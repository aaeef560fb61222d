"""Analysis CLI: the reference's notebook suite as one command.

Port of ``tvqvae_tpu/scripts/analyze.py``, with its flags, plus
``--device`` (the card unless ``cpu`` is asked for):

    python -m tvqvae_tpu_torch.scripts.analyze --dataset_file data.npz \
        --synthetic_file synthetic.npz [--distances_json d.json] \
        [--save_dir analysis] [--rocket_num_kernels 1000] [--config cfg.json] [--device cuda]

From the dataset's test split and a generated ``.npz`` in original units
(the generate CLI's; re-scaled with the dataset's scaler) it writes under
``--save_dir`` the JAX CLI's artifacts: time-series CI bands, marginal
distributions, visual inspection, trajectory overlays, the per-class
clustering map and the altitude map and profiles, ``pca.png`` and
``tsne.png`` of the ROCKET features (computed on the device), and
``quality_metrics.json`` (FID against the test features, MDD/ACD/SD/KD);
with ``--distances_json`` (the flyability CLI's, its ``per_flight`` table)
the distance correlation heatmaps and percentile curves, euclidean and
spherical. ``run(args, figures=False)`` computes every figure's data and
the metrics and draws nothing (matplotlib is imported by the drawing
alone; the CLI, as the JAX package's, needs it).
"""

import argparse
import json
import os
import time

import numpy as np

from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.utils import plots


def build_argparser():
    p = argparse.ArgumentParser(description="Analysis figure suite (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="config in the reference schema, YAML or .json; defaults built in")
    p.add_argument("--dataset_file", type=str, required=True)
    p.add_argument("--synthetic_file", type=str, required=True,
                   help="generated .npz in ORIGINAL units (generate CLI output); re-scaled with "
                        "the dataset scaler")
    p.add_argument("--distances_json", type=str, default=None,
                   help="optional flyability distances JSON for heatmaps/percentiles")
    p.add_argument("--save_dir", type=str, default="analysis")
    p.add_argument("--rocket_num_kernels", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def run(args, figures: bool = True) -> dict:
    """-> {"results" (the quality metrics), "figures" (each figure's data by
    file name; None where it draws its inputs as they are), "seconds" (by
    step)}."""
    seconds, out = {}, {}
    clock = [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        seconds[step] = seconds.get(step, 0.0) + now - clock[0]
        clock[0] = now

    def figure(name, draw, data=None):
        out[name] = data
        if figures:
            import matplotlib.pyplot as plt

            fig = draw()
            fig.savefig(os.path.join(args.save_dir, name), bbox_inches="tight")
            plt.close(fig)

    cfg = load_config(args.config)
    os.makedirs(args.save_dir, exist_ok=True)
    data = get_data(args.dataset_file, cfg.dataset.features, scale=cfg.dataset.data_scaling)
    X_gen_raw = np.asarray(np.load(args.synthetic_file)["X"], np.float32)
    N, C, L = X_gen_raw.shape
    flat = X_gen_raw.transpose(0, 2, 1).reshape(N, L * C)
    X_gen = data.scaler.transform(flat).reshape(N, L, C).transpose(0, 2, 1).astype(np.float32)
    feats = cfg.dataset.features
    lap("load")

    ci = plots.timeseries_ci_data(data.X_test, X_gen)
    figure("timeseries_ci.png", lambda: plots.draw_timeseries_ci(ci, feats), ci)
    lap("timeseries_ci")
    dist = plots.distributions_data(data.X_test, X_gen)
    figure("distribution_plots.png", lambda: plots.draw_distributions(dist, feats), dist)
    lap("distributions")
    figure("visual_inspection.png", lambda: plots.plot_visual_inspection(data.X_test, X_gen))
    if {"latitude", "longitude"} <= set(feats):
        la, lo = feats.index("latitude"), feats.index("longitude")
        figure("trajectories_generated.png",
               lambda: plots.plot_trajectories(X_gen, la, lo, title="generated"))
        figure("trajectories_real.png",
               lambda: plots.plot_trajectories(data.X_test, la, lo, title="real"))
        figure("clustering_real.png",
               lambda: plots.plot_clustering(data.X_test, data.y_test, la, lo,
                                             title="real trajectories per class"))
        if "altitude" in feats:
            alt = plots.altitude_map_data(X_gen, la, lo, feats.index("altitude"))
            figure("altitude_map_generated.png",
                   lambda: plots.draw_altitude_map(alt, X_gen, la, lo,
                                                   title="generated altitude"), alt)
    if "altitude" in feats:
        figure("altitude_generated.png",
               lambda: plots.plot_altitude(X_gen, feats.index("altitude")))
    lap("overlays")

    # feature-space metrics and embeddings (Quality_Statistical_metrics.ipynb)
    metrics = Metrics(data.input_length, data.in_channels, data.n_classes,
                      cfg.evaluation.batch_size, data.X_train, data.X_test,
                      feature_extractor_type="rocket", rocket_num_kernels=args.rocket_num_kernels,
                      device=args.device)
    z_gen = metrics.z_gen_fn(X_gen)
    lap("rocket")
    results = {"FID": metrics.fid_score(metrics.z_test, z_gen)}
    lap("fid")
    mdd, acd, sd, kd = metrics.stat_metrics(data.X_test, X_gen)
    results.update({"MDD": mdd, "ACD": acd, "SD": sd, "KD": kd})
    lap("stat_metrics")
    pca = plots.pca_data([metrics.z_test, z_gen], ["Z_test", "Z_gen"], device=args.device)
    lap("pca")
    figure("pca.png", lambda: plots.draw_scatter(pca, "PCA"), pca)
    tsne = plots.tsne_data([metrics.z_test, z_gen], ["Z_test", "Z_gen"], device=args.device)
    lap("tsne")
    figure("tsne.png", lambda: plots.draw_scatter(tsne, "t-SNE"), tsne)
    with open(os.path.join(args.save_dir, "quality_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    lap("embedding figures")

    # distance-metric analyses (correlation_heatmaps / trajectories_distances)
    if args.distances_json:
        with open(args.distances_json) as f:
            per_flight = json.load(f)["per_flight"]
        eucl = [k for k in per_flight if "Euclidean" in k] + ["Discrete Frechet", "Frechet"]
        sph = [k for k in per_flight if "Spherical" in k]
        for tag, keys in (("euclidean", eucl), ("spherical", sph)):
            corr = plots.metric_correlation(per_flight, keys)
            figure(f"correlation_heatmap_{tag}.png",
                   lambda: plots.draw_metric_correlation_heatmap(
                       corr, keys, f"distance correlations ({tag})"), corr)
            pct = plots.metric_percentiles(per_flight, keys)
            figure(f"percentile_plots_{tag}.png",
                   lambda: plots.draw_metric_percentiles(pct, keys,
                                                         f"distance percentiles ({tag})"), pct)
        lap("distances")

    print(f"[analyze] artifacts in {args.save_dir}")
    return {"results": results, "figures": out, "seconds": seconds}


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
