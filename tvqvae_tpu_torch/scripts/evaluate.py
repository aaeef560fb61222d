"""Evaluate CLI: FID, IS and the TSGBench statistics of trained checkpoints.

Port of ``tvqvae_tpu/scripts/evaluate.py``, with its flags and result names:

    python -m tvqvae_tpu_torch.scripts.evaluate --dataset_file data.npz \
        [--config cfg.json] [--model_save_dir saved_models] [--fid_method svd] \
        [--device cuda]

``max(|X_test|, min_num_gen_samples)`` unconditional samples from the
stages under ``<model_save_dir>/<dataset stem>/`` (``from_checkpoints``),
then ``FID`` against the test split's features and ``FID_rec`` of the
test split's stage-1 round trip (the VQ kernel encodes it), ``MDD``,
``ACD``, ``SD`` and ``KD``, and ``IS_mean``/``IS_std`` through the FCN when
``fcn`` exists. When ``stage3`` exists (and not ``--no_fidelity_enhancer``)
the same over the enhanced samples (``... with FE``), and ``FID_svq`` of
the SVQ round trip at stage 3's tau when it is above 0. The metrics go to
the run directory's ``metrics.jsonl`` (``RunLogger``) and to stdout as JSON.

The images are the JAX CLI's, under its file names in the run directory:
``visual_inspection.png``, ``pca_test_gen.png`` and ``tsne_test_gen.png``
of the test and generated features, ``visual_inspection_fe.png`` and
``pca_test_gen_fe.png`` with the enhancer, and ``conditional_class_<k>.png``
for every class (``min(batch_size, 16)`` samples conditioned on it, seeded
``seed + k``). The embeddings run on the device (``utils/embedding.py``,
no scikit-learn). ``run(args, figures=False)`` computes every image's data
and draws nothing (matplotlib is imported by the drawing alone; the CLI, as
the JAX package's, needs it).
"""

import argparse
import json
import os
from pathlib import Path

from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.utils import plots
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
from tvqvae_tpu_torch.utils.logging import RunLogger


def evaluate(cfg, data, ckpt_dir: str, logger: RunLogger, batch_size: int, min_num_gen: int,
             use_fe: bool, feature_extractor_type: str, seed: int = 0,
             fid_method: str = "schur", device="cuda", figures: bool = True):
    """-> (results, images): the metrics, and each image's data by file name
    (the PCA/t-SNE points, the conditional samples; None where the figure
    draws its inputs as they are). With ``figures`` each image is drawn and
    written through ``logger.log_image``."""
    stage = {s: os.path.join(ckpt_dir, s) for s in ("stage1", "stage2", "stage3", "fcn")}
    has_stage3 = os.path.exists(stage["stage3"])
    have_fe = has_stage3 and use_fe
    fcn_vars = load_checkpoint(stage["fcn"])[0] if os.path.exists(stage["fcn"]) else None

    sampler = TrainedModelSampler.from_checkpoints(
        cfg, stage["stage1"], stage["stage2"], stage["stage3"] if has_stage3 else None,
        batch_size=batch_size, device=device)
    metrics = Metrics(
        data.input_length, data.in_channels, data.n_classes, batch_size,
        data.X_train, data.X_test, feature_extractor_type=feature_extractor_type,
        fcn_variables=fcn_vars if feature_extractor_type == "supervised_fcn" else None,
        fid_method=fid_method, device=device)
    fcn_metrics = None
    if fcn_vars is not None:
        fcn_metrics = metrics if feature_extractor_type == "supervised_fcn" else Metrics(
            data.input_length, data.in_channels, data.n_classes, batch_size,
            data.X_train[:batch_size], data.X_test[:batch_size],
            feature_extractor_type="supervised_fcn", fcn_variables=fcn_vars, device=device)

    results, images = {}, {}

    def image(name, draw, image_data=None):
        images[name] = image_data
        if figures:
            import matplotlib.pyplot as plt

            fig = draw()
            logger.log_image(fig, name)
            plt.close(fig)

    n_gen = max(len(data.X_test), min_num_gen)
    print(f"[evaluate] sampling {n_gen} unconditional trajectories...")
    _, _, x_gen = sampler.sample(n_gen, "unconditional", seed=seed)

    z_gen = metrics.z_gen_fn(x_gen)
    z_rec = metrics.compute_z(sampler.reconstruct(data.X_test))
    results["FID"] = metrics.fid_score(metrics.z_test, z_gen)
    results["FID_rec"] = metrics.fid_score(metrics.z_test, z_rec)
    mdd, acd, sd, kd = metrics.stat_metrics(data.X_test, x_gen)
    results.update({"MDD": mdd, "ACD": acd, "SD": sd, "KD": kd})
    if fcn_metrics is not None:
        results["IS_mean"], results["IS_std"] = fcn_metrics.inception_score(x_gen)

    image("visual_inspection.png", lambda: plots.plot_visual_inspection(data.X_test, x_gen))
    pca = plots.pca_data([metrics.z_test, z_gen], ["Z_test", "Z_gen"], device=device)
    image("pca_test_gen.png", lambda: plots.draw_scatter(pca, "PCA"), pca)
    tsne = plots.tsne_data([metrics.z_test, z_gen], ["Z_test", "Z_gen"], device=device)
    image("tsne_test_gen.png", lambda: plots.draw_scatter(tsne, "t-SNE"), tsne)

    if have_fe:
        x_gen_fe = sampler.enhance(x_gen)
        z_gen_fe = metrics.z_gen_fn(x_gen_fe)
        results["FID with FE"] = metrics.fid_score(metrics.z_test, z_gen_fe)
        mdd, acd, sd, kd = metrics.stat_metrics(data.X_test, x_gen_fe)
        results.update({"MDD with FE": mdd, "ACD with FE": acd,
                        "SD with FE": sd, "KD with FE": kd})
        if fcn_metrics is not None:
            is_mean, is_std = fcn_metrics.inception_score(x_gen_fe)
            results["IS_mean with FE"] = is_mean
            results["IS_std with FE"] = is_std
        # the SVQ round trip at the stored tau
        if sampler.tau > 0:
            x_svq = sampler.reconstruct(data.X_test, svq_temp=sampler.tau, seed=seed)
            results["FID_svq"] = metrics.fid_score(metrics.z_test, metrics.compute_z(x_svq))
        image("visual_inspection_fe.png", lambda: plots.plot_visual_inspection(
            data.X_test, x_gen_fe, title="visual inspection (FE)"))
        pca_fe = plots.pca_data([metrics.z_test, z_gen_fe], ["Z_test", "Z_gen_FE"], device=device)
        image("pca_test_gen_fe.png", lambda: plots.draw_scatter(pca_fe, "PCA"), pca_fe)

    # the per-class conditional grids (reference evaluate.py:207-270)
    for cls in range(data.n_classes):
        _, _, xc = sampler.sample(min(batch_size, 16), "conditional", class_index=cls,
                                  seed=seed + cls)
        real = data.X_test[data.y_test[:, 0] == cls][:16]
        image(f"conditional_class_{cls}.png",
              lambda: plots.plot_visual_inspection(real, xc, title=f"class {cls}"), xc)

    logger.log_metrics(results, step=0)
    return results, images


def build_argparser():
    p = argparse.ArgumentParser(description="Evaluate trained models (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="config in the reference schema, YAML or .json; defaults built in")
    p.add_argument("--dataset_file", type=str, required=True)
    p.add_argument("--model_save_dir", type=str, default="saved_models")
    p.add_argument("--run_dir", type=str, default="runs")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--min_num_gen_samples", type=int, default=None)
    p.add_argument("--no_fidelity_enhancer", action="store_true")
    p.add_argument("--feature_extractor_type", type=str, default=None,
                   choices=[None, "rocket", "supervised_fcn"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fid_method", type=str, default="schur", choices=("schur", "svd"),
                   help="schur = the reference's Schur trace; svd = exact trace identity, "
                        "far faster at the 2000-wide ROCKET features")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def run(args, figures: bool = True) -> dict:
    """The CLI's work on parsed ``args``: -> {"results", "images"};
    ``figures=False`` computes the images' data, draws nothing."""
    cfg = load_config(args.config)
    data = get_data(args.dataset_file, cfg.dataset.features, scale=cfg.dataset.data_scaling)
    stem = Path(args.dataset_file).stem
    logger = RunLogger(os.path.join(args.run_dir, f"{stem}_evaluate"),
                       experiment_name=cfg.logger.experiment_name,
                       run_name=f"{stem}_evaluate", mlflow_uri=cfg.logger.mlflow_uri)
    try:
        results, images = evaluate(
            cfg, data, os.path.join(args.model_save_dir, stem), logger,
            batch_size=args.batch_size or cfg.evaluation.batch_size,
            min_num_gen=args.min_num_gen_samples or cfg.evaluation.min_num_gen_samples,
            use_fe=not args.no_fidelity_enhancer,
            feature_extractor_type=args.feature_extractor_type
            or cfg.evaluation.feature_extractor_type,
            seed=args.seed, fid_method=args.fid_method, device=args.device, figures=figures)
    finally:
        logger.close()
    print(json.dumps({k: float(v) for k, v in results.items()}, indent=2))
    return {"results": results, "images": images}


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
