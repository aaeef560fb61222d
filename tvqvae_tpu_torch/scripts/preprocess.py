"""Preprocess CLI: raw EuroControl/OpenSky CSVs -> training tensors.

Port of ``tvqvae_tpu/scripts/preprocess.py`` (reference
timevqvae/scripts/preprocess.py:482-538), with its flags and one more,
``--device`` (the clustering's; the card unless ``cpu`` is asked for):

    python -m tvqvae_tpu_torch.scripts.preprocess --data_source OpenSky \
        --ADEP EHAM --ADES LIMC --raw_data_dir raw --save_dir data/real \
        [--adep_latlon LAT LON] [--ades_latlon LAT LON] [--n_clusters 5] \
        [--n_samples N] [--device cuda]

It reads ``<raw_data_dir>/OpenSky/*<ADEP>*<ADES>*.csv`` or the monthly
``<raw_data_dir>/EuroControl/20YYMM/`` directories and writes
``<save_dir>/<data_source>_<ADEP>_<ADES>.npz`` (X (N, 4, L) float32, y),
which ``data.get_data`` reads; also a Traffic pickle where pandas and
``traffic`` import. It prints the seconds of each stage.
"""

import argparse
import json
import os
import time

from tvqvae_tpu_torch.data.preprocess import (
    airport_latlon,
    export_dataset,
    load_eurocontrol,
    load_opensky,
    prepare_trajectories,
    remove_outliers,
)


def build_argparser():
    p = argparse.ArgumentParser(description="Preprocess raw ADS-B data (PyTorch port)")
    p.add_argument("--ADEP", type=str, default="EHAM")
    p.add_argument("--ADES", type=str, default="LIMC")
    p.add_argument("--raw_data_dir", dest="base_path", type=str, default="../raw_data/")
    p.add_argument("--data_source", type=str, default="EuroControl")
    p.add_argument("--save_dir", type=str, default="./data/real/")
    p.add_argument("--adep_latlon", type=float, nargs=2, default=None)
    p.add_argument("--ades_latlon", type=float, nargs=2, default=None)
    p.add_argument("--n_clusters", type=int, default=5)
    p.add_argument("--n_samples", type=int, default=None,
                   help="override the resample length (default: even-forced average "
                        "sequence length)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the clustering runs: cuda (default) or cpu")
    return p


def cluster_and_export(args, t, avg_len, base, report):
    """Resample, cluster and write; print and return the report (stage
    seconds, shapes, the written path, the flight ids and their labels)."""
    X, labels, ids = prepare_trajectories(t, args.n_samples or avg_len,
                                          n_clusters=args.n_clusters, device=args.device,
                                          report=report)
    os.makedirs(args.save_dir, exist_ok=True)
    t0 = time.perf_counter()
    out = export_dataset(base, X, labels, ids)
    report["export"] = time.perf_counter() - t0
    print("[preprocess] " + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                        for k, v in report.items()}), flush=True)
    print(f"Saved {X.shape[0]} trajectories of shape {X.shape[1:]} -> {out}")
    return dict(report, path=out, shape=X.shape, flights=ids, labels=labels)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    report = {}
    src = args.data_source.lower()
    if "eurocontrol" in src:
        t0 = time.perf_counter()
        t, avg_len = load_eurocontrol(os.path.join(args.base_path, "EuroControl"),
                                      args.ADEP, args.ADES)
        report["parse"] = time.perf_counter() - t0
        # en-route outlier filtering also applies to EuroControl points
        t0 = time.perf_counter()
        t, avg_len2 = remove_outliers(t, airport_latlon(args.ADEP, args.adep_latlon),
                                      airport_latlon(args.ADES, args.ades_latlon))
        report["outliers"] = time.perf_counter() - t0
        avg_len = avg_len2 or avg_len
    elif "opensky" in src:
        t, avg_len = load_opensky(os.path.join(args.base_path, "OpenSky"), args.ADEP, args.ADES,
                                  adep_latlon=args.adep_latlon, ades_latlon=args.ades_latlon,
                                  report=report)
    else:
        raise ValueError(f"Invalid data source: {args.data_source} "
                         "(EuroControl and OpenSky are supported)")
    base = os.path.join(args.save_dir, f"{args.data_source}_{args.ADEP}_{args.ADES}")
    return cluster_and_export(args, t, avg_len, base, report)


if __name__ == "__main__":
    main()
