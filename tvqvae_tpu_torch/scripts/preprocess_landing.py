"""Landing-trajectory preprocess CLI: chunked OpenSky CSV -> final-approach
tensors.

Port of ``tvqvae_tpu/scripts/preprocess_landing.py`` (reference
timevqvae/scripts/preprocess_landing.py:208-395), with its flags and one
more, ``--device`` (the clustering's; the card unless ``cpu`` is asked for):

    python -m tvqvae_tpu_torch.scripts.preprocess_landing --ADES ENGM \
        --raw_data_dir raw --save_dir data/real [--ades_latlon LAT LON] \
        [--chunk_size 15000000] [--n_clusters 5] [--n_samples N] [--device cuda]

It reads ``<raw_data_dir>/landing/*<ADES>*.csv`` in chunks of
``--chunk_size`` rows, assigns flight ids within each chunk (as the
reference does), keeps the points within 100 km of the destination, removes
outliers with the landing thresholds (final distance 10 km, short-sequence
z -1, no initial-distance rule), clusters and resamples, and writes
``<save_dir>/landing_<ADES>.npz``.
"""

import argparse
import glob
import os
import time

from tvqvae_tpu_torch.data.preprocess import (
    airport_latlon,
    assign_flight_ids,
    haversine_np,
    remove_outliers,
)
from tvqvae_tpu_torch.data.table import (
    Table,
    concat,
    dropna,
    parse_iso8601,
    read_csv_chunks,
    take,
    to_float,
)
from tvqvae_tpu_torch.scripts.preprocess import cluster_and_export


def get_landing_data(t: Table, ades_latlon, distance_km: float = 100.0) -> Table:
    """The points within ``distance_km`` of the destination (reference
    preprocess_landing.py:279-291)."""
    d = haversine_np(t["latitude"], t["longitude"], ades_latlon[0], ades_latlon[1])
    return take(t, d <= distance_km)


def process_chunk(chunk: Table, ades_latlon, distance_km: float) -> Table:
    """Reference preprocess_landing.py:257-277."""
    chunk = dropna(chunk)
    for c in ("latitude", "longitude", "altitude"):
        chunk[c] = to_float(chunk[c])
    chunk = take(chunk, chunk["altitude"] >= 0)
    chunk["timestamp"] = parse_iso8601(chunk["timestamp"])
    chunk = assign_flight_ids(chunk, window_hours=6)
    return get_landing_data(chunk, ades_latlon, distance_km)


def build_argparser():
    p = argparse.ArgumentParser(description="Preprocess landing trajectories (PyTorch port)")
    p.add_argument("--ADES", type=str, default="ENGM")
    p.add_argument("--raw_data_dir", dest="base_path", type=str, default="../raw_data")
    p.add_argument("--save_dir", type=str, default="./data/real/")
    p.add_argument("--ades_latlon", type=float, nargs=2, default=None)
    p.add_argument("--chunk_size", type=int, default=15_000_000)
    p.add_argument("--n_clusters", type=int, default=5)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the clustering runs: cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    ades_ll = airport_latlon(args.ADES, args.ades_latlon)
    files = [f for f in sorted(glob.glob(os.path.join(args.base_path, "landing", "*.csv")))
             if args.ADES in os.path.basename(f)]
    if not files:
        raise FileNotFoundError(f"no landing csv for {args.ADES}")
    report = {}
    t0 = time.perf_counter()
    t = concat([process_chunk(chunk, ades_ll, distance_km=100.0)
                for chunk in read_csv_chunks(files[0], args.chunk_size)])
    report["load"] = time.perf_counter() - t0  # read, ids and the 100-km cut, by chunk
    # landing thresholds: final distance 10 km, short-seq z > -1, no
    # initial-distance rule (reference preprocess_landing.py:121-126, 248-250)
    t0 = time.perf_counter()
    t, avg_len = remove_outliers(t, adep_latlon=None, ades_latlon=ades_ll,
                                 airport_km=10.0, short_seq_z=-1.0)
    report["outliers"] = time.perf_counter() - t0
    base = os.path.join(args.save_dir, f"landing_{args.ADES}")
    return cluster_and_export(args, t, avg_len, base, report)


if __name__ == "__main__":
    main()
