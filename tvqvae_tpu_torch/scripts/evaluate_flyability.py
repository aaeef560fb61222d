"""Flyability CLI: replay generated trajectories through BlueSky and score
them with the 14 trajectory distances.

Port of ``tvqvae_tpu/scripts/evaluate_flyability.py``, with its flags and
outputs, plus ``--device`` (the card unless ``cpu`` is asked for):

    python -m tvqvae_tpu_torch.scripts.evaluate_flyability \
        --synthetic_file synthetic.npz [--save_dir flyability_results] \
        [--ADEP EHAM --ADES LIMC] [--bluesky_cmd "bluesky --headless --scenfile {scenfile}"] \
        [--logs_directory ~/bluesky/output] [--device cuda]

Input: the generate CLI's ``.npz`` (X in original units, channels
``--features``) or a flight-points CSV (flight_id, timestamp, latitude,
longitude, altitude). Outputs under ``--save_dir``: ``<stem>_simulated.csv``
(each simulated flight cut at its point closest to the destination),
``<stem>_distances.json`` (``per_flight`` and ``summary``: mean, median and
p90 of each metric) and ``<stem>_distance_cdfs.png`` (matplotlib, imported
only by the plot step, which fails without it as the JAX package's does).
``run`` goes through the named steps: ``load_points`` -> ``simulate_points``
-> ``filter_simulated`` -> ``write_simulated`` -> ``score_and_write`` ->
``plot_distance_cdfs``; ``run(args, plot=False)`` stops before the plot.
No pandas: it is not a dependency of the port.
"""

import argparse
import csv
import json
import os
import re
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from tvqvae_tpu_torch.data.preprocess import airport_latlon, haversine_np
from tvqvae_tpu_torch.evaluation.flyability.bluesky import (
    ROW,
    BlueSkyConfig,
    Table,
    concat,
    flights,
    simulate,
    sort_rows,
    table_len,
    take,
)
from tvqvae_tpu_torch.evaluation.flyability.distances import (
    calculate_trajectory_distances_batch,
)

EPOCH = np.datetime64("2020-01-01T00:00:00", "ns")


# --------------------------------------------------------------------------
# points in and out


def npz_to_points(path: str, features) -> Table:
    """Synthetic npz (X (N, C, L), y) -> flight-points table; timestamps from
    the running max of the timedelta channel (or the sample index)."""
    X = np.load(path)["X"]
    td_idx = features.index("timedelta") if "timedelta" in features else None
    tables = []
    for i in range(X.shape[0]):
        t = {f: X[i, j] for j, f in enumerate(features)}
        rel = X[i, td_idx] if td_idx is not None else np.arange(X.shape[-1])
        secs = np.maximum.accumulate(rel).astype(np.float64)
        t["timestamp"] = EPOCH + np.round(secs * 1e9).astype("int64").astype("timedelta64[ns]")
        t["flight_id"] = np.full(X.shape[-1], f"SYN{i:05d}")
        tables.append(t)
    points = concat(tables)
    points[ROW] = np.arange(table_len(points))
    return points


def _parse_timestamp(s: str) -> np.datetime64:
    """ISO 8601 text (date, time to the nanosecond, an optional Z or +HH:MM
    offset) -> UTC datetime64[ns]."""
    s = s.strip().replace(" ", "T", 1)
    offset = np.timedelta64(0, "m")
    if s.endswith("Z"):
        s = s[:-1]
    else:
        m = re.search(r"T.*([+-])(\d\d):?(\d\d)$", s)
        if m:
            minutes = int(m.group(2)) * 60 + int(m.group(3))
            offset = np.timedelta64(minutes if m.group(1) == "+" else -minutes, "m")
            s = s[:m.start(1)]
    return np.datetime64(s, "ns") - offset


def _column(values):
    try:
        return np.asarray([float(v) for v in values], np.float64)
    except ValueError:
        return np.asarray(values, dtype=str)


def read_points_csv(path: str) -> Table:
    """A flight-points CSV -> table (numeric columns float64, timestamps
    ISO 8601 in UTC), sorted by (flight_id, timestamp); ``ROW`` keeps the
    file's row order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = list(zip(*body)) if body else [()] * len(header)
    t = {}
    for name, col in zip(header, cols):
        if name == "timestamp":
            t[name] = np.asarray([_parse_timestamp(v) for v in col], "datetime64[ns]")
        elif name == "flight_id":
            t[name] = np.asarray(col, dtype=str)
        else:
            t[name] = _column(col)
    t[ROW] = np.arange(len(body))
    return sort_rows(t, ("flight_id", "timestamp"))


def _format_timestamp(ts: np.datetime64) -> str:
    """pandas' text of a UTC timestamp: seconds, then micro- or nanoseconds
    where there are any, then +00:00."""
    ns = int(ts.astype("datetime64[ns]").astype("int64"))
    secs, frac = divmod(ns, 10**9)
    text = datetime.fromtimestamp(secs, timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
    if frac:
        text += f".{frac // 1000:06d}" if frac % 1000 == 0 else f".{frac:09d}"
    return text + "+00:00"


def _format(x) -> str:
    """A cell's text: numbers as their shortest round-trip text in the
    column's own precision, as pandas writes them."""
    return _format_timestamp(x) if isinstance(x, np.datetime64) else str(x)


def write_points_csv(points: Table, path: str) -> None:
    names = [k for k in points if k != ROW]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        for r in range(table_len(points)):
            w.writerow([_format(points[k][r]) for k in names])


# --------------------------------------------------------------------------
# the steps


def longest_non_outlier_duration(points: Table) -> str:
    """IQR-filtered longest flight duration as HH:MM:SS
    (reference evaluate_flyability.py:44-79)."""
    dur = np.asarray([
        (f["timestamp"].max() - f["timestamp"].min()) / np.timedelta64(1, "s")
        for _, f in flights(points)
    ])
    q1, q3 = np.quantile(dur, 0.25), np.quantile(dur, 0.75)
    iqr = q3 - q1
    keep = dur[(dur >= q1 - 1.5 * iqr) & (dur <= q3 + 1.5 * iqr)]
    secs = int(keep.max()) if len(keep) else int(dur.max())
    return f"{secs // 3600:02d}:{(secs % 3600) // 60:02d}:{secs % 60:02d}"


def filter_simulated(points: Table, ades_latlon) -> Table:
    """Truncate each simulated flight at its closest point to the
    destination airport (reference evaluate_flyability.py:96-125)."""
    out = []
    for _, f in flights(points):
        f = take(f, np.argsort(f["timestamp"], kind="stable"))
        d = haversine_np(f["latitude"], f["longitude"], ades_latlon[0], ades_latlon[1])
        out.append(take(f, slice(0, int(np.argmin(d)) + 1)))
    return concat(out)


def score_distances(original: Table, simulated: Table, adep_latlon, device="cuda") -> dict:
    """Per-flight 14-metric distances (reference flyability_eval.py:271-351),
    scored in shape buckets: on the card a DP kernel launch and the Frechet
    kernel's rounds a bucket."""
    sim = dict(flights(simulated))
    gens, sims = [], []
    for fid, f in flights(original):
        if fid not in sim:
            continue
        f = take(f, np.argsort(f["timestamp"], kind="stable"))
        s = take(sim[fid], np.argsort(sim[fid]["timestamp"], kind="stable"))
        gen = np.stack([f["latitude"], f["longitude"]], axis=1)
        sm = np.stack([s["latitude"], s["longitude"]], axis=1)
        if len(gen) < 2 or len(sm) < 2:
            continue
        gens.append(gen)
        sims.append(sm)
    if not gens:
        return {}
    return calculate_trajectory_distances_batch(gens, sims, adep_latlon, device=device)


def plot_distance_cdfs(results: dict, out_path: str) -> None:
    """Cumulative-distribution plots per metric
    (reference flyability_eval.py:354-411)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = sorted(results)
    ncol = 4
    nrow = (len(keys) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3 * nrow))
    for ax, k in zip(np.ravel(axes), keys):
        vals = np.sort(np.asarray(results[k]))
        ax.plot(vals, np.linspace(0, 1, len(vals)))
        ax.set_title(k, fontsize=9)
        ax.set_ylabel("CDF")
    for ax in np.ravel(axes)[len(keys):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def load_points(args) -> Table:
    if args.synthetic_file.endswith(".npz"):
        return npz_to_points(args.synthetic_file, args.features)
    return read_points_csv(args.synthetic_file)


def simulate_points(points: Table, args) -> Table:
    cfg = BlueSkyConfig(
        workdir=os.path.join(args.save_dir, "bluesky_work"),
        logs_directory=args.logs_directory,
        command=args.bluesky_cmd,
        batch_size=args.batch_size,
        simulation_time=longest_non_outlier_duration(points),
        default_ac_type=args.ac_type,
    )
    print(f"[flyability] simulating {len(np.unique(points['flight_id']))} flights "
          f"(simulation_time={cfg.simulation_time})")
    return simulate(points, cfg)


def write_simulated(simulated: Table, args) -> str:
    path = os.path.join(args.save_dir, f"{Path(args.synthetic_file).stem}_simulated.csv")
    write_points_csv(simulated, path)
    print(f"[flyability] simulated tracks -> {path}")
    return path


def score_and_write(points: Table, simulated: Table, args) -> dict:
    """Score every simulated flight against its generated track and write
    ``<stem>_distances.json`` (``per_flight``, ``summary``)."""
    results = score_distances(points, simulated, airport_latlon(args.ADEP, args.adep_latlon),
                              device=args.device)
    summary = {
        k: {"mean": float(np.mean(v)), "median": float(np.median(v)),
            "p90": float(np.percentile(v, 90))}
        for k, v in results.items()
    }
    stem = Path(args.synthetic_file).stem
    with open(os.path.join(args.save_dir, f"{stem}_distances.json"), "w") as f:
        json.dump({"per_flight": results, "summary": summary}, f, indent=2)
    print(json.dumps(summary, indent=2))
    return results


def build_argparser():
    p = argparse.ArgumentParser(description="BlueSky flyability evaluation (PyTorch port)")
    p.add_argument("--synthetic_file", type=str, required=True,
                   help="generated .npz (or flight-points .csv)")
    p.add_argument("--save_dir", type=str, default="flyability_results")
    p.add_argument("--ADEP", type=str, default="EHAM")
    p.add_argument("--ADES", type=str, default="LIMC")
    p.add_argument("--adep_latlon", type=float, nargs=2, default=None)
    p.add_argument("--ades_latlon", type=float, nargs=2, default=None)
    p.add_argument("--ac_type", type=str, default="A319")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--bluesky_cmd", type=str,
                   default="bluesky --headless --scenfile {scenfile}")
    p.add_argument("--logs_directory", type=str,
                   default=os.path.expanduser("~/bluesky/output"))
    p.add_argument("--no_score", action="store_true",
                   help="skip the 14-metric distance scoring")
    p.add_argument(
        "--features", type=str, nargs="+",
        default=["latitude", "longitude", "altitude", "timedelta"],
    )
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def run(args, plot: bool = True):
    """points -> simulate -> filter -> write -> score and write -> plot.
    Returns the per-flight results ({} with ``--no_score``)."""
    os.makedirs(args.save_dir, exist_ok=True)
    points = load_points(args)
    simulated = simulate_points(points, args)
    simulated = filter_simulated(simulated, airport_latlon(args.ADES, args.ades_latlon))
    write_simulated(simulated, args)
    if args.no_score:
        return {}
    results = score_and_write(points, simulated, args)
    if plot:
        stem = Path(args.synthetic_file).stem
        plot_distance_cdfs(results, os.path.join(args.save_dir, f"{stem}_distance_cdfs.png"))
    return results


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
