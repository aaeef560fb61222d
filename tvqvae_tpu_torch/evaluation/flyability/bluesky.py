"""BlueSky air-traffic-simulator harness for flyability evaluation, without
pandas.

The port of ``tvqvae_tpu/evaluation/flyability/bluesky.py`` (reference
eval_logic.py:20-417): generated trajectories are replayed through the
external BlueSky simulator (a subprocess) via .scn scenario files, per flight
a CRE + DEFWPT/ADDWPT waypoint program with LNAV/VNAV, a CRELOG EVALLOG
logger sampling lat/lon/alt/id every ``log_dt`` seconds, batches assembled
with PCALL + fast-forward + timed CLOSE. The scenario files and the logs are
the same text as the JAX package's.

A flight-points table is a dict of equal-length numpy columns: ``flight_id``
(str), ``timestamp`` (datetime64[ns], UTC), ``latitude``, ``longitude``,
``altitude`` and any others (``AC Type``, ``groundspeed``), sorted by
(flight_id, timestamp). ``ROW`` holds each point's row label in the table it
came from, as the pandas index does in the JAX package, where the scenario
files name the waypoints after it. pandas is not a dependency of the
port, so neither this module nor the flyability CLI uses it.
"""

import glob
import os
import subprocess
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from tvqvae_tpu_torch.data.preprocess import haversine_np
from tvqvae_tpu_torch.data.table import Table, concat, sort_rows, table_len, take

KM_TO_NM = 0.539957
ROW = "_row"
LOG_COLUMNS = ("relt", "latitude", "longitude", "altitude", "flight_id")


@dataclass
class BlueSkyConfig:
    workdir: str = "./bluesky_eval"
    logs_directory: str = os.path.expanduser("~/bluesky/output")
    command: str = "bluesky --headless --scenfile {scenfile}"
    batch_size: int = 256
    delta: Optional[float] = 1e3  # Douglas-Peucker simplification tolerance
    simulation_time: str = "02:00:00"  # HH:MM:SS
    log_dt: int = 10
    default_ac_type: str = "A319"


# --------------------------------------------------------------------------
# tables


def flights(t: Table):
    """(flight_id, rows of that flight in table order) in sorted id order."""
    if not t:
        return
    ids = t["flight_id"]
    for fid in np.unique(ids):
        yield fid, take(t, np.flatnonzero(ids == fid))


def _row_labels(t: Table) -> np.ndarray:
    return t[ROW] if ROW in t else np.arange(table_len(t))


# --------------------------------------------------------------------------
# flight preparation


def _bearing_deg(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Initial great-circle bearing in degrees (reference :39-77)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlon = lon2 - lon1
    y = np.sin(dlon) * np.cos(lat2)
    x = np.cos(lat1) * np.sin(lat2) - np.sin(lat1) * np.cos(lat2) * np.cos(dlon)
    return (np.degrees(np.arctan2(y, x)) + 360.0) % 360.0


def add_ground_speed(flight: Table) -> Table:
    """Derive knots groundspeed between consecutive waypoints
    (reference :163-193; first point repeats the first segment speed)."""
    flight = take(flight, np.argsort(flight["timestamp"], kind="stable"))
    lat, lon = flight["latitude"], flight["longitude"]
    d_nm = haversine_np(lat[:-1], lon[:-1], lat[1:], lon[1:]) * KM_TO_NM
    dt_h = np.diff(flight["timestamp"].astype("int64")) / 1e9 / 3600.0
    speed = d_nm / (dt_h + 1e-6)
    flight["groundspeed"] = np.concatenate([speed[:1], speed])
    return flight


def _differs_from_previous(x: np.ndarray) -> np.ndarray:
    keep = np.ones(len(x), bool)
    keep[1:] = x[1:] != x[:-1]
    return keep


def remove_neighbours(flight: Table) -> Table:
    """Drop waypoints repeating the previous coordinates (reference :197-206)."""
    flight = take(flight, _differs_from_previous(flight["latitude"]))
    return take(flight, _differs_from_previous(flight["longitude"]))


def simplify_track(flight: Table, tolerance_m: Optional[float]) -> Table:
    """Douglas-Peucker simplification in local meters (the reference calls
    traffic's ``.simplify(delta)``, eval_logic.py:362)."""
    if tolerance_m is None or table_len(flight) <= 2:
        return flight
    lat = flight["latitude"]
    lon = flight["longitude"]
    lat0 = float(lat.mean())
    x = np.radians(lon) * 6371000.0 * np.cos(np.radians(lat0))
    y = np.radians(lat) * 6371000.0
    pts = np.stack([x, y], axis=1)

    keep = np.zeros(len(pts), bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(pts) - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        seg = pts[i1] - pts[i0]
        ss = float(seg @ seg)
        w = pts[i0 + 1:i1] - pts[i0]
        if ss == 0.0:
            d = np.linalg.norm(w, axis=1)
        else:
            t = np.clip((w @ seg) / ss, 0.0, 1.0)
            d = np.linalg.norm(w - t[:, None] * seg[None], axis=1)
        k = int(np.argmax(d))
        if d[k] > tolerance_m:
            idx = i0 + 1 + k
            keep[idx] = True
            stack.append((i0, idx))
            stack.append((idx, i1))
    return take(flight, np.flatnonzero(keep))


# --------------------------------------------------------------------------
# scenario files


def build_scenario(flight: Table, scen_dir: str, ac_type: str) -> str:
    """Write one flight's .scn (reference :209-237): CRE at the first point
    with initial heading/speed, then DEFWPT/ADDWPT per waypoint (named after
    the point's row label), LNAV/VNAV, and QUIT at the last waypoint."""
    os.makedirs(scen_dir, exist_ok=True)
    fid = str(flight["flight_id"][0])
    fname = os.path.join(scen_dir, f"output_{fid}.scn")
    lat, lon, alt = flight["latitude"], flight["longitude"], flight["altitude"]
    gs = flight["groundspeed"]
    hdg = _bearing_deg(lat[0], lon[0], lat[1], lon[1])
    actype = flight["AC Type"][0] if "AC Type" in flight else ac_type
    rows = _row_labels(flight)
    with open(fname, "w") as f:
        f.write(f"00:00:00.00>CRE {fid} {actype} {lat[0]} {lon[0]} {hdg} {alt[0]} {gs[0]}\n")
        last_wpt = None
        for k in range(1, len(lat)):
            last_wpt = f"WPTZ{rows[k]}"
            f.write(f"00:00:00.00>DEFWPT {last_wpt},{lat[k]}, {lon[k]}\n")
            f.write(f"00:00:00.00>{fid} ADDWPT {last_wpt} {alt[k]} {gs[k]}\n")
        f.write(f"00:00:00.00>{fid} LNAV ON\n")
        f.write(f"00:00:00.00>{fid} VNAV ON\n")
        f.write(f"00:00:00.00>{fid} AT {last_wpt} QUIT\n")
    return fname


def build_logger(workdir: str, dt: int = 10,
                 variables=("traf.lat", "traf.lon", "traf.alt", "traf.id")) -> str:
    """CRELOG EVALLOG logger scenario (reference :260-271)."""
    fname = os.path.join(workdir, "evaluation_logger.scn")
    with open(fname, "w") as f:
        f.write(f"0:00:00.00>CRELOG EVALLOG {dt}\n")
        f.write(f"0:00:00.00>EVALLOG ADD {' '.join(variables)} \n")
        f.write("0:00:00.00>EVALLOG ON\n")
    return fname


def assemble_scenarios(
    workdir: str, flight_ids: List[str], simulation_time: str,
    logger_scn: str, debug: bool = False,
) -> str:
    """Master scenario: PCALL each flight + the logger, FF, timed CLOSE
    (reference :240-257)."""
    fname = os.path.join(workdir, "evaluation_scenario.scn")
    with open(fname, "w") as f:
        for fid in flight_ids:
            f.write(
                f"00:00:00.00>PCALL "
                f"{os.path.join(workdir, 'scenarios', f'output_{fid}.scn')}\n"
            )
        f.write(f"00:00:00.00>PCALL {logger_scn}\n")
        f.write("00:00:03.00>FF\n")
        end = "00:01:00" if debug else simulation_time
        f.write(f"{end}.00>OP\n")
        f.write(f"{end}.10>CLOSE\n")
    return fname


# --------------------------------------------------------------------------
# logs


def logs_to_table(fname: str) -> Table:
    """Parse an EVALLOG csv (reference :279-289): '#' starts a comment, the
    columns are relt, latitude, longitude, altitude, flight_id; rows sorted
    by (flight_id, relt)."""
    rows = []
    with open(fname) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append(line.split(","))
    if any(len(r) != len(LOG_COLUMNS) for r in rows):
        raise ValueError(f"{fname}: expected {len(LOG_COLUMNS)} fields a row")
    cols = list(zip(*rows)) if rows else [()] * len(LOG_COLUMNS)
    t = {name: np.asarray(col, np.float64) for name, col in zip(LOG_COLUMNS[:4], cols)}
    t["flight_id"] = np.asarray(cols[4], dtype=str)
    return sort_rows(t, ("flight_id", "relt"))


def annotate_logs(logs: Table, original: Table) -> Table:
    """Attach original per-flight metadata + absolute timestamps
    (reference :292-305): the first point's columns but its coordinates,
    joined on flight_id (inner, in the metadata's order), then the log's
    relt, latitude, longitude and altitude; timestamp += relt seconds."""
    orig = sort_rows(original, ("flight_id", "timestamp"))
    ids = orig["flight_id"]
    firsts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    meta = {k: v[firsts] for k, v in orig.items()
            if k not in ("altitude", "longitude", "latitude", ROW)}
    meta["flight_id"] = meta["flight_id"].astype(str)
    log_ids = np.char.strip(logs["flight_id"].astype(str))
    left, right = [], []
    for k, fid in enumerate(meta["flight_id"]):
        rows = np.flatnonzero(log_ids == fid)
        left.append(np.full(len(rows), k))
        right.append(rows)
    left = np.concatenate(left) if left else np.zeros(0, int)
    right = np.concatenate(right) if right else np.zeros(0, int)
    merged = take(meta, left)
    for k in LOG_COLUMNS[:4]:
        merged[k] = logs[k][right]
    ns = np.round(merged["relt"] * 1e9).astype("int64").astype("timedelta64[ns]")
    merged["timestamp"] = merged["timestamp"] + ns
    return merged


def _newest_file(directory: str) -> str:
    files = glob.glob(os.path.join(directory, "*"))
    if not files:
        raise FileNotFoundError(f"no simulator logs in {directory}")
    return max(files, key=os.path.getctime)


def simulate(points: Table, cfg: BlueSkyConfig, debug: bool = False) -> Table:
    """Replay all flights through BlueSky in batches (reference :321-383).

    points: flight-points table with flight_id/timestamp/latitude/longitude/
    altitude. Returns the simulated points annotated with the original
    metadata ({} when no flight has two distinct points)."""
    os.makedirs(cfg.workdir, exist_ok=True)
    scen_dir = os.path.join(cfg.workdir, "scenarios")
    logger_scn = build_logger(cfg.workdir, cfg.log_dt)

    prepared = []
    for _, flight in flights(points):
        flight = take(flight, np.argsort(flight["timestamp"], kind="stable"))
        # drop runs of grounded duplicates (reference :343-345)
        alt = flight["altitude"]
        grounded = (alt == 0) & np.r_[alt[1:] == 0, False]
        flight = remove_neighbours(take(flight, ~grounded))
        if table_len(flight) < 2:
            continue
        prepared.append(add_ground_speed(flight))

    out = []
    for s in range(0, len(prepared), cfg.batch_size):
        batch = prepared[s:s + cfg.batch_size]
        fids = []
        for flight in batch:
            sf = simplify_track(flight, cfg.delta)
            if table_len(sf) < 2:
                sf = flight
            build_scenario(sf, scen_dir, cfg.default_ac_type)
            fids.append(str(sf["flight_id"][0]))
        scen = assemble_scenarios(cfg.workdir, fids, cfg.simulation_time, logger_scn, debug)
        cmd = cfg.command.format(scenfile=scen)
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.DEVNULL)
        proc.wait()
        log_file = _newest_file(cfg.logs_directory)
        out.append(annotate_logs(logs_to_table(log_file), concat(batch)))
        os.remove(log_file)
    return concat(out)


def clean(workdir: str) -> None:
    """Remove generated scenario files (reference :402-417)."""
    for name in ("evaluation_scenario.scn", "evaluation_logger.scn"):
        try:
            os.remove(os.path.join(workdir, name))
        except OSError:
            pass
    try:
        for f in glob.glob(os.path.join(workdir, "scenarios", "*")):
            os.remove(f)
        os.rmdir(os.path.join(workdir, "scenarios"))
    except OSError as e:
        print(e)
