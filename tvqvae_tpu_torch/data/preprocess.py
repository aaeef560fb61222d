"""Host-side ADS-B preprocessing: raw CSV -> clustered, resampled tensors.

Port of ``tvqvae_tpu/data/preprocess.py`` (the reference's
``scripts/preprocess.py`` and ``preprocess_landing.py`` without ``traffic``)
on numpy tables (``data/table.py``) instead of pandas, with the clustering in
float64 torch on an explicit device (``data/mixture.py``) instead of
scikit-learn:
  1. load EuroControl (``Flights_*.csv`` joined with
     ``Flight_Points_Actual_*.csv``) or OpenSky (one CSV) points,
  2. flight ids by (icao24, callsign) with a 6-h gap rule,
  3. outlier removal: consecutive points > 50 km apart, first/last point
     > 100 km from ADEP/ADES, altitude z-score > 2.2 (rows), shortest
     sequences z < -1.4, duplicate timestamps; the average length forced even,
  4. uniform-time resampling to that length, and GMM(5) clusters (seed 199,
     StandardScaler) of the flights resampled to <= 1000 points of
     projected latitude/longitude.

Three faults of the JAX module are not copied:
  - its ``resample_flight`` divides the timestamps' int64 by 1e9, which
    assumes nanoseconds; pandas 3 parses them in microseconds, so its
    timedelta channel comes out 1000x too small. The port holds
    ``datetime64[ns]`` and works in float64 seconds;
  - its ``assign_flight_ids`` counts 6-h gaps over the whole time-sorted
    table, so one aircraft's gap splits every other aircraft's flight in the
    air at that moment. The port applies the rule within each key;
  - its ``prepare_trajectories`` lists the ids before dropping flights of
    fewer than 2 points, so they can fall out of step with ``X``. The
    port's ids are ``X``'s.

Clustering features use a local equirectangular projection instead of the
reference's EuroPP (cartopy), as the JAX module does. Airport coordinates
come from the built-in table, an explicit override, or
``traffic.data.airports`` when ``traffic`` is installed.
"""

import glob
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tvqvae_tpu_torch.data.table import (
    Table,
    concat,
    dropna,
    duplicated,
    group_first,
    group_last,
    inner_join,
    parse_day_month_year,
    parse_iso8601,
    read_csv,
    sort_rows,
    table_len,
    take,
    to_float,
    to_ids,
)

# Public coordinates of commonly used airports (lat, lon); extend via CLI
# --adep_latlon/--ades_latlon or the optional `traffic` database.
AIRPORTS: Dict[str, Tuple[float, float]] = {
    "EHAM": (52.3086, 4.7639),   # Amsterdam Schiphol
    "LIMC": (45.6306, 8.7281),   # Milan Malpensa
    "ENGM": (60.1939, 11.1004),  # Oslo Gardermoen
    "EGLL": (51.4706, -0.4619),  # London Heathrow
    "EGKK": (51.1481, -0.1903),  # London Gatwick
    "LFPG": (49.0097, 2.5479),   # Paris CDG
    "LFPO": (48.7233, 2.3794),   # Paris Orly
    "LOWW": (48.1103, 16.5697),  # Vienna
    "EDDF": (50.0379, 8.5622),   # Frankfurt
    "EDDM": (48.3538, 11.7861),  # Munich
    "LEMD": (40.4719, -3.5626),  # Madrid
    "LEBL": (41.2971, 2.0785),   # Barcelona
    "LIRF": (41.8003, 12.2389),  # Rome Fiumicino
    "EKCH": (55.6179, 12.6560),  # Copenhagen
    "ESSA": (59.6519, 17.9186),  # Stockholm Arlanda
    "LSZH": (47.4647, 8.5492),   # Zurich
    "EBBR": (50.9014, 4.4844),   # Brussels
    "LPPT": (38.7813, -9.1359),  # Lisbon
    "LGAV": (37.9364, 23.9445),  # Athens
    "EIDW": (53.4213, -6.2701),  # Dublin
    "EDDT": (52.5597, 13.2877),  # Berlin Tegel
    "EDDB": (52.3667, 13.5033),  # Berlin Brandenburg
    "LTFM": (41.2753, 28.7519),  # Istanbul
    "UUEE": (55.9726, 37.4146),  # Moscow Sheremetyevo
    "LIML": (45.4494, 9.2783),   # Milan Linate
    "EHRD": (51.9569, 4.4372),   # Rotterdam
}


def airport_latlon(code: str, override: Optional[Tuple[float, float]] = None):
    if override is not None:
        return tuple(override)
    if code in AIRPORTS:
        return AIRPORTS[code]
    try:  # traffic's airport database, when installed
        from traffic.data import airports as _airports

        return tuple(_airports[code].latlon)
    except Exception:
        raise KeyError(
            f"Unknown airport {code}: pass --adep_latlon/--ades_latlon "
            f"or install the `traffic` library."
        )


def haversine_np(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle distance in km (vectorized)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 6371.0 * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def flights_with_large_consecutive_distance(t: Table, threshold_km: float) -> np.ndarray:
    """Flights with any jump of more than ``threshold_km`` between
    consecutive points in time (reference data_utils.py:195-222)."""
    s = sort_rows(t, ["flight_id", "timestamp"])
    fid = s["flight_id"]
    d = haversine_np(s["latitude"][:-1], s["longitude"][:-1],
                     s["latitude"][1:], s["longitude"][1:])
    return np.unique(fid[:-1][(fid[1:] == fid[:-1]) & (d > threshold_km)])


def flights_far_from(t: Table, latlon: Tuple[float, float], threshold_km: float,
                     which: str) -> np.ndarray:
    """Flights whose first (``which="first"``) or last row, in table order,
    lies more than ``threshold_km`` from ``latlon`` (reference
    data_utils.py:224-259)."""
    ids, rows = (group_first if which == "first" else group_last)(t["flight_id"])
    d = haversine_np(t["latitude"][rows], t["longitude"][rows], latlon[0], latlon[1])
    return ids[d > threshold_km]


# --------------------------------------------------------------------------
# flight-id assignment + outlier removal


def assign_flight_ids(t: Table, window_hours: float = 6.0) -> Table:
    """``flight_id`` = icao24_callsign_<first timestamp %Y%m%d_%H%M%S>, a new
    flight after a gap of more than ``window_hours`` between consecutive
    points of the same (icao24, callsign) (reference preprocess.py:186-210).
    The rows come back sorted by time."""
    t = sort_rows(t, ["timestamp"])
    n = table_len(t)
    key = np.char.add(np.char.add(t["icao24"].astype(str), "_"), t["callsign"].astype(str))
    keys, code = np.unique(key, return_inverse=True)
    order = np.lexsort((t["timestamp"], code))  # by key, then time
    code, ts = code[order], t["timestamp"][order]
    new = np.ones(n, bool)
    new[1:] = (code[1:] != code[:-1]) | (
        np.diff(ts.astype("datetime64[ns]").astype(np.int64)) / 1e9 / 3600.0 > window_hours)
    starts = np.flatnonzero(new)
    stamp = np.datetime_as_string(ts[starts], unit="s")
    stamp = np.char.replace(np.char.replace(np.char.replace(stamp, "-", ""), ":", ""), "T", "_")
    names = np.char.add(np.char.add(keys[code[starts]], "_"), stamp)
    t["flight_id"] = np.empty(n, names.dtype)
    t["flight_id"][order] = names[np.cumsum(new) - 1]
    return t


def remove_outliers(
    t: Table,
    adep_latlon: Optional[Tuple[float, float]],
    ades_latlon: Tuple[float, float],
    consecutive_km: float = 50.0,
    airport_km: float = 100.0,
    altitude_z: float = 2.2,
    short_seq_z: float = -1.4,
) -> Tuple[Table, int]:
    """Reference preprocess.py:213-355 (en-route) / preprocess_landing.py:
    91-204 (``adep_latlon=None`` skips the initial-distance rule), in the JAX
    module's order: the drop sets on the full table; the altitude z-score
    drops rows; then the flights in the drop sets; the average length over
    what is left; then the short sequences and the flights with a repeated
    timestamp. -> (the points left, the average length forced even)."""
    from scipy.stats import zscore

    # the same steps on integer flight codes (sorted as the ids): one sort of
    # the id text in all; rows are kept or dropped through one mask
    ids, code = np.unique(t["flight_id"], return_inverse=True)
    coded = {**t, "flight_id": code}
    drop = flights_with_large_consecutive_distance(coded, consecutive_km)
    if adep_latlon is not None:
        drop = np.union1d(drop, flights_far_from(coded, adep_latlon, airport_km, "first"))
    drop = np.union1d(drop, flights_far_from(coded, ades_latlon, airport_km, "last"))

    keep = (np.abs(zscore(t["altitude"])) <= altitude_z) & ~np.isin(code, drop)

    sizes = np.bincount(code[keep], minlength=len(ids))
    present = np.flatnonzero(sizes)
    avg_len = float(sizes[present].mean())
    keep &= ~np.isin(code, present[zscore(sizes[present]) < short_seq_z])

    kept = {"flight_id": code[keep], "timestamp": t["timestamp"][keep]}
    keep &= ~np.isin(code, kept["flight_id"][duplicated(kept, ["flight_id", "timestamp"],
                                                         keep=False)])
    t = take(t, keep)

    avg = int(avg_len)
    if avg % 2:
        avg -= 1  # even length for the spectral transform (reference :100-105)
    return t, avg


# --------------------------------------------------------------------------
# loaders


def _timed(report: Optional[dict], name: str, t0: float) -> float:
    """Record the seconds since ``t0`` under ``name``; -> now."""
    now = time.perf_counter()
    if report is not None:
        report[name] = now - t0
    return now


def _first_file(directory: str, pattern: str) -> str:
    return sorted(glob.glob(os.path.join(directory, pattern)))[0]


def load_eurocontrol(base_path: str, adep: str, ades: str) -> Tuple[Table, int]:
    """EuroControl monthly directories ``20YYMM/``: ``Flights_*.csv`` joined
    with ``Flight_Points_Actual_*.csv`` on ``ECTRL ID`` (reference
    preprocess.py:21-127). Flights with a repeated ``Time Over`` are dropped.
    -> (points with ``flight_id`` = ``ECTRL ID``, timestamp, latitude,
    longitude, altitude in feet; the mean points per flight, forced even)."""
    frames = []
    for directory in sorted(glob.glob(os.path.join(base_path, "20????"))):
        flights = read_csv(_first_file(directory, "Flights_*.csv"))
        points = read_csv(_first_file(directory, "Flight_Points_Actual_*.csv"))
        flights["ECTRL ID"] = to_ids(flights["ECTRL ID"])
        points["ECTRL ID"] = to_ids(points["ECTRL ID"])
        sel = take(flights, (flights["ADEP"] == adep) & (flights["ADES"] == ades))
        pts = take(points, np.isin(points["ECTRL ID"], sel["ECTRL ID"]))
        pts = inner_join(pts, {k: sel[k] for k in ("ECTRL ID", "ADEP", "ADES", "AC Type")},
                         on="ECTRL ID")
        if table_len(pts):
            frames.append(pts)
    t = concat(frames)

    repeated = t["ECTRL ID"][duplicated(t, ["ECTRL ID", "Time Over"])]
    t = take(t, ~np.isin(t["ECTRL ID"], repeated))
    avg = int(np.unique(t["ECTRL ID"], return_counts=True)[1].mean())
    if avg % 2:
        avg -= 1

    t["flight_id"] = t["ECTRL ID"]
    t["callsign"] = t["ECTRL ID"]
    t["icao24"] = t["ECTRL ID"]
    t["latitude"] = to_float(t.pop("Latitude"))
    t["longitude"] = to_float(t.pop("Longitude"))
    t["altitude"] = to_float(t.pop("Flight Level")) * 100.0  # flight level -> feet
    t["timestamp"] = parse_day_month_year(t.pop("Time Over"))
    t.pop("ECTRL ID")
    t.pop("Sequence Number", None)
    return t, avg


def load_opensky(
    base_path: str, adep: str, ades: str, adep_latlon=None, ades_latlon=None,
    report: Optional[dict] = None,
) -> Tuple[Table, int]:
    """OpenSky CSV export (reference preprocess.py:358-416): the first
    ``*.csv`` under ``base_path`` whose name holds both airports; rows with a
    missing field or a negative altitude dropped, flight ids assigned,
    outliers removed. ``report``, where given, gets the seconds of the
    stages (``parse``, ``ids``, ``outliers``) and the rows read."""
    files = [f for f in sorted(glob.glob(os.path.join(base_path, "*.csv")))
             if adep in os.path.basename(f) and ades in os.path.basename(f)]
    if not files:
        raise FileNotFoundError(f"no OpenSky csv for {adep}->{ades} under {base_path}")
    t0 = time.perf_counter()
    t = read_csv(files[0])
    if report is not None:
        report["rows"] = table_len(t)
    t.pop("Unnamed: 0", None)
    t = dropna(t)
    for c in ("latitude", "longitude", "altitude"):
        t[c] = to_float(t[c])
    t = take(t, t["altitude"] >= 0)
    for old, new in (("estdepartureairport", "ADEP"), ("estarrivalairport", "ADES")):
        if old in t:
            t[new] = t.pop(old)
    t["timestamp"] = parse_iso8601(t["timestamp"])
    t0 = _timed(report, "parse", t0)
    t = assign_flight_ids(t, window_hours=6)
    t0 = _timed(report, "ids", t0)
    t, avg = remove_outliers(t, airport_latlon(adep, adep_latlon),
                             airport_latlon(ades, ades_latlon))
    _timed(report, "outliers", t0)
    return t, avg


# --------------------------------------------------------------------------
# trajectory preparation


def _local_xy(lat: np.ndarray, lon: np.ndarray, lat0: float, lon0: float):
    """Local equirectangular projection (km) around (lat0, lon0): the EuroPP
    stand-in for clustering features (scale-equivalent after the scaler)."""
    R = 6371.0
    x = np.radians(lon - lon0) * R * np.cos(np.radians(lat0))
    y = np.radians(lat - lat0) * R
    return x, y


def _seconds(ts: np.ndarray) -> np.ndarray:
    """``datetime64[ns]`` differences from the first stamp, in float64 s."""
    ns = ts.astype("datetime64[ns]").astype(np.int64)
    return (ns - ns[0]) / 1e9


def resample_flight(flight: Table, n_samples: int, columns: List[str]) -> Table:
    """Uniform-in-time linear resampling of one flight's ``columns`` (the
    reference's traffic ``.resample(n)``, preprocess.py:476-478), in float64
    seconds from the first stamp. -> timestamp, the columns and
    ``timedelta`` (seconds), ``n_samples`` rows each."""
    t = _seconds(flight["timestamp"])
    tq = np.linspace(t[0], t[-1], n_samples)
    out = {"timestamp": flight["timestamp"][0].astype("datetime64[ns]")
           + (tq * 1e9).astype(np.int64).astype("timedelta64[ns]")}
    for c in columns:
        out[c] = np.interp(tq, t, flight[c].astype(np.float64))
    out["timedelta"] = tq - tq[0]
    return out


def prepare_trajectories(
    t: Table,
    n_samples: int,
    n_clusters: int = 5,
    cluster_seed: int = 199,
    columns: Optional[List[str]] = None,
    device="cuda",
    report: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, List]:
    """Resampling and GMM clustering (reference preprocess.py:435-479).
    Flights are taken in sorted id order, points in time order; flights of
    fewer than 2 points are dropped. The features of the clustering are the
    flights resampled to ``min(n_samples, 1000)`` points of projected
    (latitude, longitude), interleaved, standardised, and clustered by
    ``GaussianMixture(n_clusters, random_state=cluster_seed)`` on
    ``device``. ``report``, where given, gets the seconds of the stages
    (``resample``, ``features``, ``kmeans``, ``em``), the EM iterations and
    the lower bound. -> (X (N, 4, n_samples) float32 with channels latitude,
    longitude, altitude, timedelta; labels (N,) int64; the N flight ids)."""
    from tvqvae_tpu_torch.data.mixture import GaussianMixture, StandardScaler

    columns = columns or ["latitude", "longitude", "altitude"]
    t0 = time.perf_counter()
    lat0 = float(t["latitude"].mean())
    lon0 = float(t["longitude"].mean())
    t = sort_rows(t, ["flight_id", "timestamp"])
    ids, starts, counts = np.unique(t["flight_id"], return_index=True, return_counts=True)
    keep = counts >= 2
    flights = [take(t, slice(s, s + c)) for s, c in zip(starts[keep], counts[keep])]

    feats = ["latitude", "longitude", "altitude", "timedelta"]
    X = np.empty((len(flights), len(feats), n_samples), np.float32)
    for i, f in enumerate(flights):
        r = resample_flight(f, n_samples, columns)
        X[i] = np.stack([r[c] for c in feats])
    t0 = _timed(report, "resample", t0)

    nb = n_samples if n_samples < 1000 else 1000
    F = np.empty((len(flights), 2 * nb))
    for i, f in enumerate(flights):
        r = resample_flight(f, nb, ["latitude", "longitude"])
        x, y = _local_xy(r["latitude"], r["longitude"], lat0, lon0)
        F[i, 0::2], F[i, 1::2] = y, x
    _timed(report, "features", t0)

    gmm = GaussianMixture(n_components=n_clusters, random_state=cluster_seed, device=device)
    labels = gmm.fit_predict(StandardScaler(device=device).fit_transform(F))
    if report is not None:
        report.update(kmeans=gmm.seconds_["kmeans"], em=gmm.seconds_["em"],
                      em_iterations=gmm.n_iter_, lower_bound=gmm.lower_bound_)
    return X, labels, list(ids[keep])


def export_dataset(
    path_base: str,
    X: np.ndarray,
    labels: np.ndarray,
    ids: List,
    features=("latitude", "longitude", "altitude", "timedelta"),
) -> str:
    """Write ``path_base.npz`` (X float32, y); also a Traffic pickle where
    pandas and ``traffic`` import."""
    npz_path = path_base + ".npz"
    np.savez_compressed(npz_path, X=X.astype(np.float32), y=labels)
    try:
        from traffic.core import Traffic
        import pandas as pd
    except ImportError:
        return npz_path
    frames = []
    t0 = pd.Timestamp("2020-01-01", tz="utc")
    td = list(features).index("timedelta")
    for i in range(X.shape[0]):
        f = pd.DataFrame({c: X[i, j] for j, c in enumerate(features)})
        f["timestamp"] = t0 + pd.to_timedelta(X[i, td], unit="s")
        f["flight_id"] = str(ids[i])
        f["callsign"] = str(ids[i])
        f["icao24"] = str(ids[i])
        f["cluster"] = int(labels[i])
        frames.append(f)
    Traffic(pd.concat(frames)).to_pickle(path_base + ".pkl")
    return npz_path
