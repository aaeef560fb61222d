"""Data preparation: the port (``tvqvae_tpu_torch/data/preprocess.py``,
``data/table.py`` and the two CLIs) against the JAX package, on the CPU.

- Both packages' CLIs run in the process on CSVs built here: OpenSky
  corridors, EuroControl ``20YYMM/`` directories, a chunked landing file.
  ``y`` is held exactly; latitude, longitude and altitude within one
  float32 ulp (the two resample on time axes of different units); the
  timedelta channel to JAX's value times the factor read from the unit of
  JAX's parsed timestamps (pandas 3 parses microseconds, and JAX divides by
  1e9 as if they were nanoseconds).
- Per function, on data where JAX's global gap counter does not fire: flight
  ids, the outlier sets, ``avg_len`` and the group order equal JAX's.
- The three faults of the JAX module, each beside JAX's result: the time
  unit of ``resample_flight``, the global gap counter of
  ``assign_flight_ids``, and ids out of step with ``X`` in
  ``prepare_trajectories``.
- The table helpers against pandas: missing fields, ``duplicated``, the inner
  merge, chunks, and the two timestamp formats.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from test_preprocess import _synthetic_route_df
from tvqvae_tpu.data import preprocess as jpre
from tvqvae_tpu.scripts import preprocess as jcli
from tvqvae_tpu.scripts import preprocess_landing as jlanding
from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.data import preprocess as pre
from tvqvae_tpu_torch.data import table as tb
from tvqvae_tpu_torch.scripts import preprocess as cli
from tvqvae_tpu_torch.scripts import preprocess_landing as landing

FEATURES = ["latitude", "longitude", "altitude", "timedelta"]
EHAM, LIMC, ENGM = pre.AIRPORTS["EHAM"], pre.AIRPORTS["LIMC"], pre.AIRPORTS["ENGM"]
T0 = pd.Timestamp("2021-06-01", tz="utc")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one thread is as fast, and the suite's parallel workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ns_per_unit(timestamps: pd.Series) -> float:
    """What JAX's ``/ 1e9`` is off by: nanoseconds per unit of the parsed
    timestamps (1000 for pandas 3's microseconds, 1 for nanoseconds)."""
    return np.timedelta64(1, timestamps.dt.unit) / np.timedelta64(1, "ns")


def _corridor_points(rng, c, n_pts, start, dest=LIMC, origin=EHAM, duration=5400.0):
    """One flight on corridor ``c`` (a sideways bend of (c - 1) * 1.2 deg),
    jittered whole-second stamps from ``start`` (seconds after T0)."""
    t = np.linspace(0, 1, n_pts)
    t[1:-1] += rng.uniform(-0.3, 0.3, n_pts - 2) / n_pts
    lat = origin[0] + (dest[0] - origin[0]) * t + rng.normal(0, 0.02, n_pts)
    lon = (origin[1] + (dest[1] - origin[1]) * t + (c - 1) * 1.2 * np.sin(np.pi * t)
           + rng.normal(0, 0.02, n_pts))
    lat[0], lon[0] = origin
    lat[-1], lon[-1] = dest
    alt = 300 + 35000 * np.sin(np.pi * t) + rng.normal(0, 100, n_pts)
    secs = start + np.round(t * duration)
    return secs, lat, lon, alt


def _opensky_frame(seed=0, n_corridors=3, per_corridor=6):
    """Corridor flights of distinct aircraft, overlapping in time, plus the
    cases the filters catch: a 300-km jump, a flight ending far from LIMC, a
    short flight, a flight with a repeated stamp, a row with a missing field
    and a row below ground."""
    rng = np.random.default_rng(seed)
    frames = []
    n = n_corridors * per_corridor
    for i in range(n + 4):
        c = i % n_corridors if i != n + 2 else 1
        n_pts = int(rng.integers(39, 42)) if i != n + 2 else 26
        secs, lat, lon, alt = _corridor_points(rng, c, n_pts, start=i * 1700.0)
        if i == n:
            lat[n_pts // 2] += 3.0  # a jump
        if i == n + 1:
            lat[-1] += 2.0  # ends ~220 km from LIMC
        if i == n + 3:
            secs[5] = secs[4]  # a repeated timestamp
        frames.append(pd.DataFrame({
            "timestamp": T0 + pd.to_timedelta(secs, unit="s"), "icao24": f"4b{i:04x}",
            "latitude": lat, "longitude": lon, "altitude": alt, "callsign": f"KLM{i:03d}",
            "estdepartureairport": "EHAM", "estarrivalairport": "LIMC"}))
    df = pd.concat(frames, ignore_index=True).sample(frac=1.0, random_state=1)
    df.iloc[3, df.columns.get_loc("callsign")] = None
    df.iloc[7, df.columns.get_loc("altitude")] = -50.0
    return df.reset_index(drop=True)


def _write_opensky(tmp_path, df):
    raw = tmp_path / "raw" / "OpenSky"
    raw.mkdir(parents=True)
    df.to_csv(raw / "opensky_EHAM_LIMC_2021.csv")  # with the unnamed index column
    return str(tmp_path / "raw")


def _assert_X(port, ref, factor):
    """lat/lon/alt within one float32 ulp; the timedelta to JAX's times
    ``factor`` within two float32 ulps (each side rounded once)."""
    assert port.shape == ref.shape
    np.testing.assert_array_max_ulp(port[:, :3], ref[:, :3], maxulp=1)
    np.testing.assert_allclose(port[:, 3].astype(np.float64), ref[:, 3].astype(np.float64)
                               * factor, rtol=2 * 2.0 ** -23, atol=0)


def _run_both(main_port, main_jax, argv, out_name):
    jdir, pdir = argv["save"] + "_jax", argv["save"] + "_port"
    main_jax(argv["args"] + ["--save_dir", jdir])
    got = main_port(argv["args"] + ["--save_dir", pdir, "--device", "cpu"])
    ref = np.load(os.path.join(jdir, out_name))
    out = np.load(os.path.join(pdir, out_name))
    return got, ref, out, os.path.join(pdir, out_name)


def test_opensky_cli_matches_jax(tmp_path):
    df = _opensky_frame()
    raw = _write_opensky(tmp_path, df)
    unit = _ns_per_unit(pd.to_datetime(pd.read_csv(
        os.path.join(raw, "OpenSky", "opensky_EHAM_LIMC_2021.csv"))["timestamp"], utc=True,
        format="ISO8601"))
    args = ["--ADEP", "EHAM", "--ADES", "LIMC", "--raw_data_dir", raw,
            "--data_source", "OpenSky", "--n_clusters", "3"]
    got, ref, out, path = _run_both(cli.main, jcli.main, {"args": args,
                                                          "save": str(tmp_path / "data")},
                                    "OpenSky_EHAM_LIMC.npz")
    assert out["X"].shape == (18, 4, got["shape"][2]) and out["X"].shape[2] % 2 == 0
    np.testing.assert_array_equal(out["y"], ref["y"])
    assert len(np.unique(out["y"])) == 3
    _assert_X(out["X"], ref["X"], unit)
    # the clusters are the corridors: the same partition as i % 3
    corridor = np.array([int(i.split("_")[0][2:], 16) % 3 for i in got["flights"]])
    assert len(set(zip(corridor, out["y"]))) == 3
    # the timedelta ends at each flight's duration, in seconds
    ends = df.groupby("icao24")["timestamp"].agg(lambda s: (s.max() - s.min()).total_seconds())
    want = np.array([ends[i.split("_")[0]] for i in got["flights"]])
    np.testing.assert_allclose(out["X"][:, 3, -1], want, rtol=2.0 ** -23)
    data = get_data(path, FEATURES)
    assert data.X_train.shape[1:] == (4, out["X"].shape[2])


def _eurocontrol(tmp_path, seed=0):
    """Two monthly directories of EuroControl-like files: corridor flights
    EHAM->LIMC whose ids sort differently as numbers and as text, flights on
    another route, and one flight with a repeated ``Time Over``."""
    rng = np.random.default_rng(seed)
    base = tmp_path / "raw" / "EuroControl"
    fid = iter([99001, 99002, 100003, 99004, 100005, 99006, 1000007, 99008, 100009, 99010,
                100011, 99012, 100013, 99014, 100015, 99016])
    for month, day0 in (("202106", 0), ("202107", 30)):
        d = base / month
        d.mkdir(parents=True)
        flights, points = [], []
        for i in range(8):
            ectrl = next(fid)
            route = ("EHAM", "LIMC") if i < 7 else ("EGLL", "LIMC")
            flights.append({"ECTRL ID": ectrl, "ADEP": route[0], "ADES": route[1],
                            "AC Type": "A320", "Requested FL": 350})
            secs, lat, lon, alt = _corridor_points(rng, i % 2, int(rng.integers(30, 38)),
                                                   start=(day0 + i) * 86400.0 + 3600.0)
            stamps = (T0 + pd.to_timedelta(secs, unit="s")).strftime("%d-%m-%Y %H:%M:%S")
            if i == 3 and month == "202107":
                stamps = stamps.tolist()
                stamps[6] = stamps[5]
            for k in range(len(secs)):
                points.append({"ECTRL ID": ectrl, "Sequence Number": k + 1,
                               "Time Over": stamps[k], "Flight Level": alt[k] / 100.0,
                               "Latitude": lat[k], "Longitude": lon[k]})
        flights = pd.DataFrame(flights).sample(frac=1.0, random_state=2)
        flights.to_csv(d / f"Flights_{month}01_{month}31.csv", index=False)
        pd.DataFrame(points).to_csv(d / f"Flight_Points_Actual_{month}01_{month}31.csv",
                                    index=False)
    return str(tmp_path / "raw")


def test_eurocontrol_cli_matches_jax(tmp_path):
    raw = _eurocontrol(tmp_path)
    unit = _ns_per_unit(pd.to_datetime(pd.Series(["01-06-2021 10:00:00"]),
                                       format="%d-%m-%Y %H:%M:%S", utc=True))
    args = ["--ADEP", "EHAM", "--ADES", "LIMC", "--raw_data_dir", raw,
            "--data_source", "EuroControl", "--n_clusters", "2"]
    got, ref, out, path = _run_both(cli.main, jcli.main, {"args": args,
                                                          "save": str(tmp_path / "data")},
                                    "EuroControl_EHAM_LIMC.npz")
    np.testing.assert_array_equal(out["y"], ref["y"])
    _assert_X(out["X"], ref["X"], unit)
    # numeric ids in numeric order, the repeated-time flight and the other
    # route gone
    ids = got["flights"]
    assert ids == sorted(ids) and 99001 in ids and 1000007 in ids
    assert len(ids) == len(out["X"]) and not {99012, 99008, 99016} & set(ids)
    assert get_data(path, FEATURES).X_train.shape[1] == 4


def test_landing_cli_matches_jax_over_chunks(tmp_path):
    """Chunks of 100 rows cut flights in two: each piece gets its own id in
    its chunk, in both packages."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(10):
        start = (ENGM[0] - 2.0 * np.cos(i % 2), ENGM[1] - 2.5 * np.sin(1 + i % 2))
        secs, lat, lon, alt = _corridor_points(rng, 1, 60, start=i * 86400.0, dest=ENGM,
                                               origin=start, duration=2400.0)
        alt = np.clip(20000 * (1 - np.linspace(0, 1, 60)) ** 1.5 + rng.normal(0, 50, 60), 0,
                      None)
        rows.append(pd.DataFrame({"timestamp": T0 + pd.to_timedelta(secs, unit="s"),
                                  "latitude": lat, "longitude": lon, "altitude": alt,
                                  "icao24": f"cd{i:04d}", "callsign": f"SAS{i:03d}"}))
    raw = tmp_path / "raw" / "landing"
    raw.mkdir(parents=True)
    pd.concat(rows).to_csv(raw / "landing_ENGM_2021.csv", index=False)
    args = ["--ADES", "ENGM", "--raw_data_dir", str(tmp_path / "raw"), "--n_clusters", "2",
            "--chunk_size", "100"]
    got, ref, out, path = _run_both(landing.main, jlanding.main,
                                    {"args": args, "save": str(tmp_path / "data")},
                                    "landing_ENGM.npz")
    np.testing.assert_array_equal(out["y"], ref["y"])
    _assert_X(out["X"], ref["X"], 1000.0)
    assert out["X"].shape[0] >= 6 and got["load"] >= 0
    assert get_data(path, FEATURES).X_train.shape[1] == 4


# ---------------------------------------------------------------------------
# per function, on pandas frames turned into the port's tables


def _table(df: pd.DataFrame) -> tb.Table:
    out = {}
    for c in df.columns:
        v = df[c]
        if c == "timestamp":
            out[c] = v.dt.tz_convert(None).to_numpy().astype("datetime64[ns]")
        elif pd.api.types.is_numeric_dtype(v):
            out[c] = v.to_numpy()
        else:
            out[c] = v.to_numpy().astype(str)
    return out


def _ids_frame():
    """Aircraft flying twice (a 9-h gap), never while another flight is in
    the air at that moment, so the JAX counter splits nothing else."""
    base = pd.Timestamp("2021-06-01", tz="utc")
    rows = []
    for icao, cs, starts in (("a1", "X1", [0, 9]), ("b2", "Y2", [2.5]), ("c3", "Z3", [20]),
                             ("a1", "W9", [13])):
        for h in starts:
            for m in range(0, 120, 20):
                rows.append({"timestamp": base + pd.Timedelta(hours=h, minutes=m),
                             "icao24": icao, "callsign": cs})
    return pd.DataFrame(rows).sample(frac=1.0, random_state=0).reset_index(drop=True)


def test_assign_flight_ids_matches_jax_without_the_global_counter():
    df = _ids_frame()
    ref = jpre.assign_flight_ids(df)
    got = pre.assign_flight_ids(_table(df))
    np.testing.assert_array_equal(got["timestamp"], _table(ref)["timestamp"])
    key = lambda t: sorted(zip(t["timestamp"].tolist(), t["icao24"].tolist(),  # noqa: E731
                               t["flight_id"].tolist()))
    assert key(got) == key(_table(ref))
    assert len(np.unique(got["flight_id"])) == 5


@pytest.fixture(scope="module")
def route():
    df = jpre.assign_flight_ids(_synthetic_route_df(n_flights=9, seed=3, jump_flight=4))
    return df, _table(df)


def test_outlier_sets_match_jax(route):
    df, t = route
    np.testing.assert_array_equal(
        pre.flights_with_large_consecutive_distance(t, 50.0),
        np.sort(jpre.flights_with_large_consecutive_distance(df, 50.0)))
    for which, ll in (("first", EHAM), ("last", LIMC)):
        for km in (100.0, 1.0):
            np.testing.assert_array_equal(pre.flights_far_from(t, ll, km, which),
                                          np.asarray(jpre.flights_far_from(df, ll, km, which)))


@pytest.mark.parametrize("adep", [True, False], ids=["enroute", "landing"])
def test_remove_outliers_matches_jax(route, adep):
    df, t = route
    df = df.copy()
    df.loc[df.index[-1], "altitude"] = 1e6  # an altitude row outlier
    df = pd.concat([df, df[df["flight_id"] == df["flight_id"].iloc[0]].iloc[:2]])  # repeats
    short = df[df["flight_id"] == df["flight_id"].iloc[-1]]
    df = df.drop(short.index[:25])  # a short flight
    kw = dict(adep_latlon=EHAM if adep else None, ades_latlon=LIMC,
              airport_km=100.0 if adep else 10.0, short_seq_z=-1.4 if adep else -1.0)
    ref, ref_avg = jpre.remove_outliers(df.reset_index(drop=True), **kw)
    got, avg = pre.remove_outliers(_table(df.reset_index(drop=True)), **kw)
    assert avg == ref_avg and avg % 2 == 0
    want = _table(ref)
    for c in ("flight_id", "timestamp", "latitude", "altitude"):
        np.testing.assert_array_equal(got[c], want[c])
    assert len(np.unique(got["flight_id"])) < len(np.unique(t["flight_id"]))


def test_prepare_trajectories_group_order_and_x_match_jax(route):
    df, t = route
    X_ref, y_ref, ids_ref = jpre.prepare_trajectories(df, 32, n_clusters=3)
    X, y, ids = pre.prepare_trajectories(t, 32, n_clusters=3, device="cpu")
    assert list(ids) == list(ids_ref) == sorted(ids)
    np.testing.assert_array_equal(y, y_ref)
    _assert_X(X, X_ref, _ns_per_unit(df["timestamp"]))


def test_resample_matches_jax_on_nanosecond_stamps():
    """Where JAX's unit assumption holds (datetime64[ns]), the port gives its
    numbers; whole-second stamps, which JAX's float64 epoch nanoseconds hold
    exactly."""
    df = jpre.assign_flight_ids(_synthetic_route_df(n_flights=1, n_pts=30, seed=5))
    df["timestamp"] = df["timestamp"].dt.round("1s").astype("datetime64[ns, UTC]")
    assert _ns_per_unit(df["timestamp"]) == 1.0
    cols = ["latitude", "longitude", "altitude"]
    ref = jpre.resample_flight(df, 50, cols)
    got = pre.resample_flight(_table(df), 50, cols)
    for c in cols + ["timedelta"]:
        np.testing.assert_array_equal(got[c], ref[c].to_numpy())
    np.testing.assert_array_equal(got["timestamp"], _table(ref)["timestamp"])


# ---------------------------------------------------------------------------
# the three faults of the JAX module, each beside JAX's result


def test_fault_time_unit_one_hour_flight_ends_at_3600_seconds():
    stamps = pd.Series(pd.date_range("2021-06-01 10:00", periods=61, freq="60s", tz="utc")
                       .strftime("%Y-%m-%d %H:%M:%S+00:00"))
    df = pd.DataFrame({"timestamp": pd.to_datetime(stamps, utc=True, format="ISO8601"),
                       "latitude": np.linspace(50, 51, 61), "longitude": np.linspace(4, 5, 61),
                       "altitude": np.full(61, 3e4)})
    factor = _ns_per_unit(df["timestamp"])
    ref = jpre.resample_flight(df, 11, ["latitude"])
    got = pre.resample_flight({**_table(df), "timestamp": tb.parse_iso8601(
        stamps.to_numpy().astype(str))}, 11, ["latitude"])
    assert got["timedelta"][-1] == 3600.0
    np.testing.assert_allclose(got["timedelta"], np.linspace(0, 3600, 11))
    assert ref["timedelta"].iloc[-1] == pytest.approx(3600.0 / factor)
    assert factor == 1000.0  # pandas 3: JAX's channel ends at 3.6 "seconds"
    np.testing.assert_allclose(got["latitude"], ref["latitude"].to_numpy(), rtol=1e-15)


def test_fault_global_gap_counter_splits_other_aircraft():
    d = "2021-06-01 "
    df = pd.DataFrame({
        "timestamp": pd.to_datetime([d + h for h in ("10:00", "10:30", "11:00", "11:30",
                                                     "12:00", "00:00", "11:12")], utc=True),
        "icao24": ["A"] * 5 + ["B"] * 2, "callsign": ["CS1"] * 5 + ["CS2"] * 2})
    ref = jpre.assign_flight_ids(df)
    got = pre.assign_flight_ids(_table(df))
    jax_a = sorted(set(ref.loc[ref["icao24"] == "A", "flight_id"]))
    port_a = sorted(set(got["flight_id"][got["icao24"] == "A"]))
    assert jax_a == ["A_CS1_20210601_100000", "A_CS1_20210601_113000"]
    assert port_a == ["A_CS1_20210601_100000"]
    assert sorted(set(got["flight_id"][got["icao24"] == "B"])) == [
        "B_CS2_20210601_000000", "B_CS2_20210601_111200"]


def test_fault_ids_out_of_step_with_x():
    df = jpre.assign_flight_ids(_synthetic_route_df(n_flights=6, n_pts=20, seed=1))
    lone = df.iloc[:1].copy()
    lone["flight_id"] = "AAA_one_point"  # sorts first
    df = pd.concat([df, lone], ignore_index=True)
    X_ref, _, ids_ref = jpre.prepare_trajectories(df, 16, n_clusters=2)
    X, _, ids = pre.prepare_trajectories(_table(df), 16, n_clusters=2, device="cpu")
    assert len(ids_ref) == len(X_ref) + 1 and ids_ref[0] == "AAA_one_point"
    assert len(ids) == len(X) == len(X_ref) and "AAA_one_point" not in ids
    t = _table(df)
    for i in (0, len(ids) - 1):  # row i of X is flight ids[i]
        f = tb.take(t, t["flight_id"] == ids[i])
        np.testing.assert_array_equal(X[i, 0], pre.resample_flight(
            tb.sort_rows(f, ["timestamp"]), 16, ["latitude"])["latitude"].astype(np.float32))


# ---------------------------------------------------------------------------
# the table helpers against pandas


def test_read_csv_missing_fields_and_chunks_match_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b,c\n1,x,2.5\n,y,3\n2,NA,4\n3,z,nan\n4,null,5\n5,w,6\n6,v,\n")
    t = tb.read_csv(str(path))
    ref = pd.read_csv(path).dropna()
    np.testing.assert_array_equal(tb.to_float(tb.dropna(t)["a"]), ref["a"].to_numpy())
    np.testing.assert_array_equal(tb.to_float(t["c"]), pd.read_csv(path)["c"].to_numpy())
    chunks = list(tb.read_csv_chunks(str(path), 3))
    assert [tb.table_len(c) for c in chunks] == [len(c) for c in
                                                  pd.read_csv(path, chunksize=3)]
    np.testing.assert_array_equal(tb.concat(chunks)["b"], t["b"])
    (tmp_path / "u.csv").write_text(",x\n0,1\n")
    assert set(tb.read_csv(str(tmp_path / "u.csv"))) == set(pd.read_csv(tmp_path / "u.csv"))


def test_duplicated_and_merge_match_pandas():
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"k": rng.integers(0, 4, 40), "s": rng.choice(["a", "b"], 40),
                       "v": np.arange(40)})
    t = _table(df)
    for keep in ("first", False):
        np.testing.assert_array_equal(tb.duplicated(t, ["k", "s"], keep=keep),
                                      df.duplicated(subset=["k", "s"], keep=keep).to_numpy())
    right = pd.DataFrame({"k": [2, 0, 2, 5], "w": ["p", "q", "r", "s"]})
    ref = df.merge(right, on="k")
    got = tb.inner_join(t, _table(right), on="k")
    for c in ("k", "v", "w"):
        np.testing.assert_array_equal(got[c], ref[c].to_numpy())


def test_timestamp_parsers_match_pandas():
    iso = np.array(["2021-06-01 10:00:00+00:00", "2021-06-01T10:00:00Z",
                    "2021-06-01 12:00:00.250+02:00", "2021-06-01 05:30:00-04:30",
                    "2021-06-01 10:00:01"])
    want = pd.to_datetime(pd.Series(iso), utc=True, format="ISO8601")
    np.testing.assert_array_equal(tb.parse_iso8601(iso),
                                  want.dt.tz_convert(None).to_numpy().astype("datetime64[ns]"))
    dmy = np.array(["01-06-2021 10:00:00", "31-12-2020 23:59:59"])
    want = pd.to_datetime(pd.Series(dmy), format="%d-%m-%Y %H:%M:%S", utc=True)
    np.testing.assert_array_equal(tb.parse_day_month_year(dmy),
                                  want.dt.tz_convert(None).to_numpy().astype("datetime64[ns]"))
    with pytest.raises(ValueError):
        tb.parse_day_month_year(np.array(["2021-06-01 10:00:00"]))
