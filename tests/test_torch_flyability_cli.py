"""The port's BlueSky harness and flyability CLI against the JAX package's,
on the CPU, with the JAX tests' deterministic stub simulator.

The stub (copied from tests/test_flyability.py) parses the master scenario,
replays each flight's waypoints with a fixed offset and writes an
EVALLOG-format log. The JAX side uses pandas; the port's tables are dicts of
numpy columns. Scenario files: byte-equal. Ground speeds, kept rows, parsed
logs and annotated points: equal. The CLIs on the same .npz: the same
simulated flights and points, and per-flight distances within the
tolerances of tests/test_torch_flyability.py (LCSS and EDR exactly, the
discrete Frechet 1e-6, DTW and ERP 1e-5 relative, SSPD, Hausdorff and the
continuous Frechet within 1e-3 relative and against a float64 witness: see
``_check_per_flight``).
"""

import csv
import json
import os
import stat
import textwrap
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tvqvae_tpu.data.preprocess import AIRPORTS as J_AIRPORTS
from tvqvae_tpu.evaluation.flyability import bluesky as JB
from tvqvae_tpu.evaluation.flyability import distances as J
from tvqvae_tpu.scripts import evaluate_flyability as jcli
from tvqvae_tpu_torch.data.preprocess import AIRPORTS, airport_latlon, haversine_np
from tvqvae_tpu_torch.evaluation.flyability import bluesky as B
from tvqvae_tpu_torch.evaluation.flyability import distances as D
from tvqvae_tpu_torch.scripts import evaluate_flyability as cli

STUB = textwrap.dedent(
    """\
    #!/usr/bin/env python3
    # stub bluesky: reads the master .scn, replays DEFWPT waypoints with
    # noise, writes an EVALLOG csv into the logs directory
    import os, re, sys, time

    scen = sys.argv[sys.argv.index("--scenfile") + 1]
    logs_dir = os.environ["STUB_LOGS_DIR"]
    base = os.path.dirname(scen)
    flights = {}
    with open(scen) as f:
        for line in f:
            m = re.search(r">PCALL (.*output_(.*)\\.scn)", line.strip())
            if m:
                flights[m.group(2)] = m.group(1)
    rows = []
    for fid, path in flights.items():
        wpts = []
        with open(path) as f:
            for line in f:
                m = re.search(r">CRE \\S+ \\S+ ([-\\d.]+) ([-\\d.]+)", line)
                if m:
                    wpts.append((float(m.group(1)), float(m.group(2)), 10000.0))
                m = re.search(r">DEFWPT \\S+?,([-\\d.]+), ([-\\d.]+)", line)
                if m:
                    wpts.append((float(m.group(1)), float(m.group(2)), 10000.0))
        for k, (lat, lon, alt) in enumerate(wpts):
            rows.append(f"{k * 10.0},{lat + 0.001},{lon - 0.001},{alt},{fid}")
    os.makedirs(logs_dir, exist_ok=True)
    out = os.path.join(logs_dir, f"EVALLOG_{time.time_ns()}.log")
    with open(out, "w") as f:
        f.write("# stub log\\n")
        f.write("\\n".join(rows) + "\\n")
    """
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_points(n_flights=4, n_pts=25, seed=0, dtype=np.float64):
    """The JAX tests' synthetic EHAM -> LIMC flights, as a pandas frame."""
    rng = np.random.default_rng(seed)
    lat0, lon0 = AIRPORTS["EHAM"]
    lat1, lon1 = AIRPORTS["LIMC"]
    frames = []
    for i in range(n_flights):
        t = np.linspace(0, 1, n_pts)
        lat = lat0 + (lat1 - lat0) * t + rng.normal(0, 0.01, n_pts)
        lon = lon0 + (lon1 - lon0) * t + rng.normal(0, 0.01, n_pts)
        lat[-1], lon[-1] = lat1, lon1
        alt = np.clip(30000 * np.sin(np.pi * t), 0, None)
        ts = pd.Timestamp("2020-01-01", tz="utc") + pd.to_timedelta(t * 5400, unit="s")
        frames.append(pd.DataFrame({
            "flight_id": f"SYN{i:05d}", "timestamp": ts, "latitude": lat.astype(dtype),
            "longitude": lon.astype(dtype), "altitude": alt.astype(dtype),
        }))
    return pd.concat(frames, ignore_index=True)


def _table(df: pd.DataFrame):
    """A pandas points frame as the port's table; its index becomes ROW."""
    t = {}
    for k in df.columns:
        v = df[k]
        if k == "timestamp":
            t[k] = v.dt.tz_convert("UTC").dt.tz_localize(None).to_numpy().astype("datetime64[ns]")
        elif k == "flight_id":
            t[k] = v.astype(str).to_numpy().astype(str)
        else:
            t[k] = v.to_numpy()
    t[B.ROW] = df.index.to_numpy()
    return t


def _assert_same_points(table, df, exact_cols=("latitude", "longitude", "altitude"),
                        parsed=False):
    """Equal rows; ``parsed``: values read back from simulator logs, where
    pandas' default CSV float parser (not correctly rounded) may differ from
    Python's float() by an ulp."""
    assert B.table_len(table) == len(df)
    np.testing.assert_array_equal(table["flight_id"], df["flight_id"].astype(str).to_numpy())
    for k in exact_cols:
        if parsed:
            np.testing.assert_allclose(table[k], df[k].to_numpy(), rtol=4.5e-16, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(table[k], df[k].to_numpy(), err_msg=k)
    ts = df["timestamp"].dt.tz_convert("UTC").dt.tz_localize(None).to_numpy()
    np.testing.assert_array_equal(table["timestamp"], ts.astype("datetime64[ns]"))


@pytest.fixture
def stub_cmd(tmp_path, monkeypatch):
    stub = tmp_path / "bluesky_stub.py"
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    logs_dir = tmp_path / "stub_logs"
    monkeypatch.setenv("STUB_LOGS_DIR", str(logs_dir))
    return f"python3 {stub} --headless --scenfile {{scenfile}}", str(logs_dir)


def test_preprocess_copy_matches_jax():
    assert AIRPORTS == J_AIRPORTS
    assert airport_latlon("EHAM") == AIRPORTS["EHAM"]
    assert airport_latlon("XXXX", (1.0, 2.0)) == (1.0, 2.0)
    with pytest.raises(KeyError):
        airport_latlon("XXXX")
    from tvqvae_tpu.data.preprocess import haversine_np as j_hav

    rng = np.random.default_rng(0)
    a, b = rng.uniform(40, 55, (2, 50)), rng.uniform(0, 10, (2, 50))
    np.testing.assert_array_equal(haversine_np(a[0], b[0], a[1], b[1]),
                                  j_hav(a[0], b[0], a[1], b[1]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_flight_helpers_match_jax(dtype):
    df = _make_points(1, n_pts=100, dtype=dtype)
    t = _table(df)
    _assert_same_points(B.add_ground_speed(t), JB.add_ground_speed(df))
    np.testing.assert_array_equal(B.add_ground_speed(t)["groundspeed"],
                                  JB.add_ground_speed(df)["groundspeed"].to_numpy())
    dup = pd.concat([df.iloc[:1], df, df.iloc[40:41]]).sort_index(kind="stable")
    kept = B.remove_neighbours(_table(dup))
    np.testing.assert_array_equal(kept[B.ROW], JB.remove_neighbours(dup).index.to_numpy())
    for tol in (None, 2000.0, 500.0):
        s, js = B.simplify_track(t, tol), JB.simplify_track(df, tol)
        np.testing.assert_array_equal(s[B.ROW], js.index.to_numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scenario_files_are_byte_equal(tmp_path, dtype):
    """The .scn text, waypoints named after the rows' labels (here not
    contiguous: the flight is the third of the table, thinned)."""
    df = _make_points(3, dtype=dtype)
    df = df[df["flight_id"] == "SYN00002"].iloc[::3]
    jf = JB.build_scenario(JB.add_ground_speed(df), str(tmp_path / "jax"), "A319")
    pf = B.build_scenario(B.add_ground_speed(_table(df)), str(tmp_path / "port"), "A319")
    assert open(pf, "rb").read() == open(jf, "rb").read()
    df = df.assign(**{"AC Type": "B738"})
    jf = JB.build_scenario(JB.add_ground_speed(df), str(tmp_path / "jax"), "A319")
    pf = B.build_scenario(B.add_ground_speed(_table(df)), str(tmp_path / "port"), "A319")
    assert open(pf, "rb").read() == open(jf, "rb").read()
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    for debug in (False, True):
        a = JB.assemble_scenarios(str(tmp_path / "j"), ["A", "B"], "01:30:00",
                                  JB.build_logger(str(tmp_path / "j"), 10), debug)
        b = B.assemble_scenarios(str(tmp_path / "p"), ["A", "B"], "01:30:00",
                                 B.build_logger(str(tmp_path / "p"), 10), debug)
        assert open(a).read().replace("/j/", "/p/") == open(b).read()
    assert open(tmp_path / "j" / "evaluation_logger.scn", "rb").read() == \
        open(tmp_path / "p" / "evaluation_logger.scn", "rb").read()


def test_logs_parse_and_annotate_match_jax(tmp_path):
    log = tmp_path / "EVALLOG_1.log"
    log.write_text("# header\n# simt, lat, lon, alt, id\n"
                   "20.0, 52.1, 4.9, 3000.0,  SYN00001\n"
                   "0.0, 52.3, 4.7, 0.0,  SYN00001\n"
                   "10.0,52.2,4.8,1500.0,SYN00000  # trailing comment\n"
                   "\n"
                   "0.0,52.25,4.75,0.0,SYN00000\n"
                   "5.5,50.0,5.0,100.0,UNKNOWN\n")
    logs, jlogs = B.logs_to_table(str(log)), JB.logs_to_df(str(log))
    for k in ("relt", "latitude", "longitude", "altitude"):
        np.testing.assert_array_equal(logs[k], jlogs[k].to_numpy())
    original = _make_points(2).assign(groundspeed=1.0)
    merged, jmerged = B.annotate_logs(logs, _table(original)), JB.annotate_logs(jlogs, original)
    assert [k for k in merged] == list(jmerged.columns)
    _assert_same_points(merged, jmerged)
    np.testing.assert_array_equal(merged["relt"], jmerged["relt"].to_numpy())


@pytest.mark.parametrize("delta", [None, 1e3])
def test_simulate_with_stub_matches_jax(tmp_path, stub_cmd, delta):
    cmd, logs_dir = stub_cmd
    df = _make_points(4)
    kw = dict(logs_directory=logs_dir, command=cmd, batch_size=3, simulation_time="00:10:00",
              delta=delta)
    jsim = JB.simulate(df, JB.BlueSkyConfig(workdir=str(tmp_path / "jw"), **kw))
    sim = B.simulate(_table(df), B.BlueSkyConfig(workdir=str(tmp_path / "pw"), **kw))
    assert sorted(set(sim["flight_id"])) == [f"SYN{i:05d}" for i in range(4)]
    assert [k for k in sim] == list(jsim.columns)
    _assert_same_points(sim, jsim, parsed=True)
    # the stub offsets the coordinates by 0.001 deg
    first = sim["latitude"][sim["flight_id"] == "SYN00000"][0]
    assert abs(first - df["latitude"][0]) < 0.01
    assert os.listdir(logs_dir) == []  # each batch's log is consumed
    B.clean(str(tmp_path / "pw"))
    assert not os.path.exists(tmp_path / "pw" / "scenarios")


def _npz(tmp_path, n_flights=3):
    """The generate CLI's .npz: (N, C, L) float32 in original units."""
    pts = _make_points(n_flights)
    ids = sorted(pts["flight_id"].unique())
    X = np.stack([pts[pts.flight_id == f][["latitude", "longitude", "altitude"]].to_numpy().T
                  for f in ids])
    td = np.tile(np.linspace(0, 5400, X.shape[-1]), (len(ids), 1))[:, None, :]
    X = np.concatenate([X, td], axis=1).astype(np.float32)
    path = tmp_path / "synthetic.npz"
    np.savez_compressed(path, X=X, y=np.zeros(len(ids), np.int64))
    return str(path)


def _cli_args(npz, save, cmd, logs_dir, extra=()):
    return ["--synthetic_file", npz, "--save_dir", save, "--ADEP", "EHAM", "--ADES", "LIMC",
            "--bluesky_cmd", cmd, "--logs_directory", logs_dir, "--batch_size", "2", *extra]


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return rows


def _pairs(points, simulated):
    """The (generated, simulated) [lat, lon] pairs, as score_distances pairs them."""
    sim = dict(B.flights(simulated))
    return [(np.stack([f["latitude"], f["longitude"]], 1).astype(np.float32),
             np.stack([sim[fid]["latitude"], sim[fid]["longitude"]], 1).astype(np.float32))
            for fid, f in B.flights(points) if fid in sim]


@jax.jit
def _jax_frechet(p, q):
    """JAX's ``frechet_jax`` without its cast to float32: the same 30
    bisection steps of its own decision, from its own discrete Frechet.
    Under x64, with the decision's float32 infinity made float64 (its row
    carry must keep one type), it gives the float64 witness for the
    continuous Frechet."""
    lo = jnp.maximum(jnp.sqrt(jnp.sum((p[0] - q[0]) ** 2)),
                     jnp.sqrt(jnp.sum((p[-1] - q[-1]) ** 2)))

    def body(_, state):
        lo, hi = state
        mid = 0.5 * (lo + hi)
        ok = J._frechet_decision_jax(p, q, mid)
        return jnp.where(ok, lo, mid), jnp.where(ok, mid, hi)

    return jax.lax.fori_loop(0, 30, body, (lo, J.discret_frechet(p, q)))[1]


def _check_per_flight(port, ref, pairs):
    """LCSS / EDR exactly, the discrete Frechet 1e-6, DTW and ERP 1e-5
    relative. SSPD, Hausdorff and the continuous Frechet work on differences
    of ~1e-3 deg between float32 coordinates near 50 deg, which lose most of
    their digits to cancellation, so the JAX package's own values lie up to
    ~1e-4 (SSPD, Hausdorff) to ~1e-2 (the Frechet, whose free intervals
    divide such differences) from its float64 run there (x64 enabled): the
    port is held within twice JAX's distance from that float64 run plus 1e-4
    of it (the float32 noise that
    tests/test_torch_flyability.py::test_cross_track_conditioning measures
    in both frameworks), and SSPD and Hausdorff within 1e-3 relative of
    JAX's value too."""
    assert set(port) == set(ref) and len(port) == 14 and len(pairs) == len(ref["DTW Euclidean"])
    for k, vals in ref.items():
        assert len(port[k]) == len(vals)
        for (p, q), a, b in zip(pairs, port[k], vals):
            if k.startswith(("LCSS", "EDR")):
                assert a == b, k
            elif k.startswith(("SSPD", "Hausdorff")) or k == "Frechet":
                with jax.enable_x64(True):
                    p64 = jnp.asarray(p.astype(np.float64))
                    q64 = jnp.asarray(q.astype(np.float64))
                    if k == "Frechet":
                        with mock.patch.object(J, "INF", np.float64(np.inf)):
                            w = float(_jax_frechet(p64, q64))
                    else:
                        fn = J.sspd if k.startswith("SSPD") else J.hausdorff
                        w = float(fn(p64, q64, metric=k.split()[1].lower()))
                        assert abs(a - b) <= 1e-3 * abs(b), (k, a, b)
                assert abs(a - w) <= 2 * abs(b - w) + 1e-4 * abs(w), (k, a, b, w)
            else:
                tol = 1e-6 if k == "Discrete Frechet" else 1e-5
                assert abs(a - b) <= tol * abs(b), (k, a, b)


def test_cli_matches_jax_cli(tmp_path, stub_cmd):
    cmd, logs_dir = stub_cmd
    npz = _npz(tmp_path)
    jcli.main(_cli_args(npz, str(tmp_path / "jax"), cmd, logs_dir))
    cli.main(_cli_args(npz, str(tmp_path / "port"), cmd, logs_dir, ["--device", "cpu"]))
    jrows = _read_csv(tmp_path / "jax" / "synthetic_simulated.csv")
    rows = _read_csv(tmp_path / "port" / "synthetic_simulated.csv")
    assert list(rows[0]) == list(jrows[0])
    assert [r["flight_id"] for r in rows] == [r["flight_id"] for r in jrows]
    for r, jr in zip(rows, jrows):
        assert r["timestamp"] == jr["timestamp"]
        for k in ("relt", "timedelta"):  # groundspeed: see the test below
            assert float(r[k]) == float(jr[k]), k
        for k in ("latitude", "longitude", "altitude"):  # parsed from the log: an ulp
            assert abs(float(r[k]) - float(jr[k])) <= 4.5e-16 * abs(float(jr[k])), k
    with open(tmp_path / "jax" / "synthetic_distances.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "synthetic_distances.json") as f:
        port = json.load(f)
    simulated = cli.read_points_csv(str(tmp_path / "port" / "synthetic_simulated.csv"))
    points = cli.npz_to_points(npz, ["latitude", "longitude", "altitude", "timedelta"])
    _check_per_flight(port["per_flight"], ref["per_flight"], _pairs(points, simulated))
    assert set(port["summary"]) == set(ref["summary"])
    for k, s in port["summary"].items():
        assert set(s) == {"mean", "median", "p90"} and all(np.isfinite(list(s.values())))
    assert os.path.exists(tmp_path / "port" / "synthetic_distance_cdfs.png")


def test_cli_reads_a_points_csv_as_jax_does(tmp_path, stub_cmd):
    cmd, logs_dir = stub_cmd
    path = tmp_path / "points.csv"
    _make_points(3, n_pts=20, seed=4).to_csv(path, index=False)
    points, jpoints = cli.read_points_csv(str(path)), pd.read_csv(path)
    jpoints["timestamp"] = pd.to_datetime(jpoints["timestamp"], utc=True, format="ISO8601")
    _assert_same_points(points, jpoints.sort_values(["flight_id", "timestamp"]), parsed=True)
    assert cli.longest_non_outlier_duration(points) == jcli.longest_non_outlier_duration(jpoints)
    jcli.main(_cli_args(str(path), str(tmp_path / "jax"), cmd, logs_dir))
    results = cli.run(SimpleNamespace(**vars(cli.build_argparser().parse_args(_cli_args(
        str(path), str(tmp_path / "port"), cmd, logs_dir, ["--device", "cpu"])))), plot=False)
    with open(tmp_path / "jax" / "points_distances.json") as f:
        ref = json.load(f)
    simulated = cli.read_points_csv(str(tmp_path / "port" / "points_simulated.csv"))
    _check_per_flight(results, ref["per_flight"], _pairs(points, simulated))
    # run(plot=False) stops before the plot
    assert os.path.exists(tmp_path / "port" / "points_distances.json")
    assert not os.path.exists(tmp_path / "port" / "points_distance_cdfs.png")


def test_npz_points_and_filter_match_jax(tmp_path):
    npz = _npz(tmp_path, 2)
    features = ["latitude", "longitude", "altitude", "timedelta"]
    points, jpoints = cli.npz_to_points(npz, features), jcli.npz_to_points(npz, features)
    assert [k for k in points if k != B.ROW] == list(jpoints.columns)
    _assert_same_points(points, jpoints, exact_cols=features)
    ades = AIRPORTS["LIMC"]
    kept, jkept = cli.filter_simulated(points, ades), jcli.filter_simulated(jpoints, ades)
    _assert_same_points(kept, jkept, exact_cols=features)
    assert cli.longest_non_outlier_duration(points) == jcli.longest_non_outlier_duration(jpoints)
    csv_path = tmp_path / "points.csv"
    cli.write_points_csv(points, str(csv_path))
    back = cli.read_points_csv(str(csv_path))
    np.testing.assert_array_equal(back["timestamp"], points["timestamp"])
    # float32 columns are written as their shortest float32 text
    np.testing.assert_array_equal(back["latitude"].astype(np.float32), points["latitude"])


def test_ground_speed_reads_nanoseconds_at_any_resolution(tmp_path):
    """The JAX package divides ``timestamp.astype("int64")`` by 1e9, which
    assumes nanoseconds; under pandas 3 its npz path builds microsecond
    timestamps, so its speeds come out ~1000x too large there. The port's
    timestamps are datetime64[ns]: its speeds equal JAX's on the same
    points held in nanoseconds."""
    points = cli.npz_to_points(_npz(tmp_path, 1), ["latitude", "longitude", "altitude",
                                                   "timedelta"])
    jpoints = jcli.npz_to_points(str(tmp_path / "synthetic.npz"),
                                 ["latitude", "longitude", "altitude", "timedelta"])
    ns = jpoints.assign(timestamp=jpoints["timestamp"].astype("datetime64[ns, UTC]"))
    np.testing.assert_array_equal(B.add_ground_speed(points)["groundspeed"],
                                  JB.add_ground_speed(ns)["groundspeed"].to_numpy())
    speed = B.add_ground_speed(points)["groundspeed"]
    assert 100 < np.median(speed) < 1000  # knots, EHAM -> LIMC in 90 minutes


def test_cli_skips_the_plot_without_matplotlib(tmp_path, stub_cmd, monkeypatch):
    """The card's machine has no matplotlib: ``run(args, plot=False)`` writes
    the CSV and the JSON and stops before the plot; ``main`` writes them too
    and then fails at the plot's import, as the JAX package's CLI does."""
    import builtins

    cmd, logs_dir = stub_cmd
    npz = _npz(tmp_path, 2)
    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'", name="matplotlib")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    args = cli.build_argparser().parse_args(
        _cli_args(npz, str(tmp_path / "out"), cmd, logs_dir, ["--device", "cpu"]))
    results = cli.run(args, plot=False)
    assert set(results) == set(D.KEYS)
    assert os.path.exists(tmp_path / "out" / "synthetic_simulated.csv")
    assert os.path.exists(tmp_path / "out" / "synthetic_distances.json")
    assert not os.path.exists(tmp_path / "out" / "synthetic_distance_cdfs.png")
    os.remove(tmp_path / "out" / "synthetic_distances.json")
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        cli.main(_cli_args(npz, str(tmp_path / "out"), cmd, logs_dir, ["--device", "cpu"]))
    assert os.path.exists(tmp_path / "out" / "synthetic_distances.json")
    assert not os.path.exists(tmp_path / "out" / "synthetic_distance_cdfs.png")
