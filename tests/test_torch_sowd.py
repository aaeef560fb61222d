"""The port's SOWD, geohash grid and segment distance against the JAX
package's, on the CPU.

Geohash strings, decoded cells and raster cells: exactly equal (the same
host code). OWD / SOWD and ``segments_distance``: within 1e-5 relative
(float32 in another order of operations).
"""

import importlib

import numpy as np
import pytest
import torch

# both packages re-export the sowd function, which shadows the submodule
S = importlib.import_module("tvqvae_tpu_torch.evaluation.flyability.sowd")
JS = importlib.import_module("tvqvae_tpu.evaluation.flyability.sowd")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_walk(seed, n):
    """Random 4-connected unit-step integer cell path."""
    rng = np.random.RandomState(seed)
    steps = rng.randint(0, 4, n - 1)
    moves = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]])[steps]
    return np.concatenate([[[0, 0]], np.cumsum(moves, 0)], 0).astype(np.float64) \
        + rng.randint(0, 5, 2)


def _traj(seed, n, step=0.03):
    rng = np.random.RandomState(seed)
    return np.array([6.0, 48.0]) + np.cumsum(rng.randn(n, 2) * step, 0)


def test_geohash_matches_jax():
    rng = np.random.default_rng(0)
    for lat, lon in [(42.605, -5.603), (0.0, 0.0), (-33.9, 151.2), (89.9, -179.9)] \
            + [tuple(x) for x in rng.uniform([-90, -180], [90, 180], (50, 2))]:
        for precision in (1, 5, 7, 9):
            gh = S.geohash_encode(lat, lon, precision)
            assert gh == JS.geohash_encode(lat, lon, precision)
            assert S.geohash_decode_exactly(gh) == JS.geohash_decode_exactly(gh)
    assert S.geohash_encode(42.605, -5.603, 5) == "ezs42"


@pytest.mark.parametrize("precision", [5, 6, 7])
def test_raster_matches_jax(precision):
    trajs = [_traj(7, 40), _traj(8, 25), _traj(9, 2)]
    cells, lons, lats = S.trajectory_set_grid(trajs, precision)
    j_cells, j_lons, j_lats = JS.trajectory_set_grid(trajs, precision)
    np.testing.assert_array_equal(lons, j_lons)
    np.testing.assert_array_equal(lats, j_lats)
    assert len(cells) == len(j_cells)
    for c, jc in zip(cells, j_cells):
        np.testing.assert_array_equal(c, jc)


@pytest.mark.parametrize("seed,n,m", [(0, 12, 17), (1, 30, 8), (2, 5, 5), (3, 1, 4)])
def test_owd_and_sowd_grid_match_jax(seed, n, m):
    c1, c2 = _cell_walk(seed, n), _cell_walk(seed + 100, m)
    got = S.owd_grid_brut(c1, c2, device="cpu")
    assert abs(got - JS.owd_grid_brut(c1, c2)) <= 1e-5 * abs(JS.owd_grid_brut(c1, c2))
    want = JS.sowd_grid(c1, c2)
    assert abs(S.sowd_grid(c1, c2, device="cpu") - want) <= 1e-5 * want


@pytest.mark.parametrize("precision", [5, 6])
def test_sowd_matches_jax(precision):
    t1 = _traj(9, 30, 0.02)
    for t2 in (t1 + np.random.RandomState(1).randn(*t1.shape) * 0.001, t1 + 0.5, t1):
        want = JS.sowd(t1, t2, precision=precision)
        got = S.sowd(t1, t2, precision=precision, device="cpu")
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert S.sowd(t1, t1, precision=precision, device="cpu") == 0.0
    assert S.sowd(t1, t1[:, :2], converted=True, device="cpu") == 0.0


@pytest.mark.parametrize("seed,n,m", [(0, 10, 13), (1, 25, 7), (2, 6, 6)])
def test_segments_distance_matches_jax(seed, n, m):
    t0, t1 = _traj(seed, n, 0.05), _traj(seed + 50, m, 0.05)
    got = S.segments_distance(t0, t1, device="cpu")
    want = JS.segments_distance(t0, t1)
    assert got.shape == want.shape == (n - 1, m - 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_segments_distance_t_keeps_its_device_and_shape():
    t0 = torch.from_numpy(_traj(3, 8).astype(np.float32))
    t1 = torch.from_numpy(_traj(4, 5).astype(np.float32))
    d = S.segments_distance_t(t0, t1)
    assert d.shape == (7, 4) and d.dtype == torch.float32 and bool(torch.isfinite(d).all())
    np.testing.assert_array_equal(d.numpy(), S.segments_distance(t0.numpy(), t1.numpy(),
                                                                 device="cpu"))
