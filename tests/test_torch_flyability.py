"""The port's 14 trajectory distances against the JAX package's, on the CPU.

Inputs are seeded numpy random walks near (48, 5); JAX runs its jitted
per-pair functions, the port its plain PyTorch versions (the kernels' CPU
path). Tolerances: LCSS, EDR and the bucket sizes exactly; the discrete
Frechet within 1e-6 relative (it only selects); DTW, ERP, planar SSPD and
Hausdorff and the continuous Frechet within 1e-5 relative (float32 sums in
another order). Spherical SSPD and Hausdorff go through the reference's
cross-track formula, whose float32 rounding is ill-conditioned: the JAX
package's own values lie ~1e-5 (median) to ~1e-4 (90th percentile) from its
float64 run (x64 enabled), and the port's alike. So the port is held within
1e-3 relative of JAX's float32 value, and within twice JAX's own distance
from JAX's float64 value plus 1e-4 of it (``test_cross_track_conditioning``
measures that noise).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.evaluation.flyability import distances as J
from tvqvae_tpu_torch.evaluation.flyability import distances as D
from tvqvae_tpu_torch.ops import frechet_kernel, traj_dp_kernel

SHAPES = [(2, 7), (7, 7), (33, 64), (64, 33)]
G = np.array([47.0, 4.0], np.float32)
EPS = {"euclidean": 0.05, "spherical": 5000.0}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes run as fast on one thread, and the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(rng, n, step=0.05):
    return (np.cumsum(rng.normal(0, step, (n, 2)), axis=0) + [48.0, 5.0]).astype(np.float32)


def _pair(n, m, seed=0):
    rng = np.random.default_rng(seed + 100 * n + m)
    return _walk(rng, n), _walk(rng, m)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _jax64(fn, p, q, **kw):
    """JAX's own ``fn`` in float64 (x64 enabled for the call): the witness
    for the float32 values, computed without the port."""
    with jax.enable_x64(True):
        return float(fn(jnp.asarray(np.asarray(p, np.float64)),
                        jnp.asarray(np.asarray(q, np.float64)), **kw))


def _witness(port, ref32, ref64, what):
    """The port within 1e-3 relative of JAX's float32 value, and within
    twice JAX's own distance from its float64 value plus 1e-4 of it (the
    formula's float32 noise: see test_cross_track_conditioning)."""
    assert abs(port - ref32) <= 1e-3 * abs(ref32), (what, port, ref32)
    allowed = 2 * abs(ref32 - ref64) + 1e-4 * abs(ref64)
    assert abs(port - ref64) <= allowed, (what, port, ref32, ref64)


@pytest.mark.parametrize("metric", ["euclidean", "spherical"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_dp_metrics_match_jax(n, m, metric):
    p, q = _pair(n, m)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    jp, jq = jnp.asarray(p), jnp.asarray(q)
    assert _rel(D.dtw(tp, tq, metric), J.dtw(jp, jq, metric=metric)) <= 1e-5
    assert _rel(D.erp(tp, tq, G, metric), J.erp(jp, jq, jnp.asarray(G), metric=metric)) <= 1e-5
    eps = EPS[metric]
    assert float(D.edr(tp, tq, eps, metric)) == float(J.edr(jp, jq, eps, metric=metric))
    assert float(D.lcss(tp, tq, eps, metric)) == float(J.lcss(jp, jq, eps, metric=metric))
    if metric == "euclidean":
        assert _rel(D.discret_frechet(tp, tq), J.discret_frechet(jp, jq)) <= 1e-6


@pytest.mark.parametrize("metric", ["euclidean", "spherical"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_sspd_hausdorff_match_jax(n, m, metric):
    p, q = _pair(n, m)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    for name in ("sspd", "hausdorff"):
        port = float(getattr(D, name)(tp, tq, metric))
        ref = float(getattr(J, name)(jnp.asarray(p), jnp.asarray(q), metric=metric))
        if metric == "euclidean":
            assert _rel(port, ref) <= 1e-5, name
        else:
            _witness(port, ref, _jax64(getattr(J, name), p, q, metric=metric), name)


def test_cross_track_conditioning():
    """Why spherical SSPD / Hausdorff get a float64 witness: over 20 seeded
    pairs (a track and a noisy copy of every other point) the float32
    point-to-segment distances of both frameworks lie from JAX's float64 run
    of the same formula by a median ~1e-5 and a 90th percentile ~1e-4 (the
    bearing difference in the cross-track term cancels), with the same
    distribution: the port is no less accurate than JAX."""
    rng = np.random.default_rng(1)
    sph = jax.jit(J._point_to_segments_sph)
    errs = {"jax": [], "port": []}
    for _ in range(20):
        p = (np.cumsum(rng.normal(0, 0.05, (20, 2)), 0) + [50.0, 6.0]).astype(np.float32)
        q = (p[::2] + rng.normal(0, 0.003, (10, 2))).astype(np.float32)
        with jax.enable_x64(True):
            ref = np.asarray(sph(jnp.asarray(p.astype(np.float64)),
                                 jnp.asarray(q.astype(np.float64))))
        assert ref.dtype == np.float64
        ours = D._point_to_segments_sph(torch.from_numpy(p), torch.from_numpy(q)).numpy()
        errs["jax"].append(np.abs(np.asarray(sph(jnp.asarray(p), jnp.asarray(q))) - ref) / ref)
        errs["port"].append(np.abs(ours - ref) / ref)
    stats = {k: (np.median(np.concatenate(v)), np.percentile(np.concatenate(v), 90))
             for k, v in errs.items()}
    assert 3e-6 <= stats["jax"][0] <= 3e-5 and 5e-5 <= stats["jax"][1] <= 5e-4, stats
    assert stats["port"][0] <= 1.5 * stats["jax"][0] and stats["port"][1] <= 1.5 * stats["jax"][1]


@pytest.mark.parametrize("n,m", SHAPES)
def test_frechet_matches_jax(n, m):
    p, q = _pair(n, m)
    port = float(D.frechet(torch.from_numpy(p), torch.from_numpy(q)))
    assert _rel(port, J.frechet_jax(jnp.asarray(p), jnp.asarray(q))) <= 1e-5


@pytest.mark.parametrize("n,m", [(7, 33), (33, 7)])
def test_frechet_decision_matches_jax(n, m):
    """The decision alone, at eps around the distance, is the same boolean."""
    p, q = _pair(n, m, seed=3)
    f = float(J.frechet_jax(jnp.asarray(p), jnp.asarray(q)))
    decide = jax.jit(J._frechet_decision_jax)
    for scale in (0.5, 0.9, 0.999, 1.001, 1.1, 2.0):
        eps = np.float32(f * scale)
        port = D._frechet_decision(torch.from_numpy(p)[None], torch.from_numpy(q)[None],
                                   torch.tensor([eps]))
        assert bool(port[0]) == bool(decide(jnp.asarray(p), jnp.asarray(q), eps)), scale


def test_bucket_sizes_and_padding_match_jax():
    for n in list(range(1, 80)) + [511, 512, 513, 2047, 2048, 2049, 4633, 5120, 5121]:
        assert D._bucket_size(n) == J._bucket_size(n), n
    x = _walk(np.random.default_rng(0), 13)
    np.testing.assert_array_equal(D._bucket_pad(x), J._bucket_pad(x))


def test_bucket_padding_invariance():
    """Padded trajectories with their true lengths reproduce the unpadded
    values (JAX's tests/test_distances.py::test_bucket_padding_invariance)."""
    rng = np.random.default_rng(3)
    p, q = _walk(rng, 13), _walk(rng, 21)
    pp, qq = torch.from_numpy(D._bucket_pad(p)), torch.from_numpy(D._bucket_pad(q))
    assert pp.shape[0] == 32 and qq.shape[0] == 32
    tp, tq, n, m = torch.from_numpy(p), torch.from_numpy(q), len(p), len(q)
    for metric in ("euclidean", "spherical"):
        for fn, args, tol in [(D.dtw, (), 1e-5), (D.erp, (G,), 1e-5), (D.sspd, (), 1e-5),
                              (D.hausdorff, (), 1e-5)]:
            a = float(fn(tp, tq, *args, metric=metric))
            b = float(fn(pp, qq, *args, metric=metric, n=n, m=m))
            assert _rel(b, a) <= tol, (fn.__name__, metric)
        for fn in (D.lcss, D.edr):
            eps = EPS[metric]
            assert float(fn(tp, tq, eps, metric)) == float(fn(pp, qq, eps, metric, n=n, m=m))
    assert float(D.discret_frechet(tp, tq)) == float(D.discret_frechet(pp, qq, n=n, m=m))
    # repeated-endpoint padding is exact for the continuous Frechet
    assert _rel(D.frechet(pp, qq), D.frechet(tp, tq)) <= 1e-5


def test_bundle_matches_jax_with_its_eps_conventions():
    """calculate_trajectory_distances (bucket-padded, the 14 keys) against
    JAX's: spherical LCSS at eps*1e6 metres, spherical EDR at eps itself."""
    rng = np.random.default_rng(0)
    p = np.cumsum(rng.normal(0, 0.02, (30, 2)), axis=0) + [48.0, 5.0]
    q = p + rng.normal(0, 0.005, p.shape)
    port = D.calculate_trajectory_distances(p, q, adep_latlon=(48.0, 5.0), device="cpu")
    ref = J.calculate_trajectory_distances(p, q, adep_latlon=(48.0, 5.0))
    assert set(port) == set(ref) == set(D.KEYS)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    pt, qt = torch.from_numpy(p32), torch.from_numpy(q32)
    for k, v in ref.items():
        if k.startswith(("LCSS", "EDR")):
            assert port[k] == v, k
        elif k == "Discrete Frechet":
            assert _rel(port[k], v) <= 1e-6
        elif k in ("SSPD Spherical", "Hausdorff Spherical"):
            fn = J.sspd if k.startswith("SSPD") else J.hausdorff
            _witness(port[k], v, _jax64(fn, p32, q32, metric="spherical"), k)
        else:
            assert _rel(port[k], v) <= 1e-5, k
    assert port["LCSS Spherical"] == float(D.lcss(pt, qt, 0.009 * 1e6, "spherical"))
    assert port["EDR Spherical"] == float(D.edr(pt, qt, 0.009, "spherical")) == 1.0
    assert port["Frechet"] <= port["Discrete Frechet"] + 1e-5


def test_batch_matches_per_pair():
    """One call over pairs in two buckets equals each pair scored alone
    (JAX's tests/test_distances.py::test_batched_scoring_matches_per_pair)."""
    rng = np.random.default_rng(5)
    gens, sims = [], []
    for n, m in [(14, 18), (25, 25), (40, 9), (14, 20)]:
        gens.append(_walk(rng, n, 0.03))
        sims.append(_walk(rng, m, 0.03))
    batch = D.calculate_trajectory_distances_batch(gens, sims, (48.0, 5.0), device="cpu")
    for i in range(len(gens)):
        single = D.calculate_trajectory_distances(gens[i], sims[i], (48.0, 5.0), device="cpu")
        for k, v in single.items():
            assert _rel(batch[k][i], v) <= 1e-6, (k, i)


def test_frechet_known_cases():
    """JAX's tests/test_distances.py::test_frechet_known_cases."""
    p = np.array([[0, 0], [0, 10]], np.float64)
    q = np.array([[1, 0], [1, 10]], np.float64)
    np.testing.assert_allclose(float(D.frechet(p, q)), 1.0, rtol=1e-4)
    t = np.linspace(0, 2 * np.pi, 60)
    a = np.stack([np.cos(t), np.sin(t)], axis=1)
    np.testing.assert_allclose(float(D.frechet(a, a + np.array([0.3, 0.4]))), 0.5, rtol=1e-3)
    rng = np.random.default_rng(0)
    p = np.cumsum(rng.normal(0, 0.1, (25, 2)), axis=0)
    q = np.cumsum(rng.normal(0, 0.1, (18, 2)), axis=0)
    f, df = float(D.frechet(p, q)), float(D.discret_frechet(p, q))
    lo = max(np.linalg.norm(p[0] - q[0]), np.linalg.norm(p[-1] - q[-1]))
    assert lo - 1e-5 <= f <= df + 1e-5
    p = np.array([[0, 0], [5, 1], [10, 0]], np.float64)
    q = np.array([[0, 0.2], [10, 0.2]], np.float64)
    assert float(D.frechet(p, q)) <= float(D.discret_frechet(p, q)) + 1e-6


def _sequential(combine, elems):
    """The scan one element at a time, left to right."""
    out = [tuple(e[..., :1] for e in elems)]
    for j in range(1, elems[0].shape[-1]):
        out.append(combine(out[-1], tuple(e[..., j:j + 1] for e in elems)))
    return tuple(torch.cat(parts, -1) for parts in zip(*out))


@pytest.mark.parametrize("length", [1, 2, 5, 33, 64])
def test_associative_scan_equals_sequential(length):
    """Integer-valued floats, so every order of the sums is exact."""
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.integers(0, 5, (3, length)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 40, (3, length)).astype(np.float32))
    for combine in (D._minplus_combine, D._clamp_combine):
        got = D.associative_scan(combine, (a, b))
        want = _sequential(combine, (a, b))
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    r = torch.from_numpy(rng.random((3, length)) < 0.3)
    c = torch.from_numpy(rng.random((3, length)).astype(np.float32))
    h = c + torch.from_numpy(rng.random((3, length)).astype(np.float32))
    tup = (r, torch.where(r, c, D.INF), c, h, c <= h)
    for x, y in zip(D.associative_scan(D._frechet_combine, tup),
                    _sequential(D._frechet_combine, tup)):
        assert torch.equal(x, y)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors a bucket runs the kernels' plain versions
    (``dp_metrics``, ``frechet_bisect``) and counts no launch; the kernels'
    wrappers launch only on CUDA tensors and raise for CPU tensors, as for
    other bad inputs, before anything is built."""
    p, q = _pair(33, 7)
    tp, tq = torch.from_numpy(p)[None], torch.from_numpy(q)[None]
    n, m = torch.tensor([33]), torch.tensor([7])
    spec = [v[1:] for v in D.dp_variants()]
    before = (traj_dp_kernel.launch_count, frechet_kernel.launch_count)
    out = D._score_bucket(tp, tq, n, m, torch.from_numpy(G), 0.009)
    dp = D.dp_metrics(tp, tq, n, m, G, spec)
    assert dp.shape == (1, 9)
    for k, (key, *_) in enumerate(D.dp_variants()):
        assert torch.equal(out[key], dp[:, k]), key
    assert torch.equal(out["Frechet"], D.frechet_bisect(tp, tq, n, m, dp[:, -1]))
    assert (traj_dp_kernel.launch_count, frechet_kernel.launch_count) == before
    with pytest.raises(ValueError, match="CUDA"):
        traj_dp_kernel.traj_dp(tp, tq, [33], [7], G, spec)
    with pytest.raises(ValueError, match="CUDA"):
        frechet_kernel.frechet(tp, tq, [33], [7], dp[:, -1].contiguous())
    with pytest.raises(ValueError):
        traj_dp_kernel.traj_dp(tp, tq, [33], [7], G, [("dtw", "manhattan", 0.0)])
    with pytest.raises(ValueError):
        traj_dp_kernel.traj_dp(tp, tq, [33], [7], G, [("discret_frechet", "spherical", 0.0)])
    with pytest.raises(TypeError):
        traj_dp_kernel.traj_dp(tp.double(), tq, [33], [7], G, spec)
    with pytest.raises(ValueError):
        frechet_kernel.frechet(tp[:, :, :1].contiguous(), tq, [33], [7], dp[:, -1].contiguous())
    assert (traj_dp_kernel.launch_count, frechet_kernel.launch_count) == before


def test_dp_metrics_equal_the_single_metric_functions():
    """The stacked row loops of dp_metrics give each single-metric value."""
    rng = np.random.default_rng(9)
    p = torch.from_numpy(np.stack([_walk(rng, 20), _walk(rng, 20)]))
    q = torch.from_numpy(np.stack([_walk(rng, 12), _walk(rng, 12)]))
    n, m = torch.tensor([20, 17]), torch.tensor([9, 12])
    out = D.dp_metrics(p, q, n, m, G, [v[1:] for v in D.dp_variants(0.05)])
    for k, (key, kind, metric, eps) in enumerate(D.dp_variants(0.05)):
        fn = getattr(D, kind)
        args = (G,) if kind == "erp" else (eps,) if kind in ("edr", "lcss") else ()
        assert torch.equal(out[:, k], fn(p, q, *args, metric=metric, n=n, m=m)), key
