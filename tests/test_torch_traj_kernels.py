"""The trajectory-distance kernels' wrappers, and the CUDA kernels against
their plain versions.

Torch only, so the card's machine (no JAX) runs it too:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_traj_kernels.py

The ``gpu`` cases skip without a card; the CUDA kernels have no CPU mode.
Tolerances, kernel against plain version on the same card: LCSS and EDR
exactly (integer counts over bit-equal costs); the discrete Frechet exactly
(it only selects among bit-equal costs); DTW and ERP 1e-5 relative (the
kernel adds along anti-diagonals, the plain version through a row scan);
the continuous Frechet 1e-5 relative (the same decisions over bit-equal free
intervals; the kernel runs the true lengths, the plain version the bucket
padding). The launch plans are pinned on the CPU.
"""

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.evaluation.flyability import distances as D
from tvqvae_tpu_torch.ops import frechet_kernel, traj_dp_kernel

G = (52.3086, 4.7639)


def _batch(shapes, seed=0, step=0.05):
    """Pairs of random walks near (48, 5) with true lengths ``shapes``,
    padded to their common bucket by repeating the last point."""
    rng = np.random.default_rng(seed)
    P = D._bucket_size(max(n for n, _ in shapes))
    Q = D._bucket_size(max(m for _, m in shapes))
    p, q = [], []
    for n, m in shapes:
        a = np.cumsum(rng.normal(0, step, (n, 2)), 0) + [48.0, 5.0]
        b = np.cumsum(rng.normal(0, step, (m, 2)), 0) + [48.0, 5.0]
        p.append(np.concatenate([a, np.repeat(a[-1:], P - n, 0)]))
        q.append(np.concatenate([b, np.repeat(b[-1:], Q - m, 0)]))
    return (torch.from_numpy(np.stack(p).astype(np.float32)),
            torch.from_numpy(np.stack(q).astype(np.float32)),
            torch.tensor([n for n, _ in shapes]), torch.tensor([m for _, m in shapes]))


def test_build_is_lazy():
    """Importing the wrappers compiles and loads nothing."""
    for mod in (traj_dp_kernel, frechet_kernel):
        assert not mod._lib.loaded or torch.cuda.is_available()
        assert mod.SOURCE.exists()


@pytest.mark.parametrize("nmax,mmax,threads,smem", [
    (4633, 580, 608, 4 * (4 * 5213 + 3 * 580 + 32)),
    (4633, 4633, 1024, 4 * (4 * 9266 + 3 * 4633 + 32)),
    (7, 2, 32, 4 * (4 * 9 + 3 * 2 + 32)),
])
def test_dp_launch_plan(nmax, mmax, threads, smem):
    assert traj_dp_kernel.launch_plan(nmax, mmax) == (threads, min(nmax, mmax), smem)
    assert smem <= traj_dp_kernel.SMEM_LIMIT


@pytest.mark.parametrize("mmax,threads,chunk", [
    (2, 32, 1), (33, 32, 1), (580, 608, 1), (1025, 1024, 1), (1026, 544, 2),
    (4633, 608, 8), (5120, 640, 8), (8193, 1024, 8),
])
def test_frechet_launch_plan(mmax, threads, chunk):
    assert frechet_kernel.launch_plan(mmax) == (threads, chunk)
    assert threads * chunk >= mmax - 1 and threads % 32 == 0 and threads <= 1024
    with pytest.raises(ValueError):
        frechet_kernel.launch_plan(8194)


def test_cells_counts_the_true_grids():
    assert traj_dp_kernel.cells([4633, 10], [580, 3]) == 4633 * 580 + 30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _dp_check(p, q, n, m, eps=0.009):
    spec = [v[1:] for v in D.dp_variants(eps)]
    pc, qc = p.cuda(), q.cuda()
    before = traj_dp_kernel.launch_count
    out = traj_dp_kernel.traj_dp(pc, qc, n, m, G, spec)
    torch.cuda.synchronize()
    assert traj_dp_kernel.launch_count == before + 1
    ref = D.dp_metrics(pc, qc, n.cuda(), m.cuda(), G, spec)
    for k, (key, kind, _, _) in enumerate(D.dp_variants(eps)):
        got, want = out[:, k].cpu(), ref[:, k].cpu()
        if kind in ("edr", "lcss", "discret_frechet"):
            assert torch.equal(got, want), key
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0, msg=key)
    # no atomics: the same bits again
    assert torch.equal(out, traj_dp_kernel.traj_dp(pc, qc, n, m, G, spec))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [
    [(2, 2)], [(1, 5)], [(7, 1)], [(33, 64), (64, 33), (40, 40)],
    [(100, 13), (7, 100), (64, 64)], [(300, 40), (257, 290)],
])
def test_dp_kernel_matches_plain_on_card(shapes, card):
    _dp_check(*_batch(shapes, seed=len(shapes)))


@pytest.mark.gpu
def test_dp_kernel_spherical_eps_on_card(card):
    """Near-threshold costs: LCSS and EDR still count exactly."""
    p, q, n, m = _batch([(50, 60), (60, 50)], seed=3, step=0.005)
    _dp_check(p, q, n, m, eps=0.004)


@pytest.mark.gpu
def test_dp_kernel_strided_diagonals_match_plain_on_card(card):
    """Diagonals longer than a block's 1024 threads, so that a thread
    updates more than one cell of a diagonal, as in the (5120, 5120)
    bucket."""
    p, q, n, m = _batch([(1100, 1100), (1500, 1200)], seed=21)
    threads, w, _ = traj_dp_kernel.launch_plan(1500, 1200)
    assert threads == 1024 < w
    _dp_check(p, q, n, m)


@pytest.mark.gpu
def test_wrappers_reject_bad_lengths_on_card(card):
    """True lengths past the padding, or a Frechet length below 2, raise
    before a launch."""
    p, q, n, m = _batch([(33, 7)])
    pc, qc = p.cuda(), q.cuda()
    spec = [v[1:] for v in D.dp_variants()]
    before = (traj_dp_kernel.launch_count, frechet_kernel.launch_count)
    with pytest.raises(ValueError):
        traj_dp_kernel.traj_dp(pc, qc, [p.shape[1] + 1], [7], G, spec)
    hi = torch.ones(1, device="cuda")
    with pytest.raises(ValueError):
        frechet_kernel.frechet(pc, qc, [33], [1], hi)
    with pytest.raises(ValueError):
        frechet_kernel.frechet(pc, qc, [33], [q.shape[1] + 1], hi)
    assert (traj_dp_kernel.launch_count, frechet_kernel.launch_count) == before


def _frechet_check(p, q, n, m):
    pc, qc = p.cuda(), q.cuda()
    spec = [("discret_frechet", "euclidean", 0.0)]
    hi = traj_dp_kernel.traj_dp(pc, qc, n, m, G, spec)[:, 0].contiguous()
    before = frechet_kernel.launch_count
    got = frechet_kernel.frechet(pc, qc, n, m, hi)
    torch.cuda.synchronize()
    assert frechet_kernel.launch_count == before + 1
    want = D.frechet_bisect(pc, qc, n.cuda(), m.cuda(), hi)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-5, atol=0)
    assert bool((got <= hi + 1e-6).all())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [
    [(2, 2)], [(2, 9)], [(9, 2)], [(33, 64), (64, 33), (40, 40)],
    [(100, 13), (13, 100)], [(200, 1100)], [(120, 2100)],
])
def test_frechet_kernel_matches_plain_on_card(shapes, card):
    _frechet_check(*_batch(shapes, seed=10 + len(shapes)))


@pytest.mark.gpu
def test_frechet_kernel_chunk8_matches_plain_on_card(card):
    """The plan of 8 row elements a thread, which the full-length buckets
    take: a (48, 4633) pair in bucket (64, 5120). The plain version's cost
    grows with p's rows, so this runs in seconds."""
    p, q, n, m = _batch([(48, 4633)], seed=20, step=0.01)
    assert tuple(p.shape[1:2] + q.shape[1:2]) == (64, 5120)
    assert frechet_kernel.launch_plan(4633) == (608, frechet_kernel.CHUNKS[-1]) == (608, 8)
    _frechet_check(p, q, n, m)


@pytest.mark.gpu
def test_frechet_kernel_known_cases_on_card(card):
    t = np.linspace(0, 2 * np.pi, 60)
    a = np.stack([np.cos(t), np.sin(t)], axis=1).astype(np.float32)
    p = torch.from_numpy(np.stack([a, np.array([[0, 0]] * 30 + [[0, 10]] * 30, np.float32)]))
    q = torch.from_numpy(np.stack([a + np.float32([0.3, 0.4]),
                                   np.array([[1, 0]] * 30 + [[1, 10]] * 30, np.float32)]))
    n = m = torch.tensor([60, 60])
    got = _frechet_check(p, q, n, m).cpu().numpy()
    np.testing.assert_allclose(got, [0.5, 1.0], rtol=1e-3)


@pytest.mark.gpu
def test_batch_entry_point_launches_the_kernels_on_card(card):
    """One launch of each kernel a bucket, the CPU's values."""
    rng = np.random.default_rng(5)
    gens = [np.cumsum(rng.normal(0, 0.03, (n, 2)), 0) + [48, 5] for n in (14, 25, 40, 300)]
    sims = [np.cumsum(rng.normal(0, 0.03, (m, 2)), 0) + [48, 5] for m in (18, 25, 9, 35)]
    buckets = len({(D._bucket_size(len(a)), D._bucket_size(len(b))) for a, b in zip(gens, sims)})
    assert buckets == 3
    before = (traj_dp_kernel.launch_count, frechet_kernel.launch_count)
    card_out = D.calculate_trajectory_distances_batch(gens, sims, G, device="cuda")
    assert (traj_dp_kernel.launch_count, frechet_kernel.launch_count) == \
        (before[0] + buckets, before[1] + buckets)
    cpu_out = D.calculate_trajectory_distances_batch(gens, sims, G, device="cpu")
    for k in D.KEYS:
        # the spherical cross-track formula amplifies the last-ulp differences
        # of the card's and the CPU's sin/cos (tests/test_torch_flyability.py)
        rtol = 1e-3 if k in ("SSPD Spherical", "Hausdorff Spherical") else 1e-4
        np.testing.assert_allclose(card_out[k], cpu_out[k], rtol=rtol, err_msg=k)
