"""The trajectory-distance kernels' wrappers, and the CUDA kernels against
their plain versions.

Torch only, so the card's machine (no JAX) runs it too:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_traj_kernels.py

The ``gpu`` cases skip without a card; the CUDA kernels have no CPU mode.
Tolerances, kernel against plain version on the same card: LCSS and EDR
exactly (integer counts over bit-equal costs); the discrete Frechet exactly
(it only selects among bit-equal costs); DTW and ERP 1e-5 relative (the
kernel adds cell by cell, the plain version through a row scan);
the continuous Frechet 1e-5 relative (the same decisions over bit-equal free
intervals; the kernel runs the true lengths, the plain version the bucket
padding), and exactly between its own plans (every depth and block shape
decides the same midpoints). The launch plans are pinned on the CPU.
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


def _occupancy(warps, cluster, smem):
    """An H100 at the build's register cap (65536 / kMaxThreads a thread):
    blocks an SM holds (threads, registers, shared memory, 32 blocks), and
    clusters the card holds at once (132 SMs, GPCs not modelled)."""
    threads = 32 * warps
    regs = 65536 // traj_dp_kernel.MAX_THREADS
    blocks = min(32, 2048 // threads, 65536 // (regs * threads), traj_dp_kernel.SMEM_LIMIT // smem)
    return blocks, (132 * blocks) // cluster


def _assert_covers(plan, rows, cols):
    """Every column of a rows x cols grid is held by exactly one lane
    (strip s of the cluster's warps: rank s // warps, warp s % warps), and
    each lane's steps walk every row exactly once."""
    owner = [0] * cols
    for strip in range(plan.warps * plan.cluster):
        for lane in range(32):
            if strip * 32 + lane < cols:
                owner[strip * 32 + lane] += 1
    assert owner == [1] * cols
    steps = rows + 31  # the kernel's loop: lane t on row s - t at step s
    for lane in (0, 1, 17, 31):
        walked = [s - lane for s in range(steps) if 0 <= s - lane < rows]
        assert walked == list(range(rows))


def _occupancy_gpcs(warps, cluster, smem):
    """``_occupancy`` where the card places only 7 clusters of 10 blocks or
    more at once, as an H100's GPCs do at one block an SM."""
    blocks, clusters = _occupancy(warps, cluster, smem)
    return blocks, 7 if cluster >= 10 else clusters


@pytest.mark.parametrize("B,ntasks,nmax,mmax,occupancy,plan", [
    # the [flyability] batch's buckets on an H100's 132 SMs: 128 tasks, a
    # block each; 4 tasks, a cluster of 15 blocks each
    (64, 2, 4633, 580, _occupancy, (19, 1, False)),
    (2, 2, 4633, 4633, _occupancy, (10, 15, False)),
    # the check inputs: 4 tasks of 4633 x 580 over clusters of 10
    (2, 2, 4633, 580, _occupancy, (2, 10, False)),
    # n < m: the lanes run across p's points
    (3, 2, 40, 100, _occupancy, (1, 2, True)),
    # n or m = 1
    (1, 1, 1, 5, _occupancy, (1, 1, True)),
    (4, 2, 7, 1, _occupancy, (1, 1, False)),
    # a width that is no multiple of a strip's 32 columns
    (64, 2, 300, 33, _occupancy, (2, 1, False)),
    # the discrete Frechet alone (one task a pair), as chip_smoke.py's hi
    (2, 1, 1024, 512, _occupancy, (1, 16, False)),
    # 8 tasks where the card holds 7 wide clusters: the widest that fits one wave
    (4, 2, 4633, 4633, _occupancy_gpcs, (17, 9, False)),
    # more tasks than SMs, each wider than a block's strips: more than one wave
    (128, 2, 4633, 4633, _occupancy, (19, 8, False)),
])
def test_dp_launch_plan(B, ntasks, nmax, mmax, occupancy, plan):
    """The fill rule at an H100's occupancy (``_occupancy``): the plan's
    shape, the card's limits, and every cell covered once."""
    got = traj_dp_kernel.launch_plan(B, ntasks, nmax, mmax, 132, occupancy)
    assert tuple(got[:3]) == plan
    traj_dp_kernel.check_plan(got, nmax, mmax)
    rows, cols = (mmax, nmax) if got.swap else (nmax, mmax)
    assert (got.rows, got.cols) == (rows, cols) and rows >= cols
    assert 32 * got.warps <= traj_dp_kernel.MAX_THREADS <= 1024
    assert got.cluster <= traj_dp_kernel.MAX_CLUSTER
    assert got.smem == traj_dp_kernel.smem_bytes(rows, cols, got.warps) <= traj_dp_kernel.SMEM_LIMIT
    # no block without a strip: the last block holds columns
    assert (got.cluster - 1) * got.warps * 32 < cols
    _assert_covers(got, rows, cols)


def test_dp_limits_read_from_the_source():
    """The wrapper's limits are the kernel's constexprs, and the layout they
    describe holds: whole warps within a block, a ring of a power of two
    rows that both hand-off chunks divide, a slot a kind."""
    T = traj_dp_kernel
    const = T._CONST
    assert (T.MAX_THREADS, T.MAX_CLUSTER, T.RING, T.KINDS_SLOTS) == (
        const["kMaxThreads"], const["kMaxCluster"], const["kRing"], const["kKinds"])
    assert T.MAX_THREADS % 32 == 0 and T.MAX_THREADS <= 1024 and T.MAX_CLUSTER <= 16
    assert T.RING & (T.RING - 1) == 0
    for chunk in (const["kChunk"], const["kRemoteChunk"]):
        assert chunk & (chunk - 1) == 0 and T.RING % chunk == 0 and 2 * chunk <= T.RING
    assert T.KINDS_SLOTS == len(T.KINDS) and const["kMaxTasks"] >= T.MAX_VARIANTS


def test_dp_launch_plan_rejects():
    """Grids whose points do not fit a block's shared memory raise, as do
    plans that leave columns out or exceed the kernel's blocks."""
    with pytest.raises(ValueError):
        traj_dp_kernel.launch_plan(2, 2, 9000, 9000, 132, _occupancy)
    with pytest.raises(ValueError):
        traj_dp_kernel.launch_plan(0, 2, 100, 100, 132, _occupancy)
    ok = traj_dp_kernel.make_plan(4633, 580, 1, False)
    traj_dp_kernel.check_plan(ok, 4633, 580)
    for bad in (ok._replace(warps=21), ok._replace(cluster=17),
                ok._replace(warps=18, smem=traj_dp_kernel.smem_bytes(4633, 580, 18)),
                ok._replace(smem=ok.smem + 4), ok._replace(swap=True)):
        with pytest.raises(ValueError):
            traj_dp_kernel.check_plan(bad, 4633, 580)
    with pytest.raises(ValueError):  # longer than the plan holds
        traj_dp_kernel.check_plan(ok, 4634, 580)


def test_dp_tasks_group_variants_by_metric():
    """One task a (pair, metric); a second variant of a kind opens another."""
    T = traj_dp_kernel
    spec = [v[1:] for v in D.dp_variants()]
    assert T.tasks(spec) == (T.Task(T.PLANAR_ALL, (0, 2, 4, 6, 8), 0.009, 0.009),
                             T.Task(T.SPHERICAL_ALL, (1, 3, 5, 7, -1), 0.009, 9000.0))
    assert T.tasks([("discret_frechet", "euclidean", 0.0)]) == (
        T.Task(T.FRECHET_ONLY, (-1, -1, -1, -1, 0), 0.0, 0.0),)
    got = T.tasks([("edr", "spherical", 0.5), ("dtw", "euclidean", 0.0),
                   ("edr", "spherical", 0.7), ("discret_frechet", "euclidean", 0.0)])
    assert got == (T.Task(T.SPHERICAL_ALL, (-1, -1, 0, -1, -1), 0.5, 0.0),
                   T.Task(T.PLANAR_ALL, (1, -1, -1, -1, 3), 0.0, 0.0),
                   T.Task(T.SPHERICAL_ALL, (-1, -1, 2, -1, -1), 0.7, 0.0))


def _per_sm(threads, chunk, k):
    """Blocks an H100 SM holds at the build's most registers a thread (64:
    __launch_bounds__(1024)): at most 2048 threads, 64K registers, 32 blocks."""
    return min(32, 2048 // threads, 65536 // (64 * threads))


@pytest.mark.parametrize("B,mmax,sms,depth,plan", [
    # the [flyability] batch's buckets on an H100's 132 SMs
    (2, 4633, 132, None, (6, 1, 5, 928, 5, 126)),
    (64, 580, 132, None, (2, 2, 1, 608, 15, 128)),
    # their sequential schedules, and a forced depth
    (2, 4633, 132, 1, (1, 1, 5, 928, 30, 2)),
    (64, 580, 132, 1, (1, 1, 1, 608, 30, 64)),
    (64, 580, 132, 3, (3, 2, 2, 320, 10, 256)),
    # short rows: small blocks, many to an SM
    (2, 512, 132, None, (6, 1, 1, 512, 5, 126)),
    (1, 2, 132, None, (6, 1, 1, 32, 5, 63)),
    (130, 33, 132, None, (6, 2, 1, 32, 5, 4160)),
    # more pairs than one wave of the widest blocks: narrower blocks, no speculation
    (500, 580, 132, None, (1, 1, 3, 224, 30, 500)),
    # fewer SMs: a shallower tree, or narrower blocks
    (2, 4633, 66, None, (5, 1, 5, 928, 6, 62)),
    (64, 580, 16, None, (1, 1, 3, 224, 30, 64)),
    # the longest rows; more blocks than any plan fits in one wave
    (2, 8193, 132, None, (6, 1, 8, 1024, 5, 126)),
    (4000, 8193, 132, None, (1, 1, 8, 1024, 30, 4000)),
])
def test_frechet_launch_plan(B, mmax, sms, depth, plan):
    """The fill rule at an H100's occupancy (``_per_sm``) on ``sms`` SMs."""
    got = frechet_kernel.launch_plan(B, mmax, sms, _per_sm, depth)
    assert tuple(got) == plan
    frechet_kernel.check_plan(got, mmax)
    assert got.k <= 2 ** got.depth - 1
    assert got.rounds == len(frechet_kernel.round_levels(got.depth))
    assert got.blocks == B * -(-(2 ** got.depth - 1) // got.k)
    levels = frechet_kernel.round_levels(got.depth)
    assert sum(levels) == frechet_kernel.STEPS and max(levels) == got.depth
    with pytest.raises(ValueError):
        frechet_kernel.launch_plan(B, 8194, sms, _per_sm)
    with pytest.raises(ValueError):
        frechet_kernel.launch_plan(B, mmax, sms, _per_sm, frechet_kernel.MAX_DEPTH + 1)
    with pytest.raises(ValueError):
        frechet_kernel.launch_plan(0, mmax, sms, _per_sm)


@pytest.mark.parametrize("plan,mmax", [
    ((1, 1, 1, 600, 30, 2), 580),    # threads not whole warps
    ((1, 1, 8, 2048, 30, 2), 8193),  # more threads than a block holds
    ((1, 1, 1, 512, 30, 2), 580),    # the row not covered
    ((0, 1, 1, 608, 30, 2), 580),    # no depth
    ((7, 1, 1, 608, 5, 2), 580),     # past MAX_DEPTH
    ((2, 2, 5, 928, 15, 2), 4633),   # no such instance
    ((2, 3, 1, 608, 15, 2), 580),    # no such instance
])
def test_frechet_check_plan_rejects(plan, mmax):
    """A plan given to ``frechet`` that the kernel cannot run raises."""
    with pytest.raises(ValueError):
        frechet_kernel.check_plan(frechet_kernel.Plan(*plan), mmax)


def test_frechet_plain_reached_cells():
    """The plain decision's count of reached cells, the twin of the
    kernel's ``reached_cells``: against a cell-by-cell walk of the same
    free intervals (float64 numpy), at a threshold below, at and above the
    distance; zero where the endpoints fail."""
    p, q, n, m = _batch([(9, 7), (12, 12), (5, 12)], seed=8, step=0.05)
    f = D.frechet_bisect(p, q, n, m, D._discret_frechet_rows(D._eucl_pdist(p, q), n, m))
    pp, qp = D._repeat_last(p, n), D._repeat_last(q, m)
    for scale in (0.5, 1.0, 1.5):
        eps = f * scale
        ok, cells = D._frechet_decision(pp, qp, eps, (n, m))
        assert torch.equal(ok, D._frechet_decision(pp, qp, eps))
        for b in range(len(n)):
            nb, mb, e = int(n[b]), int(m[b]), float(eps[b])

            def free(a0, a1, c):
                lo, hi = D._free_intervals(torch.tensor(a0), torch.tensor(a1), torch.tensor(c),
                                           torch.tensor(e))
                return float(lo), float(hi)

            P, Q = pp[b, :nb].numpy(), qp[b, :mb].numpy()
            ends = max(np.sum((P[0] - Q[0]) ** 2), np.sum((P[-1] - Q[-1]) ** 2)) <= np.float32(e) ** 2
            rv = [[np.inf] * mb for _ in range(nb - 1)]  # R_V(i, j) lo
            rh = [[np.inf] * (mb - 1) for _ in range(nb)]  # R_H(i, j) lo
            for i in range(nb - 1):
                lo, hi = free(P[i], P[i + 1], Q[0])
                if lo <= 0 <= hi and (i == 0 or rv[i - 1][0] == 0 and free(P[i - 1], P[i], Q[0]) == (0, 1)):
                    rv[i][0] = 0.0
            for j in range(mb - 1):
                lo, hi = free(Q[j], Q[j + 1], P[0])
                if lo <= 0 <= hi and (j == 0 or rh[0][j - 1] == 0 and free(Q[j - 1], Q[j], P[0]) == (0, 1)):
                    rh[0][j] = 0.0
            want = 0
            for i in range(nb - 1):
                for j in range(mb - 1):
                    x, y = rv[i][j], rh[i][j]
                    want += x < np.inf or y < np.inf
                    a, h = free(P[i], P[i + 1], Q[j + 1])
                    tlo, thi = free(Q[j], Q[j + 1], P[i + 1])
                    rv[i][j + 1] = (a if a <= h else np.inf) if y < np.inf else (
                        max(a, x) if a <= h and x <= h else np.inf)
                    t = tlo if x < np.inf else (max(tlo, y) if y < np.inf else np.inf)
                    rh[i + 1][j] = t if t <= thi else np.inf
            assert int(cells[b]) == (want if ends else 0), (scale, b)


def test_cells_counts_the_true_grids():
    """The cells, and the operations behind chip_smoke.py's bound: a cell's
    cost once for each metric the variants use, and one step a variant."""
    import chip_smoke

    n, m = [4633, 10], [580, 3]
    cells = traj_dp_kernel.cells(n, m)
    assert cells == 4633 * 580 + 30
    spec = [v[1:] for v in D.dp_variants()]
    assert chip_smoke.fly_bound(n, m, spec)[2] == cells * (7 + 16 + 39)
    assert chip_smoke.fly_bound(n, m, [("discret_frechet", "euclidean", 0.0)])[2] == cells * 10
    two_eps = [("edr", "spherical", 0.5), ("edr", "spherical", 0.7), ("lcss", "euclidean", 0.1)]
    assert chip_smoke.fly_bound(n, m, two_eps)[2] == cells * (16 + 7 + 6 + 6 + 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _dp_check(p, q, n, m, eps=0.009, variants=None, plan=None):
    """One launch against ``dp_metrics`` on the card (EDR, LCSS and the
    discrete Frechet exactly, DTW and ERP 1e-5 relative), and a second
    launch with the same bits."""
    variants = variants or [v[1:] for v in D.dp_variants(eps)]
    pc, qc = p.cuda(), q.cuda()
    before = traj_dp_kernel.launch_count
    out = traj_dp_kernel.traj_dp(pc, qc, n, m, G, variants, plan=plan)
    torch.cuda.synchronize()
    assert traj_dp_kernel.launch_count == before + 1
    ref = D.dp_metrics(pc, qc, n.cuda(), m.cuda(), G, variants)
    for k, (kind, metric, e) in enumerate(variants):
        got, want = out[:, k].cpu(), ref[:, k].cpu()
        if kind in ("edr", "lcss", "discret_frechet"):
            assert torch.equal(got, want), (kind, metric, e)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0, msg=f"{kind} {metric}")
    # no atomics: the same bits again
    assert torch.equal(out, traj_dp_kernel.traj_dp(pc, qc, n, m, G, variants, plan=plan))
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
@pytest.mark.parametrize("shapes,cluster,swap,seed", [
    ([(70, 20)], 1, False, 41),                       # one strip
    ([(90, 200), (150, 170)], 1, True, 41),           # several strips in a block; n < m
    ([(200, 150), (120, 199), (37, 5)], 4, False, 41),  # a cluster; ragged lengths
    # the ring wraps: across blocks (a part-filled last block), and in a block
    ([(300, 260), (260, 300)], 3, False, 42),
    ([(300, 97), (97, 300)], 1, True, 43),
    ([(400, 300), (211, 300)], 2, False, 44),
])
def test_dp_kernel_plan_branches_on_card(shapes, cluster, swap, seed, card):
    """Each branch a plan has (one strip or several, a block or a cluster,
    either side across the lanes, the hand-off ring wrapping in a block and
    across blocks) against the plain version."""
    p, q, n, m = _batch(shapes, seed=seed)
    plan = traj_dp_kernel.make_plan(int(n.max()), int(m.max()), cluster, swap)
    assert plan.cluster == cluster
    _dp_check(p, q, n, m, plan=plan)


@pytest.mark.gpu
@pytest.mark.parametrize("variants", [
    [("dtw", "euclidean", 0.0), ("lcss", "euclidean", 0.05)],
    [("erp", "spherical", 0.0)],
    [("discret_frechet", "euclidean", 0.0), ("dtw", "spherical", 0.0),
     ("edr", "euclidean", 0.02)],
    [("edr", "spherical", 900.0), ("edr", "spherical", 3000.0), ("lcss", "spherical", 900.0)],
])
def test_dp_kernel_variant_subsets_on_card(variants, card):
    """Subsets of one metric and of both, in any order, and two EDRs of
    different eps (two tasks of one metric)."""
    _dp_check(*_batch([(90, 60), (60, 90), (75, 75)], seed=50), variants=variants)


@pytest.mark.gpu
def test_dp_kernel_bucket_plans_on_card(card):
    """The plans the [flyability] batch's two buckets take on the card (a
    block of strips a task; a cluster a task), on pairs cut to 300 rows:
    past two turns of the 128-row hand-off ring, so that it wraps and a
    strip waits on the reader, while the plain version stays quick."""
    for B, nmax, mmax, seed in ((64, 4633, 580, 60), (2, 4633, 4633, 61)):
        plan = traj_dp_kernel.card_plan(B, 2, nmax, mmax, "cuda")
        assert not plan.swap and (plan.rows, plan.cols) == (nmax, mmax)
        p, q, n, m = _batch([(300, mmax)] * 2, seed=seed, step=0.01)
        _dp_check(p, q, n, m, plan=plan)


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


def _frechet_check(p, q, n, m, plan=None):
    """The kernel at the card's plan (or ``plan``): one launch a round, equal
    to the sequential schedule (depth 1), within 1e-5 of the plain version."""
    pc, qc = p.cuda(), q.cuda()
    spec = [("discret_frechet", "euclidean", 0.0)]
    hi = traj_dp_kernel.traj_dp(pc, qc, n, m, G, spec)[:, 0].contiguous()
    if plan is None:
        plan = frechet_kernel.card_plan(len(n), int(m.max()), "cuda")
    before = frechet_kernel.launch_count
    got = frechet_kernel.frechet(pc, qc, n, m, hi, plan=plan)
    torch.cuda.synchronize()
    assert frechet_kernel.launch_count == before + plan.rounds
    assert torch.equal(got, frechet_kernel.frechet(pc, qc, n, m, hi, depth=1))
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
    """The wide rows' plans: a (48, 4633) pair in bucket (64, 5120) at 8 row
    elements a thread (the most, which rows past 7169 edges take) and at the
    plan's 5, which the (5120, 5120) bucket takes too. The plain version's
    cost grows with p's rows, so this runs in seconds."""
    p, q, n, m = _batch([(48, 4633)], seed=20, step=0.01)
    assert tuple(p.shape[1:2] + q.shape[1:2]) == (64, 5120)
    chunk8 = frechet_kernel.Plan(6, 1, 8, frechet_kernel.threads_for(4633, 8), 5, 63)
    assert frechet_kernel.CHUNKS[-1] == 8 and chunk8.threads == 608
    _frechet_check(p, q, n, m, chunk8)
    plan = frechet_kernel.card_plan(1, 4633, "cuda")
    assert (plan.depth, plan.k, plan.chunk, plan.threads) == (6, 1, 5, 928)
    assert frechet_kernel.card_plan(2, 4633, "cuda") == plan._replace(blocks=126)
    _frechet_check(p, q, n, m)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", range(1, 7))
def test_frechet_kernel_every_depth_equal_on_card(depth, card):
    """Every depth the plan can choose gives the sequential schedule's
    values bit for bit, at every block shape the kernel has."""
    assert frechet_kernel.MAX_DEPTH == 6
    p, q, n, m = _batch([(33, 64), (64, 33), (40, 40), (2, 9), (9, 2)], seed=30)
    pc, qc = p.cuda(), q.cuda()
    hi = traj_dp_kernel.traj_dp(pc, qc, n, m, G, [("discret_frechet", "euclidean", 0.0)])
    hi = hi[:, 0].contiguous()
    ref = frechet_kernel.frechet(pc, qc, n, m, hi, depth=1)
    assert torch.equal(frechet_kernel.frechet(pc, qc, n, m, hi, depth=depth), ref)
    for chunk, k in frechet_kernel.INSTANCES:  # every block shape at this depth
        if k <= 2 ** depth - 1:
            plan = frechet_kernel.Plan(depth, k, chunk, frechet_kernel.threads_for(64, chunk),
                                       len(frechet_kernel.round_levels(depth)), 0)
            assert torch.equal(frechet_kernel.frechet(pc, qc, n, m, hi, plan=plan), ref), plan


@pytest.mark.gpu
def test_frechet_reached_cells_match_plain_on_card(card):
    """The kernel's count of the cells each sequential decision reaches (the
    work behind chip_smoke.py's bound) equals the plain decision's, step by
    step, and its steps end at the kernel's distance."""
    p, q, n, m = _batch([(33, 64), (64, 33), (40, 40), (2, 9), (9, 2)], seed=31)
    pc, qc, nc, mc = p.cuda(), q.cuda(), n.cuda(), m.cuda()
    hi = traj_dp_kernel.traj_dp(pc, qc, n, m, G, [("discret_frechet", "euclidean", 0.0)])
    hi = hi[:, 0].contiguous()
    got = frechet_kernel.reached_cells(pc, qc, n, m, hi)
    lo = torch.maximum(torch.sqrt(D._sq_dist(pc[:, 0], qc[:, 0])),
                       torch.sqrt(D._sq_dist(pc[:, -1], qc[:, -1])))
    h, want = hi.clone(), []
    for _ in range(frechet_kernel.STEPS):
        eps = 0.5 * (lo + h)
        ok, cells = D._frechet_decision(pc, qc, eps, (nc, mc))
        want.append(cells)
        lo, h = torch.where(ok, lo, eps), torch.where(ok, eps, h)
    assert torch.equal(got, torch.stack(want))
    assert bool((got > 0).any())
    assert torch.equal(h, frechet_kernel.frechet(pc, qc, n, m, hi))


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
    """One launch of the DP kernel a bucket and the rounds of the Frechet's
    plan, the CPU's values."""
    rng = np.random.default_rng(5)
    gens = [np.cumsum(rng.normal(0, 0.03, (n, 2)), 0) + [48, 5] for n in (14, 25, 40, 300)]
    sims = [np.cumsum(rng.normal(0, 0.03, (m, 2)), 0) + [48, 5] for m in (18, 25, 9, 35)]
    groups = D.shape_buckets(gens, sims, "cpu")
    assert len(groups) == 3
    rounds = sum(frechet_kernel.card_plan(len(idxs), int(m.max()), "cuda").rounds
                 for idxs, _, _, _, m in groups.values())
    before = (traj_dp_kernel.launch_count, frechet_kernel.launch_count)
    card_out = D.calculate_trajectory_distances_batch(gens, sims, G, device="cuda")
    assert (traj_dp_kernel.launch_count, frechet_kernel.launch_count) == \
        (before[0] + len(groups), before[1] + rounds)
    cpu_out = D.calculate_trajectory_distances_batch(gens, sims, G, device="cpu")
    for k in D.KEYS:
        # the spherical cross-track formula amplifies the last-ulp differences
        # of the card's and the CPU's sin/cos (tests/test_torch_flyability.py)
        rtol = 1e-3 if k in ("SSPD Spherical", "Hausdorff Spherical") else 1e-4
        np.testing.assert_allclose(card_out[k], cpu_out[k], rtol=rtol, err_msg=k)
