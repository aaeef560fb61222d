"""The trajectory dynamic programs as one CUDA kernel launch, and its plan.

Replaces the row loops of the JAX package's jnp code (no ``pallas_call``):
``dtw``, ``erp``, ``edr``, ``lcss`` and ``discret_frechet`` in
``tvqvae_tpu/evaluation/flyability/distances.py:187-331``, where each row is
one ``lax.associative_scan`` and the rows run under ``lax.scan``, vmapped
over a bucket of flight pairs.

``traj_dp(p, q, n, m, g, variants, plan=None)`` maps p (B, P, 2), q (B, Q,
2) float32 [lat, lon] (padded by repeating the last point), true lengths n,
m (B,) and the gap point g (2,) to (B, V) float32: one value per pair and
variant, a variant being (kind, metric, eps) with kind in ``KINDS`` and
metric "euclidean" (planar degrees) or "spherical" (great-circle metres). It
launches ``tvqvae_tpu_torch/csrc/traj_dp.cu`` once, built with nvcc for
``sm_90a`` at first use, and raises for tensors that are not on a CUDA
device. Its plain version, the JAX package's row loops in PyTorch, is
``evaluation/flyability/distances.py::dp_metrics``, which that module runs on
CPU tensors.

The launch runs one task per (pair, metric): a cell's cost is computed once
for every recurrence of that metric the call asks for (``tasks``). A task's
grid is walked with its shorter side across the lanes: each warp owns a
strip of 32 columns, one to a lane, and sweeps the rows in a skewed pipeline
with the DP state in registers; strips hand their last column on through
shared memory, within a block or across the blocks of a thread-block cluster.
``launch_plan`` is a fill rule: each task spread over as many SMs (a cluster
of up to 16 blocks) as the card has for it, the widest such cluster whose
blocks all fit one wave. What bounds the kernel: a pipeline of rows + 32 x
strips steps (plus the hand-offs) whose step is a lane's cell, and the
great-circle costs' instructions (notes at the top of the ``.cu`` file).
"""

import ctypes
import re
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tvqvae_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "traj_dp.cu"
KINDS = {"dtw": 0, "erp": 1, "edr": 2, "lcss": 3, "discret_frechet": 4}
METRICS = {"euclidean": 0, "spherical": 1}
MAX_VARIANTS = 16
# the kernel's instances (TaskType in traj_dp.cu): the recurrences a task runs
PLANAR_ALL, FRECHET_ONLY, SPHERICAL_ALL = 0, 1, 2
# the kernel's limits and layout, read from its source's constexprs
_CONST = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}
MAX_THREADS = _CONST["kMaxThreads"]  # a block's threads
MAX_CLUSTER = _CONST["kMaxCluster"]  # blocks a cluster (non-portable above 8)
RING, KINDS_SLOTS = _CONST["kRing"], _CONST["kKinds"]  # a strip's hand-off ring
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100

# Launches of the CUDA kernel (one per wrapper call that reaches the card).
launch_count = 0

_c_int_p = ctypes.POINTER(ctypes.c_int)
_lib = nvcc.Library(SOURCE, {
    "traj_dp": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # p, q, n, m
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # B, P, Q
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # rows, cols, swap
        ctypes.c_float, ctypes.c_float, ctypes.c_int,                        # g, sum_threads
        ctypes.c_int, _c_int_p, _c_int_p, ctypes.POINTER(ctypes.c_float),    # tasks
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # V, warps, cluster
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,                      # smem, out, stream
    ], ctypes.c_int),
    "traj_dp_occupancy": ([
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # warps, cluster, smem
        ctypes.c_void_p, ctypes.c_void_p,          # int* blocks, int* clusters
    ], ctypes.c_int),
})


def build(verbose: bool = False):
    return _lib.build(verbose)


class Task(NamedTuple):
    type: int                           # PLANAR_ALL, FRECHET_ONLY or SPHERICAL_ALL
    slots: Tuple[int, int, int, int, int]  # each kind's output column, -1 if not asked
    eps_edr: float
    eps_lcss: float


def tasks(variants) -> Tuple[Task, ...]:
    """The tasks of a pair: variants grouped by metric (in order of first
    appearance), at most one of each kind to a task; a second variant of a
    kind and metric (another eps) opens another task of that metric."""
    groups = []  # [metric, {kind: (slot, eps)}]
    for v, (kind, metric, eps) in enumerate(variants):
        group = next((g for g in groups if g[0] == metric and kind not in g[1]), None)
        if group is None:
            group = [metric, {}]
            groups.append(group)
        group[1][kind] = (v, float(eps))
    out = []
    for metric, kinds in groups:
        if metric == "spherical":
            ty = SPHERICAL_ALL
        else:
            ty = FRECHET_ONLY if set(kinds) == {"discret_frechet"} else PLANAR_ALL
        slots = tuple(kinds[k][0] if k in kinds else -1 for k in KINDS)
        out.append(Task(ty, slots, kinds.get("edr", (0, 0.0))[1], kinds.get("lcss", (0, 0.0))[1]))
    return tuple(out)


class Plan(NamedTuple):
    warps: int    # warps a block, one strip of 32 columns each
    cluster: int  # blocks a task (a thread-block cluster)
    swap: bool    # lanes across p's points: rows are q's points
    rows: int     # the longest rows the plan holds (shared memory)
    cols: int     # the longest columns it covers
    smem: int     # dynamic shared memory a block


def smem_bytes(rows: int, cols: int, warps: int) -> int:
    """A block's shared memory (smem_bytes in traj_dp.cu): the rows' and
    columns' features as float4, a hand-off ring of RING rows x 5 kinds and
    two counters a warp, two sums."""
    return 16 * (rows + cols) + 4 * warps * RING * KINDS_SLOTS + 8 * warps + 8


def make_plan(nmax: int, mmax: int, cluster: int, swap: bool) -> Plan:
    """The plan over at most ``cluster`` blocks a task: the fewest warps a
    block that cover the columns, then the fewest blocks that hold those
    warps."""
    rows, cols = (mmax, nmax) if swap else (nmax, mmax)
    s = -(-cols // 32)
    warps = -(-s // min(cluster, s))
    cluster = -(-s // warps)
    return Plan(warps, cluster, swap, rows, cols, smem_bytes(rows, cols, warps))


def check_plan(plan: Plan, nmax: int, mmax: int):
    """Raise ValueError unless the kernel can run ``plan`` over grids of at
    most nmax x mmax: whole warps within its block limit, a cluster of at
    most MAX_CLUSTER, rows and columns within what it holds, every column
    covered, and the shared memory it needs."""
    rows, cols = (mmax, nmax) if plan.swap else (nmax, mmax)
    if not 1 <= plan.warps <= MAX_THREADS // 32 \
            or not 1 <= plan.cluster <= MAX_CLUSTER or rows > plan.rows or cols > plan.cols \
            or plan.warps * plan.cluster * 32 < plan.cols \
            or plan.smem != smem_bytes(plan.rows, plan.cols, plan.warps) \
            or plan.smem > SMEM_LIMIT:
        raise ValueError(f"plan {plan} cannot run grids of {nmax} x {mmax}")


def plans(nmax: int, mmax: int):
    """Every plan the kernel has for grids of at most nmax x mmax: each
    side across the lanes and each cluster size."""
    out = []
    for swap in (False, True):
        for cluster in range(1, MAX_CLUSTER + 1):
            plan = make_plan(nmax, mmax, cluster, swap)
            try:
                check_plan(plan, nmax, mmax)
            except ValueError:
                continue
            if plan not in out:
                out.append(plan)
    return out


def launch_plan(B: int, ntasks: int, nmax: int, mmax: int, sms: int,
                occupancy: Callable[[int, int, int], Tuple[int, int]]) -> Plan:
    """The plan of a launch of B pairs of ``ntasks`` tasks each over grids of
    at most nmax x mmax, on a card of ``sms`` SMs whose occupancy for a plan
    is ``occupancy(warps, cluster, smem)`` -> (blocks an SM holds, clusters
    the card holds at once). A fill rule: the lanes run across the shorter
    side; each task takes up to sms // tasks SMs, as the widest cluster of
    at most MAX_CLUSTER blocks whose blocks all fit one wave (more blocks
    where one cannot hold the strips). Where none fits one wave, the
    widest the card places; the launch then runs in more than one."""
    if B < 1 or ntasks < 1:
        raise ValueError(f"need pairs and tasks, got B={B}, ntasks={ntasks}")
    swap = mmax > nmax
    spread = max(1, min(MAX_CLUSTER, sms // (B * ntasks)))
    placed = []
    for cluster in [*range(spread, 0, -1), *range(spread + 1, MAX_CLUSTER + 1)]:
        plan = make_plan(nmax, mmax, cluster, swap)
        try:
            check_plan(plan, nmax, mmax)
        except ValueError:
            continue
        blocks, clusters = occupancy(plan.warps, plan.cluster, plan.smem)
        if blocks < 1 or clusters < 1:
            continue
        if B * ntasks * plan.cluster <= sms * blocks and \
                (plan.cluster == 1 or clusters >= B * ntasks):
            return plan
        placed.append(plan)
    if not placed:
        raise ValueError(f"grids of {nmax} x {mmax} need more shared memory or threads than a "
                         "block has")
    return placed[0]


_occupancy = {}


def card_occupancy(warps: int, cluster: int, smem: int) -> Tuple[int, int]:
    """(blocks one SM of the current card holds, clusters it holds at once)
    of the built kernel at this plan (the CUDA occupancy queries)."""
    key = (torch.cuda.current_device(), warps, cluster, smem)
    if key not in _occupancy:
        lib = _lib.get()
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        _lib.check("traj_dp_occupancy", lib.traj_dp_occupancy(
            warps, cluster, smem, ctypes.byref(blocks), ctypes.byref(clusters)))
        _occupancy[key] = (blocks.value, clusters.value)
    return _occupancy[key]


def card_plan(B: int, ntasks: int, nmax: int, mmax: int, device) -> Plan:
    """``launch_plan`` on the given CUDA device: its SM count and the built
    kernel's occupancy."""
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return launch_plan(B, ntasks, nmax, mmax, sms, card_occupancy)


def sum_threads(nmax: int, mmax: int) -> int:
    """The block size whose order ERP's border sums take: whole warps over
    min(nmax, mmax), at most 1024 (the one-block-a-variant kernel's block,
    so the sums keep its bits)."""
    return min(1024, max(32, -(-min(nmax, mmax) // 32) * 32))


def cells(n, m) -> int:
    """Grid cells a task updates: sum of n*m over pairs."""
    return sum(int(a) * int(b) for a, b in zip(n, m))


def _lengths(x, B, full):
    t = torch.as_tensor(x).reshape(-1).expand(B).to(torch.int64).cpu()
    if bool((t < 1).any()) or bool((t > full).any()):
        raise ValueError(f"true lengths must lie in [1, {full}], got {t.tolist()}")
    return t


def _check(p, q, variants):
    if p.dim() != 3 or q.dim() != 3 or p.shape[-1] != 2 or q.shape[-1] != 2 \
            or p.shape[0] != q.shape[0]:
        raise ValueError(f"need p (B, P, 2) and q (B, Q, 2), got {tuple(p.shape)}, "
                         f"{tuple(q.shape)}")
    if p.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"need float32, got {p.dtype} and {q.dtype}")
    if p.device != q.device or p.device.type != "cuda":
        raise ValueError(f"need p and q on one CUDA device, got {p.device} and {q.device}")
    if not (p.is_contiguous() and q.is_contiguous()):
        raise ValueError("p and q must be contiguous")
    if not 1 <= len(variants) <= MAX_VARIANTS:
        raise ValueError(f"need 1 to {MAX_VARIANTS} variants, got {len(variants)}")
    for kind, metric, _ in variants:
        if kind not in KINDS or metric not in METRICS:
            raise ValueError(f"unknown variant ({kind!r}, {metric!r})")
        if kind == "discret_frechet" and metric != "euclidean":
            raise ValueError("the discrete Frechet is planar only")


@torch.no_grad()
def traj_dp(p: torch.Tensor, q: torch.Tensor, n, m, g, variants,
            plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, P, 2) x (B, Q, 2), lengths (B,) -> (B, V) DP values, in one
    launch at the card's ``launch_plan`` or at ``plan`` (``check_plan``)."""
    global launch_count
    variants = [tuple(v) for v in variants]
    _check(p, q, variants)
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]
    n_host, m_host = _lengths(n, B, P), _lengths(m, B, Q)
    nmax, mmax = int(n_host.max()), int(m_host.max())
    task = tasks(variants)
    if plan is None:
        plan = card_plan(B, len(task), nmax, mmax, p.device)
    check_plan(plan, nmax, mmax)
    g0, g1 = (float(v) for v in torch.as_tensor(g, dtype=torch.float32).reshape(2).tolist())
    T = len(task)
    types = (ctypes.c_int * T)(*(t.type for t in task))
    slots = (ctypes.c_int * (5 * T))(*(s for t in task for s in t.slots))
    eps = (ctypes.c_float * (2 * T))(*(e for t in task for e in (t.eps_edr, t.eps_lcss)))
    n_dev = n_host.to(device=p.device, dtype=torch.int32)
    m_dev = m_host.to(device=p.device, dtype=torch.int32)
    out = torch.empty(B, len(variants), dtype=torch.float32, device=p.device)
    lib = _lib.get()
    with torch.cuda.device(p.device):
        err = lib.traj_dp(
            p.data_ptr(), q.data_ptr(), n_dev.data_ptr(), m_dev.data_ptr(), B, P, Q,
            plan.rows, plan.cols, int(plan.swap), g0, g1, sum_threads(nmax, mmax),
            T, types, slots, eps, len(variants), plan.warps, plan.cluster, plan.smem,
            out.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream,
        )
    _lib.check("traj_dp", err)
    launch_count += 1
    return out
