"""The continuous Fréchet distance as CUDA kernel launches, and its plan.

Replaces the JAX package's jnp bisection (no ``pallas_call``):
``frechet_jax`` and ``_frechet_decision_jax`` in
``tvqvae_tpu/evaluation/flyability/distances.py:378-524``, 30 bisection
steps, each an Alt-Godau free-space decision whose rows are ``lax.scan``
steps and whose in-row propagation is a ``lax.associative_scan`` of the
five-tuple maps (r, c, A, C, F), vmapped over a bucket of flight pairs.

``frechet(p, q, n, m, hi, depth=None)`` maps p (B, P, 2), q (B, Q, 2)
float32 planar points (padded by repeating the last point), true lengths n,
m (B,) with n, m >= 2 and the discrete Fréchet hi (B,) to (B,) float32: 30
bisection steps from lo = max(endpoint distances), each halving [lo, hi] by
the decision at its midpoint. It runs them as ceil(30 / depth) launches of
``tvqvae_tpu_torch/csrc/frechet_decision.cu``, one a round of speculative
bisection: every round decides the 2^depth - 1 midpoints of the next depth
levels of the bisection tree for every pair at once, K candidates to a
thread block, and walks the tree down the decisions, so the result equals
the 30 sequential steps bit for bit at every depth. ``launch_plan`` picks
the row elements a thread, the depth and the candidates a block by a fill
rule: the shortest wavefront, then the fewest rounds whose blocks fit in
one wave on the card; ``depth=1`` forces the sequential schedule, ``plan=``
a given plan. It raises for tensors that are not on a CUDA device. Its
plain version is ``evaluation/flyability/distances.py::frechet_bisect``,
with the same depth schedule, which that module runs on CPU tensors at
depth 1. ``reached_cells`` counts the cells the 30 sequential decisions
reach (the work they need).

A decision walks the free-space grid as a wavefront: thread t owns a chunk
of q's columns and walks row s - t at step s, entering with what thread
t - 1 left at step s - 1, and skips the arithmetic of cells that nothing
reaches. What bounds the kernel: the chain of rounds x (n - 1 + threads -
1) dependent steps, each as long as one thread's chunk of reachable cells
and a barrier.
"""

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from tvqvae_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "frechet_decision.cu"
STEPS = 30  # bisection steps: the JAX package's fori_loop
MAX_THREADS = 1024
MAX_DEPTH = 6  # depth 7 takes depth 6's five rounds for twice the decisions
CHUNKS = (1, 2, 3, 4, 5, 6, 7, 8)  # row elements a thread
# (row elements a thread, candidates a block): the kernel's template
# instances; two candidates only up to 4 elements, where a thread's 2 x chunk
# bottom edges stay in registers
INSTANCES = tuple((c, 1) for c in CHUNKS) + tuple((c, 2) for c in CHUNKS[:4])

# Launches of the CUDA kernel (one per round of each wrapper call that reaches the card).
launch_count = 0

_lib = nvcc.Library(SOURCE, {
    "frechet_decision": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # p, q, n, m
        ctypes.c_void_p,                                                     # hi
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # B, P, Q
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # threads, chunk, k
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # levels, first, last
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # lo, hi, ok, stride
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # done, out, cells
        ctypes.c_void_p,                                                     # stream
    ], ctypes.c_int),
    "frechet_decision_blocks_per_sm": ([
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # threads, chunk, k
        ctypes.c_void_p,                           # int* blocks
    ], ctypes.c_int),
})


def build(verbose: bool = False):
    return _lib.build(verbose)


class Plan(NamedTuple):
    depth: int    # bisection levels a round
    k: int        # candidates a block
    chunk: int    # row elements a thread
    threads: int  # threads a block
    rounds: int   # launches: ceil(STEPS / depth)
    blocks: int   # blocks of a full round: B * ceil((2^depth - 1) / k)


def round_levels(depth: int):
    """Bisection levels of each round: ``depth`` each, the last what remains."""
    return [min(depth, STEPS - s) for s in range(0, STEPS, depth)]


def active_threads(mmax: int, chunk: int) -> int:
    """Threads that hold columns: the wavefront's depth across a row."""
    return -(-max(1, mmax - 1) // chunk)


def threads_for(mmax: int, chunk: int) -> Optional[int]:
    """Threads that cover a row of mmax - 1 elements at ``chunk`` a thread (a
    multiple of 32), or None past MAX_THREADS."""
    threads = max(32, -(-active_threads(mmax, chunk) // 32) * 32)
    return threads if threads <= MAX_THREADS else None


def _plan(B: int, depth: int, k: int, chunk: int, threads: int) -> Plan:
    return Plan(depth, k, chunk, threads, len(round_levels(depth)),
                B * -(-(2 ** depth - 1) // k))


def launch_plan(B: int, mmax: int, sms: int, blocks_per_sm: Callable[[int, int, int], int],
                depth: Optional[int] = None) -> Plan:
    """The launch plan of a bucket of B pairs whose q has at most mmax points,
    on a card of ``sms`` SMs that hold ``blocks_per_sm(threads, chunk, k)``
    blocks each. A fill rule: the first plan whose round fits in one wave of
    blocks, taking the fewest row elements a thread (the shortest wavefront),
    then the fewest rounds (the deepest tree), then the fewest candidates a
    block; at ``depth`` if one is given. Where no plan
    fits one wave, the fewest row elements a thread at depth 1 (or
    ``depth``) and one candidate a block."""
    if B < 1:
        raise ValueError(f"need at least one pair, got B={B}")
    if depth is not None and not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must lie in [1, {MAX_DEPTH}], got {depth}")
    chunks = [(c, threads_for(mmax, c)) for c in CHUNKS if threads_for(mmax, c) is not None]
    if not chunks:
        raise ValueError(f"rows of {mmax - 1} edges exceed {MAX_THREADS * CHUNKS[-1]}")
    depths = [depth] if depth is not None else range(MAX_DEPTH, 0, -1)  # fewest rounds first
    for chunk, threads in chunks:
        for d in depths:
            for k in (k for c, k in INSTANCES if c == chunk and k <= 2 ** d - 1):
                plan = _plan(B, d, k, chunk, threads)
                if plan.blocks <= sms * blocks_per_sm(threads, chunk, k):
                    return plan
    return _plan(B, depth or 1, 1, *chunks[0])


def check_plan(plan: Plan, mmax: int):
    """Raise ValueError unless the kernel can run ``plan`` over rows of
    mmax - 1 edges: an instance it has, whole warps of at most MAX_THREADS
    that cover the row, and a depth in [1, MAX_DEPTH]."""
    if (plan.chunk, plan.k) not in INSTANCES or plan.threads % 32 \
            or not 32 <= plan.threads <= MAX_THREADS or plan.threads * plan.chunk < mmax - 1 \
            or not 1 <= plan.depth <= MAX_DEPTH:
        raise ValueError(f"plan {plan} cannot run rows of {mmax - 1} edges")


_occupancy = {}


def card_blocks_per_sm(threads: int, chunk: int, k: int) -> int:
    """Blocks one SM of the current card holds (the CUDA occupancy query on
    the built kernel: its registers and shared memory)."""
    key = (torch.cuda.current_device(), threads, chunk, k)
    if key not in _occupancy:
        lib = _lib.get()
        out = ctypes.c_int(0)
        _lib.check("frechet_decision_blocks_per_sm",
                   lib.frechet_decision_blocks_per_sm(threads, chunk, k, ctypes.byref(out)))
        _occupancy[key] = out.value
    return _occupancy[key]


def card_plan(B: int, mmax: int, device, depth: Optional[int] = None) -> Plan:
    """``launch_plan`` on the given CUDA device: its SM count and the built
    kernel's occupancy."""
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return launch_plan(B, mmax, sms, card_blocks_per_sm, depth)


def _lengths(x, B, full):
    t = torch.as_tensor(x).reshape(-1).expand(B).to(torch.int64).cpu()
    if bool((t < 2).any()) or bool((t > full).any()):
        raise ValueError(f"true lengths must lie in [2, {full}], got {t.tolist()}")
    return t


def _check(p, q, hi):
    if p.dim() != 3 or q.dim() != 3 or p.shape[-1] != 2 or q.shape[-1] != 2 \
            or p.shape[0] != q.shape[0] or hi.shape != (p.shape[0],):
        raise ValueError(f"need p (B, P, 2), q (B, Q, 2), hi (B,), got {tuple(p.shape)}, "
                         f"{tuple(q.shape)}, {tuple(hi.shape)}")
    if p.dtype != torch.float32 or q.dtype != torch.float32 or hi.dtype != torch.float32:
        raise TypeError(f"need float32, got {p.dtype}, {q.dtype}, {hi.dtype}")
    if not (p.device == q.device == hi.device) or p.device.type != "cuda":
        raise ValueError(f"need p, q and hi on one CUDA device, got {p.device}, {q.device}, "
                         f"{hi.device}")
    if not (p.is_contiguous() and q.is_contiguous() and hi.is_contiguous()):
        raise ValueError("p, q and hi must be contiguous")


def _rounds(p, q, n, m, hi, depth, plan, cells=None):
    """Launch the rounds of ``plan`` (the card's, at ``depth`` if given);
    with ``cells`` ((rounds, B, 2^depth) int64 zeros) each round also adds
    up the cells its decisions reach. -> (out, plan)."""
    global launch_count
    _check(p, q, hi)
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]
    n_host, m_host = _lengths(n, B, P), _lengths(m, B, Q)
    mmax = int(m_host.max())
    if plan is None:
        plan = card_plan(B, mmax, p.device, depth)
    elif depth is not None:
        raise ValueError("give depth or plan, not both")
    check_plan(plan, mmax)
    dev = p.device
    n_dev = n_host.to(device=dev, dtype=torch.int32)
    m_dev = m_host.to(device=dev, dtype=torch.int32)
    state = torch.empty(2, B, dtype=torch.float32, device=dev)  # the bracket between rounds
    ok_stride = 2 ** plan.depth
    ok = torch.empty(B, ok_stride, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _lib.get()
    levels = round_levels(plan.depth)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r, lv in enumerate(levels):
            err = lib.frechet_decision(
                p.data_ptr(), q.data_ptr(), n_dev.data_ptr(), m_dev.data_ptr(), hi.data_ptr(),
                B, P, Q, plan.threads, plan.chunk, plan.k,
                lv, int(r == 0), int(r == len(levels) - 1),
                state[0].data_ptr(), state[1].data_ptr(), ok.data_ptr(), ok_stride,
                done.data_ptr(), out.data_ptr(), None if cells is None else cells[r].data_ptr(),
                stream,
            )
            _lib.check("frechet_decision", err)
            launch_count += 1
    return out, plan


@torch.no_grad()
def frechet(p: torch.Tensor, q: torch.Tensor, n, m, hi: torch.Tensor,
            depth: Optional[int] = None, plan: Optional[Plan] = None) -> torch.Tensor:
    """(B, P, 2) x (B, Q, 2), lengths (B,), hi (B,) -> (B,) Fréchet distances,
    in ``plan.rounds`` launches: the card's ``launch_plan``, at ``depth`` if
    given, or ``plan`` as given (``check_plan``)."""
    return _rounds(p, q, n, m, hi, depth, plan)[0]


@torch.no_grad()
def reached_cells(p: torch.Tensor, q: torch.Tensor, n, m, hi: torch.Tensor) -> torch.Tensor:
    """The work the 30 sequential decisions need, as the kernel counts it at
    depth 1: (30, B) int64, the cells (i, j) of each true grid whose R_V(i, j)
    or R_H(i, j) is nonempty at each step's eps (zero where the endpoints
    fail). A cell that nothing reaches needs no arithmetic. Its plain twin is
    ``distances._frechet_decision(..., cells=)``."""
    B = p.shape[0]
    cells = torch.zeros(STEPS, B, 2, dtype=torch.int64, device=p.device)
    _rounds(p, q, n, m, hi, 1, None, cells)
    return cells[:, :, 0]
