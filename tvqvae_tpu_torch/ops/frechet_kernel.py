"""The continuous Fréchet distance as one CUDA kernel, and its plain twin.

Replaces the JAX package's jnp bisection (no ``pallas_call``):
``frechet_jax`` and ``_frechet_decision_jax`` in
``tvqvae_tpu/evaluation/flyability/distances.py:378-524``, 30 bisection
steps, each an Alt-Godau free-space decision whose rows are ``lax.scan``
steps and whose in-row propagation is a ``lax.associative_scan`` of the
five-tuple maps (r, c, A, C, F), vmapped over a bucket of flight pairs.

``frechet(p, q, n, m, hi)`` maps p (B, P, 2), q (B, Q, 2) float32 planar
points (padded by repeating the last point), true lengths n, m (B,) with
n, m >= 2 and the discrete Fréchet hi (B,) to (B,) float32: 30 bisection
steps from lo = max(endpoint distances), each halving [lo, hi] by the
decision at its midpoint. It launches
``tvqvae_tpu_torch/csrc/frechet_decision.cu`` once, one thread block per
pair running all 30 steps, and raises for tensors that are not on a CUDA
device. Its plain version is
``evaluation/flyability/distances.py::frechet_bisect``, which that module
runs on CPU tensors.

What bounds the kernel: the chain of 30 x (n - 1) dependent rows, each a
block-wide scan (two barriers); the free intervals it computes on the fly,
two per grid cell and step, bound it far below that.
"""

import ctypes

import torch

from tvqvae_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "frechet_decision.cu"
STEPS = 30  # kSteps in frechet_decision.cu
MAX_THREADS = 1024
CHUNKS = (1, 2, 4, 8)  # row elements a thread holds; the kernel's template instances

# Launches of the CUDA kernel (one per wrapper call that reaches the card).
launch_count = 0

_lib = nvcc.Library(SOURCE, {
    "frechet_decision": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # p, q, n, m
        ctypes.c_void_p,                                                     # hi
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # B, P, Q
        ctypes.c_int, ctypes.c_int,                                          # nmax, mmax
        ctypes.c_int, ctypes.c_int,                                          # threads, chunk
        ctypes.c_void_p, ctypes.c_void_p,                                    # out, stream
    ], ctypes.c_int),
})


def build(verbose: bool = False):
    return _lib.build(verbose)


def launch_plan(mmax: int):
    """(threads, chunk): each thread holds ``chunk`` consecutive elements of
    a row of mmax - 1 vertical edges, the fewest that 1024 threads cover."""
    elems = max(1, mmax - 1)
    need = -(-elems // MAX_THREADS)
    chunk = next((c for c in CHUNKS if c >= need), None)
    if chunk is None:
        raise ValueError(f"rows of {elems} edges exceed {MAX_THREADS * CHUNKS[-1]}")
    per_chunk = -(-elems // chunk)
    return max(32, -(-per_chunk // 32) * 32), chunk


def _lengths(x, B, full):
    t = torch.as_tensor(x).reshape(-1).expand(B).to(torch.int64).cpu()
    if bool((t < 2).any()) or bool((t > full).any()):
        raise ValueError(f"true lengths must lie in [2, {full}], got {t.tolist()}")
    return t


@torch.no_grad()
def frechet(p: torch.Tensor, q: torch.Tensor, n, m, hi: torch.Tensor) -> torch.Tensor:
    """(B, P, 2) x (B, Q, 2), lengths (B,), hi (B,) -> (B,) Fréchet distances."""
    global launch_count
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
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]
    n_host, m_host = _lengths(n, B, P), _lengths(m, B, Q)
    threads, chunk = launch_plan(int(m_host.max()))
    n_dev = n_host.to(device=p.device, dtype=torch.int32)
    m_dev = m_host.to(device=p.device, dtype=torch.int32)
    out = torch.empty(B, dtype=torch.float32, device=p.device)
    lib = _lib.get()
    with torch.cuda.device(p.device):
        err = lib.frechet_decision(
            p.data_ptr(), q.data_ptr(), n_dev.data_ptr(), m_dev.data_ptr(), hi.data_ptr(),
            B, P, Q, int(n_host.max()), int(m_host.max()), threads, chunk,
            out.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream,
        )
    _lib.check("frechet_decision", err)
    launch_count += 1
    return out
