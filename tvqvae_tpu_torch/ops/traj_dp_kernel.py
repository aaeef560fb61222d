"""The trajectory dynamic programs as one CUDA kernel, and its plain twin.

Replaces the row loops of the JAX package's jnp code (no ``pallas_call``):
``dtw``, ``erp``, ``edr``, ``lcss`` and ``discret_frechet`` in
``tvqvae_tpu/evaluation/flyability/distances.py:187-331``, where each row is
one ``lax.associative_scan`` and the rows run under ``lax.scan``, vmapped
over a bucket of flight pairs.

``traj_dp(p, q, n, m, g, variants)`` maps p (B, P, 2), q (B, Q, 2) float32
[lat, lon] (padded by repeating the last point), true lengths n, m (B,) and
the gap point g (2,) to (B, V) float32: one value per pair and variant, a
variant being (kind, metric, eps) with kind in ``KINDS`` and metric
"euclidean" (planar degrees) or "spherical" (great-circle metres). It
launches ``tvqvae_tpu_torch/csrc/traj_dp.cu`` once, a thread block per
(pair, variant), built with nvcc for ``sm_90a`` at first use, and raises for
tensors that are not on a CUDA device. Its plain version, the JAX package's
row loops in PyTorch, is ``evaluation/flyability/distances.py::dp_metrics``,
which that module runs on CPU tensors.

The kernel sweeps anti-diagonals of the true n x m grid, each cell's cost
computed from the points in shared memory and never stored (notes at the top
of the ``.cu`` file). What bounds it: the chain of n + m - 1 dependent
diagonals, each one barrier; its operations, counted by ``cells``, bound it
far below that.
"""

import ctypes

import torch

from tvqvae_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "traj_dp.cu"
KINDS = {"dtw": 0, "erp": 1, "edr": 2, "lcss": 3, "discret_frechet": 4}
METRICS = {"euclidean": 0, "spherical": 1}
MAX_VARIANTS = 16  # kMaxVariants in traj_dp.cu
MAX_THREADS = 1024
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100

# Launches of the CUDA kernel (one per wrapper call that reaches the card).
launch_count = 0

_c_int_p = ctypes.POINTER(ctypes.c_int)
_lib = nvcc.Library(SOURCE, {
    "traj_dp": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # p, q, n, m
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # B, P, Q
        ctypes.c_int, ctypes.c_int,                                          # nmax, mmax
        ctypes.c_float, ctypes.c_float,                                      # g
        ctypes.c_int, _c_int_p, _c_int_p, ctypes.POINTER(ctypes.c_float),    # V, kinds, metrics, eps
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,        # threads, smem, out, stream
    ], ctypes.c_int),
})


def build(verbose: bool = False):
    return _lib.build(verbose)


def launch_plan(nmax: int, mmax: int):
    """(threads, diagonal buffer length, dynamic shared bytes) for a launch
    whose longest true lengths are nmax, mmax: per point 3 floats of
    features and 1 of gap cost for p and q, three anti-diagonals of
    min(nmax, mmax) floats, 32 floats of reduction scratch."""
    w = min(nmax, mmax)
    threads = min(MAX_THREADS, max(32, -(-w // 32) * 32))
    smem = 4 * (4 * (nmax + mmax) + 3 * w + 32)
    return threads, w, smem


def cells(n, m) -> int:
    """Grid cells the kernel updates per variant: sum of n*m over pairs."""
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
def traj_dp(p: torch.Tensor, q: torch.Tensor, n, m, g, variants) -> torch.Tensor:
    """(B, P, 2) x (B, Q, 2), lengths (B,) -> (B, V) DP values."""
    global launch_count
    variants = [tuple(v) for v in variants]
    _check(p, q, variants)
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]
    n_host, m_host = _lengths(n, B, P), _lengths(m, B, Q)
    threads, _, smem = launch_plan(int(n_host.max()), int(m_host.max()))
    if smem > SMEM_LIMIT:
        raise ValueError(f"true lengths up to ({int(n_host.max())}, {int(m_host.max())}) need "
                         f"{smem} bytes of shared memory, more than {SMEM_LIMIT}")
    g0, g1 = (float(v) for v in torch.as_tensor(g, dtype=torch.float32).reshape(2).tolist())
    V = len(variants)
    kinds = (ctypes.c_int * V)(*(KINDS[k] for k, _, _ in variants))
    metrics = (ctypes.c_int * V)(*(METRICS[mt] for _, mt, _ in variants))
    eps = (ctypes.c_float * V)(*(float(e) for _, _, e in variants))
    n_dev = n_host.to(device=p.device, dtype=torch.int32)
    m_dev = m_host.to(device=p.device, dtype=torch.int32)
    out = torch.empty(B, V, dtype=torch.float32, device=p.device)
    lib = _lib.get()
    with torch.cuda.device(p.device):
        err = lib.traj_dp(
            p.data_ptr(), q.data_ptr(), n_dev.data_ptr(), m_dev.data_ptr(), B, P, Q,
            int(n_host.max()), int(m_host.max()), g0, g1, V, kinds, metrics, eps,
            threads, smem, out.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream,
        )
    _lib.check("traj_dp", err)
    launch_count += 1
    return out
