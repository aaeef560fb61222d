"""Fused nearest-code assignment + codebook statistics: CUDA kernel and plain twin.

Replaces the TPU kernel ``tvqvae_tpu/ops/vq_pallas.py::_kernel`` (reached
through ``nearest_codes_stats_pallas``). ``nearest_codes_stats(flat, embed)``
maps (M, D) x (K, D) float32 to

    idx (M,) int32        argmax_k 2<x, e_k> - |x|^2 - |e_k|^2, first on ties
    counts (K,) float32   rows assigned to each code
    embed_sum (K, D)      sum of the rows assigned to each code

On a CUDA tensor it launches the hand-written kernel in
``tvqvae_tpu_torch/csrc/vq_nearest.cu`` (the design and what bounds it are
noted there), built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` beside the package and loaded with ``ctypes``. On a CPU
tensor it runs ``nearest_codes_stats_plain``, the same function in plain
PyTorch, which also serves as the kernel's reference on the card. A CUDA
tensor never falls back to the plain version: the kernel runs or the call
raises.

No gradient is needed: the indices are integers and counts/embed_sum feed
only the EMA codebook update, so none of the outputs carries a tangent (the
reason ``tvqvae_tpu/models/vq.py`` wraps the TPU kernel's inputs in
``stop_gradient``). The wrapper runs under ``torch.no_grad``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "vq_nearest.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_DIM = 512  # the statistics kernel keeps 4 columns per thread of 128

# Launches of the CUDA kernel (one per wrapper call that reaches the card).
launch_count = 0

_lib = None
_lib_lock = threading.Lock()


def nearest_codes_stats_plain(flat: torch.Tensor, embed: torch.Tensor):
    """The kernel's function in plain PyTorch (CPU path and reference)."""
    x2 = (flat * flat).sum(-1, keepdim=True)
    e2 = (embed * embed).sum(-1)[None, :]
    dist = 2.0 * (flat @ embed.T) - x2 - e2
    idx = dist.argmax(-1)
    counts = torch.bincount(idx, minlength=embed.shape[0]).to(flat.dtype)
    embed_sum = torch.zeros_like(embed).index_add_(0, idx, flat)
    return idx.to(torch.int32), counts, embed_sum


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> Path:
    """Compile the kernel's shared library (once per source and flag set)
    and return its path. With ``verbose`` print nvcc's ptxas report."""
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libvq_nearest_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip(), flush=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.vq_nearest_stats.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.vq_nearest_stats.restype = ctypes.c_int
            lib.vq_error_string.argtypes = [ctypes.c_int]
            lib.vq_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(flat: torch.Tensor, embed: torch.Tensor) -> None:
    if flat.dim() != 2 or embed.dim() != 2 or flat.shape[1] != embed.shape[1]:
        raise ValueError(
            f"need flat (M, D) and embed (K, D), got {tuple(flat.shape)} "
            f"and {tuple(embed.shape)}"
        )
    if flat.dtype != torch.float32 or embed.dtype != torch.float32:
        raise TypeError(f"need float32, got {flat.dtype} and {embed.dtype}")
    if flat.device != embed.device:
        raise ValueError(f"flat on {flat.device}, embed on {embed.device}")
    if not (flat.is_contiguous() and embed.is_contiguous()):
        raise ValueError("flat and embed must be contiguous")
    if flat.shape[0] < 1 or embed.shape[0] < 1:
        raise ValueError("need at least one row and one code")


@torch.no_grad()
def nearest_codes_stats(flat: torch.Tensor, embed: torch.Tensor):
    """(M, D) x (K, D) -> (idx (M,) int32, counts (K,), embed_sum (K, D))."""
    global launch_count
    _check(flat, embed)
    if flat.device.type == "cpu":
        return nearest_codes_stats_plain(flat, embed)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    M, D = flat.shape
    K = embed.shape[0]
    if D > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes D <= {MAX_DIM}, got {D}")
    lib = _load()
    idx = torch.empty(M, dtype=torch.int32, device=flat.device)
    counts = torch.empty(K, dtype=torch.float32, device=flat.device)
    embed_sum = torch.empty(K, D, dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        err = lib.vq_nearest_stats(
            flat.data_ptr(), embed.data_ptr(), M, K, D, idx.data_ptr(),
            counts.data_ptr(), embed_sum.data_ptr(),
            torch.cuda.current_stream(flat.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"vq_nearest_stats launch failed: {lib.vq_error_string(err).decode()}"
        )
    launch_count += 1
    return idx, counts, embed_sum
