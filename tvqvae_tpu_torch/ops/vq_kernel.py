"""Fused nearest-code assignment + codebook statistics: CUDA kernel and plain twin.

Replaces the TPU kernel ``tvqvae_tpu/ops/vq_pallas.py::_kernel`` (reached
through ``nearest_codes_stats_pallas``). ``nearest_codes_stats(flat, embed)``
maps (M, D) x (K, D) float32 to

    idx (M,) int32        argmax_k 2<x, e_k> - |x|^2 - |e_k|^2, first on ties
    counts (K,) float32   rows assigned to each code
    embed_sum (K, D)      sum of the rows assigned to each code

On a CUDA tensor it launches the hand-written kernels in
``tvqvae_tpu_torch/csrc/vq_nearest.cu``, built with ``nvcc`` for ``sm_90a`` at
first use into ``build/kernels/`` beside the package and loaded with
``ctypes``. On a CPU tensor it runs ``nearest_codes_stats_plain``, the same
function in plain PyTorch, which also serves as the kernels' reference on the
card. A CUDA tensor never falls back to the plain version: the kernels run or
the call raises.

The kernels (notes at the top of the ``.cu`` file) read x from device memory
once, in tiles of 64 rows held in shared memory; distances are register-tiled
fp32 FFMA against a codebook streamed in chunks of 32 or 128 codes; each tile
writes per-code partial sums, which a last kernel adds in tile order, so the
statistics are deterministic without atomics. What bounds them on an H100:
bytes at K=32 (the published codebooks), fp32 operations at K >= 512.
``plan`` decides, from the shapes and the card's SM count, whether the codes
are split over a second grid dimension (at most three launches then, else
two) and how much scratch the kernels need; one ``torch.empty`` holds it.

No gradient is needed: the indices are integers and counts/embed_sum feed
only the EMA codebook update, so none of the outputs carries a tangent (the
reason ``tvqvae_tpu/models/vq.py`` wraps the TPU kernel's inputs in
``stop_gradient``). The wrapper runs under ``torch.no_grad``.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from tvqvae_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "vq_nearest.cu"
MAX_DIM = 512  # a 64-row tile of x at D=512 still fits in shared memory
# Rows of x per block (kTileRows in vq_nearest.cu) and the chunk widths its
# assign kernel is built for (codes per chunk). They must match the source.
TILE_ROWS = 64
CHUNK_CODES = (32, 128)
BLOCKS_PER_SM = 2  # split the codes until the assign grid has this many blocks a SM
SCRATCH_ALIGN = 256

# Launches of the CUDA kernel (one per wrapper call that reaches the card).
launch_count = 0

_lib = nvcc.Library(SOURCE, {
    "vq_nearest_stats": ([
        ctypes.c_void_p, ctypes.c_void_p,                   # flat, embed
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # M, K, D
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # chunk_codes, splits, chunks_per_split
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx, counts, embed_sum
        ctypes.c_void_p, ctypes.c_void_p,                   # win_val, win_idx
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # slot_tab, pcnt, part
        ctypes.c_void_p,                                    # stream
    ], ctypes.c_int),
})


def nearest_codes_stats_plain(flat: torch.Tensor, embed: torch.Tensor):
    """The kernel's function in plain PyTorch (CPU path and reference)."""
    x2 = (flat * flat).sum(-1, keepdim=True)
    e2 = (embed * embed).sum(-1)[None, :]
    dist = 2.0 * (flat @ embed.T) - x2 - e2
    idx = dist.argmax(-1)
    counts = torch.bincount(idx, minlength=embed.shape[0]).to(flat.dtype)
    embed_sum = torch.zeros_like(embed).index_add_(0, idx, flat)
    return idx.to(torch.int32), counts, embed_sum


class Plan(NamedTuple):
    """Launch plan and scratch layout of one call (byte offsets into one buffer)."""

    tiles: int
    chunk_codes: int
    splits: int
    chunks_per_split: int
    slots: int
    offsets: dict
    scratch_bytes: int


def plan(M: int, K: int, D: int, sms: int) -> Plan:
    """Tiles of TILE_ROWS rows; chunks of 32 codes where K <= 32 (no padding
    codes at the published codebook size), else of 128, split over a second
    grid dimension while tiles alone give fewer than BLOCKS_PER_SM blocks per
    SM. Scratch: pcnt (tiles, slots) int32 and part (tiles, slots, D)
    float32; where K > TILE_ROWS, slot_tab (tiles, K) int32; with a split,
    the winners win_val/win_idx (splits, M)."""
    tiles = -(-M // TILE_ROWS)
    chunk_codes = CHUNK_CODES[0] if K <= CHUNK_CODES[0] else CHUNK_CODES[1]
    chunks = -(-K // chunk_codes)
    splits = min(chunks, -(-BLOCKS_PER_SM * sms // tiles))
    chunks_per_split = -(-chunks // splits)
    splits = -(-chunks // chunks_per_split)  # no empty split
    slots = min(TILE_ROWS, K)
    sizes = {"pcnt": 4 * tiles * slots, "part": 4 * tiles * slots * D}
    if K > TILE_ROWS:  # else a tile's slot is the code itself
        sizes["slot_tab"] = 4 * tiles * K
    if splits > 1:
        sizes.update(win_val=4 * splits * M, win_idx=4 * splits * M)
    offsets, end = {}, 0
    for name, n in sizes.items():
        offsets[name] = end
        end += -(-n // SCRATCH_ALIGN) * SCRATCH_ALIGN
    return Plan(tiles, chunk_codes, splits, chunks_per_split, slots, offsets, end)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def build(verbose: bool = False):
    """Compile the kernel's shared library (once per source and flag set)
    and return its path. With ``verbose`` print nvcc's ptxas report."""
    return _lib.build(verbose)


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
    lib = _lib.get()
    index = flat.device.index if flat.device.index is not None else torch.cuda.current_device()
    pl = plan(M, K, D, _sm_count(index))
    idx = torch.empty(M, dtype=torch.int32, device=flat.device)
    counts = torch.empty(K, dtype=torch.float32, device=flat.device)
    embed_sum = torch.empty(K, D, dtype=torch.float32, device=flat.device)
    scratch = torch.empty(pl.scratch_bytes, dtype=torch.uint8, device=flat.device)
    base = scratch.data_ptr()
    at = {name: base + off for name, off in pl.offsets.items()}
    with torch.cuda.device(flat.device):
        err = lib.vq_nearest_stats(
            flat.data_ptr(), embed.data_ptr(), M, K, D,
            pl.chunk_codes, pl.splits, pl.chunks_per_split,
            idx.data_ptr(), counts.data_ptr(), embed_sum.data_ptr(),
            at.get("win_val"), at.get("win_idx"), at.get("slot_tab"), at["pcnt"], at["part"],
            torch.cuda.current_stream(flat.device).cuda_stream,
        )
    _lib.check("vq_nearest_stats", err)
    launch_count += 1
    return idx, counts, embed_sum
