"""The VQ kernel's wrapper, and the CUDA kernel against its plain version.

Torch only, so the card's machine (no JAX) runs it too:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_vq_kernel.py

The ``gpu`` cases skip without a card; the CUDA kernel has no CPU mode.
Tolerances: idx and counts exactly; embed_sum 1e-4 absolute plus 1e-6
relative (the kernel sums each code's rows in row order within a tile of 64
rows and then the tiles in order, the plain version with index_add_ in
another order; at D=16 a code's sum of ~200 rows reaches ~100, where a
float32 ulp is 8e-6). The launch plan (tiles, code splits, scratch) is
pinned on the CPU.
"""

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.ops import nvcc, vq_kernel
from tvqvae_tpu_torch.ops.vq_kernel import nearest_codes_stats, nearest_codes_stats_plain


def _inputs(M, D, K, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(K, D)).astype(np.float32)))


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    flat, embed = _inputs(8, 4, 3)
    before = vq_kernel.launch_count
    with pytest.raises(ValueError):
        nearest_codes_stats(flat, embed[:, :3].contiguous())
    with pytest.raises(TypeError):
        nearest_codes_stats(flat.double(), embed)
    with pytest.raises(ValueError):
        nearest_codes_stats(flat.T.contiguous().T, embed)  # non-contiguous view
    with pytest.raises(ValueError):
        nearest_codes_stats(flat[:0], embed)
    nearest_codes_stats(flat, embed)  # the CPU runs the plain version
    assert vq_kernel.launch_count == before


def test_plain_version_matches_numpy():
    flat, embed = _inputs(200, 16, 12, seed=1)
    idx, cnt, es = nearest_codes_stats_plain(flat, embed)
    f, e = flat.double().numpy(), embed.double().numpy()
    d = 2 * f @ e.T - (f * f).sum(1, keepdims=True) - (e * e).sum(1)[None]
    ref = d.argmax(1)
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(ref, minlength=12))
    np.testing.assert_allclose(es.numpy(), np.eye(12)[ref].T @ f, atol=1e-4)


def test_build_is_lazy():
    """Importing the module compiles nothing; the library loads at first launch."""
    assert not vq_kernel._lib.loaded or torch.cuda.is_available()
    assert vq_kernel.SOURCE.exists()
    assert "-gencode=arch=compute_90a,code=sm_90a" in nvcc.NVCC_FLAGS


@pytest.mark.parametrize("M,K,D,tiles,splits,scratch", [
    (864, 32, 128, 14, 1, 231168),
    (3456, 32, 128, 54, 1, 891648),
    (3456, 512, 128, 54, 4, 2004480),
    (3456, 2048, 128, 54, 4, 2336256),
])
def test_plan_at_kernel_shapes(M, K, D, tiles, splits, scratch):
    """The launch plan on a 132-SM H100 at chip_smoke's four shapes."""
    pl = vq_kernel.plan(M, K, D, sms=132)
    assert (pl.tiles, pl.splits, pl.scratch_bytes) == (tiles, splits, scratch)
    assert pl.slots == min(vq_kernel.TILE_ROWS, K)
    assert ("win_val" in pl.offsets) == (splits > 1)


@pytest.mark.parametrize("M,K,D", [(1, 1, 1), (65, 33, 3), (865, 2048, 20), (64, 2048, 512), (7, 64, 9),
                                   (100000, 4096, 64), (3456, 65, 128)])
def test_plan_covers_every_chunk_and_fits_the_scratch(M, K, D):
    pl = vq_kernel.plan(M, K, D, sms=132)
    assert pl.chunk_codes == (32 if K <= 32 else 128)
    chunks = -(-K // pl.chunk_codes)
    assert pl.tiles * vq_kernel.TILE_ROWS >= M > (pl.tiles - 1) * vq_kernel.TILE_ROWS
    # every split has at least one chunk, and together they hold all
    assert (pl.splits - 1) * pl.chunks_per_split < chunks <= pl.splits * pl.chunks_per_split
    assert ("slot_tab" in pl.offsets) == (K > vq_kernel.TILE_ROWS)
    sizes = {"slot_tab": 4 * pl.tiles * K, "pcnt": 4 * pl.tiles * pl.slots,
             "part": 4 * pl.tiles * pl.slots * D, "win_val": 4 * pl.splits * M,
             "win_idx": 4 * pl.splits * M}
    ends = sorted((off, off + sizes[name]) for name, off in pl.offsets.items())
    assert all(off % vq_kernel.SCRATCH_ALIGN == 0 for off, _ in ends)
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])) and ends[-1][1] <= pl.scratch_bytes


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _check_on_card(flat, embed):
    """idx and counts equal to the plain version's, embed_sum within 1e-4 +
    1e-6 relative (NaN where the plain version has NaN), one launch, and a
    second call that gives the same bits."""
    before = vq_kernel.launch_count
    idx, cnt, es = nearest_codes_stats(flat, embed)
    torch.cuda.synchronize()
    assert vq_kernel.launch_count == before + 1
    p_idx, p_cnt, p_es = nearest_codes_stats_plain(flat, embed)
    assert torch.equal(idx, p_idx)
    assert torch.equal(cnt, p_cnt)
    torch.testing.assert_close(es, p_es, atol=1e-4, rtol=1e-6, equal_nan=True)
    # no atomics: a second run gives the same bits
    idx2, cnt2, es2 = nearest_codes_stats(flat, embed)
    assert torch.equal(idx, idx2) and torch.equal(cnt, cnt2)
    assert torch.equal(es.view(torch.int32), es2.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,D", [
    *((M, K, D) for M, K in [(864, 32), (3456, 32), (3456, 512), (3456, 2048), (5, 3)]
      for D in (128, 16)),
    # the new design's edges: one row, ragged tiles, one code, a second
    # chunk of one code, 4-byte copies (D % 4 != 0), the largest D
    *((M, K, D) for M in (1, 63, 65, 865) for K in (1, 33) for D in (1, 3, 20, 512)),
])
def test_kernel_matches_plain_on_card(M, K, D, card):
    _check_on_card(*(t.cuda() for t in _inputs(M, D, K, seed=4)))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,D", [(64, 2048, 128), (1, 2048, 20), (100, 2048, 512), (130, 700, 7)])
def test_kernel_code_split_on_card(M, K, D, card):
    """Few row tiles and many codes: the codes are split over the grid and
    the splits' winners merged."""
    assert vq_kernel.plan(M, K, D, sms=132).splits > 1
    _check_on_card(*(t.cuda() for t in _inputs(M, D, K, seed=5)))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [33, 2048])
def test_kernel_ties_take_the_lowest_index_on_card(K, card):
    """Duplicated codebook rows, within a chunk and across chunks and splits:
    rows near a duplicated code take its lowest index."""
    D = 32
    rng = np.random.default_rng(6)
    embed = rng.normal(size=(K, D)).astype(np.float32)
    pairs = [(2, 5), (0, K - 1), (7, K // 2 + 7)]
    for lo, hi in pairs:
        embed[hi] = embed[lo]
    picks = rng.choice([hi for _, hi in pairs] + [lo for lo, _ in pairs], size=96)
    flat = embed[picks] + 0.01 * rng.normal(size=(96, D)).astype(np.float32)
    flat, embed = torch.from_numpy(flat).cuda(), torch.from_numpy(embed).cuda()
    _check_on_card(flat, embed)
    idx = nearest_codes_stats(flat, embed)[0].cpu().numpy()
    assert not set(idx) & {hi for _, hi in pairs}


@pytest.mark.gpu
@pytest.mark.parametrize("K", [32, 2048])
def test_kernel_nan_rows_go_to_code_zero_on_card(K, card):
    flat, embed = _inputs(200, 16, K, seed=7)
    flat[3, 5] = float("nan")
    flat[150:152] = float("nan")
    flat, embed = flat.cuda(), embed.cuda()
    _check_on_card(flat, embed)
    idx = nearest_codes_stats(flat, embed)[0].cpu()
    assert idx[3] == 0 and idx[150] == 0 and idx[151] == 0


@pytest.mark.gpu
def test_kernel_unaligned_rows_on_card(card):
    """A contiguous view that starts 4 bytes into its storage: D % 4 == 0,
    but 16-byte copies would be misaligned."""
    flat, embed = _inputs(301, 128, 40, seed=8)
    flat = flat.cuda().flatten()[1:1 + 300 * 128].view(300, 128)
    assert flat.is_contiguous() and flat.data_ptr() % 16 == 4
    _check_on_card(flat, embed.cuda())
