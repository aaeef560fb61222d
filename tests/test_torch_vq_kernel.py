"""The VQ kernel's wrapper, and the CUDA kernel against its plain version.

Torch only, so the card's machine (no JAX) runs it too:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_vq_kernel.py

The ``gpu`` cases skip without a card; the CUDA kernel has no CPU mode.
Tolerances: idx and counts exactly; embed_sum 1e-4 absolute plus 1e-6
relative (the kernel sums each code's rows in row order, the plain version
with index_add_ in another order; at D=16 a code's sum of ~200 rows reaches
~100, where a float32 ulp is 8e-6).
"""

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.ops import vq_kernel
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
    assert vq_kernel._lib is None or torch.cuda.is_available()
    assert vq_kernel.SOURCE.exists()
    assert "-gencode=arch=compute_90a,code=sm_90a" in vq_kernel.NVCC_FLAGS


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", [(864, 32), (3456, 32), (3456, 512), (3456, 2048), (5, 3)])
@pytest.mark.parametrize("D", [128, 16])
def test_kernel_matches_plain_on_card(M, K, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    flat, embed = (t.cuda() for t in _inputs(M, D, K, seed=4))
    before = vq_kernel.launch_count
    idx, cnt, es = nearest_codes_stats(flat, embed)
    torch.cuda.synchronize()
    assert vq_kernel.launch_count == before + 1
    p_idx, p_cnt, p_es = nearest_codes_stats_plain(flat, embed)
    assert torch.equal(idx, p_idx)
    assert torch.equal(cnt, p_cnt)
    torch.testing.assert_close(es, p_es, atol=1e-4, rtol=1e-6)
    # no atomics: a second run gives the same bits
    idx2, cnt2, es2 = nearest_codes_stats(flat, embed)
    assert torch.equal(idx, idx2) and torch.equal(cnt, cnt2) and torch.equal(es, es2)
