"""Port parity: the VQ kernel's plain version and the eval-mode quantizer.

The JAX side runs the Pallas kernel in interpret mode on the CPU
(``vq_pallas.py`` picks it off-TPU) and the XLA branch of ``vq_forward``.
Tolerances: indices and counts exactly; embed_sum to 1e-4 (sums of up to a
few hundred float32 rows in another order); quantized vectors are codebook
rows, so exact once the indices agree.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_vq_kernel.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.models.vq import CodebookState as JCodebookState
from tvqvae_tpu.models.vq import VQParams as JVQParams
from tvqvae_tpu.models.vq import vq_forward as j_vq_forward
from tvqvae_tpu.ops.vq_pallas import nearest_codes_stats_pallas
from tvqvae_tpu_torch.models.vq import CodebookState, VQParams, lookup_codes, vq_forward
from tvqvae_tpu_torch.ops.vq_kernel import nearest_codes_stats

# test_vq.py::test_pallas_kernel_matches_xla's cases plus the published
# LF (32 x 27 tokens) and HF (32 x 108 tokens) shapes, as (M, D, K)
CASES = [(96, 8, 16), (512, 128, 32), (700, 64, 32), (864, 128, 32), (3456, 128, 32)]


def _inputs(M, D, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, D)).astype(np.float32),
            rng.normal(size=(K, D)).astype(np.float32))


@pytest.mark.parametrize("M,D,K", CASES)
def test_plain_matches_pallas_interpret(M, D, K):
    flat, embed = _inputs(M, D, K)
    j_idx, j_cnt, j_es = nearest_codes_stats_pallas(jnp.asarray(flat), jnp.asarray(embed))
    idx, cnt, es = nearest_codes_stats(torch.from_numpy(flat), torch.from_numpy(embed))
    assert idx.dtype == torch.int32 and cnt.dtype == es.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_allclose(es.numpy(), np.asarray(j_es), atol=1e-4)


def _codebook_pair(embed):
    K = embed.shape[0]
    j = JCodebookState(embed=jnp.asarray(embed), embed_avg=jnp.asarray(embed),
                       cluster_size=jnp.zeros((K,)), initted=jnp.asarray(True))
    t = CodebookState(torch.from_numpy(embed), torch.from_numpy(embed.copy()),
                      torch.zeros(K), torch.tensor(True))
    return j, t


@pytest.mark.parametrize("M,D,K", CASES)
def test_vq_forward_eval_matches_xla_branch(M, D, K):
    flat, embed = _inputs(M, D, K, seed=1)
    x = flat.reshape(M // 4, 4, D) if M % 4 == 0 else flat.reshape(M, 1, D)
    js, ts = _codebook_pair(embed)
    ref = j_vq_forward(js, jnp.asarray(x), JVQParams(K, D), train=False)
    out = vq_forward(ts, torch.from_numpy(x), VQParams(K, D))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(out.quantized.numpy(), np.asarray(ref.quantized))
    np.testing.assert_allclose(float(out.perplexity), float(ref.perplexity), rtol=1e-5)


@pytest.mark.parametrize("temp", [0.5, 2.0])
def test_svq_branch_with_jax_gumbel_noise(temp):
    """jax.random.categorical(key, l) == argmax(l + jax.random.gumbel(key));
    handing the port JAX's draws gives the same stochastic assignment."""
    B, N, D, K = 4, 12, 16, 8
    flat, embed = _inputs(B * N, D, K, seed=2)
    x = flat.reshape(B, N, D)
    js, ts = _codebook_pair(embed)
    key = jax.random.key(7)
    ref = j_vq_forward(js, jnp.asarray(x), JVQParams(K, D), train=False,
                       svq_temp=temp, rng=key)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (B * N, K))))
    out = vq_forward(ts, torch.from_numpy(x), VQParams(K, D), svq_temp=temp, noise=noise)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(float(out.perplexity), float(ref.perplexity), rtol=1e-5)


def test_svq_branch_seeded_and_zero_temp_is_argmax():
    flat, embed = _inputs(64, 8, 16, seed=3)
    _, ts = _codebook_pair(embed)
    x = torch.from_numpy(flat.reshape(8, 8, 8))
    p = VQParams(16, 8)
    a = vq_forward(ts, x, p, svq_temp=1.0, generator=torch.Generator().manual_seed(0))
    b = vq_forward(ts, x, p, svq_temp=1.0, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a.indices.numpy(), b.indices.numpy())
    np.testing.assert_array_equal(vq_forward(ts, x, p, svq_temp=0.0).indices.numpy(),
                                  vq_forward(ts, x, p).indices.numpy())


def test_lookup_codes():
    _, embed = _inputs(1, 4, 6)
    _, ts = _codebook_pair(embed)
    s = torch.tensor([[0, 5], [3, 3]], dtype=torch.int32)
    np.testing.assert_array_equal(lookup_codes(ts, s).numpy(), embed[s.numpy()])


def test_ties_go_to_the_first_code():
    embed = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]], np.float32)
    flat = np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]], np.float32)
    idx, cnt, es = nearest_codes_stats(torch.from_numpy(flat), torch.from_numpy(embed))
    assert idx.tolist() == [0, 0, 1]
    assert cnt.tolist() == [2.0, 1.0, 0.0]
    np.testing.assert_array_equal(es.numpy(), [[1.5, 0.5], [0.0, 1.0], [0.0, 0.0]])
