"""Port parity at the published width: the stage-1 encoders, quantizer and decoders.

The published configuration (``Config()`` defaults: hid_dim 128, init_dim 4,
two ResBlocks, codebooks 32/32) at L=4633, C=4, B=2 is initialised by the JAX
package; its BatchNorm statistics, scales and Snake slopes are drawn at random
(``randomize`` of ``test_torch_stage1``), and each codebook is 32 encoder
latents of other series, as the k-means init latch takes codes from data, so
that the tokens spread over the codebook. The tree goes through
``utils/convert.stage1_from_jax`` into the port, which runs on the CPU (the
plain VQ version). Tolerances, relative to the largest magnitude of the
reference output: latents 1e-4 (float32 conv stacks at full width, sums in
another order), decoded series 5e-4 (the decoder adds the two 4633x4633
TimeHead products); tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models.maskgit import FrozenStage1 as JFrozen
from tvqvae_tpu.models.maskgit import decode_tokens as j_decode_tokens
from tvqvae_tpu.models.maskgit import encode_tokens as j_encode_tokens
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.stage1 import init_stage1
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, decode_tokens, encode_tokens
from tvqvae_tpu_torch.models.stage1 import Stage1Spec
from tvqvae_tpu_torch.utils import convert

from test_torch_stage1 import randomize

L, C, B = 4633, 4, 2
BANDS = ("lf", "hf")


def _encode(model, tree, x, band):
    return np.asarray(model.apply({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                                  jnp.asarray(x), band, method="encode"))


@pytest.fixture(scope="module")
def published():
    """Both packages' outputs at the published width, computed once."""
    jspec = JStage1Spec.from_config(JConfig(), L, C)
    model, params, stats, vq_l, vq_h = init_stage1(jax.random.key(0), jspec, jnp.zeros((B, C, L)))
    rng = np.random.default_rng(0)
    tree = {"params": randomize(params, rng), "batch_stats": randomize(stats, rng)}
    x_codes = np.random.default_rng(2).normal(size=(B, C, L)).astype(np.float32)
    for band, vq in (("lf", vq_l), ("hf", vq_h)):
        z = _encode(model, tree, x_codes, band).reshape(-1, vq.embed.shape[1])
        codes = jnp.asarray(z[rng.choice(len(z), vq.embed.shape[0], replace=False)])
        tree[f"vq_{band[0]}"] = vq.replace(embed=codes, embed_avg=codes)
    x = np.random.default_rng(1).normal(size=(B, C, L)).astype(np.float32)

    jf = JFrozen(tree["params"], tree["batch_stats"], tree["vq_l"], tree["vq_h"])
    tspec = Stage1Spec.from_config(Config(), L, C)
    frozen = FrozenStage1.from_state_dict(tspec, convert.stage1_from_jax(tree), "cpu")
    out = {}
    with torch.no_grad():
        xt = torch.from_numpy(x)
        for band in BANDS:
            tokens = np.array(j_encode_tokens(model, jf, jnp.asarray(x), band))
            out[band] = {
                "z": (frozen.model.encode(xt, band).numpy(), _encode(model, tree, x, band)),
                "tokens": (encode_tokens(frozen, xt, band).numpy(), tokens),
                "series": (decode_tokens(frozen, torch.from_numpy(tokens), band).numpy(),
                           np.asarray(j_decode_tokens(model, jf, jnp.asarray(tokens), band))),
            }
    return out


def _rel_err(pair):
    port, ref = pair
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("band", BANDS)
def test_published_width_latents_match_jax(published, band):
    assert _rel_err(published[band]["z"]) <= 1e-4


@pytest.mark.parametrize("band", BANDS)
def test_published_width_tokens_match_jax(published, band):
    port, ref = published[band]["tokens"]
    np.testing.assert_array_equal(port, ref)
    # the codebook is used, not one code for every token
    assert len(np.unique(ref)) > 4


@pytest.mark.parametrize("band", BANDS)
def test_published_width_decoded_series_match_jax(published, band):
    assert published[band]["series"][0].shape == (B, C, L)
    assert _rel_err(published[band]["series"]) <= 5e-4
