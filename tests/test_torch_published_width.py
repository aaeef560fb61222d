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

The same tokens also go through both decoders under the JAX sampler's
bfloat16 defaults (``compute_dtype="bfloat16"``, ``fast_bn``,
``bf16_head``, ``bf16_istft``): the port's bfloat16 decode within 0.06 of
JAX's bfloat16 decode's scale (the bound of ``tests/test_bf16_decode.py``;
measured 0.024 LF, 0.034 HF), and the guard of
``tests/test_torch_precision.py``: the port's own bfloat16-vs-float32 gap
between 0.25x and 4x JAX's (measured 0.023 against 0.021, 0.034 against
0.037).

The seeded weights ``TrainedModelSampler.from_init(seed=0)`` draws (the
port's ``init_stage1`` from the first draws of the seed's generator; every
BatchNorm keeps its identity statistics, so the random stacks are not
normalised) go to JAX through ``utils/convert.stage1_to_jax``, and
uniformly drawn tokens, as random priors sample them, are decoded by both
packages in float32 and under the bfloat16 defaults. Without normalisation
bfloat16 rounding grows through the stacks, and JAX's own bfloat16 decode
lies far from its float32 one there (measured 0.300 LF, 0.111 HF of scale):
the port's gap stays between 0.25x and 4x JAX's (measured 0.245 against
0.300, 0.129 against 0.111). JAX's larger reading, 0.30, is the bound
``chip_smoke.py`` (``BF16_PUBLISHED``) holds the card's seeded bfloat16
sampler to.
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
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.stage1 import init_stage1
from tvqvae_tpu.models.vq import CodebookState as JCodebookState
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, decode_tokens, encode_tokens
from tvqvae_tpu_torch.models.stage1 import Stage1Spec
from tvqvae_tpu_torch.models.stage1 import init_stage1 as t_init_stage1
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
    bf16 = dict(compute_dtype="bfloat16", fast_bn=True, bf16_head=True, bf16_istft=True)
    frozen16 = FrozenStage1.from_state_dict(Stage1Spec.from_config(Config(), L, C, **bf16),
                                            convert.stage1_from_jax(tree), "cpu")
    model16 = type(model)(JStage1Spec.from_config(JConfig(), L, C, **bf16))
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
            out[band]["series16"] = (
                decode_tokens(frozen16, torch.from_numpy(tokens), band).numpy(),
                np.asarray(jax.jit(lambda s, b=band: j_decode_tokens(model16, jf, s, b))(
                    jnp.asarray(tokens))))
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


@pytest.mark.parametrize("band", BANDS)
def test_published_width_bf16_decode_matches_jax(published, band):
    (port32, jax32), (port16, jax16) = published[band]["series"], published[band]["series16"]
    own, jax_own = _rel_err((port16, port32)), _rel_err((jax16, jax32))
    assert 0.25 <= own / jax_own <= 4.0, (own, jax_own)
    assert _rel_err((port16, jax16)) <= 0.06


@pytest.fixture(scope="module")
def seeded():
    """The bfloat16-vs-float32 gaps of both packages' decodes on the port's
    seeded weights (identity BatchNorm statistics), one uniform token draw
    per band: {band: (port's gap, JAX's gap)}."""
    bf16 = dict(compute_dtype="bfloat16", fast_bn=True, bf16_head=True, bf16_istft=True)
    spec, spec16 = (Stage1Spec.from_config(Config(), L, C, **kw) for kw in ({}, bf16))
    model, vq_l, vq_h = t_init_stage1(spec, torch.Generator().manual_seed(0), "cpu")
    tree = convert.stage1_to_jax(model, vq_l, vq_h)
    frozen, frozen16 = (FrozenStage1.from_state_dict(sp, convert.stage1_from_jax(tree), "cpu")
                        for sp in (spec, spec16))
    jf = JFrozen(tree["params"], tree["batch_stats"], JCodebookState(**tree["vq_l"]),
                 JCodebookState(**tree["vq_h"]))
    jmodels = [JStage1Model(JStage1Spec.from_config(JConfig(), L, C, **kw)) for kw in ({}, bf16)]
    rng = np.random.default_rng(4)
    out = {}
    with torch.no_grad():
        for band, vq in (("lf", vq_l), ("hf", vq_h)):
            shape = encode_tokens(frozen, torch.zeros(B, C, L), band).shape
            tokens = rng.integers(0, vq.embed.shape[0], size=shape)
            port32, port16 = (decode_tokens(f, torch.from_numpy(tokens), band).numpy()
                              for f in (frozen, frozen16))
            jax32, jax16 = (np.asarray(jax.jit(lambda s, m=m: j_decode_tokens(m, jf, s, band))(
                jnp.asarray(tokens))) for m in jmodels)
            out[band] = (_rel_err((port16, port32)), _rel_err((jax16, jax32)))
    return out


@pytest.mark.parametrize("band", BANDS)
def test_seeded_weights_bf16_gap_matches_jax(seeded, band):
    own, jax_own = seeded[band]
    assert 0.25 <= own / jax_own <= 4.0, (own, jax_own)
