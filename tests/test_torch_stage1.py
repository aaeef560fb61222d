"""Port parity: the eval-mode stage-1 model and the weights bridge.

A small stage 1 (L=127, C=4, hid_dim 16, init_dim 4, one ResBlock, codebooks
8/8) is initialised by the JAX package, its BatchNorm statistics, scales and
Snake slopes are drawn at random so that every leaf matters, and the tree goes
through ``utils/convert.stage1_from_jax`` into the port. Outputs agree to 2e-4
(float32 conv stacks of ~30 layers, sums in another order); token indices
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.stage1 import init_stage1
from tvqvae_tpu.utils import import_reference
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, encode_tokens
from tvqvae_tpu_torch.models.stage1 import Stage1Spec
from tvqvae_tpu_torch.utils import convert

ATOL = 2e-4
L, C = 127, 4
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
}


def randomize(tree, rng):
    """Random values for every leaf a fresh init leaves at identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = randomize(dict(v), rng)
            continue
        shape = np.shape(v)
        if k == "var":
            out[k] = rng.uniform(0.5, 1.5, shape)
        elif k in ("mean", "bias"):
            out[k] = 0.1 * rng.normal(size=shape)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, shape)
        elif k == "a":
            out[k] = rng.uniform(0.2, 0.5, shape)
        else:
            out[k] = np.asarray(v)
        out[k] = jnp.asarray(out[k], jnp.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    jspec = JStage1Spec.from_config(JConfig.from_dict(CFG), L, C)
    model, params, stats, vq_l, vq_h = init_stage1(jax.random.key(0), jspec, jnp.zeros((2, C, L)))
    rng = np.random.default_rng(0)
    params, stats = randomize(params, rng), randomize(stats, rng)
    tree = {"params": params, "batch_stats": stats, "vq_l": vq_l, "vq_h": vq_h}
    tspec = Stage1Spec.from_config(Config.from_dict(CFG), L, C)
    frozen = FrozenStage1.from_state_dict(tspec, convert.stage1_from_jax(tree), "cpu")
    x = np.random.default_rng(1).normal(size=(3, C, L)).astype(np.float32)
    return model, tree, frozen, x


def _apply(model, tree, *args, **kw):
    return model.apply({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                       *args, **kw)


def test_spec_matches_jax(pair):
    model, _, frozen, _ = pair
    j, t = model.spec, frozen.model.spec
    for f in ("halvings_l", "halvings_h", "tokens_l", "tokens_h", "hw_l", "hw_h"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.vq_l.codebook_size, t.vq_l.dim) == (j.vq_l.codebook_size, j.vq_l.dim)


def test_state_dict_covers_every_leaf(pair):
    _, tree, frozen, _ = pair
    n_params = sum(1 for _ in convert._flatten(tree["params"]))
    n_stats = sum(1 for _ in convert._flatten(tree["batch_stats"]))
    sd = frozen.model.state_dict()
    # every BN adds num_batches_tracked beside its two running statistics
    assert len(sd) == n_params + n_stats + n_stats // 2


@pytest.mark.parametrize("band", ["lf", "hf"])
def test_encoder_matches_jax(pair, band):
    model, tree, frozen, x = pair
    ref = np.asarray(_apply(model, tree, jnp.asarray(x), band, method="encode"))
    with torch.no_grad():
        out = frozen.model.encode(torch.from_numpy(x), band).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("band", ["lf", "hf"])
def test_decoder_with_time_head_matches_jax(pair, band):
    model, tree, frozen, _ = pair
    n = model.spec.tokens_l if band == "lf" else model.spec.tokens_h
    zq = np.random.default_rng(2).normal(size=(3, n, 16)).astype(np.float32)
    ref = np.asarray(_apply(model, tree, jnp.asarray(zq), band, method="decode"))
    with torch.no_grad():
        out = frozen.model.decode(torch.from_numpy(zq), band).numpy()
    assert out.shape == ref.shape == (3, C, L)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_tokens_are_h_major(pair):
    """encode flattens the encoder's NCHW output as NHWC: token n is
    (h, w) = divmod(n, W')."""
    _, _, frozen, x = pair
    m = frozen.model
    with torch.no_grad():
        xt = torch.from_numpy(x)
        tokens = m.encode(xt, "hf")
        from tvqvae_tpu_torch.ops import time_to_timefreq, zero_pad_low_freq

        z = m.encoder_h(zero_pad_low_freq(time_to_timefreq(xt, 4), copy=True))
    H, W = m.spec.hw_h
    assert H > 1 and W > 1
    for n in (0, 1, W - 1, W, H * W - 1):
        torch.testing.assert_close(tokens[:, n], z[:, :, n // W, n % W], rtol=0, atol=0)


def test_forward_matches_jax(pair):
    model, tree, frozen, x = pair
    ref = _apply(model, tree, jnp.asarray(x), tree["vq_l"], tree["vq_h"], False)
    with torch.no_grad():
        out = frozen.model(torch.from_numpy(x), frozen.vq_l, frozen.vq_h)
    for band in ("l", "h"):
        np.testing.assert_array_equal(getattr(out, f"vq_{band}").indices.numpy(),
                                      np.asarray(getattr(ref, f"vq_{band}").indices))
        for f in (f"x_{band}", f"xhat_{band}"):
            np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                       atol=ATOL, err_msg=f)


@pytest.mark.parametrize("band", ["lf", "hf"])
def test_encode_tokens_matches_jax(pair, band):
    from tvqvae_tpu.models.maskgit import FrozenStage1 as JFrozen
    from tvqvae_tpu.models.maskgit import encode_tokens as j_encode_tokens

    model, tree, frozen, x = pair
    jf = JFrozen(tree["params"], tree["batch_stats"], tree["vq_l"], tree["vq_h"])
    ref = np.asarray(j_encode_tokens(model, jf, jnp.asarray(x), band))
    with torch.no_grad():
        out = encode_tokens(frozen, torch.from_numpy(x), band).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind", ["conv2d", "conv_transpose", "conv1d", "dense"])
def test_convert_inverts_the_reference_importer(kind):
    """The port's per-leaf transposes undo import_reference's torch->flax ones
    (for the transposed conv: the spatial flip)."""
    rng = np.random.default_rng(3)
    shape, fn, parent = {
        "conv2d": ((5, 3, 3, 4), import_reference._conv2d, "Conv_0"),
        "conv_transpose": ((3, 5, 3, 4), import_reference._convT2d, "ConvTranspose2dTorch_0"),
        "conv1d": ((5, 3, 3), import_reference._conv1d, "Conv_0"),
        "dense": ((5, 3), import_reference._dense, "Dense_0"),
    }[kind]
    w = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape[1] if kind == "conv_transpose" else shape[0]).astype(np.float32)
    flax_leaf = fn({"weight": w, "bias": b})
    sd = convert.params_to_state_dict({parent: flax_leaf})
    np.testing.assert_array_equal(sd[f"{parent}.weight"].numpy(), w)
    np.testing.assert_array_equal(sd[f"{parent}.bias"].numpy(), b)
