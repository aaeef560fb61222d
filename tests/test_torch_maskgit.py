"""Port parity: the transformer priors and MaskGIT iterative decoding.

Small priors (LF: 16 wide, 2 layers, 2 heads; HF: 8 wide, 1 layer, 1 head,
so the HF prior has project_in/out; 3 classes) are initialised by the JAX
package, every leaf that init leaves at identity is drawn at random, and the
trees go through ``utils/convert.prior_from_jax``. Logits agree to 1e-4
(float32, a few layers). Decoding is compared with JAX's own Gumbel draws
injected into the port, and must give identical token grids.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.train.stage2 import init_stage2, make_prior_apply_fns
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models import transformer as ttr
from tvqvae_tpu_torch.models.stage1 import Stage1Spec
from tvqvae_tpu_torch.utils.convert import prior_from_jax

ATOL = 1e-4
L, C, N_CLASSES = 127, 4, 3


def make_cfg(use_rmsnorm=True, cfg_scale=1.0):
    prior = {"ff_mult": 1, "use_rmsnorm": use_rmsnorm}
    return {
        "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                    "downsampled_width": {"lf": 4, "hf": 8}},
        "decoder": {"n_resnet_blocks": 1},
        "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
        "MaskGIT": {
            "choice_temperatures": {"lf": 10, "hf": 4},
            "T": {"lf": 3, "hf": 1},
            "cfg_scale": cfg_scale,
            "prior_model_l": {**prior, "hidden_dim": 16, "n_layers": 2, "heads": 2},
            "prior_model_h": {**prior, "hidden_dim": 8, "n_layers": 1, "heads": 1},
        },
    }


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(dict(v), rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v))
        elif k in ("mean", "bias", "logit_bias"):
            out[k] = 0.1 * rng.normal(size=np.shape(v))
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, np.shape(v))
        else:
            out[k] = np.asarray(v)
        if not isinstance(out[k], dict):
            out[k] = jnp.asarray(out[k], jnp.float32)
    return out


def build(cfg_dict, force_projections=False, seed=0):
    jcfg = JConfig.from_dict(cfg_dict)
    js1 = JStage1Spec.from_config(jcfg, L, C)
    spec = jmg.MaskGITSpec.from_config(jcfg, js1)
    t_l, t_h = jmg.build_transformers(jcfg, js1, N_CLASSES, force_projections=force_projections)
    params, h_stats = init_stage2(jax.random.key(seed), t_l, t_h, spec)
    rng = np.random.default_rng(seed)
    params, h_stats = randomize(params, rng), randomize(h_stats, rng)
    j_apply = make_prior_apply_fns(t_l, t_h, params, h_stats)

    tcfg = Config.from_dict(cfg_dict)
    ts1 = Stage1Spec.from_config(tcfg, L, C)
    force = (force_projections, force_projections)
    p_l, p_h = tmg.build_transformers(tcfg, ts1, N_CLASSES, force)
    sd_l, sd_h = prior_from_jax(params, h_stats)
    p_l.load_state_dict(sd_l)
    p_h.load_state_dict(sd_h)
    return spec, tmg.MaskGITSpec.from_config(tcfg, ts1), j_apply, (p_l.eval(), p_h.eval())


@pytest.fixture(scope="module")
def default_pair():
    return build(make_cfg())


def _tokens(spec, B=4, seed=1):
    rng = np.random.default_rng(seed)
    # codes plus some mask tokens, as mid-decoding grids hold
    s_l = rng.integers(0, spec.mask_token_l + 1, size=(B, spec.tokens_l)).astype(np.int32)
    s_h = rng.integers(0, spec.mask_token_h + 1, size=(B, spec.tokens_h)).astype(np.int32)
    return s_l, s_h


def _check_logits(pair, cond):
    spec, _, (j_l, j_h), (p_l, p_h) = pair
    s_l, s_h = _tokens(spec)
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.from_numpy(cond)
    ref_l = np.asarray(j_l(jnp.asarray(s_l), jc))
    ref_h = np.asarray(j_h(jnp.asarray(s_l), jnp.asarray(s_h), jc))
    with torch.no_grad():
        out_l = p_l(torch.from_numpy(s_l), None, tc).numpy()
        out_h = p_h(torch.from_numpy(s_l), torch.from_numpy(s_h), tc).numpy()
    assert out_l.shape == ref_l.shape == (4, spec.tokens_l, spec.mask_token_l)
    assert out_h.shape == ref_h.shape == (4, spec.tokens_h, spec.mask_token_h)
    np.testing.assert_allclose(out_l, ref_l, atol=ATOL)
    np.testing.assert_allclose(out_h, ref_h, atol=ATOL)


@pytest.mark.parametrize("cond", [None, np.array([[0], [2], [1], [2]], np.int32)])
def test_prior_logits_match_jax(default_pair, cond):
    _check_logits(default_pair, cond)


@pytest.mark.parametrize("variant", ["layernorm", "forced_projections"])
def test_prior_variants_match_jax(variant):
    if variant == "layernorm":
        pair = build(make_cfg(use_rmsnorm=False), seed=2)
    else:
        pair = build(make_cfg(), force_projections=True, seed=3)
        assert pair[3][0].projections  # square 16 -> 16 pair kept on the LF prior
    _check_logits(pair, np.array([[1], [0], [2], [1]], np.int32))


def test_prior_defaults_follow_flax(default_pair):
    """gelu is the tanh form; norms use eps 1e-6 and pred_norm 1e-12; the
    projections exist only where in_dim != hidden_dim."""
    p_l, p_h = default_pair[3]
    assert not p_l.projections and p_h.projections
    assert p_l.post_emb_norm.eps == ttr.NORM_EPS == 1e-6
    assert p_l.RMSNorm_0.eps == 1e-6 and p_l.block_0.RMSNorm_1.eps == 1e-6
    assert p_l.pred_norm.eps == 1e-12
    x = torch.linspace(-3, 3, 7)
    torch.testing.assert_close(ttr._gelu(x), torch.from_numpy(
        np.array(jax.nn.gelu(jnp.asarray(x.numpy())))), atol=1e-6, rtol=0)


def test_decode_schedule_matches_jax():
    for n, T, temp in [(27, 10, 10.0), (108, 1, 4.0), (12, 3, 10.0)]:
        m_ref, t_ref = jmg.decode_schedule(n, T, temp, "cosine")
        m, t = tmg.decode_schedule(n, T, temp, "cosine")
        np.testing.assert_array_equal(m, np.asarray(m_ref))
        np.testing.assert_array_equal(t, np.asarray(t_ref))


def test_rank_breaks_ties_by_position():
    x = np.array([[np.inf, 0.3, np.inf, -1.0, 0.3, np.inf]], np.float32)
    np.testing.assert_array_equal(tmg._rank(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmg._rank(jnp.asarray(x))))
    assert tmg._rank(torch.from_numpy(x)).tolist() == [[3, 1, 4, 0, 2, 5]]


def test_gumbel_floor_matches_jax(monkeypatch):
    """Confidence noise draws its uniforms from [1e-20, 1): a zero draw
    gives the same finite value as JAX's minval=1e-20, not -inf."""
    g = tmg._gumbel((4096,), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(g).all()
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(shape))
    g0 = tmg._gumbel((3,), None, "cpu")
    np.testing.assert_allclose(g0.numpy(), -np.log(-np.log(np.float32(1e-20))), rtol=1e-6)


def jax_decode_noise(rng, spec, num):
    """The Gumbel draws iterative_decoding(rng, ...) makes in the JAX
    package, in the port's noise layout."""
    r_l, r_h = jax.random.split(rng)
    noise = {}
    for band, r, T, n, K in (("l", r_l, spec.T_l, spec.tokens_l, spec.mask_token_l),
                             ("h", r_h, spec.T_h, spec.tokens_h, spec.mask_token_h)):
        g_s, g_c = [], []
        for step in jax.random.split(r, T):
            r_s, r_g = jax.random.split(step)
            g_s.append(np.array(jax.random.gumbel(r_s, (num, n, K))))
            g_c.append(np.array(jmg._gumbel(r_g, (num, n))))
        noise[band] = (torch.from_numpy(np.stack(g_s)), torch.from_numpy(np.stack(g_c)))
    return noise


@pytest.mark.parametrize("class_index,cfg_scale", [(None, 1.0), (2, 1.0), (1, 2.5)])
def test_iterative_decoding_with_jax_noise(class_index, cfg_scale):
    pair = build(make_cfg(cfg_scale=cfg_scale), seed=4)
    spec, tspec, (j_l, j_h), (p_l, p_h) = pair
    num = 6
    j_decode = jax.jit(lambda r: jmg.iterative_decoding(r, spec, j_l, j_h, num, class_index))
    for seed in range(3):
        rng = jax.random.key(seed)
        ref_l, ref_h = j_decode(rng)
        with torch.no_grad():
            s_l, s_h = tmg.iterative_decoding(
                tspec, lambda s, c: p_l(s, None, c), lambda a, b, c: p_h(a, b, c),
                num, class_index, device="cpu", noise=jax_decode_noise(rng, spec, num),
            )
        assert s_l.dtype == torch.int32
        np.testing.assert_array_equal(s_l.numpy(), np.asarray(ref_l))
        np.testing.assert_array_equal(s_h.numpy(), np.asarray(ref_h))
        assert (s_l.numpy() < spec.mask_token_l).all() and (s_h.numpy() < spec.mask_token_h).all()


def test_iterative_decoding_seeded_draws_repeat(default_pair):
    _, tspec, _, (p_l, p_h) = default_pair

    def run(seed):
        with torch.no_grad():
            return tmg.iterative_decoding(
                tspec, lambda s, c: p_l(s, None, c), lambda a, b, c: p_h(a, b, c), 3,
                device="cpu", generator=torch.Generator().manual_seed(seed))

    a, b = run(5), run(5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
