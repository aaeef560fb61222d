"""Port parity: the ESS sampler (``models/maskgit.py``'s ESS half,
``train/stage2.make_ess_sampling_fn`` and the sampler's ESS branch).

The small model of ``tests/test_torch_sampler.py`` with T = 8 LF steps
(a moving-average window of 2 at the default rate 0.3), weights from the
port's seeded init written as flax trees (no flax init, no compile of one).
JAX's draws are handed to the port. Tolerances: confidences 1e-5; mask
lengths, ``t_star``, ``s_star`` and tokens exact; series 2e-4 of their
scale. The seeds were chosen without near-ties; the retraction test with
the prior asserts the confidences and their ranks before ``t_star``.

``critical_reverse_sampling``'s exits are hit on purpose with a scripted
prior (``scripted_apply``) whose prediction is the true token until a row
holds more than ``k`` mask tokens: with k = n it never errs, so the walk
ends at a schedule plateau or at t = 1; with a smaller k the error jumps
from 0 and the moving average of the error ratio passes 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_sampler import CFG, C, L, N_CLASSES
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.generation import TrainedModelSampler as JTrainedModelSampler
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.train.stage2 import make_prior_apply_fns
from tvqvae_tpu.utils import checkpoint as jckpt
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.train.stage2 import init_stage2
from tvqvae_tpu_torch.utils import convert

T_L = 8
ESS_CFG = {**CFG, "MaskGIT": {**CFG["MaskGIT"], "T": {"lf": T_L, "hf": 1},
                              "ESS": {"use": True}}}
ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The port's seeded stage 1 and priors, and the same trees as flax
    trees with JAX's apply functions over them."""
    jcfg, cfg = JConfig.from_dict(ESS_CFG), Config.from_dict(ESS_CFG)
    js1, s1 = JStage1Spec.from_config(jcfg, L, C), Stage1Spec.from_config(cfg, L, C)
    g = torch.Generator().manual_seed(0)
    model, vq_l, vq_h = init_stage1(s1, g, "cpu")
    t_l, t_h = init_stage2(*tmg.build_transformers(cfg, s1, N_CLASSES), g, "cpu")
    t_l.eval(), t_h.eval()
    params, h_stats = convert.prior_to_jax(t_l, t_h)
    jt_l, jt_h = jmg.build_transformers(jcfg, js1, N_CLASSES)
    j_l, j_h = make_prior_apply_fns(jt_l, jt_h, params, h_stats)
    spec = jmg.MaskGITSpec.from_config(jcfg, js1)
    with torch.no_grad():  # spread the codebook: the critic's distances then rarely tie
        vq_l.embed.copy_(torch.randn(vq_l.embed.shape, generator=g))
    return dict(
        jcfg=jcfg, cfg=cfg, spec=spec, tspec=tmg.MaskGITSpec.from_config(cfg, s1),
        j_l=jax.jit(j_l), j_h=jax.jit(j_h),
        t_l=lambda s, c: t_l(s, None, c), t_h=lambda a, b, c: t_h(a, b, c),
        embed=vq_l.embed.clone(), jembed=jnp.asarray(vq_l.embed.numpy()),
        stage1=convert.stage1_to_jax(model, vq_l, vq_h),
        stage2={"params": params, "h_stats": h_stats},
    )


def band_noise(r, T, num, n, K):
    """``decode_band_scan``'s draws from key ``r``, in the port's layout."""
    g_s, g_c = [], []
    for step in jax.random.split(r, T):
        r_s, r_g = jax.random.split(step)
        g_s.append(np.array(jax.random.gumbel(r_s, (num, n, K))))
        g_c.append(np.array(jmg._gumbel(r_g, (num, n))))
    return torch.from_numpy(np.stack(g_s)), torch.from_numpy(np.stack(g_c))


def critic_noise(r, T, num, n, K):
    """``decode_with_token_critic``'s draws from key ``r``: row t-1 holds
    step t's (``fold_in(r, t)``)."""
    g_s, g_c = [], []
    for t in range(1, T):
        r_s, r_g = jax.random.split(jax.random.fold_in(r, t))
        g_s.append(np.array(jax.random.gumbel(r_s, (num, n, K))))
        g_c.append(np.array(jmg._gumbel(r_g, (num, n))))
    return torch.from_numpy(np.stack(g_s)), torch.from_numpy(np.stack(g_c))


def ess_noise(rng, spec, num):
    """``iterative_decoding_ess(rng, ...)``'s draws."""
    r_l, r_crit, r_h = jax.random.split(rng, 3)
    return {"l": band_noise(r_l, spec.T_l, num, spec.tokens_l, spec.mask_token_l),
            "crit": critic_noise(r_crit, spec.T_l, num, spec.tokens_l, spec.mask_token_l),
            "h": band_noise(r_h, spec.T_h, num, spec.tokens_h, spec.mask_token_h)}


def tokens(seed, shape, K):
    return np.random.default_rng(seed).integers(0, K, size=shape).astype(np.int32)


def cond_pair(class_index, num):
    if class_index is None:
        return None, None
    c = np.full((num, 1), class_index, np.int32)
    return jnp.asarray(c), torch.from_numpy(c)


# ---------------------------------------------------------------------------
# the confidences and the float32 schedule


@pytest.mark.parametrize("class_index", [None, 2])
def test_confidence_score_matches_jax(world, class_index):
    w, num = world, 5
    s = tokens(1, (num, w["spec"].tokens_l), w["spec"].mask_token_l)
    jc, tc = cond_pair(class_index, num)
    ref = jmg.compute_confidence_score(w["j_l"], jnp.asarray(s), w["spec"].mask_token_l,
                                       w["jembed"], jc)
    with torch.no_grad():
        got = tmg.compute_confidence_score(w["t_l"], torch.from_numpy(s), w["spec"].mask_token_l,
                                           w["embed"], tc)
    assert got.shape == (num, w["spec"].tokens_l) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_confidence_tiles_the_condition_variant_major():
    """Variant i of every row sees row j's condition at flat index i*b + j
    (``jnp.tile``), not b*j + i."""
    seen = []

    def apply_fn(s, cond):
        seen.append(cond.clone())
        return torch.zeros(s.shape + (4,))

    cond = torch.tensor([[0], [1], [2]], dtype=torch.int32)
    tmg.compute_confidence_score(apply_fn, torch.zeros((3, 2), dtype=torch.int32), 4,
                                 torch.zeros(4, 2), cond)
    assert seen[0].flatten().tolist() == [0, 1, 2, 0, 1, 2]


@jax.jit
def _jax_mask_lens(num_tokens, tf, T):
    """JAX's ``mask_len`` (``critical_reverse_sampling``) over arrays: the
    Python ints it sees are exact in float32, as here."""
    return jnp.clip(jnp.floor(num_tokens * jmg.gamma_fn_jnp("cosine")(tf / T)), 0,
                    None).astype(jnp.int32)


@pytest.mark.parametrize("num_tokens", [12, 24, 27, 96, 108])
def test_ess_mask_len_matches_jax_float32(num_tokens):
    """The config's token counts (this file's 12/24, the quality run's 24/96,
    the published 27/108) for T = 1..12 at every t + 1 and at JAX's 2.0."""
    cases = [(tf, T) for T in range(1, 13)
             for tf in sorted({float(t) for t in range(1, T + 1)} | {2.0})]
    tf, T = (np.asarray(v, np.float32) for v in zip(*cases))
    want = np.asarray(_jax_mask_lens(np.float32(num_tokens), tf, T))
    got = [tmg.ess_mask_len(num_tokens, a, b) for a, b in cases]
    assert got == want.tolist()
    assert len(set(got)) >= 10  # the table is not degenerate


# ---------------------------------------------------------------------------
# critical reverse sampling: each exit


def scripted_apply(framework, s_true, k, K):
    """A prior that predicts the true tokens while a row holds at most ``k``
    mask tokens and the next code otherwise."""
    if framework == "jax":
        truth = jnp.asarray(s_true)

        def fn(s, cond):
            m = jnp.sum(s == K, axis=-1, keepdims=True)
            return 10.0 * jax.nn.one_hot(jnp.where(m <= k, truth, (truth + 1) % K), K)
    else:
        truth = torch.from_numpy(s_true).long()

        def fn(s, cond):
            m = (s == K).sum(-1, keepdim=True)
            return 10.0 * torch.nn.functional.one_hot(
                torch.where(m <= k, truth, (truth + 1) % K), K).float()
    return fn


def _first_exit(n, T, k):
    """Where the scripted walk stops, by the rules (no model): the first
    plateau, the first error after the seeding forward, or t = 1."""
    ml = lambda tf: tmg.ess_mask_len(n, tf, T)  # noqa: E731
    for t in range(T - 1, 0, -1):
        if ml(t + 1.0) == ml(float(t)):
            return t, "plateau"
        if t == 1:
            return t, "t == 1"
        if t != T - 1 and ml(float(t)) > k:
            return t, "moving average"
    return 1, "fallback"


@pytest.mark.parametrize("n,T,k,exit_", [
    (8, 10, 8, "plateau"),  # ml(3) = ml(2) = 7: the walk stops at t = 2
    (96, 10, 96, "t == 1"),  # ml(t) all distinct, the prior never errs
    (96, 10, 40, "moving average"),  # the error jumps once 40 are masked
    (12, 1, 12, "fallback"),  # T = 1: t_star = 1 and the t = 2 re-masking
])
def test_critical_reverse_sampling_exits_match_jax(world, n, T, k, exit_):
    K, num = 8, 3
    t_want, how = _first_exit(n, T, k)
    assert how == exit_
    s = tokens(3, (num, n), K)
    conf = np.random.default_rng(4).random((num, n)).astype(np.float32)
    embed = np.random.default_rng(5).normal(size=(K, 6)).astype(np.float32)
    j_t, j_s = jmg.critical_reverse_sampling(
        scripted_apply("jax", s, k, K), jnp.asarray(s), jnp.asarray(conf), K, T, n,
        jnp.asarray(embed))
    t_t, t_s = tmg.critical_reverse_sampling(
        scripted_apply("torch", s, k, K), torch.from_numpy(s), torch.from_numpy(conf), K, T, n,
        torch.from_numpy(embed))
    assert t_t == int(j_t) == t_want
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


@pytest.mark.parametrize("class_index,seed", [(None, 6), (1, 7)])
def test_critical_reverse_sampling_with_the_prior_matches_jax(world, class_index, seed):
    w, num = world, 4
    spec = w["spec"]
    s = tokens(seed, (num, spec.tokens_l), spec.mask_token_l)
    jc, tc = cond_pair(class_index, num)
    conf = jmg.compute_confidence_score(w["j_l"], jnp.asarray(s), spec.mask_token_l,
                                        w["jembed"], jc)
    j_t, j_s = jmg.critical_reverse_sampling(w["j_l"], jnp.asarray(s), conf, spec.mask_token_l,
                                             spec.T_l, spec.tokens_l, w["jembed"], jc)
    with torch.no_grad():
        t_conf = tmg.compute_confidence_score(w["t_l"], torch.from_numpy(s), spec.mask_token_l,
                                              w["embed"], tc)
        np.testing.assert_allclose(t_conf.numpy(), np.asarray(conf), atol=1e-5)
        assert torch.equal(tmg._rank(t_conf), torch.from_numpy(np.array(jmg._rank(conf))))
        t_t, t_s = tmg.critical_reverse_sampling(w["t_l"], torch.from_numpy(s), t_conf,
                                                 spec.mask_token_l, spec.T_l, spec.tokens_l,
                                                 w["embed"], tc)
    assert t_t == int(j_t)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


# ---------------------------------------------------------------------------
# the critic-guided re-decode and the whole ESS pass


@pytest.mark.parametrize("t_star", [1, T_L // 2, T_L - 1])
def test_decode_with_token_critic_matches_jax(world, t_star):
    w, num = world, 4
    spec = w["spec"]
    n, K = spec.tokens_l, spec.mask_token_l
    s = tokens(8, (num, n), K)
    rank = np.argsort(np.argsort(np.random.default_rng(9).random((num, n)), -1), -1)
    s = np.where(rank < tmg.ess_mask_len(n, t_star + 0.0, T_L), K, s).astype(np.int32)
    r = jax.random.key(10 + t_star)
    jc, tc = cond_pair(0, num)
    ref = jmg.decode_with_token_critic(r, w["j_l"], jnp.asarray(s), jnp.int32(t_star), K, T_L, n,
                                       spec.choice_temp_l, w["jembed"], jc)
    with torch.no_grad():
        got = tmg.decode_with_token_critic(w["t_l"], torch.from_numpy(s), t_star, K, T_L, n,
                                           spec.choice_temp_l, w["embed"], tc,
                                           noise=critic_noise(r, T_L, num, n, K))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if t_star == T_L - 1:  # the last step re-masks nothing
        assert (got.numpy() != K).all()


@pytest.mark.parametrize("class_index", [None, 2])
def test_iterative_decoding_ess_matches_jax(world, class_index):
    w, num = world, 4
    spec = w["spec"]
    rng = jax.random.key(21)
    embed_h = jnp.zeros((spec.mask_token_h, 1))  # not read by the HF pass
    ref_l, ref_h = jax.jit(lambda r: jmg.iterative_decoding_ess(
        r, spec, w["j_l"], w["j_h"], w["jembed"], embed_h, num, class_index))(rng)
    with torch.no_grad():
        s_l, s_h, t_star = tmg.iterative_decoding_ess(
            w["tspec"], w["t_l"], w["t_h"], w["embed"], num, class_index, device="cpu",
            noise=ess_noise(rng, spec, num))
    assert 1 <= t_star < T_L
    np.testing.assert_array_equal(s_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(s_h.numpy(), np.asarray(ref_h))


# ---------------------------------------------------------------------------
# the sampler


@pytest.fixture(scope="module")
def jax_sampler(world, tmp_path_factory):
    """The JAX package's sampler over the same weights, read from Orbax
    checkpoints as it reads them."""
    root = tmp_path_factory.mktemp("ess")
    meta = {"config": {}, "input_length": L, "in_channels": C, "n_classes": N_CLASSES}
    for name in ("stage1", "stage2"):
        jckpt.save_checkpoint(str(root / name), world[name], meta=meta)
    return JTrainedModelSampler(world["jcfg"], str(root / "stage1"), str(root / "stage2"),
                                batch_size=4)


def _jax_batches(seed, spec, bs, n):
    """The draws of JAX's ``sample(n, seed=seed)``: one key per batch."""
    rng, out = jax.random.key(seed), []
    for _ in range(0, n, bs):
        rng, r = jax.random.split(rng)
        out.append(ess_noise(r, spec, bs))
    return out


@pytest.mark.parametrize("class_index", [None, 1])
def test_sampler_with_ess_matches_jax_sampler(world, jax_sampler, class_index):
    """Six samples in batches of 4: the second batch draws 4 and keeps 2, as
    JAX's does (one t_star per batch of 4)."""
    w, n, seed = world, 6, 3
    assert jax_sampler.use_ess
    kind = "unconditional" if class_index is None else "conditional"
    ref = jax_sampler.sample(n, kind, class_index=class_index, seed=seed)
    port = TrainedModelSampler(w["cfg"], w["stage1"], w["stage2"], input_length=L,
                               in_channels=C, n_classes=N_CLASSES, batch_size=4, device="cpu")
    assert port.use_ess and port._ess_rate == 0.3
    out = port.sample(n, kind, class_index=class_index,
                      noise=_jax_batches(seed, w["spec"], 4, n))
    for o, r in zip(out, ref):
        assert o.shape == (n, C, L)
        assert np.abs(o - r).max() <= ATOL * np.abs(r).max()


def test_the_three_constructors_build_ess(world, tmp_path):
    """``__init__``, ``from_init`` and ``from_checkpoints`` take the ESS
    branch from the config, under float32, ``fast_bn`` and bfloat16, with
    the enhancer on; a seeded sampler repeats itself."""
    from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = world["cfg"]
    meta = {"input_length": L, "in_channels": C, "n_classes": N_CLASSES}
    for name in ("stage1", "stage2"):
        save_checkpoint(str(tmp_path / name), world[name], meta)
    samplers = [
        TrainedModelSampler.from_init(cfg, L, C, N_CLASSES, seed=1, device="cpu", batch_size=3,
                                      use_fidelity_enhancer=True, compute_dtype="bfloat16",
                                      fast_bn=True),
        TrainedModelSampler.from_checkpoints(cfg, str(tmp_path / "stage1"),
                                             str(tmp_path / "stage2"), batch_size=3,
                                             device="cpu", fast_bn=True),
        TrainedModelSampler(cfg, world["stage1"], world["stage2"], input_length=L, in_channels=C,
                            n_classes=N_CLASSES, batch_size=3, device="cpu"),
    ]
    for s in samplers:
        assert s.use_ess
        x = s.sample(4, "conditional", class_index=0, seed=2)[2]
        assert x.shape == (4, C, L) and x.dtype == np.float32 and np.isfinite(x).all()
        np.testing.assert_array_equal(x, s.sample(4, "conditional", class_index=0, seed=2)[2])
    plain = TrainedModelSampler(dataclasses.replace(cfg, maskgit=dataclasses.replace(
        cfg.maskgit, ess_use=False)), world["stage1"], world["stage2"], input_length=L,
        in_channels=C, n_classes=N_CLASSES, batch_size=3, device="cpu")
    assert not plain.use_ess
