"""Port parity: stage-2 training (the MaskGIT priors) and the initialiser.

The same numpy-seeded inputs go through the JAX package and the port, on
the CPU, at a small size: stage 1 at L=127, C=4, hid_dim 16, codebooks 8/8
(12 LF and 24 HF tokens); LF prior 16 wide, 2 layers, 2 heads; HF prior 8
wide, 1 layer, 1 head; 3 classes; B=4. Tolerances, each with its reason:

  - ``random_mask_tokens`` with JAX's uniform draws handed in: masked grids
    and keep masks exactly (integer results of float32 comparisons).
  - ``masked_ce`` to 1e-6 relative (a float32 log-softmax and one sum).
  - the train branches on their own, structurally: exact where the port
    only selects or multiplies by 0 or 1; the drop rates within a few
    binomial standard deviations.
  - the Upscale BatchNorm in train mode against flax to 1e-5: flax takes
    the batch variance as E[x^2] - E[x]^2, the port a two-pass variance,
    equal to rounding over B*M = 96 rows.
  - ten steps of the JAX package's jitted token step, all dropouts and
    p_unconditional 0, JAX's masking draws handed in: losses to 1e-5
    relative every step; every parameter (the zero-gradient ones included,
    which weight decay moves) and the HF BatchNorm statistics to 1e-4 after
    ten steps.
  - the port's on-the-fly step against its token step (dropout on, same
    generator seed): exactly equal (same code and inputs on the CPU).
  - the token dataset against JAX's on N=70 (not a multiple of 64): equal.
  - ``init_weights_`` against flax's initialisers, leaf by leaf (>= 256
    elements): std within 5% of JAX's draw, kernels inside flax's +-2
    truncation, biases zero.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models import transformer as jtr
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.vq import init_codebook as j_init_codebook
from tvqvae_tpu.train import stage2 as jst2
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models.layers import TRUNCATED_NORMAL_STD, BatchNorm1d, init_weights_
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.models.transformer import BidirectionalTransformer, EncoderBlock, Upscale
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage2 as tst2
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.train.stage1 import create_stage1_state
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

L, C, B, N_CLASSES = 127, 4, 4, 3
LR, MAX_STEPS, STEPS = 1e-3, 100, 10
DRAWS = 16  # initialiser draws a side


def make_cfg(rate=0.0, p_unconditional=0.0):
    prior = {"ff_mult": 1, "use_rmsnorm": True, "p_unconditional": p_unconditional,
             "model_dropout": rate, "emb_dropout": rate}
    return {
        "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                    "downsampled_width": {"lf": 4, "hf": 8}},
        "decoder": {"n_resnet_blocks": 1},
        "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
        "MaskGIT": {
            "T": {"lf": 3, "hf": 1},
            "prior_model_l": {**prior, "hidden_dim": 16, "n_layers": 2, "heads": 2},
            "prior_model_h": {**prior, "hidden_dim": 8, "n_layers": 1, "heads": 1},
        },
    }


def randomize(tree, rng):
    """Random values where flax's init leaves a constant: biases, norm
    scales, the logit bias and the BatchNorm statistics."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(dict(v), rng)
            continue
        shape = np.shape(v)
        draw = {"var": lambda: rng.uniform(0.5, 1.5, shape),
                "scale": lambda: rng.uniform(0.8, 1.2, shape)}.get(k)
        if k in ("mean", "bias", "logit_bias"):
            draw = lambda: 0.1 * rng.normal(size=shape)  # noqa: E731
        out[k] = jnp.asarray(draw() if draw else np.asarray(v), jnp.float32)
    return out


def _port_priors(cfg_dict, params=None, h_stats=None, seed=0):
    cfg = Config.from_dict(cfg_dict)
    s1 = Stage1Spec.from_config(cfg, L, C)
    t_l, t_h = tmg.build_transformers(cfg, s1, N_CLASSES)
    if params is None:
        return tst2.init_stage2(t_l, t_h, torch.Generator().manual_seed(seed), "cpu")
    sd_l, sd_h = convert.prior_from_jax(params, h_stats)
    t_l.load_state_dict(sd_l)
    t_h.load_state_dict(sd_h)
    return t_l, t_h


def _tx():
    return functools.partial(adamw, learning_rate=warmup_cosine_schedule(LR, MAX_STEPS, 0.1),
                             weight_decay=0.01)


def _jax_mask_draws(key, B_, n):
    """The uniforms ``random_mask_tokens(key, ...)`` draws in the JAX package."""
    r_ratio, r_pos = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(r_ratio, (B_,)))),
            torch.from_numpy(np.array(jax.random.uniform(r_pos, (B_, n)))))


# ---------------------------------------------------------------------------
# masking and the loss


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_mask_tokens_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 8, size=(6, 27)).astype(np.int32)
    key = jax.random.key(seed)
    ref_s, ref_keep = jmg.random_mask_tokens(key, jnp.asarray(s), 8)
    s_M, keep = tmg.random_mask_tokens(torch.from_numpy(s), 8, noise=_jax_mask_draws(key, 6, 27))
    np.testing.assert_array_equal(s_M.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    assert s_M.dtype == torch.int32


def test_random_mask_tokens_keeps_between_0_and_n_minus_1():
    n = 27
    s = torch.zeros(5, n, dtype=torch.int32)
    ratio = torch.tensor([0.0, 1e-7, 0.5, 0.9999, 1.0 - 2.0 ** -24])
    scores = torch.rand((5, n), generator=torch.Generator().manual_seed(0))
    _, keep = tmg.random_mask_tokens(s, 8, noise=(ratio, scores))
    counts = keep.sum(-1).tolist()
    assert counts[0] == counts[1] == n - 1  # gamma(0) = 1 would keep all n: clipped
    assert counts[-1] == 0 and all(0 <= c <= n - 1 for c in counts)
    # the kept positions are those of the highest scores
    for row in range(5):
        kept = scores[row][keep[row]]
        if 0 < len(kept) < n:
            assert kept.min() > scores[row][~keep[row]].max()
    # seeded draws repeat
    a = tmg.random_mask_tokens(s, 8, generator=torch.Generator().manual_seed(3))
    b = tmg.random_mask_tokens(s, 8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("all_kept", [False, True])
def test_masked_ce_matches_jax(all_kept):
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(4, 12, 8))).astype(np.float32)
    targets = rng.integers(0, 8, size=(4, 12)).astype(np.int32)
    keep = rng.uniform(size=(4, 12)) < 0.4
    keep[1] = True  # a row with no masked position
    if all_kept:
        keep[:] = True
    ref = float(jmg.masked_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(keep)))
    got = tmg.masked_ce(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(keep))
    assert got.dtype == torch.float32
    if all_kept:
        assert got.item() == ref == 0.0
    else:
        np.testing.assert_allclose(got.item(), ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# the train branches, each on its own


@pytest.mark.parametrize("branch", ["attention", "feed_forward"])
def test_layer_dropout_is_one_unscaled_draw_for_the_whole_batch(branch):
    """With the other branch's output layer zeroed, the block gives exactly
    x (dropped) or the eval output (kept, not rescaled) for every sample."""
    gen = torch.Generator().manual_seed(0)
    blk = EncoderBlock(16, 2, layer_dropout=0.5)
    init_weights_(blk, gen)
    other = blk.Dense_5 if branch == "attention" else blk.Dense_3
    with torch.no_grad():
        other.weight.zero_()
        other.bias.zero_()
        x = torch.randn(8, 5, 16, generator=gen)
        kept = blk(x)
        assert not torch.equal(kept, x)
        outs = [blk(x, train=True, generator=gen) for _ in range(200)]
    picks = [torch.equal(y, kept) for y in outs]
    assert all(p or torch.equal(y, x) for p, y in zip(picks, outs))
    assert abs(np.mean(picks) - 0.5) < 0.12  # 200 draws: 0.035 binomial std


def test_attention_and_feed_forward_dropout_are_inverted():
    """Rate 0.5 on the attention probabilities: each kept probability is
    doubled, so a row of the dropped matrix sums to 2 x (kept mass)."""
    from tvqvae_tpu_torch.models.layers import dropout

    attn = torch.softmax(torch.randn(4, 2, 6, 6, generator=torch.Generator().manual_seed(1)), -1)
    dropped = dropout(attn, 0.5, torch.Generator().manual_seed(2))
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], attn[kept] * 2.0, rtol=0, atol=0)
    blk = EncoderBlock(16, 2, dropout=0.3)
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        a = blk(x, train=True, generator=torch.Generator().manual_seed(5))
        b = blk(x, train=True, generator=torch.Generator().manual_seed(5))
        c = blk(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _prior(kind="lf", p_unconditional=0.0, rate=0.0):
    return BidirectionalTransformer(kind, 12 if kind == "lf" else 24, 8, 8, 16, 16, 1, 1, 1, True,
                                    N_CLASSES, p_unconditional=p_unconditional,
                                    model_dropout=rate, emb_dropout=rate)


def test_class_dropout_rate_and_inclusive_threshold(monkeypatch):
    t = _prior(p_unconditional=0.2)
    n = 20000
    cond = torch.randint(0, N_CLASSES, (n, 1), generator=torch.Generator().manual_seed(0))
    idx = t._class_index(cond, n, "cpu", True, torch.Generator().manual_seed(1))
    dropped = idx == N_CLASSES
    assert abs(dropped.float().mean().item() - 0.2) < 0.015  # 0.0028 binomial std
    assert torch.equal(idx[~dropped], cond.long()[~dropped])
    assert torch.equal(t._class_index(cond, n, "cpu", False, None), cond.long())
    assert (t._class_index(None, 3, "cpu", True, None) == N_CLASSES).all()
    # a draw equal to p_unconditional drops the class (JAX tests uniform <= p)
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.full(shape, 0.2))
    assert (t._class_index(cond[:5], 5, "cpu", True, None) == N_CLASSES).all()


def test_token_dropout_spares_mask_tokens_and_scales_kept_ones():
    t = _prior(rate=0.3)
    gen = torch.Generator().manual_seed(0)
    s = torch.randint(0, 9, (64, 12), generator=gen)  # 8 is the mask token
    emb = torch.randn(64, 12, 16, generator=gen) + 3.0  # no zero entries
    out = t._token_dropout(s, emb, 8, True, gen)
    mask = (s == 8)[..., None].expand_as(emb)
    assert mask.any() and torch.equal(out[mask], emb[mask])
    kept = (out != 0) & ~mask
    torch.testing.assert_close(out[kept], emb[kept] / 0.7, rtol=0, atol=0)
    assert abs(1 - kept.sum().item() / (~mask).sum().item() - 0.3) < 0.02
    assert torch.equal(t._token_dropout(s, emb, 8, False, gen), emb)


@pytest.mark.parametrize("kind", ["lf", "hf"])
def test_eval_mode_is_unchanged_by_the_rates_and_draws_nothing(kind):
    gen = torch.Generator().manual_seed(0)
    a = init_weights_(_prior(kind, p_unconditional=0.2, rate=0.3), gen)
    b = _prior(kind)
    b.load_state_dict(a.state_dict())
    n = 12 if kind == "lf" else 24
    s_l = torch.randint(0, 9, (3, 12), generator=gen)
    s_h = torch.randint(0, 9, (3, n), generator=gen) if kind == "hf" else None
    cond = torch.tensor([[0], [2], [1]])
    state = gen.get_state()
    with torch.no_grad():
        out_a = a(s_l, s_h, cond, generator=gen)
        out_b = b(s_l, s_h, cond)
    assert torch.equal(out_a, out_b) and torch.equal(gen.get_state(), state)
    with torch.no_grad():
        a(s_l, s_h, cond, train=True, generator=gen)
        assert a.training and not torch.equal(gen.get_state(), state)
        a(s_l, s_h, cond)  # the mode follows ``train``, not the last call
    assert not a.training


def test_upscale_batchnorm_train_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    jm = jtr.Upscale(out_dim=16, hidden_dim=32)
    var = jm.init(jax.random.key(0), jnp.asarray(x), 24, False)
    var = randomize({"params": var["params"], "batch_stats": var["batch_stats"]}, rng)
    y_ref, mut = jm.apply(var, jnp.asarray(x), 24, True, mutable=["batch_stats"])
    m = Upscale(16, 16, 32)
    m.load_state_dict(convert.params_to_state_dict(var["params"], var["batch_stats"]))
    assert isinstance(m.BatchNorm_0, BatchNorm1d)
    with torch.no_grad():
        y = m.train()(torch.from_numpy(x), 24)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **tol)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(m.BatchNorm_0.running_mean.numpy(), np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(m.BatchNorm_0.running_var.numpy(), np.asarray(stats["var"]), **tol)
    with torch.no_grad():  # eval: the running statistics, as flax's use_running_average
        y_eval = m.eval()(torch.from_numpy(x), 24)
    ref_eval = jm.apply({"params": var["params"], "batch_stats": mut["batch_stats"]},
                        jnp.asarray(x), 24, False)
    np.testing.assert_allclose(y_eval.numpy(), np.asarray(ref_eval), **tol)


# ---------------------------------------------------------------------------
# ten steps against the JAX package's jitted token step


@pytest.fixture(scope="module")
def run():
    jcfg = JConfig.from_dict(make_cfg())
    js1 = JStage1Spec.from_config(jcfg, L, C)
    spec = jmg.MaskGITSpec.from_config(jcfg, js1)
    jt_l, jt_h = jmg.build_transformers(jcfg, js1, N_CLASSES)
    params, h_stats = jst2.init_stage2(jax.random.key(0), jt_l, jt_h, spec)
    rng = np.random.default_rng(0)
    params, h_stats = randomize(params, rng), randomize(h_stats, rng)
    tx = j_adamw(j_schedule(LR, MAX_STEPS, 0.1), weight_decay=0.01)
    jstate = jst2.create_stage2_state(params, h_stats, tx)
    jstep = jax.jit(jst2.make_stage2_train_step_tokens(jt_l, jt_h, spec, tx))

    t_l, t_h = _port_priors(make_cfg(), params, h_stats)
    tstate = tst2.create_stage2_state(t_l, t_h, _tx())
    tstep = tst2.stage2_train_step_tokens
    bias0 = t_l.logit_bias.detach().clone()

    data = np.random.default_rng(1)
    key = jax.random.key(7)
    res = {"j": [], "t": []}
    for t in range(STEPS):
        s_l = data.integers(0, 8, size=(B, spec.tokens_l)).astype(np.int32)
        s_h = data.integers(0, 8, size=(B, spec.tokens_h)).astype(np.int32)
        y = data.integers(0, N_CLASSES, size=(B, 1)).astype(np.int32)
        # the masking draws of JAX's step t: fold_in(key, step), split in four
        r_l, r_h, _, _ = jax.random.split(jax.random.fold_in(key, t), 4)
        noise = {"l": _jax_mask_draws(r_l, B, spec.tokens_l),
                 "h": _jax_mask_draws(r_h, B, spec.tokens_h)}
        jstate, jm = jstep(jstate, jnp.asarray(s_l), jnp.asarray(s_h), jnp.asarray(y), key)
        _, tm = tstep(tstate, torch.from_numpy(s_l), torch.from_numpy(s_h), torch.from_numpy(y),
                      noise=noise)
        res["j"].append({k: float(v) for k, v in jm.items()})
        res["t"].append({k: v.item() for k, v in tm.items()})
    sd_l, sd_h = convert.prior_from_jax(jstate.params, jstate.h_stats)
    res.update(tstate=tstate, j_final={"l": sd_l, "h": sd_h}, bias0=bias0)
    return res


def test_ten_token_steps_losses_match_jax(run):
    for t, (j, p) in enumerate(zip(run["j"], run["t"])):
        assert set(p) == set(j) == {"loss", "mask_pred_loss", "mask_pred_loss_l", "mask_pred_loss_h"}
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-5, err_msg=f"step {t + 1} {k}")
    assert run["tstate"].step == STEPS


def test_ten_token_steps_parameters_and_statistics_match_jax(run):
    tstate = run["tstate"]
    n = 0
    for band, prior in (("l", tstate.t_l), ("h", tstate.t_h)):
        ours = prior.state_dict()
        ref = run["j_final"][band]
        assert set(ours) == set(ref)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{band}.{k}")
            n += 1
    assert n == len(tstate.optimizer.param_groups[0]["params"]) + 2  # + the HF BN statistics
    # the mask-token column of the logit bias has a zero gradient (its logit
    # is dropped); weight decay moves it all the same, as optax does
    bias = tstate.t_l.logit_bias.detach()
    assert (bias[:, -1] != run["bias0"][:, -1]).all()


# ---------------------------------------------------------------------------
# the stage-1 hand-off, the token dataset, the on-the-fly step


def _draws(init):
    """DRAWS calls of a jitted flax init, each leaf stacked on a leading axis."""
    keys = jax.random.split(jax.random.key(0), DRAWS)
    return jax.tree.map(lambda *a: jnp.stack(a), *[init(k) for k in keys])


@pytest.fixture(scope="module")
def j_stage1():
    """The JAX package's small stage 1 and DRAWS draws of its flax init
    (one compiled init, leaves stacked on a leading axis)."""
    js1 = JStage1Spec.from_config(JConfig.from_dict(make_cfg()), L, C)
    model = JStage1Model(js1)
    vq_l, vq_h = (j_init_codebook(jax.random.key(i), p) for i, p in ((1, js1.vq_l), (2, js1.vq_h)))
    x = jnp.zeros((2, C, L))
    init = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x, vq_l, vq_h, False))
    return model, _draws(init), vq_l, vq_h


@pytest.fixture(scope="module")
def stage1(j_stage1):
    """A small stage 1 (the first init draw, random BatchNorm statistics), in both packages."""
    model, draws, vq_l, vq_h = j_stage1
    p1 = jax.tree.map(lambda a: a[0], draws["params"])
    bs1 = randomize(jax.tree.map(lambda a: a[0], draws["batch_stats"]), np.random.default_rng(2))
    jfrozen = jmg.FrozenStage1(params=p1, batch_stats=bs1, vq_l=vq_l, vq_h=vq_h)
    s1 = Stage1Spec.from_config(Config.from_dict(make_cfg()), L, C)
    tree = {"params": p1, "batch_stats": bs1, "vq_l": vq_l, "vq_h": vq_h}
    frozen = tmg.FrozenStage1.from_state_dict(s1, convert.stage1_from_jax(tree), "cpu")
    X = np.random.default_rng(3).normal(size=(70, C, L)).astype(np.float32)
    return model, jfrozen, frozen, X


def test_precompute_token_dataset_matches_jax(stage1):
    model, jfrozen, frozen, X = stage1
    ref_l, ref_h = jst2.precompute_token_dataset(model, jfrozen, X, batch_size=64)
    tok_l, tok_h = tst2.precompute_token_dataset(frozen, X, batch_size=64)
    assert tok_l.dtype == tok_h.dtype == np.int32
    assert tok_l.shape == (70, 12) and tok_h.shape == (70, 24)
    np.testing.assert_array_equal(tok_l, ref_l)
    np.testing.assert_array_equal(tok_h, ref_h)
    # a tensor split gives the same sweep
    dev_l, dev_h = tst2.precompute_token_dataset(frozen, torch.from_numpy(X), batch_size=64)
    np.testing.assert_array_equal(dev_l, tok_l)
    np.testing.assert_array_equal(dev_h, tok_h)


def test_on_the_fly_step_equals_token_step(stage1):
    """Dropout 0.3 and p_unconditional 0.2 on: the encode draws nothing, so
    from the same generator seed the two steps give the same update."""
    _, _, frozen, X = stage1
    cfg = make_cfg(rate=0.3, p_unconditional=0.2)
    t_l, t_h = _port_priors(cfg, seed=4)
    a = tst2.create_stage2_state(t_l, t_h, _tx())
    b = tst2.create_stage2_state(copy.deepcopy(t_l), copy.deepcopy(t_h), _tx())
    tok_l, tok_h = tst2.precompute_token_dataset(frozen, X)
    fly, tok = tst2.make_stage2_train_step(frozen), tst2.stage2_train_step_tokens
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    y = torch.from_numpy(np.random.default_rng(5).integers(0, N_CLASSES, (70, 1)))
    for t in range(3):
        idx = torch.arange(8 * t, 8 * t + 8)
        _, ma = fly(a, torch.from_numpy(X)[idx], y[idx], ga)
        _, mb = tok(b, torch.from_numpy(tok_l)[idx], torch.from_numpy(tok_h)[idx], y[idx], gb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma), t
    for pa, pb in zip([*a.t_l.state_dict().values(), *a.t_h.state_dict().values()],
                      [*b.t_l.state_dict().values(), *b.t_h.state_dict().values()]):
        assert torch.equal(pa, pb)


def test_frozen_stage1_from_stage1_state():
    s1 = Stage1Spec.from_config(Config.from_dict(make_cfg()), L, C)
    model, vq_l, vq_h = init_stage1(s1, torch.Generator().manual_seed(0), "cpu")
    state = create_stage1_state(model, vq_l, vq_h, _tx())
    frozen = tmg.FrozenStage1.from_stage1_state(state)
    assert not frozen.model.training and frozen.model is not state.model
    assert not any(p.requires_grad for p in frozen.model.parameters())
    assert all(p.requires_grad for p in state.model.parameters())
    for k, v in state.model.state_dict().items():
        assert torch.equal(frozen.model.state_dict()[k], v)
    assert frozen.vq_l is state.vq_l and frozen.vq_h is state.vq_h


# ---------------------------------------------------------------------------
# the runner, on the CPU


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    X, y = tdata.make_synthetic_trajectories(n=80, channels=C, length=L, seed=7)
    path = str(tmp_path_factory.mktemp("data") / "d.npz")
    tdata.save_npz(path, X, y)
    data = tdata.get_data(path, ["latitude", "longitude", "altitude", "timedelta"])
    s1 = Stage1Spec.from_config(Config.from_dict(make_cfg()), L, C)
    model, vq_l, vq_h = init_stage1(s1, torch.Generator().manual_seed(0), "cpu")
    return data, tmg.FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)


def _tiny_cfg():
    return Config.from_dict({**make_cfg(rate=0.3, p_unconditional=0.2),
                             "dataset": {"batch_sizes": {"stage2": 8}},
                             "trainer_params": {"val_check_interval": {"stage2": 20}}})


class _Recorder:
    def __init__(self):
        self.loss = []

    def log_metrics(self, metrics, step):
        self.loss.append(metrics["train/loss"].item())


def test_train_stage2_on_cpu_learns(tiny, capsys):
    data, frozen = tiny
    rec = _Recorder()
    state = runner.train_stage2(_tiny_cfg(), data, frozen, max_steps=60, device="cpu",
                                logger=rec, log_interval=1)
    assert state.step == 60 and len(rec.loss) == 60 and np.isfinite(rec.loss).all()
    assert np.mean(rec.loss[-10:]) < np.mean(rec.loss[6:16])
    assert "[stage2] precomputed 72 token rows in" in capsys.readouterr().out
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-6)
    # the HF prior's Upscale BatchNorm moved its running statistics
    assert not torch.equal(state.t_h.projector.BatchNorm_0.running_var, torch.ones(32))


def test_train_stage2_paths_agree(tiny):
    """The runner's precomputed-token steps and the on-the-fly step driven
    by hand over the same batches (``make_batches`` order), the same seeded
    weights and the same generator: the same priors after a few steps."""
    data, frozen = tiny
    cfg, steps, seed = _tiny_cfg(), 4, 0
    a = runner.train_stage2(cfg, data, frozen, max_steps=steps, seed=seed, device="cpu")
    t_l, t_h = tst2.init_stage2(*tmg.build_transformers(cfg, frozen.model.spec, data.n_classes),
                                torch.Generator().manual_seed(seed), "cpu")
    b = tst2.create_stage2_state(t_l, t_h, runner._adamw(cfg, steps))
    fly, gen = tst2.make_stage2_train_step(frozen), torch.Generator().manual_seed(seed + 1)
    X, y = torch.from_numpy(data.X_train), torch.from_numpy(data.y_train)
    for idx in runner._batch_order(len(X), 8, steps, seed, "cpu"):
        fly(b, X[idx], y[idx], gen)
    assert b.step == a.step == steps
    for pa, pb in zip([*a.t_l.state_dict().values(), *a.t_h.state_dict().values()],
                      [*b.t_l.state_dict().values(), *b.t_h.state_dict().values()]):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("flag", [
    {"bundle_steps": 4}, {"bf16_mu": True}, {"bf16_nu": True}, {"tp": 2},
])
def test_train_stage2_refuses_unported_options(tiny, flag):
    """Step bundles run (a bundle of 4 over 2 steps is all tail:
    ``tests/test_torch_bundle.py`` holds bundles to single steps); one
    process is refused ``tp`` = 2 as JAX refuses it (a world that divides
    runs, ``tests/test_torch_tp.py``); the bfloat16 moments run."""
    data, frozen = tiny
    (name, value), = flag.items()
    if name == "tp":
        with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
            runner.train_stage2(_tiny_cfg(), data, frozen, max_steps=2, device="cpu", **flag)
        return
    state = runner.train_stage2(_tiny_cfg(), data, frozen, max_steps=2, device="cpu", **flag)
    moments = next(iter(state.optimizer.state.values()))
    assert state.step == 2
    if name == "bundle_steps":
        return
    assert moments["exp_avg" if name == "bf16_mu" else "exp_avg_sq"].dtype == torch.bfloat16


def test_train_stage2_refuses_cuda_without_a_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, frozen = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.train_stage2(_tiny_cfg(), data, frozen, max_steps=2)


# ---------------------------------------------------------------------------
# the initialiser


def _stack(state_dicts):
    return {k: torch.stack([sd[k] for sd in state_dicts]) for k in state_dicts[0]}


def _jax_draws(params) -> dict:
    """Stacked flax draws -> {port name: (DRAWS, *port shape)}."""
    return _stack([convert.params_to_state_dict(jax.tree.map(lambda a: a[i], params))
                   for i in range(DRAWS)])


def _fan_in(params) -> dict:
    """Port name -> flax's fan_in (all but the output axis) of each kernel."""
    out = {}
    for path, arr in convert._flatten(params):
        if path[-1] == "kernel":
            out[convert._param(path, arr[0])[0]] = int(np.prod(arr.shape[1:-1]))
    return out


def _leaves_match_flax(ours: dict, ref: dict, fan_in: dict) -> int:
    """Each leaf of >= 256 elements: the std over all draws within 5% of
    JAX's (16 draws a side: the std of a 256-element leaf's pooled std is
    ~1%); kernels inside flax's truncation; biases zero."""
    checked = 0
    for k, r in ref.items():
        if r[0].numel() < 256:
            continue
        o = ours[k]
        assert o.shape == r.shape, k
        assert abs(o.std().item() - r.std().item()) <= 0.05 * r.std().item(), k
        if k in fan_in:  # lecun_normal: a normal truncated to +-2 standard deviations
            assert o.abs().max().item() <= 2.0 / (np.sqrt(fan_in[k]) * TRUNCATED_NORMAL_STD), k
        checked += 1
    for k, v in ours.items():
        if k.endswith(".bias"):
            assert not v.any(), k
    return checked


def test_init_weights_draws_flax_distributions_stage1(j_stage1):
    _, draws, _, _ = j_stage1
    ref = _jax_draws(draws["params"])
    s1 = Stage1Spec.from_config(Config.from_dict(make_cfg()), L, C)
    ours = _stack([dict(init_stage1(s1, torch.Generator().manual_seed(i), "cpu")[0].named_parameters())
                   for i in range(DRAWS)])
    fan_in = _fan_in(draws["params"])
    # a transposed conv's fan_in is its input channels times its taps (torch: weight.shape[0])
    k = next(k for k in fan_in if "ConvTranspose2dTorch" in k)
    assert fan_in[k] == ours[k].shape[1] * ours[k].shape[3] * ours[k].shape[4]
    assert _leaves_match_flax(ours, ref, fan_in) >= 20


def test_init_weights_draws_flax_distributions_stage2():
    jcfg = JConfig.from_dict(make_cfg())
    js1 = JStage1Spec.from_config(jcfg, L, C)
    jt_l, jt_h = jmg.build_transformers(jcfg, js1, N_CLASSES)
    s_l, s_h, y = jnp.zeros((2, 12), jnp.int32), jnp.zeros((2, 24), jnp.int32), jnp.zeros((2, 1), jnp.int32)
    p_l = _draws(jax.jit(lambda k: jt_l.init(k, s_l, None, y, False)["params"]))
    p_h = _draws(jax.jit(lambda k: jt_h.init(k, s_l, s_h, y, False)["params"]))
    priors = [_port_priors(make_cfg(), seed=i) for i in range(DRAWS)]
    n = 0
    for band, params in enumerate((p_l, p_h)):
        ours = _stack([dict(p[band].named_parameters()) for p in priors])
        n += _leaves_match_flax(ours, _jax_draws(params), _fan_in(params))
    assert n >= 10
