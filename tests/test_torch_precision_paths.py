"""Port parity: the reduced-precision paths, on the CPU at small shapes.

- Three stage-1 steps with the production recipe (``compute_dtype``
  bfloat16, ``fast_bn``, ``bf16_head``, Adam's first moment in bfloat16;
  dropout 0) against the JAX package's jitted step from the same weights on
  the same batches (L=127, C=4, B=4, ``tests/test_torch_train_stage1.py``'s
  model without the optional ResBlocks): losses within 2e-2 relative at
  every step; the step-1 VQ indices equal, asserted before the gradients
  (one flipped argmin moves a gradient by O(1), and bfloat16 encoders flip
  near-ties: JAX's own bfloat16 forward flips 0-2 of the 144 indices against
  its float32 one, the port's 0-3 against JAX's at step 1 on 17 of 24 seeds,
  then more as the codebooks' EMA (decay 0.8) spreads a flip; so the seeds
  are ones without a near-tie, as the float32 test's are). The step-1
  gradient of every leaf that a BatchNorm does not cancel
  (``chip_smoke.py::biases_cancelled_by_batchnorm``; JAX's read from its
  first moment, so rounded to bfloat16) within 5e-2 of the leaf's scale
  plus twice JAX's own bfloat16-vs-float32 gap on that leaf (the float32
  gradient is the port's, equal to JAX's to 1e-4 of scale), the median leaf
  within 5e-2. A flat 5e-2 per leaf does not hold for the reference
  itself: JAX's bfloat16 gradients lie up to 0.37 of scale from the
  float32 ones here (median 0.060), the port's up to 0.31 from JAX's
  bfloat16 ones (``head_h``'s dense; median 0.032). XLA rounds a fused
  elementwise chain of the backward once, eager torch after each op.
- Three stage-3 steps (the enhancer stream in bfloat16 with ``fast_norm``,
  first moment in bfloat16; dim 8, dim_mults (1,), dropout 0) against JAX's
  precomputed-x' step compiled as written (``jit_as_written``), the same
  bounds (measured: worst leaf 0.081 of scale, median 0.0093, JAX's own
  0.050). XLA's default jit may keep a fused bfloat16 chain in float32
  (excess precision): over six draws at dim_mults (1,) and (1, 2, 4, 8)
  it lies 0.018-0.098 (median leaf) from the as-written compile, and the
  port 0.010-0.029 (``tools/stage3_fidelity_experiment.py --part
  rounding``). The port's convs add the bias to the rounded bfloat16
  output, as flax's do; when they rounded conv and bias together, the
  median here was 0.063.
- remat: a step with it equals the step without it exactly on the CPU
  (float32 and bfloat16, dropout 0.3): the same losses, parameters, running
  statistics and dropout masks, every checkpointed block run twice (the
  recompute) and its BatchNorm statistics moved once per step.
- The sampler under bfloat16 (the JAX sampler's defaults: ``fast_bn``,
  ``bf16_head``, ``bf16_istft``): with JAX's draws handed in, its tokens
  equal the float32 sampler's exactly; its decode of them is within 0.06 of
  the JAX bfloat16 decode's scale (``tests/test_bf16_decode.py``'s bound),
  its bfloat16-vs-float32 gap within 0.25x-4x of JAX's, its convs compute
  in bfloat16; the bfloat16 encoder's float32 latents within 0.06 of JAX's,
  and the VQ indices of the same float32 latents exactly equal.
- Each runner resumes a bfloat16-moment run bit-equal from its snapshot,
  the moments stored and restored as bfloat16.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import biases_cancelled_by_batchnorm
from test_torch_checkpoint import K, Recorder, resume_world  # noqa: F401 (a fixture)
from test_torch_precision import BF16_STACK, gap, guard
from test_torch_sampler import CFG as SAMPLER_CFG
from test_torch_sampler import N_CLASSES, jax_decode_noise
from test_torch_stage3 import randomize
from test_torch_train_stage1 import CFG as S1_CFG
from test_torch_train_stage1 import B, C, L, _random_tree
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.vq import CodebookState as JCodebookState
from tvqvae_tpu.models.vq import init_codebook as j_init_codebook
from tvqvae_tpu.models.vq import vq_forward as j_vq_forward
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.train.stage1 import create_stage1_state as j_create_state
from tvqvae_tpu.train.stage1 import make_stage1_train_step as j_make_train_step
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.models import layers as tl
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, encode_tokens
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.models.vq import vq_forward
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage2 as tst2
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

LR, MAX_STEPS, STEPS = 1e-3, 100, 3
RECIPE = dict(compute_dtype="bfloat16", fast_bn=True, bf16_head=True)
# the stage-1 step's model without the optional ResBlocks (each stack keeps
# its one mandatory ResBlock): the JAX step compiles in ~12 s, not ~20
S1_STEP_CFG = {**S1_CFG, "encoder": {**S1_CFG["encoder"], "n_resnet_blocks": 0},
               "decoder": {**S1_CFG["decoder"], "n_resnet_blocks": 0}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_tx():
    return j_adamw(j_schedule(LR, MAX_STEPS, 0.1), weight_decay=0.01, mu_dtype=jnp.bfloat16)


def _t_tx():
    return functools.partial(adamw, learning_rate=warmup_cosine_schedule(LR, MAX_STEPS, 0.1),
                             weight_decay=0.01, mu_dtype=torch.bfloat16)


def jit_as_written(fn):
    """``jax.jit(fn)`` compiled without ``xla_allow_excess_precision``, the
    licence (on by default) that lets XLA keep a fused bfloat16 chain in
    float32 and skip the roundings the program writes out. Compiled at the
    first call; later calls take arguments of the same shapes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                {"xla_allow_excess_precision": False}))
        return compiled[0](*args)

    return call


def _check_grads(t_grads, j_grads, j_grads32, skip=()):
    """Each leaf's gradient within 5e-2 of its scale plus twice JAX's own
    bfloat16-vs-float32 gap on that leaf; the median leaf within 5e-2."""
    gaps = {}
    for name, g in t_grads.items():
        if name not in skip:
            gaps[name], own = gap(g, j_grads[name]), gap(j_grads[name], j_grads32[name])
            assert gaps[name] <= 5e-2 + 2 * own, (name, gaps[name], own)
    assert np.median(list(gaps.values())) <= 5e-2


# ---------------------------------------------------------------------------
# three stage-1 steps with the production recipe, against JAX's


def test_stage1_bf16_steps_match_jax():
    jspec = JStage1Spec.from_config(JConfig.from_dict(S1_STEP_CFG), L, C, **RECIPE)
    model = JStage1Model(jspec)
    vq_l, vq_h = (j_init_codebook(jax.random.key(i), p)
                  for i, p in ((1, jspec.vq_l), (2, jspec.vq_h)))
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((B, C, L)), vq_l, vq_h))
    rng = np.random.default_rng(18)
    tree = {"params": _random_tree(shapes["params"], rng),
            "batch_stats": _random_tree(shapes["batch_stats"], rng), "vq_l": vq_l, "vq_h": vq_h}
    xs = np.random.default_rng(19).normal(size=(STEPS, B, C, L)).astype(np.float32)
    tx = _j_tx()
    jstate = j_create_state(tree["params"], tree["batch_stats"], vq_l, vq_h, tx)
    jstep = jax.jit(j_make_train_step(model, tx))

    states = {}
    for dt in ("float32", "bfloat16"):
        spec = Stage1Spec.from_config(Config.from_dict(S1_STEP_CFG), L, C,
                                      **{**RECIPE, "compute_dtype": dt})
        frozen = FrozenStage1.from_state_dict(spec, convert.stage1_from_jax(tree), "cpu")
        states[dt] = create_stage1_state(frozen.model, frozen.vq_l, frozen.vq_h, _t_tx())
    tstate, tstep = states["bfloat16"], make_stage1_train_step()
    j_loss, t_loss = [], []
    for t in range(STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(xs[t]), jax.random.key(1))
        _, tm = tstep(tstate, torch.from_numpy(xs[t]))
        j_loss.append(float(jm["loss"]))
        t_loss.append(tm["loss"].item())
        if t == 0:
            # step-1 indices equal: every code's EMA count equal (a flip moves two by 0.2)
            for band in ("vq_l", "vq_h"):
                np.testing.assert_allclose(getattr(tstate, band).cluster_size.numpy(),
                                           np.asarray(getattr(jstate, band).cluster_size),
                                           rtol=0, atol=1e-5, err_msg=band)
            # JAX's step-1 gradient: its first moment is 0.1 * grad
            j_grads = convert.params_to_state_dict(jax.tree.map(
                lambda m: m.astype(jnp.float32) / 0.1, jstate.opt_state[0].mu))
            t_grads = {k: p.grad.clone() for k, p in tstate.model.named_parameters()}
            # the float32 gradient, the port's (equal to JAX's to 1e-4 of scale,
            # tests/test_torch_train_stage1.py), for the bound
            f32 = states["float32"]
            tstep(f32, torch.from_numpy(xs[0]))
            grads32 = {k: p.grad.clone() for k, p in f32.model.named_parameters()}
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-2)
    _check_grads(t_grads, j_grads, grads32, skip=biases_cancelled_by_batchnorm(tstate.model))
    mu = tstate.optimizer.state[next(tstate.model.parameters())]["exp_avg"]
    assert mu.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# three stage-3 steps, bfloat16 stream with fast_norm, against JAX's


def test_stage3_bf16_steps_match_jax():
    Ls, kw = 48, dict(dim=8, dim_mults=(1,), resnet_block_groups=4, dropout=0.0)
    fe = tl.init_weights_(tfe.FidelityEnhancer(Ls, C, **kw), torch.Generator().manual_seed(2))
    params = randomize(convert.fe_to_jax(fe), np.random.default_rng(3))
    jfe_mod = jfe.FidelityEnhancer(input_length=Ls, in_channels=C, **kw,
                                   compute_dtype="bfloat16", fast_norm=True)
    tx = _j_tx()
    jstate = jst3.create_stage3_state(params, tx)
    jstep = jit_as_written(jst3.make_stage3_train_step_pre(jfe_mod, tx))
    states = {}
    for dt in ("float32", "bfloat16"):
        port = tfe.FidelityEnhancer(Ls, C, **kw, compute_dtype=dt, fast_norm=True)
        port.load_state_dict(convert.fe_from_jax(params))
        states[dt] = tst3.create_stage3_state(port, _t_tx())
    tstate, tstep = states["bfloat16"], tst3.make_stage3_train_step_pre()
    data = np.random.default_rng(4)
    j_loss, t_loss = [], []
    for t in range(STEPS):
        x = data.normal(size=(B, C, Ls)).astype(np.float32)
        xp = (0.8 * x + 0.3 * data.normal(size=x.shape)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(xp), jax.random.key(0))
        _, tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(xp))
        j_loss.append(float(jm["loss"]))
        t_loss.append(tm["loss"].item())
        if t == 0:
            j_grads = convert.fe_from_jax(jax.tree.map(
                lambda m: np.asarray(m, np.float32) / 0.1, jstate.opt_state[0].mu))
            t_grads = {k: p.grad.clone() for k, p in tstate.fe.named_parameters()}
            # the port's float32 gradient (JAX's to 2e-4, tests/test_torch_stage3.py)
            tstep(states["float32"], torch.from_numpy(x), torch.from_numpy(xp))
            grads32 = {k: p.grad.clone() for k, p in states["float32"].fe.named_parameters()}
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-2)
    _check_grads(t_grads, j_grads, grads32)


# ---------------------------------------------------------------------------
# remat


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(dt, monkeypatch):
    cfg = Config.from_dict({**S1_CFG, "encoder": {**S1_CFG["encoder"], "dropout": 0.3},
                            "decoder": {**S1_CFG["decoder"], "dropout": 0.3}})
    xs = torch.from_numpy(np.random.default_rng(5).normal(size=(2, B, C, L)).astype(np.float32))
    runs, draw = [], tl.dropout_mask
    for remat in (False, True):
        masks = []
        monkeypatch.setattr(tl, "dropout_mask",
                            lambda *a, **k: masks.append(draw(*a, **k)) or masks[-1])
        spec = Stage1Spec.from_config(cfg, L, C, compute_dtype=dt, remat=remat, fast_bn=True)
        model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(0), "cpu")
        before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        state = create_stage1_state(model, vq_l, vq_h, runner._adamw(cfg, 10, bf16_mu=True))
        blocks = [m for m in model.modules() if isinstance(m, (tl.ResBlock2d, tl.EncBlock2d,
                                                                 tl.DecBlock2d))]
        calls = []
        for m in blocks:  # a pre-hook: the recompute stops once it has what the backward needs
            m.register_forward_pre_hook(lambda *_: calls.append(1))
        gen = torch.Generator().manual_seed(1)
        losses = [make_stage1_train_step()(state, x, gen)[1]["loss"].item() for x in xs]
        runs.append(dict(losses=losses, masks=masks, calls=len(calls), blocks=len(blocks),
                         sd=state.model.state_dict(), before=before))
    plain, remat = runs
    assert remat["losses"] == plain["losses"]
    assert len(remat["masks"]) == len(plain["masks"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(remat["masks"], plain["masks"]))
    assert plain["calls"] == 2 * plain["blocks"] and remat["calls"] == 2 * plain["calls"]
    for k, v in plain["sd"].items():
        assert torch.equal(remat["sd"][k], v), k
        if "running" in k:  # moved, and by the plain step's amount: once per step
            assert not torch.equal(v, plain["before"][k]), k


# ---------------------------------------------------------------------------
# the sampler under bfloat16


@pytest.fixture(scope="module")
def samplers():
    cfg = Config.from_dict(SAMPLER_CFG)
    f32 = TrainedModelSampler.from_init(cfg, L, C, N_CLASSES, seed=6, device="cpu", batch_size=4)
    trees = (convert.stage1_to_jax(f32.frozen.model, f32.frozen.vq_l, f32.frozen.vq_h),
             dict(zip(("params", "h_stats"), convert.prior_to_jax(f32.t_l, f32.t_h))))
    bf16 = TrainedModelSampler(cfg, *trees, input_length=L, in_channels=C, n_classes=N_CLASSES,
                               batch_size=4, compute_dtype="bfloat16", fast_bn=True, device="cpu")
    jcfg = JConfig.from_dict(SAMPLER_CFG)
    jmodels = {dt: JStage1Model(JStage1Spec.from_config(jcfg, L, C, compute_dtype=dt, fast_bn=True,
                                                        bf16_head=True, bf16_istft=True))
               for dt in ("float32", "bfloat16")}
    s1 = trees[0]
    jfrozen = jmg.FrozenStage1(s1["params"], s1["batch_stats"], JCodebookState(**s1["vq_l"]),
                               JCodebookState(**s1["vq_h"]))
    return f32, bf16, jmodels, jfrozen, jmg.MaskGITSpec.from_config(jcfg, jmodels["float32"].spec)


def test_sampler_bf16_tokens_equal_and_decode_matches_jax(samplers, monkeypatch):
    f32, bf16, jmodels, jfrozen, jspec = samplers
    assert bf16.s1_spec.compute_dtype == "bfloat16" and bf16.s1_spec.bf16_istft
    tokens, decode = [], tst2.decode_tokens
    monkeypatch.setattr(tst2, "decode_tokens",
                        lambda fr, s, band: tokens.append(s) or decode(fr, s, band))
    seen = []
    for m in bf16.frozen.model.decoder_l.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(lambda mod, i, o: seen.append((i[0].dtype, o.dtype)))
    noise = jax_decode_noise(jax.random.key(7), jspec, 4)
    out = {name: s.sample(4, "conditional", class_index=1, noise=[noise])
           for name, s in (("float32", f32), ("bfloat16", bf16))}
    assert len(tokens) == 4 and all(torch.equal(a, b) for a, b in zip(tokens[:2], tokens[2:]))
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}

    @functools.partial(jax.jit, static_argnums=0)
    def j_decode(dt, s_l, s_h):
        return tuple(jmg.decode_tokens(jmodels[dt], jfrozen, s, band)
                     for s, band in ((s_l, "lf"), (s_h, "hf")))

    ref = {dt: j_decode(dt, *(jnp.asarray(t.numpy()) for t in tokens[:2]))
           for dt in ("float32", "bfloat16")}
    for i in range(2):  # x_l, x_h
        assert gap(out["bfloat16"][i], ref["bfloat16"][i]) <= BF16_STACK, i
        guard(out["bfloat16"][i], out["float32"][i], ref["bfloat16"][i], ref["float32"][i])
    assert np.isfinite(out["bfloat16"][2]).all()


def test_sampler_bf16_encoder_and_vq_indices_match_jax(samplers):
    _, bf16, jmodels, jfrozen, _ = samplers
    x = np.random.default_rng(8).normal(size=(3, C, L)).astype(np.float32)
    for band in ("lf", "hf"):
        variables = {"params": jfrozen.params, "batch_stats": jfrozen.batch_stats}
        z_ref = jax.jit(functools.partial(jmodels["bfloat16"].apply, method="encode"),
                        static_argnums=2)(variables, jnp.asarray(x), band)
        with torch.no_grad():
            z = bf16.frozen.model.encode(torch.from_numpy(x), band)
        assert z.dtype == torch.float32 and gap(z, z_ref) <= BF16_STACK
        # the same float32 latents give the same indices
        jstate = jfrozen.vq_l if band == "lf" else jfrozen.vq_h
        tstate = bf16.frozen.vq_l if band == "lf" else bf16.frozen.vq_h
        p = bf16.s1_spec.vq_l if band == "lf" else bf16.s1_spec.vq_h
        jp = jmodels["bfloat16"].spec.vq_l if band == "lf" else jmodels["bfloat16"].spec.vq_h
        ref = j_vq_forward(jstate, z_ref, jp, train=False).indices
        ours = vq_forward(tstate, torch.from_numpy(np.array(z_ref)), p).indices
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    rec = bf16.reconstruct(x)
    assert rec.shape == x.shape and np.isfinite(rec).all()
    assert encode_tokens(bf16.frozen, torch.from_numpy(x), "hf").shape[1] == bf16.s1_spec.tokens_h


# ---------------------------------------------------------------------------
# resume with bfloat16 moments


PRECISION = {
    "stage1": dict(compute_dtype="bfloat16", remat=True, fast_bn=True, bf16_mu=True,
                   bf16_nu=True, bf16_head=True, bf16_istft=True),
    "stage2": dict(bf16_mu=True, bf16_nu=True),
    "stage3": dict(compute_dtype="bfloat16", fast_norm=True, bf16_mu=True, bf16_nu=True),
}


def _run(stage, world, save_path):
    cfg, data, frozen = world
    rec = Recorder()
    kw = dict(max_steps=2 * K, seed=1, logger=rec, device="cpu", log_interval=1,
              save_path=save_path, **PRECISION[stage])
    if stage == "stage1":
        out = runner.train_stage1(cfg, data, **kw)
    elif stage == "stage2":
        out = runner.train_stage2(cfg, data, frozen, **kw)
    else:
        out = runner.train_stage3(cfg, data, frozen, tau=0.0, **kw)
    return out, rec


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_bf16_moments_resume_bit_equal(stage, resume_world, tmp_path):
    path = str(tmp_path / stage)
    _, straight = _run(stage, resume_world, path)
    snap = load_train_state(path + ".train")
    assert snap["step"] == K
    moments = [s for s in snap["optimizer"]["state"].values()]
    assert moments and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.bfloat16
                           for s in moments)
    final, _ = load_checkpoint(path)
    for suffix in ("", ".meta.json"):
        (tmp_path / f"{stage}{suffix}").unlink()
    state, resumed = _run(stage, resume_world, path)
    assert resumed.train == straight.train[K:]  # losses bit-equal, from step K + 1
    for st in state.optimizer.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
    again, _ = load_checkpoint(path)
    for (k, a), b in zip(convert._flatten(again), (v for _, v in convert._flatten(final))):
        np.testing.assert_array_equal(a, b, err_msg="/".join(k))
