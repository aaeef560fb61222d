"""Port parity: the precomputed-x' stage-3 step with dropout on.

The JAX package's ``train/stage3.py::make_stage3_train_step_pre`` (jitted)
and the port's, at the published enhancer widths (dim 8, dim_mults
(1, 2, 4, 8), 4 groups) with the published dropout 0.5, L=64 (the four
levels divide it), B=3, for 12 steps of a 60-step warmup-cosine schedule
(the warmup is 6 steps), in float32 and in the production recipe
(``compute_dtype`` bfloat16, ``fast_norm``, ``bf16_mu``). Random streams
never match across frameworks, so the masks are JAX's: for each step the
JAX step's dropout key is derived as the step derives it
(``fold_in(rng, step)``, then the second half of a split), the enhancer
runs once under ``nn.intercept_methods`` to record each ``nn.Dropout``'s
keep mask in call order, and the port's ``fidelity_enhancer.dropout`` is
patched to take them in the same order (``chip_smoke.py::MaskTape``). The
recorded mask is the dropout of a tensor of ones (the draw depends on the
key and the shape alone), so an input that is exactly 0 where it was kept
cannot hide it. Every forward of the port takes exactly as many masks as
JAX's drew.

JAX's step is compiled as written (``jit_as_written``: XLA may not skip
the bfloat16 roundings the program asks for); under bfloat16 JAX's default
jit lies farther from that than the port does (module docstring of
``tests/test_torch_precision_paths.py``).

Tolerances:
  - float32: losses within 1e-5 relative at every step; every leaf after
    the run within 1e-4 + 1e-4 relative of JAX's. No leaf needs Adam's
    sign-step cap (2·Σlr).
  - the production recipe: the tolerance of
    ``tests/test_torch_precision_paths.py::test_stage3_bf16_steps_match_jax``:
    losses within 2e-2 relative at every step, the step-1 gradient of each
    leaf within 5e-2 of its scale plus twice JAX's bfloat16-vs-float32 gap
    on that leaf (against the port's float32 gradient under the same masks,
    JAX's within 2e-6 here), and the median leaf within 5e-2. The port
    failed the median while its convs rounded conv and bias together,
    where flax adds the bias to the rounded bfloat16 output
    (``layers._CastAtCall``): 0.080 then, 0.025 since (worst leaf 0.12;
    JAX's own bfloat16-vs-float32 median 0.14).
"""
import functools

import numpy as np
import pytest
import torch
from test_torch_parallel import _random_tree

from chip_smoke import MaskTape

import jax
import jax.numpy as jnp
from flax import linen as nn

from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

C, L, B = 4, 64, 3
DIM, MULTS, GROUPS, RATE = 8, (1, 2, 4, 8), 4, 0.5
LR, MAX_STEPS, STEPS = 1e-3, 60, 12
# UnetBlocks of the published U-Net, each followed by a dropout: 4 levels x 2
# ResnetBlocks down, 2 in the middle, 4 x 2 up, 1 final; 2 UnetBlocks each
N_DROPOUTS = 2 * (4 * 2 + 2 + 4 * 2 + 1)
RECIPES = {"float32": dict(compute_dtype="float32", fast_norm=False, mu_dtype=None),
           "production": dict(compute_dtype="bfloat16", fast_norm=True, mu_dtype="bfloat16")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dropout_key(rng, step: int):
    """The dropout key ``make_stage3_train_step_pre`` derives from ``rng`` at
    ``state.step`` == ``step``."""
    return jax.random.split(jax.random.fold_in(rng, step))[1]


def mask_collector(fe):
    """-> jitted ``f(params, xprime, r_drop)``: the keep masks of every
    ``nn.Dropout`` of ``fe.apply(..., train=True, rngs={"dropout": r_drop})``
    in call order, channels-last."""

    def collect(params, xprime, r_drop):
        masks = []

        def record(f, args, kwargs, context):
            if not (isinstance(context.module, nn.Dropout) and context.method_name == "__call__"):
                return f(*args, **kwargs)
            x = args[0]
            kept = f(jnp.ones(x.shape, jnp.float32), *args[1:], **kwargs) != 0
            masks.append(kept)
            return jnp.where(kept, x / (1.0 - context.module.rate), jnp.zeros_like(x))

        with nn.intercept_methods(record):
            fe.apply({"params": params}, xprime, True, rngs={"dropout": r_drop})
        return masks

    return jax.jit(collect)


def to_port_masks(masks):
    """JAX's channels-last (B, L, C) masks -> the port's (B, C, L) bool tensors."""
    return [torch.from_numpy(np.array(m)).transpose(1, 2).contiguous() for m in masks]


def _j_fe(compute_dtype="float32", fast_norm=False):
    return jfe.FidelityEnhancer(input_length=L, in_channels=C, dim=DIM, dim_mults=MULTS,
                                resnet_block_groups=GROUPS, dropout=RATE,
                                compute_dtype=compute_dtype, fast_norm=fast_norm)


def _port_fe(params, compute_dtype="float32", fast_norm=False):
    fe = tfe.FidelityEnhancer(L, C, DIM, MULTS, GROUPS, RATE, compute_dtype, fast_norm)
    fe.load_state_dict(convert.fe_from_jax(params))
    return fe


@pytest.fixture(scope="module")
def inputs():
    """The initial parameters, the (x, x') batches, and JAX's masks of each
    step (they depend on the key and the shapes alone, so both recipes share
    them)."""
    fe = _j_fe()
    shapes = jax.eval_shape(lambda: fe.init({"params": jax.random.key(0)},
                                            jnp.zeros((B, C, L)), False))["params"]
    params = _random_tree(shapes, np.random.default_rng(0))
    data = np.random.default_rng(9)
    xs, xps = [], []
    for _ in range(STEPS):
        x = data.normal(size=(B, C, L)).astype(np.float32)
        xs.append(x)
        xps.append((0.8 * x + 0.3 * data.normal(size=x.shape)).astype(np.float32))
    rng = jax.random.key(0)
    collect = mask_collector(fe)
    masks = [to_port_masks(collect(params, jnp.asarray(xp), dropout_key(rng, s)))
             for s, xp in enumerate(xps)]
    return dict(params=params, xs=xs, xps=xps, rng=rng, masks=masks)


def _t_tx(mu_dtype):
    return functools.partial(adamw, learning_rate=warmup_cosine_schedule(LR, MAX_STEPS, 0.1),
                             weight_decay=0.01, mu_dtype=mu_dtype)


def _grads(fe):
    return {k: p.grad.clone() for k, p in fe.named_parameters()}


@pytest.fixture(scope="module", params=list(RECIPES))
def run(request, inputs):
    from test_torch_precision_paths import jit_as_written  # imported here: the runner
    # parity imports this module's helpers, and the precision tests' imports take ~10 s

    recipe = RECIPES[request.param]
    dt, fast, mu = recipe["compute_dtype"], recipe["fast_norm"], recipe["mu_dtype"]
    params = inputs["params"]
    tx = j_adamw(j_schedule(LR, MAX_STEPS, 0.1), weight_decay=0.01,
                 mu_dtype=None if mu is None else jnp.bfloat16)
    jstate = jst3.create_stage3_state(params, tx)
    jstep = jit_as_written(jst3.make_stage3_train_step_pre(_j_fe(dt, fast), tx))
    tstate = tst3.create_stage3_state(_port_fe(params, dt, fast),
                                      _t_tx(None if mu is None else torch.bfloat16))
    tstep = tst3.make_stage3_train_step_pre()
    feed = MaskTape(torch)
    mp = pytest.MonkeyPatch()
    mp.setattr(tfe, "dropout", feed)
    res = {"recipe": request.param, "j": [], "t": [], "taken": []}
    try:
        for s in range(STEPS):
            x, xp = inputs["xs"][s], inputs["xps"][s]
            jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(xp), inputs["rng"])
            feed.load(inputs["masks"][s])
            _, tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(xp))
            res["taken"].append((feed.pos, len(feed.masks)))
            res["j"].append({k: float(v) for k, v in jm.items()})
            res["t"].append({k: v.item() for k, v in tm.items()})
            if s == 0:
                res["j_grads"] = convert.fe_from_jax(jax.tree.map(
                    lambda m: np.asarray(m, np.float32) / 0.1, jax.device_get(jstate.opt_state[0].mu)))
                res["t_grads"] = _grads(tstate.fe)
                # the port's float32 gradient under the same masks: the bound's bfloat16 gap
                f32 = tst3.create_stage3_state(_port_fe(params), _t_tx(None))
                feed.load(inputs["masks"][0])
                tstep(f32, torch.from_numpy(x), torch.from_numpy(xp))
                res["t_grads32"] = _grads(f32.fe)
    finally:
        mp.undo()
    res.update(tstate=tstate, j_final=convert.fe_from_jax(jax.device_get(jstate.params)),
               init=convert.fe_from_jax(params))
    return res


def test_each_forward_takes_every_mask_jax_drew(inputs, run):
    assert all(len(m) == N_DROPOUTS for m in inputs["masks"])
    assert run["taken"] == [(N_DROPOUTS, N_DROPOUTS)] * STEPS
    # the masks keep about half and differ from step to step
    kept = np.mean([m.float().mean().item() for m in inputs["masks"][0]])
    assert abs(kept - (1 - RATE)) < 0.02
    assert not torch.equal(inputs["masks"][0][0], inputs["masks"][1][0])


def test_losses_match_jax(run):
    rtol = 1e-5 if run["recipe"] == "float32" else 2e-2
    for t, (j, p) in enumerate(zip(run["j"], run["t"])):
        assert set(p) == set(j) == {"loss", "fidelity_enhancer_loss", "percept_loss"}
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=rtol, atol=0, err_msg=f"step {t + 1} {k}")
    assert run["tstate"].step == STEPS
    assert run["t"][-1]["loss"] < run["t"][0]["loss"]


def test_leaves_match_jax(run):
    """float32: every leaf within 1e-4 + 1e-4 relative after the 12 steps
    (they moved far beyond it). The production recipe: each leaf's step-1
    gradient and the median leaf's to the bfloat16 step test's rule."""
    if run["recipe"] == "float32":
        ours = run["tstate"].fe.state_dict()
        assert set(ours) == set(run["j_final"])
        moved = max(float((v - run["init"][k]).abs().max()) for k, v in run["j_final"].items())
        assert moved > 10 * 1e-4
        for k, v in run["j_final"].items():
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
        return
    from test_torch_precision_paths import _check_grads

    _check_grads(run["t_grads"], run["j_grads"], run["t_grads32"])
