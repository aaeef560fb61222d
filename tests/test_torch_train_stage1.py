"""Port parity: the stage-1 training path.

The same numpy-seeded inputs go through the JAX package and the port, on
the CPU, at a small stage 1 (L=127, C=4, init_dim 4, hid_dim 16, one
ResBlock, codebooks 8/8, dropout 0). Tolerances, each with its reason:

  - schedule: float64 optax (``enable_x64``) to 1e-7 relative; optax's own
    float32 evaluation within 2 float32 ulps of the peak lr.
  - AdamW: 5 updates to 1e-6 relative in float64; in float32 to 2e-6
    absolute (a float32 ulp or two; stated in the test).
  - train-mode BatchNorm against flax ``nn.BatchNorm(momentum=0.9)``:
    output, running statistics and gradients to 1e-5.
  - train-mode ``vq_forward`` against JAX with ``use_pallas`` True (the
    Pallas kernel in interpret mode) and False: indices exactly; EMA state
    to 1e-5; commitment loss to 1e-6; the straight-through gradient to 1e-6;
    k-means init and dead-code expiry with JAX's row draws handed in.
  - the training step: step-1 gradients (JAX's, read from its first Adam
    moment, 0.1 * grad) per leaf to 1e-4 of the leaf's max |grad|; ten steps with indices equal at every step (asserted before
    anything else: one flipped argmin changes the gradient by O(1); the
    seeds were chosen with no near-tie), losses to 1e-4 relative, and
    parameters, BatchNorm statistics and codebooks to 2e-4 after ten steps.
    Except (hazard of Adam, ``chip_smoke.py::biases_cancelled_by_batchnorm``):
    a bias whose per-channel constant reaches a train-mode BatchNorm through
    shift-invariant linear ops only has a gradient of 0 up to rounding, and
    Adam's m / (sqrt(v) + 1e-8) turns that noise into steps of up to lr.
    Those biases, and the running means of the BatchNorms they feed, may
    differ by up to 2 * sum(lr_t); at step 1 their gradients are bounded by
    1e-5 of their conv weight's gradient. They are every conv right before a
    BatchNorm and, found by this test, the ``Conv_1`` of an encoder
    ResBlock followed by an EncBlock2d.
  - the per-sample eval step to 1e-5 relative.
  - data functions: arrays and batch orders exactly equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from chip_smoke import biases_cancelled_by_batchnorm
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.data import dataset as jdata
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.vq import CodebookState as JCodebookState
from tvqvae_tpu.models.vq import VQParams as JVQParams
from tvqvae_tpu.models.vq import init_codebook as j_init_codebook
from tvqvae_tpu.models.vq import vq_forward as j_vq_forward
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.train.stage1 import create_stage1_state as j_create_state
from tvqvae_tpu.train.stage1 import make_stage1_eval_step as j_make_eval_step
from tvqvae_tpu.train.stage1 import make_stage1_train_step as j_make_train_step
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.models.layers import BatchNorm2d, ResBlock2d, dropout
from tvqvae_tpu_torch.models.maskgit import FrozenStage1
from tvqvae_tpu_torch.models.stage1 import Stage1Spec
from tvqvae_tpu_torch.models.vq import CodebookState, VQParams, vq_forward
from tvqvae_tpu_torch.models.vqvae import VQVAEEncoder
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train.optim import AdamWStorage, adamw
from tvqvae_tpu_torch.train.stage1 import (
    create_stage1_state,
    make_stage1_eval_step,
    make_stage1_train_step,
)
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

L, C, B = 127, 4, 4
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}, "dropout": 0.0},
    "decoder": {"n_resnet_blocks": 1, "dropout": 0.0},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
}
LR, MAX_STEPS, STEPS = 1e-3, 100, 10  # ten steps inside the 10-step warmup
ADAM_NOISE = 2 * sum(warmup_cosine_schedule(LR, MAX_STEPS)(t) for t in range(STEPS))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# schedule and optimizer


@pytest.mark.parametrize("max_steps", [9, 10, 100, 2000])
def test_schedule_matches_optax(max_steps):
    ours = warmup_cosine_schedule(LR, max_steps, 0.1)
    steps = range(max_steps + 3)
    with jax.enable_x64(True):
        ref64 = np.array([float(j_schedule(LR, max_steps, 0.1)(t)) for t in steps])
    ref32 = np.array([float(j_schedule(LR, max_steps, 0.1)(t)) for t in steps])
    got = np.array([ours(t) for t in steps])
    np.testing.assert_allclose(got, ref64, rtol=1e-7, atol=0)
    np.testing.assert_allclose(got, ref32, rtol=0, atol=2 * 2.0 ** -23 * LR)
    # the first step has lr 0, unless int(max_steps * 0.1) == 0 starts the cosine at once
    assert got[0] == (LR if max_steps < 10 else 0.0)
    assert got[-1] == pytest.approx(1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adamw_matches_optax(dtype):
    """In float64, to 1e-6 relative (optax evaluates the schedule in float32
    from its int32 step count even so: lr off by ~2e-8 relative). In
    float32 the port computes optax's bias corrections 1 - b^t in float32
    too (1 - 0.999^t loses 5 bits to cancellation there), so what is left is
    the rounding of the update's ops: to 2e-6 absolute on parameters of up
    to ~3 after 5 updates (measured 9.5e-7, a float32 ulp or two)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    init = [rng.normal(size=s).astype(dtype) for s in shapes]
    grads = [[rng.normal(size=s).astype(dtype) for s in shapes] for _ in range(5)]
    lr = 0.1  # steps of ~0.1 on parameters of ~1: the tolerances see the update
    tol = dict(rtol=1e-6, atol=0) if dtype == "float64" else dict(rtol=0, atol=2e-6)
    with jax.enable_x64(dtype == "float64"):
        tx = j_adamw(j_schedule(lr, 10, 0.1), weight_decay=0.01)
        jp = [jnp.asarray(a) for a in init]
        js = tx.init(jp)
        tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        opt, sched = adamw(tp, warmup_cosine_schedule(lr, 10, 0.1), weight_decay=0.01)
        for t, g in enumerate(grads):
            upd, js = tx.update([jnp.asarray(a) for a in g], js, jp)
            jp = optax.apply_updates(jp, upd)
            for p, a in zip(tp, g):
                p.grad = torch.from_numpy(a)
            opt.step()
            sched.step()
            for p, r, a in zip(tp, jp, init):
                assert np.asarray(r).dtype == dtype and p.dtype == getattr(torch, dtype)
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), **tol)
                if t == 0:  # lr 0: the first step moves nothing
                    np.testing.assert_array_equal(p.detach().numpy(), a)
    # one optimizer: the moments are stored in the parameter's dtype unless a
    # storage dtype is named (bfloat16 moments: tests/test_torch_precision.py)
    assert isinstance(opt, AdamWStorage)
    assert all(opt.state[p][k].dtype == p.dtype for p in tp for k in ("exp_avg", "exp_avg_sq"))
    opt, _ = adamw(tp, 0.1, mu_dtype=torch.bfloat16)
    assert isinstance(opt, AdamWStorage) and opt.mu_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# train-mode layers


def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(1)
    F = 6
    x = (2.0 * rng.normal(size=(4, F, 3, 10)) + 0.5).astype(np.float32)
    w_out = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, F), 0.1 * rng.normal(size=F)
    mean, var = 0.1 * rng.normal(size=F), rng.uniform(0.5, 1.5, F)
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def j_loss(params, xh):
        y, mut = bn.apply({"params": params, "batch_stats": {"mean": f32(mean), "var": f32(var)}},
                          xh, mutable=["batch_stats"])
        return jnp.sum(y * f32(w_out.transpose(0, 2, 3, 1))), (y, mut["batch_stats"])

    xh = f32(x.transpose(0, 2, 3, 1))
    (gp, gx), (y_ref, stats) = jax.grad(j_loss, argnums=(0, 1), has_aux=True)(
        {"scale": f32(scale), "bias": f32(bias)}, xh)

    m = BatchNorm2d(F)
    with torch.no_grad():
        for t, v in ((m.weight, scale), (m.bias, bias), (m.running_mean, mean), (m.running_var, var)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m.train()(xt)
    (y * torch.from_numpy(w_out)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(stats["var"]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(gp["bias"]), **tol)
    # eval mode normalises with the running statistics, as flax does
    y_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": {"scale": f32(scale), "bias": f32(bias)}, "batch_stats": stats}, xh)
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(xt).numpy(),
                                   np.asarray(y_eval).transpose(0, 3, 1, 2), **tol)


def test_dropout_is_inverted_and_reaches_only_resblocks():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    y = dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.7) < 0.03
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(1)))
    # a ResBlock drops out only in train mode, and its masks come from the generator
    block = ResBlock2d(3, 3, False, dropout=0.5)
    xb = torch.randn(2, 3, 3, 8, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ref = ResBlock2d(3, 3, False)
        ref.load_state_dict(block.state_dict())
        h_ref = ref.train()(xb) - xb  # the same block without dropout
        h = block.train()(xb, gen) - xb
        state = gen.get_state()
        block.eval()(xb, gen)
    assert torch.equal(gen.get_state(), state)  # no draws in eval mode
    hit = h.abs() > 1e-6
    torch.testing.assert_close(h[hit], h_ref[hit] / 0.5)
    assert 0 < hit.sum() < h.numel()
    # the JAX stacks give the rate to their ResBlocks only
    enc = VQVAEEncoder(8, 4, 16, 3, 1, dropout=0.3)
    assert {type(b).__name__: getattr(b, "dropout", None) for b in enc} == {
        "EncBlock2d": None, "ResBlock2d": 0.3}


# ---------------------------------------------------------------------------
# train-mode quantizer


def _vq_pair(K, D, seed, kmeans_init=False):
    rng = np.random.default_rng(seed)
    if kmeans_init:
        embed, initted = np.zeros((K, D), np.float32), False
    else:
        embed, initted = rng.normal(size=(K, D)).astype(np.float32), True
    avg = (embed + 0.1 * rng.normal(size=(K, D))).astype(np.float32)
    cs = rng.uniform(0, 3, K).astype(np.float32)
    j = JCodebookState(jnp.asarray(embed), jnp.asarray(avg), jnp.asarray(cs), jnp.asarray(initted))
    t = CodebookState(torch.from_numpy(embed.copy()), torch.from_numpy(avg.copy()),
                      torch.from_numpy(cs.copy()), torch.tensor(initted))
    return j, t


def _assert_state_close(t_state, j_state, tol=1e-5):
    for f in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)),
                                   rtol=tol, atol=tol, err_msg=f)
    assert bool(t_state.initted) == bool(j_state.initted)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vq_train_matches_jax(use_pallas):
    K, D, Bv, N = 8, 16, 3, 40
    rng = np.random.default_rng(2)
    x = rng.normal(size=(Bv, N, D)).astype(np.float32)
    w = rng.normal(size=(Bv, N, D)).astype(np.float32)
    js, ts = _vq_pair(K, D, seed=3)
    jp = JVQParams(K, D, commitment_weight=0.7, use_pallas=use_pallas)
    tp = VQParams(K, D, commitment_weight=0.7)

    def j_loss(xj):
        out = j_vq_forward(js, xj, jp, train=True)
        return jnp.sum(out.quantized * w) + 3.0 * out.loss, out

    gx, jout = jax.grad(j_loss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vq_forward(ts, xt, tp, train=True)
    (torch.sum(out.quantized * torch.from_numpy(w)) + 3.0 * out.loss).backward()

    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(jout.indices))
    _assert_state_close(out.state, jout.state)
    np.testing.assert_allclose(out.commit_loss.item(), float(jout.commit_loss), rtol=1e-6)
    np.testing.assert_allclose(out.loss.item(), float(jout.loss), rtol=1e-6)
    np.testing.assert_allclose(out.perplexity.item(), float(jout.perplexity), rtol=1e-6)
    np.testing.assert_allclose(out.quantized.detach().numpy(), np.asarray(jout.quantized),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6, atol=1e-6)
    # quantize read the pre-update codebook; the new state carries no graph
    torch.testing.assert_close(out.quantized.detach(), ts.embed[out.indices.long()], rtol=0, atol=1e-6)
    assert not any(getattr(out.state, f).requires_grad for f in ("embed", "embed_avg", "cluster_size"))
    # eval mode leaves the codebook and has no commitment loss
    ev = vq_forward(ts, xt, tp)
    assert ev.state is ts and ev.commit_loss.item() == 0.0


@pytest.mark.parametrize("kmeans_init,threshold", [(True, 0), (False, 4), (True, 5)])
def test_vq_kmeans_and_dead_codes_match_jax(kmeans_init, threshold):
    """JAX's row draws (its ``split`` order in ``vq_forward``) handed to the port."""
    K, D, M = 8, 16, 120
    x = np.random.default_rng(4).normal(size=(2, M // 2, D)).astype(np.float32)
    js, ts = _vq_pair(K, D, seed=5, kmeans_init=kmeans_init)
    jp = JVQParams(K, D, threshold_ema_dead_code=threshold, kmeans_init=kmeans_init, kmeans_iters=4)
    tp = VQParams(K, D, threshold_ema_dead_code=threshold, kmeans_init=kmeans_init, kmeans_iters=4)
    key = jax.random.key(6)
    jout = j_vq_forward(js, jnp.asarray(x), jp, train=True, rng=key)
    draws = {}
    if kmeans_init:
        key, krng = jax.random.split(key)
        draws["kmeans_idx"] = torch.from_numpy(np.array(jax.random.randint(krng, (K,), 0, M)))
    if threshold:
        key, erng = jax.random.split(key)
        draws["dead_code_idx"] = torch.from_numpy(np.array(jax.random.randint(erng, (K,), 0, M)))
    out = vq_forward(ts, torch.from_numpy(x).requires_grad_(True), tp, train=True, **draws)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(jout.indices))
    _assert_state_close(out.state, jout.state)
    np.testing.assert_allclose(out.commit_loss.item(), float(jout.commit_loss), rtol=1e-6)
    if threshold:
        assert bool((out.state.cluster_size < threshold).any())  # some codes did expire
    assert not out.state.embed.requires_grad


# ---------------------------------------------------------------------------
# the training step, ten steps, the eval step


def _random_tree(shapes, rng):
    """Random values for a parameter / statistics tree of ``jax.ShapeDtypeStruct``s:
    kernels U(-1/sqrt(fan_in), ..), small biases, BatchNorm scales near 1,
    Snake slopes in [0.2, 0.5], random running statistics."""
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = _random_tree(v, rng)
            continue
        shape = v.shape
        bound = 1.0 / np.sqrt(np.prod(shape[:-1])) if k == "kernel" else 0.0
        draw = {"kernel": lambda: rng.uniform(-bound, bound, shape),
                "var": lambda: rng.uniform(0.5, 1.5, shape),
                "mean": lambda: 0.1 * rng.normal(size=shape),
                "bias": lambda: 0.1 * rng.normal(size=shape),
                "scale": lambda: rng.uniform(0.8, 1.2, shape),
                "a": lambda: rng.uniform(0.2, 0.5, shape)}[k]
        out[k] = jnp.asarray(draw(), jnp.float32)
    return out


def _port_state(spec, tree):
    frozen = FrozenStage1.from_state_dict(spec, convert.stage1_from_jax(tree), "cpu")
    tx = functools.partial(adamw, learning_rate=warmup_cosine_schedule(LR, MAX_STEPS, 0.1),
                           weight_decay=0.01)
    return create_stage1_state(frozen.model, frozen.vq_l, frozen.vq_h, tx)


@pytest.fixture(scope="module")
def run():
    """Ten steps of the JAX package's jitted step and of the port's, from the
    same weights on the same batches; the step-1 gradients of both."""
    jspec = JStage1Spec.from_config(JConfig.from_dict(CFG), L, C)
    model = JStage1Model(jspec)
    vq_l, vq_h = (j_init_codebook(jax.random.key(i), p) for i, p in ((1, jspec.vq_l), (2, jspec.vq_h)))
    # the tree's shapes by tracing flax's init (no compile), then numpy-seeded values
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((B, C, L)), vq_l, vq_h))
    rng = np.random.default_rng(0)
    tree = {"params": _random_tree(shapes["params"], rng),
            "batch_stats": _random_tree(shapes["batch_stats"], rng), "vq_l": vq_l, "vq_h": vq_h}
    xs = np.random.default_rng(1).normal(size=(STEPS, B, C, L)).astype(np.float32)

    tx = j_adamw(j_schedule(LR, MAX_STEPS, 0.1), weight_decay=0.01)
    jstate = j_create_state(tree["params"], tree["batch_stats"], vq_l, vq_h, tx)
    jstep = jax.jit(j_make_train_step(model, tx))

    @jax.jit
    def j_indices(state, x):
        out, _ = model.apply({"params": state.params, "batch_stats": state.batch_stats}, x,
                             state.vq_l, state.vq_h, True, mutable=["batch_stats"])
        return out.vq_l.indices, out.vq_h.indices

    spec = Stage1Spec.from_config(Config.from_dict(CFG), L, C)
    tstate = _port_state(spec, tree)
    captured = []
    tstate.model.register_forward_hook(
        lambda m, i, o: captured.append((o.vq_l.indices.numpy(), o.vq_h.indices.numpy())))
    tstep = make_stage1_train_step()

    res = {"j_idx": [], "t_idx": [], "j_loss": [], "t_loss": []}
    for t in range(STEPS):
        res["j_idx"].append(tuple(np.asarray(i) for i in j_indices(jstate, jnp.asarray(xs[t]))))
        jstate, jm = jstep(jstate, jnp.asarray(xs[t]), jax.random.key(1))
        res["j_loss"].append(float(jm["loss"]))
        if t == 0:  # the step's own jax.grad: its first Adam moment is 0.1 * grad
            mu = jstate.opt_state[0].mu
            res["j_grads"] = convert.params_to_state_dict(jax.tree.map(lambda m: m / 0.1, mu))
        _, tm = tstep(tstate, torch.from_numpy(xs[t]))
        if t == 0:
            res["t_grads"] = {k: p.grad.clone() for k, p in tstate.model.named_parameters()}
        res["t_idx"].append(captured[-1])
        res["t_loss"].append(tm["loss"].item())
    res["j_final"] = convert.stage1_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats,
                                              "vq_l": jstate.vq_l, "vq_h": jstate.vq_h})
    res.update(jmodel=model, jstate=jstate, tstate=tstate, spec=spec,
               cancelled=biases_cancelled_by_batchnorm(tstate.model))
    return res


def test_indices_equal_at_every_step(run):
    for t, (j, p) in enumerate(zip(run["j_idx"], run["t_idx"])):
        for band, a, b in zip(("lf", "hf"), j, p):
            np.testing.assert_array_equal(b, a, err_msg=f"step {t + 1} {band}")


def test_step1_gradients_match_jax(run):
    cancelled = run["cancelled"]
    assert len(cancelled) >= 20
    for name, g in run["t_grads"].items():
        ref = run["j_grads"][name].numpy()
        if name in cancelled:  # zero up to rounding, in both packages
            scale = np.abs(run["j_grads"][cancelled[name]].numpy()).max()
            assert max(np.abs(ref).max(), g.abs().max().item()) <= 1e-5 * scale, name
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_ten_step_losses_match_jax(run):
    test_indices_equal_at_every_step(run)
    np.testing.assert_allclose(run["t_loss"], run["j_loss"], rtol=1e-4)
    assert run["t_loss"][-1] < run["t_loss"][0]


def _final_pairs(run, select):
    tstate = run["tstate"]
    ours = dict(tstate.model.state_dict())
    for band, cb in (("vq_l", tstate.vq_l), ("vq_h", tstate.vq_h)):
        for f in ("embed", "embed_avg", "cluster_size"):
            ours[f"{band}.{f}"] = getattr(cb, f)
    for k, ref in run["j_final"].items():
        if select(k):
            yield k, ours[k].detach().numpy(), ref.numpy()


def test_ten_step_parameters_match_jax(run):
    test_indices_equal_at_every_step(run)
    names = {k for k, _ in run["tstate"].model.named_parameters()}
    n = 0
    for k, ours, ref in _final_pairs(run, lambda k: k in names):
        atol = 2e-4 + (ADAM_NOISE if k in run["cancelled"] else 0.0)
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=atol, err_msg=k)
        n += 1
    assert n == len(names)


def test_ten_step_batchnorm_statistics_match_jax(run):
    """Every BatchNorm follows a conv with a cancelled bias, so each running
    mean gets that bias's bound; the running variances are tight."""
    test_indices_equal_at_every_step(run)
    pairs = list(_final_pairs(run, lambda k: k.endswith(("running_mean", "running_var"))))
    assert len(pairs) == 2 * sum(isinstance(m, BatchNorm2d) for m in run["tstate"].model.modules())
    for k, ours, ref in pairs:
        atol = 2e-4 + (ADAM_NOISE if k.endswith("running_mean") else 0.0)
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=atol, err_msg=k)


def test_ten_step_codebooks_match_jax(run):
    test_indices_equal_at_every_step(run)
    pairs = list(_final_pairs(run, lambda k: k.startswith(("vq_l.", "vq_h.")) and "initted" not in k))
    assert len(pairs) == 6
    for k, ours, ref in pairs:
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("per_sample", [True, False])
def test_eval_step_matches_jax(run, per_sample):
    """The JAX state after ten steps, through both eval steps on the same weights."""
    js = run["jstate"]
    tstate = _port_state(run["spec"], {"params": js.params, "batch_stats": js.batch_stats,
                                       "vq_l": js.vq_l, "vq_h": js.vq_h})
    x = np.random.default_rng(2).normal(size=(3, C, L)).astype(np.float32)
    ref = jax.jit(j_make_eval_step(run["jmodel"], per_sample=per_sample))(js, jnp.asarray(x))
    out = make_stage1_eval_step(per_sample=per_sample)(tstate, torch.from_numpy(x))
    groups = (0, 1) if per_sample else (0,)
    for gi in groups:
        assert set(out[gi]) == set(ref[gi])
        for k, v in out[gi].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[gi][k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    np.testing.assert_array_equal(out[-1].vq_h.indices.numpy(), np.asarray(ref[-1].vq_h.indices))
    assert not tstate.model.training


# ---------------------------------------------------------------------------
# data


def test_synthetic_data_and_splits_match_jax(tmp_path):
    X, y = tdata.make_synthetic_trajectories(n=50, channels=4, length=64, n_classes=4, seed=3)
    jX, jy = jdata.make_synthetic_trajectories(n=50, channels=4, length=64, n_classes=4, seed=3)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    path = str(tmp_path / "d.npz")
    tdata.save_npz(path, X, y)
    for scale in (True, False):
        ours = tdata.get_data(path, ["a", "b", "c", "d"], scale=scale)
        ref = jdata.get_data(path, ["a", "b", "c", "d"], scale=scale)
        for f in ("X_train", "y_train", "X_test", "y_test"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
        assert ours.n_classes == ref.n_classes
        for k, v in ours.scaler.to_state().items():
            np.testing.assert_array_equal(v, ref.scaler.to_state()[k])
    with pytest.raises(ImportError):
        tdata.load_trajectories(str(tmp_path / "d.pkl"), ["a"])


@pytest.mark.parametrize("kw", [
    dict(batch_size=7, shuffle=True, seed=4, repeat=True),
    dict(batch_size=7, shuffle=False, drop_remainder=False),
    dict(batch_size=8, shuffle=True, seed=1, repeat=True, process_index=1, process_count=2),
])
def test_make_batches_matches_jax(kw):
    X = np.arange(30 * 2).reshape(30, 2)
    y = np.arange(30)
    take = 12 if kw.get("repeat") else None
    ours = list(_take(tdata.make_batches(X, y, **kw), take))
    ref = list(_take(jdata.make_batches(X, y, **kw), take))
    assert len(ours) == len(ref) > 0
    for (a, b), (c, d) in zip(ours, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _take(it, n):
    for i, v in enumerate(it):
        if n is not None and i == n:
            return
        yield v


# ---------------------------------------------------------------------------
# the runner, on the CPU


class _Recorder:
    def __init__(self):
        self.train, self.val = [], []

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.train.append(metrics["train/loss"].item())
        if "val/loss" in metrics:
            self.val.append((step, metrics["val/loss"]))


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    X, y = tdata.make_synthetic_trajectories(n=80, channels=C, length=L, seed=7)
    path = str(tmp_path_factory.mktemp("data") / "d.npz")
    tdata.save_npz(path, X, y)
    return tdata.get_data(path, ["latitude", "longitude", "altitude", "timedelta"])


def _tiny_cfg(dropout=0.3):
    return Config.from_dict({**CFG, "encoder": {**CFG["encoder"], "dropout": dropout},
                             "decoder": {**CFG["decoder"], "dropout": dropout},
                             "dataset": {"batch_sizes": {"stage1": 8}},
                             "trainer_params": {"val_check_interval": {"stage1": 10}}})


def test_train_stage1_on_cpu_learns_and_validates(tiny_data):
    """30 steps with dropout 0.3: the loss falls after the 3-step warmup, and
    validation runs at steps 10, 20 and 30 over all 8 test series."""
    rec = _Recorder()
    state = runner.train_stage1(_tiny_cfg(), tiny_data, max_steps=30, device="cpu",
                                logger=rec, log_interval=1)
    assert state.step == 30 and len(rec.train) == 30
    assert np.isfinite(rec.train).all()
    assert np.mean(rec.train[-5:]) < np.mean(rec.train[3:8])
    assert [s for s, _ in rec.val] == [10, 20, 30]
    assert all(np.isfinite(v) for _, v in rec.val)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-6)


@pytest.mark.parametrize("flag", [
    {"bundle_steps": 4}, {"compute_dtype": "bfloat16"}, {"remat": True}, {"fast_bn": True}, {"bf16_mu": True},
    {"bf16_nu": True}, {"bf16_head": True}, {"bf16_istft": True}, {"tp": 2}, {"rng_impl": "rbg"},
])
def test_train_stage1_refuses_unported_options(tiny_data, flag):
    """No option is refused any more. The RNG implementation (JAX's rbg for
    its dropout key) runs and changes nothing: the port's masks come from
    torch's generator either way (``tests/test_torch_rbg_rng.py``); step
    bundles run (a bundle of 4 over 2 steps is all tail:
    ``tests/test_torch_bundle.py`` holds bundles to single steps); tensor
    parallelism runs where the world divides by ``tp``
    (``tests/test_torch_tp.py``) and one process is refused ``tp`` = 2 as
    JAX refuses it; the precision and remat options run, and reach the spec
    or the optimizer."""
    (name, value), = flag.items()
    if name == "tp":
        with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
            runner.train_stage1(_tiny_cfg(), tiny_data, max_steps=2, device="cpu", **flag)
        return
    state = runner.train_stage1(_tiny_cfg(), tiny_data, max_steps=2, device="cpu", **flag)
    assert state.step == 2
    if name == "rng_impl":
        base = runner.train_stage1(_tiny_cfg(), tiny_data, max_steps=2, device="cpu")
        for k, v in base.model.state_dict().items():
            assert torch.equal(v, state.model.state_dict()[k]), k
        with pytest.raises(ValueError, match="none of JAX's"):
            runner.train_stage1(_tiny_cfg(), tiny_data, max_steps=2, device="cpu",
                                rng_impl="philox")
        return
    if name == "bundle_steps":
        return
    moments = next(iter(state.optimizer.state.values()))
    if name in ("bf16_mu", "bf16_nu"):
        key = "exp_avg" if name == "bf16_mu" else "exp_avg_sq"
        assert moments[key].dtype == torch.bfloat16
    else:
        assert getattr(state.model.spec, name) == value


def test_codebook_dict_round_trip():
    _, ts = _vq_pair(8, 16, seed=9)
    back = runner.codebook_from_dict(runner.codebook_to_dict(ts))
    for f in ("embed", "embed_avg", "cluster_size", "initted"):
        assert torch.equal(getattr(back, f), getattr(ts, f))
