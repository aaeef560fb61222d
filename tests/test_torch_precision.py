"""Port parity: the reduced-precision ops and modules, on the CPU.

The same numpy-seeded inputs and weights (the port's seeded init, exported
with ``utils/convert.module_to_jax``, with random norm statistics, scales
and biases) go through the JAX package's modules and the port's. Tolerances,
each with its reason:

  - float32 with the fast norms on: a BatchNorm to 2e-5 (the JAX package's
    own bound, ``tests/test_fast_bn.py``) and its running statistics to
    1e-6 relative; the fast GroupNorm to 3e-5; the enhancer with
    ``fast_norm`` to 2e-4 of its scale.
  - bfloat16 single ops (a conv block in both BatchNorm modes, the fast
    BatchNorm, the fast GroupNorm, the TimeHead, the iSTFT, the enhancer's
    ``WSConv1d``, ``ChanLayerNorm`` and ``UnetBlock``): port against JAX
    within 2^-7 of the output's scale, two bfloat16 ulps at the largest
    value. XLA rounds a fused chain of elementwise ops once, eager torch
    after each op, so a few ulps apart is the expected gap.
  - the bfloat16 enhancer against JAX's: 0.06 of its scale, the bound the
    JAX package holds its own bfloat16 decode to float32 with
    (``tests/test_bf16_decode.py``).
  - the guard against a port that quietly computes in float32: the port's
    own bfloat16-vs-float32 gap lies between 0.25x and 4x JAX's on the same
    input, and the convs' outputs are bfloat16 (forward hooks).
  - the iSTFT's bfloat16 constants equal numpy's rounding exactly.
  - AdamW with bfloat16 moments against optax over 6 steps of the same
    float32 gradients: the stored moments within one bfloat16 ulp of
    optax's, elementwise (the count that differ is asserted: none), the
    parameters to the float32 AdamW bound of
    ``tests/test_torch_train_stage1.py`` (the update reads the unrounded
    float32 moments in both).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_stage3 import randomize
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.models import layers as jl
from tvqvae_tpu.models import vqvae as jv
from tvqvae_tpu.ops import stft as jstft
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.models import layers as tl
from tvqvae_tpu_torch.models import vqvae as tv
from tvqvae_tpu_torch.ops import stft as tstft
from tvqvae_tpu_torch.train.optim import AdamWStorage, adamw
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

BF16_OP = 2.0 ** -7  # two bfloat16 ulps at the largest value
BF16_STACK = 0.06  # tests/test_bf16_decode.py's bound on JAX's own bf16 decode
GUARD = (0.25, 4.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def gap(a, ref) -> float:
    """max |a - ref| over max |ref|."""
    a, ref = _np(a), _np(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def guard(port_bf16, port_f32, jax_bf16, jax_f32) -> float:
    """The port's bfloat16-vs-float32 gap over JAX's, asserted in GUARD."""
    ratio = gap(port_bf16, port_f32) / gap(jax_bf16, jax_f32)
    assert GUARD[0] <= ratio <= GUARD[1], ratio
    return ratio


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _nchw(y):
    return np.moveaxis(_np(y), -1, 1)


def _conv_dtypes(module):
    """Forward hooks recording every conv's output dtype -> the list they fill."""
    seen = []
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
    return seen


def _randomize_norms(module, seed):
    """Random BatchNorm/GroupNorm scales, biases and running statistics, so
    every leaf matters."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                n = m.weight.numel()
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.normal(size=n)))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.normal(size=n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
    return module


# ---------------------------------------------------------------------------
# the iSTFT


@pytest.mark.parametrize("n_fft", [4, 8, 16])
def test_stft_bf16_constants_round_as_numpy(n_fft):
    like = torch.zeros((), dtype=torch.bfloat16)
    for t_kern, j_kern in ((tstft._synthesis_kernel, jstft._synthesis_kernel),
                           (tstft._analysis_kernel, jstft._analysis_kernel)):
        ours = tstft._const(t_kern(n_fft, True), like)
        ref = j_kern(n_fft, True, jnp.bfloat16)
        assert ours.dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def test_istft_bf16_matches_jax():
    xf = _x((2, 8, 3, 130), 0)
    ref16 = jstft.timefreq_to_time(jnp.asarray(xf, jnp.bfloat16), 4)
    ref32 = jstft.timefreq_to_time(jnp.asarray(xf), 4)
    out16 = tstft.timefreq_to_time(torch.from_numpy(xf).bfloat16(), 4)
    out32 = tstft.timefreq_to_time(torch.from_numpy(xf), 4)
    assert out16.dtype == torch.bfloat16 and ref16.dtype == jnp.bfloat16
    assert gap(out16, ref16) <= BF16_OP
    guard(out16, out32, ref16, ref32)


# ---------------------------------------------------------------------------
# the conv blocks, both BatchNorm modes


def _blocks(kind, dt, fast):
    """(port block, flax block) of ``kind`` at compute dtype ``dt``."""
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dt == "bfloat16" else (torch.float32, jnp.float32)
    if kind == "res":
        return (tl.ResBlock2d(6, 8, False, 0.0, tdt, fast),
                jl.ResBlock2d(8, False, 0.0, dtype=jdt, fast_bn=fast))
    if kind == "enc":
        return (tl.EncBlock2d(6, 8, False, tdt, fast),
                jl.EncBlock2d(8, False, dtype=jdt, fast_bn=fast))
    return (tl.DecBlock2d(6, 8, False, tdt, fast),
            jl.DecBlock2d(8, False, dtype=jdt, fast_bn=fast))


def _run_block(kind, dt, fast, state, x, train):
    """One block in both packages from ``state`` (a port state dict) ->
    (port out, port running stats, JAX out NCHW, JAX running stats, conv
    output dtypes)."""
    tb, jb = _blocks(kind, dt, fast)
    tb.load_state_dict(state)
    params, stats = convert.module_to_jax(tb)
    seen = _conv_dtypes(tb)
    with torch.no_grad():
        out = tb.train(train)(torch.from_numpy(x))
    ref, mut = jb.apply({"params": params, "batch_stats": stats}, _nhwc(x), train,
                        mutable=["batch_stats"])
    bn = tb.BatchNorm_0
    return (out, (bn.running_mean.clone(), bn.running_var.clone()), _nchw(ref),
            (mut["batch_stats"]["BatchNorm_0"]["mean"], mut["batch_stats"]["BatchNorm_0"]["var"]),
            seen)


@pytest.mark.parametrize("fast", [False, True], ids=["sandwich", "fast_bn"])
@pytest.mark.parametrize("kind", ["res", "enc", "dec"])
def test_block_bf16_matches_jax(kind, fast):
    """Train mode (batch statistics, running statistics moved) and eval mode."""
    tb, _ = _blocks(kind, "float32", fast)
    state = _randomize_norms(tl.init_weights_(tb, torch.Generator().manual_seed(0)), 1).state_dict()
    x = _x((2, 6, 3, 16), 2)
    for train in (True, False):
        out16, st16, ref16, jst16, seen = _run_block(kind, "bfloat16", fast, state, x, train)
        out32, _, ref32, _, _ = _run_block(kind, "float32", fast, state, x, train)
        assert out16.dtype == torch.bfloat16 and seen and set(seen) == {torch.bfloat16}
        assert gap(out16, ref16) <= BF16_OP, (train, gap(out16, ref16))
        guard(out16, out32, ref16, ref32)
        for ours, ref in zip(st16, jst16):
            assert gap(ours, ref) <= BF16_OP


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fast_batchnorm_matches_jax(dt):
    """float32: output and gradients to 2e-5, running statistics to 1e-6
    relative; bfloat16: 2^-7 of the scale."""
    F = 6
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    m = _randomize_norms(tl.BatchNorm2d(F, fast=True), 3)
    x = _x((4, F, 3, 10), 4, 2.0) + 0.5
    w_out = _x(x.shape, 5)
    params, stats = convert.module_to_jax(m)
    jbn = jl.BatchNorm(use_running_average=False)

    def j_loss(p, xh):
        y, mut = jbn.apply({"params": p, "batch_stats": stats}, xh, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(np.moveaxis(w_out, 1, -1))), (y, mut)

    (gp, gx), (ref, mut) = jax.grad(j_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(np.moveaxis(x, 1, -1), jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = m.train()(xt)
    (y.float() * torch.from_numpy(w_out)).sum().backward()
    assert y.dtype == tdt
    if dt == "float32":
        np.testing.assert_allclose(_np(y), _nchw(ref), rtol=0, atol=2e-5)
        np.testing.assert_allclose(xt.grad.numpy(), _nchw(gx), rtol=0, atol=2e-5)
        for ours, k in ((m.weight.grad, "scale"), (m.bias.grad, "bias")):
            np.testing.assert_allclose(ours.numpy(), np.asarray(gp[k]), rtol=2e-5, atol=2e-5)
        for ours, k in ((m.running_mean, "mean"), (m.running_var, "var")):
            np.testing.assert_allclose(ours.numpy(), np.asarray(mut["batch_stats"][k]), rtol=1e-6,
                                       atol=1e-7)
    else:
        assert gap(y, _nchw(ref)) <= BF16_OP
        for ours, k in ((m.running_mean, "mean"), (m.running_var, "var")):
            assert gap(ours, mut["batch_stats"][k]) <= BF16_OP
    # eval mode normalises with the running statistics
    with torch.no_grad():
        y_eval = m.eval()(xt)
    ref_eval = jl.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": mut["batch_stats"]},
        jnp.asarray(np.moveaxis(x, 1, -1), jdt))
    assert gap(y_eval, _nchw(ref_eval)) <= (2e-5 if dt == "float32" else BF16_OP)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fast_groupnorm_matches_jax(dt):
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    m = _randomize_norms(tl.GroupNorm(4, 16, fast=True), 6)
    x = _x((3, 16, 29), 7, 1.7)
    params, _ = convert.module_to_jax(m)
    ref = jl.GroupNorm(num_groups=4, epsilon=1e-5).apply({"params": params},
                                                         jnp.asarray(np.moveaxis(x, 1, -1), jdt))
    with torch.no_grad():
        out = m(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    if dt == "float32":
        np.testing.assert_allclose(out.numpy(), _nchw(ref), rtol=3e-5, atol=3e-5)
    else:
        assert gap(out, _nchw(ref)) <= BF16_OP


# ---------------------------------------------------------------------------
# the TimeHead


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_time_head_bf16_matches_jax(in_dtype):
    """Dense in bfloat16, the residual add in float32; the input is float32,
    or bfloat16 as ``bf16_istft`` hands it over."""
    Lh, Lin = 40, 37
    head = tl.init_weights_(tv.TimeHead(Lh), torch.Generator().manual_seed(8))
    with torch.no_grad():
        head.Dense_0.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(9))
    params, _ = convert.module_to_jax(head)
    x = _x((2, 4, Lin), 10)
    outs = {}
    for dt in ("bfloat16", "float32"):
        t = tv.TimeHead(Lh, getattr(torch, dt))
        t.load_state_dict(head.state_dict())
        xin = torch.from_numpy(x).to(getattr(torch, in_dtype))
        with torch.no_grad():
            ours = t(xin)
        ref = jv.TimeHead(Lh, dtype=getattr(jnp, dt)).apply(
            {"params": params}, jnp.asarray(x, getattr(jnp, in_dtype)))
        assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
        outs[dt] = ours, ref
    assert gap(*outs["bfloat16"]) <= BF16_OP
    guard(outs["bfloat16"][0], outs["float32"][0], outs["bfloat16"][1], outs["float32"][1])


# ---------------------------------------------------------------------------
# the enhancer's pieces and the whole enhancer


def test_wsconv_and_chan_layer_norm_bf16_match_jax():
    """``WSConv1d`` standardises with eps 1e-3 under bfloat16; ``ChanLayerNorm``
    keys its eps on its input's dtype and returns that dtype."""
    conv = tl.init_weights_(tfe.WSConv1d(6, 8, compute_dtype=torch.bfloat16),
                            torch.Generator().manual_seed(11))
    params, _ = convert.module_to_jax(conv)
    x = _x((2, 6, 33), 12)
    ref = jfe.WSConv1d(8, dtype=jnp.bfloat16).apply({"params": params},
                                                    jnp.asarray(np.moveaxis(x, 1, -1)))
    with torch.no_grad():
        out = conv(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and gap(out, _nchw(ref)) <= BF16_OP

    norm = tfe.ChanLayerNorm(8)
    with torch.no_grad():
        norm.g.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(13))
    xb = torch.from_numpy(_x((2, 8, 33), 14)).bfloat16()
    ref = jfe.ChanLayerNorm().apply({"params": {"g": jnp.asarray(norm.g.detach().numpy())}},
                                    jnp.asarray(np.moveaxis(_np(xb), 1, -1), jnp.bfloat16))
    with torch.no_grad():
        out = norm(xb)
    assert out.dtype == torch.bfloat16 and gap(out, _nchw(ref)) <= BF16_OP


@pytest.mark.parametrize("fast_norm", [False, True])
def test_unet_block_bf16_matches_jax(fast_norm):
    blk = tfe.UnetBlock(6, 8, 4, 0.0, torch.bfloat16, fast_norm)
    _randomize_norms(tl.init_weights_(blk, torch.Generator().manual_seed(15)), 16)
    params, _ = convert.module_to_jax(blk)
    x = _x((2, 6, 33), 17)
    ref = jfe.UnetBlock(8, 4, 0.0, dtype=jnp.bfloat16, fast_norm=fast_norm).apply(
        {"params": params}, jnp.asarray(np.moveaxis(x, 1, -1)))
    with torch.no_grad():
        out = blk(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and gap(out, _nchw(ref)) <= BF16_OP


FE_KW = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, dropout=0.0)


@pytest.fixture(scope="module")
def fe_params():
    fe = tl.init_weights_(tfe.FidelityEnhancer(48, 4, **FE_KW), torch.Generator().manual_seed(18))
    return randomize(convert.fe_to_jax(fe), np.random.default_rng(19))


def _fe_pair(params, dt, fast_norm, x):
    fe = tfe.FidelityEnhancer(48, 4, **FE_KW, compute_dtype=dt, fast_norm=fast_norm)
    fe.load_state_dict(convert.fe_from_jax(params))
    seen = _conv_dtypes(fe.Unet1D_0)
    with torch.no_grad():
        ours = fe(torch.from_numpy(x))
    jmod = jfe.FidelityEnhancer(48, 4, **FE_KW, compute_dtype=dt, fast_norm=fast_norm)
    ref = jax.jit(lambda p, xj: jmod.apply({"params": p}, xj, False))(params, jnp.asarray(x))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    return ours, ref, seen


def test_enhancer_fast_norm_float32_matches_jax(fe_params):
    x = _x((2, 4, 48), 20)
    ours, ref, _ = _fe_pair(fe_params, "float32", True, x)
    assert gap(ours, ref) <= 2e-4


def test_enhancer_bf16_matches_jax(fe_params):
    """The stream in bfloat16 with the fast GroupNorm, as the sampler runs
    it; attention and the head stay float32."""
    x = _x((2, 4, 48), 21)
    ours16, ref16, seen = _fe_pair(fe_params, "bfloat16", True, x)
    ours32, ref32, _ = _fe_pair(fe_params, "float32", True, x)
    assert gap(ours16, ref16) <= BF16_STACK
    guard(ours16, ours32, ref16, ref32)
    # the stream convs compute in bfloat16; the attentions' and the head's in float32
    assert seen.count(torch.bfloat16) > seen.count(torch.float32) > 0


# ---------------------------------------------------------------------------
# AdamW with bfloat16 moments


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The bfloat16 spacing at each |a| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("nu_bf16", [False, True], ids=["bf16_mu", "bf16_mu_nu"])
def test_adamw_bf16_moments_match_optax(nu_bf16):
    rng = np.random.default_rng(22)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(6)]
    lr = 0.1
    tx = j_adamw(j_schedule(lr, 10, 0.1), weight_decay=0.01, mu_dtype=jnp.bfloat16,
                 nu_dtype=jnp.bfloat16 if nu_bf16 else None)
    jp = [jnp.asarray(a) for a in init]
    js = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, sched = adamw(tp, warmup_cosine_schedule(lr, 10, 0.1), weight_decay=0.01,
                       mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16 if nu_bf16 else None)
    assert isinstance(opt, AdamWStorage)
    differ = 0
    for g in grads:
        upd, js = update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        sched.step()
        adam = js[0]  # optax's ScaleByAdamState
        for i, p in enumerate(tp):
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == (torch.bfloat16 if nu_bf16 else torch.float32)
            for ours, ref in ((st["exp_avg"], adam.mu[i]), (st["exp_avg_sq"], adam.nu[i])):
                if ours.dtype == torch.float32:
                    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
                    continue
                ours, ref = _np(ours), _np(ref)
                assert (np.abs(ours - ref) <= _bf16_ulp(ref)).all()
                differ += int((ours != ref).sum())
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]), rtol=0,
                                       atol=6 * lr * 1e-5)
    assert differ == 0, f"{differ} stored moments differ from optax's by one bfloat16 ulp"
