"""Port parity: stage 3 (the fidelity enhancer) and its training.

The same numpy-seeded inputs go through the JAX package and the port, on
the CPU, at a small size: FE dim 8, dim_mults (1, 2, 4, 8), 4 groups, C=4,
L=96 and the odd L=101; a small stage 1 (L=101, C=4, hid_dim 16, codebooks
8/8) for the x' round trip; B=3. One jitted flax init gives 16 FE draws (the
initialiser check) and, from the first, the weights of every parity case,
with random GroupNorm/ChanLayerNorm scales and random biases. The FE's
parameters do not depend on ``input_length``, so the same tree also runs at
the published L=4633. Tolerances, each with its reason:

  - the blocks (``WSConv1d``, ``ChanLayerNorm``, ``UnetBlock``,
    ``ResnetBlock1d`` with and without its skip, both attentions) to 1e-5:
    flax's GroupNorm takes the variance as E[x^2] - E[x]^2, the port a
    two-pass variance, equal up to rounding at these sizes;
  - the whole U-Net and the enhancer to 2e-4 (float32 through ~60 layers);
    at the published width (``Config()``, L=4633, B=2) to 5e-4 of the
    output's scale;
  - the x' round trip and the x' sweep to 2e-4 (the stage-1 stacks'
    tolerance), at tau = 0 and at tau > 0 with JAX's Gumbel draws;
  - ten steps of the JAX package's jitted precomputed-x' step, dropout 0:
    losses to 1e-5 relative, every leaf to 1e-4;
  - the port's on-the-fly tau = 0 step against its precomputed step
    (dropout on, same generator seed): exactly equal;
  - ``init_weights_`` against flax's initialisers (16 draws a side): each
    leaf of >= 256 elements, std within 5%; the smaller random leaves
    pooled by kind and shape, a two-sample KS test at p >= 1e-3 and the
    std within 4 standard errors; kernels inside flax's +-2 truncation,
    Snake ``a`` in [0.2, 0.5], norms at 1 and biases at 0.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import reference_stage3_sd
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.stage1 import init_stage1 as j_init_stage1
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.utils import import_reference
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models.layers import TRUNCATED_NORMAL_STD
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

C, L, L_ODD, B = 4, 96, 101, 3
MULTS, GROUPS = (1, 2, 4, 8), 4
LR, MAX_STEPS, STEPS, DRAWS = 1e-3, 100, 10, 16
S1_CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
}
FE_CFG = {"dim": 8, "dim_mults": list(MULTS), "resnet_block_groups": GROUPS}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, rng):
    """Random values where flax's init leaves a constant: biases, norm
    scales (GroupNorm ``scale``, ChanLayerNorm ``g``). -> a numpy tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(dict(v), rng)
        elif k == "bias":
            out[k] = (0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
        elif k in ("scale", "g"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _j_fe(input_length, dropout=0.0):
    return jfe.FidelityEnhancer(input_length=input_length, in_channels=C, dim=8, dim_mults=MULTS,
                                resnet_block_groups=GROUPS, dropout=dropout)


def _port_fe(params, input_length=L, dropout=0.0):
    fe = tfe.FidelityEnhancer(input_length, C, 8, MULTS, GROUPS, dropout)
    fe.load_state_dict(convert.fe_from_jax(params))
    return fe


@pytest.fixture(scope="module")
def fe_draws():
    """DRAWS draws of the JAX enhancer's flax init (one compiled init),
    leaves stacked on a leading axis; and the first, randomised."""
    fe = _j_fe(L)
    x = jnp.zeros((2, C, L))
    init = jax.jit(lambda k: fe.init({"params": k, "dropout": k}, x, False)["params"])
    # numpy trees: converting a tree of device arrays leaf by leaf is slow
    draws = jax.device_get([init(k) for k in jax.random.split(jax.random.key(0), DRAWS)])
    return draws, randomize(draws[0], np.random.default_rng(1))


# ---------------------------------------------------------------------------
# the blocks


def _block_pair(j_module, t_module, x_cl, seed):
    """Init the flax block on channels-last ``x_cl``, randomise it, load it
    into the port's block -> (flax output channel-first, port output)."""
    v = j_module.init(jax.random.key(seed), jnp.asarray(x_cl))
    params = randomize(dict(v["params"]), np.random.default_rng(seed))
    ref = np.asarray(j_module.apply({"params": params}, jnp.asarray(x_cl))).transpose(0, 2, 1)
    t_module.load_state_dict(convert.params_to_state_dict(params))
    with torch.no_grad():
        out = t_module(torch.from_numpy(x_cl.transpose(0, 2, 1).copy())).numpy()
    return ref, out


@pytest.mark.parametrize("case", ["wsconv", "chan_ln", "unet_block", "resnet_same", "resnet_skip",
                                  "linear_attention", "attention"])
def test_blocks_match_flax(case):
    c_in, c_out, n = {"resnet_skip": (16, 8, 37)}.get(case, (8, 8, 37))
    x = 2.0 * _x((B, n, c_in), 3) + 0.5
    j_module, t_module = {
        "wsconv": (jfe.WSConv1d(c_out), tfe.WSConv1d(c_in, c_out)),
        "chan_ln": (jfe.ChanLayerNorm(), tfe.ChanLayerNorm(c_in)),
        "unet_block": (jfe.UnetBlock(c_out, GROUPS), tfe.UnetBlock(c_in, c_out, GROUPS, 0.0)),
        "resnet_same": (jfe.ResnetBlock1d(c_out, GROUPS), tfe.ResnetBlock1d(c_in, c_out, GROUPS, 0.0)),
        "resnet_skip": (jfe.ResnetBlock1d(c_out, GROUPS), tfe.ResnetBlock1d(c_in, c_out, GROUPS, 0.0)),
        "linear_attention": (jfe.LinearAttention1d(), tfe.LinearAttention1d(c_in)),
        "attention": (jfe.Attention1d(), tfe.Attention1d(c_in)),
    }[case]
    ref, out = _block_pair(j_module, t_module, x, seed=len(case))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if case == "resnet_skip":
        assert hasattr(t_module, "Conv_0")
    if case == "resnet_same":
        assert not hasattr(t_module, "Conv_0")


def test_wsconv_standardises_inside_the_graph():
    """The standardised kernel has zero mean and unit biased variance per
    output channel, and the gradient reaches the raw weight through it."""
    m = tfe.WSConv1d(5, 6)
    x = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(0))
    w = m.weight
    var, mean = torch.var_mean(w, dim=(1, 2), correction=0)
    ws = (w - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + 1e-5)
    torch.testing.assert_close(m(x), torch.nn.functional.conv1d(x, ws, m.bias, padding=1))
    m(x).square().sum().backward()
    g = m.weight.grad
    # the standardisation removes each channel's mean: its gradient has none
    # (up to the rounding of 15 float32 additions)
    assert (g.sum(dim=(1, 2)).abs() <= 1e-5 * g.abs().sum(dim=(1, 2))).all()


@pytest.mark.parametrize("length", [L, L_ODD])
def test_unet_matches_flax(fe_draws, length):
    """The whole U-Net (through the enhancer, at its own length): the odd
    length exercises the skip resizes (e.g. 101 -> 50 -> 25 -> 12, back up
    to 96, the last skip resized to it, ``last_up`` to 192, resized to 101)."""
    _, params = fe_draws
    x = _x((B, C, length), 4)
    ref = np.asarray(jax.jit(lambda p, x: _j_fe(length).apply({"params": p}, x, False))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        out = _port_fe(params, length)(torch.from_numpy(x)).numpy()
    assert out.shape == (B, C, length)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_enhancer_resizes_a_wrong_length_input(fe_draws):
    _, params = fe_draws
    x = _x((B, C, 50), 5)
    ref = np.asarray(jax.jit(lambda p, x: _j_fe(L).apply({"params": p}, x, False))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        out = _port_fe(params, L)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (B, C, L)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_published_width_enhancer_matches_flax(fe_draws):
    """``Config()``'s enhancer (dim 8, dim_mults (1, 2, 4, 8), 4 groups) at
    L=4633, C=4, B=2: down 4633 -> 2316 -> 1158 -> 579, full attention over
    579 positions, up to 4632, ``last_up`` 9264, resized back to 4633."""
    _, params = fe_draws
    x = _x((2, C, 4633), 6)
    j = jfe.FidelityEnhancer(input_length=4633, in_channels=C)
    ref = np.asarray(jax.jit(lambda p, x: j.apply({"params": p}, x, False))(params, jnp.asarray(x)))
    fe = tfe.FidelityEnhancer.from_config(Config(), 4633, C)
    fe.load_state_dict(convert.fe_from_jax(params))
    with torch.no_grad():
        out = fe(torch.from_numpy(x)).numpy()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 5e-4, err


def test_unported_enhancer_options_raise():
    """The enhancer's reduced-precision options are ported: the stream's
    convs compute in bfloat16, the GroupNorms take the fast path, and the
    output is float32 (``tests/test_torch_precision.py`` holds both against
    JAX)."""
    fe = tfe.FidelityEnhancer(L, C, compute_dtype="bfloat16", fast_norm=True)
    unet = fe.Unet1D_0
    assert getattr(unet, unet.stem).compute_dtype == torch.bfloat16
    assert all(m.fast for m in fe.modules() if isinstance(m, torch.nn.GroupNorm))
    with torch.no_grad():
        assert fe(torch.from_numpy(_x((2, C, L), 0))).dtype == torch.float32
    with pytest.raises(ValueError, match="floating-point"):
        tfe.FidelityEnhancer(L, C, compute_dtype="int8")


# ---------------------------------------------------------------------------
# the converter against tvqvae_tpu/utils/import_reference.py's layout


def test_converter_names_follow_import_reference_layout(fe_draws):
    """The port's enhancer, a distinct random value per leaf, written in the
    reference Unet1D's naming (``chip_smoke.reference_stage3_sd``), through
    ``import_reference.fe_from_state_dict`` and then ``fe_from_jax``, loads
    strictly into the port with every value in place; the flax tree it
    gives has the JAX init's paths."""
    fe = tfe.FidelityEnhancer(L, C, 8, MULTS, GROUPS, 0.0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for v in fe.state_dict().values():
            v.copy_(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
    expected = {k: v.clone() for k, v in fe.Unet1D_0.state_dict().items()}
    sd = reference_stage3_sd(fe, 0.0)
    sd["fidelity_enhancer.tau"] = torch.from_numpy(sd["fidelity_enhancer.tau"])
    params, tau, inferred = import_reference.fe_from_state_dict(sd)
    assert tau == 0.0 and inferred["dim"] == 8 and inferred["dim_mults"] == list(MULTS)
    out = tfe.FidelityEnhancer(L, C, 8, MULTS, GROUPS, 0.0)
    out.load_state_dict(convert.fe_from_jax(params))
    for key, val in expected.items():
        torch.testing.assert_close(out.Unet1D_0.state_dict()[key], val, rtol=0, atol=0, msg=key)
    jax_paths = {p for p, _ in convert._flatten(fe_draws[0][0])}
    assert {p for p, _ in convert._flatten(params)} == jax_paths


# ---------------------------------------------------------------------------
# dropout and the initialiser


def test_dropout_is_inverted_and_drawn_from_the_generator():
    blk = tfe.UnetBlock(8, 8, GROUPS, 0.5)
    x = torch.randn(4, 8, 64, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    with torch.no_grad():
        ref = blk(x, generator=gen)
        assert torch.equal(gen.get_state(), state)  # eval mode draws nothing
        a = blk(x, True, torch.Generator().manual_seed(2))
        b = blk(x, True, torch.Generator().manual_seed(2))
        c = blk(x, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], ref[kept] / 0.5, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.5) < 0.03  # 2048 draws: 0.011 binomial std
    # the U-Net drops after every UnetBlock in train mode only
    fe = tfe.FidelityEnhancer(L, C, 8, (1, 2), GROUPS, 0.5)
    xs = torch.randn(2, C, L)
    with torch.no_grad():
        assert torch.equal(fe(xs), fe(xs))
        assert not torch.equal(fe(xs, True, torch.Generator().manual_seed(0)), fe(xs))


@pytest.mark.parametrize("leaves", ["large", "small", "per_leaf"])
def test_init_weights_draws_flax_distributions(fe_draws, leaves):
    """``large``: each leaf of >= 256 elements, its 16 draws a side pooled:
    std within 5% of flax's, kernels inside the +-2 truncation. ``small``:
    the random leaves of fewer than 256 elements (kernels and Snake ``a``),
    the 16 draws of every leaf of one kind and shape pooled (>= 512 values
    a side): a two-sample Kolmogorov-Smirnov test against flax's pool at
    p >= 1e-3, the std within 4 standard errors (4/sqrt(n)) of flax's,
    kernels inside the truncation. ``per_leaf``: the same test on each of
    those small leaves alone, its 16 draws a side, so that one leaf with
    another initialiser cannot hide in a pool of its kind. Either way norms
    sit at 1, biases at 0 and Snake ``a`` in [0.2, 0.5]."""
    from scipy.stats import ks_2samp

    draws, _ = fe_draws
    converted = [convert.fe_from_jax(d) for d in draws]
    ref = {k: torch.stack([sd[k] for sd in converted]) for k in converted[0]}
    ours = [tst3.init_stage3(tfe.FidelityEnhancer(L, C, 8, MULTS, GROUPS),
                             torch.Generator().manual_seed(i), "cpu") for i in range(DRAWS)]
    ours = {k: torch.stack([dict(m.named_parameters())[k] for m in ours]) for k in ref}
    fan_in = {convert._param(p, a)[0]: int(np.prod(a.shape[:-1]))
              for p, a in convert._flatten(draws[0]) if p[-1] == "kernel"}
    checked, pools = 0, {}
    for k, r in ref.items():
        o = ours[k].detach()
        assert o.shape == r.shape, k
        if k in fan_in:
            assert o.abs().max().item() <= 2.0 / (np.sqrt(fan_in[k]) * TRUNCATED_NORMAL_STD), k
        if k.endswith((".g", "GroupNorm_0.weight")):
            assert (o == 1).all() and (r == 1).all(), k
        elif k.endswith(".bias"):
            assert not o.any() and not r.any(), k
        elif k.endswith(".a"):
            assert o.min() >= 0.2 and o.max() <= 0.5, k
        if k.endswith((".g", "GroupNorm_0.weight", ".bias")):
            continue
        if leaves == "large" and r[0].numel() >= 256:
            assert abs(o.std().item() - r.std().item()) <= 0.05 * r.std().item(), k
            checked += 1
        elif leaves != "large" and r[0].numel() < 256:
            key = (k.rsplit(".", 1)[-1], tuple(r.shape[1:])) if leaves == "small" else k
            pool = pools.setdefault(key, ([], []))
            pool[0].append(o.flatten())
            pool[1].append(r.flatten())
    for kind, (o, r) in pools.items():
        o, r = torch.cat(o).numpy(), torch.cat(r).numpy()
        assert len(o) >= (512 if leaves == "small" else 16), kind
        assert ks_2samp(o, r).pvalue >= 1e-3, kind
        assert abs(o.std() / r.std() - 1) <= 4 / np.sqrt(len(o)), kind
        checked += 1
    assert checked >= {"large": 40, "small": 9, "per_leaf": 9}[leaves]


# ---------------------------------------------------------------------------
# the x' round trip and the sweep, against JAX


@pytest.fixture(scope="module")
def stage1():
    """A small stage 1 at L=101 (random BatchNorm statistics) in both packages."""
    js1 = JStage1Spec.from_config(JConfig.from_dict(S1_CFG), L_ODD, C)
    model, params, stats, vq_l, vq_h = jax.device_get(
        j_init_stage1(jax.random.key(0), js1, jnp.zeros((2, C, L_ODD))))
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if p[-1].key == "var"
                      else 0.1 * rng.normal(size=s.shape)).astype(np.float32), stats)
    jfrozen = jmg.FrozenStage1(params=params, batch_stats=stats, vq_l=vq_l, vq_h=vq_h)
    tree = {"params": params, "batch_stats": stats, "vq_l": vq_l, "vq_h": vq_h}
    s1 = Stage1Spec.from_config(Config.from_dict(S1_CFG), L_ODD, C)
    frozen = tmg.FrozenStage1.from_state_dict(s1, convert.stage1_from_jax(tree), "cpu")
    return model, jfrozen, frozen


@pytest.mark.parametrize("tau", [0.0, 20.0])
def test_svq_roundtrip_matches_jax(stage1, tau):
    model, jfrozen, frozen = stage1
    x = _x((B, C, L_ODD), 7)
    key = jax.random.key(3)
    ref = np.asarray(jax.jit(lambda x, r: jst3.svq_roundtrip(model, jfrozen, x, tau, r))(
        jnp.asarray(x), key))
    noise = None
    if tau > 0:  # JAX splits the key in two, one per band, and draws categorical = Gumbel argmax
        spec = frozen.model.spec
        noise = tuple(torch.from_numpy(np.array(jax.random.gumbel(r, (B * n, p.codebook_size))))
                      for r, n, p in zip(jax.random.split(key), (spec.tokens_l, spec.tokens_h),
                                         (spec.vq_l, spec.vq_h)))
    out = tst3.svq_roundtrip(frozen, torch.from_numpy(x), tau, noise=noise)
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)
    if tau > 0:  # a stochastic round trip differs from the argmax one
        assert not torch.allclose(out, tst3.svq_roundtrip(frozen, torch.from_numpy(x), 0.0))


def test_precompute_xprime_dataset_matches_jax(stage1):
    model, jfrozen, frozen = stage1
    X = _x((70, C, L_ODD), 8)  # not a multiple of 32: the last batch wraps
    ref = jst3.precompute_xprime_dataset(model, jfrozen, X, batch_size=32)
    out = tst3.precompute_xprime_dataset(frozen, X, batch_size=32)
    assert out.dtype == np.float32 and out.shape == ref.shape == (70, C, L_ODD)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    dev = tst3.precompute_xprime_dataset(frozen, torch.from_numpy(X), keep_on_device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), out)


# ---------------------------------------------------------------------------
# ten steps against the JAX package's jitted precomputed-x' step


def _tx():
    return functools.partial(adamw, learning_rate=warmup_cosine_schedule(LR, MAX_STEPS, 0.1),
                             weight_decay=0.01)


@pytest.fixture(scope="module")
def run(fe_draws):
    _, params = fe_draws
    fe = _j_fe(L)
    tx = j_adamw(j_schedule(LR, MAX_STEPS, 0.1), weight_decay=0.01)
    jstate = jst3.create_stage3_state(params, tx)
    jstep = jax.jit(jst3.make_stage3_train_step_pre(fe, tx))
    tstate = tst3.create_stage3_state(_port_fe(params), _tx())
    tstep = tst3.make_stage3_train_step_pre()
    data = np.random.default_rng(9)
    res = {"j": [], "t": []}
    for _ in range(STEPS):
        x = data.normal(size=(B, C, L)).astype(np.float32)
        xp = (0.8 * x + 0.3 * data.normal(size=x.shape)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(xp), jax.random.key(0))
        _, tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(xp))
        res["j"].append({k: float(v) for k, v in jm.items()})
        res["t"].append({k: v.item() for k, v in tm.items()})
    res.update(tstate=tstate, j_final=convert.fe_from_jax(jax.device_get(jstate.params)))
    return res


def test_ten_precomputed_steps_losses_match_jax(run):
    for t, (j, p) in enumerate(zip(run["j"], run["t"])):
        assert set(p) == set(j) == {"loss", "fidelity_enhancer_loss", "percept_loss"}
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=0, err_msg=f"step {t + 1} {k}")
    assert run["tstate"].step == STEPS
    assert run["t"][-1]["loss"] < run["t"][1]["loss"]


def test_ten_precomputed_steps_parameters_match_jax(run):
    ours = run["tstate"].fe.state_dict()
    assert set(ours) == set(run["j_final"])
    for k, v in run["j_final"].items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the port's own paths


def _small_frozen(length=L):
    s1 = Stage1Spec.from_config(Config.from_dict(S1_CFG), length, C)
    model, vq_l, vq_h = init_stage1(s1, torch.Generator().manual_seed(0), "cpu")
    return tmg.FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)


def test_on_the_fly_step_equals_precomputed_step():
    """Dropout 0.5 on: at tau = 0 the round trip draws nothing, so from the
    same generator seed the two steps make the same update."""
    frozen = _small_frozen()
    fe = tst3.init_stage3(tfe.FidelityEnhancer(L, C, 8, (1, 2), GROUPS, 0.5),
                          torch.Generator().manual_seed(4), "cpu")
    a = tst3.create_stage3_state(fe, _tx())
    b = tst3.create_stage3_state(copy.deepcopy(fe), _tx())
    X = torch.from_numpy(_x((24, C, L), 10))
    xprime = tst3.precompute_xprime_dataset(frozen, X, keep_on_device=True)
    fly, pre = tst3.make_stage3_train_step(frozen), tst3.make_stage3_train_step_pre()
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for t in range(3):
        idx = torch.arange(8 * t, 8 * t + 8)
        _, ma = fly(a, X[idx], ga)
        _, mb = pre(b, X[idx], xprime[idx], gb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma), t
    for pa, pb in zip(a.fe.state_dict().values(), b.fe.state_dict().values()):
        assert torch.equal(pa, pb)


def test_percept_loss_is_refused():
    """A perceptual weight needs its net: the steps refuse a weight > 0
    without ``percept_fn`` (JAX's drop the term silently), and the runner,
    whose JAX counterpart passes no ``percept_fn``, refuses the weight."""
    with pytest.raises(ValueError, match="percept_fn"):
        tst3.make_stage3_train_step_pre(percept_loss_weight=0.1)
    with pytest.raises(ValueError, match="percept_fn"):
        tst3.make_stage3_train_step(_small_frozen(), percept_loss_weight=0.1)
    X, y = tdata.make_synthetic_trajectories(n=16, channels=C, length=L, seed=7)
    data = tdata.DatasetSplits(X[:12], y[:12, None], X[12:], y[12:, None], None, 3)
    cfg = Config.from_dict({**S1_CFG, "fidelity_enhancer": {**FE_CFG, "percept_loss_weight": 0.1}})
    with pytest.raises(NotImplementedError, match="percept_fn"):
        runner.train_stage3(cfg, data, _small_frozen(), max_steps=2, device="cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    X, y = tdata.make_synthetic_trajectories(n=80, channels=C, length=L, seed=7)
    path = str(tmp_path_factory.mktemp("data") / "d.npz")
    tdata.save_npz(path, X, y)
    data = tdata.get_data(path, ["latitude", "longitude", "altitude", "timedelta"])
    return data, _small_frozen(data.input_length)


def _tiny_cfg(dropout=0.5):
    return Config.from_dict({**S1_CFG, "fidelity_enhancer": {**FE_CFG, "dim_mults": [1, 2],
                                                             "dropout": dropout},
                             "dataset": {"batch_sizes": {"stage3": 8}},
                             "trainer_params": {"val_check_interval": {"stage3": 20}}})


class _Recorder:
    def __init__(self):
        self.loss = []

    def log_metrics(self, metrics, step):
        self.loss.append(metrics["train/loss"].item())


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_train_stage3_on_cpu_learns(tiny, capsys, tau):
    data, frozen = tiny
    rec = _Recorder()
    state = runner.train_stage3(_tiny_cfg(), data, frozen, max_steps=40, tau=tau, device="cpu",
                                logger=rec, log_interval=1)
    assert state.step == 40 and len(rec.loss) == 40
    assert np.isfinite(rec.loss).all() and np.mean(rec.loss[-10:]) < np.mean(rec.loss[:10])
    out = capsys.readouterr().out
    assert ("[stage3] precomputed 72 x' rows in" in out) == (tau == 0.0)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-6)


def test_train_stage3_paths_agree(tiny):
    """The runner's precomputed-x' steps and the on-the-fly step driven by
    hand over the same batches (``make_batches`` order), the same seeded
    weights and the same generator: the same enhancer after a few steps,
    up to x' being decoded in the sweep's batches of 32 rather than in a
    step's 8."""
    data, frozen = tiny
    cfg, steps, seed = _tiny_cfg(), 4, 0
    a = runner.train_stage3(cfg, data, frozen, max_steps=steps, seed=seed, device="cpu")
    fe = tst3.init_stage3(tfe.FidelityEnhancer.from_config(cfg, data.input_length, data.in_channels),
                          torch.Generator().manual_seed(seed), "cpu")
    b = tst3.create_stage3_state(fe, runner._adamw(cfg, steps))
    fly, gen = tst3.make_stage3_train_step(frozen), torch.Generator().manual_seed(seed + 1)
    X = torch.from_numpy(data.X_train)
    for idx in runner._batch_order(len(X), 8, steps, seed, "cpu"):
        fly(b, X[idx], gen)
    assert a.step == b.step == steps
    for (k, pa), pb in zip(a.fe.state_dict().items(), b.fe.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("flag", [
    {"bundle_steps": 4}, {"compute_dtype": "bfloat16"}, {"fast_norm": True}, {"bf16_mu": True},
    {"bf16_nu": True}, {"tp": 2},
])
def test_train_stage3_refuses_unported_options(tiny, flag):
    """Step bundles run (a bundle of 4 over 2 steps is all tail:
    ``tests/test_torch_bundle.py`` holds bundles to single steps); one
    process is refused ``tp`` = 2 as JAX refuses it (a world that divides
    runs, ``tests/test_torch_tp.py``); the precision options run, and reach
    the enhancer or its optimizer."""
    data, frozen = tiny
    (name, value), = flag.items()
    if name == "tp":
        with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
            runner.train_stage3(_tiny_cfg(), data, frozen, max_steps=2, device="cpu", **flag)
        return
    state = runner.train_stage3(_tiny_cfg(), data, frozen, max_steps=2, device="cpu", **flag)
    assert state.step == 2
    if name == "bundle_steps":
        return
    unet, opt = state.fe.Unet1D_0, state.optimizer
    moments = next(iter(opt.state.values()))
    got = {"compute_dtype": getattr(unet, unet.stem).compute_dtype == torch.bfloat16,
           "fast_norm": all(m.fast for m in unet.modules() if isinstance(m, torch.nn.GroupNorm)),
           "bf16_mu": moments["exp_avg"].dtype == torch.bfloat16,
           "bf16_nu": moments["exp_avg_sq"].dtype == torch.bfloat16}
    assert got[name] and sum(got.values()) == 1


def test_train_stage3_refuses_cuda_without_a_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, frozen = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.train_stage3(_tiny_cfg(), data, frozen, max_steps=2)
