"""The enhancer's init against flax's: the law of its large leaves and its
function at init.

N draws a side: JAX's runner's init at seeds 0..N-1
(``tvqvae_tpu/train/stage3.py::init_stage3``: ``r_p, r_d = split(key(i))``,
one compiled flax init) and the port runner's (``train/stage3.py::init_stage3``
from ``torch.Generator().manual_seed(i)``), at small widths (dim 8,
dim_mults (1, 2), 4 groups, C=4, L=32), in float32 and in the quality
recipe's bfloat16 stream with ``fast_norm`` (JAX's draws are made once:
flax's initialisers do not read the compute dtype; the port's are made by
each recipe's modules while JAX's programs compile in threads). Every
check is a distribution test at a fixed threshold:

  - each leaf of >= 256 elements, its N draws pooled: a two-sample KS test
    of the values at p >= 1e-3, the means within 4 standard errors, a KS
    test of the per-output-channel norms at p >= 1e-3, and the share of
    values beyond 1.5 of flax's pooled std (the truncation's tails) within
    4 standard errors;
  - the function at init on one numpy-drawn (x, x') batch, enhancer dropout
    0: ||FE(x') - x'|| / ||x'||, the std of each level's output (the
    U-Net's blocks, convs and attentions, named as ``utils/convert.py``
    names them: flax's ``capture_intermediates`` against the port's forward
    hooks), the step-1 loss mean |FE(x') - x| and the global gradient norm,
    each a two-sample KS test over the N draws at p >= 1e-3.

The JAX side's bfloat16 step is compiled as written
(``test_torch_precision_paths.py::jit_as_written``). The helpers also serve
``tools/stage3_fidelity_experiment.py --part init_law``, which runs them at
the published widths and the quality run's geometry.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_precision_paths import jit_as_written
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.train.stage3 import init_stage3
from tvqvae_tpu_torch.utils import convert

C, L, B, N = 4, 32, 4, 64
WIDTHS = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4)
RECIPES = {"float32": dict(compute_dtype="float32", fast_norm=False),
           "bfloat16": dict(compute_dtype="bfloat16", fast_norm=True)}
LARGE, P_MIN, Z_MAX, TAIL = 256, 1e-3, 4.0, 1.5
# the U-Net's levels: its blocks, convs and attentions (``_PreNormResidual``
# runs inside ``Unet1D`` in the port, so it has no forward of its own)
LEVELS = ("ResnetBlock1d_", "Conv_", "LinearAttention1d_", "Attention1d_")
LEAF_CHECKS = ("ks", "mean", "channel_norms", "tails")


def jax_enhancer(input_length, widths, recipe):
    """The JAX enhancer with dropout 0."""
    return jfe.FidelityEnhancer(input_length=input_length, in_channels=C, dropout=0.0,
                                **widths, **recipe)


def port_enhancer(input_length, widths, recipe):
    return tfe.FidelityEnhancer(input_length, C, widths["dim"], tuple(widths["dim_mults"]),
                                widths["resnet_block_groups"], 0.0, **recipe)


def jax_init(fe, x0):
    """JAX's runner's init of ``fe`` from one key, jitted."""

    def init(key):
        r_p, r_d = jax.random.split(key)
        return fe.init({"params": r_p, "dropout": r_d}, x0, False)["params"]

    return jax.jit(init)


def jax_draws(init, n, first=0):
    """``init``'s draws at seeds first..first+n-1 as numpy trees."""
    return [jax.device_get(init(jax.random.key(i))) for i in range(first, first + n)]


def port_draws(make_fe, n, first=0):
    """The port runner's inits at seeds first..first+n-1."""
    return [init_stage3(make_fe(), torch.Generator().manual_seed(i), "cpu")
            for i in range(first, first + n)]


def stacked(state_dicts):
    """{leaf: (n, *shape) float64} over the draws (the port's names and layout)."""
    return {k: np.stack([np.asarray(sd[k], np.float64) for sd in state_dicts])
            for k in state_dicts[0]}


def _z(a, b):
    """(mean(a) - mean(b)) over its standard error."""
    return float((a.mean() - b.mean()) / math.sqrt(a.var() / len(a) + b.var() / len(b)))


def _share_z(a, b, threshold):
    """The gap between the shares of |a| and |b| beyond ``threshold``, in
    standard errors of a pooled binomial."""
    pa, pb = (np.abs(a) > threshold).mean(), (np.abs(b) > threshold).mean()
    p = (pa * len(a) + pb * len(b)) / (len(a) + len(b))
    return float((pa - pb) / math.sqrt(p * (1 - p) * (1 / len(a) + 1 / len(b))))


def leaf_law(ours, ref, large=LARGE):
    """Per leaf of >= ``large`` elements (stacked draws, the port's layout:
    output channels first): the KS p of the values and of the per-output-
    channel norms, the means' and the tail shares' gaps in standard errors."""
    from scipy.stats import ks_2samp

    out = {}
    for k, r in ref.items():
        if r[0].size < large:
            continue
        o = ours[k]
        assert o.shape == r.shape, k
        norms = [np.linalg.norm(a.reshape(a.shape[0] * a.shape[1], -1), axis=1) for a in (o, r)]
        o, r = o.ravel(), r.ravel()
        out[k] = {"n": len(o), "ks": float(ks_2samp(o, r).pvalue), "mean": _z(o, r),
                  "channel_norms": float(ks_2samp(*norms).pvalue),
                  "tails": _share_z(o, r, TAIL * r.std())}
    return out


def leaf_passes(row, check):
    return row[check] >= P_MIN if check in ("ks", "channel_norms") else abs(row[check]) <= Z_MAX


def jax_stats_fn(fe, x, xp):
    """params -> ||FE(x') - x'|| / ||x'||, each level's output std, the
    step-1 loss and the global gradient norm (dropout 0), to be compiled."""
    x, xp = jnp.asarray(x), jnp.asarray(xp)

    def stats(params):
        def loss(p):
            out, state = fe.apply({"params": p}, xp, True, capture_intermediates=True,
                                  mutable=["intermediates"])
            return jnp.mean(jnp.abs(out - x)), (out, state["intermediates"]["Unet1D_0"])

        (value, (out, inter)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        res = {f"std:{k}": jnp.std(v["__call__"][0].astype(jnp.float32))
               for k, v in inter.items() if k.startswith(LEVELS)}
        res["rel_change"] = jnp.linalg.norm(out - xp) / jnp.linalg.norm(xp)
        res["loss"] = value
        res["grad_norm"] = jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(grads)))
        return res

    return stats


def jax_function_stats(fn, trees):
    """A compiled ``jax_stats_fn`` over the draws -> {stat: (n,)}."""
    rows = [jax.device_get(fn(jax.tree.map(jnp.asarray, t))) for t in trees]
    return {k: np.array([float(r[k]) for r in rows]) for k in rows[0]}


def port_levels(fe):
    """The names of ``fe``'s levels, the children of ``Unet1D_0`` that flax
    names as it names the U-Net's blocks, convs and attentions."""
    return [name for name, _ in fe.Unet1D_0.named_children() if name.startswith(LEVELS)]


def port_function_stats(fes, x, xp, levels):
    """The port's counterpart of ``jax_function_stats`` over ``levels``,
    each a forward hook on ``Unet1D_0``'s module of that name."""
    x, xp = torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(xp))
    rows = []
    for fe in fes:
        row = {}
        hooks = [fe.Unet1D_0.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: row.__setitem__(
                f"std:{name}", o.detach().float().std(correction=0).item()))
            for name in levels]
        out = fe(xp, train=True)
        for h in hooks:
            h.remove()
        value = (out - x).abs().mean()
        value.backward()
        row["rel_change"] = ((out.detach() - xp).norm() / xp.norm()).item()
        row["loss"] = value.item()
        row["grad_norm"] = math.sqrt(sum(p.grad.double().square().sum().item()
                                         for p in fe.parameters() if p.grad is not None))
        fe.zero_grad(set_to_none=True)
        rows.append(row)
    return {k: np.array([r[k] for r in rows]) for k in rows[0]}


def function_law(ours, ref):
    """{stat: KS p} between the two sides' per-draw values."""
    from scipy.stats import ks_2samp

    assert set(ours) == set(ref), set(ours) ^ set(ref)
    return {k: float(ks_2samp(ours[k], ref[k]).pvalue) for k in ref}


def batch(rng, shape):
    """A numpy-drawn (x, x'): x' a noisy, shrunk x, as a stage-1 round trip."""
    x = rng.normal(size=shape).astype(np.float32)
    return x, (0.8 * x + 0.3 * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """{recipe: (leaf law, function law, the levels compared)}. The port's
    side runs while JAX's init and each recipe's statistics compile in
    threads (XLA compiles outside the GIL; the statistics on a zero tree).
    Flax's initialisers do not read the compute dtype (the parameters are
    float32 in either recipe), so one init serves both."""
    x, xp = batch(np.random.default_rng(0), (B, C, L))
    init = jax_init(jax_enhancer(L, WIDTHS, RECIPES["float32"]), jnp.zeros((2, C, L)))
    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                         jax.eval_shape(init, jax.random.key(0)))
    stats = {r: (jit_as_written if r == "bfloat16" else jax.jit)(
        jax_stats_fn(jax_enhancer(L, WIDTHS, recipe), x, xp)) for r, recipe in RECIPES.items()}
    port = {}
    with ThreadPoolExecutor(len(stats) + 1) as pool:
        runs = [pool.submit(init, jax.random.key(0))]
        runs += [pool.submit(fn, zeros) for fn in stats.values()]
        for r, recipe in RECIPES.items():
            fes = port_draws(lambda: port_enhancer(L, WIDTHS, recipe), N)
            port[r] = (stacked([{k: v.detach() for k, v in fe.state_dict().items()}
                                for fe in fes]),
                       port_function_stats(fes, x, xp, port_levels(fes[0])))
        for run in runs:
            jax.block_until_ready(run.result())
    trees = jax_draws(init, N)
    ref = stacked([convert.fe_from_jax(t) for t in trees])
    out = {}
    for r, (ours, t_stats) in port.items():
        j_stats = jax_function_stats(stats[r], trees)
        levels = [k[4:] for k in j_stats if k.startswith("std:")]
        out[r] = leaf_law(ours, ref), function_law(t_stats, j_stats), levels
    return out


@pytest.mark.parametrize("check", LEAF_CHECKS)
@pytest.mark.parametrize("recipe", RECIPES)
def test_large_leaves_follow_flax(sides, recipe, check):
    law, _, _ = sides[recipe]
    assert len(law) >= 20  # the kernels of >= 256 elements: 26 at these widths
    failed = {k: row for k, row in law.items() if not leaf_passes(row, check)}
    assert not failed, failed


@pytest.mark.parametrize("stat", ["rel_change", "levels", "loss", "grad_norm"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_function_at_init_follows_flax(sides, recipe, stat):
    _, law, levels = sides[recipe]
    if stat == "levels":
        # down path, bottleneck, up path and head: every block, conv and attention
        assert len(levels) >= 20 and any(k.startswith("Attention1d_") for k in levels)
        ps = {k: p for k, p in law.items() if k.startswith("std:")}
    else:
        ps = {stat: law[stat]}
    failed = {k: p for k, p in ps.items() if p < P_MIN}
    assert not failed, failed
