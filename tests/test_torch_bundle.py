"""Bundled training (``--bundle_steps``, ``train/multistep.py``) against the
JAX package, on the CPU, at small shapes.

On the CPU a bundle is the same steps in a loop (the card replays a CUDA
graph of the step: ``chip_smoke.py``'s ``[bundle]``). Tolerances, each with
its reason:

  - (a) the loop: the port's ``runner._loop`` and JAX's, driven by
    recording ``train_once``/``train_tail``/``eval_once``/``snapshot``, over
    (max_steps, bundle, start_step, log and validation intervals), a
    trimmed run without a tail among them: the steps trained (in bundles
    and singly), logged, validated and snapshotted, and the logged values,
    exactly. The port does not snapshot the last step of a trimmed run (the
    stage checkpoint follows it), where the JAX runner's lambda, which
    compares against the untrimmed budget, would.
  - (b) the optimizer, 12 steps of JAX's ``warmup_cosine_schedule``: against
    ``optax.adamw`` under the optimizer tests' tolerances (float32: 2e-6
    absolute, ``tests/test_torch_train_stage1.py``; bfloat16 first moment:
    each stored moment within one bfloat16 ulp of optax's and the
    parameters within 6 lr 1e-5, ``tests/test_torch_precision.py``); and
    against the eager step before the step count moved to the device
    (``_host_step``: the count, the learning rate and the bias corrections
    as host scalars), bit for bit, with its table grown during the run or
    reserved, and through a ``state_dict`` round trip.
  - (c) the runners, bundle 3 over 6 steps, against the JAX runners at
    ``bundle_steps=3``: stage 1 on JAX's host path (``data_on_device=False``:
    ``make_batches``' order, as the port's), dropout 0; stage 2 on
    precomputed tokens, dropouts and ``p_unconditional`` 0, JAX's batch
    order (``device_epoch_indices``) and masking draws handed to the port.
    The weights cross through ``utils/convert.py`` from one numpy draw in
    JAX's trees. ``tests/test_torch_stage3_runner.py``'s tolerances: every
    leaf within 1e-4 + 1e-4 relative; the biases a BatchNorm cancels and
    the running means they feed within Adam's sign-step noise,
    2 sum(lr_t) (``tests/test_torch_train_stage1.py``); the logged bundle
    means within 1e-4 relative (the ten-step tests' losses).
  - (d) the port alone: bundle 3 over 8 steps equals bundle 1 bit for bit
    (states, snapshots with the generator, logged means, which are the
    single steps' summed in order and divided by 3), and so does the
    bundled run resumed from its step-6 snapshot, for stage 1 on the device
    gather and on the host feed, stage 2 on tokens and stage 3 on x', each
    with dropout on.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from test_torch_parallel import _random_tree
from test_torch_train_stage2 import _jax_mask_draws, randomize

from chip_smoke import biases_cancelled_by_batchnorm

import jax
import jax.numpy as jnp
import optax

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.data.dataset import DatasetSplits as JSplits
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.vq import init_codebook as j_init_codebook
from tvqvae_tpu.train import runner as jrunner
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.utils import checkpoint as jckpt
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits
from tvqvae_tpu_torch.models.maskgit import FrozenStage1
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.train import optim, runner
from tvqvae_tpu_torch.train import stage2 as tst2
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

C, L, N, N_TEST, SEED = 4, 127, 40, 8, 0
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}, "dropout": 0.0},
    "decoder": {"n_resnet_blocks": 1, "dropout": 0.0},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "MaskGIT": {
        "T": {"lf": 3, "hf": 1},
        "prior_model_l": {"hidden_dim": 16, "n_layers": 2, "heads": 2, "ff_mult": 1,
                          "use_rmsnorm": True, "p_unconditional": 0.0, "model_dropout": 0.0,
                          "emb_dropout": 0.0},
        "prior_model_h": {"hidden_dim": 8, "n_layers": 1, "heads": 1, "ff_mult": 1,
                          "use_rmsnorm": True, "p_unconditional": 0.0, "model_dropout": 0.0,
                          "emb_dropout": 0.0},
    },
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4},
    "dataset": {"batch_sizes": {"stage1": 8, "stage2": 8, "stage3": 8}},
    "exp_params": {"lr": 1e-3, "linear_warmup_rate": 0.1},
    "trainer_params": {"val_check_interval": {"stage1": 1000, "stage2": 1000,
                                              "stage3": 1000}},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the loop


class _Log:
    """The logged train metrics by step, as logged (device tensors from the
    port, floats from JAX), and the validations by step."""

    def __init__(self):
        self.train, self.val = {}, {}

    def log_metrics(self, metrics, step):
        train = {k: v for k, v in metrics.items() if k.startswith("train/")}
        if train:
            self.train[step] = train
        else:
            self.val[step] = metrics

    def close(self):
        pass


def _floats(log):
    return {s: {k: float(v) for k, v in m.items()} for s, m in log.train.items()}


def _drive(loop, max_steps, bundle, start, log_every, val_every, tail, tensor):
    """``loop`` (either package's ``_loop``) with recording callables; ->
    what they saw."""
    seen = {"bundles": [], "singles": [], "evals": [], "snapshots": []}
    log = _Log()
    value = torch.tensor if tensor else np.float32

    def train_once(step):
        seen["bundles"].append(step)
        return {"loss": value(step - (bundle - 1) / 2)}  # the bundle's mean step

    def train_tail(step):
        seen["singles"].append(step)
        return {"loss": value(step)}

    def eval_once(step):
        seen["evals"].append(step)
        return {"loss": 2.0 * step}

    loop("loop", max_steps, train_once, eval_once, log, val_every, log_interval=log_every,
         start_step=start, snapshot=seen["snapshots"].append, stride=bundle,
         train_tail=train_tail if tail else None)
    return seen, log


# (max_steps, bundle, start_step, log interval, validation interval, with a tail)
LOOP_CASES = [
    (23, 10, 0, 1, 20, True),  # two bundles and a 3-step tail
    (23, 10, 20, 1, 20, True),  # a resume with fewer steps left than a bundle
    (30, 10, 0, 100, 10, True),  # no remainder
    (25, 4, 3, 5, 7, True),  # boundaries crossed inside bundles
    (25, 4, 3, 5, 7, False),  # the remainder trimmed
    (12, 1, 0, 3, 5, True),  # one step a dispatch
    (7, 10, 0, 2, 3, True),  # all tail
    (103, 10, 0, 100, 50, False),  # trimmed to 100
]


@pytest.mark.parametrize("case", LOOP_CASES, ids=[str(c) for c in LOOP_CASES])
def test_loop_matches_jax(case, capsys):
    max_steps, bundle, start, log_every, val_every, tail = case
    j_seen, j_log = _drive(jrunner._loop, *case, tensor=False)
    seen, log = _drive(runner._loop, *case, tensor=True)
    last = (j_seen["bundles"] + j_seen["singles"])[-1]
    assert last == (max_steps if tail else max_steps - (max_steps - start) % bundle)
    for k in ("bundles", "singles", "evals"):
        assert seen[k] == j_seen[k], k
    assert seen["snapshots"] == [s for s in j_seen["snapshots"] if s < last]
    assert _floats(log) == _floats(j_log)
    assert log.val == j_log.val
    trimmed = "trims max_steps" in capsys.readouterr().out
    assert trimmed == (not tail and (max_steps - start) % bundle != 0)


# ---------------------------------------------------------------------------
# (b) the optimizer


def _host_step(opt, count, lr):
    """The AdamWStorage step as it ran before its count moved to the device:
    the count, the learning rate and the bias corrections host scalars."""
    for group, params, mu_flat, nu_flat in [(opt.param_groups[gi], ps, m, n)
                                            for gi, ps, m, n in opt._chunks]:
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
        d1 = float(torch.tensor(b1, dtype=mu_flat.dtype))
        d2 = float(torch.tensor(b2, dtype=nu_flat.dtype))
        cdt = torch.promote_types(params[0].dtype, torch.float32)
        g = torch.cat([p.grad.reshape(-1) for p in params]).to(cdt)
        mu = g * (1.0 - b1)
        mu += mu_flat.to(cdt) * d1
        nu = g * g
        nu *= 1.0 - b2
        nu += nu_flat.to(cdt) * d2
        c1, c2 = (float(1.0 - torch.tensor(b, dtype=cdt) ** count) for b in (b1, b2))
        u = mu / c1
        u /= (nu / c2).sqrt_() + eps
        u += torch.cat([p.reshape(-1) for p in params]).to(cdt) * wd
        u *= -lr
        u = u.to(params[0].dtype)
        with torch.no_grad():
            torch._foreach_add_(params, [v.view_as(p) for p, v in
                                         zip(params, u.split([p.numel() for p in params]))])
        mu_flat.copy_(mu)
        nu_flat.copy_(nu)


SHAPES = [(3, 4), (5,), (2, 3, 3)]
OPT_STEPS, OPT_LR = 12, 0.1


def _grads(dtype):
    rng = np.random.default_rng(0)
    init = [rng.normal(size=s).astype(dtype) for s in SHAPES]
    return init, [[rng.normal(size=s).astype(dtype) for s in SHAPES] for _ in range(OPT_STEPS)]


@pytest.mark.parametrize("mu", [None, "bfloat16"])
def test_adamw_matches_optax_over_twelve_steps(mu):
    init, grads = _grads("float32")
    mu_dtype = getattr(torch, mu) if mu else None
    tx = j_adamw(j_schedule(OPT_LR, OPT_STEPS, 0.1), weight_decay=0.01,
                 mu_dtype=jnp.bfloat16 if mu else None)
    jp = [jnp.asarray(a) for a in init]
    js = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, sched = optim.adamw(tp, warmup_cosine_schedule(OPT_LR, OPT_STEPS, 0.1),
                             weight_decay=0.01, mu_dtype=mu_dtype)
    for g in grads:
        upd, js = update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        sched.step()
        for i, p in enumerate(tp):
            if mu:
                ours = opt.state[p]["exp_avg"].float().numpy()
                ref = np.asarray(js[0].mu[i].astype(jnp.float32))
                e = np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny)))
                assert (np.abs(ours - ref) <= 2.0 ** (e - 7)).all()
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]), rtol=0,
                                           atol=6 * OPT_LR * 1e-5)
            else:
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]), rtol=0,
                                           atol=2e-6)
    assert opt.count == OPT_STEPS and int(opt._counts[torch.device("cpu")]) == OPT_STEPS


@pytest.mark.parametrize("dtype, mu", [("float32", None), ("float32", "bfloat16"),
                                       ("float64", None), ("bfloat16", None)])
@pytest.mark.parametrize("table", ["grown", "reserved"])
def test_adamw_is_the_host_scalar_step_bit_for_bit(dtype, mu, table, monkeypatch):
    """12 steps against ``_host_step``; the table grows from 4 rows during
    the run, or is reserved for all 12 first; a ``state_dict`` taken at step
    6 and loaded into a fresh optimizer continues bit-equal."""
    monkeypatch.setattr(optim.AdamWStorage, "TABLE", 4)
    init, grads = _grads("float32")
    dt = getattr(torch, dtype)
    mu_dtype = getattr(torch, mu) if mu else None
    schedule = warmup_cosine_schedule(OPT_LR, OPT_STEPS, 0.1)
    ref = [torch.nn.Parameter(torch.from_numpy(a).to(dt)) for a in init]
    ref_opt, _ = optim.adamw(ref, schedule, weight_decay=0.01, mu_dtype=mu_dtype)
    ref_opt._build_chunks()
    tp = [torch.nn.Parameter(torch.from_numpy(a).to(dt)) for a in init]
    opt, sched = optim.adamw(tp, schedule, weight_decay=0.01, mu_dtype=mu_dtype)
    if table == "reserved":
        opt.reserve(OPT_STEPS)
        assert len(opt._tables[(0, torch.promote_types(dt, torch.float32),
                                torch.device("cpu"))]) == OPT_STEPS
    for t, g in enumerate(grads):
        if t == 6:  # a snapshot's round trip
            sd, sched_sd = opt.state_dict(), sched.state_dict()
            tp = [torch.nn.Parameter(p.detach().clone()) for p in tp]
            opt, sched = optim.adamw(tp, schedule, weight_decay=0.01, mu_dtype=mu_dtype)
            opt.load_state_dict(sd)
            sched.load_state_dict(sched_sd)
            assert opt.count == 6 and all(float(s["step"]) == 6 for s in sd["state"].values())
        for p, q, a in zip(tp, ref, g):
            p.grad = torch.from_numpy(a).to(dt)
            q.grad = p.grad.clone()
        _host_step(ref_opt, t + 1, 1.0 * schedule(t))  # LambdaLR's base lr times the factor
        opt.step()
        sched.step()
        for p, q in zip(tp, ref):
            assert torch.equal(p, q)
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][k], ref_opt.state[q][k])
    assert opt.count == OPT_STEPS
    assert opt.state_dict()["state"][0]["step"] == OPT_STEPS


# ---------------------------------------------------------------------------
# (c) the runners against JAX's at bundle_steps=3

BUNDLE, STEPS = 3, 6


def _series():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, L, dtype=np.float32)
    X = (np.sin(2 * np.pi * (t[None, None] * rng.uniform(0.5, 2, (N + N_TEST, C, 1))
                             + rng.uniform(0, 1, (N + N_TEST, C, 1))))
         + 0.1 * rng.normal(size=(N + N_TEST, C, L))).astype(np.float32)
    y = rng.integers(0, 3, (N + N_TEST, 1))
    return X, y


@pytest.fixture(scope="module")
def stage1_tree():
    """A small stage 1 in the JAX package's tree: its codebook init, random
    weights and BatchNorm statistics (shapes traced, not compiled)."""
    js1 = JStage1Spec.from_config(JConfig.from_dict(CFG), L, C)
    vq_l, vq_h = (j_init_codebook(jax.random.key(i), p) for i, p in ((1, js1.vq_l), (2, js1.vq_h)))
    shapes = jax.eval_shape(lambda: JStage1Model(js1).init(jax.random.key(0), jnp.zeros((2, C, L)),
                                                           vq_l, vq_h))
    rng = np.random.default_rng(2)
    params, stats = (jax.device_get(_random_tree(shapes[k], rng))
                     for k in ("params", "batch_stats"))
    return {"params": params, "batch_stats": stats, "vq_l": jrunner.codebook_to_dict(vq_l),
            "vq_h": jrunner.codebook_to_dict(vq_h)}


@pytest.fixture(scope="module")
def stage1_runs(stage1_tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bundle_stage1")
    X, y = _series()
    jcfg, cfg = JConfig.from_dict(CFG), Config.from_dict(CFG)

    def j_init(rng, spec, x0):
        model = JStage1Model(spec)
        vq = [jrunner.codebook_from_dict(stage1_tree[b]) for b in ("vq_l", "vq_h")]
        return model, stage1_tree["params"], stage1_tree["batch_stats"], *vq

    j_log, mp = _Log(), pytest.MonkeyPatch()
    mp.setattr(jrunner, "init_stage1", j_init)
    try:
        jrunner.train_stage1(jcfg, JSplits(X[:N], y[:N], X[N:], y[N:], None, 3),
                             str(tmp / "jax"), logger=j_log, max_steps=STEPS, seed=SEED,
                             bundle_steps=BUNDLE, data_on_device=False)
    finally:
        mp.undo()

    def init_from_jax(spec, generator, dev):
        frozen = FrozenStage1.from_state_dict(spec, convert.stage1_from_jax(stage1_tree), dev)
        return frozen.model, frozen.vq_l, frozen.vq_h

    log, mp = _Log(), pytest.MonkeyPatch()
    mp.setattr(runner, "init_stage1", init_from_jax)
    try:
        state = runner.train_stage1(cfg, DatasetSplits(X[:N], y[:N], X[N:], y[N:], None, 3),
                                    max_steps=STEPS, seed=SEED, logger=log, device="cpu",
                                    bundle_steps=BUNDLE, data_on_device=False)
    finally:
        mp.undo()
    return dict(j_final=convert.stage1_from_jax(jckpt.load_checkpoint(str(tmp / "jax"))[0]),
                j_log=j_log, state=state, log=log)


def test_bundled_stage1_runner_matches_jax(stage1_runs):
    state = stage1_runs["state"]
    assert state.step == STEPS
    ours = dict(state.model.state_dict())
    for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h)):
        for f in ("embed", "embed_avg", "cluster_size"):
            ours[f"{band}.{f}"] = getattr(cb, f)
    cancelled = biases_cancelled_by_batchnorm(state.model)
    lrs = warmup_cosine_schedule(CFG["exp_params"]["lr"], STEPS, 0.1)
    noise = 2 * sum(lrs(t) for t in range(STEPS))
    n = 0
    for k, ref in stage1_runs["j_final"].items():
        if k.endswith("initted") or k.endswith("num_batches_tracked"):
            continue
        loose = k in cancelled or k.endswith("running_mean")
        np.testing.assert_allclose(ours[k].detach().numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 + (noise if loose else 0.0), err_msg=k)
        n += 1
    assert n > 50


def test_bundled_stage1_runner_logs_jax_bundle_means(stage1_runs):
    ours, ref = _floats(stage1_runs["log"]), _floats(stage1_runs["j_log"])
    assert sorted(ours) == sorted(ref) == [STEPS]  # log_interval 100: the last bundle
    for step in ref:
        assert set(ours[step]) == set(ref[step])
        for k, v in ref[step].items():
            np.testing.assert_allclose(ours[step][k], v, rtol=1e-4, err_msg=f"{step} {k}")


@pytest.fixture(scope="module")
def stage2_runs(stage1_tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bundle_stage2")
    X, y = _series()
    jcfg, cfg = JConfig.from_dict(CFG), Config.from_dict(CFG)
    jdata = JSplits(X[:N], y[:N], X[N:], y[N:], None, 3)
    tree = {**stage1_tree, "step": np.asarray(0)}
    jckpt.save_checkpoint(str(tmp / "stage1"), tree, meta=jrunner.config_meta(jcfg, jdata))
    save_checkpoint(str(tmp / "stage1.npz"), tree, meta=jrunner.config_meta(jcfg, jdata))

    drawn, init = {}, jrunner.init_stage2

    def j_init(rng, t_l, t_h, spec):  # flax's init, the constants randomized
        rs = np.random.default_rng(3)
        drawn["params"], drawn["h_stats"] = (jax.device_get(randomize(jax.device_get(t), rs))
                                             for t in init(rng, t_l, t_h, spec))
        # copies: the runner donates its state
        return jax.tree.map(jnp.asarray, (drawn["params"], drawn["h_stats"]))

    j_log, mp = _Log(), pytest.MonkeyPatch()
    mp.setattr(jrunner, "init_stage2", j_init)
    try:
        jrunner.train_stage2(jcfg, jdata, str(tmp / "stage1"), str(tmp / "jax"), logger=j_log,
                             max_steps=STEPS, seed=SEED, bundle_steps=BUNDLE)
    finally:
        mp.undo()
    j_final = jckpt.load_checkpoint(str(tmp / "jax"))[0]

    # JAX's batch order and masking draws, handed to the port's runner
    bs = CFG["dataset"]["batch_sizes"]["stage2"]
    order = np.stack([np.asarray(jrunner.device_epoch_indices(jax.random.key(SEED + 2), s, N, bs))
                      for s in range(STEPS)])
    frozen, s1, _ = runner.load_stage1_bundle(cfg, str(tmp / "stage1.npz"), device="cpu")
    n_l, n_h = s1.tokens_l, s1.tokens_h
    noise = []
    for s in range(STEPS):
        r_l, r_h, _, _ = jax.random.split(jax.random.fold_in(jax.random.key(SEED + 1), s), 4)
        noise.append({"l": _jax_mask_draws(r_l, bs, n_l), "h": _jax_mask_draws(r_h, bs, n_h)})

    def init_from_jax(t_l, t_h, generator, dev):
        sd_l, sd_h = convert.prior_from_jax(drawn["params"], drawn["h_stats"])
        t_l.load_state_dict(sd_l)
        t_h.load_state_dict(sd_h)
        return t_l.to(dev), t_h.to(dev)

    def step_with_jax_masks(state, s_l, s_h, y, generator=None):
        return tst2.stage2_train_step_tokens(state, s_l, s_h, y, generator,
                                             noise=noise[state.step])

    log, mp = _Log(), pytest.MonkeyPatch()
    mp.setattr(runner, "init_stage2", init_from_jax)
    mp.setattr(runner, "_batch_order",
               lambda n, b, steps, seed, dev: torch.from_numpy(order[:steps]).to(dev))
    mp.setattr(runner, "stage2_train_step_tokens", step_with_jax_masks)
    try:
        state = runner.train_stage2(cfg, DatasetSplits(X[:N], y[:N], X[N:], y[N:], None, 3),
                                    frozen, max_steps=STEPS, seed=SEED, logger=log,
                                    device="cpu", bundle_steps=BUNDLE)
    finally:
        mp.undo()
    sd_l, sd_h = convert.prior_from_jax(j_final["params"], j_final.get("h_stats"))
    return dict(j_final={"l": sd_l, "h": sd_h}, j_log=j_log, state=state, log=log)


def test_bundled_stage2_runner_matches_jax(stage2_runs):
    state = stage2_runs["state"]
    assert state.step == STEPS
    n = 0
    for band, prior in (("l", state.t_l), ("h", state.t_h)):
        ours = prior.state_dict()
        for k, v in stage2_runs["j_final"][band].items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{band}.{k}")
            n += 1
    assert n == len(state.optimizer.param_groups[0]["params"]) + 2  # + the HF BN statistics


def test_bundled_stage2_runner_logs_jax_bundle_means(stage2_runs):
    ours, ref = _floats(stage2_runs["log"]), _floats(stage2_runs["j_log"])
    assert sorted(ours) == sorted(ref) == [STEPS]
    for step in ref:
        assert set(ours[step]) == set(ref[step])
        for k, v in ref[step].items():
            np.testing.assert_allclose(ours[step][k], v, rtol=1e-4, err_msg=f"{step} {k}")


# ---------------------------------------------------------------------------
# (d) the port alone: bundles equal single steps bit for bit

PORT_STEPS, PORT_SNAPSHOT = 8, 6
DROPOUT = {"encoder": {**CFG["encoder"], "dropout": 0.3},
           "decoder": {**CFG["decoder"], "dropout": 0.3},
           "MaskGIT": {**CFG["MaskGIT"],
                       "prior_model_l": {**CFG["MaskGIT"]["prior_model_l"], "model_dropout": 0.3,
                                         "p_unconditional": 0.2},
                       "prior_model_h": {**CFG["MaskGIT"]["prior_model_h"], "model_dropout": 0.3,
                                         "p_unconditional": 0.2}},
           "fidelity_enhancer": {**CFG["fidelity_enhancer"], "dropout": 0.5},
           "trainer_params": {"val_check_interval": dict.fromkeys(("stage1", "stage2", "stage3"),
                                                                  PORT_SNAPSHOT)}}


@pytest.fixture(scope="module")
def port_data():
    X, y = _series()
    cfg = Config.from_dict({**CFG, **DROPOUT})
    model, vq_l, vq_h = init_stage1(Stage1Spec.from_config(cfg, L, C),
                                    torch.Generator().manual_seed(4), "cpu")
    frozen = FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)
    return cfg, DatasetSplits(X[:N], y[:N], X[N:], y[N:], None, 3), frozen


def _port_run(kind, bundle, path, port_data):
    cfg, data, frozen = port_data
    log = _Log()
    kw = dict(max_steps=PORT_STEPS, seed=1, logger=log, log_interval=1, device="cpu",
              bundle_steps=bundle, save_path=path)
    if kind.startswith("stage1"):
        state = runner.train_stage1(cfg, data, data_on_device=kind == "stage1", **kw)
    elif kind == "stage2":
        state = runner.train_stage2(cfg, data, frozen, **kw)
    else:
        state = runner.train_stage3(cfg, data, frozen, **kw)
    return state, log


def _tensors(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            out.update({f"{f.name}.{k}": t for k, t in v.state_dict().items()})
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{c.name}": getattr(v, c.name) for c in dataclasses.fields(v)})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adamw.{i}.{k}": t for k, t in st.items()})
    return out


def _assert_equal(a, b, at=""):
    if isinstance(a, dict):
        assert set(a) == set(b), at
        for k in a:
            _assert_equal(a[k], b[k], f"{at}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), at
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{at}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), at
    else:
        assert a == b, at


def _assert_means(eager, bundled, start):
    """Each logged bundle mean is the eager steps' metrics summed in order
    from zeros and divided by the bundle's length; a tail step is its step."""
    tail = (PORT_STEPS - start) % BUNDLE
    ends = list(range(start + BUNDLE, PORT_STEPS - tail + 1, BUNDLE))
    assert sorted(bundled.train) == ends + list(range(PORT_STEPS - tail + 1, PORT_STEPS + 1))
    prev = start
    for s in sorted(bundled.train):
        for k, got in bundled.train[s].items():
            ref = eager.train[s][k]
            if s - prev > 1:
                acc = torch.zeros_like(ref)
                for t in range(prev + 1, s + 1):
                    acc += eager.train[t][k]
                ref = acc / (s - prev)
            assert torch.equal(got, ref), (s, k)
        prev = s


@pytest.mark.parametrize("kind", ["stage1", "stage1_host", "stage2", "stage3"])
def test_bundles_equal_single_steps_and_resume(kind, port_data, tmp_path):
    eager, e_log = _port_run(kind, 1, str(tmp_path / "eager"), port_data)
    bundled, b_log = _port_run(kind, BUNDLE, str(tmp_path / "bundled"), port_data)
    assert eager.step == bundled.step == PORT_STEPS
    _assert_equal(_tensors(eager), _tensors(bundled))
    _assert_equal(load_train_state(str(tmp_path / "eager.train")),
                  load_train_state(str(tmp_path / "bundled.train")))
    assert load_train_state(str(tmp_path / "bundled.train"))["step"] == PORT_SNAPSHOT
    _assert_means(e_log, b_log, 0)
    _assert_equal(e_log.val, b_log.val)
    # resumed in bundles from the step-6 snapshot: 2 steps left, all tail
    for suffix in ("", ".meta.json"):
        os.remove(str(tmp_path / "bundled") + suffix)
    resumed, r_log = _port_run(kind, BUNDLE, str(tmp_path / "bundled"), port_data)
    assert resumed.step == PORT_STEPS
    _assert_equal(_tensors(eager), _tensors(resumed))
    _assert_means(e_log, r_log, PORT_SNAPSHOT)


def test_bundle_steps_below_one_raise(port_data):
    cfg, data, _ = port_data
    with pytest.raises(ValueError, match="bundle_steps must be at least 1"):
        runner.train_stage1(cfg, data, max_steps=2, device="cpu", bundle_steps=0)


def test_capture_hooks_are_the_cpu_loop():
    """On the CPU nothing is captured: the multistep reports no graph and
    the VQ wrapper counts no captured launch."""
    from tvqvae_tpu_torch.ops import vq_kernel
    from tvqvae_tpu_torch.train.multistep import Multistep

    p = torch.nn.Parameter(torch.ones(3))
    opt, sched = optim.adamw([p], 0.1)
    state = type("S", (), {"optimizer": opt, "scheduler": sched, "step": 0})()

    def step():
        p.grad = torch.full_like(p, 0.5)
        opt.step()
        sched.step()
        state.step += 1
        return {"x": p.detach().sum()}

    before = vq_kernel.captured_launches
    ms = Multistep(step, state, None, 10)
    means = ms.bundle(4)
    assert ms.graph is None and ms.replays == 0 and state.step == opt.count == 4
    assert vq_kernel.captured_launches == before
    assert set(means) == {"x"} and torch.isfinite(means["x"])
    functools.reduce(lambda a, _: ms.single(), range(2), None)
    assert state.step == 6
