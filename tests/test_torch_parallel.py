"""Port parity: data parallelism (``tvqvae_tpu_torch/parallel/``).

W ranks, each with B/W rows of a global batch of B, must take the step one
process takes with all B rows: the JAX package's 1-D ``data`` mesh, where
GSPMD turns every reduction over the sharded batch into an all-reduce. Here
two ``gloo`` processes (this file run as a script, one torch thread each)
step on their slices of the global batch, and the JAX package's jitted step
runs once on the whole of it, from the same weights (JAX's tree through
``utils/convert.py``), with JAX's masks and SVQ draws handed in and dropout
0. Tolerances, each with its reason:

  - VQ indices, counts (``cluster_size`` at decay 0) and tokens exactly;
    ``embed_sum`` (``embed_avg`` at decay 0) within (n-1)·2⁻²⁴·Σ|x| per
    entry, the float32 error bound of a sum of n terms taken in another
    order (the two ranks' partial sums against one pass);
  - the step-1 gradients (the port's averaged ``p.grad``; JAX's from its
    first Adam moment, 0.1·grad) per leaf to 1e-4 of the leaf's max |grad|:
    they are what the BatchNorm, VQ and masked-CE reductions decide, and a
    statistic reduced without its gradient shows here (the forward alone
    would pass); the biases that a train-mode BatchNorm cancels have a
    gradient of 0 up to rounding in both and are bounded by 1e-5 of their
    conv weight's;
  - parameters, BatchNorm statistics and codebooks after three steps to
    2e-4 (+ 2·Σlr for the BatchNorm-cancelled biases and the running means
    they feed: Adam's sign step, ``chip_smoke.py::biases_cancelled_by_batchnorm``);
  - every rank's parameters and BatchNorm statistics bit-equal.

Then ``train_stage1`` by two ranks with a snapshot and a resume between
them against the uninterrupted two-rank run (bit-equal) and against one
process (four Adam steps from lr 1e-3: every element within 2e-4 + 2·Σlr,
all but 1e-4 of them within 2e-4; the ranks' validation equal to one
process's validation of the same state to 1e-5 relative); the primary
alone writes and the other rank finds the files after the call (the
barrier); the process slices of ``make_batches`` partition the global batch
(the JAX package's ``tests/test_multihost.py`` cases, against the port); the
sampler over ``devices=("cpu", "cpu")`` against one device, bit-equal (CPU
convolutions take another algorithm at one row than at two, so every chunk
here holds two rows or more); the train CLI's ``--host_data`` and
``--no_precompute`` against its default paths, bit-equal; and the host
feed against the device gather.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d
from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec
from tvqvae_tpu_torch.models.vq import CodebookState, VQParams, vq_forward
from tvqvae_tpu_torch.parallel import mesh
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage2 as tst2
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step
from tvqvae_tpu_torch.utils import checkpoint as tckpt
from tvqvae_tpu_torch.utils.schedule import cosine_decay_schedule, warmup_cosine_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, G = 2, 8  # ranks, global batch
C, L, L3, N_CLASSES = 4, 127, 96, 3
LR, MAX_STEPS, STEPS = 1e-3, 100, 3
ADAM_NOISE = 2 * sum(warmup_cosine_schedule(LR, MAX_STEPS)(t) for t in range(STEPS))
S1_CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}, "dropout": 0.0},
    "decoder": {"n_resnet_blocks": 1, "dropout": 0.0},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
}
_PRIOR = {"ff_mult": 1, "use_rmsnorm": True, "p_unconditional": 0.0, "model_dropout": 0.0,
          "emb_dropout": 0.0}
S2_CFG = {**S1_CFG, "MaskGIT": {
    "T": {"lf": 3, "hf": 1},
    "prior_model_l": {**_PRIOR, "hidden_dim": 16, "n_layers": 2, "heads": 2},
    "prior_model_h": {**_PRIOR, "hidden_dim": 8, "n_layers": 1, "heads": 1},
}}
FE = dict(dim=8, dim_mults=(1, 2, 4, 8), resnet_block_groups=4)
TAU = 0.5
VQ_K, VQ_D, VQ_N = 8, 16, 40
FCN_LR, FCN_WD = 1e-3, 1e-5


# ---------------------------------------------------------------------------
# the port's side, run by each rank (and by nothing of JAX)


def _tx():
    return lambda params: adamw(params, warmup_cosine_schedule(LR, MAX_STEPS), weight_decay=0.01)


def _grads(named):
    return {k: p.grad.detach().clone() for k, p in named}


def _bn_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items() if k.endswith(("running_mean",
                                                                                  "running_var"))}


def _frozen(sd, length):
    spec = Stage1Spec.from_config(Config.from_dict(S1_CFG), length, C)
    frozen = tmg.FrozenStage1.from_state_dict(spec, sd, "cpu")
    frozen.model.requires_grad_(False)
    return frozen


def port_vq(inp):
    state = CodebookState(*(torch.from_numpy(a.copy()) for a in inp["state"]))
    x = torch.from_numpy(mesh.shard_batch(inp["x"]))
    out = vq_forward(state, x, VQParams(VQ_K, VQ_D, decay=0.0), train=True)
    return {"indices": out.indices.numpy(), "cluster_size": out.state.cluster_size.numpy(),
            "embed_avg": out.state.embed_avg.numpy(), "perplexity": out.perplexity.item()}


def port_stage1(inp):
    spec = Stage1Spec.from_config(Config.from_dict(S1_CFG), L, C, fast_bn=inp["fast_bn"])
    frozen = tmg.FrozenStage1.from_state_dict(spec, inp["sd"], "cpu")
    state = create_stage1_state(frozen.model, frozen.vq_l, frozen.vq_h, _tx())
    captured = []
    state.model.register_forward_hook(
        lambda m, i, o: captured.append((o.vq_l.indices.numpy(), o.vq_h.indices.numpy())))
    step = make_stage1_train_step()
    out = {"loss": []}
    for t in range(STEPS):
        _, m = step(state, torch.from_numpy(mesh.shard_batch(inp["xs"][t])))
        out["loss"].append(mesh.all_reduce_metrics(m)["loss"].item())
        if t == 0:
            out["grads"] = _grads(state.model.named_parameters())
    sd = dict(state.model.state_dict())
    for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h)):
        for f in ("embed", "embed_avg", "cluster_size"):
            sd[f"{band}.{f}"] = getattr(cb, f)
    out.update(indices=captured, final=sd)
    return out


def port_stage2(inp):
    cfg = Config.from_dict(S2_CFG)
    frozen = _frozen(inp["s1"], L)
    t_l, t_h = tmg.build_transformers(cfg, frozen.model.spec, N_CLASSES)
    t_l.load_state_dict(inp["sd_l"])
    t_h.load_state_dict(inp["sd_h"])
    state = tst2.create_stage2_state(t_l, t_h, _tx())
    step = tst2.make_stage2_train_step(frozen)
    out = {"loss": [], "tokens": []}
    for t in range(STEPS):
        x, y = (torch.from_numpy(mesh.shard_batch(a[t])) for a in (inp["xs"], inp["ys"]))
        noise = {band: tuple(torch.from_numpy(mesh.shard_batch(d)) for d in draws)
                 for band, draws in inp["noise"][t].items()}
        out["tokens"].append(tuple(tmg.encode_tokens(frozen, x, band).numpy()
                                   for band in ("lf", "hf")))
        _, m = step(state, x, y, noise=noise)
        out["loss"].append({k: v.item() for k, v in mesh.all_reduce_metrics(m).items()})
        if t == 0:
            out["grads"] = {"l": _grads(t_l.named_parameters()), "h": _grads(t_h.named_parameters())}
    out["final"] = {"l": dict(t_l.state_dict()), "h": dict(t_h.state_dict())}
    return out


def port_stage3(inp):
    frozen = _frozen(inp["s1"], L3)
    fe = FidelityEnhancer(L3, C, **FE, dropout=0.0)
    fe.load_state_dict(inp["fe"])
    state = tst3.create_stage3_state(fe, _tx())
    step = tst3.make_stage3_train_step(frozen, inp["tau"])
    n_l, n_h = frozen.model.spec.tokens_l, frozen.model.spec.tokens_h
    lo, hi = mesh.shard_bounds(G).start, mesh.shard_bounds(G).stop
    out = {"loss": []}
    for t in range(STEPS):
        x = torch.from_numpy(mesh.shard_batch(inp["xs"][t]))
        noise = None
        if inp["noise"] is not None:  # the rows of this rank's series, (b, n) flattened
            g_l, g_h = inp["noise"][t]
            noise = (g_l[lo * n_l:hi * n_l], g_h[lo * n_h:hi * n_h])
        _, m = step(state, x, noise=noise)
        out["loss"].append(mesh.all_reduce_metrics(m)["loss"].item())
        if t == 0:
            out["grads"] = _grads(fe.named_parameters())
    out["final"] = dict(fe.state_dict())
    return out


def port_fcn(inp):
    fcn = FCN(C, N_CLASSES)
    fcn.load_state_dict(inp["sd"])
    opt, sched = adamw(fcn.parameters(), cosine_decay_schedule(FCN_LR, MAX_STEPS),
                       weight_decay=FCN_WD)
    out = {"loss": []}
    for t in range(STEPS):
        x, y = (torch.from_numpy(mesh.shard_batch(a[t])) for a in (inp["xs"], inp["ys"]))
        ce, _ = runner.fcn_train_step(fcn, opt, sched, x, y)
        out["loss"].append(mesh.all_reduce_metrics({"ce": ce})["ce"].item())
        if t == 0:
            out["grads"] = _grads(fcn.named_parameters())
    out["final"] = dict(fcn.state_dict())
    return out


class Recorder:
    def __init__(self):
        self.val = []

    def log_metrics(self, metrics, step):
        if "val/loss" in metrics:
            self.val.append((step, {k: float(v) for k, v in metrics.items()}))


def runner_data():
    X, y = tdata.make_synthetic_trajectories(n=44, channels=C, length=L, n_classes=N_CLASSES,
                                             seed=5)
    return tdata.DatasetSplits(X_train=X[:32], y_train=y[:32, None], X_test=X[32:],
                               y_test=y[32:, None], scaler=None, n_classes=N_CLASSES)


def runner_cfg():
    return Config.from_dict({**S1_CFG, "dataset": {"batch_sizes": {"stage1": G}},
                             "trainer_params": {"val_check_interval": {"stage1": 2}}})


def train_runner(save_path, logger=None):
    return runner.train_stage1(runner_cfg(), runner_data(), max_steps=4, device="cpu",
                               log_interval=1, save_path=save_path, logger=logger)


def port_runner(workdir):
    """Two-rank ``train_stage1``: uninterrupted; then again with its stage
    checkpoint removed after the run, so that the third call resumes from
    the step-2 snapshot. Rank 0's writes wait 0.3 s before they start: the
    other rank must still find the files when its call returns."""
    rank = mesh.process_index()
    writes = []
    real = tckpt._replace_into

    def recording(path, write):
        writes.append(os.path.basename(path))
        if rank == 0:
            time.sleep(0.3)
        real(path, write)

    tckpt._replace_into = recording
    rec = Recorder()
    full = train_runner(os.path.join(workdir, "full", "stage1"), rec)
    seen = all(os.path.exists(os.path.join(workdir, "full", f)) for f in
               ("stage1", "stage1.meta.json", "stage1.train"))
    part = os.path.join(workdir, "part", "stage1")
    train_runner(part)
    mesh.barrier()
    if rank == 0:
        os.remove(part)
        os.remove(part + ".meta.json")
    mesh.barrier()
    resumed = train_runner(part)
    tckpt._replace_into = real
    return {"writes": writes, "seen": seen, "val": rec.val,
            "full": runner.stage1_to_jax(full.model, full.vq_l, full.vq_h),
            "resumed": runner.stage1_to_jax(resumed.model, resumed.vq_l, resumed.vq_h),
            "bn": _bn_stats(full.model)}


def grid_eval_state():
    """A seeded stage-1 state of ``runner_cfg`` for the grid validation."""
    from tvqvae_tpu_torch.models.stage1 import init_stage1

    model, vq_l, vq_h = init_stage1(Stage1Spec.from_config(runner_cfg(), L, C),
                                    torch.Generator().manual_seed(9), "cpu")
    return create_stage1_state(model, vq_l, vq_h, _tx())


def port_grid_eval():
    """``runner._make_eval`` by both ranks as a (1, 2) grid, the state's big
    weights split over them: both ranks run every batch (gathering the
    weights together) and reduce over their one-rank data group."""
    from tvqvae_tpu_torch.parallel import tp

    state = grid_eval_state()
    with tp.make_mesh2d(1, 2):
        tp.shard_train_state_tp(state, min_elems=512)
        fraction = tp.sharded_fraction(state.model)
        val = runner._make_eval(state, runner_data().X_test, G, torch.device("cpu"))(0)
    return {"val": val, "fraction": fraction}


CASES = ("vq", "s1_flax", "s1_fast", "s2", "s3_0", "s3_tau", "fcn")


def worker(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank: every case on its slices, then the runner; its results to
    ``out<rank>.pkl``."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    fns = {"vq": port_vq, "s1_flax": port_stage1, "s1_fast": port_stage1, "s2": port_stage2,
           "s3_0": port_stage3, "s3_tau": port_stage3, "fcn": port_fcn}
    out = {name: fns[name](cases[name]) for name in CASES}
    out["runner"] = port_runner(workdir)
    out["grid_eval"] = port_grid_eval()
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's side, one process over the global batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _random_tree(shapes, rng):
    """Random values for a tree of ``jax.ShapeDtypeStruct``s: kernels
    U(-1/sqrt(fan_in), ..), scales near 1, small biases, random running
    statistics, Snake slopes in [0.2, 0.5]."""
    import jax.numpy as jnp

    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = _random_tree(v, rng)
            continue
        shape = v.shape
        if k in ("kernel", "embedding"):
            a = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]) if k == "kernel" else 1.0)
        elif k in ("var", "scale", "g"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k == "a":
            a = rng.uniform(0.2, 0.5, shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        out[k] = jnp.asarray(a, jnp.float32)
    return out


def _jax_stage1(length, fast_bn=False, seed=0):
    """The JAX stage 1 at S1_CFG: (model, random tree with codebooks)."""
    import jax
    import jax.numpy as jnp

    from tvqvae_tpu.config import Config as JConfig
    from tvqvae_tpu.models.stage1 import Stage1Model, Stage1Spec as JSpec
    from tvqvae_tpu.models.vq import init_codebook

    spec = JSpec.from_config(JConfig.from_dict(S1_CFG), length, C, fast_bn=fast_bn)
    model = Stage1Model(spec)
    vq_l, vq_h = (init_codebook(jax.random.key(i), p) for i, p in ((1, spec.vq_l), (2, spec.vq_h)))
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((2, C, length)),
                                               vq_l, vq_h))
    rng = np.random.default_rng(seed)
    return model, {"params": _random_tree(shapes["params"], rng),
                   "batch_stats": _random_tree(shapes["batch_stats"], rng),
                   "vq_l": vq_l, "vq_h": vq_h}


def _jax_tx():
    from tvqvae_tpu.train.optim import adamw as j_adamw
    from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule

    return j_adamw(j_schedule(LR, MAX_STEPS, 0.1), weight_decay=0.01)


def _mu_grads(opt_state):
    """The step's gradient tree from optax's first moment after one step."""
    import jax

    return jax.tree.map(lambda m: np.asarray(m) / 0.1, opt_state[0].mu)


def jax_vq():
    import jax.numpy as jnp

    from tvqvae_tpu.models.vq import CodebookState as JState, VQParams as JParams, vq_forward

    rng = np.random.default_rng(2)
    embed = rng.normal(size=(VQ_K, VQ_D)).astype(np.float32)
    avg = (embed + 0.1 * rng.normal(size=embed.shape)).astype(np.float32)
    cs = rng.uniform(0, 3, VQ_K).astype(np.float32)
    x = rng.normal(size=(G, VQ_N, VQ_D)).astype(np.float32)
    out = vq_forward(JState(*map(jnp.asarray, (embed, avg, cs)), jnp.asarray(True)),
                     jnp.asarray(x), JParams(VQ_K, VQ_D, decay=0.0), train=True)
    inp = {"state": (embed, avg, cs, np.asarray(True)), "x": x}
    ref = {"indices": np.asarray(out.indices), "cluster_size": np.asarray(out.state.cluster_size),
           "embed_avg": np.asarray(out.state.embed_avg), "perplexity": float(out.perplexity),
           "x": x}
    return inp, ref


def jax_stage1(fast_bn):
    import jax
    import jax.numpy as jnp

    from tvqvae_tpu.train.stage1 import create_stage1_state as j_create, make_stage1_train_step
    from tvqvae_tpu_torch.utils import convert

    model, tree = _jax_stage1(L, fast_bn)
    xs = np.random.default_rng(1).normal(size=(STEPS, G, C, L)).astype(np.float32)
    tx = _jax_tx()
    state = j_create(tree["params"], tree["batch_stats"], tree["vq_l"], tree["vq_h"], tx)
    step = jax.jit(make_stage1_train_step(model, tx))

    @jax.jit
    def indices(state, x):
        out, _ = model.apply({"params": state.params, "batch_stats": state.batch_stats}, x,
                             state.vq_l, state.vq_h, True, mutable=["batch_stats"])
        return out.vq_l.indices, out.vq_h.indices

    ref = {"indices": [], "loss": []}
    for t in range(STEPS):
        ref["indices"].append(tuple(np.asarray(i) for i in indices(state, jnp.asarray(xs[t]))))
        state, m = step(state, jnp.asarray(xs[t]), jax.random.key(1))
        ref["loss"].append(float(m["loss"]))
        if t == 0:
            ref["grads"] = convert.params_to_state_dict(_mu_grads(state.opt_state))
    ref["final"] = convert.stage1_from_jax({"params": state.params, "batch_stats": state.batch_stats,
                                            "vq_l": state.vq_l, "vq_h": state.vq_h})
    return {"sd": convert.stage1_from_jax(tree), "xs": xs, "fast_bn": fast_bn}, ref


def _jax_mask_draws(key, n_rows, n):
    import jax

    r_ratio, r_pos = jax.random.split(key)
    return (np.array(jax.random.uniform(r_ratio, (n_rows,))),
            np.array(jax.random.uniform(r_pos, (n_rows, n))))


def jax_stage2():
    import jax
    import jax.numpy as jnp

    from tvqvae_tpu.config import Config as JConfig
    from tvqvae_tpu.models import maskgit as jmg
    from tvqvae_tpu.models.stage1 import Stage1Spec as JSpec
    from tvqvae_tpu.train import stage2 as jst2
    from tvqvae_tpu_torch.utils import convert

    model, tree = _jax_stage1(L, seed=3)
    jcfg = JConfig.from_dict(S2_CFG)
    spec = jmg.MaskGITSpec.from_config(jcfg, JSpec.from_config(jcfg, L, C))
    t_l, t_h = jmg.build_transformers(jcfg, JSpec.from_config(jcfg, L, C), N_CLASSES)
    shapes = jax.eval_shape(lambda: jst2.init_stage2(jax.random.key(0), t_l, t_h, spec))
    rng = np.random.default_rng(4)
    params, h_stats = _random_tree(shapes[0], rng), _random_tree(shapes[1], rng)
    tx = _jax_tx()
    state = jst2.create_stage2_state(params, h_stats, tx)
    frozen = jmg.FrozenStage1(params=tree["params"], batch_stats=tree["batch_stats"],
                              vq_l=tree["vq_l"], vq_h=tree["vq_h"])
    step = jax.jit(jst2.make_stage2_train_step(model, t_l, t_h, spec, tx))
    data = np.random.default_rng(5)
    xs = data.normal(size=(STEPS, G, C, L)).astype(np.float32)
    ys = data.integers(0, N_CLASSES, size=(STEPS, G, 1)).astype(np.int64)
    key = jax.random.key(7)
    ref, noise = {"loss": []}, []
    for t in range(STEPS):
        r_l, r_h, _, _ = jax.random.split(jax.random.fold_in(key, t), 4)
        noise.append({"l": _jax_mask_draws(r_l, G, spec.tokens_l),
                      "h": _jax_mask_draws(r_h, G, spec.tokens_h)})
        state, m = step(state, frozen, jnp.asarray(xs[t]), jnp.asarray(ys[t], jnp.int32), key)
        ref["loss"].append({k: float(v) for k, v in m.items()})
        if t == 0:
            g = _mu_grads(state.opt_state)
            gl, gh = convert.prior_from_jax(g, h_stats)
            ref["grads"] = {"l": gl, "h": gh}
    enc = jax.jit(lambda x: (jmg.encode_tokens(model, frozen, x, "lf"),
                             jmg.encode_tokens(model, frozen, x, "hf")))
    ref["tokens"] = [tuple(np.asarray(s) for s in enc(jnp.asarray(xs[t]))) for t in range(STEPS)]
    fl, fh = convert.prior_from_jax(state.params, state.h_stats)
    ref["final"] = {"l": fl, "h": fh}
    sd_l, sd_h = convert.prior_from_jax(params, h_stats)
    return {"s1": convert.stage1_from_jax(tree), "sd_l": sd_l, "sd_h": sd_h, "xs": xs, "ys": ys,
            "noise": noise}, ref


def jax_stage3(tau):
    import jax
    import jax.numpy as jnp

    from tvqvae_tpu.models import maskgit as jmg
    from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFE
    from tvqvae_tpu.train import stage3 as jst3
    from tvqvae_tpu_torch.utils import convert

    model, tree = _jax_stage1(L3, seed=6)
    fe = JFE(input_length=L3, in_channels=C, dim=FE["dim"], dim_mults=FE["dim_mults"],
             resnet_block_groups=FE["resnet_block_groups"], dropout=0.0)
    shapes = jax.eval_shape(lambda: fe.init(jax.random.key(0), jnp.zeros((2, C, L3)), False))
    params = _random_tree(shapes["params"], np.random.default_rng(7))
    tx = _jax_tx()
    state = jst3.create_stage3_state(params, tx, tau)
    frozen = jmg.FrozenStage1(params=tree["params"], batch_stats=tree["batch_stats"],
                              vq_l=tree["vq_l"], vq_h=tree["vq_h"])
    step = jax.jit(jst3.make_stage3_train_step(model, fe, tx, tau=tau))
    xs = np.random.default_rng(8).normal(size=(STEPS, G, C, L3)).astype(np.float32)
    n_l, n_h = model.spec.tokens_l, model.spec.tokens_h
    K_l, K_h = model.spec.vq_l.codebook_size, model.spec.vq_h.codebook_size
    key = jax.random.key(9)
    ref, noise = {"loss": []}, []
    for t in range(STEPS):
        if tau > 0:  # the SVQ Gumbels of JAX's step t: fold_in, split, split
            r_svq, _ = jax.random.split(jax.random.fold_in(key, t))
            r1, r2 = jax.random.split(r_svq)
            noise.append((torch.from_numpy(np.array(jax.random.gumbel(r1, (G * n_l, K_l)))),
                          torch.from_numpy(np.array(jax.random.gumbel(r2, (G * n_h, K_h))))))
        state, m = step(state, frozen, jnp.asarray(xs[t]), key)
        ref["loss"].append(float(m["loss"]))
        if t == 0:
            ref["grads"] = convert.fe_from_jax(_mu_grads(state.opt_state))
    ref["final"] = convert.fe_from_jax(state.params)
    return {"s1": convert.stage1_from_jax(tree), "fe": convert.fe_from_jax(params), "xs": xs,
            "tau": tau, "noise": noise or None}, ref


def jax_fcn():
    import jax
    import jax.numpy as jnp
    import optax

    from tvqvae_tpu.models.fcn import FCN as JFCN
    from tvqvae_tpu_torch.utils import convert

    model = JFCN(n_classes=N_CLASSES)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0)},
                                               jnp.zeros((2, C, 64)), True))
    rng = np.random.default_rng(10)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng)
    tx = optax.adamw(optax.cosine_decay_schedule(FCN_LR, MAX_STEPS), weight_decay=FCN_WD)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, stats, opt_state, x, y):
        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": stats}, x, True,
                                      mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy(logits, jax.nn.one_hot(y[:, 0], N_CLASSES)).mean()
            return ce, mut

        (ce, mut), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), mut["batch_stats"], opt_state, ce

    data = np.random.default_rng(11)
    xs = data.normal(size=(STEPS, G, C, 64)).astype(np.float32)
    ys = data.integers(0, N_CLASSES, size=(STEPS, G, 1)).astype(np.int64)
    sd0 = convert.fcn_from_jax({"params": params, "batch_stats": stats})
    ref = {"loss": []}
    for t in range(STEPS):
        params, stats, opt_state, ce = step(params, stats, opt_state, jnp.asarray(xs[t]),
                                            jnp.asarray(ys[t]))
        ref["loss"].append(float(ce))
        if t == 0:
            ref["grads"] = convert.fcn_from_jax({"params": _mu_grads(opt_state),
                                                 "batch_stats": stats})
    ref["final"] = convert.fcn_from_jax({"params": params, "batch_stats": stats})
    return {"sd": sd0, "xs": xs, "ys": ys}, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX package's steps on the global batches, then two gloo ranks
    running every case and the runner: (references, [rank 0's, rank 1's
    results], the work directory)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        builders = {"vq": jax_vq, "s1_flax": lambda: jax_stage1(False),
                    "s1_fast": lambda: jax_stage1(True), "s2": jax_stage2,
                    "s3_0": lambda: jax_stage3(0.0), "s3_tau": lambda: jax_stage3(TAU),
                    "fcn": jax_fcn}
        cases, refs = {}, {}
        for name in CASES:
            cases[name], refs[name] = builders[name]()
    finally:
        torch.set_num_threads(n)
    work = str(tmp_path_factory.mktemp("ranks"))
    with open(os.path.join(work, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(W),
                               str(port), work], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(W)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(W):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return refs, outs, work, logs


def _assert_grads(ours: dict, ref: dict, cancelled=()):
    assert set(ours) <= set(ref)
    for name, g in ours.items():
        r = np.asarray(ref[name])
        if name in cancelled:
            scale = np.abs(np.asarray(ref[cancelled[name]])).max()
            assert max(np.abs(r).max(), g.abs().max().item()) <= 1e-5 * scale, name
            continue
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * scale, err_msg=name)


def _assert_final(ours: dict, ref: dict, loose=(), noise=ADAM_NOISE):
    """Every leaf of ``ref`` to 2e-4; the ``loose`` biases and (with them)
    the running means within 2e-4 + ``noise`` (2·Σlr of the steps)."""
    n = 0
    for k, r in ref.items():
        if k.endswith("num_batches_tracked") or k.endswith("initted"):
            continue
        atol = 2e-4 + (noise if k in loose or (loose and k.endswith("running_mean")) else 0)
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(r), rtol=2e-4, atol=atol,
                                   err_msg=k)
        n += 1
    assert n > 0


def _assert_ranks_equal(outs):
    for k, v in outs[0].items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(outs[1][k])), k


def test_vq_statistics_are_the_global_batch(ranks):
    refs, outs, _, _ = ranks
    ref = refs["vq"]
    np.testing.assert_array_equal(np.concatenate([o["vq"]["indices"] for o in outs]),
                                  ref["indices"])
    n = G * VQ_N  # rows summed into each code
    bound = (n - 1) * 2.0 ** -24 * np.abs(ref["x"]).sum(axis=(0, 1))  # per dimension
    for o in outs:
        np.testing.assert_array_equal(o["vq"]["cluster_size"], ref["cluster_size"])  # counts
        assert (np.abs(o["vq"]["embed_avg"] - ref["embed_avg"]) <= bound[None, :]).all()
        assert o["vq"]["perplexity"] == pytest.approx(ref["perplexity"], rel=1e-6)


@pytest.mark.parametrize("case", ["s1_flax", "s1_fast"])
def test_stage1_two_ranks_match_jax(ranks, case):
    """Both BatchNorm modes: the indices of every step, the step-1 gradients
    (global BatchNorm statistics differentiated through), the losses, and
    the state after three steps; both ranks hold the same state."""
    from chip_smoke import biases_cancelled_by_batchnorm

    refs, outs, _, _ = ranks
    ref, ours = refs[case], [o[case] for o in outs]
    for t in range(STEPS):
        for band in (0, 1):
            np.testing.assert_array_equal(
                np.concatenate([o["indices"][t][band] for o in ours]), ref["indices"][t][band],
                err_msg=f"step {t + 1} band {band}")
    model = Stage1Model(Stage1Spec.from_config(Config.from_dict(S1_CFG), L, C))
    cancelled = biases_cancelled_by_batchnorm(model)
    assert len(cancelled) >= 10
    _assert_grads(ours[0]["grads"], ref["grads"], cancelled)
    np.testing.assert_allclose(ours[0]["loss"], ref["loss"], rtol=1e-4)
    _assert_final(ours[0]["final"], ref["final"], loose=set(cancelled))
    _assert_ranks_equal([o["final"] for o in ours])
    assert sum(isinstance(m, BatchNorm2d) for m in model.modules()) > 0


def test_stage2_two_ranks_match_jax(ranks):
    refs, outs, _, _ = ranks
    ref, ours = refs["s2"], [o["s2"] for o in outs]
    for t in range(STEPS):
        for band in (0, 1):
            np.testing.assert_array_equal(
                np.concatenate([o["tokens"][t][band] for o in ours]), ref["tokens"][t][band])
        for k, v in ref["loss"][t].items():
            assert ours[0]["loss"][t][k] == pytest.approx(v, rel=1e-5), (t, k)
    for band in ("l", "h"):
        _assert_grads(ours[0]["grads"][band], ref["grads"][band])
        _assert_final(ours[0]["final"][band], ref["final"][band])
        _assert_ranks_equal([o["final"][band] for o in ours])


@pytest.mark.parametrize("case", ["s3_0", "s3_tau"])
def test_stage3_two_ranks_match_jax(ranks, case):
    refs, outs, _, _ = ranks
    ref, ours = refs[case], [o[case] for o in outs]
    np.testing.assert_allclose(ours[0]["loss"], ref["loss"], rtol=1e-5)
    _assert_grads(ours[0]["grads"], ref["grads"])
    _assert_final(ours[0]["final"], ref["final"])
    _assert_ranks_equal([o["final"] for o in ours])


def test_fcn_two_ranks_match_jax(ranks):
    refs, outs, _, _ = ranks
    ref, ours = refs["fcn"], [o["fcn"] for o in outs]
    cancelled = {f"Conv_{i}.bias": f"Conv_{i}.weight" for i in range(3)}  # each before a BatchNorm
    np.testing.assert_allclose(ours[0]["loss"], ref["loss"], rtol=1e-5)
    _assert_grads(ours[0]["grads"], ref["grads"], cancelled)
    noise = 2 * sum(cosine_decay_schedule(FCN_LR, MAX_STEPS)(t) for t in range(STEPS))
    _assert_final(ours[0]["final"], ref["final"], loose=set(cancelled), noise=noise)
    _assert_ranks_equal([o["final"] for o in ours])
    assert sum(isinstance(m, BatchNorm1d) for m in FCN(C, N_CLASSES).modules()) == 3


def test_train_stage1_two_ranks_resume_equals_one_run(ranks):
    _, outs, _, _ = ranks
    """Resumed from the step-2 snapshot (each rank its own generator and its
    place in the host feed), the run ends bit-equal to the uninterrupted
    one, and both ranks end in the same state."""
    _, outs, _, _ = ranks

    def flat(tree):
        return dict(tckpt._flatten(tree))

    full = flat(outs[0]["runner"]["full"])
    for other in (outs[0]["runner"]["resumed"], outs[1]["runner"]["full"],
                  outs[1]["runner"]["resumed"]):
        other = flat(other)
        assert set(other) == set(full)
        for k in full:
            np.testing.assert_array_equal(other[k], full[k], err_msg=k)


def test_train_stage1_two_ranks_match_one_process(ranks, tmp_path):
    """The same four steps in one process (``make_batches``' global order,
    dropout 0): the state within Adam's element rule below; the ranks'
    validation (they split the test split's batches) equal to one process's
    validation of the same state to 1e-5 relative."""
    from chip_smoke import biases_cancelled_by_batchnorm

    _, outs, _, _ = ranks
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = Recorder()
        one = train_runner(str(tmp_path / "stage1"), rec)
    finally:
        torch.set_num_threads(n)
    ref = runner.stage1_to_jax(one.model, one.vq_l, one.vq_h)
    from tvqvae_tpu_torch.utils import convert

    ours = convert.stage1_from_jax(outs[0]["runner"]["full"])
    theirs = convert.stage1_from_jax(ref)
    # four steps at lr ~1e-3 from the first: an element whose gradient is 0
    # up to rounding takes Adam's sign step either way, so every element is
    # held within 2e-4 + 2·Σlr and all but 1e-4 of them within 2e-4
    noise = 2 * sum(warmup_cosine_schedule(runner_cfg().exp_params.lr, 4)(t) for t in range(4))
    cancelled = biases_cancelled_by_batchnorm(one.model)
    beyond, n_el = 0, 0
    for k, r in theirs.items():
        if k.endswith(("num_batches_tracked", "initted")):
            continue
        err = np.abs(np.asarray(ours[k], np.float64) - np.asarray(r, np.float64))
        assert err.max() <= 2e-4 + noise, k
        if k not in cancelled and not k.endswith("running_mean"):
            beyond += int((err > 2e-4 + 2e-4 * np.abs(np.asarray(r))).sum())
            n_el += err.size
    assert beyond <= 1e-4 * n_el, (beyond, n_el)
    assert [s for s, _ in outs[0]["runner"]["val"]] == [s for s, _ in rec.val] == [2, 4]
    # the ranks' validation at step 4 (each rank its share of the test
    # split's batches, the sums all-reduced) against one process's
    # validation of the same final state: the same means up to the order of
    # the additions
    spec = Stage1Spec.from_config(runner_cfg(), L, C)
    frozen = tmg.FrozenStage1.from_state_dict(spec, ours, "cpu")
    state = create_stage1_state(frozen.model, frozen.vq_l, frozen.vq_h, _tx())
    data = runner_data()
    val = runner._make_eval(state, data.X_test, G, torch.device("cpu"))(4)
    logged = outs[0]["runner"]["val"][-1][1]
    assert len(val) == 6
    for k, v in val.items():
        assert logged[f"val/{k}"] == pytest.approx(v, rel=1e-5), k


def test_primary_alone_writes_and_the_barrier_holds(ranks):
    _, outs, work, logs = ranks
    r0, r1 = outs[0]["runner"], outs[1]["runner"]
    assert r1["writes"] == []
    assert {"stage1", "stage1.meta.json", "stage1.train"} <= set(r0["writes"])
    assert r0["seen"] and r1["seen"]  # rank 1 found rank 0's late files on return
    assert "resuming from step 2" in logs[0] and "resuming from step 2" not in logs[1]
    # the BatchNorm running statistics are equal on both ranks
    for k, v in r0["bn"].items():
        assert torch.equal(v, r1["bn"][k]), k


def test_validation_under_a_grid_equals_one_process(ranks):
    """Under a (1, 2) grid (``parallel/tp.py``) the two ranks hold one slice
    of the batch: each runs every validation batch and sums over its data
    group alone, so the totals are one process's, not twice them."""
    _, outs, _, _ = ranks
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = runner._make_eval(grid_eval_state(), runner_data().X_test, G,
                                torch.device("cpu"))(0)
    finally:
        torch.set_num_threads(n)
    for o in outs:
        got = o["grid_eval"]
        assert got["fraction"] > 0.25
        assert set(got["val"]) == set(one) and len(one) == 6
        for k, v in one.items():
            assert got["val"][k] == pytest.approx(v, rel=1e-6), k


# ---------------------------------------------------------------------------
# the process slices, the sampler's devices, the CLI's feeds


@pytest.mark.parametrize("P", [2, 4])
def test_process_slices_partition_global_batch(P):
    from tvqvae_tpu.data import make_batches as j_make_batches

    X = np.arange(40, dtype=np.float32).reshape(40, 1)
    y = np.arange(40).reshape(40, 1)
    globals_ = list(tdata.make_batches(X, y, G, shuffle=True, seed=3))
    parts = [list(tdata.make_batches(X, y, G, shuffle=True, seed=3, process_index=pi,
                                     process_count=P)) for pi in range(P)]
    refs = [list(j_make_batches(X, y, G, shuffle=True, seed=3, process_index=pi,
                                process_count=P)) for pi in range(P)]
    assert all(len(p) == len(globals_) for p in parts)
    for i, (gx, gy) in enumerate(globals_):
        np.testing.assert_array_equal(np.concatenate([p[i][0] for p in parts]), gx)
        np.testing.assert_array_equal(np.concatenate([p[i][1] for p in parts]), gy)
        for pi in range(P):
            assert parts[pi][i][0].shape == (G // P, 1)
            np.testing.assert_array_equal(parts[pi][i][0], refs[pi][i][0])
            bounds = mesh.shard_bounds(G, pi, P)
            np.testing.assert_array_equal(mesh.shard_batch(gx, pi, P), gx[bounds])


def test_process_slices_identical_order_across_hosts():
    X = np.arange(32, dtype=np.float32).reshape(32, 1)
    a, b = ([xb for xb, _ in tdata.make_batches(X, None, 8, shuffle=True, seed=7, process_index=1,
                                                 process_count=2)] for _ in range(2))
    for xa, xb in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_bounds(G, 0, 3)


@pytest.mark.parametrize("start_step", [0, 1, 3, 7])
def test_host_feed_gives_the_device_batches(start_step):
    """``runner._Feed``: the host feed (``on_device=False``, what the ranks
    of a group take), resumed after ``start_step`` and staged 3 steps at a
    time (a bundle's batches; 1 or 2 in the tail), yields the batches that
    the device gather gives one process at the same steps."""
    rng = np.random.default_rng(start_step)
    X = rng.normal(size=(20, 2, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=(20, 1))
    dev = torch.device("cpu")
    gather = runner._Feed((X, y, None), 6, 12, 4, dev, start_step)
    host = runner._Feed((X, y, None), 6, 12, 4, dev, start_step, on_device=False, bundle=3)
    step = start_step
    while step < 12:
        k = min(3, 12 - step)
        host.prepare(k)
        for _ in range(k):
            step += 1
            (gx, gy, gn), (hx, hy, hn) = gather.next(), host.next()
            assert gn is None and hn is None
            assert torch.equal(gx, hx) and torch.equal(gy, hy), step


def test_one_process_collectives_are_no_ops():
    assert not mesh.initialized()
    assert (mesh.process_index(), mesh.process_count(), mesh.is_primary()) == (0, 1, True)
    t = torch.arange(3.0)
    assert mesh.all_reduce_(t) is t and torch.equal(t, torch.arange(3.0))
    x = torch.ones(2, requires_grad=True)
    assert mesh.all_reduce_sum(x) is x
    m = {"loss": torch.tensor(1.5)}
    assert mesh.all_reduce_metrics(m) is m
    assert mesh.all_gather_object(7) == [7]
    mesh.barrier("one process")


@pytest.fixture(scope="module")
def samplers():
    from test_torch_sampler import CFG as SAMPLER_CFG, C as SC, L as SL, N_CLASSES as SN
    from tvqvae_tpu_torch.generation import TrainedModelSampler

    cfg = Config.from_dict(SAMPLER_CFG)
    kw = dict(seed=3, device="cpu", batch_size=4, use_fidelity_enhancer=True)
    return (TrainedModelSampler.from_init(cfg, SL, SC, SN, **kw),
            TrainedModelSampler.from_init(cfg, SL, SC, SN, devices=("cpu", "cpu"), **kw))


@pytest.mark.parametrize("kind", ["unconditional", "conditional"])
def test_sampler_devices_equal_one_device(samplers, kind):
    one, two = samplers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = {"kind": kind, "class_index": 1} if kind == "conditional" else {}
        a, b = one.sample(8, seed=5, **kw), two.sample(8, seed=5, **kw)
    finally:
        torch.set_num_threads(n)
    assert len(two.devices) == 2 and len(two._replicas) == 2
    for x, y in zip(a, b):
        assert x.shape == (8, one.in_channels, one.input_length)
        np.testing.assert_array_equal(x, y)


def test_decoding_noise_is_what_decoding_draws(samplers):
    one, _ = samplers
    noise = tmg.decoding_noise(one.mg_spec, 4, torch.Generator().manual_seed(5), "cpu")
    assert noise["l"][0].shape == (one.mg_spec.T_l, 4, one.mg_spec.tokens_l,
                                   one.mg_spec.mask_token_l)
    for x, y in zip(one.sample(4, seed=5), one.sample(4, seed=5, noise=[noise])):
        np.testing.assert_array_equal(x, y)


def test_sampler_devices_need_a_dividing_batch():
    from test_torch_sampler import CFG as SAMPLER_CFG, C as SC, L as SL, N_CLASSES as SN
    from tvqvae_tpu_torch.generation import TrainedModelSampler

    with pytest.raises(ValueError, match="divide"):
        TrainedModelSampler.from_init(Config.from_dict(SAMPLER_CFG), SL, SC, SN, device="cpu",
                                      batch_size=3, devices=("cpu", "cpu"))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI over stages 1-3 (three steps each): its defaults, and
    ``--host_data --no_precompute``."""
    import json

    from test_torch_sampler import CFG as SAMPLER_CFG
    from tvqvae_tpu_torch.scripts import train

    root = tmp_path_factory.mktemp("cli")
    X, y = tdata.make_synthetic_trajectories(n=24, channels=C, length=L, n_classes=N_CLASSES,
                                             seed=1)
    data = str(root / "d.npz")
    tdata.save_npz(data, X, y)
    cfg = str(root / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({**SAMPLER_CFG, "dataset": {"batch_sizes": {"stage1": 4, "stage2": 4,
                                                               "stage3": 4}}}, f)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, flags in (("default", []), ("host", ["--host_data", "--no_precompute"])):
            d = root / name
            train.main(["--dataset_file", data, "--config", cfg, "--stage", "all", "--max_steps",
                        "3", "--device", "cpu", "--no_val_metrics", "--model_save_dir",
                        str(d / "models"), "--run_dir", str(d / "runs"), *flags])
            out[name] = {s: dict(tckpt._flatten(tckpt.load_checkpoint(
                str(d / "models" / "d" / f"stage{s}"))[0])) for s in "123"}
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("stage", ["1", "2", "3"])
def test_cli_host_data_and_no_precompute_equal_the_defaults(cli_runs, stage):
    a, b = cli_runs["default"][stage], cli_runs["host"][stage]
    assert set(a) == set(b) and len(a) > 3
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"stage{stage} {k}")


def test_cli_flags_reach_the_runners(monkeypatch, tmp_path):
    from tvqvae_tpu_torch.scripts import train

    seen = {}
    for name in ("train_stage1", "train_stage2", "train_stage3"):
        monkeypatch.setattr(runner, name, lambda *a, _n=name, **kw: seen.setdefault(_n, kw))
    monkeypatch.setattr(runner, "load_stage1_bundle", lambda *a, **kw: (None, None, None))
    X, y = tdata.make_synthetic_trajectories(n=8, channels=C, length=L, seed=1)
    tdata.save_npz(str(tmp_path / "d.npz"), X, y)
    train.main(["--dataset_file", str(tmp_path / "d.npz"), "--device", "cpu", "--no_val_metrics",
                "--model_save_dir", str(tmp_path / "m"), "--run_dir", str(tmp_path / "r"),
                "--host_data", "--no_precompute"])
    assert seen["train_stage1"]["data_on_device"] is False
    assert seen["train_stage2"]["precompute"] is False
    assert seen["train_stage3"]["precompute"] is False


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
