"""Stage-3 training of both packages at the quality run's geometry, on the CPU.

The fidelity enhancer of the JAX package (``tvqvae_tpu``) and of the
PyTorch port (``tvqvae_tpu_torch``) trained side by side on the quality
run's data (``tvqvae_tpu_torch/scripts/quality_run.py::DATA``: 1200
synthetic series, C=4, L=512; 1080 train, 120 test) over one fixed stage 1
at the quality run's config (hid_dim 64), with the production recipe
(bfloat16 stream, ``fast_norm``, ``bf16_mu``), B=16, dropout 0.5, the
warmup-cosine schedule, 1000 steps. Reads both packages, writes only under
``--workdir``:

    python tools/stage3_fidelity_experiment.py --workdir build/fe_exp --part stage1
    python tools/stage3_fidelity_experiment.py --workdir build/fe_exp --part jax --seed 0
    python tools/stage3_fidelity_experiment.py --workdir build/fe_exp --part port --seed 0
    python tools/stage3_fidelity_experiment.py --workdir build/fe_exp --part arm_a
    python tools/stage3_fidelity_experiment.py --workdir build/fe_exp --part report

(``--part all`` runs them in that order, seeds 0-2.) The parts:

  - ``stage1``: the port trains stage 1 on the CPU for ``--stage1_minutes``
    (the step count from a timed probe after a warm-up: 12 steps less 4),
    writes it as the port's checkpoint and, unchanged (the JAX tree
    layout), as the JAX package's; computes x' (the tau = 0 round trip) of
    both splits in both packages and records their distance and the
    stage-1 reconstruction error. Every stage-3 run below trains on the port's x' of the train
    split (each runner's own sweep is replaced by it), so both packages
    see the same (x, x') pairs; a near-tie in the trained codebooks moves
    a token between the packages' own sweeps.
  - ``jax --seed s``: the JAX runner ``train_stage3(seed=s)`` (its own init,
    its device batch order ``device_epoch_indices(key(s + 2))``, its dropout
    keys from ``key(s + 1)``), the loss of every step. With ``--port_init``
    (the converse of arm (c)): from the port runner's init at seed s
    (``utils/convert.py::fe_to_jax``), JAX's own order and keys kept.
    With ``--init_seed i`` (the init-only arm): the runner stays at seed s
    (its order and dropout keys) and starts from the init draw i, JAX's
    runner's (``init_stage3(key(i))``) or, with ``--port_init``, the port
    runner's (``torch.Generator().manual_seed(i)``): the runs ``init_jax_si``
    and ``init_port_si``, so the init alone varies between the two sides.
  - ``port --seed s``: the port's runner ``train_stage3(seed=s)`` (its own
    init, ``_batch_order``, its generator), the loss of every step. With
    ``--jax_init`` (arm (c)): from the JAX runner's init at seed s, the
    port's own order and generator kept.
  - ``arm_a``: the port's runner from JAX's seed-0 init, on JAX's seed-0
    batches, with the dropout masks of JAX's seed-0 steps handed to
    ``fidelity_enhancer.dropout`` (``tests/test_torch_stage3_dropout.py``'s
    recording), to set beside ``jax --seed 0``.
  - ``gen --ckpt_dir DIR --seed s``: the quality run's generated series,
    sampled on the CPU from the stage 1 and stage 2 a quality run wrote
    under ``DIR`` (``models/qr`` of its workdir, e.g. trained on the card),
    as the quality run samples them (``--n_eval`` series, seed 1 + s), and
    that run's own enhancer as the run ``card``. With ``stage1
    --stage1_ckpt DIR/stage1`` the stage-3 runs train over that same stage
    1, so every enhancer can be scored on those samples.
  - ``report``: for every trained enhancer, each scored in its own package
    in float32: the held-out L1 of FE(x'_test) against x_test, the ROCKET
    FID (the port's ``Metrics``, against the train split) of FE(x'_test)
    beside x'_test's, with ``gen`` run the FID of FE(generated) beside the
    generated series' own (the quality run's ``fid_gen_fe`` and
    ``fid_gen``), and the mean loss over the 20 steps ending at steps 100,
    250, 500 and 1000. -> ``report.json``.
  - ``rounding``: the bfloat16 step-1 gradient's gaps between the port,
    JAX's step compiled as written and JAX's default jit (small shapes).
  - ``bias_order --device cuda``: on the card, without JAX, whether its
    convs round the bias as flax does.
  - ``init_law``: the enhancer's init against flax's at the published
    widths and the quality geometry (L=512, the recipe's bfloat16 stream),
    256 draws a side (JAX's runner's ``init_stage3(key(i))``, the port
    runner's from ``Generator().manual_seed(i)``, i = 0..255): per leaf
    of >= 256 elements KS of the values and of the per-output-channel norms,
    the means and the tail shares beyond 1.5 std in standard errors, and
    each side's one-sample KS against the exact law (a normal cut at +-2,
    scaled to 1/sqrt(fan_in)); on 16 train rows and their x' (rows drawn
    with ``--seed``), dropout 0, the KS p of ||FE(x') - x'|| / ||x'||, each
    level's output std, the step-1 loss and the gradient norm
    (``tests/test_torch_stage3_init_law.py``'s helpers). -> ``init_law.json``,
    and every draw's statistics -> ``init_law_draws.json``; ``--first_draw
    k`` takes seeds k..k+255 (``init_law_from<k>.json``).
  - ``stats``: from ``report.json``, each side's medians and Mann-Whitney's
    p between the sides; with ``init_law_draws.json``, Spearman's rho
    between each statistic of a run's init draw and the run's scores, over
    the init-only arm's runs. -> ``stats.json``.

Set ``--threads`` (torch) and ``XLA_FLAGS`` to share the cores between
parts run side by side.
"""

import argparse
import functools
import json
import os
import re
import shutil
import sys
import time

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

RECIPE = dict(compute_dtype="bfloat16", fast_norm=True, bf16_mu=True)
# the arms' runs: each package's own (b), the port from JAX's init (c), JAX
# from the port's init (the converse of (c)), and JAX's runner at one seed from
# either package's init draw (the init-only arm)
SIDES = ("jax", "port", "port_jinit", "jax_pinit", "init_jax", "init_port")
LOSS_AT = (100, 250, 500, 1000)
INIT_LAW_DRAWS = 256  # init_law: draws a side


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _paths(wd):
    return {"data": os.path.join(wd, "qr.npz"), "cfg": os.path.join(wd, "cfg.json"),
            "s1": os.path.join(wd, "stage1.npz"), "s1_jax": os.path.join(wd, "stage1_jax"),
            "xprime": os.path.join(wd, "xprime.npz")}


def _configs(wd):
    from tvqvae_tpu.config import Config as JConfig
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.scripts.quality_run import CFG_OVERRIDES

    return JConfig.from_dict(CFG_OVERRIDES), Config.from_dict(CFG_OVERRIDES)


def _data(wd):
    """The quality run's splits (the port's ``get_data``) and the JAX package's."""
    from tvqvae_tpu.data.dataset import DatasetSplits as JSplits
    from tvqvae_tpu_torch.data import get_data

    _, cfg = _configs(wd)
    data = get_data(_paths(wd)["data"], cfg.dataset.features, scale=cfg.dataset.data_scaling)
    jdata = JSplits(data.X_train, data.y_train, data.X_test, data.y_test, data.scaler,
                    data.n_classes)
    return data, jdata


def _write(wd, name, obj):
    with open(os.path.join(wd, name), "w") as f:
        json.dump(obj, f, indent=1)
    print(f"[{name}] " + json.dumps({k: v for k, v in obj.items() if k != "loss"}), flush=True)


def part_stage1(args):
    import torch

    from tvqvae_tpu.data import make_synthetic_trajectories as j_make
    from tvqvae_tpu.train import runner as jrunner
    from tvqvae_tpu.train import stage3 as jst3
    from tvqvae_tpu.utils import checkpoint as jckpt
    from tvqvae_tpu_torch.data import make_synthetic_trajectories, save_npz
    from tvqvae_tpu_torch.scripts.quality_run import CFG_OVERRIDES, DATA
    from tvqvae_tpu_torch.train import runner
    from tvqvae_tpu_torch.train.stage3 import precompute_xprime_dataset
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint

    torch.set_num_threads(args.threads)
    wd, p = args.workdir, _paths(args.workdir)
    X, y = make_synthetic_trajectories(**DATA)
    jX, jy = j_make(**DATA)
    assert np.array_equal(X, jX) and np.array_equal(y, jy), "the two packages' sets differ"
    save_npz(p["data"], X, y)
    with open(p["cfg"], "w") as f:
        json.dump(CFG_OVERRIDES, f, indent=1)
    jcfg, cfg = _configs(wd)
    data, _ = _data(wd)

    if args.stage1_ckpt:  # a stage 1 trained elsewhere, e.g. by a quality run on the card
        for ext in ("", ".meta.json"):
            shutil.copyfile(args.stage1_ckpt + ext, p["s1"] + ext)
    probe, steps, s1_min = [], None, None
    for n in (2, 4, 12) if not args.stage1_ckpt else ():  # the first call warms up
        t0 = time.time()
        runner.train_stage1(cfg, data, max_steps=n, device="cpu", log_interval=10**9)
        probe.append(time.time() - t0)
    if probe:
        probe = (probe[2] - probe[1]) / 8
        steps = max(int(args.stage1_minutes * 60 / probe), 10)
        t0 = time.time()
        runner.train_stage1(cfg, data, max_steps=steps, device="cpu", save_path=p["s1"],
                            resume=False, log_interval=10**9)
        s1_min = (time.time() - t0) / 60
    tree, meta = load_checkpoint(p["s1"])
    jckpt.save_checkpoint(p["s1_jax"], tree, meta=meta)

    frozen, _, _ = runner.load_stage1_bundle(cfg, p["s1"], device="cpu")
    xp = {k: precompute_xprime_dataset(frozen, getattr(data, f"X_{k}"), batch_size=32)
          for k in ("train", "test")}
    model, jfrozen, _, _ = jrunner.load_stage1_bundle(jcfg, p["s1_jax"])
    jxp = {k: np.asarray(jst3.precompute_xprime_dataset(model, jfrozen, getattr(data, f"X_{k}"),
                                                         batch_size=32))
           for k in ("train", "test")}
    np.savez(p["xprime"], **xp)
    scale = float(np.abs(xp["train"]).max())
    _write(wd, "stage1.json", {
        "stage1_steps": steps if steps else int(np.asarray(tree["step"])),
        "stage1_from": args.stage1_ckpt or "this run", "stage1_minutes": s1_min,
        "probe_s_per_step": probe or None,
        "xprime_jax_vs_port_of_scale": max(float(np.abs(xp[k] - jxp[k]).max()) for k in xp) / scale,
        "xprime_jax_vs_port_mean_abs": float(np.mean([np.abs(xp[k] - jxp[k]).mean() for k in xp])),
        "recon_l1_test": float(np.abs(xp["test"] - data.X_test).mean()),
        "recon_mse_test": float(np.square(xp["test"] - data.X_test).mean()),
        "recon_l1_train": float(np.abs(xp["train"] - data.X_train).mean()),
        "threads": torch.get_num_threads()})


class _Losses:
    def __init__(self):
        self.loss = {}

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.loss[int(step)] = float(metrics["train/loss"])

    def close(self):
        pass


def _xprime_train(wd):
    return np.load(_paths(wd)["xprime"])["train"]


def _port_init(wd, seed):
    """The port runner's enhancer init at ``seed`` (``init_stage3`` from
    ``torch.Generator().manual_seed(seed)``, the recipe's modules) as a JAX
    params tree."""
    import torch

    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.train.stage3 import init_stage3
    from tvqvae_tpu_torch.utils import convert

    _, cfg = _configs(wd)
    data, _ = _data(wd)
    fe = FidelityEnhancer.from_config(cfg, data.input_length, data.in_channels,
                                      RECIPE["compute_dtype"], RECIPE["fast_norm"])
    return convert.fe_to_jax(init_stage3(fe, torch.Generator().manual_seed(seed), "cpu"))


def _jax_run_init(args):
    """-> (the JAX run's name, the init tree it starts from, None for the
    runner's own init at ``--seed``)."""
    if args.init_seed is None:
        if args.port_init:
            return f"jax_pinit_s{args.seed}", _port_init(args.workdir, args.seed)
        return f"jax_s{args.seed}", None
    i = args.init_seed
    if args.port_init:
        return f"init_port_s{i}", _port_init(args.workdir, i)
    return f"init_jax_s{i}", _jax_init(args.workdir, i)[1]


def part_jax(args):
    jax = _jax()
    import jax.numpy as jnp

    from tvqvae_tpu.train import runner as jrunner
    from tvqvae_tpu.train import stage3 as jst3

    wd, p, seed = args.workdir, _paths(args.workdir), args.seed
    name, tree = _jax_run_init(args)
    jcfg, _ = _configs(wd)
    _, jdata = _data(wd)
    rec = _Losses()
    loop, sweep, xprime = jrunner._loop, jst3.precompute_xprime_dataset, _xprime_train(wd)
    init = jrunner.init_stage3
    jrunner._loop = functools.partial(loop, log_interval=1)  # the loss of every step
    jst3.precompute_xprime_dataset = lambda *a, keep_on_device=False, **k: (
        jnp.asarray(xprime) if keep_on_device else xprime)
    if tree is not None:
        tree = jax.tree.map(jnp.asarray, tree)
        jrunner.init_stage3 = lambda rng, fe, x: tree
    t0 = time.time()
    try:
        jrunner.train_stage3(jcfg, jdata, p["s1_jax"], os.path.join(wd, name),
                             logger=rec, max_steps=args.steps, seed=seed, resume=False,
                             **RECIPE)
    finally:
        jrunner._loop, jst3.precompute_xprime_dataset = loop, sweep
        jrunner.init_stage3 = init
    _write(wd, f"{name}.json", {"seed": seed, "init_seed": args.init_seed,
                                "minutes": (time.time() - t0) / 60, "loss": rec.loss})


def _port_run(args, name, seed, patch=None):
    import torch

    from tvqvae_tpu_torch.train import runner

    torch.set_num_threads(args.threads)
    wd, p = args.workdir, _paths(args.workdir)
    _, cfg = _configs(wd)
    data, _ = _data(wd)
    frozen, _, _ = runner.load_stage1_bundle(cfg, p["s1"], device="cpu")
    rec = _Losses()
    sweep, xprime = runner.precompute_xprime_dataset, torch.from_numpy(_xprime_train(wd))
    runner.precompute_xprime_dataset = lambda *a, keep_on_device=False, **k: (
        xprime if keep_on_device else xprime.numpy())
    t0 = time.time()
    undo = patch() if patch else (lambda: None)
    try:
        runner.train_stage3(cfg, data, frozen, max_steps=args.steps, seed=seed, logger=rec,
                            log_interval=1, device="cpu", resume=False,
                            save_path=os.path.join(wd, f"{name}.npz"), **RECIPE)
    finally:
        undo()
        runner.precompute_xprime_dataset = sweep
    _write(wd, f"{name}.json", {"seed": seed, "minutes": (time.time() - t0) / 60,
                                "threads": torch.get_num_threads(), "loss": rec.loss})


def _jax_init(wd, seed):
    """-> (the JAX runner's enhancer, its init at ``seed``, the splits, the
    port's config)."""
    jax = _jax()
    import jax.numpy as jnp

    from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFE
    from tvqvae_tpu.train.stage3 import init_stage3 as j_init_stage3

    jcfg, cfg = _configs(wd)
    data, _ = _data(wd)
    _, C, L = data.X_train.shape
    f = jcfg.fidelity_enhancer
    jfe = JFE(input_length=L, in_channels=C, dim=f.dim, dim_mults=tuple(f.dim_mults),
              resnet_block_groups=f.resnet_block_groups, dropout=f.dropout, **{
                  k: RECIPE[k] for k in ("compute_dtype", "fast_norm")})
    B = cfg.dataset.batch_sizes["stage3"]
    j_init = jax.device_get(j_init_stage3(jax.random.key(seed), jfe,
                                          jnp.asarray(data.X_train[:min(4, B)])))
    return jfe, j_init, data, cfg


def _init_from(j_init):
    """Stands in for the port runner's ``init_stage3``: the given JAX tree."""
    from tvqvae_tpu_torch.utils import convert

    def init_stage3(fe, generator, dev):
        fe.load_state_dict(convert.fe_from_jax(j_init))
        return fe.to(dev)

    return init_stage3


def part_port(args):
    """The port's runner at ``--seed``; with ``--jax_init`` from the JAX
    runner's init at that seed, its own batch order and stream kept."""
    if not args.jax_init:
        return _port_run(args, f"port_s{args.seed}", args.seed)
    from tvqvae_tpu_torch.train import runner

    init = _init_from(_jax_init(args.workdir, args.seed)[1])

    def patch():
        saved, runner.init_stage3 = runner.init_stage3, init

        def undo():
            runner.init_stage3 = saved

        return undo

    _port_run(args, f"port_jinit_s{args.seed}", args.seed, patch)


def part_arm_a(args):
    """The port's runner on JAX's seed-0 init, batches and dropout masks."""
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from chip_smoke import MaskTape
    from test_torch_stage3_dropout import dropout_key, mask_collector, to_port_masks
    from tvqvae_tpu.train import runner as jrunner
    from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
    from tvqvae_tpu_torch.train import runner

    seed = 0
    jfe, j_init, data, cfg = _jax_init(args.workdir, seed)
    N, C, L = data.X_train.shape
    B = cfg.dataset.batch_sizes["stage3"]
    # the JAX runner's batch order and dropout keys at this seed
    key = jax.random.key(seed + 2)
    order = np.stack([np.asarray(jrunner.device_epoch_indices(key, s, N, B))
                      for s in range(args.steps)])
    collect, rk, zeros = mask_collector(jfe), jax.random.key(seed + 1), jnp.zeros((B, C, L))
    tape, steps = MaskTape(torch), []

    def patch():
        saved = runner.init_stage3, runner._batch_order, runner.make_stage3_train_step_pre
        saved_dropout = tfe.dropout

        def make_step():  # each step takes the masks of JAX's step, every one of them
            step = saved[2]()

            def run(state, *a):
                tape.load(to_port_masks(collect(j_init, zeros, dropout_key(rk, len(steps)))))
                out = step(state, *a)
                steps.append(tape.pos)
                assert tape.pos == len(tape.masks), (len(steps), tape.pos, len(tape.masks))
                return out

            return run

        runner.init_stage3 = _init_from(j_init)
        runner._batch_order = lambda n, b, steps, s, dev: torch.from_numpy(order[:steps]).to(dev)
        runner.make_stage3_train_step_pre = make_step
        tfe.dropout = tape

        def undo():
            runner.init_stage3, runner._batch_order, runner.make_stage3_train_step_pre = saved
            tfe.dropout = saved_dropout
            assert len(steps) == args.steps, (len(steps), args.steps)

        return undo

    _port_run(args, "arm_a", seed, patch)


def part_rounding(args):
    """The step-1 gradient of the precomputed-x' step in the production
    recipe (dropout 0, B=3, L=48 at dim_mults (1,) and L=64 at (1, 2, 4, 8),
    weights drawn with numpy, seeds 0-2): the median leaf's gap (max error
    over the leaf's max) between the port, JAX's step compiled as written
    (``xla_allow_excess_precision`` off) and as ``jax.jit`` compiles it by
    default, and each package's float32 step. -> ``rounding.json``."""
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from test_torch_parallel import _random_tree
    from test_torch_precision import gap
    from test_torch_precision_paths import jit_as_written
    from tvqvae_tpu.models import fidelity_enhancer as jfe
    from tvqvae_tpu.train import stage3 as jst3
    from tvqvae_tpu.train.optim import adamw as j_adamw
    from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
    from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
    from tvqvae_tpu_torch.train import stage3 as tst3
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.utils import convert
    from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

    torch.set_num_threads(args.threads)
    C, B, rows = 4, 3, []
    tx = j_adamw(j_schedule(1e-3, 100, 0.1), weight_decay=0.01)
    t_tx = functools.partial(adamw, learning_rate=warmup_cosine_schedule(1e-3, 100, 0.1),
                             weight_decay=0.01)
    for mults, L in (((1,), 48), ((1, 2, 4, 8), 64)):
        kw = dict(dim=8, dim_mults=mults, resnet_block_groups=4, dropout=0.0, fast_norm=True)
        for seed in (0, 1, 2):
            def jm(dt):
                return jfe.FidelityEnhancer(input_length=L, in_channels=C, compute_dtype=dt, **kw)

            shapes = jax.eval_shape(lambda: jm("float32").init(
                {"params": jax.random.key(0)}, jnp.zeros((B, C, L)), False))["params"]
            params = _random_tree(shapes, np.random.default_rng(seed))
            d = np.random.default_rng(seed + 100)
            x = d.normal(size=(B, C, L)).astype(np.float32)
            xp = (0.8 * x + 0.3 * d.normal(size=x.shape)).astype(np.float32)
            grads = {}
            for name, dt, jit in (("jax_as_written", "bfloat16", jit_as_written),
                                  ("jax_jit", "bfloat16", jax.jit),
                                  ("jax_f32", "float32", jax.jit)):
                st = jit(jst3.make_stage3_train_step_pre(jm(dt), tx))(
                    jst3.create_stage3_state(params, tx), jnp.asarray(x), jnp.asarray(xp),
                    jax.random.key(0))[0]
                grads[name] = convert.fe_from_jax(jax.tree.map(
                    lambda m: np.asarray(m, np.float32) / 0.1, jax.device_get(st.opt_state[0].mu)))
            for name, dt in (("port", "bfloat16"), ("port_f32", "float32")):
                fe = tfe.FidelityEnhancer(L, C, compute_dtype=dt, **kw)
                fe.load_state_dict(convert.fe_from_jax(params))
                st = tst3.create_stage3_state(fe, t_tx)
                tst3.make_stage3_train_step_pre()(st, torch.from_numpy(x), torch.from_numpy(xp))
                grads[name] = {k: p.grad for k, p in st.fe.named_parameters()}
            row = {"dim_mults": list(mults), "seed": seed}
            for a, b in (("port", "jax_as_written"), ("port", "jax_jit"),
                         ("jax_jit", "jax_as_written"), ("jax_as_written", "jax_f32"),
                         ("port", "port_f32"), ("port_f32", "jax_f32")):
                row[f"{a}~{b}"] = float(np.median([gap(grads[a][k], grads[b][k])
                                                   for k in grads[b]]))
            rows.append(row)
            print(json.dumps(row), flush=True)
    _write(args.workdir, "rounding.json", {"rows": rows})


def part_gen(args):
    """The quality run's generated series from ``--ckpt_dir``'s stages 1-2,
    and its enhancer's checkpoint as the run ``card``."""
    import torch

    from tvqvae_tpu_torch.generation import TrainedModelSampler

    torch.set_num_threads(args.threads)
    wd, d = args.workdir, args.ckpt_dir
    _, cfg = _configs(wd)
    sampler = TrainedModelSampler.from_checkpoints(
        cfg, os.path.join(d, "stage1"), os.path.join(d, "stage2"), batch_size=64, device="cpu")
    t0 = time.time()
    _, _, xgen = sampler.sample(args.n_eval, seed=1 + args.seed)
    np.savez(os.path.join(wd, "xgen.npz"), xgen=xgen)
    shutil.copyfile(os.path.join(d, "stage3"), os.path.join(wd, "card.npz"))
    _write(wd, "card.json", {"seed": args.seed, "ckpt_dir": d, "n": len(xgen),
                             "sample_minutes": (time.time() - t0) / 60, "minutes": None,
                             "loss": {}})


def _smoothed(loss, at, window=20):
    vals = [loss[str(s)] if str(s) in loss else loss.get(s) for s in range(at - window + 1, at + 1)]
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else None


def part_report(args):
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFE
    from tvqvae_tpu.utils import checkpoint as jckpt
    from tvqvae_tpu_torch.evaluation import Metrics
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.utils import convert
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint

    torch.set_num_threads(args.threads)
    wd, p = args.workdir, _paths(args.workdir)
    jcfg, cfg = _configs(wd)
    data, _ = _data(wd)
    N, C, L = data.X_test.shape
    xp = np.load(p["xprime"])["test"]
    metrics = Metrics(L, C, data.n_classes, cfg.evaluation.batch_size, data.X_train,
                      data.X_test, feature_extractor_type="rocket", fid_method="svd",
                      device="cpu")
    f = jcfg.fidelity_enhancer
    jfe = JFE(input_length=L, in_channels=C, dim=f.dim, dim_mults=tuple(f.dim_mults),
              resnet_block_groups=f.resnet_block_groups, dropout=f.dropout)
    japply = jax.jit(lambda prm, x: jfe.apply({"params": prm}, x, False))

    gen = os.path.join(wd, "xgen.npz")
    xgen = np.load(gen)["xgen"] if os.path.exists(gen) else None

    def fid(x):
        return metrics.fid_score(metrics.z_train, metrics.z_gen_fn(x))

    def score(enhance):
        out = enhance(xp)
        res = {"heldout_l1": float(np.abs(out - data.X_test).mean()),
               "fid_fe_xprime_test": fid(out)}
        if xgen is not None:
            res["fid_gen_fe"] = fid(enhance(xgen))
        return res

    rep = {"fid_xprime_test": fid(xp),
           "fid_gen": None if xgen is None else fid(xgen),
           "fid_x_test": metrics.fid_score(metrics.z_train, metrics.z_test),
           "heldout_l1_xprime": float(np.abs(xp - data.X_test).mean()), "runs": {}}
    with open(os.path.join(wd, "stage1.json")) as fh:
        rep["stage1"] = json.load(fh)
    for name in sorted(os.listdir(wd)):
        if not re.fullmatch(r"(jax_s\d+|jax_pinit_s\d+|port_s\d+|port_jinit_s\d+"
                            r"|init_(jax|port)_s\d+|arm_a|card)\.json", name):
            continue
        run = name[:-5]
        with open(os.path.join(wd, name)) as fh:
            log = json.load(fh)
        if run.startswith(("jax", "init_")):  # the JAX runner's checkpoints
            prm = jckpt.load_checkpoint(os.path.join(wd, run))[0]["params"]

            def enhance(x):
                return np.concatenate([np.asarray(japply(prm, jnp.asarray(x[i:i + 64])))
                                       for i in range(0, len(x), 64)])
        else:
            fe = FidelityEnhancer.from_config(cfg, L, C).eval()
            fe.load_state_dict(convert.fe_from_jax(
                load_checkpoint(os.path.join(wd, run + ".npz"))[0]["params"]))

            def enhance(x):
                with torch.no_grad():
                    return np.concatenate([fe(torch.from_numpy(x[i:i + 64])).numpy()
                                           for i in range(0, len(x), 64)])
        rep["runs"][run] = {**score(enhance), "minutes": log["minutes"],
                            **{f"loss_{s}": _smoothed(log["loss"], s) for s in LOSS_AT}}
        print(run, json.dumps(rep["runs"][run]), flush=True)
    for side in SIDES:
        runs = [v for k, v in rep["runs"].items() if k.startswith(side + "_s")]
        if runs:
            rep[side + "_seeds"] = {m: [min(r[m] for r in runs), float(np.mean([r[m] for r in runs])),
                                        max(r[m] for r in runs)]
                                    for m in ("heldout_l1", "fid_fe_xprime_test", "fid_gen_fe",
                                              "loss_1000")
                                    if all(r.get(m) is not None for r in runs)}
    with open(os.path.join(wd, "report.json"), "w") as fh:
        json.dump(rep, fh, indent=1)
    print("REPORT " + json.dumps({k: v for k, v in rep.items() if k != "runs"}), flush=True)


def part_bias_order(args):
    """On ``--device`` (no JAX): whether a bfloat16 conv or dense given its
    bias rounds as the port's layers round (the product rounded, then the
    bias added, as flax adds it). At the quality run's shapes: the
    enhancer's k7 stem, k3 and k1 convs and the stage-1 head's dense, each
    fused call against product + bias, and the production enhancer's
    output (seeded weights, biases N(0, 0.1), B=16) with the port's convs
    against the same convs given the bias in the call.
    -> ``bias_order.json``."""
    import torch
    import torch.nn.functional as F

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models import layers
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.scripts.quality_run import CFG_OVERRIDES

    dev, bf = args.device, torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    ops = {"stem conv k7, 4->8": (r(16, 4, 512), r(8, 4, 7, scale=0.2), 1,
                                  lambda x, w, b: F.conv1d(x, w, b, padding=3)),
           "conv k3, 8->8": (r(16, 8, 512), r(8, 8, 3, scale=0.2), 1,
                             lambda x, w, b: F.conv1d(x, w, b, padding=1)),
           "conv k1, 16->8": (r(16, 16, 512), r(8, 16, 1, scale=0.25), 1, F.conv1d),
           "dense 512->512": (r(16, 4, 512), r(512, 512, scale=0.04), 0, F.linear)}
    rep = {"device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu", "ops": {}}
    for name, (x, w, chan_first, f) in ops.items():
        b = r(w.shape[0]).to(bf)
        x, w = x.to(bf), w.to(bf)
        fused = f(x, w, b)
        split = f(x, w, None) + (b[:, None] if chan_first else b)
        rep["ops"][name] = {"equal": bool(torch.equal(fused, split)),
                            "share_differing": float((fused != split).float().mean()),
                            "max_abs": float((fused.float() - split.float()).abs().max())}

    fe = FidelityEnhancer.from_config(Config.from_dict(CFG_OVERRIDES), 512, 4,
                                      compute_dtype="bfloat16", fast_norm=True)
    fe = layers.init_weights_(fe, torch.Generator().manual_seed(1))
    with torch.no_grad():  # the init's biases are 0, a trained enhancer's are not
        for m in fe.modules():
            if isinstance(m, layers._CastAtCall) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    fe = fe.to(dev).eval()
    x = r(16, 4, 512)
    with torch.no_grad():
        ours = fe(x)
        cast_call = layers._CastAtCall._cast_call

        def fused_call(self, x, w):
            dt = self.compute_dtype
            return self._functional(layers.cast_to(x, dt), layers.cast_to(w, dt),
                                    layers.cast_to(self.bias, dt))

        layers._CastAtCall._cast_call = fused_call
        try:
            fused = fe(x)
        finally:
            layers._CastAtCall._cast_call = cast_call
    rep["enhancer"] = {"equal": bool(torch.equal(ours, fused)),
                       "max_abs": float((ours - fused).abs().max()),
                       "scale": float(ours.abs().max())}
    _write(args.workdir, "bias_order.json", rep)


def part_stats(args):
    """From ``report.json``: each side's median, min and max of every
    metric, and Mann-Whitney's two-sided p between the sides."""
    from scipy.stats import mannwhitneyu

    with open(os.path.join(args.workdir, "report.json")) as fh:
        runs = json.load(fh)["runs"]
    sides = {side: [v for k, v in runs.items() if re.fullmatch(side + r"_s\d+", k)]
             for side in SIDES}
    sides = {k: v for k, v in sides.items() if v}
    out = {}
    for m in ("heldout_l1", "fid_fe_xprime_test", "fid_gen_fe", *(f"loss_{s}" for s in LOSS_AT)):
        vals = {k: [r[m] for r in v if r.get(m) is not None] for k, v in sides.items()}
        out[m] = {k: {"n": len(v), "median": float(np.median(v)), "min": min(v), "max": max(v)}
                  for k, v in vals.items() if v}
        names = sorted(out[m])
        out[m]["p"] = {f"{a}~{b}": float(mannwhitneyu(vals[a], vals[b]).pvalue)
                       for i, a in enumerate(names) for b in names[i + 1:]}
    draws = os.path.join(args.workdir, "init_law_draws.json")
    if os.path.exists(draws):  # which property of an init draw goes with its run's scores
        from scipy.stats import spearmanr

        with open(draws) as fh:
            draws = json.load(fh)
        arm = [(draws[hit.group(1)], int(hit.group(2)), r) for k, r in runs.items()
               if (hit := re.fullmatch(r"init_(jax|port)_s(\d+)", k))]
        out["spearman"] = {}
        for stat in draws["jax"]:
            for m in ("fid_fe_xprime_test", "heldout_l1", "loss_1000"):
                pairs = [(d[stat][i], r[m]) for d, i, r in arm if r.get(m) is not None]
                if len(pairs) > 2:
                    rho, p = spearmanr(*zip(*pairs))
                    out["spearman"].setdefault(stat, {})[m] = {"rho": float(rho), "p": float(p),
                                                               "n": len(pairs)}
    _write(args.workdir, "stats.json", out)


def part_init_law(args):
    """The law of the enhancer's init and its function at init, both
    packages, ``INIT_LAW_DRAWS`` draws a side, at the published widths."""
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from scipy.stats import kstest, truncnorm

    import test_torch_stage3_init_law as law
    from test_torch_precision_paths import jit_as_written
    from tvqvae_tpu.train.stage3 import init_stage3 as j_init_stage3
    from tvqvae_tpu_torch.models.layers import TRUNCATED_NORMAL_STD
    from tvqvae_tpu_torch.utils import convert

    torch.set_num_threads(args.threads)
    wd, n = args.workdir, INIT_LAW_DRAWS
    _, cfg = _configs(wd)
    data, _ = _data(wd)
    f, L = cfg.fidelity_enhancer, data.input_length
    widths = dict(dim=f.dim, dim_mults=tuple(f.dim_mults),
                  resnet_block_groups=f.resnet_block_groups)
    recipe = {k: RECIPE[k] for k in ("compute_dtype", "fast_norm")}
    B = cfg.dataset.batch_sizes["stage3"]
    t0, first = time.time(), args.first_draw
    j_fe = law.jax_enhancer(L, widths, recipe)
    x0 = jnp.asarray(data.X_train[:min(4, B)])
    trees = law.jax_draws(law.jax_init(j_fe, x0), n, first)
    own = jax.device_get(j_init_stage3(jax.random.key(first + n - 1), j_fe, x0))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(trees[-1]),
                                                    jax.tree.leaves(own))), "not the runner's draws"
    fes = law.port_draws(lambda: law.port_enhancer(L, widths, recipe), n, first)
    ours = law.stacked([{k: v.detach() for k, v in fe.state_dict().items()} for fe in fes])
    ref = law.stacked([convert.fe_from_jax(t) for t in trees])
    leaves = law.leaf_law(ours, ref)
    for k, row in leaves.items():  # each side against the exact law: a scaled normal cut at +-2
        fan_in = int(np.prod(ref[k].shape[2:]))
        exact = truncnorm(-2.0, 2.0, scale=1.0 / (np.sqrt(fan_in) * TRUNCATED_NORMAL_STD)).cdf
        row["exact_ks"] = {side: float(kstest(v[k].ravel(), exact).pvalue)
                           for side, v in (("jax", ref), ("port", ours))}
    rows = np.sort(np.random.default_rng(args.seed).choice(len(data.X_train), B, replace=False))
    x, xp = data.X_train[rows], _xprime_train(wd)[rows]
    j_stats = law.jax_function_stats(jit_as_written(law.jax_stats_fn(j_fe, x, xp)), trees)
    t_stats = law.port_function_stats(fes, x, xp, law.port_levels(fes[0]))
    ps = law.function_law(t_stats, j_stats)

    def summary(v):
        return [float(np.median(v)), float(v.min()), float(v.max())]

    tag = f"_from{first}" if first else ""
    with open(os.path.join(wd, f"init_law{tag}_draws.json"), "w") as fh:
        json.dump({"jax": {k: v.tolist() for k, v in j_stats.items()},
                   "port": {k: v.tolist() for k, v in t_stats.items()}}, fh)
    _write(wd, f"init_law{tag}.json", {
        "n_draws": n, "first_draw": first, "widths": widths, "recipe": recipe, "input_length": L,
        "batch_rows": rows.tolist(), "threads": torch.get_num_threads(),
        "minutes": (time.time() - t0) / 60,
        "leaves_failed": {c: [k for k, r in leaves.items() if not law.leaf_passes(r, c)]
                          for c in law.LEAF_CHECKS},
        "leaves_min_p": {c: min(r[c] for r in leaves.values()) for c in ("ks", "channel_norms")},
        "leaves_max_abs_z": {c: max(abs(r[c]) for r in leaves.values()) for c in ("mean", "tails")},
        "exact_min_p": {side: min(r["exact_ks"][side] for r in leaves.values())
                        for side in ("jax", "port")},
        "function_failed": [k for k, p in ps.items() if p < law.P_MIN],
        "function_min_p": min(ps.values()),
        "function": {k: {"p": p, "jax": summary(j_stats[k]), "port": summary(t_stats[k])}
                     for k, p in ps.items()},
        "leaves": leaves})


PARTS = {"stage1": part_stage1, "jax": part_jax, "port": part_port, "arm_a": part_arm_a,
         "gen": part_gen, "report": part_report, "rounding": part_rounding,
         "bias_order": part_bias_order, "stats": part_stats, "init_law": part_init_law}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "fe_exp"))
    ap.add_argument("--part", choices=(*PARTS, "all"), default="all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--stage1_minutes", type=float, default=15.0)
    ap.add_argument("--threads", type=int, default=4, help="torch threads")
    ap.add_argument("--stage1_ckpt", help="stage1: take this stage-1 checkpoint (the port's "
                                          "format) instead of training one")
    ap.add_argument("--ckpt_dir", help="gen: a quality run's models/qr directory")
    ap.add_argument("--n_eval", type=int, default=1024, help="gen: series to sample")
    ap.add_argument("--device", default="cpu", help="bias_order: the device")
    ap.add_argument("--jax_init", action="store_true",
                    help="port: start from the JAX runner's init at --seed")
    ap.add_argument("--port_init", action="store_true",
                    help="jax: start from the port runner's init at --seed (or --init_seed)")
    ap.add_argument("--first_draw", type=int, default=0,
                    help="init_law: the first draw's seed (outputs tagged _from<k> unless 0)")
    ap.add_argument("--init_seed", type=int, default=None,
                    help="jax: start from the init draw at this seed (JAX's, or the port's "
                         "with --port_init), the runner kept at --seed")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.part != "all":
        return PARTS[args.part](args)
    part_stage1(args)
    for seed in (0, 1, 2):
        args.seed = seed
        part_jax(args)
        part_port(args)
    part_arm_a(args)
    part_report(args)


if __name__ == "__main__":
    main()
