"""Port parity: tensor parallelism (``tvqvae_tpu_torch/parallel/tp.py``).

A run of W ranks with ``tp`` = N must take the step one process takes on the
same global batch, with the big parameter leaves and their AdamW moments
held by each rank as 1/N slices between steps: the JAX package's 2-D
``(data, model)`` mesh, where GSPMD partitions the unchanged step from the
placement of its inputs.

  1. The rule, without a compile: for every leaf of the JAX package's
     stage-1 tree at the published width, its prior pair and its enhancer
     (``jax.eval_shape``), at ``tp`` 2 and 4 and floors 2^16 and 512, the
     port shards the leaf JAX's ``tp_leaf_spec`` shards, along the torch dim
     that ``utils/convert.py`` maps JAX's axis to. At the published width
     the rule splits 137,396,224 of stage 1's 181,404,532 parameters and
     leaves the two 4633 x 4633 TimeHead kernels whole, and splits no leaf
     of the enhancer (its largest holds 24,576 elements).
  2. Four gloo ranks (this file run as a script, one torch thread each)
     form a (2, 2) grid, then a (1, 4) grid, at ``tests/test_tp.py``'s
     floor of 512 elements, and step the JAX package's tiny stage 1
     (``test_torch_parallel.S1_CFG``) on the global batch of 8 rows: with
     SGD the loss, every parameter and the VQ codebooks within rtol 2e-4 /
     atol 1e-5 of JAX's one-device step; with AdamW the step-1 gradients
     within 1e-4 of each leaf's max |gradient| (``test_torch_parallel``'s
     rule, the biases that a train-mode BatchNorm cancels within 1e-5 of
     their weight's) and the moments gathered whole equal to optax's by the
     same rule (the second moment, 1e-3·g², to 2e-4 of its max); after the
     step over a quarter of the parameter bytes still split and every
     split parameter and moment its slice's shape.
  3. Three stage-2 and stage-3 steps on each grid, JAX's masking draws
     handed in, against JAX's one-device steps (``test_torch_parallel``'s
     ``jax_stage2`` and ``jax_stage3``): tokens equal, losses 1e-5 relative, step-1 gradients as in
     2, every leaf after the steps within 2e-4.
  4. ``train_stage1(tp=2)`` on the (2, 2) grid: the step-8 snapshot of a
     12-step run, resumed, ends bit-equal to the straight run; the snapshot
     holds whole tensors; the checkpoint is the JAX layout and loads
     through ``load_stage1_bundle``. The train CLI with ``--tp 2`` writes
     stages 1-3.
"""

import os
import pickle
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_parallel as tpar
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec
from tvqvae_tpu_torch.parallel import mesh, tp
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage2 as tst2
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step
from tvqvae_tpu_torch.utils import checkpoint as tckpt
from tvqvae_tpu_torch.utils import convert

REPO = tpar.REPO
W, G, C, L = 4, tpar.G, tpar.C, tpar.L
GRIDS = ((2, 2), (1, 4))
TEST_MIN_ELEMS = 512  # tests/test_tp.py's: the tiny models' leaves lie below 2^16
SGD_LR = 1e-2
PUB_L, PUB_C, PUB_CLASSES = 4633, 4, 4
RUN_STEPS, RUN_SNAPSHOT = 12, 8


# ---------------------------------------------------------------------------
# 1. the rule at the published width


@pytest.fixture(scope="module")
def published():
    """{tree: [(JAX leaf path, flax shape)], the port's module (meta)} for
    the stage-1 parameters, both priors and the enhancer."""
    import jax.numpy as jnp

    from tvqvae_tpu.config import Config as JConfig
    from tvqvae_tpu.models import maskgit as jmg
    from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFE
    from tvqvae_tpu.models.stage1 import Stage1Model as JModel, Stage1Spec as JSpec
    from tvqvae_tpu.models.vq import init_codebook
    from tvqvae_tpu.train import stage2 as jst2

    jcfg, cfg = JConfig(), Config()
    spec = JSpec.from_config(jcfg, PUB_L, PUB_C)
    model = JModel(spec)

    def init1():
        vq_l, vq_h = init_codebook(jax.random.key(1), spec.vq_l), init_codebook(jax.random.key(2),
                                                                                spec.vq_h)
        return model.init(jax.random.key(0), jnp.zeros((2, PUB_C, PUB_L)), vq_l, vq_h)

    t_l, t_h = jmg.build_transformers(jcfg, spec, PUB_CLASSES)
    mg = jmg.MaskGITSpec.from_config(jcfg, spec)
    f = jcfg.fidelity_enhancer
    fe = JFE(input_length=PUB_L, in_channels=PUB_C, dim=f.dim, dim_mults=tuple(f.dim_mults),
             resnet_block_groups=f.resnet_block_groups, dropout=f.dropout)
    s1 = jax.eval_shape(init1)["params"]
    s2 = jax.eval_shape(lambda: jst2.init_stage2(jax.random.key(0), t_l, t_h, mg))[0]
    s3 = jax.eval_shape(lambda: fe.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                        jnp.zeros((2, PUB_C, PUB_L)), False))["params"]

    def leaves(tree):
        return [(tuple(k.key for k in path), tuple(x.shape))
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]]

    pspec = Stage1Spec.from_config(cfg, PUB_L, PUB_C)
    with torch.device("meta"):
        p1 = Stage1Model(pspec)
        pl, ph = tmg.build_transformers(cfg, pspec, PUB_CLASSES)
        p3 = FidelityEnhancer.from_config(cfg, PUB_L, PUB_C)
    return {"stage1": [(leaves(s1), p1)],
            "priors": [(leaves(s2["l"]), pl), (leaves(s2["h"]), ph)],
            "enhancer": [(leaves(s3), p3)]}


def _torch_image(path, shape, axis):
    """The torch name of a JAX leaf and the dim ``utils/convert.py`` carries
    its ``axis`` to: a marker array, size 2 along ``axis`` and 1 elsewhere,
    through the converter."""
    name, arr = convert._param(path, np.zeros([2 if i == axis else 1 for i in range(len(shape))]))
    return name, (None if axis is None else arr.shape.index(2))


@pytest.mark.parametrize("min_elems", [2 ** 16, TEST_MIN_ELEMS])
@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("tree", ["stage1", "priors", "enhancer"])
def test_rule_equals_jax_at_the_published_width(published, tree, n_model, min_elems):
    from tvqvae_tpu.parallel.tp import tp_leaf_spec as jax_rule

    split = total = n_split = 0
    for leaves, module in published[tree]:
        plan = tp.tp_plan(module, n_model, min_elems)
        names = set()
        for path, shape in leaves:
            spec = jax_rule(jax.ShapeDtypeStruct(shape, np.float32), n_model, min_elems)
            axis = None if spec == P() else list(spec).index("model")
            name, dim = _torch_image(path, shape, axis)
            assert plan[name] == dim, (name, shape, spec)
            assert tp.tp_leaf_spec(shape, n_model, min_elems) == axis, name
            names.add(name)
            total += int(np.prod(shape))
            split += int(np.prod(shape)) if dim is not None else 0
            n_split += dim is not None
        assert names == set(plan)  # every parameter of the port is a leaf of JAX's tree
    # the published enhancer's largest leaf holds 24,576 elements: below the floor, whole
    assert n_split == 0 if (tree, min_elems) == ("enhancer", 2 ** 16) else n_split > 0
    if tree == "stage1" and min_elems == 2 ** 16:
        assert (split, total, n_split) == (137_396_224, 181_404_532, 70)
        plan = tp.tp_plan(published["stage1"][0][1], n_model)
        assert plan["head_l.Dense_0.weight"] is None and plan["head_h.Dense_0.weight"] is None


def test_leaf_spec_rules():
    """``tests/test_tp.py``'s cases of JAX's rule, against the port's."""
    assert tp.tp_leaf_spec((64, 64), 2, 512) == 1  # a Dense kernel: the trailing axis wins the tie
    assert tp.tp_leaf_spec((3, 4, 16, 64), 2, 512) == 3
    assert tp.tp_leaf_spec((8, 8), 2, 512) is None  # below the floor
    assert tp.tp_leaf_spec((33, 65), 2, 32) is None  # nothing divides
    assert tp.tp_leaf_spec((), 2, 0) is None


# ---------------------------------------------------------------------------
# 2-4. the ranks' side, run by each rank (and by nothing of JAX)


def _sgd(params):
    opt = torch.optim.SGD(params, lr=SGD_LR)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)


def _clone(sd):
    return {k: v.clone() for k, v in sd.items()}


def _slices_ok(modules, optimizer, full_shapes):
    """Every split parameter and each of its moments has the slice's shape."""
    ok, n = True, 0
    for m in modules:
        for k, p in m.named_parameters():
            s = getattr(p, "tp_shard", None)
            if s is None:
                continue
            n += 1
            want = list(full_shapes[id(m)][k])
            want[s.dim] //= s.count
            ok &= list(p.shape) == want
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v) and v.dim():
                    ok &= list(v.shape) == want
    return ok and n > 0


def _full_grads(module):
    return {k: tp.full_tensor(p, p.grad).clone() for k, p in module.named_parameters()}


def _whole(*modules):
    with tp.gathered(*modules):
        return [_clone(m.state_dict()) for m in modules]


def tp_stage1(inp, grid, adam):
    """One stage-1 step on the grid from JAX's weights: SGD or AdamW."""
    frozen = tpar._frozen(_clone(inp["sd"]), L)
    model = frozen.model.train().requires_grad_(True)
    state = create_stage1_state(model, frozen.vq_l, frozen.vq_h, tpar._tx() if adam else _sgd)
    shapes = {id(model): {k: tuple(p.shape) for k, p in model.named_parameters()}}
    with grid:
        tp.shard_train_state_tp(state, TEST_MIN_ELEMS)
        _, m = make_stage1_train_step()(state, torch.from_numpy(mesh.shard_batch(inp["xs"][0])))
        out = {"loss": mesh.all_reduce_metrics(m)["loss"].item(),
               "fraction": tp.sharded_fraction(model),
               "slices": _slices_ok([model], state.optimizer, shapes)}
        if adam:
            out["grads"] = _full_grads(model)
            out["mu"], out["nu"] = ({k: tp.full_tensor(p, state.optimizer.state[p][key]).clone()
                                     for k, p in model.named_parameters()}
                                    for key in ("exp_avg", "exp_avg_sq"))
        final, = _whole(model)
    for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h)):
        for f in ("embed", "embed_avg", "cluster_size"):
            final[f"{band}.{f}"] = getattr(cb, f)
    out["final"] = final
    return out


def tp_stage2(inp, grid):
    frozen = tpar._frozen(inp["s1"], L)
    t_l, t_h = tmg.build_transformers(Config.from_dict(tpar.S2_CFG), frozen.model.spec,
                                      tpar.N_CLASSES)
    t_l.load_state_dict(inp["sd_l"])
    t_h.load_state_dict(inp["sd_h"])
    state = tst2.create_stage2_state(t_l, t_h, tpar._tx())
    shapes = {id(t): {k: tuple(p.shape) for k, p in t.named_parameters()} for t in (t_l, t_h)}
    step = tst2.make_stage2_train_step(frozen)
    out = {"loss": [], "tokens": []}
    with grid:
        tp.shard_train_state_tp(state, TEST_MIN_ELEMS)
        out["fraction"] = tp.sharded_fraction(t_l, t_h)
        for t in range(tpar.STEPS):
            x, y = (torch.from_numpy(mesh.shard_batch(a[t])) for a in (inp["xs"], inp["ys"]))
            noise = {band: tuple(torch.from_numpy(mesh.shard_batch(d)) for d in draws)
                     for band, draws in inp["noise"][t].items()}
            out["tokens"].append(tuple(tmg.encode_tokens(frozen, x, band).numpy()
                                       for band in ("lf", "hf")))
            _, m = step(state, x, y, noise=noise)
            out["loss"].append({k: v.item() for k, v in mesh.all_reduce_metrics(m).items()})
            if t == 0:
                out["grads"] = {"l": _full_grads(t_l), "h": _full_grads(t_h)}
        out["slices"] = _slices_ok([t_l, t_h], state.optimizer, shapes)
        fl, fh = _whole(t_l, t_h)
    out["final"] = {"l": fl, "h": fh}
    return out


def tp_stage3(inp, grid):
    frozen = tpar._frozen(inp["s1"], tpar.L3)
    fe = FidelityEnhancer(tpar.L3, C, **tpar.FE, dropout=0.0)
    fe.load_state_dict(inp["fe"])
    state = tst3.create_stage3_state(fe, tpar._tx())
    shapes = {id(fe): {k: tuple(p.shape) for k, p in fe.named_parameters()}}
    step = tst3.make_stage3_train_step(frozen, inp["tau"])
    out = {"loss": []}
    with grid:
        tp.shard_train_state_tp(state, TEST_MIN_ELEMS)
        out["fraction"] = tp.sharded_fraction(fe)
        for t in range(tpar.STEPS):
            _, m = step(state, torch.from_numpy(mesh.shard_batch(inp["xs"][t])))
            out["loss"].append(mesh.all_reduce_metrics(m)["loss"].item())
            if t == 0:
                out["grads"] = _full_grads(fe)
        out["slices"] = _slices_ok([fe], state.optimizer, shapes)
        out["final"], = _whole(fe)
    return out


def run_cfg():
    return Config.from_dict({**tpar.S1_CFG, "dataset": {"batch_sizes": {"stage1": G}},
                             "trainer_params": {"val_check_interval": {"stage1": 4}}})


def tp_runner(workdir):
    """``train_stage1(tp=2)`` over the four ranks: straight to 12 steps in
    ``full``; then the step-8 snapshot copied to ``part`` and resumed to 12."""
    data = tpar.runner_data()
    kw = dict(max_steps=RUN_STEPS, seed=4, device="cpu", log_interval=RUN_STEPS, tp=2)
    full = runner.train_stage1(run_cfg(), data, save_path=os.path.join(workdir, "full", "stage1"),
                               **kw)
    part = os.path.join(workdir, "part", "stage1")
    if mesh.is_primary():
        os.makedirs(os.path.dirname(part), exist_ok=True)
        shutil.copy(os.path.join(workdir, "full", "stage1.train"), part + ".train")
    mesh.barrier()
    resumed = runner.train_stage1(run_cfg(), data, save_path=part, **kw)
    return {"full": runner.stage1_to_jax(full.model, full.vq_l, full.vq_h),
            "resumed": runner.stage1_to_jax(resumed.model, resumed.vq_l, resumed.vq_h)}


CLI_CFG = {**tpar.S2_CFG, "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2],
                                                 "resnet_block_groups": 4},
           "dataset": {"batch_sizes": {"stage1": 4, "stage2": 4, "stage3": 4}}}


def tp_cli(workdir):
    """The train CLI with ``--tp 2`` over the four ranks, stages 1-3, two
    steps each (stages 2-3 read stage 1 back from the primary's file)."""
    import json

    from tvqvae_tpu_torch.data import dataset as tdata
    from tvqvae_tpu_torch.scripts import train

    root = os.path.join(workdir, "cli")
    data, cfg = os.path.join(root, "d.npz"), os.path.join(root, "cfg.json")
    if mesh.is_primary():
        os.makedirs(root, exist_ok=True)
        X, y = tdata.make_synthetic_trajectories(n=80, channels=C, length=L,
                                                 n_classes=tpar.N_CLASSES, seed=2)
        tdata.save_npz(data, X, y)
        with open(cfg, "w") as f:
            json.dump(CLI_CFG, f)
    mesh.barrier()
    train.main(["--dataset_file", data, "--config", cfg, "--stage", "all", "--max_steps", "2",
                "--device", "cpu", "--no_val_metrics", "--tp", "2", "--model_save_dir",
                os.path.join(root, "models"), "--run_dir", os.path.join(root, "runs")])


def _wait_for(path, timeout=300):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.05)


def worker(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank: stage 1 on both grids and the runner, then (once the
    parent has written their inputs) stages 2 and 3 on both grids; its
    results to ``out<rank>.pkl``."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    tp.MIN_SHARD_ELEMS = TEST_MIN_ELEMS
    grids = {g: tp.make_mesh2d(*g) for g in GRIDS}
    with open(os.path.join(workdir, "cases1.pkl"), "rb") as f:
        s1 = pickle.load(f)
    out = {(g, kind): tp_stage1(s1, grids[g], kind == "adam") for g in GRIDS
           for kind in ("sgd", "adam")}
    out["runner"] = tp_runner(workdir)
    tp_cli(workdir)
    _wait_for(os.path.join(workdir, "cases2.pkl"))
    with open(os.path.join(workdir, "cases2.pkl"), "rb") as f:
        cases = pickle.load(f)
    for g in GRIDS:
        out[(g, "s2")] = tp_stage2(cases["s2"], grids[g])
        out[(g, "s3")] = tp_stage3(cases["s3"], grids[g])
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's side, one device over the global batch


def jax_stage1():
    """JAX's tiny stage 1 (random weights) and one step on a global batch of
    G rows with SGD and with AdamW -> (inputs, {"sgd": ref, "adam": ref})."""
    import jax.numpy as jnp
    import optax

    from tvqvae_tpu.train.stage1 import create_stage1_state as j_create, make_stage1_train_step

    model, tree = tpar._jax_stage1(L, seed=12)
    xs = np.random.default_rng(13).normal(size=(1, G, C, L)).astype(np.float32)
    inputs = {"sd": convert.stage1_from_jax(tree), "xs": xs}

    def refs():
        out = {}
        for kind, tx in (("sgd", optax.sgd(SGD_LR)), ("adam", tpar._jax_tx())):
            state = j_create(tree["params"], tree["batch_stats"], tree["vq_l"], tree["vq_h"], tx)
            state, m = jax.jit(make_stage1_train_step(model, tx))(state, jnp.asarray(xs[0]),
                                                                  jax.random.key(1))
            ref = {"loss": float(m["loss"]),
                   "final": convert.stage1_from_jax({"params": state.params,
                                                     "batch_stats": state.batch_stats,
                                                     "vq_l": state.vq_l, "vq_h": state.vq_h})}
            if kind == "adam":
                ref["grads"] = convert.params_to_state_dict(tpar._mu_grads(state.opt_state))
                ref["mu"], ref["nu"] = (convert.params_to_state_dict(
                    jax.tree.map(np.asarray, getattr(state.opt_state[0], k))) for k in ("mu", "nu"))
            out[kind] = ref
        return out

    return inputs, refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks running stage 1 on both grids and the runner while
    this process computes JAX's references; then stages 2 and 3, whose
    inputs ``test_torch_parallel``'s JAX functions make. -> (references, [each rank's results],
    the work directory)."""
    work = str(tmp_path_factory.mktemp("tp"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = []
    try:
        s1_inputs, s1_refs = jax_stage1()
        with open(os.path.join(work, "cases1.pkl"), "wb") as f:
            pickle.dump(s1_inputs, f)
        port = tpar._free_port()
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(W),
                                   str(port), work], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(W)]
        # JAX compiles the three references at once (its compiler leaves the GIL)
        with ThreadPoolExecutor(3) as pool:
            s1, s2, s3 = (pool.submit(s1_refs), pool.submit(tpar.jax_stage2),
                          pool.submit(tpar.jax_stage3, 0.0))
            cases, refs = {}, {}
            cases["s2"], refs["s2"] = s2.result()
            cases["s3"], refs["s3"] = s3.result()
            with open(os.path.join(work, "cases2.pkl.tmp"), "wb") as f:
                pickle.dump(cases, f)
            os.replace(os.path.join(work, "cases2.pkl.tmp"), os.path.join(work, "cases2.pkl"))
            refs["s1"] = s1.result()
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        torch.set_num_threads(n)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(W):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return refs, outs, work


def _cancelled():
    from chip_smoke import biases_cancelled_by_batchnorm

    return biases_cancelled_by_batchnorm(Stage1Model(Stage1Spec.from_config(
        Config.from_dict(tpar.S1_CFG), L, C)))


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x4"])
def test_stage1_sgd_step_equals_jax(ranks, grid):
    """SGD: the loss, every parameter and the codebooks within rtol 2e-4 /
    atol 1e-5 of JAX's one-device step; the rule engaged and the slices
    kept after the step; every rank the same state."""
    refs, outs, _ = ranks
    ref = refs["s1"]["sgd"]
    for o in outs:
        ours = o[(grid, "sgd")]
        assert ours["fraction"] > 0.25 and ours["slices"]
        assert ours["loss"] == pytest.approx(ref["loss"], rel=2e-4, abs=1e-5)
        n = 0
        for k, r in ref["final"].items():
            if k.endswith(("num_batches_tracked", "initted")):
                continue
            np.testing.assert_allclose(np.asarray(ours["final"][k], np.float64),
                                       np.asarray(r, np.float64), rtol=2e-4, atol=1e-5,
                                       err_msg=k)
            n += 1
        assert n > 40
    tpar._assert_ranks_equal([o[(grid, "sgd")]["final"] for o in outs[:2]])


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x4"])
def test_stage1_adam_gradients_and_moments_equal_optax(ranks, grid):
    """AdamW: the step-1 gradients, and both moments gathered whole, against
    optax's after JAX's one-device step (module docstring's rule)."""
    refs, outs, _ = ranks
    ref = refs["s1"]["adam"]
    cancelled = _cancelled()
    for o in outs:
        ours = o[(grid, "adam")]
        assert ours["fraction"] > 0.25 and ours["slices"]
        tpar._assert_grads(ours["grads"], ref["grads"], cancelled)
        tpar._assert_grads({k: v / 0.1 for k, v in ours["mu"].items()}, ref["grads"], cancelled)
        for k, r in ref["nu"].items():
            scale = np.abs(np.asarray(ref["nu"].get(cancelled.get(k, k)))).max()
            np.testing.assert_allclose(ours["nu"][k].numpy(), np.asarray(r), rtol=0,
                                       atol=2e-4 * scale, err_msg=k)
        assert ours["loss"] == pytest.approx(ref["loss"], rel=2e-4, abs=1e-5)


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x4"])
def test_stage2_steps_equal_jax(ranks, grid):
    refs, outs, _ = ranks
    ref = refs["s2"]
    data_count = grid[0]
    for t in range(tpar.STEPS):
        for band in (0, 1):  # the ranks of model index 0 hold the data slices in order
            got = np.concatenate([outs[d * grid[1]][(grid, "s2")]["tokens"][t][band]
                                  for d in range(data_count)])
            np.testing.assert_array_equal(got, ref["tokens"][t][band])
    for o in outs:
        ours = o[(grid, "s2")]
        assert ours["fraction"] > 0.25 and ours["slices"]
        for t in range(tpar.STEPS):
            for k, v in ref["loss"][t].items():
                assert ours["loss"][t][k] == pytest.approx(v, rel=1e-5), (t, k)
        for band in ("l", "h"):
            tpar._assert_grads(ours["grads"][band], ref["grads"][band])
            tpar._assert_final(ours["final"][band], ref["final"][band])


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x4"])
def test_stage3_steps_equal_jax(ranks, grid):
    refs, outs, _ = ranks
    ref = refs["s3"]
    for o in outs:
        ours = o[(grid, "s3")]
        assert ours["fraction"] > 0.25 and ours["slices"]
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
        tpar._assert_grads(ours["grads"], ref["grads"])
        tpar._assert_final(ours["final"], ref["final"])
    tpar._assert_ranks_equal([o[(grid, "s3")]["final"] for o in outs[:2]])


def test_runner_resume_is_bit_equal_and_the_checkpoint_loads(ranks):
    """``train_stage1(tp=2)``: resumed from its step-8 snapshot, the run ends
    bit-equal to the straight one on every rank; the snapshot holds whole
    tensors (its layout does not depend on ``tp``); the checkpoint is the
    JAX layout and loads through ``load_stage1_bundle``."""
    _, outs, work = ranks
    full = dict(tckpt._flatten(outs[0]["runner"]["full"]))
    for o in outs:
        for other in (o["runner"]["full"], o["runner"]["resumed"]):
            other = dict(tckpt._flatten(other))
            assert set(other) == set(full)
            for k in full:
                np.testing.assert_array_equal(other[k], full[k], err_msg=k)
    snap = tckpt.load_train_state(os.path.join(work, "full", "stage1.train"))
    model = Stage1Model(Stage1Spec.from_config(run_cfg(), L, C))
    assert snap["step"] == RUN_SNAPSHOT and len(snap["generators"]) == 2
    for k, v in model.state_dict().items():
        assert tuple(snap["model"][k].shape) == tuple(v.shape), k
    for i, p in enumerate(model.parameters()):
        assert tuple(snap["optimizer"]["state"][i]["exp_avg"].shape) == tuple(p.shape)
    tree, meta = tckpt.load_checkpoint(os.path.join(work, "part", "stage1"))
    assert int(tree["step"]) == RUN_STEPS and meta["completed_step"] == RUN_STEPS
    frozen, _, _ = runner.load_stage1_bundle(run_cfg(), os.path.join(work, "part", "stage1"),
                                             device="cpu")
    sd = convert.stage1_from_jax(outs[0]["runner"]["full"])
    for k, v in frozen.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("stage", ["1", "2", "3"])
def test_train_cli_with_tp_writes_every_stage(ranks, stage):
    """``python -m tvqvae_tpu_torch.scripts.train --tp 2`` run by the four
    ranks: each stage's checkpoint records its two steps, finite, whole."""
    _, _, work = ranks
    tree, meta = tckpt.load_checkpoint(os.path.join(work, "cli", "models", "d", f"stage{stage}"))
    assert meta["completed_step"] == 2 and int(tree["step"]) == 2
    leaves = dict(tckpt._flatten(tree))
    assert len(leaves) > 10
    assert all(np.isfinite(v).all() for v in leaves.values() if v.dtype.kind == "f")


def test_one_process_grid_and_refusals():
    """Without a process group a (1, 1) grid is the one process; a grid the
    world does not hold and a ``tp`` the world does not divide raise."""
    g = tp.make_mesh2d(1, 1)
    with g:
        assert (mesh.data_index(), mesh.data_count(), mesh.grid()) == (0, 1, g)
    assert mesh.grid() is None
    with pytest.raises(ValueError, match="grid needs 2 ranks"):
        tp.make_mesh2d(1, 2)
    with pytest.raises(ValueError, match="1 devices not divisible by tp=2"):
        runner._train_grid(2)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
