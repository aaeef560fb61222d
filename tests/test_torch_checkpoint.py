"""The port's checkpoints: the inverse converters, the file format and its
path rule, resume, and JAX checkpoints read through the exporter.

At the small shapes of ``tests/test_torch_sampler.py`` (L=127, C=4,
hid_dim 16, codebooks 8/8, priors 16x2Lx2H and 8x1Lx1H, enhancer dim 8):

- ``*_to_jax(*_from_jax(tree))`` gives ``tree`` back leaf for leaf, dtypes
  included, for trees in the JAX package's own layout (its inits traced by
  ``jax.eval_shape``, filled with seeded numbers);
- ``save_checkpoint`` -> ``load_checkpoint`` is exact, at exactly the path
  given, with the meta beside it;
- a checkpoint written by the JAX package (Orbax), exported by
  ``tools/export_jax_ckpt.py`` and read by ``from_checkpoints`` samples bit
  for bit as the in-memory port sampler does, and within 2e-4 of the JAX
  package's ``make_sampling_fn`` with JAX's draws handed in (the enhancer
  within 5e-4 of its scale, as in ``tests/test_torch_sampler.py``);
- each stage run for 2k steps with validation every k (one snapshot, at k),
  its checkpoint deleted and run again, resumes at k and ends bit-equal on
  the CPU, losses and every leaf; called once more it returns at once.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_sampler import CFG, C, L, N_CLASSES, jax_decode_noise
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.fcn import FCN as JFCN
from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFidelityEnhancer
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.stage1 import init_stage1 as j_init_stage1
from tvqvae_tpu.train import runner as jrunner
from tvqvae_tpu.train.stage2 import init_stage2 as j_init_stage2
from tvqvae_tpu.train.stage2 import make_sampling_fn as j_make_sampling_fn
from tvqvae_tpu.train.stage3 import init_stage3 as j_init_stage3
from tvqvae_tpu.utils import checkpoint as jckpt
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import get_data, make_synthetic_trajectories, save_npz
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, build_transformers, iterative_decoding
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train.stage2 import init_stage2
from tvqvae_tpu_torch.train.stage3 import init_stage3
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)

REPO = Path(__file__).resolve().parents[1]
K = 2  # validation (and so snapshot) interval of the resume runs
META = {"config": {}, "input_length": L, "in_channels": C, "n_classes": N_CLASSES}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def filled(shapes, seed):
    """A tree of ``jax.eval_shape`` leaves filled with seeded numbers."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.dtype == jnp.bool_:
            return rng.random(s.shape) < 0.5
        if jnp.issubdtype(s.dtype, jnp.integer):
            return rng.integers(0, 9, s.shape).astype(s.dtype)
        return rng.normal(size=s.shape).astype(s.dtype)

    return jax.tree.map(leaf, shapes)


@pytest.fixture(scope="module")
def specs():
    jcfg, cfg = JConfig.from_dict(CFG), Config.from_dict(CFG)
    return jcfg, JStage1Spec.from_config(jcfg, L, C), cfg, Stage1Spec.from_config(cfg, L, C)


# --------------------------------------------------------------------------
# the inverse converters


def test_stage1_round_trip(specs):
    jcfg, js1, _, s1 = specs
    shapes = jax.eval_shape(lambda k: j_init_stage1(k, js1, jnp.zeros((2, C, L)))[1:],
                            jax.random.key(0))
    params, stats, vq_l, vq_h = filled(shapes, 1)
    tree = {"params": params, "batch_stats": stats, "vq_l": jrunner.codebook_to_dict(vq_l),
            "vq_h": jrunner.codebook_to_dict(vq_h)}
    frozen = FrozenStage1.from_state_dict(s1, convert.stage1_from_jax(tree), "cpu")
    assert_trees_equal(convert.stage1_to_jax(frozen.model, frozen.vq_l, frozen.vq_h), tree)
    assert "num_batches_tracked" not in json.dumps(list(flat(tree)))


@pytest.mark.parametrize("force", [False, True], ids=["fresh", "imported_projections"])
def test_prior_round_trip(specs, force):
    jcfg, js1, cfg, s1 = specs
    t_l, t_h = jmg.build_transformers(jcfg, js1, N_CLASSES, force_projections=force)
    spec = jmg.MaskGITSpec.from_config(jcfg, js1)
    params, h_stats = filled(jax.eval_shape(lambda k: j_init_stage2(k, t_l, t_h, spec),
                                            jax.random.key(0)), 2)
    p_l, p_h = build_transformers(cfg, s1, N_CLASSES, (force, force))
    sd_l, sd_h = convert.prior_from_jax(params, h_stats)
    p_l.load_state_dict(sd_l)
    p_h.load_state_dict(sd_h)
    back, back_stats = convert.prior_to_jax(p_l, p_h)
    assert ("project_in" in back["l"]) is force
    assert_trees_equal({"params": back, "h_stats": back_stats},
                       {"params": params, "h_stats": h_stats})


def test_fe_round_trip(specs):
    jcfg = specs[0]
    fc = jcfg.fidelity_enhancer
    jfe = JFidelityEnhancer(input_length=L, in_channels=C, dim=fc.dim, dim_mults=tuple(fc.dim_mults),
                            resnet_block_groups=fc.resnet_block_groups, dropout=fc.dropout)
    params = filled(jax.eval_shape(lambda k: j_init_stage3(k, jfe, jnp.zeros((2, C, L))),
                                   jax.random.key(0)), 3)
    fe = FidelityEnhancer.from_config(specs[2], L, C)
    fe.load_state_dict(convert.fe_from_jax(params))
    assert_trees_equal(convert.fe_to_jax(fe), params)


def test_fcn_round_trip():
    variables = filled(jax.eval_shape(lambda k: JFCN(n_classes=N_CLASSES).init(
        {"params": k}, jnp.zeros((2, C, 64)), True), jax.random.key(0)), 4)
    fcn = FCN(C, N_CLASSES)
    fcn.load_state_dict(convert.fcn_from_jax(variables))
    assert_trees_equal(convert.fcn_to_jax(fcn), variables)


# --------------------------------------------------------------------------
# the file format


def test_save_load_is_exact_with_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 5)).astype(np.float32)},
                       "b": rng.normal(size=(2,)).astype(np.float64)},
            "vq_l": {"initted": np.array(True), "embed": np.float32(rng.normal(size=(4, 2)))},
            "step": np.asarray(7, np.int32), "tau": np.asarray(0.25, np.float32),
            "ids": np.arange(5, dtype=np.int64), "file": np.asarray(1, np.int16)}
    meta = {"input_length": np.int64(L), "scale": np.float32(0.5), "v": np.arange(2)}
    save_checkpoint(str(tmp_path / "ck"), tree, meta)
    back, back_meta = load_checkpoint(str(tmp_path / "ck"))
    assert_trees_equal(back, tree)
    assert back_meta == {"input_length": L, "scale": 0.5, "v": [0, 1]}
    with pytest.raises(ValueError):
        save_checkpoint(str(tmp_path / "bad"), {"a/b": np.zeros(1)})


def test_path_rule(tmp_path):
    """The writer, the reader, the meta and ``_stage_completed`` use exactly
    the path given: no ``.npz`` is appended, and no temp file stays."""
    tree = {"step": np.asarray(3, np.int32)}
    save_checkpoint(str(tmp_path / "m" / "stage1"), tree, {**META, "completed_step": 3})
    assert sorted(os.listdir(tmp_path / "m")) == ["stage1", "stage1.meta.json"]
    assert runner._stage_completed(str(tmp_path / "m" / "stage1"), 3, True, "stage1")
    assert not runner._stage_completed(str(tmp_path / "m" / "stage1"), 4, True, "stage1")
    assert not runner._stage_completed(str(tmp_path / "m" / "stage1"), 3, False, "stage1")
    assert_trees_equal(load_checkpoint(str(tmp_path / "m" / "stage1"))[0], tree)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "m" / "stage1.npz"))
    save_checkpoint(str(tmp_path / "n" / "x.npz"), tree)
    assert os.listdir(tmp_path / "n") == ["x.npz"]
    save_train_state(str(tmp_path / "s" / "stage1.train"), {"step": 2, "t": torch.ones(2)})
    assert os.listdir(tmp_path / "s") == ["stage1.train"]
    assert load_train_state(str(tmp_path / "s" / "stage1.train"))["step"] == 2


# --------------------------------------------------------------------------
# JAX checkpoints through the exporter


def _exporter():
    spec = importlib.util.spec_from_file_location("export_jax_ckpt",
                                                  REPO / "tools" / "export_jax_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exported(specs, tmp_path_factory):
    """Seeded port weights written as JAX checkpoints by the JAX package's
    Orbax writer, then exported to the port's format."""
    _, _, cfg, s1 = specs
    g = torch.Generator().manual_seed(0)
    model, vq_l, vq_h = init_stage1(s1, g, "cpu")
    t_l, t_h = init_stage2(*build_transformers(cfg, s1, N_CLASSES), g, "cpu")
    fe = init_stage3(FidelityEnhancer.from_config(cfg, L, C), g, "cpu")
    with torch.no_grad():  # random GroupNorm scales and biases, not the identity
        for name, p in fe.named_parameters():
            if "GroupNorm" in name:
                p.copy_(0.5 + torch.rand(p.shape, generator=g) if name.endswith("weight")
                        else 0.1 * torch.randn(p.shape, generator=g))
    params, h_stats = convert.prior_to_jax(t_l, t_h)
    step = np.asarray(5, np.int32)
    trees = {"stage1": {**convert.stage1_to_jax(model, vq_l, vq_h), "step": step},
             "stage2": {"params": params, "h_stats": h_stats, "step": step},
             "stage3": {"params": convert.fe_to_jax(fe), "tau": np.asarray(0.0, np.float32),
                        "step": step}}
    root = tmp_path_factory.mktemp("ckpt")
    for name, tree in trees.items():
        jckpt.save_checkpoint(str(root / "jax" / name), tree,
                              meta={**META, "completed_step": 5})
    assert _exporter().export_model_dir(str(root / "jax"), str(root / "port")) == [
        "stage1", "stage2", "stage3"]
    return root, trees


def test_export_copies_trees_and_meta(exported):
    root, trees = exported
    for name, tree in trees.items():
        back, meta = load_checkpoint(str(root / "port" / name))
        assert_trees_equal(back, jckpt.load_checkpoint(str(root / "jax" / name))[0])
        assert_trees_equal(back, tree)
        assert (root / "port" / f"{name}.meta.json").read_bytes() == \
               (root / "jax" / f"{name}.meta.json").read_bytes()
    assert sorted(os.listdir(root / "port")) == sorted(
        [*trees, *(f"{n}.meta.json" for n in trees)])


def test_from_checkpoints_matches_memory_and_jax(exported, specs):
    root, trees = exported
    jcfg, js1, cfg, _ = specs
    port = {n: str(root / "port" / n) for n in trees}
    disk = TrainedModelSampler.from_checkpoints(cfg, port["stage1"], port["stage2"],
                                                batch_size=4, device="cpu")
    disk_fe = TrainedModelSampler.from_checkpoints(cfg, port["stage1"], port["stage2"],
                                                   port["stage3"], use_fidelity_enhancer=True,
                                                   batch_size=4, device="cpu")
    memory = TrainedModelSampler(cfg, trees["stage1"], trees["stage2"], input_length=L,
                                 in_channels=C, n_classes=N_CLASSES, stage3=trees["stage3"],
                                 use_fidelity_enhancer=True, batch_size=4, device="cpu")
    assert (disk.input_length, disk.in_channels, disk.n_classes) == (L, C, N_CLASSES)
    with pytest.raises(ValueError):
        TrainedModelSampler.from_checkpoints(cfg, port["stage1"], port["stage2"],
                                             use_fidelity_enhancer=True, device="cpu")

    num, rng = 4, jax.random.key(11)
    mg_spec = jmg.MaskGITSpec.from_config(jcfg, js1)
    noise = jax_decode_noise(rng, mg_spec, num)
    got = disk_fe.sample(num, "conditional", class_index=1, noise=[noise])
    for a, b in zip(got, memory.sample(num, "conditional", class_index=1, noise=[noise])):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(2).normal(size=(6, C, L)).astype(np.float32)
    np.testing.assert_array_equal(disk_fe.reconstruct(x), memory.reconstruct(x))
    with torch.no_grad():
        tok_disk, tok_mem = (iterative_decoding(
            s.mg_spec, lambda a, c, s=s: s.t_l(a, None, c), lambda a, b, c, s=s: s.t_h(a, b, c),
            num, 1, device="cpu", noise=noise) for s in (disk_fe, memory))
    for a, b in zip(tok_disk, tok_mem):
        assert torch.equal(a, b)

    # the JAX package reads its own checkpoints
    model, frozen, _, meta = jrunner.load_stage1_bundle(jcfg, str(root / "jax" / "stage1"))
    assert meta["input_length"] == L
    tree2, _ = jckpt.load_checkpoint(str(root / "jax" / "stage2"))
    t_l, t_h = jmg.build_transformers(jcfg, js1, N_CLASSES)
    ref = j_make_sampling_fn(model, t_l, t_h, mg_spec)(frozen, tree2["params"], tree2["h_stats"],
                                                      rng, num, 1)
    raw = disk.sample(num, "conditional", class_index=1, noise=[noise])
    for a, b in zip(raw, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4)
    fc = jcfg.fidelity_enhancer
    jfe = JFidelityEnhancer(input_length=L, in_channels=C, dim=fc.dim, dim_mults=tuple(fc.dim_mults),
                            resnet_block_groups=fc.resnet_block_groups, dropout=fc.dropout)
    tree3, _ = jckpt.load_checkpoint(str(root / "jax" / "stage3"))
    ref_fe = np.asarray(jax.jit(lambda p, x: jfe.apply({"params": p}, x, False))(
        tree3["params"], ref[2]))
    assert np.abs(got[2] - ref_fe).max() <= 5e-4 * np.abs(ref_fe).max()


# --------------------------------------------------------------------------
# resume


class Recorder:
    def __init__(self):
        self.train, self.val = [], []

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.train.append((step, float(metrics["train/loss"])))
        else:
            self.val.append((step, {k: float(v) for k, v in metrics.items()}))


@pytest.fixture(scope="module")
def resume_world(tmp_path_factory):
    cfg = Config.from_dict({**CFG, "dataset": {"batch_sizes": {"stage1": 4, "stage2": 4,
                                                               "stage3": 4}},
                            "trainer_params": {"val_check_interval": {"stage1": K, "stage2": K,
                                                                      "stage3": K}}})
    path = tmp_path_factory.mktemp("data") / "trajectories.npz"
    save_npz(str(path), *make_synthetic_trajectories(n=20, channels=C, length=L, seed=3))
    data = get_data(str(path), cfg.dataset.features)
    spec = Stage1Spec.from_config(cfg, L, C)
    model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(5), "cpu")
    return cfg, data, FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)


def _run(stage, world, save_path, resume=True):
    cfg, data, frozen = world
    rec = Recorder()
    kw = dict(max_steps=2 * K, seed=1, logger=rec, device="cpu", log_interval=1,
              save_path=save_path, resume=resume)
    if stage == "stage1":
        out = runner.train_stage1(cfg, data, **kw)
    elif stage == "stage2":
        out = runner.train_stage2(cfg, data, frozen, **kw)
    else:
        out = runner.train_stage3(cfg, data, frozen, tau=0.0, **kw)
    return out, rec


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_resume_is_bit_equal(stage, resume_world, tmp_path):
    path = str(tmp_path / stage)
    _, straight = _run(stage, resume_world, path)
    assert [s for s, _ in straight.train] == list(range(1, 2 * K + 1))
    assert os.path.exists(path + ".train")  # the snapshot at step K, the only one
    assert load_train_state(path + ".train")["step"] == K
    final, meta = load_checkpoint(path)
    with open(path + ".meta.json") as f:
        assert json.load(f)["completed_step"] == 2 * K
    assert int(final["step"]) == 2 * K and meta["input_length"] == L

    os.remove(path)
    os.remove(path + ".meta.json")
    state, resumed = _run(stage, resume_world, path)
    assert state.step == 2 * K
    assert resumed.train == straight.train[K:]  # losses bit-equal, from step K + 1
    assert resumed.val == [v for v in straight.val if v[0] > K]
    assert_trees_equal(load_checkpoint(path)[0], final)

    again, rec = _run(stage, resume_world, path)
    assert again is None and not rec.train and not rec.val
    fresh, rec = _run(stage, resume_world, path, resume=False)  # neither skips nor resumes
    assert fresh.step == 2 * K and rec.train == straight.train
