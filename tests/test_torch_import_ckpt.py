"""Port parity: reference checkpoints into the port (``import_ckpt``).

Reference-layout Lightning checkpoints are written with ``torch.save`` from
seeded port modules through ``chip_smoke.py``'s inverse of
``import_reference`` (the reference's own files are not in the repository),
at a small geometry: C=4, L=64, hid_dim 8, codebooks 6/7, priors 8x2Lx1H
(square: the wrapper's projections are forced) and 12x2Lx1H, FE dim 8 with
dim_mults (1, 2), 3 classes, random BatchNorm statistics. Then:

  - the port's CLI and the JAX package's CLI (Orbax) on the same files give
    equal trees leaf by leaf (exactly: both are transposes) and equal meta,
    for the four stages; stage 2 also in the older x-transformers naming,
    from ``tests/test_import_stage2.py``'s torch transcription, imported;
  - the inverse followed by the JAX package's ``import_reference`` gives back
    the seeded trees, exactly;
  - a config whose geometry does not match stops both CLIs with the same
    ``SystemExit`` message;
  - a checkpoint whose ``hyper_parameters`` holds an instance of a class from
    a module that cannot be imported loads, and none of its globals runs;
  - a sampler from the imported checkpoints equals the in-memory one built
    from the same modules: reconstruct tokens exactly, series within 2e-4
    (the sampler's tolerance), with and without the enhancer.
"""

import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_import_stage2 as xt  # the torch transcription of x-transformers
from tvqvae_tpu.scripts import import_ckpt as j_cli
from tvqvae_tpu.utils import checkpoint as jckpt
from tvqvae_tpu.utils import import_reference as jir
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import build_transformers, encode_tokens
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.scripts import import_ckpt
from tvqvae_tpu_torch.train.stage2 import init_stage2
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
from tvqvae_tpu_torch.utils.import_reference import InertGlobal, load_reference_checkpoint

C, L, N_CLASSES, TAU = 4, 64, 3, 0.25
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 8, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 6, "hf": 7}},
    "MaskGIT": {"T": {"lf": 3, "hf": 1},
                "prior_model_l": {"hidden_dim": 8, "n_layers": 2, "heads": 1, "ff_mult": 1},
                "prior_model_h": {"hidden_dim": 12, "n_layers": 2, "heads": 1, "ff_mult": 1}},
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4},
}
STAGES = ("stage1", "stage2", "stage3", "fcn")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_cfg(path, cfg):
    import yaml

    with open(path + ".json", "w") as f:
        json.dump(cfg, f)
    with open(path + ".yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return path + ".json", path + ".yaml"


def _seeded_modules():
    """The port's modules at CFG, seeded, with random BatchNorm statistics."""
    cfg = Config.from_dict(CFG)
    g = torch.Generator().manual_seed(0)
    spec = Stage1Spec.from_config(cfg, L, C)
    model, vq_l, vq_h = init_stage1(spec, g, "cpu")
    t_l, t_h = init_stage2(*build_transformers(cfg, spec, N_CLASSES, (True, True)), g, "cpu")
    fe = init_weights_(FidelityEnhancer.from_config(cfg, L, C), g)
    fcn = init_weights_(FCN(C, N_CLASSES), g)
    with torch.no_grad():
        for m in (model, t_h, fcn):
            for mod in m.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.running_mean.normal_(0.0, 0.1, generator=g)
                    mod.running_var.uniform_(0.5, 1.5, generator=g)
    return dict(cfg=cfg, spec=spec, model=model.eval(), vq_l=vq_l, vq_h=vq_h, t_l=t_l.eval(),
                t_h=t_h.eval(), fe=fe.eval(), fcn=fcn.eval())


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("import_ckpt"))
    mods = _seeded_modules()
    paths = cs.write_reference_ckpts(torch, os.path.join(tmp, "ref"), mods["model"], mods["vq_l"],
                                     mods["vq_h"], mods["t_l"], mods["t_h"], mods["fe"], TAU,
                                     mods["fcn"])
    cfg_json, cfg_yaml = _write_cfg(os.path.join(tmp, "cfg"), CFG)
    flags = ["--stage1_ckpt", paths["stage1"], "--stage2_ckpt", paths["stage2"],
             "--stage3_ckpt", paths["stage3"], "--fcn_ckpt", paths["fcn"]]
    ours, theirs = os.path.join(tmp, "port"), os.path.join(tmp, "jax")
    seconds = import_ckpt.main(flags + ["--out_dir", ours, "--config", cfg_json, "--device", "cpu"])
    j_cli.main(flags + ["--out_dir", theirs, "--config", cfg_yaml])
    return dict(mods, tmp=tmp, paths=paths, ours=ours, theirs=theirs, seconds=seconds,
                cfg_json=cfg_json, cfg_yaml=cfg_yaml)


def _assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("stage", STAGES)
def test_port_cli_writes_the_jax_cli_trees_and_meta(imported, stage):
    tree, meta = load_checkpoint(os.path.join(imported["ours"], stage))
    j_tree, j_meta = jckpt.load_checkpoint(os.path.join(imported["theirs"], stage))
    _assert_trees_equal(tree, j_tree)
    assert meta == json.loads(json.dumps(j_meta))
    assert meta["imported_from"] == os.path.abspath(imported["paths"][stage])
    if stage == "stage2":
        assert meta["force_projections"] is True
    if stage == "stage3":
        assert meta["tau"] == pytest.approx(TAU) and float(tree["tau"]) == pytest.approx(TAU)
    assert imported["seconds"][stage] > 0


def _seeded_tree(mods, stage):
    if stage == "stage1":
        return convert.stage1_to_jax(mods["model"], mods["vq_l"], mods["vq_h"])
    if stage == "stage2":
        params, h_stats = convert.prior_to_jax(mods["t_l"], mods["t_h"])
        return {"params": params, "h_stats": h_stats}
    if stage == "stage3":
        return {"params": convert.fe_to_jax(mods["fe"])}
    return convert.fcn_to_jax(mods["fcn"])


@pytest.mark.parametrize("stage", STAGES)
def test_the_inverse_and_jax_import_reference_give_back_the_seeded_trees(imported, stage):
    ckpt = torch.load(imported["paths"][stage], weights_only=True)
    if stage == "stage1":
        params, stats, vq_l, vq_h, inferred = jir.stage1_from_state_dict(ckpt)
        got = {"params": params, "batch_stats": stats, "vq_l": vq_l, "vq_h": vq_h}
        assert inferred["input_length"] == L and inferred["in_channels"] == C
    elif stage == "stage2":
        params, h_stats, inferred = jir.stage2_from_state_dict(ckpt)
        got = {"params": params, "h_stats": h_stats}
        assert inferred["force_projections"] is True
    elif stage == "stage3":
        params, tau, _ = jir.fe_from_state_dict(ckpt)
        got = {"params": params}
        assert tau == pytest.approx(TAU)
    else:
        got = jir.fcn_from_state_dict(ckpt)[0]
    _assert_trees_equal(got, _seeded_tree(imported, stage))


@pytest.mark.parametrize("naming", ["new", "old"])
def test_stage2_in_both_x_transformers_namings(imported, tmp_path, monkeypatch, naming):
    """The transcription's priors at the stage-1 geometry of CFG, through the
    port's CLI, against JAX's ``stage2_from_state_dict`` of the same file."""
    spec = imported["spec"]
    monkeypatch.setattr(xt, "N_TOK_L", spec.tokens_l)
    monkeypatch.setattr(xt, "N_TOK_H", spec.tokens_h)
    assert (xt.E, xt.K_L, xt.K_H, xt.NCLS) == (8, 6, 7, N_CLASSES)
    kw = {} if naming == "new" else dict(nested_norm=False, old_ff=True, attn_out_bias=False,
                                          attn_seq_out=True)
    _, _, ckpt = xt._stage2_sd(**kw)
    path = str(tmp_path / "stage2.ckpt")
    torch.save(ckpt, path)
    out = str(tmp_path / "out")
    import_ckpt.main(["--stage1_ckpt", imported["paths"]["stage1"], "--stage2_ckpt", path,
                      "--n_classes", str(N_CLASSES), "--out_dir", out,
                      "--config", imported["cfg_json"], "--device", "cpu"])
    tree, meta = load_checkpoint(os.path.join(out, "stage2"))
    params, h_stats, inferred = jir.stage2_from_state_dict(torch.load(path, weights_only=True))
    _assert_trees_equal(tree, {"params": params, "h_stats": h_stats, "step": np.asarray(0)})
    assert meta["force_projections"] is inferred["force_projections"] is True


def _bad_configs():
    wide = json.loads(json.dumps(CFG))
    wide["encoder"]["hid_dim"] = 16
    deep_fe = json.loads(json.dumps(CFG))
    deep_fe["fidelity_enhancer"]["dim_mults"] = [1, 2, 4]
    short = json.loads(json.dumps(CFG))
    short["encoder"]["downsampled_width"] = {"lf": 2, "hf": 8}
    return {"stage1": (wide, ["stage1"]), "stage3": (deep_fe, ["stage1", "stage3"]),
            "stage2_tokens": (short, ["stage1", "stage2"])}


@pytest.mark.parametrize("case", sorted(_bad_configs()))
def test_mismatched_geometry_stops_both_clis_with_the_same_message(imported, tmp_path, case):
    cfg, stages = _bad_configs()[case]
    cfg_json, cfg_yaml = _write_cfg(str(tmp_path / "cfg"), cfg)
    flags = ["--n_classes", str(N_CLASSES)]
    for s in stages:
        flags += [f"--{s}_ckpt", imported["paths"][s]]
    if case == "stage2_tokens":  # the stage-1 checkpoint of that geometry
        flags[flags.index("--stage1_ckpt") + 1] = _short_stage1(tmp_path, cfg)
    with pytest.raises(SystemExit) as ours:
        import_ckpt.main(flags + ["--out_dir", str(tmp_path / "a"), "--config", cfg_json,
                                  "--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        j_cli.main(flags + ["--out_dir", str(tmp_path / "b"), "--config", cfg_yaml])
    assert str(ours.value) == str(theirs.value)
    assert "imported" in str(ours.value) or "tokens" in str(ours.value)


def _short_stage1(tmp_path, cfg_dict):
    cfg = Config.from_dict(cfg_dict)
    model, vq_l, vq_h = init_stage1(Stage1Spec.from_config(cfg, L, C),
                                    torch.Generator().manual_seed(3), "cpu")
    path = str(tmp_path / "short_stage1.ckpt")
    torch.save({"state_dict": cs.reference_stage1_sd(model, vq_l, vq_h)}, path)
    return path


def test_a_checkpoint_with_unimportable_hyper_parameters_loads(imported, tmp_path):
    """Lightning pickles ``hyper_parameters``; a class from a module the
    loading machine lacks (here one that is removed after pickling) loads
    as an inert stub, and a pickled call of a function is not run."""
    mod = types.ModuleType("reference_only_module")
    ran = []

    class HParams(dict):
        pass

    class RunConfig:
        def __init__(self):
            self.lr, self.scale = 1e-3, torch.ones(2)

    def side_effect(*args):
        ran.append(args)

    class Call:
        def __reduce__(self):
            return side_effect, ("ran",)

    for obj in (HParams, RunConfig, side_effect):
        obj.__module__ = mod.__name__
        obj.__qualname__ = obj.__name__
        setattr(mod, obj.__name__, obj)
    sys.modules[mod.__name__] = mod
    try:
        ckpt = torch.load(imported["paths"]["stage1"], weights_only=True)
        ckpt["hyper_parameters"] = HParams(cfg=RunConfig(), call=Call(), n_classes=N_CLASSES)
        path = str(tmp_path / "stage1.ckpt")
        torch.save(ckpt, path)
    finally:
        del sys.modules[mod.__name__]
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, weights_only=True)
    with pytest.raises(ModuleNotFoundError):
        torch.load(path, weights_only=False)
    loaded = load_reference_checkpoint(path)
    assert not ran
    hp = loaded["hyper_parameters"]
    assert isinstance(hp, InertGlobal) and hp["n_classes"] == N_CLASSES
    assert isinstance(hp["cfg"], InertGlobal) and isinstance(hp["call"], InertGlobal)
    torch.testing.assert_close(hp["cfg"].state["scale"], torch.ones(2))
    out = str(tmp_path / "out")
    import_ckpt.main(["--stage1_ckpt", path, "--n_classes", str(N_CLASSES), "--out_dir", out,
                      "--config", imported["cfg_json"], "--device", "cpu"])
    _assert_trees_equal(load_checkpoint(os.path.join(out, "stage1"))[0],
                        load_checkpoint(os.path.join(imported["ours"], "stage1"))[0])


@pytest.mark.parametrize("use_fe", [False, True])
def test_sampler_from_imported_checkpoints_equals_the_in_memory_one(imported, use_fe):
    m, cfg = imported, imported["cfg"]
    d = m["ours"]
    disk = TrainedModelSampler.from_checkpoints(
        cfg, os.path.join(d, "stage1"), os.path.join(d, "stage2"), os.path.join(d, "stage3"),
        use_fidelity_enhancer=use_fe, batch_size=4, device="cpu")
    mem = TrainedModelSampler(
        cfg, _seeded_tree(m, "stage1"), _seeded_tree(m, "stage2"), input_length=L,
        in_channels=C, n_classes=N_CLASSES, stage3={**_seeded_tree(m, "stage3"), "tau": TAU},
        use_fidelity_enhancer=use_fe, batch_size=4, device="cpu")
    assert disk.tau == mem.tau == pytest.approx(TAU)
    # parameters read from disk are C-contiguous, as the trained modules' are:
    # permuted strides would send the card's convolutions to other kernels
    for module in (disk.frozen.model, disk.t_l, disk.t_h, disk.fe):
        assert all(p.is_contiguous() for p in module.parameters())
    for kw in ({}, {"kind": "conditional", "class_index": 1}):
        for a, b in zip(disk.sample(6, seed=3, **kw), mem.sample(6, seed=3, **kw)):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)
    x = np.random.default_rng(4).normal(size=(6, C, L)).astype(np.float32)
    for band in ("lf", "hf"):
        xt_ = torch.from_numpy(x)
        assert torch.equal(encode_tokens(disk.frozen, xt_, band),
                           encode_tokens(mem.frozen, xt_, band))
    np.testing.assert_allclose(disk.reconstruct(x), mem.reconstruct(x), rtol=0, atol=2e-4)
    if use_fe:
        np.testing.assert_allclose(disk.enhance(x), mem.enhance(x), rtol=0, atol=2e-4)
