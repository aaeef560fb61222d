"""The port's quality run (``tvqvae_tpu_torch/scripts/quality_run.py``)
against the JAX tool's (``tools/quality_run.py``), on the CPU.

- The port's ``CFG_OVERRIDES`` (a dict written as JSON) give the config the
  JAX tool's YAML constant gives (read from the tool's source, not
  imported): ``dataclasses.asdict`` equal.
- The synthetic set is the JAX package's, bit for bit.
- The FID the quality run scores with (``"schur"``, 2000-wide ROCKET
  features, fewer series than features) is the JAX package's and stays
  finite where ``scipy.linalg.sqrtm`` of the singular covariance product
  returns NaN, as scipy 1.18's does.
- One run at cut budgets (the small widths of ``tests/test_torch_sampler.py``,
  2 steps a stage, ROCKET with 50 kernels, ``n_eval`` 24, ``--ess``) prints
  the JAX tool's JSON lines and SUMMARY keys, finite, with the ladder's
  noise rung above its floor; then the generate CLI samples through the ESS
  sampler from a JSON config with ``MaskGIT.ESS.use``.
"""

import ast
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_sampler import CFG
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.data import make_synthetic_trajectories as j_make_synthetic
from tvqvae_tpu.evaluation.eval_utils import calculate_fid as j_calculate_fid
from tvqvae_tpu_torch.data import make_synthetic_trajectories
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.evaluation.eval_utils import calculate_fid
from tvqvae_tpu_torch.generation import sampler as tsampler
from tvqvae_tpu_torch.scripts import generate, quality_run, train
from tvqvae_tpu_torch.scripts._cli import load_config

TOOL = Path(__file__).resolve().parents[1] / "tools" / "quality_run.py"
# the SUMMARY keys of tools/quality_run.py with --ess
JAX_SUMMARY_KEYS = {"fid_floor", "fid_noise", "fid_rec", "fid_gen", "fid_gen_fe",
                    "ess_ms_per_32batch", "fid_gen_ess", "train_minutes", "bf16", "fast_bn",
                    "bf16_mu", "bf16_nu", "bf16_head", "bf16_istft", "seed"}
N_EVAL = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool_constant(name):
    tree = ast.parse(TOOL.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_overrides_give_the_jax_tools_config(tmp_path):
    (tmp_path / "cfg.yaml").write_text(_tool_constant("CFG_OVERRIDES"))
    (tmp_path / "cfg.json").write_text(json.dumps(quality_run.CFG_OVERRIDES))
    want = dataclasses.asdict(JConfig.from_yaml(str(tmp_path / "cfg.yaml")))
    assert dataclasses.asdict(load_config(str(tmp_path / "cfg.json"))) == want
    assert want["encoder"]["hid_dim"] == 64


def test_synthetic_set_is_the_jax_packages():
    assert quality_run.DATA == dict(n=1200, channels=4, length=512, n_classes=5, seed=7)
    X, y = make_synthetic_trajectories(**quality_run.DATA)
    X_ref, y_ref = j_make_synthetic(**quality_run.DATA)
    assert X.shape == (1200, 4, 512) and X.dtype == np.float32
    np.testing.assert_array_equal(X, X_ref)
    np.testing.assert_array_equal(y, y_ref)


def test_flags_and_defaults_are_the_jax_tools():
    assert set(quality_run.SUMMARY_KEYS) == JAX_SUMMARY_KEYS - {"ess_ms_per_32batch",
                                                                "fid_gen_ess"}
    args = quality_run.build_argparser().parse_args([])
    assert (args.fast_bn, args.bf16, args.bf16_mu, args.bf16_nu, args.bf16_head,
            args.bf16_istft, args.ess, args.seed, args.n_eval, args.skip_train,
            args.device) == (True, False, True, False, True, False, False, 0, 256, False, "cuda")
    assert Path(args.workdir).name == "qr"


@pytest.mark.parametrize("flags, method", [([], "schur"), (["--fid_method", "svd"], "svd")])
def test_fid_method_reaches_the_ladders_metrics(tmp_path, monkeypatch, flags, method):
    """``--fid_method`` (default the JAX tool's schur) is the FID the
    ladder's ``Metrics`` scores with."""
    seen = {}

    class Stop(Exception):
        pass

    def metrics(*args, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(quality_run, "Metrics", metrics)
    monkeypatch.setattr(quality_run, "DATA", {**quality_run.DATA, "n": 8, "length": 16})
    args = quality_run.build_argparser().parse_args(
        ["--workdir", str(tmp_path), "--skip_train", "--device", "cpu", *flags])
    with pytest.raises(Stop):
        quality_run.run(args)
    assert seen["fid_method"] == method


def _features(rng, n, D, rank=30):
    """Unit-norm rows of a rank-``rank`` signal plus noise: n < D gives the
    singular covariance product of the quality run's ladder."""
    base = np.random.default_rng(0).normal(size=(rank, D))
    z = rng.normal(size=(n, rank)) @ base + 0.3 * rng.normal(size=(n, D))
    return z / np.linalg.norm(z, axis=1, keepdims=True)


@pytest.mark.parametrize("D,n1,n2,rtol", [(40, 300, 200, 1e-12), (200, 150, 60, 1e-7)])
def test_schur_fid_is_the_jax_packages(D, n1, n2, rtol):
    rng = np.random.default_rng(D)
    z1, z2 = _features(rng, n1, D), _features(rng, n2, D)
    want = j_calculate_fid(z1, z2, "schur")
    np.testing.assert_allclose(calculate_fid(z1, z2, "schur"), want, rtol=rtol)


def test_schur_fid_is_finite_where_sqrtm_returns_nan(monkeypatch):
    """scipy 1.18's ``sqrtm`` (the card's) returns NaN for the singular
    S1 S2 of n < D; the port's Schur FID does not call it."""
    import scipy.linalg

    from tvqvae_tpu.evaluation import eval_utils as j_eval_utils

    rng = np.random.default_rng(1)
    z1, z2 = _features(rng, 150, 200), _features(rng, 60, 200)
    want = calculate_fid(z1, z2, "schur")
    nan_sqrtm = lambda a, *_, **__: np.full_like(a, np.nan)  # noqa: E731
    monkeypatch.setattr(scipy.linalg, "sqrtm", nan_sqrtm)
    monkeypatch.setattr(j_eval_utils, "sqrtm", nan_sqrtm)
    assert np.isnan(j_calculate_fid(z1, z2, "schur"))  # the fault under scipy 1.18
    assert calculate_fid(z1, z2, "schur") == want and np.isfinite(want)


def _small_overrides():
    cut = {**CFG, **quality_run.CFG_OVERRIDES}
    cut["encoder"] = CFG["encoder"]
    cut["trainer_params"] = {"max_steps": {"stage1": 2, "stage2": 2, "stage3": 2},
                             "val_check_interval": {"stage1": 2, "stage2": 2, "stage3": 2}}
    cut["evaluation"] = {**cut["evaluation"], "min_num_gen_samples": 8}
    return cut


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    work = tmp_path_factory.mktemp("qr")
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        small = functools.partial(Metrics, rocket_num_kernels=50)
        m.setattr(train, "Metrics", small)
        m.setattr(quality_run, "Metrics", small)
        args = quality_run.build_argparser().parse_args(
            ["--workdir", str(work), "--bf16", "--ess", "--n_eval", str(N_EVAL),
             "--device", "cpu"])
        summary, details = quality_run.run(args, overrides=_small_overrides())
    return work, summary, details


def test_cpu_run_prints_the_jax_summary(ran):
    work, summary, details = ran
    assert set(summary) == JAX_SUMMARY_KEYS
    for k, v in summary.items():
        if not isinstance(v, bool):
            assert np.isfinite(v), k
    assert summary["fid_noise"] > summary["fid_floor"]
    assert summary["bf16"] and summary["fast_bn"] and summary["bf16_mu"]
    for stage in ("stage1", "stage2", "stage3"):
        assert (work / "models" / "qr" / stage).exists()
        assert (work / "runs" / f"qr_{stage}" / "metrics.jsonl").exists()
    cfg = json.loads((work / "cfg.json").read_text())
    assert cfg["trainer_params"]["max_steps"]["stage1"] == 2
    # the plain VQ version counts no launches; ESS runs the LF prior at
    # least for the naive pass, the confidences and one retraction step
    assert details["vq_launches"] == {"train": 0, "rec": 0}
    assert set(details["stage_minutes"]) == set(details["step_ms_p50"]) == {
        "stage1", "stage2", "stage3"}
    assert details["ess"]["prior_forwards_per_batch"] >= 3 + 1 + 1


def test_generate_cli_runs_an_ess_config(ran, tmp_path, monkeypatch):
    work = ran[0]
    cfg = {**_small_overrides(), "MaskGIT": {**CFG["MaskGIT"], "ESS": {"use": True}}}
    (tmp_path / "ess.json").write_text(json.dumps(cfg))
    built, make = [], tsampler.make_ess_sampling_fn
    monkeypatch.setattr(tsampler, "make_ess_sampling_fn",
                        lambda *a, **k: built.append(1) or make(*a, **k))
    generate.main(["--config", str(tmp_path / "ess.json"), "--dataset_file",
                   str(work / "qr.npz"), "--model_save_dir", str(work / "models"),
                   "--synthetic_save_dir", str(tmp_path / "raw"),
                   "--synthetic_fidelity_dir", str(tmp_path / "fe"),
                   "--n_samples", "6", "--batch_size", "4", "--device", "cpu"])
    assert built  # the ESS branch built the sampler
    for path in (tmp_path / "raw" / "synthetic.npz", tmp_path / "fe" / "synthetic_fe.npz"):
        out = np.load(path)
        assert out["X"].shape[1:] == (4, 512) and np.isfinite(out["X"]).all()

