"""Port parity: the analysis CLI and the evaluate CLI's images, on the CPU.

- ``analyze``: the port's CLI and the JAX package's on the same dataset,
  generated ``.npz`` and flyability distances JSON (30 ROCKET kernels):
  the same artifact names, and ``quality_metrics.json`` equal (FID to
  1e-5 relative, the statistics to 1e-10, as the evaluation tests hold
  them); ``run(args, figures=False)`` in a fresh process computes every
  figure's data and the metrics, writes no image and imports no
  matplotlib.
- ``evaluate``: over seeded stage checkpoints written with the port's
  writers, the CLI writes the JAX CLI's image file names (read from its
  source) into its run directory; ``run(args, figures=False)`` computes the
  same images' data (the PCA and t-SNE points, one conditional batch a
  class) and writes none.
"""

import functools
import inspect
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tvqvae_tpu.data import make_synthetic_trajectories as j_make
from tvqvae_tpu.data import save_npz as j_save
from tvqvae_tpu.scripts import analyze as janalyze
from tvqvae_tpu.scripts import evaluate as jevaluate
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import build_transformers
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.scripts import analyze, evaluate
from tvqvae_tpu_torch.train.stage2 import init_stage2
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, L, N_CLASSES, KERNELS = 4, 64, 3, 30
KEYS = ["SSPD Euclidean", "SSPD Spherical", "DTW Euclidean", "DTW Spherical",
        "Hausdorff Euclidean", "Hausdorff Spherical", "LCSS Euclidean", "LCSS Spherical",
        "ERP Euclidean", "ERP Spherical", "EDR Euclidean", "EDR Spherical",
        "Discrete Frechet", "Frechet"]
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 8, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 6, "hf": 7}},
    "MaskGIT": {"T": {"lf": 3, "hf": 1},
                "prior_model_l": {"hidden_dim": 8, "n_layers": 1, "heads": 1, "ff_mult": 1},
                "prior_model_h": {"hidden_dim": 8, "n_layers": 1, "heads": 1, "ff_mult": 1}},
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4},
    "evaluation": {"batch_size": 4, "min_num_gen_samples": 8},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("analyze")
    X, y = j_make(n=60, channels=C, length=L, n_classes=N_CLASSES, seed=3)
    j_save(str(root / "flights.npz"), X, y)
    Xg = X[:12] + np.random.default_rng(0).normal(0, 0.05, X[:12].shape)
    np.savez_compressed(str(root / "synthetic.npz"), X=Xg.astype(np.float32),
                        y=np.zeros(12, np.int64))
    rng = np.random.default_rng(1)
    with open(root / "distances.json", "w") as f:
        json.dump({"per_flight": {k: rng.random(12).tolist() for k in KEYS}}, f)
    return root


def _analyze_argv(root, save):
    return ["--dataset_file", str(root / "flights.npz"), "--synthetic_file",
            str(root / "synthetic.npz"), "--distances_json", str(root / "distances.json"),
            "--save_dir", str(save), "--rocket_num_kernels", str(KERNELS)]


@pytest.fixture(scope="module")
def analyzed(files):
    janalyze.main(_analyze_argv(files, files / "jax"))
    args = analyze.build_argparser().parse_args(
        _analyze_argv(files, files / "port") + ["--device", "cpu"])
    return analyze.run(args)


def test_analyze_writes_the_jax_artifacts(files, analyzed):
    jax_names = sorted(os.listdir(files / "jax"))
    assert "pca.png" in jax_names and "tsne.png" in jax_names
    assert sorted(os.listdir(files / "port")) == jax_names
    assert set(analyzed["figures"]) == set(jax_names) - {"quality_metrics.json"}


def test_analyze_quality_metrics_match_jax(files, analyzed):
    ours = json.loads((files / "port" / "quality_metrics.json").read_text())
    theirs = json.loads((files / "jax" / "quality_metrics.json").read_text())
    assert set(ours) == set(theirs) == {"FID", "MDD", "ACD", "SD", "KD"}
    np.testing.assert_allclose(ours["FID"], theirs["FID"], rtol=1e-5)
    for k in ("MDD", "ACD", "SD", "KD"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-10, err_msg=k)
    assert ours == analyzed["results"]


def test_analyze_reports_its_seconds_and_embeddings(analyzed):
    assert {"load", "rocket", "fid", "stat_metrics", "pca", "tsne", "distances"} <= set(
        analyzed["seconds"])
    tsne = analyzed["figures"]["tsne.png"]
    assert [len(e) for _, e in tsne["sets"]] == [6, 12]
    assert np.isfinite(tsne["kl_divergence"]) and 0.0 < tsne["trustworthiness"] <= 1.0
    corr = analyzed["figures"]["correlation_heatmap_spherical.png"]
    assert corr.shape == (6, 6) and np.allclose(np.diag(corr), 1.0)


def test_analyze_without_figures_draws_nothing_and_imports_no_matplotlib(files, tmp_path):
    save = tmp_path / "nofig"
    code = (
        "import json, sys\n"
        "from tvqvae_tpu_torch.scripts import analyze\n"
        f"args = analyze.build_argparser().parse_args({_analyze_argv(files, save)!r}"
        " + ['--device', 'cpu'])\n"
        "out = analyze.run(args, figures=False)\n"
        "assert not any(m.split('.')[0] == 'matplotlib' for m in sys.modules), 'matplotlib'\n"
        "print(json.dumps({'figures': sorted(out['figures']), 'results': out['results']}))\n")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert os.listdir(save) == ["quality_metrics.json"]
    jax_names = set(os.listdir(files / "jax")) - {"quality_metrics.json"}
    assert set(got["figures"]) == jax_names
    want = json.loads((files / "port" / "quality_metrics.json").read_text())
    assert got["results"] == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# the evaluate CLI's images


@pytest.fixture(scope="module")
def stages(files):
    """Seeded stage checkpoints at CFG, written as the runners write them."""
    models = files / "models" / "flights"
    cfg = Config.from_dict(CFG)
    g = torch.Generator().manual_seed(0)
    spec = Stage1Spec.from_config(cfg, L, C)
    model, vq_l, vq_h = init_stage1(spec, g, "cpu")
    t_l, t_h = init_stage2(*build_transformers(cfg, spec, N_CLASSES), g, "cpu")
    fe = init_weights_(FidelityEnhancer.from_config(cfg, L, C), g)
    meta = {"input_length": L, "in_channels": C, "n_classes": N_CLASSES}
    params, h_stats = convert.prior_to_jax(t_l, t_h)
    trees = {"stage1": convert.stage1_to_jax(model, vq_l, vq_h),
             "stage2": {"params": params, "h_stats": h_stats},
             "stage3": {"params": convert.fe_to_jax(fe), "tau": np.float32(0.0)},
             "fcn": convert.fcn_to_jax(init_weights_(FCN(C, N_CLASSES), g))}
    for name, tree in trees.items():
        save_checkpoint(str(models / name), tree, meta=meta)
    (files / "cfg.json").write_text(json.dumps(CFG))
    return ["--dataset_file", str(files / "flights.npz"), "--config", str(files / "cfg.json"),
            "--model_save_dir", str(files / "models"), "--device", "cpu",
            "--min_num_gen_samples", "8", "--fid_method", "svd"]


def _jax_image_names(n_classes):
    src = inspect.getsource(jevaluate.evaluate)
    names = re.findall(r'f?"([\w{}]+\.png)"', src)
    assert "conditional_class_{cls}.png" in names
    return {n.format(cls=c) for n in names for c in range(n_classes)}


@pytest.mark.parametrize("figures", [True, False])
def test_evaluate_writes_the_jax_cli_images(files, stages, tmp_path, monkeypatch, figures):
    monkeypatch.setattr(evaluate, "Metrics", functools.partial(Metrics, rocket_num_kernels=50))
    args = evaluate.build_argparser().parse_args([*stages, "--run_dir", str(tmp_path)])
    out = evaluate.run(args, figures=figures)
    n_classes = get_data(str(files / "flights.npz"), Config().dataset.features).n_classes
    want = _jax_image_names(n_classes)
    assert set(out["images"]) == want
    written = {f for f in os.listdir(tmp_path / "flights_evaluate") if f.endswith(".png")}
    assert written == (want if figures else set())
    pca = out["images"]["pca_test_gen_fe.png"]
    assert [label for label, _ in pca["sets"]] == ["Z_test", "Z_gen_FE"]
    assert all(np.isfinite(e).all() for _, e in pca["sets"])
    for c in range(n_classes):
        assert out["images"][f"conditional_class_{c}.png"].shape == (4, C, L)
    assert np.isfinite(list(out["results"].values())).all()


def test_chip_smoke_checks_the_jax_cli_image_names():
    """``chip_smoke.py`` checks the evaluate CLI's images against
    ``JAX_EVAL_IMAGES`` and one conditional grid a class."""
    from chip_smoke import JAX_EVAL_IMAGES

    want = {*JAX_EVAL_IMAGES, *(f"conditional_class_{c}.png" for c in range(N_CLASSES))}
    assert _jax_image_names(N_CLASSES) == want
