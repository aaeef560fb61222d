"""The tools that compare source trees' quality runs (ROADMAP §3.2).

``tools/quality_tree_diff.py`` runs two trees' cut quality runs (on
demand, not here) and holds their stage checkpoints leaf by leaf; here its
comparison reads two tiny checkpoints written by ``utils/checkpoint.py``,
and its cut config loads as the port's ``Config`` at the small widths.
``tools/quality_arm_stats.py`` reads the card runs' SUMMARY lines by arm.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.scripts.quality_run import CFG_OVERRIDES
from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint

TOOL = Path(__file__).resolve().parents[1] / "tools" / "quality_tree_diff.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("quality_tree_diff", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(rng):
    return {"params": {"enc": {"Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                                          "bias": np.zeros(4, np.float32)}},
                       "vq": {"embed": rng.normal(size=(8, 4)).astype(np.float32)}},
            "step": np.int64(7)}


def test_compare_checkpoints(tool, tmp_path):
    base = _tree(np.random.default_rng(0))
    save_checkpoint(str(tmp_path / "a"), base, {"step": 7})
    save_checkpoint(str(tmp_path / "same"), _tree(np.random.default_rng(0)))
    same = tool.compare_checkpoints(str(tmp_path / "a"), str(tmp_path / "same"))
    assert same == {"leaves": 4, "differ": 0, "max_gap": 0.0, "max_leaf": None, "only_a": [],
                    "only_b": [], "shape": []}

    other = _tree(np.random.default_rng(0))
    other["params"]["enc"]["Conv_0"]["bias"][2] = 2.5e-3  # as a noise-gradient bias moves
    other["params"]["vq"]["embed"][1, 1] += 1e-6
    other["params"]["vq"]["extra"] = np.ones(2, np.float32)
    other["step"] = np.zeros((1,), np.int64)
    save_checkpoint(str(tmp_path / "b"), other)
    r = tool.compare_checkpoints(str(tmp_path / "a"), str(tmp_path / "b"))
    assert (r["leaves"], r["differ"], r["max_leaf"]) == (4, 2, "params/enc/Conv_0/bias")
    assert r["max_gap"] == pytest.approx(2.5e-3, rel=1e-6)
    assert (r["only_a"], r["only_b"], r["shape"]) == ([], ["params/vq/extra"], ["step"])


def test_cut_overrides_load_at_small_widths(tool, tmp_path):
    cut = tool.cut_overrides(CFG_OVERRIDES, 2)
    (tmp_path / "cfg.json").write_text(json.dumps(cut))
    cfg = load_config(str(tmp_path / "cfg.json"))
    assert cfg.encoder.hid_dim == 16 and cfg.vqvae.codebook_sizes == {"lf": 8, "hf": 8}
    assert cfg.trainer_params.max_steps == {"stage1": 2, "stage2": 2, "stage3": 2}
    assert cfg.dataset.batch_sizes == CFG_OVERRIDES["dataset"]["batch_sizes"]
    assert cfg.evaluation.feature_extractor_type == "rocket"


def test_arm_stats_reads_summaries_and_rules(tmp_path):
    """``tools/quality_arm_stats.py``: the last SUMMARY line of each log, the
    median's verdict by ROADMAP §3.2's rule, and Mann-Whitney's exact p."""
    spec = importlib.util.spec_from_file_location(
        "quality_arm_stats", TOOL.with_name("quality_arm_stats.py"))
    stats = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stats)
    rows = {"head": [0.0104, 0.012, 0.009, 0.0168], "low": [0.0057, 0.006, 0.0071]}
    for name, vals in rows.items():
        for i, v in enumerate(vals):
            s = {"fid_gen": v, "fid_gen_ess": v, "fid_gen_fe": 0.02, "fid_rec": 3e-4,
                 "train_minutes": 2.7}
            (tmp_path / f"{name}{i}.log").write_text(
                "[stage1] ...\nSUMMARY " + json.dumps({**s, "fid_gen": 1.0}) + "\n"
                + "SUMMARY " + json.dumps(s) + "\n")
    out = stats.main(["--against", "head", "--group", f"head={tmp_path}/head*.log",
                      "--group", f"low={tmp_path}/low*.log"])
    assert out["head"]["median"] == pytest.approx(0.0112) and "p_below" not in out["head"]
    assert out["head"]["verdict"] == "reads as the head's"
    assert out["low"]["fid_gen"] == rows["low"]
    assert out["low"]["verdict"] == "reads as the baseline tree's"
    assert out["low"]["U"] == 0 and out["low"]["p_below"] == pytest.approx(1 / 35)
    assert stats.verdict(0.008, 0.0075, 0.009) == "between: run 3 more"
