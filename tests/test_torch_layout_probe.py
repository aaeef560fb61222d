"""``tools/layout_probe.py``: the loaded stage 1 in both weight layouts.

On the card the probe names the kernels each layout launches (ROADMAP
§3.2); here, on the CPU, it must load the same stage 1 both ways, leave
the old copy's kernels with permuted strides, and find the two layouts'
latents, tokens and decoder outputs equal (the CPU's convolutions do not
depend on the weights' strides).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.utils import convert

TOOL = Path(__file__).resolve().parents[1] / "tools" / "layout_probe.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("layout_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_any_order_copies_keep_the_transpose(tool):
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4).transpose(2, 1, 0)
    saved = convert._tensor
    with tool.any_order_copies():
        kept = convert._tensor(arr)
    assert convert._tensor is saved
    contiguous = convert._tensor(arr)
    assert not kept.is_contiguous() and contiguous.is_contiguous()
    assert torch.equal(kept, contiguous)


def test_probe_on_the_cpu(tool):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tool.probe("cpu", n=16, seed=0)
    finally:
        torch.set_num_threads(threads)
    assert out["permuted_weights"]
    assert all(k.endswith(".weight") for k in out["permuted_weights"])
    assert [r["band"] for r in out["bands"]] == ["lf", "hf"]
    for r in out["bands"]:
        assert r["contiguous_repeat_equal"] and r["layouts_equal"] and r["decode_layouts_equal"]
        assert r["layouts_max_abs_gap"] == 0.0 and r["tokens_differ_between_layouts"] == 0
        assert r["contiguous_vs_f64_max_abs"] == r["permuted_vs_f64_max_abs"]
        assert 0.0 < r["contiguous_vs_f64_max_abs"] < 1e-4 * r["latent_absmax_f64"]
        assert r["kernels_only_contiguous"] == r["kernels_only_permuted"] == {}
