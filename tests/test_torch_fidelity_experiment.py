"""The stage-3 experiment tool's init-only arm, at tiny shapes.

``tools/stage3_fidelity_experiment.py --part jax --init_seed i [--port_init]``
runs JAX's stage-3 runner at ``--seed`` from init draw i of either package.
The runner derives its batch order (``device_epoch_indices(key(seed + 2))``)
and its dropout keys (``key(seed + 1)``) from the seed it is given
(``tvqvae_tpu/train/runner.py::train_stage3``), so the arm holds when the
runner always gets ``--seed`` and only the init tree changes with
``--init_seed``. The runner is replaced by a recorder of what it is handed;
JAX's ``init_stage3`` by a stand-in that returns its key (no compile); the
configs and the splits by an enhancer of dim 8, dim_mults (1,), L=16.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.data.dataset import DatasetSplits as JSplits
from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFE
from tvqvae_tpu.train import runner as jrunner
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.train.stage3 import init_stage3
from tvqvae_tpu_torch.utils import convert

N, C, L, B = 8, 4, 16, 4
SMALL = {"dataset": {"batch_sizes": {"stage3": B}},
         "fidelity_enhancer": {"dim": 8, "dim_mults": [1], "resnet_block_groups": 4}}


def _tool():
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "stage3_fidelity_experiment.py")
    spec = importlib.util.spec_from_file_location("stage3_fidelity_experiment", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Data:
    X_train = np.random.default_rng(0).normal(size=(N, C, L)).astype(np.float32)
    y_train = np.zeros(N, np.int32)
    X_test, y_test, scaler, n_classes = X_train[:2], y_train[:2], None, 1
    input_length, in_channels = L, C


@pytest.fixture(scope="module")
def tool():
    mod = _tool()
    data = _Data()
    mod._configs = lambda wd: (JConfig.from_dict(SMALL), Config.from_dict(SMALL))
    mod._data = lambda wd: (data, JSplits(data.X_train, data.y_train, data.X_test, data.y_test,
                                          None, 1))
    mod._xprime_train = lambda wd: data.X_train
    return mod


def _run(tool, tmp_path, monkeypatch, argv):
    """-> what the JAX runner was handed: its seed, the init it starts from
    (None where it keeps its own ``init_stage3``), three steps' batches and
    the dropout key."""
    seen = {}
    own = jrunner.init_stage3

    def train_stage3(jcfg, jdata, s1, save, *, seed, compute_dtype, fast_norm, **kw):
        seen["seed"] = seed
        seen["recipe"] = (compute_dtype, fast_norm)
        seen["init"] = (None if jrunner.init_stage3 is own
                        else jax.device_get(jrunner.init_stage3(None, None, None)))
        seen["order"] = [np.asarray(jrunner.device_epoch_indices(jax.random.key(seed + 2), s, N, B))
                         for s in range(3)]
        seen["dropout"] = np.asarray(jax.random.key_data(jax.random.key(seed + 1)))
        seen["name"] = os.path.basename(save)

    monkeypatch.setattr(jrunner, "train_stage3", train_stage3)
    tool.main(["--workdir", str(tmp_path), "--part", "jax", *argv])
    assert jrunner.init_stage3 is own  # restored
    return seen


def _jax_init_stage3(rng, fe, x):
    """Stands in for JAX's ``init_stage3`` (no compile): a tree of its key,
    after checking the enhancer and the example batch the tool hands it."""
    assert (fe.compute_dtype, fe.fast_norm, fe.dim_mults, fe.input_length) == (
        "bfloat16", True, (1,), L)
    assert x.shape == (B, C, L)
    return {"Unet1D_0": {"key": np.asarray(jax.random.key_data(rng))}}


def _leaves(tree):
    return [np.asarray(v) for _, v in sorted(convert._flatten(tree))]


def _equal(a, b):
    a, b = _leaves(a), _leaves(b)
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _port_draw(i):
    fe = FidelityEnhancer(L, C, 8, (1,), 4, compute_dtype="bfloat16", fast_norm=True)
    return convert.fe_to_jax(init_stage3(fe, torch.Generator().manual_seed(i), "cpu"))


def test_init_seed_changes_the_init_not_the_stream(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(jst3, "init_stage3", _jax_init_stage3)
    runs = {(src, i): _run(tool, tmp_path, monkeypatch,
                           ["--seed", "0", "--init_seed", str(i)]
                           + (["--port_init"] if src == "port" else []))
            for src in ("jax", "port") for i in (0, 1)}
    ref = runs[("jax", 0)]
    for (src, i), seen in runs.items():
        assert seen["name"] == f"init_{src}_s{i}" and seen["seed"] == 0
        assert seen["recipe"] == ("bfloat16", True)
        expected = (_jax_init_stage3(jax.random.key(i), JFE(L, C, 8, (1,), compute_dtype="bfloat16",
                                                            fast_norm=True), _Data.X_train[:B])
                    if src == "jax" else _port_draw(i))
        assert _equal(seen["init"], expected), (src, i)
        # the stream: the same batches and dropout key whatever the init
        assert all(np.array_equal(a, b) for a, b in zip(seen["order"], ref["order"]))
        assert np.array_equal(seen["dropout"], ref["dropout"])
    for src in ("jax", "port"):
        assert not _equal(runs[(src, 0)]["init"], runs[(src, 1)]["init"])


def test_without_init_seed_the_init_follows_the_seed(tool, tmp_path, monkeypatch):
    own = _run(tool, tmp_path, monkeypatch, ["--seed", "1"])
    assert own["name"] == "jax_s1" and own["seed"] == 1 and own["init"] is None
    converse = _run(tool, tmp_path, monkeypatch, ["--seed", "1", "--port_init"])
    assert converse["name"] == "jax_pinit_s1" and converse["seed"] == 1
    assert _equal(converse["init"], _port_draw(1))
    assert not _equal(converse["init"], _port_draw(0))
