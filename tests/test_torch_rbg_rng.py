"""Port parity: the rbg training-rng option (``train --rbg_rng``, the
runner's ``rng_impl="rbg"``), the two cases of the JAX package's
``tests/test_rbg_rng.py`` on the port.

JAX's option picks XLA's counter-based generator for the stage-1 dropout
key; its runs under rbg and under threefry differ only in their dropout
masks. The port's masks come from torch's generator either way (on the card
Philox4x32-10, itself counter-based), so here the two runs agree exactly:
the JAX property, "the same up to the masks", with no masks to differ.
"""

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.train import runner

TINY = {  # the JAX test's tiny stage 1, dropout on so that masks are drawn
    "encoder": {"init_dim": 4, "hid_dim": 8, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}, "dropout": 0.3},
    "decoder": {"n_resnet_blocks": 1, "dropout": 0.3},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "dataset": {"batch_sizes": {"stage1": 4}},
}


class Losses:
    def __init__(self):
        self.loss = []

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.loss.append(float(metrics["train/loss"]))


def _run(rng_impl, steps):
    X, y = tdata.make_synthetic_trajectories(n=8, channels=2, length=64, seed=0)
    data = tdata.DatasetSplits(X_train=X, y_train=y[:, None], X_test=X[:0], y_test=y[:0, None],
                               scaler=None, n_classes=3)
    log = Losses()
    state = runner.train_stage1(Config.from_dict(TINY), data, max_steps=steps, seed=0,
                                device="cpu", log_interval=1, logger=log, rng_impl=rng_impl)
    return state, log.loss


def test_stage1_step_trains_under_rbg_keys():
    state, losses = _run("rbg", 3)
    assert state.step == 3 and len(losses) == 3
    assert np.isfinite(losses).all()


def test_rbg_and_threefry_agree_up_to_dropout_masks():
    (s_t, l_t), (s_r, l_r) = _run(None, 1), _run("rbg", 1)
    assert np.isfinite(l_t).all() and np.isfinite(l_r).all()
    assert abs(l_t[0] - l_r[0]) / max(abs(l_t[0]), 1e-6) < 0.5  # JAX's own bound
    sd_t, sd_r = s_t.model.state_dict(), s_r.model.state_dict()
    for k, v in sd_t.items():  # the port's masks do not depend on the option
        assert torch.equal(v, sd_r[k]), k


def test_train_cli_hands_rbg_to_stage1(monkeypatch, tmp_path):
    """``--rbg_rng`` reaches ``train_stage1`` as ``rng_impl="rbg"``, as the
    JAX CLI passes it."""
    from tvqvae_tpu_torch.scripts import train

    seen = {}
    monkeypatch.setattr(runner, "train_stage1", lambda *a, **kw: seen.update(kw))
    X, y = tdata.make_synthetic_trajectories(n=8, channels=2, length=64, seed=1)
    tdata.save_npz(str(tmp_path / "d.npz"), X, y)
    base = ["--dataset_file", str(tmp_path / "d.npz"), "--stage", "1", "--device", "cpu",
            "--model_save_dir", str(tmp_path / "m"), "--run_dir", str(tmp_path / "r")]
    train.main(base + ["--rbg_rng"])
    assert seen["rng_impl"] == "rbg"
    train.main(base)
    assert seen["rng_impl"] is None
