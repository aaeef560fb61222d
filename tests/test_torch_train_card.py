"""The stage-1 training step on the card: the VQ kernel feeding the EMA.

Torch only, so the card's machine (no JAX) runs it:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_train_card.py

The ``gpu`` cases skip without a card. A small stage 1 (L=127, hid_dim 16,
codebooks 8/8, dropout 0) trains on the card twice from the same seeded
weights: once through the CUDA kernel, once with the VQ's plain twin put in
its place. cuDNN's backward convolutions are not bit-deterministic, so the
two are held to tolerances: indices equal at every step, losses to 1e-5
relative, codebook statistics to 1e-4.
"""

import functools

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits
from tvqvae_tpu_torch.models import vq as vq_module
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.ops import vq_kernel
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.train.runner import train_stage1
from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step
from tvqvae_tpu_torch.utils.scaler import MinMaxScaler
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

L, C, B = 127, 4, 8
SMALL = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}, "dropout": 0.0},
    "decoder": {"n_resnet_blocks": 1, "dropout": 0.0},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
}
CFG = Config.from_dict(SMALL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the VQ kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _state(seed=0):
    spec = Stage1Spec.from_config(CFG, L, C)
    model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(seed), "cuda")
    tx = functools.partial(adamw, learning_rate=warmup_cosine_schedule(1e-3, 40), weight_decay=0.01)
    state = create_stage1_state(model, vq_l, vq_h, tx)
    seen = []
    model.register_forward_hook(lambda m, i, o: seen.append((o.vq_l.indices, o.vq_h.indices)))
    return state, seen


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, C, L)).astype(np.float32)).cuda() for _ in range(n)]


@pytest.mark.gpu
def test_train_step_kernel_matches_plain_twin_on_card(card, monkeypatch):
    step = make_stage1_train_step()
    xs = _batches(3)
    kernel, k_seen = _state()
    before = vq_kernel.launch_count
    k_loss = [step(kernel, x)[1]["loss"].item() for x in xs]
    assert vq_kernel.launch_count - before == 2 * len(xs)
    monkeypatch.setattr(vq_module, "nearest_codes_stats", vq_kernel.nearest_codes_stats_plain)
    plain, p_seen = _state()
    p_loss = [step(plain, x)[1]["loss"].item() for x in xs]
    for t, (a, b) in enumerate(zip(k_seen, p_seen)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), f"indices differ at step {t + 1}"
    np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5)
    for band in ("vq_l", "vq_h"):
        for f in ("embed", "embed_avg", "cluster_size"):
            torch.testing.assert_close(getattr(getattr(kernel, band), f),
                                       getattr(getattr(plain, band), f), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_train_steps_hold_no_memory_across_steps_on_card(card):
    """The codebook update stores tensors outside the graph: after the
    optimizer's state exists, 20 more steps leave the allocation unchanged."""
    step = make_stage1_train_step()
    state, seen = _state()
    xs = _batches(4)
    sizes = []
    for t in range(23):
        step(state, xs[t % len(xs)])
        seen.clear()
        torch.cuda.synchronize()
        sizes.append(torch.cuda.memory_allocated())
    assert sizes[3:] == [sizes[3]] * 20, sizes
    assert not state.vq_h.embed.requires_grad and state.vq_h.embed.grad_fn is None


@pytest.mark.gpu
def test_train_stage1_on_card_launches_two_per_step_and_per_val_batch(card):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40, C, L)).astype(np.float32)
    data = DatasetSplits(X[:32], np.zeros((32, 1)), X[32:], np.zeros((8, 1)), MinMaxScaler(), 1)
    cfg = Config.from_dict({**SMALL, "dataset": {"batch_sizes": {"stage1": B}},
                            "trainer_params": {"val_check_interval": {"stage1": 5}}})
    before = vq_kernel.launch_count
    state = train_stage1(cfg, data, max_steps=10, device="cuda")
    # two validations (steps 5 and 10) of one 8-series batch each
    assert vq_kernel.launch_count - before == 2 * 10 + 2 * 2
    assert state.step == 10 and state.vq_l.embed.is_cuda
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_stage1_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_stage1(CFG, None, max_steps=1)
