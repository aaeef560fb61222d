"""Port parity: the stage-3 runner, past two epochs and the warmup.

Both packages' ``train_stage3`` runners train the fidelity enhancer over
the same frozen stage 1 (the JAX package's init, written as its checkpoint
and carried across with ``utils/convert.py``), from the same enhancer init
(the JAX package's ``init_stage3(jax.random.key(seed), ...)``, loaded into
the port in place of its own draw) and on the same batches (the JAX
runner's ``device_epoch_indices(jax.random.key(seed + 2), step, N, B)``,
handed to the port in place of its ``make_batches`` order). The enhancer's
dropout is 0: masks cannot match across frameworks.

N=40 series at L=64, B=8: 5 steps an epoch, 30 steps (six epochs), the
warmup 3 steps at ``linear_warmup_rate`` 0.1. Tolerances are the ten-step
test's (``tests/test_torch_stage3.py``): every leaf within 1e-4 + 1e-4
relative of JAX's. None needs the Adam sign-step rule (a leaf whose
gradient a norm cancels moves by up to lr a step either way): the
``WSConv1d`` biases in front of each GroupNorm hold the tight bound too.
The enhancer's output on fixed series is held to 2e-4, the U-Net's forward
tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.data.dataset import DatasetSplits as JSplits
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.stage1 import init_stage1 as j_init_stage1
from tvqvae_tpu.train import runner as jrunner
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu.utils import checkpoint as jckpt
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint

C, L, N, B, STEPS, SEED = 4, 64, 40, 8, 30, 0
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4,
                          "dropout": 0.0},
    "dataset": {"batch_sizes": {"stage3": B}},
    "exp_params": {"lr": 1e-3, "linear_warmup_rate": 0.1},
    "trainer_params": {"val_check_interval": {"stage3": 1000}},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_fe(cfg):
    f = cfg.fidelity_enhancer
    return jfe.FidelityEnhancer(input_length=L, in_channels=C, dim=f.dim,
                                dim_mults=tuple(f.dim_mults),
                                resnet_block_groups=f.resnet_block_groups, dropout=f.dropout)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage3_runner")
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, L, dtype=np.float32)
    X = (np.sin(2 * np.pi * (t[None, None] * rng.uniform(0.5, 2, (N + 8, C, 1))
                             + rng.uniform(0, 1, (N + 8, C, 1))))
         + 0.1 * rng.normal(size=(N + 8, C, L))).astype(np.float32)
    y = rng.integers(0, 3, (N + 8, 1))
    jcfg, cfg = JConfig.from_dict(CFG), Config.from_dict(CFG)

    # the frozen stage 1: the JAX package's init with random BatchNorm
    # statistics, written as its checkpoint
    js1 = JStage1Spec.from_config(jcfg, L, C)
    _, params, stats, vq_l, vq_h = jax.device_get(
        j_init_stage1(jax.random.key(1), js1, jnp.zeros((2, C, L))))
    srng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (srng.uniform(0.5, 1.5, s.shape) if p[-1].key == "var"
                      else 0.1 * srng.normal(size=s.shape)).astype(np.float32), stats)
    tree = {"params": params, "batch_stats": stats,
            "vq_l": jrunner.codebook_to_dict(vq_l), "vq_h": jrunner.codebook_to_dict(vq_h),
            "step": np.asarray(0)}
    jdata = JSplits(X[:N], y[:N], X[N:], y[N:], None, 3)
    s1_path = str(tmp / "stage1")
    jckpt.save_checkpoint(s1_path, tree, meta=jrunner.config_meta(jcfg, jdata))

    # the JAX runner, and the init it draws
    j_path = str(tmp / "stage3_jax")
    jrunner.train_stage3(jcfg, jdata, s1_path, j_path, max_steps=STEPS, seed=SEED)
    j_final = jckpt.load_checkpoint(j_path)[0]
    j_init = jax.device_get(jst3.init_stage3(jax.random.key(SEED), _j_fe(jcfg),
                                             jnp.asarray(X[:min(4, B)])))
    key = jax.random.key(SEED + 2)
    order = np.stack([np.asarray(jrunner.device_epoch_indices(key, s, N, B))
                      for s in range(STEPS)])

    # the port's runner over the same stage 1 (the same tree in the port's
    # checkpoint format), init and batches
    port_s1 = str(tmp / "stage1.npz")
    save_checkpoint(port_s1, tree, meta=jrunner.config_meta(jcfg, jdata))
    frozen, _, _ = runner.load_stage1_bundle(cfg, port_s1, device="cpu")
    mp = pytest.MonkeyPatch()

    def init_from_jax(fe, generator, dev):
        fe.load_state_dict(convert.fe_from_jax(j_init))
        return fe.to(dev)

    mp.setattr(runner, "init_stage3", init_from_jax)
    mp.setattr(runner, "_batch_order",
               lambda n, b, steps, seed, dev: torch.from_numpy(order[:steps]).to(dev))
    try:
        data = DatasetSplits(X[:N], y[:N], X[N:], y[N:], None, 3)
        state = runner.train_stage3(cfg, data, frozen, max_steps=STEPS, seed=SEED,
                                    device="cpu")
    finally:
        mp.undo()
    return dict(cfg=jcfg, j_init=j_init, j_final=j_final, state=state, order=order)


def test_the_run_spans_two_epochs_and_the_warmup(runs):
    order = runs["order"]
    per_epoch = N // B
    assert STEPS >= 2 * per_epoch and int(STEPS * CFG["exp_params"]["linear_warmup_rate"]) < STEPS
    for e in range(STEPS // per_epoch):  # each epoch a permutation of the rows
        assert sorted(order[e * per_epoch:(e + 1) * per_epoch].ravel()) == list(range(N))
    assert runs["state"].step == STEPS and int(runs["j_final"]["step"]) == STEPS
    # the leaves moved far beyond the tolerance they are held to below
    init = convert.fe_from_jax(runs["j_init"])
    moved = max(float((v - init[k]).abs().max())
                for k, v in convert.fe_from_jax(runs["j_final"]["params"]).items())
    assert moved > 100 * 1e-4


def test_enhancer_leaves_match_jax_after_the_run(runs):
    ref = convert.fe_from_jax(runs["j_final"]["params"])
    ours = runs["state"].fe.state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_enhancer_output_matches_jax_after_the_run(runs):
    x = np.random.default_rng(5).normal(size=(6, C, L)).astype(np.float32)
    ref = np.asarray(_j_fe(runs["cfg"]).apply({"params": runs["j_final"]["params"]},
                                              jnp.asarray(x), False))
    with torch.no_grad():
        out = runs["state"].fe.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
