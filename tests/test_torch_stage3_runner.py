"""Port parity: the stage-3 runner, past two epochs and the warmup.

Both packages' ``train_stage3`` runners train the fidelity enhancer over
the same frozen stage 1 (random weights in the JAX package's tree, written
as its checkpoint and carried across with ``utils/convert.py``), from the
same enhancer init (a numpy draw in the tree of the JAX package's
``init_stage3``, taken by both runners in place of their own draws; the
trees are traced, not compiled, so the file stays under two minutes) and
on the same batches (the JAX runner's ``device_epoch_indices(
jax.random.key(seed + 2), step, N, B)``, handed to the port in place of
its ``make_batches`` order). N=40 series at L=64, B=8: 5 steps an epoch.
Two cases:

  - ``narrow``: dim_mults (1, 2), dropout 0, 30 steps (six epochs; the
    warmup 3 steps at ``linear_warmup_rate`` 0.1).
  - ``published``: the published enhancer widths (dim 8, dim_mults
    (1, 2, 4, 8), 4 groups) with the published dropout 0.5, 10 steps
    (two epochs; warmup 1 step). Random streams never match across
    frameworks, so the dropout masks are the JAX runner's: each step's
    dropout key is derived as its step derives it from
    ``jax.random.key(seed + 1)``, the masks are recorded from one enhancer
    forward under ``nn.intercept_methods``, and the port's
    ``fidelity_enhancer.dropout`` takes them in order
    (``chip_smoke.py::MaskTape``); the run takes
    exactly as many as JAX drew. At these widths a rounding difference
    grows through training, in JAX as in the port: the JAX runner (its
    batch sharded over the 8 host devices) against the same steps in one
    jitted loop lies 0.008 of the leaf bound and 5.1e-5 in the output
    apart after 10 steps, and 2.3x the leaf bound and 1.4e-2 in the
    output after 15; the L1 loss's sign flips make the growth uneven. Ten
    steps is inside that horizon.

Tolerances are the ten-step test's (``tests/test_torch_stage3.py``): every
leaf within 1e-4 + 1e-4 relative of JAX's. None needs the Adam sign-step
rule (a leaf whose gradient a norm cancels moves by up to lr a step either
way): the ``WSConv1d`` biases in front of each GroupNorm hold the tight
bound too. The enhancer's output on fixed series is held to 2e-4, the
U-Net's forward tolerance.
"""

import numpy as np
import pytest
import torch
from test_torch_parallel import _random_tree
from test_torch_stage3_dropout import dropout_key, mask_collector, to_port_masks

from chip_smoke import MaskTape

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.data.dataset import DatasetSplits as JSplits
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.models.vq import init_codebook as j_init_codebook
from tvqvae_tpu.train import runner as jrunner
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu.utils import checkpoint as jckpt
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint

C, L, N, B, SEED = 4, 64, 40, 8, 0
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
# case -> (enhancer overrides, steps, the least largest move of a leaf, in tolerances)
CASES = {"narrow": ({}, 30, 100),
         "published": ({"dim_mults": [1, 2, 4, 8], "dropout": 0.5}, 10, 40)}
# the dropouts of one forward at the published widths: 2 per ResnetBlock, 19 blocks
N_DROPOUTS = 38


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
def stage1(tmp_path_factory):
    """The series and the frozen stage 1 both cases train over: the JAX
    package's codebook init and random weights and BatchNorm statistics in
    its tree, written as its checkpoint and as the port's."""
    tmp = tmp_path_factory.mktemp("stage3_runner")
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, L, dtype=np.float32)
    X = (np.sin(2 * np.pi * (t[None, None] * rng.uniform(0.5, 2, (N + 8, C, 1))
                             + rng.uniform(0, 1, (N + 8, C, 1))))
         + 0.1 * rng.normal(size=(N + 8, C, L))).astype(np.float32)
    y = rng.integers(0, 3, (N + 8, 1))
    jcfg = JConfig.from_dict(CFG)
    js1 = JStage1Spec.from_config(jcfg, L, C)
    vq_l, vq_h = (j_init_codebook(jax.random.key(i), p) for i, p in ((1, js1.vq_l), (2, js1.vq_h)))
    # the weights' shapes traced, not compiled (an init compiles for ~14 s)
    shapes = jax.eval_shape(lambda: JStage1Model(js1).init(jax.random.key(0), jnp.zeros((2, C, L)),
                                                           vq_l, vq_h))
    srng = np.random.default_rng(2)
    params, stats = (jax.device_get(_random_tree(shapes[k], srng))
                     for k in ("params", "batch_stats"))
    tree = {"params": params, "batch_stats": stats,
            "vq_l": jrunner.codebook_to_dict(vq_l), "vq_h": jrunner.codebook_to_dict(vq_h),
            "step": np.asarray(0)}
    jdata = JSplits(X[:N], y[:N], X[N:], y[N:], None, 3)
    paths = {"jax": str(tmp / "stage1"), "port": str(tmp / "stage1.npz")}
    jckpt.save_checkpoint(paths["jax"], tree, meta=jrunner.config_meta(jcfg, jdata))
    save_checkpoint(paths["port"], tree, meta=jrunner.config_meta(jcfg, jdata))
    return X, y, jdata, paths, tmp


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, stage1):
    overrides, steps, _ = CASES[request.param]
    case = {**CFG, "fidelity_enhancer": {**CFG["fidelity_enhancer"], **overrides}}
    X, y, jdata, paths, tmp = stage1
    jcfg, cfg = JConfig.from_dict(case), Config.from_dict(case)
    s1_path = paths["jax"]

    # the JAX runner, from a numpy draw in its init's tree (shapes traced,
    # not compiled: the init compiles for ~10-14 s)
    def init_stage3(rng, fe, x):
        shapes = jax.eval_shape(lambda: jst3.init_stage3(rng, fe, x))
        return _random_tree(shapes, np.random.default_rng(3))

    j_path = str(tmp / f"stage3_jax_{request.param}")
    j_init = jax.device_get(init_stage3(jax.random.key(SEED), _j_fe(jcfg), jnp.zeros((B, C, L))))
    mp = pytest.MonkeyPatch()
    mp.setattr(jrunner, "init_stage3", init_stage3)
    try:
        jrunner.train_stage3(jcfg, jdata, s1_path, j_path, max_steps=steps, seed=SEED)
    finally:
        mp.undo()
    j_final = jckpt.load_checkpoint(j_path)[0]
    key = jax.random.key(SEED + 2)
    order = np.stack([np.asarray(jrunner.device_epoch_indices(key, s, N, B))
                      for s in range(steps)])
    masks = []
    if jcfg.fidelity_enhancer.dropout > 0:  # each step's, drawn from key(seed + 1)
        collect, rng = mask_collector(_j_fe(jcfg)), jax.random.key(SEED + 1)
        xp = jnp.zeros((B, C, L))  # the masks depend on the key and the shapes alone
        masks = [to_port_masks(collect(j_init, xp, dropout_key(rng, s))) for s in range(steps)]

    # the port's runner over the same stage 1 (the same tree in the port's
    # checkpoint format), init and batches
    frozen, _, _ = runner.load_stage1_bundle(cfg, paths["port"], device="cpu")
    mp = pytest.MonkeyPatch()

    def init_from_jax(fe, generator, dev):
        fe.load_state_dict(convert.fe_from_jax(j_init))
        return fe.to(dev)

    mp.setattr(runner, "init_stage3", init_from_jax)
    mp.setattr(runner, "_batch_order",
               lambda n, b, steps, seed, dev: torch.from_numpy(order[:steps]).to(dev))
    feed = MaskTape(torch)
    feed.load([m for step in masks for m in step])
    mp.setattr(tfe, "dropout", feed)
    try:
        data = DatasetSplits(X[:N], y[:N], X[N:], y[N:], None, 3)
        state = runner.train_stage3(cfg, data, frozen, max_steps=steps, seed=SEED,
                                    device="cpu")
    finally:
        mp.undo()
    return dict(cfg=jcfg, j_init=j_init, j_final=j_final, state=state, order=order,
                masks=masks, taken=feed.pos, steps=steps, case=request.param)


def test_the_run_spans_two_epochs_and_the_warmup(runs):
    order = runs["order"]
    per_epoch = N // B
    steps = runs["steps"]
    assert steps >= 2 * per_epoch and int(steps * CFG["exp_params"]["linear_warmup_rate"]) < steps
    for e in range(steps // per_epoch):  # each epoch a permutation of the rows
        assert sorted(order[e * per_epoch:(e + 1) * per_epoch].ravel()) == list(range(N))
    assert runs["state"].step == steps and int(runs["j_final"]["step"]) == steps
    if runs["cfg"].fidelity_enhancer.dropout > 0:
        # every forward took the masks of one JAX step, none left over
        assert [len(m) for m in runs["masks"]] == [N_DROPOUTS] * steps
        assert runs["taken"] == N_DROPOUTS * steps
    # the leaves moved far beyond the tolerance they are held to below
    init = convert.fe_from_jax(runs["j_init"])
    moved = max(float((v - init[k]).abs().max())
                for k, v in convert.fe_from_jax(runs["j_final"]["params"]).items())
    assert moved > CASES[runs["case"]][2] * 1e-4


def test_enhancer_leaves_match_jax_after_the_run(runs):
    ref = convert.fe_from_jax(runs["j_final"]["params"])
    ours = runs["state"].fe.state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_enhancer_output_matches_jax_after_the_run(runs):
    x = np.random.default_rng(5).normal(size=(6, C, L)).astype(np.float32)
    fe = _j_fe(runs["cfg"])
    ref = np.asarray(jax.jit(lambda p, x: fe.apply({"params": p}, x, False))(
        runs["j_final"]["params"], jnp.asarray(x)))
    with torch.no_grad():
        out = runs["state"].fe.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
