"""Port parity on the sampler side after training: the enhancer's FID test.

The quality run's ``fid_gen_fe`` sits above the reference's spread while
``fid_gen`` sits inside it, and every parity test of the sampler ran on
initialised weights. Here the port trains stages 1-3 for a few steps on the
CPU at the small shapes of ``tests/test_torch_sampler.py`` (6 steps each, on
40 synthetic series, dropout as configured), its trained states are carried
to the JAX package with ``utils/convert.py``'s ``stage1_to_jax``,
``prior_to_jax`` and ``fe_to_jax``, and both packages sample and enhance
from them with JAX's Gumbel draws handed to the port. Tolerances: tokens
exactly; x_l, x_h and the enhanced series within 2e-4 of their scale (the
float32 stacks; the enhancer on top); ``enhance`` of the same series within
2e-4 of scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_sampler import CFG, C, L, N_CLASSES, jax_decode_noise
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFidelityEnhancer
from tvqvae_tpu.models.stage1 import Stage1Model as JStage1Model
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.train.runner import codebook_from_dict as j_codebook_from_dict
from tvqvae_tpu.train.stage2 import make_prior_apply_fns, make_sampling_fn
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, iterative_decoding
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils.convert import fe_to_jax, prior_to_jax, stage1_to_jax

STEPS, NUM = 6, 4


def _scale_gap(a, ref) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def trained():
    """The port's stages 1-3 after STEPS steps each, as the JAX package's
    trees, and both packages' samplers over them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        X, y = tdata.make_synthetic_trajectories(n=40, channels=C, length=L, n_classes=N_CLASSES,
                                                 seed=3)
        data = tdata.DatasetSplits(X_train=X[:32], y_train=y[:32, None], X_test=X[32:],
                                   y_test=y[32:, None], scaler=None, n_classes=N_CLASSES)
        cfg = Config.from_dict({**CFG, "dataset": {"batch_sizes": {"stage1": 8, "stage2": 8,
                                                                    "stage3": 8}}})
        st1 = runner.train_stage1(cfg, data, max_steps=STEPS, device="cpu")
        frozen = FrozenStage1.from_stage1_state(st1)
        st2 = runner.train_stage2(cfg, data, frozen, max_steps=STEPS, device="cpu")
        st3 = runner.train_stage3(cfg, data, frozen, max_steps=STEPS, device="cpu")
    finally:
        torch.set_num_threads(n)
    tree1 = stage1_to_jax(st1.model, st1.vq_l, st1.vq_h)
    p2, h_stats = prior_to_jax(st2.t_l.eval(), st2.t_h.eval())
    stage3 = {"params": fe_to_jax(st3.fe), "tau": np.float32(0.0)}
    port = TrainedModelSampler(cfg, tree1, {"params": p2, "h_stats": h_stats},
                               input_length=L, in_channels=C, n_classes=N_CLASSES, batch_size=NUM,
                               device="cpu", stage3=stage3, use_fidelity_enhancer=True)

    jcfg = JConfig.from_dict(CFG)
    s1 = JStage1Spec.from_config(jcfg, L, C)
    jfrozen = jmg.FrozenStage1(tree1["params"], tree1["batch_stats"],
                               j_codebook_from_dict(tree1["vq_l"]),
                               j_codebook_from_dict(tree1["vq_h"]))
    t_l, t_h = jmg.build_transformers(jcfg, s1, N_CLASSES)
    spec = jmg.MaskGITSpec.from_config(jcfg, s1)
    fe = JFidelityEnhancer(input_length=L, in_channels=C, dim=8, dim_mults=(1, 2),
                           resnet_block_groups=4)
    return dict(port=port, model=JStage1Model(s1), frozen=jfrozen, t_l=t_l, t_h=t_h, spec=spec,
                p2=p2, h_stats=h_stats,
                fe_apply=jax.jit(lambda x: fe.apply({"params": stage3["params"]}, x, False)),
                X=X[32:])


@pytest.mark.parametrize("class_index", [None, 1])
def test_trained_sampler_with_enhancer_matches_jax(trained, class_index):
    w = trained
    rng = jax.random.key(21 + (class_index or 0))
    ref_l, ref_h, ref_x = make_sampling_fn(w["model"], w["t_l"], w["t_h"], w["spec"])(
        w["frozen"], w["p2"], w["h_stats"], rng, NUM, class_index)
    ref_fe = np.asarray(w["fe_apply"](ref_x))
    noise = jax_decode_noise(rng, w["spec"], NUM)
    kind = "unconditional" if class_index is None else "conditional"
    x_l, x_h, x = w["port"].sample(NUM, kind, class_index=class_index, noise=[noise])

    # the same draws give the same token grids from the trained priors
    j_l, j_h = make_prior_apply_fns(w["t_l"], w["t_h"], w["p2"], w["h_stats"])
    tok = jax.jit(lambda r: jmg.iterative_decoding(r, w["spec"], j_l, j_h, NUM, class_index))(rng)
    port = w["port"]
    with torch.no_grad():
        s_l, s_h = iterative_decoding(port.mg_spec, lambda s, c: port.t_l(s, None, c),
                                      lambda a, b, c: port.t_h(a, b, c), NUM, class_index,
                                      device="cpu", noise=noise)
    np.testing.assert_array_equal(s_l.numpy(), np.asarray(tok[0]))
    np.testing.assert_array_equal(s_h.numpy(), np.asarray(tok[1]))
    assert _scale_gap(x_l, ref_l) <= 2e-4 and _scale_gap(x_h, ref_h) <= 2e-4
    gap = _scale_gap(x, ref_fe)
    assert gap <= 2e-4, gap
    assert np.abs(x - (x_l + x_h)).max() > 1e-3  # the trained enhancer acted


def test_trained_enhance_matches_jax(trained):
    x = trained["X"][:6]
    out = trained["port"].enhance(x)
    ref = np.asarray(trained["fe_apply"](jnp.asarray(x)))
    assert _scale_gap(out, ref) <= 2e-4
