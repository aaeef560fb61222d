"""Port parity for the slice as a whole: the sampler and the service.

One small model (L=127, C=4, hid_dim 16, codebooks 8/8; priors 16x2Lx2H and
8x1Lx1H; T = 3/1; 3 classes; fidelity enhancer dim 8, dim_mults (1, 2), 4
groups) is handed to both packages as the same in-memory trees: stages 1
and 2 from the JAX package's init, the enhancer from the port's seeded init
(random GroupNorm scales and biases) written out as a flax tree. The JAX side
runs ``make_sampling_fn``, the enhancer's ``apply`` (what its sampler does
with ``use_fidelity_enhancer``) and ``encode_tokens``/``decode_tokens``; the
port runs ``TrainedModelSampler`` on the CPU with JAX's Gumbel draws
injected. Tolerances: tokens and indices exactly, series to 2e-4 (float32
conv stacks), enhanced series to 5e-4 of their scale (the U-Net on top).
"""

import json
import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu.models.fidelity_enhancer import FidelityEnhancer as JFidelityEnhancer
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.stage1 import init_stage1
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.serving import GenerationService as JGenerationService
from tvqvae_tpu.train.stage2 import init_stage2, make_prior_apply_fns, make_sampling_fn
from tvqvae_tpu.utils.scaler import MinMaxScaler as JMinMaxScaler
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import encode_tokens, iterative_decoding
from tvqvae_tpu_torch.serving import GenerationService, make_server
from tvqvae_tpu_torch.utils.scaler import MinMaxScaler

ATOL = 2e-4
L, C, N_CLASSES = 127, 4, 3
FEATURES = ["latitude", "longitude", "altitude", "timedelta"]
CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "MaskGIT": {
        "choice_temperatures": {"lf": 10, "hf": 4},
        "T": {"lf": 3, "hf": 1},
        "prior_model_l": {"hidden_dim": 16, "n_layers": 2, "heads": 2},
        "prior_model_h": {"hidden_dim": 8, "n_layers": 1, "heads": 1},
    },
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4},
}


def jax_decode_noise(rng, spec, num):
    """The Gumbel draws of the JAX package's iterative_decoding(rng, ...),
    in the port's noise layout."""
    r_l, r_h = jax.random.split(rng)
    noise = {}
    for band, r, T, n, K in (("l", r_l, spec.T_l, spec.tokens_l, spec.mask_token_l),
                             ("h", r_h, spec.T_h, spec.tokens_h, spec.mask_token_h)):
        g_s, g_c = [], []
        for step in jax.random.split(r, T):
            r_s, r_g = jax.random.split(step)
            g_s.append(np.array(jax.random.gumbel(r_s, (num, n, K))))
            g_c.append(np.array(jmg._gumbel(r_g, (num, n))))
        noise[band] = (torch.from_numpy(np.stack(g_s)), torch.from_numpy(np.stack(g_c)))
    return noise


@pytest.fixture(scope="module")
def world():
    jcfg = JConfig.from_dict(CFG)
    s1 = JStage1Spec.from_config(jcfg, L, C)
    model, params, stats, vq_l, vq_h = init_stage1(jax.random.key(0), s1, jnp.zeros((2, C, L)))
    frozen = jmg.FrozenStage1(params, stats, vq_l, vq_h)
    spec = jmg.MaskGITSpec.from_config(jcfg, s1)
    t_l, t_h = jmg.build_transformers(jcfg, s1, N_CLASSES)
    p2, h_stats = init_stage2(jax.random.key(1), t_l, t_h, spec)
    port = TrainedModelSampler(
        Config.from_dict(CFG),
        {"params": params, "batch_stats": stats, "vq_l": vq_l, "vq_h": vq_h},
        {"params": p2, "h_stats": h_stats},
        input_length=L, in_channels=C, n_classes=N_CLASSES, batch_size=4, device="cpu",
    )
    return dict(model=model, frozen=frozen, spec=spec, t_l=t_l, t_h=t_h, p2=p2,
                h_stats=h_stats, port=port)


@pytest.mark.parametrize("class_index", [None, 1])
def test_sample_matches_jax_sampling_fn(world, class_index):
    w, num = world, 4
    fn = make_sampling_fn(w["model"], w["t_l"], w["t_h"], w["spec"])
    rng = jax.random.key(11)
    ref = fn(w["frozen"], w["p2"], w["h_stats"], rng, num, class_index)
    noise = jax_decode_noise(rng, w["spec"], num)
    kind = "unconditional" if class_index is None else "conditional"
    out = w["port"].sample(num, kind, class_index=class_index, noise=[noise])
    for o, r in zip(out, ref):
        assert o.shape == (num, C, L)
        np.testing.assert_allclose(o, np.asarray(r), atol=ATOL)

    # the same draws give the same token grids
    j_l, j_h = make_prior_apply_fns(w["t_l"], w["t_h"], w["p2"], w["h_stats"])
    ref_l, ref_h = jax.jit(lambda r: jmg.iterative_decoding(r, w["spec"], j_l, j_h, num,
                                                            class_index))(rng)
    port = w["port"]
    with torch.no_grad():
        s_l, s_h = iterative_decoding(
            port.mg_spec, lambda s, c: port.t_l(s, None, c),
            lambda a, b, c: port.t_h(a, b, c), num, class_index,
            device="cpu", noise=noise)
    np.testing.assert_array_equal(s_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(s_h.numpy(), np.asarray(ref_h))


def test_reconstruct_matches_jax(world):
    w = world
    x = np.random.default_rng(2).normal(size=(6, C, L)).astype(np.float32)

    @jax.jit
    def j_roundtrip(xb):
        s_l = jmg.encode_tokens(w["model"], w["frozen"], xb, "lf")
        s_h = jmg.encode_tokens(w["model"], w["frozen"], xb, "hf")
        x_rec = (jmg.decode_tokens(w["model"], w["frozen"], s_l, "lf")
                 + jmg.decode_tokens(w["model"], w["frozen"], s_h, "hf"))
        return s_l, s_h, x_rec

    ref_l, ref_h, ref_x = j_roundtrip(jnp.asarray(x))
    port = w["port"]
    with torch.no_grad():
        for band, ref in (("lf", ref_l), ("hf", ref_h)):
            s = encode_tokens(port.frozen, torch.from_numpy(x), band)
            np.testing.assert_array_equal(s.numpy(), np.asarray(ref))
    out = port.reconstruct(x)  # batch_size 4: two batches, the last partial
    assert out.shape == (6, C, L)
    np.testing.assert_allclose(out, np.asarray(ref_x), atol=ATOL)


def _scaler_pair():
    raw = np.random.default_rng(3).uniform(-60.0, 40.0, size=(32, L * C)).astype(np.float32)
    return MinMaxScaler().fit(raw), JMinMaxScaler().fit(raw)


def test_service_generate_matches_jax_service(world):
    t_scaler, j_scaler = _scaler_pair()
    port_svc = GenerationService(world["port"], scaler=t_scaler, features=FEATURES)
    jax_svc = JGenerationService(world["port"], scaler=j_scaler, features=FEATURES)
    for kw in ({"class_index": None, "seed": 3}, {"class_index": 2, "seed": 5}):
        X, y = port_svc.generate(3, **kw)
        X_ref, y_ref = jax_svc.generate(3, **kw)
        np.testing.assert_array_equal(X, X_ref)
        np.testing.assert_array_equal(y, y_ref)
    assert (X[:, FEATURES.index("altitude")] >= 0).all()
    assert (X[:, FEATURES.index("timedelta"), 0] == 0).all()
    Xm, ym = port_svc.generate_mix({0: 1, 2: 2}, seed=1)
    Xm_ref, ym_ref = jax_svc.generate_mix({0: 1, 2: 2}, seed=1)
    np.testing.assert_array_equal(Xm, Xm_ref)
    assert ym.tolist() == ym_ref.tolist() == [0, 2, 2]
    assert port_svc.info()["model"] == "tvqvae_tpu_torch"


def test_http_server_answers(world):
    svc = GenerationService(world["port"], features=FEATURES)
    srv = make_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        for body, n, labels in (({"n": 2, "seed": 1}, 2, [-1, -1]),
                                ({"n": 1, "class_index": 2}, 1, [2]),
                                ({"class_counts": {"0": 1, "1": 2}}, 3, [0, 1, 1])):
            conn = HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/v1/generate", body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            conn.close()
            assert resp.status == 200, out
            assert out["shape"] == [n, C, L] and out["y"] == labels
            assert np.isfinite(np.asarray(out["X"])).all()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_from_init_is_seeded_and_runs_on_cpu():
    cfg = Config.from_dict(CFG)
    a = TrainedModelSampler.from_init(cfg, L, C, N_CLASSES, seed=4, device="cpu", batch_size=2)
    b = TrainedModelSampler.from_init(cfg, L, C, N_CLASSES, seed=4, device="cpu", batch_size=2)
    xa = a.sample(3, "conditional", class_index=0, seed=9)[2]
    xb = b.sample(3, "conditional", class_index=0, seed=9)[2]
    assert xa.shape == (3, C, L) and np.isfinite(xa).all()
    np.testing.assert_array_equal(xa, xb)
    assert a.reconstruct(xa).shape == (3, C, L)


def test_cuda_device_turns_tf32_off(monkeypatch):
    """cuDNN convolutions default to TF32; the JAX package computes at
    Precision.HIGHEST, so a CUDA entry point turns TF32 off."""
    from tvqvae_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainedModelSampler.from_init(Config.from_dict(CFG), L, C, N_CLASSES, device="cuda")


@pytest.mark.parametrize("kw", [
    {"stage3": "seeded"}, {"use_fidelity_enhancer": True}, {"compute_dtype": "bfloat16"},
    {"ess": True},
])
def test_unported_options_raise(world, fe_world, kw):
    """Every option of the JAX sampler is ported. The ESS sampler is: a
    config with ``MaskGIT.ESS.use`` builds a sampler with ``use_ess``
    that samples (``tests/test_torch_ess.py`` holds it against JAX). The
    fidelity enhancer is: a well-formed stage3 tree builds (and stays off
    unless asked for), and ``use_fidelity_enhancer`` without one raises
    ``ValueError``, as the JAX sampler does. bfloat16 decoding is ported:
    the sampler builds with the JAX sampler's bfloat16 defaults
    (``bf16_head``, ``bf16_istft``) in its stage-1 spec and its enhancer's
    stream (``tests/test_torch_precision_paths.py`` holds it against JAX)."""
    cfg_dict = dict(CFG)
    if kw.pop("ess", False):
        cfg_dict["MaskGIT"] = {**CFG["MaskGIT"], "ESS": {"use": True}}
        s = TrainedModelSampler(Config.from_dict(cfg_dict), *_trees(world), input_length=L,
                                in_channels=C, n_classes=N_CLASSES, device="cpu")
        assert s.use_ess and s._ess_rate == 0.3
        x = s.sample(2, "conditional", class_index=0, seed=1)[2]
        assert x.shape == (2, C, L) and np.isfinite(x).all()
        return
    if kw.get("stage3") == "seeded":
        s = TrainedModelSampler(Config.from_dict(cfg_dict), *_trees(world), input_length=L,
                                in_channels=C, n_classes=N_CLASSES, device="cpu",
                                stage3=fe_world["stage3"])
        assert s.fe is not None and not s.use_fe
        return
    if kw.get("compute_dtype") == "bfloat16":
        s = TrainedModelSampler(Config.from_dict(cfg_dict), *_trees(world), input_length=L,
                                in_channels=C, n_classes=N_CLASSES, device="cpu",
                                stage3=fe_world["stage3"], **kw)
        spec = s.frozen.model.spec
        assert (spec.compute_dtype, spec.bf16_head, spec.bf16_istft) == ("bfloat16", True, True)
        assert s.fe.Unet1D_0.stem and getattr(s.fe.Unet1D_0, s.fe.Unet1D_0.stem).compute_dtype \
            == torch.bfloat16
        x = s.sample(2, "conditional", class_index=0, seed=1)[2]
        assert x.dtype == np.float32 and np.isfinite(x).all()
        return
    with pytest.raises(ValueError):
        TrainedModelSampler(Config.from_dict(cfg_dict), {}, {}, input_length=L,
                            in_channels=C, n_classes=N_CLASSES, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the fidelity enhancer


def _trees(world):
    f = world["frozen"]
    return ({"params": f.params, "batch_stats": f.batch_stats, "vq_l": f.vq_l, "vq_h": f.vq_h},
            {"params": world["p2"], "h_stats": world["h_stats"]})


def _to_flax(state_dict) -> dict:
    """A port enhancer's state dict as the JAX package's parameter tree:
    conv kernels (O, I, k) -> (k, I, O), GroupNorm weight -> scale."""
    tree = {}
    for key, v in state_dict.items():
        *mods, leaf = key.split(".")
        a = v.detach().numpy()
        if leaf == "weight":
            leaf, a = (("scale", a) if mods[-1].startswith("GroupNorm")
                       else ("kernel", a.transpose(2, 1, 0)))
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


@pytest.fixture(scope="module")
def fe_world(world):
    gen = torch.Generator().manual_seed(6)
    fe = init_weights_(FidelityEnhancer.from_config(Config.from_dict(CFG), L, C), gen)
    with torch.no_grad():  # norms away from their identity values
        for name, p in fe.named_parameters():
            if "GroupNorm" in name or name.endswith(".g"):
                p.copy_((0.5 + torch.rand(p.shape, generator=gen)) if name.endswith(("weight", ".g"))
                        else 0.1 * torch.randn(p.shape, generator=gen))
    stage3 = {"params": _to_flax(fe.state_dict()), "tau": np.float32(0.25)}
    port = TrainedModelSampler(Config.from_dict(CFG), *_trees(world), input_length=L,
                               in_channels=C, n_classes=N_CLASSES, batch_size=4, device="cpu",
                               stage3=stage3, use_fidelity_enhancer=True)
    jfe = JFidelityEnhancer(input_length=L, in_channels=C, dim=8, dim_mults=(1, 2),
                            resnet_block_groups=4)
    j_apply = jax.jit(lambda x: jfe.apply({"params": stage3["params"]}, x, False))
    return dict(port=port, stage3=stage3, j_apply=j_apply)


def test_sample_with_fidelity_enhancer_matches_jax(world, fe_world):
    """The enhancer refines x only: x_l and x_h are the plain sampler's."""
    w, num = world, 4
    rng = jax.random.key(12)
    ref_l, ref_h, ref_x = make_sampling_fn(w["model"], w["t_l"], w["t_h"], w["spec"])(
        w["frozen"], w["p2"], w["h_stats"], rng, num, None)
    ref = np.asarray(fe_world["j_apply"](ref_x))
    x_l, x_h, x = fe_world["port"].sample(num, noise=[jax_decode_noise(rng, w["spec"], num)])
    np.testing.assert_allclose(x_l, np.asarray(ref_l), atol=ATOL)
    np.testing.assert_allclose(x_h, np.asarray(ref_h), atol=ATOL)
    assert x.shape == (num, C, L)
    err = np.abs(x - ref).max() / np.abs(ref).max()
    assert err <= 5e-4, err
    assert np.abs(x - (x_l + x_h)).max() > 1e-2  # the enhancer did act


@pytest.mark.parametrize("length", [L, 90])
def test_enhance_matches_jax(fe_world, length):
    """In batches of 4 (6 series: the last batch partial); another length is
    resized to ``input_length`` first."""
    x = np.random.default_rng(4).normal(size=(6, C, length)).astype(np.float32)
    out = fe_world["port"].enhance(x)
    ref = np.asarray(fe_world["j_apply"](jnp.asarray(x)))
    assert out.shape == (6, C, L)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 5e-4, err


def test_service_reports_the_fidelity_enhancer(world, fe_world):
    assert GenerationService(fe_world["port"], features=FEATURES).info()["fidelity_enhancer"]
    assert not GenerationService(world["port"], features=FEATURES).info()["fidelity_enhancer"]
    with pytest.raises(ValueError, match="no fidelity enhancer"):
        world["port"].enhance(np.zeros((1, C, L), np.float32))


def test_from_init_draws_the_enhancer_after_the_priors():
    cfg = Config.from_dict(CFG)
    plain = TrainedModelSampler.from_init(cfg, L, C, N_CLASSES, seed=4, device="cpu", batch_size=2)
    a, b = (TrainedModelSampler.from_init(cfg, L, C, N_CLASSES, seed=4, device="cpu", batch_size=2,
                                          use_fidelity_enhancer=True) for _ in range(2))
    assert a.use_fe and plain.fe is None
    for k, v in plain.t_h.state_dict().items():  # the earlier draws are unchanged
        assert torch.equal(a.t_h.state_dict()[k], v)
    xa, xb, xp = (s.sample(3, seed=9) for s in (a, b, plain))
    np.testing.assert_array_equal(xa[2], xb[2])
    np.testing.assert_array_equal(xa[0], xp[0])
    np.testing.assert_allclose(xa[2], a.enhance(xp[2]), rtol=0, atol=1e-6)
    assert not np.allclose(xa[2], xp[2])
