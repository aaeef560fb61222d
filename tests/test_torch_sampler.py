"""Port parity for the slice as a whole: the sampler and the service.

One small model (L=127, C=4, hid_dim 16, codebooks 8/8; priors 16x2Lx2H and
8x1Lx1H; T = 3/1; 3 classes) is initialised by the JAX package and handed to
both packages as the same in-memory trees. The JAX side runs
``make_sampling_fn`` and ``encode_tokens``/``decode_tokens``; the port runs
``TrainedModelSampler`` on the CPU with JAX's Gumbel draws injected.
Tolerances: tokens and indices exactly, series to 2e-4 (float32 conv stacks).
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
from tvqvae_tpu.models import maskgit as jmg
from tvqvae_tpu.models.stage1 import init_stage1
from tvqvae_tpu.models.stage1 import Stage1Spec as JStage1Spec
from tvqvae_tpu.serving import GenerationService as JGenerationService
from tvqvae_tpu.train.stage2 import init_stage2, make_prior_apply_fns, make_sampling_fn
from tvqvae_tpu.utils.scaler import MinMaxScaler as JMinMaxScaler
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.generation import TrainedModelSampler
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
    {"stage3": {}}, {"use_fidelity_enhancer": True}, {"compute_dtype": "bfloat16"}, {"ess": True},
])
def test_unported_options_raise(kw):
    cfg_dict = dict(CFG)
    if kw.pop("ess", False):
        cfg_dict["MaskGIT"] = {**CFG["MaskGIT"], "ESS": {"use": True}}
    with pytest.raises(NotImplementedError):
        TrainedModelSampler(Config.from_dict(cfg_dict), {}, {}, input_length=L,
                            in_channels=C, n_classes=N_CLASSES, device="cpu", **kw)
