"""Port parity: the FCN feature net and its training (``train_fcn``).

The same numpy-seeded inputs go through the JAX package and the port, on
the CPU: the FCN at its fixed widths (128/256/128 channels, kernels 8/5/3)
over C=4, L=64, B=8, 3 classes, on JAX's weights with random BatchNorm
scales, biases and statistics. Tolerances, each with its reason:

  - logits and the 128-wide features, eval and train mode, to 2e-4
    (float32 through three convolutions of up to 256 x 5 taps);
  - the running statistics after a train-mode call to 1e-5: flax takes the
    batch variance as E[x^2] - E[x]^2, the port a two-pass variance, equal
    up to rounding over B*L = 512 values;
  - one conv with "SAME" padding at k = 8, 5, 3 to 1e-5 (one conv);
  - ``cosine_decay_schedule`` against optax to 1e-6 relative (optax
    computes in float32, the port in float64);
  - ten ``train_fcn`` steps against the JAX runner's step on the same
    batches: losses to 1e-5 relative every step, parameters and BatchNorm
    statistics to 1e-4 after ten, except the leaves where JAX's float32 run
    is itself farther from JAX's float64 run of the same steps (the
    BatchNorm-cancelled directions): there the port is held to twice JAX's
    distance from float64.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from chip_smoke import witness_check
from tvqvae_tpu.data.dataset import make_batches as j_make_batches
from tvqvae_tpu.models.fcn import FCN as JFCN
from tvqvae_tpu.utils import import_reference
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.layers import BatchNorm1d
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.scaler import MinMaxScaler
from tvqvae_tpu_torch.utils.schedule import cosine_decay_schedule

C, L, B, N_CLASSES = 4, 64, 8, 3
LR, WD, STEPS = 1e-3, 1e-5, 10


def randomize(variables, rng):
    """Random biases, BatchNorm scales and statistics -> a numpy tree."""

    def draw(path, v):
        k = path[-1].key
        if k in ("bias", "mean"):
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        if k in ("scale", "var"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


@pytest.fixture(scope="module")
def jfcn():
    model = JFCN(n_classes=N_CLASSES)
    x = jnp.zeros((2, C, L))
    variables = jax.jit(lambda k: model.init({"params": k}, x, True))(jax.random.key(0))
    return model, randomize(variables, np.random.default_rng(0))


def _port(variables):
    m = FCN(C, N_CLASSES)
    m.load_state_dict(convert.fcn_from_jax(variables))
    return m


def _x(seed, n=B):
    return np.random.default_rng(seed).normal(size=(n, C, L)).astype(np.float32)


def test_fcn_eval_matches_flax(jfcn):
    model, variables = jfcn
    x = _x(1)
    m = _port(variables)
    assert all(isinstance(getattr(m, f"BatchNorm_{i}"), BatchNorm1d) for i in range(3))
    with torch.no_grad():
        for features in (False, True):
            ref = np.asarray(model.apply(variables, jnp.asarray(x), False, features))
            out = m(torch.from_numpy(x), features=features).numpy()
            assert out.shape == ((B, 128) if features else (B, N_CLASSES))
            np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)


def test_fcn_train_batchnorm_matches_flax(jfcn):
    model, variables = jfcn
    x = 1.5 * _x(2) + 0.3
    ref, mut = model.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    m = _port(variables)
    with torch.no_grad():
        out = m(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=2e-4)
    for i in range(3):
        bn, stats = getattr(m, f"BatchNorm_{i}"), mut["batch_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5, atol=1e-5)
    assert m.training
    with torch.no_grad():
        m(torch.from_numpy(x))
    assert not m.training  # the mode follows ``train``, not the last call


@pytest.mark.parametrize("k", [8, 5, 3])
def test_same_padding_matches_flax(k):
    """torch's padding="same" pads (k-1)//2 on the left and the rest on the
    right: (3, 4) at k=8, as flax's (TensorFlow's) SAME does."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 19, 3)).astype(np.float32)  # channels-last, odd length
    conv = nn.Conv(5, (k,), padding="SAME")
    params = jax.device_get(conv.init(jax.random.key(k), jnp.asarray(x))["params"])
    ref = np.asarray(conv.apply({"params": params}, jnp.asarray(x))).transpose(0, 2, 1)
    m = torch.nn.Conv1d(3, 5, k, padding="same")
    m.load_state_dict(convert.params_to_state_dict(params))
    with torch.no_grad():
        out = m(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # the explicit pads that torch's "same" amounts to
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    with torch.no_grad():
        manual = torch.nn.functional.conv1d(
            torch.nn.functional.pad(xt, ((k - 1) // 2, k // 2)), m.weight, m.bias)
    np.testing.assert_allclose(out, manual.numpy(), rtol=0, atol=1e-6)


def test_converter_follows_import_reference_layout():
    """A reference-named FCNBaseline state dict, a distinct random value per
    leaf, through ``import_reference.fcn_from_state_dict`` and then
    ``fcn_from_jax``, loads strictly into the port with every value in
    place (the reference names ``layers.{i}.layers.{0: conv, 1: bn}`` and
    ``final``)."""
    m = FCN(C, N_CLASSES)
    rng = np.random.default_rng(0)
    ref_sd, expected = {}, {}
    for key, v in m.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        mod, leaf = key.rsplit(".", 1)
        kind, i = mod.split("_")
        ref = {"Conv": f"layers.{i}.layers.0", "BatchNorm": f"layers.{i}.layers.1",
               "Dense": "final"}[kind]
        val = rng.normal(size=v.shape).astype(np.float32)
        ref_sd[f"{ref}.{leaf}"] = val
        expected[key] = val
    variables, inferred = import_reference.fcn_from_state_dict(ref_sd)
    assert inferred == {"in_channels": C, "n_classes": N_CLASSES}
    m.load_state_dict(convert.fcn_from_jax(variables))
    for key, val in expected.items():
        np.testing.assert_array_equal(m.state_dict()[key].numpy(), val, err_msg=key)


@pytest.mark.parametrize("T", [9, 10, 1000])
def test_cosine_decay_schedule_matches_optax(T):
    """To optax in float64 within 1e-7 relative, and to optax's own float32
    arithmetic within two float32 ulps of lr."""
    ours = cosine_decay_schedule(LR, T)
    steps = range(T + 3)
    with jax.enable_x64(True):
        ref64 = np.array([float(optax.cosine_decay_schedule(LR, T)(t)) for t in steps])
    ref32 = np.array([float(optax.cosine_decay_schedule(LR, T)(t)) for t in steps])
    got = np.array([ours(t) for t in steps])
    np.testing.assert_allclose(got, ref64, rtol=1e-7, atol=0)
    np.testing.assert_allclose(got, ref32, rtol=0, atol=2 * 2.0 ** -23 * LR)
    assert got[0] == LR and (got[T:] == 0.0).all()


# ---------------------------------------------------------------------------
# ten train_fcn steps against the JAX runner's step


def _data(n=40, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, C, L)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, size=(n, 1))
    X += y[:, :, None].astype(np.float32)  # a class signal to learn
    return DatasetSplits(X[:32], y[:32], X[32:], y[32:], MinMaxScaler(), N_CLASSES)


def _jax_run(model, variables, data, steps, bs, dtype=jnp.float32):
    """``tvqvae_tpu/train/runner.py::train_fcn``'s step_fn over its
    host-batch order, on variables and batches cast to ``dtype`` (float64
    needs x64 enabled around the call)."""
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), variables)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adamw(optax.cosine_decay_schedule(LR, steps), weight_decay=WD)
    opt_state = tx.init(params)

    @jax.jit
    def step_fn(params, batch_stats, opt_state, xb, yb):
        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": batch_stats}, xb, True,
                                      mutable=["batch_stats"])
            onehot = jax.nn.one_hot(yb[:, 0], N_CLASSES)
            ce = optax.softmax_cross_entropy(logits, onehot).mean()
            return ce, (mut, (logits.argmax(-1) == yb[:, 0]).mean())

        (ce, (mut, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), mut["batch_stats"], opt_state, ce, acc

    batches = j_make_batches(data.X_train, data.y_train, bs, shuffle=True, seed=0, repeat=True)
    out = []
    for _ in range(steps):
        xb, yb = next(batches)
        params, batch_stats, opt_state, ce, acc = step_fn(params, batch_stats, opt_state,
                                                          jnp.asarray(xb, dtype), jnp.asarray(yb))
        out.append((float(ce), float(acc)))
    return out, jax.device_get({"params": params, "batch_stats": batch_stats})


class _Recorder:
    def __init__(self):
        self.loss, self.acc = [], []

    def log_metrics(self, metrics, step):
        self.loss.append(metrics["train/loss"].item())
        self.acc.append(metrics["train/acc"].item())


@pytest.fixture(scope="module")
def fcn_run(jfcn):
    model, variables = jfcn
    data = _data()
    ref, final = _jax_run(model, variables, data, STEPS, B)
    rec = _Recorder()
    mp = pytest.MonkeyPatch()
    # train_fcn's seeded init, replaced by JAX's weights
    mp.setattr(runner, "init_weights_", lambda m, g: _port(variables))
    try:
        fcn = runner.train_fcn(Config(), data, logger=rec, max_epochs=STEPS, batch_size=B,
                               lr=LR, weight_decay=WD, device="cpu", log_interval=1)
    finally:
        mp.undo()
    return ref, final, rec, fcn


def test_ten_train_fcn_steps_losses_match_jax(fcn_run):
    ref, _, rec, _ = fcn_run
    assert len(rec.loss) == STEPS
    np.testing.assert_allclose(rec.loss, [r[0] for r in ref], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(rec.acc, [r[1] for r in ref])


def _float64_witness(model, variables, data):
    """The JAX runner's step in float64 from the same weights over the same
    batches: what both float32 runs approximate, computed independently of
    the port (rounded to float32 by the converter, far below the bounds)."""
    with jax.enable_x64(True):
        _, final = _jax_run(model, variables, data, STEPS, B, jnp.float64)
    return {k: v.double() for k, v in convert.fcn_from_jax(final).items()}


def test_ten_train_fcn_steps_parameters_and_statistics_match_jax(fcn_run, jfcn):
    """Every leaf within 1e-4 (+ 1e-4 relative) of JAX's, except where JAX's
    float32 run is itself farther than that from the float64 witness (JAX's
    step in float64): there the port must be no farther from the witness
    than twice JAX's distance (``chip_smoke.py::witness_check``). Those
    leaves are where a train-mode BatchNorm cancels the gradient (each
    conv's bias feeds only the BatchNorm right after it, a per-channel
    constant its batch mean removes; a conv's weights are scale-invariant
    per output channel). The gradient along those directions is rounding
    noise, which Adam's m / (sqrt(v) + eps) turns into steps of up to lr
    (``chip_smoke.py::biases_cancelled_by_batchnorm`` states the same for
    stage 1); the biases and the running means they feed stay within
    1e-4 + 2 * sum(lr_t) of JAX's all the same."""
    _, final, _, fcn = fcn_run
    assert not fcn.training
    ours = fcn.state_dict()
    ref = convert.fcn_from_jax(final)
    exact = _float64_witness(*jfcn, _data())
    assert set(ours) == set(ref) == set(exact)
    noise = 1e-4 + 2 * sum(cosine_decay_schedule(LR, STEPS)(t) for t in range(STEPS))
    cancelled = {f"{m}_{i}.{leaf}": noise for i in range(3)
                 for m, leaf in (("Conv", "bias"), ("BatchNorm", "running_mean"))}
    _, witnessed = witness_check("ten FCN steps", ours, ref, exact, 1e-4, cancelled)
    assert not set(witnessed) - set(cancelled) - {"Conv_1.weight", "Conv_2.weight"}, witnessed


def test_train_fcn_on_cpu_learns(capsys):
    data = _data(n=80, seed=4)
    rec = _Recorder()
    fcn = runner.train_fcn(Config(), data, logger=rec, max_epochs=30, batch_size=256,
                           device="cpu", log_interval=1)
    assert len(rec.loss) == 30 and np.isfinite(rec.loss).all()
    assert np.mean(rec.loss[-5:]) < np.mean(rec.loss[:5])
    assert "[fcn] step 30/30 ce=" in capsys.readouterr().out
    with torch.no_grad():
        z = fcn(torch.from_numpy(data.X_test), features=True)
    assert z.shape == (len(data.X_test), 128) and torch.isfinite(z).all()


def test_train_fcn_seeded_init_is_repeatable():
    data = _data()
    a = runner.train_fcn(Config(), data, max_epochs=2, batch_size=B, device="cpu", seed=5)
    b = runner.train_fcn(Config(), data, max_epochs=2, batch_size=B, device="cpu", seed=5)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_train_fcn_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.train_fcn(Config(), _data(), max_epochs=1)
