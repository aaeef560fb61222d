"""Port parity: the evaluation paths (the sampler's tau, the tau search,
the stage-3 step with a perceptual net, the runners' validation-time
metrics and the train and evaluate CLIs), on the CPU at small shapes.

- The stage-3 precomputed-x' step with a fitted MiniRocket ``percept_fn``
  (weight 0.5): JAX's jitted step and the port's from the same enhancer
  weights and inputs, two steps, losses to 1e-5 relative and every leaf to
  1e-4 (``tests/test_torch_stage3.py``'s step tolerances); the term moves
  the loss and not the update (MiniRocket's PPV is a hard threshold).
- ``search_optimal_tau`` in both packages over the same FIDs handed in
  through stub samplers and metrics: the same arg-min.
- One small model trained by the train CLI (``--stage all --search_tau``,
  validation metrics on, then ``--stage fcn``; the shapes of
  ``tests/test_torch_sampler.py``, 40 series) feeds the rest: the runners'
  ``val/running_metrics/...`` keys are the JAX runner's, stage 3 trained at
  a searched tau > 0 that the sampler reads back, and the evaluate CLI
  writes every result key of the JAX package's, images excepted.
"""

import functools
import inspect
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import JAX_EVAL_KEYS
from test_torch_sampler import CFG, C, L, N_CLASSES
from test_torch_stage3 import randomize
from tvqvae_tpu.evaluation import rocket as jrocket
from tvqvae_tpu.generation import sampler as jsampler
from tvqvae_tpu.models import fidelity_enhancer as jfe
from tvqvae_tpu.scripts import evaluate as jevaluate
from tvqvae_tpu.train import runner as jrunner
from tvqvae_tpu.train import stage3 as jst3
from tvqvae_tpu.train.optim import adamw as j_adamw
from tvqvae_tpu.utils.schedule import warmup_cosine_schedule as j_schedule
from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import make_synthetic_trajectories, save_npz
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.evaluation import rocket as trocket
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.generation import sampler as tsampler
from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
from tvqvae_tpu_torch.scripts import evaluate, train
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

STEPS, TAUS = 3, [0.5, 2.0]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the stage-3 step with a MiniRocket perceptual net, against JAX's


def test_stage3_step_with_a_minirocket_percept_fn_matches_jax():
    Ls, weight, lr = 64, 0.5, 1e-3
    fe = jfe.FidelityEnhancer(input_length=Ls, in_channels=C, dim=8, dim_mults=(1,),
                              resnet_block_groups=4, dropout=0.0)
    # the port's seeded init as a flax tree (a flax init would cost a compile)
    params = randomize(convert.fe_to_jax(tst3.init_stage3(
        tfe.FidelityEnhancer(Ls, C, 8, (1,), 4, 0.0), torch.Generator().manual_seed(0), "cpu")),
        np.random.default_rng(1))
    data = np.random.default_rng(2)
    x_fit = data.normal(size=(8, C, Ls)).astype(np.float32)
    j_mr, t_mr = jrocket.MiniRocket(Ls).fit(x_fit), trocket.MiniRocket(Ls, device="cpu").fit(x_fit)
    tx = j_adamw(j_schedule(lr, 10, 0.1), weight_decay=0.01)
    jstate = jst3.create_stage3_state(params, tx)
    jstep = jax.jit(jst3.make_stage3_train_step_pre(fe, tx, weight, j_mr))
    states = []  # with the perceptual term, and without
    for _ in range(2):
        port = tfe.FidelityEnhancer(Ls, C, 8, (1,), 4, 0.0)
        port.load_state_dict(convert.fe_from_jax(params))
        states.append(tst3.create_stage3_state(port, lambda p: adamw(
            p, learning_rate=warmup_cosine_schedule(lr, 10, 0.1), weight_decay=0.01)))
    step, plain = tst3.make_stage3_train_step_pre(weight, t_mr), tst3.make_stage3_train_step_pre()
    for t in range(2):
        x = data.normal(size=(3, C, Ls)).astype(np.float32)
        xp = (0.8 * x + 0.3 * data.normal(size=x.shape)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(xp), jax.random.key(0))
        _, tm = step(states[0], torch.from_numpy(x), torch.from_numpy(xp))
        _, pm = plain(states[1], torch.from_numpy(x), torch.from_numpy(xp))
        for k in ("loss", "fidelity_enhancer_loss", "percept_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=f"{t} {k}")
        assert tm["percept_loss"] > 0
        assert tm["loss"] == tm["fidelity_enhancer_loss"] + tm["percept_loss"]
        assert tm["fidelity_enhancer_loss"] == pm["loss"]
    want = convert.fe_from_jax(jax.device_get(jstate.params))
    for (k, a), b in zip(states[0].fe.state_dict().items(), states[1].fe.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
        assert torch.equal(a, b), k  # the hard threshold passes no gradient


# ---------------------------------------------------------------------------
# the tau search over FIDs handed in


class _StubSampler:
    def sample(self, n, kind, seed=0):
        assert kind == "unconditional"
        return None, None, np.zeros((n, C, 8), np.float32)

    def reconstruct(self, x, svq_temp=None, seed=0):
        return x * svq_temp


class _StubMetrics:
    def __init__(self, fids):
        self.fids = list(fids)

    def compute_z(self, x):
        return x.reshape(len(x), -1)

    def fid_score(self, z1, z2):
        return self.fids.pop(0)


@pytest.mark.parametrize("fids", [[3.0, 1.0, 2.0, 5.0], [0.2, 0.9, 0.2, 0.4], [4.0, 3.0, 2.0, 1.0]])
def test_search_optimal_tau_picks_the_argmin_as_jax_does(fids):
    cfg, taus = Config(), [0.1, 0.5, 1.0, 2.0]
    X = np.ones((4, C, 8), np.float32)
    want = jsampler.search_optimal_tau(cfg, _StubSampler(), _StubMetrics(fids), X,
                                       n_samples=4, tau_search_rng=taus)
    got = tsampler.search_optimal_tau(cfg, _StubSampler(), _StubMetrics(fids), X,
                                      n_samples=4, tau_search_rng=taus)
    assert got == want == taus[int(np.argmin(fids))]


# ---------------------------------------------------------------------------
# one small model through the train CLI, then the evaluate CLI


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --stage all --search_tau`` with validation metrics, then
    ``--stage fcn`` (3 steps); -> (root, the common arguments)."""
    root = tmp_path_factory.mktemp("eval")
    save_npz(str(root / "flights.npz"),
             *make_synthetic_trajectories(n=40, channels=C, length=L, n_classes=N_CLASSES, seed=4))
    cfg = {**CFG, "dataset": {"batch_sizes": {"stage1": 4, "stage2": 4, "stage3": 4}},
           "trainer_params": {"val_check_interval": {"stage1": 2, "stage2": 2, "stage3": 2}},
           "evaluation": {"batch_size": 4, "min_num_gen_samples": 8},
           "fidelity_enhancer": {**CFG["fidelity_enhancer"], "tau_search_rng": TAUS}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    common = ["--dataset_file", str(root / "flights.npz"), "--config", str(root / "cfg.json"),
              "--model_save_dir", str(root / "models"), "--device", "cpu"]
    runs = ["--run_dir", str(root / "runs")]
    with pytest.MonkeyPatch.context() as mp:
        # 50 ROCKET kernels, not 1000: the tau search's Schur FID runs at 2K dims
        mp.setattr(train, "Metrics", functools.partial(Metrics, rocket_num_kernels=50))
        train.main([*common, *runs, "--stage", "all", "--search_tau", "--max_steps", str(STEPS)])
    with pytest.MonkeyPatch.context() as mp:
        # the JAX CLI trains the FCN for the runner's default 1000 steps; fewer here
        mp.setattr(runner, "train_fcn", functools.partial(runner.train_fcn, max_epochs=STEPS))
        train.main([*common, *runs, "--stage", "fcn"])
    return root, common


def _jax_running_metric_keys(stage: int):
    """The keys of the JAX runner's validation dict, read from its source
    (the runner needs JAX checkpoints to run): stage 2's literal keys,
    stage 3's f-string keys under each tag."""
    src = inspect.getsource(jrunner.train_stage2 if stage == 2 else jrunner.train_stage3)
    if stage == 2:
        return set(re.findall(r'"(running_metrics/\w+)"', src))
    names = re.findall(r'f"(running_metrics/\w+)\{tag\}"', src)
    tags = re.findall(r'\("((?: with FE)?)", (?:x|arr|x_fe)\)', src)
    assert names and tags == ["", " with FE"]
    return {n + t for n in names for t in tags}


@pytest.mark.parametrize("stage", [2, 3])
def test_validation_logs_the_jax_runners_running_metrics(trained, stage):
    root, _ = trained
    want = _jax_running_metric_keys(stage)
    assert len(want) == 5 * (stage - 1)
    lines = [json.loads(s) for s in
             (root / "runs" / f"flights_stage{stage}" / "metrics.jsonl").read_text().splitlines()]
    vals = [r for r in lines if any(k.startswith("val/running_metrics/") for k in r)]
    assert [r["step"] for r in vals] == [2, 3]  # every val_check_interval and the last step
    for r in vals:
        got = {k[len("val/"):]: v for k, v in r.items() if k.startswith("val/")}
        assert set(got) == want and np.isfinite(list(got.values())).all()


def test_stage3_trained_at_the_searched_tau_and_the_sampler_reads_it(trained):
    root, _ = trained
    ckpt = root / "models" / "flights"
    tree, _ = load_checkpoint(str(ckpt / "stage3"))
    tau = float(tree["tau"])
    assert tau in TAUS
    cfg = Config.from_dict(json.loads((root / "cfg.json").read_text()))
    s = TrainedModelSampler.from_checkpoints(cfg, str(ckpt / "stage1"), str(ckpt / "stage2"),
                                             str(ckpt / "stage3"), device="cpu")
    assert s.tau == tau
    assert TrainedModelSampler.from_checkpoints(cfg, str(ckpt / "stage1"), str(ckpt / "stage2"),
                                                device="cpu").tau == 0.0


def test_jax_result_keys_are_the_jax_evaluate_ones():
    """``chip_smoke.py`` checks the evaluate CLI against this list of the
    JAX CLI's result names, read here from its source."""
    src = inspect.getsource(jevaluate.evaluate)
    assert set(re.findall(r'results\["([^"]+)"\]', src)) <= set(JAX_EVAL_KEYS)
    for k in JAX_EVAL_KEYS:
        assert f'"{k}"' in src, k


def test_evaluate_cli_writes_every_jax_key(trained, tmp_path, capsys, monkeypatch):
    root, common = trained
    monkeypatch.setattr(evaluate, "Metrics", functools.partial(Metrics, rocket_num_kernels=50))
    capsys.readouterr()
    evaluate.main([*common, "--run_dir", str(tmp_path), "--min_num_gen_samples", "8",
                   "--fid_method", "svd"])
    out = capsys.readouterr().out
    results = json.loads(out[out.index("{"):])
    assert set(results) == set(JAX_EVAL_KEYS)
    assert np.isfinite(list(results.values())).all()
    logged = json.loads((tmp_path / "flights_evaluate" / "metrics.jsonl").read_text())
    assert {k: logged[k] for k in results} == results
    evaluate.main([*common, "--run_dir", str(tmp_path), "--min_num_gen_samples", "8",
                   "--fid_method", "svd", "--no_fidelity_enhancer"])
    out = capsys.readouterr().out
    assert set(json.loads(out[out.index("{"):])) == {"FID", "FID_rec", "MDD", "ACD", "SD", "KD",
                                                     "IS_mean", "IS_std"}
