"""The port's CLIs end to end on the CPU, at small shapes.

``main([...])`` of each script with ``--device cpu``, a synthetic ``.npz``
(24 series, C=4, L=127, 3 classes) and a ``.json`` config in the reference
schema at the small shapes of ``tests/test_torch_sampler.py``: ``train
--stage all`` writes stage1/2/3 with their metas and ``--stage fcn`` the
FCN; ``train_fcn`` writes its checkpoint; ``generate`` writes finite
``.npz`` files in original units (raw and enhanced); the service ``serve``
builds answers a request through ``make_server``. Every JAX option the port
does not run is refused by name and reason (``--no_precompute``,
``--host_data`` and ``--data_parallel`` run since data parallelism); every precision flag of the JAX CLIs
reaches the runners or the sampler with its value; the train CLI's defaults
are the JAX train CLI's, ``--bundle_steps`` 10 among them; and a JAX
``train`` command line parses.
"""

import functools
import json
import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from test_torch_sampler import CFG, C, L, N_CLASSES
from tvqvae_tpu.scripts import train as jtrain
from tvqvae_tpu_torch.data import make_synthetic_trajectories, save_npz
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.scripts import generate, serve, train, train_fcn
from tvqvae_tpu_torch.serving import make_server
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --stage all`` once; -> (root, the common arguments)."""
    root = tmp_path_factory.mktemp("cli")
    save_npz(str(root / "flights.npz"),
             *make_synthetic_trajectories(n=24, channels=C, length=L, n_classes=N_CLASSES, seed=4))
    cfg = {**CFG, "dataset": {"batch_sizes": {"stage1": 4, "stage2": 4, "stage3": 4}},
           "trainer_params": {"val_check_interval": {"stage1": 2, "stage2": 2, "stage3": 2}}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    common = ["--dataset_file", str(root / "flights.npz"), "--config", str(root / "cfg.json"),
              "--model_save_dir", str(root / "models"), "--device", "cpu"]
    train.main([*common, "--stage", "all", "--run_dir", str(root / "runs"),
                "--max_steps", str(STEPS)])
    return root, common


def test_train_all_writes_every_stage(trained):
    root, _ = trained
    ckpt = root / "models" / "flights"
    for stage in ("stage1", "stage2", "stage3"):
        tree, meta = load_checkpoint(str(ckpt / stage))
        assert int(tree["step"]) == STEPS and meta["completed_step"] == STEPS
        assert (meta["input_length"], meta["in_channels"], meta["n_classes"]) == (L, C, N_CLASSES)
        assert (ckpt / f"{stage}.train").exists()  # the snapshot at step 2
        lines = (root / "runs" / f"flights_{stage}" / "metrics.jsonl").read_text().splitlines()
        assert json.loads(lines[-1])["step"] == STEPS
    assert set(load_checkpoint(str(ckpt / "stage3"))[0]) == {"params", "tau", "step"}


def test_train_stage_fcn(trained, monkeypatch):
    root, common = trained
    # the JAX CLI trains the FCN for the runner's default 1000 steps; fewer here
    monkeypatch.setattr(runner, "train_fcn", functools.partial(runner.train_fcn, max_epochs=3))
    train.main([*common, "--stage", "fcn", "--run_dir", str(root / "runs")])
    fcn, meta = runner.load_fcn_bundle(str(root / "models" / "flights" / "fcn"), device="cpu")
    assert meta["n_classes"] == N_CLASSES and "completed_step" not in meta
    x = np.random.default_rng(0).normal(size=(2, C, L)).astype(np.float32)
    with torch.no_grad():
        assert fcn(torch.from_numpy(x)).shape == (2, N_CLASSES)


def test_train_fcn_cli(trained, tmp_path):
    root, _ = trained
    (tmp_path / "fcn.json").write_text(json.dumps(
        {"dataset": {"batch_size": 8}, "exp_params": {"LR": 2e-3, "weight_decay": 0.0}}))
    train_fcn.main(["--dataset_file", str(root / "flights.npz"), "--config",
                    str(tmp_path / "fcn.json"), "--model_save_dir", str(tmp_path / "m"),
                    "--run_dir", str(tmp_path / "runs"), "--max_steps", "2", "--device", "cpu"])
    tree, meta = load_checkpoint(str(tmp_path / "m" / "flights" / "fcn"))
    assert set(tree) == {"params", "batch_stats"} and meta["in_channels"] == C


def test_generate_writes_original_units(trained, tmp_path):
    root, common = trained
    generate.main([*common, "--n_samples", "8", "--batch_size", "4",
                   "--synthetic_save_dir", str(tmp_path / "raw"),
                   "--synthetic_fidelity_dir", str(tmp_path / "fe")])
    X_real = np.load(root / "flights.npz")["X"]
    for path in (tmp_path / "raw" / "synthetic.npz", tmp_path / "fe" / "synthetic_fe.npz"):
        z = np.load(path)
        X, y = z["X"], z["y"]
        assert X.shape[1:] == (C, L) and len(X) == len(y) and 6 <= len(X) <= 10
        assert np.isfinite(X).all() and set(y) <= set(range(N_CLASSES))
        assert (X[:, 2] >= 0).all() and (X[:, 3, 0] == 0).all()
        # original units: the timedelta channel climbs to the real data's scale
        assert X[:, 3].max() > 0.25 * X_real[:, 3].max()


def test_serve_builds_a_service_that_answers(trained):
    _, common = trained
    parser = serve.build_argparser()
    svc = serve.build_service(parser.parse_args([*common, "--use_fe", "--batch_size", "4"]), parser)
    assert svc.info()["fidelity_enhancer"] and svc.info()["postprocess"]
    svc.warmup()
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps({"n": 2, "class_index": 1}).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert resp.status == 200 and out["shape"] == [2, C, L] and out["y"] == [1, 1]
    assert np.isfinite(np.asarray(out["X"])).all()


UNPORTED = [
    (train, ["--bundle_steps", "10"]), (train, ["--rbg_rng"]), (train, ["--no_precompute"]),
    (train, ["--host_data"]), (train, ["--tp", "2"]), (serve, ["--data_parallel"]),
]


@pytest.mark.parametrize("script, flag", UNPORTED,
                         ids=[f"{s.__name__.rsplit('.', 1)[1]}{f[0]}" for s, f in UNPORTED])
def test_unported_flag_is_refused(script, flag, capsys, monkeypatch):
    """The JAX flags the port once refused: none is any more. ``--tp 2`` is
    refused to one process as the JAX CLI refuses a device count that
    ``tp`` does not divide; ``--bundle_steps 10``, ``--rbg_rng``,
    ``--no_precompute``, ``--host_data`` and serve's ``--data_parallel``
    parse and get past the refusal (to the missing dataset file here;
    ``tests/test_torch_bundle.py``, ``tests/test_torch_rbg_rng.py`` and
    ``tests/test_torch_parallel.py`` run them)."""
    if flag[0] == "--tp":
        with pytest.raises(SystemExit) as exc:
            script.main(["--dataset_file", "/nonexistent/flights.npz", *flag])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "1 devices not divisible by tp=2" in err and "not ported" not in err
        assert script.build_argparser().parse_args(
            ["--dataset_file", "f.npz", *flag]).tp == 2
        return
    args = script.build_argparser().parse_args(["--dataset_file", "/nonexistent/f.npz", *flag,
                                                "--device", "cpu"])
    if flag[0] == "--bundle_steps":
        assert args.bundle_steps == 10
    else:
        assert getattr(args, flag[0][2:]) is True
    with pytest.raises(FileNotFoundError):
        script.main(["--dataset_file", "/nonexistent/flights.npz", *flag, "--device", "cpu"])


def test_serve_data_parallel_builds_over_the_devices(tmp_path, monkeypatch):
    """``--data_parallel`` hands the sampler every device: on the CPU the CPU
    alone; on CUDA every visible card, a batch that does not divide their
    count refused as the JAX CLI refuses it."""
    seen = {}

    def fake(cfg, *a, **kw):
        seen.update(kw)
        raise RuntimeError("built")

    monkeypatch.setattr(serve.TrainedModelSampler, "from_checkpoints", fake)
    X, y = make_synthetic_trajectories(n=8, channels=C, length=L, seed=1)
    save_npz(str(tmp_path / "d.npz"), X, y)
    base = ["--dataset_file", str(tmp_path / "d.npz"), "--data_parallel"]
    with pytest.raises(RuntimeError, match="built"):
        serve.build_service(serve.build_argparser().parse_args(base + ["--device", "cpu"]))
    assert seen["devices"] == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    p = serve.build_argparser()
    with pytest.raises(SystemExit):
        serve.build_service(p.parse_args(base + ["--batch_size", "32"]), p)
    with pytest.raises(RuntimeError, match="built"):
        serve.build_service(p.parse_args(base + ["--batch_size", "33"]), p)
    assert seen["devices"] == [torch.device("cuda", i) for i in range(3)]


_STAGES = ("train_stage1", "train_stage2", "train_stage3")
# each precision flag of the JAX CLIs -> where its value lands: {runner or sampler: {kwarg: value}}
PRECISION = [
    (train, "--bf16", {"train_stage1": {"compute_dtype": "bfloat16"},
                       "train_stage3": {"compute_dtype": "bfloat16"}}),
    (train, "--remat", {"train_stage1": {"remat": True}}),
    (train, "--fast_bn", {"train_stage1": {"fast_bn": True}, "train_stage3": {"fast_norm": True}}),
    (train, "--bf16_mu", {s: {"bf16_mu": True} for s in _STAGES}),
    (train, "--bf16_nu", {s: {"bf16_nu": True} for s in _STAGES}),
    (train, "--bf16_head", {"train_stage1": {"bf16_head": True}}),
    (train, "--bf16_istft", {"train_stage1": {"bf16_istft": True}}),
    (generate, "--bf16", {"from_checkpoints": {"compute_dtype": "bfloat16"}}),
    (generate, "--fast_bn", {"from_checkpoints": {"fast_bn": True}}),
    (serve, "--bf16", {"from_checkpoints": {"compute_dtype": "bfloat16"}}),
    (serve, "--fast_bn", {"from_checkpoints": {"fast_bn": True}}),
]


class _Stop(Exception):
    pass


def _cli_calls(script, argv, common, monkeypatch):
    """Run ``script`` with ``argv`` and the runners (train) or the sampler's
    ``from_checkpoints`` (generate, serve) replaced by recorders -> {name:
    the keyword arguments it got}."""
    calls = {}

    def recorder(name, stop=False):
        def record(*args, **kw):
            calls[name] = kw
            if stop:
                raise _Stop
            return None
        return record

    if script is train:
        for name in _STAGES:
            monkeypatch.setattr(runner, name, recorder(name))
        monkeypatch.setattr(runner, "load_stage1_bundle", lambda *a, **k: (None, None, None))
        train.main([*common, "--stage", "all", "--no_val_metrics", *argv])
    else:
        monkeypatch.setattr(TrainedModelSampler, "from_checkpoints",
                            recorder("from_checkpoints", stop=True))
        with pytest.raises(_Stop):
            if script is serve:
                serve.build_service(serve.build_argparser().parse_args([*common, *argv]))
            else:
                generate.main([*common, *argv])
    return calls


@pytest.mark.parametrize("script, flag, lands", PRECISION,
                         ids=[f"{s.__name__.rsplit('.', 1)[1]}{f}" for s, f, _ in PRECISION])
def test_precision_flag_reaches_the_runner(trained, tmp_path, monkeypatch, script, flag, lands):
    """The flag is accepted and its value reaches every runner (or the
    sampler) the JAX CLI hands it to; ``--no-<flag>`` hands over the opposite."""
    _, common = trained
    if script is train:
        common = [*common, "--run_dir", str(tmp_path / "runs")]
    calls = _cli_calls(script, [flag], common, monkeypatch)
    for name, kw in lands.items():
        for k, v in kw.items():
            assert calls[name][k] == v, (name, k)
    if isinstance(next(iter(next(iter(lands.values())).values())), bool) and flag != "--remat":
        calls = _cli_calls(script, ["--no-" + flag[2:]], common, monkeypatch)
        for name, kw in lands.items():
            for k in kw:
                assert calls[name][k] is False, (name, k)


def test_train_defaults_are_the_jax_clis_bundle_steps_included():
    """Every flag the two train parsers share defaults as the JAX CLI's does,
    ``--bundle_steps`` 10 included; the generate and serve CLIs default to
    ``--fast_bn``, as the JAX ones do."""
    j = vars(jtrain.build_argparser().parse_args(["--dataset_file", "d.npz"]))
    p = vars(train.build_argparser().parse_args(["--dataset_file", "d.npz"]))
    shared = set(j) & set(p)
    assert {"fast_bn", "bf16_mu", "bf16_nu", "bf16_head", "bf16_istft", "bf16", "remat",
            "bundle_steps"} <= shared
    assert {k: p[k] for k in shared} == {k: j[k] for k in shared}
    assert (j["bundle_steps"], p["bundle_steps"]) == (10, 10)
    assert (p["fast_bn"], p["bf16_mu"], p["bf16_head"]) == (True, True, True)
    assert p["device"] == "cuda" and p["tp"] == 1
    for script in (generate, serve):
        args = script.build_argparser().parse_args(["--dataset_file", "d.npz"])
        assert args.fast_bn is True and args.bf16 is False and args.device == "cuda"


def test_a_jax_train_command_line_parses():
    ours = train.build_argparser()._option_string_actions
    for action in jtrain.build_argparser()._actions:
        for opt in action.option_strings:
            assert opt in ours, opt
    args = train.build_argparser().parse_args(
        ["--dataset_file", "d.npz", "--stage", "2", "--no-fast_bn", "--no-bf16_mu",
         "--no-bf16_head", "--bundle_steps", "1", "--no_val_metrics", "--use_pallas"])
    assert args.stage == "2" and not args.fast_bn
