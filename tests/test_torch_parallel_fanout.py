"""Port parity: what a process group does of JAX's mesh beyond the steps
(``tvqvae_tpu_torch/parallel/``).

Two ``gloo`` ranks (this file run as a script, one torch thread each), each
with its contiguous half of a global batch, against the JAX package on the
whole batch or against one process of the port:

  (a) ``vq_forward(train=True)`` with k-means init, with dead-code expiry
      and with both, JAX's global row draws handed in, against JAX's
      ``vq_forward`` on the whole batch, and the k-means itself against
      JAX's ``kmeans``: indices and counts (``cluster_size``, the k-means
      ``bins``) exactly; the k-means means, ``embed_avg`` and ``embed``
      within (n-1)·2⁻²⁴·Σ|x| per column (the float32 error bound of a sum
      of n terms taken in another order: the ranks' partial sums against one
      pass) plus 2⁻²² relative for the EMA's own rounding (``embed`` over
      its smoothed counts), the expired codes' rows exactly (each is one
      row of the batch); both ranks equal. The data are seeded so that no
      row lies near a tie between its two nearest codes (ROADMAP §3.3: a
      near tie flips between any two implementations); the test asserts the
      gap;
  (b) ``train_stage1`` with both on in two ranks against one process of
      the same seed: the rows drawn (the same global indices: the state's
      ``draws`` generator, seeded alike everywhere), the state after four
      Adam steps within Adam's element rule of
      ``tests/test_torch_parallel.py``; and resumed from its step-2
      snapshot, bit-equal to the straight two-rank run;
  (c) ``precompute_token_dataset`` and ``precompute_xprime_dataset`` with
      ``data_parallel`` over the two ranks against JAX's sweeps on the same
      weights, with N not divisible by the rounded batch: tokens exactly,
      x' within 2e-4 of its scale;
  (d) ``train_stage2`` and ``train_stage3`` (tau 0) in the two ranks with
      the precompute on (the ranks share one host) against the same ranks
      on the on-the-fly path: losses and every leaf bit-equal on the CPU;
  (e) one validation of each runner, decoded (and enhanced) over the two
      ranks, against one process's validation of the same state: the series
      bit-equal on the CPU (CPU convolutions take another algorithm at one
      row than at two, so every slice here holds two rows or more; the
      11-series validation's last batch of 3 is decoded whole on each rank).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import dataset as tdata
from tvqvae_tpu_torch.models import maskgit as tmg
from tvqvae_tpu_torch.models import vq as tvq
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec
from tvqvae_tpu_torch.parallel import mesh
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.train import stage2 as tst2
from tvqvae_tpu_torch.train import stage3 as tst3
from tvqvae_tpu_torch.utils import checkpoint as tckpt
from tvqvae_tpu_torch.utils import convert
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

from test_torch_parallel import C, L, N_CLASSES, REPO, S1_CFG, W, _free_port, _frozen

VQ_K, VQ_D, VQ_B, VQ_N, VQ_ITERS = 8, 16, 4, 30, 4
# (kmeans_init, threshold_ema_dead_code, the state's seed: no near tie at the assignment)
VQ_CASES = {"kmeans": (True, 0, 5), "dead": (False, 4, 16), "both": (True, 5, 7)}
KM_CFG = {**S1_CFG, "VQ-VAE": {**S1_CFG["VQ-VAE"], "kmeans_init": True, "kmeans_iters": 4,
                               "threshold_ema_dead_code": 6},
          "dataset": {"batch_sizes": {"stage1": 8}},
          "trainer_params": {"val_check_interval": {"stage1": 2}}}
S1_STEPS = 4
SWEEP_N, SWEEP_BATCHES = 13, (3, 8)  # rounded up to 4 and 8 over the two ranks
CFG = {  # the sampler tests' small model, dropout as configured
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
    "dataset": {"batch_sizes": {"stage1": 8, "stage2": 8, "stage3": 8}},
    "evaluation": {"batch_size": 4},
}
RUN_STEPS, VAL_N = 3, 11  # validation batches of 4, 4 and 3


# ---------------------------------------------------------------------------
# the port's side, run by each rank (and by nothing of JAX)


def port_vq(inp):
    out = {}
    for name, (km, thr, _) in VQ_CASES.items():
        embed, avg, cs, initted = (torch.from_numpy(np.array(a)) for a in inp["state"][name])
        p = tvq.VQParams(VQ_K, VQ_D, threshold_ema_dead_code=thr, kmeans_init=km,
                         kmeans_iters=VQ_ITERS)
        x = torch.from_numpy(mesh.shard_batch(inp["x"]))
        draws = {k: torch.from_numpy(v) for k, v in inp["draws"][name].items()}
        o = tvq.vq_forward(tvq.CodebookState(embed, avg, cs, initted), x, p, train=True, **draws)
        res = {"indices": o.indices.numpy(),
               **{f: getattr(o.state, f).numpy() for f in ("embed", "embed_avg", "cluster_size")}}
        if km:
            means, bins = tvq.kmeans(x.reshape(-1, VQ_D), VQ_K, VQ_ITERS, draws["kmeans_idx"])
            res.update(means=means.numpy(), bins=bins.numpy())
        out[name] = res
    return out


class DrawRecorder:
    """Wraps ``models/vq.py::_global_rows``: the global row indices each
    k-means init and dead-code expiry asked for, and the rows it got."""

    def __init__(self):
        self.calls, self.real = [], tvq._global_rows

    def __enter__(self):
        def recording(flat, idx):
            rows = self.real(flat, idx)
            self.calls.append((idx.clone(), rows.clone()))
            return rows

        tvq._global_rows = recording
        return self

    def __exit__(self, *exc):
        tvq._global_rows = self.real


def km_data():
    X, y = tdata.make_synthetic_trajectories(n=48, channels=C, length=L, n_classes=N_CLASSES,
                                             seed=15)
    return tdata.DatasetSplits(X_train=X[:32], y_train=y[:32, None], X_test=X[32:],
                               y_test=y[32:, None], scaler=None, n_classes=N_CLASSES)


def km_run(save_path):
    """``train_stage1`` with k-means init and dead-code expiry on -> (state,
    the rows it drew)."""
    with DrawRecorder() as rec:
        state = runner.train_stage1(Config.from_dict(KM_CFG), km_data(), max_steps=S1_STEPS,
                                    seed=3, device="cpu", log_interval=1, save_path=save_path)
    return state, rec.calls


def port_stage1(workdir):
    """Straight; then again with its stage checkpoint removed after the run,
    so that the third call resumes from the step-2 snapshot."""
    full, calls = km_run(os.path.join(workdir, "s1full", "stage1"))
    part = os.path.join(workdir, "s1part", "stage1")
    km_run(part)
    mesh.barrier()
    if mesh.process_index() == 0:
        os.remove(part)
        os.remove(part + ".meta.json")
    mesh.barrier()
    resumed, _ = km_run(part)
    return {"full": runner.stage1_to_jax(full.model, full.vq_l, full.vq_h),
            "resumed": runner.stage1_to_jax(resumed.model, resumed.vq_l, resumed.vq_h),
            "draws": full.draws.get_state(), "calls": calls}


def port_sweeps(inp):
    frozen = _frozen(inp["s1"], L)
    out = {}
    for bs in SWEEP_BATCHES:
        out[bs] = (tst2.precompute_token_dataset(frozen, inp["X"], batch_size=bs,
                                                 data_parallel=True),
                   tst3.precompute_xprime_dataset(frozen, inp["X"], batch_size=bs,
                                                  data_parallel=True))
    return out


class FakeMetrics:
    """What ``runner._running_metrics`` reads of an ``evaluation.Metrics``,
    recording the series each validation scores instead."""

    z_test = X_test = None

    def __init__(self):
        self.seen = []

    def z_gen_fn(self, x):
        self.seen.append(np.array(x))

    def fid_score(self, *a, **kw):
        return 0.0

    def stat_metrics(self, *a):
        return 0.0, 0.0, 0.0, 0.0


class Losses:
    def __init__(self):
        self.loss = []

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.loss.append(float(metrics["train/loss"]))


def run_data():
    X, y = tdata.make_synthetic_trajectories(n=28, channels=C, length=L, n_classes=N_CLASSES,
                                             seed=16)
    return tdata.DatasetSplits(X_train=X[:24], y_train=y[:24, None], X_test=X[24:],
                               y_test=y[24:, None], scaler=None, n_classes=N_CLASSES)


def run_frozen():
    """A seeded small stage 1, frozen."""
    from tvqvae_tpu_torch.models.stage1 import init_stage1

    model, vq_l, vq_h = init_stage1(Stage1Spec.from_config(Config.from_dict(CFG), L, C),
                                    torch.Generator().manual_seed(17), "cpu")
    return tmg.FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)


def stage_run(stage, precompute, metrics=None, stage2_ckpt=None):
    """``train_stage2`` or ``train_stage3`` (tau 0) of ``CFG`` for RUN_STEPS
    steps, validating at the last -> (losses, state dicts, the validation's
    series)."""
    logger = Losses()
    kw = dict(max_steps=RUN_STEPS, seed=4, device="cpu", logger=logger, log_interval=1,
              precompute=precompute, metrics=metrics, val_n_samples=VAL_N)
    if stage == 2:
        state = runner.train_stage2(Config.from_dict(CFG), run_data(), run_frozen(), **kw)
        sd = {"l": dict(state.t_l.state_dict()), "h": dict(state.t_h.state_dict())}
    else:
        state = runner.train_stage3(Config.from_dict(CFG), run_data(), run_frozen(),
                                    stage2_ckpt=stage2_ckpt, **kw)
        sd = {"fe": dict(state.fe.state_dict())}
    return {"loss": logger.loss, "sd": sd, "val": metrics.seen if metrics is not None else None}


def port_stages(workdir):
    out = {}
    for stage in (2, 3):
        # the primary alone holds the metrics, as in the train CLI
        metrics = FakeMetrics() if mesh.is_primary() else None
        ckpt = os.path.join(workdir, "stage2") if stage == 3 else None
        out[stage] = {"pre": stage_run(stage, True, metrics, ckpt),
                      "fly": stage_run(stage, False, None, ckpt)}
    return out


def worker(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {"one_host": mesh.one_host(), "vq": port_vq(cases["vq"]), "s1": port_stage1(workdir),
           "sweeps": port_sweeps(cases["sweeps"]), "stages": port_stages(workdir)}
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's side, and one process of the port


def jax_vq():
    import jax
    import jax.numpy as jnp

    from tvqvae_tpu.models.vq import CodebookState as JState, VQParams as JParams
    from tvqvae_tpu.models.vq import kmeans as j_kmeans, vq_forward as j_vq_forward

    x = np.random.default_rng(4).normal(size=(VQ_B, VQ_N, VQ_D)).astype(np.float32)
    M = VQ_B * VQ_N
    inp, ref = {"x": x, "state": {}, "draws": {}}, {"x": x}
    for i, (name, (km, thr, seed)) in enumerate(VQ_CASES.items()):
        rng = np.random.default_rng(seed)
        embed = (np.zeros((VQ_K, VQ_D)) if km else rng.normal(size=(VQ_K, VQ_D))).astype(np.float32)
        avg = (embed + 0.1 * rng.normal(size=(VQ_K, VQ_D))).astype(np.float32)
        cs = rng.uniform(0, 3, VQ_K).astype(np.float32)
        state = (embed, avg, cs, np.asarray(not km))
        key = jax.random.key(6 + i)
        out = j_vq_forward(JState(*map(jnp.asarray, state)), jnp.asarray(x),
                           JParams(VQ_K, VQ_D, threshold_ema_dead_code=thr, kmeans_init=km,
                                   kmeans_iters=VQ_ITERS), train=True, rng=key)
        draws, res = {}, {"indices": np.asarray(out.indices)}
        res.update({f: np.asarray(getattr(out.state, f))
                    for f in ("embed", "embed_avg", "cluster_size")})
        if km:
            key, krng = jax.random.split(key)
            draws["kmeans_idx"] = np.array(jax.random.randint(krng, (VQ_K,), 0, M))
            means, bins = j_kmeans(krng, jnp.asarray(x.reshape(M, VQ_D)), VQ_K, VQ_ITERS)
            res.update(means=np.asarray(means), bins=np.asarray(bins))
            codebook = np.asarray(means, np.float64)  # what the step's assignment reads
        else:
            codebook = embed.astype(np.float64)
        if thr:
            key, erng = jax.random.split(key)
            draws["dead_code_idx"] = np.array(jax.random.randint(erng, (VQ_K,), 0, M))
            res["expired"] = np.asarray(out.state.cluster_size) < thr
        d = ((x.reshape(M, 1, VQ_D).astype(np.float64) - codebook[None]) ** 2).sum(-1)
        d.sort(axis=1)
        res["tie_gap"] = float((d[:, 1] - d[:, 0]).min() / d[:, 0].max())
        inp["state"][name], inp["draws"][name], ref[name] = state, draws, res
    return inp, ref


def jax_sweeps():
    from tvqvae_tpu.models import maskgit as jmg
    from tvqvae_tpu.train import stage2 as jst2
    from tvqvae_tpu.train import stage3 as jst3

    from test_torch_parallel import _jax_stage1

    model, tree = _jax_stage1(L, seed=18)
    frozen = jmg.FrozenStage1(params=tree["params"], batch_stats=tree["batch_stats"],
                              vq_l=tree["vq_l"], vq_h=tree["vq_h"])
    X = np.random.default_rng(19).normal(size=(SWEEP_N, C, L)).astype(np.float32)
    tok = jst2.precompute_token_dataset(model, frozen, X, batch_size=64)
    xprime = jst3.precompute_xprime_dataset(model, frozen, X, batch_size=32)
    return {"s1": convert.stage1_from_jax(tree), "X": X}, {"tokens": tok, "xprime": xprime}


def one_process_stage1(tmp):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, calls = km_run(os.path.join(tmp, "stage1"))
    finally:
        torch.set_num_threads(n)
    return {"final": runner.stage1_to_jax(state.model, state.vq_l, state.vq_h),
            "draws": state.draws.get_state(), "calls": calls,
            "cluster_sizes": (state.vq_l.cluster_size, state.vq_h.cluster_size)}


def write_stage2(path):
    """A seeded stage 2 (one step) for the stage-3 validations to sample from."""
    cfg = Config.from_dict(CFG)
    runner.train_stage2(cfg, run_data(), run_frozen(), max_steps=1, seed=6, device="cpu",
                        save_path=path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's references, then two gloo ranks running every case while this
    process runs (b)'s one-process run: (references, [rank 0's, rank 1's
    results], the work directory)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("fanout"))
    try:
        cases, refs = {}, {}
        cases["vq"], refs["vq"] = jax_vq()
        cases["sweeps"], refs["sweeps"] = jax_sweeps()
        write_stage2(os.path.join(work, "stage2"))
    finally:
        torch.set_num_threads(n)
    with open(os.path.join(work, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(W),
                               str(port), work], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(W)]
    try:
        refs["s1"] = one_process_stage1(work)
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(W):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return refs, outs, work


def _bound(x, n):
    """(n-1)·2⁻²⁴·Σ|x| per column of the rows ``x`` (M, D)."""
    return (n - 1) * 2.0 ** -24 * np.abs(x).astype(np.float64).sum(0)


@pytest.mark.parametrize("case", list(VQ_CASES))
def test_vq_kmeans_and_dead_codes_two_ranks_match_jax(ranks, case):
    refs, outs, _ = ranks
    ref, ours = refs["vq"][case], [o["vq"][case] for o in outs]
    assert ref["tie_gap"] > 1e-3  # no near tie at the step's assignment
    M = VQ_B * VQ_N
    x = refs["vq"]["x"].reshape(M, VQ_D)
    bound = _bound(x, M)[None, :]
    np.testing.assert_array_equal(np.concatenate([o["indices"] for o in ours]), ref["indices"])
    got = ours[0]
    np.testing.assert_array_equal(got["cluster_size"], ref["cluster_size"])
    avg = np.abs(got["embed_avg"] - ref["embed_avg"])
    assert (avg <= bound + 2.0 ** -22 * np.abs(ref["embed_avg"])).all()
    cs = ref["cluster_size"].astype(np.float64)
    smoothed = (cs + 1e-5) / (cs.sum() + VQ_K * 1e-5) * cs.sum()
    err = np.abs(got["embed"] - ref["embed"])
    within = err <= bound / smoothed[:, None] + 2.0 ** -21 * np.abs(ref["embed"])
    if "expired" in ref:
        assert ref["expired"].any()  # some codes did expire: their rows exactly
        np.testing.assert_array_equal(got["embed"][ref["expired"]], ref["embed"][ref["expired"]])
        within |= ref["expired"][:, None]
    assert within.all()
    if "means" in ref:
        np.testing.assert_array_equal(got["bins"], ref["bins"])
        assert (np.abs(got["means"] - ref["means"]) <= bound).all()
    for k, v in ours[0].items():  # the ranks' codebooks and k-means (each its own indices)
        if k != "indices":
            np.testing.assert_array_equal(v, ours[1][k], err_msg=k)


def test_train_stage1_kmeans_and_dead_codes_two_ranks_match_one_process(ranks):
    """Four steps of both codebooks with k-means init (at step 1) and dead-code
    expiry: the ranks draw the global rows one process draws and end with
    its draw generator's state; the rows they got and the state after the
    steps within Adam's element rule (``test_torch_parallel.py``); both
    ranks' states equal."""
    from chip_smoke import biases_cancelled_by_batchnorm

    refs, outs, _ = ranks
    one = refs["s1"]
    assert any(bool((cs < KM_CFG["VQ-VAE"]["threshold_ema_dead_code"]).any())
               for cs in one["cluster_sizes"])  # codes expire
    # per step and band: a dead-code draw, after the k-means draw of step 1
    assert len(one["calls"]) == 2 * S1_STEPS + 2
    for o in outs:
        assert torch.equal(o["s1"]["draws"], one["draws"])
        assert len(o["s1"]["calls"]) == len(one["calls"])
        for (idx, rows), (ridx, rrows) in zip(o["s1"]["calls"], one["calls"]):
            assert torch.equal(idx, ridx)
            np.testing.assert_allclose(rows.numpy(), rrows.numpy(), rtol=2e-4, atol=2e-4)
    ours = convert.stage1_from_jax(outs[0]["s1"]["full"])
    theirs = convert.stage1_from_jax(one["final"])
    cfg = Config.from_dict(KM_CFG)
    noise = 2 * sum(warmup_cosine_schedule(cfg.exp_params.lr, S1_STEPS)(t) for t in range(S1_STEPS))
    cancelled = biases_cancelled_by_batchnorm(Stage1Model(Stage1Spec.from_config(cfg, L, C)))
    beyond, n_el = 0, 0
    for k, r in theirs.items():
        if k.endswith(("num_batches_tracked", "initted")):
            assert torch.equal(torch.as_tensor(ours[k]), torch.as_tensor(r)), k
            continue
        err = np.abs(np.asarray(ours[k], np.float64) - np.asarray(r, np.float64))
        assert err.max() <= 2e-4 + noise, k
        if k not in cancelled and not k.endswith("running_mean"):
            beyond += int((err > 2e-4 + 2e-4 * np.abs(np.asarray(r))).sum())
            n_el += err.size
    assert beyond <= 1e-4 * n_el, (beyond, n_el)
    a, b = (dict(tckpt._flatten(o["s1"]["full"])) for o in outs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_stage1_kmeans_and_dead_codes_resume_equals_straight_run(ranks):
    """Resumed from the step-2 snapshot, which holds the draw generator's
    state, the two-rank run ends bit-equal to the straight one."""
    _, outs, _ = ranks
    for o in outs:
        full, resumed = (dict(tckpt._flatten(o["s1"][k])) for k in ("full", "resumed"))
        assert set(full) == set(resumed)
        for k in full:
            np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


@pytest.mark.parametrize("bs", SWEEP_BATCHES)
def test_sweeps_over_two_ranks_match_jax(ranks, bs):
    refs, outs, _ = ranks
    ref = refs["sweeps"]
    for o in outs:
        (tok_l, tok_h), xprime = o["sweeps"][bs]
        np.testing.assert_array_equal(tok_l, ref["tokens"][0])
        np.testing.assert_array_equal(tok_h, ref["tokens"][1])
        assert xprime.shape == (SWEEP_N, C, L)
        scale = np.abs(ref["xprime"]).max()
        np.testing.assert_allclose(xprime, ref["xprime"], rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("stage", [2, 3])
def test_precompute_in_a_group_equals_the_on_the_fly_steps(ranks, stage):
    """The ranks share one host, so the runner precomputes (spread over
    them); its steps on the precomputed slices equal the on-the-fly steps
    of the same ranks bit for bit."""
    _, outs, _ = ranks
    for o in outs:
        assert o["one_host"]
        pre, fly = o["stages"][stage]["pre"], o["stages"][stage]["fly"]
        assert pre["loss"] == fly["loss"]
        for part, sd in pre["sd"].items():
            assert set(sd) == set(fly["sd"][part])
            for k, v in sd.items():
                assert torch.equal(v, fly["sd"][part][k]), (part, k)
    assert len(outs[0]["stages"][stage]["pre"]["loss"]) == RUN_STEPS


@pytest.mark.parametrize("stage", [2, 3])
def test_validation_over_two_ranks_equals_one_process(ranks, stage):
    """The primary's validation, decoded (and, in stage 3, enhanced) over
    both ranks, against one process's validation of the final state: the
    same series, bit for bit."""
    _, outs, work = ranks
    o = outs[0]["stages"][stage]["pre"]
    assert outs[1]["stages"][stage]["pre"]["val"] is None  # the other rank scores nothing
    cfg = Config.from_dict(CFG)
    frozen = run_frozen()
    spec = tmg.MaskGITSpec.from_config(cfg, frozen.model.spec)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if stage == 2:
            t_l, t_h = tmg.build_transformers(cfg, frozen.model.spec, N_CLASSES)
            t_l.load_state_dict(o["sd"]["l"])
            t_h.load_state_dict(o["sd"]["h"])
            sets = runner._val_samples(cfg, tst2.make_sampling_fn(frozen, t_l, t_h, spec), VAL_N,
                                       10_000 + RUN_STEPS, torch.device("cpu"))
        else:
            tree, _ = tckpt.load_checkpoint(os.path.join(work, "stage2"))
            t_l, t_h = tst2.priors_from_tree(cfg, frozen.model.spec, N_CLASSES, tree)
            fe = FidelityEnhancer.from_config(cfg, L, C)
            fe.load_state_dict(o["sd"]["fe"])
            sets = runner._val_samples(cfg, tst2.make_sampling_fn(frozen, t_l.eval(), t_h.eval(),
                                                                  spec),
                                       VAL_N, 20_000 + RUN_STEPS, torch.device("cpu"),
                                       enhance=fe)
    finally:
        torch.set_num_threads(n)
    assert len(o["val"]) == len(sets) == stage - 1
    for got, (_, want) in zip(o["val"], sets):
        assert got.shape == (VAL_N, C, L)
        np.testing.assert_array_equal(got, want)


def test_one_process_gathers_and_one_host_are_identities():
    assert not mesh.initialized() and mesh.one_host()
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(t) is t


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
