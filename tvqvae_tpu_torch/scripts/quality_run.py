"""End-to-end quality run: synthetic data -> 3-stage training -> FID ladder.

Port of ``tools/quality_run.py``, with its flags and defaults and one more,
``--device``:

    python -m tvqvae_tpu_torch.scripts.quality_run --workdir DIR [--bf16] \
        [--ess] [--n_eval 256] [--seed 0] [--skip_train] [--device cuda]

It builds the synthetic set the JAX tool trains on
(``make_synthetic_trajectories(n=1200, channels=4, length=512,
n_classes=5, seed=7)``), writes the same config overrides
(``CFG_OVERRIDES``: hid_dim 64, budgets 3000/5000/1000, ROCKET features)
as a JSON config, trains stages 1, 2 and 3 through the train CLI
(``scripts/train.py::main``, the precision flags passed resolved, as the
JAX tool passes them), and scores the ladder with the port's ``Metrics``
(ROCKET features, FID against the train split):

    floor (z_train vs z_test) <~ rec (stage-1 round trip) <~ gen (the
    sampler) <~ gen_fe (the sampler's samples enhanced) << noise

With ``--ess`` it also times the ESS sampler on the trained stages 1-2 (ms
per 32-batch over 10 batches after a warm-up, waiting for the device) and
scores ``fid_gen_ess``. It prints the JAX tool's JSON lines, one line of
its own (minutes and median ms per step of each stage, the VQ kernel's
launches, the prior forwards a batch and the plain sampler's ms per
32-batch beside ESS's), and the ``SUMMARY`` line with the JAX tool's keys.

It trains with the train CLI's ``--bundle_steps`` default of 10, as the
JAX tool does: a JAX bundle (``tvqvae_tpu/train/runner.py::make_multistep``)
scans 10 steps in one device program; the port captures each stage's step
once as a CUDA graph and replays it 10 times a bundle
(``train/multistep.py``; on the CPU a loop of the same steps). Either way
the steps are the single steps and the logged train metrics bundle means.
"""

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.data import get_data, make_synthetic_trajectories, save_npz
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.ops import vq_kernel
from tvqvae_tpu_torch.scripts import train
from tvqvae_tpu_torch.scripts._cli import load_config

# tools/quality_run.py's CFG_OVERRIDES, in the reference schema
CFG_OVERRIDES = {
    "dataset": {"batch_sizes": {"stage1": 32, "stage2": 16, "stage3": 16}},
    "encoder": {"hid_dim": 64},
    "trainer_params": {
        "max_steps": {"stage1": 3000, "stage2": 5000, "stage3": 1000},
        "val_check_interval": {"stage1": 1500, "stage2": 2500, "stage3": 500},
    },
    "evaluation": {"batch_size": 64, "feature_extractor_type": "rocket"},
}
DATA = dict(n=1200, channels=4, length=512, n_classes=5, seed=7)
STEM = "qr"  # the dataset file's stem names the checkpoint directory
ESS_BATCH, ESS_ITERS = 32, 10
# the JAX tool's SUMMARY keys; --ess adds ess_ms_per_32batch and fid_gen_ess
SUMMARY_KEYS = ("fid_floor", "fid_noise", "fid_rec", "fid_gen", "fid_gen_fe", "train_minutes",
                "bf16", "fast_bn", "bf16_mu", "bf16_nu", "bf16_head", "bf16_istft", "seed")


def build_argparser():
    ap = argparse.ArgumentParser(description="End-to-end quality run (PyTorch port)")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "qr"))
    ap.add_argument("--fast_bn", action=argparse.BooleanOptionalAction, default=True,
                    help="stage-1 BatchNorm and stage-3 GroupNorm in the compute dtype "
                         "(the train CLI's default)")
    ap.add_argument("--bf16", action="store_true",
                    help="train the stage-1 conv stacks and the stage-3 stream in bfloat16")
    ap.add_argument("--bf16_mu", action=argparse.BooleanOptionalAction, default=True,
                    help="AdamW's first moment in bfloat16 (all stages; the train CLI's default)")
    ap.add_argument("--bf16_nu", action="store_true",
                    help="AdamW's second moment in bfloat16 (all stages)")
    ap.add_argument("--bf16_head", action=argparse.BooleanOptionalAction, default=True,
                    help="stage-1 TimeHead dense in the compute dtype (the train CLI's default)")
    ap.add_argument("--bf16_istft", action="store_true",
                    help="stage-1 training-side iSTFT in the compute dtype")
    ap.add_argument("--ess", action="store_true",
                    help="also time the ESS sampler on the trained stages and score it")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (train CLI --seed) and sampling-seed offset; the "
                         "dataset's seed stays 7")
    ap.add_argument("--n_eval", type=int, default=256)
    ap.add_argument("--fid_method", choices=("schur", "svd"), default="schur",
                    help="the ladder's FID: schur (the JAX tool's, seconds of host time each "
                         "at 2000 ROCKET features) or svd (the same quantity, milliseconds)")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the checkpoints already in workdir")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _train_argv(args, cfg_path: str, data_path: str, wd: str, stage: str):
    """The train CLI's command line, the precision flags resolved as the JAX
    tool passes them (so a flipped CLI default cannot change the arm)."""
    argv = ["--config", cfg_path, "--dataset_file", data_path, "--stage", stage,
            "--model_save_dir", os.path.join(wd, "models"), "--run_dir", os.path.join(wd, "runs"),
            "--device", args.device]
    if args.bf16:
        argv.append("--bf16")
    argv.append("--fast_bn" if args.fast_bn else "--no-fast_bn")
    argv.append("--bf16_mu" if args.bf16_mu else "--no-bf16_mu")
    if args.bf16_nu:
        argv.append("--bf16_nu")
    argv.append("--bf16_head" if args.bf16_head else "--no-bf16_head")
    if args.bf16_istft:
        argv.append("--bf16_istft")
    return argv + ["--seed", str(args.seed)]


def _step_ms_p50(run_dir: str) -> Optional[float]:
    """The runner's last logged median ms per step (``StepTimer``, host
    clock, over its last 200 steps) in ``run_dir/metrics.jsonl``."""
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    last = None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            last = rec.get("perf/step_time_p50_ms", last)
    return last


def _time_batches(sampler: TrainedModelSampler, device: str):
    """ms per 32-batch of ``sampler``'s token sampling and decoders over
    ``ESS_ITERS`` batches after a warm-up, and the prior forwards a batch
    (LF and HF)."""
    gen = torch.Generator(device=sampler.device).manual_seed(0)
    sampler._sample_tokens(ESS_BATCH, None, generator=gen)
    forwards = []
    hooks = [m.register_forward_pre_hook(lambda *_: forwards.append(1))
             for m in (sampler.t_l, sampler.t_h)]
    try:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(ESS_ITERS):
            sampler._sample_tokens(ESS_BATCH, None, generator=gen)
        _sync(device)
        ms = (time.perf_counter() - t0) / ESS_ITERS * 1e3
    finally:
        for h in hooks:
            h.remove()
    return ms, len(forwards) / ESS_ITERS


def run(args, overrides: Mapping = CFG_OVERRIDES) -> Tuple[dict, dict]:
    """The quality run under ``args`` (``build_argparser``'s), with the
    config ``overrides`` (the JAX tool's by default; tests and the card
    smoke pass cut budgets). -> (the SUMMARY dict, the port's own line:
    minutes and median ms per step by stage, VQ launches in training and
    in FID_rec, prior forwards a batch and ms per 32-batch of the ESS and
    the plain sampler)."""
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    cfg_path = os.path.join(wd, "cfg.json")
    data_path = os.path.join(wd, f"{STEM}.npz")

    # --- data + config ---------------------------------------------------
    X, y = make_synthetic_trajectories(**DATA)
    save_npz(data_path, X, y)
    with open(cfg_path, "w") as f:
        json.dump(dict(overrides), f, indent=1)
    cfg = load_config(cfg_path)

    # --- train, stage by stage (what --stage all runs), each timed -------
    stage_min, step_ms = {}, {}
    launches = vq_kernel.launch_count
    t0 = time.time()
    if not args.skip_train:
        for stage in ("1", "2", "3"):
            ts = time.time()
            train.main(_train_argv(args, cfg_path, data_path, wd, stage))
            _sync(args.device)
            stage_min[f"stage{stage}"] = (time.time() - ts) / 60.0
            step_ms[f"stage{stage}"] = _step_ms_p50(os.path.join(wd, "runs",
                                                                 f"{STEM}_stage{stage}"))
    train_minutes = (time.time() - t0) / 60.0
    vq = {"train": vq_kernel.launch_count - launches}
    print(json.dumps({"train_minutes": round(train_minutes, 1), "bf16": args.bf16,
                      "bf16_mu": args.bf16_mu, "bf16_nu": args.bf16_nu,
                      "bf16_head": args.bf16_head, "seed": args.seed,
                      "fast_bn": args.fast_bn}), flush=True)

    # --- FID ladder ------------------------------------------------------
    data = get_data(data_path, cfg.dataset.features, scale=cfg.dataset.data_scaling)
    ckpt = os.path.join(wd, "models", STEM)
    n = args.n_eval
    metrics = Metrics(data.input_length, data.in_channels, data.n_classes,
                      cfg.evaluation.batch_size, data.X_train, data.X_test,
                      feature_extractor_type="rocket", fid_method=args.fid_method,
                      device=args.device)
    res = {"fid_floor": metrics.fid_score(metrics.z_train, metrics.z_test)}
    noise = np.random.default_rng(0).normal(
        size=(n, data.in_channels, data.input_length)).astype(np.float32)
    res["fid_noise"] = metrics.fid_score(metrics.z_train, metrics.z_gen_fn(noise))
    print(json.dumps({k: round(v, 5) for k, v in res.items()}), flush=True)

    sampler = TrainedModelSampler.from_checkpoints(
        cfg, f"{ckpt}/stage1", f"{ckpt}/stage2", f"{ckpt}/stage3",
        use_fidelity_enhancer=True, batch_size=64, device=args.device)
    launches = vq_kernel.launch_count
    xrec = sampler.reconstruct(data.X_train[:n])
    vq["rec"] = vq_kernel.launch_count - launches
    res["fid_rec"] = metrics.fid_score(metrics.z_train, metrics.z_gen_fn(xrec))
    sampler.use_fe = False  # raw samples first; enhance() them separately
    _, _, xgen = sampler.sample(n, seed=1 + args.seed)
    xgen_fe = sampler.enhance(xgen)
    res["fid_gen"] = metrics.fid_score(metrics.z_train, metrics.z_gen_fn(xgen))
    res["fid_gen_fe"] = metrics.fid_score(metrics.z_train, metrics.z_gen_fn(xgen_fe))
    print(json.dumps({k: round(float(v), 5) for k, v in res.items()}), flush=True)

    # --- ESS (optional) --------------------------------------------------
    ess = {}
    if args.ess:
        ess_cfg = dataclasses.replace(cfg, maskgit=dataclasses.replace(cfg.maskgit, ess_use=True))
        ess_sampler = TrainedModelSampler.from_checkpoints(
            ess_cfg, f"{ckpt}/stage1", f"{ckpt}/stage2", batch_size=ESS_BATCH,
            device=args.device)
        res["ess_ms_per_32batch"], ess["prior_forwards_per_batch"] = _time_batches(
            ess_sampler, args.device)
        # the plain sampler over the same weights, timed alike, for comparison
        ess["plain_ms_per_32batch"], ess["plain_prior_forwards_per_batch"] = _time_batches(
            sampler, args.device)
        _, _, x_ess = ess_sampler.sample(n, seed=2)
        res["fid_gen_ess"] = metrics.fid_score(metrics.z_train, metrics.z_gen_fn(x_ess))

    details = {"stage_minutes": stage_min, "step_ms_p50": step_ms, "vq_launches": vq,
               "ess": ess, "device": args.device}
    print(json.dumps(details), flush=True)
    res["train_minutes"] = train_minutes
    for k in SUMMARY_KEYS[6:]:
        res[k] = getattr(args, k)
    summary = {k: (round(float(v), 5) if isinstance(v, (int, float)) and not isinstance(v, bool)
                   else v) for k, v in res.items()}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return summary, details


def main(argv=None):
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
