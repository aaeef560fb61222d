"""Stage-1 training orchestration.

Port of the stage-1 part of ``tvqvae_tpu/train/runner.py``: ``_adamw``,
``_loop``, ``codebook_to_dict``/``codebook_from_dict`` and ``train_stage1``.
The loop is the JAX package's device-data path: the train split is uploaded
once, each step gathers its batch on the device by index, and validation
runs over the whole test split in fixed, wrap-padded batches with the
padding masked out of the sums. Nothing reads a value back from the device
between steps; the loop waits for the device only where it prints or
validates.

Not ported yet (ROADMAP item 11): the checkpoint writer (``save_path``),
mid-run snapshots and resume, and the ``scripts/train.py`` CLI.
``train_stage1`` returns the final ``Stage1TrainState`` instead.
"""

import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits, make_batches
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.models.vq import CodebookState
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.train.stage1 import (
    Stage1TrainState,
    create_stage1_state,
    make_stage1_eval_step,
    make_stage1_train_step,
)
from tvqvae_tpu_torch.utils.device import resolve_device
from tvqvae_tpu_torch.utils.profiling import StepTimer
from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule


def codebook_to_dict(cb: CodebookState) -> dict:
    return {f: getattr(cb, f).detach().cpu().numpy()
            for f in ("embed", "embed_avg", "cluster_size", "initted")}


def codebook_from_dict(d: dict) -> CodebookState:
    """A codebook on the CPU (``.to(device)`` moves it)."""
    return CodebookState(*(torch.as_tensor(np.asarray(d[f]))
                           for f in ("embed", "embed_avg", "cluster_size", "initted")))


def _adamw(cfg: Config, max_steps: int) -> Callable:
    """AdamW (weight decay 0.01) with the reference warmup-cosine schedule, as
    ``tx(parameters) -> (optimizer, scheduler)``."""
    schedule = warmup_cosine_schedule(cfg.exp_params.lr, max_steps,
                                      cfg.exp_params.linear_warmup_rate)
    return functools.partial(adamw, learning_rate=schedule, weight_decay=0.01)


def _loop(name: str, max_steps: int, train_once, eval_once, logger, val_interval: int,
          log_interval: int = 100):
    """Call ``train_once(step)`` for steps 1..``max_steps``; log every
    ``log_interval`` steps and validate and print every ``val_interval`` and
    at the end. ``logger.log_metrics(metrics, step)`` gets the train metrics
    as 0-dim device tensors (reading one waits for the device) and the
    validation metrics as floats."""
    timer = StepTimer()
    t0 = time.time()
    last = {"step": 0, "t": t0}  # segment-rate anchor
    for step in range(1, max_steps + 1):
        metrics = train_once(step)
        timer.tick()
        if logger and (step % log_interval == 0 or step == max_steps):
            logger.log_metrics({f"train/{k}": v for k, v in metrics.items()}
                               | timer.summary(), step)
        if step % max(val_interval, 1) == 0 or step == max_steps:
            val = eval_once(step) if eval_once else {}
            now = time.time()
            rate = step / (now - t0)
            # the rate since the last print shows a slowdown a cumulative one hides
            seg = (step - last["step"]) / max(now - last["t"], 1e-9)
            last["step"], last["t"] = step, now
            line = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            print(f"[{name}] step {step}/{max_steps} "
                  f"({rate:.1f} it/s cum, {seg:.1f} seg) {line}")
            if logger and val:
                logger.log_metrics({f"val/{k}": v for k, v in val.items()}, step)


def train_stage1(
    cfg: Config,
    data: DatasetSplits,
    max_steps: Optional[int] = None,
    seed: int = 0,
    logger=None,
    bundle_steps: int = 1,
    device="cuda",
    log_interval: int = 100,
    compute_dtype: str = "float32",
    remat: bool = False,
    fast_bn: bool = False,
    bf16_mu: bool = False,
    bf16_nu: bool = False,
    bf16_head: bool = False,
    bf16_istft: bool = False,
    tp: int = 1,
    rng_impl: Optional[str] = None,
) -> Stage1TrainState:
    """Train stage 1 from seeded random weights for ``max_steps`` (default:
    the config's) and return the final state. Batches of
    ``dataset.batch_sizes["stage1"]`` follow ``make_batches(shuffle=True,
    seed=seed, repeat=True)``; dropout masks come from a generator seeded
    ``seed + 1``. The step bundles (``bundle_steps`` > 1), reduced-precision,
    remat, tensor-parallel and RNG-implementation options of the JAX runner
    are not ported and raise ``NotImplementedError``."""
    unported = {"bundle_steps": bundle_steps > 1, "compute_dtype": compute_dtype != "float32",
                "remat": remat, "fast_bn": fast_bn, "bf16_mu": bf16_mu, "bf16_nu": bf16_nu, "bf16_head": bf16_head,
                "bf16_istft": bf16_istft, "tp": tp > 1, "rng_impl": rng_impl is not None}
    if any(unported.values()):
        raise NotImplementedError(
            f"not ported yet: {', '.join(k for k, v in unported.items() if v)}")
    dev = resolve_device(device)
    batch_size = cfg.dataset.batch_sizes.get("stage1", 32)
    max_steps = max_steps or cfg.trainer_params.max_steps["stage1"]
    N = len(data.X_train)
    if N < batch_size:
        raise ValueError(f"{N} training series, fewer than one batch of {batch_size}")

    t_init = time.time()
    spec = Stage1Spec.from_config(cfg, data.input_length, data.in_channels)
    model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(seed), dev)
    state = create_stage1_state(model, vq_l, vq_h, _adamw(cfg, max_steps))
    print(f"[stage1] model init: {time.time() - t_init:.1f}s")

    t_up = time.time()
    X_dev = torch.from_numpy(data.X_train).to(dev)
    batches = make_batches(np.arange(N), None, batch_size, shuffle=True, seed=seed, repeat=True)
    order = torch.from_numpy(np.stack([next(batches)[0] for _ in range(max_steps)])).to(dev)
    print(f"[stage1] train split -> {dev}: {data.X_train.nbytes / 1e6:.0f} MB in "
          f"{time.time() - t_up:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    step_fn = make_stage1_train_step()

    def train_once(step):
        return step_fn(state, X_dev[order[step - 1]], gen)[1]

    eval_once = _make_eval(state, data.X_test, batch_size, dev) if len(data.X_test) else None
    t_loop = time.time()
    _loop("stage1", max_steps, train_once, eval_once, logger,
          cfg.trainer_params.val_check_interval.get("stage1", 5000), log_interval)
    print(f"[stage1] loop {time.time() - t_loop:.1f}s")
    return state


def _make_eval(state: Stage1TrainState, X_test: np.ndarray, batch_size: int, dev):
    """Validation over the whole test split: fixed batches of
    ``min(batch_size, N)`` indices, the last wrapped around to the start,
    and the wrapped entries masked out of the per-sample sums, so the
    metrics are exact means over the split."""
    eval_step = make_stage1_eval_step(per_sample=True)
    X = torch.from_numpy(X_test).to(dev)
    N = len(X_test)
    bs = min(batch_size, N)
    nb = -(-N // bs)
    flat = torch.arange(nb * bs, device=dev)
    idx, valid = (flat % N).reshape(nb, bs), (flat < N).reshape(nb, bs)

    def eval_once(step):
        sums, scalar_sums = {}, {}
        for ib, vb in zip(idx, valid):
            per, scalars, _ = eval_step(state, X[ib])
            for k, v in per.items():
                sums[k] = sums.get(k, 0.0) + torch.where(vb, v, 0.0).sum()
            for k, v in scalars.items():
                scalar_sums[k] = scalar_sums.get(k, 0.0) + v
        out = {k: float(v) / N for k, v in sums.items()}
        out.update({k: float(v) / nb for k, v in scalar_sums.items()})
        out["recons_loss.time"] = out["recons_loss.LF.time"] + out["recons_loss.HF.time"]
        # the commitment loss is 0 outside training, so the val loss is the recon terms
        out["loss"] = out["recons_loss.time"]
        return out

    return eval_once
