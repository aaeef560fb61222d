"""Stage-1 (VQ-VAE) training step and state.

Port of ``tvqvae_tpu/train/stage1.py``. One step: forward in train mode
(STFT -> encoders -> VQ -> decoders), loss (MSE LF + L1 HF + commitment),
``backward``, AdamW with the warmup-cosine schedule, and the side state
advanced: BatchNorm running statistics (in the modules) and the two
codebooks (one EMA step each, from the VQ kernel's counts and row sums).

JAX's step is a pure function of the state; here the state holds the model
and optimizer, which the step updates in place. Metrics stay on the device
as 0-dim tensors: reading one waits for the device.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from tvqvae_tpu_torch.models.stage1 import Stage1Model, stage1_losses
from tvqvae_tpu_torch.models.vq import CodebookState


@dataclass
class Stage1TrainState:
    model: Stage1Model
    vq_l: CodebookState
    vq_h: CodebookState
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_stage1_state(model: Stage1Model, vq_l: CodebookState, vq_h: CodebookState,
                        tx: Callable) -> Stage1TrainState:
    """``tx(parameters) -> (optimizer, scheduler)``, e.g. ``train/optim.py::adamw``
    with its schedule bound."""
    optimizer, scheduler = tx(model.parameters())
    return Stage1TrainState(model, vq_l, vq_h, optimizer, scheduler)


Metrics = Dict[str, torch.Tensor]


def make_stage1_train_step() -> Callable:
    """Returns step(state, x, generator=None) -> (state, metrics); ``generator``
    draws the dropout masks (on the model's device)."""

    def step(state: Stage1TrainState, x: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[Stage1TrainState, Metrics]:
        out = state.model(x, state.vq_l, state.vq_h, train=True, generator=generator)
        total, metrics = stage1_losses(out)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.vq_l, state.vq_h = out.vq_l.state, out.vq_h.state
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_stage1_eval_step(per_sample: bool = False) -> Callable:
    """Eval step (eval-mode BatchNorm, no dropout, codebooks unchanged, commit
    loss 0). Default: step(state, x) -> (batch-mean metrics, out). With
    ``per_sample``: -> ({name: (B,) per-sample losses}, {name: batch
    scalars}, out), so a caller can average over a whole split in fixed
    batches with the padding masked out."""

    @torch.no_grad()
    def step(state: Stage1TrainState, x: torch.Tensor):
        out = state.model(x, state.vq_l, state.vq_h, train=False)
        if per_sample:
            per = {
                "recons_loss.LF.time": ((out.x_l - out.xhat_l) ** 2).mean(dim=(1, 2)),
                "recons_loss.HF.time": (out.x_h - out.xhat_h).abs().mean(dim=(1, 2)),
            }
            scalars = {"perplexity.LF": out.vq_l.perplexity, "perplexity.HF": out.vq_h.perplexity}
            return per, scalars, out
        _, metrics = stage1_losses(out)
        return metrics, out

    return step
