"""Stage-1 (VQ-VAE) training step and state.

Port of ``tvqvae_tpu/train/stage1.py``. One step: forward in train mode
(STFT -> encoders -> VQ -> decoders), loss (MSE LF + L1 HF + commitment),
``backward``, AdamW with the warmup-cosine schedule, and the side state
advanced: BatchNorm running statistics (in the modules) and the two
codebooks (one EMA step each, from the VQ kernel's counts and row sums).

Inside a ``torch.distributed`` process group each rank steps on its slice
of the global batch; the BatchNorm and VQ statistics are the global batch's
(``models/layers.py``, ``models/vq.py``) and the gradients are averaged
over the ranks before AdamW (``parallel.all_reduce_grads``), so W ranks take
one process's step over the whole batch; the metrics stay per rank (their
mean over the ranks is the global value: ``parallel.all_reduce_metrics``).

JAX's step is a pure function of the state; here the state holds the model
and optimizer, which the step updates in place. Metrics stay on the device
as 0-dim tensors: reading one waits for the device.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from tvqvae_tpu_torch.models.stage1 import Stage1Model, stage1_losses
from tvqvae_tpu_torch.models.vq import CodebookState
from tvqvae_tpu_torch.parallel.mesh import all_reduce_grads


@dataclass
class Stage1TrainState:
    model: Stage1Model
    vq_l: CodebookState
    vq_h: CodebookState
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    draws: Optional[torch.Generator] = None  # the VQ's k-means and dead-code rows


def create_stage1_state(model: Stage1Model, vq_l: CodebookState, vq_h: CodebookState,
                        tx: Callable, draws: Optional[torch.Generator] = None
                        ) -> Stage1TrainState:
    """``tx(parameters) -> (optimizer, scheduler)``, e.g. ``train/optim.py::adamw``
    with its schedule bound. ``draws`` (on the model's device) draws the
    rows of the codebooks' k-means init and dead-code expiry: inside a
    process group every rank holds it in the same state (the runner seeds
    it alike everywhere); without it one process draws them from the
    step's generator."""
    optimizer, scheduler = tx(model.parameters())
    return Stage1TrainState(model, vq_l, vq_h, optimizer, scheduler, draws=draws)


Metrics = Dict[str, torch.Tensor]


def copy_codebook_(dst: CodebookState, src: CodebookState) -> None:
    """Copy ``src``'s tensors into ``dst``'s."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def make_stage1_train_step(in_place: bool = False) -> Callable:
    """Returns step(state, x, generator=None) -> (state, metrics); ``generator``
    draws the dropout masks (on the model's device), ``state.draws`` the
    VQ's k-means and dead-code rows. The step binds the
    state's codebooks to the new ones, or with ``in_place`` copies the new
    ones into the state's tensors, which a CUDA graph of the step needs
    (``train/multistep.py``)."""

    def step(state: Stage1TrainState, x: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[Stage1TrainState, Metrics]:
        out = state.model(x, state.vq_l, state.vq_h, train=True, generator=generator,
                          row_generator=state.draws)
        total, metrics = stage1_losses(out)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        all_reduce_grads(state.model.parameters())
        state.optimizer.step()
        state.scheduler.step()
        if in_place:
            copy_codebook_(state.vq_l, out.vq_l.state)
            copy_codebook_(state.vq_h, out.vq_h.state)
        else:
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
