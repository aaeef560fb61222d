"""Stage 3 (the fidelity enhancer): training state and steps, and the x' set.

Port of ``tvqvae_tpu/train/stage3.py``. The frozen stage 1 degrades a batch
through a stochastic-VQ round trip at temperature tau (``svq_roundtrip``:
encode both bands, quantise, decode, sum) into x', and the enhancer learns
L1(FE(x'), x) with one AdamW step. At tau = 0 the round trip is argmax
through the VQ kernel with eval-mode BatchNorm, deterministic per series, so
the default path computes x' for the whole train split once
(``precompute_xprime_dataset``) and the step runs on (x, x') pairs
(``make_stage3_train_step_pre``); ``make_stage3_train_step`` runs the round
trip inside each step, which tau > 0 needs (x' is then a fresh draw every
step).

JAX splits its key into an SVQ key and a dropout key; here one
``torch.Generator`` draws the SVQ categoricals first, then the dropout
masks. At tau = 0 the round trip draws nothing, so from the same generator
state the two steps make the same update. ``noise`` hands in the SVQ's
Gumbel draws instead (the parity tests pass JAX's). The state holds the
enhancer and its optimizer, which the step updates in place; metrics stay
on the device as 0-dim tensors.

Inside a ``torch.distributed`` process group each rank steps on its slice
and the gradients are averaged over the ranks before AdamW
(``parallel.all_reduce_grads``); the enhancer's GroupNorms are per series.
The x' sweep takes ``data_parallel`` to spread each batch over the group.

With ``percept_loss_weight`` w > 0 (0 in the published config) the loss is
L1 + w mean((percept_fn(FE(x')) - percept_fn(x))^2), ``percept_fn`` being
e.g. a fitted ``evaluation.MiniRocket``. Its PPV features are a hard
threshold, so the term has no gradient, in JAX as here: it moves the
reported ``loss`` and ``percept_loss``, not the update. JAX's step drops
the term silently when no ``percept_fn`` is given; here that is an error.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, decode_tokens, encode_tokens
from tvqvae_tpu_torch.parallel.mesh import all_gather, all_reduce_grads
from tvqvae_tpu_torch.train.stage2 import sweep_batches
from tvqvae_tpu_torch.utils.device import resolve_device

Metrics = Dict[str, torch.Tensor]


@dataclass
class Stage3TrainState:
    fe: FidelityEnhancer
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_stage3(fe: FidelityEnhancer, generator: torch.Generator, device="cuda") -> FidelityEnhancer:
    """Seeded random weights (``layers.init_weights_``; a CPU generator gives
    the same weights on every device) -> the enhancer on ``device``."""
    return init_weights_(fe, generator).to(resolve_device(device))


def create_stage3_state(fe: FidelityEnhancer, tx: Callable) -> Stage3TrainState:
    """``tx(parameters) -> (optimizer, scheduler)``, e.g. ``train/runner.py::_adamw``.
    tau is the step's (``make_stage3_train_step(frozen, tau)``), not the
    state's."""
    return Stage3TrainState(fe, *tx(fe.parameters()))


def _check_percept(percept_loss_weight: float, percept_fn: Optional[Callable]) -> None:
    if percept_loss_weight > 0.0 and percept_fn is None:
        raise ValueError("percept_loss_weight > 0 needs a percept_fn (e.g. a fitted "
                         "evaluation.MiniRocket) for the perceptual loss")


@torch.no_grad()
def svq_roundtrip(frozen: FrozenStage1, x: torch.Tensor, tau: float,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """x (B, C, L) -> x' = decode_lf(SVQ_tau(x)) + decode_hf(SVQ_tau(x)),
    without a gradient. tau = 0: argmax through the VQ kernel, two launches.
    tau > 0: a categorical draw over softmax(-dist / tau) per token, the LF
    draws first; ``noise`` = (LF Gumbel (B*n_l, K_l), HF (B*n_h, K_h))
    replaces them."""
    temp = tau if tau and tau > 0.0 else None
    noise = noise if temp is not None and noise is not None else (None, None)
    s_l = encode_tokens(frozen, x, "lf", svq_temp=temp, generator=generator, noise=noise[0])
    s_h = encode_tokens(frozen, x, "hf", svq_temp=temp, generator=generator, noise=noise[1])
    return decode_tokens(frozen, s_l, "lf") + decode_tokens(frozen, s_h, "hf")


def _fe_update(state: Stage3TrainState, x: torch.Tensor, xprime: torch.Tensor,
               generator: Optional[torch.Generator], percept_loss_weight: float = 0.0,
               percept_fn: Optional[Callable] = None) -> Tuple[Stage3TrainState, Metrics]:
    """The update shared by both steps: FE(x') in train mode (dropout masks
    from ``generator``), mean |FE(x') - x| plus the weighted perceptual
    term, one AdamW step."""
    xhat = state.fe(xprime, train=True, generator=generator)
    recons = (xhat - x).abs().mean()
    percept = torch.zeros((), device=recons.device)
    if percept_loss_weight > 0.0:
        percept = percept_loss_weight * ((percept_fn(xhat) - percept_fn(x)) ** 2).mean()
    loss = recons + percept
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_grads(state.fe.parameters())
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, {"loss": loss.detach(), "fidelity_enhancer_loss": recons.detach(),
                   "percept_loss": percept.detach()}


def make_stage3_train_step(frozen: FrozenStage1, tau: float = 0.0,
                           percept_loss_weight: float = 0.0,
                           percept_fn: Optional[Callable] = None) -> Callable:
    """step(state, x, generator=None, noise=None) -> (state, metrics), the
    on-the-fly path: ``svq_roundtrip`` of ``x`` at ``tau`` (the SVQ draws
    from ``generator`` first, or ``noise``), then the update."""
    _check_percept(percept_loss_weight, percept_fn)

    def step(state, x, generator=None, noise=None):
        xprime = svq_roundtrip(frozen, x, tau, generator, noise)
        return _fe_update(state, x, xprime, generator, percept_loss_weight, percept_fn)

    return step


def make_stage3_train_step_pre(percept_loss_weight: float = 0.0,
                               percept_fn: Optional[Callable] = None) -> Callable:
    """step(state, x, xprime, generator=None) -> (state, metrics), on a
    precomputed x' (valid at tau = 0 only, where x' is deterministic)."""
    _check_percept(percept_loss_weight, percept_fn)

    def step(state, x, xprime, generator=None):
        return _fe_update(state, x, xprime, generator, percept_loss_weight, percept_fn)

    return step


def make_xprime_fn(frozen: FrozenStage1) -> Callable:
    """x (B, C, L) -> x', the deterministic tau = 0 round trip."""

    @torch.inference_mode()
    def f(x: torch.Tensor) -> torch.Tensor:
        return svq_roundtrip(frozen, x, 0.0)

    return f


def precompute_xprime_dataset(frozen: FrozenStage1, X, batch_size: int = 32,
                              keep_on_device: bool = False, data_parallel: bool = False):
    """One tau = 0 sweep over ``X`` (N, C, L) -> x' (N, C, L) float32, a numpy
    array or, with ``keep_on_device``, a tensor on the frozen model's device.
    Fixed batches of ``min(batch_size, N)`` rows, the last wrapped around to
    the start and its wrapped rows dropped (two VQ launches a batch). ``X``
    is a numpy array, or a tensor (already on the frozen model's device:
    each batch is then a device gather).

    With ``data_parallel`` every rank of the data group calls it together
    (JAX's ``mesh=``): the batch is rounded up to a multiple of
    ``data_count()``, each rank runs the round trip of its slice (two VQ
    launches) and one all-gather gives every rank the whole batch's x'."""
    f = make_xprime_fn(frozen)
    gather = all_gather if data_parallel else (lambda t: t)
    out = [gather(f(xb).float())[:real] for real, xb in sweep_batches(
        X, X.shape[0], batch_size, data_parallel, frozen.vq_l.embed.device)]
    xprime = torch.cat(out)
    return xprime if keep_on_device else xprime.cpu().numpy()
