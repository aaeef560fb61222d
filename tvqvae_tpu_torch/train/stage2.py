"""Stage 2 (MaskGIT prior): training state and steps, the token dataset, and
the sampling function.

Port of ``tvqvae_tpu/train/stage2.py``. One step masks both token grids,
runs the LF prior on the masked LF grid and the HF prior on the masked LF
and HF grids, adds the two masked cross-entropies, and takes one AdamW step
over both priors. The frozen stage-1 encode is deterministic (eval-mode
BatchNorm, argmax through the VQ kernel), so the default path encodes the
train split once (``precompute_token_dataset``) and the step runs on token
grids (``stage2_train_step_tokens``); ``make_stage2_train_step``
encodes each batch inside the step instead. The encode draws nothing from
the generator, so from the same generator state the two steps make the
same update.

Inside a ``torch.distributed`` process group each rank steps on its slice;
the HF prior's BatchNorm statistics, the masked cross-entropies'
denominators (``masked_ce``) and the averaged gradients
(``parallel.all_reduce_grads``) are the global batch's. The token sweep and
the sampler take ``data_parallel`` to spread a batch over the group.

JAX's step is a pure function of the state; here the state holds the two
priors and the optimizer, which the step updates in place (the HF prior's
BatchNorm buffers are JAX's ``h_stats``). Metrics stay on the device as
0-dim tensors. JAX passes every parameter tree to the sampler as a jit
argument; here ``make_sampling_fn`` and ``make_ess_sampling_fn`` close over
the modules.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import (
    FrozenStage1,
    MaskGITSpec,
    build_transformers,
    decode_tokens,
    decoding_noise,
    encode_tokens,
    iterative_decoding,
    iterative_decoding_ess,
    masked_ce,
    random_mask_tokens,
)
from tvqvae_tpu_torch.models.transformer import BidirectionalTransformer
from tvqvae_tpu_torch.parallel.mesh import all_gather, all_reduce_grads, data_count, shard_bounds
from tvqvae_tpu_torch.utils.convert import prior_from_jax
from tvqvae_tpu_torch.utils.device import resolve_device

Metrics = Dict[str, torch.Tensor]


@dataclass
class Stage2TrainState:
    t_l: BidirectionalTransformer
    t_h: BidirectionalTransformer
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_stage2(t_l: BidirectionalTransformer, t_h: BidirectionalTransformer,
                generator: torch.Generator, device="cuda"):
    """Seeded random weights for both priors (``layers.init_weights_``: the
    LF prior's draws, then the HF prior's; a CPU generator gives the same
    weights on every device). -> (t_l, t_h) on ``device``."""
    dev = resolve_device(device)
    return init_weights_(t_l, generator).to(dev), init_weights_(t_h, generator).to(dev)


def priors_from_tree(cfg, s1, n_classes: int, tree: Mapping):
    """Both priors, on the CPU, from a stage-2 tree in the JAX package's
    layout (``{"params": {"l", "h"}, "h_stats"}``, as a checkpoint holds
    it); imported reference priors carry square project_in/out layers,
    which the tree shows. -> (t_l, t_h)."""
    params = tree["params"]
    force = ("project_in" in params["l"], "project_in" in params["h"])
    t_l, t_h = build_transformers(cfg, s1, n_classes, force)
    sd_l, sd_h = prior_from_jax(params, tree.get("h_stats"))
    t_l.load_state_dict(sd_l)
    t_h.load_state_dict(sd_h)
    return t_l, t_h


def create_stage2_state(t_l: BidirectionalTransformer, t_h: BidirectionalTransformer,
                        tx: Callable) -> Stage2TrainState:
    """One optimizer over both priors' parameters, as optax runs over the
    ``{"l", "h"}`` tree. ``tx(parameters) -> (optimizer, scheduler)``, e.g.
    ``train/runner.py::_adamw``."""
    optimizer, scheduler = tx([*t_l.parameters(), *t_h.parameters()])
    return Stage2TrainState(t_l, t_h, optimizer, scheduler)


def stage2_train_step_tokens(state: Stage2TrainState, s_l: torch.Tensor, s_h: torch.Tensor,
                             y: Optional[torch.Tensor],
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[dict] = None) -> Tuple[Stage2TrainState, Metrics]:
    """One step on precomputed token grids (B, 27) and (B, 108); ``y``
    (B, 1) class indices or None (JAX's ``make_stage2_train_step_tokens``).
    Draws in order: the LF mask, the HF mask, the LF prior's dropouts, the
    HF prior's. ``noise`` = {"l": (ratio, scores), "h": (...)} replaces the
    masking draws (``random_mask_tokens``)."""
    noise = noise or {}
    s_l_M, keep_l = random_mask_tokens(s_l, state.t_l.mask_token_l, generator=generator,
                                       noise=noise.get("l"))
    s_h_M, keep_h = random_mask_tokens(s_h, state.t_h.mask_token_h, generator=generator,
                                       noise=noise.get("h"))
    logits_l = state.t_l(s_l_M, None, y, train=True, generator=generator)
    logits_h = state.t_h(s_l_M, s_h_M, y, train=True, generator=generator)  # the masked LF grid
    ce_l = masked_ce(logits_l, s_l, keep_l)
    ce_h = masked_ce(logits_h, s_h, keep_h)
    loss = ce_l + ce_h
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_grads([*state.t_l.parameters(), *state.t_h.parameters()])
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    loss = loss.detach()
    return state, {"loss": loss, "mask_pred_loss": loss,
                   "mask_pred_loss_l": ce_l.detach(), "mask_pred_loss_h": ce_h.detach()}


def make_stage2_train_step(frozen: FrozenStage1) -> Callable:
    """step(state, x, y, generator=None, noise=None) -> (state, metrics):
    encodes both bands of ``x`` (B, C, L) through the frozen stage 1 (two
    VQ kernel launches), then ``stage2_train_step_tokens``."""

    def step(state, x, y, generator=None, noise=None):
        with torch.no_grad():
            s_l, s_h = encode_tokens(frozen, x, "lf"), encode_tokens(frozen, x, "hf")
        return stage2_train_step_tokens(state, s_l, s_h, y, generator, noise)

    return step


def make_token_encode_fn(frozen: FrozenStage1) -> Callable:
    """x (B, C, L) -> (s_l, s_h) int32 token grids through the frozen
    stage 1 (deterministic: eval-mode BatchNorm, argmax VQ)."""

    @torch.inference_mode()
    def enc(x: torch.Tensor):
        return encode_tokens(frozen, x, "lf"), encode_tokens(frozen, x, "hf")

    return enc


def sweep_batches(X, N: int, batch_size: int, data_parallel: bool, dev):
    """The batches of a precompute sweep over ``X`` (N, C, L): fixed
    batches of ``min(batch_size, N)`` rows (with ``data_parallel`` rounded
    up to a multiple of ``data_count()``, as JAX rounds to its mesh), the
    last wrapped around to the start. -> (rows of the batch that are real,
    this rank's rows of the batch on ``dev``: all of them, or with
    ``data_parallel`` its ``shard_bounds`` slice). ``X`` is a numpy array,
    or a tensor (each batch then a gather where it lies)."""
    bs = min(batch_size, N)
    if data_parallel:
        bs = -(-bs // data_count()) * data_count()
    for start in range(0, N, bs):
        idx = np.arange(start, start + bs) % N
        if data_parallel:
            idx = idx[shard_bounds(bs)]
        if isinstance(X, torch.Tensor):
            xb = X[torch.from_numpy(idx).to(X.device)]
        else:
            xb = torch.from_numpy(np.ascontiguousarray(X[idx], dtype=np.float32))
        yield min(bs, N - start), xb.to(dev)


def precompute_token_dataset(frozen: FrozenStage1, X, batch_size: int = 64,
                             data_parallel: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """One eval-mode sweep over ``X`` (N, C, L) -> (tokens_l (N, 27),
    tokens_h (N, 108)) int32 numpy arrays. Fixed batches of
    ``min(batch_size, N)`` rows, the last wrapped around to the start and
    its wrapped rows dropped. ``X`` is a numpy array, or a tensor (already
    on the frozen model's device: each batch is then a device gather).

    With ``data_parallel`` every rank of the data group calls it together
    (JAX's ``mesh=``): the batch is rounded up to a multiple of
    ``data_count()``, each rank encodes its slice (two VQ launches) and one
    all-gather gives every rank the whole batch's tokens, which are one
    process's (the encode is per series)."""
    enc = make_token_encode_fn(frozen)
    gather = all_gather if data_parallel else (lambda t: t)
    out_l, out_h = [], []
    for real, xb in sweep_batches(X, X.shape[0], batch_size, data_parallel,
                                   frozen.vq_l.embed.device):
        s_l, s_h = enc(xb)
        out_l.append(gather(s_l)[:real])
        out_h.append(gather(s_h)[:real])
    return (torch.cat(out_l).to(torch.int32).cpu().numpy(),
            torch.cat(out_h).to(torch.int32).cpu().numpy())


def make_sampling_fn(
    frozen: FrozenStage1,
    t_l: BidirectionalTransformer,
    t_h: BidirectionalTransformer,
    spec: MaskGITSpec,
    data_parallel: bool = False,
) -> Callable:
    """Returns fn(num, class_index=None, generator=None, noise=None) ->
    (x_l, x_h, x), each (num, C, L): MaskGIT decoding of both token grids,
    codebook lookup, the frozen decoders and the LF+HF sum.

    With ``data_parallel`` every rank of the data group calls it together
    and the batch decodes over the group (JAX's ``mesh=``, which shards the
    tokens over ``data``): every rank draws the whole batch's decoding
    noise (``decoding_noise``, from ``generator`` as one process draws it,
    or takes the given ``noise``), decodes the rows of its ``shard_bounds``
    slice, and one all-gather gives every rank the whole batch in row
    order: what one process samples. The ranks of a model group decode the
    same slice. A ``num`` the group does not divide is decoded whole on
    every rank."""

    def apply_l(s_l, cond):
        return t_l(s_l, None, cond)

    def apply_h(s_l, s_h, cond):
        return t_h(s_l, s_h, cond)

    def decode(num, class_index, generator, noise):
        device = frozen.vq_l.embed.device
        s_l, s_h = iterative_decoding(
            spec, apply_l, apply_h, num, class_index,
            device=device, generator=generator, noise=noise,
        )
        x_l = decode_tokens(frozen, s_l, "lf")
        x_h = decode_tokens(frozen, s_h, "hf")
        return x_l, x_h, x_l + x_h

    @torch.inference_mode()
    def sample(num: int, class_index: Optional[int] = None,
               generator: Optional[torch.Generator] = None, noise: Optional[dict] = None):
        if not data_parallel or num % data_count():
            return decode(num, class_index, generator, noise)
        if noise is None:
            noise = decoding_noise(spec, num, generator, frozen.vq_l.embed.device)
        rows = shard_bounds(num)
        mine = {band: tuple(t[:, rows] for t in ts) for band, ts in noise.items()}
        return tuple(all_gather(t) for t in decode(rows.stop - rows.start, class_index, None,
                                                   mine))

    return sample


def make_ess_sampling_fn(
    frozen: FrozenStage1,
    t_l: BidirectionalTransformer,
    t_h: BidirectionalTransformer,
    spec: MaskGITSpec,
    error_ratio_ma_rate: float = 0.3,
) -> Callable:
    """The ESS sampler, with ``make_sampling_fn``'s signature: the naive LF
    decode, critical reverse sampling and the critic-guided re-decode
    (``iterative_decoding_ess``), the HF pass, then the codebook lookup and
    the frozen decoders of both bands. ``noise`` is
    ``iterative_decoding_ess``'s {"l", "crit", "h"}. The critic scores with
    the float32 LF codebook, whatever the stage-1 stacks' precision."""

    def apply_l(s_l, cond):
        return t_l(s_l, None, cond)

    def apply_h(s_l, s_h, cond):
        return t_h(s_l, s_h, cond)

    @torch.inference_mode()
    def sample(num: int, class_index: Optional[int] = None,
               generator: Optional[torch.Generator] = None, noise: Optional[dict] = None):
        device = frozen.vq_l.embed.device
        s_l, s_h, _ = iterative_decoding_ess(
            spec, apply_l, apply_h, frozen.vq_l.embed, num, class_index, error_ratio_ma_rate,
            device=device, generator=generator, noise=noise,
        )
        x_l = decode_tokens(frozen, s_l, "lf")
        x_h = decode_tokens(frozen, s_h, "hf")
        return x_l, x_h, x_l + x_h

    return sample
