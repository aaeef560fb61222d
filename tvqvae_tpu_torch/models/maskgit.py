"""MaskGIT prior: training-time masking and iterative parallel decoding
over a frozen stage 1.

Port of ``tvqvae_tpu/models/maskgit.py``:

  - ``FrozenStage1`` bundles the eval-mode stage-1 model with its two
    codebooks; ``encode_tokens``/``decode_tokens`` run through it.
  - ``random_mask_tokens`` masks a per-row random number of positions for
    training, and ``masked_ce`` is the cross-entropy over the masked
    positions only.
  - ``decode_band_scan`` is the JAX ``lax.scan`` as a Python loop over the T
    steps. Every sample starts fully masked, so the per-step mask lengths
    are static (``decode_schedule``), and "re-mask the k least confident" is
    ``rank(confidence) < k``.
  - ``_rank`` is a double stable argsort: known tokens all tie at +inf
    confidence, and the ties must break by position as ``jnp.argsort`` does.
  - random draws: the categorical sample is ``argmax(logits + g)`` with
    standard Gumbel ``g`` (what ``jax.random.categorical`` computes) and the
    confidence noise is ``_gumbel`` (uniforms from 1e-20). A caller passes a
    ``torch.Generator``, or ``noise`` with the draws themselves (the parity
    tests hand in JAX's).
  - the ESS sampler (``iterative_decoding_ess``): the naive LF decode, the
    token critic's confidences (``compute_confidence_score``), the step
    retraction (``critical_reverse_sampling``) and the critic-guided
    re-decode (``decode_with_token_critic``). JAX's ``lax.scan`` loops are
    Python loops over t, and its ``lax.cond`` skips a host-side ``break``
    (one ``.item()`` a step) or a start index. The retraction's error is
    summed over the whole batch, so one ``t_star`` serves every sample of a
    batch. Its mask lengths are JAX's float32 arithmetic
    (``ess_mask_len``), not ``decode_schedule``'s float64 tables.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import copy
import math

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec
from tvqvae_tpu_torch.models.transformer import BidirectionalTransformer
from tvqvae_tpu_torch.models.vq import CodebookState, gumbel, lookup_codes, vq_forward
from tvqvae_tpu_torch.parallel.mesh import all_reduce_, data_count, initialized


def gamma_fn(mode: str = "cosine") -> Callable[[np.ndarray], np.ndarray]:
    if mode == "linear":
        return lambda r: 1.0 - r
    if mode == "cosine":
        return lambda r: np.cos(r * np.pi / 2.0)
    if mode == "square":
        return lambda r: 1.0 - r ** 2
    if mode == "cubic":
        return lambda r: 1.0 - r ** 3
    raise NotImplementedError(mode)


def gamma_cosine(r: torch.Tensor) -> torch.Tensor:
    """``gamma_fn("cosine")`` over tensors: the training mask schedule."""
    return torch.cos(r * math.pi / 2.0)


def decode_schedule(num_tokens: int, T: int, choice_temp: float, mode: str):
    """Static per-step (mask_len, temperature) tables, as numpy arrays."""
    ratios = (np.arange(T) + 1.0) / T
    mask_lens = np.clip(np.floor(num_tokens * gamma_fn(mode)(ratios)), 0, None).astype(np.int32)
    temps = (choice_temp * (1.0 - ratios)).astype(np.float32)
    return mask_lens, temps


def ess_mask_len(num_tokens: int, tf: float, T: int, mode: str = "cosine") -> int:
    """``clip(floor(num_tokens * gamma(tf / T)), 0)`` in float32, as the JAX
    ESS functions compute it at run time; on the host, so that the card and
    the CPU take the same lengths."""
    r = torch.tensor(tf, dtype=torch.float32) / T
    if mode == "cosine":
        g = torch.cos(r * math.pi / 2.0)
    else:  # the polynomial schedules: numpy's formulas on a float32 tensor
        g = gamma_fn(mode)(r)
    return max(int(torch.floor(num_tokens * g)), 0)


def _rank(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Rank of each element when sorted ascending (ties by position)."""
    order = torch.argsort(x, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """-log(-log(u)), u uniform in [1e-20, 1) as the JAX package draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u * (1.0 - 1e-20) + 1e-20))


# --------------------------------------------------------------------------
# frozen stage-1 bundle


@dataclass
class FrozenStage1:
    model: Stage1Model  # eval mode, weights loaded
    vq_l: CodebookState
    vq_h: CodebookState

    @staticmethod
    def from_state_dict(spec: Stage1Spec, sd: dict, device) -> "FrozenStage1":
        """From ``utils/convert.stage1_from_jax``'s layout: the model's keys
        plus ``vq_l.*`` / ``vq_h.*`` codebook fields. The model is built on
        the meta device and takes ``sd``'s tensors as they are: the default
        initialisation it skips costs seconds at the published width."""
        with torch.device("meta"):
            model = Stage1Model(spec)
        model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(("vq_l.", "vq_h."))},
                              assign=True)
        fields = ("embed", "embed_avg", "cluster_size", "initted")
        vq_l, vq_h = (CodebookState(*(sd[f"{band}.{f}"] for f in fields))
                      for band in ("vq_l", "vq_h"))
        return FrozenStage1(model.to(device).eval(), vq_l.to(device), vq_h.to(device))

    @staticmethod
    def from_stage1_state(state) -> "FrozenStage1":
        """From a trained ``train/stage1.Stage1TrainState``: an eval-mode
        copy of its model with ``requires_grad`` off, and its two codebooks,
        on the state's device (the stage-1 bundle JAX loads from a
        checkpoint). The training state is left as it was."""
        model = copy.deepcopy(state.model).eval().requires_grad_(False)
        return FrozenStage1(model, state.vq_l, state.vq_h)


def encode_tokens(
    frozen: FrozenStage1,
    x: torch.Tensor,
    band: str,
    svq_temp: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (B, C, L) -> token indices (B, N) through the frozen encoder and
    quantizer (eval-mode BN; argmax through the VQ kernel)."""
    z = frozen.model.encode(x, band)
    state = frozen.vq_l if band == "lf" else frozen.vq_h
    spec = frozen.model.spec
    p = spec.vq_l if band == "lf" else spec.vq_h
    return vq_forward(state, z, p, svq_temp=svq_temp, generator=generator, noise=noise).indices


def decode_tokens(frozen: FrozenStage1, s: torch.Tensor, band: str) -> torch.Tensor:
    """Token indices (B, N) -> time series (B, C, L) through the frozen decoder."""
    state = frozen.vq_l if band == "lf" else frozen.vq_h
    return frozen.model.decode(lookup_codes(state, s), band)


# --------------------------------------------------------------------------
# training-time masking + loss


def random_mask_tokens(
    s: torch.Tensor,
    mask_token: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: a ratio ~ U[0, 1), ``n_keep = clip(floor(cos(ratio * pi / 2)
    * n), 0, n - 1)`` (the cosine schedule, as the JAX step uses it), and the ``n_keep`` positions of highest U[0, 1) score kept;
    the rest become ``mask_token``. -> (masked tokens, keep) with True =
    kept. ``noise`` = (ratio (B,), scores (B, n)) replaces the draws."""
    B, n = s.shape
    if noise is None:
        ratio = torch.rand(B, generator=generator, device=s.device)
        scores = torch.rand((B, n), generator=generator, device=s.device)
    else:
        ratio, scores = (t.to(s.device) for t in noise)
    n_keep = torch.clamp(torch.floor(gamma_cosine(ratio) * n), 0, n - 1)
    keep = _rank(-scores, dim=-1) < n_keep.to(torch.int64)[:, None]
    return torch.where(keep, s, torch.full_like(s, mask_token)), keep


def masked_ce(logits: torch.Tensor, targets: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Cross-entropy (float32 log-softmax) averaged over the masked
    positions only; 0 where no position is masked.

    Inside a process group the average is the global batch's, Σ(nll·w) /
    max(Σw, 1) with both sums over the data group (W slices): each rank
    returns W times its share of it, W·Σ_local(nll·w) / max(Σw, 1), so the
    mean over the ranks, of the values and of the gradients (``parallel.all_reduce_grads``), is
    the global one. A mean of per-rank means would weigh a rank that masks
    few tokens like one that masks many."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    w = (~keep).float()
    if not initialized():
        return (nll * w).sum() / w.sum().clamp_min(1.0)
    denom = all_reduce_(w.sum().detach())
    return data_count() * (nll * w).sum() / denom.clamp_min(1.0)


# --------------------------------------------------------------------------
# MaskGIT bundle


@dataclass(frozen=True)
class MaskGITSpec:
    tokens_l: int
    tokens_h: int
    mask_token_l: int
    mask_token_h: int
    T_l: int
    T_h: int
    choice_temp_l: float
    choice_temp_h: float
    cfg_scale: float

    @staticmethod
    def from_config(cfg: Config, s1: Stage1Spec) -> "MaskGITSpec":
        return MaskGITSpec(
            tokens_l=s1.tokens_l,
            tokens_h=s1.tokens_h,
            mask_token_l=s1.vq_l.codebook_size,
            mask_token_h=s1.vq_h.codebook_size,
            T_l=cfg.maskgit.T["lf"],
            T_h=cfg.maskgit.T["hf"],
            choice_temp_l=float(cfg.maskgit.choice_temperatures["lf"]),
            choice_temp_h=float(cfg.maskgit.choice_temperatures["hf"]),
            cfg_scale=float(cfg.maskgit.cfg_scale),
        )


def build_transformers(
    cfg: Config, s1: Stage1Spec, n_classes: int,
    force_projections: Tuple[bool, bool] = (False, False),
) -> Tuple[BidirectionalTransformer, BidirectionalTransformer]:
    """The LF and HF priors with the config's dropout rates (used in train
    mode only). ``force_projections`` (LF, HF) keeps square project_in/out
    layers, as imported reference priors carry them."""

    def mk(kind, pm, n_tok, force):
        return BidirectionalTransformer(
            kind=kind,
            num_tokens=n_tok,
            codebook_size_l=s1.vq_l.codebook_size,
            codebook_size_h=s1.vq_h.codebook_size,
            embed_dim=s1.hid_dim,
            hidden_dim=pm.hidden_dim,
            n_layers=pm.n_layers,
            heads=pm.heads,
            ff_mult=pm.ff_mult,
            use_rmsnorm=pm.use_rmsnorm,
            n_classes=n_classes,
            force_projections=force,
            p_unconditional=pm.p_unconditional,
            model_dropout=pm.model_dropout,
            emb_dropout=pm.emb_dropout,
        )

    return (
        mk("lf", cfg.maskgit.prior_model_l, s1.tokens_l, force_projections[0]),
        mk("hf", cfg.maskgit.prior_model_h, s1.tokens_h, force_projections[1]),
    )


# --------------------------------------------------------------------------
# iterative decoding (sampling)


def _masked_prediction(apply_fn: Callable, cfg_scale: float,
                       class_condition: Optional[torch.Tensor], s) -> torch.Tensor:
    """Classifier-free-guidance logit mixing."""
    if class_condition is None:
        return apply_fn(s, None)
    if cfg_scale == 1.0:
        return apply_fn(s, class_condition)
    logits_null = apply_fn(s, None)
    logits = apply_fn(s, class_condition)
    return logits_null + cfg_scale * (logits - logits_null)


def decode_band_scan(
    apply_fn: Callable,
    s_init: torch.Tensor,
    mask_token: int,
    T: int,
    num_tokens: int,
    choice_temp: float,
    cfg_scale: float,
    class_condition: Optional[torch.Tensor],
    mode: str = "cosine",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """One band's iterative decoding loop over T steps.

    ``apply_fn(s, class_condition) -> logits``. ``noise``, when given, is
    (g_sample (T, B, n, K), g_confidence (T, B, n)): the Gumbel draws of the
    categorical sample and of the confidence at each step."""
    mask_lens, temps = decode_schedule(num_tokens, T, choice_temp, mode)
    s = s_init
    for t in range(T):
        logits = _masked_prediction(apply_fn, cfg_scale, class_condition, s)  # (B, n, K)
        if noise is None:
            g_sample = gumbel(logits.shape, generator, logits.device)
            g_conf = _gumbel(s.shape, generator, logits.device)
        else:
            g_sample, g_conf = (n[t].to(logits.device) for n in noise)
        sampled = (logits + g_sample).argmax(-1).to(s.dtype)
        unknown = s == mask_token
        sampled = torch.where(unknown, sampled, s)

        probs = torch.softmax(logits, dim=-1)
        sel = torch.gather(probs, -1, sampled.long()[..., None])[..., 0]
        sel = torch.where(unknown, sel, torch.full_like(sel, float("inf")))

        confidence = torch.log(sel + 1e-5) + float(temps[t]) * g_conf
        masking = _rank(confidence, dim=-1) < int(mask_lens[t])
        s = torch.where(masking, torch.full_like(sampled, mask_token), sampled)
    return s


def decoding_noise(spec: MaskGITSpec, num: int, generator: Optional[torch.Generator],
                   device) -> dict:
    """The draws ``iterative_decoding`` makes for a batch of ``num``, made
    up front in its order (per LF step its categorical and confidence
    Gumbels, then the HF steps'), as the dict its ``noise`` takes: handing
    them in gives what drawing them inside gives from the same generator
    state. A batch split into row chunks decodes each chunk with its rows."""
    noise = {}
    for band, T, n, K in (("l", spec.T_l, spec.tokens_l, spec.mask_token_l),
                          ("h", spec.T_h, spec.tokens_h, spec.mask_token_h)):
        g_sample, g_conf = [], []
        for _ in range(T):
            g_sample.append(gumbel((num, n, K), generator, device))
            g_conf.append(_gumbel((num, n), generator, device))
        noise[band] = (torch.stack(g_sample), torch.stack(g_conf))
    return noise


def iterative_decoding(
    spec: MaskGITSpec,
    apply_l: Callable,  # (s_l, class_condition) -> logits
    apply_h_given: Callable,  # (s_l, s_h, class_condition) -> logits
    num: int,
    class_index: Optional[int] = None,
    mode: str = "cosine",
    *,
    device,
    generator: Optional[torch.Generator] = None,
    noise: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample LF then HF token grids, (num, tokens_l) and (num, tokens_h)
    int32. ``noise`` is {"l": (g_sample, g_conf), "h": (...)} as
    ``decode_band_scan`` takes it."""
    cond = (
        torch.full((num, 1), class_index, dtype=torch.int32, device=device)
        if class_index is not None else None
    )
    noise = noise or {}
    s_l = torch.full((num, spec.tokens_l), spec.mask_token_l, dtype=torch.int32, device=device)
    s_l = decode_band_scan(
        apply_l, s_l, spec.mask_token_l, spec.T_l, spec.tokens_l,
        spec.choice_temp_l, spec.cfg_scale, cond, mode,
        generator=generator, noise=noise.get("l"),
    )
    s_h = torch.full((num, spec.tokens_h), spec.mask_token_h, dtype=torch.int32, device=device)
    s_h = decode_band_scan(
        lambda s, c: apply_h_given(s_l, s, c), s_h, spec.mask_token_h, spec.T_h,
        spec.tokens_h, spec.choice_temp_h, spec.cfg_scale, cond, mode,
        generator=generator, noise=noise.get("h"),
    )
    return s_l, s_h


# --------------------------------------------------------------------------
# ESS: the enhanced sampling scheme (JAX ``models/maskgit.py:322-550``)


def compute_confidence_score(
    apply_fn: Callable,
    s: torch.Tensor,
    mask_token: int,
    embed: torch.Tensor,
    class_condition: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-token self-critic confidence: for each position i, mask it,
    predict it, score ``-||E[s_i] - E[pred_i]||^2``, and softmax over the
    positions. The n variants run as one (n*b, n) batch, variant-major
    (the class condition tiled, not interleaved). -> (b, n) float32."""
    b, n = s.shape
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    variants = torch.where(eye[:, None, :], torch.full_like(s, mask_token)[None], s[None])
    cond = class_condition.repeat(n, 1) if class_condition is not None else None
    logits = apply_fn(variants.reshape(n * b, n), cond)  # (n*b, n, K)
    logits = logits.reshape(n, b, n, logits.shape[-1])
    pos = torch.arange(n, device=s.device)
    pred = logits[pos, :, pos].argmax(-1)  # (n, b): position i of variant i
    emb = embed.float()
    dist = ((emb[s.T.long()] - emb[pred]) ** 2).sum(-1)  # (n, b)
    return torch.softmax(-dist.T, dim=-1)


def critical_reverse_sampling(
    apply_fn: Callable,
    s: torch.Tensor,
    confidence_scores: torch.Tensor,
    mask_token: int,
    T: int,
    num_tokens: int,
    embed: torch.Tensor,
    class_condition: Optional[torch.Tensor] = None,
    error_ratio_ma_rate: float = 0.3,
    mode: str = "cosine",
) -> Tuple[int, torch.Tensor]:
    """Step retraction: walk back from t = T-1, re-masking the least
    confident tokens, until the prediction error of the tokens revealed at
    t stops improving. -> (t_star, s_star).

    Stops at the first t where the schedule plateaus (no forward), where
    the moving average over the last ``w`` error ratios exceeds 1, or at
    t = 1; with T <= 1 it returns t_star = 1 and the t = 2 schedule's
    re-masking. The first forward (t = T-1) only seeds the previous error.
    The error is summed over the whole batch: one t_star per batch."""
    w = max(1, round(T * error_ratio_ma_rate))  # Python's round, as JAX
    conf_rank = _rank(confidence_scores, dim=-1)
    emb = embed.float()
    z_true = emb[s.long()]
    mask = torch.full_like(s, mask_token)

    def ml(tf: float) -> int:
        return ess_mask_len(num_tokens, tf, T, mode)

    ring = torch.zeros(w, dtype=torch.float32, device=s.device)
    prev = torch.zeros((), dtype=torch.float32, device=s.device)
    count = 0
    for t in range(T - 1, 0, -1):
        ml_t, ml_tm1 = ml(t + 1.0), ml(float(t))
        masking_t = conf_rank < ml_t
        # the plateau stops before a forward; at t = 1 JAX's forward only
        # feeds a stop that is already decided, so it is skipped here
        stop = ml_t == ml_tm1 or t == 1
        if not stop:
            masking_tm1 = conf_rank < ml_tm1
            logits = apply_fn(torch.where(masking_tm1, mask, s), class_condition)
            sq = ((z_true - emb[logits.argmax(-1)]) ** 2).sum(-1)
            interest = masking_tm1 & ~masking_t  # revealed at t
            err = (torch.where(interest, sq, torch.zeros_like(sq)).sum()
                   / interest.sum().clamp_min(1))
            if t != T - 1:  # the first forward only seeds prev
                ring[count % w] = err / (prev + 1e-5)
                count += 1
                n_valid = min(count, w)
                stop = bool(ring[:n_valid].sum() / n_valid > 1.0)
            prev = err
        if stop:
            return t, torch.where(masking_t, mask, s)
    return 1, torch.where(conf_rank < ml(2.0), mask, s)


def decode_with_token_critic(
    apply_fn: Callable,
    s: torch.Tensor,
    t_star: int,
    mask_token: int,
    T: int,
    num_tokens: int,
    choice_temp: float,
    embed: torch.Tensor,
    class_condition: Optional[torch.Tensor] = None,
    mode: str = "cosine",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Resume decoding at t = t_star .. T-1 with the token critic's
    confidences: each step resamples every position from the prior, scores
    the sample with ``compute_confidence_score``, and re-masks the least
    confident by the float32 schedule. ``noise``, when given, is
    (g_sample (T-1, B, n, K), g_confidence (T-1, B, n)), row t-1 for step t;
    rows before t_star are not read."""
    for t in range(max(int(t_star), 1), T):
        logits = apply_fn(s, class_condition)
        if noise is None:
            g_sample = gumbel(logits.shape, generator, logits.device)
            g_conf = _gumbel(s.shape, generator, logits.device)
        else:
            g_sample, g_conf = (n[t - 1].to(logits.device) for n in noise)
        sampled = (logits + g_sample).argmax(-1).to(s.dtype)
        conf = compute_confidence_score(apply_fn, sampled, mask_token, embed, class_condition)
        ratio = (torch.tensor(float(t), dtype=torch.float32) + 1.0) / T
        ml = ess_mask_len(num_tokens, float(t) + 1.0, T, mode)
        temp = float(choice_temp * (1.0 - ratio))  # float32, as JAX's
        confidence = torch.log(conf + 1e-5) + temp * g_conf
        s = torch.where(_rank(confidence, dim=-1) < ml, torch.full_like(sampled, mask_token),
                        sampled)
    return s


def iterative_decoding_ess(
    spec: MaskGITSpec,
    apply_l: Callable,  # (s_l, class_condition) -> logits
    apply_h_given: Callable,  # (s_l, s_h, class_condition) -> logits
    embed_l: torch.Tensor,
    num: int,
    class_index: Optional[int] = None,
    error_ratio_ma_rate: float = 0.3,
    mode: str = "cosine",
    *,
    device,
    generator: Optional[torch.Generator] = None,
    noise: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Naive LF decode (``decode_band_scan``, with classifier-free
    guidance) -> the critic's confidences -> critical reverse sampling ->
    the critic-guided re-decode (no guidance: the critic calls ``apply_l``)
    -> the standard HF pass. -> (s_l, s_h, t_star). ``noise`` is {"l":
    ..., "crit": ..., "h": ...}: the LF and HF passes' draws as
    ``decode_band_scan`` takes them and the re-decode's as
    ``decode_with_token_critic`` takes them."""
    cond = (
        torch.full((num, 1), class_index, dtype=torch.int32, device=device)
        if class_index is not None else None
    )
    noise = noise or {}
    s_l = torch.full((num, spec.tokens_l), spec.mask_token_l, dtype=torch.int32, device=device)
    s_l = decode_band_scan(
        apply_l, s_l, spec.mask_token_l, spec.T_l, spec.tokens_l,
        spec.choice_temp_l, spec.cfg_scale, cond, mode,
        generator=generator, noise=noise.get("l"),
    )
    conf = compute_confidence_score(apply_l, s_l, spec.mask_token_l, embed_l, cond)
    t_star, s_star = critical_reverse_sampling(
        apply_l, s_l, conf, spec.mask_token_l, spec.T_l, spec.tokens_l, embed_l, cond,
        error_ratio_ma_rate, mode,
    )
    s_l = decode_with_token_critic(
        apply_l, s_star, t_star, spec.mask_token_l, spec.T_l, spec.tokens_l,
        spec.choice_temp_l, embed_l, cond, mode, generator=generator, noise=noise.get("crit"),
    )
    s_h = torch.full((num, spec.tokens_h), spec.mask_token_h, dtype=torch.int32, device=device)
    s_h = decode_band_scan(
        lambda s, c: apply_h_given(s_l, s, c), s_h, spec.mask_token_h, spec.T_h,
        spec.tokens_h, spec.choice_temp_h, spec.cfg_scale, cond, mode,
        generator=generator, noise=noise.get("h"),
    )
    return s_l, s_h, t_star
