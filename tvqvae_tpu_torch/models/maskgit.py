"""MaskGIT prior: iterative parallel decoding over a frozen stage 1.

Port of the sampling half of ``tvqvae_tpu/models/maskgit.py``:

  - ``FrozenStage1`` bundles the eval-mode stage-1 model with its two
    codebooks; ``encode_tokens``/``decode_tokens`` run through it.
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

Training-time masking and the ESS sampler come with later slices.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec
from tvqvae_tpu_torch.models.transformer import BidirectionalTransformer
from tvqvae_tpu_torch.models.vq import CodebookState, gumbel, lookup_codes, vq_forward


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


def decode_schedule(num_tokens: int, T: int, choice_temp: float, mode: str):
    """Static per-step (mask_len, temperature) tables, as numpy arrays."""
    ratios = (np.arange(T) + 1.0) / T
    mask_lens = np.clip(np.floor(num_tokens * gamma_fn(mode)(ratios)), 0, None).astype(np.int32)
    temps = (choice_temp * (1.0 - ratios)).astype(np.float32)
    return mask_lens, temps


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
        plus ``vq_l.*`` / ``vq_h.*`` codebook fields."""
        model = Stage1Model(spec)
        model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(("vq_l.", "vq_h."))})
        fields = ("embed", "embed_avg", "cluster_size", "initted")
        vq_l, vq_h = (CodebookState(*(sd[f"{band}.{f}"] for f in fields))
                      for band in ("vq_l", "vq_h"))
        return FrozenStage1(model.to(device).eval(), vq_l.to(device), vq_h.to(device))


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
    """The LF and HF priors. ``force_projections`` (LF, HF) keeps square
    project_in/out layers, as imported reference priors carry them."""

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
