"""Vector quantization against a Euclidean codebook, eval branch.

Port of the eval branch of ``tvqvae_tpu/models/vq.py::vq_forward``:

  - assignment: argmax of -(|x|^2 - 2 x.e + |e|^2). With ``svq_temp`` > 0
    a categorical draw from softmax(dist / temp) instead (temp 0 means
    argmax, as in the reference's falsy-zero check).
  - the argmax always goes through ``ops/vq_kernel.nearest_codes_stats``,
    which launches the CUDA kernel on the card and runs its plain twin on
    the CPU; it also returns the per-code counts that give the perplexity.
  - the categorical draw is ``argmax(dist / temp + g)`` with Gumbel noise
    ``g``, which is what ``jax.random.categorical`` computes; a caller may
    pass ``noise`` (for instance JAX's own draws, in the parity tests)
    instead of drawing it from ``generator``.

The EMA update, k-means init and dead-code expiry run only in training and
come with the training slice.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from tvqvae_tpu_torch.ops.vq_kernel import nearest_codes_stats


@dataclass(frozen=True)
class VQParams:
    """Static quantizer hyper-parameters."""

    codebook_size: int
    dim: int
    decay: float = 0.8
    eps: float = 1e-5
    commitment_weight: float = 1.0
    threshold_ema_dead_code: int = 0
    kmeans_init: bool = False
    kmeans_iters: int = 10


@dataclass
class CodebookState:
    embed: torch.Tensor  # (K, D)
    embed_avg: torch.Tensor  # (K, D)
    cluster_size: torch.Tensor  # (K,)
    initted: torch.Tensor  # () bool

    def to(self, device) -> "CodebookState":
        return CodebookState(*(t.to(device) for t in (
            self.embed, self.embed_avg, self.cluster_size, self.initted)))


def init_codebook(p: VQParams, generator: torch.Generator) -> CodebookState:
    """A N(0, 1) codebook (the JAX package's init without k-means)."""
    embed = torch.randn((p.codebook_size, p.dim), generator=generator)
    return CodebookState(
        embed=embed,
        embed_avg=embed.clone(),
        cluster_size=torch.zeros(p.codebook_size),
        initted=torch.tensor(True),
    )


@dataclass
class VQOutput:
    quantized: torch.Tensor  # (B, N, D)
    indices: torch.Tensor  # (B, N) int32
    perplexity: torch.Tensor  # scalar


def neg_sq_dist(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """-(|x|^2 - 2 x.e^T + |e|^2): (M, D), (K, D) -> (M, K)."""
    x2 = (x * x).sum(-1, keepdim=True)
    e2 = (embed * embed).sum(-1)[None, :]
    return -(x2 - 2.0 * (x @ embed.T) + e2)


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1) as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def vq_forward(
    state: CodebookState,
    x: torch.Tensor,
    p: VQParams,
    *,
    svq_temp: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> VQOutput:
    """Quantize (B, N, D) -> VQOutput in eval mode (the codebook is unchanged).

    ``noise`` (M, K), when given, replaces the Gumbel draw of the
    ``svq_temp`` branch (M = B*N, K = codebook size)."""
    B, N, D = x.shape
    flat = x.reshape(B * N, D).float().contiguous()
    if svq_temp is None or svq_temp == 0.0:
        indices, counts, _ = nearest_codes_stats(flat, state.embed)
    else:
        logits = neg_sq_dist(flat, state.embed) / svq_temp
        if noise is None:
            noise = gumbel(logits.shape, generator, logits.device)
        indices = (logits + noise).argmax(-1).to(torch.int32)
        counts = torch.bincount(indices, minlength=p.codebook_size).float()

    quantized = state.embed[indices.long()]
    avg_probs = counts / flat.shape[0]
    perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
    return VQOutput(
        quantized=quantized.reshape(B, N, D),
        indices=indices.reshape(B, N),
        perplexity=perplexity,
    )


def lookup_codes(state: CodebookState, indices: torch.Tensor) -> torch.Tensor:
    """Token indices -> codebook vectors (the decode-time embedding lookup)."""
    return state.embed[indices.long()]
