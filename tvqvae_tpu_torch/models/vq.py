"""Vector quantization against an EMA-updated Euclidean codebook.

Port of ``tvqvae_tpu/models/vq.py::vq_forward``:

  - assignment: argmax of -(|x|^2 - 2 x.e + |e|^2). With ``svq_temp`` > 0
    a categorical draw from softmax(dist / temp) instead (temp 0 means
    argmax, as in the reference's falsy-zero check).
  - the argmax always goes through ``ops/vq_kernel.nearest_codes_stats``,
    which launches the CUDA kernel on the card and runs its plain twin on
    the CPU; it also returns the per-code counts and row sums that give the
    perplexity and feed the EMA update.
  - the categorical draw is ``argmax(dist / temp + g)`` with Gumbel noise
    ``g``, which is what ``jax.random.categorical`` computes; a caller may
    pass ``noise`` (for instance JAX's own draws, in the parity tests)
    instead of drawing it from ``generator``.
  - train mode: ``quantize`` reads the pre-update codebook; the codebook
    advances one EMA step (cluster sizes, row sums, Laplace-smoothed
    ``embed``); the output is the straight-through ``x + (q - x).detach()``;
    the commitment loss is ``mean((q.detach() - x)^2)`` (0 in eval).
  - optional k-means init on the first training batch (the ``initted``
    latch) and dead-code expiry below a cluster-size threshold, both off in
    the published config. Their random rows are drawn from
    ``row_generator`` (``generator`` where none is given, outside a process
    group), or given as indices into the global batch's rows
    (``kmeans_idx``, ``dead_code_idx``: JAX's draws, in the parity tests).
  - inside a process group (``parallel/``) each rank quantizes its own rows
    (the kernel launches on every rank) and train mode sums the kernel's
    ``counts`` and ``embed_sum`` over the ranks before the EMA step, so the
    codebooks advance as one process's would over the global batch; the
    perplexity is the global batch's. k-means init and dead-code expiry
    act on the global batch as JAX's do on its sharded one: the rows are
    drawn over all ``data_count() * B * N`` of them (rank r holds the
    contiguous block r, ``parallel/mesh.py::shard_bounds``) from a
    generator every rank holds in the same state, each rank fills in the
    rows it holds and one sum over the data group gives every rank the
    same rows; each Lloyd iteration runs the kernel on the rank's rows and
    sums its counts and row sums over the group. The ranks' codebooks stay
    equal, so the ``initted`` latch, one host read, agrees on every rank.

The codebook update runs under ``torch.no_grad`` and stores tensors outside
the autograd graph, so a step's graph dies with the step.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tvqvae_tpu_torch.ops.vq_kernel import nearest_codes_stats
from tvqvae_tpu_torch.parallel.mesh import all_reduce_, data_count, data_index, initialized
from tvqvae_tpu_torch.utils.device import capturing


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
    """A N(0, 1) codebook, or with ``kmeans_init`` a zero one waiting for
    its first training batch (as the JAX package initialises it)."""
    shape = (p.codebook_size, p.dim)
    if p.kmeans_init:
        embed, initted = torch.zeros(shape), torch.tensor(False)
    else:
        embed, initted = torch.randn(shape, generator=generator), torch.tensor(True)
    return CodebookState(
        embed=embed,
        embed_avg=embed.clone(),
        cluster_size=torch.zeros(p.codebook_size),
        initted=initted,
    )


@dataclass
class VQOutput:
    quantized: torch.Tensor  # (B, N, D), straight-through in train mode
    indices: torch.Tensor  # (B, N) int32
    perplexity: torch.Tensor  # scalar
    loss: torch.Tensor  # scalar: commitment_weight * commit_loss
    commit_loss: torch.Tensor  # scalar, 0 in eval mode
    state: CodebookState  # advanced one EMA step (train) or unchanged (eval)


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


def _row_draw(idx: Optional[torch.Tensor], K: int, M: int, generator, device) -> torch.Tensor:
    """K row indices into M rows: the given ones, or uniform draws."""
    if idx is None:
        if generator is None and initialized():
            raise ValueError("k-means init and dead-code expiry inside a process group draw "
                             "their rows from row_generator, held in the same state by every "
                             "rank")
        return torch.randint(0, M, (K,), generator=generator, device=device)
    return idx.to(device=device, dtype=torch.long)


def _global_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the global batch whose slice this rank holds as
    ``flat`` (its contiguous block of ``data_count()``): each rank fills in
    the rows it holds, zeros elsewhere, and one sum over the data group
    gives every rank all of them. ``flat[idx]`` without a process group."""
    if not initialized():
        return flat[idx]
    M = flat.shape[0]
    local = idx - data_index() * M
    mine = (local >= 0) & (local < M)
    rows = torch.where(mine[:, None], flat[local.clamp(0, M - 1)], 0.0)
    return all_reduce_(rows)


def _stats(samples: torch.Tensor, means: torch.Tensor):
    """The nearest-code pass of a Lloyd iteration over the global batch:
    (bins, sums) summed over the data group in one collective."""
    _, bins, sums = nearest_codes_stats(samples, means.contiguous())
    if not initialized():
        return bins, sums
    both = all_reduce_(torch.cat([bins[:, None], sums], 1))
    return both[:, 0], both[:, 1:]


@torch.no_grad()
def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           init_idx: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-Lloyd k-means on (M, D) samples from ``num_clusters`` random
    rows; empty clusters keep their mean. Returns (means, bins). Each
    assignment is a nearest-code pass (the VQ kernel on the card). Inside a
    process group ``samples`` is this rank's slice of the global batch and
    the k-means is the global batch's (module docstring): ``init_idx`` and
    the draws index the global rows."""
    M = samples.shape[0] * data_count()  # the global batch's rows
    means = _global_rows(samples, _row_draw(init_idx, num_clusters, M, generator,
                                            samples.device))
    for _ in range(num_iters):
        bins, sums = _stats(samples, means)
        new_means = sums / bins.clamp_min(1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins, _ = _stats(samples, means)
    return means, bins


def vq_forward(
    state: CodebookState,
    x: torch.Tensor,
    p: VQParams,
    *,
    train: bool = False,
    svq_temp: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    kmeans_idx: Optional[torch.Tensor] = None,
    dead_code_idx: Optional[torch.Tensor] = None,
    row_generator: Optional[torch.Generator] = None,
) -> VQOutput:
    """Quantize (B, N, D) -> VQOutput. In eval mode the codebook is unchanged.

    ``noise`` (M, K), when given, replaces the Gumbel draw of the
    ``svq_temp`` branch (M = B*N, K = codebook size); ``kmeans_idx`` and
    ``dead_code_idx`` (K,) replace the row draws of k-means init and
    dead-code expiry, as indices into the global batch's rows.
    ``row_generator`` draws those rows; without one they come from
    ``generator`` in one process, and inside a process group, where every
    rank must draw the same rows, its absence is an error."""
    B, N, D = x.shape
    K = p.codebook_size
    flat = x.reshape(B * N, D).float().contiguous()

    if row_generator is None and not initialized():
        row_generator = generator
    # the latch reads a flag on the device: only where k-means init is on, and
    # not inside a CUDA graph capture, which begins once it is set (train/multistep.py)
    if train and p.kmeans_init and not capturing() and not bool(state.initted):
        means, bins = kmeans(flat.detach(), K, p.kmeans_iters, kmeans_idx, row_generator)
        state = CodebookState(embed=means, embed_avg=means, cluster_size=bins,
                              initted=torch.ones_like(state.initted))

    if svq_temp is None or svq_temp == 0.0:
        indices, counts, embed_sum = nearest_codes_stats(flat, state.embed)
    else:
        with torch.no_grad():
            logits = neg_sq_dist(flat, state.embed) / svq_temp
            if noise is None:
                noise = gumbel(logits.shape, generator, logits.device)
            indices = (logits + noise).argmax(-1).to(torch.int32)
            counts = torch.bincount(indices, minlength=K).float()
            embed_sum = torch.zeros_like(state.embed).index_add_(0, indices, flat)

    rows = flat.shape[0]
    if train and initialized():
        # the batch is sharded over the data group: the EMA statistics are
        # the global batch's, as JAX's sum(0) over the sharded axis gives them
        counts, embed_sum = all_reduce_(counts.detach()), all_reduce_(embed_sum.detach())
        rows *= data_count()

    quantized = state.embed[indices.long()]  # the pre-update codebook

    new_state = state
    if train:
        with torch.no_grad():
            cluster_size = state.cluster_size * p.decay + counts * (1.0 - p.decay)
            embed_avg = state.embed_avg * p.decay + embed_sum * (1.0 - p.decay)
            n = cluster_size.sum()
            smoothed = (cluster_size + p.eps) / (n + K * p.eps) * n
            embed = embed_avg / smoothed[:, None]
            if p.threshold_ema_dead_code > 0:
                expired = cluster_size < p.threshold_ema_dead_code
                ridx = _row_draw(dead_code_idx, K, rows, row_generator, flat.device)
                embed = torch.where(expired[:, None], _global_rows(flat, ridx), embed)
        new_state = CodebookState(embed=embed, embed_avg=embed_avg,
                                  cluster_size=cluster_size, initted=state.initted)
        commit_loss = ((quantized - flat) ** 2).mean()  # quantized carries no gradient
        q = x.float() + (quantized.reshape(B, N, D) - x.float()).detach()
    else:
        commit_loss = torch.zeros((), device=flat.device)
        q = quantized.reshape(B, N, D)

    avg_probs = counts / rows
    perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
    return VQOutput(
        quantized=q,
        indices=indices.reshape(B, N),
        perplexity=perplexity,
        loss=commit_loss * p.commitment_weight,
        commit_loss=commit_loss,
        state=new_state,
    )


def lookup_codes(state: CodebookState, indices: torch.Tensor) -> torch.Tensor:
    """Token indices -> codebook vectors (the decode-time embedding lookup)."""
    return state.embed[indices.long()]
