"""Bidirectional transformer priors over VQ token grids, eval mode.

Port of ``tvqvae_tpu/models/transformer.py``. Submodules carry the JAX tree's
names; in ``EncoderBlock`` ``Dense_0..2`` are the q/k/v projections,
``Dense_3`` the attention output and ``Dense_4``/``Dense_5`` the feed-forward
pair. What differs between flax and PyTorch defaults, and is set here:

  - flax ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate="tanh")``.
  - flax ``LayerNorm``/``RMSNorm`` use eps 1e-6; ``pred_norm`` uses 1e-12.
  - the weight-tied logits use the whole token table, mask row included,
    plus ``logit_bias`` (num_tokens, K+1), and then drop the mask column.
  - ``project_in``/``project_out`` exist only when in_dim != hidden_dim (the
    HF prior at the published config), or with ``force_projections``.
  - ``Upscale`` is nearest resize + two k3 convs with eval-mode BatchNorm,
    over (B, D, N) channel-first sequences.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tvqvae_tpu_torch.ops.interp import interp_nearest

NORM_EPS = 1e-6  # flax LayerNorm / RMSNorm default


def _norm(dim: int, use_rmsnorm: bool) -> nn.Module:
    return nn.RMSNorm(dim, eps=NORM_EPS) if use_rmsnorm else nn.LayerNorm(dim, eps=NORM_EPS)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class EncoderBlock(nn.Module):
    """Pre-norm attention + feed-forward block (head dim 64)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, ff_mult: int = 1,
                 use_rmsnorm: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        norm = "RMSNorm" if use_rmsnorm else "LayerNorm"
        self.add_module(f"{norm}_0", _norm(dim, use_rmsnorm))
        self.add_module(f"{norm}_1", _norm(dim, use_rmsnorm))
        self.norm_names = (f"{norm}_0", f"{norm}_1")
        self.Dense_0 = nn.Linear(dim, inner, bias=False)
        self.Dense_1 = nn.Linear(dim, inner, bias=False)
        self.Dense_2 = nn.Linear(dim, inner, bias=False)
        self.Dense_3 = nn.Linear(inner, dim)
        self.Dense_4 = nn.Linear(dim, dim * ff_mult)
        self.Dense_5 = nn.Linear(dim * ff_mult, dim)

    def forward(self, x):
        B, N, _ = x.shape
        h = getattr(self, self.norm_names[0])(x)
        q, k, v = (
            lin(h).reshape(B, N, self.heads, self.dim_head).transpose(1, 2)
            for lin in (self.Dense_0, self.Dense_1, self.Dense_2)
        )
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.dim_head), dim=-1)
        h = (attn @ v).transpose(1, 2).reshape(B, N, self.heads * self.dim_head)
        x = x + self.Dense_3(h)
        h = getattr(self, self.norm_names[1])(x)
        return x + self.Dense_5(_gelu(self.Dense_4(h)))


class Upscale(nn.Module):
    """Stretch LF token embeddings (B, N, D) to the HF grid length (B, M, D)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_dim, hidden_dim, 3, padding=1)
        self.BatchNorm_0 = nn.BatchNorm1d(hidden_dim, eps=1e-5)
        self.Conv_1 = nn.Conv1d(hidden_dim, out_dim, 3, padding=1)

    def forward(self, x, upscale_size: int):
        x = interp_nearest(x.transpose(1, 2), upscale_size)  # (B, D, M)
        x = self.Conv_1(self.BatchNorm_0(_gelu(self.Conv_0(x))))
        return x.transpose(1, 2)


class BidirectionalTransformer(nn.Module):
    def __init__(self, kind: str, num_tokens: int, codebook_size_l: int,
                 codebook_size_h: int, embed_dim: int, hidden_dim: int,
                 n_layers: int, heads: int, ff_mult: int, use_rmsnorm: bool,
                 n_classes: int, force_projections: bool = False):
        super().__init__()
        if kind not in ("lf", "hf"):
            raise ValueError(f"kind must be 'lf' or 'hf', got {kind!r}")
        self.kind = kind
        self.n_classes = n_classes
        in_dim = embed_dim if kind == "lf" else 2 * embed_dim
        self.tok_emb_l = nn.Embedding(codebook_size_l + 1, embed_dim)
        if kind == "hf":
            self.tok_emb_h = nn.Embedding(codebook_size_h + 1, embed_dim)
            self.projector = Upscale(embed_dim, embed_dim, 2 * embed_dim)
        self.pos_emb = nn.Embedding(num_tokens + 1, in_dim)
        self.class_emb = nn.Embedding(n_classes + 1, in_dim)
        self.projections = in_dim != hidden_dim or force_projections
        if self.projections:
            self.project_in = nn.Linear(in_dim, hidden_dim)
            self.project_out = nn.Linear(hidden_dim, in_dim)
        self.post_emb_norm = nn.LayerNorm(hidden_dim, eps=NORM_EPS)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", EncoderBlock(hidden_dim, heads, ff_mult=ff_mult,
                                                       use_rmsnorm=use_rmsnorm))
        self.final_norm_name = "RMSNorm_0" if use_rmsnorm else "LayerNorm_0"
        self.add_module(self.final_norm_name, _norm(hidden_dim, use_rmsnorm))
        self.pred_head = nn.Linear(in_dim, embed_dim)
        self.pred_norm = nn.LayerNorm(embed_dim, eps=1e-12)
        out_codes = codebook_size_l if kind == "lf" else codebook_size_h
        self.logit_bias = nn.Parameter(torch.zeros(num_tokens, out_codes + 1))

    def forward(self, s_l: torch.Tensor, s_h: Optional[torch.Tensor] = None,
                class_condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token grids (B, n) -> logits (B, n, K) of the band this prior predicts."""
        B = s_l.shape[0]
        if self.kind == "lf":
            emb = self.tok_emb_l(s_l.long())
            out_table = self.tok_emb_l.weight
        else:
            if s_h is None:
                raise ValueError("the HF prior needs both token grids")
            emb_l = self.projector(self.tok_emb_l(s_l.long()), s_h.shape[1])
            emb = torch.cat([emb_l, self.tok_emb_h(s_h.long())], dim=-1)
            out_table = self.tok_emb_h.weight

        n = emb.shape[1]
        emb = emb + self.pos_emb.weight[:n][None]
        if class_condition is None:
            cls_idx = torch.full((B, 1), self.n_classes, dtype=torch.long, device=emb.device)
        else:
            cls_idx = class_condition.long().reshape(B, 1)
        h = torch.cat([self.class_emb(cls_idx), emb], dim=1)  # (B, 1+n, in_dim)

        if self.projections:
            h = self.project_in(h)
        h = self.post_emb_norm(h)
        for i in range(self.n_layers):
            h = getattr(self, f"block_{i}")(h)
        h = getattr(self, self.final_norm_name)(h)
        if self.projections:
            h = self.project_out(h)

        h = self.pred_norm(_gelu(self.pred_head(h[:, 1:, :])))
        logits = h @ out_table.T + self.logit_bias
        return logits[:, :, :-1]  # drop the mask-token logit
