"""Bidirectional transformer priors over VQ token grids.

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
  - ``Upscale`` is nearest resize + two k3 convs with a BatchNorm between,
    over (B, D, N) channel-first sequences; in train mode the BatchNorm has
    flax's statistics (``layers.BatchNorm1d``).

``forward(..., train=True, generator=...)`` runs the train branches of the
JAX module, every draw from ``generator``:

  - attention dropout on the post-softmax probabilities and feed-forward
    dropout after the GELU, both inverted (``x / keep``), rate
    ``model_dropout``;
  - layer dropout, rate ``model_dropout``: one Bernoulli scalar per branch
    per call, shared by the whole batch, and no rescale (the branch is
    multiplied by 0 or 1; not torch-style stochastic depth);
  - class dropout: a given class becomes the unconditional index
    ``n_classes`` where ``uniform <= p_unconditional``;
  - token-embedding dropout (inverted, rate ``emb_dropout``) except at the
    band's mask-token positions; the HF prior drops out both bands'
    embeddings before ``Upscale``.

``train=False`` (the default) runs none of them, and draws nothing.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tvqvae_tpu_torch.models.layers import BatchNorm1d, dropout
from tvqvae_tpu_torch.ops.interp import interp_nearest

NORM_EPS = 1e-6  # flax LayerNorm / RMSNorm default


def _norm(dim: int, use_rmsnorm: bool) -> nn.Module:
    return nn.RMSNorm(dim, eps=NORM_EPS) if use_rmsnorm else nn.LayerNorm(dim, eps=NORM_EPS)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _maybe_dropout(x, rate: float, train: bool, generator):
    return dropout(x, rate, generator) if train and rate > 0.0 else x


def _layer_drop(h, rate: float, train: bool, generator):
    """The branch ``h`` times one draw of Bernoulli(1 - rate) for the whole
    batch, not rescaled."""
    if not train or rate <= 0.0:
        return h
    keep = torch.rand((), generator=generator, device=h.device) < 1.0 - rate
    return h * keep.to(h.dtype)


class EncoderBlock(nn.Module):
    """Pre-norm attention + feed-forward block (head dim 64)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, ff_mult: int = 1,
                 use_rmsnorm: bool = True, dropout: float = 0.0, layer_dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.layer_dropout = dropout, layer_dropout
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

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        B, N, _ = x.shape
        h = getattr(self, self.norm_names[0])(x)
        q, k, v = (
            lin(h).reshape(B, N, self.heads, self.dim_head).transpose(1, 2)
            for lin in (self.Dense_0, self.Dense_1, self.Dense_2)
        )
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.dim_head), dim=-1)
        attn = _maybe_dropout(attn, self.dropout, train, generator)
        h = (attn @ v).transpose(1, 2).reshape(B, N, self.heads * self.dim_head)
        x = x + _layer_drop(self.Dense_3(h), self.layer_dropout, train, generator)
        h = getattr(self, self.norm_names[1])(x)
        h = _maybe_dropout(_gelu(self.Dense_4(h)), self.dropout, train, generator)
        return x + _layer_drop(self.Dense_5(h), self.layer_dropout, train, generator)


class Upscale(nn.Module):
    """Stretch LF token embeddings (B, N, D) to the HF grid length (B, M, D)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_dim, hidden_dim, 3, padding=1)
        self.BatchNorm_0 = BatchNorm1d(hidden_dim)
        self.Conv_1 = nn.Conv1d(hidden_dim, out_dim, 3, padding=1)

    def forward(self, x, upscale_size: int):
        """In train mode (the module's ``training``, which
        ``BidirectionalTransformer.forward`` sets) the BatchNorm normalises
        with the batch's statistics and updates its running statistics."""
        x = interp_nearest(x.transpose(1, 2), upscale_size)  # (B, D, M)
        x = self.Conv_1(self.BatchNorm_0(_gelu(self.Conv_0(x))))
        return x.transpose(1, 2)


class BidirectionalTransformer(nn.Module):
    def __init__(self, kind: str, num_tokens: int, codebook_size_l: int,
                 codebook_size_h: int, embed_dim: int, hidden_dim: int,
                 n_layers: int, heads: int, ff_mult: int, use_rmsnorm: bool,
                 n_classes: int, force_projections: bool = False, p_unconditional: float = 0.0,
                 model_dropout: float = 0.0, emb_dropout: float = 0.0):
        super().__init__()
        if kind not in ("lf", "hf"):
            raise ValueError(f"kind must be 'lf' or 'hf', got {kind!r}")
        self.kind = kind
        self.n_classes = n_classes
        self.mask_token_l, self.mask_token_h = codebook_size_l, codebook_size_h
        self.p_unconditional, self.emb_dropout = p_unconditional, emb_dropout
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
            self.add_module(f"block_{i}", EncoderBlock(
                hidden_dim, heads, ff_mult=ff_mult, use_rmsnorm=use_rmsnorm,
                dropout=model_dropout, layer_dropout=model_dropout))
        self.final_norm_name = "RMSNorm_0" if use_rmsnorm else "LayerNorm_0"
        self.add_module(self.final_norm_name, _norm(hidden_dim, use_rmsnorm))
        self.pred_head = nn.Linear(in_dim, embed_dim)
        self.pred_norm = nn.LayerNorm(embed_dim, eps=1e-12)
        out_codes = codebook_size_l if kind == "lf" else codebook_size_h
        self.logit_bias = nn.Parameter(torch.zeros(num_tokens, out_codes + 1))

    def _class_index(self, class_condition, batch: int, device, train: bool, generator):
        """(B, 1) class rows: ``n_classes`` (unconditional) without a
        condition; in train mode a given class is dropped to it where
        ``uniform <= p_unconditional``."""
        if class_condition is None:
            return torch.full((batch, 1), self.n_classes, dtype=torch.long, device=device)
        idx = class_condition.long().reshape(batch, 1)
        if train and self.p_unconditional > 0.0:
            drop = torch.rand(idx.shape, generator=generator, device=device) <= self.p_unconditional
            idx = torch.where(drop, torch.full_like(idx, self.n_classes), idx)
        return idx

    def _token_dropout(self, s, emb, mask_token: int, train: bool, generator):
        """Inverted dropout on token embeddings, except at mask-token positions."""
        if not train or self.emb_dropout <= 0.0:
            return emb
        return torch.where((s == mask_token)[..., None], emb, dropout(emb, self.emb_dropout, generator))

    def forward(self, s_l: torch.Tensor, s_h: Optional[torch.Tensor] = None,
                class_condition: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token grids (B, n) -> logits (B, n, K) of the band this prior
        predicts. ``train`` selects the train branches (module docstring),
        whose draws come from ``generator``."""
        self.train(train)
        B = s_l.shape[0]
        if self.kind == "lf":
            emb = self._token_dropout(s_l, self.tok_emb_l(s_l.long()), self.mask_token_l,
                                      train, generator)
            out_table = self.tok_emb_l.weight
        else:
            if s_h is None:
                raise ValueError("the HF prior needs both token grids")
            emb_l = self._token_dropout(s_l, self.tok_emb_l(s_l.long()), self.mask_token_l,
                                        train, generator)
            emb_h = self._token_dropout(s_h, self.tok_emb_h(s_h.long()), self.mask_token_h,
                                        train, generator)
            emb = torch.cat([self.projector(emb_l, s_h.shape[1]), emb_h], dim=-1)
            out_table = self.tok_emb_h.weight

        n = emb.shape[1]
        emb = emb + self.pos_emb.weight[:n][None]
        cls_idx = self._class_index(class_condition, B, emb.device, train, generator)
        h = torch.cat([self.class_emb(cls_idx), emb], dim=1)  # (B, 1+n, in_dim)

        if self.projections:
            h = self.project_in(h)
        h = self.post_emb_norm(h)
        for i in range(self.n_layers):
            h = getattr(self, f"block_{i}")(h, train, generator)
        h = getattr(self, self.final_norm_name)(h)
        if self.projections:
            h = self.project_out(h)

        h = self.pred_norm(_gelu(self.pred_head(h[:, 1:, :])))
        logits = h @ out_table.T + self.logit_bias
        return logits[:, :, :-1]  # drop the mask-token logit
