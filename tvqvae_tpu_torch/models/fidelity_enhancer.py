"""Fidelity enhancer: a 1-D U-Net refining sampled trajectories.

Port of ``tvqvae_tpu/models/fidelity_enhancer.py``, channel-first (B, C, L)
throughout; the JAX package runs the U-Net channels-last. Module
names are the flax tree's, so ``utils/convert.py::fe_from_jax`` renames and
transposes leaf by leaf:

  - flax builds ``_PreNormResidual(LinearAttention1d())`` in ``Unet1D``'s
    compact scope, so the attention's parameters sit at
    ``Unet1D_0/LinearAttention1d_{n}`` (and ``Attention1d_0``) and each
    ``_PreNormResidual_{n}`` holds only its ``ChanLayerNorm_0``;
  - ``Conv_{n}`` counts through the whole U-Net: the stem, the down convs,
    the up convs, ``last_up``, then the three head convs;
  - a ``ResnetBlock1d`` holds ``UnetBlock_0``/``UnetBlock_1`` (each
    ``WSConv1d_0``, ``GroupNorm_0``, ``Snake_0``) and, when the width
    changes, the 1x1 skip ``Conv_0``.

``WSConv1d`` standardises its kernel inside the forward (biased variance
over taps and input channels), so the gradient flows through the
standardisation as in JAX. Dropout (inverted, ``layers.dropout``) follows
each ``UnetBlock`` in train mode only, with masks from the caller's
``torch.Generator``.

``compute_dtype`` is the U-Net stream's dtype, as in JAX: the convs of the
stem, the blocks, the down and up paths compute in it (float32 parameters
cast at each call), ``WSConv1d`` standardises in float32 with eps 1e-5 at
float32 and 1e-3 otherwise, ``ChanLayerNorm`` reduces in float32 and
returns its input's dtype (eps keyed the same way), the GroupNorms run
flax's float32 sandwich or, with ``fast_norm``, ``layers.GroupNorm``'s
fast path; the attentions compute in float32 on the rounded stream (flax
promotes their bfloat16 input against float32 parameters) and add back in
the stream's dtype; the output head is float32, and so is the output.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from tvqvae_tpu_torch.models.layers import (
    Conv1d,
    GroupNorm,
    Snake,
    cast_dtype,
    cast_to,
    dropout,
    normalize,
    stats_dtype,
)
from tvqvae_tpu_torch.ops.interp import interp_linear, interp_nearest

ATTN_HEADS, ATTN_DIM_HEAD = 4, 32


class WSConv1d(Conv1d):
    """Weight-standardised 'same' conv (odd kernel): per output channel,
    (w - mean) / sqrt(var + eps) over (taps, input channels) in float32,
    then the conv and bias in ``compute_dtype`` (``layers._CastAtCall``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 compute_dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2,
                         compute_dtype=compute_dtype)

    def forward(self, x):
        eps = 1e-5 if self.compute_dtype in (None, torch.float32) else 1e-3
        w = self.weight  # read once: a tensor-parallel weight is gathered at every read
        var, mean = torch.var_mean(w, dim=(1, 2), keepdim=True, correction=0)
        return self._cast_call(x, (w - mean) * torch.rsqrt(var + eps))


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channel axis (1) with a scale ``g`` and no bias:
    float32 statistics, the result in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        eps = 1e-3 if x.dtype in (torch.bfloat16, torch.float16) else 1e-5
        xf = x.to(stats_dtype(x))
        var, mean = torch.var_mean(xf, dim=1, keepdim=True, correction=0)
        return ((xf - mean) * torch.rsqrt(var + eps) * self.g[:, None]).to(x.dtype)


class UnetBlock(nn.Module):
    """WSConv -> GroupNorm (eps 1e-5) -> Snake -> dropout (train mode)."""

    def __init__(self, in_channels: int, features: int, groups: int, rate: float,
                 compute_dtype=None, fast_norm: bool = False):
        super().__init__()
        self.rate = rate
        self.compute_dtype = compute_dtype
        self.WSConv1d_0 = WSConv1d(in_channels, features, compute_dtype=compute_dtype)
        self.GroupNorm_0 = GroupNorm(groups, features, eps=1e-5, fast=fast_norm)
        self.Snake_0 = Snake(features)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        x = self.Snake_0(normalize(self.GroupNorm_0, self.WSConv1d_0(x), self.compute_dtype))
        return dropout(x, self.rate, generator) if train and self.rate > 0.0 else x


class ResnetBlock1d(nn.Module):
    """Two UnetBlocks plus the input, through a 1x1 conv when the width changes."""

    def __init__(self, in_channels: int, features: int, groups: int, rate: float,
                 compute_dtype=None, fast_norm: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.UnetBlock_0 = UnetBlock(in_channels, features, groups, rate, compute_dtype, fast_norm)
        self.UnetBlock_1 = UnetBlock(features, features, groups, rate, compute_dtype, fast_norm)
        if in_channels != features:
            self.Conv_0 = Conv1d(in_channels, features, 1, compute_dtype=compute_dtype)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = self.UnetBlock_1(self.UnetBlock_0(x, train, generator), train, generator)
        return cast_to(self.Conv_0(x) if hasattr(self, "Conv_0") else x, self.compute_dtype) + h


class LinearAttention1d(nn.Module):
    """Linear attention: softmax of q over the head dimension (then the
    scale), of k over positions; context k v^T, out context^T q; a 1x1 conv
    with bias and a ChanLayerNorm."""

    def __init__(self, channels: int, heads: int = ATTN_HEADS, dim_head: int = ATTN_DIM_HEAD):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.Conv_0 = nn.Conv1d(channels, 3 * inner, 1, bias=False)
        self.Conv_1 = nn.Conv1d(inner, channels, 1)
        self.ChanLayerNorm_0 = ChanLayerNorm(channels)

    def forward(self, x):
        B, _, N = x.shape
        x = x.to(self.Conv_0.weight.dtype)  # flax promotes a bfloat16 stream to the parameters'
        q, k, v = (t.reshape(B, self.heads, self.dim_head, N) for t in self.Conv_0(x).chunk(3, 1))
        q = torch.softmax(q, dim=-2) * self.dim_head ** -0.5
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(B, -1, N)
        return self.ChanLayerNorm_0(self.Conv_1(out))


class Attention1d(nn.Module):
    """Full softmax attention over positions (q scaled before q k^T); a bare 1x1 conv out."""

    def __init__(self, channels: int, heads: int = ATTN_HEADS, dim_head: int = ATTN_DIM_HEAD):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.Conv_0 = nn.Conv1d(channels, 3 * inner, 1, bias=False)
        self.Conv_1 = nn.Conv1d(inner, channels, 1)

    def forward(self, x):
        B, _, N = x.shape
        x = x.to(self.Conv_0.weight.dtype)  # flax promotes a bfloat16 stream to the parameters'
        q, k, v = (t.reshape(B, self.heads, self.dim_head, N) for t in self.Conv_0(x).chunk(3, 1))
        sim = torch.einsum("bhdi,bhdj->bhij", q * self.dim_head ** -0.5, k)
        out = torch.einsum("bhij,bhdj->bhdi", torch.softmax(sim, dim=-1), v)
        return self.Conv_1(out.reshape(B, -1, N))


class _PreNormResidual(nn.Module):
    """Holds the pre-norm of ``x + attention(norm(x))``; ``Unet1D`` holds the attention."""

    def __init__(self, channels: int):
        super().__init__()
        self.ChanLayerNorm_0 = ChanLayerNorm(channels)


def _resize_cat(x, skip):
    """[x, skip linearly resized to x's length] along the channels."""
    return torch.cat([x, interp_linear(skip, x.shape[-1])], dim=1)


class Unet1D(nn.Module):
    """(B, channels, L) -> (B, channels, L)."""

    def __init__(self, dim: int, channels: int, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 resnet_block_groups: int = 8, dropout: float = 0.0,
                 compute_dtype=None, fast_norm: bool = False):
        super().__init__()
        g, p = resnet_block_groups, dropout
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self._counts = {}

        def res(d_in, d_out):
            return self._add("ResnetBlock1d",
                             ResnetBlock1d(d_in, d_out, g, p, compute_dtype, fast_norm))

        def conv(*args, **kw):  # a stream conv, in the compute dtype
            return self._add("Conv", Conv1d(*args, **kw, compute_dtype=compute_dtype))

        self.stem = conv(channels, dim, 7, padding=3)
        self.downs = []  # (resnet, resnet, prenorm, attention, conv, stride)
        for ind, (d_in, d_out) in enumerate(in_out):
            blocks = [res(d_in, d_in), res(d_in, d_in), *self._attention(d_in, LinearAttention1d)]
            if ind < len(in_out) - 1:
                blocks.append(conv(d_in, d_out, 4, stride=2, padding=1))
            else:
                blocks.append(conv(d_in, d_out, 3, padding=1))
            self.downs.append(blocks)
        mid = dims[-1]
        self.mid = [res(mid, mid), *self._attention(mid, Attention1d), res(mid, mid)]
        self.ups = []  # (resnet, resnet, prenorm, attention, conv); 2x nearest before all but the last conv
        for d_in, d_out in reversed(in_out):
            self.ups.append([res(d_out + d_in, d_out), res(d_out + d_in, d_out),
                             *self._attention(d_out, LinearAttention1d),
                             conv(d_out, d_in, 3, padding=1)])
        self.last_up = conv(dim, dim, 3, padding=1)
        self.final = res(2 * dim, dim)
        self.head = [self._add("Conv", nn.Conv1d(dim, channels, 1)),  # float32
                     self._add("Conv", nn.Conv1d(channels, channels, 3)),
                     self._add("Conv", nn.Conv1d(channels, channels, 3))]

    def _add(self, kind: str, module: nn.Module) -> str:
        """Register ``module`` as ``{kind}_{n}`` (flax's auto-numbering) -> its name."""
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        return f"{kind}_{n}"

    def _attention(self, channels: int, cls) -> List[str]:
        return [self._add("_PreNormResidual", _PreNormResidual(channels)),
                self._add(cls.__name__, cls(channels))]

    def _attend(self, x, prenorm: str, attention: str):
        out = getattr(self, attention)(getattr(self, prenorm).ChanLayerNorm_0(x))  # float32
        return x + out.to(x.dtype)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        m = lambda name: getattr(self, name)  # noqa: E731
        x = m(self.stem)(x)
        r = x
        skips = []
        for res0, res1, pre, attn, conv in self.downs:
            x = m(res0)(x, train, generator)
            skips.append(x)
            x = self._attend(m(res1)(x, train, generator), pre, attn)
            skips.append(x)
            x = m(conv)(x)
        res0, pre, attn, res1 = self.mid
        x = m(res1)(self._attend(m(res0)(x, train, generator), pre, attn), train, generator)
        for i, (res0, res1, pre, attn, conv) in enumerate(self.ups):
            x = m(res0)(_resize_cat(x, skips.pop()), train, generator)
            x = m(res1)(_resize_cat(x, skips.pop()), train, generator)
            x = self._attend(x, pre, attn)
            if i < len(self.ups) - 1:
                x = interp_nearest(x, 2 * x.shape[-1])
            x = m(conv)(x)
        x = m(self.last_up)(interp_nearest(x, 2 * x.shape[-1]))
        x = torch.cat([interp_linear(x, r.shape[-1]), r], dim=1)
        x = m(self.final)(x, train, generator)
        x = m(self.head[0])(x.to(m(self.head[0]).weight.dtype))
        for name in self.head[1:]:  # edge padding 1, then a VALID k3 conv
            x = m(name)(nn.functional.pad(x, (1, 1), mode="replicate"))
        return x


class FidelityEnhancer(nn.Module):
    """Linear resize to ``input_length``, then the U-Net; (B, C, L) in and out."""

    def __init__(self, input_length: int, in_channels: int, dim: int = 8,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), resnet_block_groups: int = 4,
                 dropout: float = 0.5, compute_dtype: str = "float32", fast_norm: bool = False):
        super().__init__()
        self.input_length = input_length
        self.Unet1D_0 = Unet1D(dim, in_channels, tuple(dim_mults), resnet_block_groups, dropout,
                               cast_dtype(compute_dtype), fast_norm)

    @staticmethod
    def from_config(cfg, input_length: int, in_channels: int, compute_dtype: str = "float32",
                    fast_norm: bool = False) -> "FidelityEnhancer":
        fe = cfg.fidelity_enhancer
        return FidelityEnhancer(input_length, in_channels, fe.dim, tuple(fe.dim_mults),
                                fe.resnet_block_groups, fe.dropout, compute_dtype, fast_norm)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        """``train`` turns dropout on, with masks drawn from ``generator``."""
        return self.Unet1D_0(interp_linear(x, self.input_length), train, generator)
