"""Conv-stack building blocks (port of ``tvqvae_tpu/models/layers.py``).

The stacks run NCHW, PyTorch's layout; the JAX package runs NHWC inside and
keeps the same public layouts, so the two meet at the model boundary.
Submodules carry the names of the JAX parameter tree (``Conv_0``,
``BatchNorm_0``, ``Snake_1`` ...), so ``utils/convert.py`` moves weights leaf
by leaf.

  - The JAX ``ConvTranspose2dTorch`` (an input-dilated conv with padding
    k-1-p and an unflipped kernel) computes what ``nn.ConvTranspose2d``
    computes; the converter flips the kernel.
  - ``EncBlock2d`` pads with edge ("replicate") values and then runs a VALID
    stride-(1, 2) conv, as the JAX block does.
  - ``BatchNorm2d`` and ``BatchNorm1d`` have flax's train semantics
    (``nn.BatchNorm(momentum=0.9)``): they normalise with the batch's
    biased variance over every axis but the channel axis (1) and move the
    running statistics 0.1 of the way to the batch mean and *biased*
    variance (torch's own update takes the unbiased one). In eval mode they
    are torch's modules over the running statistics. Inside a
    ``torch.distributed`` process group of more than one rank
    (``parallel/``) the train statistics are the global batch's, in both
    modes: each rank's mean and variance of its rows go through one
    all-reduce that the backward differentiates through, and combine by the
    law of total variance (``_FlaxTrainStatistics._global_moments``); the
    running statistics stay equal on every rank.
  - Only ``ResBlock2d`` drops out (after ``Conv_1``, before the skip add),
    as in the JAX stacks, which build ``EncBlock2d``/``DecBlock2d`` with rate
    0. The masks come from the ``torch.Generator`` the caller passes through
    ``NamedStack.forward``; a kept value is ``x / keep``, as
    ``flax.linen.Dropout`` computes it. The masks are float32 draws whatever
    the compute dtype, so one generator state gives the same masks in
    float32 and bfloat16.

Reduced precision, as flax computes it (no autocast): parameters stay
float32 and a layer given a ``compute_dtype`` casts its input, kernel and
bias to it at each call (``Conv2d``, ``Conv1d``, ``ConvTranspose2d``); Snake
runs in its input's dtype. ``compute_dtype=None`` (the JAX package's
"float32") casts nothing: the layer computes in its parameters' dtype, so a
``.double()`` copy of a model runs in float64. Under bfloat16 a BatchNorm
either runs flax's float32 sandwich, ``bn(h.float()).to(dtype)`` (the
default), or, with ``fast``, the JAX package's fast BatchNorm: float32
statistics reduced over the bfloat16 input, the biased variance as
E[x^2] - E[x]^2, the folded per-channel ``x * w + b`` in the input dtype
(``BatchNorm2d(fast=...)`` is the JAX package's ``batch_norm(train, fast)``:
the train flag is the module's mode here). ``GroupNorm`` with ``fast`` is
the enhancer's counterpart.

``NamedStack(..., remat=True)`` recomputes each block in the backward
(``torch.utils.checkpoint``), as the JAX stacks' ``nn.remat`` does. A
ResBlock's dropout mask is drawn before the block runs and handed in, so the
recompute uses the same mask; the recompute leaves the BatchNorm running
statistics alone, so they move once per step.
"""

import contextlib
import math
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tvqvae_tpu_torch.ops.snake import snake
from tvqvae_tpu_torch.parallel.mesh import all_reduce_sum, data_count, data_index


def cast_dtype(name) -> Optional[torch.dtype]:
    """The JAX package's ``compute_dtype`` string -> the dtype a layer casts
    to: None for ``"float32"`` (no cast: the parameters' dtype), else the
    torch dtype (``"bfloat16"``)."""
    dt = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"not a floating-point compute dtype: {name!r}")
    return None if dt == torch.float32 else dt


def cast_to(t, dtype):
    """``t.to(dtype)``; None (a missing bias, or no compute dtype) leaves it."""
    return t if t is None or dtype is None else t.to(dtype)


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype norm statistics are reduced in: float32, or wider when the
    input is (a float64 copy of a model)."""
    return torch.promote_types(x.dtype, torch.float32)


class _CastAtCall:
    """A conv computing in ``compute_dtype``: input, kernel and bias are cast
    at each call before the functional conv (float32 parameters, as flax's
    ``nn.Conv(dtype=...)``; None: no cast). The bias is added to the conv's
    output in that dtype, as flax adds it: a conv given the bias (torch's
    CPU convs fuse it) rounds once where flax rounds twice under bfloat16."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return self._cast_call(x, self.weight)

    def _cast_call(self, x, w):
        dt = self.compute_dtype
        y = self._functional(cast_to(x, dt), cast_to(w, dt), None)
        b = cast_to(self.bias, dt)
        return y if b is None else y + b.view(-1, *[1] * (y.dim() - 2))


class Conv2d(_CastAtCall, nn.Conv2d):
    _functional = nn.Conv2d._conv_forward


class Conv1d(_CastAtCall, nn.Conv1d):
    _functional = nn.Conv1d._conv_forward


class ConvTranspose2d(_CastAtCall, nn.ConvTranspose2d):
    def _functional(self, x, w, b):
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Snake(nn.Module):
    """Learnable per-channel snake activation over channel-first inputs, in
    the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.a = nn.Parameter(torch.full((features,), 0.35))

    def forward(self, x):
        return snake(x, self.a.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2))))


class _FlaxTrainStatistics:
    """Train mode of a torch BatchNorm with flax's statistics (eps 1e-5);
    with ``fast``, the JAX package's fast BatchNorm in train and eval mode.
    When the batch is split over more than one rank (its data group) the
    train statistics are the global batch's (``_global_moments``), in both
    modes."""

    MOMENTUM = 0.9  # flax convention: the weight of the old running value

    def __init__(self, num_features: int, fast: bool = False):
        super().__init__(num_features, eps=1e-5)
        self.fast = fast
        self.recomputing = False  # a remat recompute: the running statistics stay

    def forward(self, x):
        if self.fast:
            return self._fast(x)
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.dim()))
        if data_count() > 1:
            var, mean = torch.var_mean(x.to(stats_dtype(x)), dim=dims, correction=0)
            mean, var = self._global_moments(mean, var)
            self._update_running(mean, var)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            w = self.weight * torch.rsqrt(var + self.eps)
            return (x - mean.view(shape)) * w.view(shape) + self.bias.view(shape)
        if not self.recomputing:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
            self._update_running(mean, var)
        # batch statistics (biased variance); the running buffers are not passed
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean, var):
        if not self.recomputing:
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)

    def _fast(self, x):
        """float32 statistics over ``x`` (E[x^2] - E[x]^2), then ``x * w + b``
        in ``x``'s dtype with w = scale * rsqrt(var + eps), b = bias - mean w."""
        if self.training:
            xf = x.to(stats_dtype(x))
            dims = (0, *range(2, x.dim()))
            mean = xf.mean(dims)
            var = xf.square().mean(dims) - mean.square()
            if data_count() > 1:
                mean, var = self._global_moments(mean, var)
            if not self.recomputing:
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        w = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * w
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * w.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)

    @staticmethod
    def _global_moments(mean, var):
        """This rank's per-channel mean and biased variance of its rows ->
        the global batch's, as GSPMD gives them, differentiable: one
        all-reduce over the data group of a (W, 2, C) tensor holding each
        slice's row (so every rank reads all of them), whose backward sums
        their gradients over the group, so the step differentiates through
        the global statistics; then mean = mean_r(m_r) and var = mean_r(v_r) + mean_r((m_r -
        mean)^2) over the equal slices (the law of total variance), which
        keeps the per-rank formula's conditioning where E[x^2] - E[x]^2 over
        global sums would lose digits wherever |mean| >> std."""
        W, r = data_count(), data_index()
        mine = torch.stack([mean, var])[None]
        rows = torch.cat([mine.new_zeros((r, *mine.shape[1:])), mine,
                          mine.new_zeros((W - r - 1, *mine.shape[1:]))])
        m, v = all_reduce_sum(rows).unbind(1)
        mean = m.mean(0)
        return mean, v.mean(0) + (m - mean).square().mean(0)


class BatchNorm2d(_FlaxTrainStatistics, nn.BatchNorm2d):
    """Over (B, C, H, W): statistics over B, H and W."""


class BatchNorm1d(_FlaxTrainStatistics, nn.BatchNorm1d):
    """Over (B, C, N): statistics over B and N."""


def normalize(norm: nn.Module, h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A block's norm (a ``BatchNorm2d`` or ``GroupNorm``, each with ``.fast``)
    in ``dtype``: the fast one on ``h`` as it is, else flax's float32
    sandwich ``norm(h.float()).to(dtype)`` (no cast when ``dtype`` is None)."""
    return norm(h) if norm.fast or dtype is None else norm(h.float()).to(dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``; with ``fast``, the JAX package's fast GroupNorm:
    float32 statistics per (sample, group) as E[x^2] - E[x]^2 and the folded
    per-channel ``x * w + b`` in the input dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, fast: bool = False):
        super().__init__(num_groups, num_channels, eps=eps)
        self.fast = fast

    def forward(self, x):
        if not self.fast:
            return super().forward(x)
        B, C = x.shape[:2]
        g = self.num_groups
        xg = x.reshape(B, g, -1).to(stats_dtype(x))
        mean = xg.mean(-1)  # (B, g)
        var = xg.square().mean(-1) - mean.square()
        w = torch.rsqrt(var + self.eps).repeat_interleave(C // g, 1) * self.weight  # (B, C)
        b = self.bias - mean.repeat_interleave(C // g, 1) * w
        shape = (B, C) + (1,) * (x.dim() - 2)
        return x * w.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


def dropout_mask(shape, rate: float, generator=None, device=None) -> torch.Tensor:
    """The keep mask (probability ``1 - rate``), drawn in float32."""
    return torch.empty(shape, device=device).bernoulli_(1.0 - rate, generator=generator).bool()


def dropout(x: torch.Tensor, rate: float, generator=None, mask=None) -> torch.Tensor:
    """Inverted dropout: ``x / keep`` where kept (probability ``1 - rate``),
    else 0; ``mask`` (``dropout_mask``'s) replaces the draw."""
    if mask is None:
        mask = dropout_mask(x.shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _geometry(frequency_independence: bool, kw: int):
    """(kernel, padding) of a block: (1, kw)/(0, 1) or (3, kw)/(1, 1)."""
    return ((1, kw), (0, 1)) if frequency_independence else ((3, kw), (1, 1))


class ResBlock2d(nn.Module):
    """Snake -> conv -> BN -> Snake -> conv -> dropout, plus a 1x1-projected
    skip when the channel count changes ('same' padding; dropout only in
    train mode), in ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool,
                 dropout: float = 0.0, compute_dtype=None, fast_bn: bool = False):
        super().__init__()
        ksize, pad = _geometry(frequency_independence, 3)
        dt = self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.out_channels = out_channels
        self.Snake_0 = Snake(in_channels)
        self.Conv_0 = Conv2d(in_channels, out_channels, ksize, padding=pad, compute_dtype=dt)
        self.BatchNorm_0 = BatchNorm2d(out_channels, fast=fast_bn)
        self.Snake_1 = Snake(out_channels)
        self.Conv_1 = Conv2d(out_channels, out_channels, ksize, padding=pad, compute_dtype=dt)
        if in_channels != out_channels:
            self.Conv_2 = Conv2d(in_channels, out_channels, 1, compute_dtype=dt)

    def draw_mask(self, x, generator=None):
        """The dropout mask of this block's input ``x``, or None outside
        training (``forward`` would draw the same)."""
        if not (self.training and self.dropout > 0.0):
            return None
        return dropout_mask((x.shape[0], self.out_channels, *x.shape[2:]), self.dropout,
                            generator, x.device)

    def forward(self, x, generator=None, mask=None):
        x = cast_to(x, self.compute_dtype)
        h = self.Conv_0(self.Snake_0(x))
        h = self.Conv_1(self.Snake_1(normalize(self.BatchNorm_0, h, self.compute_dtype)))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, generator, mask)
        skip = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return skip + h


class EncBlock2d(nn.Module):
    """Width-halving block: edge padding, VALID stride-(1, 2) conv, BN,
    Snake, in ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool,
                 compute_dtype=None, fast_bn: bool = False):
        super().__init__()
        ksize, self.pad = _geometry(frequency_independence, 4)
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv2d(in_channels, out_channels, ksize, stride=(1, 2),
                             compute_dtype=compute_dtype)
        self.BatchNorm_0 = BatchNorm2d(out_channels, fast=fast_bn)
        self.Snake_0 = Snake(out_channels)

    def forward(self, x):
        ph, pw = self.pad
        x = F.pad(cast_to(x, self.compute_dtype), (pw, pw, ph, ph), mode="replicate")
        return self.Snake_0(normalize(self.BatchNorm_0, self.Conv_0(x), self.compute_dtype))


def conv_transpose(in_channels: int, out_channels: int, frequency_independence: bool,
                   compute_dtype=None):
    """Width-doubling transposed conv, kernel (3, 4)/(1, 4), stride (1, 2)."""
    ksize, pad = _geometry(frequency_independence, 4)
    return ConvTranspose2d(in_channels, out_channels, ksize, stride=(1, 2), padding=pad,
                           compute_dtype=compute_dtype)


class DecBlock2d(nn.Module):
    """Width-doubling block: transposed conv -> BN -> Snake, in ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool,
                 compute_dtype=None, fast_bn: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ConvTranspose2dTorch_0 = conv_transpose(
            in_channels, out_channels, frequency_independence, compute_dtype
        )
        self.BatchNorm_0 = BatchNorm2d(out_channels, fast=fast_bn)
        self.Snake_0 = Snake(out_channels)

    def forward(self, x):
        h = self.ConvTranspose2dTorch_0(x)
        return self.Snake_0(normalize(self.BatchNorm_0, h, self.compute_dtype))


@contextlib.contextmanager
def _statistics_kept(block: nn.Module):
    """A remat recompute of ``block``: its BatchNorms leave the running
    statistics as the first pass left them."""
    norms = [m for m in block.modules() if isinstance(m, _FlaxTrainStatistics)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


class NamedStack(nn.Sequential):
    """A sequence of blocks named as the JAX package's auto-numbering names
    them (``EncBlock2d_0``, ``ResBlock2d_3``, ...). With ``remat`` each
    Enc/Res/DecBlock is recomputed in the backward (the bare transposed
    convs are not, as in JAX)."""

    def __init__(self, blocks, remat: bool = False):
        counts = {}
        named = OrderedDict()
        for block in blocks:
            kind = type(block).__name__
            if isinstance(block, nn.ConvTranspose2d):
                kind = "ConvTranspose2dTorch"
            n = counts.get(kind, 0)
            counts[kind] = n + 1
            named[f"{kind}_{n}"] = block
        super().__init__(named)
        self.remat = remat

    def forward(self, x, generator=None):
        """Run the blocks in order; ``generator`` draws the ResBlocks' dropout
        masks, each before its block runs."""
        for block in self:
            res = isinstance(block, ResBlock2d)
            args = (x, None, block.draw_mask(x, generator)) if res else (x,)
            if self.remat and torch.is_grad_enabled() and not isinstance(block, nn.ConvTranspose2d):
                x = checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                               context_fn=lambda b=block: (contextlib.nullcontext(),
                                                           _statistics_kept(b)))
            else:
                x = block(*args)
        return x


# flax's lecun_normal draws a normal truncated to +-2 and divides it by the
# standard deviation of that truncated normal, so the kernel's std is 1/sqrt(fan_in)
TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for every layer of ``module``, all drawn from
    ``generator``, from the distributions flax gives the JAX package's
    layers: convolution and linear kernels ``lecun_normal`` (a normal
    truncated to +-2, times 1/(sqrt(fan_in) * 0.8796), fan_in = input
    channels times the kernel's taps; ``WSConv1d`` is a ``Conv1d``) with zero
    bias; Snake ``a`` U(0.2, 0.5); embeddings N(0, 1/dim) (``nn.Embed``'s
    default); norms (BatchNorm, GroupNorm, ``ChanLayerNorm``) and running
    statistics keep their identity values: scales 1, biases 0. The draws
    differ from JAX's; the distributions are the same."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            # torch stores (out, in, *kernel), a transposed conv (in, out, *kernel)
            fan_in = w.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1] * math.prod(w.shape[2:])
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.mul_(1.0 / (math.sqrt(fan_in) * TRUNCATED_NORMAL_STD))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Snake):
            m.a.copy_(0.2 + 0.3 * torch.rand(m.a.shape, generator=generator))
        elif isinstance(m, nn.Embedding):
            w = m.weight
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))
    return module
