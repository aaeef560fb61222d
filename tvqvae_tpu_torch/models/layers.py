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
  - ``BatchNorm2d`` has flax's train semantics (``nn.BatchNorm(momentum=
    0.9)``): it normalises with the batch's biased variance and moves the
    running statistics 0.1 of the way to the batch mean and *biased*
    variance (torch's own update takes the unbiased one). In eval mode it is
    ``nn.BatchNorm2d`` over the running statistics.
  - Only ``ResBlock2d`` drops out (after ``Conv_1``, before the skip add),
    as in the JAX stacks, which build ``EncBlock2d``/``DecBlock2d`` with rate
    0. The masks come from the ``torch.Generator`` the caller passes through
    ``NamedStack.forward``; a kept value is ``x / keep``, as
    ``flax.linen.Dropout`` computes it.
"""

import math
from collections import OrderedDict

import torch
from torch import nn

from tvqvae_tpu_torch.ops.snake import snake


class Snake(nn.Module):
    """Learnable per-channel snake activation over channel-first inputs."""

    def __init__(self, features: int):
        super().__init__()
        self.a = nn.Parameter(torch.full((features,), 0.35))

    def forward(self, x):
        return snake(x, self.a.view(1, -1, *([1] * (x.dim() - 2))))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5) with flax's train-mode statistics."""

    MOMENTUM = 0.9  # flax convention: the weight of the old running value

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        # batch statistics (biased variance); the running buffers are not passed
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Inverted dropout: ``x / keep`` where kept (probability ``1 - rate``), else 0."""
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _geometry(frequency_independence: bool, kw: int):
    """(kernel, padding) of a block: (1, kw)/(0, 1) or (3, kw)/(1, 1)."""
    return ((1, kw), (0, 1)) if frequency_independence else ((3, kw), (1, 1))


class ResBlock2d(nn.Module):
    """Snake -> conv -> BN -> Snake -> conv -> dropout, plus a 1x1-projected
    skip when the channel count changes ('same' padding; dropout only in
    train mode)."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool,
                 dropout: float = 0.0):
        super().__init__()
        ksize, pad = _geometry(frequency_independence, 3)
        self.dropout = dropout
        self.Snake_0 = Snake(in_channels)
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, ksize, padding=pad)
        self.BatchNorm_0 = BatchNorm2d(out_channels)
        self.Snake_1 = Snake(out_channels)
        self.Conv_1 = nn.Conv2d(out_channels, out_channels, ksize, padding=pad)
        if in_channels != out_channels:
            self.Conv_2 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, generator=None):
        h = self.Conv_0(self.Snake_0(x))
        h = self.Conv_1(self.Snake_1(self.BatchNorm_0(h)))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, generator)
        skip = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return skip + h


class EncBlock2d(nn.Module):
    """Width-halving block: edge padding, VALID stride-(1, 2) conv, BN, Snake."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool):
        super().__init__()
        ksize, self.pad = _geometry(frequency_independence, 4)
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, ksize, stride=(1, 2))
        self.BatchNorm_0 = BatchNorm2d(out_channels)
        self.Snake_0 = Snake(out_channels)

    def forward(self, x):
        ph, pw = self.pad
        x = nn.functional.pad(x, (pw, pw, ph, ph), mode="replicate")
        return self.Snake_0(self.BatchNorm_0(self.Conv_0(x)))


def conv_transpose(in_channels: int, out_channels: int, frequency_independence: bool):
    """Width-doubling transposed conv, kernel (3, 4)/(1, 4), stride (1, 2)."""
    ksize, pad = _geometry(frequency_independence, 4)
    return nn.ConvTranspose2d(in_channels, out_channels, ksize, stride=(1, 2), padding=pad)


class DecBlock2d(nn.Module):
    """Width-doubling block: transposed conv -> BN -> Snake."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool):
        super().__init__()
        self.ConvTranspose2dTorch_0 = conv_transpose(
            in_channels, out_channels, frequency_independence
        )
        self.BatchNorm_0 = BatchNorm2d(out_channels)
        self.Snake_0 = Snake(out_channels)

    def forward(self, x):
        return self.Snake_0(self.BatchNorm_0(self.ConvTranspose2dTorch_0(x)))


class NamedStack(nn.Sequential):
    """A sequence of blocks named as the JAX package's auto-numbering names
    them (``EncBlock2d_0``, ``ResBlock2d_3``, ...)."""

    def __init__(self, blocks):
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

    def forward(self, x, generator=None):
        """Run the blocks in order; ``generator`` draws the ResBlocks' dropout masks."""
        for block in self:
            x = block(x, generator) if isinstance(block, ResBlock2d) else block(x)
        return x


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for every layer of ``module``, all drawn from
    ``generator``: convolutions and linear layers U(-1/sqrt(fan_in), ..) with
    zero bias, Snake ``a`` U(0.2, 0.5) as in the JAX package, embeddings
    N(0, 1/dim); norms and running statistics keep their identity values."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
            w.copy_(torch.rand(w.shape, generator=generator) * 2 * bound - bound)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Snake):
            m.a.copy_(0.2 + 0.3 * torch.rand(m.a.shape, generator=generator))
        elif isinstance(m, nn.Embedding):
            w = m.weight
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))
    return module
