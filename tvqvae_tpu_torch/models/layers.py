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
  - BatchNorm is eval-mode ``nn.BatchNorm2d`` (eps 1e-5) over the running
    statistics. Training, with the JAX package's biased-variance statistics
    and flax momentum, belongs to the training slice.
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


def _geometry(frequency_independence: bool, kw: int):
    """(kernel, padding) of a block: (1, kw)/(0, 1) or (3, kw)/(1, 1)."""
    return ((1, kw), (0, 1)) if frequency_independence else ((3, kw), (1, 1))


class ResBlock2d(nn.Module):
    """Snake -> conv -> BN -> Snake -> conv, plus a 1x1-projected skip when
    the channel count changes ('same' padding; dropout is identity in eval)."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool):
        super().__init__()
        ksize, pad = _geometry(frequency_independence, 3)
        self.Snake_0 = Snake(in_channels)
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, ksize, padding=pad)
        self.BatchNorm_0 = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.Snake_1 = Snake(out_channels)
        self.Conv_1 = nn.Conv2d(out_channels, out_channels, ksize, padding=pad)
        if in_channels != out_channels:
            self.Conv_2 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.Conv_0(self.Snake_0(x))
        h = self.Conv_1(self.Snake_1(self.BatchNorm_0(h)))
        skip = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return skip + h


class EncBlock2d(nn.Module):
    """Width-halving block: edge padding, VALID stride-(1, 2) conv, BN, Snake."""

    def __init__(self, in_channels: int, out_channels: int, frequency_independence: bool):
        super().__init__()
        ksize, self.pad = _geometry(frequency_independence, 4)
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, ksize, stride=(1, 2))
        self.BatchNorm_0 = nn.BatchNorm2d(out_channels, eps=1e-5)
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
        self.BatchNorm_0 = nn.BatchNorm2d(out_channels, eps=1e-5)
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
