"""Time-frequency VQ-VAE encoder / decoder conv stacks.

Port of ``tvqvae_tpu/models/vqvae.py``. The encoder doubles ``init_dim`` at
each of ``num_halvings`` width-halvings and ends in a ResBlock to
``hid_dim``; the decoder mirrors it and appends two transposed convs, so its
output width is W' * 2^(num_halvings+1). The STFT, band copy and iSTFT live
outside the stacks (``models/stage1.py``), as in the JAX package.

The stacks take and return NCHW maps: (B, 2C, H, W) -> (B, hid_dim, H', W')
-> (B, 2C, H, W''). ``dropout`` reaches the ResBlocks only, as in the JAX
stacks (their Enc/DecBlocks take no rate).
"""

import torch
from torch import nn

from tvqvae_tpu_torch.ops.interp import interp_linear

from .layers import DecBlock2d, EncBlock2d, NamedStack, ResBlock2d, conv_transpose


class VQVAEEncoder(NamedStack):
    """(B, in_channels, H, W) map -> (B, hid_dim, H', W') latents."""

    def __init__(self, in_channels: int, init_dim: int, hid_dim: int,
                 num_halvings: int, n_resnet_blocks: int,
                 frequency_independence: bool = False, dropout: float = 0.0):
        fi = frequency_independence
        d = init_dim
        blocks = [EncBlock2d(in_channels, d, fi)]
        for _ in range(num_halvings - 1):
            blocks.append(EncBlock2d(d, 2 * d, fi))
            d *= 2
            blocks += [ResBlock2d(d, d, fi, dropout) for _ in range(n_resnet_blocks)]
        blocks.append(ResBlock2d(d, hid_dim, fi, dropout))
        super().__init__(blocks)


class VQVAEDecoder(NamedStack):
    """(B, hid_dim, H', W') latents -> (B, out_channels, H, W'' = W' * 2^(k+1))."""

    def __init__(self, init_dim: int, hid_dim: int, out_channels: int,
                 num_halvings: int, n_resnet_blocks: int,
                 frequency_independence: bool = False, dropout: float = 0.0):
        fi = frequency_independence
        k = num_halvings
        d = init_dim * 2 ** (k - 1) if k >= 1 else init_dim
        blocks = [ResBlock2d(hid_dim, d, fi, dropout)]
        for _ in range(k - 1):
            blocks += [ResBlock2d(d, d, fi, dropout) for _ in range(n_resnet_blocks)]
            blocks.append(DecBlock2d(d, d // 2, fi))
            d //= 2
        blocks.append(conv_transpose(d, out_channels, fi))
        blocks.append(conv_transpose(out_channels, out_channels, fi))
        super().__init__(blocks)


class TimeHead(nn.Module):
    """Post-iSTFT head: linear resize of (B, C, L') to ``input_length`` plus a
    residual dense layer over time (out = x + Dense(x))."""

    def __init__(self, input_length: int):
        super().__init__()
        self.input_length = input_length
        self.Dense_0 = nn.Linear(input_length, input_length)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = interp_linear(x, self.input_length)
        return x + self.Dense_0(x)
