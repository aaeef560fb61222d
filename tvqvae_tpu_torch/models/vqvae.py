"""Time-frequency VQ-VAE encoder / decoder conv stacks.

Port of ``tvqvae_tpu/models/vqvae.py``. The encoder doubles ``init_dim`` at
each of ``num_halvings`` width-halvings and ends in a ResBlock to
``hid_dim``; the decoder mirrors it and appends two transposed convs, so its
output width is W' * 2^(num_halvings+1). The STFT, band copy and iSTFT live
outside the stacks (``models/stage1.py``), as in the JAX package.

The stacks take and return NCHW maps: (B, 2C, H, W) -> (B, hid_dim, H', W')
-> (B, 2C, H, W''). ``dropout`` reaches the ResBlocks only, as in the JAX
stacks (their Enc/DecBlocks take no rate).

``compute_dtype`` is the stacks' compute dtype (None: the parameters';
``fast_bn`` picks the BatchNorm under it, ``remat`` recomputes each block
in the backward: ``layers.py``); under a compute dtype both stacks return
float32, as the JAX ones do (the VQ distances, the iSTFT and the losses
stay float32).
"""

import torch
import torch.nn.functional as F
from torch import nn

from tvqvae_tpu_torch.ops.interp import interp_linear

from .layers import DecBlock2d, EncBlock2d, NamedStack, ResBlock2d, conv_transpose


class VQVAEEncoder(NamedStack):
    """(B, in_channels, H, W) map -> (B, hid_dim, H', W') float32 latents."""

    def __init__(self, in_channels: int, init_dim: int, hid_dim: int,
                 num_halvings: int, n_resnet_blocks: int,
                 frequency_independence: bool = False, dropout: float = 0.0,
                 compute_dtype=None, remat: bool = False, fast_bn: bool = False):
        fi, prec = frequency_independence, dict(compute_dtype=compute_dtype, fast_bn=fast_bn)
        d = init_dim
        blocks = [EncBlock2d(in_channels, d, fi, **prec)]
        for _ in range(num_halvings - 1):
            blocks.append(EncBlock2d(d, 2 * d, fi, **prec))
            d *= 2
            blocks += [ResBlock2d(d, d, fi, dropout, **prec) for _ in range(n_resnet_blocks)]
        blocks.append(ResBlock2d(d, hid_dim, fi, dropout, **prec))
        super().__init__(blocks, remat)
        self.compute_dtype = compute_dtype

    def forward(self, x, generator=None):
        out = super().forward(x, generator)
        return out if self.compute_dtype is None else out.float()


class VQVAEDecoder(NamedStack):
    """(B, hid_dim, H', W') latents -> (B, out_channels, H, W'' = W' * 2^(k+1)), float32."""

    def __init__(self, init_dim: int, hid_dim: int, out_channels: int,
                 num_halvings: int, n_resnet_blocks: int,
                 frequency_independence: bool = False, dropout: float = 0.0,
                 compute_dtype=None, remat: bool = False, fast_bn: bool = False):
        fi, prec = frequency_independence, dict(compute_dtype=compute_dtype, fast_bn=fast_bn)
        k = num_halvings
        d = init_dim * 2 ** (k - 1) if k >= 1 else init_dim
        blocks = [ResBlock2d(hid_dim, d, fi, dropout, **prec)]
        for _ in range(k - 1):
            blocks += [ResBlock2d(d, d, fi, dropout, **prec) for _ in range(n_resnet_blocks)]
            blocks.append(DecBlock2d(d, d // 2, fi, **prec))
            d //= 2
        blocks.append(conv_transpose(d, out_channels, fi, compute_dtype))
        blocks.append(conv_transpose(out_channels, out_channels, fi, compute_dtype))
        super().__init__(blocks, remat)
        self.compute_dtype = compute_dtype

    def forward(self, x, generator=None):
        out = super().forward(x, generator)
        return out if self.compute_dtype is None else out.float()


class TimeHead(nn.Module):
    """Post-iSTFT head: linear resize of (B, C, L') to ``input_length`` plus a
    residual dense layer over time (out = x + Dense(x)). The dense's product
    computes in ``compute_dtype`` (None: the parameters') and is rounded to
    it once; its bias (cast to that dtype) and the residual add in the
    parameters' dtype, float32. That is what the JAX package's jitted
    ``TimeHead`` computes under XLA's default flags, which the JAX runner
    uses: the dot's bfloat16 output, then the bias and the residual added
    in float32, the sum never rounded to bfloat16."""

    def __init__(self, input_length: int, compute_dtype=None):
        super().__init__()
        self.input_length = input_length
        self.compute_dtype = compute_dtype
        self.Dense_0 = nn.Linear(input_length, input_length)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = interp_linear(x, self.input_length)
        w, b = self.Dense_0.weight, self.Dense_0.bias
        dt = self.compute_dtype or w.dtype
        return x + (F.linear(x.to(dt), w.to(dt)).to(w.dtype) + b.to(dt).to(w.dtype))
