"""Static shape math for the VQ-VAE latent grid.

Port of ``tvqvae_tpu/ops/shapes.py`` (pure Python, copied): the encoder
output geometry (H', W', num_tokens) follows in closed form from
(L, n_fft, downsampled_width):

  - W frames = L + 1 (hop = n_fft//4 = 1, centered), H = n_fft//2 + 1 bins.
  - each stride-(1,2) encoder block maps W -> floor(W/2), H -> H.
  - number of halvings k = round(log2(downsample_rate)),
    downsample_rate = round(L / (log2(n_fft)-1) / downsampled_width).

At the published L=4633: LF -> (3, 9) = 27 tokens, HF -> (3, 36) = 108.
"""

import math
from typing import NamedTuple

from .stft import stft_num_frames


def compute_downsample_rate(input_length: int, n_fft: int, downsampled_width: int) -> int:
    """Python ``round`` (banker's rounding), as in the reference."""
    if input_length < downsampled_width:
        return 1
    return round(input_length / (math.log2(n_fft) - 1) / downsampled_width)


class TokenGeometry(NamedTuple):
    h_prime: int
    w_prime: int
    num_tokens: int
    num_halvings: int
    downsample_rate: int
    w_frames: int  # STFT frames before downsampling


def token_geometry(input_length: int, n_fft: int, downsampled_width: int) -> TokenGeometry:
    """Closed-form encoder output geometry for a (·, C, input_length) input."""
    rate = compute_downsample_rate(input_length, n_fft, downsampled_width)
    k = int(round(math.log2(rate))) if rate > 1 else 0
    k = max(k, 1)  # the first encoder block always halves once
    w_frames = stft_num_frames(input_length, n_fft)
    h = n_fft // 2 + 1
    w = w_frames >> k
    return TokenGeometry(
        h_prime=h,
        w_prime=w,
        num_tokens=h * w,
        num_halvings=k,
        downsample_rate=rate,
        w_frames=w_frames,
    )
