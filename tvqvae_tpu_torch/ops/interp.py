"""1-D resampling along the last axis.

Port of ``tvqvae_tpu/ops/interp.py``, formula for formula: the sample
positions are computed in float32 as there, which is what
``F.interpolate(mode='linear', align_corners=False)`` and
``F.interpolate(mode='nearest')`` compute.
"""

import torch


def interp_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Linear resize of (..., L) to (..., size), align_corners=False:
    half-pixel sample positions, clamped at the borders."""
    L = x.shape[-1]
    if size == L:
        return x
    scale = L / size
    pos = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    pos = pos.clamp(0.0, L - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=L - 1)
    frac = (pos - lo).to(x.dtype)
    return x[..., lo] * (1.0 - frac) + x[..., hi] * frac


def interp_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of (..., L) to (..., size): index = floor(i * L / size)."""
    L = x.shape[-1]
    if size == L:
        return x
    idx = (torch.arange(size, dtype=torch.float32, device=x.device) * (L / size)).floor().long()
    return x[..., idx.clamp(0, L - 1)]
