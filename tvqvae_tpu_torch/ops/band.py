"""Low-/high-frequency band splitting on (B, C, H, W) time-frequency maps.

Port of ``tvqvae_tpu/ops/band.py``. The LF band is frequency bin 0, the HF
band bins 1:. With ``copy=False`` the other band is zeroed; with
``copy=True`` the kept band is broadcast into the other band's bins (LF: bin
0 repeated over all H; HF: bin 1 duplicated into bin 0).
"""

import torch


def zero_pad_high_freq(xf: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """Keep the LF band (frequency bin 0) of (B, C, H, W)."""
    if copy:
        return xf[:, :, :1, :].expand_as(xf)
    return torch.cat([xf[:, :, :1, :], torch.zeros_like(xf[:, :, 1:, :])], dim=2)


def zero_pad_low_freq(xf: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """Keep the HF band (frequency bins 1:) of (B, C, H, W)."""
    if copy:
        return torch.cat([xf[:, :, 1:2, :], xf[:, :, 1:, :]], dim=2)
    return torch.cat([torch.zeros_like(xf[:, :, :1, :]), xf[:, :, 1:, :]], dim=2)
