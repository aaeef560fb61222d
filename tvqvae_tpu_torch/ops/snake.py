"""Snake activation: x + (1/a) * sin^2(a * x) (port of ``tvqvae_tpu/ops/snake.py``)."""

import torch


def snake(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``a`` broadcasts against ``x`` (per-channel shape like (1, C, 1, 1))."""
    s = torch.sin(a * x)
    return x + (s * s) / a
