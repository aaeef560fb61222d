"""Short-time Fourier transform as 1-D convolutions.

Port of ``tvqvae_tpu/ops/stft.py``. With TimeVQVAE's tiny ``n_fft`` (4,
hop = n_fft//4 = 1; periodic Hann window, normalized, centered with reflect
padding, one-sided) the analysis transform is a linear map from each
length-n_fft window to 2*(n_fft//2+1) real channels, so

  - STFT is one ``conv1d`` with the windowed-DFT basis as its kernel, and
  - iSTFT is one ``conv_transpose1d`` (overlap-add of the windowed
    inverse-DFT basis) divided by the window-square envelope.

The kernels are the JAX package's, built with numpy. Layouts are the JAX
package's too: (B, C, L) maps to (B, 2C, H, W) with H = n_fft//2 + 1 bins,
W = L + 1 frames (hop 1), and channel (c*2 + z) holding the (real, imag)
part of input channel c.

On the card a float32 convolution runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; the JAX package computes the
transform at ``Precision.HIGHEST``, so the port's float32 entry points turn
TF32 off (``utils/device.py``).
"""

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(n_fft)."""
    n = np.arange(n_fft)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))


def stft_num_frames(length: int, n_fft: int) -> int:
    """Number of STFT frames for a centered transform with hop = n_fft//4."""
    hop = max(n_fft // 4, 1)
    padded = length + 2 * (n_fft // 2)
    return (padded - n_fft) // hop + 1


def istft_length(num_frames: int, n_fft: int) -> int:
    """Signal length returned by a centered iSTFT (torch default length)."""
    hop = max(n_fft // 4, 1)
    return (num_frames - 1) * hop


def _analysis_kernel(n_fft: int, norm: bool) -> np.ndarray:
    """(2*nbins, 1, n_fft): row (2k + z) is the z-th (0=real, 1=imag)
    component of onesided bin k, X[k, t] = sum_n w[n] x[t*hop+n] e^{-2i pi k n/N}."""
    nbins = n_fft // 2 + 1
    w = hann_window(n_fft)
    scale = 1.0 / np.sqrt(n_fft) if norm else 1.0
    n = np.arange(n_fft)
    k = np.arange(nbins)
    ang = -2.0 * np.pi * k[:, None] * n[None, :] / n_fft
    re = w[None, :] * np.cos(ang) * scale
    im = w[None, :] * np.sin(ang) * scale
    return np.stack([re, im], axis=1).reshape(2 * nbins, 1, n_fft)


def _synthesis_kernel(n_fft: int, norm: bool) -> np.ndarray:
    """(2*nbins, 1, n_fft): channel (2k + z) is the contribution of the z-th
    component of bin k to the windowed inverse frame; the imaginary parts of
    the DC and Nyquist bins contribute nothing (Hermitian symmetry)."""
    nbins = n_fft // 2 + 1
    w = hann_window(n_fft)
    denorm = np.sqrt(n_fft) if norm else 1.0
    n = np.arange(n_fft)
    kern = np.zeros((2 * nbins, 1, n_fft))
    for k in range(nbins):
        edge = k == 0 or (n_fft % 2 == 0 and k == nbins - 1)
        a_k = 1.0 if edge else 2.0
        ang = 2.0 * np.pi * k * n / n_fft
        kern[2 * k, 0, :] = w * a_k * np.cos(ang) / n_fft * denorm
        if not edge:
            kern[2 * k + 1, 0, :] = -w * a_k * np.sin(ang) / n_fft * denorm
    return kern


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def time_to_timefreq(x: torch.Tensor, n_fft: int, norm: bool = True) -> torch.Tensor:
    """(B, C, L) time series -> (B, 2C, H, W) time-frequency map."""
    B, C, L = x.shape
    hop = max(n_fft // 4, 1)
    pad = n_fft // 2
    nbins = n_fft // 2 + 1
    xf = F.pad(x.reshape(B * C, 1, L), (pad, pad), mode="reflect")
    out = F.conv1d(xf, _const(_analysis_kernel(n_fft, norm), x), stride=hop)
    W = out.shape[-1]  # out: (B*C, 2*nbins, W) in (k z) order
    out = out.reshape(B, C, nbins, 2, W).transpose(2, 3)
    return out.reshape(B, 2 * C, nbins, W)


def timefreq_to_time(xf: torch.Tensor, n_fft: int, norm: bool = True) -> torch.Tensor:
    """(B, 2C, H, W) time-frequency map -> (B, C, (W-1)*hop) time series:
    per-frame inverse DFT, synthesis window, overlap-add, division by the
    window-square envelope, and trimming of the centre padding."""
    B, C2, H, W = xf.shape
    C = C2 // 2
    hop = max(n_fft // 4, 1)
    pad = n_fft // 2
    nbins = n_fft // 2 + 1
    if H != nbins:
        raise ValueError(f"expected {nbins} frequency bins, got {H}")

    # (B, 2C, H, W) -> (B*C, 2*nbins, W) with (k z) channel order
    z = xf.reshape(B, C, 2, nbins, W).transpose(2, 3).reshape(B * C, 2 * nbins, W)
    ola = F.conv_transpose1d(z, _const(_synthesis_kernel(n_fft, norm), xf), stride=hop)

    wsq = (hann_window(n_fft) ** 2).reshape(1, 1, n_fft)
    env = F.conv_transpose1d(
        xf.new_ones((1, 1, W)), _const(wsq, xf), stride=hop
    )
    L_out = (W - 1) * hop
    y = ola[:, 0, pad:pad + L_out] / env[:, 0, pad:pad + L_out]
    return y.reshape(B, C, L_out)
