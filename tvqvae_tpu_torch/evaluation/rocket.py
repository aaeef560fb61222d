"""ROCKET and MiniRocket features on the device.

Port of ``tvqvae_tpu/evaluation/rocket.py``. The JAX package computes both
in jnp, outside any Pallas kernel, so they are plain PyTorch here.

ROCKET: the kernel bank is drawn on the host with the JAX package's
``np.random.RandomState`` draws in the same order (bit-equal banks), cached
on the device once per bank and device, and applied as a shifted gather:

    out[b, k, i] = bias_k + sum_j w[k, j] * x[b, i - pad_k + j * dil_k]

over the (at most 11) taps in order, per chunk of 125 kernels, with the
out-of-range positions reading 0; then the proportion of positive values
(PPV) and the max over each kernel's own output length. Features are
(B, 2K), ``[ppv, max]`` per kernel; the caller L2-normalises them.

MiniRocket (the optional stage-3 perceptual net): the 84 two-valued length-9
kernels with a nonzero sum, one unpadded dilated ``conv1d`` per dilation,
and per (kernel, dilation) three biases, the batch means of the 0.25, 0.5
and 0.75 quantiles over time of a fitting batch. ``torch.quantile`` refuses
inputs above 2^24 elements (a 64-series fit at L=4633 has ~24 M), so the
quantiles come from one sort along time, interpolated as ``jnp.quantile``
does.
"""

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tvqvae_tpu_torch.utils.device import resolve_device

CHUNK = 125  # kernels per gather pass, as in the JAX package


@dataclass
class RocketKernels:
    weights: np.ndarray  # (K, max_len) zero-padded
    lengths: np.ndarray  # (K,)
    biases: np.ndarray  # (K,)
    dilations: np.ndarray  # (K,)
    paddings: np.ndarray  # (K,)
    input_length: int


def generate_kernels(input_length: int, num_kernels: int = 1000, seed: int = 0) -> RocketKernels:
    """Random kernel bank with the reference's distributions: lengths in
    {7, 9, 11}, N(0, 1) mean-centred weights, U(-1, 1) bias, log-uniform
    integer dilation, padding half the span or none."""
    rng = np.random.RandomState(seed)
    candidate = np.array([7, 9, 11], np.int32)
    lengths = rng.choice(candidate, num_kernels)
    max_len = int(candidate.max())

    weights = np.zeros((num_kernels, max_len), np.float64)
    biases = rng.uniform(-1.0, 1.0, num_kernels)
    dilations = np.zeros(num_kernels, np.int32)
    paddings = np.zeros(num_kernels, np.int32)
    for i in range(num_kernels):
        ln = lengths[i]
        w = rng.normal(0, 1, ln)
        weights[i, :ln] = w - w.mean()
        dilation = np.int32(2 ** rng.uniform(0, np.log2((input_length - 1) / (ln - 1))))
        dilations[i] = dilation
        paddings[i] = ((ln - 1) * dilation) // 2 if rng.randint(2) == 1 else 0
    return RocketKernels(
        weights=weights.astype(np.float32),
        lengths=lengths.astype(np.int32),
        biases=biases.astype(np.float32),
        dilations=dilations.astype(np.int32),
        paddings=paddings.astype(np.int32),
        input_length=input_length,
    )


def _device_bank(kernels: RocketKernels, device: torch.device):
    """The bank's tensors on ``device`` and the longest output length,
    uploaded once per bank and device and cached on the bank object, so the
    cache dies with the bank."""
    cache = kernels.__dict__.setdefault("_device_cache", {})
    if device in cache:
        return cache[device]
    out_lens = (kernels.input_length + 2 * kernels.paddings
                - (kernels.lengths - 1) * kernels.dilations).astype(np.int64)
    bank = tuple(torch.as_tensor(a, device=device) for a in (
        kernels.weights, kernels.biases, kernels.dilations.astype(np.int64),
        kernels.paddings.astype(np.int64), out_lens))
    cache[device] = (bank, int(out_lens.max()))
    return cache[device]


def _chunk_features(xpad: torch.Tensor, w, b, d, p, ol, i_max: int, L: int):
    """PPV and max (B, Kc) of one chunk of kernels over ``xpad`` (B, L + 1),
    whose last column is the 0 that out-of-range taps read. One (B, Kc,
    i_max) accumulator and one gathered tensor of that size are alive."""
    i_grid = torch.arange(i_max, device=xpad.device)
    acc = torch.zeros(xpad.shape[0], w.shape[0], i_max, device=xpad.device)
    for j in range(w.shape[1]):
        pos = i_grid[None, :] - p[:, None] + j * d[:, None]  # (Kc, I)
        pos = torch.where((pos >= 0) & (pos < L), pos, L)
        acc.addcmul_(xpad[:, pos], w[None, :, j, None])
    acc += b[None, :, None]
    acc.masked_fill_((i_grid[None, :] >= ol[:, None])[None], float("-inf"))
    ppv = (acc > 0).sum(-1, dtype=torch.float32) / ol.to(torch.float32)
    return ppv, acc.amax(-1)


@torch.inference_mode()
def apply_kernels(x: np.ndarray, kernels: RocketKernels, batch: int = 256,
                  device="cuda") -> np.ndarray:
    """(B, L) series -> (B, 2K) float32 ``[ppv, max]`` features, computed on
    ``device`` in batches of ``batch`` series (the last one as it comes)."""
    dev = resolve_device(device)
    (w, b, d, p, ol), i_max = _device_bank(kernels, dev)
    L = kernels.input_length
    xf = np.asarray(x, np.float32)
    outs = []
    for s in range(0, xf.shape[0], batch):
        xb = torch.from_numpy(xf[s:s + batch]).to(dev)
        xpad = F.pad(xb, (0, 1))
        ppvs, mxs = [], []
        for k in range(0, w.shape[0], CHUNK):
            e = slice(k, k + CHUNK)
            ppv, mx = _chunk_features(xpad, w[e], b[e], d[e], p[e], ol[e], i_max, L)
            ppvs.append(ppv)
            mxs.append(mx)
        feats = torch.stack([torch.cat(ppvs, 1), torch.cat(mxs, 1)], -1)
        outs.append(feats.reshape(xb.shape[0], -1).cpu().numpy())
    return np.concatenate(outs, axis=0)


def sorted_quantiles(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=-1)`` (linear) for each q, stacked last:
    one sort along the last axis, then low * (1 - w) + high * w at position
    q (n - 1). No limit on the input's size."""
    s = x.sort(dim=-1).values
    n = s.shape[-1]
    out = []
    for q in qs:
        pos = float(np.float32(q) * np.float32(n - 1))
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        w = pos - lo
        out.append(s[..., lo] * (1.0 - w) + s[..., hi] * w)
    return torch.stack(out, -1)


class MiniRocket:
    """MiniRocket transform, the optional stage-3 perceptual feature net.
    ``fit(x)`` once captures the quantile biases; then ``self(x)`` maps
    (B, C, L) series (channel 0, as the reference) to (B, num_features)
    features on ``device``."""

    kernel_length = 9
    num_kernels = 84

    def __init__(self, input_length: int, num_features: int = 10000, seed: int = 0,
                 device="cuda"):
        rng = np.random.RandomState(seed)
        kernels = []
        for _ in range(self.num_kernels):
            k = rng.choice([-1.0, 2.0], size=self.kernel_length, p=[2 / 3, 1 / 3])
            if k.sum() != 0:
                kernels.append(k)
        self.kernels = np.asarray(kernels, np.float32)  # (Kk, 9)
        max_dilation = (input_length - 1) // (self.kernel_length - 1)
        dil = np.logspace(0, np.log10(max(max_dilation, 1)), num=self.num_kernels, base=2,
                          dtype=int)
        self.dilations = [int(v) for v in np.unique(dil)]
        self.num_features = num_features
        self.device = resolve_device(device)
        self._kern = torch.from_numpy(self.kernels)[:, None, :].to(self.device)
        self.biases: List[np.ndarray] = None  # (Kk, 3) per dilation, after fit
        self._bias_dev: List[torch.Tensor] = None

    def _series(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)[:, :1, :]

    def _convs(self, xb: torch.Tensor) -> list:
        return [F.conv1d(xb, self._kern, dilation=d) for d in self.dilations]

    @torch.no_grad()
    def fit(self, x) -> "MiniRocket":
        self._bias_dev = [sorted_quantiles(out, (0.25, 0.5, 0.75)).mean(0)
                          for out in self._convs(self._series(x))]
        self.biases = [q.cpu().numpy() for q in self._bias_dev]
        return self

    def __call__(self, x, normalize: bool = True) -> torch.Tensor:
        if self.biases is None:
            raise RuntimeError("call fit() first")
        xb = self._series(x)
        feats = []
        for out, bias in zip(self._convs(xb), self._bias_dev):
            ppv = (out[:, :, None, :] > bias[None, :, :, None]).float().mean(-1)  # (B, Kk, 3)
            feats.append(ppv.reshape(xb.shape[0], -1))
        z = torch.cat(feats, -1)
        if z.shape[-1] < self.num_features:  # zero-filled to the fixed width (reference)
            z = F.pad(z, (0, self.num_features - z.shape[-1]))
        if normalize:
            z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return z
