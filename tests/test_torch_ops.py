"""Port parity: tvqvae_tpu_torch.ops against tvqvae_tpu.ops on the CPU.

Inputs are made with numpy from a seed and fed to both packages; every
comparison is float32 at 1e-5 absolute (the two packages evaluate the same
formulas with sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tvqvae_tpu import ops as jops
from tvqvae_tpu_torch import ops as tops

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("L", [64, 127, 301])
@pytest.mark.parametrize("n_fft", [4, 8])
def test_stft_matches_jax(L, n_fft):
    x = np.random.default_rng(0).normal(size=(2, 3, L)).astype(np.float32)
    ref = np.asarray(jops.time_to_timefreq(jnp.asarray(x), n_fft))
    out = tops.time_to_timefreq(_t(x), n_fft).numpy()
    assert out.shape == ref.shape
    assert out.shape[3] == tops.stft_num_frames(L, n_fft)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("L", [64, 127, 301])
@pytest.mark.parametrize("n_fft", [4, 8])
def test_istft_matches_jax(L, n_fft):
    rng = np.random.default_rng(1)
    W = tops.stft_num_frames(L, n_fft)
    xf = rng.normal(size=(2, 6, n_fft // 2 + 1, W)).astype(np.float32)
    ref = np.asarray(jops.timefreq_to_time(jnp.asarray(xf), n_fft))
    out = tops.timefreq_to_time(_t(xf), n_fft).numpy()
    assert out.shape == ref.shape == (2, 3, tops.istft_length(W, n_fft))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_stft_istft_roundtrip():
    x = np.random.default_rng(2).normal(size=(2, 4, 127)).astype(np.float32)
    rt = tops.timefreq_to_time(tops.time_to_timefreq(_t(x), 4), 4).numpy()
    np.testing.assert_allclose(rt[..., :127], x, atol=ATOL)


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("band", ["high", "low"])
def test_band_split_matches_jax(band, copy):
    xf = np.random.default_rng(3).normal(size=(2, 6, 5, 11)).astype(np.float32)
    jf = jops.zero_pad_high_freq if band == "high" else jops.zero_pad_low_freq
    tf = tops.zero_pad_high_freq if band == "high" else tops.zero_pad_low_freq
    np.testing.assert_array_equal(tf(_t(xf), copy=copy).numpy(),
                                  np.asarray(jf(jnp.asarray(xf), copy=copy)))


@pytest.mark.parametrize("L,size", [(128, 127), (127, 128), (10, 4633), (4634, 4633), (7, 7)])
def test_interp_matches_jax(L, size):
    x = np.random.default_rng(4).normal(size=(2, 3, L)).astype(np.float32)
    np.testing.assert_allclose(
        tops.interp_linear(_t(x), size).numpy(),
        np.asarray(jops.interp_linear(jnp.asarray(x), size)), atol=ATOL,
    )
    np.testing.assert_array_equal(
        tops.interp_nearest(_t(x), size).numpy(),
        np.asarray(jops.interp_nearest(jnp.asarray(x), size)),
    )


def test_snake_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 3, 9)).astype(np.float32)
    a = rng.uniform(0.2, 0.5, size=(1, 4, 1, 1)).astype(np.float32)
    np.testing.assert_allclose(tops.snake(_t(x), _t(a)).numpy(),
                               np.asarray(jops.snake(jnp.asarray(x), jnp.asarray(a))),
                               atol=ATOL)


def test_token_geometry_published_shape():
    lf = tops.token_geometry(4633, 4, 8)
    hf = tops.token_geometry(4633, 4, 32)
    assert (lf.h_prime, lf.w_prime, lf.num_tokens) == (3, 9, 27)
    assert (hf.h_prime, hf.w_prime, hf.num_tokens) == (3, 36, 108)


@pytest.mark.parametrize("L", [16, 96, 127, 301, 512, 4633])
@pytest.mark.parametrize("width", [4, 8, 32])
@pytest.mark.parametrize("n_fft", [4, 8])
def test_token_geometry_matches_jax(L, width, n_fft):
    assert tuple(tops.token_geometry(L, n_fft, width)) == tuple(
        jops.token_geometry(L, n_fft, width)
    )
