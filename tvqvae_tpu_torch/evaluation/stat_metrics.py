"""TSGBench statistical metrics, host numpy and scipy.

Port of ``tvqvae_tpu/evaluation/stat_metrics.py``: MDD is the mean
absolute difference of the two Gaussian KDEs on a 100-point grid; ACD
compares the mean positive-lag autocorrelations of channel 0 (through the
FFT, equal to ``np.correlate(x, x, "full")[L-1:]``); SD and KD compare the
skewness and the kurtosis of all values. scipy is imported inside the
functions.
"""

import numpy as np


def marginal_distribution_difference(real: np.ndarray, gen: np.ndarray) -> float:
    from scipy.stats import gaussian_kde

    rv = np.asarray(real, np.float64).reshape(-1)
    gv = np.asarray(gen, np.float64).reshape(-1)
    real_kde = gaussian_kde(rv)
    gen_kde = gaussian_kde(gv)
    grid = np.linspace(min(rv.min(), gv.min()), max(rv.max(), gv.max()), 100)
    return float(np.mean(np.abs(real_kde(grid) - gen_kde(grid))))


def _autocorr_fft(x: np.ndarray) -> np.ndarray:
    """Positive-lag autocorrelation == np.correlate(x, x, 'full')[L-1:]."""
    L = x.shape[-1]
    n = 1 << (2 * L - 1).bit_length()
    f = np.fft.rfft(x, n=n, axis=-1)
    return np.fft.irfft(f * np.conj(f), n=n, axis=-1)[..., :L]


def auto_correlation_difference(real: np.ndarray, gen: np.ndarray) -> float:
    """Channel 0 only, as the reference."""
    r = _autocorr_fft(np.asarray(real, np.float64)[:, 0, :]).mean(axis=0)
    g = _autocorr_fft(np.asarray(gen, np.float64)[:, 0, :]).mean(axis=0)
    return float(np.mean(np.abs(r - g)))


def skewness_difference(real: np.ndarray, gen: np.ndarray) -> float:
    from scipy.stats import skew

    return float(np.abs(skew(np.asarray(real).reshape(-1)) - skew(np.asarray(gen).reshape(-1))))


def kurtosis_difference(real: np.ndarray, gen: np.ndarray) -> float:
    from scipy.stats import kurtosis

    return float(np.abs(kurtosis(np.asarray(real).reshape(-1))
                        - kurtosis(np.asarray(gen).reshape(-1))))
