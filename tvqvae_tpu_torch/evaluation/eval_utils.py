"""FID and Inception Score, and the outlier filter before FID.

Port of ``tvqvae_tpu/evaluation/eval_utils.py``: host float64 numpy on
feature arrays the extractors made on the card; scipy is imported inside
the functions that use it. ``remove_outliers`` filters with the port's own
isolation forest (``isolation_forest.py``), the card's machine having no
scikit-learn.
"""

from typing import Tuple

import numpy as np

from tvqvae_tpu_torch.evaluation.isolation_forest import IsolationForest


def calculate_inception_score(
    p_yx: np.ndarray, n_split: int = 10, shuffle: bool = True,
    eps: float = 1e-16, seed=None,
) -> Tuple[float, float]:
    """KL-based IS over softmax class posteriors (the "Inception" net is the
    supervised FCN). ``seed=None`` shuffles differently on every call, as
    the JAX package's ``Metrics.inception_score`` does. The shuffle works
    on a copy (JAX's shuffles a float64 caller's array in place)."""
    p = np.array(p_yx, np.float64)
    if shuffle:
        np.random.RandomState(seed).shuffle(p)
    scores = []
    n_part = int(np.floor(p.shape[0] / n_split))
    for i in range(n_split):
        part = p[i * n_part:(i + 1) * n_part]
        p_y = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + eps) - np.log(p_y + eps))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def calculate_fid(z1: np.ndarray, z2: np.ndarray, method: str = "schur") -> float:
    """Frechet distance between the feature Gaussians of ``z1`` and ``z2``.

    ``"schur"`` is the reference's: the real part of tr sqrtm(S1 S2) from
    the Schur decomposition of the dense S1 S2. The trace of a primary
    matrix square root is the sum of the principal square roots of the
    Schur form's diagonal, so this takes that sum (``scipy.linalg.schur``,
    complex) where the JAX package takes the trace of ``scipy.linalg.sqrtm``:
    the same number (against scipy 1.17's ``sqrtm``, within 1e-13 relative
    when n > D and 2e-8 when n < D, the zero modes' rounding), and finite
    where scipy 1.18's ``sqrtm`` returns NaN for the singular product that
    n < D gives (the quality run's 2000-wide ROCKET features).
    ``"svd"`` computes the same quantity through tr sqrtm(S1 S2) = sum
    svdvals(X1c X2c^T) / sqrt((n1-1)(n2-1)), one (n1, n2) SVD instead of a
    (D, D) Schur decomposition. They agree to ~1e-12 when n > D; below that,
    Schur's O(sqrt(eps)) zero-mode roots understate FID and ``"svd"`` is
    exact (the JAX package's docstring has the measurements)."""
    z1 = np.asarray(z1, np.float64)
    z2 = np.asarray(z2, np.float64)
    mu1, mu2 = z1.mean(axis=0), z2.mean(axis=0)
    ssdiff = float(((mu1 - mu2) ** 2).sum())
    if method == "svd":
        x1 = z1 - mu1
        x2 = z2 - mu2
        n1, n2 = z1.shape[0], z2.shape[0]
        tr_s1 = float((x1 * x1).sum()) / (n1 - 1)
        tr_s2 = float((x2 * x2).sum()) / (n2 - 1)
        c = x1.dot(x2.T) / np.sqrt((n1 - 1.0) * (n2 - 1.0))
        tr_sqrt = float(np.linalg.svd(c, compute_uv=False).sum())
        return ssdiff + tr_s1 + tr_s2 - 2.0 * tr_sqrt
    if method != "schur":
        raise ValueError(method)
    from scipy.linalg import schur

    s1 = np.cov(z1, rowvar=False)
    s2 = np.cov(z2, rowvar=False)
    t = schur(s1.dot(s2), output="complex")[0]
    tr_sqrt = float(np.sqrt(np.diag(t)).real.sum())
    return ssdiff + float(np.trace(s1) + np.trace(s2)) - 2.0 * tr_sqrt


def remove_outliers(z: np.ndarray) -> np.ndarray:
    """The rows of ``z`` an isolation forest (100 trees, ``max_samples=0.9``,
    ``contamination=0.1``, ``random_state=0``) keeps as inliers."""
    z = np.asarray(z)
    keep = IsolationForest().fit_predict(z) == 1
    return z[keep]
