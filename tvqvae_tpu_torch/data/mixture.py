"""Standardisation, k-means and full-covariance Gaussian mixtures in float64
torch on an explicit device: what ``prepare_trajectories`` clusters with.

scikit-learn's algorithms at the settings the JAX package calls them with
(``StandardScaler().fit_transform``, then
``GaussianMixture(n_components, random_state=seed).fit_predict``), written
after scikit-learn 1.9 (``sklearn/preprocessing/_data.py``,
``sklearn/cluster/_kmeans.py``, ``sklearn/mixture/_base.py`` and
``_gaussian_mixture.py``):

- ``StandardScaler``: the corrected two-pass variance (ddof 0), and scale 1
  for the features whose variance cannot be told from a constant's;
- ``kmeans_plusplus``: the first centre drawn by ``choice(n, p=w/sum w)``,
  then ``2 + int(log k)`` candidates a centre from ``uniform * potential``
  searched in the cumulative sum of the closest squared distances, the one
  that lowers the potential most kept;
- ``KMeans``: the data centred by its mean, one k-means++ init, Lloyd
  iterations (labels by the smallest ``|c|^2 - 2 x.c``, the first on ties;
  empty clusters moved to the farthest points) until the labels repeat or
  the centres move less than KMEANS_TOL times the mean feature variance;
- ``GaussianMixture``: full covariances, responsibilities initialised from
  one ``KMeans`` on the same random state, EM until the mean
  log-likelihood changes by less than GMM_TOL, then a final E-step whose
  argmax is the label.

The random draws are numpy's ``RandomState``, on the host, in scikit-learn's
order, so on the same input the centres, labels and iteration counts are
scikit-learn's. The distances, products and factorisations run on the
device; the host reads back only the few numbers that steer a draw or a
stop.
"""

import math
import time
import warnings
from typing import Tuple, Union

import numpy as np
import torch

from tvqvae_tpu_torch.utils.device import resolve_device

EPS = float(np.finfo(np.float64).eps)
# scikit-learn's defaults, the settings the JAX package clusters with
KMEANS_MAX_ITER, KMEANS_TOL = 300, 1e-4
GMM_TOL, GMM_REG_COVAR, GMM_MAX_ITER = 1e-3, 1e-6, 100
RandomStateLike = Union[None, int, np.random.RandomState]


def _check_random_state(seed: RandomStateLike) -> np.random.RandomState:
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def _as_tensor(X, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X,
                           dtype=torch.float64).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StandardScaler:
    """Zero mean, unit variance per feature (ddof 0); features whose variance
    is within the two-pass algorithm's error of a constant's keep scale 1."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def fit(self, X) -> "StandardScaler":
        X = _as_tensor(X, self.device)
        n = X.shape[0]
        self.mean_ = X.sum(0) / n
        temp = X - self.mean_
        correction = temp.sum(0)
        self.var_ = ((temp * temp).sum(0) - correction ** 2 / n) / n
        constant = self.var_ <= n * EPS * self.var_ + (n * self.mean_ * EPS) ** 2
        self.scale_ = torch.where(constant, torch.ones_like(self.var_), self.var_.sqrt())
        return self

    def transform(self, X) -> torch.Tensor:
        return (_as_tensor(X, self.device) - self.mean_) / self.scale_

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)


def _sq_distances(Y: torch.Tensor, X: torch.Tensor, x_sq: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (len(Y), len(X)) as scikit-learn's
    ``_euclidean_distances(Y, X, Y_norm_squared=x_sq, squared=True)``."""
    d = -2.0 * (Y @ X.T)
    d += (Y * Y).sum(1)[:, None]
    d += x_sq[None, :]
    return d.clamp_(min=0.0)


def kmeans_plusplus(X: torch.Tensor, n_clusters: int,
                    random_state: RandomStateLike) -> Tuple[torch.Tensor, np.ndarray]:
    """k-means++ seeding of ``X`` (n, d) on its device, unit sample weights.
    -> (centres (n_clusters, d), their row indices in ``X``)."""
    rs = _check_random_state(random_state)
    n = X.shape[0]
    x_squared_norms = (X * X).sum(1)
    n_local_trials = 2 + int(np.log(n_clusters))
    weight = np.ones(n)
    indices = np.full(n_clusters, -1, dtype=int)
    indices[0] = rs.choice(n, p=weight / weight.sum())
    closest = _sq_distances(X[indices[:1]], X, x_squared_norms)[0]
    current_pot = float(closest.sum())
    for c in range(1, n_clusters):
        rand_vals = rs.uniform(size=n_local_trials) * current_pot
        candidates = np.searchsorted(np.cumsum(closest.cpu().numpy()), rand_vals)
        np.clip(candidates, None, n - 1, out=candidates)
        dist = torch.minimum(closest, _sq_distances(X[candidates], X, x_squared_norms))
        pots = dist.sum(1).cpu().numpy()
        best = int(np.argmin(pots))
        current_pot = float(pots[best])
        closest = dist[best]
        indices[c] = candidates[best]
    return X[indices].clone(), indices


def _assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Lloyd's E-step: each row's centre by the smallest ``|c|^2 - 2 x.c``
    (the first on ties)."""
    d = -2.0 * (X @ centers.T)
    d += (centers * centers).sum(1)[None, :]
    return d.argmin(1)


class KMeans:
    """Lloyd's k-means with one k-means++ init (scikit-learn's ``KMeans(
    n_clusters, n_init=1)`` with unit sample weights)."""

    def __init__(self, n_clusters: int, random_state: RandomStateLike = None, device="cuda"):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.device = resolve_device(device)

    def _m_step(self, X, labels, centers_old):
        """(new centres, their shift): each cluster's mean; an empty cluster
        takes the point farthest from its own centre (scikit-learn's
        ``_relocate_empty_clusters_dense``)."""
        k = self.n_clusters
        sums = torch.zeros_like(centers_old).index_add_(0, labels, X)
        weight = torch.bincount(labels, minlength=k).to(X.dtype).cpu().numpy()
        empty = np.flatnonzero(weight == 0)
        if len(empty):
            far_d = ((X - centers_old[labels]) ** 2).sum(1).cpu().numpy()
            if far_d.max() > 0:
                far = np.argpartition(far_d, -len(empty))[:-len(empty) - 1:-1]
                for new_id, idx in zip(empty, far):
                    old_id = int(labels[idx])
                    sums[old_id] -= X[idx]
                    sums[new_id] = X[idx]
                    weight[new_id] = 1.0
                    weight[old_id] -= 1.0
        filled = weight > 0
        inv = np.where(filled, 1.0 / np.where(filled, weight, 1.0), 0.0)
        centers = sums * torch.from_numpy(inv).to(X.device)[:, None]
        if not filled.all():  # only where no point lies off its centre
            centers[torch.from_numpy(~filled).to(X.device)] = centers[int(weight.argmax())]
        shift = ((centers - centers_old) ** 2).sum(1).sqrt()
        return centers, shift

    def fit(self, X) -> "KMeans":
        X = _as_tensor(X, self.device)
        rs = _check_random_state(self.random_state)
        tol = float(X.var(0, unbiased=False).mean()) * KMEANS_TOL
        X_mean = X.mean(0)
        X = X - X_mean  # more accurate distances
        centers, _ = kmeans_plusplus(X, self.n_clusters, rs)

        labels_old = None
        strict = False
        for i in range(KMEANS_MAX_ITER):
            labels = _assign(X, centers)
            centers, shift = self._m_step(X, labels, centers)
            if labels_old is not None and torch.equal(labels, labels_old):
                strict = True
                break
            if float((shift ** 2).sum()) <= tol:
                break
            labels_old = labels
        if not strict:  # labels that match the final centres
            labels = _assign(X, centers)
        self.inertia_ = float(((X - centers[labels]) ** 2).sum())
        self.labels_ = labels
        self.cluster_centers_ = centers + X_mean
        self.n_iter_ = i + 1
        return self


class GaussianMixture:
    """Full-covariance Gaussian mixture fitted by EM from a k-means
    initialisation (scikit-learn's ``GaussianMixture`` defaults: GMM_TOL,
    GMM_REG_COVAR, GMM_MAX_ITER, one init).

    After ``fit_predict``: ``weights_`` (K,), ``means_`` (K, d),
    ``covariances_`` and ``precisions_cholesky_`` (K, d, d) as tensors on
    the device; ``n_iter_``, ``lower_bound_`` (the mean log-likelihood),
    ``converged_``; and ``seconds_`` of the k-means initialisation and of the
    EM iterations with the final E-step."""

    def __init__(self, n_components: int, random_state: RandomStateLike = None, device="cuda"):
        self.n_components = n_components
        self.random_state = random_state
        self.device = resolve_device(device)

    def _estimate_parameters(self, X, resp):
        """(nk, means, covariances) of the responsibilities ``resp``."""
        nk = resp.sum(0) + 10 * EPS
        means = (resp.T @ X) / nk[:, None]
        d = X.shape[1]
        cov = torch.empty(self.n_components, d, d, dtype=X.dtype, device=X.device)
        for k in range(self.n_components):
            diff = X - means[k]
            cov[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
            cov[k].diagonal().add_(GMM_REG_COVAR)
        return nk, means, cov

    def _set_precisions(self, cov):
        """The precision Cholesky factors: (cholesky(cov)^-1)^T, upper
        triangular."""
        chol, info = torch.linalg.cholesky_ex(cov)
        if bool((info != 0).any()):
            raise ValueError(
                "Fitting the mixture model failed because some components have ill-defined "
                "empirical covariance (for instance caused by singleton or collapsed samples). "
                "Try to decrease the number of components, increase reg_covar, or scale the "
                "input data.")
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        self.precisions_cholesky_ = torch.linalg.solve_triangular(
            chol, eye.expand_as(cov), upper=False).mT
        self.covariances_ = cov

    def _e_step(self, X) -> Tuple[float, torch.Tensor]:
        """(mean log-likelihood, log responsibilities (n, K))."""
        n, d = X.shape
        prec = self.precisions_cholesky_
        log_det = prec.diagonal(dim1=-2, dim2=-1).log().sum(1)
        log_prob = torch.empty(n, self.n_components, dtype=X.dtype, device=X.device)
        for k in range(self.n_components):
            y = X @ prec[k] - self.means_[k] @ prec[k]
            log_prob[:, k] = (y * y).sum(1)
        weighted = -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det
        weighted += self.weights_.log()
        norm = torch.logsumexp(weighted, 1)
        return float(norm.mean()), weighted - norm[:, None]

    def fit_predict(self, X) -> np.ndarray:
        """Fit on ``X`` (n, d); -> the component of each row (int64)."""
        X = _as_tensor(X, self.device)
        n = X.shape[0]
        if n < self.n_components:
            raise ValueError(f"Expected n_samples >= n_components but got n_components = "
                             f"{self.n_components}, n_samples = {n}")
        rs = _check_random_state(self.random_state)
        t0 = time.perf_counter()
        labels = KMeans(self.n_components, random_state=rs, device=self.device).fit(X).labels_
        resp = torch.zeros(n, self.n_components, dtype=X.dtype, device=X.device)
        resp[torch.arange(n, device=X.device), labels] = 1.0
        _sync(self.device)
        t1 = time.perf_counter()

        nk, self.means_, cov = self._estimate_parameters(X, resp)
        self.weights_ = nk / n
        self._set_precisions(cov)
        lower_bound = -math.inf
        self.converged_ = False
        for n_iter in range(1, GMM_MAX_ITER + 1):
            prev = lower_bound
            lower_bound, log_resp = self._e_step(X)
            nk, self.means_, cov = self._estimate_parameters(X, log_resp.exp())
            self.weights_ = nk / nk.sum()
            self._set_precisions(cov)
            if abs(lower_bound - prev) < GMM_TOL:
                self.converged_ = True
                break
        if not self.converged_:
            warnings.warn("Best performing initialization did not converge. Try different "
                          "init parameters, or increase max_iter, tol, or check for "
                          "degenerate data.", RuntimeWarning)
        self.n_iter_ = n_iter
        self.lower_bound_ = lower_bound
        # a final E-step, so that the labels are those of the fitted model
        labels = self._e_step(X)[1].argmax(1).cpu().numpy().astype(np.int64)
        self.seconds_ = {"kmeans": t1 - t0, "em": time.perf_counter() - t1}
        return labels
