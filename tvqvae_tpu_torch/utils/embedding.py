"""PCA, t-SNE and trustworthiness in float64 torch on an explicit device:
the embeddings the figures draw (``utils/plots.py``).

The JAX package calls scikit-learn on the host (``PCA(n_components=2,
random_state=0)`` and ``TSNE(n_components=2, random_state=0,
init="random", perplexity=...)``); the card's machine has no scikit-learn,
so the port computes the same things itself, written after scikit-learn 1.9
(``sklearn/decomposition/_pca.py``, ``sklearn/manifold/_t_sne.py``,
``_utils.pyx``):

- ``PCA``: the centred data's SVD, signs by ``svd_flip(u_based_decision=
  False)`` (each component's largest-magnitude loading positive), so the
  coordinates are scikit-learn's;
- ``TSNE``: conditional probabilities by the per-row binary search for the
  perplexity (100 steps, entropy tolerance 1e-5), symmetrised and
  normalised; the initial embedding ``1e-4 * standard_normal`` drawn from
  ``RandomState(0)`` on the host as scikit-learn draws it; 250
  iterations with P exaggerated 12 times at momentum 0.5, then up to 1000
  in all at momentum 0.8, each phase restarting the update and the gains
  (+0.2 where the step turned, x0.8 elsewhere, at least 0.01), learning rate
  ``max(n / 12 / 4, 50)``, a convergence check every 50 iterations (no
  progress for 250, then 300, checks' worth, or a gradient norm below
  1e-7). scikit-learn's default method is Barnes-Hut over 3 * perplexity
  neighbours; this one takes the exact gradient over all pairs, which at
  the figures' N <= 1024 costs one (N, N) product an iteration. So the
  embeddings differ point for point; their KL divergence and
  trustworthiness are held to scikit-learn's;
- ``trustworthiness``: scikit-learn's, by the ranks of each point's
  embedding neighbours among its input neighbours.

The host reads back only the error and gradient norm at each check.
"""

import numpy as np
import torch

from tvqvae_tpu_torch.utils.device import resolve_device

N_COMPONENTS, RANDOM_STATE = 2, 0  # the figures' PCA(2) and TSNE(2, random_state=0)
MACHINE_EPSILON = float(np.finfo(np.double).eps)
PERPLEXITY_TOL, PERPLEXITY_STEPS = 1e-5, 100
EARLY_EXAGGERATION, EXPLORATION_ITERS, MAX_ITERS = 12.0, 250, 1000
N_ITER_WITHOUT_PROGRESS, N_ITER_CHECK, MIN_GRAD_NORM, MIN_GAIN = 300, 50, 1e-7, 0.01


def _as_f64(X, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(X), device=dev).to(torch.float64)


def _sq_distances(X: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances, exact zeros on the diagonal."""
    sq = (X * X).sum(1)
    D = (sq[:, None] + sq[None, :] - 2.0 * X @ X.T).clamp_min_(0.0)
    D.fill_diagonal_(0.0)
    return D


class PCA:
    """The two principal components of the data ``fit`` is given;
    ``transform`` projects onto them. -> float64 numpy coordinates."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def fit(self, X) -> "PCA":
        X = _as_f64(X, self.device)
        self.mean_ = X.mean(0)
        Vt = torch.linalg.svd(X - self.mean_, full_matrices=False)[2][:N_COMPONENTS]
        # svd_flip(u_based_decision=False): each row's largest |loading| positive
        signs = torch.sign(Vt.gather(1, Vt.abs().argmax(1, keepdim=True)))
        self.components_ = Vt * signs
        return self

    def transform(self, X) -> np.ndarray:
        X = _as_f64(X, self.device)
        return ((X - self.mean_) @ self.components_.T).cpu().numpy()

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)


def binary_search_perplexity(D: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Conditional probabilities p(j|i) from squared distances ``D`` (N, N),
    each row's Gaussian precision found by scikit-learn's bisection on the
    entropy (all rows at once; a row stops moving once within tolerance)."""
    n = D.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=D.device)
    beta = torch.ones(n, dtype=D.dtype, device=D.device)
    lo = torch.full_like(beta, -float("inf"))
    hi = torch.full_like(beta, float("inf"))
    active = torch.ones(n, dtype=torch.bool, device=D.device)
    target = float(np.log(perplexity))
    for _ in range(PERPLEXITY_STEPS):
        P = torch.exp(-D * beta[:, None]) * off
        s = P.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        P = P / s[:, None]
        diff = torch.log(s) + beta * (D * P).sum(1) - target
        active &= diff.abs() > PERPLEXITY_TOL
        if not bool(active.any()):
            break
        up = active & (diff > 0.0)
        down = active & (diff <= 0.0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0), beta)
        beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0),
                           beta)
    return P


def joint_probabilities(D: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Symmetrised p_ij (N, N), summing to 1 over i != j, floored at the
    machine epsilon off the diagonal, 0 on it."""
    P = binary_search_perplexity(D, perplexity)
    P = P + P.T
    P = torch.clamp_min(P / torch.clamp_min(P.sum(), MACHINE_EPSILON), MACHINE_EPSILON)
    return P.fill_diagonal_(0.0)


def _kl_and_grad(P: torch.Tensor, Y: torch.Tensor, compute_error: bool):
    """Student-t (one degree of freedom) Q, KL(P || Q) over i != j and its
    gradient in Y."""
    W = 1.0 / (1.0 + _sq_distances(Y))
    W.fill_diagonal_(0.0)
    Q = torch.clamp_min(W / W.sum(), MACHINE_EPSILON)
    kl = None
    if compute_error:
        off = ~torch.eye(P.shape[0], dtype=torch.bool, device=P.device)
        kl = (P * torch.log(torch.clamp_min(P, MACHINE_EPSILON) / Q))[off].sum()
    PQd = (P - Q) * W
    PQd.fill_diagonal_(0.0)
    grad = 4.0 * (PQd.sum(1, keepdim=True) * Y - PQd @ Y)
    return kl, grad


class TSNE:
    """Two-dimensional t-SNE with scikit-learn's defaults, ``init="random"``,
    ``random_state=0`` and the exact gradient. After ``fit_transform``:
    ``kl_divergence_``, ``n_iter_``."""

    def __init__(self, perplexity: float = 30.0, device="cuda"):
        self.perplexity = perplexity
        self.device = resolve_device(device)

    def _descend(self, P, Y, it, max_iter, momentum, lr, patience):
        update = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        error, best_error, best_iter = float("inf"), float("inf"), it
        i = it
        for i in range(it, max_iter):
            check = (i + 1) % N_ITER_CHECK == 0
            kl, grad = _kl_and_grad(P, Y, check or i == max_iter - 1)
            turned = update * grad < 0.0
            gains = torch.where(turned, gains + 0.2, gains * 0.8).clamp_min_(MIN_GAIN)
            grad = grad * gains
            update = momentum * update - lr * grad
            Y = Y + update
            if kl is not None:
                error = float(kl)
            if check:
                if error < best_error:
                    best_error, best_iter = error, i
                elif i - best_iter > patience:
                    break
                if float(torch.linalg.vector_norm(grad)) <= MIN_GRAD_NORM:
                    break
        return Y, error, i

    def fit_transform(self, X) -> np.ndarray:
        X = _as_f64(X, self.device)
        n = X.shape[0]
        P = joint_probabilities(_sq_distances(X), self.perplexity)
        lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
        y0 = 1e-4 * np.random.RandomState(RANDOM_STATE).standard_normal(
            size=(n, N_COMPONENTS)).astype(np.float32)
        Y = torch.as_tensor(y0, device=self.device).to(torch.float64)
        Y, _, it = self._descend(P * EARLY_EXAGGERATION, Y, 0, EXPLORATION_ITERS, 0.5, lr,
                                 EXPLORATION_ITERS)
        Y, kl, it = self._descend(P, Y, it + 1, MAX_ITERS, 0.8, lr, N_ITER_WITHOUT_PROGRESS)
        self.kl_divergence_, self.n_iter_ = kl, it
        return Y.cpu().numpy()


def trustworthiness(X, X_embedded, n_neighbors: int = 5, device="cuda") -> float:
    """How far each point's ``n_neighbors`` nearest neighbours in the
    embedding lie down its neighbour ranking in the input: 1 when they are
    its nearest there too (scikit-learn's ``trustworthiness``)."""
    dev = resolve_device(device)
    X, E = _as_f64(X, dev), _as_f64(X_embedded, dev)
    n = X.shape[0]
    k = n_neighbors
    DX = _sq_distances(X).fill_diagonal_(float("inf"))
    DE = _sq_distances(E).fill_diagonal_(float("inf"))
    order = torch.argsort(DX, dim=1)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(1, n + 1, device=dev).expand(n, n).contiguous())
    nn_e = torch.topk(DE, k, dim=1, largest=False).indices
    ranks = rank.gather(1, nn_e) - k
    t = float(ranks[ranks > 0].sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
