"""The port's scaler, k-means and Gaussian mixture
(``tvqvae_tpu_torch/data/mixture.py``) against scikit-learn 1.9 on the CPU.

The port never imports scikit-learn; this test does, as the reference. On
seeded corridor features (``chip_smoke.corridor_features``: flights along a
few routes, interleaved as ``prepare_trajectories`` builds them), with
separated and with partly overlapping corridors:
  - the scaler's output within 1e-12 plus n * eps of each column's
    magnitude (the sums' order differs);
  - the k-means++ centre indices, the Lloyd labels and ``n_iter_`` exactly;
    one Lloyd M-step with an empty cluster as scikit-learn's Cython step;
  - the mixture's labels and ``n_iter_`` exactly; ``weights_``, ``means_``
    and ``covariances_`` within 1e-8 relative (to each array's largest
    magnitude), ``lower_bound_`` within 1e-10 relative.
The geometry ``prepare_trajectories`` meets, more features than flights and
constant first and last points, is one of the cases.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SkKMeans
from sklearn.cluster import kmeans_plusplus as sk_kmeans_plusplus
from sklearn.cluster._k_means_lloyd import lloyd_iter_chunked_dense
from sklearn.mixture import GaussianMixture as SkGaussianMixture
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from chip_smoke import corridor_features
from tvqvae_tpu_torch.data import mixture

SEED = 199


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "separated": dict(n=300, points=10, k=5, spread=0.2, seed=0, pinned_ends=True),
    "overlapping": dict(n=400, points=6, k=4, spread=2.5, seed=1),
    "more_features_than_flights": dict(n=40, points=30, k=3, spread=0.5, seed=2,
                                       pinned_ends=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = dict(CASES[request.param])
    k = kw.pop("k")
    F, corridor = corridor_features(k=k, **kw)
    return request.param, SkStandardScaler().fit_transform(F), F, corridor, k


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def test_scaler_matches_sklearn(case):
    _, Fs, F, _, _ = case
    scaler = mixture.StandardScaler(device="cpu")
    ref = SkStandardScaler().fit(F)
    # the two sum n values in other orders: each mean is off by up to
    # n * eps * max|x|, which a constant column (scale 1) keeps as it is
    bound = 1e-12 + len(F) * np.finfo(np.float64).eps * np.abs(F).max(0) / ref.scale_
    assert (np.abs(scaler.fit_transform(F).numpy() - Fs) <= bound).all()
    np.testing.assert_array_equal(scaler.scale_.numpy() == 1.0, ref.scale_ == 1.0)


def test_kmeans_plusplus_picks_sklearns_centres(case):
    _, Fs, _, _, k = case
    _, want = sk_kmeans_plusplus(Fs, k, random_state=np.random.RandomState(SEED))
    centres, got = mixture.kmeans_plusplus(torch.from_numpy(Fs), k, np.random.RandomState(SEED))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(centres.numpy(), Fs[want])


def test_lloyd_matches_sklearn(case):
    _, Fs, _, _, k = case
    ref = SkKMeans(k, n_init=1, random_state=np.random.RandomState(SEED)).fit(Fs)
    got = mixture.KMeans(k, random_state=np.random.RandomState(SEED), device="cpu").fit(Fs)
    np.testing.assert_array_equal(got.labels_.numpy(), ref.labels_)
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(got.cluster_centers_.numpy(), ref.cluster_centers_, rtol=0,
                               atol=1e-12 * np.abs(ref.cluster_centers_).max())
    assert got.inertia_ == pytest.approx(ref.inertia_, rel=1e-12)


def test_lloyd_m_step_relocates_an_empty_cluster_as_sklearn():
    """A centre far from every point gets none; scikit-learn moves it to the
    point farthest from its own centre, and so does the port."""
    F, _ = corridor_features(60, 4, 3, 0.5, seed=3)
    X = F - F.mean(0)
    centers = np.stack([X[0], X[1], X[2], X[0] + 1e4])
    new, weight = np.zeros_like(centers), np.zeros(4)
    labels, shift = np.full(60, -1, np.int32), np.zeros(4)
    lloyd_iter_chunked_dense(X, np.ones(60), centers, new, weight, labels, shift, 1)
    km = mixture.KMeans(4, device="cpu")
    got_labels = mixture._assign(torch.from_numpy(X), torch.from_numpy(centers))
    assert (got_labels.numpy() == 3).sum() == 0
    got, got_shift = km._m_step(torch.from_numpy(X), got_labels, torch.from_numpy(centers))
    np.testing.assert_allclose(got.numpy(), new, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_shift.numpy(), shift, rtol=1e-12)


def test_gaussian_mixture_matches_sklearn(case):
    name, Fs, _, corridor, k = case
    ref = SkGaussianMixture(k, random_state=SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a ConvergenceWarning where max_iter is reached
        want = ref.fit_predict(Fs)
        gmm = mixture.GaussianMixture(k, random_state=SEED, device="cpu")
        got = gmm.fit_predict(Fs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert gmm.n_iter_ == ref.n_iter_ and gmm.converged_ == ref.converged_
    for attr in ("weights_", "means_", "covariances_"):
        assert _rel(getattr(gmm, attr).numpy(), getattr(ref, attr)) <= 1e-8, attr
    assert abs(gmm.lower_bound_ - ref.lower_bound_) <= 1e-10 * abs(ref.lower_bound_)
    if name == "separated":  # the clusters are the corridors
        assert len(set(zip(got, corridor))) == k
    if name == "overlapping":
        assert gmm.n_iter_ > 2  # soft responsibilities: EM does more than settle


def test_mixture_refuses_too_few_samples():
    with pytest.raises(ValueError, match="n_samples >= n_components"):
        mixture.GaussianMixture(5, device="cpu").fit_predict(np.zeros((3, 2)))
