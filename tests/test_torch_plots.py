"""Port parity: the figures (``utils/plots.py``) and the embeddings under
them (``utils/embedding.py``), on the CPU.

- PCA against scikit-learn's ``PCA(n_components=2, random_state=0)``: the
  coordinates within 1e-5 of their scale (scikit-learn runs float32 and, at
  2000 features, its randomized solver; the port an exact float64 SVD);
- t-SNE: the perplexity search's conditional probabilities and the exact
  method's KL divergence and gradient against scikit-learn's own functions
  (1e-6, float32 distances against float64); on ~120 points of 4 clusters,
  the KL divergence within 10% of scikit-learn's default (Barnes-Hut)
  ``kl_divergence_`` and the trustworthiness (k=5) within 0.02 of its
  embedding's; ``trustworthiness`` equal to scikit-learn's on one embedding;
- every figure function against the JAX package's of the same name on the
  same input: the drawn data (line and scatter coordinates, fill polygons,
  bar heights, image arrays, texts and titles) equal, PCA's within 1e-5 of
  scale; the t-SNE figure's point counts per set (its embedding is not
  scikit-learn's point for point);
- the data functions import no matplotlib.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sklearn.decomposition import PCA as SkPCA
from sklearn.manifold import TSNE as SkTSNE
from sklearn.manifold import _t_sne as sk_tsne
from sklearn.manifold import _utils as sk_utils
from sklearn.manifold import trustworthiness as sk_trustworthiness

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from tvqvae_tpu.utils import plots as jplots  # noqa: E402
from tvqvae_tpu_torch.utils import embedding, plots  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clusters(n, d, seed, k=4, spread=3.0):
    rng = np.random.default_rng(seed)
    centres = spread * rng.normal(size=(k, d))
    return (centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# the embeddings against scikit-learn


@pytest.mark.parametrize("n, d", [(120, 50), (300, 2000)])
def test_pca_matches_sklearn(n, d):
    X = _clusters(n, d, 0)
    Y = _clusters(n // 2, d, 1)
    sk = SkPCA(n_components=2, random_state=0).fit(X)
    ours = embedding.PCA(device="cpu").fit(X)
    for a, b in ((ours.transform(X), sk.transform(X)), (ours.transform(Y), sk.transform(Y))):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-5)


def test_binary_search_perplexity_matches_sklearn():
    X = _clusters(90, 20, 2)
    D = ((X[:, None] - X[None]) ** 2).sum(-1).astype(np.float32)
    want = sk_utils._binary_search_perplexity(D, 22.0, 0)
    got = embedding.binary_search_perplexity(torch.from_numpy(D).double(), 22.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # each row's perplexity is the one asked for
    H = -(got * np.log(np.where(got > 0, got, 1.0))).sum(1)
    np.testing.assert_allclose(np.exp(H), 22.0, rtol=1e-4)


def test_kl_divergence_and_gradient_match_sklearn_exact():
    from scipy.spatial.distance import squareform

    X = _clusters(60, 10, 3)
    n = len(X)
    D = torch.from_numpy(((X[:, None] - X[None]) ** 2).sum(-1)).double()
    P = embedding.joint_probabilities(D, 15.0)
    Y = np.random.default_rng(4).normal(size=(n, 2))
    kl, grad = embedding._kl_and_grad(P, torch.from_numpy(Y), True)
    P_condensed = squareform(P.numpy(), checks=False)
    want_kl, want_grad = sk_tsne._kl_divergence(Y.ravel(), P_condensed, 1, n, 2)
    np.testing.assert_allclose(float(kl), want_kl, rtol=1e-10)
    np.testing.assert_allclose(grad.numpy().ravel(), want_grad, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(P_condensed.sum(), 0.5, rtol=1e-12)


@pytest.fixture(scope="module")
def tsne_pair():
    X = _clusters(120, 30, 5, spread=2.0)
    perplexity = min(30, max(2, len(X) // 4))
    sk = SkTSNE(n_components=2, random_state=0, init="random", perplexity=perplexity)
    sk_emb = sk.fit_transform(X)
    ours = embedding.TSNE(perplexity=perplexity, device="cpu")
    emb = ours.fit_transform(X)
    return X, sk, sk_emb, ours, emb


def test_tsne_kl_divergence_within_ten_percent_of_sklearn(tsne_pair):
    _, sk, _, ours, emb = tsne_pair
    assert emb.shape == (120, 2) and np.isfinite(emb).all()
    assert abs(ours.kl_divergence_ - sk.kl_divergence_) <= 0.1 * sk.kl_divergence_, \
        (ours.kl_divergence_, sk.kl_divergence_)
    assert ours.n_iter_ == sk.n_iter_ == 999


def test_tsne_trustworthiness_within_two_hundredths_of_sklearn(tsne_pair):
    X, _, sk_emb, _, emb = tsne_pair
    ref = sk_trustworthiness(X, sk_emb, n_neighbors=5)
    assert abs(embedding.trustworthiness(X, emb, 5, device="cpu") - ref) <= 0.02
    np.testing.assert_allclose(embedding.trustworthiness(X, sk_emb, 5, device="cpu"), ref,
                               rtol=1e-12)


def test_tsne_starts_from_sklearns_draw(monkeypatch):
    """The first phase starts from ``1e-4 * RandomState(0).standard_normal``."""
    seen = []
    real = embedding._kl_and_grad

    def spy(P, Y, compute_error):
        if not seen:
            seen.append(Y.numpy().copy())
        return real(P, Y, compute_error)

    monkeypatch.setattr(embedding, "_kl_and_grad", spy)
    monkeypatch.setattr(embedding, "EXPLORATION_ITERS", 1)
    monkeypatch.setattr(embedding, "MAX_ITERS", 2)
    embedding.TSNE(perplexity=5, device="cpu").fit_transform(_clusters(20, 4, 6))
    want = 1e-4 * np.random.RandomState(0).standard_normal(size=(20, 2)).astype(np.float32)
    np.testing.assert_array_equal(seen[0], want.astype(np.float64))


# ---------------------------------------------------------------------------
# the figures against the JAX package's


def _figure_data(fig):
    """What a figure draws: per axes its title, texts, line coordinates,
    collections (offsets, colour arrays, sizes, fill polygons), bar heights
    and image arrays."""
    out = [("suptitle", fig._suptitle.get_text() if fig._suptitle else "")]
    for i, ax in enumerate(fig.axes):
        out.append((f"{i}/title", ax.get_title()))
        out.append((f"{i}/texts", [t.get_text() for t in ax.texts]))
        for j, line in enumerate(ax.lines):
            out.append((f"{i}/line{j}", np.asarray(line.get_xydata(), float)))
        for j, c in enumerate(ax.collections):
            out.append((f"{i}/coll{j}/offsets", np.asarray(c.get_offsets(), float)))
            arr = c.get_array()
            if arr is not None:
                out.append((f"{i}/coll{j}/array", np.asarray(arr, float)))
            if hasattr(c, "get_sizes"):
                out.append((f"{i}/coll{j}/sizes", np.asarray(c.get_sizes(), float)))
            if type(c).__name__ in ("PolyCollection", "FillBetweenPolyCollection"):
                out.append((f"{i}/coll{j}/paths",
                            [np.asarray(p.vertices, float) for p in c.get_paths()]))
        out.append((f"{i}/bars", np.asarray([[p.get_x(), p.get_width(), p.get_height()]
                                             for p in ax.patches
                                             if type(p).__name__ == "Rectangle"], float)))
        for j, im in enumerate(ax.images):
            out.append((f"{i}/image{j}", np.asarray(im.get_array(), float)))
    return out


def _assert_same_figure(fig, ref, rtol=1e-12, scale_of=None):
    a, b = _figure_data(fig), _figure_data(ref)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        if isinstance(y, str) or (isinstance(y, list) and y and isinstance(y[0], str)):
            assert x == y, k
        elif isinstance(y, list):
            assert len(x) == len(y), k
            for u, v in zip(x, y):
                np.testing.assert_allclose(u, v, rtol=rtol, atol=0, err_msg=k)
        else:
            assert np.shape(x) == np.shape(y), k
            if scale_of is not None and scale_of(k):
                s = max(np.abs(y).max(), 1e-30)
                np.testing.assert_allclose(x / s, y / s, rtol=0, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=k)
    plt.close(fig)
    plt.close(ref)


def _tracks(n=24, L=64, seed=0):
    """(n, 4, L) lat/lon/alt/timedelta tracks in degree and feet ranges, with
    3 classes."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, L)
    X = np.stack([48.0 + 3 * t[None] + 0.2 * rng.normal(size=(n, 1)),
                  6.0 + 2 * t[None] * rng.uniform(0.5, 1.5, (n, 1)),
                  10000.0 * np.sin(np.pi * t)[None] * rng.uniform(0.8, 1.2, (n, 1)),
                  np.cumsum(rng.uniform(5, 15, (n, L)), 1)], 1).astype(np.float32)
    return X, rng.integers(0, 3, n)


def _series(seed, shape=(6, 3, 40)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _distances(n=25, seed=1):
    rng = np.random.default_rng(seed)
    keys = ["SSPD Euclidean", "SSPD Spherical", "DTW Euclidean", "DTW Spherical",
            "Discrete Frechet", "Frechet"]
    return {k: rng.random(n).tolist() for k in keys}, keys


FIGURES = {
    "plot_reconstruction": lambda m: m.plot_reconstruction(
        _series(1), _series(2), _series(3), _series(4), 2, 1, 7),
    "plot_generated": lambda m: m.plot_generated(_series(1), _series(2), _series(3), 1, 2, 5,
                                                 "t"),
    "plot_visual_inspection": lambda m: m.plot_visual_inspection(_series(1, (40, 3, 30)),
                                                                 _series(2, (12, 3, 30)), 30),
    "plot_trajectories": lambda m: m.plot_trajectories(_tracks()[0], 0, 1, title="t"),
    "plot_trajectories_labels": lambda m: m.plot_trajectories(
        _tracks()[0], 0, 1, labels=_tracks()[1],
        airports={"EHAM": (52.3, 4.8), "LIMC": (45.6, 8.7)}),
    "plot_clustering": lambda m: m.plot_clustering(_tracks()[0], _tracks()[1], 0, 1),
    "plot_altitude": lambda m: m.plot_altitude(_tracks()[0], 2),
    "plot_altitude_map": lambda m: m.plot_altitude_map(_tracks()[0], 0, 1, 2),
    "plot_timeseries_ci": lambda m: m.plot_timeseries_ci(
        _tracks(30, seed=2)[0], _tracks(20, seed=3)[0], ["lat", "lon", "alt", "td"]),
    "plot_distributions": lambda m: m.plot_distributions(
        _tracks(30, seed=2)[0], _tracks(20, seed=3)[0], None, bins=40),
    "plot_metric_correlation_heatmap": lambda m: m.plot_metric_correlation_heatmap(
        *_distances(), "c"),
    "plot_metric_percentiles": lambda m: m.plot_metric_percentiles(*_distances(), "p"),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_draws_what_jax_draws(name):
    _assert_same_figure(FIGURES[name](plots), FIGURES[name](jplots))


def test_pca_figure_draws_what_jax_draws():
    z = [_clusters(70, 40, 7), _clusters(50, 40, 8)]
    ours = plots.plot_pca(z, ["a", "b"], n=64, device="cpu")
    _assert_same_figure(ours, jplots.plot_pca(z, ["a", "b"], n=64),
                        scale_of=lambda k: k.endswith("offsets"))


def test_tsne_figure_draws_the_sets_jax_draws():
    z = [_clusters(70, 40, 7), _clusters(50, 40, 8)]
    ours = plots.plot_tsne(z, ["a", "b"], n=64, device="cpu")
    ref = jplots.plot_tsne(z, ["a", "b"], n=64)
    a, b = ours.axes[0].collections, ref.axes[0].collections
    assert [len(c.get_offsets()) for c in a] == [len(c.get_offsets()) for c in b] == [64, 50]
    assert all(np.isfinite(np.asarray(c.get_offsets())).all() for c in a)
    assert [t.get_text() for t in ours.axes[0].get_legend().get_texts()] == ["a", "b"]
    plt.close(ours)
    plt.close(ref)


def test_tsne_data_draws_each_set_with_one_random_state():
    """The joint embedding's rows: every set drawn in turn from one
    ``RandomState(0)``, as the JAX function draws them."""
    z = [_clusters(30, 5, 9), _clusters(20, 5, 10)]
    seen = []
    real = embedding.TSNE.fit_transform

    def spy(self, X):
        seen.append(np.asarray(X))
        return real(self, X)

    mp = pytest.MonkeyPatch()
    mp.setattr(embedding.TSNE, "fit_transform", spy)
    mp.setattr(embedding, "MAX_ITERS", 260)
    try:
        data = plots.tsne_data(z, ["a", "b"], n=16, device="cpu")
    finally:
        mp.undo()
    rng = np.random.RandomState(0)
    want = np.concatenate([zz[rng.choice(len(zz), size=16, replace=True)] for zz in z])
    np.testing.assert_array_equal(seen[0], want)
    assert [len(e) for _, e in data["sets"]] == [16, 16]
    assert np.isfinite(data["kl_divergence"]) and 0.0 < data["trustworthiness"] <= 1.0


def test_geographic_extent_matches_jax():
    X = _tracks()[0]
    assert plots.geographic_extent(X, 0, 1, 0.5) == jplots.geographic_extent(X, 0, 1, 0.5)


def test_data_functions_import_no_matplotlib():
    code = (
        "import sys, numpy as np\n"
        "from tvqvae_tpu_torch.utils import plots\n"
        "X = np.random.default_rng(0).normal(size=(30, 4, 20)).astype(np.float32)\n"
        "plots.timeseries_ci_data(X, X[:10]); plots.distributions_data(X, X[:10])\n"
        "plots.altitude_map_data(X); plots.pca_data([X[:, 0], X[:10, 0]], ['a', 'b'], "
        "device='cpu')\n"
        "plots.tsne_data([X[:, 0], X[:10, 0]], ['a', 'b'], device='cpu')\n"
        "d = {k: list(np.arange(5.0) * (i + 1) % 3) for i, k in enumerate('abc')}\n"
        "plots.metric_correlation(d, list('abc')); plots.metric_percentiles(d, list('abc'))\n"
        "assert not any(m.split('.')[0] == 'matplotlib' for m in sys.modules), 'matplotlib'\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
