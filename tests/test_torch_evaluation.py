"""Port parity: the evaluation modules (isolation forest, FID/IS, TSGBench
statistics, ROCKET, MiniRocket and the ``Metrics`` engine).

The same numpy-seeded inputs go through the JAX package and the port, on
the CPU, at small sizes (L = 96-127, at most 100 ROCKET kernels, n <= 512).
Tolerances, each with its reason:

  - ``calculate_fid`` (both methods, no filter) to 1e-10 relative, IS with
    the same seed to 1e-12, MDD/ACD/SD/KD to 1e-12 relative: the same host
    float64 code;
  - the ROCKET bank bit-equal (the same ``RandomState`` draws); its features
    (float32 gathers) with the max within 1e-5, a PPV entry off by at most
    1/ol and in at most 0.1% of the entries (measured here: none off);
  - MiniRocket's dilations and kernels equal, its biases within 1e-5, and
    the sort-based quantiles above 2^24 elements against ``np.quantile``;
  - ``Metrics.z_train``/``z_test``: ROCKET as above, the FCN to 2e-4 (the
    FCN's tolerance in ``tests/test_torch_fcn.py``);
  - the isolation forest cannot draw sklearn's trees (its splitter has its
    own C stream), so it is held to sklearn's own spread across seeds:
    planted 8-sigma outliers all removed, the kept set's Jaccard index with
    sklearn's seed 0 no lower than sklearn's seeds 1-4 reach, and the FID
    through the port's filter within 1.5x sklearn's largest seed-to-seed
    FID difference of the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
from sklearn.ensemble import IsolationForest as SkIsolationForest
from sklearn.ensemble._iforest import _average_path_length

import tvqvae_tpu.evaluation as jev
from tvqvae_tpu.evaluation import rocket as jrocket
from tvqvae_tpu.evaluation import stat_metrics as jstat
from tvqvae_tpu.models.fcn import FCN as JFCN
import tvqvae_tpu_torch.evaluation as tev
from tvqvae_tpu_torch.evaluation import isolation_forest as tiso
from tvqvae_tpu_torch.evaluation import rocket as trocket
from tvqvae_tpu_torch.evaluation import stat_metrics as tstat

PPV_SHARE = 1e-3  # at most this share of the PPV entries may differ, each by <= 1/ol


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These shapes run as fast on one thread, and then the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_exports_every_name_of_the_jax_package():
    assert set(jev.__all__) <= set(tev.__all__)
    for name in jev.__all__:
        assert hasattr(tev, name), name


# ---------------------------------------------------------------------------
# FID, IS and the TSGBench statistics


@pytest.mark.parametrize("method", ["schur", "svd"])
@pytest.mark.parametrize("n1, n2, D", [(300, 200, 16), (40, 30, 100)])
def test_calculate_fid_matches_jax(method, n1, n2, D):
    rng = np.random.default_rng(D)
    z1 = rng.normal(size=(n1, D))
    z2 = 1.2 * rng.normal(size=(n2, D)) + 0.3
    want = jev.calculate_fid(z1, z2, method=method)
    np.testing.assert_allclose(tev.calculate_fid(z1, z2, method=method), want, rtol=1e-10)
    assert tev.calculate_fid(z1, z1, method="svd") < 1e-8


def test_calculate_fid_rejects_an_unknown_method():
    with pytest.raises(ValueError):
        tev.calculate_fid(np.zeros((4, 2)), np.zeros((4, 2)), method="cholesky")


@pytest.mark.parametrize("n_split", [5, 10])
def test_inception_score_matches_jax_with_the_same_seed(n_split):
    logits = np.random.default_rng(n_split).normal(size=(200, 5)) * 3
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    got = tev.calculate_inception_score(p, n_split=n_split, seed=3)
    want = jev.calculate_inception_score(p.copy(), n_split=n_split, seed=3)  # shuffles in place
    np.testing.assert_allclose(got, want, rtol=1e-12)
    confident = np.eye(4)[np.tile(np.arange(4), 25)]
    np.testing.assert_allclose(tev.calculate_inception_score(confident, 5, shuffle=False)[0], 4.0)


@pytest.mark.parametrize("name", ["marginal_distribution_difference", "auto_correlation_difference",
                                  "skewness_difference", "kurtosis_difference"])
def test_stat_metrics_match_jax(name):
    rng = np.random.default_rng(5)
    real = rng.normal(size=(12, 4, 96)).astype(np.float32)
    gen = (rng.standard_t(4, size=(10, 4, 96)) * 0.8 + 0.1).astype(np.float32)
    want = getattr(jstat, name)(real, gen)
    np.testing.assert_allclose(getattr(tstat, name)(real, gen), want, rtol=1e-12)


# ---------------------------------------------------------------------------
# ROCKET and MiniRocket


def _out_lens(k):
    return k.input_length + 2 * k.paddings - (k.lengths - 1) * k.dilations


def check_rocket(got, want, ol, norm=1.0):
    """Hold ``got`` (B, 2K) to ``want``: the max columns within 1e-5 (of
    ``norm``-scaled values), a PPV entry off by at most 1/ol and in at most
    PPV_SHARE of the entries. -> the number of PPV entries off."""
    np.testing.assert_allclose(got[:, 1::2], want[:, 1::2], rtol=0, atol=1e-5)
    diff = np.abs(got[:, 0::2] - want[:, 0::2])
    off = diff > 1e-6 * norm
    assert (diff <= norm / ol + 1e-6).all()
    assert off.sum() <= PPV_SHARE * off.size, f"{off.sum()} of {off.size} PPV entries differ"
    return int(off.sum())


@pytest.mark.parametrize("L, K, seed", [(96, 100, 0), (127, 64, 3), (4633, 40, 0)])
def test_rocket_bank_is_bit_equal(L, K, seed):
    a, b = jrocket.generate_kernels(L, K, seed), trocket.generate_kernels(L, K, seed)
    for f in ("weights", "lengths", "biases", "dilations", "paddings"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.input_length == b.input_length


@pytest.mark.parametrize("L, seed", [(96, 0), (127, 1)])
def test_rocket_features_match_jax(L, seed):
    x = np.random.default_rng(seed).normal(size=(40, L))
    kernels = jrocket.generate_kernels(L, 100, seed=seed)
    want = jrocket.apply_kernels(x, kernels)
    got = trocket.apply_kernels(x, trocket.generate_kernels(L, 100, seed=seed), device="cpu")
    assert got.shape == (40, 200) and got.dtype == np.float32
    assert check_rocket(got, want, _out_lens(kernels)[None]) == 0  # measured: none off


def test_rocket_features_do_not_depend_on_the_batch():
    x = np.random.default_rng(2).normal(size=(10, 64))
    k = trocket.generate_kernels(64, 30, seed=0)
    np.testing.assert_array_equal(trocket.apply_kernels(x, k, batch=4, device="cpu"),
                                  trocket.apply_kernels(x, k, batch=16, device="cpu"))
    assert set(k._device_cache) == {torch.device("cpu")}  # the bank, uploaded once


def test_minirocket_matches_jax():
    x = np.random.default_rng(0).normal(size=(6, 2, 128)).astype(np.float32)
    j = jrocket.MiniRocket(128).fit(x)
    t = trocket.MiniRocket(128, device="cpu").fit(x)
    assert t.dilations == j.dilations and np.array_equal(t.kernels, j.kernels)
    for a, b in zip(t.biases, j.biases):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    z = t(x).numpy()
    assert z.shape == (6, 10000)
    np.testing.assert_allclose(np.linalg.norm(z, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(z, np.asarray(j(x)), rtol=0, atol=1e-5)


def test_minirocket_dilations_at_the_published_length():
    # np.logspace(..., base=2, dtype=int) truncates: 1-6 at L=4633, as in JAX
    t = trocket.MiniRocket(4633, device="cpu")
    assert t.dilations == jrocket.MiniRocket(4633).dilations == [1, 2, 3, 4, 5, 6]


def test_quantiles_above_two_to_the_24_elements():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 4, 2 ** 20 + 3))
                         .astype(np.float32))
    assert x.numel() > 2 ** 24  # where some torch versions' torch.quantile refuses
    got = trocket.sorted_quantiles(x, (0.25, 0.5, 0.75)).numpy()
    want = np.stack([np.quantile(x.numpy().astype(np.float64), q, axis=-1)
                     for q in (0.25, 0.5, 0.75)], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the Metrics engine


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(40, 2, 96)).astype(np.float32),
            rng.normal(size=(20, 2, 96)).astype(np.float32))


def test_metrics_rocket_features_match_jax(series):
    Xtr, Xte = series
    j = jev.Metrics(96, 2, 3, batch_size=16, X_train=Xtr, X_test=Xte, rocket_num_kernels=50)
    t = tev.Metrics(96, 2, 3, batch_size=16, X_train=Xtr, X_test=Xte, rocket_num_kernels=50,
                    device="cpu")
    ol = _out_lens(t.rocket_kernels)[None]
    for got, want in ((t.z_train, j.z_train), (t.z_test, j.z_test)):
        assert got.shape == want.shape and got.dtype == np.float32
        # rows are L2-normalised: a PPV flip of 1/ol moves a feature by 1/(ol |z|)
        check_rocket(got, want, ol, norm=float(np.linalg.norm(want, axis=-1).min()) ** -1)
    assert t.fid_score(t.z_test, t.z_test) < 1e-8
    mdd, acd, sd, kd = t.stat_metrics(Xte, Xtr)
    np.testing.assert_allclose([mdd, acd, sd, kd], j.stat_metrics(Xte, Xtr), rtol=1e-12)


def test_metrics_fcn_features_match_jax(series):
    Xtr, Xte = series
    variables = jax.jit(lambda k: JFCN(n_classes=3).init({"params": k}, Xtr[:2], False))(
        jax.random.key(0))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["batch_stats"] = jax.tree_util.tree_map(  # statistics a training run would leave
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim and v.min() > 0 else
                   0.1 * rng.normal(size=v.shape)).astype(np.float32), variables["batch_stats"])
    j = jev.Metrics(96, 2, 3, batch_size=8, X_train=Xtr, X_test=Xte,
                    feature_extractor_type="supervised_fcn", fcn_variables=variables)
    t = tev.Metrics(96, 2, 3, batch_size=8, X_train=Xtr, X_test=Xte,
                    feature_extractor_type="supervised_fcn", fcn_variables=variables, device="cpu")
    for got, want in ((t.z_train, j.z_train), (t.z_test, j.z_test)):
        assert got.shape == want.shape == (len(want), 128)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t._fcn_out(Xte, features=False).numpy(),
                               np.asarray(j._fcn_logits(Xte)), rtol=2e-4, atol=2e-4)
    is_mean, is_std = t.inception_score(Xte)
    assert 1.0 <= is_mean <= 3.0 and np.isfinite(is_std)


def test_metrics_refuses_what_it_cannot_build(series):
    Xtr, Xte = series
    with pytest.raises(ValueError, match="FCN"):
        tev.Metrics(96, 2, 3, 8, Xtr, Xte, feature_extractor_type="supervised_fcn", device="cpu")
    with pytest.raises(ValueError):
        tev.Metrics(96, 2, 3, 8, Xtr, Xte, feature_extractor_type="inception", device="cpu")
    m = tev.Metrics(96, 2, 3, 8, Xtr[:8], Xte[:8], rocket_num_kernels=4, device="cpu")
    with pytest.raises(ValueError, match="FCN"):
        m.inception_score(Xte)


# ---------------------------------------------------------------------------
# the isolation forest against sklearn's


def _sk_keep(z, seed):
    return SkIsolationForest(max_samples=0.9, contamination=0.1, random_state=seed).fit_predict(z) == 1


def _jaccard(a, b):
    return (a & b).sum() / (a | b).sum()


def test_average_path_length_matches_sklearn():
    n = np.array([0, 1, 2, 3, 10, 921, 1e6])
    np.testing.assert_allclose(tiso.average_path_length(n), _average_path_length(n), rtol=1e-15)


def test_planted_outliers_are_all_removed():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(400, 16))
    planted = rng.choice(400, 20, replace=False)  # 5%, 8 sigma out along random signs
    z[planted] += 8 * np.sign(rng.normal(size=(20, 16)))
    keep = tiso.IsolationForest().fit_predict(z) == 1
    assert not keep[planted].any()
    assert keep.sum() == 360  # contamination 0.1
    kept = tev.remove_outliers(z)
    assert kept.shape == (360, 16) and np.array_equal(kept, z[keep])


@pytest.mark.parametrize("kind", ["gaussian", "student_t"])
def test_kept_set_is_within_sklearns_seed_spread(kind):
    rng = np.random.default_rng(6)
    z = rng.normal(size=(256, 32)) if kind == "gaussian" else rng.standard_t(3, size=(256, 32))
    ref = _sk_keep(z, 0)
    floor = min(_jaccard(_sk_keep(z, s), ref) for s in range(1, 5))
    ours = tiso.IsolationForest().fit_predict(z) == 1
    assert _jaccard(ours, ref) >= floor, (_jaccard(ours, ref), floor)


def test_fid_through_the_port_filter_is_within_sklearns_seed_spread():
    rng = np.random.default_rng(8)
    z1 = rng.normal(size=(512, 8))
    z2 = 1.1 * rng.normal(size=(400, 8)) + 0.2

    def fid(keep1, keep2):
        return jev.calculate_fid(z1[keep1], z2[keep2])

    sk = [fid(_sk_keep(z1, s), _sk_keep(z2, s)) for s in range(5)]
    np.testing.assert_allclose(jev.calculate_fid(jev.remove_outliers(z1), jev.remove_outliers(z2)),
                               sk[0], rtol=1e-12)
    spread = max(abs(f - sk[0]) for f in sk[1:])
    ours = tev.calculate_fid(tev.remove_outliers(z1), tev.remove_outliers(z2))
    assert abs(ours - sk[0]) <= 1.5 * spread, (ours, sk)


def test_isolation_forest_trees_respect_the_depth_cap_and_are_seeded():
    z = np.random.default_rng(9).normal(size=(100, 4))
    a, b = tiso.IsolationForest().fit(z), tiso.IsolationForest().fit(z)
    assert a.max_samples_ == 90
    assert max(t.depth.max() for t in a.trees_) <= 7  # ceil(log2(90))
    np.testing.assert_array_equal(a.score_samples(z), b.score_samples(z))
    assert sum(t.size.sum() for t in a.trees_) == 100 * 90
    dup = np.repeat(z[:3], 10, axis=0)  # rows alike on every feature end as leaves
    assert set(tiso.IsolationForest().fit_predict(dup)) <= {-1, 1}
