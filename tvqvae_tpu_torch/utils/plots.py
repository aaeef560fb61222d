"""Figures: the JAX package's ``utils/plots.py`` figure functions, under
the same names, with the data each draws split from the drawing.

Reference: timevqvae/utils/plot_utils.py (trajectory, cluster and altitude
plots) and the inline validation plots of its trainers and sampler. Each
data-heavy figure has a ``*_data`` function that computes what it draws
(the PCA and t-SNE embeddings, on the device through ``utils/embedding.py``
in place of scikit-learn; the confidence bands; the histogram densities;
the correlation matrix; the percentile curves; the altitude scatter) and a
``draw_*`` function that draws it; the function of the JAX name composes
the two. The data functions need numpy and torch only; matplotlib is imported
by the drawing alone, so a machine without it (the card's) computes every
figure's data. The map figures draw on cartopy where it imports and on
plain lat/lon axes otherwise.
"""

from typing import Optional, Sequence

import numpy as np

from tvqvae_tpu_torch.utils.embedding import PCA, TSNE, trustworthiness


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_reconstruction(x_l, xhat_l, x_h, xhat_h, b: int, c: int, step: int):
    """Stage-1 validation plot (reference stage1.py:138-167)."""
    plt = _plt()
    fig, axes = plt.subplots(3, 1, figsize=(4, 6))
    fig.suptitle(f"step-{step} | channel {c} (blue: GT, orange: recon)")
    pairs = [
        (x_l[b, c], xhat_l[b, c], r"$x_l$ (LF)"),
        (x_h[b, c], xhat_h[b, c], r"$x_h$ (HF)"),
        (x_l[b, c] + x_h[b, c], xhat_l[b, c] + xhat_h[b, c], r"$x$ (LF+HF)"),
    ]
    for ax, (gt, rec, title) in zip(axes, pairs):
        ax.plot(np.asarray(gt), alpha=0.7)
        ax.plot(np.asarray(rec), alpha=0.7)
        ax.set_title(title)
        ax.set_ylim(-4, 4)
    fig.tight_layout()
    return fig


def plot_generated(x_l, x_h, x, b: int, c: int, step: int, title=""):
    """Stage-2 sampling plot (reference stage2.py:121-140)."""
    plt = _plt()
    fig, axes = plt.subplots(3, 1, figsize=(4, 6))
    fig.suptitle(f"step-{step} | channel {c} {title}")
    for ax, (arr, t) in zip(axes, [(x_l, r"$\hat{x}_l$"), (x_h, r"$\hat{x}_h$"),
                                   (x, r"$\hat{x}$")]):
        ax.plot(np.asarray(arr)[b, c])
        ax.set_title(t)
        ax.set_ylim(-4, 4)
    fig.tight_layout()
    return fig


def plot_visual_inspection(X_real, X_gen, n: int = 30, title: str = "visual inspection"):
    """Overlay grids of real vs generated series per channel (reference
    sampler.py:370-411)."""
    plt = _plt()
    C = X_real.shape[1]
    fig, axes = plt.subplots(2, C, figsize=(3 * C, 5), squeeze=False)
    fig.suptitle(title)
    for c in range(C):
        for row, data, name in [(0, X_real, "real"), (1, X_gen, "generated")]:
            ax = axes[row][c]
            for i in range(min(n, data.shape[0])):
                ax.plot(np.asarray(data)[i, c], alpha=0.2, color="C0")
            ax.set_title(f"{name} ch{c}")
    fig.tight_layout()
    return fig


# --------------------------------------------------------------------------
# embeddings


def pca_data(z_sets: Sequence[np.ndarray], labels: Sequence[str], n: int = 1024,
             device="cuda") -> dict:
    """The PCA scatter's points: each set's rows drawn with replacement by a
    fresh ``RandomState(0)``, the first set's draw fitted, every draw
    projected. -> {"sets": [(label, (m, 2) coordinates)]}."""
    pca = PCA(device=device)
    sets = []
    for i, (z, label) in enumerate(zip(z_sets, labels)):
        idx = np.random.RandomState(0).choice(z.shape[0], size=min(n, z.shape[0]), replace=True)
        emb = pca.fit_transform(z[idx]) if i == 0 else pca.transform(z[idx])
        sets.append((label, emb))
    return {"sets": sets}


def tsne_data(z_sets, labels, n: int = 512, device="cuda") -> dict:
    """The joint t-SNE's points: every set's rows drawn with replacement
    from one ``RandomState(0)``, embedded together at perplexity
    ``min(30, max(2, N // 4))``. -> {"sets": [(label, (m, 2))],
    "kl_divergence", "n_iter", "trustworthiness" (k=5)}."""
    rng = np.random.RandomState(0)
    subs = []
    for z in z_sets:
        idx = rng.choice(z.shape[0], size=min(n, z.shape[0]), replace=True)
        subs.append(z[idx])
    X = np.concatenate(subs)
    tsne = TSNE(perplexity=min(30, max(2, len(X) // 4)), device=device)
    emb = tsne.fit_transform(X)
    bounds = np.cumsum([0] + [len(s) for s in subs])
    return {"sets": [(label, emb[a:b]) for label, a, b in zip(labels, bounds[:-1], bounds[1:])],
            "kl_divergence": tsne.kl_divergence_, "n_iter": tsne.n_iter_,
            "trustworthiness": trustworthiness(X, emb, 5, device=device)}


def draw_scatter(data: dict, title: str):
    """The PCA or t-SNE figure of ``pca_data`` / ``tsne_data``."""
    plt = _plt()
    fig = plt.figure(figsize=(4, 4))
    plt.title(title)
    for label, emb in data["sets"]:
        plt.scatter(emb[:, 0], emb[:, 1], alpha=0.1, label=label)
    plt.legend(loc="upper right")
    plt.tight_layout()
    return fig


def plot_pca(z_sets: Sequence[np.ndarray], labels: Sequence[str], n: int = 1024,
             title: str = "PCA", device="cuda"):
    """PCA scatter; fits on the first set, projects the rest (reference
    sampler.py:413-435, stage3.py:348-360)."""
    return draw_scatter(pca_data(z_sets, labels, n, device), title)


def plot_tsne(z_sets, labels, n: int = 512, title: str = "t-SNE", device="cuda"):
    """Joint t-SNE embedding (reference sampler.py:437-481)."""
    return draw_scatter(tsne_data(z_sets, labels, n, device), title)


# --------------------------------------------------------------------------
# maps


def _cartopy():
    """Optional geo stack: (cartopy, ccrs) or (None, None)."""
    try:
        import cartopy
        import cartopy.crs as ccrs

        return cartopy, ccrs
    except ImportError:
        return None, None


def geographic_extent(X: np.ndarray, lat_idx: int = 0, lon_idx: int = 1, margin: float = 0.5):
    """[lon_min, lon_max, lat_min, lat_max] with a margin, from (B, C, L)
    trajectories (reference plot_utils.py:24-43 extract_geographic_info)."""
    lats = np.asarray(X)[:, lat_idx, :]
    lons = np.asarray(X)[:, lon_idx, :]
    return [float(lons.min() - margin), float(lons.max() + margin),
            float(lats.min() - margin), float(lats.max() + margin)]


def _class_colors(n: int):
    """husl-like categorical palette (the reference uses seaborn's husl,
    plot_utils.py:114)."""
    try:
        import seaborn as sns

        return sns.color_palette("husl", max(n, 1))
    except ImportError:
        return [f"C{i % 10}" for i in range(max(n, 1))]


def _map_axes(nrows=1, ncols=1, figsize=(5, 5)):
    """(fig, axes, is_map): GeoAxes grid under cartopy, plain axes without."""
    plt = _plt()
    cartopy, ccrs = _cartopy()
    if cartopy is not None:
        fig, axes = plt.subplots(nrows, ncols, figsize=figsize,
                                 subplot_kw={"projection": ccrs.EuroPP()}, squeeze=False)
        return fig, axes, True
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    return fig, axes, False


def _decorate_map(ax, extent=None, airports: Optional[dict] = None):
    """Coastlines, borders, gridlines and airport markers on a GeoAxes
    (reference plot_utils.py:74-95)."""
    _, ccrs = _cartopy()
    import cartopy.feature as cfeature

    pc = ccrs.PlateCarree()
    ax.coastlines()
    ax.add_feature(cfeature.BORDERS, linestyle=":", alpha=1.0)
    if extent is not None:
        ax.set_extent(extent, crs=pc)
    for (name, (lat, lon)), color, tag in zip((airports or {}).items(), ["red", "green"],
                                              ["Origin", "Destination"]):
        ax.scatter([lon], [lat], color=color, s=300, zorder=5, label=f"{tag}: {name}",
                   transform=pc)
    gl = ax.gridlines(draw_labels=True, color="gray", alpha=0.5, linestyle="--")
    gl.top_labels = False
    gl.right_labels = False


def plot_trajectories(X: np.ndarray, lat_idx: int = 0, lon_idx: int = 1,
                      labels: Optional[np.ndarray] = None, title: str = "trajectories",
                      max_n: int = 200, airports: Optional[dict] = None):
    """Lat/lon trajectories, coloured by cluster when ``labels`` are given,
    on an EuroPP map with airport markers under cartopy (reference
    plot_utils.py:63-146). ``airports``: {ICAO: (lat, lon)}, the first the
    origin (red), the second the destination (green)."""
    fig, axes, is_map = _map_axes(figsize=(6, 6))
    ax = axes[0][0]
    ax.set_title(title)
    n = min(max_n, X.shape[0])
    kw = {}
    if is_map:
        kw["transform"] = _cartopy()[1].PlateCarree()
    if labels is None:
        for i in range(n):
            ax.plot(X[i, lon_idx], X[i, lat_idx], alpha=0.2, color="darkblue", linewidth=1, **kw)
    else:
        colors = _class_colors(int(np.max(labels)) + 1)
        for i in range(n):
            ax.plot(X[i, lon_idx], X[i, lat_idx], alpha=0.3, color=colors[int(labels[i])],
                    linewidth=1, **kw)
    if is_map:
        _decorate_map(ax, geographic_extent(X[:n], lat_idx, lon_idx), airports)
        if airports:
            ax.legend(loc="upper right")
    else:
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
    fig.tight_layout()
    return fig


def plot_clustering(X: np.ndarray, labels: np.ndarray, lat_idx: int = 0, lon_idx: int = 1,
                    title: str = "trajectories per class", max_n_per_class: int = 200,
                    airports: Optional[dict] = None):
    """One panel per cluster, husl-coloured (reference plot_utils.py:158-230)."""
    labels = np.asarray(labels).reshape(-1)
    n_clusters = int(labels.max()) + 1
    colors = _class_colors(n_clusters)
    fig, axes, is_map = _map_axes(1, n_clusters, figsize=(5 * n_clusters, 6))
    kw = {}
    if is_map:
        kw["transform"] = _cartopy()[1].PlateCarree()
    extent = geographic_extent(X, lat_idx, lon_idx)
    for c in range(n_clusters):
        ax = axes[0][c]
        for i in np.nonzero(labels == c)[0][:max_n_per_class]:
            ax.plot(X[i, lon_idx], X[i, lat_idx], alpha=0.2, color=colors[c], linewidth=1, **kw)
        if is_map:
            _decorate_map(ax, extent, airports)
        else:
            ax.set_xlabel("longitude")
            ax.set_ylabel("latitude")
        ax.set_title(f"Class {c}")
    fig.suptitle(title, fontsize=16)
    fig.tight_layout()
    return fig


def plot_altitude(X: np.ndarray, alt_idx: int = 2, title: str = "altitude", max_n: int = 200):
    """Altitude profiles over time (plain axes; ``plot_altitude_map`` is the
    reference's map scatter, plot_utils.py:306-384)."""
    plt = _plt()
    fig = plt.figure(figsize=(5, 3))
    plt.title(title)
    for i in range(min(max_n, X.shape[0])):
        plt.plot(X[i, alt_idx], alpha=0.2, color="C0")
    plt.xlabel("timestep")
    plt.ylabel("altitude")
    plt.tight_layout()
    return fig


def altitude_map_data(X: np.ndarray, lat_idx: int = 0, lon_idx: int = 1, alt_idx: int = 2,
                      max_n: int = 50, stride: int = 8) -> dict:
    """The altitude map's scatter: every ``stride``-th point of the first
    ``max_n`` trajectories, its marker size growing with the altitude, and
    the map's extent."""
    n = min(max_n, X.shape[0])
    lats = np.asarray(X)[:n, lat_idx, ::stride].ravel()
    lons = np.asarray(X)[:n, lon_idx, ::stride].ravel()
    alts = np.asarray(X)[:n, alt_idx, ::stride].ravel()
    sizes = 10 + 40 * (alts - alts.min()) / max(alts.max() - alts.min(), 1e-9)
    return {"n": n, "lats": lats, "lons": lons, "alts": alts, "sizes": sizes,
            "extent": geographic_extent(X[:n], lat_idx, lon_idx)}


def draw_altitude_map(data: dict, X: np.ndarray, lat_idx: int = 0, lon_idx: int = 1,
                      title: str = "altitude"):
    plt = _plt()
    cartopy, ccrs = _cartopy()
    if cartopy is not None:
        import cartopy.feature as cfeature

        fig, ax = plt.subplots(figsize=(9, 8), subplot_kw={"projection": ccrs.Mercator()})
        pc = ccrs.PlateCarree()
        ax.coastlines(resolution="50m")
        ax.add_feature(cfeature.LAND, color="lightgray")
        ax.add_feature(cfeature.OCEAN, color="azure")
        ax.add_feature(cfeature.BORDERS, linestyle=":")
        ax.set_extent(data["extent"], crs=pc)
        kw = {"transform": pc}
    else:
        fig, ax = plt.subplots(figsize=(9, 8))
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
        kw = {}
    for i in range(data["n"]):
        ax.plot(X[i, lon_idx], X[i, lat_idx], color="black", alpha=0.2, zorder=1, **kw)
    sc = ax.scatter(data["lons"], data["lats"], c=data["alts"], cmap="viridis", s=data["sizes"],
                    zorder=2, **kw)
    fig.colorbar(sc, ax=ax, aspect=30, label="Altitude (feet)")
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_altitude_map(X: np.ndarray, lat_idx: int = 0, lon_idx: int = 1, alt_idx: int = 2,
                      title: str = "altitude", max_n: int = 50, stride: int = 8):
    """Trajectories on a map with altitude as colour and size (reference
    plot_utils.py:306-384, Basemap merc -> cartopy Mercator); plain lat/lon
    axes without cartopy."""
    return draw_altitude_map(altitude_map_data(X, lat_idx, lon_idx, alt_idx, max_n, stride), X,
                             lat_idx, lon_idx, title)


# --------------------------------------------------------------------------
# real against generated


def timeseries_ci_data(X_real, X_gen) -> dict:
    """Per channel and set, the mean and the 2.5/97.5 percentiles over the
    series at each step. -> {"real"|"generated": (mean, lo, hi), each (C, L)}."""
    out = {}
    for data, name in ((X_real, "real"), (X_gen, "generated")):
        arr = np.asarray(data)
        out[name] = (arr.mean(axis=0), np.percentile(arr, 2.5, axis=0),
                     np.percentile(arr, 97.5, axis=0))
    return out


def draw_timeseries_ci(data: dict, feature_names=None,
                       title: str = "time series (mean ± 95% CI)"):
    plt = _plt()
    C = data["real"][0].shape[0]
    fig, axes = plt.subplots(1, C, figsize=(3.2 * C, 3), squeeze=False)
    for c in range(C):
        ax = axes[0][c]
        for name, color in (("real", "C0"), ("generated", "C1")):
            mu, lo, hi = (a[c] for a in data[name])
            ax.plot(mu, color=color, label=name)
            ax.fill_between(np.arange(len(mu)), lo, hi, color=color, alpha=0.2)
        ax.set_title(feature_names[c] if feature_names else f"ch{c}")
        if c == 0:
            ax.legend()
    fig.suptitle(title)
    fig.tight_layout()
    return fig


def plot_timeseries_ci(X_real, X_gen, feature_names=None,
                       title: str = "time series (mean ± 95% CI)"):
    """Per-channel mean with 95% bands, real vs generated (the reference's
    time_series.ipynb)."""
    return draw_timeseries_ci(timeseries_ci_data(X_real, X_gen), feature_names, title)


def distributions_data(X_real, X_gen, bins: int = 80) -> list:
    """Per channel, the density histograms of every value, real and
    generated, over their common range. -> [{"edges", "real", "generated"}]."""
    out = []
    for c in range(X_real.shape[1]):
        r = np.asarray(X_real)[:, c, :].ravel()
        g = np.asarray(X_gen)[:, c, :].ravel()
        lo, hi = min(r.min(), g.min()), max(r.max(), g.max())
        hr, edges = np.histogram(r, bins=bins, range=(lo, hi), density=True)
        hg, _ = np.histogram(g, bins=bins, range=(lo, hi), density=True)
        out.append({"edges": edges, "real": hr, "generated": hg})
    return out


def draw_distributions(data: list, feature_names=None, title: str = "marginal distributions"):
    plt = _plt()
    C = len(data)
    fig, axes = plt.subplots(1, C, figsize=(3.2 * C, 3), squeeze=False)
    for c, d in enumerate(data):
        ax = axes[0][c]
        for name in ("real", "generated"):
            ax.hist(d["edges"][:-1], bins=d["edges"], weights=d[name], alpha=0.5, label=name)
        ax.set_title(feature_names[c] if feature_names else f"ch{c}")
        if c == 0:
            ax.legend()
    fig.suptitle(title)
    fig.tight_layout()
    return fig


def plot_distributions(X_real, X_gen, feature_names=None, bins: int = 80,
                       title: str = "marginal distributions"):
    """Per-channel marginal histograms, real vs generated (the reference's
    distribution_plots.ipynb)."""
    return draw_distributions(distributions_data(X_real, X_gen, bins), feature_names, title)


# --------------------------------------------------------------------------
# flyability distances


def metric_correlation(results: dict, keys) -> np.ndarray:
    """The correlation matrix between per-flight distance metrics."""
    return np.corrcoef(np.stack([np.asarray(results[k], float) for k in keys]))


def draw_metric_correlation_heatmap(corr: np.ndarray, keys, title: str):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(1.1 * len(keys) + 2, 1.0 * len(keys) + 1))
    im = ax.imshow(corr, vmin=-1, vmax=1, cmap="coolwarm")
    ax.set_xticks(range(len(keys)))
    ax.set_yticks(range(len(keys)))
    ax.set_xticklabels(keys, rotation=45, ha="right", fontsize=8)
    ax.set_yticklabels(keys, fontsize=8)
    for i in range(len(keys)):
        for j in range(len(keys)):
            ax.text(j, i, f"{corr[i, j]:.2f}", ha="center", va="center", fontsize=7)
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_metric_correlation_heatmap(results: dict, keys, title: str):
    """Correlation heatmap between per-flight distance metrics (the
    reference's correlation_heatmaps.ipynb)."""
    return draw_metric_correlation_heatmap(metric_correlation(results, keys), keys, title)


def metric_percentiles(results: dict, keys) -> dict:
    """Each metric's percentiles 0..100. -> {"q": (101,), key: (101,)}."""
    qs = np.linspace(0, 100, 101)
    return {"q": qs, **{k: np.percentile(np.asarray(results[k], float), qs) for k in keys}}


def draw_metric_percentiles(data: dict, keys, title: str):
    plt = _plt()
    ncol = 4
    nrow = (len(keys) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.6 * nrow), squeeze=False)
    for ax, k in zip(np.ravel(axes), keys):
        ax.plot(data["q"], data[k])
        ax.set_title(k, fontsize=9)
        ax.set_xlabel("percentile")
    for ax in np.ravel(axes)[len(keys):]:
        ax.axis("off")
    fig.suptitle(title)
    fig.tight_layout()
    return fig


def plot_metric_percentiles(results: dict, keys, title: str):
    """Percentile curves per distance metric (the reference's
    percentile_plots figures)."""
    return draw_metric_percentiles(metric_percentiles(results, keys), keys, title)
