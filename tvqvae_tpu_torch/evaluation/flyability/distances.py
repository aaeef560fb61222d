"""Trajectory distances: the 14 flyability metrics in PyTorch, with CUDA
kernels for the dynamic programs and the continuous Fréchet.

The port of ``tvqvae_tpu/evaluation/flyability/distances.py``. Every metric
here is the plain PyTorch version: float32 tensors on any device, batched
over flight pairs (a leading batch axis is optional); arrays become float32
tensors, a float64 tensor stays float64 (a witness for the float32 values). They keep the JAX
package's semantics letter for letter:

  - trajectories are (n, 2) [latitude, longitude]; "euclidean" variants are
    planar degrees, "spherical" variants great-circle metres with
    R = 6378137 and the JAX package's (lat, lon) argument order;
  - DTW / ERP / EDR / LCSS / the discrete Fréchet are row dynamic programs;
    each row is one associative scan of the JAX package's own combine
    function (``associative_scan`` below), the rows a loop;
  - ERP borders are the total gap sums, EDR and LCSS borders zero, the gap
    point the departure airport; spherical LCSS uses eps*1e6 metres while
    spherical EDR keeps 0.009 (metres); spherical SSPD is not halved;
  - the discrete and continuous Fréchet are planar only; the continuous one
    bisects 30 times from lo = max(endpoint distances), hi = the discrete
    Fréchet, over the Alt-Godau free-space decision;
  - under bucket padding (repeat the last point) the DP answers are read at
    the true (n-1, m-1) corner.

``calculate_trajectory_distances_batch`` scores a list of pairs in shape
buckets. On the card each bucket takes one launch of the DP family
(``ops/traj_dp_kernel.py``, ``csrc/traj_dp.cu``) and the rounds of the
continuous Fréchet (``ops/frechet_kernel.py``, ``csrc/frechet_decision.cu``:
ceil(30 / depth) launches, the depth from its launch plan), which starts
from the first kernel's discrete Fréchet. SSPD and Hausdorff are batched
distance matrices in plain PyTorch on either device. On CPU tensors the
bucket runs the kernels' plain versions below (``dp_metrics``,
``frechet_bisect`` at depth 1, whose ``bisection_round`` is the kernel's
round); on the card the plain loops never run.
"""

import math
from typing import Dict, Sequence

import numpy as np
import torch

from tvqvae_tpu_torch.ops import frechet_kernel, traj_dp_kernel
from tvqvae_tpu_torch.utils.device import resolve_device

R_SPHERICAL = 6378137.0  # meters (reference basic_spherical.py:10)
BIG = 1e30
INF = float("inf")
DEG = math.pi / 180  # jnp.radians multiplies by float32(pi / 180)
BISECTION_STEPS = 30

KEYS = (
    "SSPD Euclidean", "SSPD Spherical", "DTW Euclidean", "DTW Spherical",
    "Hausdorff Euclidean", "Hausdorff Spherical", "LCSS Euclidean",
    "LCSS Spherical", "ERP Euclidean", "ERP Spherical", "EDR Euclidean",
    "EDR Spherical", "Discrete Frechet", "Frechet",
)


def dp_variants(eps: float = 0.009):
    """The nine DP metrics of the bundle as (key, kind, metric, eps), with the
    JAX package's epsilon conventions (spherical LCSS eps*1e6 metres,
    spherical EDR eps itself)."""
    return (
        ("DTW Euclidean", "dtw", "euclidean", 0.0),
        ("DTW Spherical", "dtw", "spherical", 0.0),
        ("ERP Euclidean", "erp", "euclidean", 0.0),
        ("ERP Spherical", "erp", "spherical", 0.0),
        ("EDR Euclidean", "edr", "euclidean", eps),
        ("EDR Spherical", "edr", "spherical", eps),
        ("LCSS Euclidean", "lcss", "euclidean", eps),
        ("LCSS Spherical", "lcss", "spherical", eps * 1e6),
        ("Discrete Frechet", "discret_frechet", "euclidean", 0.0),
    )


# --------------------------------------------------------------------------
# inputs


def _tensor(x, device=None, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if dtype is None:
            dtype = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
        return x.to(device=device if device is not None else x.device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, np.float32), device=device, dtype=dtype)


def _prep(p, q, n=None, m=None):
    """-> p (B, P, 2), q (B, Q, 2), n (B,), m (B,) int64 on p's device, and
    whether the inputs had no batch axis."""
    p = _tensor(p)
    q = _tensor(q, p.device, p.dtype)
    single = p.dim() == 2
    if single:
        p, q = p[None], q[None]
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]

    def lengths(x, full):
        if x is None:
            return torch.full((B,), full, dtype=torch.int64, device=p.device)
        return torch.as_tensor(x, device=p.device).to(torch.int64).reshape(-1).expand(B)

    return p, q, lengths(n, P), lengths(m, Q), single


def _out(x: torch.Tensor, single: bool) -> torch.Tensor:
    return x[0] if single else x


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, L) x."""
    return x.gather(-1, idx.clamp(0, x.shape[-1] - 1)[:, None])[:, 0]


def _rows(n: torch.Tensor) -> int:
    """Rows a DP must run: the longest true length (later rows never reach
    a true corner)."""
    return int(n.max())


# --------------------------------------------------------------------------
# point/segment distance primitives (batched over leading axes)


def _eucl_pdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 2), (..., m, 2) -> (..., n, m) planar distances."""
    d0 = a[..., :, None, 0] - b[..., None, :, 0]
    d1 = a[..., :, None, 1] - b[..., None, :, 1]
    return torch.sqrt(d0 * d0 + d1 * d1 + 1e-30)


def _haversine_angle(lat1, lon1, lat2, lon2):
    """2·asin(sqrt(hav)) in radians, in the JAX package's operation order."""
    s = (
        torch.square(torch.sin((lat2 - lat1) / 2))
        + torch.cos(lat1) * torch.cos(lat2) * torch.square(torch.sin((lon2 - lon1) / 2))
    )
    return 2 * torch.asin(torch.sqrt(torch.clamp(s, 0.0, 1.0)))


def _sph_pdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) [lat, lon] degrees -> (..., n, m) great-circle meters."""
    return R_SPHERICAL * _haversine_angle(
        (a[..., 0] * DEG)[..., :, None], (a[..., 1] * DEG)[..., :, None],
        (b[..., 0] * DEG)[..., None, :], (b[..., 1] * DEG)[..., None, :])


def _pair_dists(p, q, metric: str):
    if metric not in ("euclidean", "spherical"):
        raise ValueError(f"unknown metric {metric!r}")
    return _eucl_pdist(p, q) if metric == "euclidean" else _sph_pdist(p, q)


def _point_to_segments_eucl(pts: torch.Tensor, traj: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) points vs (..., m, 2) polyline -> (..., n, m-1)
    point-to-segment distances (reference basic_euclidean.py point_to_seg)."""
    s0 = traj[..., None, :-1, :]
    s1 = traj[..., None, 1:, :]
    v = s1 - s0
    w = pts[..., :, None, :] - s0
    vv = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    wv = w[..., 0] * v[..., 0] + w[..., 1] * v[..., 1]
    t = torch.where(vv > 0, wv / torch.clamp(vv, min=1e-30), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    proj = s0 + t[..., None] * v
    d = pts[..., :, None, :] - proj
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + 1e-30)


def _point_to_segments_sph(pts: torch.Tensor, traj: torch.Tensor) -> torch.Tensor:
    """Spherical point-to-path with the reference's semantics
    (basic_spherical.py point_to_path:219-258): the cross-track distance
    counts only when both along-track distances are within the segment
    length; off the path it falls back to min(d13, d23). The along-track
    distance uses the JAX package's cancellation-free form."""
    lat_p = (pts[..., 0] * DEG)[..., :, None]
    lon_p = (pts[..., 1] * DEG)[..., :, None]
    lat_a = (traj[..., :-1, 0] * DEG)[..., None, :]
    lon_a = (traj[..., :-1, 1] * DEG)[..., None, :]
    lat_b = (traj[..., 1:, 0] * DEG)[..., None, :]
    lon_b = (traj[..., 1:, 1] * DEG)[..., None, :]

    def bearing(lat1, lon1, lat2, lon2):
        y = torch.sin(lon2 - lon1) * torch.cos(lat2)
        x = (torch.cos(lat1) * torch.sin(lat2)
             - torch.sin(lat1) * torch.cos(lat2) * torch.cos(lon2 - lon1))
        return torch.atan2(y, x)

    d13 = _haversine_angle(lat_a, lon_a, lat_p, lon_p)  # start -> point
    d23 = _haversine_angle(lat_b, lon_b, lat_p, lon_p)  # end -> point
    d12 = _haversine_angle(lat_a, lon_a, lat_b, lon_b)  # segment length
    th13 = bearing(lat_a, lon_a, lat_p, lon_p)
    th12 = bearing(lat_a, lon_a, lat_b, lon_b)
    crt = torch.asin(torch.clamp(torch.sin(d13) * torch.sin(th13 - th12), -1.0, 1.0))
    cos_crt = torch.clamp(torch.abs(torch.cos(crt)), min=1e-12)

    def along_track(dp):
        h = torch.sin((dp + crt) / 2) * torch.sin((dp - crt) / 2) / cos_crt
        return 2.0 * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))

    d1p = along_track(d13)
    d2p = along_track(d23)
    off_path = (d1p > d12) | (d2p > d12)
    seg = torch.where(off_path, torch.minimum(d13, d23), torch.abs(crt))
    return R_SPHERICAL * seg


def _pts_to_traj(pts, traj, metric: str):
    f = _point_to_segments_eucl if metric == "euclidean" else _point_to_segments_sph
    return torch.amin(f(pts, traj), dim=-1)  # (..., n)


# --------------------------------------------------------------------------
# log-depth row recurrences


def associative_scan(combine, elems):
    """Inclusive scan along the last axis of a tuple of equal-shaped tensors
    under an associative ``combine(left, right) -> tuple`` (the JAX
    package's combine functions, as ``jax.lax.associative_scan`` takes
    them). Hillis-Steele doubling: log2(L) steps of one combine each."""
    elems = tuple(elems)
    length = elems[0].shape[-1]
    d = 1
    while d < length:
        new = combine(tuple(e[..., :-d] for e in elems), tuple(e[..., d:] for e in elems))
        elems = tuple(torch.cat([e[..., :d], x], -1) for e, x in zip(elems, new))
        d *= 2
    return elems


def _minplus_combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 + a2, torch.minimum(b2, b1 + a2)


def _minplus_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dp[0] = b[0]; dp[j] = min(b[j], dp[j-1] + a[j])."""
    return associative_scan(_minplus_combine, (a, b))[1]


def _clamp_combine(left, right):
    lo1, hi1 = left
    lo2, hi2 = right
    return (torch.maximum(lo2, torch.minimum(hi2, lo1)),
            torch.maximum(lo2, torch.minimum(hi2, hi1)))


def _clamp_scan(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """dp[0] = max(lo[0], min(hi[0], BIG)); dp[j] = max(lo[j], min(hi[j], dp[j-1]))."""
    return associative_scan(_clamp_combine, (lo, hi))[1]


# --------------------------------------------------------------------------
# dynamic programs over a cost tensor C (B, P, Q), true lengths n, m (B,)


def _dtw_rows(C, n, m):
    B = C.shape[0]
    big = C.new_full((B, 1), BIG)
    prev = torch.cumsum(C[:, 0], -1)
    best = torch.where(n == 1, _at(prev, m - 1), BIG)
    for i in range(1, _rows(n)):
        c = C[:, i]
        b = c + torch.minimum(prev, torch.cat([big, prev[:, :-1]], -1))
        b = torch.cat([c[:, :1] + prev[:, :1], b[:, 1:]], -1)
        prev = _minplus_scan(c, b)
        best = torch.where(n - 1 == i, _at(prev, m - 1), best)
    return best


def _erp_rows(C, gp, gq, n, m):
    B, P, Q = C.shape
    gp = torch.where(torch.arange(P, device=C.device) < n[:, None], gp, 0.0)
    gq_masked = torch.where(torch.arange(Q, device=C.device) < m[:, None], gq, 0.0)
    sgp, sgq = gp.sum(-1, keepdim=True), gq_masked.sum(-1, keepdim=True)
    zero = C.new_zeros((B, 1))
    a = torch.cat([zero, gq], -1)  # in-row gap costs
    prev = torch.cat([zero, sgq.expand(B, Q)], -1)
    best = torch.where(n == 0, _at(prev, m), BIG)
    for i in range(_rows(n)):
        diag = prev[:, :-1] + C[:, i]
        up = prev[:, 1:] + gp[:, i:i + 1]
        prev = _minplus_scan(a, torch.cat([sgp, torch.minimum(diag, up)], -1))
        best = torch.where(n - 1 == i, _at(prev, m), best)
    return best


def _edr_rows(sub, n, m):
    B, P, Q = sub.shape
    zero = sub.new_zeros((B, 1))
    a = torch.cat([zero, sub.new_ones((B, Q))], -1)
    prev = sub.new_zeros((B, Q + 1))
    best = torch.where(n == 0, _at(prev, m), BIG)
    for i in range(_rows(n)):
        diag = prev[:, :-1] + sub[:, i]
        up = prev[:, 1:] + 1.0
        prev = _minplus_scan(a, torch.cat([zero, torch.minimum(diag, up)], -1))
        best = torch.where(n - 1 == i, _at(prev, m), best)
    return best / torch.maximum(n, m).to(best.dtype)


def _lcss_rows(match, n, m):
    B, P, Q = match.shape
    zero = match.new_zeros((B, 1))
    prev = match.new_zeros((B, Q + 1))
    best = torch.where(n == 0, _at(prev, m), 0.0)
    for i in range(_rows(n)):
        b = torch.cat([zero, torch.maximum(prev[:, :-1] + match[:, i], prev[:, 1:])], -1)
        # associative_scan(jnp.maximum, b) in JAX: a running max, exact in any order
        prev = torch.cummax(b, -1).values
        best = torch.where(n - 1 == i, _at(prev, m), best)
    return 1.0 - best / torch.minimum(n, m).to(best.dtype)


def _discret_frechet_rows(C, n, m):
    B = C.shape[0]
    big = C.new_full((B, 1), BIG)
    prev = torch.cummax(C[:, 0], -1).values
    best = torch.where(n == 1, _at(prev, m - 1), BIG)
    for i in range(1, _rows(n)):
        c = C[:, i]
        mcol = torch.minimum(prev, torch.cat([big, prev[:, :-1]], -1))
        first = torch.maximum(c[:, :1], prev[:, :1])
        prev = _clamp_scan(torch.cat([first, c[:, 1:]], -1), torch.cat([first, mcol[:, 1:]], -1))
        best = torch.where(n - 1 == i, _at(prev, m - 1), best)
    return best


def dtw(p, q, metric: str = "euclidean", n=None, m=None):
    """Dynamic time warping (reference dtw.py:15-78). n/m give the true
    lengths when p/q are padded to a bucket shape."""
    p, q, n, m, single = _prep(p, q, n, m)
    return _out(_dtw_rows(_pair_dists(p, q, metric), n, m), single)


def erp(p, q, g, metric: str = "euclidean", n=None, m=None):
    """Edit distance with real penalty (reference erp.py, traj-dist borders:
    the TOTAL gap sums, erp.py:40-41)."""
    p, q, n, m, single = _prep(p, q, n, m)
    g = _tensor(g, p.device, p.dtype).reshape(1, 1, 2)
    gp = _pair_dists(p, g, metric)[..., 0]
    gq = _pair_dists(q, g, metric)[..., 0]
    return _out(_erp_rows(_pair_dists(p, q, metric), gp, gq, n, m), single)


def edr(p, q, eps: float, metric: str = "euclidean", n=None, m=None):
    """Edit distance on real sequences / max(n, m) (zero borders, edr.py:33)."""
    p, q, n, m, single = _prep(p, q, n, m)
    sub = (_pair_dists(p, q, metric) >= eps).to(p.dtype)
    return _out(_edr_rows(sub, n, m), single)


def lcss(p, q, eps: float, metric: str = "euclidean", n=None, m=None):
    """1 - LCSS/min(n, m) (reference lcss.py)."""
    p, q, n, m, single = _prep(p, q, n, m)
    match = (_pair_dists(p, q, metric) < eps).to(p.dtype)
    return _out(_lcss_rows(match, n, m), single)


def discret_frechet(p, q, metric: str = "euclidean", n=None, m=None):
    """Discrete Frechet distance (reference discret_frechet.py:10-37)."""
    p, q, n, m, single = _prep(p, q, n, m)
    return _out(_discret_frechet_rows(_pair_dists(p, q, metric), n, m), single)


def dp_metrics(p, q, n, m, g, variants) -> torch.Tensor:
    """The plain version of ``ops/traj_dp_kernel.py``: (B, V) values of the
    DP ``variants`` ((kind, metric, eps) with kind in dtw, erp, edr, lcss,
    discret_frechet). Variants of one kind share one row loop, their cost
    tensors stacked along the batch axis."""
    p, q, n, m, _ = _prep(p, q, n, m)
    B = p.shape[0]
    g = _tensor(g, p.device, p.dtype).reshape(1, 1, 2)
    out = [None] * len(variants)
    by_kind = {}
    for v, (kind, metric, eps) in enumerate(variants):
        by_kind.setdefault(kind, []).append((v, metric, eps))
    for kind, group in by_kind.items():
        costs = [_pair_dists(p, q, metric) for _, metric, _ in group]
        nn, mm = n.repeat(len(group)), m.repeat(len(group))
        if kind == "dtw":
            vals = _dtw_rows(torch.cat(costs), nn, mm)
        elif kind == "erp":
            gp = torch.cat([_pair_dists(p, g, metric)[..., 0] for _, metric, _ in group])
            gq = torch.cat([_pair_dists(q, g, metric)[..., 0] for _, metric, _ in group])
            vals = _erp_rows(torch.cat(costs), gp, gq, nn, mm)
        elif kind == "edr":
            vals = _edr_rows(torch.cat([(c >= e).to(p.dtype)
                                        for c, (_, _, e) in zip(costs, group)]), nn, mm)
        elif kind == "lcss":
            vals = _lcss_rows(torch.cat([(c < e).to(p.dtype)
                                         for c, (_, _, e) in zip(costs, group)]), nn, mm)
        elif kind == "discret_frechet":
            vals = _discret_frechet_rows(torch.cat(costs), nn, mm)
        else:
            raise ValueError(f"unknown DP kind {kind!r}")
        for k, (v, _, _) in enumerate(group):
            out[v] = vals[k * B:(k + 1) * B]
    return torch.stack(out, -1)


def _masked_pts_to_traj(pts, traj, metric, n_pts):
    """Point-to-trajectory distances with the points side masked. The
    trajectory side is assumed padded by REPEATING its last point, which
    adds only zero-length segments and leaves min-over-segments intact."""
    d = _pts_to_traj(pts, traj, metric)
    return d, torch.arange(pts.shape[-2], device=pts.device) < n_pts[:, None]


def sspd(p, q, metric: str = "euclidean", n=None, m=None):
    """Symmetrized segment-path distance (reference sspd.py:51,135)."""
    p, q, n, m, single = _prep(p, q, n, m)
    d_pq, v_p = _masked_pts_to_traj(p, q, metric, n)
    d_qp, v_q = _masked_pts_to_traj(q, p, metric, m)
    mean_pq = torch.where(v_p, d_pq, 0.0).sum(-1) / n.to(p.dtype)
    mean_qp = torch.where(v_q, d_qp, 0.0).sum(-1) / m.to(p.dtype)
    # traj-dist quirk preserved: e_sspd halves the directed sum
    # (sspd.py:78-81) but s_sspd does NOT (sspd.py:170-174).
    if metric == "spherical":
        return _out(mean_pq + mean_qp, single)
    return _out((mean_pq + mean_qp) / 2.0, single)


def hausdorff(p, q, metric: str = "euclidean", n=None, m=None):
    """Symmetric Hausdorff over point-to-trajectory distances
    (reference hausdorff.py:46,117)."""
    p, q, n, m, single = _prep(p, q, n, m)
    d_pq, v_p = _masked_pts_to_traj(p, q, metric, n)
    d_qp, v_q = _masked_pts_to_traj(q, p, metric, m)
    return _out(torch.maximum(
        torch.where(v_p, d_pq, -INF).amax(-1),
        torch.where(v_q, d_qp, -INF).amax(-1),
    ), single)


# --------------------------------------------------------------------------
# continuous Frechet: Alt-Godau free-space decision under bisection


def _free_intervals(a, b, c, eps):
    """Free intervals of segments a->b w.r.t. eps-balls at c (the last axis
    holds the two coordinates; the others broadcast, eps too). Returns
    (lo, hi) clamped to [0, 1]; empty encoded lo > hi."""
    d0, d1 = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    w0, w1 = c[..., 0] - a[..., 0], c[..., 1] - a[..., 1]
    dd = d0 * d0 + d1 * d1
    ww = w0 * w0 + w1 * w1
    ddc = torch.clamp(dd, min=1e-30)
    e2 = eps * eps
    t0 = torch.where(dd > 0, (w0 * d0 + w1 * d1) / ddc, 0.0)
    disc = torch.where(dd > 0, (e2 - ww) / ddc + t0 * t0, torch.where(ww <= e2, 1.0, -1.0))
    r = torch.sqrt(torch.clamp(disc, min=0.0))
    # one-sided clamps only: an interval entirely outside [0, 1] must stay
    # empty (lo > hi), not collapse to a spurious endpoint
    lo = torch.clamp(t0 - r, min=0.0)
    hi = torch.clamp(t0 + r, max=1.0)
    return torch.where(disc >= 0, lo, 1.0), torch.where(disc >= 0, hi, -1.0)


def _frechet_combine(left, right):
    """Composition of in-row maps (r, c, A, C, F): A composed non-reset map
    is x -> max(A, x) if F and x <= C else empty; the A1 <= C2 cross term
    keeps an interval that the first map lifts above the second's cap
    empty."""
    r1, c1, A1, C1, F1 = left
    r2, c2, A2, C2, F2 = right
    c12 = torch.where(F2 & (c1 <= C2), torch.maximum(A2, c1), INF)
    return (r1 | r2, torch.where(r2, c2, c12), torch.maximum(A1, A2),
            torch.minimum(C1, C2), F1 & F2 & (A1 <= C2))


def _sq_dist(a, b):
    d0, d1 = a[..., 0] - b[..., 0], a[..., 1] - b[..., 1]
    return d0 * d0 + d1 * d1


def _frechet_decision(p, q, eps, lengths=None):
    """Monotone free-space reachability (Alt & Godau): is F(p, q) <= eps?
    p (B, P, 2), q (B, Q, 2), eps (B,) -> (B,) bool. Rows over p's segments;
    in a row the reachable-lo propagation along q is one associative scan of
    the (r, c, A, C, F) maps. The free intervals of every row are computed
    at once (the same elementwise formula as the JAX package's per row).
    With ``lengths`` = (n, m), the true lengths (B,), -> (that, (B,) int64):
    also the cells (i, j) of each true grid whose R_V(i, j) or R_H(i, j) is
    nonempty, zero where the endpoints fail (the kernel's
    ``reached_cells``)."""
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]
    e = eps[:, None]
    e2 = eps * eps
    ok_ends = (_sq_dist(p[:, 0], q[:, 0]) <= e2) & (_sq_dist(p[:, -1], q[:, -1]) <= e2)
    true_col = torch.ones((B, 1), dtype=torch.bool, device=p.device)

    def reachable_border(lo, hi):  # R lo of the boundary edges (inf = unreachable)
        full = (lo <= 0.0) & (hi >= 1.0)
        prefix = torch.cat([true_col, torch.cumprod(full[:, :-1].to(torch.int32), -1) > 0], -1)
        out = torch.where(prefix & (lo <= 0.0), 0.0, INF)
        return torch.where(out <= hi, out, INF)

    # bottom boundary R_H(0, j) and left boundary R_V(i, 0)
    bottom = reachable_border(*_free_intervals(q[:, :-1], q[:, 1:], p[:, :1], e))
    rv0 = reachable_border(*_free_intervals(p[:, :-1], p[:, 1:], q[:, :1], e))
    # vertical edges V(i, j+1) and top edges H(i+1, j), rows i = 0..P-2
    v_lo, v_hi = _free_intervals(p[:, :-1, None], p[:, 1:, None], q[:, None, 1:], e[..., None])
    h_lo, h_hi = _free_intervals(q[:, None, :-1], q[:, None, 1:], p[:, 1:, None], e[..., None])
    reach_v = torch.zeros(B, dtype=torch.bool, device=p.device)
    if lengths is not None:
        rows = lengths[0] - 1
        cols = torch.arange(Q - 1, device=p.device)[None] < lengths[1][:, None] - 1
        cells = torch.zeros(B, dtype=torch.int64, device=p.device)
    for i in range(P - 1):
        a, h, rv_left = v_lo[:, i], v_hi[:, i], rv0[:, i:i + 1]
        # in-row propagation to R_V(i, j+1): reset to V(i, j+1) when the
        # bottom edge j is reachable, else clamped-max from R_V(i, j)
        r = bottom < INF
        c = torch.where(r & (a <= h), a, INF)
        rs, cs, As, Cs, Fs = associative_scan(_frechet_combine, (r, c, a, h, a <= h))
        base = torch.where(Fs & (rv_left <= Cs), torch.maximum(As, rv_left), INF)
        s = torch.where(rs, cs, base)  # lo of R_V(i, j+1), j = 0..Q-2
        rv_lo = torch.cat([rv_left, s[:, :-1]], -1)  # R_V(i, j), j = 0..Q-2
        if lengths is not None:
            cells += (((rv_lo < INF) | (bottom < INF)) & cols).sum(-1) * (i < rows)
        top = torch.where(rv_lo < INF, h_lo[:, i],
                          torch.where(bottom < INF, torch.maximum(h_lo[:, i], bottom), INF))
        bottom = torch.where(top <= h_hi[:, i], top, INF)
        reach_v = s[:, -1] < INF  # R_V(i, Q-1) nonempty
    ok = ok_ends & (reach_v | (bottom[:, -1] < INF))
    return ok if lengths is None else (ok, torch.where(ok_ends, cells, 0))


def _repeat_last(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x (B, L, 2) with every point at or past n[b] replaced by x[b, n[b]-1]:
    the bucket padding, whatever the padding held."""
    idx = torch.minimum(torch.arange(x.shape[1], device=x.device)[None], n[:, None] - 1)
    return x.gather(1, idx[..., None].expand(-1, -1, 2))


def bisection_round(lo, hi, levels: int, decide):
    """``levels`` bisection steps of every bracket (lo, hi) (B,) at once: the
    midpoints of the next ``levels`` levels of the bisection tree, in heap
    order (node v's children are 2v, taken when its decision holds, and
    2v + 1), decided together by ``decide`` ((B, 2^levels - 1) eps -> bool of
    that shape), then the walk down the decisions. Each midpoint is the
    expression the sequential step computes on the same bracket, so the
    result is that of ``levels`` sequential steps bit for bit. -> (lo, hi)."""
    l, h, mids = lo[:, None], hi[:, None], []
    for _ in range(levels):
        mid = 0.5 * (l + h)
        mids.append(mid)
        l = torch.stack([l, mid], -1).flatten(1)  # left child (l, mid), right (mid, h)
        h = torch.stack([mid, h], -1).flatten(1)
    mids = torch.cat(mids, 1)
    ok = decide(mids)
    v = torch.zeros_like(lo, dtype=torch.int64)[:, None]  # heap index - 1
    for _ in range(levels):
        mid, yes = mids.gather(1, v)[:, 0], ok.gather(1, v)
        lo, hi = torch.where(yes[:, 0], lo, mid), torch.where(yes[:, 0], mid, hi)
        v = 2 * v + 1 + (~yes).to(torch.int64)
    return lo, hi


def frechet_bisect(p, q, n, m, hi, depth: int = 1) -> torch.Tensor:
    """The plain version of ``ops/frechet_kernel.py``: 30 bisection steps of
    the decision from lo = max(endpoint distances) and the given hi (the
    discrete Frechet), over p[:n], q[:m] padded by repeating the last point,
    as the kernel's rounds of ``depth`` levels (``bisection_round``; each
    round decides the pairs repeated along its 2^depth - 1 candidates).
    Every depth gives depth 1's values bit for bit. -> (B,) float32."""
    p, q, n, m, _ = _prep(p, q, n, m)
    p, q = _repeat_last(p, n), _repeat_last(q, m)
    lo = torch.maximum(torch.sqrt(_sq_dist(p[:, 0], q[:, 0])),
                       torch.sqrt(_sq_dist(p[:, -1], q[:, -1])))
    hi = _tensor(hi, p.device, p.dtype).reshape(-1)
    for levels in frechet_kernel.round_levels(depth):
        C = 2 ** levels - 1
        pc, qc = p.repeat_interleave(C, 0), q.repeat_interleave(C, 0)
        lo, hi = bisection_round(
            lo, hi, levels,
            lambda eps: _frechet_decision(pc, qc, eps.reshape(-1)).reshape(eps.shape))
    return hi


def frechet(p, q):
    """Continuous (Euclidean, planar-degree) Frechet distance as bisection
    over the free-space decision, from hi = the discrete Frechet. Exact to
    ~1e-6 relative; the reference's critical-value solver underestimates on
    some inputs (see the JAX package's ``frechet_jax``)."""
    p, q, n, m, single = _prep(p, q)
    return _out(frechet_bisect(p, q, n, m, _discret_frechet_rows(_eucl_pdist(p, q), n, m)),
                single)


# --------------------------------------------------------------------------
# the 14-metric bundle (reference flyability_eval.py:271-351)


def _bucket_size(n: int, min_size: int = 32) -> int:
    """Bucket size for a trajectory of n points: next power of two up to
    2048, then the next multiple of 512 (bounded shape count, padding
    overhead <= 11% at real lengths)."""
    if n <= 2048:
        return max(min_size, 1 << (n - 1).bit_length())
    return -(-n // 512) * 512


def _bucket_pad(x: np.ndarray, min_size: int = 32) -> np.ndarray:
    """Pad a (n, 2) trajectory to its bucket size by repeating its last
    point. Repeated-endpoint padding adds only zero-length segments (exact
    for SSPD/Hausdorff/Frechet); the DP metrics read their answer at the
    true corner via the n/m arguments."""
    n = x.shape[0]
    size = _bucket_size(n, min_size)
    if size == n:
        return x
    return np.concatenate([x, np.repeat(x[-1:], size - n, axis=0)])


def _matrix_chunk(P: int, Q: int) -> int:
    """Pairs per sub-batch where (P, Q) matrices are materialised: ~6 such
    float32 buffers a pair within ~4 GB (the JAX package's rule)."""
    return max(1, int(4e9 // (6 * P * Q * 4)))


def shape_buckets(gens: Sequence[np.ndarray], sims: Sequence[np.ndarray], device):
    """Pairs grouped by padded shape as ``_score_bucket`` takes them, in order
    of first appearance: {(P, Q): (indices, p (B, P, 2), q (B, Q, 2), n, m
    (B,) int64)} on ``device``, float32, padded by repeating the last point."""
    groups = {}
    for i, (gp, sp) in enumerate(zip(gens, sims)):
        groups.setdefault((_bucket_size(len(gp)), _bucket_size(len(sp))), []).append(i)
    out = {}
    for key, idxs in groups.items():
        p = torch.from_numpy(np.stack([_bucket_pad(np.asarray(gens[i], np.float32))
                                       for i in idxs])).to(device)
        q = torch.from_numpy(np.stack([_bucket_pad(np.asarray(sims[i], np.float32))
                                       for i in idxs])).to(device)
        n = torch.tensor([len(gens[i]) for i in idxs], dtype=torch.int64, device=device)
        m = torch.tensor([len(sims[i]) for i in idxs], dtype=torch.int64, device=device)
        out[key] = (idxs, p, q, n, m)
    return out


def _score_bucket(p, q, n, m, g, eps) -> Dict[str, torch.Tensor]:
    """All 14 metrics of one bucket: p (B, P, 2), q (B, Q, 2) padded by
    repeating the last point, n, m (B,) int64 on p's device. The DP family
    and the Frechet go through the kernels on CUDA tensors and through their
    plain versions on CPU tensors; SSPD and Hausdorff are plain matrices in
    sub-batches."""
    B, P, Q = p.shape[0], p.shape[1], q.shape[1]
    chunk = _matrix_chunk(P, Q)
    out = {}
    for metric in ("euclidean", "spherical"):
        name = metric.capitalize()
        parts = [(sspd(p[s:s + chunk], q[s:s + chunk], metric, n[s:s + chunk], m[s:s + chunk]),
                  hausdorff(p[s:s + chunk], q[s:s + chunk], metric, n[s:s + chunk], m[s:s + chunk]))
                 for s in range(0, B, chunk)]
        out[f"SSPD {name}"] = torch.cat([a for a, _ in parts])
        out[f"Hausdorff {name}"] = torch.cat([b for _, b in parts])
    variants = dp_variants(eps)
    spec = [v[1:] for v in variants]
    cuda = p.device.type == "cuda"
    if cuda:
        dp = traj_dp_kernel.traj_dp(p, q, n, m, g, spec)
    else:  # the plain row loops materialise (P, Q) costs: sub-batches
        dp = torch.cat([dp_metrics(p[s:s + chunk], q[s:s + chunk], n[s:s + chunk],
                                   m[s:s + chunk], g, spec)
                        for s in range(0, B, chunk)])
    for k, (key, *_) in enumerate(variants):
        out[key] = dp[:, k]
    hi = out["Discrete Frechet"].contiguous()
    out["Frechet"] = (frechet_kernel.frechet if cuda else frechet_bisect)(p, q, n, m, hi)
    return out


def calculate_trajectory_distances_batch(
    gens: Sequence[np.ndarray], sims: Sequence[np.ndarray], adep_latlon,
    eps: float = 0.009, device="cuda",
) -> Dict[str, list]:
    """All 14 metrics for a list of flight pairs ((n, 2) / (m, 2) [lat, lon]
    arrays), bucketed by padded shape. Returns {metric: [per-flight values]}
    in input order, with the reference's key names. On the card each bucket
    is one DP kernel launch, then the continuous Frechet's rounds."""
    dev = resolve_device(device)
    g = torch.tensor(np.asarray(adep_latlon, np.float32), device=dev)
    out = {k: [None] * len(gens) for k in KEYS}
    for idxs, p, q, n, m in shape_buckets(gens, sims, dev).values():
        vals = _score_bucket(p, q, n, m, g, eps)
        for k in KEYS:
            for j, v in zip(idxs, vals[k].cpu().tolist()):
                out[k][j] = float(v)
    return out


def calculate_trajectory_distances(
    gen_traj: np.ndarray, sim_traj: np.ndarray, adep_latlon, eps: float = 0.009,
    device="cuda",
) -> Dict[str, float]:
    """One flight pair: (n, 2) / (m, 2) [lat, lon] arrays -> the reference's
    14 metrics with its exact key names and epsilon conventions."""
    out = calculate_trajectory_distances_batch([gen_traj], [sim_traj], adep_latlon, eps, device)
    return {k: v[0] for k, v in out.items()}
