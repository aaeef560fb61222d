"""SOWD (Symmetric One-Way Distance) on a geohash grid and the all-pairs
segment distance, in PyTorch.

The port of ``tvqvae_tpu/evaluation/flyability/sowd.py`` (reference
trajectory_distances/sowd.py, linecell.py, segment_distance.py; dead,
unexported code in the reference, ported there in working form). The
geohash encode/decode and the rasterisation onto the grid are host
numpy/Python, copied as they are; the one-way distance over cell sequences
and the TRACLUS segment distance are broadcasted plain PyTorch. The numpy
entry points take ``device`` ("cuda" unless the caller asks for the CPU);
``owd_matrix`` and ``segments_distance_t`` run on their tensors' device.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.utils.device import resolve_device

__all__ = [
    "geohash_encode",
    "geohash_decode_exactly",
    "trajectory_set_grid",
    "owd_grid_brut",
    "sowd_grid",
    "sowd",
    "segments_distance",
]

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash_encode(lat: float, lon: float, precision: int = 7) -> str:
    """Standard geohash encoding (5 bits/char, lon first on even bits)."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    chars = []
    for i in range(0, len(bits), 5):
        v = 0
        for b in bits[i:i + 5]:
            v = (v << 1) | b
        chars.append(_BASE32[v])
    return "".join(chars)


def geohash_decode_exactly(gh: str) -> Tuple[float, float, float, float]:
    """-> (lat_center, lon_center, lat_err, lon_err), like
    geohash2.decode_exactly (the linecell.py:148-149 call)."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for ch in gh:
        v = _BASE32.index(ch)
        for shift in range(4, -1, -1):
            bit = (v >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return (
        (lat_lo + lat_hi) / 2,
        (lon_lo + lon_hi) / 2,
        (lat_hi - lat_lo) / 2,
        (lon_hi - lon_lo) / 2,
    )


def _grid_for(traj_set: Sequence[np.ndarray], precision: int):
    """Geohash-aligned cell grid covering the trajectory set, identical to
    linecell.trajectory_set_grid:142-153 (cell edges at the decoded corner
    cells' edges, width 2*dlon / 2*dlat)."""
    allpts = np.concatenate([np.asarray(t, float) for t in traj_set])
    lon_min, lat_min = allpts[:, 0].min(), allpts[:, 1].min()
    lon_max, lat_max = allpts[:, 0].max(), allpts[:, 1].max()
    lat_ble, lon_ble, dlat, dlon = geohash_decode_exactly(
        geohash_encode(lat_min, lon_min, precision)
    )
    lat_tre, lon_tre, _, _ = geohash_decode_exactly(
        geohash_encode(lat_max, lon_max, precision)
    )
    lats_all = np.arange(lat_ble - dlat, lat_tre + 3 * dlat, dlat * 2)
    lons_all = np.arange(lon_ble - dlon, lon_tre + 3 * dlon, dlon * 2)
    return lons_all, lats_all, dlon, dlat


def _cell_of(p, lons_all, lats_all):
    cx = int(np.searchsorted(lons_all, p[0], side="right") - 1)
    cy = int(np.searchsorted(lats_all, p[1], side="right") - 1)
    return cx, cy


def _raster_segment(p0, p1, lons_all, lats_all):
    """Cells crossed by segment p0->p1, in order, via exact crossings of the
    grid lines (the closed-form of linecell's shapely intersections)."""
    c0 = _cell_of(p0, lons_all, lats_all)
    c1 = _cell_of(p1, lons_all, lats_all)
    cells = [c0]
    dx = p1[0] - p0[0]
    dy = p1[1] - p0[1]
    # parametric crossing times of every interior grid line
    ts = []
    if dx != 0:
        lo, hi = sorted((c0[0], c1[0]))
        for k in range(lo + 1, hi + 1):
            ts.append(((lons_all[k] - p0[0]) / dx, "x", 1 if dx > 0 else -1))
    if dy != 0:
        lo, hi = sorted((c0[1], c1[1]))
        for k in range(lo + 1, hi + 1):
            ts.append(((lats_all[k] - p0[1]) / dy, "y", 1 if dy > 0 else -1))
    ts.sort(key=lambda t: t[0])
    cx, cy = c0
    for _, axis, step in ts:
        if axis == "x":
            cx += step
        else:
            cy += step
        cells.append((cx, cy))
    return cells


def trajectory_set_grid(
    traj_set: Sequence[np.ndarray], precision: int = 7
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Rasterize each (n, 2) lon/lat trajectory onto the shared geohash
    grid -> list of (m_i, 2) int cell-index arrays (consecutive duplicates
    collapsed, like linecell.py:200-209), plus the grid edge vectors."""
    lons_all, lats_all, _, _ = _grid_for(traj_set, precision)
    out = []
    for traj in traj_set:
        traj = np.asarray(traj, float)
        cells = []
        for i in range(len(traj) - 1):
            seg = _raster_segment(traj[i], traj[i + 1], lons_all, lats_all)
            if cells and seg and tuple(cells[-1]) == tuple(seg[0]):
                seg = seg[1:]
            cells.extend(seg)
        if not cells:  # single-point trajectory
            cells = [_cell_of(traj[0], lons_all, lats_all)]
        out.append(np.asarray(cells, np.int32))
    return out, lons_all, lats_all


def owd_matrix(c1: torch.Tensor, c2: torch.Tensor,
               m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """(mean over valid c1 of min over valid c2 distance) with padding
    masks; one broadcasted distance matrix."""
    diff = c1[:, None, :].to(torch.float32) - c2[None, :, :].to(torch.float32)
    d = torch.sqrt(torch.sum(diff * diff, -1))
    d = torch.where(m2[None, :], d, float("inf"))
    mins = torch.amin(d, dim=1)
    return torch.sum(torch.where(m1, mins, 0.0)) / torch.clamp(m1.sum(), min=1)


def owd_grid_brut(cells1, cells2, device="cuda") -> float:
    """Reference sowd.py:10-32 semantics on (m, 2) cell arrays."""
    dev = resolve_device(device)
    c1 = torch.as_tensor(np.asarray(cells1, np.float32), device=dev)
    c2 = torch.as_tensor(np.asarray(cells2, np.float32), device=dev)
    m1 = torch.ones(len(c1), dtype=torch.bool, device=dev)
    m2 = torch.ones(len(c2), dtype=torch.bool, device=dev)
    return float(owd_matrix(c1, c2, m1, m2))


def sowd_grid(cells1, cells2, device="cuda") -> float:
    """Symmetrized OWD over pre-gridded cell sequences (sowd.py:142-151;
    the reference's brute and pruned variants agree)."""
    return 0.5 * (owd_grid_brut(cells1, cells2, device)
                  + owd_grid_brut(cells2, cells1, device))


def sowd(traj_1: np.ndarray, traj_2: np.ndarray, precision: int = 7,
         converted: bool = False, device="cuda") -> float:
    """sowd.py:154-160 in working form (the reference's non-converted path
    crashes on its own trajectory_set_grid return arity)."""
    if converted:
        return sowd_grid(np.asarray(traj_1)[:, :2], np.asarray(traj_2)[:, :2], device)
    cells, _, _ = trajectory_set_grid([np.asarray(traj_1), np.asarray(traj_2)], precision)
    return sowd_grid(cells[0], cells[1], device)


# --------------------------------------------------------------------------
# all-pairs segment distance (segment_distance.py:15-84)


def _ordered_mixed_distance(si, ei, sj, ej):
    """ordered_mixed_distance broadcast over (I, J) pairs; inputs (I, J, 2),
    the "i" segment the longer one."""
    siei = ei - si
    sjej = ej - sj
    n2_i = torch.sum(siei * siei, -1)
    n2_j = torch.sum(sjej * sjej, -1)
    n_i = torch.sqrt(n2_i)
    n_j = torch.sqrt(n2_j)
    sisj = sj - si
    siej = ej - si
    u1 = torch.sum(sisj * siei, -1) / n2_i
    u2 = torch.sum(siej * siei, -1) / n2_i
    ps = si + u1[..., None] * siei
    pe = si + u2[..., None] * siei
    cos_t = torch.clamp(torch.sum(sjej * siei, -1) / (n_i * n_j), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    lpe1 = torch.linalg.vector_norm(sj - ps, dim=-1)
    lpe2 = torch.linalg.vector_norm(ej - pe, dim=-1)
    den = lpe1 + lpe2
    dped = torch.where(den > 0, (lpe1 ** 2 + lpe2 ** 2) / torch.clamp(den, min=1e-30), 0.0)
    lpa1 = torch.minimum(torch.linalg.vector_norm(si - ps, dim=-1),
                         torch.linalg.vector_norm(ei - ps, dim=-1))
    lpa2 = torch.minimum(torch.linalg.vector_norm(si - pe, dim=-1),
                         torch.linalg.vector_norm(ei - pe, dim=-1))
    dpad = torch.minimum(lpa1, lpa2)
    dad = torch.where(theta < np.float32(np.pi / 2), n_j * torch.sin(theta), n_j)
    return (dped + dpad + dad) / 3.0


def segments_distance_t(t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """(n0, 2) x (n1, 2) float32 -> (n0-1, n1-1) TRACLUS mixed distances."""
    s_i, e_i = t0[:-1], t0[1:]
    s_j, e_j = t1[:-1], t1[1:]
    I, J = s_i.shape[0], s_j.shape[0]
    si = s_i[:, None, :].expand(I, J, 2)
    ei = e_i[:, None, :].expand(I, J, 2)
    sj = s_j[None, :, :].expand(I, J, 2)
    ej = e_j[None, :, :].expand(I, J, 2)
    # the longer segment of each pair plays the "i" role
    # (segment_distance.py:65-72)
    n2_i = torch.sum((ei - si) ** 2, -1)
    n2_j = torch.sum((ej - sj) ** 2, -1)
    swap = (n2_j > n2_i)[..., None]
    return _ordered_mixed_distance(torch.where(swap, sj, si), torch.where(swap, ej, ei),
                                   torch.where(swap, si, sj), torch.where(swap, ei, ej))


def segments_distance(traj_0: np.ndarray, traj_1: np.ndarray, device="cuda") -> np.ndarray:
    """(n0-1, n1-1) matrix of TRACLUS mixed distances between every segment
    pair, as one broadcasted computation."""
    dev = resolve_device(device)
    t0 = torch.as_tensor(np.asarray(traj_0, np.float32)[:, :2], device=dev)
    t1 = torch.as_tensor(np.asarray(traj_1, np.float32)[:, :2], device=dev)
    return segments_distance_t(t0, t1).cpu().numpy()
