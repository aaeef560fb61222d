"""The near-tie rule of ``chip_smoke.py`` for the VQ kernel's token checks.

``chip_smoke.py`` holds the kernel's tokens to its plain twin's on the card
at three sites (the published-width train step, the stage-2 sweep, the
stage-3 x' sweep). Two correct float32 evaluations of the distances can pick
different codes where two codes lie within rounding of each other;
``vq_near_ties`` lets such a row pass only within the forward-error bound of
``vq_tie_bounds`` and only up to ``VQ_TIE_CAP`` of the rows. Here, on the
CPU: the bound holds for the plain twin's float32 distances; float32
near-ties the plain twin resolves against float64 pass, with their count and
ratio; a wrong token, a pair far from the float64 nearest code and flips
above the cap fail.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    VQ_TIE_CAP,
    AssignTape,
    given_assignment,
    same_latent_ties,
    vq_near_ties,
    vq_tie_bounds,
)
from tvqvae_tpu_torch.ops import vq_kernel

K, D = 32, 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codebook(seed=0, k=K, d=D):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(k, d)).astype(np.float32))


def _random_rows(n, seed=1, d=D, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).normal(size=(n, d)))
                            .astype(np.float32))


def _near_ties(embed, n, seed=2, a=0, c=1, spread=1e-5):
    """n rows about the bisector of codes a and c, within ``spread`` of it."""
    rng = np.random.default_rng(seed)
    ea, ec = embed[a].double(), embed[c].double()
    u = (ea - ec) / (ea - ec).norm()
    noise = torch.from_numpy(rng.normal(size=(n, embed.shape[1]))) * 0.3
    noise = noise - (noise @ u)[:, None] * u[None]
    t = torch.from_numpy(rng.uniform(-1, 1, size=n)) * spread
    return ((ea + ec)[None] / 2 + noise + t[:, None] * u[None]).float()


def _flips(embed, n_max, seed=2):
    """Rows whose plain float32 code differs from the float64 nearest one,
    with both codes: (rows, float64 codes, plain codes)."""
    x = _near_ties(embed, 4000, seed)
    d, _ = vq_tie_bounds(x, embed)
    i64 = d.argmax(1).to(torch.int32)
    i32 = vq_kernel.nearest_codes_stats_plain(x, embed)[0]
    rows = torch.nonzero(i64 != i32).flatten()[:n_max]
    assert len(rows) == n_max, "too few float32 near-ties drawn"
    return x[rows], i64[rows], i32[rows]


@pytest.mark.parametrize("d,scale,offset", [(128, 1.0, 0.0), (64, 1.0, 0.0), (128, 30.0, 0.0),
                                            (128, 1.0, 50.0)])
def test_bound_holds_for_the_plain_twin(d, scale, offset):
    """|d32 - d64| <= b entrywise for the plain twin's float32 distances, also
    at large norms and far from the origin (where |x|^2 and |e|^2 cancel)."""
    embed = _codebook(3, d=d) * scale + offset
    x = _random_rows(512, 4, d=d, scale=scale) + offset
    d64, b = vq_tie_bounds(x, embed)
    d32 = 2.0 * (x @ embed.T) - (x * x).sum(-1, keepdim=True) - (embed * embed).sum(-1)
    assert bool(((d32.double() - d64).abs() <= b).all())
    assert float(((d32.double() - d64).abs() / b).max()) > 0


def test_accepts_float32_near_ties():
    """A few rows the plain twin's float32 argmax resolves against the
    float64 one, among agreeing rows: they pass, counted, with the ratio."""
    embed = _codebook()
    tie_x, i64, i32 = _flips(embed, 3)
    x = torch.cat([_random_rows(4000), tie_x])
    good = torch.cat([vq_tie_bounds(x[:4000], embed)[0].argmax(1).to(torch.int32), i64])
    plain = vq_kernel.nearest_codes_stats_plain(x, embed)[0]
    ties = vq_near_ties([(x, embed, good, plain)])
    assert ties["compared"] == len(x)
    assert ties["differing"] == 3
    assert 0.0 < ties["max_ratio"] <= 1.0
    assert ties["within_bound"] >= 3 and ties["bad"] == 0
    assert [r["codes"] for r in ties["rows"]] == [(int(a), int(c)) for a, c in zip(i64, i32)]
    assert all(r["nearest"] in r["codes"] for r in ties["rows"])


def test_no_difference_reports_zero():
    embed, x = _codebook(), _random_rows(1000)
    idx = vq_kernel.nearest_codes_stats_plain(x, embed)[0]
    ties = vq_near_ties([(x, embed, idx, idx.clone()), (x[:10], embed, idx[:10], idx[:10])])
    assert (ties["compared"], ties["differing"], ties["max_ratio"], ties["rows"]) == (
        1010, 0, 0.0, [])


def test_rejects_a_wrong_token():
    """One token set to a code far from the row: gap far above the bound."""
    embed, x = _codebook(), _random_rows(4000)
    idx = vq_kernel.nearest_codes_stats_plain(x, embed)[0]
    wrong = idx.clone()
    d, b = vq_tie_bounds(x[:1], embed)
    wrong[0] = int(d[0].argmin())
    with pytest.raises(AssertionError, match="beyond float32 rounding"):
        vq_near_ties([(x, embed, idx, wrong)])


def test_rejects_a_pair_far_from_the_nearest_code():
    """Both sides' codes lie within the bound of each other, but the float64
    nearest code is a third, far nearer, one."""
    embed, x = _codebook(), _random_rows(2000)
    v = _random_rows(1, 5)[0]
    row = x[0].clone()
    embed[0], embed[1], embed[2] = row + v, row - v, row + 1e-3
    x[0] = row
    idx = vq_kernel.nearest_codes_stats_plain(x, embed)[0]
    a, c = idx.clone(), idx.clone()
    a[0], c[0] = 0, 1
    d, b = vq_tie_bounds(x[:1], embed)
    assert abs(float(d[0, 0] - d[0, 1])) <= float(b[0, 0] + b[0, 1])
    with pytest.raises(AssertionError, match="beyond float32 rounding"):
        vq_near_ties([(x, embed, a, c)])


def test_rejects_flips_above_the_cap():
    """Honest near-ties, but more of them than VQ_TIE_CAP of the rows."""
    embed = _codebook()
    n_flips = 6
    tie_x, i64, i32 = _flips(embed, n_flips, seed=6)
    n_rows = int(n_flips / VQ_TIE_CAP) - 1000  # the flips are ~0.12% of the rows
    x = torch.cat([_random_rows(n_rows - n_flips), tie_x])
    good = vq_kernel.nearest_codes_stats_plain(x[:-n_flips], embed)[0]
    with pytest.raises(AssertionError, match="above the near-tie cap"):
        vq_near_ties([(x, embed, torch.cat([good, i64]), torch.cat([good, i32]))])
    # the same flips among enough rows pass
    x = torch.cat([_random_rows(int(n_flips / VQ_TIE_CAP)), tie_x])
    good = vq_kernel.nearest_codes_stats_plain(x[:-n_flips], embed)[0]
    ties = vq_near_ties([(x, embed, torch.cat([good, i64]), torch.cat([good, i32]))])
    assert ties["differing"] == n_flips


def test_same_latent_ties_and_given_assignment(capsys):
    """The tapes record what each side saw; on bit-equal latents the rule
    compares the two runs' own indices, on other latents the plain twin is
    handed the kernel side's rows. ``given_assignment`` returns the plain
    statistics of another side's indices."""
    embed, x = _codebook(), _random_rows(300)
    plain = vq_kernel.nearest_codes_stats_plain
    a, c = AssignTape(plain), AssignTape(plain)
    a(x, embed), c(x, embed)
    assert same_latent_ties(torch, vq_kernel, a, c, "[t]")["differing"] == 0
    assert "bit-equal latents in both runs: True" in capsys.readouterr().out
    c2 = AssignTape(plain)
    c2(x + 1e-3, embed)
    ties = same_latent_ties(torch, vq_kernel, a, c2, "[t]")
    out = capsys.readouterr().out
    assert "finding: the plain twin's run saw other latents" in out and ties["differing"] == 0
    idx, counts, sums = given_assignment(torch, [a.calls[0][2]])(x, embed)
    p_idx, p_counts, p_sums = plain(x, embed)
    assert torch.equal(idx, p_idx) and torch.equal(counts, p_counts)
    assert torch.allclose(sums, p_sums, rtol=0, atol=1e-5)
