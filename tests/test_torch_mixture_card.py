"""The port's Gaussian mixture and the preprocess CLIs on the card against
the same code on the CPU, as ``chip_smoke.py``'s ``[preprocess]`` (c) holds
the mixture.

Torch only, so the card's machine (no JAX, no scikit-learn) runs it:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mixture_card.py

The ``gpu`` cases skip without a card. Seeded corridor features at N=512,
D=400, K=5 (more features than flights in a component, as in
``prepare_trajectories``) and at N=400, D=12, K=4 with overlapping
corridors (soft responsibilities, many EM iterations): the k-means++ centres
and the labels equal, the iterations equal, the means within 1e-9 relative
and the lower bound within 1e-9 relative. Then both CLIs, ``preprocess`` on
a small OpenSky export (``chip_smoke.write_opensky_csv`` at 300 points a
flight) and ``preprocess_landing`` on a chunked approach file, with
``--device cuda`` and ``--device cpu``: the same ``.npz`` (the host work is
the same code; the labels come from the two devices' mixtures).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import corridor_features, mixture_fit
from tvqvae_tpu_torch.data import mixture
from tvqvae_tpu_torch.data.preprocess import AIRPORTS
from tvqvae_tpu_torch.scripts import preprocess, preprocess_landing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the check is the card against the CPU")


@pytest.mark.gpu
@pytest.mark.parametrize("n,points,k,spread,pinned", [(512, 200, 5, 1.5, True),
                                                      (400, 6, 4, 2.5, False)])
def test_mixture_on_card_matches_cpu(card, n, points, k, spread, pinned):
    F, _ = corridor_features(n, points, k, spread, seed=13, pinned_ends=pinned)
    Fs = mixture.StandardScaler(device="cpu").fit_transform(F)
    idx = [mixture.kmeans_plusplus(Fs.to(dev), k, np.random.RandomState(199))[1]
           for dev in ("cuda", "cpu")]
    np.testing.assert_array_equal(*idx)
    (lc, gc), (lh, gh) = (mixture_fit(torch, F, k, dev) for dev in ("cuda", "cpu"))
    np.testing.assert_array_equal(lc, lh)
    assert gc.n_iter_ == gh.n_iter_
    rel = float((gc.means_.cpu() - gh.means_).abs().max() / gh.means_.abs().max())
    assert rel <= 1e-9
    assert abs(gc.lower_bound_ - gh.lower_bound_) <= 1e-9 * abs(gh.lower_bound_)


def _landing_csv(path, n_flights=12, points=200, seed=0):
    """Approaches to ENGM from two directions, one aircraft each, a day
    apart, stamps every 12 s."""
    rng = np.random.default_rng(seed)
    lat1, lon1 = AIRPORTS["ENGM"]
    epoch = np.datetime64("2021-06-01T00:00:00", "s")
    lines = ["timestamp,latitude,longitude,altitude,icao24,callsign"]
    for i in range(n_flights):
        t = np.linspace(0, 1, points)
        lat = lat1 - 0.8 * (1 - t) * (1 if i % 2 else -1) + rng.normal(0, 0.002, points)
        lon = lon1 - 1.2 * (1 - t) + rng.normal(0, 0.002, points)
        lat[-1], lon[-1] = lat1, lon1
        alt = 200 + 15000 * (1 - t) ** 1.5 + rng.normal(0, 20, points)
        stamps = np.datetime_as_string(epoch + i * 86400 + (t * 2400).astype(np.int64))
        lines += [f"{s}+00:00,{a:.6f},{o:.6f},{h:.1f},cd{i:04d},SAS{i:03d}"
                  for s, a, o, h in zip(stamps, lat, lon, alt)]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.gpu
def test_preprocess_clis_on_card_match_cpu(card, tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PREP_POINTS", 300)
    (tmp_path / "raw" / "OpenSky").mkdir(parents=True)
    (tmp_path / "raw" / "landing").mkdir()
    chip_smoke.write_opensky_csv(str(tmp_path / "raw" / "OpenSky" / "os_EHAM_LIMC.csv"))
    _landing_csv(tmp_path / "raw" / "landing" / "landing_ENGM.csv")
    runs = {"OpenSky_EHAM_LIMC.npz": (preprocess.main, ["--data_source", "OpenSky"]),
            "landing_ENGM.npz": (preprocess_landing.main, ["--chunk_size", "500",
                                                           "--n_clusters", "2"])}
    for name, (main, argv) in runs.items():
        out = {}
        for dev in ("cuda", "cpu"):
            got = main(argv + ["--raw_data_dir", str(tmp_path / "raw"), "--save_dir",
                               str(tmp_path / dev), "--device", dev])
            out[dev] = np.load(os.path.join(tmp_path / dev, name))
            assert got["path"].endswith(name)
        np.testing.assert_array_equal(out["cuda"]["y"], out["cpu"]["y"])
        np.testing.assert_array_equal(out["cuda"]["X"], out["cpu"]["X"])
        assert len(np.unique(out["cuda"]["y"])) > 1
