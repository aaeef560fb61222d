"""The port's ``config.py`` is pinned to the JAX package's: the defaults and
every config file of the repo parse to the same values in both, so a drift
in budgets, learning rates, intervals or the ESS rate cannot pass unseen
(the parity tests read only the shape fields)."""

import dataclasses
from pathlib import Path

import pytest

from test_torch_sampler import CFG
from tvqvae_tpu.config import Config as JConfig
from tvqvae_tpu_torch.config import Config

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


def test_there_are_config_files():
    assert [p.name for p in CONFIGS] == ["config.yaml", "fcn_config.yaml"]


def test_defaults_match():
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JConfig())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_files_match(path):
    assert dataclasses.asdict(Config.from_yaml(str(path))) == \
        dataclasses.asdict(JConfig.from_yaml(str(path)))


def test_from_dict_matches():
    d = {**CFG, "MaskGIT": {**CFG["MaskGIT"], "ESS": {"use": True, "error_ratio_ma_rate": 0.5},
                            "cfg_scale": 2}, "exp_params": {"lr": 3e-4},
         "trainer_params": {"max_steps": {"stage1": 7}}, "seed": 3}
    assert dataclasses.asdict(Config.from_dict(d)) == dataclasses.asdict(JConfig.from_dict(d))
