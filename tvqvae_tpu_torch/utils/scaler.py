"""Min-max feature scaling to (-1, 1).

A copy of ``tvqvae_tpu/utils/scaler.py`` (the equivalent of sklearn's
MinMaxScaler(feature_range=(-1, 1))), with the same ``to_state`` layout, so a
scaler saved by the JAX package loads here.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class MinMaxScaler:
    feature_range: tuple = (-1.0, 1.0)
    data_min_: np.ndarray = None
    data_max_: np.ndarray = None

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        """x: (n_samples, n_features)"""
        self.data_min_ = np.asarray(x).min(axis=0)
        self.data_max_ = np.asarray(x).max(axis=0)
        return self

    @property
    def scale_(self) -> np.ndarray:
        lo, hi = self.feature_range
        rng = self.data_max_ - self.data_min_
        rng = np.where(rng == 0.0, 1.0, rng)
        return (hi - lo) / rng

    @property
    def min_(self) -> np.ndarray:
        lo, _ = self.feature_range
        return lo - self.data_min_ * self.scale_

    def transform(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x) * self.scale_ + self.min_

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) - self.min_) / self.scale_

    def to_state(self) -> dict:
        return {
            "feature_range": np.asarray(self.feature_range),
            "data_min": self.data_min_,
            "data_max": self.data_max_,
        }

    @staticmethod
    def from_state(state: dict) -> "MinMaxScaler":
        s = MinMaxScaler(feature_range=tuple(np.asarray(state["feature_range"]).tolist()))
        s.data_min_ = np.asarray(state["data_min"])
        s.data_max_ = np.asarray(state["data_max"])
        return s
