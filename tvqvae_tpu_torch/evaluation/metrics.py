"""Metrics engine: FID, IS and the TSGBench statistics over cached features.

Port of ``tvqvae_tpu/evaluation/metrics.py``. The featuriser is the ROCKET
bank (``rocket.py``, on ``device``) or the supervised FCN (``models/fcn.py``
from a trained checkpoint's tree, on ``device``); the train and test feature
matrices are computed once, at construction, and reused by every FID of a
validation or an evaluation. The scores themselves are host numpy
(``eval_utils.py``, ``stat_metrics.py``).
"""

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.evaluation.eval_utils import (
    calculate_fid,
    calculate_inception_score,
    remove_outliers,
)
from tvqvae_tpu_torch.evaluation.rocket import RocketKernels, apply_kernels, generate_kernels
from tvqvae_tpu_torch.evaluation.stat_metrics import (
    auto_correlation_difference,
    kurtosis_difference,
    marginal_distribution_difference,
    skewness_difference,
)
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.utils.convert import fcn_from_jax
from tvqvae_tpu_torch.utils.device import resolve_device


class Metrics:
    def __init__(
        self,
        input_length: int,
        in_channels: int,
        n_classes: int,
        batch_size: int,
        X_train: np.ndarray,
        X_test: np.ndarray,
        feature_extractor_type: str = "rocket",
        fcn_variables: Optional[Mapping] = None,
        rocket_num_kernels: int = 1000,
        fid_method: str = "schur",
        device="cuda",
    ):
        """``fcn_variables``: the FCN's ``{"params", "batch_stats"}`` tree in
        the JAX package's layout, as its checkpoint holds it."""
        self.feature_extractor_type = feature_extractor_type
        self.fid_method = fid_method
        self.batch_size = batch_size
        self.n_classes = n_classes
        self.device = resolve_device(device)
        self.X_train = np.asarray(X_train)
        self.X_test = np.asarray(X_test)

        self._fcn = None
        if feature_extractor_type == "supervised_fcn":
            if fcn_variables is None:
                raise ValueError("FCN features need the trained FCN's variables")
            self._fcn = FCN(in_channels, n_classes)
            self._fcn.load_state_dict(fcn_from_jax(fcn_variables))
            self._fcn.to(self.device).eval()
        elif feature_extractor_type == "rocket":
            self.rocket_kernels: RocketKernels = generate_kernels(
                self.X_train.shape[-1], num_kernels=rocket_num_kernels)
        else:
            raise ValueError(feature_extractor_type)

        self.z_train = self.compute_z(self.X_train)
        self.z_test = self.compute_z(self.X_test)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _fcn_out(self, x: np.ndarray, features: bool) -> torch.Tensor:
        xb = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self._fcn(xb, features=features)

    def extract_feature_representations(self, x: np.ndarray) -> np.ndarray:
        """(B, C, L) -> (B, D) float32 features: the FCN's pooled 128, or
        ROCKET's 2K of channel 0, L2-normalised on the host."""
        if self.feature_extractor_type == "supervised_fcn":
            return self._fcn_out(x, features=True).cpu().numpy()
        z = apply_kernels(np.asarray(x)[:, 0, :].astype(np.float64), self.rocket_kernels,
                          device=self.device)
        norm = np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-12)
        return (z / norm).astype(np.float32)

    def compute_z(self, x: np.ndarray) -> np.ndarray:
        zs = [self.extract_feature_representations(x[s:s + self.batch_size])
              for s in range(0, x.shape[0], self.batch_size)]
        return np.concatenate(zs, axis=0)

    def z_gen_fn(self, x_gen: np.ndarray) -> np.ndarray:
        return self.compute_z(x_gen)

    # ------------------------------------------------------------------

    def fid_score(self, z1: np.ndarray, z2: np.ndarray, method: Optional[str] = None) -> float:
        """FID of the isolation-forest inliers of each set; ``method``
        overrides the instance's (``"schur"`` or ``"svd"``)."""
        return calculate_fid(remove_outliers(z1), remove_outliers(z2),
                             method=method or self.fid_method)

    def inception_score(self, x_gen: np.ndarray, n_split: int = 5):
        """IS over the FCN's softmax posteriors; unseeded, as in JAX."""
        if self._fcn is None:
            raise ValueError("IS needs the supervised FCN")
        ps = [torch.softmax(self._fcn_out(x_gen[s:s + self.batch_size], features=False), -1)
              .cpu().numpy() for s in range(0, x_gen.shape[0], self.batch_size)]
        return calculate_inception_score(np.concatenate(ps), n_split=n_split)

    def stat_metrics(self, x_real: np.ndarray, x_gen: np.ndarray
                     ) -> Tuple[float, float, float, float]:
        """(MDD, ACD, SD, KD)."""
        mdd = marginal_distribution_difference(x_real, x_gen)
        acd = auto_correlation_difference(x_real, x_gen)
        sd = skewness_difference(x_real, x_gen)
        kd = kurtosis_difference(x_real, x_gen)
        return mdd, acd, sd, kd
