from .eval_utils import (
    calculate_fid,
    calculate_inception_score,
    remove_outliers,
)
from .metrics import Metrics
from .rocket import MiniRocket, RocketKernels, apply_kernels, generate_kernels
from .stat_metrics import (
    auto_correlation_difference,
    kurtosis_difference,
    marginal_distribution_difference,
    skewness_difference,
)

__all__ = [
    "calculate_fid",
    "calculate_inception_score",
    "remove_outliers",
    "Metrics",
    "MiniRocket",
    "RocketKernels",
    "apply_kernels",
    "generate_kernels",
    "auto_correlation_difference",
    "kurtosis_difference",
    "marginal_distribution_difference",
    "skewness_difference",
]
