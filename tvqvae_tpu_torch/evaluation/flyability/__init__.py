from .distances import (
    calculate_trajectory_distances,
    discret_frechet,
    dtw,
    edr,
    erp,
    frechet,
    hausdorff,
    lcss,
    sspd,
)
from .bluesky import (
    BlueSkyConfig,
    build_logger,
    build_scenario,
    clean,
    simulate,
)
from .sowd import (
    segments_distance,
    sowd,
    sowd_grid,
    trajectory_set_grid,
)

__all__ = [
    "calculate_trajectory_distances",
    "discret_frechet",
    "dtw",
    "edr",
    "erp",
    "frechet",
    "hausdorff",
    "lcss",
    "sspd",
    "BlueSkyConfig",
    "build_logger",
    "build_scenario",
    "clean",
    "simulate",
    "segments_distance",
    "sowd",
    "sowd_grid",
    "trajectory_set_grid",
]
