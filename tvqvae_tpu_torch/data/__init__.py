from .dataset import (
    DatasetSplits,
    get_data,
    load_trajectories,
    make_batches,
    make_synthetic_trajectories,
    save_npz,
)

__all__ = [
    "DatasetSplits",
    "get_data",
    "load_trajectories",
    "make_batches",
    "make_synthetic_trajectories",
    "save_npz",
]
