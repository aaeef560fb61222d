"""Trajectory dataset loading, scaling, and batching.

Port of ``tvqvae_tpu/data/dataset.py``, numpy only, with the same results
for the same inputs and seeds:
  - per-(time, feature) min-max scaling to (-1, 1), fitted on the raveled
    (N, L*C) matrix (``utils/scaler.py``);
  - (B, C, L) channel-first arrays;
  - the seeded 90/10 permutation split (seed 42, the legacy global numpy
    generator's stream, here from a ``RandomState`` of that seed);
  - ``make_batches``: one ``default_rng(seed)`` permutation per epoch.

Two formats: ``.npz`` with X (N, C, L) and y (N,), and pickled
``traffic.Traffic`` objects where the optional ``traffic`` library is
installed (``ImportError`` otherwise).
"""

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tvqvae_tpu_torch.utils.scaler import MinMaxScaler


@dataclass
class DatasetSplits:
    X_train: np.ndarray  # (N_train, C, L)
    y_train: np.ndarray  # (N_train, 1)
    X_test: np.ndarray
    y_test: np.ndarray
    scaler: MinMaxScaler
    n_classes: int

    @property
    def input_length(self) -> int:
        return self.X_train.shape[-1]

    @property
    def in_channels(self) -> int:
        return self.X_train.shape[1]


def load_trajectories(dataset_file: str, features: List[str]):
    """Load the (N, C, L) raw feature array and per-flight labels from disk."""
    if str(dataset_file).endswith(".npz"):
        z = np.load(dataset_file, allow_pickle=False)
        return np.asarray(z["X"], np.float32), np.asarray(z["y"], np.int64)
    try:
        from traffic.core import Traffic  # optional dependency
    except ImportError as e:
        raise ImportError(
            "Loading Traffic pickles requires the `traffic` library; "
            "alternatively convert to .npz with X (N, C, L) and y (N,)."
        ) from e
    traffic = Traffic.from_file(dataset_file)
    rows, labels = [], []
    for flight in traffic:
        df = flight.data
        if df["cluster"].nunique() != 1:
            raise ValueError("Each flight should have a unique cluster")
        rows.append(df[features].to_numpy(np.float32))  # (L, C)
        labels.append(df["cluster"].iloc[0])
    X = np.stack(rows).transpose(0, 2, 1)  # (N, C, L)
    uniq = {c: i for i, c in enumerate(sorted(set(labels)))}
    return X, np.asarray([uniq[c] for c in labels], np.int64)


def get_data(
    dataset_file: str,
    features: List[str],
    train_ratio: float = 0.9,
    random_seed: int = 42,
    scale: bool = True,
) -> DatasetSplits:
    X, y = load_trajectories(dataset_file, features)
    N, C, L = X.shape

    scaler = MinMaxScaler()
    if scale:
        flat = X.transpose(0, 2, 1).reshape(N, L * C)  # the reference's ravel order
        flat = scaler.fit_transform(flat)
        X = flat.reshape(N, L, C).transpose(0, 2, 1).astype(np.float32)
    else:
        scaler.fit(np.zeros((1, L * C)))

    indices = np.random.RandomState(random_seed).permutation(N)
    split = int(train_ratio * N)
    tr, te = indices[:split], indices[split:]
    return DatasetSplits(
        X_train=X[tr],
        y_train=y[tr][:, None],
        X_test=X[te],
        y_test=y[te][:, None],
        scaler=scaler,
        n_classes=int(y.max()) + 1 if len(y) else 1,
    )


def make_batches(
    X: np.ndarray,
    y: Optional[np.ndarray],
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    drop_remainder: bool = True,
    repeat: bool = False,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Epoch-based numpy batcher. ``drop_remainder`` drops the short final
    batch of each epoch. With ``process_index``/``process_count`` each
    process yields its contiguous slice of every global batch, from the same
    permutation on every process."""
    N = X.shape[0]
    if process_count is not None:
        if process_index is None or not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
        per = batch_size // process_count
        lo, hi = process_index * per, (process_index + 1) * per
    else:
        lo, hi = 0, batch_size
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(N) if shuffle else np.arange(N)
        stop = (N // batch_size) * batch_size if drop_remainder else N
        for i in range(0, stop, batch_size):
            idx = order[i:i + batch_size][lo:hi]
            yield X[idx], (y[idx] if y is not None else None)
        if not repeat:
            return


def save_npz(path: str, X: np.ndarray, y: np.ndarray) -> None:
    np.savez_compressed(path, X=np.asarray(X, np.float32), y=np.asarray(y, np.int64))


def make_synthetic_trajectories(
    n: int = 64, channels: int = 4, length: int = 128, n_classes: int = 3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Small synthetic flight-like dataset for tests and smoke runs: smooth
    class-dependent lat/lon arcs, an altitude profile and a time delta."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    X = np.zeros((n, channels, length), np.float32)
    y = rng.integers(0, n_classes, size=n)
    for i in range(n):
        c = y[i]
        phase = rng.normal(0, 0.1)
        amp = 1.0 + 0.2 * c + rng.normal(0, 0.05)
        X[i, 0] = amp * np.sin(2 * np.pi * (t + phase))  # "lat"
        if channels > 1:
            X[i, 1] = amp * np.cos(2 * np.pi * (t + phase) * (1 + 0.1 * c))
        if channels > 2:
            X[i, 2] = np.clip(np.sin(np.pi * t) + rng.normal(0, 0.02, length), 0, None)
        if channels > 3:
            X[i, 3] = np.cumsum(np.abs(rng.normal(1.0, 0.05, length)))
        X[i] += rng.normal(0, 0.01, (channels, length))
    return X, y
