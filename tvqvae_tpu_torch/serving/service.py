"""Generation service: a sampler behind a validated, thread-safe request API.

Port of ``tvqvae_tpu/serving/service.py``, close to verbatim:

- responses are returned in ORIGINAL physical units when the service holds
  the training scaler (inverse transform + the generate CLI's validity
  fixes, ``postprocess_generated`` below, copied from
  ``tvqvae_tpu/scripts/generate.py``);
- the device is single-threaded by design: a lock serializes sampling so
  the threaded HTTP front end (serving/server.py) never interleaves device
  work;
- optional coalescing merges concurrent same-class requests into one batch.
"""

import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np


def postprocess_generated(
    X_gen: np.ndarray,
    scaler,
    features,
    altitude_idx=None,
    timedelta_idx=None,
) -> np.ndarray:
    """Inverse scaling + physical-validity fixes: altitude clipped at >= 0,
    timedelta[0] := 0 (channels resolved from the feature list)."""
    N, C, L = X_gen.shape
    flat = X_gen.transpose(0, 2, 1).reshape(N, L * C)
    flat = scaler.inverse_transform(flat)
    X = flat.reshape(N, L, C).transpose(0, 2, 1)
    if altitude_idx is None and "altitude" in features:
        altitude_idx = features.index("altitude")
    if timedelta_idx is None and "timedelta" in features:
        timedelta_idx = features.index("timedelta")
    if altitude_idx is not None:
        X[:, altitude_idx] = np.clip(X[:, altitude_idx], 0.0, None)
    if timedelta_idx is not None:
        X[:, timedelta_idx, 0] = 0.0
    return X


class _Request:
    __slots__ = ("n", "class_index", "result", "error", "event")

    def __init__(self, n, class_index):
        self.n = n
        self.class_index = class_index
        self.result = None
        self.error = None
        self.event = threading.Event()


class _Dispatcher(threading.Thread):
    """Coalescing dispatcher: merges concurrent requests for the SAME class
    into one device batch, so k concurrent small requests cost one batch of
    decoding instead of k.
    Requests that can't join the current batch (different class, or the
    batch is full) are requeued behind the inbox — strict fairness is
    traded for batch purity (a continuous same-class stream can delay other
    classes by one window)."""

    def __init__(self, run_fn, capacity: int, window_s: float):
        super().__init__(daemon=True)
        self._run = run_fn  # (total_n, class_index) -> (X, y)
        self.capacity = int(capacity)
        self.window = float(window_s)
        self.inbox: "queue.Queue" = queue.Queue()
        self._stop = False

    def submit(self, n: int, class_index) -> Tuple[np.ndarray, np.ndarray]:
        req = _Request(n, class_index)
        self.inbox.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self):
        self._stop = True
        self.inbox.put(None)

    def run(self):
        while True:
            head = self.inbox.get()
            if head is None:
                return
            time.sleep(self.window)  # let concurrent requests pile up
            batch, total, back = [head], head.n, []
            while True:
                try:
                    r = self.inbox.get_nowait()
                except queue.Empty:
                    break
                if r is None:
                    self.inbox.put(None)
                    break
                if (r.class_index == head.class_index
                        and total + r.n <= self.capacity):
                    batch.append(r)
                    total += r.n
                else:
                    back.append(r)
            for r in back:
                self.inbox.put(r)
            try:
                X, y = self._run(total, head.class_index)
                off = 0
                for r in batch:
                    r.result = (X[off:off + r.n], y[off:off + r.n])
                    off += r.n
            except Exception as e:  # propagate to every waiter
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()
            if self._stop and self.inbox.empty():
                return


class GenerationService:
    """Wraps a TrainedModelSampler (or any object with the same `.sample`
    surface) behind a validated, thread-safe request API.

    Parameters
    ----------
    sampler: TrainedModelSampler-like — needs `.sample(n, kind, class_index,
        seed=)`, plus `input_length/in_channels/n_classes/batch_size/use_fe`
        attributes.
    scaler: optional fitted MinMaxScaler — when present, responses are
        inverse-transformed to original units with the generate CLI's
        physical-validity fixes (altitude clip, timedelta[0]=0).
    features: channel names (used for postprocess + reported by info()).
    max_request: upper bound on trajectories per request.
    """

    def __init__(
        self,
        sampler,
        scaler=None,
        features=None,
        max_request: int = 4096,
        coalesce_ms: Optional[float] = None,
    ):
        """coalesce_ms: when set, requests WITHOUT an explicit seed are
        merged with concurrent same-class requests arriving within that
        window into one device batch (up to the sampler batch size).
        Explicit-seed requests always take the direct path so their
        reproducibility contract holds."""
        self.sampler = sampler
        self.scaler = scaler
        self.features = list(features) if features is not None else None
        self.max_request = int(max_request)
        self._lock = threading.Lock()
        self._served = 0
        self._auto_seed = 0
        self._dispatcher = None
        if coalesce_ms is not None:
            self._dispatcher = _Dispatcher(
                self._run_locked,
                capacity=int(getattr(sampler, "batch_size", 32)),
                window_s=float(coalesce_ms) / 1e3,
            )
            self._dispatcher.start()

    # ------------------------------------------------------------------

    def info(self) -> Dict:
        s = self.sampler
        return {
            "model": "tvqvae_tpu_torch",
            "input_length": int(getattr(s, "input_length", 0)),
            "in_channels": int(getattr(s, "in_channels", 0)),
            "n_classes": int(getattr(s, "n_classes", 0)),
            "batch_size": int(getattr(s, "batch_size", 0)),
            "fidelity_enhancer": bool(getattr(s, "use_fe", False)),
            "ess": bool(getattr(s, "use_ess", False)),
            "postprocess": self.scaler is not None,
            "coalesce": self._dispatcher is not None,
            "features": self.features,
            "max_request": self.max_request,
            "served": self._served,
        }

    def warmup(self, classes: bool = False) -> None:
        """Run every decode path the service will hit once (the first call
        builds the VQ kernel and warms the card): unconditional and, with
        classes=True, each class."""
        self.sampler.sample(1, "unconditional", seed=0)
        if classes:
            for c in range(int(getattr(self.sampler, "n_classes", 0))):
                self.sampler.sample(1, "conditional", class_index=c, seed=0)

    # ------------------------------------------------------------------

    def _validate(self, n: int, class_index: Optional[int]) -> None:
        if not isinstance(n, int) or n < 1:
            raise ValueError(f"n must be a positive integer, got {n!r}")
        if n > self.max_request:
            raise ValueError(
                f"n={n} exceeds max_request={self.max_request}"
            )
        if class_index is not None:
            ncls = int(getattr(self.sampler, "n_classes", 0))
            if not isinstance(class_index, int) or not 0 <= class_index < ncls:
                raise ValueError(
                    f"class_index must be in [0, {ncls}), got {class_index!r}"
                )

    def _run_locked(
        self, n: int, class_index: Optional[int], seed: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One serialized device call -> raw (X, y) in model units."""
        kind = "unconditional" if class_index is None else "conditional"
        with self._lock:
            if seed is None:
                seed = self._auto_seed
                self._auto_seed += 1
            _, _, x = self.sampler.sample(
                n, kind, class_index=class_index, seed=int(seed)
            )
            self._served += n
        x = np.asarray(x)
        y = np.full(
            n, -1 if class_index is None else class_index, np.int64
        )
        return x, y

    def generate(
        self,
        n: int,
        class_index: Optional[int] = None,
        seed: Optional[int] = None,
        postprocess: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sample `n` trajectories; returns (X, y) with X (n, C, L) and y
        (n,) int labels (-1 for unconditional draws — the prior does not
        report which class an unconditional sample came from). seed=None
        draws fresh randomness per request (and is eligible for request
        coalescing); an explicit seed is reproducible and always direct."""
        self._validate(n, class_index)
        if self._dispatcher is not None and seed is None:
            x, y = self._dispatcher.submit(n, class_index)
        else:
            x, y = self._run_locked(n, class_index, seed=seed or 0)
        if postprocess and self.scaler is not None:
            x = postprocess_generated(x, self.scaler, self.features or [])
        return x, y

    def close(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.shutdown()

    def generate_mix(
        self,
        class_counts: Dict[int, int],
        seed: int = 0,
        postprocess: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-class conditional sampling with explicit counts (the serving
        analogue of the generate CLI's class-distribution matching,
        reference generate.py:96-112)."""
        total = sum(int(v) for v in class_counts.values())
        self._validate(total, None)
        Xs, ys = [], []
        for cls in sorted(class_counts):
            cnt = int(class_counts[cls])
            if cnt <= 0:
                continue
            x, y = self.generate(
                cnt, class_index=int(cls), seed=seed + int(cls),
                postprocess=postprocess,
            )
            Xs.append(x)
            ys.append(y)
        if not Xs:
            raise ValueError("class_counts sum to zero")
        return np.concatenate(Xs), np.concatenate(ys)
