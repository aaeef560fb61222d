"""Step-time instrumentation: ``StepTimer``.

Port of ``tvqvae_tpu/utils/profiling.py::StepTimer``. It reads the host
clock between ticks; the device runs behind the host, so over a window the
mean is the step rate only where something in the loop waits for the device.
"""

import time
from typing import Optional

import numpy as np


class StepTimer:
    """Streaming step timing with percentile summaries."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        """Record elapsed time since the last tick."""
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "perf/step_time_mean_ms": float(t.mean() * 1e3),
            "perf/step_time_p50_ms": float(np.percentile(t, 50) * 1e3),
            "perf/step_time_p90_ms": float(np.percentile(t, 90) * 1e3),
            "perf/steps_per_sec": float(1.0 / t.mean()),
        }
