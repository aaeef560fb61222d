"""Profiling and step-time instrumentation.

Port of ``tvqvae_tpu/utils/profiling.py``:

  - ``trace(logdir)``: a context manager around ``torch.profiler`` that
    records host and device activity and writes a Chrome trace
    (``trace.json`` under ``logdir``, viewable in Perfetto or
    ``chrome://tracing``), where the JAX module writes a ``jax.profiler``
    trace for TensorBoard;
  - ``annotate(name)``: a named span inside a trace
    (``torch.profiler.record_function``);
  - ``StepTimer``: streaming wall-clock step statistics (mean, p50, p90,
    steps/s) for per-interval logging from the train loops. It reads the
    host clock between ticks; the device runs behind the host, so over a
    window the mean is the step rate only where something in the loop waits
    for the device.
"""

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record host and, where a card is present, device activity while the
    block runs, then write ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named span inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Streaming step timing with percentile summaries."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self, n_steps: int = 1) -> None:
        """Record elapsed time since the last tick; ``n_steps`` > 1 divides it
        so bundled loops still report per-step times."""
        now = time.perf_counter()
        if self._last is not None:
            self._times.append((now - self._last) / max(n_steps, 1))
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
