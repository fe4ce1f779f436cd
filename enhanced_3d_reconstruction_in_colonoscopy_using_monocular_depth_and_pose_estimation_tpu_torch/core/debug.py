"""Tracing and step timing.

- ``profile_trace``: ``torch.profiler`` over the enclosed block (CPU, and
  the card when there is one), written as a Chrome trace to
  ``<log_dir>/trace.json``; the profiler is yielded for ``key_averages``.
- ``StepTimer``: rolling per-step wall-clock statistics for train loops.

The JAX package's ``nan_checks`` is not ported yet.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block; write ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling per-step timing: ``with timer.step(): ...`` then
    ``timer.summary()``. A step that queues work on the card is timed to
    the end of its host work; end it with a sync to time the device."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / max(arr.mean(), 1e-12)),
        }
