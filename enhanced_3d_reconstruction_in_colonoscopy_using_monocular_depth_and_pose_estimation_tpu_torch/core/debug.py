"""Tracing, numerical debugging and step timing.

- ``profile_trace``: ``torch.profiler`` over the enclosed block (CPU, and
  the card when there is one), written as a Chrome trace to
  ``<log_dir>/trace.json``; the profiler is yielded for ``key_averages``.
- ``nan_checks``: the JAX package's ``jax_debug_nans`` toggle, as a
  ``TorchDispatchMode`` that raises ``FloatingPointError`` at the first op
  whose floating output holds a NaN, naming the op (and, in a forward,
  the module it ran in). Every kernel of the port is an op, so its output
  is checked too; autograd carries the mode into the backward.
- ``StepTimer``: rolling per-step wall-clock statistics for train loops.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


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


# Ops that return uninitialised memory: NaN bit patterns there are no
# result of any computation.
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


def _module_path() -> str:
    """The dotted name, from the outermost module down, of the innermost
    module whose ``forward`` is on the calling stack ("" outside a
    forward, as in a backward)."""
    chain = []  # innermost first
    frame = sys._getframe(1)
    while frame is not None:
        mod = frame.f_locals.get("self")
        if (frame.f_code.co_name == "forward"
                and isinstance(mod, torch.nn.Module)
                and (not chain or chain[-1] is not mod)):
            chain.append(mod)
        frame = frame.f_back
    chain.reverse()
    parts = []
    for outer, inner in zip(chain, chain[1:]):
        name = next((n for n, m in outer.named_modules() if m is inner), "")
        if name:
            parts.append(name)
    return ".".join(parts)


class _NanCheckMode(TorchDispatchMode):
    """Checks every floating output of every op while ``nan_checks`` is
    on (read from ``_STATE``, which autograd's device threads see too)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _STATE["enabled"] and func.__name__.split(".")[0] \
                not in _UNINITIALISED:
            for t in pytree.tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    where = _module_path()
                    raise FloatingPointError(
                        f"nan_checks: {func} produced a NaN"
                        + (f" (in {where})" if where else ""))
        return out


# Process-wide, as the JAX flag: autograd runs a CUDA backward on its own
# device thread, which must see the same switch.
_STATE = {"enabled": False, "modes": 0}


@contextlib.contextmanager
def nan_checks(enable: bool = True):
    """Raise ``FloatingPointError`` at the first op inside the block whose
    floating output holds a NaN (not inf: as ``jax_debug_nans``). Nests;
    ``enable=False`` turns the checks off inside an enabled block. The
    previous state returns on exit."""
    prev = _STATE["enabled"]
    _STATE["enabled"] = enable
    mode = _NanCheckMode() if enable and not _STATE["modes"] else None
    try:
        if mode is None:
            yield
        else:
            _STATE["modes"] += 1
            try:
                with mode:
                    yield
            finally:
                _STATE["modes"] -= 1
    finally:
        _STATE["enabled"] = prev


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
