"""Tracing, numerical debugging and step timing.

- ``profile_trace``: ``torch.profiler`` over the enclosed block (CPU, and
  the card when there is one), written as a Chrome trace to
  ``<log_dir>/trace.json``; the profiler is yielded for ``key_averages``.
- ``nan_checks``: the JAX package's ``jax_debug_nans`` toggle, as a
  ``TorchDispatchMode`` that raises ``FloatingPointError`` at the first op
  whose floating output holds a NaN, naming the op (and, in a forward,
  the module it ran in). Every kernel of the port is an op, so its output
  is checked too; autograd carries the mode into the backward.
- The recorder: spans and counts of the program's stages, kept in one
  bounded in-memory ring (``Recorder``; the process's own is
  ``RECORDER``, which the functions below use), on whether or not a
  profiler runs:

  - ``span(name, ident, device)``: a context manager that records the
    block's start and end on ``time.perf_counter_ns()`` (the clock of
    ``time.perf_counter()``), its own id and its parent, the span
    enclosing it on the same thread. ``ident`` is the id of the request
    the span serves (a frame's number, a batch's, a step). With
    ``device=True`` and CUDA in use it also records a pair of CUDA events
    on the current stream, whose ``device_ms`` is read once they have
    completed, so the span never syncs. While a torch profiler records,
    the span also opens ``torch.profiler.record_function(name)``, its
    twin on the trace's own clock beside the ops and kernels it launched;
  - ``record(name, start_ns, end_ns, ident, parent)``: a span that
    started on one thread and ended on another (no twin);
  - ``count(name, n)``: a counter, kept as time-stamped increments;
  - ``spans`` and ``counts``: what the ring holds inside an interval;
    ``dropped`` says whether the ring still covers it;
  - ``tracing(False)``: the one off switch, as a call or a ``with``
    block (on by default). A span then still times its block for its
    caller but records nothing;
  - ``step_stats``: the statistics of a loop's step spans.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
from time import perf_counter_ns

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
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


# ------------------------------------------------------------------ spans


class Span:
    """One span: ``name``, ``id`` (None when tracing was off), ``parent``,
    ``ident``, ``start_ns`` and ``end_ns`` on ``perf_counter_ns``, an
    optional ``value`` (rows, say) and ``device_ms`` (None until CUDA
    events recorded with it have completed and a read resolved them). As
    a context manager it times its block (``Recorder.span``)."""

    __slots__ = ("name", "id", "parent", "ident", "start_ns", "end_ns",
                 "value", "device_ms", "_events", "_twin", "_rec",
                 "_device")

    def __init__(self, name: str, ident=None, parent=None, start_ns=None,
                 end_ns=None, value=None):
        self.name, self.ident, self.parent = name, ident, parent
        self.start_ns, self.end_ns, self.value = start_ns, end_ns, value
        self.id = None
        self.device_ms = None
        self._events = self._twin = self._rec = None
        self._device = False

    @property
    def ms(self) -> float:
        """The span's host milliseconds."""
        return (self.end_ns - self.start_ns) * 1e-6

    def _resolve(self) -> None:
        if self._events is not None and self._events[1].query():
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None

    def __enter__(self) -> "Span":
        rec = self._rec
        if rec is not None and rec.enabled:
            stack = rec._stack()
            self.parent = stack[-1] if stack else None
            self.id = next(rec._ids)
            stack.append(self.id)
            if _autograd_profiler._is_profiler_enabled:
                self._twin = torch.profiler.record_function(self.name)
                self._twin.__enter__()
            if self._device and torch.cuda.is_initialized():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        else:
            self._rec = None
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        rec, self._rec = self._rec, None
        if rec is None:
            return False
        if self._events is not None:
            self._events[1].record()
        if self._twin is not None:
            self._twin.__exit__(None, None, None)
            self._twin = None
        stack = rec._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        rec._put(self.end_ns, self)
        return False


class Count:
    """One increment ``n`` of counter ``name`` at ``t_ns``."""

    __slots__ = ("name", "t_ns", "n")

    def __init__(self, name: str, t_ns: int, n):
        self.name, self.t_ns, self.n = name, t_ns, n


class Recorder:
    """Spans and counts in one ring of ``capacity`` entries: the newest
    overwrite the oldest, and ``dropped`` counts what was overwritten."""

    def __init__(self, capacity: int = 1 << 17):
        self.capacity = int(capacity)
        self.enabled = True
        self._ring: list = [None] * self.capacity
        self._written = 0
        self._dropped = 0
        self._lost_ns = -1      # the newest end of an overwritten entry
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _put(self, end_ns: int, entry) -> None:
        with self._lock:
            i = self._written % self.capacity
            old = self._ring[i]
            if old is not None:
                self._dropped += 1
                self._lost_ns = max(self._lost_ns, old[0])
            self._ring[i] = (end_ns, entry.name, entry)
            self._written += 1

    def span(self, name: str, ident=None, device: bool = False) -> Span:
        """A context manager that records the block as span ``name``."""
        s = Span(name, ident)
        s._rec, s._device = self, device
        return s

    def record(self, name: str, start_ns: int, end_ns: int, ident=None,
               parent=None, value=None) -> int | None:
        """Record a span timed elsewhere (started on one thread, ended on
        another); returns its id, None when tracing is off."""
        if not self.enabled:
            return None
        s = Span(name, ident, parent, start_ns, end_ns, value)
        s.id = next(self._ids)
        self._put(end_ns, s)
        return s.id

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to counter ``name``, stamped now."""
        if self.enabled:
            t = perf_counter_ns()
            self._put(t, Count(name, t, n))

    def _held(self, name: str, start_ns, end_ns) -> list:
        lo = -1 if start_ns is None else start_ns
        hi = float("inf") if end_ns is None else end_ns
        with self._lock:
            held = self._ring[:]
        return [item[2] for item in held if item is not None
                and item[1] == name and lo <= item[0] <= hi]

    def spans(self, name: str, start_ns: int | None = None,
              end_ns: int | None = None) -> list[Span]:
        """The held spans ``name`` that lie wholly inside ``[start_ns,
        end_ns]`` (either bound None: open), oldest first, their device
        times resolved where their events have completed."""
        lo = -1 if start_ns is None else start_ns
        out = sorted((s for s in self._held(name, start_ns, end_ns)
                      if isinstance(s, Span) and s.start_ns >= lo),
                     key=lambda s: s.start_ns)
        for s in out:
            s._resolve()
        return out

    def counts(self, name: str, start_ns: int | None = None,
               end_ns: int | None = None) -> list[Count]:
        """The held increments of counter ``name`` stamped inside
        ``[start_ns, end_ns]``, oldest first."""
        return sorted((c for c in self._held(name, start_ns, end_ns)
                       if isinstance(c, Count)), key=lambda c: c.t_ns)

    def dropped(self, since_ns: int | None = None) -> int:
        """The entries the ring has overwritten; with ``since_ns``, 0
        unless the newest of them ended at or after it (so the ring may
        miss an entry from then on)."""
        with self._lock:
            if since_ns is not None and self._lost_ns < since_ns:
                return 0
            return self._dropped


RECORDER = Recorder()


def span(name: str, ident=None, device: bool = False) -> Span:
    """``RECORDER.span``: ``with span("runner.upload"): ...``."""
    return RECORDER.span(name, ident, device)


def record(name: str, start_ns: int, end_ns: int, ident=None, parent=None,
           value=None) -> int | None:
    """``RECORDER.record``."""
    return RECORDER.record(name, start_ns, end_ns, ident, parent, value)


def count(name: str, n=1) -> None:
    """``RECORDER.count``."""
    RECORDER.count(name, n)


def spans(name: str, start_ns: int | None = None,
          end_ns: int | None = None) -> list[Span]:
    """``RECORDER.spans``."""
    return RECORDER.spans(name, start_ns, end_ns)


def counts(name: str, start_ns: int | None = None,
           end_ns: int | None = None) -> list[Count]:
    """``RECORDER.counts``."""
    return RECORDER.counts(name, start_ns, end_ns)


def dropped(since_ns: int | None = None) -> int:
    """``RECORDER.dropped``."""
    return RECORDER.dropped(since_ns)


class tracing:
    """Turn ``RECORDER``'s recording on or off: ``tracing(False)`` as a
    call switches it off; as a ``with`` block, only for the block (the
    previous state returns on exit)."""

    def __init__(self, enabled: bool = True):
        self._prev = RECORDER.enabled
        RECORDER.enabled = bool(enabled)

    def __enter__(self) -> "tracing":
        return self

    def __exit__(self, *exc) -> bool:
        RECORDER.enabled = self._prev
        return False


def step_stats(steps: list[Span]) -> dict[str, float]:
    """Mean, p50 and p95 seconds and steps a second over every span in
    ``steps`` (a loop's ``train.step`` spans); {} for none."""
    if not steps:
        return {}
    arr = np.asarray([s.ms * 1e-3 for s in steps])
    return {
        "step_time_mean_s": float(arr.mean()),
        "step_time_p50_s": float(np.percentile(arr, 50)),
        "step_time_p95_s": float(np.percentile(arr, 95)),
        "steps_per_s": float(1.0 / max(arr.mean(), 1e-12)),
    }
