"""The port's own spans and counts (``core.debug``'s recorder), read over
a traced run's window before its slice: ``[window.t0, window.t0 +
pre["seconds"]]``, on the ``perf_counter`` clock that both the window and
the recorder stamp with, and which the profiler has not slowed.

Every read gives None where there is nothing to read: a port without the
recorder, a run without that part of the window, an interval the ring no
longer covers whole (it dropped an entry that ended inside it), or no
span or count of the name inside it.
"""

from __future__ import annotations

import importlib

from .harness import PORT


def recorder():
    """The port's recorder (``core.debug.RECORDER``), or None where the
    port has none."""
    try:
        debug = importlib.import_module(f"{PORT}.core.debug")
    except ImportError:
        return None
    return getattr(debug, "RECORDER", None)


def interval(run) -> tuple[int, int] | None:
    """``[window.t0, window.t0 + pre["seconds"]]`` in nanoseconds, or
    None without it."""
    pre = run.extra.get("pre")
    if run.window is None or not pre:
        return None
    lo = round(run.window.t0 * 1e9)
    return lo, lo + round(pre["seconds"] * 1e9)


def _read(run, name: str, what: str) -> list | None:
    rec, span = recorder(), interval(run)
    if rec is None or span is None or rec.dropped(span[0]):
        return None
    return getattr(rec, what)(name, *span) or None


def spans(run, name: str) -> list | None:
    """The spans ``name`` that lie wholly inside the interval."""
    return _read(run, name, "spans")


def counts(run, name: str) -> list | None:
    """The increments of counter ``name`` stamped inside the interval."""
    return _read(run, name, "counts")


def mean_ms(run, name: str) -> float | None:
    """The mean host milliseconds of the spans ``name``."""
    got = spans(run, name)
    return None if got is None else sum(s.ms for s in got) / len(got)
