"""Stage clock of the reconstruction path: milliseconds per named stage,
on the card's clock (CUDA events) for device work and on the host's
clock otherwise. A stage named twice adds up (backprojection, frame by
frame)."""

from __future__ import annotations

import contextlib
import time

import torch


class StageClock:
    def __init__(self, device: str | torch.device = "cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self._ms: dict[str, float] = {}
        self._events: list[tuple[str, object, object]] = []

    def _add(self, name: str, ms: float) -> None:
        self._ms[name] = self._ms.get(name, 0.0) + ms

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = True):
        """Time the block as ``name``. ``device``: the block queues work on
        the card, timed by events around it; otherwise the block is host
        work, timed on the host's clock after the card has drained what
        earlier stages queued (their time is theirs)."""
        self._ms.setdefault(name, 0.0)
        if self.cuda and device:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((name, start, end))
            return
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        self._add(name, (time.perf_counter() - t0) * 1e3)

    def result(self) -> dict[str, float]:
        """Milliseconds by stage, in the order first seen."""
        if self._events:
            torch.cuda.synchronize()
            for name, start, end in self._events:
                self._add(name, start.elapsed_time(end))
            self._events.clear()
        return dict(self._ms)
