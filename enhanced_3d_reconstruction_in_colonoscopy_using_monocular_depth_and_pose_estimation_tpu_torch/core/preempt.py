"""Preemption-graceful training: SIGTERM/SIGINT -> checkpoint -> exit
(the JAX package's ``core/preempt.py``).

A scheduler delivers SIGTERM to every worker ahead of maintenance or a
spot preemption. The signal sets a flag that the fit loops check at step
boundaries; they save a final ``latest/`` checkpoint (never displacing a
best-k slot) and return cleanly, so ``trainer.resume=true`` continues
mid-epoch after the restart.

A first Ctrl-C (SIGINT) is treated the same way; a second raises
``KeyboardInterrupt`` at once.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager that latches termination signals into ``requested``.

    Handlers are installed on ``__enter__`` and the previous ones restored
    on ``__exit__``. ``signal.signal`` works only in the main thread, so a
    fit running in a worker thread gets a guard that is never requested.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev: dict[int, object] = {}
        self._sigint_hits = 0
        self.requested = False

    def _handler(self, signum, frame):  # noqa: ARG002 (signal API)
        self.requested = True
        if signum == signal.SIGINT:
            self._sigint_hits += 1
            if self._sigint_hits > 1:
                raise KeyboardInterrupt

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False
