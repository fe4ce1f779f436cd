"""Metric logging: a JSONL sink and stdout, in the JAX package's schema.

Each ``log`` call appends one record (the metrics, ``step`` and ``time``
in seconds since the logger was made) to ``<log_dir>/metrics.jsonl`` and
prints it every ``stdout_every`` steps or when forced. Namespaces follow
the reference (``Train/``, ``Val/``, ``lr/``, ``perf/``). Tensors are read
with ``.item()``, which waits for the card. The JAX package's optional W&B
sink is off without a key, and is not ported.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Mapping


def _to_scalar(v: Any) -> Any:
    return v.item() if hasattr(v, "item") else v


class MetricLogger:
    def __init__(self, log_dir: str, stdout_every: int = 100):
        self.log_dir = log_dir
        self.stdout_every = max(1, stdout_every)
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                        encoding="utf-8", buffering=1)
        self._t0 = time.time()

    def log(self, metrics: Mapping[str, Any], step: int,
            force_stdout: bool = False) -> None:
        record = {k: _to_scalar(v) for k, v in metrics.items()}
        record["step"] = step
        record["time"] = round(time.time() - self._t0, 3)
        self._fh.write(json.dumps(record) + "\n")
        if force_stdout or step % self.stdout_every == 0:
            msg = " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items())
            print(f"[metrics] {msg}", file=sys.stdout, flush=True)

    def close(self) -> None:
        self._fh.close()


class NullLogger:
    """A logger that writes nothing: the ranks other than 0 of a
    multi-process run (rank 0 logs the global metrics)."""

    def log(self, metrics: Mapping[str, Any], step: int,
            force_stdout: bool = False) -> None:
        pass

    def close(self) -> None:
        pass
