"""Checkpointing (best-k on val_loss, plus mid-run resume) and early
stopping.

The JAX package keeps Orbax checkpoints; the port keeps ``torch.save``
files with the same semantics. A state is any object with ``state_dict()``
and ``load_state_dict()`` (``train.depth_task.DepthTrainState`` holds the
model, the optimizer and the step). Layout under ``directory``:

- ``<step>/state.pt`` and ``<step>/metrics.json``: the best
  ``max_to_keep`` saves by lowest ``val_loss``;
- ``latest/<step>/state.pt`` and ``latest/metrics.json``: the newest save
  when the best-k store did not keep it, so ``restore_latest`` resumes
  where the run stopped (not at its best step), and the early-stopping
  state saved in the metrics survives the restart.

Files are written under a temporary name and renamed into place. Reading
an Orbax checkpoint of the JAX package is out of scope.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

_STATE = "state.pt"
_METRICS = "metrics.json"


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _steps(root: str) -> list[int]:
    """Steps saved under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root) if d.isdigit()
                  and os.path.exists(os.path.join(root, d, _STATE)))


def _save_state(root: str, step: int, state: Any) -> str:
    path = os.path.join(root, str(step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    return path


class CheckpointManager:
    """The best ``max_to_keep`` saves by val_loss plus a ``latest/`` slot."""

    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._latest_dir = os.path.join(self.directory, "latest")

    def _val_loss(self, step: int) -> float:
        m = _read_json(os.path.join(self.directory, str(step), _METRICS))
        return float(m["val_loss"])

    def save(self, step: int, state: Any, metrics: dict[str, float]) -> None:
        """Save ``state`` with ``metrics`` (which hold ``val_loss``)."""
        step = int(step)
        metrics = {k: float(v) for k, v in metrics.items()}
        path = _save_state(self.directory, step, state)
        _write_json(os.path.join(path, _METRICS), metrics)
        ranked = sorted(_steps(self.directory),
                        key=lambda s: (self._val_loss(s), -s))
        for stale in ranked[self.max_to_keep:]:
            shutil.rmtree(os.path.join(self.directory, str(stale)))
        # The latest/ slot holds this save unless the best-k store kept it
        # (no second copy); ``_latest`` takes the newest step across both.
        for old in _steps(self._latest_dir):
            shutil.rmtree(os.path.join(self._latest_dir, str(old)))
        if step not in ranked[:self.max_to_keep]:
            _save_state(self._latest_dir, step, state)
        os.makedirs(self._latest_dir, exist_ok=True)
        _write_json(os.path.join(self._latest_dir, _METRICS),
                    {"step": step, **metrics})

    def _latest(self) -> tuple[str, int] | None:
        """(store root, step) of the newest save across both stores."""
        cands = [(self.directory, s) for s in _steps(self.directory)[-1:]]
        cands += [(self._latest_dir, s) for s in _steps(self._latest_dir)[-1:]]
        return max(cands, key=lambda rs: rs[1]) if cands else None

    def latest_step(self) -> int | None:
        owner = self._latest()
        return None if owner is None else owner[1]

    def latest_metrics(self) -> dict | None:
        """Metrics recorded with the newest save (e.g. early-stop state)."""
        owner = self._latest()
        if owner is None:
            return None
        root, step = owner
        m = _read_json(os.path.join(self._latest_dir, _METRICS))
        if m is not None and m.get("step") == step:
            return {k: v for k, v in m.items() if k != "step"}
        return _read_json(os.path.join(root, str(step), _METRICS))

    def read_best(self) -> dict | None:
        """The saved state dict with the lowest val_loss in the best-k
        store, else the newest save's (the JAX package's
        ``restore_best_untyped``); None if there is none."""
        ranked = sorted(_steps(self.directory),
                        key=lambda s: (self._val_loss(s), -s))
        if ranked:
            root, step = self.directory, ranked[0]
        else:
            owner = self._latest()
            if owner is None:
                return None
            root, step = owner
        return torch.load(os.path.join(root, str(step), _STATE),
                          map_location="cpu", weights_only=True)

    def restore_latest(self, state: Any) -> Any | None:
        """Load the newest save into ``state`` and return it; None if there
        is none."""
        owner = self._latest()
        if owner is None:
            return None
        root, step = owner
        state.load_state_dict(torch.load(
            os.path.join(root, str(step), _STATE), map_location="cpu",
            weights_only=True))
        return state


class EarlyStopping:
    """Patience-based early stop on val_loss (reference:
    ``EarlyStopping(monitor="val_loss", patience=20)``)."""

    def __init__(self, patience: int = 20):
        self.patience = patience
        self.best: float | None = None
        self.bad_count = 0

    def update(self, value: float) -> bool:
        """Returns True if training should stop."""
        if self.best is None or value < self.best:
            self.best = value
            self.bad_count = 0
            return False
        self.bad_count += 1
        # Lightning semantics: stop when wait_count >= patience, checked
        # only after a non-improving eval.
        return self.bad_count >= self.patience
