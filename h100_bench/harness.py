"""One run of one cell: the cell's files, the run's record, the line.

``cell_spec`` reads a cell from ``BENCHMARK.json`` and the files it names;
``run_cell`` runs it and returns the result's fields. Everything that
belongs to one configuration, traffic mix or metric is read from its own
file under ``h100_bench/`` by name:

- ``configs/<config>.json``: the model's sizes;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``generator``
  names ``generators/<generator>.py``: its ``run(spec, seed, seconds,
  trace, device, t_start)`` makes the set-up, drives the window, checks
  what the window produced and returns an ``Outcome``;
- ``limits/<workload>.json``: the limits of the numbers the check
  compares;
- ``metrics/<metric>.py``, or, where no file has the whole name,
  ``metrics/<stem>.py`` for the part of the name before its first dot: a
  ``read(run)`` that returns the metric's value from the run (``Run``),
  or None when the run holds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PORT = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
        "and_pose_estimation_tpu_torch")
# Top-level module names that must never load in a run: JAX, its
# libraries, and the JAX package under both of its names.
FORBIDDEN = frozenset({
    "jax", "jaxlib", "flax", "optax", "orbax", "e3d_tpu",
    "enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_"
    "pose_estimation_tpu"})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def _load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, manifest_path: Path = ROOT / "BENCHMARK.json"
              ) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports, as ``run_cell`` takes them."""
    manifest = _load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path.name}; "
                       f"known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return {
        "cell": cell,
        "config": _load_json(ROOT / configs[cell["config"]]["file"]),
        "traffic": _load_json(BENCH_DIR / "traffic"
                              / f"{cell['traffic']}.json"),
        "limits": _load_json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": [m for m in manifest["end_to_end"]
                       if _applies(m, name)],
        "per_layer": [m for m in manifest["per_layer"]
                      if _applies(m, name)],
    }


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read``, else that of
    ``metrics/<stem>.py`` (``stem``: the name before its first dot), which
    serves every suffix without a file of its own."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_generator(name: str):
    """The module ``generators/<name>.py`` (``name`` a Python
    identifier), whose ``run`` drives a cell of that traffic."""
    if not name.isidentifier():
        raise ValueError(f"generator name {name!r} is not an identifier")
    return importlib.import_module(f"h100_bench.generators.{name}")


@dataclass
class Run:
    """What a metric reader may read."""
    spec: dict
    device: str
    setup_s: float
    window: object = None           # loadgen.Window
    net_hw: tuple = ()
    trace: object = None            # trace.Slice, in a traced run
    # Also in a traced run, ``extra["pre"]``: the window's part before the
    # slice, which the profiler has not slowed: its seconds, units of work
    # (served batches or training steps), frames, and for serving the
    # engine's counters then.
    extra: dict = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.spec["config"]

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    @property
    def window_s(self) -> float:
        return self.window.t1 - self.window.t0

    def completed_in_window(self) -> int:
        w = self.window
        return sum(1 for r in w.requests if r.ok and r.done <= w.t1)


@dataclass
class Outcome:
    """What a generator's ``run`` returns: the run, whether its check
    held, the numbers compared beside their limits, and the requests or
    steps attempted and failed in the window."""
    run: Run
    correct: bool
    checks: dict
    attempted: int
    failed: int


def log(msg: str) -> None:
    print(f"h100_bench: {msg}", file=sys.stderr, flush=True)


def log_rate(window) -> None:
    """Frames completed in each fifth of the window, to show whether
    anything still warms up inside it."""
    span = (window.t1 - window.t0) / 5
    counts = [0] * 5
    for r in window.requests:
        if r.ok and window.t0 <= r.done < window.t1:
            counts[min(4, int((r.done - window.t0) / span))] += 1
    log("frames/s by fifth of the window: "
        + ", ".join(f"{c / span:.1f}" for c in counts))


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def free(device: str) -> None:
    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """The result's fields of one run of ``spec`` (``cell_spec``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    res = load_generator(spec["traffic"]["generator"]).run(
        spec, seed, seconds, trace, device, t_start)
    run = res.run
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": res.correct,
        "attempted": res.attempted,
        "failed": res.failed,
        "metrics": metrics,
        "device": {"memory_peak_bytes": run.extra["memory_peak_bytes"]},
    }
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_by_host()}
    out["_run"] = run
    out["checks"] = res.checks
    return out
