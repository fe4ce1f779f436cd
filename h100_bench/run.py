"""The H100 benchmark of the PyTorch/CUDA port: one run of one cell.

Run from the root of a checkout, on a machine with the cards the cell
asks for::

    python3 h100_bench/run.py --workload vitl-serve-backlog --seed 7 \\
        --seconds 45 --trace 0

It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (platform, card name, count, the peak memory of the window;
with ``--trace 1`` also the device's busy seconds in the traced slice and
the slice's length), with ``--trace 1`` a ``breakdown`` of the slice, and
last
``checks``: each number the correctness check compared, beside its limit.
The same numbers end standard error. Without a card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it exits non-zero and prints no result.

The cells, configurations and metrics are named in ``BENCHMARK.json`` at
the root, and everything that belongs to one of them is a file of its own
here, found by name:

- a configuration: ``configs/<name>.json`` (the model's published sizes);
- a traffic mix: ``traffic/<name>.json``, its parameters, whose
  ``generator`` names ``generators/<generator>.py`` (``closed_loop``,
  ``open_loop``, ``train_steps``): a new arrival pattern is a new file
  there, whose ``run`` builds on ``serving.py`` or ``training.py``;
- a metric: ``metrics/<name>.py``, or ``metrics/<stem>.py`` for the part
  of the name before its first dot where every suffix reads alike, whose
  ``read(run)`` returns the value from the run (``harness.Run``: the
  window's requests, the engine's counters, the traced slice), or None
  when there is nothing to read;
- the limits of a cell's check: ``limits/<workload>.json``.

A later change adds a configuration, a mix, a metric or a cell by adding
those files and the entries in ``BENCHMARK.json``; no file here needs an
edit. Operations and bytes come from ``counts.py``, the references from
``reference/`` (``dav2.py`` served, ``train.py`` fine-tuning), none of
which reads the program. ``calibrate.py`` takes the readings a cell's
limits are set from (the program's, the float8 control's, a planted
fault's) and ``sweep.py`` an open-loop cell's knee; no run calls them.

Kernels are built by the port into ``build/`` at the root of the checkout
on first use (a fixed directory, keyed by a hash of each source), so only
a checkout's first run compiles; ``TORCH_EXTENSIONS_DIR``,
``TRITON_CACHE_DIR`` and ``TORCHINDUCTOR_CACHE_DIR`` are pointed at fixed
directories under ``build/h100_bench/`` for anything else that compiles,
and Python's bytecode cache (``sys.pycache_prefix``) too.

The CPU tests are in ``tests/``: ``python -m pytest h100_bench/tests``
(those marked ``cuda`` skip without a card).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Fixed cache directories under ``build/h100_bench/``: Python's
    bytecode (the installed torch ships none, and compiling its modules
    from source cost seconds of every run's set-up) and any compiler's."""
    sys.pycache_prefix = str(ROOT / "build" / "h100_bench" / "pycache")
    sys.dont_write_bytecode = False
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = ROOT / "build" / "h100_bench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def _args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in checks.items()]


def main(argv=None) -> int:
    args = _args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from h100_bench import harness

    spec = harness.cell_spec(args.workload)
    import torch

    torch.set_num_threads(4)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available():
        print("h100_bench: no CUDA device (torch.cuda.is_available() is "
              "False); nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    out.pop("_run")
    bad = harness.forbidden_modules()
    if bad:
        print("h100_bench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    for line in _check_lines(checks):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
