"""Readings for the video cell's limit: the sound program's, the float8
control's and planted faults', each judged by the cell's own check.

    python3 h100_bench/calibrate_faults.py --workload vda-vitl-video-backlog \\
        --seeds 101 102 ... --faults temporal_off no_carry --control \\
        --seconds 25

For each seed the cell runs as ``run.py`` runs it (``harness.run_cell``:
two procedures interleaved, the checked one drawn from the seed), for
``--seconds``, long enough for the checked procedure's first
``check_frames`` maps to resolve inside the window: once sound, and once
under each planted fault. With ``--control`` the sound run's checked maps
are replaced by the control's over the same frames (the reference with
float8 operands, ``video.reference_maps(fp8=True)``) and the run is
checked again. Every reading is ``video.check``'s verdict and numbers,
one JSON line on standard output; the limit lies between the program's
largest ``map_rel_err`` and the smallest of the control's and the
faults', each of which must come out ``correct`` false. The faults,
planted under the harness:

- ``temporal_off``: every motion module returns its input (the
  temporal modules skipped);
- ``no_carry``: no window carries keyframes: positions 0-9 of a window
  are its own frames, the previous window's inputs at 22-31, where VDA
  carries those at 0, 12, 24 ... 31.

The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("temporal_off", "no_carry")


@contextlib.contextmanager
def planted(fault: str):
    """The port broken underneath the harness by ``fault`` (module
    docstring); nothing for ""."""
    if not fault:
        yield
        return
    from h100_bench.harness import PORT

    if fault == "temporal_off":
        mod = importlib.import_module(f"{PORT}.models.temporal")
        saved = mod.TemporalModule.forward
        mod.TemporalModule.forward = lambda self, x, frames: x
        try:
            yield
        finally:
            mod.TemporalModule.forward = saved
    elif fault == "no_carry":
        eng = importlib.import_module(f"{PORT}.serving.engine")
        saved = eng.cliplib
        proxy = types.SimpleNamespace(**vars(saved))
        proxy.KEYFRAMES = tuple(range(saved.STEP, saved.WINDOW))
        eng.cliplib = proxy
        try:
            yield
        finally:
            eng.cliplib = saved
    else:
        raise ValueError(f"unknown fault {fault!r}")


def control_check(out: dict, seed: int) -> tuple[bool, dict]:
    """``video.check`` of the run in ``out`` (``harness.run_cell``'s) with
    the checked procedure's maps replaced by the float8 control's of the
    same frames."""
    from h100_bench import video

    run = out["_run"]
    got, pool_idx = video.checked_frames(run)
    ctl = video.reference_maps(run, seed, pool_idx,
                               int(run.traffic["check_frames"]), fp8=True)
    for r in got:
        r.depth = ctl[r.pos].cpu().numpy()
    return video.check(run, seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="*", default=[], choices=FAULTS)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=25.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100_bench import harness

    spec = harness.cell_spec(args.workload)
    if spec["traffic"]["generator"] != "video_streams":
        p.error(f"{args.workload} is no video cell; the serving and "
                "training cells' readings are calibrate.py's")

    def emit(side: str, seed: int, correct: bool, checks: dict,
             t: float) -> None:
        print(json.dumps({"side": side, "seed": seed, "correct": correct,
                          "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)

    for seed in args.seeds:
        for fault in [""] + list(args.faults):
            t = time.perf_counter()
            with planted(fault):
                out = harness.run_cell(spec, seed, args.seconds, False,
                                       args.device)
            emit(fault or "program", seed, out["correct"], out["checks"], t)
            if not fault and args.control:
                t = time.perf_counter()
                emit("control", seed, *control_check(out, seed), t)
            del out
            harness.free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
