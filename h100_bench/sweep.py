"""The knee of an open-loop cell: its traffic at several scope counts.

    python3 h100_bench/sweep.py --workload vitl-live-scopes \\
        --scopes 2 3 4 5 6 --seconds 20 --seed 5

For each count it runs the cell's window as ``run.py`` does, with only
``scopes`` changed, and prints one JSON line: frames due and completed,
the latency's median and 95th percentile, and the median latency of the
window's first and last thirds. A backlog grows where the last third's
median is well above the first's, or frames complete slower than they
are due. The cell's ``scopes`` is then fixed by hand in its traffic file
at four fifths of the highest count that sustains; the benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--scopes", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from h100_bench import harness

    spec = harness.cell_spec(args.workload)
    for n in args.scopes:
        spec["traffic"] = {**spec["traffic"], "scopes": n}
        out = harness.run_cell(spec, args.seed, args.seconds, False)
        w = out["_run"].window
        deadline = w.t1 + float(spec["traffic"]["grace_s"])
        lat = np.asarray([(r.done if r.ok else deadline) - r.due
                          for r in w.requests]) * 1e3
        third = len(lat) // 3
        done = sum(1 for r in w.requests if r.ok and r.done <= w.t1)
        print(json.dumps({
            "scopes": n, "offered_fps": n * float(spec["traffic"]["fps"]),
            "due": len(lat), "completed_in_window": done,
            "served_fps": done / (w.t1 - w.t0),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "first_third_p50_ms": float(np.median(lat[:third])),
            "last_third_p50_ms": float(np.median(lat[-third:])),
            "fill": w.stats.get("mean_batch_fill"),
            "lateness_p99_ms": float(np.percentile(w.lateness_s, 99) * 1e3),
            "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
