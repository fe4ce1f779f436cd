"""An open loop of live scopes: ``scopes`` sources each send one frame
every ``1 / fps`` seconds from a phase drawn from the seed, whether or not
earlier frames came back. A request is due at its scheduled time; the
generator's lateness is recorded."""

from __future__ import annotations

import time

import numpy as np

from h100_bench import serving
from h100_bench.loadgen import (Request, Sampler, Slicer, Window, drain,
                                resolve)


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float):
    return serving.run(spec, seed, seconds, trace, device, t_start, drive)


def schedule(traffic: dict, seconds: float, rng: np.random.Generator,
             pool: int) -> list[tuple[float, int]]:
    """(due offset in seconds, frame index) of every open-loop frame due
    in ``[0, seconds)``, in time order: scope s sends frame k at
    phase_s + k / fps, phases uniform in one frame period."""
    fps = float(traffic["fps"])
    n = int(traffic["scopes"])
    phases = rng.uniform(0.0, 1.0 / fps, n)
    starts = rng.integers(0, pool, n)
    out = []
    for s in range(n):
        k = 0
        while phases[s] + k / fps < seconds:
            out.append((phases[s] + k / fps, int((starts[s] + k) % pool)))
            k += 1
    out.sort()
    return out


def drive(engine, frames: list, traffic: dict, seconds: float,
          rng: np.random.Generator, n_check: int, slicer: Slicer,
          grace_s: float) -> tuple[Window, Sampler]:
    """Submit every frame of ``schedule`` at its due time; ``n_check`` of
    them, drawn from the seed, keep their maps for the check."""
    plan = schedule(traffic, seconds, rng, len(frames))
    reqs = [Request(i, f, 0.0) for i, (_, f) in enumerate(plan)]
    sampler = Sampler(n_check, rng, list(range(len(reqs))))
    engine.reset_stats()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    lateness = []
    for (off, _), req in zip(plan, reqs):
        req.due = t0 + off
        while True:
            now = time.perf_counter()
            slicer.poll(now - t0)
            if now >= req.due:
                break
            time.sleep(min(req.due - now, 0.002))
        req.submitted = time.perf_counter()
        lateness.append(req.submitted - req.due)
        fut = engine.submit(frames[req.frame])
        fut.add_done_callback(lambda f, r=req: resolve(r, f, sampler))
    while (now := time.perf_counter()) < t1:
        slicer.poll(now - t0)
        time.sleep(min(t1 - now, 0.01))
    stats = engine.stats()
    slicer.finish()
    win = Window(t0, t1, reqs, stats, lateness)
    drain(reqs, grace_s)
    return win, sampler
