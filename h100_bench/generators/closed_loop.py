"""A closed loop (an offline run over a recorded procedure): ``in_flight``
frames are kept submitted, and each resolved frame is replaced by the next
at once. A request is due when it is submitted."""

from __future__ import annotations

import queue
import time

import numpy as np

from h100_bench import serving
from h100_bench.loadgen import (Request, Sampler, Slicer, Window, drain,
                                resolve)


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float):
    return serving.run(spec, seed, seconds, trace, device, t_start, drive)


def drive(engine, frames: list, traffic: dict, seconds: float,
          rng: np.random.Generator, n_check: int, slicer: Slicer,
          grace_s: float) -> tuple[Window, Sampler]:
    """Keep ``in_flight`` frames submitted for ``seconds``; a reservoir of
    ``n_check`` resolved maps is kept for the check."""
    sampler = Sampler(n_check, rng)
    done_q: queue.SimpleQueue = queue.SimpleQueue()
    order = rng.permutation(len(frames))
    reqs: list[Request] = []

    def submit() -> None:
        i = len(reqs)
        req = Request(i, int(order[i % len(order)]), time.perf_counter())
        reqs.append(req)
        fut = engine.submit(frames[req.frame])
        req.submitted = req.due
        fut.add_done_callback(
            lambda f, r=req: (resolve(r, f, sampler), done_q.put(r)))

    engine.reset_stats()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    for _ in range(int(traffic["in_flight"])):
        submit()
    while True:
        now = time.perf_counter()
        slicer.poll(now - t0)
        if now >= t1:
            break
        try:
            done_q.get(timeout=min(0.05, t1 - now))
        except queue.Empty:
            continue
        if time.perf_counter() < t1:
            submit()
    stats = engine.stats()
    slicer.finish()
    win = Window(t0, t1, reqs, stats)
    drain(reqs, grace_s)
    return win, sampler
