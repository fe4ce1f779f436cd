"""The generators: the open-loop schedule follows from the seed, a stall
moves live_p95_ms, the closed loop keeps its frames in flight."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from h100_bench import harness, loadgen
from h100_bench.generators import closed_loop, open_loop
from h100_bench.tests.helpers import tiny_spec

TRAFFIC = dict(scopes=3, fps=30)


def test_schedule_follows_the_seed():
    a = open_loop.schedule(TRAFFIC, 2.0, np.random.default_rng(5), 64)
    b = open_loop.schedule(TRAFFIC, 2.0, np.random.default_rng(5), 64)
    c = open_loop.schedule(TRAFFIC, 2.0, np.random.default_rng(2**40 + 5), 64)
    assert a == b and a != c
    # Every seed sends each scope's frames one period apart: the same
    # count, in another phase.
    assert len(a) == len(c) == 3 * 60
    offs = np.asarray([t for t, _ in a])
    assert np.all(np.diff(offs) >= 0) and offs.max() < 2.0


class _FakeEngine:
    """Resolves each frame ``delay`` seconds after it is submitted, and
    nothing while ``stall`` is set."""

    def __init__(self, delay: float):
        self.delay, self.stall = delay, threading.Event()
        self.pending: list = []
        self.lock = threading.Lock()
        self.stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, frame):
        fut = Future()
        with self.lock:
            self.pending.append((time.perf_counter() + self.delay, fut))
        return fut

    def _run(self):
        while not self.stop:
            time.sleep(0.001)
            if self.stall.is_set():
                continue
            now = time.perf_counter()
            with self.lock:
                due = [p for p in self.pending if p[0] <= now]
                self.pending = [p for p in self.pending if p[0] > now]
            for _, fut in due:
                fut.set_result(np.zeros((2, 2), np.float32))

    def reset_stats(self):
        pass

    def stats(self):
        return {"batches": 0}


def _p95(stall_s: float) -> float:
    engine = _FakeEngine(0.005)
    spec = tiny_spec("open_loop", scopes=4, fps=50)
    if stall_s:
        threading.Timer(0.4, engine.stall.set).start()
        threading.Timer(0.4 + stall_s, engine.stall.clear).start()
    window, _ = open_loop.drive(engine, [None] * 8, spec["traffic"], 1.5,
                                np.random.default_rng(1), 4,
                                loadgen.Slicer(), 2.0)
    engine.stop = True
    run = harness.Run(spec, "cpu", 0.0, window)
    return harness.load_reader("live_p95_ms")(run)


def test_a_stall_moves_live_p95():
    calm = _p95(0.0)
    stalled = _p95(0.5)
    assert calm < 60.0
    # Frames due during the stall wait for it, timed from when they were
    # due, so the tail carries most of the stall.
    assert stalled > calm + 250.0


def test_a_frame_never_answered_counts_above_any_limit():
    spec = tiny_spec("open_loop")
    w = loadgen.Window(0.0, 1.0, [loadgen.Request(i, 0, 0.5)
                                  for i in range(100)])
    for r in w.requests:
        r.ok, r.done = True, 0.51
    run = harness.Run(spec, "cpu", 0.0, w)
    assert harness.load_reader("live_p95_ms")(run) < 20.0
    for r in w.requests[:6]:
        r.ok, r.done = False, float("inf")
    # Missing frames count at the window's close plus the grace.
    assert harness.load_reader("live_p95_ms")(run) >= 1e3 * 5.0


def test_closed_loop_keeps_its_frames_in_flight():
    engine = _FakeEngine(0.01)
    spec = tiny_spec("closed_loop", in_flight=6)
    window, sampler = closed_loop.drive(
        engine, [None] * 8, spec["traffic"], 0.5, np.random.default_rng(3),
        4, loadgen.Slicer(), 2.0)
    engine.stop = True
    done = [r for r in window.requests if r.ok]
    assert len(done) == len(window.requests) > 6 * 20
    # At most in_flight were out at any time.
    events = sorted([(r.submitted, 1) for r in done]
                    + [(r.done, -1) for r in done])
    level = np.cumsum([d for _, d in events])
    assert level.max() <= 6
    assert len(sampler.kept) == 4
