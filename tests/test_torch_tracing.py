"""``core.debug``'s recorder on the CPU: spans, counts, the ring, the off
switch and the profiler twins, and the spans the port's engine, runner
and training step leave (the tiny ``vitt`` model)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import debug
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.preprocess import DevicePreprocessor
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.serving.engine import DepthServingEngine
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask

FRAME_HW = (60, 80)
INPUT_SIZE = 56


@pytest.fixture(scope="module")
def vitt():
    return tda.build_depth_model("vitt", 20.0, torch.float32, device="cpu")


def _frames(n: int, seed: int = 0) -> list[np.ndarray]:
    return list(np.random.default_rng(seed).integers(
        0, 256, size=(n, *FRAME_HW, 3), dtype=np.uint8))


def test_spans_nest_on_a_thread_and_take_ids_across_threads():
    rec = debug.Recorder(capacity=64)
    with rec.span("outer", ident=7) as outer:
        with rec.span("inner") as inner:
            pass
        with rec.span("inner") as second:
            pass
    assert outer.parent is None and outer.ident == 7
    assert inner.parent == second.parent == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns
    assert [s.id for s in rec.spans("inner")] == [inner.id, second.id]

    got = {}

    def worker():
        with rec.span("thread") as s:
            got["span"] = s

    with rec.span("main") as main:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    # Another thread's span has its own stack: no parent, a fresh id.
    assert got["span"].parent is None
    ids = [outer.id, inner.id, second.id, main.id, got["span"].id]
    assert len(set(ids)) == len(ids)
    # A span that crosses threads is recorded whole, with the parent given.
    sid = rec.record("queue", main.start_ns, main.end_ns, ident=3,
                     parent=main.id, value=2)
    (queued,) = rec.spans("queue")
    assert (queued.id, queued.parent, queued.ident, queued.value) == (
        sid, main.id, 3, 2)
    assert queued.ms == pytest.approx(main.ms)


def test_ring_keeps_its_capacity_and_counts_what_it_dropped():
    rec = debug.Recorder(capacity=8)
    for k in range(5):
        rec.count("c", k)
    assert [c.n for c in rec.counts("c")] == [0, 1, 2, 3, 4]
    assert rec.dropped() == 0
    for k in range(5, 12):
        rec.count("c", k)
    held = rec.counts("c")
    assert [c.n for c in held] == list(range(4, 12))
    assert rec.dropped() == 4
    mid = held[3].t_ns
    assert [c.n for c in rec.counts("c", mid, None)][0] == 7
    assert [c.n for c in rec.counts("c", None, mid)][-1] == 7
    # The ring covers what ended after the newest dropped entry only.
    rec = debug.Recorder(capacity=8)
    for k in range(1, 13):
        rec.record("s", 10 * k - 5, 10 * k)
    assert [s.end_ns for s in rec.spans("s")] == list(range(50, 130, 10))
    assert rec.dropped() == 4
    assert rec.dropped(since_ns=41) == 0
    assert rec.dropped(since_ns=40) == 4


def test_spans_are_read_whole_inside_an_interval():
    rec = debug.Recorder(capacity=16)
    for a, b in ((0, 10), (5, 20), (12, 18), (19, 30)):
        rec.record("s", a, b)
    assert [(s.start_ns, s.end_ns) for s in rec.spans("s", 5, 20)] == [
        (5, 20), (12, 18)]
    assert len(rec.spans("s")) == 4 and rec.spans("other") == []


def test_tracing_off_records_nothing():
    t0 = time.perf_counter_ns()
    debug.tracing(False)
    try:
        with debug.span("tracing.off") as s:
            pass
        debug.count("tracing.off.count", 3)
        assert debug.record("tracing.off", 0, 1) is None
    finally:
        debug.tracing(True)
    # The span still timed its block for its caller.
    assert s.id is None and s.end_ns >= s.start_ns >= t0
    assert debug.spans("tracing.off", t0) == []
    assert debug.counts("tracing.off.count", t0) == []
    with debug.tracing(False):
        with debug.span("tracing.off"):
            pass
    with debug.span("tracing.on") as on:
        pass
    assert debug.RECORDER.enabled and on.id is not None
    assert debug.spans("tracing.off", t0) == []
    assert [s.id for s in debug.spans("tracing.on", t0)] == [on.id]


def test_device_span_off_cuda_has_no_device_time():
    rec = debug.Recorder(capacity=4)
    with rec.span("optimizer", device=True):
        pass
    (s,) = rec.spans("optimizer")
    assert s.device_ms is None


def test_a_span_and_its_profiler_twin_agree(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # The first twin under a new profiler pays the profiler's set-up.
        with debug.span("tracing.warm"):
            pass
        with debug.span("tracing.twin") as s:
            torch.ones(64).sum()
    # time_ns less perf_counter_ns, from the read pair least interrupted.
    pairs = []
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        pairs.append((b - a, t - (a + b) // 2))
    offset_ns = min(pairs)[1]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (twin,) = [e for e in trace["traceEvents"]
               if e.get("name") == "tracing.twin" and e.get("ph") == "X"]
    base = int(trace.get("baseTimeNanoseconds", 0))
    start_ns = round(float(twin["ts"]) * 1e3) + base
    assert abs(start_ns - (s.start_ns + offset_ns)) < 1e6
    assert abs(float(twin["dur"]) * 1e3 - (s.end_ns - s.start_ns)) < 1e6


def test_a_frame_followed_through_the_engine(vitt):
    t0 = time.perf_counter_ns()
    with DepthServingEngine(vitt, input_size=INPUT_SIZE, batch_size=4,
                            max_delay_s=0.5, device="cpu") as engine:
        futures = engine.submit_many(_frames(3, seed=1))
        for f in futures:
            f.result(timeout=60)
        stats = engine.stats()
    assert stats["completed"] == 3
    assert 0 < stats["latency_p50_ms"] <= stats["latency_p95_ms"] \
        <= stats["latency_p99_ms"] <= stats["latency_max_ms"]

    frames = debug.spans("engine.frame", t0)
    assert sorted(s.ident for s in frames) == [0, 1, 2]
    frame = next(s for s in frames if s.ident == 1)
    (queued,) = [s for s in debug.spans("engine.queue", t0) if s.ident == 1]
    assert frame.start_ns == queued.start_ns
    assert queued.end_ns <= frame.end_ns
    (batch,) = [s for s in debug.spans("engine.batch", t0)
                if s.id == frame.parent]
    (collect,) = [s for s in debug.spans("engine.collect", t0)
                  if s.ident == batch.ident]
    # Three frames were due; the batch of 4 closed at the flush deadline.
    assert collect.value == 3
    assert queued.end_ns <= collect.end_ns <= batch.start_ns \
        <= frame.end_ns <= batch.end_ns
    stages = [s for name in ("runner.upload", "runner.launch",
                             "runner.readback")
              for s in debug.spans(name, t0) if s.parent == batch.id]
    assert [s.name for s in stages] == ["runner.upload", "runner.launch",
                                        "runner.readback"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    assert batch.start_ns <= stages[0].start_ns
    assert stages[-1].end_ns <= batch.end_ns
    assert sum(s.ms for s in stages) <= batch.ms
    assert batch.parent is not None and batch.parent == collect.parent
    engine.reset_stats()
    assert "latency_p50_ms" not in engine.stats()


def test_runner_counts_the_rows_it_padded(vitt):
    t0 = time.perf_counter_ns()
    runner = tda.BatchedRunner(vitt, FRAME_HW, INPUT_SIZE, batch_size=4)
    assert len(runner(_frames(5, seed=2))) == 5
    assert [c.n for c in debug.counts("runner.rows", t0)] == [4, 4]
    assert [c.n for c in debug.counts("runner.padded_rows", t0)] == [0, 3]
    assert len(debug.spans("runner.upload", t0)) == 2


def test_a_training_step_records_its_stages():
    t0 = time.perf_counter_ns()
    task = DepthTask("vitt", encoder_lr=1e-3, decoder_lr=1e-3,
                     div_factor=25.0, total_steps=4, grad_accum=2,
                     device="cpu", grad_checkpoint=False)
    state = task.init_state(0)
    rng = np.random.default_rng(3)
    loader = {"image": rng.integers(0, 256, (4, 60, 64, 3), dtype=np.uint8),
              "depth": rng.integers(0, 65536, (4, 60, 64),
                                    dtype=np.uint16)}
    b = DevicePreprocessor(size=56, device="cpu")(
        loader, train=True, generator=torch.Generator().manual_seed(0))
    batch = {k: b[k].reshape(2, 2, *b[k].shape[1:])
             for k in ("image", "depth")}
    task.train_step(state, batch)
    assert len(debug.spans("train.preprocess", t0)) == 1
    micro = debug.spans("train.microbatch", t0)
    (opt,) = debug.spans("train.optimizer", t0)
    assert [s.ident for s in micro] == [0, 0] and opt.ident == 0
    assert micro[-1].end_ns <= opt.start_ns and opt.device_ms is None
