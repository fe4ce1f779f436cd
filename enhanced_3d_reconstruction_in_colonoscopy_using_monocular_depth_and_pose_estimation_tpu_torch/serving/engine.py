"""Streaming depth-inference engine for serving.

- callers ``submit()`` uint8 BGR frames and get futures;
- a batcher thread groups requests of one resolution up to ``batch_size``,
  flushing after ``max_delay_s`` so latency stays bounded at low load;
  frames of another resolution wait in a worker-local deferred list;
- one ``BatchedRunner`` per resolution runs resize, normalization, the
  forward and the resize back on the model's device, with ragged tails
  padded so each resolution has one batch shape;
- ``close()`` serves everything submitted before it, then stops the thread.

Each frame and batch leaves spans in ``core.debug``'s recorder, stamped on
``perf_counter_ns``: ``engine.queue`` (``submit()`` to the batcher taking
the frame) and ``engine.frame`` (``submit()`` to its future resolved),
both with the frame's number as ``ident``; ``engine.collect`` (the
batch's first frame taken to the batch closed: full, at the flush
deadline or at shutdown; ``value`` the rows) and ``engine.batch`` (the
runner's call and the futures resolved; the parent of the frames' spans
and of the ``runner.*`` spans), with the batch's number; all under
``engine.run``, the batcher thread's life. ``stats()`` reads its latency
quantiles from the ``engine.frame`` spans.

The model's weights go to the device once, when the engine is built.

``runner`` (optional) replaces the per-resolution ``BatchedRunner``s:
any ``list[BGR uint8] -> list[(H, W) f32]`` callable, such as an
exported program (``serving/export.py::exported_runner``,
``cli/serve.py --from-export``); ``model`` may then be ``None``.

``calib_batches`` K > 0 (a ``quant_int8`` model) calibrates static int8
scales once per resolution: the first K device batches are held (their
futures resolve late), calibrate a frozen-scale ``BatchedRunner``, and
are served through it with every later batch of that resolution. A
partial batch, an idle queue or ``close()`` calibrates early on what is
held. So a held backlog waits at most ``max_delay_s`` for more frames:
the JAX package's engine waits for the next frame without a timeout and
hangs when the frames stop, below K batches, at a multiple of the batch
size.

Clip mode: an engine built on a Video Depth Anything model
(``models.depth_anything.VideoDepthAnything``) serves streams, not
frames: ``submit(frame, stream=key)`` keys each frame by its stream, in
order, and ``end_stream(key)`` says the stream has ended. The batcher
cuts each stream into VDA's windows (``serving/clips.py``: 32 positions,
22 new frames each after the first, the first 10 carried from the window
before), runs one window a forward (B = 1, 32 frames) through a
``ClipRunner``, aligns and blends it on the device, and resolves a
frame's future with its final map: most frames with their window, the
last 8 of a window with the next window's blend, and the rest of a stream
once ``end_stream`` has run its last window, padded with copies of its
last frame. Windows run in the order their streams became ready. A
stream's state is freed at its end. ``close()`` ends every open stream.
Besides the frame spans, each window leaves ``clip.collect`` (the
window's first new frame taken to the window formed; ``value`` the
stream's window number) and ``clip.stitch`` (alignment and blend), inside
``engine.batch``, and the counters ``clip.windows``, ``clip.new_frames``,
``clip.carried_frames`` and ``clip.padded_frames``; ``stats()`` counts a
window as a batch whose fill is the frames it resolved.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from ..core import debug
from ..core.device import resolve_device
from ..models.depth_anything import (BatchedRunner, ClipRunner,
                                     VideoDepthAnything)
from . import clips as cliplib


class _Stats:
    """Serving counters since the last ``reset()`` (``since_ns``, on
    ``perf_counter_ns``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.since_ns = time.perf_counter_ns()
            self.submitted = 0
            self.completed = 0
            self.failed = 0
            self.batches = 0
            self.batch_fill = 0  # sum of batch sizes, for mean fill
            self.runner_s = 0.0  # wall time inside the runners

    def note_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def note_batch(self, size: int, failed: bool,
                   runner_s: float = 0.0) -> None:
        with self._lock:
            self.runner_s += runner_s
            self.batches += 1
            self.batch_fill += size
            if failed:
                self.failed += size
            else:
                self.completed += size

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "mean_batch_fill": (self.batch_fill / self.batches
                                    if self.batches else 0.0),
                "runner_seconds": self.runner_s,
            }


class DepthServingEngine:
    """Batched streaming inference over a fixed model."""

    def __init__(self, model, input_size: int = 518, batch_size: int = 8,
                 max_delay_s: float = 0.05,
                 device: str = "cuda", calib_batches: int = 0,
                 runner=None):
        self.calib_batches = int(calib_batches)
        if self.calib_batches > 0:
            if runner is not None:
                raise ValueError("calib_batches does not apply to an "
                                 "exported runner (its dials are fixed "
                                 "at export time)")
            if not getattr(model, "quant_int8", False):
                raise ValueError("calib_batches requires a quant_int8 "
                                 "model (--int8)")
        self._fixed_runner = runner
        self.clip_mode = isinstance(model, VideoDepthAnything)
        if self.clip_mode and (runner is not None or self.calib_batches):
            raise ValueError("a video model serves through its own clip "
                             "runner, without calibration")
        self.model = (None if model is None
                      else model.to(resolve_device(device)).eval())
        self.input_size = input_size
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self._runners: dict[tuple, BatchedRunner] = {}  # worker-local
        # worker-local: resolution -> items held for calibration
        self._calib_wait: dict[tuple, list] = {}
        self._queue: queue.Queue = queue.Queue()
        self._stats = _Stats()
        self._deferred: list = []  # worker-local: other-resolution frames
        self._closed = False
        self._lock = threading.Lock()
        self._frame_numbers = itertools.count()   # under self._lock
        self._batch_numbers = itertools.count()   # worker-local
        # Clip mode, worker-local: streams by key, those ready in order.
        self._streams: dict = {}
        self._ready: collections.deque = collections.deque()
        self._clip_runners: dict[tuple, ClipRunner] = {}
        self._run_span = debug.span("engine.run")
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(self, bgr: np.ndarray, stream=None) -> Future:
        """Submit one BGR uint8 frame; resolves to an (H, W) f32 map:
        metric depth, or in clip mode (``stream``, any hashable key, is
        required there and refused elsewhere) the frame's final aligned
        relative disparity."""
        if (stream is None) == self.clip_mode:
            raise ValueError("submit(frame, stream=key) serves a video "
                             "model; a frame model takes no stream"
                             if self.clip_mode is False else
                             "a video model serves streams: "
                             "submit(frame, stream=key)")
        fut: Future = Future()
        with self._lock:  # closed-check + put must be atomic vs close()
            if self._closed:
                raise RuntimeError("engine is closed")
            # Counted in the same critical section as the put, so a
            # concurrent stats() reader never sees completed > submitted.
            self._stats.note_submit()
            self._queue.put((bgr, fut, time.perf_counter_ns(),
                             next(self._frame_numbers), stream))
        return fut

    def end_stream(self, stream) -> None:
        """Clip mode: ``stream`` has no more frames; its last windows run
        (padded) and its state is freed."""
        if not self.clip_mode:
            raise ValueError("end_stream applies to a video model")
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.put(("end", stream))

    def submit_many(self, frames: Sequence[np.ndarray]) -> list[Future]:
        return [self.submit(f) for f in frames]

    def stats(self) -> dict:
        """Serving counters and end-to-end latency quantiles (ms) since
        the last ``reset_stats()``: submitted/completed/failed, batches,
        mean batch fill, the wall seconds spent inside the runners
        (upload, forward, readback; ``runner_seconds``), and p50/p95/p99
        and max of ``submit()`` to resolved over this engine's
        ``engine.frame`` spans that the recorder holds (none while
        tracing is off)."""
        out = self._stats.snapshot()
        since, run_id = self._stats.since_ns, self._run_span.id
        if run_id is None:
            return out
        batches = {s.id for s in debug.spans("engine.batch", since)
                   if s.parent == run_id}
        lat = np.asarray([s.ms for s in debug.spans("engine.frame", since)
                          if s.parent in batches], np.float64)
        if lat.size:
            out.update(
                latency_p50_ms=float(np.percentile(lat, 50)),
                latency_p95_ms=float(np.percentile(lat, 95)),
                latency_p99_ms=float(np.percentile(lat, 99)),
                latency_max_ms=float(lat.max()),
            )
        return out

    def reset_stats(self) -> None:
        """Zero the counters and start the latency quantiles afresh, e.g.
        after warmup, so first-batch set-up does not sit in the p99 of a
        measurement."""
        self._stats.reset()

    def close(self) -> None:
        """Serve what was submitted, then stop the batcher thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=600)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- internals

    def _collect_batch(self):
        """Block for one item, then greedily batch same-resolution frames
        until batch_size or max_delay_s. Other-resolution frames go to a
        worker-local deferred list (NOT back onto the queue: a tail
        re-queue would land behind the shutdown sentinel and starve
        minority resolutions). Returns None only once everything,
        including deferred frames, has been served, and [] when a
        calibration backlog is held and no frame came for max_delay_s;
        else ``(batch number, items)``. A frame's ``engine.queue`` span
        ends when it joins a batch."""
        if self._deferred:
            first = self._deferred.pop(0)
        else:
            try:
                first = self._queue.get(
                    timeout=self.max_delay_s if self._calib_wait else None)
            except queue.Empty:
                return []
            if first is None:
                return None
        items = []

        def take(item) -> None:
            debug.record("engine.queue", item[2], time.perf_counter_ns(),
                         item[3])
            items.append(item)

        with debug.span("engine.collect",
                        next(self._batch_numbers)) as collect:
            take(first)
            shape = first[0].shape
            # deferred frames of the same shape join this batch immediately
            same = [d for d in self._deferred if d[0].shape == shape]
            for d in same[: self.batch_size - 1]:
                self._deferred.remove(d)
                take(d)
            deadline = time.perf_counter() + self.max_delay_s
            saw_sentinel = False
            while len(items) < self.batch_size:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    saw_sentinel = True
                    break
                if nxt[0].shape != shape:
                    self._deferred.append(nxt)
                    continue
                take(nxt)
            collect.value = len(items)
        if saw_sentinel:
            self._queue.put(None)  # keep shutdown pending until drained
        return collect.ident, items

    def _runner(self, shape: tuple) -> BatchedRunner:
        runner = self._runners.get(shape)
        if runner is None:
            runner = BatchedRunner(self.model, shape[:2], self.input_size,
                                   self.batch_size)
            self._runners[shape] = runner
        return runner

    def _serve_items(self, items, runner=None, number=None) -> None:
        frames = [item[0] for item in items]
        failed = False
        with debug.span("engine.batch", number) as batch:
            t0 = time.perf_counter()
            try:
                depths = (runner or self._runner(frames[0].shape))(frames)
                for item, depth in zip(items, depths):
                    item[1].set_result(depth)
                    self._frame_done(item, batch.id)
            except Exception as exc:
                # The worker keeps serving; the waiters see the error.
                failed = True
                for item in items:
                    if not item[1].done():
                        item[1].set_exception(exc)
                        self._frame_done(item, batch.id)
            runner_s = time.perf_counter() - t0
        self._stats.note_batch(len(items), failed, runner_s)

    @staticmethod
    def _frame_done(item, batch_id) -> None:
        debug.record("engine.frame", item[2], time.perf_counter_ns(),
                     item[3], batch_id)

    def _freeze_and_serve(self, shape: tuple) -> None:
        """Calibrate once on the backlog held for ``shape``, keep the
        frozen-scale runner, and serve the backlog through it."""
        items = self._calib_wait.pop(shape, [])
        if not items:
            return
        try:
            runner = BatchedRunner(
                self.model, shape[:2], self.input_size, self.batch_size,
                calib_frames=[item[0] for item in items],
                calib_batches=self.calib_batches)
        except Exception as exc:  # the worker keeps serving; waiters see it
            for item in items:
                if not item[1].done():
                    item[1].set_exception(exc)
            self._stats.note_batch(len(items), True)
            return
        self._runners[shape] = runner
        self._serve_items(items, runner, next(self._batch_numbers))

    def _run(self) -> None:
        with self._run_span:
            if self.clip_mode:
                self._clip_loop()
            else:
                self._loop()

    # ------------------------------------------------------------ clip mode

    def _clip_loop(self) -> None:
        """Take frames and ends off the queue into their streams; run the
        oldest ready stream's next window whenever one is ready. At
        ``close()`` every open stream ends and runs out."""
        while True:
            block = not self._ready
            try:
                item = self._queue.get(block=block)
            except queue.Empty:
                self._clip_window(self._ready.popleft())
                continue
            if item is None:
                for st in list(self._streams.values()):
                    st.ended = True
                    self._mark_ready(st)
                while self._ready:
                    self._clip_window(self._ready.popleft())
                return
            if isinstance(item[0], str):        # ("end", key)
                st = self._streams.get(item[1])
                if st is not None:
                    st.ended = True
                    self._mark_ready(st)
                continue
            self._clip_take(item)

    def _clip_take(self, item) -> None:
        now = time.perf_counter_ns()
        debug.record("engine.queue", item[2], now, item[3])
        key = item[4]
        st = self._streams.get(key)
        if st is None:
            st = self._streams[key] = cliplib.Stream(key, item[0].shape)
        if item[0].shape != st.shape or st.ended:
            item[1].set_exception(ValueError(
                f"stream {key!r}: " + ("ended" if st.ended else
                f"frame {item[0].shape}, the stream's are {st.shape}")))
            self._frame_done(item, None)
            self._stats.note_batch(1, True)
            return
        st.pending.append((item, now))
        st.received += 1
        self._mark_ready(st)

    def _mark_ready(self, st) -> None:
        if st.ready() and st.key not in self._ready:
            self._ready.append(st.key)

    def _clip_runner(self, shape: tuple) -> ClipRunner:
        runner = self._clip_runners.get(shape)
        if runner is None:
            runner = self._clip_runners[shape] = ClipRunner(
                self.model, shape[:2], self.input_size)
        return runner

    def _clip_window(self, key) -> None:
        """Run stream ``key``'s next window, stitch it and resolve the
        frames it makes final."""
        st = self._streams[key]
        k = st.windows
        taken = st.pending[:st.need()]
        del st.pending[:len(taken)]
        take = [item for item, _ in taken]
        pad = st.need() - len(take)
        now = time.perf_counter_ns()
        debug.record("clip.collect", taken[0][1] if taken else now, now, k,
                     value=len(take))
        carried = 0 if k == 0 else cliplib.OVERLAP
        # New positions final at once; the rest wait for the next blend.
        n_final = cliplib.FINAL_END - carried
        waiting = st.waiting
        failed = False
        with debug.span("engine.batch", next(self._batch_numbers)) as batch:
            t0 = time.perf_counter()
            try:
                inputs, maps = self._clip_runner(st.shape)(
                    [item[0] for item in take], st.carried, pad,
                    st.last_input)
                if take:
                    end = carried + len(take)
                    st.last_input = inputs[end - 1:end]
                st.carried = inputs[list(cliplib.KEYFRAMES)]
                with debug.span("clip.stitch", k):
                    final, st.ref, st.tail, done = cliplib.stitch(
                        maps, k == 0, st.ref, st.tail)
                st.windows += 1
                st.waiting = take[n_final:]
                items = waiting + take[:n_final]
                out = ([] if done is None else [done[:len(waiting)]]) \
                    + [final[:len(take[:n_final])]]
                if st.done():     # no window follows: the tail is final
                    items += st.waiting
                    out.append(st.tail[:len(st.waiting)])
                    st.waiting = []
                host = ClipRunner.readback(torch.cat(out))
                for item, depth in zip(items, host):
                    item[1].set_result(depth)
                    self._frame_done(item, batch.id)
            except Exception as exc:
                # The stream is dropped; the worker keeps serving.
                failed = True
                items = waiting + take + [item for item, _ in st.pending]
                st.pending, st.waiting, st.ended = [], [], True
                for item in items:
                    if not item[1].done():
                        item[1].set_exception(exc)
                        self._frame_done(item, batch.id)
            runner_s = time.perf_counter() - t0
        debug.count("clip.windows")
        debug.count("clip.new_frames", len(take))
        debug.count("clip.carried_frames", carried)
        debug.count("clip.padded_frames", pad)
        self._stats.note_batch(len(items), failed, runner_s)
        if failed or st.done():
            self._streams.pop(key, None)
        elif st.ready():
            self._ready.append(key)

    def _loop(self) -> None:
        while True:
            got = self._collect_batch()
            if not got:
                # Shutdown (None) or an idle queue ([]): calibrate and
                # serve whatever is held.
                for shape in list(self._calib_wait):
                    self._freeze_and_serve(shape)
                if got is None:
                    return
                continue
            number, items = got
            shape = items[0][0].shape
            if self.calib_batches > 0 and shape not in self._runners:
                wait = self._calib_wait.setdefault(shape, [])
                wait.extend(items)
                # Once K batches are held, or early on a partial batch.
                if (len(wait) >= self.calib_batches * self.batch_size
                        or len(items) < self.batch_size):
                    self._freeze_and_serve(shape)
                continue
            self._serve_items(items, self._fixed_runner, number)
