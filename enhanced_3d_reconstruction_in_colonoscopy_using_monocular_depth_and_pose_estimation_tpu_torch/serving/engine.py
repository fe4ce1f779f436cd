"""Streaming depth-inference engine for serving.

- callers ``submit()`` uint8 BGR frames and get futures;
- a batcher thread groups requests of one resolution up to ``batch_size``,
  flushing after ``max_delay_s`` so latency stays bounded at low load;
  frames of another resolution wait in a worker-local deferred list;
- one ``BatchedRunner`` per resolution runs resize, normalization, the
  forward and the resize back on the model's device, with ragged tails
  padded so each resolution has one batch shape;
- ``close()`` serves everything submitted before it, then stops the thread.

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
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from ..core.device import resolve_device
from ..models.depth_anything import BatchedRunner


class _Stats:
    """Serving counters + end-to-end latency quantiles.

    Latency = submit() to result-set (queueing + batching delay + device
    time). A bounded reservoir of the most recent samples keeps memory
    O(1) on long-running servers.
    """

    def __init__(self, keep: int = 4096):
        self._lock = threading.Lock()
        self._keep = keep
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._lat: list[float] = []
            self._pos = 0
            self.submitted = 0
            self.completed = 0
            self.failed = 0
            self.batches = 0
            self.batch_fill = 0  # sum of batch sizes, for mean fill
            self.runner_s = 0.0  # wall time inside the runners

    def note_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def note_batch(self, size: int, latencies_s: list[float],
                   failed: bool, runner_s: float = 0.0) -> None:
        with self._lock:
            self.runner_s += runner_s
            self.batches += 1
            self.batch_fill += size
            if failed:
                self.failed += size
            else:
                self.completed += size
            for v in latencies_s:
                if len(self._lat) < self._keep:
                    self._lat.append(v)
                else:  # ring buffer: most recent window
                    self._lat[self._pos] = v
                    self._pos = (self._pos + 1) % self._keep

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "mean_batch_fill": (self.batch_fill / self.batches
                                    if self.batches else 0.0),
                "runner_seconds": self.runner_s,
            }
            if lat.size:
                out.update(
                    latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
                    latency_p95_ms=float(np.percentile(lat, 95) * 1e3),
                    latency_p99_ms=float(np.percentile(lat, 99) * 1e3),
                    latency_max_ms=float(lat.max() * 1e3),
                )
            return out


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
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(self, bgr: np.ndarray) -> Future:
        """Submit one BGR uint8 frame; resolves to an (H, W) f32 depth map."""
        fut: Future = Future()
        with self._lock:  # closed-check + put must be atomic vs close()
            if self._closed:
                raise RuntimeError("engine is closed")
            # Counted in the same critical section as the put, so a
            # concurrent stats() reader never sees completed > submitted.
            self._stats.note_submit()
            self._queue.put((bgr, fut, time.monotonic()))
        return fut

    def submit_many(self, frames: Sequence[np.ndarray]) -> list[Future]:
        return [self.submit(f) for f in frames]

    def stats(self) -> dict:
        """Serving counters and end-to-end latency quantiles (ms):
        submitted/completed/failed, batches, mean batch fill, the wall
        seconds spent inside the runners (upload, forward, readback;
        ``runner_seconds``), p50/p95/p99 over a recent-sample
        reservoir."""
        return self._stats.snapshot()

    def reset_stats(self) -> None:
        """Zero the counters and latency reservoir, e.g. after warmup, so
        first-batch set-up does not sit in the p99 of a measurement."""
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
        calibration backlog is held and no frame came for max_delay_s."""
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
        items = [first]
        shape = first[0].shape
        # deferred frames of the same shape join this batch immediately
        same = [d for d in self._deferred if d[0].shape == shape]
        for d in same[: self.batch_size - 1]:
            self._deferred.remove(d)
            items.append(d)
        deadline = time.monotonic() + self.max_delay_s
        saw_sentinel = False
        while len(items) < self.batch_size:
            timeout = deadline - time.monotonic()
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
            items.append(nxt)
        if saw_sentinel:
            self._queue.put(None)  # keep shutdown pending until drained
        return items

    def _runner(self, shape: tuple) -> BatchedRunner:
        runner = self._runners.get(shape)
        if runner is None:
            runner = BatchedRunner(self.model, shape[:2], self.input_size,
                                   self.batch_size)
            self._runners[shape] = runner
        return runner

    def _serve_items(self, items, runner=None) -> None:
        frames = [bgr for bgr, _, _ in items]
        futures = [fut for _, fut, _ in items]
        failed = False
        t0 = time.monotonic()
        try:
            depths = (runner or self._runner(frames[0].shape))(frames)
            for fut, depth in zip(futures, depths):
                fut.set_result(depth)
        except Exception as exc:  # the worker keeps serving; waiters see it
            failed = True
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)
        done = time.monotonic()
        self._stats.note_batch(len(items), [done - t for _, _, t in items],
                               failed, done - t0)

    def _freeze_and_serve(self, shape: tuple) -> None:
        """Calibrate once on the backlog held for ``shape``, keep the
        frozen-scale runner, and serve the backlog through it."""
        items = self._calib_wait.pop(shape, [])
        if not items:
            return
        try:
            runner = BatchedRunner(
                self.model, shape[:2], self.input_size, self.batch_size,
                calib_frames=[bgr for bgr, _, _ in items],
                calib_batches=self.calib_batches)
        except Exception as exc:  # the worker keeps serving; waiters see it
            for _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(exc)
            self._stats.note_batch(len(items), [], True)
            return
        self._runners[shape] = runner
        self._serve_items(items, runner)

    def _run(self) -> None:
        while True:
            items = self._collect_batch()
            if not items:
                # Shutdown (None) or an idle queue ([]): calibrate and
                # serve whatever is held.
                for shape in list(self._calib_wait):
                    self._freeze_and_serve(shape)
                if items is None:
                    return
                continue
            shape = items[0][0].shape
            if self.calib_batches > 0 and shape not in self._runners:
                wait = self._calib_wait.setdefault(shape, [])
                wait.extend(items)
                # Once K batches are held, or early on a partial batch.
                if (len(wait) >= self.calib_batches * self.batch_size
                        or len(items) < self.batch_size):
                    self._freeze_and_serve(shape)
                continue
            self._serve_items(items, self._fixed_runner)
