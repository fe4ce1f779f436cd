"""The traced slice of a window, and what is read from its trace.

A traced run profiles one steady slice in the middle of its window with
``torch.profiler`` (CPU and CUDA activities, every thread's host ops with
their input shapes), marked on the driving thread by a
``h100_bench.slice`` range, and reads it back from Chrome-trace JSON
written under ``TMPDIR`` and deleted at once. Recording every host op
slows the serving thread, so the slice's wall holds more idle device time
than an untraced window does; device times are the card's own. From it:

- ``busy_s``: the union of the device's activity (kernels, copies, sets)
  inside the slice, so overlapping kernels count once; ``device_ops()``
  the kernels with the most device time;
- ``op_calls(name)``: each call of a host op (``e3d::flash_attn_fwd``...)
  with its recorded shapes and the device seconds of the kernels it
  launched, matched through the launch's correlation id: a launch on the
  op's thread inside the op's range belongs to it;
- ``idle_by_host()``: the device's idle time inside the slice, summed by
  what the launching thread was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

SLICE_MARK = "h100_bench.slice"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def start_profiler(device_type: str):
    """A started profiler of every thread's host ops and their shapes and
    of the device; None if the installed torch cannot profile threads
    other than the caller's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None
    prof = profile(activities=acts, record_shapes=True,
                   experimental_config=cfg)
    prof.start()
    return prof


def read_events(prof) -> list[dict]:
    """The profiler's events, through a Chrome trace in ``TMPDIR``."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="h100_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Slice:
    """One slice's events (times in microseconds, as the trace has them)."""

    def __init__(self, events: list[dict]):
        marks = [e for e in events if e.get("name") == SLICE_MARK
                 and e.get("ph") == "X" and "dur" in e]
        if not marks:
            raise ValueError("the trace holds no slice mark")
        mark = max(marks, key=lambda e: e["dur"])
        self.t0 = float(mark["ts"])
        self.t1 = self.t0 + float(mark["dur"])
        self.device = [e for e in events if e.get("cat") in _DEVICE_CATS
                       and e.get("ph") == "X"]
        self.ops = [e for e in events if e.get("cat") == "cpu_op"
                    and e.get("ph") == "X"]
        self.launches = [e for e in events if e.get("cat") in _LAUNCH_CATS
                         and e.get("ph") == "X"
                         and "correlation" in e.get("args", {})]
        self._kernels = defaultdict(list)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self._kernels[corr].append(e)
        # Each thread's launches and ops, by start time.
        self._launch_ts: dict = defaultdict(list)
        self._launch_ev: dict = defaultdict(list)
        for e in sorted(self.launches, key=lambda e: float(e["ts"])):
            self._launch_ts[e.get("tid")].append(float(e["ts"]))
            self._launch_ev[e.get("tid")].append(e)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy_intervals(self) -> list[tuple[float, float]]:
        clipped = []
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                clipped.append((a, b))
        return _merge(clipped)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    def op_calls(self, name: str) -> list[tuple[dict, float]]:
        """(args, device seconds) of each call of op ``name`` that began
        inside the slice and launched at least one kernel."""
        calls = [e for e in self.ops if e["name"] == name
                 and self.t0 <= float(e["ts"]) < self.t1]
        out = []
        for op in calls:
            a, b = float(op["ts"]), float(op["ts"]) + float(op["dur"])
            ts = self._launch_ts.get(op.get("tid"), [])
            evs = self._launch_ev.get(op.get("tid"), [])
            secs = 0.0
            n = 0
            for launch in evs[bisect.bisect_left(ts, a):
                              bisect.bisect_right(ts, b)]:
                for k in self._kernels.get(launch["args"]["correlation"],
                                           ()):
                    if k.get("cat") == "kernel":
                        secs += float(k["dur"]) * 1e-6
                        n += 1
            if n:
                out.append((op.get("args", {}), secs))
        return out

    def device_ops(self) -> list[list]:
        """The ten kernels (and copies) with the most device seconds."""
        by_name: dict[str, float] = defaultdict(float)
        for e in self.device:
            if self.t0 <= float(e["ts"]) < self.t1:
                by_name[e["name"][:160]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    def idle_by_host(self) -> list[list]:
        """Idle device time inside the slice, summed by the host op the
        launching thread was in at each gap's middle (outermost > inner)."""
        tid = max(self._launch_ts, key=lambda t: len(self._launch_ts[t]),
                  default=None)
        ops = sorted((e for e in self.ops if e.get("tid") == tid),
                     key=lambda e: (float(e["ts"]), -float(e["dur"])))
        busy = self._busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out: dict[str, float] = defaultdict(float)
        # One sweep: ops on one thread nest, so the ops still open at a
        # time are a stack, outermost first.
        stack: list[dict] = []
        nxt = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while nxt < len(ops) and float(ops[nxt]["ts"]) <= mid:
                start = float(ops[nxt]["ts"])
                while stack and _end(stack[-1]) < start:
                    stack.pop()
                stack.append(ops[nxt])
                nxt += 1
            while stack and _end(stack[-1]) < mid:
                stack.pop()
            cover = stack
            if not cover:
                what = "no op (Python, numpy or waiting)"
            elif len(cover) == 1:
                what = cover[0]["name"]
            else:
                what = f"{cover[0]['name']} > {cover[-1]['name']}"
            out[what[:160]] += (b - a) * 1e-6
        return [[k, v] for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])[:10]]
