"""The video cells' set-up, window and check (``generators/video_streams.py``):
Video Depth Anything behind ``DepthServingEngine``'s clip mode, fed
whole procedures as streams, its final maps held against the reference's
windowed run (``reference/vda.py``).

A procedure is a stream of ``procedure_frames`` frames, frame i of
procedure p being ``pool[(o_p + i) % pool]`` with o_p drawn from the
seed; ``procedures_in_flight`` run at once, each kept ``ahead`` frames
submitted beyond its last resolved one, its stream ended once its last
frame is in, and a new procedure starts as soon as one has resolved every
frame. A request is due when it is submitted. At the window's close the
open procedures are ended, so that their last windows run (padded) and
every frame submitted resolves.

The check follows one procedure, drawn from the seed among the first
``check_procedures`` started in the window: every final map of its first
``check_frames`` frames (which six windows make final at 128: five
alignments and blends) must have resolved inside the window, and they are
compared with the reference run over the same frames from the first
window, as ``serving.check_serving`` compares maps (``map_rel_err``).
"""

from __future__ import annotations

import importlib
import queue
import time
from dataclasses import dataclass

import numpy as np

from . import loadgen
from . import trace as tracelib
from .harness import PORT, Outcome, Run, free, log, log_rate, sync
from .reference.dav2 import lower_bound_hw
from .reference.vda import OVERLAP, VDA, WINDOW
from .serving import relative_error
from .weights_vda import make_vda_weights

STEP = WINDOW - OVERLAP


@dataclass
class ClipRequest(loadgen.Request):
    proc: int = 0              # the procedure's number in the window
    pos: int = 0               # the frame's number in its procedure


class VideoSlice(tracelib.Slice):
    """A traced slice that also reads the program's span twins
    (``user_annotation`` ranges, such as ``temporal.module``)."""

    def __init__(self, events: list[dict]):
        super().__init__(events)
        self.annotations = [e for e in events
                            if e.get("cat") == "user_annotation"
                            and e.get("ph") == "X"]

    def range_device_s(self, name: str) -> float | None:
        """Device seconds of the kernels launched inside the ranges
        ``name`` that began in the slice (matched as ``op_calls``
        matches an op's); None without such a range."""
        ranges = [e for e in self.annotations if e["name"] == name
                  and self.t0 <= float(e["ts"]) < self.t1]
        if not ranges:
            return None
        import bisect

        seen: set = set()
        secs = 0.0
        for r in ranges:
            a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
            ts = self._launch_ts.get(r.get("tid"), [])
            evs = self._launch_ev.get(r.get("tid"), [])
            for launch in evs[bisect.bisect_left(ts, a):
                              bisect.bisect_right(ts, b)]:
                corr = launch["args"]["correlation"]
                if corr in seen:
                    continue
                seen.add(corr)
                secs += sum(float(k["dur"]) * 1e-6
                            for k in self._kernels.get(corr, ())
                            if k.get("cat") == "kernel")
        return secs


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Outcome:
    run_ = window(spec, seed, seconds, trace, device, t_start)
    t = time.perf_counter()
    correct, checks = check(run_, seed)
    log(f"check took {time.perf_counter() - t:.2f} s")
    reqs = run_.window.requests
    return Outcome(run_, correct, checks, len(reqs),
                   sum(1 for r in reqs if not r.ok))


def build(spec: dict, seed: int, device: str):
    """The port's VDA model with the seed's weights, through the port's
    converter of the published layout."""
    import torch

    depth_anything = importlib.import_module(f"{PORT}.models.depth_anything")
    convert = importlib.import_module(f"{PORT}.models.convert")
    cfg = spec["config"]
    model = depth_anything.build_vda_model(
        cfg["encoder"], dtype=getattr(torch, cfg["dtype"]), device=device)
    convert.load_vda_state_dict(model, make_vda_weights(cfg, seed, device))
    return model


def window(spec: dict, seed: int, seconds: float, trace: bool, device: str,
           t_start: float) -> Run:
    """Set-up (the model, the pool, ``warmup_windows`` windows of two
    streams) and the measured window of procedures."""
    import torch

    engine_mod = importlib.import_module(f"{PORT}.serving.engine")
    cfg, traffic = spec["config"], spec["traffic"]
    log(f"imports done at {time.perf_counter() - t_start:.2f} s")
    model = build(spec, seed, device)
    free(device)
    log(f"model loaded at {time.perf_counter() - t_start:.2f} s")
    hw = tuple(traffic["frame_hw"])
    frames = loadgen.make_frames(seed, int(traffic["pool"]), hw, device)
    log(f"frames made at {time.perf_counter() - t_start:.2f} s")
    engine = engine_mod.DepthServingEngine(
        model, input_size=int(traffic["input_size"]), device=device)
    prof: dict = {}
    try:
        # Two streams of 22 x warmup_windows frames run that many windows
        # each: the first window, carried ones, a padded last one.
        warm = []
        for s in range(2):
            for i in range(STEP * int(traffic["warmup_windows"])):
                warm.append(engine.submit(frames[(s + i) % len(frames)],
                                          stream=("warm-up", s)))
            engine.end_stream(("warm-up", s))
        for fut in warm:
            fut.result()
        sync(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(f"warmed up: set-up {setup_s:.2f} s")

        def on_start():
            prof["pre"] = engine.stats()
            prof["t_pre"] = time.perf_counter()
            prof["p"] = tracelib.start_profiler(device)
            prof["mark"] = torch.profiler.record_function(tracelib.SLICE_MARK)
            prof["mark"].__enter__()
            prof["batches"] = -engine.stats()["batches"]

        def on_stop():
            prof["batches"] += engine.stats()["batches"]
            prof["mark"].__exit__(None, None, None)
            if prof["p"] is not None:
                prof["p"].stop()

        slice_s = float(traffic["trace_slice_s"])
        slicer = (loadgen.Slicer((seconds - slice_s) / 2, slice_s, on_start,
                                 on_stop) if trace else loadgen.Slicer())
        rng = np.random.default_rng(int(seed) % (1 << 63))
        win, checked = drive(engine, frames, traffic, seconds, rng, slicer)
    finally:
        engine.close()
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    net_hw = lower_bound_hw(*hw, int(traffic["input_size"]),
                            cfg["patch_size"])
    run = Run(spec, device, setup_s, win, net_hw)
    run.extra.update(memory_peak_bytes=memory_peak, frames=frames,
                     checked=checked)
    done = run.completed_in_window()
    log(f"window closed; {done} frames in {run.window_s:.2f} s "
        f"({done / run.window_s:.2f} frames/s), {len(win.requests)} "
        f"attempted, {win.stats['batches']} windows")
    log_rate(win)
    if trace and prof.get("p") is not None:
        t = time.perf_counter()
        run.trace = VideoSlice(tracelib.read_events(prof["p"]))
        run.extra["slice_units"] = prof["batches"]
        stats, t_pre = prof["pre"], prof["t_pre"]
        run.extra["pre"] = {
            "seconds": t_pre - win.t0, "units": stats["batches"],
            "frames": sum(1 for r in win.requests
                          if r.ok and r.done <= t_pre),
            "runner_seconds": stats["runner_seconds"],
            "mean_batch_fill": stats["mean_batch_fill"]}
        log(f"trace read in {time.perf_counter() - t:.2f} s; "
            f"{prof['batches']} windows in the slice")
    elif trace:
        log("this torch cannot profile every thread: no trace")
    del engine, model
    free(device)
    return run


class _Procedure:
    def __init__(self, number: int, offset: int, length: int):
        self.number, self.offset, self.length = number, offset, length
        self.key = ("procedure", number)
        self.next = 0          # frames submitted
        self.resolved = 0
        self.ended = False


def drive(engine, frames: list, traffic: dict, seconds: float,
          rng: np.random.Generator, slicer: loadgen.Slicer):
    """The closed loop of procedures for ``seconds``; returns the window
    and the checked procedure's number."""
    n_flight = int(traffic["procedures_in_flight"])
    length = int(traffic["procedure_frames"])
    ahead = int(traffic["ahead"])
    n_check = int(traffic["check_frames"])
    checked = int(rng.integers(0, int(traffic["check_procedures"])))
    pool = len(frames)
    done_q: queue.SimpleQueue = queue.SimpleQueue()
    reqs: list[ClipRequest] = []
    procs: list[_Procedure] = []

    def on_done(fut, r: ClipRequest) -> None:
        r.done = time.perf_counter()
        exc = fut.exception()
        if exc is None:
            r.ok = True
            if r.proc == checked and r.pos < n_check:
                r.depth = fut.result()
        else:
            r.error = repr(exc)[:200]
        done_q.put(r)

    def start() -> _Procedure:
        p = _Procedure(len(procs), int(rng.integers(0, pool)), length)
        procs.append(p)
        return p

    def top_up(p: _Procedure) -> None:
        while (not p.ended and p.next < p.length
               and p.next - p.resolved < ahead):
            frame = (p.offset + p.next) % pool
            req = ClipRequest(len(reqs), frame, time.perf_counter(),
                              proc=p.number, pos=p.next)
            req.submitted = req.due
            reqs.append(req)
            fut = engine.submit(frames[frame], stream=p.key)
            fut.add_done_callback(lambda f, r=req: on_done(f, r))
            p.next += 1
        if p.next == p.length and not p.ended:
            engine.end_stream(p.key)
            p.ended = True

    engine.reset_stats()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    active = [start() for _ in range(n_flight)]
    for p in active:
        top_up(p)
    while True:
        now = time.perf_counter()
        slicer.poll(now - t0)
        if now >= t1:
            break
        try:
            r = done_q.get(timeout=min(0.05, t1 - now))
        except queue.Empty:
            continue
        procs[r.proc].resolved += 1
        while True:          # take every resolution waiting
            try:
                procs[done_q.get_nowait().proc].resolved += 1
            except queue.Empty:
                break
        if time.perf_counter() >= t1:
            break
        for i, p in enumerate(active):
            if p.resolved == p.length:
                active[i] = p = start()
            top_up(p)
    for p in active:
        if not p.ended:
            engine.end_stream(p.key)
            p.ended = True
    stats = engine.stats()
    slicer.finish()
    win = loadgen.Window(t0, t1, reqs, stats)
    loadgen.drain(reqs, float(traffic["grace_s"]))
    return win, checked


def check(run: Run, seed: int) -> tuple[bool, dict]:
    """Every request came back (``missing_frames``); the checked
    procedure's first ``check_frames`` maps all resolved in the window
    (``checked_frames``) and lie within the limit of the reference's
    (``map_rel_err``)."""
    limits = run.spec["limits"]
    w = run.window
    missing = sum(1 for r in w.requests if not r.ok)
    maes, spreads, n = compare(run, seed)
    rel = relative_error(maes, spreads)
    checks = {
        "missing_frames": {"value": missing,
                           "limit": limits["missing_frames"]},
        "checked_frames": {"value": n,
                           "limit": limits["checked_frames_min"]},
        "map_rel_err": {"value": rel, "limit": limits["map_rel_err"]},
    }
    ok = (missing <= limits["missing_frames"]
          and n >= limits["checked_frames_min"]
          and rel <= limits["map_rel_err"])
    return ok, checks


def checked_frames(run: Run) -> tuple[list, list[int]]:
    """The checked procedure's requests of its first ``check_frames``
    frames, in order, that resolved inside the window with a map; and
    the pool indices of that procedure's frames the reference needs."""
    w, traffic = run.window, run.traffic
    n_check = int(traffic["check_frames"])
    checked = run.extra["checked"]
    got = sorted((r for r in w.requests if r.proc == checked
                  and r.pos < n_check and r.ok and r.done <= w.t1
                  and r.depth is not None), key=lambda r: r.pos)
    first = next((r for r in w.requests if r.proc == checked), None)
    length = int(traffic["procedure_frames"])
    # Window k leaves frames below 22k + 24 final; it reads to 22k + 31.
    k = max(0, -(-(n_check - (WINDOW - 8)) // STEP))
    need = min(length, STEP * k + WINDOW)
    pool = len(run.extra["frames"])
    start = 0 if first is None else first.frame
    return got, [(start + i) % pool for i in range(need)]


def compare(run: Run, seed: int):
    """(maes, spreads, maps compared) of the checked procedure's maps
    against the reference's windowed run."""
    import torch

    got, pool_idx = checked_frames(run)
    n_check = int(run.traffic["check_frames"])
    if len(got) < n_check:
        return [float("inf")], [1.0], len(got)
    want = reference_maps(run, seed, pool_idx, n_check)
    maes, spreads = [], []
    for r in got:
        w = want[r.pos]
        g = torch.from_numpy(np.asarray(r.depth, np.float32)).to(w.device)
        maes.append(float((g - w).abs().mean()))
        spreads.append(float((w - w.mean()).abs().mean()))
    run.extra["map_mae"], run.extra["map_spread"] = maes, spreads
    return maes, spreads, len(got)


def reference_maps(run: Run, seed: int, pool_idx: list[int], limit: int,
                   fp8: bool = False) -> list:
    """The reference's (``fp8``: the control's) final maps of a
    procedure's first ``limit`` frames (``pool_idx`` its frames' pool
    indices, as many as the windows that finalise them read)."""
    import torch

    cfg, frames = run.config, run.extra["frames"]
    ref = VDA(cfg, make_vda_weights(cfg, seed, run.device), fp8=fp8)
    x = torch.from_numpy(np.stack([frames[i] for i in pool_idx])).to(
        run.device)
    maps = ref.infer_video(x, int(run.traffic["input_size"]), limit=limit)
    del ref, x
    free(run.device)
    return maps
