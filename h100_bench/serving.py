"""The serving cells' set-up, window and check, shared by every serving
generator (``generators/closed_loop.py``, ``generators/open_loop.py``):
the port's model behind ``DepthServingEngine``, driven by the
generator's ``drive``, and its maps held against the reference's."""

from __future__ import annotations

import importlib
import time

import numpy as np

from . import loadgen
from .harness import PORT, Outcome, Run, free, log, log_rate, sync
from .reference.dav2 import DAv2, lower_bound_hw
from .weights import make_weights


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, drive) -> Outcome:
    """A serving cell's run under ``drive`` (``serve_window``), checked
    (``check_serving``)."""
    run_, sampler = serve_window(spec, seed, seconds, trace, device,
                                 t_start, drive)
    t = time.perf_counter()
    correct, checks = check_serving(run_, sampler, seed)
    log(f"check took {time.perf_counter() - t:.2f} s")
    reqs = run_.window.requests
    return Outcome(run_, correct, checks, len(reqs),
                   sum(1 for r in reqs if not r.ok))


def serve_window(spec: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, drive) -> tuple[Run, object]:
    """Set-up and the measured window of a serving cell: the port's model
    with the seed's weights behind ``DepthServingEngine``, warmed on the
    cell's frame shape, then driven for ``seconds`` by ``drive(engine,
    frames, traffic, seconds, rng, n_check, slicer, grace_s)``, which
    returns the ``loadgen.Window`` and the ``loadgen.Sampler`` of the maps
    kept for the check."""
    import torch

    from . import trace as tracelib

    depth_anything = importlib.import_module(f"{PORT}.models.depth_anything")
    convert = importlib.import_module(f"{PORT}.models.convert")
    engine_mod = importlib.import_module(f"{PORT}.serving.engine")

    cfg, traffic = spec["config"], spec["traffic"]
    log(f"imports done at {time.perf_counter() - t_start:.2f} s")
    model = depth_anything.build_depth_model(
        cfg["encoder"], cfg["max_depth"], dtype=getattr(torch, cfg["dtype"]),
        device=device)
    convert.load_dav2_state_dict(model, make_weights(cfg, seed, device))
    free(device)
    log(f"model loaded at {time.perf_counter() - t_start:.2f} s")
    hw = tuple(traffic["frame_hw"])
    frames = loadgen.make_frames(seed, int(traffic["pool"]), hw, device)
    log(f"frames made at {time.perf_counter() - t_start:.2f} s")
    engine = engine_mod.DepthServingEngine(
        model, input_size=int(traffic["input_size"]),
        batch_size=int(traffic["batch_size"]),
        max_delay_s=float(traffic["max_delay_ms"]) / 1e3, device=device)
    try:
        batch = int(traffic["batch_size"])
        warm = [engine.submit(frames[i % len(frames)])
                for i in range(batch * int(traffic["warmup_batches"]))]
        for fut in warm:
            fut.result()
        sync(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(f"warmed up: set-up {setup_s:.2f} s")

        prof: dict = {}

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
        window, sampler = drive(engine, frames, traffic, seconds, rng,
                                int(traffic["check_frames"]), slicer,
                                float(traffic["grace_s"]))
    finally:
        engine.close()
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    net_hw = lower_bound_hw(*hw, int(traffic["input_size"]),
                            cfg["patch_size"])
    run = Run(spec, device, setup_s, window, net_hw)
    run.extra.update(memory_peak_bytes=memory_peak, frames=frames)
    log(f"window closed; {run.completed_in_window()} frames in "
        f"{run.window_s:.2f} s ({run.completed_in_window() / run.window_s:.2f}"
        f" frames/s), {len(window.requests)} attempted")
    log_rate(window)
    if window.lateness_s:
        late = np.asarray(window.lateness_s) * 1e3
        log(f"generator lateness: p50 {np.percentile(late, 50):.3f} ms, "
            f"p99 {np.percentile(late, 99):.3f} ms, max {late.max():.3f} ms")
    if trace and prof.get("p") is not None:
        t = time.perf_counter()
        run.trace = tracelib.Slice(tracelib.read_events(prof["p"]))
        run.extra["slice_units"] = prof["batches"]
        stats, t_pre = prof["pre"], prof["t_pre"]
        run.extra["pre"] = {
            "seconds": t_pre - window.t0, "units": stats["batches"],
            "frames": sum(1 for r in window.requests
                          if r.ok and r.done <= t_pre),
            "runner_seconds": stats["runner_seconds"],
            "mean_batch_fill": stats["mean_batch_fill"]}
        log(f"trace read in {time.perf_counter() - t:.2f} s; "
            f"{prof['batches']} batches in the slice")
    elif trace:
        log("this torch cannot profile every thread: no trace")
    del engine, model
    free(device)
    return run, sampler


def check_serving(run: Run, sampler, seed: int) -> tuple[bool, dict]:
    """The check of a serving cell: every request due in the window came
    back, and the sampled maps lie within the limit of the reference's.

    The number compared is the sampled maps' mean absolute error against
    the float32 reference over their mean absolute deviation about each
    map's own mean (``map_rel_err``): with random weights, how far a
    map's depth moves under rounding scales with how much the map varies
    at all, so the ratio is steady from seed to seed where the error in
    metres is not."""
    import torch

    limits = run.spec["limits"]
    w = run.window
    missing = sum(1 for r in w.requests if not r.ok)
    kept = sorted((r for r in sampler.kept if r.depth is not None),
                  key=lambda r: r.index)
    cfg = run.config
    ref = DAv2(cfg, make_weights(cfg, seed, run.device))
    block = int(run.traffic["batch_size"])
    frames = run.extra["frames"]
    maes, spreads = [], []
    for i in range(0, len(kept), block):
        part = kept[i:i + block]
        x = torch.from_numpy(np.stack([frames[r.frame] for r in part])
                             ).to(run.device)
        want = ref.depth_of_frames(x, int(run.traffic["input_size"]))
        got = torch.from_numpy(np.stack([np.asarray(r.depth, np.float32)
                                         for r in part])).to(run.device)
        maes += (got - want).abs().mean(dim=(1, 2)).tolist()
        spreads += (want - want.mean(dim=(1, 2), keepdim=True)
                    ).abs().mean(dim=(1, 2)).tolist()
    run.extra["map_mae"] = maes
    run.extra["map_spread"] = spreads
    rel = relative_error(maes, spreads)
    del ref
    free(run.device)
    checks = {
        "missing_frames": {"value": missing,
                           "limit": limits["missing_frames"]},
        "checked_frames": {"value": len(kept),
                           "limit": limits["checked_frames_min"]},
        "map_rel_err": {"value": rel, "limit": limits["map_rel_err"]},
    }
    ok = (missing <= limits["missing_frames"]
          and len(kept) >= limits["checked_frames_min"]
          and rel <= limits["map_rel_err"])
    return ok, checks


def relative_error(maes: list[float], spreads: list[float]) -> float:
    """Summed mean absolute errors over summed mean absolute deviations;
    infinite with nothing compared."""
    total = sum(spreads)
    return sum(maes) / total if total > 0 else float("inf")
