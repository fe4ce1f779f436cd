"""The training cells' set-up, window and check, shared by every
training generator (``generators/train_steps.py``): the port's
``DepthTask`` stepped on the seed's batches, its first steps followed by
the float32 reference (``reference/train.py``) and held to its limits."""

from __future__ import annotations

import importlib
import time

import numpy as np

from . import loadgen
from .harness import PORT, Outcome, Run, free, log, sync
from .weights import make_weights

# An optimizer group's hyperparameters that the check reads as the
# optimizer held them after each checked step.
HYPERS = ("lr", "weight_decay", "betas", "eps")


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Outcome:
    """A training cell's run (``window``), checked (``check``)."""
    run_ = window(spec, seed, seconds, trace, device, t_start)
    correct, checks = check(run_, seed)
    return Outcome(run_, correct, checks, len(run_.extra["steps"]),
                   checks["failed_steps"]["value"])


def hyperparameters(groups: list[dict]) -> list[dict]:
    """``HYPERS`` of each optimizer group, as plain floats."""
    return [{k: ([float(x) for x in g[k]] if k == "betas" else float(g[k]))
             for k in HYPERS} for g in groups]


def training_data(spec: dict, seed: int, device: str
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The loader's batches of the set-up steps, from the seed: uint8
    images (steps, rows, H, W, 3) and uint16 depths (steps, rows, H, W);
    the window's later steps take them again, with fresh draws."""
    tr = spec["traffic"]
    rows = int(tr["accumulate"]) * int(tr["microbatch"])
    n, hw = int(tr["check_steps"]), tuple(tr["frame_hw"])
    images = np.stack(loadgen.make_frames(seed, rows * n, hw, device))
    depths = np.stack(loadgen.make_depths(seed, rows * n, hw, device,
                                          int(tr["depth_low"])))
    return images.reshape(n, rows, *hw, 3), depths.reshape(n, rows, *hw)


def window(spec: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float) -> Run:
    """Set-up and the measured window of a training cell: the port's
    ``DepthTask`` with the seed's weights, driven through
    ``DevicePreprocessor`` and ``train_step`` on the loader's uint8 images
    and uint16 depths with the seed's augmentation draws. Set-up runs the
    first ``check_steps`` steps, which the reference follows, on rows that
    all differ, from step ``start_step`` of the OneCycle schedule (the
    moments start empty, as a run resumed from weights alone); the
    window then runs whole steps until ``seconds`` have passed, the last
    ending in a sync."""
    import torch

    from . import trace as tracelib

    depth_task = importlib.import_module(f"{PORT}.train.depth_task")
    dtypes = importlib.import_module(f"{PORT}.core.dtypes")
    preprocess = importlib.import_module(f"{PORT}.data.preprocess")
    augment = importlib.import_module(f"{PORT}.ops.augment")
    cfg, tr = spec["config"], spec["traffic"]
    log(f"imports done at {time.perf_counter() - t_start:.2f} s")
    accum, mb = int(tr["accumulate"]), int(tr["microbatch"])
    rows, size = accum * mb, int(tr["input_size"])
    task = depth_task.DepthTask(
        encoder=cfg["encoder"], min_depth=tr["min_depth"],
        max_depth=cfg["max_depth"], encoder_lr=tr["encoder_lr"],
        decoder_lr=tr["decoder_lr"], pct_start=tr["pct_start"],
        div_factor=tr["div_factor"], total_steps=int(tr["total_steps"]),
        grad_accum=accum, clip_norm=tr["clip_norm"],
        grad_checkpoint=bool(tr["grad_checkpoint"]),
        policy=dtypes.DtypePolicy(compute_dtype=getattr(torch, cfg["dtype"])),
        device=device)
    state = task.init_state(0, pretrained_params=make_weights(cfg, seed,
                                                              device))
    state.step = int(tr["start_step"])
    free(device)
    log(f"model loaded at {time.perf_counter() - t_start:.2f} s")
    n_slots = int(tr["check_steps"])
    images, depths = training_data(spec, seed, device)
    pre = preprocess.DevicePreprocessor(size=size, device=device)
    log(f"data made at {time.perf_counter() - t_start:.2f} s")

    def step(k: int) -> float:
        d = loadgen.draw_augment(seed, k, rows, (size, size), tr)
        params = augment.AugmentParams(
            torch.from_numpy(d["flip"]), torch.from_numpy(d["factors"]),
            torch.from_numpy(d["order"]),
            torch.from_numpy(d["translate"].astype(np.float32)),
            torch.from_numpy(d["scale"]))
        b = pre({"image": images[k % n_slots], "depth": depths[k % n_slots]},
                train=True, aug_params=params)
        batch = {key: b[key].reshape(accum, mb, *b[key].shape[1:])
                 for key in ("image", "depth")}
        _, metrics = task.train_step(state, batch)
        return float(metrics["loss"])

    opt = state.optimizer.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    losses, grads, hypers = [], {}, []
    for k in range(n_slots):
        losses.append(step(k))
        hypers.append(hyperparameters(opt.param_groups))
        if k == 0:
            # The clipped gradient as AdamW got it: exp_avg = (1 - b1) g,
            # kept on the host for the reference to compare.
            b1 = opt.param_groups[0]["betas"][0]
            grads = {names[id(p)]: (s["exp_avg"] / (1 - b1)).to("cpu")
                     for p, s in opt.state.items()}
        log(f"set-up step {k}: loss {losses[-1]:.6f} at "
            f"{time.perf_counter() - t_start:.2f} s")
    start = make_weights(cfg, seed, device)
    with torch.no_grad():
        change = {n: float((p - start[n]).norm())
                  for n, p in state.model.named_parameters()}
    del start
    free(device)
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")

    steps = []
    prof = {}
    t0 = time.perf_counter()
    k = n_slots
    while time.perf_counter() - t0 < seconds:
        traced = (trace and "p" not in prof
                  and time.perf_counter() - t0 >= seconds / 2)
        if traced:
            prof["pre"] = {"seconds": time.perf_counter() - t0,
                           "units": len(steps), "frames": len(steps) * rows}
            prof["p"] = tracelib.start_profiler(device)
            mark = torch.profiler.record_function(tracelib.SLICE_MARK)
            mark.__enter__()
        ts = time.perf_counter()
        loss = step(k)
        steps.append((ts, time.perf_counter(), loss))
        if traced:
            mark.__exit__(None, None, None)
            if prof["p"] is not None:
                prof["p"].stop()
        k += 1
    window = loadgen.Window(t0, steps[-1][1] if steps else t0)
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    run = Run(spec, device, setup_s, window, (size, size))
    run.extra.update(memory_peak_bytes=memory_peak, steps=steps,
                     rows=rows, images=images,
                     depths=depths,
                     program={"loss": losses, "grads": grads,
                              "grad_norms": {n: float(g.norm())
                                             for n, g in grads.items()},
                              "hypers": hypers, "change_norms": change})
    rate = len(steps) * rows / max(run.window_s, 1e-9)
    log(f"window closed; {len(steps)} steps of {rows} frames in "
        f"{run.window_s:.2f} s ({rate:.2f} frames/s)")
    if trace and prof.get("p") is not None:
        t = time.perf_counter()
        run.trace = tracelib.Slice(tracelib.read_events(prof["p"]))
        run.extra.update(slice_units=1, pre=prof["pre"])
        log(f"trace read in {time.perf_counter() - t:.2f} s")
    del task, state, opt, pre
    free(device)
    return run


def reference_readings(run: Run, seed: int, fp8: bool = False,
                       steps: int | None = None) -> dict:
    """The reference's losses of the first ``steps`` set-up steps (all of
    them by default), its clipped gradient of the first by leaf (on the
    host) with its norms, its groups' hyperparameters after each and,
    over all the set-up steps, its tensors' change."""
    import torch

    from .reference.train import Trainer, preprocess

    cfg, tr = run.config, run.traffic
    n = int(tr["check_steps"]) if steps is None else int(steps)
    start = make_weights(cfg, seed, run.device)
    trainer = Trainer(cfg, start, tr, fp8=fp8)
    size, mb = int(tr["input_size"]), int(tr["microbatch"])
    out = {"loss": [], "grads": {}, "grad_norms": {}, "hypers": []}
    for k in range(n):
        d = loadgen.draw_augment(seed, k, run.extra["rows"], (size, size), tr)
        x, gt = preprocess(
            torch.from_numpy(run.extra["images"][k]).to(run.device),
            torch.from_numpy(run.extra["depths"][k].astype(np.int32)
                             ).to(run.device), size, d)
        loss, norms = trainer.step([(x[i:i + mb], gt[i:i + mb])
                                    for i in range(0, x.shape[0], mb)])
        out["loss"].append(loss)
        out["hypers"].append(hyperparameters(trainer.opt.param_groups))
        if k == 0:
            out["grad_norms"] = norms
            out["grads"] = {name: p.grad.detach().to("cpu")
                            for name, p in trainer.params.items()}
        del x, gt
    if n == int(tr["check_steps"]):
        out["change_norms"] = trainer.change_norms(start)
    del trainer, start
    free(run.device)
    return out


def grad_distances(program: dict, reference: dict) -> dict[str, float]:
    """Each leaf's distance between the two sides' first gradients (host
    tensors by name); a leaf the program has none of (it never stepped)
    counts as a zero gradient."""
    import torch

    return {name: float(torch.linalg.vector_norm(
        g - program[name] if name in program else g))
        for name, g in reference.items()}


def hyper_gap(program: list[list[dict]], reference: list[list[dict]]
              ) -> float:
    """The largest relative gap of any group's ``HYPERS`` after any step
    both sides took; infinite where the groups differ in number."""
    gap = 0.0
    for p_step, r_step in zip(program, reference):
        if len(p_step) != len(r_step):
            return float("inf")
        for p, r in zip(p_step, r_step):
            for k in HYPERS:
                pv = np.atleast_1d(np.asarray(p[k], np.float64))
                rv = np.atleast_1d(np.asarray(r[k], np.float64))
                gap = max(gap, float(np.max(
                    np.abs(pv - rv) / np.maximum(np.abs(rv), 1e-300))))
    return gap


def training_numbers(program: dict, reference: dict) -> dict:
    """The numbers a training cell can compare, of what both sides read:
    the worst step's loss gap relative to the reference's loss; the first
    step's gradient norms by leaf, the worst leaf's gap and the median
    leaf's (``reference.train.leaf_gaps``); the first step's gradients'
    distance by leaf on the same scale, the worst leaf's and the median
    leaf's (``leaf_distances``), and over the whole gradient relative to
    its norm; the tensors' change over the set-up steps by leaf, the
    worst leaf's gap, over the leaves the reference's gradient keeps; and
    the groups' hyperparameters' largest relative gap (``hyper_gap``)."""
    from .reference.train import leaf_distances, leaf_gaps

    out = {"loss_rel_gap": max(abs(p - r) / abs(r) for p, r in
                               zip(program["loss"], reference["loss"]))}
    worst, median, n = leaf_gaps(program["grad_norms"],
                                 reference["grad_norms"])
    out.update(grad_leaf_gap=worst, grad_median_gap=median, grad_leaves=n)
    if "change_norms" in program and "change_norms" in reference:
        worst, median, n = leaf_gaps(program["change_norms"],
                                     reference["change_norms"],
                                     keep=reference["grad_norms"])
        out.update(change_leaf_gap=worst, change_median_gap=median,
                   change_leaves=n)
    if program.get("grads") and reference.get("grads"):
        ref = reference["grad_norms"]
        dist = grad_distances(program["grads"], reference["grads"])
        worst, median, _ = leaf_distances(dist, ref)
        total = float(np.sqrt(sum(v * v for v in ref.values())))
        out.update(grad_diff_gap=worst, grad_diff_median=median,
                   grad_diff_global=float(np.sqrt(sum(
                       v * v for v in dist.values()))) / max(total, 1e-30))
    out["hyper_gap"] = hyper_gap(program["hypers"], reference["hypers"])
    return out


def check(run: Run, seed: int, reference: dict | None = None
          ) -> tuple[bool, dict]:
    """The check of a training cell: every window step's loss finite, and
    each number of ``training_numbers`` that ``limits/<workload>.json``
    limits within its limit; the others are printed as readings.
    ``reference`` is the reference's readings of this seed, where they
    were taken already; else they are taken here."""
    limits = run.spec["limits"]
    t = time.perf_counter()
    ref = reference_readings(run, seed) if reference is None else reference
    nums = training_numbers(run.extra["program"], ref)
    readings = {k: v for k, v in nums.items() if k not in limits}
    log(f"reference took {time.perf_counter() - t:.2f} s; losses "
        f"{run.extra['program']['loss']} against {ref['loss']}; "
        f"readings, not compared: {readings}")
    bad = sum(1 for *_, loss in run.extra["steps"] if not np.isfinite(loss))
    checks = {"failed_steps": {"value": bad,
                               "limit": limits["failed_steps"]}}
    for k in limits:
        if k != "failed_steps":
            # A number the run could not read fails its limit.
            checks[k] = {"value": nums.get(k, float("inf")),
                         "limit": limits[k]}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    run.extra.update(numbers=nums, reference=ref)
    return ok, checks
