#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``csrc/``, holds each one
against its plain PyTorch version on the card, serves vitl DAv2 depth
(seeded random weights, 518 px, batch 8) through ``DepthServingEngine``,
checks that the served batches went through the kernels, holds one batch
against the same model on the plain attention, and prints timings and a
``torch.profiler`` breakdown of one batch's device time. The last line is ``{"ok": true, "device": {...}}``; any failed
phase raises and exits non-zero. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

PKG = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
       "and_pose_estimation_tpu_torch")
FRAME_HW = (475, 475)   # SimCol frame size: 518 px network input, N = 1370
BATCH = 8
N_FRAMES = 3 * BATCH
BLOCKS = 24             # vitl depth: one K1 launch per block per batch


def _cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    cbuild = importlib.import_module(f"{PKG}.utils.cbuild")

    t0 = time.perf_counter()
    seconds = cbuild.build(["flash_attn_fwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")
    for line in cbuild.build_log("flash_attn_fwd").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def _attention_case(b: int, n: int, h: int, d: int, seed: int):
    """Views of one packed (B, N, 3, H, D) qkv projection, as the encoder
    hands them to the kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    return qkv.unbind(2)


def phase_k1() -> dict:
    """K1 against its plain version; times at the flagship shape."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    flash_attention = fa.flash_attention
    flash_attention_reference = fa.flash_attention_reference

    # bf16 output: the kernel rounds unnormalised P to bf16 before PV, the
    # plain version rounds normalised P; both round O to bf16. LSE is f32
    # in both, differing only in summation order.
    o_tol, lse_tol = 2e-2, 1e-3
    flagship = (8, 1370, 16, 64)
    errs = {}
    for shape, seed in ((flagship, 0), ((3, 130, 5, 32), 1)):
        q, k, v = _attention_case(*shape, seed)
        o, lse = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_reference(q, k, v)
        eo = (o.float() - ro.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"K1 {shape}: max|dO| {eo:.3e} (tol {o_tol}), "
              f"max|dLSE| {el:.3e} (tol {lse_tol})")
        if not (eo <= o_tol and el <= lse_tol):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape}")
        errs[shape] = max(eo, el)

    b, n, h, d = flagship
    q, k, v = _attention_case(*flagship, 0)
    ms = _cuda_ms(lambda: flash_attention(q, k, v), iters=50)
    plain_ms = _cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5,
                        warmup=1)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = _cuda_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=50)
    flops = 4 * b * h * n * n * d
    nbytes = 4 * b * n * h * d * 2 + b * h * n * 4
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(flop_ms, byte_ms)
    print(f"K1 {flagship}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    return {"name": "flash_attn_fwd", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attn_fwd.cu",
            "replaces": "enhanced_3d_reconstruction_in_colonoscopy_using_"
                        "monocular_depth_and_pose_estimation_tpu/ops/"
                        "flash_attention.py:336",
            "max_abs_err": errs[flagship], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms}


def _frames(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, size=(n, *FRAME_HW, 3), dtype=np.uint8))


def _check_maps(maps) -> None:
    import numpy as np

    for i, m in enumerate(maps):
        if m.shape != FRAME_HW or not np.isfinite(m).all() \
                or m.min() < 0.0 or m.max() > 20.0:
            raise AssertionError(f"served map {i}: shape {m.shape}, range "
                                 f"[{m.min()}, {m.max()}]")


def phase_serve(model, frames) -> int:
    """The main path: vitl depth served by DepthServingEngine. Returns K1's
    launches in this run."""
    flash = importlib.import_module(f"{PKG}.ops.flash_attention")
    engine_mod = importlib.import_module(f"{PKG}.serving.engine")

    engine = engine_mod.DepthServingEngine(model, input_size=518,
                                           batch_size=BATCH)
    flash.flash_attention.launches = 0
    t0 = time.perf_counter()
    futures = engine.submit_many(frames)
    maps = [f.result(timeout=600) for f in futures]
    engine.close()
    seconds = time.perf_counter() - t0
    launches = flash.flash_attention.launches
    stats = engine.stats()
    _check_maps(maps)
    print(f"serve: {len(maps)} frames of {FRAME_HW} in {stats['batches']} "
          f"batches, {seconds:.2f} s (first batch sets up the libraries); "
          f"K1 launches {launches}; maps finite, in [0, 20]")
    if stats["failed"] or stats["batches"] < 3 \
            or launches != BLOCKS * stats["batches"]:
        raise AssertionError(f"serve: stats {stats}, K1 launches {launches}"
                             f" (want {BLOCKS} per batch)")
    return launches


def phase_plain(model, frames) -> None:
    """One batch through the same model with the plain attention, and once
    more in f32 as the yardstick of what bf16 rounding costs."""
    import numpy as np
    import torch

    attn = importlib.import_module(f"{PKG}.ops.attention")
    da = importlib.import_module(f"{PKG}.models.depth_anything")

    runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)
    kernel = np.stack(runner(frames))
    attn.set_force_plain(True)
    try:
        plain = np.stack(runner(frames))
        model.pretrained.dtype = torch.float32
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            f32 = np.stack(runner(frames))
    finally:
        model.pretrained.dtype = torch.bfloat16
        attn.set_force_plain(False)
    d_kp, d_kf, d_pf = (np.abs(a - b) for a, b in
                        ((kernel, plain), (kernel, f32), (plain, f32)))
    for name, d in (("K1 vs plain, both bf16", d_kp),
                    ("K1 bf16 vs plain f32", d_kf),
                    ("plain bf16 vs plain f32", d_pf)):
        print(f"vitl batch, {name}: max|d depth| {d.max():.4f} m, "
              f"mean {d.mean():.5f} m")
    # The two bf16 paths differ only in where attention rounds, but 24
    # blocks of random weights amplify any rounding: the plain bf16 path's
    # own distance from f32 measures that. The kernel path may be no
    # further from f32 than 1.5x that (mean), and may differ from the
    # plain bf16 path by at most 2x its largest distance from f32.
    if not (d_kf.mean() <= 1.5 * d_pf.mean()
            and d_kp.max() <= 2.0 * d_pf.max()):
        raise AssertionError("model on K1 disagrees with the plain model")


def phase_throughput(model, frames, k1_ms: float, smi: str) -> None:
    import numpy as np
    import torch

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    engine_mod = importlib.import_module(f"{PKG}.serving.engine")

    batch = frames[:BATCH]
    runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)
    for _ in range(2):
        runner(batch)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        runner(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3

    x = torch.from_numpy(np.stack(batch)).cuda()
    dev_ms = _cuda_ms(lambda: da._run_batched_u8(
        model, x, runner.net_hw, FRAME_HW), iters=10, warmup=2)

    with engine_mod.DepthServingEngine(model, batch_size=BATCH) as engine:
        for f in engine.submit_many(frames):
            f.result(timeout=600)
        engine.reset_stats()
        stream = frames * 4
        t0 = time.perf_counter()
        for f in engine.submit_many(stream):
            f.result(timeout=600)
        serve_s = time.perf_counter() - t0
        stats = engine.stats()
    print(f"throughput, vitl 518 px, batch {BATCH}, {smi}:")
    print(f"  BatchedRunner (u8 upload, forward, f32 readback): "
          f"{ms:.2f} ms/batch, {BATCH / ms * 1e3:.2f} frames/s")
    print(f"  device forward (_run_batched_u8): {dev_ms:.2f} ms/batch, "
          f"{BATCH / dev_ms * 1e3:.2f} frames/s; K1 {BLOCKS} x "
          f"{k1_ms:.4f} ms = {100 * BLOCKS * k1_ms / dev_ms:.1f}% of it")
    print(f"  DepthServingEngine, {len(stream)} frames submitted at once: "
          f"{len(stream) / serve_s:.2f} frames/s, latency p50 "
          f"{stats['latency_p50_ms']:.1f} ms, p99 "
          f"{stats['latency_p99_ms']:.1f} ms")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")


def phase_profile(model, frames) -> None:
    """Where one vitl batch's device time goes: ``torch.profiler`` over a
    few forwards, device time summed by kernel name, and the share of the
    window in which the card ran no kernel."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    net_hw = da._lower_bound_hw(*FRAME_HW, 518)
    x = torch.from_numpy(np.stack(frames[:BATCH])).cuda()
    for _ in range(2):
        da._run_batched_u8(model, x, net_hw, FRAME_HW)
    torch.cuda.synchronize()
    iters = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            da._run_batched_u8(model, x, net_hw, FRAME_HW)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        print("device time by kernel: not measured (the profiler saw no "
              "device events)")
        return
    print(f"device time, vitl batch {BATCH} (torch.profiler, {iters} "
          f"forwards): {busy_us / iters / 1e3:.2f} ms/batch in kernels of "
          f"{wall_us / iters / 1e3:.2f} ms wall; idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:12]:
        print(f"  {100 * e.self_device_time_total / busy_us:5.1f}%  "
              f"{e.self_device_time_total / iters / 1e3:7.3f} ms  "
              f"x{e.count // iters:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    k1 = phase_k1()

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    model = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                 seed=0)
    frames = _frames(N_FRAMES, seed=0)
    k1["launches"] = phase_serve(model, frames)
    phase_plain(model, frames[:BATCH])
    phase_throughput(model, frames, k1["ms"], smi)
    phase_profile(model, frames)

    print(json.dumps({"kernels": [k1]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
