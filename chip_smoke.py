#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``csrc/`` and the host media
and image codecs from ``csrc/host/`` (one compiler per source, in
parallel), holds each kernel against its plain PyTorch version on the
card (K1, K2, K3; K4 and K5 also against K1, and their LSE through the
default backward; K6 at vitl's and vitg's decoder resizes, timed on the
device alone and with the host's enqueue; AUG, the training
augmentation's two kernels, at one fine-tuning step's 256 images of
518 px: within 1e-4, the affine's fill pixels exact, timed on the device
alone, with the host's table and copy, and through
``DevicePreprocessor``), and drives the port's paths at vitl width with
seeded random weights. Every forward that autograd does not record takes
K6 at the decoder's resizes of 128 channels or a multiple (vitl 5 a
batch, vitg 4; a training forward none); every training microbatch's
images take AUG's two launches, and no other path launches them:

- serving: vitl DAv2 depth at 518 px, batch 8, through
  ``DepthServingEngine``; checks that the served batches went through K1,
  holds one batch against the same model on the plain attention, and
  prints timings and a ``torch.profiler`` breakdown of one batch; phase
  "throughput" also serves a batch with the resizes on K6 and on the
  matmul resize (``E3D_PALLAS_RESIZE=0``), in turns;
- video: ``cli.video_depth.main`` on a 48-frame 475x475 MJPEG AVI, once
  per configuration of the JAX package's knobs (default: K1;
  ``E3D_PALLAS_RESIZE`` + ``E3D_FLASH_PAIR``: K4;
  ``E3D_FLASH_PIPE`` and ``E3D_FLASH_HLOOP``: K5; K6 in each), with the
  launches held
  to the batches the engine ran, the entry point's 48 depth maps against
  the plain f32 model, every output frame against the rendering of its
  depth map, and once more through ``python -m`` with the knobs in the
  environment;
- training: vitl depth fine-tuning at 518 px through ``fit_depth``
  (16-mixed, gradient checkpointing, microbatch 8, grad-accum 4, four
  optimizer steps, validation), with the attention backward on the
  port's default (``E3D_FLASH_BWD_FUSED`` unset: the one of K2 and K3
  measured faster) and once more, for one step, on the other; checks
  launch counts, finite losses, that every parameter moved and got a
  gradient, and the kernels' gradient against the plain attention's;
  prints frames/s trained and a profile of one optimizer step;
- the file-based entry points, at vitl 518 px on SimCol-shaped trees of
  475x475 frames written by the port's own writers: the image codecs
  round-trip bit for bit (8-bit RGB and 16-bit gray PNG, 16-bit TIFF);
  ``cli.infer.main`` on 32 frames at batch 8 (K1 24 per batch, every
  ``.npy`` map against the plain f32 model by the video rule, a second
  run skips all 32); ``cli.serve.main --once`` on the same frames and a
  truncated PNG (left unread, the rest served and held to the same rule,
  the p50/p95/p99 line printed); ``cli.train_depth.main`` (``model=large``,
  16-mixed, gradient checkpointing, batch 8, accum 2, two steps: K1 48
  and the default backward 24 per microbatch, K1 24 per validation
  batch; a finite train_loss, the snapshot and a checkpoint); and
  ``cli.test_depth.main`` on that checkpoint directory (K1 24 per batch;
  finite metrics; abs_rel and rmse within 2x the plain bf16 run's
  distance from the plain f32 run, plus 1e-3 relative);
- vitg, the giant encoder (40 fused-SwiGLU blocks, 24 heads): phase "K1"
  also times K1 at vitg's (8, 1370, 24, 64); ``cli.infer.main --encoder
  vitg`` on the 32-frame tree (K1 40 per batch, maps by the video rule)
  and a ``BatchedRunner`` batch of 8 (device ms, frames/s, peak memory);
  one vitg microbatch of 2 through ``DepthTask``'s loss under gradient
  checkpointing (K1 80, K2 40; every parameter, ``mlp.w12`` and ``mlp.w3``
  included, a finite non-zero gradient; the kernels' gradient against
  the plain bf16 and f32 backward);
- pose: ``cli.train_pose.main`` at the recipe's size (518 px, batch 64,
  '32-true' with TF32 off, cycled momentum) on a SimCol tree of four
  65-frame procedures (two train: two optimizer steps; one validates, one
  tests), the test JSON's ATE/RTE/ROTE finite, no attention kernel or K6
  launched, ms per step, pairs/s, peak memory and a profiled step's idle
  share; one more step in bf16-mixed; and one ``PoseTask.train_step`` on
  the card against the CPU from the same weights and batch;
- reconstruction (phase "recon"): (a) ``cli.pointcloud.main`` at the
  reference's size: a synthetic colon (a cylinder of radius 1 m seen from
  its axis) of 64 frames of 475x475 with exact 16-bit depth, fused,
  voxel-downsampled (0.01 m) and meshed at Poisson depth 9 (512^3) on
  the card; the points on the cylinder, the mesh a tube of radius ~1,
  the card's mesh against the CPU's of the same points, every stage's
  time (device stages on CUDA events), peak memory, no kernel launched;
  (b) ``cli.pointcloud_model.main --encoder vitl`` on the infer CLI
  phase's 32 frames (K1 24 a frame; the clouds by the video rule against
  the plain f32 model's maps); (c) ``eval_depth_offline``,
  ``calc_metrics`` and ``calc_stats`` on that tree, each on the card and
  on the CPU with equal results, and ``video_to_images`` on the video
  phase's AVI (frames byte-equal to its JPEGs);
- the speed dials (phase "dials"): kernels Q1 and Q2 (``csrc/quant.cu``)
  bit for bit against their plain versions at vitl's encoder sites and
  two decoder convs, ``torch._int_mm`` against the CPU's and in both
  operand layouts, the tap form of the int8 conv against the f64 plain
  conv, each pass timed beside the bf16 GEMM or cuDNN conv it replaces;
  then dynamic int8, static int8 (K = 2), token merging at 0.3 and both
  at vitl 518 px, batch 8, through ``BatchedRunner`` (launches per
  batch, device ms, maps against the plain f32 model by the rule of
  ``DIAL_BOUND``, the merged forward repeated bit for bit), the auto
  scope at batch 8 and 64, ``DepthServingEngine`` with calibration (and
  a held single batch resolved without ``close()``), and
  ``cli.infer.main`` once per dial on the infer phase's 32 frames. Every
  other phase holds Q1 and Q2 to 0 launches;
- the kernels as ``torch.library`` ops: phase "dispatch" times each op's
  host cost a call against the direct launch, and phases "throughput"
  and "serve CLI" serve with the launches called both ways, in turns;
- export (phase "export"): ``cli.export_model.main --check`` at vitl,
  475x475 frames, batch 8, 518 px (seconds, artifact bytes against
  vitl's parameter bytes, no weight in it), the replay of the serve CLI
  phase's 32 frames through ``exported_runner`` and through
  ``cli.serve.main --from-export --once`` against a live
  ``BatchedRunner`` (within 1e-3 of max|live|), K1 24 a replayed batch
  counted inside the ops, device ms and kernel ms against the live
  program, an ``--int8 --int8-calib 2`` artifact (its amax equal to a
  live calibration's; Q1 248, Q2 124 a batch), K6 5 a batch in the
  plain artifact and 0 in one exported under ``E3D_PALLAS_RESIZE=0``
  (replayed with the knob reset; each sidecar counts the K6 it holds),
  and
  fault 3.1's order: export, then the live program, in one process;
- the exported training step (phase "export_train"):
  ``cli.export_model.main --train`` at vitl, 518 px, microbatch 8,
  accum 3 (seconds, artifact bytes, no weight in it, K1 48 and K2 24
  nodes in its microbatch program), ``load_exported_train_step``, and one
  replayed step from the seeded state against the live
  ``DepthTask.train_step`` from the same state and batch (metrics within
  1e-4 relative, parameters within 2 lr and at most 1% more of them
  beyond 1e-6 lr than between two live steps, launches K1 48 and K2 24
  a microbatch and nothing else, peak memory at most 1.5x the eager
  step's), then ms a step of each;
- distillation (phase "distill"): ``cli.train_depth.main`` with a vits
  student and a vitl teacher from a checkpoint the phase saves (518 px,
  microbatch 8, accum 2, two steps): ``Train/train_distill`` logged and
  finite, the launches reckoned in advance, and ``distill_weight=0``
  giving the plain step's loss bit for bit;
- NaN checks (phase "nan"): ``nan_checks`` names block 3's op for a NaN
  weight in a vitl forward and raises on a NaN made in the backward, both
  run through without it, and a vitl step is timed with and without it;
- the parallel modes (phase "parallel"): the train_depth CLI phase's run
  (vitl 518 px, global microbatch 8, accum 2, two steps) with each rank
  a process started as torchrun would (``--rank-worker``): DP and FSDP at
  world 1 on NCCL, then DP, TP and TP+SP with two ranks sharing the card
  over gloo (NCCL refuses two ranks on one device): each run's losses
  within 1e-3 of the plain run's and its update within 0.5 of the plain
  run's in relative norm, every rank's launches the plain run's, every
  parameter moved and finite, TP's peak memory per rank below the world-1
  run's, ms a step; FSDP, GPipe and interleaved with two ranks must stop
  at DepthTask's refusal (gloo has no all-gather, reduce-scatter or
  send/recv of CUDA tensors) on every rank;
- preemption (phase "preempt"): a train_depth process at vitl gets
  SIGTERM once it logs its first step, exits 0 with ``latest/`` and
  ``preempted`` 1, and ``trainer.resume=true`` reaches ``max_steps``.
- Video Depth Anything (phase "vda"): ``e3d::temporal_attn`` timed on
  the device alone at VDA-L's four motion-module shapes; one 32-frame
  window at 518 x 644 (C3VD's 1080 x 1350 frames) through ``ClipRunner``
  against the same model in f32 with the plain attention and TF32 off
  (the benchmark's ``map_rel_err`` within 0.14; K1 24, K6 5 and TA 8 a
  window); the engine's clip mode on two interleaved 60-frame streams
  (six windows, every map finite and non-negative); and
  ``cli.video_depth.main --model vda`` on a 40-frame AVI (two windows).
  Every other path's counts hold TA, the temporal attention op, to 0.

After the build it prints the compiler's register and spill report (and
any C75xx note, such as a serialized ``wgmma`` chain, by kernel) and,
where the toolkit has ``cuobjdump``, how many ``wgmma`` (HGMMA),
``mma.sync`` (HMMA), TMA and bulk-copy instructions and scalar atomics
each attention kernel holds; the warp-specialised kernels (K1 to K5)
must keep their ``wgmma`` and TMA, and the forwards (K1, K4, K5) hold no
``mma.sync``.

The line before the last two is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero. Without a CUDA device it exits 1 and prints no result.
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
LIBRARIES = ["flash_attn_fwd", "flash_attn_bwd", "lerp_resize", "quant",
             "augment", "host/jpegcodec", "host/container", "host/pngdec",
             "host/tiffdec", "host/meshing"]
JAX_PKG = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
           "depth_and_pose_estimation_tpu")
JAX_FLASH = f"{JAX_PKG}/ops/flash_attention.py"
FLAGSHIP = (8, 1370, 16, 64)  # vitl at 518 px: B, N, H, D
VITG_SHAPE = (8, 1370, 24, 64)  # vitg at 518 px
VITG_BLOCKS = 40        # vitg depth: one K1 launch per block per batch
# K6 launches a forward that autograd does not record: the decoder's
# resizes at 128 channels or a multiple (vitl's five, vitg's four).
K6_VITL = 5
K6_VITG = 4
# The decoder's align-corners resizes at vitl, batch 8, 518 px (NCHW):
# the four fusion upsamples at 256 channels, then the head's at 128.
DPT_RESIZES = [((8, 256, 19, 19), (37, 37)), ((8, 256, 37, 37), (74, 74)),
               ((8, 256, 74, 74), (148, 148)),
               ((8, 256, 148, 148), (296, 296)),
               ((8, 128, 296, 296), (518, 518))]
# vitg's: the fusion upsamples at 384 channels, the head's at 192.
K6_RESIZES = {"vitl": DPT_RESIZES,
              "vitg": [((8, 384, h, h), (h2, h2)) for (_, _, h, _), (h2, _)
                       in DPT_RESIZES[:4]] + [((8, 192, 296, 296),
                                               (518, 518))]}
VIDEO_FRAMES = 6 * BATCH
# Training: 14 microbatches of 8 frames, grad-accum 4 (the trainer's
# default), so 4 optimizer steps, the last a trailing group of 2.
TRAIN_MICROBATCHES = 14
VAL_BATCHES = 2
ACCUM = 4
# The backward kernels round P and dS to bf16 before the products that
# consume them; the plain backward computes in f32 from the same bf16
# inputs and rounds only its outputs: max error over max |gradient|.
BWD_TOL = 2e-2


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


def _device_ms(fn, iters: int, warmup: int = 3) -> float:
    """The card's time a call of ``fn``, without the host's: as
    ``_cuda_ms``, but a ``torch.cuda._sleep`` that outlasts the host's
    enqueue of the ``iters`` calls goes before the start event, so the
    card finds them all queued and runs them back to back. Fails if the
    sleep ended before the host had enqueued them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (2e3 * host_s + 2.0)))
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if enqueue_ms >= ev[0].elapsed_time(ev[1]):
        raise AssertionError(f"_device_ms: the host took {enqueue_ms:.3f} "
                             "ms to enqueue, longer than the card slept")
    return ev[1].elapsed_time(ev[2]) / iters


def _sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep``'s cycles a millisecond on this card."""
    import torch

    if not hasattr(_sleep_cycles_per_ms, "rate"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _sleep_cycles_per_ms.rate = 10_000_000 / start.elapsed_time(end)
    return _sleep_cycles_per_ms.rate


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
    import re

    cbuild = importlib.import_module(f"{PKG}.utils.cbuild")

    t0 = time.perf_counter()
    seconds = cbuild.build(LIBRARIES)
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())})")
    notes: dict[str, list[str]] = {}
    for name in LIBRARIES:
        kernel = None
        for line in cbuild.build_log(name).splitlines():
            flash = re.search(
                r"(?<=\d)(flash_attn_\w+?_kernel)ILi(\d+)E(?:Lb(\d)E)?", line)
            if flash:
                kernel = (f"{flash.group(1)}<"
                          + ", ".join(a for a in flash.groups()[1:] if a)
                          + ">")
            note = re.search(r"\((C75\d\d)\)", line)
            if note and name.startswith("flash_attn"):
                notes.setdefault(kernel or name, []).append(note.group(1))
            lerp = re.search(
                r"(?<=\d)(lerp_resize\w*?_kernel)I(13__nv_bfloat16|f)"
                r"(?:Li(\d+)E)?(?:Lb(\d)E)?E",
                line)
            if "Compiling entry" in line and flash:
                args = ", ".join(a for a in flash.groups()[1:] if a)
                print(f"  ptxas {name}: {flash.group(1)}<{args}>")
            elif "Compiling entry" in line and lerp:
                args = "bf16" if lerp.group(2).endswith("bfloat16") else "f32"
                args += "".join(f", {a}" for a in lerp.groups()[2:] if a)
                print(f"  ptxas {name}: {lerp.group(1)}<{args}>")
            elif "registers" in line or "spill" in line \
                    or "warning" in line.lower() or "(C75" in line:
                # (C75xx): ptxas notes on wgmma and setmaxnreg, such as a
                # serialized wgmma chain or an ignored register count.
                print(f"  ptxas:   {line.strip()}")
    # The verdicts on the overlaps among the rest: any note on K1
    # (flash_attn_fwd_kernel<*>: softmax under the products) or on
    # flash_attn_fwd_heads_kernel<*, 1> (K5's cross-head overlap) means
    # ptxas serialized it.
    print("  ptxas C75xx notes by attention kernel: "
          + (", ".join(f"{k} {sorted(set(v))}" for k, v in notes.items())
             or "none"))
    k1 = {k: sorted(set(v)) for k, v in notes.items()
          if k.startswith("flash_attn_fwd_kernel<")}
    print(f"  ptxas C75xx notes on K1 (flash_attn_fwd_kernel<32>, <64>): "
          f"{k1 or 'none'}")


# SASS opcodes that show how an attention kernel moves data and
# multiplies: wgmma, mma.sync, TMA tensor loads and stores, bulk copies,
# bulk reductions; and scalar atomics (RED, REDG, ATOM, ATOMG, ATOMS,
# counted as "atomics").
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "UBLKCP", "UBLKRED",
            "atomics")


def phase_sass() -> None:
    """Per attention kernel, its count of each of ``SASS_OPS`` from
    ``cuobjdump -sass`` of the two built libraries. The backward's dK/dV
    and dQ kernels and the forward's K1, K4 and K5 (both schedules; D 32
    and 64) must issue wgmma and TMA loads, and the forwards no mma.sync;
    K2's dQ must leave by bulk reduction and no kernel by scalar
    atomics."""
    import os
    import re
    import shutil

    cbuild = importlib.import_module(f"{PKG}.utils.cbuild")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass: cuobjdump not available")
        return
    sass = "".join(
        subprocess.run([tool, "-sass", str(cbuild.library_path(lib))],
                       capture_output=True, text=True, check=True,
                       timeout=300).stdout
        for lib in ("flash_attn_fwd", "flash_attn_bwd"))
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        head = re.search(r"Function : \S*?(?<=\d)(flash_attn_\w+?_kernel)"
                         r"ILi(\d+)E(?:Lb(\d)E)?", line)
        if head:
            args = ", ".join(a for a in head.groups()[1:] if a)
            fn = f"{head.group(1)}<{args}>"
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                       line)
        if fn and op:
            name = op.group(1)
            if name.startswith(("RED", "ATOM")):
                name = "atomics"
            if name in SASS_OPS:
                counts[fn][name] += 1
    for fn, c in counts.items():
        print(f"  sass {fn}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    bwd = [fn for fn in counts if "_dkv_" in fn or "_dq_" in fn]
    fwd = [fn for fn in counts if fn.startswith("flash_attn_fwd")]
    bad = [fn for fn in bwd + fwd
           if not counts[fn]["HGMMA"] or not counts[fn]["UTMALDG"]]
    bad += [fn for fn in fwd if counts[fn]["HMMA"]]
    bad += [fn for fn, c in counts.items() if c["atomics"]]
    bad += [fn for fn in bwd if "_dkv_" in fn and fn.endswith(", 1>")
            and not counts[fn]["UBLKRED"]]
    # dK/dV <32|64, 0|1>, dQ <32|64>; K1 <32|64>, K4 <32|64>,
    # K5 <32|64, 0|1>.
    if len(bwd) != 6 or len(fwd) != 8 or bad:
        raise AssertionError(f"sass: kernels {sorted(counts)}; without "
                             f"wgmma or TMA, with mma.sync (K1, K4, K5), "
                             f"without the bulk reduction, or with scalar "
                             f"atomics: {bad}")


def _attention_case(b: int, n: int, h: int, d: int, seed: int):
    """Views of one packed (B, N, 3, H, D) qkv projection, as the encoder
    hands them to the kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    return qkv.unbind(2)


def _last_launch() -> tuple[int, int]:
    """The grid of the forward library's last launch and the blocks of
    its kernel that one SM holds at once, as the library reports them."""
    import ctypes

    cbuild = importlib.import_module(f"{PKG}.utils.cbuild")
    fn = cbuild.load("flash_attn_fwd").e3d_flash_attn_fwd_last_launch
    blocks, per_sm = ctypes.c_longlong(), ctypes.c_int()
    err = fn(ctypes.byref(blocks), ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"e3d_flash_attn_fwd_last_launch: error {err}, "
                           f"{per_sm.value} blocks per SM")
    return blocks.value, per_sm.value


def _time_forward(label: str, call, shape) -> dict:
    """A forward's time at ``shape`` beside the plain version, SDPA and
    the bound; the rate, and the grid and waves of the timed launches as
    the library reports them."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    b, n, h, d = shape
    q, k, v = _attention_case(*shape, 0)
    ms = _cuda_ms(lambda: call(q, k, v), iters=50)
    blocks, per_sm = _last_launch()
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v),
                        iters=5, warmup=1)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = _cuda_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=50)
    flops = 4 * b * h * n * n * d
    nbytes = 4 * b * n * h * d * 2 + b * h * n * 4
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(flop_ms, byte_ms)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{label} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms ({ms / library_ms:.2f}x), bound "
          f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} "
          f"MB), {flops / ms / 1e9:.1f} TFLOP/s; {blocks} blocks, {per_sm} "
          f"per SM on {sms} SMs, {blocks / (per_sm * sms):.2f} waves")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms}


def phase_forward(label: str, name: str, line: int, call) -> dict:
    """A forward kernel (K1, K4, or K5 in one schedule) against the plain
    version at the flagship shape, at D 32 and at a small ragged N; K4 and
    K5 also against K1. Times at the flagship shape (``_time_forward``),
    and at D 32 beside SDPA."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    # bf16 output: the kernels round unnormalised P to bf16 before PV, the
    # plain version rounds normalised P; both round O to bf16. LSE is f32
    # in both, differing only in summation order. K4 and K5 against K1:
    # both round O to bf16 from f32 sums taken in another order (and over
    # other key tiles), so O within max|O_K1| / 64, two to four bf16 steps
    # of the largest output.
    o_tol, lse_tol = 2e-2, 1e-3
    errs = {}
    k1_diff = 0.0
    cases = [(FLAGSHIP, 0), ((2, 130, 5, 32), 1), ((2, 50, 4, 64), 2)]
    if label == "K1":
        cases.append((VITG_SHAPE, 3))
    for shape, seed in cases:
        q, k, v = _attention_case(*shape, seed)
        o, lse = call(q, k, v)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v)
        eo = (o.float() - ro.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        msg = (f"{label} {shape}: max|dO| {eo:.3e} (tol {o_tol}), max|dLSE| "
               f"{el:.3e} (tol {lse_tol})")
        d1o = d1l = k1_tol = 0.0
        if label != "K1":
            o1, lse1 = fa.flash_attention(q, k, v)  # K1: the knobs are off
            d1o = (o.float() - o1.float()).abs().max().item()
            d1l = (lse - lse1).abs().max().item()
            k1_tol = o1.float().abs().max().item() / 64
            k1_diff = max(k1_diff, d1o, d1l)
            msg += (f"; against K1: max|dO| {d1o:.3e} (tol {k1_tol:.3e}), "
                    f"max|dLSE| {d1l:.3e} (tol {lse_tol})")
        print(msg)
        if not (eo <= o_tol and el <= lse_tol and d1o <= k1_tol
                and d1l <= lse_tol):
            raise AssertionError(f"{label} disagrees with its plain version "
                                 f"or K1 at {shape}")
        errs[shape] = max(eo, el)

    t = _time_forward(label, call, FLAGSHIP)
    b, n, h, d = FLAGSHIP
    # The same work at D 32 (the smaller encoders' head dim): the kernel
    # beside SDPA, printed only.
    d32 = (b, n, h, 32)
    q32, k32, v32 = _attention_case(*d32, 0)
    ms32 = _cuda_ms(lambda: call(q32, k32, v32), iters=50)
    q32, k32, v32 = (x.transpose(1, 2).contiguous() for x in (q32, k32, v32))
    sdpa32 = _cuda_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32),
                      iters=50)
    print(f"{label} {d32}: kernel {ms32:.4f} ms, SDPA {sdpa32:.4f} ms")
    rec = {"name": name, "route": "cuda",
           "source": f"{PKG}/csrc/flash_attn_fwd.cu",
           "replaces": f"{JAX_FLASH}:{line}",
           "max_abs_err": errs[FLAGSHIP], **t}
    if label != "K1":
        rec["max_diff_k1"] = k1_diff
    else:  # K1 at vitg's shape, the giant encoder's 24 heads
        rec["vitg"] = {"shape": list(VITG_SHAPE),
                       "max_abs_err": errs[VITG_SHAPE],
                       **_time_forward(label, call, VITG_SHAPE)}
    return rec


def phase_variant_grads() -> None:
    """One forward and backward through FlashAttentionQKV with K4, K5 pipe
    and K5 hloop and the default backward, each against K1 and the same
    backward: each forward's LSE drives the backward."""
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    b, n, h, d = FLAGSHIP
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    do = torch.randn((b, n, h, d), generator=gen, device="cuda",
                     dtype=torch.bfloat16)

    def dqkv(flags: dict):
        with _Knobs(flags):
            x = qkv.clone().requires_grad_(True)
            fa.flash_attention_qkv(x).backward(do)
        return x.grad

    bwd = _bwd_name(fa._BWD_FUSED)
    want = dqkv({})
    for label, knob, counter in (
            ("K4", "_PAIR", fa.flash_attention_pair),
            ("K5 pipe", "_PIPE", fa.flash_attention_heads),
            ("K5 hloop", "_HLOOP", fa.flash_attention_heads)):
        before = (counter.launches, fa.flash_attention.launches)
        got = dqkv({knob: True})
        if (counter.launches, fa.flash_attention.launches) != \
                (before[0] + 1, before[1]):
            raise AssertionError(f"{label} + {bwd}: the forward did not run "
                                 f"on {label}")
        rel = {nm: ((g.float() - w.float()).abs().max()
                    / w.float().abs().max()).item()
               for nm, g, w in zip(("dq", "dk", "dv"), got.unbind(2),
                                   want.unbind(2))}
        print(f"{label} + {bwd} vs K1 + {bwd} {FLAGSHIP}: max|err| / "
              "max|ref| " + ", ".join(f"{k} {e:.3e}" for k, e in rel.items())
              + f" (tol {BWD_TOL})")
        if max(rel.values()) > BWD_TOL:
            raise AssertionError(f"{label}'s LSE gives another gradient "
                                 "than K1's")


def phase_k6() -> dict:
    """K6 against its plain version at the decoder's resizes (vitl and
    vitg, batch 8, bf16, channels-last memory as the decoder hands it), at
    most one bf16 ulp apart, with the count of elements that differ; per
    shape, K6's time beside F.interpolate's, the matmul resize's, the
    plain version's and the bound, each on the device alone
    (``_device_ms``) and with the host's enqueue in it (``_cuda_ms``).
    The record sums vitl's five: one batch's resizes."""
    import torch
    import torch.nn.functional as F

    rz = importlib.import_module(f"{PKG}.ops.resize")
    keys = ("ms", "host_ms", "plain_ms", "library_ms", "library_host_ms",
            "matmul_ms", "matmul_host_ms", "bound_ms", "fill_ms")
    tot = {model: dict.fromkeys(keys, 0.0) for model in K6_RESIZES}
    max_err = 0.0
    for model, resizes in K6_RESIZES.items():
        for shape, out_hw in resizes:
            gen = torch.Generator(device="cuda").manual_seed(shape[2])
            x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
            x = x.contiguous(memory_format=torch.channels_last)
            with torch.no_grad():
                y = rz.lerp_resize(x, out_hw)
                torch.cuda.synchronize()
                ref = rz.lerp_resize_reference(x, out_hw)
            diff = (y.float() - ref.float()).abs()
            ulp = ref.float().abs() * 2.0 ** -7  # one bf16 ulp, at most
            off = int((diff > 0).sum())
            diff_max = diff.max().item()
            if not bool((diff <= ulp + 1e-30).all()) or not y.is_contiguous(
                    memory_format=torch.channels_last):
                raise AssertionError(f"K6 {shape} -> {out_hw}: more than "
                                     "one bf16 ulp from its plain version")
            del diff, ulp, ref
            max_err = max(max_err, diff_max)
            calls = {
                "": lambda: rz.lerp_resize(x, out_hw),
                "library_": lambda: F.interpolate(
                    x, size=out_hw, mode="bilinear", align_corners=True),
                "matmul_": lambda: rz._apply_separable(
                    x, rz._align_corners_matrix, out_hw, "bilinear", False)}
            t = {"bound_ms": (x.numel() + y.numel()) * 2 / PEAK_BYTES * 1e3,
                 "plain_ms": _device_ms(lambda: rz.lerp_resize_reference(
                     x, out_hw), iters=5, warmup=1),
                 # What the card's writes alone take: a fill of y's bytes.
                 "fill_ms": _device_ms(lambda: y.fill_(1.0), iters=20)}
            for key, fn in calls.items():
                t[f"{key}ms"] = _device_ms(fn, iters=20)
                t[f"{key}host_ms"] = _cuda_ms(fn, iters=20)
            for key, val in t.items():
                tot[model][key] += val
            plan = rz._lerp_plan(*shape, *out_hw, x.element_size(),
                                 rz._sm_count(0))
            print(f"K6 {model} {shape[1]} ch {shape[2]}->{out_hw[0]} plan: "
                  f"{plan.tiles} tiles of {plan.band} rows x {plan.span} "
                  f"columns ({plan.src_cols} source columns a slot, ring "
                  f"{plan.ring}), grid {plan.grid} of {plan.threads} "
                  f"threads, {plan.smem} bytes of shared memory a block")
            print(f"K6 {model} {shape[1]} ch {shape[2]}->{out_hw[0]}: "
                  f"kernel {t['ms']:.4f} ms device, {t['host_ms']:.4f} ms "
                  f"with the host ({100 * t['bound_ms'] / t['ms']:.1f}% of "
                  f"the bound); F.interpolate {t['library_ms']:.4f} / "
                  f"{t['library_host_ms']:.4f} ms; matmul resize "
                  f"{t['matmul_ms']:.4f} / {t['matmul_host_ms']:.4f} ms; "
                  f"plain {t['plain_ms']:.4f} ms; bound "
                  f"{t['bound_ms']:.4f} ms (bytes); a fill of the output "
                  f"{t['fill_ms']:.4f} ms; {off} of {y.numel()} "
                  f"elements differ from the plain version, max "
                  f"{diff_max:.3e}")
            del x, y
        s = tot[model]
        print(f"K6 {model} per batch ({len(resizes)} resizes): kernel "
              f"{s['ms']:.4f} ms device, {s['host_ms']:.4f} ms with the "
              f"host ({100 * s['bound_ms'] / s['ms']:.1f}% of the bound); "
              f"F.interpolate {s['library_ms']:.4f} / "
              f"{s['library_host_ms']:.4f} ms; matmul resize "
              f"{s['matmul_ms']:.4f} / {s['matmul_host_ms']:.4f} ms; bound "
              f"{s['bound_ms']:.4f} ms; fills of the outputs "
              f"{s['fill_ms']:.4f} ms")
    vitl = tot["vitl"]
    return {"name": "lerp_resize", "route": "cuda",
            "source": f"{PKG}/csrc/lerp_resize.cu",
            "replaces": f"{JAX_PKG}/ops/resize.py:354",
            "max_abs_err": max_err, "ms": vitl["ms"],
            "plain_ms": vitl["plain_ms"], "bound_ms": vitl["bound_ms"],
            "bound_by": "bytes", "library_ms": vitl["library_ms"],
            **{k: vitl[k] for k in ("host_ms", "library_host_ms",
                                     "matmul_ms", "matmul_host_ms",
                                     "fill_ms")},
            "vitg": tot["vitg"]}



# The batched training augmentation (``csrc/augment.cu``, AUG: kernel A's
# contrast partial sums, then kernel B's gather, jitter and
# normalisation; two launches a call) at one fine-tuning step's images:
# the benchmark's vitl-finetune step of 256 frames at 518 px. Against the
# plain per-image path it may differ by AUG_TOL on the normalised output
# (the contrast mean and the gray products summed in another order; the
# card tests say why), and the affine's fill pixels not at all.
AUG_SHAPE = (256, 518, 518)
AUG_TOL = 1e-4
AUG_LAUNCHES = 2


def phase_augment(smi: str) -> dict:
    """AUG against its plain version, ``apply_augment_reference``, on the
    same card inputs at ``AUG_SHAPE`` (f32, a little outside [0, 1] as
    after the bicubic resize; the recipe's draws from a seeded CPU
    generator): within ``AUG_TOL``, the fill pixels exact, bit for bit
    from call to call, ``AUG_LAUNCHES`` launches a call on its counter.
    Then the two launches' time on the device alone (the table already on
    the card) and each kernel's through ``torch.profiler``, the wrapper's
    with the host's table and copy, the plain path's, the bound (one read
    and one write of the images), and ``DevicePreprocessor``'s host time
    on the fine-tuning path (256 uint8 475x475 frames and their depths:
    upload, resize, augmentation)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    taug = importlib.import_module(f"{PKG}.ops.augment")
    cbuild = importlib.import_module(f"{PKG}.utils.cbuild")
    pre = importlib.import_module(f"{PKG}.data.preprocess")
    b, h, w = AUG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 1.1 - 0.05
    params = taug.draw_augment_params(torch.Generator().manual_seed(18), b,
                                      (h, w))
    before = taug.augment_kernel.launches
    got = taug.augment_kernel(x, params)
    again = taug.augment_kernel(x, params)
    torch.cuda.synchronize()
    launches = taug.augment_kernel.launches - before
    want = taug.apply_augment_reference(x, params)
    err = (got - want).abs().max().item()
    table = taug.augment_tables(params, b, h, w)
    n = b * taug._TABLE_HEADER
    rows = torch.from_numpy(table[n:n + b * h].reshape(b, h)).cuda()
    cols = torch.from_numpy(table[n + b * h:].reshape(b, w)).cuda()
    fill = (rows[:, :, None] < 0) | (cols[:, None, :] < 0)
    fill_exact = torch.equal(got[fill], want[fill])
    repeat = torch.equal(got, again)
    fill_share = fill.float().mean().item()
    print(f"AUG {b}x{h}x{w}: max |kernels - plain| {err:.3e} (tolerance "
          f"{AUG_TOL}); {100 * fill_share:.1f}% of the pixels filled by the "
          f"affine, equal to the plain path's: {fill_exact}; bit for bit "
          f"from call to call: {repeat}; {launches} launches in 2 calls")
    if not (err <= AUG_TOL and fill_exact and repeat
            and launches == 2 * AUG_LAUNCHES and got.is_contiguous()):
        raise AssertionError(f"AUG: error {err}, fills exact {fill_exact}, "
                             f"repeat {repeat}, launches {launches}")
    del got, again, want, fill, rows, cols

    # The two launches alone, on buffers the wrapper would make.
    table_d = torch.from_numpy(table).cuda()
    chunks = -(-h * w // taug._MEAN_CHUNK)
    partial = torch.empty((b, chunks), device="cuda")
    out = torch.empty_like(x)
    fn = taug._bind(cbuild.load("augment"))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = fn(x.data_ptr(), out.data_ptr(), table_d.data_ptr(),
                  partial.data_ptr(), b, h, w, chunks, stream)
        if code:
            raise AssertionError(f"AUG launch: CUDA error {code}")

    ms = _device_ms(launch, iters=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            launch()
        torch.cuda.synchronize()
    split = {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
             e.device_time_total / e.count / 1e3
             for e in prof.key_averages() if e.device_time_total > 0}
    host_ms = _cuda_ms(lambda: taug.augment_kernel(x, params), iters=10)
    plain_ms = _cuda_ms(lambda: taug.apply_augment_reference(x, params),
                        iters=2, warmup=1)
    bound_ms = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
    del out, partial

    rng = np.random.default_rng(18)
    batch = {"image": rng.integers(0, 256, (b, *FRAME_HW, 3), np.uint8),
             "depth": rng.integers(0, 65536, (b, *FRAME_HW), np.uint16)}
    prep = pre.DevicePreprocessor(size=h, device="cuda")
    prep_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep(batch, train=True, aug_params=params)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"AUG {b}x{h}x{w} ({smi}): kernels {ms:.4f} ms device "
          f"({100 * bound_ms / ms:.1f}% of the bound; by kernel "
          f"{ {k: round(v, 4) for k, v in split.items()} } ms), "
          f"{host_ms:.4f} ms with the host's table and copy; plain per-image "
          f"path {plain_ms:.2f} ms; bound {bound_ms:.4f} ms (bytes: one read "
          f"and one write of the images); DevicePreprocessor on the "
          f"fine-tuning path (256 uint8 475x475 frames): host ms "
          f"{[round(t, 2) for t in prep_ms]} (the first warms the resize)")
    return {"name": "augment", "route": "cuda",
            "source": f"{PKG}/csrc/augment.cu",
            "replaces": f"{JAX_PKG}/ops/augment.py:182",
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "by_kernel_ms": split,
            "preprocess_host_ms": prep_ms[1:]}

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


def phase_serve(model, frames) -> dict[str, int]:
    """The main path: vitl depth served by DepthServingEngine. Returns
    every kernel's launches in this run (K1 and K6: no dial is on)."""
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    engine_mod = importlib.import_module(f"{PKG}.serving.engine")

    engine = engine_mod.DepthServingEngine(model, input_size=518,
                                           batch_size=BATCH)
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    t0 = time.perf_counter()
    futures = engine.submit_many(frames)
    maps = [f.result(timeout=600) for f in futures]
    engine.close()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    stats = engine.stats()
    want = _want(K1=BLOCKS * stats["batches"], K6=K6_VITL * stats["batches"])
    _check_maps(maps)
    print(f"serve: {len(maps)} frames of {FRAME_HW} in {stats['batches']} "
          f"batches, {seconds:.2f} s (first batch sets up the libraries); "
          f"launches {counts}; maps finite, in [0, 20]")
    if stats["failed"] or stats["batches"] < 3 or counts != want:
        raise AssertionError(f"serve: stats {stats}, launches {counts}, "
                             f"want {want} ({BLOCKS} K1 and {K6_VITL} K6 per batch)")
    return counts


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
    """Served frames/s at batch 8: the BatchedRunner loop, the device
    forward (CUDA events) and the engine over a burst of 96 frames; the
    runner loop and the engine also with the launches called directly,
    past the ops' dispatcher (``_DirectLaunches``), in turns (direct, ops,
    ops, direct), with each run's host share (1 - the device forward's
    time over the wall)."""
    import numpy as np
    import torch

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    engine_mod = importlib.import_module(f"{PKG}.serving.engine")

    batch = frames[:BATCH]
    runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)
    for _ in range(2):
        runner(batch)
    x = torch.from_numpy(np.stack(batch)).cuda()
    dev_ms = _cuda_ms(lambda: da._run_batched_u8(
        model, x, runner.net_hw, FRAME_HW), iters=10, warmup=2)
    stream = frames * 4

    def measure():
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            runner(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        with engine_mod.DepthServingEngine(model,
                                           batch_size=BATCH) as engine:
            for f in engine.submit_many(frames):
                f.result(timeout=600)
            engine.reset_stats()
            t0 = time.perf_counter()
            for f in engine.submit_many(stream):
                f.result(timeout=600)
            serve_s = time.perf_counter() - t0
            stats = engine.stats()
        return ms, serve_s, stats

    runs = {}
    for label in ("direct", "ops", "ops ", "direct "):
        if label.startswith("direct"):
            with _DirectLaunches():
                runs[label] = measure()
        else:
            runs[label] = measure()
    ms, serve_s, stats = runs["ops"]
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
    for label, (ms, serve_s, stats) in runs.items():
        engine_dev = stats["batches"] * dev_ms / 1e3
        print(f"  launches {label.strip():6s}: BatchedRunner {ms:.2f} "
              f"ms/batch "
              f"(host share {max(0.0, 1 - dev_ms / ms):.3f}); engine "
              f"{len(stream) / serve_s:.2f} frames/s (host share "
              f"{max(0.0, 1 - engine_dev / serve_s):.3f}, in the runner "
              f"{stats['runner_seconds']:.2f} of {serve_s:.2f} s)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    _resize_ab(model, batch, runner, x, smi)


def _resize_ab(model, batch, runner, x, smi: str) -> None:
    """The served batch with the decoder's resizes on K6 (the default)
    and on the matmul resize (``E3D_PALLAS_RESIZE=0``, the module flag),
    in turns (matmul, K6, K6, matmul): device ms a batch (CUDA events),
    kernel ms a batch (torch.profiler), K6's launches a batch, and the
    maps' distance from the plain f32 model (plain attention, f32, K6 in
    f32), held to the rule of phase "plain": no further than 1.5x the
    plain bf16 model's (plain attention, the matmul resize)."""
    import numpy as np
    import torch

    attn = importlib.import_module(f"{PKG}.ops.attention")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    from torch.autograd import DeviceType

    attn.set_force_plain(True)
    try:
        with _Knobs({"_NO_PALLAS_RESIZE": True}):
            plain = np.stack(runner(batch))
        model.pretrained.dtype = torch.float32
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            f32 = np.stack(runner(batch))
    finally:
        model.pretrained.dtype = torch.bfloat16
        attn.set_force_plain(False)
    d_pf = np.abs(plain - f32).mean()

    def forward():
        return da._run_batched_u8(model, x, runner.net_hw, FRAME_HW)

    results = []
    for label in ("matmul", "K6", "K6 ", "matmul "):
        flags = {"_NO_PALLAS_RESIZE": True} if label.startswith("matmul") \
            else {}
        with _Knobs(flags):
            torch.cuda.synchronize()
            _video_counts(fa, rz, zero=True)
            maps = np.stack(runner(batch))
            torch.cuda.synchronize()
            k6 = _video_counts(fa, rz)["K6"]
            dev_ms = _cuda_ms(forward, iters=10, warmup=2)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    forward()
                torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 3e3
        d = np.abs(maps - f32)
        results.append((label.strip(), dev_ms, busy, k6, d.mean()))
        print(f"  resize A/B [{label.strip():6s}]: device {dev_ms:.2f} "
              f"ms/batch ({BATCH / dev_ms * 1e3:.2f} frames/s), kernels "
              f"{busy:.2f} ms/batch, K6 {k6} a batch; maps vs plain f32: "
              f"mean {d.mean():.5f} m, max {d.max():.4f} m (plain bf16 "
              f"with the matmul resize: mean {d_pf:.5f}); {smi}")
    for label, _, _, k6, dist in results:
        if k6 != (K6_VITL if label == "K6" else 0) or dist > 1.5 * d_pf:
            raise AssertionError(f"resize A/B [{label}]: K6 {k6}, distance "
                                 f"from f32 {dist} (rule {1.5 * d_pf})")


def _print_profile(prof, wall_us: float, plain_wall_us: float, iters: int,
                   what: str) -> list:
    """Device time by kernel name from a ``torch.profiler`` run over
    ``iters`` repetitions, and the share of the window in which the card
    ran no kernel: against the profiled wall time, and against the wall
    time of the same runs without the profiler (whose own host cost
    inflates the first). Returns the kernels' events, largest first."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print(f"device time by kernel, {what}: not measured (the profiler "
              "saw no device events)")
        return []
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"device time, {what} (torch.profiler, {iters} runs): "
          f"{busy_us / iters / 1e3:.2f} ms per run in kernels of "
          f"{wall_us / iters / 1e3:.2f} ms wall; idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}; unprofiled "
          f"{plain_wall_us / iters / 1e3:.2f} ms wall, idle share "
          f"{max(0.0, 1 - busy_us / plain_wall_us):.3f}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:12]:
        print(f"  {100 * e.self_device_time_total / busy_us:5.1f}%  "
              f"{e.self_device_time_total / iters / 1e3:7.3f} ms  "
              f"x{e.count // iters:<4d} {e.key[:90]}")
    return kernels


def phase_profile(model, frames) -> None:
    """Where one vitl batch's device time goes: ``torch.profiler`` over a
    few forwards."""
    import numpy as np
    import torch

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    net_hw = da._lower_bound_hw(*FRAME_HW, 518)
    x = torch.from_numpy(np.stack(frames[:BATCH])).cuda()
    da._run_batched_u8(model, x, net_hw, FRAME_HW)
    _profiled(lambda: da._run_batched_u8(model, x, net_hw, FRAME_HW), 3,
              f"vitl batch {BATCH} forward")


# ---------------------------------------------------------------- video

# Per configuration of the JAX package's knobs: the module flags to set,
# and the launches each batch the engine runs must make.
VIDEO_CONFIGS = {
    "default": ({}, {"K1": BLOCKS, "K4": 0, "K5": 0, "K6": K6_VITL}),
    "PALLAS_RESIZE + PAIR": ({"_PAIR": True, "_PALLAS_RESIZE": True},
                             {"K1": 0, "K4": BLOCKS, "K5": 0,
                              "K6": K6_VITL}),
    "PIPE": ({"_PIPE": True},
             {"K1": 0, "K4": 0, "K5": BLOCKS, "K6": K6_VITL}),
    "HLOOP": ({"_HLOOP": True},
              {"K1": 0, "K4": 0, "K5": BLOCKS, "K6": K6_VITL}),
}


def _video_counts(fa, rz, zero: bool = False) -> dict[str, int]:
    """Every kernel's launch count (zeroed first with ``zero``): the six
    attention and resize kernels, the int8 passes Q1 and Q2, the
    training augmentation's two kernels (AUG, counted per launch), and
    VDA's temporal attention op (TA, a call each)."""
    quant = importlib.import_module(f"{PKG}.ops.quant")
    taug = importlib.import_module(f"{PKG}.ops.augment")
    tatt = importlib.import_module(f"{PKG}.ops.temporal_attention")
    fns = {"K1": fa.flash_attention, "K2": fa.flash_attention_bwd_fused,
           "K3": fa.flash_attention_bwd_split, "K4": fa.flash_attention_pair,
           "K5": fa.flash_attention_heads, "K6": rz.lerp_resize,
           "Q1": quant.quantize_int8, "Q2": quant.dequantize_int32,
           "AUG": taug.augment_kernel, "TA": tatt.temporal_attention}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


class _Knobs:
    """Set the port's module flags of one configuration; restore them."""

    def __init__(self, flags: dict):
        rz = importlib.import_module(f"{PKG}.ops.resize")
        self.mods = {"_PALLAS_RESIZE": rz, "_NO_PALLAS_RESIZE": rz}
        fa = importlib.import_module(f"{PKG}.ops.flash_attention")
        self.mods.update({k: fa for k in ("_PAIR", "_PIPE", "_HLOOP")})
        self.flags = flags

    def __enter__(self):
        self.saved = {k: getattr(m, k) for k, m in self.mods.items()}
        for k, m in self.mods.items():
            setattr(m, k, self.flags.get(k, False))

    def __exit__(self, *exc):
        for k, m in self.mods.items():
            setattr(m, k, self.saved[k])


def _video_input(path: str, seed: int) -> list:
    """A 475x475 MJPEG AVI of seeded frames (coarse colour blocks and
    noise), written by the port's encoder at quality 90; returns the
    frames as the port's decoder reads them back (RGB)."""
    import numpy as np

    native = importlib.import_module(f"{PKG}.media.native")
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (VIDEO_FRAMES, 16, 16, 3)).astype(np.float32)
    big = coarse.repeat(30, axis=1).repeat(30, axis=2)[:, :FRAME_HW[0],
                                                       :FRAME_HW[1]]
    frames = np.clip(big + rng.normal(0.0, 8.0, big.shape), 0, 255
                     ).astype(np.uint8)
    with native.VideoWriter(path, FRAME_HW[1], FRAME_HW[0], fps=30.0) as w:
        for f in frames:
            w.write_rgb(f, quality=90)
    with native.VideoReader(path) as r:
        return [r.frame_rgb(i) for i in range(r.num_frames)]


def _check_video(path: str, depths=None) -> None:
    """``path`` holds the 48 frames at the frame size; with ``depths``,
    each frame is, byte for byte, the JPEG (quality 90) of the Spectral
    rendering of that frame's depth map."""
    native = importlib.import_module(f"{PKG}.media.native")
    colormap = importlib.import_module(f"{PKG}.media.colormap")
    with native.VideoReader(path) as r:
        shapes = {r.frame_rgb(i).shape for i in range(r.num_frames)}
        if r.num_frames != VIDEO_FRAMES or shapes != {(*FRAME_HW, 3)}:
            raise AssertionError(f"{path}: {r.num_frames} frames of "
                                 f"{shapes}")
        if depths is None:
            return
        for i, depth in enumerate(depths):
            want = native.encode_jpeg(
                colormap.colorize_depth(depth, bgr=False), 90)
            if r.frame_bytes(i) != want:
                raise AssertionError(f"{path}: frame {i} is not the "
                                     "rendering of its depth map")


def _decoder_layouts(runner, rz, bgr) -> list:
    """Whether each decoder resize that K6 takes lies in channels-last
    memory, the kernel's layout (another layout would be copied into it
    first): a spy on the dispatch test, so the launch counter stays the
    wrapper's own."""
    import torch

    seen = []
    real = rz._takes_lerp

    def spy(x, method, channels_last):
        taken = real(x, method, channels_last)
        if taken:
            seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return taken

    with _Knobs({"_PALLAS_RESIZE": True}):
        rz._takes_lerp = spy
        try:
            runner(bgr)
        finally:
            rz._takes_lerp = real
    return seen


def phase_video(model, smi: str) -> dict[str, dict[str, int]]:
    """The slice's path: ``cli.video_depth.main`` on a 48-frame MJPEG AVI
    at vitl width, 518 px, batch 8, under each knob configuration, with
    the launch counts held to the batches the engine ran. The depth maps
    the entry point rendered (all 48, through its ``on_depth`` hook) are
    held to the plain f32 model on the same weights, and every output
    frame to the rendering of its depth map; then the environment knobs
    through ``python -m``."""
    import os
    import tempfile

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    attn = importlib.import_module(f"{PKG}.ops.attention")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    native = importlib.import_module(f"{PKG}.media.native")
    colormap = importlib.import_module(f"{PKG}.media.colormap")
    vd = importlib.import_module(f"{PKG}.cli.video_depth")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        avi = os.path.join(tmp, "in.avi")
        rgb = _video_input(avi, seed=5)
        bgr = [f[..., ::-1] for f in rgb]  # as the entry point submits them
        runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)
        x = torch.from_numpy(np.stack(bgr[:BATCH])).cuda()

        # Host codecs alone, per frame: decode, and encode a rendering.
        t0 = time.perf_counter()
        with native.VideoReader(avi) as r:
            for i in range(r.num_frames):
                r.frame_rgb(i)
        dec_ms = (time.perf_counter() - t0) / VIDEO_FRAMES * 1e3
        vis = colormap.colorize_depth(np.linspace(0, 20, FRAME_HW[0] *
                                                  FRAME_HW[1]).reshape(
            FRAME_HW).astype(np.float32), bgr=False)
        t0 = time.perf_counter()
        for _ in range(VIDEO_FRAMES):
            native.encode_jpeg(vis, 90)
        enc_ms = (time.perf_counter() - t0) / VIDEO_FRAMES * 1e3
        print(f"video: {VIDEO_FRAMES} frames of {FRAME_HW}, MJPEG q90, "
              f"{os.path.getsize(avi) / 2**20:.2f} MiB; host decode "
              f"{dec_ms:.2f} ms/frame, encode of a rendering {enc_ms:.2f} "
              "ms/frame")

        layouts = _decoder_layouts(runner, rz, bgr[:BATCH])
        print(f"video: decoder resizes reaching K6: {len(layouts)}, in "
              f"channels-last memory: {sum(layouts)}")
        if layouts != [True] * 5:
            raise AssertionError(f"decoder resizes at K6: {layouts} (want "
                                 "five, all in channels-last memory)")

        # The yardsticks, over all 48 frames: the plain model in bf16 and
        # in f32, knobs off. The entry point builds the same seeded model.
        def every_frame():
            return np.concatenate([np.stack(runner(bgr[i:i + BATCH]))
                                   for i in range(0, VIDEO_FRAMES, BATCH)])

        with _Knobs({}):
            attn.set_force_plain(True)
            try:
                plain = every_frame()
                model.pretrained.dtype = torch.float32
                with torch.backends.cudnn.flags(
                        enabled=True,
                        benchmark=torch.backends.cudnn.benchmark,
                        deterministic=torch.backends.cudnn.deterministic,
                        allow_tf32=False):
                    f32 = every_frame()
            finally:
                model.pretrained.dtype = torch.bfloat16
                attn.set_force_plain(False)
        d_pf = np.abs(plain - f32)

        for cfg, (flags, per_batch) in VIDEO_CONFIGS.items():
            out = os.path.join(tmp, f"out_{len(launches)}.mp4")
            depths = {}
            with _Knobs(flags):
                torch.cuda.synchronize()
                _video_counts(fa, rz, zero=True)
                t0 = time.perf_counter()
                result = vd.main(["-i", avi, "-o", out, "--encoder", "vitl",
                                  "--batch-size", str(BATCH)],
                                 on_depth=depths.__setitem__)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = _video_counts(fa, rz)
                dev_ms = _cuda_ms(lambda: da._run_batched_u8(
                    model, x, runner.net_hw, FRAME_HW), iters=10, warmup=2)
            stats = result["engine"]
            n_b = stats["batches"]
            want = {k: v * n_b for k, v in per_batch.items()}
            want.update(K2=0, K3=0, Q1=0, Q2=0, AUG=0, TA=0)
            if sorted(depths) != list(range(VIDEO_FRAMES)):
                raise AssertionError(f"video [{cfg}]: depth maps of frames "
                                     f"{sorted(depths)}")
            maps = np.stack([depths[i] for i in range(VIDEO_FRAMES)])
            _check_video(out, maps)
            d_kf = np.abs(maps - f32)
            d_kp = np.abs(maps - plain)
            print(f"video [{cfg}]: {result['frames']} frames in {n_b} "
                  f"batches (fill {stats['mean_batch_fill']:.2f}), "
                  f"{seconds:.2f} s in main() (model init, decode, serve, "
                  f"render, encode): {result['frames'] / seconds:.2f} "
                  f"frames/s; latency p50 {stats['latency_p50_ms']:.1f} ms; "
                  f"BatchedRunner device {dev_ms:.2f} ms/batch "
                  f"({BATCH / dev_ms * 1e3:.2f} frames/s), {smi}")
            print(f"  launches {counts} (want {want}); the entry point's "
                  f"{VIDEO_FRAMES} depth maps vs plain f32: mean "
                  f"{d_kf.mean():.5f} m, max {d_kf.max():.4f} m (plain bf16 "
                  f"vs f32: mean {d_pf.mean():.5f}, max {d_pf.max():.4f}); "
                  f"vs plain bf16 max {d_kp.max():.4f}; every output frame "
                  "is its depth map's rendering")
            if counts != want or stats["failed"] or \
                    result["frames"] != VIDEO_FRAMES:
                raise AssertionError(f"video [{cfg}]: launches {counts}, "
                                     f"want {want}; stats {stats}")
            if not (d_kf.mean() <= 1.5 * d_pf.mean()
                    and d_kp.max() <= 2.0 * d_pf.max()):
                raise AssertionError(f"video [{cfg}]: depth further from "
                                     "f32 than the plain bf16 model allows")
            launches[cfg] = counts

        # The environment knobs reach the real entry point: python -m.
        out = os.path.join(tmp, "env.avi")
        code = (
            "import json, runpy, sys\n"
            f"sys.argv = ['video_depth', '-i', {avi!r}, '-o', {out!r}, "
            "'--encoder', 'vitl']\n"
            f"runpy.run_module('{PKG}.cli.video_depth', run_name='__main__',"
            " alter_sys=True)\n"
            f"fa = sys.modules['{PKG}.ops.flash_attention']\n"
            f"rz = sys.modules['{PKG}.ops.resize']\n"
            "print(json.dumps({'K1': fa.flash_attention.launches, "
            "'K4': fa.flash_attention_pair.launches, "
            "'K6': rz.lerp_resize.launches}))\n")
        env = dict(os.environ, E3D_PALLAS_RESIZE="1", E3D_FLASH_PAIR="1")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"python -m video_depth under the knobs "
                                 f"exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        batches = sub["K4"] // BLOCKS
        print(f"video [E3D_PALLAS_RESIZE=1 E3D_FLASH_PAIR=1, python -m, "
              f"own process]: {time.perf_counter() - t0:.1f} s, launches "
              f"{sub}")
        if sub["K1"] or not batches or sub["K4"] != BLOCKS * batches \
                or sub["K6"] != 5 * batches:
            raise AssertionError(f"python -m video_depth: launches {sub}")
        _check_video(out)
    return launches


# ------------------------------------------------------------- training


def _profiled(fn, iters: int, what: str) -> list:
    """``fn`` timed ``iters`` times on the host clock, then profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _print_profile(prof, wall_us, plain_wall_us, iters, what)


def _bwd_name(fused: bool) -> str:
    return "K2" if fused else "K3"


# The backward's kernels, by the part of their names the profiler shows.
BWD_PARTS = {"prep": "flash_attn_bwd_prep_kernel",
             "dkv": "flash_attn_bwd_dkv_kernel",
             "dq": "flash_attn_bwd_dq_kernel",
             "convert": "flash_attn_bwd_convert_kernel"}


def phase_bwd(fused: bool) -> dict:
    """K2 (fused) or K3 (split) against the plain backward; times at the
    flagship shape beside the plain version and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    name = "K2" if fused else "K3"

    def wrapper(*args):
        """The training path's call: the backward op, whose packed dqkv
        the kernels fill (``flash_attention_qkv_backward``)."""
        return fa._bwd_op(*args, fused)

    def case(shape, seed):
        q, k, v = _attention_case(*shape, seed)
        o, lse = fa.flash_attention(q, k, v)
        gen = torch.Generator(device="cuda").manual_seed(seed + 100)
        do = torch.randn(q.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        return q, k, v, o, lse, do

    errs = {}
    for shape, seed in ((FLAGSHIP, 0), ((3, 130, 5, 32), 1)):
        args = case(shape, seed)
        grads = wrapper(*args).unbind(2)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(*args)
        abs_err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(grads, ref))
        rel = {n: ((g.float() - r.float()).abs().max()
                   / r.float().abs().max()).item()
               for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
        print(f"{name} {shape}: max|err| / max|ref| "
              + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
              + f" (tol {BWD_TOL}); max|err| {abs_err:.3e}")
        if not all(torch.isfinite(g).all() for g in grads) \
                or max(rel.values()) > BWD_TOL:
            raise AssertionError(f"{name} disagrees with the plain backward "
                                 f"at {shape}")
        errs[shape] = abs_err
        del args, grads, ref

    b, n, h, d = FLAGSHIP
    args = case(FLAGSHIP, 0)
    ms = _cuda_ms(lambda: wrapper(*args), iters=20)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_bwd_reference(*args),
                        iters=3, warmup=1)
    q, k, v, o, lse, do = args
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh)
    doh = do.transpose(1, 2).contiguous()
    library_ms = _cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True), iters=20)
    flops = 5 * 2 * b * h * n * n * d
    # Read q, k, v, o, dO (bf16) and LSE (f32); write dq, dk, dv (bf16).
    nbytes = 8 * b * n * h * d * 2 + b * h * n * 4
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(flop_ms, byte_ms)
    print(f"{name} {FLAGSHIP}: op {ms:.4f} ms per launch, plain "
          f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} "
          f"MB), {flops / ms / 1e9:.1f} TFLOP/s")
    # What the wrapper's time is made of: each of its three kernels.
    kernels = _profiled(lambda: wrapper(*args), 5,
                        f"{name} op at {FLAGSHIP}")
    parts = {part: sum(e.self_device_time_total for e in kernels
                       if key in e.key) / 5 / 1e3
             for part, key in BWD_PARTS.items()}
    parts = {k: v for k, v in parts.items() if v > 0}
    print(f"{name} {FLAGSHIP} by kernel (torch.profiler): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    return {"name": "flash_attn_bwd_fused" if fused else
            "flash_attn_bwd_split", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attn_bwd.cu",
            "replaces": f"{JAX_FLASH}:{507 if fused else 548}",
            "max_abs_err": errs[FLAGSHIP], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms, "kernels_ms": parts}


class SeededFrames:
    """In-memory datamodule: seeded uint8 SimCol-size frames and uint16
    depth, ``n_train`` batches of ``mb`` to train on, ``n_val`` to
    validate on."""

    size = 518

    def __init__(self, n_train: int, n_val: int, mb: int, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)

        def batch():
            return {"image": rng.integers(0, 256, (mb, *FRAME_HW, 3),
                                          dtype=np.uint8),
                    "depth": rng.integers(1, 65536, (mb, *FRAME_HW),
                                          dtype=np.uint16)}

        self.batches = [batch() for _ in range(n_train)]
        self.val = [batch() for _ in range(n_val)]
        self.train_dataset = None

    def setup(self, stage: str) -> None:
        self.train_dataset = self.batches

    def train_loader(self):
        return self.batches

    def val_loader(self):
        return self.val


def _flat(grads: dict):
    import torch

    return torch.cat([g.float().flatten() for _, g in sorted(grads.items())])


def phase_grads(data, encoder: str = "vitl", n_count: int = BATCH,
                blocks: int = BLOCKS) -> dict[str, int]:
    """One microbatch of ``n_count`` through ``DepthTask``'s loss and the
    backward on the kernels, with gradient checkpointing: every trainable
    parameter gets a finite, non-zero gradient (each attn.qkv weight and
    bias, and vitg's mlp.w12 and mlp.w3, in particular). Then the kernels'
    gradient against the plain attention's in bf16 and in f32 on a
    microbatch of 2. Returns the launches of the counted backward."""
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    attn = importlib.import_module(f"{PKG}.ops.attention")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    dt = importlib.import_module(f"{PKG}.train.depth_task")
    pre = importlib.import_module(f"{PKG}.data.preprocess")

    task = dt.DepthTask(encoder, device="cuda")
    model = da.build_depth_model(encoder, device="cuda", seed=1,
                                 grad_checkpoint=True).train()
    batch = pre.DevicePreprocessor(518, device="cuda")(data.batches[0],
                                                       train=False)
    maxd = torch.full((BATCH,), task.max_depth, device="cuda")

    def grads(n: int, plain: bool = False, f32: bool = False) -> dict:
        model.zero_grad(set_to_none=True)
        attn.set_force_plain(plain)
        if f32:
            model.pretrained.dtype = torch.float32
        try:
            with torch.backends.cudnn.flags(
                    enabled=True, benchmark=torch.backends.cudnn.benchmark,
                    deterministic=torch.backends.cudnn.deterministic,
                    allow_tf32=not f32):
                loss, _ = task._loss_and_metrics(
                    model, batch["image"][:n], batch["depth"][:n], maxd[:n])
                loss.backward()
        finally:
            model.pretrained.dtype = torch.bfloat16
            attn.set_force_plain(False)
        return {name: p.grad for name, p in model.named_parameters()
                if name != "pretrained.mask_token"}

    bwd = _bwd_name(fa._BWD_FUSED)
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    counted = grads(n_count)
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    want = _want(K1=2 * blocks, **{bwd: blocks})
    if counts != want:
        raise AssertionError(f"grads {encoder}: launches {counts}, want "
                             f"{want} (K1 forward and recompute)")
    bad = [name for name, g in counted.items() if g is None
           or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    qkv = [name for name in counted if ".attn.qkv." in name]
    ffn = sorted({name.rsplit(".", 1)[0].split(".mlp.")[1]
                  for name in counted if ".mlp." in name})
    print(f"grads, {encoder} microbatch {n_count} on K1/{bwd}: "
          f"{len(counted)} parameters ({len(qkv)} attn.qkv weights and "
          f"biases; FFN {ffn}), launches {counts}; "
          f"{len(counted) - len(bad)} with a finite, non-zero gradient")
    if bad or len(qkv) != 2 * blocks:
        raise AssertionError(f"grads {encoder}: no finite, non-zero "
                             f"gradient for {bad[:8]}")

    n = 2  # plain attention keeps (n, H, 1370, 1370) f32 scores
    kernel = _flat(counted if n_count == n else grads(n))
    del counted
    plain = _flat(grads(n, plain=True))
    f32 = _flat(grads(n, plain=True, f32=True))
    cos = torch.nn.functional.cosine_similarity

    def dist(a):
        return ((a - f32).norm() / f32.norm()).item(), cos(a, f32, dim=0).item()

    (d_kf, c_kf), (d_pf, c_pf) = dist(kernel), dist(plain)
    d_kp = ((kernel - plain).norm() / plain.norm()).item()
    print(f"grads, {encoder} microbatch {n}, flattened ({kernel.numel()} "
          f"values): K1/{bwd} bf16 vs plain f32 rel. norm {d_kf:.4f}, cos "
          f"{c_kf:.6f}; plain bf16 vs plain f32 {d_pf:.4f}, cos {c_pf:.6f}; "
          f"K1/{bwd} vs plain bf16 {d_kp:.4f}")
    # Random weights amplify bf16 rounding, so the check is relative: the
    # kernels may be no further from f32 than 1.5x the plain bf16 path.
    if not (d_kf <= 1.5 * d_pf and 1 - c_kf <= 1.5 ** 2 * (1 - c_pf)):
        raise AssertionError(f"grads {encoder}: the kernels' gradient is "
                             "further from f32 than 1.5x the plain bf16 "
                             "gradient's")
    return counts


def _read_log(log_dir: str) -> list[dict]:
    import os

    with open(os.path.join(log_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _fit(data, fused: bool, max_steps=None):
    """``fit_depth`` on vitl with the recipe's defaults (16-mixed, gradient
    checkpointing, the DAv2 LRs, clip 1.0) and OneCycle over 4 steps, the
    backward on K2 (``fused``) or K3. Returns (task, state, launches, log
    records, wall seconds)."""
    import os
    import tempfile

    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    dt = importlib.import_module(f"{PKG}.train.depth_task")
    loop = importlib.import_module(f"{PKG}.train.loop")

    task = dt.DepthTask("vitl", total_steps=4, grad_accum=ACCUM,
                        device="cuda")
    # Each optimizer step's wall on the host clock, synced at both ends:
    # the first against the steady ones.
    task.step_ms = []
    step = task.train_step

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        task.step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    task.train_step = timed_step
    knob = fa._BWD_FUSED
    fa._BWD_FUSED = fused
    try:
        with tempfile.TemporaryDirectory() as tmp:
            log_dir = os.path.join(tmp, "log")
            torch.cuda.synchronize()
            _video_counts(fa, rz, zero=True)
            t0 = time.perf_counter()
            state = loop.fit_depth(task, data, max_epochs=1,
                                   log_dir=log_dir,
                                   ckpt_dir=os.path.join(tmp, "ckpt"),
                                   val_check_interval=1.0, seed=0,
                                   max_steps=max_steps)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _video_counts(fa, rz)
            records = _read_log(log_dir)
    finally:
        fa._BWD_FUSED = knob
        del task.train_step
    return task, state, counts, records, seconds


def phase_train(data, smi: str) -> tuple:
    """The training path: vitl at 518 px through ``fit_depth``, on the
    default backward."""
    import math

    import torch

    dt = importlib.import_module(f"{PKG}.train.depth_task")
    init = {k: v.clone() for k, v in dt.DepthTask(
        "vitl", device="cuda").init_state(0).model.state_dict().items()}
    fused = importlib.import_module(f"{PKG}.ops.flash_attention")._BWD_FUSED
    torch.cuda.reset_peak_memory_stats()
    task, state, counts, records, seconds = _fit(data, fused=fused)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    n_mb = TRAIN_MICROBATCHES
    want = _want(K1=2 * BLOCKS * n_mb + BLOCKS * VAL_BATCHES,
                 K6=K6_VITL * VAL_BATCHES, AUG=AUG_LAUNCHES * n_mb,
                 **{_bwd_name(fused): BLOCKS * n_mb})
    steps = -(-n_mb // ACCUM)
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "val_loss" in r]
    perf = next(r for r in records if "perf/step_time_mean_s" in r)
    values = [v for r in train + val for k, v in r.items()
              if k.startswith(("train_loss", "Train/", "val_loss", "Val/"))]
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, init[k])]
    frames = n_mb * BATCH
    step_s = perf["perf/step_time_mean_s"]
    print(f"train on {_bwd_name(fused)} (the default), vitl 518 px, "
          f"16-mixed, gradient checkpointing, "
          f"{n_mb} microbatches of {BATCH}, accum {ACCUM}: {state.step} "
          f"optimizer steps in {seconds:.2f} s (with preprocessing, "
          f"validation on {VAL_BATCHES} batches and a checkpoint); "
          f"launches {counts}")
    print(f"  losses {[round(r['train_loss'], 5) for r in train]}, "
          f"val_loss {val[-1]['val_loss']:.5f}; {len(moved)} of "
          f"{len(init)} parameters changed")
    print(f"  per optimizer step (train.step spans, {smi}): mean "
          f"{step_s * 1e3:.1f} ms, p50 {perf['perf/step_time_p50_s'] * 1e3:.1f}"
          f" ms; {frames / (step_s * steps):.2f} frames/s trained; "
          f"{frames / seconds:.2f} frames/s over the whole fit; peak device "
          f"memory {peak:.2f} GiB")
    first, rest = task.step_ms[0], task.step_ms[1:]
    print(f"  first optimizer step {first:.1f} ms (the first backward's "
          f"cuBLAS/cuDNN set-up; the kernels were built in phase build), "
          f"steady {sum(rest) / len(rest):.1f} ms (host clock, synced; "
          f"{[round(t, 1) for t in rest]}): what a train-step export "
          f"could save a restarted fine-tune")
    if counts != want:
        raise AssertionError(f"train: launches {counts}, want {want}")
    if state.step != steps or len(train) != steps or len(val) != 1 \
            or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"train: step {state.step}, records "
                             f"{train + val}")
    # mask_token is not used by the model: no gradient, zero init, so
    # weight decay leaves it at zero.
    still = sorted(set(init) - set(moved) - {"pretrained.mask_token"})
    if still:
        raise AssertionError(f"train: parameters unchanged: {still[:8]}")
    return task, state, counts


def phase_train_other(data) -> dict:
    """The training path once more with the other backward (the JAX
    package's ``E3D_FLASH_BWD_FUSED`` set against the default), one
    optimizer step."""
    import math

    fused = not importlib.import_module(
        f"{PKG}.ops.flash_attention")._BWD_FUSED
    name = _bwd_name(fused)
    _, state, counts, records, seconds = _fit(data, fused=fused, max_steps=1)
    want = _want(K1=2 * BLOCKS * ACCUM + BLOCKS * VAL_BATCHES,
                 K6=K6_VITL * VAL_BATCHES, AUG=AUG_LAUNCHES * ACCUM,
                 **{name: BLOCKS * ACCUM})
    loss = next(r["train_loss"] for r in records if "train_loss" in r)
    print(f"train on {name} (the other backward): {state.step} optimizer "
          f"step of {ACCUM} microbatches in {seconds:.2f} s, loss "
          f"{loss:.5f}; launches {counts}")
    if counts != want or not math.isfinite(loss):
        raise AssertionError(f"train on {name}: launches {counts}, want "
                             f"{want}")
    return counts


def phase_train_profile(task, state, data) -> None:
    """Where one whole optimizer step's device time goes, and how long the
    card idles in it: ``DepthTask.train_step`` on vitl, ``ACCUM``
    microbatches of 8 (forward, recompute and backward on K1 and the
    default backward), the global-norm clip and the two-group AdamW
    step."""
    import torch

    pre = importlib.import_module(f"{PKG}.data.preprocess")
    prep = pre.DevicePreprocessor(518, device="cuda")
    prepped = [prep(b, train=False) for b in data.batches[:ACCUM]]
    batch = {k: torch.stack([p[k] for p in prepped])
             for k in ("image", "depth")}

    def step():
        task.train_step(state, batch)

    iters = 1
    kernels = _profiled(step, iters,
                        f"vitl optimizer step ({ACCUM} microbatches of "
                        f"{BATCH}, clip, AdamW)")
    busy = sum(e.self_device_time_total for e in kernels)
    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    bwd = _bwd_name(fa._BWD_FUSED)
    for label, key in (("K1", "flash_attn_fwd"), (bwd, "flash_attn_bwd"),
                       *((f"  {bwd} {part}", k)
                         for part, k in BWD_PARTS.items())):
        t = sum(e.self_device_time_total for e in kernels if key in e.key)
        if busy and t:
            print(f"  {label} share {t / busy:.3f} "
                  f"({t / iters / 1e3:.3f} ms per optimizer step)")


# ------------------------------------------------------------ file CLIs

# The file-based entry points' fixtures: SimCol-shaped trees of 475x475
# frames written by the port's own writers. infer and serve: 32 frames in
# 2 procedures (4 batches of 8). train_depth and test_depth: 3 procedures
# of 32 (the first trains: 4 microbatches, 2 optimizer steps at accum 2;
# the other two validate and test: 8 batches of 8).
CLI_FRAMES = 4 * BATCH
TRAIN_CLI_FRAMES = 4 * BATCH
TRAIN_CLI_ACCUM = 2


def _captured(fn, *args):
    """``fn(*args)`` with its standard output captured and echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip() and not line.startswith("[metrics]"):
            print(f"  | {line}")
    return result, text


def _want(**launches) -> dict[str, int]:
    return {k: launches.get(k, 0) for k in ("K1", "K2", "K3", "K4", "K5",
                                            "K6", "Q1", "Q2", "AUG", "TA")}


def phase_codecs(smi: str) -> None:
    """The port's image codecs at SimCol's frame size: its writers
    (``media.imageio``: 8-bit RGB and 16-bit gray PNG, 16-bit TIFF)
    through its readers (``data.native``), bit for bit, with the host's
    ms per frame."""
    import os
    import tempfile

    import numpy as np

    imageio = importlib.import_module(f"{PKG}.media.imageio")
    native = importlib.import_module(f"{PKG}.data.native")
    rng = np.random.default_rng(11)
    n = 16
    cases = {
        "PNG 8-bit RGB": (rng.integers(0, 256, (n, *FRAME_HW, 3),
                                       dtype=np.uint8), "png"),
        "PNG 16-bit gray": (rng.integers(0, 65536, (n, *FRAME_HW),
                                         dtype=np.uint16), "png"),
        "TIFF 16-bit gray": (rng.integers(0, 65536, (n, *FRAME_HW),
                                          dtype=np.uint16), "tiff"),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for label, (imgs, ext) in cases.items():
            paths = [os.path.join(tmp, f"{ext}{imgs.ndim}_{i}.{ext}")
                     for i in range(n)]
            write = imageio.write_png if ext == "png" else \
                imageio.write_tiff16
            read = (lambda p: native.decode_png_batch([p])[0]) \
                if ext == "png" else native.decode_tiff
            t0 = time.perf_counter()
            for path, img in zip(paths, imgs):
                write(path, img)
            w_ms = (time.perf_counter() - t0) / n * 1e3
            t0 = time.perf_counter()
            back = [read(p) for p in paths]
            r_ms = (time.perf_counter() - t0) / n * 1e3
            size = sum(os.path.getsize(p) for p in paths) / n / 2 ** 10
            equal = all(np.array_equal(a, b) for a, b in zip(back, imgs))
            print(f"codecs [{label}, {FRAME_HW}, random pixels, {size:.0f} "
                  f"KiB a file]: write {w_ms:.2f} ms/frame, read "
                  f"{r_ms:.2f} ms/frame (host, {smi}); round trip "
                  f"{'bit-equal' if equal else 'DIFFERS'}")
            if not equal:
                raise AssertionError(f"codecs [{label}]: round trip differs")


def _plain_maps(model, bgr: list) -> tuple:
    """Depth maps of ``bgr`` frames from the plain bf16 model and the plain
    f32 model (cuDNN's TF32 off), the yardsticks of the CLI phases."""
    import numpy as np
    import torch

    attn = importlib.import_module(f"{PKG}.ops.attention")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)

    def every_frame():
        return np.concatenate([np.stack(runner(bgr[i:i + BATCH]))
                               for i in range(0, len(bgr), BATCH)])

    attn.set_force_plain(True)
    try:
        plain = every_frame()
        model.pretrained.dtype = torch.float32
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            f32 = every_frame()
    finally:
        model.pretrained.dtype = torch.bfloat16
        attn.set_force_plain(False)
    return plain, f32


def _check_maps_relative(label: str, maps, plain, f32) -> None:
    """The video phase's rule: the entry point's maps no further from the
    plain f32 model than 1.5x the plain bf16 model's distance (mean), and
    from the plain bf16 model at most 2x its largest distance from f32."""
    import numpy as np

    _check_maps(list(maps))
    d_kf, d_kp, d_pf = (np.abs(a - b) for a, b in
                        ((maps, f32), (maps, plain), (plain, f32)))
    print(f"  {label}: {len(maps)} depth maps vs plain f32: mean "
          f"{d_kf.mean():.5f} m, max {d_kf.max():.4f} m (plain bf16 vs f32: "
          f"mean {d_pf.mean():.5f}, max {d_pf.max():.4f}); vs plain bf16 "
          f"max {d_kp.max():.4f}")
    if not (d_kf.mean() <= 1.5 * d_pf.mean()
            and d_kp.max() <= 2.0 * d_pf.max()):
        raise AssertionError(f"{label}: depth further from f32 than the "
                             "plain bf16 model allows")


def phase_infer_cli(model, tmp: str, smi: str, encoder: str = "vitl",
                    blocks: int = BLOCKS, resizes: int = K6_VITL,
                    rerun: bool = True) -> tuple:
    """``cli.infer.main --encoder <encoder>`` (vitl by default) on a SimCol
    tree of 32 frames (batch 8, ``--save-numpy``): K1's launches, every
    map against the plain f32 model (``model``: the CLI's own seeded
    weights), and skip-existing on a second run (``rerun``). Returns the
    launches, the frames' paths and BGR arrays, and the yardstick maps."""
    import glob
    import os

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    synthetic = importlib.import_module(f"{PKG}.data.synthetic")
    dio = importlib.import_module(f"{PKG}.data.io")
    infer = importlib.import_module(f"{PKG}.cli.infer")

    root = synthetic.make_simcol_fixture(
        os.path.join(tmp, f"infer_{encoder}"), n_procedures=2,
        frames_per_proc=CLI_FRAMES // 2, hw=FRAME_HW[0], seed=21)
    paths = sorted(glob.glob(os.path.join(
        root, "SyntheticColon_I", "Frames_S*", "FrameBuffer_*.png")))
    bgr = [np.ascontiguousarray(dio.decode_rgb(p)[..., ::-1])
           for p in paths]
    args = ["-i", root, "-d", "simcol", "--encoder", encoder,
            "--batch-size", str(BATCH), "--save-numpy"]
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    result, _ = _captured(infer.main, args)
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    batches = -(-CLI_FRAMES // BATCH)
    want = _want(K1=blocks * batches, K6=resizes * batches)
    host = 1.0 - result["model_seconds"] / result["seconds"]
    print(f"infer CLI ({encoder}): {result['processed']} frames of "
          f"{FRAME_HW} in "
          f"{result['seconds']:.2f} s through main() (model init, decode, "
          f"{batches} batches, render, PNG and .npy writes): "
          f"{CLI_FRAMES / result['seconds']:.2f} frames/s; in the model's "
          f"entry points {result['model_seconds']:.2f} s, host share "
          f"{host:.3f}; {smi}; launches {counts} (want {want})")
    if counts != want or result["processed"] != CLI_FRAMES:
        raise AssertionError(f"infer CLI: launches {counts}, want {want}; "
                             f"{result}")
    maps = np.stack([np.load(os.path.join(
        root, "SyntheticColon_I", f"{os.path.basename(os.path.dirname(p))}"
        "_OP", os.path.basename(p)[:-4] + ".npy")) for p in paths])
    plain, f32 = _plain_maps(model, bgr)
    _check_maps_relative(f"infer CLI ({encoder})", maps, plain, f32)
    if not rerun:
        return counts, paths, bgr, plain, f32

    # Skip-existing: a second run skips all 32. (The SimCol glob,
    # Frames_*, also takes the first run's Frames_*_OP renderings as new
    # frames, as the reference's run.py does.)
    again, text = _captured(infer.main, args)
    print(f"infer CLI, second run: skipped {again['skipped']}, processed "
          f"{again['processed']} (the first run's renderings)")
    if f"Skipped existing: {CLI_FRAMES}" not in text:
        raise AssertionError(f"infer CLI second run: {again}")
    return counts, paths, bgr, plain, f32


def phase_serve_cli(paths, plain, f32, tmp: str, smi: str) -> dict:
    """``cli.serve.main --once`` over a flat folder of the same 32 frames
    plus one truncated PNG: the truncated file is left unread (parked
    while it stays unchanged), the others are served through K1 and held
    against the plain f32 model."""
    import os
    import shutil

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    serve = importlib.import_module(f"{PKG}.cli.serve")

    indir = os.path.join(tmp, "incoming")
    outdir = os.path.join(tmp, "served")
    os.makedirs(indir)
    names = []
    for p in paths:
        name = f"{os.path.basename(os.path.dirname(p))}_{os.path.basename(p)}"
        shutil.copy(p, os.path.join(indir, name))
        names.append(name[:-4])
    cut = os.path.join(indir, "zz_truncated.png")
    with open(paths[0], "rb") as f:
        data = f.read()
    with open(cut, "wb") as f:
        f.write(data[:len(data) // 2])
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    t0 = time.perf_counter()
    result, text = _captured(serve.main, [
        "-i", indir, "-o", outdir, "--encoder", "vitl", "--batch-size",
        str(BATCH), "--once", "--save-numpy"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _video_counts(fa, rz)
    stats = result["stats"]
    want = _want(K1=BLOCKS * stats["batches"], K6=K6_VITL * stats["batches"])
    print(f"serve CLI: {result['served']} frames served in "
          f"{stats['batches']} batches (fill {stats['mean_batch_fill']:.2f}), "
          f"{seconds:.2f} s through main() (model init, decode, serve, "
          f"render, writes): {result['served'] / seconds:.2f} frames/s; "
          f"latency p50/p95/p99 {stats['latency_p50_ms']:.1f}/"
          f"{stats['latency_p95_ms']:.1f}/{stats['latency_p99_ms']:.1f} ms; "
          f"{smi}; unread {sorted(result['unread'])}; launches {counts} "
          f"(want {want})")
    if counts != want or result["served"] != CLI_FRAMES \
            or list(result["unread"]) != [cut] \
            or "latency p50/p95/p99 = " not in text or stats["failed"]:
        raise AssertionError(f"serve CLI: launches {counts}, want {want}; "
                             f"{result}")
    maps = np.stack([np.load(os.path.join(outdir, f"{n}.npy"))
                     for n in names])
    _check_maps_relative("serve CLI", maps, plain, f32)

    # The same run with the launches called directly, past the ops'
    # dispatcher, in turns: frames/s and host share (1 - the engine's
    # time in its runner over the wall of main()).
    def timed(label, direct):
        out = os.path.join(tmp, f"served_{label}")
        t0 = time.perf_counter()
        if direct:
            with _DirectLaunches():
                res, _ = _captured(serve.main, [
                    "-i", indir, "-o", out, "--encoder", "vitl",
                    "--batch-size", str(BATCH), "--once"])
        else:
            res, _ = _captured(serve.main, [
                "-i", indir, "-o", out, "--encoder", "vitl",
                "--batch-size", str(BATCH), "--once"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = res["stats"]["runner_seconds"]
        print(f"  serve CLI, launches {'direct' if direct else 'ops'}: "
              f"{res['served'] / wall:.2f} frames/s, host share "
              f"{1 - busy / wall:.3f} (runner {busy:.2f} of {wall:.2f} s)")

    for i, direct in enumerate((True, False, True)):
        timed(f"t{i}", direct)
    return counts


def _cli_data(root: str) -> list[str]:
    return [f"dataset.data_dir={root}",
            f"dataset.train_list={root}/train.txt",
            f"dataset.val_list={root}/val.txt",
            f"dataset.test_list={root}/test.txt",
            "model=large", "dataset.size=518",
            f"dataset.batch_size={BATCH}"]


def phase_train_cli(tmp: str, smi: str) -> tuple:
    """``cli.train_depth.main`` at vitl 518 px on a SimCol tree (3
    procedures of 32 frames; the config's 16-mixed and gradient
    checkpointing; microbatch 8, accum 2, two optimizer steps): the run
    dir, its snapshot, a finite train_loss, a checkpoint, and the
    launches (K1 48 and the default backward 24 per microbatch, K1 24 per
    validation batch). Returns the launches, the checkpoint dir and the
    data overrides."""
    import math
    import os

    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    synthetic = importlib.import_module(f"{PKG}.data.synthetic")
    train_depth = importlib.import_module(f"{PKG}.cli.train_depth")

    root = synthetic.make_simcol_fixture(
        os.path.join(tmp, "train"), n_procedures=3,
        frames_per_proc=TRAIN_CLI_FRAMES, hw=FRAME_HW[0], seed=31)
    data = _cli_data(root)
    overrides = data + [f"trainer.accumulate_grad_batches={TRAIN_CLI_ACCUM}",
                        "++trainer.max_steps=2"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _video_counts(fa, rz, zero=True)
        t0 = time.perf_counter()
        out, _ = _captured(train_depth.main, overrides)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _video_counts(fa, rz)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run_dir = os.path.join(tmp, out["run_dir"])
        ckpt_dir = os.path.join(tmp, out["ckpt_dir"])
        records = _read_log(run_dir)
    finally:
        os.chdir(cwd)
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "val_loss" in r]
    perf = next(r for r in records if "perf/step_time_mean_s" in r)
    microbatches = TRAIN_CLI_FRAMES // BATCH
    val_batches = len(val) * -(-2 * TRAIN_CLI_FRAMES // BATCH)
    bwd = _bwd_name(fa._BWD_FUSED)
    want = _want(K1=2 * BLOCKS * microbatches + BLOCKS * val_batches,
                 K6=K6_VITL * val_batches, AUG=AUG_LAUNCHES * microbatches,
                 **{bwd: BLOCKS * microbatches})
    saved = sorted(os.listdir(ckpt_dir))
    snapshot = os.path.join(run_dir, ".hydra", "config.yaml")
    print(f"train_depth CLI, vitl 518 px, 16-mixed, gradient "
          f"checkpointing, {microbatches} microbatches of {BATCH}, accum "
          f"{TRAIN_CLI_ACCUM}: {len(train)} optimizer steps, "
          f"{len(val)} validations of {val_batches // max(len(val), 1)} "
          f"batches, {seconds:.2f} s through main() (fixture excluded); "
          f"per optimizer step (train.step spans) {perf['perf/step_time_mean_s'] * 1e3:.1f}"
          f" ms; peak device memory {peak:.2f} GiB; {smi}; losses "
          f"{[round(r['train_loss'], 5) for r in train]}; checkpoint "
          f"entries {saved}; launches {counts} (want {want})")
    if counts != want or len(train) != 2 \
            or not all(math.isfinite(r["train_loss"]) for r in train) \
            or not os.path.exists(snapshot) \
            or not any(os.path.exists(os.path.join(ckpt_dir, s, "state.pt"))
                       for s in saved):
        raise AssertionError(f"train_depth CLI: launches {counts}, want "
                             f"{want}; records {records}; checkpoint {saved}")
    return counts, ckpt_dir, data, [r["train_loss"] for r in train]


def phase_test_cli(ckpt_dir: str, data: list, tmp: str, smi: str) -> dict:
    """``cli.test_depth.main`` on the train_depth phase's checkpoint dir
    (2 test procedures, 8 batches of 8): finite per-procedure and overall
    metrics, K1's launches, and abs_rel and rmse against the same
    checkpoint on the plain attention in f32."""
    import math
    import os

    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    attn = importlib.import_module(f"{PKG}.ops.attention")
    test_depth = importlib.import_module(f"{PKG}.cli.test_depth")

    os.environ["CHECKPOINT_PATH"] = ckpt_dir

    def run(name: str, *extra: str) -> dict:
        os.environ["E3D_RESULTS_DIR"] = os.path.join(tmp, name)
        return _captured(test_depth.main, data + list(extra))[0]

    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    t0 = time.perf_counter()
    kernel = run("results_k1")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _video_counts(fa, rz)
    batches = -(-2 * TRAIN_CLI_FRAMES // BATCH)
    want = _want(K1=BLOCKS * batches, K6=K6_VITL * batches)
    attn.set_force_plain(True)
    try:
        plain = run("results_plain_bf16")
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            f32 = run("results_plain_f32", "trainer.precision=32-true")
    finally:
        attn.set_force_plain(False)
    values = [s["mean"] for m in kernel["procedure_metrics"].values()
              for s in m.values()]
    values += [s["mean"] for s in kernel["overall_metrics"].values()]
    print(f"test_depth CLI on {ckpt_dir}: {2 * TRAIN_CLI_FRAMES} frames in "
          f"{batches} batches, {seconds:.2f} s through main(); {smi}; "
          f"procedures {sorted(kernel['procedure_metrics'])}; launches "
          f"{counts} (want {want})")
    # The rule: each of abs_rel and rmse (overall, across procedures) on
    # K1 in bf16 within 2x the plain bf16 run's distance from the plain
    # f32 run, plus 1e-3 of the f32 value (a floor for a plain bf16 run
    # that lands on f32 by chance).
    bad = []
    for key in ("abs_rel", "rmse", "d1", "l1"):
        k, p, f = (r["overall_metrics"][key]["mean"]
                   for r in (kernel, plain, f32))
        limit = 2.0 * abs(p - f) + 1e-3 * abs(f)
        print(f"  overall {key}: K1 bf16 {k:.6f}, plain bf16 {p:.6f}, plain "
              f"f32 {f:.6f}; |K1 - f32| {abs(k - f):.2e}"
              + (f" (limit {limit:.2e})" if key in ("abs_rel", "rmse")
                 else ""))
        if key in ("abs_rel", "rmse") and abs(k - f) > limit:
            bad.append(key)
    if counts != want or not all(math.isfinite(v) for v in values) \
            or len(kernel["procedure_metrics"]) != 2 or bad:
        raise AssertionError(f"test_depth CLI: launches {counts}, want "
                             f"{want}; outside the rule: {bad}; {kernel}")
    return counts


# ------------------------------------------------------------- vitg, pose


def phase_vitg_serve(tmp: str, smi: str) -> dict[str, int]:
    """vitg (40 SwiGLU blocks, 24 heads) at 518 px: ``cli.infer.main
    --encoder vitg`` on the 32-frame SimCol tree (batch 8; every map held
    to the plain f32 model by the video rule), then a ``BatchedRunner``
    batch of 8 on the host clock and the device forward on CUDA events,
    with frames/s and peak memory. K1 40 a batch, all others 0. Returns
    the CLI's launches."""
    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    da = importlib.import_module(f"{PKG}.models.depth_anything")

    model = da.build_depth_model("vitg", max_depth=20.0, device="cuda",
                                 seed=0)
    counts, _, bgr, _, _ = phase_infer_cli(model, tmp, smi, "vitg",
                                           VITG_BLOCKS, K6_VITG,
                                           rerun=False)
    batch = bgr[:BATCH]
    runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)
    runner(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _video_counts(fa, rz, zero=True)
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        runner(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    runner_counts = _video_counts(fa, rz)
    x = torch.from_numpy(np.stack(batch)).cuda()
    dev_ms = _cuda_ms(lambda: da._run_batched_u8(
        model, x, runner.net_hw, FRAME_HW), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params = sum(p.numel() for p in model.parameters())
    print(f"vitg serve, 518 px, batch {BATCH}, {smi}: {params / 1e9:.3f} B "
          f"parameters; BatchedRunner {ms:.2f} ms/batch, "
          f"{BATCH / ms * 1e3:.2f} frames/s; device forward "
          f"{dev_ms:.2f} ms/batch, {BATCH / dev_ms * 1e3:.2f} frames/s; "
          f"peak device memory {peak:.2f} GiB; launches over {iters} "
          f"batches {runner_counts}")
    if runner_counts != _want(K1=VITG_BLOCKS * iters, K6=K6_VITG * iters):
        raise AssertionError(f"vitg serve: launches {runner_counts}")
    return counts


# Pose: SimCol-shaped procedures of 65 frames (64 pairs each): two train
# (two optimizer steps of 64), one validates, one tests.
POSE_BATCH = 64
POSE_FRAMES = 65


def _pose_tree(tmp: str) -> str:
    import os

    synthetic = importlib.import_module(f"{PKG}.data.synthetic")
    root = synthetic.make_simcol_fixture(
        os.path.join(tmp, "pose"), n_procedures=4,
        frames_per_proc=POSE_FRAMES, hw=FRAME_HW[0], seed=41)
    for name, procs in (("train", (1, 2)), ("val", (3,)), ("test", (4,))):
        with open(os.path.join(root, f"{name}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(",".join(f"SyntheticColon_I/Frames_S{p}" for p in procs))
    return root


def phase_pose(tmp: str, smi: str) -> dict[str, int]:
    """``cli.train_pose.main`` at the recipe's size (518 px, batch 64,
    '32-true', cycled momentum) on a SimCol tree of 475x475 frames: two
    optimizer steps, validation, the test JSON's per-procedure and
    overall ATE/RTE/ROTE all finite, no attention kernel or K6 launched;
    ms per step, pairs/s and peak memory; a second run takes one step in
    bf16-mixed; then one step profiled for the card's idle share. Returns
    the launches."""
    import math
    import os

    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    train_pose = importlib.import_module(f"{PKG}.cli.train_pose")
    pose_data = importlib.import_module(f"{PKG}.data.pose")
    pose_task = importlib.import_module(f"{PKG}.train.pose_task")

    root = _pose_tree(tmp)
    lists = {m: f"{root}/{m}.txt" for m in ("train", "val", "test")}
    data = [f"dataset.data_dir={root}",
            f"dataset.train_list={lists['train']}",
            f"dataset.val_list={lists['val']}",
            f"dataset.test_list={lists['test']}", "dataset.size=518",
            f"dataset.batch_size={POSE_BATCH}", "trainer.max_epochs=1",
            "trainer.log_every_n_steps=1"]

    def run(name: str, *extra: str) -> tuple:
        cwd = os.path.join(tmp, name)
        os.makedirs(cwd)
        os.environ["E3D_RESULTS_DIR"] = os.path.join(cwd, "results")
        os.chdir(cwd)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = _captured(train_pose.main, data + list(extra))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            os.chdir(tmp)
        return out, _read_log(os.path.join(cwd, out["run_dir"])), seconds

    here = os.getcwd()
    torch.cuda.reset_peak_memory_stats()
    _video_counts(fa, rz, zero=True)
    try:
        out, records, seconds = run("f32")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = _video_counts(fa, rz)
        out16, records16, seconds16 = run("bf16", "trainer.precision=bf16-mixed",
                                          "++trainer.max_steps=1")
    finally:
        os.chdir(here)
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "val_loss" in r]
    step_s = next(r for r in records
                  if "perf/step_time_mean_s" in r)["perf/step_time_mean_s"]
    values = [v for m in out["procedure_metrics"].values() for v in m.values()]
    values += list(out["overall_metrics"].values())
    values += [r["train_loss"] for r in train] + [val[-1]["val_loss"]]
    loss16 = [r["train_loss"] for r in records16 if "train_loss" in r]
    print(f"pose, train_pose CLI, 518 px, batch {POSE_BATCH}, 32-true "
          f"(TF32 off), cycled b1: {len(train)} optimizer steps, "
          f"validation on {POSE_FRAMES - 1} pairs, test on "
          f"{POSE_FRAMES - 1}: {seconds:.2f} s through main() (fixture "
          f"excluded); per optimizer step (train.step spans, the first with its "
          f"set-up) {step_s * 1e3:.1f} ms, {POSE_BATCH / step_s:.2f} "
          f"pairs/s; peak device memory "
          f"{peak:.2f} GiB; {smi}; losses "
          f"{[round(r['train_loss'], 5) for r in train]}, val_loss "
          f"{val[-1]['val_loss']:.5f}; launches {counts}")
    for proc, m in out["procedure_metrics"].items():
        print(f"  {proc}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))
    print("  overall: " + ", ".join(
        f"{k} {v:.6f}" for k, v in out["overall_metrics"].items()))
    print(f"pose, bf16-mixed: {len(loss16)} optimizer step in "
          f"{seconds16:.2f} s through main(), loss {loss16}")
    steps = 2 * (POSE_FRAMES - 1) // POSE_BATCH
    if counts != _want() or len(train) != steps or len(val) != 1 \
            or sorted(out["procedure_metrics"]) != ["SyntheticColon_I/S4"] \
            or sorted(out["overall_metrics"]) != ["ate", "rote", "rte"] \
            or not all(math.isfinite(v) for v in values + loss16) \
            or len(loss16) != 1:
        raise AssertionError(f"pose: launches {counts}; {out}; {records}")

    # One optimizer step as fit_pose takes it (host batch in, upload,
    # forward, loss, backward, clip, AdamW), profiled.
    dm = pose_data.PoseDataModule(root, lists["train"], lists["val"],
                                  lists["test"], batch_size=POSE_BATCH,
                                  size=518)
    dm.setup("fit")
    batch = next(iter(dm.train_loader()))
    task = pose_task.PoseTask(total_steps=8, cycle_momentum=True,
                              device="cuda")
    state = task.init_state(0)
    task.train_step(state, batch)
    torch.cuda.synchronize()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        task.train_step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"pose optimizer step, steady state (host batch in, upload, "
          f"forward, backward, clip, AdamW; {smi}): {ms:.1f} ms, "
          f"{POSE_BATCH / ms * 1e3:.2f} pairs/s")
    _profiled(lambda: task.train_step(state, batch), iters,
              f"pose optimizer step (batch {POSE_BATCH}, 518 px, 32-true)")
    return counts


def phase_pose_parity() -> None:
    """One ``PoseTask.train_step`` ('32-true', TF32 off, dropout off) from
    the same weights and batch on the card and on the CPU. cuDNN and the
    CPU's convolutions sum in other orders: the loss within 1e-4
    relative; the clipped gradient (all parameters) within 1e-2 in
    relative norm: BatchNorm's backward reduces in f32 on the card and in
    f64 on the CPU, and random weights amplify the difference (up to 1e-3
    from an f64 gradient here, 4e-3 from the CPU's on the card test's
    batch), where TF32 would put it 0.1 away (the phase prints the
    distances from f64 at 64 and 128 px); the running statistics within
    1e-4 relative and 1e-5 absolute, every
    parameter within 2 lr of the CPU's (Adam's first step moves each by
    about +-lr, either way where the gradient is at rounding level) and at
    most 1% of them further than 1e-6 lr, and the updated nets' eval
    poses within 1e-3."""
    import torch

    pose_task = importlib.import_module(f"{PKG}.train.pose_task")
    gen = torch.Generator().manual_seed(5)
    batch = {"input": torch.randn((8, 8, 128, 128), generator=gen),
             "target": torch.randn((8, 7), generator=gen)}
    args = dict(dropout=False, cycle_momentum=True, total_steps=10)
    cpu_task = pose_task.PoseTask(device="cpu", **args)
    cpu = cpu_task.init_state(seed=0)
    gpu_task = pose_task.PoseTask(device="cuda", **args)
    gpu = gpu_task.init_state(weights={
        k: v.clone() for k, v in cpu.model.state_dict().items()})
    cpu, cpu_m = cpu_task.train_step(cpu, batch)
    gpu, gpu_m = gpu_task.train_step(gpu, batch)
    _, cpu_pred = cpu_task.eval_step(cpu, batch)
    _, gpu_pred = gpu_task.eval_step(gpu, batch)
    lr0 = float(cpu_task.lr_table()[0])
    loss_rel = abs(gpu_m["loss"].item() - cpu_m["loss"].item()) \
        / abs(cpu_m["loss"].item())
    g_cpu = torch.cat([p.grad.flatten() for p in cpu.model.parameters()])
    g_gpu = torch.cat([p.grad.flatten().cpu()
                       for p in gpu.model.parameters()])
    grad_rel = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    param_max = 0.0
    flipped = total = 0
    for p_cpu, p_gpu in zip(cpu.model.parameters(), gpu.model.parameters()):
        diff = (p_gpu.detach().cpu() - p_cpu.detach()).abs()
        param_max = max(param_max, diff.max().item())
        flipped += int((diff > 1e-6 * lr0 + 1e-8).sum())
        total += diff.numel()
    sd_cpu, sd_gpu = cpu.model.state_dict(), gpu.model.state_dict()
    stats_ok = all(torch.allclose(sd_gpu[k].cpu(), sd_cpu[k], rtol=1e-4,
                                  atol=1e-5)
                   for k in sd_cpu if k.endswith(("running_mean",
                                                  "running_var")))
    stats_err = max((sd_gpu[k].cpu() - sd_cpu[k]).abs().max().item()
                    for k in sd_cpu if k.endswith(("running_mean",
                                                   "running_var")))
    pred_err = (gpu_pred.cpu() - cpu_pred).abs().max().item()
    print(f"pose parity, card (TF32 off) vs CPU, one step of 8 at 128 px: "
          f"loss rel. {loss_rel:.2e} (tol 1e-4); gradient rel. norm "
          f"{grad_rel:.2e} (tol 1e-2); running stats max|d| "
          f"{stats_err:.2e}; parameters max|d| {param_max:.3e} (lr "
          f"{lr0:.3e}, tol 2 lr), {flipped} of {total} beyond 1e-6 lr "
          f"(tol 1%); eval poses max|d| {pred_err:.2e} (tol 1e-3)")
    # How far f32 lies from f64 here: the raw gradient of the same net in
    # f64 on the CPU against f32 on the CPU, on the card (TF32 off, as
    # '32-true' runs) and on the card with TF32 on.
    import copy

    rp = importlib.import_module(f"{PKG}.models.resnet_pose")
    pl = importlib.import_module(f"{PKG}.losses.pose_loss")

    def raw_grad(model, x, t, tf32=False):
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=tf32):
            pl.pose_loss(model(x), t).backward()
        return torch.cat([p.grad.flatten().double().cpu()
                          for p in model.parameters()])

    for hw in (64, 128):
        x = batch["input"][:, :, :hw, :hw].contiguous()
        t = batch["target"]
        base = rp.build_pose_model(dropout=False, device="cpu").train()
        f64 = copy.deepcopy(base).double()
        f64.dtype = torch.float64
        ref = raw_grad(f64, x.double(), t)
        d = {name: ((raw_grad(copy.deepcopy(base).to(dev), x.to(dev),
                              t.to(dev), tf32) - ref).norm()
                    / ref.norm()).item()
             for name, dev, tf32 in (("CPU f32", "cpu", False),
                                     ("card TF32 off", "cuda", False),
                                     ("card TF32 on", "cuda", True))}
        print(f"pose gradient at {hw} px against f64 on the CPU, rel. norm: "
              + ", ".join(f"{k} {v:.2e}" for k, v in d.items()))
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-2 and stats_ok
            and param_max <= 2.0 * lr0 * 1.01 + 1e-7
            and flipped <= 0.01 * total and pred_err <= 1e-3):
        raise AssertionError("pose parity: the card's step is outside its "
                             "tolerance of the CPU's")


# ---------------------------------------------------------- reconstruction

# A synthetic colon at SimCol's frame size: a cylinder of radius 1 m seen
# from its axis (tests/test_recon_geometric.py), 64 frames stepping along
# it; cut from a procedure's 601-1201 frames.
RECON_FRAMES = 64
RECON_STEP = 0.05       # m between camera positions along the axis
RECON_CAM = (156.0, 156.0, 237.0, 237.0)  # fx, fy, cx, cy
R_CYL = 1.0
MESH_DEPTH = 9          # 512^3, the reference's Poisson depth
VOXEL = 0.01


def _cylinder_tree(tmp: str) -> str:
    """SyntheticColon_I/Frames_S1 (RGB frames), Frames_S1_OP (exact
    z-depth of the cylinder as 16-bit mm PNGs), the poses (identity
    orientation, positions along the axis) and a ``cam.txt``."""
    import os

    import numpy as np

    imageio = importlib.import_module(f"{PKG}.media.imageio")
    fx, fy, cx, cy = RECON_CAM
    root = os.path.join(tmp, "cylinder")
    colon = os.path.join(root, "SyntheticColon_I")
    frames, op = (os.path.join(colon, d) for d in ("Frames_S1",
                                                   "Frames_S1_OP"))
    os.makedirs(frames)
    os.makedirs(op)
    v, u = np.mgrid[0:FRAME_HW[0], 0:FRAME_HW[1]].astype(np.float64)
    radial = np.maximum(np.hypot((u - cx) / fx, (v - cy) / fy), 1e-6)
    # Rounded to the millimetre: the points then lie within 0.5 mm x
    # radial (<= 2.15 at the corners) of the surface.
    depth_mm = np.round(np.clip(R_CYL / radial * 1000.0, 0, 65535)).astype(
        np.uint16)
    rng = np.random.default_rng(51)
    for i in range(RECON_FRAMES):
        imageio.write_png(os.path.join(frames, f"FrameBuffer_{i:04d}.png"),
                          rng.integers(0, 256, (*FRAME_HW, 3),
                                       dtype=np.uint8))
        imageio.write_png(os.path.join(op, f"Depth_{i:04d}.png"), depth_mm)
    z = np.arange(RECON_FRAMES) * RECON_STEP
    np.savetxt(os.path.join(colon, "SavedPosition_S1.txt"),
               np.stack([0 * z, 0 * z, z], axis=1))
    np.savetxt(os.path.join(colon, "SavedRotationQuaternion_S1.txt"),
               np.tile([0.0, 0.0, 0.0, 1.0], (RECON_FRAMES, 1)))
    np.savetxt(os.path.join(colon, "cam.txt"),
               np.array([[fx, 0, cx, 0, fy, cy, 0, 0, 1]]))
    return root


def _mesh_distances(a, b):
    """Largest distance from a vertex of ``a`` to ``b`` and back."""
    from scipy.spatial import cKDTree

    return (float(cKDTree(b).query(a)[0].max()),
            float(cKDTree(a).query(b)[0].max()))


def phase_recon(tmp: str, smi: str) -> dict[str, int]:
    """(a) ``cli.pointcloud.main`` at the reference's size on the card:
    64 frames of 475x475 of a synthetic colon, ``--mesh-depth 9`` (512^3)
    and ``--voxel-size 0.01``. The fused points lie on the cylinder, the
    mesh is a tube of radius ~1 (the JAX package's geometric rule), and
    the card's mesh matches the CPU's mesh of the same points (vertex
    counts within 1%, every vertex within 0.05 of a grid spacing of the
    other mesh, both ways). Prints the stages, device work on the card's
    clock. No kernel of the port runs. Returns the launches."""
    import os

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    pointcloud = importlib.import_module(f"{PKG}.cli.pointcloud")
    recon = importlib.import_module(f"{PKG}.recon")
    rnative = importlib.import_module(f"{PKG}.recon.native")
    poisson = importlib.import_module(f"{PKG}.recon.poisson")

    t0 = time.perf_counter()
    root = _cylinder_tree(tmp)
    tree_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    _video_counts(fa, rz, zero=True)
    # Twice: the first run pays cuFFT's plans and the first launches of
    # every kernel it uses, as a user's single run does; the second shows
    # the steady stage times. Both outputs must be equal.
    runs = []
    for i in range(2):
        out = os.path.join(tmp, f"recon_out{i}")
        result, _ = _captured(pointcloud.main, [
            "-i", root, "-o", out, "--mesh-depth", str(MESH_DEPTH),
            "--voxel-size", str(VOXEL)])
        runs.append(result)
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grid = 1 << MESH_DEPTH
    for name in ("combined_point_cloud.ply", "combined_mesh.ply"):
        with open(os.path.join(tmp, "recon_out0", name), "rb") as f0, \
                open(os.path.join(out, name), "rb") as f1:
            if f0.read() != f1.read():
                raise AssertionError(f"recon (a): two runs wrote two {name}")
    print(f"recon (a) pointcloud, {RECON_FRAMES} frames of {FRAME_HW}, "
          f"voxel {VOXEL} m, mesh depth {MESH_DEPTH} ({grid}^3), {smi}: "
          f"{result['points_before']} points before the voxel grid, "
          f"{result['points_after']} after; {result['verts']} vertices, "
          f"{result['tris']} triangles (both runs' files byte-equal); "
          f"main() {runs[0]['seconds']:.2f} s cold, {result['seconds']:.2f} "
          f"s warm (tree written in {tree_s:.2f} s before); peak device "
          f"memory {peak:.2f} GiB ({held:.2f} GiB held before); launches "
          f"over both runs {counts}")
    print(f"  cuts: {RECON_FRAMES} frames of a procedure's 601-1201, "
          f"{RECON_STEP} m apart on a straight path with one orientation; "
          "exact depth of a cylinder in place of a model's, rounded to the "
          "mm; random colour; voxel size and Poisson depth the reference's")
    host = ("normals", "readback", "mesher", "prune")
    for label, run in (("cold", runs[0]), ("warm", result)):
        stages = run["stages"]
        print(f"  {label}: backprojection "
              f"{stages['backprojection'] / RECON_FRAMES:.4f} ms/frame "
              "(card); " + "; ".join(
                  f"{k} {v:.2f} ms ({'host' if k in host else 'card'})"
                  for k, v in stages.items() if k != "backprojection"))
    if counts != _want():
        raise AssertionError(f"recon (a): launches {counts}")

    pc = recon.read_ply(os.path.join(out, "combined_point_cloud.ply"))
    points = pc["points"]
    radii = np.hypot(points[:, 0], points[:, 1])
    r_err = float(np.abs(radii - R_CYL).max())
    mesh = recon.read_ply(os.path.join(out, "combined_mesh.ply"))
    verts = mesh["points"]
    z = points[:, 2]
    zmid = (verts[:, 2] > z.min() + 1.0) & (verts[:, 2] < z.max() - 1.0)
    med = float(np.median(np.hypot(verts[zmid, 0], verts[zmid, 1])))
    print(f"  fused points' radius within {r_err:.5f} m of {R_CYL} "
          f"(tolerance 2e-3); mesh median radius {med:.5f} m over "
          f"{int(zmid.sum())} interior vertices (tolerance 0.12)")
    if not (r_err <= 2e-3 and zmid.sum() > 100
            and abs(med - R_CYL) < 0.12):
        raise AssertionError("recon (a): the cylinder is not reconstructed")

    # The CPU's mesh of the same points: normals as main() takes them.
    normals = rnative.estimate_normals(
        points, radius=0.1, max_nn=30,
        orient_toward=points.mean(axis=0).astype(np.float32))
    t0 = time.perf_counter()
    cv, _ = poisson.poisson_mesh(points, -normals, grid_depth=MESH_DEPTH,
                                 density_percentile=5.0, device="cpu")
    cpu_s = time.perf_counter() - t0
    extent = float((points.max(0) - points.min(0)).max()) * 1.1
    spacing = extent / (grid - 1)
    d_gc, d_cg = _mesh_distances(verts, cv)
    print(f"  card mesh vs the CPU's ({cpu_s:.2f} s on the host): "
          f"{len(verts)} vs {len(cv)} vertices; largest distance card->CPU "
          f"{d_gc / spacing:.4f}, CPU->card {d_cg / spacing:.4f} grid "
          f"spacings (tolerance 0.05; spacing {spacing * 1e3:.3f} mm)")
    if not (abs(len(verts) - len(cv)) <= 0.01 * len(cv)
            and max(d_gc, d_cg) <= 0.05 * spacing):
        raise AssertionError("recon (a): the card's mesh is not the CPU's")
    return counts


def phase_recon_model(root: str, plain, f32, tmp: str, smi: str
                      ) -> dict[str, int]:
    """(b) ``cli.pointcloud_model.main --encoder vitl`` at 518 px on the
    infer CLI phase's 32 frames: K1 24 launches a frame, all others 0;
    every per-frame cloud no further from the plain f32 model's cloud
    than 1.5x the plain bf16 model's (``plain``, ``f32``: that phase's
    maps of the same seeded weights)."""
    import glob
    import os

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    pcm = importlib.import_module(f"{PKG}.cli.pointcloud_model")
    recon = importlib.import_module(f"{PKG}.recon")

    # A view of the tree holding its 32 frames under distinct names: the
    # glob of pointcloud_model (Frames_*/FrameBuffer_*.png, the
    # reference's) would also take the infer phase's renderings in
    # Frames_*_OP, and it writes one PLY per frame name, so the two
    # procedures' FrameBuffer_0000 would share one file.
    paths = sorted(glob.glob(os.path.join(
        root, "SyntheticColon_I", "Frames_S[12]", "FrameBuffer_*.png")))
    view = os.path.join(tmp, "view_model")
    os.makedirs(os.path.join(view, "SyntheticColon_I", "Frames_S1"))
    os.symlink(os.path.join(root, "UnityCam"), os.path.join(view,
                                                            "UnityCam"))
    names = []
    for i, path in enumerate(paths):
        names.append(f"FrameBuffer_{i:04d}")
        os.symlink(path, os.path.join(view, "SyntheticColon_I", "Frames_S1",
                                      names[-1] + ".png"))
    out = os.path.join(tmp, "clouds")
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    result, _ = _captured(pcm.main, ["--encoder", "vitl", "-i", view,
                                     "-o", out])
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    want = _want(K1=BLOCKS * CLI_FRAMES, K6=K6_VITL * CLI_FRAMES)
    print(f"recon (b) pointcloud_model (vitl, 518 px), {result['frames']} "
          f"frames of {FRAME_HW}: {result['seconds']:.2f} s through main() "
          f"(model init, decode, one frame at a time, back-projection, PLY "
          f"writes): {result['frames'] / result['seconds']:.2f} frames/s; "
          f"in infer_image {result['model_seconds']:.2f} s; {smi}; "
          f"launches {counts} (want {want})")
    if counts != want or result["frames"] != CLI_FRAMES:
        raise AssertionError(f"recon (b): launches {counts}, want {want}")

    cam = recon.load_intrinsics(os.path.join(root, "UnityCam", "cam.txt"))

    def cloud(depth):
        pts, _, valid = recon.backproject_depth(
            torch.from_numpy(depth).cuda(), *cam, depth_scale=1.0,
            depth_trunc=21.0)
        return pts[valid].cpu().numpy()

    d_kf, d_pf = [], []
    for i, (p, name) in enumerate(zip(paths, names)):
        got = recon.read_ply(os.path.join(out, name + ".ply"))["points"]
        ref, yard = cloud(f32[i]), cloud(plain[i])
        if got.shape != ref.shape:
            raise AssertionError(f"recon (b): {p}: {got.shape} points, "
                                 f"want {ref.shape}")
        d_kf.append(np.linalg.norm(got - ref, axis=1).mean())
        d_pf.append(np.linalg.norm(yard - ref, axis=1).mean())
    print(f"  clouds vs plain f32: mean {np.mean(d_kf):.5f} m (plain bf16 "
          f"vs f32: {np.mean(d_pf):.5f} m; rule: at most 1.5x)")
    if not np.mean(d_kf) <= 1.5 * np.mean(d_pf):
        raise AssertionError("recon (b): clouds further from f32 than the "
                             "plain bf16 model allows")
    return counts


def _same(label: str, card, cpu, rtol: float = 1e-6) -> None:
    """Card and CPU results (nested dicts of floats or arrays) equal to
    ``rtol``: the card sums in other orders."""
    import numpy as np

    if isinstance(cpu, dict):
        if set(card) != set(cpu):
            raise AssertionError(f"{label}: keys {set(card)} vs {set(cpu)}")
        for k in cpu:
            _same(f"{label}/{k}", card[k], cpu[k], rtol)
        return
    if not np.allclose(card, cpu, rtol=rtol, atol=1e-9, equal_nan=True):
        raise AssertionError(f"{label}: card {card} vs CPU {cpu}")


def phase_recon_tools(root: str, tmp: str, smi: str) -> None:
    """(c) The offline tools on the infer CLI phase's tree, each on the
    card and on the CPU: ``eval_depth_offline --no-strict`` on its
    colourised side-by-side renderings (as Frames_S5/S10 of a view of
    the tree), ``calc_metrics`` on its ``.npy`` maps written as 16-bit
    mm PNGs, ``calc_stats`` on its training split at 518 px; and
    ``video_to_images`` on the video phase's AVI (frames byte-equal to the
    stored JPEGs)."""
    import glob
    import os

    import numpy as np

    imageio = importlib.import_module(f"{PKG}.media.imageio")
    native = importlib.import_module(f"{PKG}.media.native")
    tools = {name: importlib.import_module(f"{PKG}.cli.{name}")
             for name in ("eval_depth_offline", "calc_metrics", "calc_stats",
                          "video_to_images")}
    colon = os.path.join(root, "SyntheticColon_I")
    view_eval = os.path.join(tmp, "view_eval", "SyntheticColon_I")
    view_cm = os.path.join(tmp, "view_metrics", "SyntheticColon_I")
    for src, dst in (("S1", "S5"), ("S2", "S10")):
        os.makedirs(view_eval, exist_ok=True)
        os.symlink(os.path.join(colon, f"Frames_{src}"),
                   os.path.join(view_eval, f"Frames_{dst}"))
        os.symlink(os.path.join(colon, f"Frames_{src}_OP"),
                   os.path.join(view_eval, f"Frames_{dst}_OP"))
        # calc_metrics' view: the ground truth's Depth_*.png, and the
        # infer phase's maps as 16-bit mm PNGs of the same names.
        for sub in (f"Frames_{src}", f"Frames_{src}_OP"):
            os.makedirs(os.path.join(view_cm, sub))
        for npy in glob.glob(os.path.join(colon, f"Frames_{src}_OP",
                                          "FrameBuffer_*.npy")):
            mm = np.clip(np.load(npy) * 1000.0, 0, 65535).astype(np.uint16)
            name = os.path.basename(npy)[:-4].replace("FrameBuffer",
                                                      "Depth") + ".png"
            os.symlink(os.path.join(colon, f"Frames_{src}", name),
                       os.path.join(view_cm, f"Frames_{src}", name))
            imageio.write_png(os.path.join(view_cm, f"Frames_{src}_OP",
                                           name), mm)

    runs = {
        "eval_depth_offline": ["--input-path", os.path.dirname(view_eval),
                               "--no-strict"],
        "calc_metrics": ["--dataset-root", os.path.dirname(view_cm)],
        "calc_stats": ["--data-dir", root, "--train-list",
                       os.path.join(root, "train.txt"), "--size", "518",
                       "--batch-size", str(BATCH)],
    }
    results = {}
    for name, args in runs.items():
        t0 = time.perf_counter()
        card, _ = _captured(tools[name].main, args)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, _ = _captured(tools[name].main, args + ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        _same(f"recon (c) {name}", card, cpu)
        results[name] = card
        print(f"recon (c) {name}: card {card_s:.2f} s, CPU {cpu_s:.2f} s "
              f"through main() ({smi}); results equal within 1e-6 relative")
    evaluated = [k for k in results["eval_depth_offline"] if k != "overall"]
    if (len(evaluated) != 2 or "overall" not in results["calc_metrics"]
            or not results["calc_stats"]["valid_px"]):
        raise AssertionError(f"recon (c): tools evaluated too little: "
                             f"{results}")

    avi = os.path.join(tmp, "in.avi")
    _video_input(avi, seed=5)  # the video phase's AVI, byte for byte
    frames_dir = os.path.join(tmp, "frames")
    n, _ = _captured(tools["video_to_images"].main,
                     ["--video_path", avi, "--output_dir", frames_dir])
    with native.VideoReader(avi) as r:
        same = n == r.num_frames == VIDEO_FRAMES and all(
            open(os.path.join(frames_dir, f"frame_{i:04d}.jpg"), "rb").read()
            == r.frame_bytes(i) for i in range(n))
    print(f"recon (c) video_to_images: {n} frames, byte-equal to the "
          f"stored JPEGs: {same}")
    if not same:
        raise AssertionError("recon (c): video_to_images frames differ")


# ------------------------------------------------------- the speed dials

QUANT_SRC = f"{PKG}/csrc/quant.cu"
JAX_QUANT = f"{JAX_PKG}/ops/quant.py"
M_TOKENS = BATCH * 1370   # vitl, batch 8, 518 px: token rows of a GEMM
LONG_ROW = 8192           # > csrc/quant.cu kShortMax: Q1's two-pass rows
# The encoder's int8 sites at vitl: (name, N, K) of x (M, K) @ w (N, K)^T.
ENC_SITES = [("qkv", 3072, 1024), ("proj", 1024, 1024),
             ("fc1", 4096, 1024), ("fc2", 1024, 4096)]
# The decoder's convs with both widths >= 128 at vitl (the JAX package's
# QConv gate): projects 0-3, the stride-2 resize, layer1-4_rn, the
# fusion blocks' 3 + 5 + 5 + 5 convs and output_conv1.
DPT_SITES = 4 + 1 + 4 + 3 + 3 * 5 + 1
# Two decoder convs at vitl, batch 8: the widest (the stride-2 resize,
# 1024 -> 1024 at 37x37) and the largest (output_conv1, 256 -> 128 at
# 296x296): (name, (B, H, W, C), Cout, stride).
DPT_CONVS = [("resize_3", (BATCH, 37, 37, 1024), 1024, 2),
             ("output_conv1", (BATCH, 296, 296, 256), 128, 1)]
DIAL_FLAGS = {"int8": ["--int8"], "int8 static K=2": ["--int8",
                                                      "--int8-calib", "2"],
              "merge 0.3": ["--token-merge", "0.3"],
              "int8 + merge 0.3": ["--int8", "--token-merge", "0.3"]}
# A dial's maps are held to the JAX package's bound on their mean relative
# distance from the plain f32 model's (int8 0.1, tests/test_quant_int8.py;
# merging and both 0.5, tests/test_token_merge.py, test_quant_int8.py)
# unless the plain bf16 model's own distance exceeds a tenth of it; then
# to DIAL_MULTIPLE times that distance (fixed in PERF.md before the first
# card run: random vitl weights amplify rounding).
DIAL_BOUND = {"int8": 0.1, "int8 static K=2": 0.1, "merge 0.3": 0.5,
              "int8 + merge 0.3": 0.5}
DIAL_MULTIPLE = 25.0


def _rel(maps, ref) -> float:
    import numpy as np

    return float(np.abs(maps - ref).mean() / np.abs(ref).mean())


def _site_launches(dial: str) -> dict[str, int]:
    """Per batch of 8 under the auto scope (all at batch 8): K1 once a
    block, K6 once a decoder resize; Q2 once a site, Q1 twice
    (activations and weights)."""
    sites = 24 * 4 + DPT_SITES if dial.startswith("int8") else 0
    return _want(K1=BLOCKS, K6=K6_VITL, Q1=2 * sites, Q2=sites)


def phase_quant_kernels(smi: str) -> tuple[dict, dict]:
    """Q1 and Q2 at vitl's int8 sites (batch 8, 518 px) against their
    plain versions, bit for bit; torch._int_mm against the CPU's and in
    both operand layouts; the tap form of the int8 conv against the f64
    plain one; times of each pass beside the bf16 cuBLAS GEMM or cuDNN
    conv it replaces. Returns the kernels' records."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    quant = importlib.import_module(f"{PKG}.ops.quant")
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = {"Q1": 0.0, "Q2": 0.0}
    q1_sites, q2_sites = {}, {}

    def same(name, got, want):
        d = (got.float() - want.float()).abs().max().item()
        worst[name] = max(worst[name], d)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {d}")

    def q1_bytes(r, k, size):
        return r * k * size + r * k + r * 4

    print(f"speed-dial kernels, vitl batch {BATCH} 518 px ({smi}):")
    for site, n, k in ENC_SITES:
        x = (torch.randn((M_TOKENS, k), generator=gen, device="cuda")
             * 3).bfloat16()
        w = torch.randn((n, k), generator=gen, device="cuda") / k ** 0.5
        bias = torch.randn(n, generator=gen, device="cuda")
        xq, xs = quant.quantize_int8(x)
        same("Q1", xq, quant.quantize_int8_reference(x)[0])
        same("Q1", xs, quant.quantize_int8_reference(x)[1])
        given = torch.tensor([4.0 / 127], device="cuda")
        same("Q1", quant.quantize_int8(x, given)[0],
             quant.quantize_int8_reference(x, given)[0])
        wq, ws = quant.quantize_int8(w)
        same("Q1", wq, quant.quantize_int8_reference(w)[0])
        same("Q1", ws, quant.quantize_int8_reference(w)[1])
        acc = quant.int_mm(xq, wq.t())
        wkn = wq.t().contiguous()  # the same operand, row-major (K, N)
        copy = quant.int_mm(xq, wkn)
        cpu = torch._int_mm(xq[:512].cpu(), wq.cpu().t())
        if not (torch.equal(acc, copy) and torch.equal(acc[:512].cpu(), cpu)):
            raise AssertionError(f"_int_mm [{site}]: the card's int32 "
                                 "product differs from the CPU's or between "
                                 "operand layouts")
        cast_first = site in ("qkv", "proj")
        out = quant.dequantize_int32(acc, xs, ws, bias, torch.bfloat16,
                                     cast_first)
        same("Q2", out, quant.dequantize_int32_reference(
            acc, xs, ws, bias, torch.bfloat16, cast_first))
        wb = w.bfloat16()
        # The same bytes as rows of LONG_ROW elements take Q1's two-pass
        # long-row kernels: what the one-block-per-row kernel is held to.
        x_long = x.view(-1, LONG_ROW)
        t = {
            "Q1": _cuda_ms(lambda: quant.quantize_int8(x), 20),
            "Q1 two-pass": _cuda_ms(lambda: quant.quantize_int8(x_long), 20),
            "Q1 plain": _cuda_ms(lambda: quant.quantize_int8_reference(x), 5),
            "Q1 weight": _cuda_ms(lambda: quant.quantize_int8(w), 20),
            "int_mm": _cuda_ms(lambda: torch._int_mm(xq, wq.t()), 20),
            "int_mm (K, N)": _cuda_ms(lambda: torch._int_mm(xq, wkn), 20),
            "bf16 GEMM": _cuda_ms(lambda: torch.mm(x, wb.t()), 20),
            "Q2": _cuda_ms(lambda: quant.dequantize_int32(
                acc, xs, ws, bias, torch.bfloat16, cast_first), 20),
            "Q2 plain": _cuda_ms(lambda: quant.dequantize_int32_reference(
                acc, xs, ws, bias, torch.bfloat16, cast_first), 5),
        }
        b1 = q1_bytes(M_TOKENS, k, 2) / PEAK_BYTES * 1e3
        b2 = (M_TOKENS * n * 6 + M_TOKENS * 4 + n * 8) / PEAK_BYTES * 1e3
        ops = 2 * M_TOKENS * n * k
        q1_sites[f"{site} input ({M_TOKENS}, {k}) bf16"] = {
            "ms": t["Q1"], "plain_ms": t["Q1 plain"], "bound_ms": b1}
        q2_sites[f"{site} output ({M_TOKENS}, {n}) -> bf16"] = {
            "ms": t["Q2"], "plain_ms": t["Q2 plain"], "bound_ms": b2}
        print(f"  [{site}] ({M_TOKENS}, {k}) x ({k}, {n}): Q1 {t['Q1']:.4f} "
              f"ms (bound {b1:.4f}, plain {t['Q1 plain']:.4f}; the same "
              f"bytes as {tuple(x_long.shape)} rows on the two-pass "
              f"kernels {t['Q1 two-pass']:.4f}), weight Q1 "
              f"{t['Q1 weight']:.4f}; _int_mm {t['int_mm']:.4f} ms "
              f"({ops / t['int_mm'] / 1e9:.1f} TOP/s; with a row-major "
              f"(K, N) mat2 {t['int_mm (K, N)']:.4f}), bf16 "
              f"GEMM {t['bf16 GEMM']:.4f} ms ({ops / t['bf16 GEMM'] / 1e9:.1f}"
              f" TFLOP/s); Q2 {t['Q2']:.4f} ms (bound {b2:.4f}, plain "
              f"{t['Q2 plain']:.4f}); W8A8 total "
              f"{t['Q1'] + t['Q1 weight'] + t['int_mm'] + t['Q2']:.4f} ms "
              f"against bf16 {t['bf16 GEMM']:.4f}")
        del x, x_long, w, xq, wq, wkn, acc, copy, out

    for site, (b, h, w_, c), cout, stride in DPT_CONVS:
        x = torch.randn((b, c, h, w_), generator=gen, device="cuda").to(
            torch.bfloat16, memory_format=torch.channels_last)
        wt = torch.randn((cout, c, 3, 3), generator=gen,
                         device="cuda") / (9 * c) ** 0.5
        bias = torch.randn(cout, generator=gen, device="cuda")
        rows = x.permute(0, 2, 3, 1).reshape(b, -1)
        xq, xs = quant.quantize_int8(rows)
        same("Q1", xq, quant.quantize_int8_reference(rows)[0])
        same("Q1", xs, quant.quantize_int8_reference(rows)[1])
        wq, ws = quant.quantize_int8(
            wt.permute(0, 2, 3, 1).reshape(cout, -1).contiguous())
        xq4, wq4 = xq.view(b, h, w_, c), wq.view(cout, 3, 3, c)
        acc = quant.conv_acc(xq4, wq4, stride, 1)
        if not torch.equal(acc, quant.conv_acc_reference(xq4, wq4, stride,
                                                         1)):
            raise AssertionError(f"int8 conv [{site}]: the int32 "
                                 "accumulator differs from the f64 plain one")
        out = quant.dequantize_int32(acc, xs, ws, bias, torch.bfloat16)
        same("Q2", out, quant.dequantize_int32_reference(
            acc, xs, ws, bias, torch.bfloat16))
        wb, bb = wt.bfloat16(), bias.bfloat16()
        t = {
            "Q1": _cuda_ms(lambda: quant.quantize_int8(rows), 10),
            "Q1 plain": _cuda_ms(lambda: quant.quantize_int8_reference(rows),
                                 3),
            "taps": _cuda_ms(lambda: quant.conv_acc(xq4, wq4, stride, 1), 5),
            "Q2": _cuda_ms(lambda: quant.dequantize_int32(
                acc, xs, ws, bias, torch.bfloat16), 10),
            "Q2 plain": _cuda_ms(lambda: quant.dequantize_int32_reference(
                acc, xs, ws, bias, torch.bfloat16), 3),
            "int8 conv": _cuda_ms(lambda: quant.int8_conv(
                x, wt, bias, stride, 1), 5),
            "cuDNN bf16": _cuda_ms(lambda: F.conv2d(x, wb, bb, stride, 1), 10),
        }
        ho, wo = acc.shape[1:3]
        b1 = q1_bytes(b, h * w_ * c, 2) / PEAK_BYTES * 1e3
        b2 = (b * ho * wo * cout * 6) / PEAK_BYTES * 1e3
        q1_sites[f"{site} per-image rows ({b}, {h * w_ * c}) bf16"] = {
            "ms": t["Q1"], "plain_ms": t["Q1 plain"], "bound_ms": b1}
        q2_sites[f"{site} output ({b}, {ho}, {wo}, {cout}) -> bf16"] = {
            "ms": t["Q2"], "plain_ms": t["Q2 plain"], "bound_ms": b2}
        print(f"  [DPT {site}] ({b}, {c}, {h}, {w_}) -> {cout}, 3x3, stride "
              f"{stride}: Q1 {t['Q1']:.4f} ms (bound {b1:.4f}, plain "
              f"{t['Q1 plain']:.4f}); 9 tap _int_mm summed in int32 "
              f"{t['taps']:.4f} ms; Q2 {t['Q2']:.4f} ms (bound {b2:.4f}, "
              f"plain {t['Q2 plain']:.4f}); the whole int8 conv "
              f"{t['int8 conv']:.4f} ms against cuDNN bf16 "
              f"{t['cuDNN bf16']:.4f} ms")
        del x, rows, xq, acc, out

    # The accumulators against the CPU's: a fusion-block conv of 2 images.
    xq = torch.randint(-127, 128, (2, 37, 37, 256), generator=gen,
                       device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (256, 3, 3, 256), generator=gen,
                       device="cuda", dtype=torch.int8)
    if not torch.equal(quant.conv_acc(xq, wq, 1, 1).cpu(),
                       quant.conv_acc_reference(xq.cpu(), wq.cpu(), 1, 1)):
        raise AssertionError("int8 conv: the card's int32 accumulator "
                             "differs from the CPU's")
    print("  bit for bit: Q1 and Q2 against their plain versions at every "
          "site above; _int_mm against the CPU's and in both layouts; the "
          "tap convs against the f64 plain conv (and the CPU's)")
    torch.cuda.empty_cache()
    head_q1 = q1_sites[f"fc2 input ({M_TOKENS}, 4096) bf16"]
    head_q2 = q2_sites[f"fc1 output ({M_TOKENS}, 4096) -> bf16"]
    records = {}
    for name, kernel, line, head, by_site in (
            ("Q1", "quantize_rows_kernel (row_absmax_kernel + "
             "quantize_long_kernel for rows over 4096)", 76, head_q1,
             q1_sites),
            ("Q2", "dequant_kernel", 177, head_q2, q2_sites)):
        records[name] = {
            "name": f"{name} {kernel}", "route": "cuda",
            "source": QUANT_SRC, "replaces": f"{JAX_QUANT}:{line}",
            "launches": 0, "max_abs_err": worst[name],
            "ms": round(head["ms"], 4), "plain_ms": round(head["plain_ms"], 4),
            "bound_ms": round(head["bound_ms"], 4), "bound_by": "bytes",
            "library_ms": None,
            "by_site": {k: {kk: round(vv, 4) for kk, vv in v.items()}
                        for k, v in by_site.items()}}
    return records["Q1"], records["Q2"]


def phase_dials(model, frames, cli_paths, cli_plain, cli_f32, tmp: str,
                smi: str) -> dict[str, dict[str, int]]:
    """The speed dials at vitl, 518 px, batch 8, through BatchedRunner,
    DepthServingEngine and cli.infer.main: dynamic int8, static int8
    (K = 2), token merging at 0.3 and int8 with merging. Launches per
    batch, each dial's maps against the plain f32 model (the rule of
    DIAL_BOUND), device ms per batch, the auto scope at batch 8 and 64,
    the engine's calibration of a held single batch, and the merged
    forward repeated bit for bit. Returns the launches by path."""
    import os
    import shutil

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    quant = importlib.import_module(f"{PKG}.ops.quant")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    engine_mod = importlib.import_module(f"{PKG}.serving.engine")
    infer = importlib.import_module(f"{PKG}.cli.infer")

    sd = model.state_dict()

    def dial_model(**kw):
        m = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                 seed=0, **kw)
        m.load_state_dict(sd)
        return m

    models = {"int8": dial_model(quant_int8=True),
              "merge 0.3": dial_model(token_merge=0.3),
              "int8 + merge 0.3": dial_model(quant_int8=True,
                                             token_merge=0.3)}
    models["int8 static K=2"] = models["int8"]
    batch = frames[:BATCH]
    plain, f32 = _plain_maps(model, batch)
    bf16_rel = _rel(plain, f32)
    x = torch.from_numpy(np.stack(batch)).cuda()
    base_runner = da.BatchedRunner(model, FRAME_HW, 518, BATCH)
    default = np.stack(base_runner(batch))
    net_hw = base_runner.net_hw
    dev_ms = {"default": _cuda_ms(lambda: da._run_batched_u8(
        model, x, net_hw, FRAME_HW), iters=10, warmup=2)}

    def kernel_ms(fn, dial):
        """Kernel time per forward (torch.profiler over 3): the device's
        share of the CUDA-event time, whose rest is the host's launches."""
        events = _profiled(fn, 3, f"dial [{dial}], vitl batch {BATCH} "
                           "forward")
        return sum(e.self_device_time_total for e in events) / 3 / 1e3

    busy_ms = {"default": kernel_ms(lambda: da._run_batched_u8(
        model, x, net_hw, FRAME_HW), "none")}
    counts_by_path = {}
    print(f"speed dials, vitl 518 px, batch {BATCH}, the serve phase's "
          f"frames ({smi}); plain bf16 vs plain f32: mean relative "
          f"distance {bf16_rel:.5f}; default device forward "
          f"{dev_ms['default']:.2f} ms/batch "
          f"({BATCH / dev_ms['default'] * 1e3:.2f} frames/s)")
    rule = {}
    for dial in DIAL_FLAGS:
        bound = DIAL_BOUND[dial]
        rule[dial] = (bound if bf16_rel <= bound / 10
                      else DIAL_MULTIPLE * bf16_rel)
    for dial, m in models.items():
        calib = dial == "int8 static K=2"
        runner = (da.BatchedRunner(m, FRAME_HW, 518, BATCH,
                                   calib_frames=frames[:2 * BATCH],
                                   calib_batches=2) if calib
                  else da.BatchedRunner(m, FRAME_HW, 518, BATCH))
        torch.cuda.synchronize()
        _video_counts(fa, rz, zero=True)
        maps = np.stack(runner(batch))
        torch.cuda.synchronize()
        counts = _video_counts(fa, rz)
        counts_by_path[f"dials_runner[{dial}]"] = counts
        want = _site_launches(dial)
        _check_maps(list(maps))
        rel = _rel(maps, f32)
        if calib:
            def fwd():
                with quant.frozen_scales(runner.amax):
                    return da._run_batched_u8(m, x, net_hw, FRAME_HW)
        else:
            def fwd():
                return da._run_batched_u8(m, x, net_hw, FRAME_HW)
        dev_ms[dial] = _cuda_ms(fwd, iters=10, warmup=2)
        busy_ms[dial] = kernel_ms(fwd, dial)
        repeat = ""
        if "merge" in dial:
            again = np.stack(runner(batch))
            if not np.array_equal(again, maps):
                raise AssertionError(f"dials [{dial}]: the merged forward "
                                     "does not repeat bit for bit")
            repeat = "; repeats bit for bit"
        print(f"  [{dial}] BatchedRunner: device {dev_ms[dial]:.2f} ms/batch"
              f" ({BATCH / dev_ms[dial] * 1e3:.2f} frames/s, "
              f"{dev_ms[dial] / dev_ms['default']:.3f}x default); maps vs "
              f"plain f32: mean relative distance {rel:.5f} (held < "
              f"{rule[dial]:.5f}), vs default mean "
              f"{np.abs(maps - default).mean():.5f} m; launches {counts} "
              f"(want {want}){repeat}")
        if counts != want or rel >= rule[dial] \
                or np.array_equal(maps, default):
            raise AssertionError(f"dials [{dial}]: launches {counts}, want "
                                 f"{want}; relative distance {rel}")

    print("  per batch of 8, CUDA-event ms (kernel ms by the profiler): "
          + ", ".join(f"{k} {dev_ms[k]:.2f} ({busy_ms[k]:.2f})"
                      for k in dev_ms))

    # The auto scope: all at batch 8, mlp at batch 64; the card's times
    # under each scope.
    m8 = models["int8"]
    big = (frames * 3)[:64]
    x64 = torch.from_numpy(np.stack(big)).cuda()
    runner64 = da.BatchedRunner(m8, FRAME_HW, 518, 64)
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    _check_maps(runner64(big))
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    sites64 = 24 * 2 + DPT_SITES
    want = _want(K1=BLOCKS, K6=K6_VITL, Q1=2 * sites64, Q2=sites64)
    if counts != want:
        raise AssertionError(f"dials: auto scope at batch 64 launched "
                             f"{counts}, want {want} (mlp)")
    scope_ms = {}
    try:
        for scope in ("auto", "all", "mlp", "attn"):
            m8.pretrained.quant_scope = scope
            scope_ms[scope] = (
                _cuda_ms(lambda: da._run_batched_u8(m8, x, net_hw, FRAME_HW),
                         iters=10, warmup=2),
                _cuda_ms(lambda: da._run_batched_u8(m8, x64, net_hw,
                                                    FRAME_HW),
                         iters=3, warmup=1))
    finally:
        m8.pretrained.quant_scope = "auto"
    base64 = _cuda_ms(lambda: da._run_batched_u8(model, x64, net_hw,
                                                 FRAME_HW), iters=3, warmup=1)
    print(f"  int8 scope (device ms/batch at 8 and 64; default bf16 "
          f"{dev_ms['default']:.2f} and {base64:.2f}): "
          + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in
                      scope_ms.items())
          + f"; auto at 64 launched {counts} (scope mlp)")
    del runner64, x64
    torch.cuda.empty_cache()

    # DepthServingEngine with static calibration (K = 2) on the serve
    # frames, then a backlog of exactly one full batch, waited on
    # without close(): calibrated once the queue stays idle.
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    with engine_mod.DepthServingEngine(m8, batch_size=BATCH,
                                       calib_batches=2) as engine:
        maps = [f.result(timeout=600) for f in engine.submit_many(frames)]
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    stats = engine.stats()
    # Forwards, fixed in advance: the two calibration batches, then every
    # frame again in full batches through the frozen runner (the held
    # backlog is one served group, so the engine's batch count does not
    # give them). Calibrating twice or serving the backlog twice fails.
    runs = 2 + N_FRAMES // BATCH
    want = {k: v * runs for k, v in _site_launches("int8").items()}
    _check_maps(maps)
    counts_by_path["dials_engine"] = counts
    engine = engine_mod.DepthServingEngine(m8, batch_size=BATCH,
                                           calib_batches=2)
    try:
        t0 = time.perf_counter()
        one = [f.result(timeout=120)
               for f in engine.submit_many(frames[:BATCH])]
        waited = time.perf_counter() - t0
    finally:
        engine.close()
    _check_maps(one)
    print(f"  [int8 static K=2] DepthServingEngine: {len(maps)} frames in "
          f"{stats['batches']} batches, launches {counts} (want {want}); "
          f"a backlog of exactly one batch resolved in {waited:.2f} s "
          "without close()")
    if counts != want or stats["failed"]:
        raise AssertionError(f"dials engine: launches {counts}, want {want};"
                             f" stats {stats}")

    # cli.infer.main on the infer phase's 32 frames (flat copies, listed
    # in a text file), once per dial.
    indir = os.path.join(tmp, "dials_in")
    os.makedirs(indir)
    listed = []
    for p in cli_paths:
        name = f"{os.path.basename(os.path.dirname(p))}_{os.path.basename(p)}"
        listed.append(shutil.copy(p, os.path.join(indir, name)))
    lst = os.path.join(tmp, "dials.txt")
    with open(lst, "w", encoding="utf-8") as f:
        f.write("\n".join(listed) + "\n")
    cli_bf16 = _rel(cli_plain, cli_f32)
    cli_default = np.stack([np.load(os.path.join(
        os.path.dirname(p) + "_OP", os.path.basename(p)[:-4] + ".npy"))
        for p in cli_paths])  # the infer phase's own maps
    for dial, flags in DIAL_FLAGS.items():
        out = os.path.join(tmp, "dials_out_" + str(len(counts_by_path)))
        torch.cuda.synchronize()
        _video_counts(fa, rz, zero=True)
        result, _ = _captured(infer.main, [
            "-i", lst, "-o", out, "--encoder", "vitl", "--batch-size",
            str(BATCH), "--save-numpy"] + flags)
        torch.cuda.synchronize()
        counts = _video_counts(fa, rz)
        counts_by_path[f"dials_infer[{dial}]"] = counts
        runs = CLI_FRAMES // BATCH + (2 if "--int8-calib" in flags else 0)
        want = {k: v * runs for k, v in _site_launches(dial).items()}
        maps = np.stack([np.load(os.path.join(out, os.path.basename(p)[:-4]
                                              + ".npy")) for p in listed])
        _check_maps(list(maps))
        rel = _rel(maps, cli_f32)
        print(f"  [{dial}] infer CLI: {result['processed']} frames, "
              f"{CLI_FRAMES / result['seconds']:.2f} frames/s through main()"
              f"; maps vs plain f32 mean relative distance {rel:.5f} "
              f"(plain bf16 {cli_bf16:.5f}, held < {rule[dial]:.5f}); "
              f"launches {counts} (want {want})")
        if counts != want or rel >= rule[dial] \
                or result["processed"] != CLI_FRAMES \
                or np.array_equal(maps, cli_default):
            raise AssertionError(f"dials infer CLI [{dial}]: launches "
                                 f"{counts}, want {want}; relative "
                                 f"distance {rel}")
    del models, m8
    torch.cuda.empty_cache()
    return counts_by_path


# ------------------------------------------ the kernels as torch ops

# Each op, and the function its CUDA kernel runs: the launch as it was
# called before the kernels became ``torch.library`` ops.
OPS = (("ops.flash_attention", "_fwd_op", "_fwd_cuda"),
       ("ops.flash_attention", "_bwd_op", "_bwd_cuda"),
       ("ops.resize", "_lerp_op", "_lerp_cuda"),
       ("ops.quant", "_quantize_op", "_quantize_cuda"),
       ("ops.quant", "_dequantize_op", "_dequantize_cuda"))


class _DirectLaunches:
    """Route the public functions past the dispatcher, straight to the
    ops' CUDA kernels (the ``ctypes`` launches as they were called before
    the kernels were ops): the yardstick of the ops' host cost. The
    launches and their counts are the same; only the dispatch differs."""

    def __enter__(self):
        self.saved = []
        for mod, op, fn in OPS:
            m = importlib.import_module(f"{PKG}.{mod}")
            self.saved.append((m, op, getattr(m, op)))
            setattr(m, op, getattr(m, fn))

    def __exit__(self, *exc):
        for m, op, orig in self.saved:
            setattr(m, op, orig)


def phase_dispatch(smi: str) -> dict[str, float]:
    """Host microseconds a call of each op against its direct launch, at
    tiny shapes (the card keeps up, so the wall is the host's), in turns:
    direct, op, op, direct. Returns the op's extra microseconds by
    kernel."""
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    quant = importlib.import_module(f"{PKG}.ops.quant")
    q, k, v = _attention_case(1, 64, 2, 64, 7)
    o, lse = fa.flash_attention(q, k, v)
    gen = torch.Generator(device="cuda").manual_seed(8)
    x6 = torch.randn((1, 128, 8, 8), generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    rows = torch.randn((16, 256), generator=gen, device="cuda")
    acc = torch.randint(-99, 99, (16, 64), generator=gen, device="cuda",
                        dtype=torch.int32)
    xs, ws = torch.rand(16, device="cuda"), torch.rand(64, device="cuda")
    cases = {
        "K1": (fa._fwd_op, fa._fwd_cuda, (q, k, v, "K1")),
        "K2": (fa._bwd_op, fa._bwd_cuda, (q, k, v, o, lse, o, True)),
        "K6": (rz._lerp_op, rz._lerp_cuda, (x6, 9, 9)),
        "Q1": (quant._quantize_op, quant._quantize_cuda, (rows, None)),
        "Q2": (quant._dequantize_op, quant._dequantize_cuda,
               (acc, xs, ws, None, torch.bfloat16, False)),
    }

    def host_us(fn, args, n=400):
        for _ in range(20):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    extra = {}
    for name, (op, direct, args) in cases.items():
        d1, o1, o2, d2 = (host_us(fn, args)
                          for fn in (direct, op, op, direct))
        extra[name] = (o1 + o2 - d1 - d2) / 2
        print(f"dispatch {name}: direct launch {d1:.2f} / {d2:.2f} us a "
              f"call, through the op {o1:.2f} / {o2:.2f} us: "
              f"{extra[name]:+.2f} us a call (host, {smi})")
    return extra


# ------------------------------------------------------------- export

EXPORT_CACHES = (("ops.resize", "_device_matrix"),
                 ("ops.resize", "_device_taps"),
                 ("models.dinov2", "_bicubic_tensor"))


def _export_cli(tmp: str, name: str, *extra: str) -> tuple:
    """``cli.export_model.main`` at vitl, 475x475 frames, batch 8, 518 px,
    on the card, with ``--check``: (metadata, artifact path, seconds)."""
    import os

    export_model = importlib.import_module(f"{PKG}.cli.export_model")
    path = os.path.join(tmp, name)
    t0 = time.perf_counter()
    meta, text = _captured(export_model.main, [
        "--encoder", "vitl", "--frame-hw", *map(str, FRAME_HW),
        "--batch-size", str(BATCH), "-o", path, "--check", *extra])
    seconds = time.perf_counter() - t0
    if "replay check: max |exported - live|" not in text:
        raise AssertionError(f"export {name}: no replay check in {text}")
    return meta, path, seconds


def _batches_rgb01(bgr: list):
    import torch

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    return [torch.from_numpy(a).cuda() for a, _ in da.chunk_rgb01(bgr,
                                                                  BATCH)]


def _replay_rule(label: str, got, want) -> float:
    """The export rule: within 1e-3 of max|live| everywhere."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    dist = float(np.abs(got - want).max())
    limit = 1e-3 * float(np.abs(want).max())
    print(f"  {label}: max|replay - live| {dist:.3e} m (limit {limit:.3e},"
          f" 1e-3 of max|live|)")
    if not np.isfinite(got).all() or dist > limit:
        raise AssertionError(f"{label}: replay {dist} from live, limit "
                             f"{limit}")
    return dist


def phase_export(bgr: list, indir: str, tmp: str, smi: str
                 ) -> dict[str, dict[str, int]]:
    """Export and replay of the serving program (``cli.export_model``,
    ``serve --from-export``) at vitl, 475x475 frames, batch 8, 518 px, on
    the card: the artifact's size and contents, the replay of the serve
    CLI phase's 32 frames through ``exported_runner`` and through
    ``cli.serve.main --from-export`` against a live ``BatchedRunner``,
    the launches a replayed batch counts inside the ops, device ms a
    batch against the live program, an ``--int8 --int8-calib 2``
    artifact, one exported under ``E3D_PALLAS_RESIZE=0`` (the matmul
    resize fixed into it; the plain one holds K6), and fault 3.1's order
    (export, then the live program, in one process). Returns the
    launches by path."""
    import os

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    ex = importlib.import_module(f"{PKG}.serving.export")
    quant = importlib.import_module(f"{PKG}.ops.quant")
    serve = importlib.import_module(f"{PKG}.cli.serve")
    export_model = importlib.import_module(f"{PKG}.cli.export_model")

    # The CLIs' model: the seeded vitl init.
    model = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                 seed=0)
    params = model.state_dict()
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    net_hw = da._lower_bound_hw(*FRAME_HW, 518)
    live = np.stack(da.BatchedRunner(model, FRAME_HW, 518, BATCH)(bgr))
    batches = _batches_rgb01(bgr)

    # Fault 3.1's order: a live batch, the device caches emptied as in a
    # fresh process, the export, the live batch again.
    before = da._run_batched(model, batches[0], net_hw, FRAME_HW)
    for mod, name in EXPORT_CACHES:
        getattr(importlib.import_module(f"{PKG}.{mod}"), name).cache_clear()
    meta, path, export_s = _export_cli(tmp, "vitl.pt2")
    after = da._run_batched(model, batches[0], net_hw, FRAME_HW)
    fake = importlib.import_module("torch._subclasses.fake_tensor")
    real = (type(after) is torch.Tensor and after.is_cuda
            and not fake.is_fake(after))
    print(f"export: cli.export_model --check, vitl {FRAME_HW} batch {BATCH} "
          f"518 px on {meta['platforms']} ({meta['forward_schedule']}): "
          f"{export_s:.2f} s through main() (model init, trace, save, "
          f"replay and live check); artifact {meta['artifact_bytes']} "
          f"bytes = {meta['artifact_bytes'] / param_bytes:.5f} of vitl's "
          f"{param_bytes} parameter bytes; {smi}")
    print(f"  live after the export: {type(after).__name__} on "
          f"{after.device}, equal to the run before it: "
          f"{torch.equal(before, after)}")
    if not real or not torch.equal(before, after):
        raise AssertionError("export: the live program after an export "
                             "is not the one before it (fault 3.1)")
    prog = ex.load_exported(path)
    ep = prog.program
    leaked = [k for k, c in ep.constants.items() for p in params.values()
              if c.shape == p.shape and torch.equal(c.to(p.device), p)]
    if (meta["artifact_bytes"] >= 0.01 * param_bytes or ep.state_dict
            or ep.example_inputs is not None or leaked
            or set(ep.constants) & set(meta["param_manifest"])):
        raise AssertionError(f"export: the artifact holds weights "
                             f"({meta['artifact_bytes']} bytes, state "
                             f"{list(ep.state_dict)[:3]}, {leaked[:3]})")

    # Replay of the 32 frames: runner, counts, maps, device ms.
    run = ex.exported_runner(prog, params)
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    replay = np.stack(run(bgr))
    torch.cuda.synchronize()
    counts = {"export": _video_counts(fa, rz)}
    n_batches = len(batches)
    want = _want(K1=BLOCKS * n_batches, K6=K6_VITL * n_batches)
    print(f"  exported_runner on {len(bgr)} frames ({n_batches} batches): "
          f"launches {counts['export']} (want {want})")
    if counts["export"] != want:
        raise AssertionError(f"export replay: launches {counts['export']}")
    _replay_rule("exported_runner vs BatchedRunner", replay, live)
    x = batches[0]
    replay_ms = _cuda_ms(lambda: prog(params, x), iters=10, warmup=2)
    live_ms = _cuda_ms(lambda: da._run_batched(model, x, net_hw, FRAME_HW),
                       iters=10, warmup=2)
    print(f"  device ms a batch (CUDA events): replay {replay_ms:.2f}, "
          f"live {live_ms:.2f} ({smi})")
    busy = {}
    for label, fn in (("replay", lambda: prog(params, x)),
                      ("live", lambda: da._run_batched(model, x, net_hw,
                                                       FRAME_HW))):
        events = _profiled(fn, 3, f"export {label}, vitl batch {BATCH}")
        busy[label] = sum(e.self_device_time_total for e in events) / 3e3
    print(f"  kernel ms a batch (torch.profiler): replay "
          f"{busy['replay']:.2f}, live {busy['live']:.2f}")

    # serve --from-export on the serve CLI phase's folder.
    out = os.path.join(tmp, "served_export")
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    t0 = time.perf_counter()
    result, _ = _captured(serve.main, [
        "-i", indir, "-o", out, "--encoder", "vitl", "--batch-size",
        str(BATCH), "--once", "--save-numpy", "--from-export", path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts["export_serve_cli"] = _video_counts(fa, rz)
    stats = result["stats"]
    want = _want(K1=BLOCKS * stats["batches"], K6=K6_VITL * stats["batches"])
    names = sorted(f[:-4] for f in os.listdir(out) if f.endswith(".npy"))
    served = np.stack([np.load(os.path.join(out, f"{n}.npy"))
                       for n in names])
    print(f"  serve --from-export --once: {result['served']} frames in "
          f"{stats['batches']} batches, {seconds:.2f} s through main(): "
          f"{result['served'] / seconds:.2f} frames/s; launches "
          f"{counts['export_serve_cli']} (want {want})")
    if counts["export_serve_cli"] != want or result["served"] != len(bgr):
        raise AssertionError(f"serve --from-export: {result}")
    _replay_rule("serve --from-export vs BatchedRunner", served, live)

    # The calibrated int8 artifact: amax, replay, launches per batch.
    meta8, path8, export8_s = _export_cli(
        tmp, "vitl_int8.pt2", "--int8", "--int8-calib", "2",
        "--calib-frames", indir)
    model8 = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                  seed=0, quant_int8=True)
    program8 = ex._program(model8, net_hw, FRAME_HW)
    amax = quant.calibrate_scales(
        lambda b: program8(params, b),
        _batches_rgb01(export_model._load_calib_frames(indir, 2 * BATCH)))
    live_amax = [float(a) for a in amax.cpu().numpy()]
    print(f"export --int8 --int8-calib 2: {export8_s:.2f} s, "
          f"{meta8['artifact_bytes']} bytes; {len(live_amax)} sites, "
          f"sidecar amax equal to the live calibration's: "
          f"{meta8['int8_calib_amax'] == live_amax}")
    if meta8["int8_calib_amax"] != live_amax:
        raise AssertionError("export int8: the sidecar's amax is not the "
                             "live calibration's")
    prog8 = ex.load_exported(path8)
    frozen = ex._Program(model8, net_hw, FRAME_HW, amax)
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    replay8 = torch.cat([prog8(params, b) for b in batches]).cpu()
    torch.cuda.synchronize()
    counts["export_int8"] = _video_counts(fa, rz)
    want = _want(K1=BLOCKS * n_batches, K6=K6_VITL * n_batches,
                 Q1=248 * n_batches, Q2=124 * n_batches)
    print(f"  int8 replay of {n_batches} batches: launches "
          f"{counts['export_int8']} (want {want})")
    if counts["export_int8"] != want:
        raise AssertionError(f"export int8: {counts['export_int8']}")
    live8 = torch.cat([frozen(params, b) for b in batches]).cpu()
    _replay_rule("int8 replay vs frozen-scale live program",
                 replay8.numpy(), live8.numpy())
    del model8, program8, frozen, prog8

    # The resize is fixed at export: K6 in the plain artifact (the card's
    # default), the matmul resize in one traced under the opt-out
    # (E3D_PALLAS_RESIZE=0), which its replay keeps with the knob reset;
    # each sidecar says which the program holds.
    print(f"  plain artifact's sidecar: pallas_resize "
          f"{meta['pallas_resize']}, {meta['lerp_resize_nodes']} K6 nodes")
    if not meta["pallas_resize"] or meta["lerp_resize_nodes"] != K6_VITL:
        raise AssertionError(f"export: sidecar {meta['pallas_resize']}, "
                             f"{meta['lerp_resize_nodes']} K6 nodes")
    opt_out = {"_NO_PALLAS_RESIZE": True}
    with _Knobs(opt_out):
        meta0, path0, _ = _export_cli(tmp, "vitl_opt_out.pt2")
    prog0 = ex.load_exported(path0)
    torch.cuda.synchronize()
    _video_counts(fa, rz, zero=True)
    replay0 = prog0(params, x)
    torch.cuda.synchronize()
    counts["export_opt_out"] = _video_counts(fa, rz)
    want = _want(K1=BLOCKS)
    print(f"export under E3D_PALLAS_RESIZE=0 (sidecar pallas_resize "
          f"{meta0['pallas_resize']}, {meta0['lerp_resize_nodes']} K6 "
          f"nodes): one replayed batch with the knob reset launches "
          f"{counts['export_opt_out']} (want {want})")
    if counts["export_opt_out"] != want or meta0["lerp_resize_nodes"] \
            or meta0["pallas_resize"]:
        raise AssertionError(f"export opt-out: {counts['export_opt_out']}, "
                             f"{meta0}")
    with _Knobs(opt_out):
        live0 = da._run_batched(model, x, net_hw, FRAME_HW)
    _replay_rule("opt-out artifact vs the live program under the opt-out",
                 replay0.cpu().numpy(), live0.cpu().numpy())
    return counts


# ------------------------------------------------------ export (train)

# Phase "export_train": the depth training step exported by
# ``cli.export_model.main --train`` at vitl, 518 px, microbatch 8, over
# EXPORT_TRAIN_ACCUM microbatches (the JAX CLI's default window), under a
# OneCycle horizon of EXPORT_TRAIN_STEPS (short, so that step 0's
# learning rates are near their peaks and the parameter check below reads
# a real update).
EXPORT_TRAIN_ACCUM = 3
EXPORT_TRAIN_STEPS = 8


def _train_batch(accum: int, seed: int) -> dict:
    """A seeded (accum, 8, 518, 518, ...) depth batch on the card, a
    tenth of its depths outside [min_depth, max_depth]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (accum, BATCH, 518, 518)
    depth = torch.rand(shape, generator=gen, device="cuda") * 17.5 + 0.5
    bad = torch.rand(shape, generator=gen, device="cuda")
    depth[bad < 0.05] = 0.0
    depth[bad > 0.95] = 25.0
    return {"image": torch.randn((*shape, 3), generator=gen, device="cuda"),
            "depth": depth[..., None]}


def _peak_step(fn) -> tuple:
    """``fn()``'s result and its peak of allocated device memory (GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 30


def _step_ms(fn, iters: int) -> list[float]:
    """Each of ``iters`` calls of ``fn`` timed on CUDA events."""
    import torch

    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _param_gap(task, got: dict, want) -> tuple[float, int, int]:
    """Parameters ``got`` (name -> tensor) against the model ``want``:
    the largest distance in units of the parameter's step-0 learning
    rate, and how many of how many elements lie beyond 1e-6 of it."""
    lrs = {name: float(table[0]) for name, table in task.lr_table().items()}
    far = total = 0
    gap = 0.0
    for name, p in want.named_parameters():
        lr = lrs["encoder" if name.startswith("pretrained.") else "decoder"]
        diff = (got[name].to(p.device) - p.detach()).abs()
        gap = max(gap, diff.max().item() / lr)
        far += int((diff > 1e-6 * lr).sum())
        total += diff.numel()
    return gap, far, total


def phase_export_train(tmp: str, smi: str) -> dict[str, dict[str, int]]:
    """The exported training step at vitl, 518 px, microbatch 8, accum
    EXPORT_TRAIN_ACCUM: ``cli.export_model.main --train`` (seconds by
    program and stage, artifact bytes against vitl's parameter bytes, no
    weight in it, the kernel nodes of its microbatch program),
    ``load_exported_train_step`` (seconds), and one replayed step from the
    seeded state (the CLI's) against the live ``DepthTask.train_step``
    from the same state and batch: the loss and metrics within 1e-4
    relative; every parameter within 2 lr of live's, and at most 1% more
    of them beyond 1e-6 lr than between two live steps from that state
    (K2 sums dq in another order each run, which moves Adam's first
    update, about lr g / |g|, wherever |g| is near its noise); the
    launches counted inside the ops (K1 48 and the default backward 24 a
    microbatch, nothing else); the peak memory of each step (the
    replay's at most 1.5x the eager one's); and ms a step on CUDA events:
    the first replay, then one warm-up and three timed steps of each.
    Returns the launches by path."""
    import os

    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    ex = importlib.import_module(f"{PKG}.serving.export")
    dt = importlib.import_module(f"{PKG}.train.depth_task")
    export_model = importlib.import_module(f"{PKG}.cli.export_model")

    accum = EXPORT_TRAIN_ACCUM
    path = os.path.join(tmp, "vitl_train.pt2")
    t0 = time.perf_counter()
    meta, _ = _captured(export_model.main, [
        "--train", "--encoder", "vitl", "--input-size", "518",
        "--microbatch", str(BATCH), "--grad-accum", str(accum),
        "--total-steps", str(EXPORT_TRAIN_STEPS), "-o", path])
    export_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prog = ex.load_exported_train_step(path)
    load_s = time.perf_counter() - t0
    task = dt.DepthTask(encoder="vitl", total_steps=EXPORT_TRAIN_STEPS,
                        grad_accum=accum, device="cuda")
    state = task.init_state(0)
    params = list(state.model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    nodes = meta["kernel_nodes"]
    want_nodes = {"flash_attn_fwd": 2 * BLOCKS, "flash_attn_bwd": BLOCKS,
                  "lerp_resize": 0}
    stages = {name: {k: round(v, 2) for k, v in sec.items()}
              for name, sec in meta["seconds"].items()}
    print(f"export_train: cli.export_model --train, vitl 518 px, "
          f"microbatch {BATCH} x accum {accum} on {meta['platforms']} "
          f"({meta['forward_schedule']}, backward {meta['backward']}): "
          f"{export_s:.2f} s through main() (task init, trace, export, "
          f"save; by program and stage {stages}); "
          f"load_exported_train_step {load_s:.2f} s; graph nodes "
          f"{meta['graph_nodes']}, {len(meta['chunks'])} update chunks; "
          f"kernel nodes of the microbatch program {nodes} (want "
          f"{want_nodes}); artifact {meta['artifact_bytes']} bytes = "
          f"{meta['artifact_bytes'] / param_bytes:.5f} of vitl's "
          f"{param_bytes} parameter bytes; {smi}")
    shapes = {tuple(p.shape) for p in params}
    held = [k for ep in prog.programs.values()
            for k, c in {**ep.constants, **ep.state_dict}.items()
            if tuple(c.shape) in shapes]
    if (nodes != want_nodes or meta["artifact_bytes"] >= 0.01 * param_bytes
            or held or any(ep.example_inputs is not None
                           for ep in prog.programs.values())):
        raise AssertionError(f"export_train: kernel nodes {nodes}, "
                             f"{meta['artifact_bytes']} bytes, tensors "
                             f"shaped as parameters {held[:3]}")
    del params

    # One replayed step from the seeded state, its launches and peak; two
    # live steps from the same seed, each alone on the card.
    batch = _train_batch(accum, seed=3)
    _video_counts(fa, rz, zero=True)
    t0 = time.perf_counter()
    (state, metrics), replay_gib = _peak_step(lambda: prog(state, batch))
    first_s = time.perf_counter() - t0
    counts = {"export_train": _video_counts(fa, rz)}
    want = _want(K1=2 * BLOCKS * accum, K2=BLOCKS * accum)
    print(f"  first replayed step: {first_s * 1e3:.1f} ms wall; launches "
          f"{counts['export_train']} (want {want}); peak "
          f"{replay_gib:.2f} GiB")
    if counts["export_train"] != want:
        raise AssertionError(f"export_train launches "
                             f"{counts['export_train']}")
    opt = state.optimizer.optimizer
    if not all(bool(torch.isfinite(opt.state[p][k]).all())
               for p in state.optimizer.params
               for k in ("exp_avg", "exp_avg_sq")):
        raise AssertionError("export_train: non-finite AdamW moments")
    replayed = {n: p.detach().cpu() for n, p in
                state.model.named_parameters()}
    replay_m = {k: v.item() for k, v in metrics.items()}
    del state, metrics, opt
    torch.cuda.empty_cache()
    state = task.init_state(0)
    (state, metrics), eager_gib = _peak_step(
        lambda: task.train_step(state, batch))
    first_live = {n: p.detach().cpu() for n, p in
                  state.model.named_parameters()}
    del state, metrics
    torch.cuda.empty_cache()
    state = task.init_state(0)
    state, metrics = task.train_step(state, batch)
    live_m = {k: v.item() for k, v in metrics.items()}
    worst = max(abs(replay_m[k] - v) / abs(v) for k, v in live_m.items())
    gap, far, total = _param_gap(task, replayed, state.model)
    live_gap, live_far, _ = _param_gap(task, first_live, state.model)
    del replayed, first_live
    print(f"  replay vs live train_step from the same seeded state and "
          f"batch: metrics max rel. {worst:.2e} (tol 1e-4; replay "
          f"{replay_m}, live {live_m}); parameters max|d| {gap:.3f} lr "
          f"(tol 2), {far} of {total} ({far / total:.4%}) beyond 1e-6 lr "
          f"(tol: the live step against itself, {live_far} "
          f"({live_far / total:.4%}; max|d| {live_gap:.3f} lr), + 1%); "
          f"peak replay {replay_gib:.2f} GiB, eager {eager_gib:.2f} GiB "
          f"({replay_gib / eager_gib:.3f}x, tol 1.5x)")
    if not (worst <= 1e-4 and gap <= 2.0 * 1.01
            and far <= live_far + 0.01 * total
            and replay_gib <= 1.5 * eager_gib):
        raise AssertionError("export_train: the replay is outside its "
                             "tolerance of the live step")

    # Steady steps of each, on the live state.
    replay_ms = _step_ms(lambda: prog(state, batch), 4)
    eager_ms = _step_ms(lambda: task.train_step(state, batch), 4)
    frames = accum * BATCH
    steady = sum(replay_ms[1:]) / 3
    print(f"  ms a step (CUDA events, after one warm-up): replay "
          f"{[round(t, 2) for t in replay_ms[1:]]}, eager "
          f"{[round(t, 2) for t in eager_ms[1:]]}; mean replay "
          f"{steady:.2f} ({frames * 1e3 / steady:.2f} frames/s), eager "
          f"{sum(eager_ms[1:]) / 3:.2f} "
          f"({frames * 3e3 / sum(eager_ms[1:]):.2f} frames/s); first "
          f"replay {first_s * 1e3:.1f} ms wall against a steady "
          f"{steady:.2f} ms ({smi})")
    return counts


# ----------------------------------------------------------- distill

def phase_distill(cli_data: list, tmp: str, smi: str) -> dict[str, int]:
    """``cli.train_depth.main`` distilling a vits student from a vitl
    teacher (``trainer.distill_from``, a checkpoint this phase saves) on
    the train_depth CLI phase's tree: 518 px, microbatch 8, accum 2, two
    steps, 16-mixed, gradient checkpointing. ms a step, peak memory,
    ``Train/train_distill`` finite and logged, the launches reckoned in
    advance; then one ``DepthTask`` step with ``distill_weight=0`` against
    the plain step from the same weights: the same loss, bit for bit.
    Returns the CLI run's launches."""
    import math
    import os

    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    dt = importlib.import_module(f"{PKG}.train.depth_task")
    pre = importlib.import_module(f"{PKG}.data.preprocess")
    dino = importlib.import_module(f"{PKG}.models.dinov2")
    train_depth = importlib.import_module(f"{PKG}.cli.train_depth")

    teacher_path = os.path.join(tmp, "teacher_vitl.pth")
    teacher = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                   seed=5)
    torch.save(teacher.state_dict(), teacher_path)
    del teacher
    overrides = [o if o != "model=large" else "model=small"
                 for o in cli_data] + [
        f"trainer.accumulate_grad_batches={TRAIN_CLI_ACCUM}",
        "++trainer.max_steps=2", f"trainer.distill_from={teacher_path}"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _video_counts(fa, rz, zero=True)
        t0 = time.perf_counter()
        out, _ = _captured(train_depth.main, overrides)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _video_counts(fa, rz)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        records = _read_log(os.path.join(tmp, out["run_dir"]))
    finally:
        os.chdir(cwd)
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "val_loss" in r]
    perf = next(r for r in records if "perf/step_time_mean_s" in r)
    distill = [r.get("Train/train_distill") for r in train]
    student = dino.VIT_ARCHS["vits"]["depth"]
    microbatches = TRAIN_CLI_FRAMES // BATCH
    val_batches = len(val) * -(-2 * TRAIN_CLI_FRAMES // BATCH)
    # The teacher's forward (24 K1, and K6 at its decoder's resizes: it
    # runs under no_grad) on each microbatch; the student's forward and
    # recompute (2 x 12 K1) and backward (12) as phase "train" counts
    # vitl's; the student alone validates (vits: no K6).
    want = _want(K1=(BLOCKS + 2 * student) * microbatches
                 + student * val_batches, K6=K6_VITL * microbatches,
                 AUG=AUG_LAUNCHES * microbatches,
                 **{_bwd_name(fa._BWD_FUSED): student * microbatches})
    print(f"distill: train_depth, vits student, vitl teacher from "
          f"{os.path.basename(teacher_path)}, 518 px, 16-mixed, gradient "
          f"checkpointing, {microbatches} microbatches of {BATCH}, accum "
          f"{TRAIN_CLI_ACCUM}: {len(train)} steps, {seconds:.2f} s through "
          f"main(); per optimizer step (train.step spans) "
          f"{perf['perf/step_time_mean_s'] * 1e3:.1f} ms; peak device "
          f"memory {peak:.2f} GiB; {smi}; Train/train_distill {distill}; "
          f"losses {[round(r['train_loss'], 5) for r in train]}; launches "
          f"{counts} (want {want})")
    if counts != want or len(train) != 2 or not all(
            d is not None and math.isfinite(d) for d in distill):
        raise AssertionError(f"distill: launches {counts}, want {want}; "
                             f"records {train}")

    # distill_weight=0 against the plain step, from the same weights.
    data = SeededFrames(1, 0, BATCH, seed=4)
    prep = pre.DevicePreprocessor(518, device="cuda")
    one = prep(data.batches[0], train=False)
    batch = {k: one[k][None] for k in ("image", "depth")}
    student_sd = da.build_depth_model("vits", device="cuda",
                                      seed=6).state_dict()
    losses = []
    for weight in (None, 0.0):
        task = dt.DepthTask("vits", total_steps=4, grad_accum=1,
                            device="cuda",
                            distill_encoder=None if weight is None
                            else "vitl", distill_weight=weight or 0.0)
        if weight is not None:
            task.set_teacher(torch.load(teacher_path))
        state = task.init_state(0, pretrained_params=student_sd)
        _, metrics = task.train_step(state, batch)
        losses.append(metrics["loss"])
        del task, state
    print(f"  distill_weight=0 step loss {losses[1].item():.8f}, plain step "
          f"{losses[0].item():.8f}: bit-equal {torch.equal(*losses)}")
    if not torch.equal(*losses):
        raise AssertionError("distill: weight 0 changes the loss")
    return counts


# ----------------------------------------------------------------- nan

def phase_nan(smi: str) -> dict[str, int]:
    """``core.debug.nan_checks`` on the card: a vitl forward with one
    ``attn.qkv`` weight of block 3 set to NaN raises naming that block's
    first op; a NaN made in the backward (on autograd's device thread)
    raises; without the checks both run through; ms a vitl training step
    with the checks on and off. Returns the launches of the checked
    step."""
    import re

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    dt = importlib.import_module(f"{PKG}.train.depth_task")
    pre = importlib.import_module(f"{PKG}.data.preprocess")
    debug = importlib.import_module(f"{PKG}.core.debug")

    model = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                 seed=0)
    net_hw = da._lower_bound_hw(*FRAME_HW, 518)
    x = torch.from_numpy(np.stack(_frames(2, seed=9))).cuda()
    with torch.no_grad():
        model.pretrained.blocks[3].attn.qkv.weight[7, 11] = float("nan")
    try:
        with debug.nan_checks():
            da._run_batched_u8(model, x, net_hw, FRAME_HW)
        raise AssertionError("nan: a NaN weight went through the checks")
    except FloatingPointError as exc:
        message = str(exc)
    print(f"nan: forward with a NaN in blocks.3.attn.qkv: {message}")
    if not re.search(r"aten\.\w+\.\w+ produced a NaN "
                     r"\(in pretrained\.blocks\.3\.attn\)", message):
        raise AssertionError(f"nan: the error names {message}")
    off = da._run_batched_u8(model, x, net_hw, FRAME_HW)
    print(f"  without the checks the forward runs through: NaN maps "
          f"{bool(torch.isnan(off).any())}")
    if not torch.isnan(off).any():
        raise AssertionError("nan: the NaN weight left no NaN")
    del model

    # A NaN made in the backward: sqrt's gradient at 0 is inf, which the
    # head's backward sums with both signs.
    net = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                               seed=0).train()
    img = torch.randn((2, *net_hw, 3), device="cuda")

    def backward_nan():
        pred = net(img)
        torch.sqrt(pred - pred.detach()).sum().backward()

    try:
        with debug.nan_checks():
            backward_nan()
        raise AssertionError("nan: a backward NaN went through the checks")
    except FloatingPointError as exc:
        message = str(exc)
    net.zero_grad()
    backward_nan()
    nan_grads = sum(bool(torch.isnan(p.grad).any())
                    for p in net.parameters() if p.grad is not None)
    print(f"  backward NaN on the card: {message}; without the checks "
          f"{nan_grads} parameters get NaN gradients")
    if not nan_grads:
        raise AssertionError("nan: the backward made no NaN")
    del net

    # ms a training step, checks off and on (vitl, one microbatch of 8).
    data = SeededFrames(1, 0, BATCH, seed=10)
    one = pre.DevicePreprocessor(518, device="cuda")(data.batches[0],
                                                     train=False)
    batch = {k: one[k][None] for k in ("image", "depth")}
    task = dt.DepthTask("vitl", total_steps=8, grad_accum=1, device="cuda")
    state = task.init_state(0)
    task.train_step(state, batch)

    def step_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = task.train_step(state, batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"nan: step loss {loss}")
        return (time.perf_counter() - t0) * 1e3

    plain_ms = step_ms()
    _video_counts(fa, rz, zero=True)
    with debug.nan_checks():
        checked_ms = step_ms()
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    plain_ms2 = step_ms()
    print(f"  vitl training step (microbatch {BATCH}, 16-mixed, "
          f"checkpointing): {plain_ms:.1f} / {plain_ms2:.1f} ms without "
          f"the checks, {checked_ms:.1f} ms with them; {smi}; launches "
          f"{counts}")
    want = _want(K1=2 * BLOCKS, **{_bwd_name(fa._BWD_FUSED): BLOCKS})
    if counts != want:
        raise AssertionError(f"nan: launches {counts}, want {want}")
    return counts


# ------------------------------------------------------------- parallel

# Phase "parallel": the train_depth CLI phase's run (its tree, vitl 518
# px, 16-mixed, gradient checkpointing, global microbatch 8, accum 2, two
# optimizer steps; one validation, after the second, on one of the tree's
# two validation procedures) under each parallel
# mode, one process per rank, as torchrun starts them: (label, ranks,
# overrides, backend). Two ranks share the one card over gloo (NCCL
# refuses two ranks on one device). FSDP at world 1 shards over a data
# axis of 1, which is the DP run (as the JAX package's ``fsdp_spec``).
PARALLEL_RUNS = [
    ("DP, world 1", 1, [], "nccl"),
    ("FSDP, world 1", 1, ["trainer.fsdp=true"], "nccl"),
    ("DP, 2 ranks", 2, ["trainer.mesh_data=2"], "gloo"),
    ("TP, 2 ranks", 2, ["trainer.mesh_model=2",
                        "trainer.tensor_parallel=true"], "gloo"),
    ("TP+SP, 2 ranks", 2, ["trainer.mesh_model=2",
                           "trainer.tensor_parallel=true",
                           "trainer.seq_parallel=true"], "gloo"),
]
# The modes whose collectives gloo has only for CPU tensors (all-gather
# and reduce-scatter for FSDP, send/recv for the pipeline): with two
# ranks on the card every rank must stop at DepthTask's refusal, and any
# other outcome fails the phase.
PARALLEL_REFUSED = [
    ("FSDP, 2 ranks", ["trainer.mesh_data=2", "trainer.fsdp=true"]),
    ("GPipe, 2 ranks", ["trainer.mesh_model=2",
                        "trainer.pipeline_parallel=2"]),
    ("interleaved, 2 ranks", ["trainer.mesh_model=2",
                              "trainer.pipeline_parallel=2",
                              "++trainer.pipe_virtual=2"]),
]
GLOO_REFUSAL = ("needs collectives of CUDA tensors that the gloo backend "
                "does not have")
# Against the plain run (fixed before the card runs that read them): each
# step's loss within PARALLEL_RTOL (bf16 and another reduction order;
# the sound runs read at most 1.3e-4); the newest checkpoint's update
# from the seeded init within PARALLEL_UPDATE_RTOL of the plain run's in
# relative norm (Adam turns gradients at bf16 rounding level into
# steps of either sign; a gradient not summed over a group moves a large
# share of the elements the other way), and every element within twice
# the steps' learning rates of the plain run's.
PARALLEL_RTOL = 1e-3
PARALLEL_UPDATE_RTOL = 0.5


def _rank_worker(spec_path: str) -> int:
    """One rank of a run (``chip_smoke.py --rank-worker spec.json``):
    ``cli.train_depth.main`` in the spec's directory, then its launch
    counts, seconds and peak memory (or its error) into the spec's
    output file."""
    import os

    import torch

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    os.chdir(spec["cwd"])
    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    train_depth = importlib.import_module(f"{PKG}.cli.train_depth")
    result = {"rank": int(os.environ.get("RANK", "0"))}
    _video_counts(fa, rz, zero=True)
    t0 = time.perf_counter()
    try:
        out = train_depth.main(spec["overrides"])
        torch.cuda.synchronize()
        result.update(ok=True, run_dir=out["run_dir"],
                      ckpt_dir=out["ckpt_dir"])
    except Exception as exc:  # reported by the phase, which decides
        result.update(ok=False, error=f"{type(exc).__name__}: {exc}")
    result.update(seconds=time.perf_counter() - t0,
                  counts=_video_counts(fa, rz),
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    with open(spec["out"], "w", encoding="utf-8") as f:
        json.dump(result, f)
    return 0 if result["ok"] else 1


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_ranks(ranks: int, overrides: list, backend: str, cwd: str,
                 pipe: bool = False):
    """Start ``ranks`` rank workers on the card (every rank
    ``LOCAL_RANK=0``); returns the processes and their spec files."""
    import os

    os.makedirs(cwd, exist_ok=True)
    port = _free_port()
    procs, outs = [], []
    for rank in range(ranks):
        out = os.path.join(cwd, f"rank{rank}.json")
        spec = os.path.join(cwd, f"spec{rank}.json")
        with open(spec, "w", encoding="utf-8") as f:
            json.dump({"cwd": cwd, "overrides": overrides, "out": out}, f)
        env = dict(os.environ)
        if backend:
            env.update(RANK=str(rank), WORLD_SIZE=str(ranks),
                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), E3D_DIST_BACKEND=backend)
        log = open(os.path.join(cwd, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             spec], env=env, cwd=cwd, text=True,
            stdout=subprocess.PIPE if pipe else log,
            stderr=subprocess.STDOUT))
        outs.append(out)
    return procs, outs


def _finish_ranks(procs, outs, timeout: float) -> list[dict]:
    import os

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        if os.path.exists(out):
            with open(out, encoding="utf-8") as f:
                results.append(json.load(f))
        else:
            log = out.replace(".json", ".log")
            tail = open(log).read()[-1500:] if os.path.exists(log) else ""
            results.append({"ok": False, "error": f"exit {p.returncode}, "
                            f"no result; log tail: {tail}"})
    return results


def _newest_state(ckpt_dir: str) -> tuple[int, dict]:
    """(step, model state) of the newest save in a checkpoint dir."""
    import glob
    import os

    import torch

    paths = glob.glob(os.path.join(ckpt_dir, "*", "state.pt")) + \
        glob.glob(os.path.join(ckpt_dir, "latest", "*", "state.pt"))
    step, path = max((int(os.path.basename(os.path.dirname(p))), p)
                     for p in paths)
    return step, torch.load(path, map_location="cuda",
                            weights_only=True)["model"]


def _update_gap(init: dict, plain: dict, state: dict) -> tuple:
    """(max |state - plain|, ||(state - init) - (plain - init)|| /
    ||plain - init||) over every parameter."""
    import torch

    worst = torch.zeros((), device="cuda")
    num = torch.zeros((), device="cuda", dtype=torch.float64)
    den = torch.zeros((), device="cuda", dtype=torch.float64)
    for k, v in init.items():
        got, want = state[k].float(), plain[k].float()
        worst = torch.maximum(worst, (got - want).abs().max())
        num += (got - want).double().square().sum()
        den += (want - v.float()).double().square().sum()
    return worst.item(), (num / den).sqrt().item()


def phase_parallel(tmp: str, cli_data: list, plain_losses: list,
                   plain_ckpt: str, smi: str) -> dict[str, dict]:
    """Phase "parallel" (``PARALLEL_RUNS``): each run's per-step losses
    (rank 0 logs the global batch's) within ``PARALLEL_RTOL`` of the
    train_depth CLI phase's plain run, and its newest checkpoint's update
    within ``PARALLEL_UPDATE_RTOL`` of the plain run's; every rank's
    launches those of the plain run's schedule with one validation (K1 48
    and the backward 24 a microbatch, K1 24 a validation batch: DP splits
    the rows, TP runs K1 and K2 at 8 of vitl's 16 heads a rank); every
    parameter of the newest checkpoint moved from the seeded init and is
    finite; TP's peak memory per rank below the world-1 run's (each rank
    holds its slices of the split projections and their moments). Each
    run of ``PARALLEL_REFUSED`` must stop at DepthTask's gloo refusal on
    every rank. Prints ms a step (``train.step`` spans), seconds and peak memory
    per rank. Returns the launches by run (summed over its ranks)."""
    import math
    import os

    import torch

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    init = da.build_depth_model("vitl", device="cuda", seed=42).state_dict()
    init.pop("pretrained.mask_token")  # unused: no gradient, never moves
    plain_step, plain = _newest_state(plain_ckpt)
    # The runs validate on the first of the tree's two validation
    # procedures (a cut of the plain run's validation depth: the runs are
    # held to its training losses and update, which validation does not
    # touch, and a two-rank validation batch costs seconds over gloo).
    root = next(x.split("=", 1)[1] for x in cli_data
                if x.startswith("dataset.data_dir="))
    with open(os.path.join(root, "val.txt"), encoding="utf-8") as f:
        first = f.read().strip().split(",")[0]
    val_list = os.path.join(root, "val_parallel.txt")
    with open(val_list, "w", encoding="utf-8") as f:
        f.write(first)
    overrides = cli_data + [f"trainer.accumulate_grad_batches="
                            f"{TRAIN_CLI_ACCUM}", "++trainer.max_steps=2",
                            "trainer.val_check_interval=1.0",
                            "trainer.log_every_n_steps=1",
                            "++trainer.distributed=true",
                            f"dataset.val_list={val_list}"]
    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    microbatches = TRAIN_CLI_FRAMES // BATCH
    val_batches = -(-TRAIN_CLI_FRAMES // BATCH)
    want = _want(K1=2 * BLOCKS * microbatches + BLOCKS * val_batches,
                 K6=K6_VITL * val_batches, AUG=AUG_LAUNCHES * microbatches,
                 **{_bwd_name(fa._BWD_FUSED): BLOCKS * microbatches})
    by_run, peaks = {}, {}
    for label, ranks, extra, backend in PARALLEL_RUNS:
        cwd = os.path.join(tmp, "parallel", label.replace(" ", "_")
                           .replace(",", ""))
        procs, outs = _start_ranks(ranks, overrides + extra, backend, cwd)
        results = _finish_ranks(procs, outs, timeout=420)
        failed = [r for r in results if not r.get("ok")]
        if failed:
            raise AssertionError(f"parallel {label} ({backend}): {failed}")
        records = _read_log(os.path.join(cwd, results[0]["run_dir"]))
        train = [r for r in records if "train_loss" in r]
        losses = [r["train_loss"] for r in train]
        lr_sum = sum(max(r["lr/encoder"], r["lr/decoder"]) for r in train)
        perf = next(r for r in records if "perf/step_time_mean_s" in r)
        step, state = _newest_state(os.path.join(cwd,
                                                 results[0]["ckpt_dir"]))
        still = sorted(k for k, v in init.items() if torch.equal(v, state[k]))
        bad = sorted(k for k, v in state.items()
                     if not torch.isfinite(v).all())
        worst, gap = _update_gap(init, plain, state)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        counts = [r["counts"] for r in results]
        peaks[label] = max(r["peak_gib"] for r in results)
        print(f"parallel {label} ({backend}), vitl 518 px, global "
              f"microbatch {BATCH}, accum {TRAIN_CLI_ACCUM}: losses "
              f"{[round(x, 5) for x in losses]} (plain "
              f"{[round(x, 5) for x in plain_losses]}, rel. "
              f"{[f'{x:.2e}' for x in rel]}); update against the plain "
              f"run's: {gap:.3e} in relative norm, max |diff| {worst:.3e} "
              f"(2 lr {2 * lr_sum:.3e}); "
              f"{perf['perf/step_time_mean_s'] * 1e3:.1f} "
              f"ms a step (train.step spans, rank 0); seconds per rank "
              f"{[round(r['seconds'], 1) for r in results]}; peak memory "
              f"per rank {[round(r['peak_gib'], 2) for r in results]} GiB; "
              f"K1/K2 per rank {[(c['K1'], c['K2']) for c in counts]} "
              f"(want {want['K1']}/{want['K2']}); "
              f"checkpoint step {step}; {smi}")
        if len(losses) != len(plain_losses) or max(rel) > PARALLEL_RTOL \
                or any(not math.isfinite(x) for x in losses) \
                or any(c != want for c in counts) or still or bad \
                or step != 2 or plain_step != 2 \
                or not gap <= PARALLEL_UPDATE_RTOL \
                or not worst <= 2 * lr_sum * 1.01:
            raise AssertionError(
                f"parallel {label}: losses {losses} vs {plain_losses}, "
                f"update gap {gap} (max {worst}, 2 lr {2 * lr_sum}), "
                f"counts {counts} vs {want}, unchanged {still[:8]}, "
                f"non-finite {bad[:8]}, step {step} (plain {plain_step})")
        by_run[label] = {k: sum(c[k] for c in counts) for k in counts[0]}
        del state
        torch.cuda.empty_cache()
    if not peaks["TP, 2 ranks"] < peaks["DP, world 1"]:
        raise AssertionError(f"parallel: TP holds whole weights: {peaks}")
    for label, extra in PARALLEL_REFUSED:
        cwd = os.path.join(tmp, "parallel", label.replace(" ", "_")
                           .replace(",", ""))
        procs, outs = _start_ranks(2, overrides + extra, "gloo", cwd)
        results = _finish_ranks(procs, outs, timeout=300)
        errors = sorted({r.get("error", "").splitlines()[0][:400]
                         if r.get("error") else "" for r in results})
        print(f"parallel {label} (gloo): refused with two ranks on one "
              f"card: {errors}")
        if any(r.get("ok") or GLOO_REFUSAL not in r.get("error", "")
               for r in results):
            raise AssertionError(f"parallel {label}: want DepthTask's gloo "
                                 f"refusal on every rank, got {results}")
    print(f"parallel: ran {sorted(by_run)}; refused up front with two ranks "
          f"on one card over gloo: {[r[0] for r in PARALLEL_REFUSED]}")
    return by_run


def phase_preempt(tmp: str, cli_data: list, smi: str) -> dict[str, int]:
    """Phase "preempt": a train_depth process at vitl 518 px (the
    train_depth CLI phase's tree and config, max_steps 4, no validation
    before the last step) gets SIGTERM once it logs its first step: it
    exits 0 with ``latest/`` at the step it stopped after and
    ``preempted`` 1; ``trainer.resume=true`` reaches step 4 from there.
    Prints the seconds from the signal to the exit. Returns the first
    run's launches."""
    import os
    import signal

    ckpt_mod = importlib.import_module(f"{PKG}.core.checkpoint")
    cwd = os.path.join(tmp, "preempt")
    overrides = cli_data + [f"trainer.accumulate_grad_batches="
                            f"{TRAIN_CLI_ACCUM}", "++trainer.max_steps=4",
                            "trainer.val_check_interval=100",
                            "trainer.log_every_n_steps=1"]
    procs, outs = _start_ranks(1, overrides, "", cwd, pipe=True)
    proc = procs[0]
    t_signal = None
    for line in proc.stdout:
        if t_signal is None and line.startswith("[metrics]") \
                and "train_loss" in line and " step=1 " in line:
            proc.send_signal(signal.SIGTERM)
            t_signal = time.perf_counter()
    proc.wait(timeout=300)
    t_exit = time.perf_counter()
    first = _finish_ranks(procs, outs, timeout=10)[0]
    if t_signal is None or proc.returncode != 0 or not first.get("ok"):
        raise AssertionError(f"preempt: rc {proc.returncode}, signal sent "
                             f"{t_signal is not None}, {first}")
    ckpt_dir = os.path.join(cwd, first["ckpt_dir"])
    mgr = ckpt_mod.CheckpointManager(ckpt_dir)
    stopped, metrics = mgr.latest_step(), mgr.latest_metrics() or {}
    print(f"preempt: SIGTERM after step 1 was logged; exit 0 "
          f"{t_exit - t_signal:.2f} s after the signal; latest/ at step "
          f"{stopped} with preempted {metrics.get('preempted')}; launches "
          f"{first['counts']}; {smi}")
    if metrics.get("preempted") != 1.0 or stopped not in (1, 2, 3):
        raise AssertionError(f"preempt: latest step {stopped}, metrics "
                             f"{metrics}")
    procs, outs = _start_ranks(1, overrides + ["++trainer.resume=true"], "",
                               cwd)
    second = _finish_ranks(procs, outs, timeout=300)[0]
    resumed = ckpt_mod.CheckpointManager(ckpt_dir)
    print(f"preempt: resume from step {stopped} reached step "
          f"{resumed.latest_step()} in {second.get('seconds', 0):.1f} s; "
          f"launches {second.get('counts')}")
    if not second.get("ok") or resumed.latest_step() != 4 \
            or "preempted" in (resumed.latest_metrics() or {}):
        raise AssertionError(f"preempt: resume {second}, latest "
                             f"{resumed.latest_step()}")
    return first["counts"]



VDA_FRAME_HW = (1080, 1350)   # C3VD: 518 x 644 network input
VDA_WINDOW = 32
# A VDA-L window's temporal attention calls: 4 modules x 2 blocks.
TA_PER_WINDOW = 8


def phase_vda(smi: str) -> dict[str, int]:
    """Video Depth Anything (phase "vda"): ``e3d::temporal_attn`` at
    VDA-L's four module shapes timed on the device alone; one 32-frame
    window at 518 x 644 through ``ClipRunner`` against the same model in
    f32 with the plain attention (K1 off, TF32 off; ``map_rel_err``, the
    benchmark's rule, within its 0.14); the engine's clip mode on two
    interleaved 60-frame streams (every frame resolved, K1 24, K6 5 and
    TA 8 a window); and ``cli.video_depth.main --model vda`` on a
    40-frame AVI (two windows). Returns the launches of the engine's
    streams."""
    import os
    import tempfile

    import numpy as np
    import torch

    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    rz = importlib.import_module(f"{PKG}.ops.resize")
    attn = importlib.import_module(f"{PKG}.ops.attention")
    da = importlib.import_module(f"{PKG}.models.depth_anything")
    ta = importlib.import_module(f"{PKG}.ops.temporal_attention")
    eng = importlib.import_module(f"{PKG}.serving.engine")
    vd = importlib.import_module(f"{PKG}.cli.video_depth")
    native = importlib.import_module(f"{PKG}.media.native")

    for s, d in ((1702, 128), (437, 128), (1702, 32), (6808, 32)):
        qkv = torch.randn((VDA_WINDOW, s, 3, 8, d), device="cuda",
                          dtype=torch.bfloat16)
        with torch.no_grad():
            ms = _device_ms(lambda: ta.temporal_attention(qkv, VDA_WINDOW),
                            10)
        nbytes = 4 * VDA_WINDOW * s * 8 * d * 2
        print(f"vda: temporal_attn (32, {s}, 3, 8, {d}): {ms:.4f} ms on the "
              f"device, {nbytes / 1e6:.1f} MB, "
              f"{100 * nbytes / PEAK_BYTES / (ms * 1e-3):.1f}% of the byte "
              "bound")

    model = da.build_vda_model("vitl", device="cuda", seed=0)
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (*VDA_FRAME_HW, 3), dtype=np.uint8)
              for _ in range(16)]
    runner = da.ClipRunner(model, VDA_FRAME_HW)
    clip = frames + frames
    _video_counts(fa, rz, zero=True)
    _, maps = runner(clip, None, 0)
    torch.cuda.synchronize()
    counts = _video_counts(fa, rz)
    t0 = time.perf_counter()
    for _ in range(3):
        _, maps = runner(clip, None, 0)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) / 3 * 1e3
    f32 = da.build_vda_model("vitl", dtype=torch.float32, device="cuda",
                             seed=0)
    attn.set_force_plain(True)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, want = da.ClipRunner(f32, VDA_FRAME_HW)(clip, None, 0)
    finally:
        attn.set_force_plain(False)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    del f32
    torch.cuda.empty_cache()
    rel = float((maps - want).abs().mean()
                / (want - want.mean(dim=(1, 2), keepdim=True)).abs().mean())
    print(f"vda: a 32-frame window at {VDA_FRAME_HW} (518 x 644): "
          f"{window_ms:.1f} ms through ClipRunner (upload, forward, resize "
          f"back), map_rel_err against plain f32 {rel:.4f}; launches "
          f"{counts}")
    if not rel < 0.14 or counts["K1"] != BLOCKS or counts["TA"] != \
            TA_PER_WINDOW or counts["K6"] != K6_VITL:
        raise AssertionError(f"vda window: rel {rel}, launches {counts}")

    _video_counts(fa, rz, zero=True)
    with eng.DepthServingEngine(model, device="cuda") as e:
        futs = [e.submit(frames[(i + k) % 16], stream=k) for i in range(60)
                for k in (0, 1)]
        for k in (0, 1):
            e.end_stream(k)
        out = [f.result() for f in futs]
        stats = e.stats()
    served = _video_counts(fa, rz)
    windows = stats["batches"]
    for m in out:
        if m.shape != VDA_FRAME_HW or not np.isfinite(m).all() or m.min() < 0:
            raise AssertionError(f"vda engine map: {m.shape}, "
                                 f"[{m.min()}, {m.max()}]")
    print(f"vda: engine clip mode, two 60-frame streams: {windows} windows, "
          f"{len(out)} maps, launches {served}")
    if windows != 6 or served["TA"] != TA_PER_WINDOW * windows or \
            served["K1"] != BLOCKS * windows:
        raise AssertionError(f"vda engine: {windows} windows, {served}")

    with tempfile.TemporaryDirectory() as tmp:
        avi = os.path.join(tmp, "in.avi")
        with native.VideoWriter(avi, FRAME_HW[1], FRAME_HW[0], fps=30) as w:
            for f in _frames(40, seed=9):
                w.write_rgb(f)
        seen = []
        _video_counts(fa, rz, zero=True)
        res = vd.main(["--model", "vda", "-i", avi, "-o",
                       os.path.join(tmp, "out.mp4")],
                      on_depth=lambda i, d: seen.append(d))
        cli = _video_counts(fa, rz)
    print(f"vda: video_depth --model vda wrote {res['frames']} frames; "
          f"launches {cli}")
    if res["frames"] != 40 or len(seen) != 40 or cli["TA"] != \
            2 * TA_PER_WINDOW:
        raise AssertionError(f"vda CLI: {res['frames']} frames, {cli}")
    del model
    torch.cuda.empty_cache()
    return served


# Wall seconds by phase, in the order they ran (``_timed``).
PHASE_SECONDS: dict[str, float] = {}


def _timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept under ``name`` (a
    phase that runs twice adds up)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)
        print(f"[phase {name}: {PHASE_SECONDS[name]:.1f} s]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = _timed("device", phase_device)
    _timed("build", phase_build)
    _timed("sass", phase_sass)
    fa = importlib.import_module(f"{PKG}.ops.flash_attention")
    k1 = _timed("forward", phase_forward, "K1", "flash_attn_fwd", 336,
                fa.flash_attention)
    k4 = _timed("forward", phase_forward, "K4", "flash_attn_fwd_pair", 181,
                fa.flash_attention_pair)
    k5 = _timed(
        "forward", phase_forward, "K5 pipe", "flash_attn_fwd_heads", 254,
        lambda q, k, v: fa.flash_attention_heads(q, k, v, pipe=True))
    k5_loop = _timed(
        "forward", phase_forward, "K5 hloop", "flash_attn_fwd_heads", 274,
        lambda q, k, v: fa.flash_attention_heads(q, k, v, pipe=False))
    _timed("variant_grads", phase_variant_grads)
    k2 = _timed("bwd", phase_bwd, fused=True)
    k3 = _timed("bwd", phase_bwd, fused=False)
    faster = "K2" if k2["ms"] <= k3["ms"] else "K3"
    default = _bwd_name(fa._BWD_DEFAULT == "1")
    print(f"backward with E3D_FLASH_BWD_FUSED unset: {default}; measured "
          f"faster in this run: {faster} (K2 {k2['ms']:.4f} ms, K3 "
          f"{k3['ms']:.4f} ms through the wrapper)")
    k6 = _timed("k6", phase_k6)
    aug = _timed("augment", phase_augment, smi)
    q1, q2 = _timed("quant_kernels", phase_quant_kernels, smi)
    dispatch = _timed("dispatch", phase_dispatch, smi)
    torch.cuda.empty_cache()

    da = importlib.import_module(f"{PKG}.models.depth_anything")
    model = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                 seed=0)
    frames = _frames(N_FRAMES, seed=0)
    serve = _timed("serve", phase_serve, model, frames)
    _timed("plain", phase_plain, model, frames[:BATCH])
    _timed("throughput", phase_throughput, model, frames, k1["ms"], smi)
    _timed("profile", phase_profile, model, frames)
    video = _timed("video", phase_video, model, smi)
    del model
    torch.cuda.empty_cache()

    data = SeededFrames(TRAIN_MICROBATCHES, VAL_BATCHES, BATCH, seed=1)
    grads = _timed("grads", phase_grads, data)
    torch.cuda.empty_cache()
    task, state, train = _timed("train", phase_train, data, smi)
    other = _timed("train_other", phase_train_other, data)
    _timed("train_profile", phase_train_profile, task, state, data)
    del task, state, data
    torch.cuda.empty_cache()

    # The file-based entry points, each driven as a user would call it.
    import os
    import tempfile

    _timed("codecs", phase_codecs, smi)
    os.environ["E3D_CONFIG_ROOT"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "configs")
    with tempfile.TemporaryDirectory() as tmp:
        model = da.build_depth_model("vitl", max_depth=20.0, device="cuda",
                                     seed=0)
        infer, paths, bgr, plain, f32 = _timed(
            "infer_cli", phase_infer_cli, model, tmp, smi)
        dials = _timed("dials", phase_dials, model, frames, paths, plain,
                       f32, tmp, smi)
        del model
        served = _timed("serve_cli", phase_serve_cli, paths, plain, f32,
                        tmp, smi)
        torch.cuda.empty_cache()
        exported = _timed("export", phase_export, bgr,
                          os.path.join(tmp, "incoming"), tmp, smi)
        torch.cuda.empty_cache()
        exported.update(_timed("export_train", phase_export_train, tmp, smi))
        torch.cuda.empty_cache()
        train_cli, ckpt_dir, cli_data, cli_losses = _timed(
            "train_cli", phase_train_cli, tmp, smi)
        torch.cuda.empty_cache()
        distill = _timed("distill", phase_distill, cli_data, tmp, smi)
        torch.cuda.empty_cache()
        test_cli = _timed("test_cli", phase_test_cli, ckpt_dir, cli_data,
                          tmp, smi)
        torch.cuda.empty_cache()
        parallel = _timed("parallel", phase_parallel, tmp, cli_data,
                          cli_losses, ckpt_dir, smi)
        preempt = _timed("preempt", phase_preempt, tmp, cli_data, smi)
        torch.cuda.empty_cache()
        nan = _timed("nan", phase_nan, smi)
        torch.cuda.empty_cache()

        # Reconstruction: (a) fusion and the depth-9 mesh of a synthetic
        # colon; (b) per-frame model clouds and (c) the offline tools on
        # the infer CLI phase's tree.
        recon_pc = _timed("recon", phase_recon, tmp, smi)
        torch.cuda.empty_cache()
        infer_root = os.path.join(tmp, "infer_vitl")
        recon_model = _timed("recon_model", phase_recon_model, infer_root,
                             plain, f32, tmp, smi)
        _timed("recon_tools", phase_recon_tools, infer_root, tmp, smi)
    torch.cuda.empty_cache()

    # The giant encoder (vitg) and the pose path.
    with tempfile.TemporaryDirectory() as tmp:
        vitg_serve = _timed("vitg_serve", phase_vitg_serve, tmp, smi)
    torch.cuda.empty_cache()
    vitg_grads = _timed("vitg_grads", phase_grads,
                        SeededFrames(1, 0, BATCH, seed=2), "vitg", 2,
                        VITG_BLOCKS)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        pose = _timed("pose", phase_pose, tmp, smi)
    _timed("pose_parity", phase_pose_parity)
    vda = _timed("vda", phase_vda, smi)
    torch.cuda.empty_cache()
    # Every path's counts, each read back from its own run: "serve" is
    # DepthServingEngine's phase and "serve_cli" the serve CLI; "grads"
    # the vitl microbatch; "train" the four-step fit on the default
    # backward and "train_other" the one-step fit on the other.
    by_path = {"serve": serve, "grads": grads, "train": train,
               "train_other": other, "infer": infer, "serve_cli": served,
               "train_cli": train_cli, "test_cli": test_cli,
               "vitg_serve": vitg_serve, "vitg_grads": vitg_grads,
               "pose": pose, "pointcloud": recon_pc,
               "pointcloud_model": recon_model, **exported,
               "distill": distill, "nan": nan, "preempt": preempt,
               **{f"parallel {label}": counts
                  for label, counts in parallel.items()}}

    # VDA's temporal attention runs on no DAv2 path.
    dav2_ta = {path: c.get("TA", 0) for path, c in
               [*by_path.items(), *video.items(), *dials.items()]
               if c.get("TA", 0)}
    if dav2_ta:
        raise AssertionError(f"temporal_attn launched on DAv2 paths: "
                             f"{dav2_ta}")
    print(f"temporal_attn: 0 launches on every DAv2 path; vda {vda['TA']}")
    k1["launches"] = serve["K1"]
    k1["launches_by_path"] = {"video": video["default"]["K1"]}
    # "video": the launches over the four configurations (the video
    # phase holds every kernel outside its configuration to 0).
    on_video = {k: sum(c[k] for c in video.values())
                for k in ("K2", "K3", "K5")}
    for rec, name in ((k2, "K2"), (k3, "K3")):
        rec["launches"] = train[name] + other[name]
        rec["launches_by_path"] = {"video": on_video[name]}
    pair = video["PALLAS_RESIZE + PAIR"]
    k4["launches"] = pair["K4"]
    k4["launches_by_path"] = {"video": pair["K4"]}
    # K5's record: its pipelined schedule (the first in the JAX package's
    # order), with the looped one beside it.
    k5["launches"] = on_video["K5"]
    k5["launches_by_path"] = {"video": on_video["K5"],
                              "video_pipe": video["PIPE"]["K5"],
                              "video_hloop": video["HLOOP"]["K5"]}
    k5["hloop"] = {key: k5_loop[key] for key in
                   ("replaces", "max_abs_err", "ms", "plain_ms",
                    "library_ms", "max_diff_k1")}
    # K6: the served batches (the main path); every video configuration
    # takes it by default.
    k6["launches"] = serve["K6"]
    k6["launches_by_path"] = {
        "video": sum(c["K6"] for c in video.values()),
        **{f"video[{cfg}]": c["K6"] for cfg, c in video.items()}}
    # Q1 and Q2 run only under a dial: "dials_*" are phase "dials"'s
    # paths (BatchedRunner, the engine and the infer CLI per dial).
    for name, rec in (("Q1", q1), ("Q2", q2)):
        rec["launches"] = sum(c[name] for c in dials.values())
        rec["launches_by_path"] = {
            "video": sum(c[name] for c in video.values())}
        rec["launches_by_path"].update(
            {path: c[name] for path, c in dials.items()})
    # AUG: the fine-tuning path (phase "train"), two launches a
    # microbatch; no serving path augments.
    aug["launches"] = train["AUG"]
    aug["launches_by_path"] = {
        "video": sum(c["AUG"] for c in video.values()),
        "dials": sum(c["AUG"] for c in dials.values())}
    for name, rec in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4),
                      ("K5", k5), ("K6", k6), ("Q1", q1), ("Q2", q2),
                      ("AUG", aug)):
        rec["launches_by_path"].update(
            {path: counts[name] for path, counts in by_path.items()})
    for rec, name in ((k1, "K1"), (k6, "K6")):
        rec["launches_by_path"]["dials"] = sum(c[name]
                                               for c in dials.values())
    # Each op's host cost a call against its direct launch (phase
    # "dispatch"): K4 and K5 share K1's op, K3 K2's.
    for rec, op in ((k1, "K1"), (k4, "K1"), (k5, "K1"), (k2, "K2"),
                    (k3, "K2"), (k6, "K6"), (q1, "Q1"), (q2, "Q2")):
        rec["op_dispatch_us"] = dispatch[op]
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, q1, q2, aug]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":
        sys.exit(_rank_worker(sys.argv[2]))
    sys.exit(main())
