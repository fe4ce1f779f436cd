"""Export the batched depth-inference program (the port of the JAX
package's ``cli/export_model.py``).

Traces the full preprocess, forward and resize-back program once at a
fixed (batch, H, W) with ``torch.export`` on the card (``--device cpu``
for the CPU) and saves it; ``cli/serve.py --from-export`` and
``serving.export.load_exported`` replay it, with the weights of the
checkpoint as call-time inputs.

Usage:
    python -m ...cli.export_model --encoder vitl --load-from ckpt \\
        --frame-hw 475 1000 --batch-size 8 -o vitl_475x1000.pt2 [--check]

``--int8``, ``--token-merge`` and ``--int8-calib K --calib-frames DIR``
bake the speed dials into the program; ``--check`` replays the artifact
against the live program (the frozen-scale one under ``--int8-calib``).

``--train`` exports the depth training step instead (the JAX package's
``_export_train``): one optimizer step over ``--grad-accum`` microbatches
of ``--microbatch`` images at ``--input-size`` square, under the OneCycle
horizon ``--total-steps``; ``serving.export.load_exported_train_step``
replays it on a ``DepthTrainState``:

    python -m ...cli.export_model --train --encoder vitl \
        --grad-accum 3 --microbatch 8 --total-steps 1000 -o train.pt2
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None) -> dict:
    """Run the CLI; returns the sidecar's metadata, with the ``--check``
    distance under ``check_max_abs`` when it ran."""
    import torch

    from ..models.convert import load_or_init_depth_model
    from ..serving.export import (_Program, export_depth_program,
                                  load_exported)

    p = argparse.ArgumentParser()
    p.add_argument("--encoder", default="vitl",
                   choices=["vits", "vitb", "vitl", "vitg", "vitt"])
    p.add_argument("--load-from", default=None)
    p.add_argument("--max-depth", type=float, default=20.0)
    p.add_argument("--frame-hw", type=int, nargs=2, metavar=("H", "W"),
                   help="camera resolution the inference program is "
                        "fixed to (SimCol: 475 1000)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--token-merge", type=float, default=0.0)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8-calib", type=int, default=0, metavar="K",
                   help="with --int8 and --calib-frames: bake static "
                        "activation scales from the first K batches into "
                        "the artifact (frozen-scale program; the sidecar "
                        "records the amax vector)")
    p.add_argument("--calib-frames", default=None, metavar="DIR",
                   help="directory of frames at --frame-hw resolution "
                        "used for --int8-calib")
    p.add_argument("--check", action="store_true",
                   help="replay the artifact on random frames and report "
                        "the max deviation from the live program")
    p.add_argument("--train", action="store_true",
                   help="export the depth TRAIN step instead of inference; "
                        "--load-from then gives the weights the trace runs "
                        "on (seeded random init without it; the artifact "
                        "holds no weights, so any state of the encoder "
                        "replays it)")
    p.add_argument("--grad-accum", type=int, default=3,
                   help="train export: grad-accum window (microbatches "
                        "per optimizer step)")
    p.add_argument("--microbatch", type=int, default=8,
                   help="train export: per-microbatch batch size")
    p.add_argument("--total-steps", type=int, default=1000,
                   help="train export: OneCycle horizon baked into the "
                        "schedule (must match the resumed run)")
    p.add_argument("--device", default="cuda",
                   help="where the program is traced and runs: cuda "
                        "(default) or cpu")
    args = p.parse_args(argv)

    if args.train:
        if args.check:
            p.error("--check replays the inference export; --train has "
                    "none")
        return _export_train(args)
    if args.frame_hw is None:
        p.error("--frame-hw is required for inference export")
    if args.int8_calib:
        if not args.int8:
            p.error("--int8-calib requires --int8")
        if not args.calib_frames:
            p.error("--int8-calib requires --calib-frames DIR")

    model = load_or_init_depth_model(args.encoder, args.max_depth,
                                     args.load_from, device=args.device,
                                     token_merge=args.token_merge,
                                     quant_int8=args.int8)
    params = model.state_dict()
    calib_frames = None
    if args.int8_calib:
        calib_frames = _load_calib_frames(
            args.calib_frames, args.int8_calib * args.batch_size)
        if not calib_frames:
            raise SystemExit(f"[export] no readable frames in "
                             f"{args.calib_frames}")
    meta = export_depth_program(model, params, args.output,
                                frame_hw=tuple(args.frame_hw),
                                batch_size=args.batch_size,
                                input_size=args.input_size,
                                calib_frames=calib_frames,
                                calib_batches=args.int8_calib)
    calib_note = (f", int8-calib over {len(calib_frames)} frames"
                  if calib_frames else "")
    print(f"[export] {args.output}: {meta['artifact_bytes']} bytes, "
          f"platforms={meta['platforms']}, frame={meta['frame_hw']}, "
          f"net={meta['net_hw']}, batch={meta['batch_size']}, "
          f"attention {meta['forward_schedule']}{calib_note}")

    if args.check:
        # Export first, live program afterwards: the order in which a
        # device cache filled while tracing would hand the live program
        # fake tensors.
        prog = load_exported(args.output)
        rng = np.random.default_rng(0)
        frames = rng.random((args.batch_size, *args.frame_hw, 3),
                            np.float32)
        got = prog(params, frames)
        amax = meta.get("int8_calib_amax")
        # The artifact runs frozen scales; compare against the same
        # frozen-scale live program, not the dynamic-quant one.
        live = _Program(model, tuple(meta["net_hw"]),
                        tuple(meta["frame_hw"]),
                        None if amax is None else torch.tensor(
                            amax, dtype=torch.float32,
                            device=got.device))
        ref = live(params, torch.from_numpy(frames).to(got.device))
        dev = float((got - ref).abs().max())
        print(f"[export] replay check: max |exported - live| = {dev:.3e}")
        if not bool(torch.isfinite(got).all()) or dev > 1e-3 * max(
                float(ref.abs().max()), 1.0):
            raise SystemExit("[export] replay check FAILED")
        meta = {**meta, "check_max_abs": dev}
    return meta


def _load_calib_frames(dirpath: str, n: int) -> list:
    """The first ``n`` decodable frames of a directory (sorted), BGR
    uint8, through the infer CLI's reader."""
    from .infer import _imread_bgr

    frames = []
    for path in sorted(
            f for pat in ("*.png", "*.jpg", "*.jpeg")
            for f in glob.glob(os.path.join(dirpath, pat))):
        raw = _imread_bgr(path)
        if raw is not None:
            frames.append(raw)
        if len(frames) >= n:
            break
    return frames


def _export_train(args) -> dict:
    """Export the depth TRAIN step (state, batch) -> (state, metrics);
    returns the sidecar's metadata."""
    from ..models.convert import load_or_init_depth_model
    from ..serving.export import export_train_step
    from ..train.depth_task import DepthTask

    if args.int8 or args.token_merge:
        raise SystemExit("[export] --train does not compose with the "
                         "inference speed dials (--int8/--token-merge)")
    task = DepthTask(encoder=args.encoder, max_depth=args.max_depth,
                     total_steps=args.total_steps,
                     grad_accum=args.grad_accum, device=args.device)
    weights = (load_or_init_depth_model(
        args.encoder, args.max_depth, args.load_from,
        device=args.device).state_dict() if args.load_from else None)
    state = task.init_state(0, pretrained_params=weights)
    hw = (args.input_size, args.input_size)
    meta = export_train_step(task, state, args.output,
                             microbatch=args.microbatch, image_hw=hw)
    print(f"[export] {args.output}: {meta['artifact_bytes']} bytes, "
          f"platforms={meta['platforms']}, train step "
          f"accum{meta['grad_accum']} x bs{meta['microbatch']} @ "
          f"{meta['image_hw']}")
    return meta


if __name__ == "__main__":
    main()
