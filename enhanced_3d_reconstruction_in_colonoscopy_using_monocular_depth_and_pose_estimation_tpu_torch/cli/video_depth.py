"""One-shot video -> depth-video CLI (the port of the JAX package's
``cli/video_depth.py``).

MJPEG AVI/MP4 frames stream from the native demux and JPEG decoder
(``media/native``) into the batched ``DepthServingEngine`` on the card,
and the rendered depth (Spectral colormap or grayscale, optionally beside
the frame) goes to the native MJPEG writer (AVI or MP4 by extension),
without frames touching disk. Decode and encode run on the host while the
card works on the batch before. Other codecs raise: the port has no cv2
to fall back to.

Usage:
    python -m ...cli.video_depth -i colon.avi -o colon_depth.mp4 \\
        [--encoder vitl --load-from ckpt] [--side-by-side] [--every-n 2]
        [--max-frames N] [--grayscale] [--quality 90] [--device cuda]

The speed dials ``--token-merge``, ``--int8`` and ``--int8-calib K`` act
as in the JAX package, through the serving engine (``--int8-calib``: the
first K batches calibrate the static scales the whole video runs under).

``--model vda`` runs Video Depth Anything (``--load-from`` its published
``video_depth_anything_<encoder>.pth``) through the engine's clip mode:
the video is one stream, cut into VDA's 32-frame windows with keyframes
carried, aligned and blended, so each output frame is a temporally
consistent relative disparity (no ``--max-depth``, no speed dials).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import add_speed_dials, check_speed_dials


def _frames(path: str, every_n: int, max_frames: int | None):
    """Yield (index, RGB uint8 frame, fps) of an MJPEG video."""
    from ..media.video import open_mjpeg

    with open_mjpeg(path) as r:
        count = 0
        for i in range(0, r.num_frames, every_n):
            if max_frames is not None and count >= max_frames:
                return
            yield i, r.frame_rgb(i), r.fps
            count += 1


def main(argv=None, on_depth=None) -> dict:
    """Run the CLI; returns the frames written and the engine's stats.
    ``on_depth(index, depth)``, if given, sees each frame's depth map (f32,
    frame size) as it is rendered, with the frame's index in the input."""
    from ..media.colormap import colorize_depth, side_by_side
    from ..media.native import VideoWriter
    from ..models.convert import (load_or_init_depth_model,
                                  load_or_init_vda_model)
    from ..serving.engine import DepthServingEngine

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="dav2", choices=["dav2", "vda"],
                   help="dav2: per-frame metric depth; vda: Video Depth "
                        "Anything over 32-frame windows")
    p.add_argument("--encoder", default="vitl",
                   choices=["vits", "vitb", "vitl", "vitg", "vitt"])
    p.add_argument("--load-from", default=None)
    p.add_argument("--max-depth", type=float, default=20.0)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True,
                   help="output video (.avi or .mp4; MJPEG either way)")
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--every-n", type=int, default=1,
                   help="process every Nth frame")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--side-by-side", action="store_true",
                   help="original | divider | depth composite (run.py "
                        "--pred-only off semantics)")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--quality", type=int, default=90,
                   help="output JPEG quality")
    p.add_argument("--fps", type=float, default=None,
                   help="override output fps (default: input fps / every_n)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")
    add_speed_dials(p)
    args = p.parse_args(argv)
    if args.every_n < 1:
        p.error("--every-n must be >= 1")
    check_speed_dials(p, args)
    video = args.model == "vda"
    if video and (args.int8 or args.token_merge):
        p.error("--model vda takes no speed dial (--int8, --token-merge)")

    if video:
        model = load_or_init_vda_model(args.encoder, args.load_from,
                                       device=args.device)
    else:
        model = load_or_init_depth_model(args.encoder, args.max_depth,
                                         args.load_from, device=args.device,
                                         token_merge=args.token_merge,
                                         quant_int8=args.int8)
    out_dir = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(out_dir, exist_ok=True)

    writer = None
    n_out = 0
    try:
        with DepthServingEngine(model, input_size=args.input_size,
                                batch_size=args.batch_size,
                                device=args.device,
                                calib_batches=args.int8_calib) as engine:
            def render(rgb: np.ndarray, depth: np.ndarray) -> np.ndarray:
                vis = colorize_depth(depth, grayscale=args.grayscale,
                                     bgr=False)
                return side_by_side(rgb, vis) if args.side_by_side else vis

            def emit(i: int, rgb0: np.ndarray, fut) -> None:
                nonlocal writer, n_out
                depth = fut.result()
                if on_depth is not None:
                    on_depth(i, depth)
                frame = render(rgb0, depth)
                if writer is None:
                    fps = args.fps or max(
                        (fps_in or 30.0) / args.every_n, 1e-3)
                    writer = VideoWriter(args.output, frame.shape[1],
                                         frame.shape[0], fps=fps)
                writer.write_rgb(frame, quality=args.quality)
                n_out += 1

            # Bounded in-flight window: decode/encode overlap device
            # compute without buffering the whole video in host memory.
            # A VDA frame resolves once the window after its own has run:
            # up to 30 frames later.
            window = 64 if video else max(2 * args.batch_size, 2)
            stream = {"stream": "video"} if video else {}
            pending: list[tuple[int, np.ndarray, object]] = []
            fps_in = None
            for i, rgb, fps_in in _frames(args.input, args.every_n,
                                          args.max_frames):
                # engine.submit expects BGR (the cv2/serve convention)
                pending.append((i, rgb, engine.submit(rgb[..., ::-1],
                                                      **stream)))
                if len(pending) >= window:
                    emit(*pending.pop(0))
            if video and pending:
                engine.end_stream("video")
            for item in pending:
                emit(*item)
        stats = engine.stats()
    finally:
        # Finalize the container even on a mid-stream failure (engine
        # error, disk full, Ctrl-C): an unfinalized MP4 loses ALL
        # already-encoded frames; a finalized one is merely truncated.
        if writer is not None:
            writer.close()
    if n_out == 0:
        raise SystemExit(f"[video_depth] no frames decoded from "
                         f"{args.input}")
    print(f"[video_depth] wrote {n_out} frames -> {args.output}")
    return {"frames": n_out, "engine": stats}


if __name__ == "__main__":
    main()
