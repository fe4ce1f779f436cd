"""Model-driven per-frame point clouds (the port of the JAX package's
``cli/pointcloud_model.py``, the reference's ``depth_to_pointcloud_dav2.py``).

Usage:
    python -m ...cli.pointcloud_model --encoder vitl --load-from ckpt \\
        --max-depth 20 -i <dataset_root> -o out/ [--max-frames N] \\
        [--device cuda]

Runs the depth model on each frame (``infer_image``, on the card unless
``--device cpu``), back-projects it with the pinhole model
(x = (u - cx) z / fx, ...; depth in metres, truncated at max depth + 1)
with the per-SyntheticColon ``cam.txt`` (else ``UnityCam/cam.txt``), and
writes one PLY per frame. The speed dials ``--token-merge`` and
``--int8`` act as in the JAX package (which has no ``--int8-calib`` here).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from . import add_speed_dials


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--encoder", default="vitl",
                   choices=["vits", "vitb", "vitl", "vitg", "vitt"])
    p.add_argument("--load-from", default=None)
    p.add_argument("--max-depth", type=float, default=20.0)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")
    add_speed_dials(p, calib=False)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI. Returns the number of ``frames`` written, the wall
    ``seconds`` of ``main()`` (model set-up included) and the
    ``model_seconds`` spent in ``infer_image``."""
    import torch

    from ..data.io import decode_rgb
    from ..models.convert import load_or_init_depth_model
    from ..models.depth_anything import infer_image
    from ..recon import backproject_depth, load_intrinsics, write_ply

    t_start = time.perf_counter()
    args = parse_args(argv)
    model = load_or_init_depth_model(args.encoder, args.max_depth,
                                     args.load_from, device=args.device,
                                     token_merge=args.token_merge,
                                     quant_int8=args.int8)
    dev = next(model.parameters()).device

    frames = sorted(glob.glob(os.path.join(
        args.input, "SyntheticColon_*", "Frames_*", "FrameBuffer_*.png")))
    if not frames:
        frames = sorted(glob.glob(os.path.join(args.input, "*.png")))
    if args.max_frames:
        frames = frames[:args.max_frames]
    if not frames:
        raise SystemExit(f"no frames under {args.input}")

    os.makedirs(args.outdir, exist_ok=True)
    model_seconds = 0.0
    for frame in frames:
        colon_dir = os.path.dirname(os.path.dirname(frame))
        cam = os.path.join(colon_dir, "cam.txt")
        if not os.path.exists(cam):
            cam = os.path.join(args.input, "UnityCam", "cam.txt")
        fx, fy, cx, cy = load_intrinsics(cam)

        rgb = decode_rgb(frame)
        t0 = time.perf_counter()
        depth = infer_image(model, np.ascontiguousarray(rgb[..., ::-1]),
                            args.input_size)
        model_seconds += time.perf_counter() - t0

        pts, cols, valid = backproject_depth(
            torch.from_numpy(depth).to(dev), fx, fy, cx, cy,
            color=torch.from_numpy(rgb).to(dev),  # uint8: scaled /255
            depth_scale=1.0, depth_trunc=float(args.max_depth) + 1.0)
        name = os.path.splitext(os.path.basename(frame))[0]
        out_path = os.path.join(args.outdir, f"{name}.ply")
        write_ply(out_path, pts[valid].cpu().numpy(),
                  colors=cols[valid].cpu().numpy())
        print(f"[pointcloud_model] wrote {out_path}")
    return {"frames": len(frames), "model_seconds": model_seconds,
            "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
