"""Video -> frames CLI (the port of the JAX package's
``cli/video_to_images.py``, the reference's ``video_to_images.py``).

Usage:
    python -m ...cli.video_to_images --video_path v.avi --output_dir out/ \\
        [--config configs/video_to_image_config.yaml] [--start_time S]
        [--end_time S] [--test] [--test_frames N]

The YAML config (read by the port's YAML subset, ``core/yamlsubset.py``)
is merged with the flags, which win. Frames are extracted by
``media.video.video_to_frames`` on the host (MJPEG AVI/MP4: the stored
JPEGs are copied, or decoded, cropped and re-encoded); there is no device
work.
"""

from __future__ import annotations

import argparse

from ..core import yamlsubset
from ..media.video import video_to_frames


def main(argv=None) -> int:
    """Run the CLI. Returns the number of frames written."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--video_path", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--start_time", type=float, default=None)
    p.add_argument("--end_time", type=float, default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_frames", type=int, default=10)
    args = p.parse_args(argv)

    cfg: dict = {}
    if args.config:
        cfg = yamlsubset.load_file(args.config) or {}
    # CLI overrides win over the YAML (the reference's merge order).
    for key in ("video_path", "output_dir", "start_time", "end_time"):
        val = getattr(args, key)
        if val is not None:
            cfg[key] = val

    if not cfg.get("video_path") or not cfg.get("output_dir"):
        raise SystemExit("video_path and output_dir are required "
                         "(via --config or flags)")

    n = video_to_frames(
        cfg["video_path"], cfg["output_dir"],
        start_time=float(cfg.get("start_time") or 0.0),
        end_time=cfg.get("end_time"),
        crop=cfg.get("crop"),
        test=args.test, test_frames=args.test_frames)
    print(f"[video_to_images] wrote {n} frames to {cfg['output_dir']}")
    return n


if __name__ == "__main__":
    main()
