"""AVI -> MP4 CLI (the port of the JAX package's ``cli/convert_video.py``,
the reference's ``data_processing/convert_avi_to_mp4.py``): a lossless
remux of an MJPEG AVI."""

from __future__ import annotations

import argparse

from ..media.video import convert_avi_to_mp4


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("input", help="input .avi path")
    p.add_argument("-o", "--output", default=None, help="output .mp4 path")
    args = p.parse_args(argv)
    out = convert_avi_to_mp4(args.input, args.output)
    print(f"[convert_video] wrote {out}")


if __name__ == "__main__":
    main()
