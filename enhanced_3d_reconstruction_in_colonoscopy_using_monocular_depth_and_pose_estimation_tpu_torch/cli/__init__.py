"""Command-line entry points of the port."""

from __future__ import annotations

import argparse


def add_speed_dials(p: argparse.ArgumentParser, calib: bool = True) -> None:
    """The JAX package's speed-dial flags. ``calib=False`` leaves out
    ``--int8-calib``, for entry points whose JAX counterpart has no such
    flag."""
    p.add_argument("--token-merge", type=float, default=0.0,
                   help="ToMe token-merge fraction (0 = off): merge that "
                        "fraction of the patch tokens after the first "
                        "feature tap and run the later encoder blocks on "
                        "the shorter sequence")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 encoder projections and wide decoder "
                        "convs, with dynamic per-token scales "
                        "(inference only); on the H100 it currently takes "
                        "about twice bf16's device time, since the int8 "
                        "products are not yet a wgmma GEMM")
    if calib:
        p.add_argument("--int8-calib", type=int, default=0, metavar="K",
                       help="with --int8: freeze static activation scales "
                            "from the first K device batches of each "
                            "resolution instead of quantizing dynamically")


def check_speed_dials(p: argparse.ArgumentParser,
                      args: argparse.Namespace) -> None:
    """Exit with code 2 on ``--int8-calib`` without ``--int8``."""
    if getattr(args, "int8_calib", 0) and not args.int8:
        p.error("--int8-calib requires --int8")
