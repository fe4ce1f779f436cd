"""Command-line entry points of the port."""

from __future__ import annotations

import argparse


def add_speed_dials(p: argparse.ArgumentParser, calib: bool = True) -> None:
    """The JAX package's speed-dial flags, which the port parses and
    refuses (``refuse_speed_dials``). ``calib=False`` leaves out
    ``--int8-calib``, for entry points whose JAX counterpart has no such
    flag."""
    p.add_argument("--token-merge", type=float, default=0.0,
                   help="ToMe token-merge fraction (not in the port yet)")
    p.add_argument("--int8", action="store_true",
                   help="dynamic-int8 encoder matmuls (not in the port yet)")
    if calib:
        p.add_argument("--int8-calib", type=int, default=0, metavar="K",
                       help="static int8 scales from K batches (not in the "
                            "port yet)")


def refuse_speed_dials(p: argparse.ArgumentParser,
                       args: argparse.Namespace) -> None:
    """Exit with code 2 when a speed dial is set: the port has no token
    merging or int8 yet."""
    calib = getattr(args, "int8_calib", 0)
    if calib and not args.int8:
        p.error("--int8-calib requires --int8")
    if args.token_merge or args.int8 or calib:
        p.error("--token-merge, --int8 and --int8-calib are not ported yet "
                "(ROADMAP, \"Speed dials\")")
