"""Single/batch depth inference CLI (the port of the JAX package's
``cli/infer.py``, the reference's ``run.py``).

Usage:
    python -m ...cli.infer --encoder vitl --load-from ckpt.pth \\
        --max-depth 20 -i images_dir -d testing [-o outdir] \\
        [--input-size 518] [--save-numpy] [--pred-only] [--grayscale] \\
        [--batch-size 8] [--device cuda]

Input enumeration (single file, txt list, SimCol glob, ``frame_*.jpg``),
``infer_image`` per frame at batch 1 or one ``BatchedRunner`` per frame
resolution at batch > 1, skip-existing idempotence, min-max colormap
output with an optional side-by-side composite, the ``_OP`` output-dir
convention. Frames are read by the port's PNG and JPEG readers
(``data.io.decode_rgb``), and PNGs written by its own writer
(``media.imageio``): an unreadable frame is skipped with a warning that
names its format. The model runs on the card unless ``--device cpu``.

The speed dials ``--token-merge``, ``--int8`` and ``--int8-calib K``
act as in the JAX package; ``--int8-calib`` needs ``--int8`` and
``--batch-size`` > 1, and holds the first K batches of each resolution
to calibrate one frozen-scale runner.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from pathlib import Path

import numpy as np

from ..data.io import decode_rgb
from . import add_speed_dials, check_speed_dials


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Depth Anything V2 (H100)")
    p.add_argument("--encoder", default="vitl",
                   choices=["vits", "vitb", "vitl", "vitg", "vitt"])
    p.add_argument("--load-from", required=False, default=None)
    p.add_argument("--max-depth", type=float, default=20.0)
    p.add_argument("-i", "--img-path", required=True)
    p.add_argument("-o", "--outdir", default=None)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("-d", "--ds_type", default="testing",
                   choices=["simcol", "testing"])
    p.add_argument("--save-numpy", action="store_true")
    p.add_argument("--pred-only", action="store_true")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1 batches same-resolution frames on the device "
                        "(1 = the reference's per-frame loop)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")
    add_speed_dials(p)
    args = p.parse_args(argv)
    check_speed_dials(p, args)
    if args.int8_calib and args.batch_size < 2:
        p.error("--int8-calib requires --int8 and --batch-size>1")
    return args


def enumerate_inputs(args) -> list[str]:
    """The reference's input enumeration; sets ``args.outdir`` when it is
    not given."""
    filenames: list[str] = []
    if os.path.isfile(args.img_path):
        if args.img_path.endswith("txt"):
            with open(args.img_path, "r", encoding="utf-8") as f:
                filenames = [line for line in f.read().splitlines() if line]
        else:
            filenames = [args.img_path]
        if args.outdir is None:
            args.outdir = str(Path(args.img_path).parent)
    elif args.ds_type == "simcol":
        base = Path(args.img_path)
        for suffix in ["I", "II", "III"]:
            pattern = f"SyntheticColon_{suffix}/Frames_*/FrameBuffer_*.png"
            filenames.extend(sorted(glob.glob(str(base / pattern))))
        if args.outdir is None:
            args.outdir = str(base)
    else:
        base = Path(args.img_path)
        filenames.extend(sorted(glob.glob(str(base / "frame_*.jpg"))))
        if args.outdir is None:
            args.outdir = str(base)
    return filenames


def output_paths(args, filename: str) -> tuple[Path, str]:
    """The reference's output layout (including the ``_OP`` folders of a
    SimCol tree)."""
    base_name = Path(filename).stem
    if os.path.isfile(args.img_path):
        return Path(args.outdir), base_name
    if args.ds_type == "simcol":
        rel = Path(filename).relative_to(Path(args.img_path))
        parent = rel.parent
        return (Path(args.img_path) / parent.parent / f"{parent.name}_OP",
                base_name)
    rel = Path(filename).relative_to(Path(args.img_path))
    return Path(args.outdir) / rel.parent, base_name


def _imread_bgr(path: str) -> np.ndarray | None:
    """An input frame as BGR uint8 (cv2's order, which the model's entry
    points take); None, with a warning naming why, if it is unreadable."""
    try:
        return np.ascontiguousarray(decode_rgb(path)[..., ::-1])
    except (OSError, ValueError) as exc:
        print(f"Warning: unreadable image skipped: {path} ({exc})")
        return None


def main(argv=None) -> dict:
    """Run the CLI. Returns the counts it prints (``total``, ``skipped``,
    ``processed``, ``unreadable``), its wall ``seconds`` and the
    ``model_seconds`` spent in the model's entry points (upload, forward,
    readback) and the ``runner_seconds`` spent building the batched
    runners, with ``--int8-calib``'s calibration forwards."""
    from ..media.colormap import colorize_depth, side_by_side
    from ..media.imageio import write_png
    from ..models.convert import load_or_init_depth_model
    from ..models.depth_anything import BatchedRunner, infer_image

    t_start = time.perf_counter()
    args = parse_args(argv)
    model = load_or_init_depth_model(args.encoder, args.max_depth,
                                     args.load_from, device=args.device,
                                     token_merge=args.token_merge,
                                     quant_int8=args.int8)

    filenames = enumerate_inputs(args)
    os.makedirs(args.outdir, exist_ok=True)
    if args.batch_size == 1 and len(filenames) > 8:
        print("Hint: --batch-size 1 is the reference's per-frame loop; "
              "--batch-size 8 batches frames of one resolution on the "
              "device.")

    # Skip-existing first (the reference's idempotence).
    todo = []
    skipped = 0
    for filename in filenames:
        out_folder, base_name = output_paths(args, filename)
        if (out_folder / f"{base_name}.png").exists():
            skipped += 1
        else:
            todo.append((filename, out_folder, base_name))

    def write_outputs(filename, out_folder, base_name, raw, depth):
        out_folder.mkdir(parents=True, exist_ok=True)
        if args.save_numpy:
            np.save(str(out_folder / f"{base_name}.npy"), depth)
        rendered = colorize_depth(depth, grayscale=args.grayscale)
        png = rendered if args.pred_only else side_by_side(raw, rendered)
        write_png(str(out_folder / f"{base_name}.png"), png, bgr=True)

    unreadable = 0
    model_seconds = 0.0
    runner_seconds = 0.0
    if args.batch_size > 1:
        # Stream in resolution-keyed chunks of batch_size: decode lazily,
        # flush each full chunk, never hold the whole input set in memory;
        # one runner per resolution. With --int8-calib K the first K
        # batches of a resolution are held, so its scales are calibrated
        # once and every later flush reuses the frozen runner.
        chunks: dict[tuple, list] = {}
        runners: dict[tuple, BatchedRunner] = {}
        calib_hold = max(1, args.int8_calib) * args.batch_size

        def flush(shape, final=False):
            nonlocal model_seconds, runner_seconds
            group = chunks.get(shape, [])
            if not group:
                return
            runner = runners.get(shape)
            if runner is None:
                if args.int8_calib and len(group) < calib_hold and not final:
                    return  # keep gathering the calibration set
                t0 = time.perf_counter()
                runner = runners[shape] = BatchedRunner(
                    model, shape, args.input_size, args.batch_size,
                    calib_frames=[raw for _, raw in group],
                    calib_batches=args.int8_calib)
                runner_seconds += time.perf_counter() - t0
            del chunks[shape]
            t0 = time.perf_counter()
            depths = runner([raw for _, raw in group])
            model_seconds += time.perf_counter() - t0
            for (item, raw), depth in zip(group, depths):
                write_outputs(*item, raw, depth)

        for item in todo:
            raw = _imread_bgr(item[0])
            if raw is None:
                unreadable += 1
                continue
            shape = raw.shape[:2]
            chunks.setdefault(shape, []).append((item, raw))
            if len(chunks[shape]) >= args.batch_size:
                flush(shape)
        for shape in list(chunks):
            flush(shape, final=True)
    else:
        for filename, out_folder, base_name in todo:
            raw = _imread_bgr(filename)
            if raw is None:
                unreadable += 1
                continue
            t0 = time.perf_counter()
            depth = infer_image(model, raw, args.input_size)
            model_seconds += time.perf_counter() - t0
            write_outputs(filename, out_folder, base_name, raw, depth)

    processed = len(filenames) - skipped - unreadable
    print("\nProcessing complete:")
    print(f"- Total files: {len(filenames)}")
    print(f"- Skipped existing: {skipped}")
    print(f"- Newly processed: {processed}")
    return {"total": len(filenames), "skipped": skipped,
            "processed": processed, "unreadable": unreadable,
            "seconds": time.perf_counter() - t_start,
            "model_seconds": model_seconds, "runner_seconds": runner_seconds}


if __name__ == "__main__":
    main()
