"""Offline SimCol challenge-format depth evaluation (the port of the JAX
package's ``cli/eval_depth_offline.py``, the reference's
``eval_for_depth.py``).

Usage:
    python -m ...cli.eval_depth_offline [--input-path ./datasets/SyntheticColon/]
        [--size 475] [--no-strict] [--device cuda]

- the 9 fixed ``_OP`` test trajectories must be complete (601 frames for
  SyntheticColon_I, 1201 for II/III) unless ``--no-strict``;
- predictions are read as ``cv2.imread(IMREAD_GRAYSCALE)`` reads them
  (``data.io.imread_grayscale``: libpng's RGB->gray for a colour PNG) and
  divided by 255; the GT as ``IMREAD_UNCHANGED`` (16-bit), min-max
  normalized; the prediction's shape is asserted (default 475x475);
- under ``--no-strict`` a GT of another size is resized to the
  prediction's with cv2's ``INTER_LINEAR`` (``ops.resize.resize_linear``)
  and its valid mask with ``INTER_NEAREST``;
- per-trajectory and overall mean L1 / AbsRel / delta<1.1 / RMSE. The
  reference's "overall" reports only the last trajectory's values; here,
  as in the JAX package, the overall is a true mean over trajectories.

The resizes and the metrics run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

TEST_FOLDERS = [
    "SyntheticColon_I/Frames_S5_OP",
    "SyntheticColon_I/Frames_S10_OP",
    "SyntheticColon_I/Frames_S15_OP",
    "SyntheticColon_II/Frames_B5_OP",
    "SyntheticColon_II/Frames_B10_OP",
    "SyntheticColon_II/Frames_B15_OP",
    "SyntheticColon_III/Frames_O1_OP",
    "SyntheticColon_III/Frames_O2_OP",
    "SyntheticColon_III/Frames_O3_OP",
]
METRICS = ("l1", "abs_rel", "d1", "rmse")


def load_depth(pred_file: str, gt_file: str, expect_size: int,
               device: str | torch.device = "cpu"):
    """(pred, gt, valid_mask) tensors on ``device``."""
    from ..data.io import imread_grayscale, imread_unchanged
    from ..ops.resize import resize_linear, resize_nearest

    gt = imread_unchanged(gt_file.replace("FrameBuffer", "Depth")).astype(
        np.float32)
    gt = (gt - gt.min()) / max(gt.max() - gt.min(), 1e-12)
    pred = imread_grayscale(pred_file).astype(np.float32) / 255.0
    if expect_size and pred.shape != (expect_size, expect_size):
        raise AssertionError(
            f"Wrong size of predicted depth, expected "
            f"[{expect_size},{expect_size}], got {list(pred.shape)}")
    gt = torch.from_numpy(gt).to(device)
    pred = torch.from_numpy(pred).to(device)
    valid_mask = ~torch.isnan(gt)
    gt = torch.where(valid_mask, gt, 0.0)
    if gt.shape != pred.shape:
        gt = resize_linear(gt, tuple(pred.shape))
        # The mask must live on the RESIZED grid (--no-strict allows a
        # pred/GT size mismatch).
        valid_mask = resize_nearest(valid_mask.to(torch.uint8),
                                    tuple(pred.shape),
                                    channels_last=False).bool()
    return pred, gt, valid_mask


def eval_depth(pred: torch.Tensor, gt: torch.Tensor,
               valid_mask: torch.Tensor) -> tuple[float, ...]:
    """The reference's metric formulas: (l1, abs_rel, d1, rmse). The
    terms are f32, as the reference's; the means are taken in f64, so the
    card's and the CPU's agree whatever order they sum in."""
    pred_v = pred[valid_mask]
    gt_v = gt[valid_mask]
    eps = 1e-6
    f64 = torch.float64
    diff = pred_v - gt_v
    denom_ok = (gt_v >= 1e-6) & (gt_v <= 1.0)
    l1 = diff.abs().mean(dtype=f64)
    abs_rel = (diff.abs()[denom_ok] / (gt_v[denom_ok] + eps)).mean(dtype=f64)
    rmse = torch.sqrt((diff ** 2).mean(dtype=f64))
    thresh = torch.maximum(gt_v / (pred_v + eps),
                           (pred_v + eps) / (gt_v + eps))
    d1 = (thresh < 1.1).to(f64).mean()
    return tuple(float(v) for v in (l1, abs_rel, d1, rmse))


def main(argv=None) -> dict:
    """Run the CLI. Returns the per-trajectory means by folder and their
    mean under ``"overall"``."""
    from ..core.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--input-path", default="./datasets/SyntheticColon/")
    p.add_argument("--size", type=int, default=475)
    p.add_argument("--no-strict", action="store_true",
                   help="skip frame-count completeness asserts")
    p.add_argument("--device", default="cuda",
                   help="where the metrics run: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    root = args.input_path
    folders = [t for t in TEST_FOLDERS
               if os.path.isdir(os.path.join(root, t))] \
        if args.no_strict else TEST_FOLDERS

    # Enumerate once: the completeness check and the eval loop see the
    # same file set.
    traj_files: dict[str, list[str]] = {}
    for traj in folders:
        traj_dir = os.path.join(root, traj)
        assert os.path.exists(traj_dir), f"No input folder found: {traj_dir}"
        files = sorted(glob.glob(os.path.join(traj_dir, "Depth*.png"))) or \
            sorted(glob.glob(os.path.join(traj_dir, "FrameBuffer*.png")))
        traj_files[traj] = files
        if not args.no_strict:
            expect = 601 if "SyntheticColon_I/" in traj + "/" else 1201
            assert len(files) == expect, f"Predictions missing in {traj}"

    results: dict[str, dict[str, float]] = {}
    overall = {k: [] for k in METRICS}
    for traj in folders:
        files = traj_files[traj]
        stats = {k: [] for k in METRICS}
        gt_dir = os.path.join(root, traj[:-3] if traj.endswith("_OP")
                              else traj)
        for path in files:
            gt_path = os.path.join(gt_dir, os.path.basename(path))
            pred, gt, mask = load_depth(path, gt_path,
                                        0 if args.no_strict else args.size,
                                        dev)
            for k, v in zip(METRICS, eval_depth(pred, gt, mask)):
                stats[k].append(v)
        print(f"Results for trajectory {traj}:")
        results[traj] = {}
        for k in stats:
            mean = float(np.mean(stats[k]))
            print(f"  Mean {k}: {mean:.6f}")
            results[traj][k] = mean
            overall[k].append(mean)

    print("\nOverall Results (mean over trajectories):")
    results["overall"] = {}
    for k in overall:
        mean = float(np.mean(overall[k]))
        print(f"  {k}: {mean:.6f}")
        results["overall"][k] = mean
    return results


if __name__ == "__main__":
    main()
