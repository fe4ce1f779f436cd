"""Batch metric calculation over prediction dirs (the port of the JAX
package's ``cli/calc_metrics.py``, the reference's
``calculate_metrics.py``).

Usage:
    python -m ...cli.calc_metrics [--dataset-root ./datasets/SyntheticColon/]
        [--device cuda]

Walks every ``SyntheticColon_*/Frames_*`` against its ``Frames_*_OP``
prediction dir, reads 16-bit depths as ``cv2.imread(IMREAD_ANYDEPTH)``
reads them (``data.io.imread_anydepth``: gray at the file's depth, libpng's
RGB->gray for a colour PNG) as millimetres and converts them to metres
(/1000), masks invalid pixels (zero/inf), computes delta 1.25/1.25^2/
1.25^3, rmse, mae, abs_rel (|d|.mean / gt.mean) and sq_rel, then
per-procedure / per-colon / overall averages. The metrics run on the card
unless ``--device cpu``; their terms are f32, as the reference's, and
their means are taken in f64.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

METRICS = ("rmse", "mae", "abs_rel", "sq_rel", "delta1", "delta2", "delta3")


def load_depth_map(path: str, device: str | torch.device = "cpu"
                   ) -> torch.Tensor:
    from ..data.io import imread_anydepth

    if not os.path.exists(path):
        raise ValueError(f"Could not load depth map: {path}")
    depth = imread_anydepth(path).astype(np.float32) / 1000.0  # mm -> m
    return torch.from_numpy(depth).to(device)


def calculate_metrics(gt: torch.Tensor, pred: torch.Tensor
                      ) -> dict[str, float]:
    valid = (gt > 0) & (pred > 0) & torch.isfinite(gt) & torch.isfinite(pred)
    gt, pred = gt[valid], pred[valid]
    if gt.numel() == 0:
        return {k: float("nan") for k in METRICS}
    thresh = torch.maximum(gt / pred, pred / gt)
    f64 = torch.float64
    err = gt - pred
    sq = (err ** 2).mean(dtype=f64)
    gt_mean = gt.mean(dtype=f64)
    return {
        "rmse": float(torch.sqrt(sq)),
        "mae": float(err.abs().mean(dtype=f64)),
        "abs_rel": float(err.abs().mean(dtype=f64) / gt_mean),
        "sq_rel": float(sq / gt_mean),
        "delta1": float((thresh < 1.25).to(f64).mean()),
        "delta2": float((thresh < 1.25 ** 2).to(f64).mean()),
        "delta3": float((thresh < 1.25 ** 3).to(f64).mean()),
    }


def process_scene(gt_folder: str, pred_folder: str,
                  device: str | torch.device = "cpu") -> dict | None:
    rows = []
    for gt_file in sorted(glob.glob(os.path.join(gt_folder, "*.png"))):
        pred_file = os.path.join(pred_folder, os.path.basename(gt_file))
        if not os.path.exists(pred_file):
            print(f"Warning: Missing prediction for "
                  f"{os.path.basename(gt_file)}")
            continue
        rows.append(calculate_metrics(load_depth_map(gt_file, device),
                                      load_depth_map(pred_file, device)))
    if not rows:
        return None
    return {k: float(np.mean([r[k] for r in rows])) for k in METRICS}


def main(argv=None) -> dict:
    """Run the CLI. Returns the per-procedure metrics by colon and the
    average over every procedure under ``"overall"`` (absent when no
    procedure had predictions)."""
    from ..core.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--dataset-root", default="./datasets/SyntheticColon/")
    p.add_argument("--device", default="cuda",
                   help="where the metrics run: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    out: dict = {}
    all_metrics = []
    for colon_dir in sorted(glob.glob(os.path.join(args.dataset_root,
                                                   "SyntheticColon_*"))):
        colon = os.path.basename(colon_dir)
        results = {}
        for proc_dir in sorted(glob.glob(os.path.join(colon_dir,
                                                      "Frames_*"))):
            if proc_dir.endswith("_OP"):
                continue
            pred_dir = proc_dir + "_OP"
            if not os.path.exists(pred_dir):
                print(f"Warning: Missing predictions directory for "
                      f"{os.path.basename(proc_dir)}")
                continue
            scene = process_scene(proc_dir, pred_dir, dev)
            if scene:
                results[os.path.basename(proc_dir)] = scene

        if not results:
            continue
        out[colon] = results
        print(f"\nResults for {colon}:")
        for proc, metrics in results.items():
            print(f"  {proc}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
        avg = {k: float(np.mean([m[k] for m in results.values()]))
               for k in METRICS}
        print(f"  [avg {colon}] " + " ".join(
            f"{k}={v:.4f}" for k, v in avg.items()))
        all_metrics.extend(results.values())

    if all_metrics:
        print("\nOverall Average:")
        out["overall"] = {}
        for k in METRICS:
            out["overall"][k] = float(np.mean([m[k] for m in all_metrics]))
            print(f"  {k}: {out['overall'][k]:.4f}")
    return out


if __name__ == "__main__":
    main()
