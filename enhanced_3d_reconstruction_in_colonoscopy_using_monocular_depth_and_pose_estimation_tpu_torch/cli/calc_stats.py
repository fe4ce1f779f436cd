"""Dataset mean/std statistics (the port of the JAX package's
``cli/calc_stats.py``, the reference's ``calculate_stats.py``).

Usage:
    python -m ...cli.calc_stats --ds simcol --data-dir <root> \\
        --train-list <txt> [--size 518] [--batch-size 16] [--device cuda]

Running sum / sum-of-squares over the RGB channels and over the valid
depth pixels of the training split, as the reference's transform
pipeline sees them: decoded and resized to ``size`` x ``size`` on the
loader's threads (``host_resize=True``; native-resolution statistics would
differ, and ``--size`` would be a silent no-op). The sums run on the card
unless ``--device cpu``, in f64.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Run the CLI. Returns ``rgb_mean``, ``rgb_std`` (3 each),
    ``depth_mean``, ``depth_std`` and ``valid_px``."""
    import torch

    from ..core.device import resolve_device
    from ..data.c3vd import C3VDDataset
    from ..data.loader import PrefetchLoader
    from ..data.simcol import SimColDataset

    p = argparse.ArgumentParser()
    p.add_argument("--ds", default="simcol", choices=["simcol", "c3vd"])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--train-list", required=True)
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="where the sums run: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cls = SimColDataset if args.ds == "simcol" else C3VDDataset
    dataset = cls(args.data_dir, args.train_list, args.size, "Train",
                  args.ds, host_resize=True)

    f64 = torch.float64
    psum = torch.zeros(3, dtype=f64, device=dev)
    psum_sq = torch.zeros(3, dtype=f64, device=dev)
    dsum = torch.zeros((), dtype=f64, device=dev)
    dsum_sq = torch.zeros((), dtype=f64, device=dev)
    n_px = 0
    n_d = torch.zeros((), dtype=torch.int64, device=dev)
    loader = PrefetchLoader(dataset, args.batch_size,
                            num_threads=args.num_workers)
    for batch in loader:
        imgs = torch.from_numpy(batch["image"]).to(dev)
        if imgs.dtype == torch.uint8:
            imgs = imgs.to(torch.float32) / 255.0
        deps = torch.from_numpy(np.ascontiguousarray(batch["depth"]))
        if deps.dtype == torch.uint16:
            deps = deps.to(torch.int32).to(torch.float32) / 65535.0
        deps = deps.to(dev)
        imgs = imgs.to(f64)
        psum += imgs.sum(dim=(0, 1, 2))
        psum_sq += (imgs ** 2).sum(dim=(0, 1, 2))
        n_px += imgs.shape[0] * imgs.shape[1] * imgs.shape[2]
        valid = (deps > 0) & torch.isfinite(deps)
        d = deps[valid].to(f64)
        dsum += d.sum()
        dsum_sq += (d ** 2).sum()
        n_d += valid.sum()

    rgb_mean = (psum / n_px).cpu().numpy()
    rgb_std = np.sqrt((psum_sq / n_px).cpu().numpy() - rgb_mean ** 2)
    n_d = int(n_d)
    d_mean = float(dsum) / max(n_d, 1)
    d_std = float(np.sqrt(float(dsum_sq) / max(n_d, 1) - d_mean ** 2))
    print(f"[{args.ds}] RGB mean: {rgb_mean}")
    print(f"[{args.ds}] RGB std:  {rgb_std}")
    print(f"[{args.ds}] depth mean: {d_mean:.6f} std: {d_std:.6f} "
          f"(valid px: {n_d})")
    return {"rgb_mean": rgb_mean, "rgb_std": rgb_std, "depth_mean": d_mean,
            "depth_std": d_std, "valid_px": n_d}


if __name__ == "__main__":
    main()
