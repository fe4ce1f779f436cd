"""Depth evaluation CLI (the port of the JAX package's
``cli/test_depth.py``, the reference's ``test_lightning.py``).

Usage (``--device cpu`` runs on the CPU, the card is the default):
    CHECKPOINT_PATH=<ckpt> python -m ...cli.test_depth dataset=simcol \\
        model=large

- ``CHECKPOINT_PATH`` is a torch ``.pth``/``.ckpt`` DAv2 state dict, or a
  directory of the port's own checkpoints (``core.checkpoint``: the best
  save by val_loss, else the newest). A directory of the JAX package's
  Orbax checkpoints raises: convert it first with ``orbax_to_torch.py``
  at the repo root (it needs jax).
- Per-procedure metrics for SimCol (the procedure parsed from the
  ``SyntheticColon_*/Frames_*`` path), mean/std aggregation, and overall
  metrics: the mean and std across procedures of their means (the
  reference's convention) and over all samples; combined SimCol + C3VD
  runs add per-source metrics with C3VD's l1 and rmse back in mm.
- The results go to ``$E3D_RESULTS_DIR`` (default
  ``test_lightning_results/``) as ``<ds_type>_results.json``.

Per-sample metrics are true per-sample values, as in the JAX package
(the reference appends the batch mean once per sample).

Under ``torchrun`` the mesh knobs are ``train_depth``'s
(``trainer.distributed``, ``mesh_data``, ``mesh_model``,
``tensor_parallel``, ``seq_parallel``, ``pipeline_parallel``,
``pipe_microbatches``, ``pipe_virtual``): the test loader shards each
batch over the ranks, the per-sample metrics are gathered over the ranks
and each rank keeps its own rows (an even split of a batch the loader
replicated), so every sample is counted exactly once, and each rank
writes its rows' results as ``<ds_type>_results_p<rank>.json``, as the
JAX package's processes do.
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np

METRIC_KEYS = ("d1", "abs_rel", "rmse", "l1")


def parse_procedure(dataset_field: str) -> str:
    """SyntheticColon_I/Frames_S1 -> 'SyntheticColon_I/S1' style key."""
    m = re.search(r"(SyntheticColon_(?:I{1,3}))", dataset_field)
    colon = m.group(1) if m else dataset_field.split("/")[0]
    m2 = re.search(r"Frames_([SBO]\d+)", dataset_field)
    frame = m2.group(1) if m2 else dataset_field.split("/")[-1]
    return f"{colon}/{frame}"


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the results it writes."""
    from ..core import config as cfglib
    from ..core.dtypes import policy_from_precision
    from ..data.preprocess import DevicePreprocessor
    from ..models.convert import load_or_init_depth_model
    import torch.distributed as dist

    from ..parallel import mesh as meshlib
    from ..train.depth_task import DepthTask
    from .train_depth import (build_datamodule, build_parallel,
                              parallel_knobs, resolve_max_depth,
                              split_device, unported_knobs)

    argv = sys.argv[1:] if argv is None else argv
    device, overrides = split_device(argv)
    config_root = os.environ.get("E3D_CONFIG_ROOT", "configs")
    cfg = cfglib.compose(config_root, "test_config", overrides)
    refused = unported_knobs(cfg, training=False)
    if refused:
        raise SystemExit("[test_depth] refused: " + "; ".join(refused))
    device, mesh = build_parallel(cfg, device)

    checkpoint_path = os.environ.get("CHECKPOINT_PATH")
    if not checkpoint_path:
        raise SystemExit("CHECKPOINT_PATH env var is required")

    datamodule = build_datamodule(dict(cfg.dataset))
    datamodule.rank, datamodule.world = mesh.rank, mesh.world
    datamodule.setup("test")

    max_depth = resolve_max_depth(cfg)
    combined = cfg.dataset.ds_type == "combined"
    max_depths = ((float(cfg.model.simcol_max_depth),
                   float(cfg.model.c3vd_max_depth) / 10.0)
                  if combined else None)

    policy = policy_from_precision(str(cfg.trainer.precision))
    token_merge = float(cfg.model.get("token_merge", 0.0))
    quant_int8 = bool(cfg.model.get("quant_int8", False))
    task = DepthTask(encoder=cfg.model.encoder,
                     min_depth=float(cfg.model.min_depth),
                     max_depth=max_depth, policy=policy,
                     grad_checkpoint=False, device=device,
                     device_mesh=mesh, token_merge=token_merge,
                     quant_int8=quant_int8, **parallel_knobs(cfg))
    model = task.prepare(load_or_init_depth_model(
        cfg.model.encoder, max_depth, checkpoint_path, device=device,
        dtype=policy.compute_dtype, token_merge=token_merge,
        quant_int8=quant_int8))

    pre = DevicePreprocessor(size=datamodule.size, device=device)
    per_proc: dict[str, dict[str, list[float]]] = {}
    overall: dict[str, list[float]] = {k: [] for k in METRIC_KEYS}
    src_names = {0: "SimCol", 1: "C3VD"}
    per_source: dict[str, dict[str, list[float]]] = {
        name: {k: [] for k in METRIC_KEYS} for name in src_names.values()
    } if combined else {}

    for batch in datamodule.test_loader():
        replicated = bool(batch.pop("_replicated", False))
        prepped = pre(batch, train=False, max_depths=max_depths)
        prepped["_replicated"] = replicated
        sample_metrics = task.eval_step_per_sample(model, prepped)
        meta = list(batch["dataset"])
        sources = (np.asarray(batch["source"]).astype(int)
                   if combined and "source" in batch else None)
        if mesh.world > 1:
            # Exactly-once rows: the metrics of every rank's rows,
            # gathered, then this rank's slice: its own loader rows, or an
            # even split of a replicated batch (every rank holds it all).
            if not replicated:
                sample_metrics = {k: meshlib.gather_rows(
                    meshlib.slot_of(v, mesh.model_group,
                                    [len(meta)] * mesh.model),
                    dist.group.WORLD)
                    for k, v in sample_metrics.items()}
            nb = len(next(iter(sample_metrics.values())))
            if replicated:
                lo = mesh.rank * nb // mesh.world
                hi = (mesh.rank + 1) * nb // mesh.world
                meta = meta[lo:hi]
                if sources is not None:
                    sources = sources[lo:hi]
            else:
                lo = mesh.rank * (nb // mesh.world)
                hi = lo + len(meta)
            sample_metrics = {k: v[lo:hi] for k, v in sample_metrics.items()}
        sample_metrics = {k: v.float().cpu().numpy()
                          for k, v in sample_metrics.items()}
        for i, ds_field in enumerate(meta):
            proc = parse_procedure(str(ds_field))
            bucket = per_proc.setdefault(proc, {k: [] for k in METRIC_KEYS})
            # C3VD trains in the /10 cm convention; report l1/rmse back
            # in mm.
            mm = 10.0 if sources is not None and sources[i] == 1 else 1.0
            for k in METRIC_KEYS:
                val = float(sample_metrics[k][i])
                if k in ("l1", "rmse"):
                    val *= mm
                bucket[k].append(val)
                overall[k].append(val)
                if sources is not None:
                    per_source[src_names[sources[i]]][k].append(val)

    # Per-procedure means first, then overall = mean/std ACROSS
    # PROCEDURES (the reference's definition of its recorded results).
    proc_means = {
        proc: {k: float(np.mean(v)) for k, v in buckets.items()}
        for proc, buckets in sorted(per_proc.items())
    }
    results = {
        "procedure_metrics": {
            proc: {k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
                   for k, v in buckets.items()}
            for proc, buckets in sorted(per_proc.items())
        },
        "overall_metrics": {
            k: {"mean": float(np.mean([m[k] for m in proc_means.values()])),
                "std": float(np.std([m[k] for m in proc_means.values()]))}
            for k in METRIC_KEYS
        },
        "overall_metrics_per_sample": {
            k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
            for k, v in overall.items()
        },
        "checkpoint": checkpoint_path,
        "encoder": cfg.model.encoder,
        "ds_type": cfg.dataset.ds_type,
    }
    if combined:
        results["source_metrics"] = {
            name: {
                "count": len(next(iter(buckets.values()))),
                **{k: {"mean": float(np.mean(v)) if v else float("nan"),
                       "std": float(np.std(v)) if v else float("nan")}
                   for k, v in buckets.items()},
            }
            for name, buckets in per_source.items()
        }

    print("\n== per-procedure metrics ==")
    for proc, means in proc_means.items():
        line = " ".join(f"{k}={v:.6f}" for k, v in means.items())
        print(f"  {proc}: {line}")
    print("== overall (across procedures, reference convention) ==")
    for k, v in results["overall_metrics"].items():
        print(f"  {k}: {v['mean']:.6f} +- {v['std']:.6f}")

    out_dir = os.environ.get("E3D_RESULTS_DIR", "test_lightning_results")
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_p{mesh.rank}" if mesh.world > 1 else ""
    out_path = os.path.join(out_dir,
                            f"{cfg.dataset.ds_type}_results{suffix}.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2)
    print(f"[test_depth] wrote {out_path}")
    # Returned, not written: the rows this rank counted, by procedure.
    return {**results, "samples": per_proc}


if __name__ == "__main__":
    main()
