"""Pose-estimation training CLI (the port of the JAX package's
``cli/train_pose.py``, the reference's ``pose_estimation_lightning.py``).

Usage (Hydra-style overrides; ``--device cpu`` runs on the CPU, the card
is the default):
    python -m ...cli.train_pose model.lr=1e-4 trainer.max_epochs=30

Composes ``configs/pose_estimation/pose_estimation.yaml`` (under
``E3D_CONFIG_ROOT``, default ``configs``), writes the run dir with a
config snapshot (``.hydra/``), trains ``PoseTask`` on SimCol pairs through
``fit_pose`` (checkpoints under ``checkpoints/pose_estimation/<experiment>``),
then tests: per-procedure trajectories (the procedure parsed as
``test_depth`` parses it) get ATE/RTE/ROTE, and the overall results are
the mean over procedures. The results go to ``$E3D_RESULTS_DIR`` (default
``test_lightning_results/``) as ``pose_results.json``.

Under ``torchrun`` (``trainer.distributed``, ``trainer.mesh_data`` and
``mesh_model``, as ``train_depth`` takes them) the pose step is data
parallel (``PoseTask``); rank 0 writes the snapshot, the metrics, the
checkpoints and the results, which every rank computes on the whole test
set.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the results it writes, with the ``run_dir`` and
    ``ckpt_dir``."""
    import torch

    from ..core import config as cfglib
    from ..core.dtypes import policy_from_precision
    from ..core.logging import MetricLogger, NullLogger
    from ..data.pose import PoseDataModule
    from ..train.loop import fit_pose
    from ..train.pose_task import PoseTask
    from ..utils.experiment import pose_experiment_id
    from .test_depth import parse_procedure
    from .train_depth import build_parallel, split_device, unported_knobs

    argv = sys.argv[1:] if argv is None else argv
    device, overrides = split_device(argv)
    config_root = os.environ.get("E3D_CONFIG_ROOT", "configs")
    cfg = cfglib.compose(config_root, "pose_estimation/pose_estimation",
                         overrides)
    refused = unported_knobs(cfg)
    if refused:
        raise SystemExit("[train_pose] refused: " + "; ".join(refused))
    device, mesh = build_parallel(cfg, device)

    run_dir = cfglib.run_dir(cfg, cfg.run_dir_template)
    if mesh.rank == 0:
        cfglib.snapshot(cfg, os.path.join(run_dir, ".hydra"))
    exp_id = pose_experiment_id(cfg.model.lr, cfg.dataset.batch_size,
                                cfg.trainer.max_epochs)
    print(f"[train_pose] experiment: {exp_id}; run dir: {run_dir}")

    datamodule = PoseDataModule(**dict(cfg.dataset))
    datamodule.rank, datamodule.world = mesh.rank, mesh.world
    datamodule.setup()
    steps_per_epoch = max(1, len(datamodule.train_loader()))
    total_steps = steps_per_epoch * int(cfg.trainer.max_epochs)

    task = PoseTask(
        in_channels=int(cfg.model.in_channels),
        lr=float(cfg.model.lr),
        weight_decay=float(cfg.model.weight_decay),
        pct_start=float(cfg.model.pct_start),
        div_factor=float(cfg.model.div_factor),
        beta=float(cfg.model.beta),
        total_steps=total_steps,
        clip_norm=float(cfg.trainer.gradient_clip_val),
        policy=policy_from_precision(str(cfg.trainer.precision)),
        cycle_momentum=bool(cfg.model.get("cycle_momentum", False)),
        device=device,
        device_mesh=mesh,
    )
    logger = MetricLogger(run_dir, stdout_every=int(cfg.trainer.get(
        "log_every_n_steps", 100))) if mesh.rank == 0 else NullLogger()
    ckpt_dir = os.path.join("checkpoints", "pose_estimation", exp_id)
    state = fit_pose(
        task, datamodule,
        max_epochs=int(cfg.trainer.max_epochs),
        log_dir=run_dir, ckpt_dir=ckpt_dir,
        patience=int(cfg.trainer.get("early_stop_patience", 20)),
        logger=logger,
        max_steps=(int(cfg.trainer.max_steps)
                   if "max_steps" in cfg.trainer else None),
        log_every=int(cfg.trainer.get("log_every_n_steps", 1)),
        resume=bool(cfg.trainer.get("resume", False)),
    )

    # ---- test with per-procedure trajectory metrics ----
    per_proc: dict[str, dict[str, list]] = {}
    for batch in datamodule.test_loader():
        _, pred = task.eval_step(state, batch)
        for i, ds_field in enumerate(batch["dataset"]):
            bucket = per_proc.setdefault(parse_procedure(str(ds_field)),
                                         {"pred": [], "gt": []})
            bucket["pred"].append(pred[i])
            bucket["gt"].append(torch.as_tensor(batch["target"][i]))

    proc_results = {}
    for proc, bucket in sorted(per_proc.items()):
        metrics = task.trajectory_metrics(torch.stack(bucket["pred"]),
                                          torch.stack(bucket["gt"]))
        proc_results[proc] = {k: float(v) for k, v in metrics.items()}
        print(f"  {proc}: " + " ".join(
            f"{k}={v:.6f}" for k, v in proc_results[proc].items()))

    # Overall = the mean over procedures' trajectories (the reference's
    # convention): one trajectory through all of them would take each
    # seam between recordings for motion.
    overall = {}
    if proc_results:
        keys = next(iter(proc_results.values())).keys()
        overall = {k: float(np.mean([m[k] for m in proc_results.values()]))
                   for k in keys}
    print("== overall trajectory (mean over procedures) ==")
    for k, v in overall.items():
        print(f"  {k}: {v:.6f}")

    out_dir = os.environ.get("E3D_RESULTS_DIR", "test_lightning_results")
    out_path = os.path.join(out_dir, "pose_results.json")
    results = {"procedure_metrics": proc_results,
               "overall_metrics": overall, "experiment": exp_id}
    if mesh.rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2)
        print(f"[train_pose] wrote {out_path}")
    mesh.barrier()
    logger.close()
    return {**results, "run_dir": run_dir, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
