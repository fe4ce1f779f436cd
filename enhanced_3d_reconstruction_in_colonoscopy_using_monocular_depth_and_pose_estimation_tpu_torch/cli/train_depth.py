"""Depth fine-tuning CLI (the port of the JAX package's
``cli/train_depth.py``, the reference's ``main_lightning.py``).

Usage (Hydra-style overrides; ``--device cpu`` runs on the CPU, the card
is the default):
    python -m ...cli.train_depth dataset=simcol model=large \\
        dataset.batch_size=6 trainer.max_epochs=30 model.pct_start=0.05

Composes ``configs/default.yaml`` (under ``E3D_CONFIG_ROOT``, default
``configs``), seeds 42, builds the datamodule by ``dataset.ds_type``,
resolves the per-dataset max depth, writes the experiment's run dir with
a config snapshot (``.hydra/``), then runs ``fit_depth``: checkpoints on
val_loss under ``checkpoints/<ds_type>/<experiment>``, early stopping,
per-step LR logging to ``<run dir>/metrics.jsonl``.

``trainer.distill_from`` (a teacher checkpoint of
``trainer.distill_encoder``, vitl by default) adds the distillation term
of ``DepthTask``; ``trainer.debug_nans`` runs the fit under
``core.debug.nan_checks``. ``ds_type: pose`` builds the pose-pair
datamodule, as the JAX package does.

The parallel modes, one process per card under ``torchrun``
(``parallel.mesh``): ``trainer.distributed`` joins the process group
(also joined whenever torchrun's world holds more than one process);
``trainer.mesh_data``/``mesh_model`` lay the ranks out as the ('data',
'model') mesh; ``trainer.tensor_parallel``, ``seq_parallel``, ``fsdp``
(with ``fsdp_min_size``), ``pipeline_parallel``, ``pipe_microbatches``
and ``pipe_virtual`` are ``DepthTask``'s. Rank 0 writes the snapshot,
the metrics and the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


def build_datamodule(dataset_cfg: dict):
    from ..data.c3vd import C3VDDataModule
    from ..data.combined import CombinedDataModule
    from ..data.pose import PoseDataModule
    from ..data.simcol import SimColDataModule

    ds_type = dataset_cfg["ds_type"]
    if ds_type == "simcol":
        return SimColDataModule(**dataset_cfg)
    if ds_type == "c3vd":
        return C3VDDataModule(**dataset_cfg)
    if ds_type == "combined":
        return CombinedDataModule(**dataset_cfg)
    if ds_type == "pose":
        return PoseDataModule(**dataset_cfg)
    raise ValueError(f"unknown ds_type: {ds_type}")


def resolve_max_depth(cfg) -> float:
    """The per-dataset max depth."""
    ds = cfg.dataset.ds_type
    if ds == "simcol":
        return float(cfg.model.simcol_max_depth)
    if ds == "c3vd":
        return float(cfg.model.c3vd_max_depth)
    if ds == "combined":
        return float(cfg.model.simcol_max_depth)
    raise ValueError(ds)


def unported_knobs(cfg, training: bool = True) -> list[str]:
    """For ``training``, the speed dials, which apply to inference and
    ``test_depth`` only (the int8 ops have no backward); empty when the
    config runs on the port."""
    m = cfg.model
    if training and (float(m.get("token_merge", 0.0))
                     or bool(m.get("quant_int8", False))):
        return ["model.token_merge / model.quant_int8 apply to inference "
                "and test_depth, not to training (ROADMAP, \"Speed "
                "dials\")"]
    return []


def build_parallel(cfg, device: str):
    """Join the process group when asked (or when torchrun started more
    than one process) and lay the ranks out as the mesh of
    ``trainer.mesh_data`` x ``trainer.mesh_model``; returns (this rank's
    device, the mesh)."""
    from ..parallel import mesh as meshlib

    dev = meshlib.init_distributed(
        device, required=bool(cfg.trainer.get("distributed", False)))
    mesh = meshlib.build_mesh(meshlib.MeshSpec(
        data=int(cfg.trainer.get("mesh_data", -1)),
        model=int(cfg.trainer.get("mesh_model", 1))), dev)
    return dev, mesh


def parallel_knobs(cfg) -> dict:
    """``DepthTask``'s parallel arguments from ``cfg.trainer``."""
    t = cfg.trainer
    return dict(
        tensor_parallel=bool(t.get("tensor_parallel", False)),
        seq_parallel=bool(t.get("seq_parallel", False)),
        pipeline_parallel=int(t.get("pipeline_parallel", 0)),
        pipe_microbatches=int(t.get("pipe_microbatches", 0)),
        pipe_virtual=int(t.get("pipe_virtual", 1)))


def split_device(argv: list[str]) -> tuple[str, list[str]]:
    """``--device`` (default ``cuda``) and the remaining overrides."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    args, overrides = p.parse_known_args(argv)
    return args.device, overrides


def main(argv: list[str] | None = None) -> dict[str, str]:
    """Run the CLI; returns its ``run_dir`` and ``ckpt_dir``."""
    from ..core import config as cfglib
    from ..core.debug import nan_checks, profile_trace
    from ..core.dtypes import policy_from_precision
    from ..core.logging import MetricLogger, NullLogger
    from ..models.convert import (load_or_init_depth_model,
                                  load_torch_state_dict)
    from ..train.depth_task import DepthTask
    from ..train.loop import fit_depth
    from ..utils.experiment import experiment_id

    argv = sys.argv[1:] if argv is None else argv
    device, overrides = split_device(argv)
    config_root = os.environ.get("E3D_CONFIG_ROOT", "configs")
    cfg = cfglib.compose(config_root, "default", overrides)
    refused = unported_knobs(cfg)
    if refused:
        raise SystemExit("[train_depth] refused: " + "; ".join(refused))
    device, mesh = build_parallel(cfg, device)

    run_dir = cfglib.run_dir(cfg, cfg.run_dir_template)
    if mesh.rank == 0:
        cfglib.snapshot(cfg, os.path.join(run_dir, ".hydra"))

    exp_id = experiment_id(
        cfg.model.encoder, cfg.model.encoder_lr, cfg.model.decoder_lr,
        cfg.dataset.batch_size, cfg.trainer.max_epochs, cfg.dataset.ds_type,
        cfg.model.pct_start)
    print(f"[train_depth] experiment: {exp_id}")
    print(f"[train_depth] run dir: {run_dir}")

    datamodule = build_datamodule(dict(cfg.dataset))
    datamodule.rank, datamodule.world = mesh.rank, mesh.world
    datamodule.setup("fit")

    accum = int(cfg.trainer.get("accumulate_grad_batches", 1))
    steps_per_epoch = max(1, -(-len(datamodule.train_loader()) // accum))
    total_steps = steps_per_epoch * int(cfg.trainer.max_epochs)

    max_depth = resolve_max_depth(cfg)
    combined = cfg.dataset.ds_type == "combined"
    max_depths = ((float(cfg.model.simcol_max_depth),
                   float(cfg.model.c3vd_max_depth) / 10.0)
                  if combined else None)

    task = DepthTask(
        encoder=cfg.model.encoder,
        min_depth=float(cfg.model.min_depth),
        max_depth=max_depth,
        encoder_lr=float(cfg.model.encoder_lr),
        decoder_lr=float(cfg.model.decoder_lr),
        pct_start=float(cfg.model.pct_start),
        div_factor=float(cfg.model.div_factor),
        total_steps=total_steps,
        grad_accum=accum,
        clip_norm=float(cfg.trainer.gradient_clip_val),
        policy=policy_from_precision(str(cfg.trainer.precision)),
        grad_checkpoint=bool(cfg.model.get("use_checkpoint", True)),
        device=device,
        distill_encoder=(str(cfg.trainer.get("distill_encoder", "vitl"))
                         if cfg.trainer.get("distill_from") else None),
        distill_weight=float(cfg.trainer.get("distill_weight", 1.0)),
        device_mesh=mesh,
        fsdp=bool(cfg.trainer.get("fsdp", False)),
        fsdp_min_size=(int(cfg.trainer.get("fsdp_min_size"))
                       if cfg.trainer.get("fsdp_min_size") is not None
                       else None),
        **parallel_knobs(cfg),
    )

    # Knowledge distillation: a frozen teacher from its own checkpoint
    # (usually a vitl fine-tune) adds a SiLog term toward its predictions.
    distill_from = cfg.trainer.get("distill_from")
    if distill_from:
        print(f"[train_depth] distilling from {task.distill_encoder} "
              f"teacher ({distill_from}, weight {task.distill_weight})")
        teacher = load_or_init_depth_model(task.distill_encoder, max_depth,
                                           str(distill_from), device=device)
        task.set_teacher(teacher.state_dict())
        del teacher

    # Encoder bootstrap from the DAv2 metric checkpoint, when present.
    pretrained = None
    ckpt_path = cfg.model.get(
        "pretrained_from",
        f"./base_checkpoints/depth_anything_v2_metric_hypersim_"
        f"{cfg.model.encoder}.pth")
    if os.path.exists(ckpt_path):
        print(f"[train_depth] loading encoder weights from {ckpt_path}")
        pretrained = {k: v for k, v in load_torch_state_dict(ckpt_path).items()
                      if k.startswith("pretrained.")}
    else:
        print(f"[train_depth] no pretrained checkpoint at {ckpt_path}; "
              f"training from random init")

    logger = MetricLogger(
        run_dir, stdout_every=int(cfg.trainer.get("log_every_n_steps", 100))
    ) if mesh.rank == 0 else NullLogger()
    ckpt_dir = os.path.join("checkpoints", cfg.dataset.ds_type, exp_id)
    with contextlib.ExitStack() as stack:
        if bool(cfg.trainer.get("profile", False)):
            trace_dir = os.path.join(run_dir, "trace")
            print(f"[train_depth] profiling to {trace_dir}")
            stack.enter_context(profile_trace(trace_dir))
        if bool(cfg.trainer.get("debug_nans", False)):
            stack.enter_context(nan_checks(True))
        fit_depth(
            task, datamodule,
            max_epochs=int(cfg.trainer.max_epochs),
            log_dir=run_dir,
            ckpt_dir=ckpt_dir,
            val_check_interval=float(cfg.trainer.get("val_check_interval",
                                                     0.5)),
            patience=int(cfg.trainer.get("early_stop_patience", 20)),
            logger=logger,
            max_depths=max_depths,
            pretrained_params=pretrained,
            max_steps=(int(cfg.trainer.max_steps)
                       if "max_steps" in cfg.trainer else None),
            log_every=int(cfg.trainer.get("log_every_n_steps", 1)),
            resume=bool(cfg.trainer.get("resume", False)),
        )
    logger.close()
    return {"run_dir": run_dir, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
