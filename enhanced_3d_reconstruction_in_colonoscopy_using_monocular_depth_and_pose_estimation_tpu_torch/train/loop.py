"""Host-side training loops: ``fit_depth`` (depth fine-tuning: epochs,
validation every fraction of an epoch, checkpoint on validation, early
stopping, resume, metric logging) and ``fit_pose`` (pose training:
validation with trajectory metrics once per epoch, the same checkpoints
and stopping).

The JAX package's ``train/loop.py::fit_depth`` on one card, with the
reference trainer's knobs (``max_epochs``, ``val_check_interval=0.5``,
``accumulate_grad_batches``, checkpoint on val_loss, early-stopping
patience 20, per-step LR logging). The datamodule is any object with
``size``, ``setup(stage)``, ``train_loader()`` (with ``len``) and
``val_loader()``, whose batches hold ``image`` (uint8 frames, or [0, 1]
floats already at ``size``) and ``depth`` (uint16, or [0, 1] floats), and
``source`` for combined batches.

Multi-process runs (the task's ``mesh``): the loaders shard each global
batch over the ranks (``rank``, ``world``); a batch the world does not
divide comes whole to every rank (``_replicated``), and an accumulation
group with one such batch steps on the replicated path. The augmentation
draws are the global batch's, so every rank's rows get the one-process
run's. The steps' metrics are already global (``DepthTask``), so the
epoch banks and the validation means agree on every rank. Only rank 0
logs and writes checkpoints, in the unsharded layout, and the ranks meet
at a barrier after each save.

SIGTERM and SIGINT (``core.preempt.PreemptionGuard``) stop a fit at the
next step boundary: it saves ``latest/`` (``val_loss`` 1e30, so never a
best-k slot, with the early-stopping state and ``preempted`` 1) and
returns, and ``resume=True`` continues from that step. Under more than
one rank the ranks agree on the flag at the host-sync boundaries (log and
validation steps) with a MAX all-reduce, so a signal that reaches one rank
stops all of them at the same step.

Each step is a ``train.step`` span in ``core.debug``'s recorder (for
``fit_depth`` the batch's preprocessing and the step, with its logging;
``ident`` the step), and each wait on the loader for a step's batches a
``train.loader_wait`` span. The loops log ``perf/step_time_mean_s``,
``_p50_s``, ``_p95_s`` and ``perf/steps_per_s`` over every step span of
the epoch (``fit_pose``: of the fit), and ``perf/loader_wait_s``, the
mean seconds a step waited on its loader.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Mapping

import torch

from ..core.checkpoint import CheckpointManager, EarlyStopping
from ..core import debug
from ..core.logging import MetricLogger, NullLogger
from ..core.metrics import MetricBank
from ..core.preempt import PreemptionGuard
from ..data.preprocess import DevicePreprocessor
from ..parallel.mesh import Mesh
from .depth_task import METRIC_KEYS, DepthTask, DepthTrainState
from .pose_task import PoseTask, PoseTrainState


def _restore_stopper(stopper: EarlyStopping, ckpt: CheckpointManager) -> None:
    """Early-stopping patience from the latest checkpoint's metrics, so a
    resumed run that had plateaued does not restart its count."""
    m = ckpt.latest_metrics()
    if m and "es_bad_count" in m:
        stopper.best = float(m["es_best"])
        stopper.bad_count = int(m["es_bad_count"])


class _Saved:
    """A state dict taken on every rank, for rank 0 to write."""

    def __init__(self, state_dict: dict):
        self._sd = state_dict

    def state_dict(self) -> dict:
        return self._sd


def _save(ckpt: CheckpointManager, mesh: Mesh, step: int, state,
          metrics: dict[str, float]) -> None:
    """Save on rank 0 (every rank gathers the state: under FSDP that is
    collective), then meet at a barrier."""
    sd = state.state_dict()
    if mesh.rank == 0:
        ckpt.save(step, _Saved(sd), metrics)
    mesh.barrier()


def _preempt_agreed(guard: PreemptionGuard, mesh: Mesh,
                    host_sync: bool = True) -> bool:
    """Whether to stop for a signal. One rank: its own flag, every step.
    More: the save is collective and a signal may reach one rank a step
    before another, so the ranks agree (stop iff any saw it) with a MAX
    all-reduce, only at the host-sync boundaries (``host_sync``, the same
    on every rank); between them a flag waits for the next one."""
    if mesh.world == 1:
        return guard.requested
    if not host_sync:
        return False
    return mesh.flag_any(guard.requested)


def _handle_preemption(ckpt: CheckpointManager, mesh: Mesh, step: int,
                       state, stopper: EarlyStopping) -> None:
    """Save a final mid-run checkpoint after SIGTERM/SIGINT: val_loss
    1e30, so it never displaces a best-k slot (it lands in ``latest/``),
    with the early-stopping state, so a resumed run keeps its patience
    counter. Nothing is written when the step is already saved."""
    if ckpt.latest_step() == int(step):
        if mesh.rank == 0:
            print(f"[preempt] signal received at step {step} "
                  "(already checkpointed); exiting cleanly")
        return
    _save(ckpt, mesh, step, state, {
        "val_loss": 1e30,
        "es_best": (float(stopper.best) if stopper.best is not None
                    else 1e30),
        "es_bad_count": float(stopper.bad_count),
        "preempted": 1.0,
    })
    if mesh.rank == 0:
        print(f"[preempt] signal received - saved latest/ at step {step}; "
              "restart with trainer.resume=true to continue")


_END = object()


def _waited(items: Iterable, waits: list):
    """``items``, each wait for the next one a ``train.loader_wait``
    span appended to ``waits`` (the last, which finds the end, too)."""
    it = iter(items)
    while True:
        with debug.span("train.loader_wait") as wait:
            item = next(it, _END)
        waits.append(wait)
        if item is _END:
            return
        yield item


def _perf(steps: list, waits: list) -> dict[str, float]:
    """The ``perf/`` log of ``steps`` and ``waits`` (spans); {} for no
    step."""
    if not steps:
        return {}
    out = {f"perf/{k}": v for k, v in debug.step_stats(steps).items()}
    out["perf/loader_wait_s"] = sum(w.ms for w in waits) * 1e-3 / len(steps)
    return out


def _group_accum(loader: Iterable[dict], accum: int):
    """Group ``accum`` consecutive loader batches (Lightning grad-accum
    semantics); a trailing partial group is yielded too, and
    ``fit_depth`` steps on it with zero weights for the padding."""
    group: list[dict] = []
    for batch in loader:
        group.append(batch)
        if len(group) == accum:
            yield group
            group = []
    if group:
        yield group


def fit_depth(
    task: DepthTask,
    datamodule,
    max_epochs: int,
    log_dir: str,
    ckpt_dir: str,
    val_check_interval: float = 0.5,
    patience: int = 20,
    logger: MetricLogger | None = None,
    max_depths: tuple[float, float] | None = None,
    seed: int = 42,
    pretrained_params: Mapping[str, Any] | None = None,
    max_steps: int | None = None,
    resume: bool = False,
    log_every: int = 1,
) -> DepthTrainState:
    """Fine-tune depth; returns the final train state.

    ``resume=True`` restores the latest checkpoint in ``ckpt_dir`` (model,
    optimizer, step and early-stopping state). The augmentation draws come
    from a CPU ``torch.Generator`` seeded with ``seed + 1``."""
    if getattr(datamodule, "train_dataset", None) is None:
        datamodule.setup("fit")
    size = datamodule.size
    mesh = task.mesh
    pre = DevicePreprocessor(size=size, device=task.device)
    own_logger = logger is None
    logger = logger or (MetricLogger(log_dir) if mesh.rank == 0
                        else NullLogger())
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=1)
    stopper = EarlyStopping(patience=patience)

    state = task.init_state(seed, pretrained_params=pretrained_params)
    if resume and ckpt.restore_latest(state) is not None:
        _restore_stopper(stopper, ckpt)
        print(f"[fit_depth] resumed from step {state.step}")
    mesh.barrier()
    gen = torch.Generator().manual_seed(seed + 1)
    lr_table = task.lr_table()
    step = state.step
    log_every = max(1, log_every)

    train_loader = datamodule.train_loader()
    accum = task.grad_accum
    steps_per_epoch = max(1, -(-len(train_loader) // accum))
    val_every = max(1, int(steps_per_epoch * val_check_interval))
    combined = max_depths is not None
    bank_keys = ("loss",) + METRIC_KEYS

    stop = False
    with PreemptionGuard() as guard:
        for epoch in range(max_epochs):
            if stop:
                break
            bank = MetricBank.zeros(bank_keys, task.device)
            t_epoch = time.time()
            steps, waits = [], []
            for group in _waited(_group_accum(iter(train_loader), accum),
                                 waits):
                with debug.span("train.step", step) as step_span:
                    steps.append(step_span)
                    n_real = len(group)
                    # One batch the loader could not shard over the ranks
                    # puts the whole group on the replicated path.
                    replicated = any(bool(b.pop("_replicated", False))
                                     for b in group)
                    prepped = [pre(b, train=True, generator=gen,
                                   max_depths=max_depths,
                                   rows=mesh.loader_rows(len(b["image"]),
                                                         replicated))
                               for b in group]
                    # A trailing partial group is padded to ``accum``
                    # chunks with zero weights; the task skips them.
                    prepped += [prepped[-1]] * (accum - n_real)
                    keys = ("image", "depth") + (("max_depth",) if combined
                                                 else ())
                    batch = {k: torch.stack([p[k] for p in prepped])
                             for k in keys}
                    batch["weight"] = torch.tensor(
                        [1.0] * n_real + [0.0] * (accum - n_real))
                    batch["_replicated"] = replicated
                    state, metrics = task.train_step(state, batch)
                    bank = MetricBank.update(bank, metrics)
                    step += 1
                    boundary = bool(step % log_every == 0
                                    or step % val_every == 0
                                    or (max_steps and step >= max_steps))
                    if boundary:
                        lr_idx = min(step - 1, len(lr_table["encoder"]) - 1)
                        logger.log(
                            {"train_loss": metrics["loss"],
                             **{f"Train/train_{k}": metrics[k]
                                for k in METRIC_KEYS},
                             # the distillation term, when a teacher is set
                             **{f"Train/train_{k}": metrics[k]
                                for k in ("distill",) if k in metrics},
                             "lr/encoder":
                                 float(lr_table["encoder"][lr_idx]),
                             "lr/decoder":
                                 float(lr_table["decoder"][lr_idx]),
                             "epoch": epoch}, step=step)

                if step % val_every == 0 or (max_steps and step >= max_steps):
                    val_metrics = evaluate_depth(
                        task, state.model, datamodule.val_loader(), pre,
                        max_depths=max_depths)
                    logger.log({"val_loss": val_metrics["loss"],
                                **{f"Val/val_{k}": v
                                   for k, v in val_metrics.items()
                                   if k != "loss"}},
                               step=step, force_stdout=True)
                    # Stopper first, so its updated state rides the
                    # checkpoint.
                    should_stop = stopper.update(float(val_metrics["loss"]))
                    _save(ckpt, mesh, step, state,
                          {"val_loss": float(val_metrics["loss"]),
                           "es_best": float(stopper.best),
                           "es_bad_count": float(stopper.bad_count)})
                    if should_stop:
                        print(f"[early-stop] val_loss plateaued "
                              f"(best {stopper.best:.5f})")
                        stop = True
                        break
                if _preempt_agreed(guard, mesh, host_sync=boundary):
                    _handle_preemption(ckpt, mesh, step, state, stopper)
                    stop = True
                    break
                if max_steps and step >= max_steps:
                    stop = True
                    break
            perf = _perf(steps, waits)
            print(f"[epoch {epoch}] {time.time() - t_epoch:.1f}s "
                  f"({perf.get('perf/steps_per_s', 0):.2f} steps/s)")
            if float(bank["loss"].count) > 0:
                logger.log({f"Train/epoch_{k}": v
                            for k, v in MetricBank.compute(bank).items()},
                           step=state.step)
            if perf:
                logger.log(perf, step=state.step)
    mesh.barrier()
    if own_logger:
        logger.close()
    return state


def evaluate_depth(task: DepthTask, model, loader, pre: DevicePreprocessor,
                   max_depths=None) -> dict[str, float]:
    """Mean metrics over a loader.

    Overall metrics weight each batch equally (torchmetrics ``MeanMetric``
    updated once per batch); per-source ``SimCol/``/``C3VD/`` metrics of
    combined batches are weighted by each batch's count of that source."""
    sums: dict[str, float] = {}
    count = 0
    src_sums: dict[str, float] = {}
    src_weight: dict[str, float] = {}
    for batch in loader:
        replicated = bool(batch.pop("_replicated", False))
        prepped = pre(batch, train=False, max_depths=max_depths)
        prepped["_replicated"] = replicated
        if "source" in prepped:
            per_src = {k: float(v) for k, v in
                       task.eval_step_combined(model, prepped).items()}
            for k in ("loss",) + METRIC_KEYS:
                sums[k] = sums.get(k, 0.0) + per_src[k]
            for name in ("SimCol", "C3VD"):
                n = per_src[f"{name}/count"]
                for metric in ("l1", "rmse", "abs_rel", "d1"):
                    key = f"{name}/{metric}"
                    src_sums[key] = src_sums.get(key, 0.0) + per_src[key] * n
                    src_weight[key] = src_weight.get(key, 0.0) + n
        else:
            for k, v in task.eval_step(model, prepped).items():
                sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    out = {k: v / max(count, 1) for k, v in sums.items()}
    out.update({k: v / max(src_weight[k], 1e-12)
                for k, v in src_sums.items()})
    return out


def _accumulate_pose_val(sums: dict, counts: dict, metrics: dict,
                         batch_size: int) -> None:
    """Batch-mean accumulation of pose validation metrics. RTE is a mean
    over consecutive-frame deltas, so a 1-sample batch (a trailing one)
    has none and adds nothing to ``rte``; a NaN from a batch of two or
    more still propagates."""
    for k, v in metrics.items():
        if k == "rte" and batch_size < 2:
            continue
        sums[k] = sums.get(k, 0.0) + float(v)
        counts[k] = counts.get(k, 0) + 1


def fit_pose(
    task: PoseTask,
    datamodule,
    max_epochs: int,
    log_dir: str,
    ckpt_dir: str,
    patience: int = 20,
    logger: MetricLogger | None = None,
    seed: int = 42,
    max_steps: int | None = None,
    resume: bool = False,
    log_every: int = 1,
) -> PoseTrainState:
    """Train the pose regressor; returns the final train state (the JAX
    package's ``fit_pose``).

    Validation runs once per epoch and adds the whole validation
    trajectory's metrics (``traj_*``); each validation is checkpointed with
    the early-stopping state, and the checkpoint holds the BatchNorm
    statistics with the model. ``resume=True`` restores the latest
    checkpoint in ``ckpt_dir``. The datamodule has ``setup(stage)``,
    ``train_loader()`` and ``val_loader()`` yielding ``input`` and
    ``target`` batches."""
    if getattr(datamodule, "train_dataset", None) is None:
        datamodule.setup("fit")
    mesh = task.mesh
    own_logger = logger is None
    logger = logger or (MetricLogger(log_dir) if mesh.rank == 0
                        else NullLogger())
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=1)
    stopper = EarlyStopping(patience=patience)

    state = task.init_state(seed)
    if resume and ckpt.restore_latest(state) is not None:
        _restore_stopper(stopper, ckpt)
        print(f"[fit_pose] resumed from step {state.step}")
    mesh.barrier()
    lr_table = task.lr_table()
    step = state.step
    log_every = max(1, log_every)
    # One loader for the whole fit: it reshuffles per epoch.
    train_loader = datamodule.train_loader()
    steps, waits = [], []

    stop = False
    with PreemptionGuard() as guard:
        for epoch in range(max_epochs):
            if stop:
                break
            for batch in _waited(train_loader, waits):
                with debug.span("train.step", step) as step_span:
                    steps.append(step_span)
                    state, metrics = task.train_step(state, batch)
                    step += 1
                    boundary = bool(step % log_every == 0
                                    or (max_steps and step >= max_steps))
                    if boundary:
                        logger.log(
                            {"train_loss": metrics["loss"],
                             **{f"Train/train_{k}": metrics[k]
                                for k in ("ate", "rte", "rote")},
                             "lr": float(lr_table[min(step - 1,
                                                      len(lr_table) - 1)]),
                             "epoch": epoch}, step=step)
                if _preempt_agreed(guard, mesh, host_sync=boundary):
                    _handle_preemption(ckpt, mesh, step, state, stopper)
                    stop = True
                    break
                if max_steps and step >= max_steps:
                    stop = True
                    break
            if _preempt_agreed(guard, mesh):
                break  # already saved; no epoch-end validation
            if _validate_pose(task, state, datamodule, logger, ckpt, mesh,
                              stopper):
                break
    perf = _perf(steps, waits)
    if perf:
        logger.log(perf, step=state.step)
    mesh.barrier()
    if own_logger:
        logger.close()
    return state


def _validate_pose(task: PoseTask, state: PoseTrainState, datamodule,
                   logger, ckpt: CheckpointManager, mesh: Mesh,
                   stopper: EarlyStopping) -> bool:
    """Epoch-end validation with whole-trajectory metrics, logged and
    checkpointed; returns whether early stopping fired. The validation
    loader is not sharded: every rank validates the whole set."""
    val_sums: dict[str, float] = {}
    val_counts: dict[str, int] = {}
    preds, gts = [], []
    for batch in datamodule.val_loader():
        metrics, pred = task.eval_step(state, batch)
        preds.append(pred)
        gts.append(torch.as_tensor(batch["target"]))
        _accumulate_pose_val(val_sums, val_counts, metrics,
                             len(batch["target"]))
    val = {k: v / max(val_counts.get(k, 0), 1)
           for k, v in val_sums.items()}
    if preds:
        traj = task.trajectory_metrics(torch.cat(preds), torch.cat(gts))
        val.update({f"traj_{k}": float(v) for k, v in traj.items()})
    val_loss = float(val.get("loss", 1e9))
    logger.log({"val_loss": val.get("loss", float("nan")),
                **{f"Val/val_{k}": v for k, v in val.items()
                   if k != "loss"}}, step=state.step, force_stdout=True)
    should_stop = stopper.update(val_loss)
    _save(ckpt, mesh, state.step, state,
          {"val_loss": val_loss, "es_best": float(stopper.best),
           "es_bad_count": float(stopper.bad_count)})
    if should_stop:
        print(f"[early-stop] val_loss plateaued (best {stopper.best:.5f})")
    return should_stop
