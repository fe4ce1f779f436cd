"""Host-side depth fine-tuning loop: epochs, validation every fraction of
an epoch, checkpoint on validation, early stopping, resume, metric logging.

The JAX package's ``train/loop.py::fit_depth`` on one card, with the
reference trainer's knobs (``max_epochs``, ``val_check_interval=0.5``,
``accumulate_grad_batches``, checkpoint on val_loss, early-stopping
patience 20, per-step LR logging). The datamodule is any object with
``size``, ``setup(stage)``, ``train_loader()`` (with ``len``) and
``val_loader()``, whose batches hold ``image`` (uint8 frames, or [0, 1]
floats already at ``size``) and ``depth`` (uint16, or [0, 1] floats), and
``source`` for combined batches.

Multi-host input assembly and the preemption guard are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Mapping

import torch

from ..core.checkpoint import CheckpointManager, EarlyStopping
from ..core.debug import StepTimer
from ..core.logging import MetricLogger
from ..core.metrics import MetricBank
from ..data.preprocess import DevicePreprocessor
from .depth_task import METRIC_KEYS, DepthTask, DepthTrainState


def _restore_stopper(stopper: EarlyStopping, ckpt: CheckpointManager) -> None:
    """Early-stopping patience from the latest checkpoint's metrics, so a
    resumed run that had plateaued does not restart its count."""
    m = ckpt.latest_metrics()
    if m and "es_bad_count" in m:
        stopper.best = float(m["es_best"])
        stopper.bad_count = int(m["es_bad_count"])


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
    pre = DevicePreprocessor(size=size, device=task.device)
    own_logger = logger is None
    logger = logger or MetricLogger(log_dir)
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=1)
    stopper = EarlyStopping(patience=patience)

    state = task.init_state(seed, pretrained_params=pretrained_params)
    if resume and ckpt.restore_latest(state) is not None:
        _restore_stopper(stopper, ckpt)
        print(f"[fit_depth] resumed from step {state.step}")
    gen = torch.Generator().manual_seed(seed + 1)
    lr_table = task.lr_table()
    timer = StepTimer()
    step = state.step
    log_every = max(1, log_every)

    train_loader = datamodule.train_loader()
    accum = task.grad_accum
    steps_per_epoch = max(1, -(-len(train_loader) // accum))
    val_every = max(1, int(steps_per_epoch * val_check_interval))
    combined = max_depths is not None
    bank_keys = ("loss",) + METRIC_KEYS

    stop = False
    for epoch in range(max_epochs):
        if stop:
            break
        bank = MetricBank.zeros(bank_keys, task.device)
        t_epoch = time.time()
        for group in _group_accum(iter(train_loader), accum):
            n_real = len(group)
            prepped = [pre(b, train=True, generator=gen,
                           max_depths=max_depths) for b in group]
            # A trailing partial group is padded to ``accum`` chunks with
            # zero weights; the task skips them.
            prepped += [prepped[-1]] * (accum - n_real)
            keys = ("image", "depth") + (("max_depth",) if combined else ())
            batch = {k: torch.stack([p[k] for p in prepped]) for k in keys}
            batch["weight"] = torch.tensor(
                [1.0] * n_real + [0.0] * (accum - n_real))
            with timer.step():
                state, metrics = task.train_step(state, batch)
                bank = MetricBank.update(bank, metrics)
                step += 1
                if (step % log_every == 0 or step % val_every == 0
                        or (max_steps and step >= max_steps)):
                    lr_idx = min(step - 1, len(lr_table["encoder"]) - 1)
                    logger.log(
                        {"train_loss": metrics["loss"],
                         **{f"Train/train_{k}": metrics[k]
                            for k in METRIC_KEYS},
                         "lr/encoder": float(lr_table["encoder"][lr_idx]),
                         "lr/decoder": float(lr_table["decoder"][lr_idx]),
                         "epoch": epoch}, step=step)

            if step % val_every == 0 or (max_steps and step >= max_steps):
                val_metrics = evaluate_depth(task, state.model,
                                             datamodule.val_loader(), pre,
                                             max_depths=max_depths)
                logger.log({"val_loss": val_metrics["loss"],
                            **{f"Val/val_{k}": v
                               for k, v in val_metrics.items()
                               if k != "loss"}},
                           step=step, force_stdout=True)
                # Stopper first, so its updated state rides the checkpoint.
                should_stop = stopper.update(float(val_metrics["loss"]))
                ckpt.save(step, state,
                          {"val_loss": float(val_metrics["loss"]),
                           "es_best": float(stopper.best),
                           "es_bad_count": float(stopper.bad_count)})
                if should_stop:
                    print(f"[early-stop] val_loss plateaued "
                          f"(best {stopper.best:.5f})")
                    stop = True
                    break
            if max_steps and step >= max_steps:
                stop = True
                break
        summary = timer.summary()
        print(f"[epoch {epoch}] {time.time() - t_epoch:.1f}s "
              f"({summary.get('steps_per_s', 0):.2f} steps/s)")
        if float(bank["loss"].count) > 0:
            logger.log({f"Train/epoch_{k}": v
                        for k, v in MetricBank.compute(bank).items()},
                       step=state.step)
        if summary:
            logger.log({f"perf/{k}": v for k, v in summary.items()},
                       step=state.step)
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
        prepped = pre(batch, train=False, max_depths=max_depths)
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
