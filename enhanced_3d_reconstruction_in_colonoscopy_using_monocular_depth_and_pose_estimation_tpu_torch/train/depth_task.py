"""Depth fine-tuning task: train and eval steps of DAv2 metric depth.

The JAX package's ``train/depth_task.py`` on one card:

- ``train_step`` takes a batch of (A, mb, ...) tensors, A the
  grad-accumulation chunks, runs forward and backward per chunk (so one
  chunk's activations are live at a time), forms the weighted mean of the
  gradients, clips it by global norm and takes the two-group AdamW /
  OneCycle step (``train.optim``). An optional ``weight`` (A,) lets a
  trailing partial group step on the mean over its real chunks; a chunk
  of weight 0 adds nothing to that mean and is not run.
- the loss is SiLog over the valid mask ``min_depth <= gt <= max_depth``,
  with a per-sample ``max_depth`` when the batch has one (combined SimCol +
  C3VD); metrics are D1/AbsRel/RMSE/L1 of the detached prediction.
- precision follows the ``DtypePolicy``: f32 parameters and optimizer
  state, activations in ``compute_dtype`` (bf16 by default), loss,
  metrics and the depth head's output in f32.

The state is a ``DepthTrainState`` (model, optimizer, step). The step
updates it in place, as the JAX step donates its state, and returns it.

Distillation (``distill_encoder``, then ``set_teacher``): a frozen teacher
``DepthAnythingV2``, outside the train state and with no optimizer state,
runs under ``torch.no_grad()`` on each training chunk, and
``distill_weight * silog(pred, teacher, mask)`` joins the loss, masked to
the teacher's own ``[min_depth, max_depth]``; ``metrics["distill"]``
records the term. The step reads the teacher each time it runs, so a
teacher set after a first step takes effect at the next (the JAX step's
cache key leaves the teacher out and keeps the step built before).

Not ported (ROADMAP): the device mesh, tensor/sequence parallelism, FSDP,
pipeline parallelism. Token merging and int8 are for inference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import DtypePolicy, POLICY_BF16
from ..evaluation.depth_metrics import (DEPTH_METRIC_NAMES as METRIC_KEYS,
                                        compute_depth_errors)
from ..losses.silog import silog_loss
from ..models.convert import drop_unused
from ..models.depth_anything import DepthAnythingV2, build_depth_model
from .optim import DepthOptimizer, make_depth_optimizer, onecycle_schedule


@dataclasses.dataclass
class DepthTrainState:
    model: DepthAnythingV2
    optimizer: DepthOptimizer
    step: int = 0

    def state_dict(self) -> dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


class DepthTask:
    """Owns the configuration, the optimizer recipe and the steps of depth
    fine-tuning on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(
        self,
        encoder: str = "vitl",
        min_depth: float = 1e-6,
        max_depth: float = 20.0,
        encoder_lr: float = 5e-6,
        decoder_lr: float = 5e-5,
        pct_start: float = 0.1,
        div_factor: float = 1e9,
        total_steps: int = 1000,
        grad_accum: int = 4,
        clip_norm: float = 1.0,
        policy: DtypePolicy = POLICY_BF16,
        grad_checkpoint: bool = True,
        device: str | torch.device = "cuda",
        distill_encoder: str | None = None,
        distill_weight: float = 1.0,
    ):
        self.encoder = encoder
        self.distill_encoder = distill_encoder
        self.distill_weight = float(distill_weight)
        self.teacher: DepthAnythingV2 | None = None
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.policy = policy
        self.grad_checkpoint = grad_checkpoint
        self.grad_accum = int(grad_accum)
        self.device = resolve_device(device)
        self._sched_args = dict(total_steps=total_steps, pct_start=pct_start,
                                div_factor=div_factor)
        self._lrs = (encoder_lr, decoder_lr)
        self._clip_norm = clip_norm

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int = 0,
                   pretrained_params: Mapping[str, Any] | None = None
                   ) -> DepthTrainState:
        """A seeded model in training mode, its optimizer and step 0.

        ``pretrained_params`` is a DAv2 state dict (tensors or numpy arrays,
        e.g. ``models.convert.from_jax_params`` output); an encoder-only one
        merges over the random init (``_merge_params``)."""
        model = build_depth_model(self.encoder, self.max_depth,
                                  self.policy.compute_dtype, self.device,
                                  seed, self.grad_checkpoint)
        if pretrained_params is not None:
            model.load_state_dict(_merge_params(model.state_dict(),
                                                pretrained_params))
        model.train()
        optimizer = make_depth_optimizer(
            model, *self._lrs, clip_norm=self._clip_norm, **self._sched_args)
        return DepthTrainState(model, optimizer, 0)

    def lr_table(self) -> dict[str, np.ndarray]:
        """Per-step LR of both groups (float32), for logging."""
        steps = range(self._sched_args["total_steps"])
        return {name: np.asarray([onecycle_schedule(lr, **self._sched_args)(s)
                                  for s in steps], np.float32)
                for name, lr in zip(("encoder", "decoder"), self._lrs)}

    def set_teacher(self, teacher_params: Mapping[str, Any]) -> None:
        """Install frozen teacher weights (a DAv2 state dict of the
        ``distill_encoder`` model) for distillation. The teacher is built
        here, in eval mode, with no gradient and no optimizer state; its
        weights are copies, never the student's tensors."""
        if self.distill_encoder is None:
            raise ValueError("task was built without distill_encoder")
        teacher = build_depth_model(self.distill_encoder, self.max_depth,
                                    self.policy.compute_dtype, self.device)
        teacher.load_state_dict(_merge_params(teacher.state_dict(),
                                              teacher_params))
        self.teacher = teacher.requires_grad_(False).eval()

    # ------------------------------------------------------------- loss core

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _loss_and_metrics(self, model: DepthAnythingV2, image: torch.Tensor,
                          depth: torch.Tensor, max_depth: torch.Tensor,
                          distill: bool = False
                          ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """SiLog and the metrics; with ``distill`` and a teacher set, the
        distillation term too."""
        pred = model(image)                                  # (b, h, w) f32
        gt = depth[..., 0] if depth.dim() == 4 else depth
        maxd = max_depth[:, None, None]
        mask = (gt >= self.min_depth) & (gt <= maxd)
        loss = silog_loss(pred, gt, mask)
        metrics = compute_depth_errors(pred.detach(), gt, mask)
        if distill and self.teacher is not None:
            # Soft targets from the frozen teacher, the same SiLog distance
            # as the hard loss, masked to the teacher's range (values below
            # min_depth would hit the loss's log guard).
            with torch.no_grad():
                t_pred = self.teacher(image)
            t_mask = (t_pred >= self.min_depth) & (t_pred <= maxd)
            term = silog_loss(pred, t_pred, t_mask)
            loss = loss + self.distill_weight * term
            metrics["distill"] = term.detach()
        return loss, metrics

    def _max_depth(self, batch: Mapping[str, Any], shape) -> torch.Tensor:
        if "max_depth" in batch:
            return self._tensor(batch["max_depth"]).float()
        return torch.full(shape, self.max_depth, dtype=torch.float32,
                          device=self.device)

    # ------------------------------------------------------------ train step

    def train_step(self, state: DepthTrainState, batch: Mapping[str, Any]
                   ) -> tuple[DepthTrainState, dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (``image`` (A, mb, H, W, 3),
        ``depth`` (A, mb, H, W[, 1]), optional ``max_depth`` (A, mb) and
        ``weight`` (A,)). Returns the state and the weighted-mean ``loss``
        and metrics, as scalar tensors on the device (reading them
        syncs)."""
        image = self._tensor(batch["image"])
        depth = self._tensor(batch["depth"])
        accum, mb = image.shape[:2]
        maxd = self._max_depth(batch, (accum, mb))
        weights = (torch.as_tensor(batch["weight"]).tolist()
                   if "weight" in batch else [1.0] * accum)
        inv_a = 1.0 / max(sum(weights), 1e-6)

        model, optimizer = state.model, state.optimizer
        model.train()
        optimizer.zero_grad()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum = zero
        keys = METRIC_KEYS + (("distill",) if self.teacher is not None
                              else ())
        met_sum = {k: zero for k in keys}
        for a, w in enumerate(weights):
            if w == 0.0:
                continue
            loss, metrics = self._loss_and_metrics(model, image[a], depth[a],
                                                   maxd[a], distill=True)
            # Gradients of the weighted mean: each chunk's backward adds
            # w * inv_a times its gradient into .grad.
            (loss * (w * inv_a)).backward()
            loss_sum = loss_sum + loss.detach() * w
            met_sum = {k: met_sum[k] + metrics[k] * w for k in keys}
        optimizer.step(state.step)
        state.step += 1
        out = {k: v * inv_a for k, v in met_sum.items()}
        out["loss"] = loss_sum * inv_a
        return state, out

    # ------------------------------------------------------------- eval step

    @torch.no_grad()
    def eval_step(self, model: DepthAnythingV2, batch: Mapping[str, Any]
                  ) -> dict[str, torch.Tensor]:
        """``batch``: ``image`` (B, H, W, 3), ``depth`` (B, H, W[, 1]),
        optional ``max_depth`` (B,). Returns scalar loss and metrics."""
        image = self._tensor(batch["image"])
        loss, metrics = self._loss_and_metrics(
            model, image, self._tensor(batch["depth"]),
            self._max_depth(batch, (image.shape[0],)))
        metrics["loss"] = loss
        return metrics

    @torch.no_grad()
    def eval_step_combined(self, model: DepthAnythingV2,
                           batch: Mapping[str, Any]
                           ) -> dict[str, torch.Tensor]:
        """Overall and per-source (``SimCol/``, ``C3VD/``) metrics of one
        forward over a combined batch (``source`` 0 or 1, ``max_depth``
        (B,)). C3VD l1/rmse are scaled x10 back to mm (training runs in
        the /10 cm convention); ``<source>/count`` counts its samples."""
        pred = model(self._tensor(batch["image"]))
        depth = self._tensor(batch["depth"])
        gt = depth[..., 0] if depth.dim() == 4 else depth
        maxd = self._tensor(batch["max_depth"]).float()[:, None, None]
        mask = (gt >= self.min_depth) & (gt <= maxd)
        source = self._tensor(batch["source"])
        out = {"loss": silog_loss(pred, gt, mask)}
        out.update(compute_depth_errors(pred, gt, mask))
        for name, sid in (("SimCol", 0), ("C3VD", 1)):
            metrics = compute_depth_errors(
                pred, gt, mask & (source[:, None, None] == sid))
            scale = 10.0 if sid == 1 else 1.0
            out[f"{name}/l1"] = metrics["l1"] * scale
            out[f"{name}/rmse"] = metrics["rmse"] * scale
            out[f"{name}/abs_rel"] = metrics["abs_rel"]
            out[f"{name}/d1"] = metrics["d1"]
            out[f"{name}/count"] = torch.sum(source == sid).float()
        return out

    @torch.no_grad()
    def eval_step_per_sample(self, model: DepthAnythingV2,
                             batch: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
        """Per-sample loss and metrics, a dict of (B,) tensors, for the
        per-procedure collectors of ``cli/test_depth.py``: true per-sample
        values, as in the JAX package (the reference appends the batch's
        metric once per sample). ``batch`` as for ``eval_step``."""
        image = self._tensor(batch["image"])
        pred = model(image)
        depth = self._tensor(batch["depth"])
        gt = depth[..., 0] if depth.dim() == 4 else depth
        maxd = self._max_depth(batch, (image.shape[0],))
        rows = []
        for pred_i, gt_i, maxd_i in zip(pred, gt, maxd):
            mask = (gt_i >= self.min_depth) & (gt_i <= maxd_i)
            row = compute_depth_errors(pred_i, gt_i, mask)
            row["loss"] = silog_loss(pred_i, gt_i, mask)
            rows.append(row)
        return {k: torch.stack([row[k] for row in rows]) for k in rows[0]}


def _merge_params(base: Mapping[str, torch.Tensor],
                  overlay: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``base`` (a state dict) with the entries of ``overlay`` (converted
    DAv2 weights, possibly encoder-only) in place of its own, cast to
    their dtype. Keys the model does not have raise."""
    out = dict(base)
    for key, value in drop_unused(overlay).items():
        if key not in base:
            raise KeyError(f"pretrained weight {key!r} is not a parameter "
                           "of the model")
        t = value if torch.is_tensor(value) else torch.from_numpy(
            np.asarray(value))
        if t.shape != base[key].shape:
            raise ValueError(f"pretrained weight {key!r} has shape "
                             f"{tuple(t.shape)}, the model "
                             f"{tuple(base[key].shape)}")
        out[key] = t.to(dtype=base[key].dtype)
    return out
