"""Relative-pose training task: train and eval steps of the ResNet-18 pose
regressor (the JAX package's ``train/pose_task.py``, the reference's
``PoseEstimationModule``).

- ``train_step``: forward in training mode (BatchNorm statistics update in
  place, dropout from the state's generator), ``pose_loss``, backward,
  global-norm clip and AdamW on OneCycle (``train.optim``); metrics are
  ATE/RTE/ROTE of the detached batch predictions.
- ``trajectory_metrics``: whole-trajectory ATE/RTE/ROTE of a flat
  sequence of relative poses (``evaluation.pose_metrics``).
- Precision follows the ``DtypePolicy``: '32-true' (the recipe's, the
  default) computes convolutions and matmuls in true float32, with TF32
  off in cuDNN and cuBLAS; 'bf16-mixed' computes them in bf16 with f32
  parameters, BatchNorm statistics and loss. Each step sets TF32 for its
  policy and restores the process's setting after.

The state is a ``PoseTrainState`` (model, optimizer, dropout generator,
step); the step updates it in place and returns it.

Data parallelism (``device_mesh``, the JAX package's batch sharded over
the data axis): each rank steps on its loader rows; BatchNorm normalises
with the global batch's statistics (``models.resnet_pose``), the dropout
masks are the global batch's rows, the gradients are averaged over the
data group, and the loss and the ATE/RTE/ROTE metrics are those of the
whole batch. A batch the loader replicated runs whole on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import POLICY_F32, DtypePolicy
from ..evaluation.pose_metrics import compute_pose_errors, evaluate_trajectory
from ..losses.pose_loss import pose_loss
from ..models.resnet_pose import (PoseEstimationNet, build_pose_model,
                                  set_sync_group)
from ..parallel import mesh as meshlib
from .optim import ClippedAdamW, make_pose_optimizer, onecycle_schedule


@dataclasses.dataclass
class PoseTrainState:
    model: PoseEstimationNet
    optimizer: ClippedAdamW
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


class PoseTask:
    """Owns the configuration, the optimizer recipe and the steps of pose
    training on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(
        self,
        in_channels: int = 8,
        lr: float = 1e-4,
        weight_decay: float = 0.01,
        pct_start: float = 0.3,
        div_factor: float = 25.0,
        beta: float = 1.0,
        total_steps: int = 1000,
        clip_norm: float = 1.0,
        policy: DtypePolicy = POLICY_F32,
        cycle_momentum: bool = False,
        dropout: bool = True,
        device: str | torch.device = "cuda",
        device_mesh: meshlib.Mesh | None = None,
    ):
        self.device = resolve_device(device)
        self.mesh = device_mesh or meshlib.build_mesh(device=self.device)
        self.in_channels = in_channels
        self.beta = float(beta)
        self.policy = policy
        self.dropout = dropout
        self._lr = lr
        self._opt_args = dict(total_steps=total_steps, pct_start=pct_start,
                              div_factor=div_factor,
                              weight_decay=weight_decay, clip_norm=clip_norm,
                              cycle_momentum=cycle_momentum)
        self.tf32 = policy.compute_dtype != torch.float32
        print("[pose] " + (
            f"{policy.compute_dtype} convolutions and matmuls, f32 "
            "parameters, BatchNorm statistics and loss; TF32 on for what "
            "stays f32" if self.tf32 else
            "float32 convolutions and matmuls, TF32 off (true f32)"))

    @contextlib.contextmanager
    def _precision(self):
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int = 0,
                   weights: Mapping[str, torch.Tensor] | None = None
                   ) -> PoseTrainState:
        """A seeded model in training mode (or ``weights``, a state dict in
        the reference's names, e.g. ``models.convert.from_jax_pose_variables``
        output), its optimizer, a dropout generator seeded with ``seed``
        and step 0."""
        model = build_pose_model(self.in_channels, self.policy.compute_dtype,
                                 self.dropout, self.device, seed)
        if weights is not None:
            model.load_state_dict(weights)
        model.train()
        optimizer = make_pose_optimizer(model, self._lr, **self._opt_args)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return PoseTrainState(model, optimizer, generator, 0)

    def lr_table(self) -> np.ndarray:
        """Per-step LR values (float32), for logging."""
        sched = onecycle_schedule(self._lr, self._opt_args["total_steps"],
                                  self._opt_args["pct_start"],
                                  self._opt_args["div_factor"])
        return np.asarray([sched(s) for s in
                           range(self._opt_args["total_steps"])], np.float32)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # ------------------------------------------------------------ train step

    def train_step(self, state: PoseTrainState, batch: Mapping[str, Any]
                   ) -> tuple[PoseTrainState, dict[str, torch.Tensor]]:
        """One optimizer step on ``input`` (B, 8, H, W) and ``target``
        (B, 7). Returns the state and scalar ``loss``, ``ate``, ``rte`` and
        ``rote`` tensors on the device (reading them syncs)."""
        mesh = self.mesh
        image = self._tensor(batch["input"])
        target = self._tensor(batch["target"]).float()
        sharded = mesh.world > 1 and not batch.get("_replicated", False)
        if sharded and mesh.model > 1:
            image = meshlib.gather_rows(image, mesh.model_group)
            target = meshlib.gather_rows(target, mesh.model_group)
        group = mesh.data_group if sharded else None
        rows = mesh.data_rows(len(batch["input"]), not sharded)
        model, optimizer = state.model, state.optimizer
        model.train()
        set_sync_group(model, group)
        optimizer.zero_grad()
        with self._precision():
            pred = model(image, state.generator, rows)
            loss = pose_loss(pred, target, beta=self.beta)
            loss.backward()
            if group is not None:
                # The global loss is the mean of the ranks' equal-sized
                # batch means: average the gradients.
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None]
                meshlib.sum_grads(grads, group)
                for g in grads:
                    g.div_(mesh.data)
            optimizer.step(state.step)
        set_sync_group(model, None)
        state.step += 1
        pred, target = pred.detach(), target
        if group is not None:
            pred = meshlib.gather_rows(pred, group)
            target = meshlib.gather_rows(target, group)
            loss = meshlib.global_sum(loss.detach(), group) / mesh.data
        metrics = compute_pose_errors(pred, target)
        metrics["loss"] = loss.detach()
        return state, metrics

    # ------------------------------------------------------------- eval step

    @torch.no_grad()
    def eval_step(self, state: PoseTrainState, batch: Mapping[str, Any]
                  ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Loss and metrics of a batch in eval mode, and the (B, 7)
        predictions."""
        target = self._tensor(batch["target"]).float()
        state.model.eval()
        with self._precision():
            pred = state.model(self._tensor(batch["input"]))
        metrics = compute_pose_errors(pred, target)
        metrics["loss"] = pose_loss(pred, target, beta=self.beta)
        return metrics, pred

    @staticmethod
    def trajectory_metrics(pred_rel: torch.Tensor, gt_rel: torch.Tensor
                           ) -> dict[str, torch.Tensor]:
        """Whole-sequence trajectory metrics (flat frame order)."""
        return evaluate_trajectory(pred_rel, gt_rel)
