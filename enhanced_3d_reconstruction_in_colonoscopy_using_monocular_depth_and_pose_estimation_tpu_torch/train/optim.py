"""Optimizers and schedules of depth fine-tuning and pose training.

The recipes of the JAX package's ``train/optim.py``: global-norm clipping
(1.0), then AdamW (b2 0.999, eps 1e-8, weight decay 0.01) under a
per-step OneCycle schedule:

- depth: two groups, the DINOv2 encoder (parameter names under
  ``pretrained.``) at ``encoder_lr`` and the rest at ``decoder_lr``, b1
  0.9;
- pose: one group at ``lr``; with ``cycle_momentum`` (the pose recipe's
  setting) b1 follows ``onecycle_momentum_schedule``, 0.95 -> 0.85 ->
  0.95 inversely to the LR, and the bias correction uses the current b1,
  as torch's ``OneCycleLR`` and the JAX package's injected b1 do.

Three details follow optax rather than PyTorch's habits:

- the clip is optax's ``clip_by_global_norm``: g * max / |g| only when
  |g| >= max (``clip_grad_norm_`` would scale by max / (|g| + 1e-6));
- every parameter takes part in the update, so one that got no gradient
  (``mask_token``) gets a zero one and still decays, as an optax leaf does;
- the LR (and b1) of step ``count`` (0-based, before the step) is the
  schedule's value there, in float32 arithmetic, set on each group
  before the step.

``torch.optim.AdamW`` decays by lr * wd * p before its Adam step and uses
sqrt(v_hat) + eps, which is optax's ``adamw`` to rounding.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float,
                      div_factor: float,
                      final_div_factor: float = 1e4) -> Schedule:
    """``torch.optim.lr_scheduler.OneCycleLR`` (cos anneal, no momentum
    cycling) as a function of the 0-based step, computed in float32 as the
    JAX package computes it."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    return _two_phase_cos(initial_lr, max_lr, min_lr, total_steps, pct_start)


def onecycle_momentum_schedule(total_steps: int, pct_start: float,
                               base_momentum: float = 0.85,
                               max_momentum: float = 0.95) -> Schedule:
    """``OneCycleLR``'s ``cycle_momentum=True`` companion of
    ``onecycle_schedule``: b1 from ``max_momentum`` down to
    ``base_momentum`` at the peak LR and back, in float32."""
    return _two_phase_cos(max_momentum, base_momentum, max_momentum,
                          total_steps, pct_start)


def _two_phase_cos(start: float, peak: float, end: float, total_steps: int,
                   pct_start: float) -> Schedule:
    """Cosine from ``start`` to ``peak`` over the first ``pct_start`` of
    the steps, then to ``end``, as a function of the 0-based step, in
    float32 as the JAX package computes it."""
    f32 = np.float32
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps) - 1.0

    def anneal_cos(a: float, b: float, pct: np.float32) -> np.float32:
        return f32(b) + f32((a - b) / 2.0) * (
            f32(1.0) + np.cos(f32(np.pi) * pct))

    def schedule(step: int) -> float:
        s = min(f32(step), f32(down_end))
        pct_up = s / f32(max(up_end, 1e-12))
        pct_down = (s - f32(up_end)) / f32(max(down_end - up_end, 1e-12))
        if s <= f32(up_end):
            return float(anneal_cos(start, peak,
                                    np.clip(pct_up, f32(0), f32(1))))
        return float(anneal_cos(peak, end,
                                np.clip(pct_down, f32(0), f32(1))))

    return schedule


class ClippedAdamW:
    """Clip by global norm, then AdamW with one LR schedule per parameter
    group and, optionally, a b1 schedule shared by all groups."""

    def __init__(self, groups: list[tuple[list[nn.Parameter], Schedule]],
                 clip_norm: float = 1.0, weight_decay: float = 0.01,
                 momentum: Schedule | None = None):
        self.params = [p for params, _ in groups for p in params]
        self.clip_norm = float(clip_norm)
        self.schedules = tuple(sched for _, sched in groups)
        self.momentum = momentum
        b1 = 0.9 if momentum is None else momentum(0)
        self.optimizer = torch.optim.AdamW(
            [{"params": params, "lr": sched(0)} for params, sched in groups],
            betas=(b1, 0.999), eps=1e-8, weight_decay=weight_decay)
        # The global gradient norm of gradients that are sharded over
        # ranks (FSDP): a function of the list of gradients, set by the
        # task; None takes the norm of the tensors as they are.
        self.norm_fn: Callable[[list[torch.Tensor]], torch.Tensor] | None \
            = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        """Clip the gradients in place and take AdamW step ``count``
        (0-based). Returns the global gradient norm before clipping, on
        the device (reading it syncs)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.norm_fn is not None:
            norm = self.norm_fn(grads)
        else:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        for g in grads:
            # a DTensor's local shard (FSDP), else the tensor
            (g.to_local() if hasattr(g, "to_local") else g).mul_(factor)
        for group, schedule in zip(self.optimizer.param_groups,
                                   self.schedules):
            group["lr"] = schedule(count)
            if self.momentum is not None:
                group["betas"] = (self.momentum(count), 0.999)
        self.optimizer.step()
        return norm

    def state_dict(self) -> dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)


class DepthOptimizer(ClippedAdamW):
    """Clip by global norm, then two-group AdamW under OneCycle."""

    def __init__(self, model: nn.Module, encoder_lr: float,
                 decoder_lr: float, total_steps: int, pct_start: float,
                 div_factor: float, clip_norm: float = 1.0,
                 weight_decay: float = 0.01):
        named = list(model.named_parameters())
        enc = [p for n, p in named if n.startswith("pretrained.")]
        dec = [p for n, p in named if not n.startswith("pretrained.")]
        super().__init__(
            [(params, onecycle_schedule(lr, total_steps, pct_start,
                                        div_factor))
             for params, lr in ((enc, encoder_lr), (dec, decoder_lr))],
            clip_norm, weight_decay)


def make_depth_optimizer(model: nn.Module, encoder_lr: float,
                         decoder_lr: float, total_steps: int,
                         pct_start: float, div_factor: float,
                         clip_norm: float = 1.0,
                         weight_decay: float = 0.01) -> DepthOptimizer:
    return DepthOptimizer(model, encoder_lr, decoder_lr, total_steps,
                          pct_start, div_factor, clip_norm, weight_decay)


def make_pose_optimizer(model: nn.Module, lr: float, total_steps: int,
                        pct_start: float, div_factor: float,
                        weight_decay: float = 0.01, clip_norm: float = 1.0,
                        cycle_momentum: bool = False) -> ClippedAdamW:
    """The pose recipe: clip 1.0, then AdamW on ``onecycle_schedule`` over
    every parameter, b1 0.9 or, with ``cycle_momentum``, on
    ``onecycle_momentum_schedule``."""
    momentum = (onecycle_momentum_schedule(total_steps, pct_start)
                if cycle_momentum else None)
    return ClippedAdamW(
        [(list(model.parameters()),
          onecycle_schedule(lr, total_steps, pct_start, div_factor))],
        clip_norm, weight_decay, momentum)
