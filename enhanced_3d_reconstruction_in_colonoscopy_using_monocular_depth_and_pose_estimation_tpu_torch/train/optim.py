"""Optimizer and LR schedule of depth fine-tuning.

The recipe of the JAX package's ``train/optim.py``: global-norm clipping
(1.0), then AdamW (betas 0.9/0.999, eps 1e-8, weight decay 0.01) in two
groups, the DINOv2 encoder (parameter names under ``pretrained.``) at
``encoder_lr`` and the rest at ``decoder_lr``, each under a per-step
OneCycle schedule.

Three details follow optax rather than PyTorch's habits:

- the clip is optax's ``clip_by_global_norm``: g * max / |g| only when
  |g| >= max (``clip_grad_norm_`` would scale by max / (|g| + 1e-6));
- every parameter takes part in the update, so one that got no gradient
  (``mask_token``) gets a zero one and still decays, as an optax leaf does;
- the LR of step ``count`` (0-based, before the step) is the schedule's
  value there, in float32 arithmetic, set on each group before the step.

``torch.optim.AdamW`` decays by lr * wd * p before its Adam step and uses
sqrt(v_hat) + eps, which is optax's ``adamw`` to rounding. The pose
optimizer waits for the pose slice.
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
    f32 = np.float32
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps) - 1.0

    def anneal_cos(start: float, end: float, pct: np.float32) -> np.float32:
        return f32(end) + f32((start - end) / 2.0) * (
            f32(1.0) + np.cos(f32(np.pi) * pct))

    def schedule(step: int) -> float:
        s = min(f32(step), f32(down_end))
        pct_up = s / f32(max(up_end, 1e-12))
        pct_down = (s - f32(up_end)) / f32(max(down_end - up_end, 1e-12))
        if s <= f32(up_end):
            return float(anneal_cos(initial_lr, max_lr,
                                    np.clip(pct_up, f32(0), f32(1))))
        return float(anneal_cos(max_lr, min_lr,
                                np.clip(pct_down, f32(0), f32(1))))

    return schedule


class DepthOptimizer:
    """Clip by global norm, then two-group AdamW under OneCycle."""

    def __init__(self, model: nn.Module, encoder_lr: float,
                 decoder_lr: float, total_steps: int, pct_start: float,
                 div_factor: float, clip_norm: float = 1.0,
                 weight_decay: float = 0.01):
        named = list(model.named_parameters())
        enc = [p for n, p in named if n.startswith("pretrained.")]
        dec = [p for n, p in named if not n.startswith("pretrained.")]
        self.params = enc + dec
        self.clip_norm = float(clip_norm)
        self.schedules = tuple(
            onecycle_schedule(lr, total_steps, pct_start, div_factor)
            for lr in (encoder_lr, decoder_lr))
        self.optimizer = torch.optim.AdamW(
            [{"params": enc, "lr": self.schedules[0](0)},
             {"params": dec, "lr": self.schedules[1](0)}],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

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
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        for g in grads:
            g.mul_(factor)
        for group, schedule in zip(self.optimizer.param_groups,
                                   self.schedules):
            group["lr"] = schedule(count)
        self.optimizer.step()
        return norm

    def state_dict(self) -> dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)


def make_depth_optimizer(model: nn.Module, encoder_lr: float,
                         decoder_lr: float, total_steps: int,
                         pct_start: float, div_factor: float,
                         clip_norm: float = 1.0,
                         weight_decay: float = 0.01) -> DepthOptimizer:
    return DepthOptimizer(model, encoder_lr, decoder_lr, total_steps,
                          pct_start, div_factor, clip_norm, weight_decay)
