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

``FunctionalClippedAdamW`` is ``ClippedAdamW.step`` on tensors (the
exported training step's update, ``serving/export.py``): parameters,
gradients, moments and the step in, new ones out, nothing mutated. The
per-step scalars that the eager step computes on the host (each group's
LR, torch's bias corrections) become a constant table indexed by the step
tensor, filled by the host in the eager step's own arithmetic.
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
            norm = global_norm(grads)
        factor = clip_factor(norm, self.clip_norm)
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


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of a list of gradients, as a 0-dim tensor."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def clip_factor(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` factor: 1 below ``clip_norm``, else
    clip_norm / norm."""
    return torch.where(norm < clip_norm, torch.ones_like(norm),
                       clip_norm / norm)


def _scalar_dtype() -> torch.dtype:
    """The dtype of ``torch.optim.AdamW``'s ``state["step"]`` tensors."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


# The most elements of one chunk of the exported step's update (64 MiB of
# float32): its temporaries are a chunk's size, not the model's.
CHUNK_ELEMENTS = 1 << 24


class FunctionalClippedAdamW:
    """``ClippedAdamW.step`` of ``opt`` as a function of tensors.

    ``update(params, grads, exp_avg, exp_avg_sq, count)`` takes the
    parameters and gradients as lists in ``opt.params`` order, the AdamW
    moments as one flat tensor per chunk (``chunks``: consecutive
    parameters of one group, flattened and joined, up to
    ``CHUNK_ELEMENTS`` elements or one larger parameter), and ``count``,
    the 0-based step before the update (an int64 0-dim tensor). It
    returns ``(params, exp_avg, exp_avg_sq, norm)``: each chunk's new
    parameters and moments as new flat tensors, and the global gradient
    norm before the clip. Chunks keep the traced program to a few nodes
    a parameter and its temporaries to a chunk's size.

    The arithmetic is the eager step's, op for op: the norm of the
    per-tensor norms, the clip, then torch's single-tensor AdamW (the path
    the eager step takes on the CPU), elementwise, so the same on a flat
    chunk as on each tensor:

        p = p * (1 - lr wd);  m = lerp(m, g, 1 - b1);
        v = addcmul(v b2, g, g, 1 - b2);  d = sqrt(v) / sqrt(bc2) + eps;
        p = p + (-lr / bc1) m / d,      bc_i = 1 - b_i ** (count + 1).

    The three scalars that depend on the step, 1 - lr wd and -lr / bc1 of
    each group and sqrt(bc2), are rows of ``table``: the Python floats the
    eager step computes on the host, rounded to float32 as its kernels
    round them. The table runs past ``total_steps`` (where the schedules
    stop moving) until the bias corrections round to 1 in float32; a later
    step reads its last row, which is what the eager step computes there.
    On the card the eager step takes torch's multi-tensor AdamW, whose
    fused multiply-adds round the update differently (by ulps of the
    update)."""

    def __init__(self, opt: ClippedAdamW, total_steps: int):
        if opt.momentum is not None:
            raise ValueError("FunctionalClippedAdamW: a b1 schedule "
                             "(cycle_momentum) is not supported")
        if opt.norm_fn is not None:
            raise ValueError("FunctionalClippedAdamW: sharded gradients "
                             "(norm_fn) are not supported")
        groups = opt.optimizer.param_groups
        self.clip_norm = opt.clip_norm
        self.betas = tuple(groups[0]["betas"])
        self.eps = float(groups[0]["eps"])
        self.groups = len(groups)
        self.chunks = _chunks([[p.numel() for p in group["params"]]
                               for group in groups])
        self.table = _step_table(
            opt.schedules, int(total_steps), self.betas,
            float(groups[0]["weight_decay"])).to(opt.params[0].device)

    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               exp_avg: list[torch.Tensor], exp_avg_sq: list[torch.Tensor],
               count: torch.Tensor) -> tuple[list[torch.Tensor],
                                             list[torch.Tensor],
                                             list[torch.Tensor],
                                             torch.Tensor]:
        norm = global_norm(grads)
        factor = clip_factor(norm, self.clip_norm)
        row = self.table.index_select(
            0, count.clamp(max=self.table.shape[0] - 1).reshape(1))[0]
        n = self.groups
        decay, neg_step, bc2_sqrt = row[:n], row[n:2 * n], row[2 * n]
        b1, b2 = self.betas
        new_p, new_m, new_v = [], [], []
        for c, (lo, hi, g) in enumerate(self.chunks):
            grad = flatten(grads[lo:hi]) * factor
            m = torch.lerp(exp_avg[c], grad, 1 - b1)
            v = torch.addcmul(exp_avg_sq[c] * b2, grad, grad, value=1 - b2)
            denom = v.sqrt() / bc2_sqrt + self.eps
            new_p.append(flatten(params[lo:hi]) * decay[g]
                         + (neg_step[g] * m) / denom)
            new_m.append(m)
            new_v.append(v)
        return new_p, new_m, new_v, norm


def _chunks(groups: list[list[int]]) -> list[tuple[int, int, int]]:
    """(lo, hi, group) of each chunk, given each group's parameter
    sizes: consecutive parameters of one group up to ``CHUNK_ELEMENTS``
    elements, or one larger parameter alone."""
    chunks, i = [], 0
    for g, sizes in enumerate(groups):
        lo, total = i, 0
        for size in sizes:
            if i > lo and total + size > CHUNK_ELEMENTS:
                chunks.append((lo, i, g))
                lo, total = i, 0
            total += size
            i += 1
        chunks.append((lo, i, g))
    return chunks


def flatten(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors flattened and joined, in order: one chunk's flat
    layout."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _step_table(schedules, total_steps: int, betas: tuple[float, float],
                weight_decay: float) -> torch.Tensor:
    """(L, 2G + 1) float32: row ``count`` holds each group's 1 - lr wd,
    then each group's -lr / bc1, then sqrt(bc2), computed as
    ``torch.optim.AdamW`` computes them (Python floats, the step
    count + 1), up to the first row past the schedules' end at which every
    value has rounded to its limit."""
    b1, b2 = betas
    # The schedules stop moving at their last step.
    last = max(total_steps, 1) - 1
    lrs = [[s(c) for s in schedules] for c in range(last + 1)]

    def row(count: int, limit: bool = False) -> list[float]:
        lr = lrs[min(count, last)]
        step = float(count + 1)
        bc1 = 1.0 if limit else 1 - b1 ** step
        bc2 = 1.0 if limit else 1 - b2 ** step
        return ([1 - x * weight_decay for x in lr]
                + [-(x / bc1) for x in lr] + [bc2 ** 0.5])

    rows = [row(c) for c in range(last + 1)]
    end = np.float32(row(last, limit=True))
    while (np.float32(rows[-1]) != end).any():
        rows.append(row(len(rows)))
    return torch.tensor(rows, dtype=torch.float64).to(torch.float32)


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
