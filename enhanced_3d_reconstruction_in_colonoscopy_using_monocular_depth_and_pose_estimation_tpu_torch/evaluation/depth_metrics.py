"""Depth-estimation metrics (D1, AbsRel, RMSE, L1) over a validity mask.

Definitions over valid pixels, in f32, with the JAX package's guards
(masked-out pixels divide by 1, means divide by max(count, 1e-12)):

    l1      = mean(|pred - gt|)
    abs_rel = mean(|pred - gt| / (gt + 1e-6))
    rmse    = sqrt(mean((pred - gt)^2))
    d1      = mean(max(gt/pred, pred/gt) < 1.1)

``reduce`` maps each masked sum to its sum over the ranks that hold the
rest of the batch, as in ``losses.silog``.
"""

from __future__ import annotations

import torch

DEPTH_METRIC_NAMES = ("d1", "abs_rel", "rmse", "l1")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, reduce,
                 eps: float = 1e-12) -> torch.Tensor:
    return reduce(torch.sum(x * mask)) / torch.clamp(reduce(torch.sum(mask)),
                                                     min=eps)


def compute_depth_errors(pred: torch.Tensor, gt: torch.Tensor,
                         valid_mask: torch.Tensor | None = None,
                         reduce=lambda x: x) -> dict[str, torch.Tensor]:
    """D1/AbsRel/RMSE/L1 over valid pixels (all pixels if no mask), as a
    dict of scalar f32 tensors."""
    pred = pred.float()
    gt = gt.float()
    mask = torch.ones_like(pred) if valid_mask is None else valid_mask.float()

    diff = pred - gt
    epsilon = 1e-6
    l1 = _masked_mean(diff.abs(), mask, reduce)
    abs_rel = _masked_mean(diff.abs() / (gt + epsilon), mask, reduce)
    rmse = torch.sqrt(_masked_mean(diff * diff, mask, reduce))

    valid = mask > 0
    safe_pred = torch.where(valid, pred, torch.ones_like(pred))
    safe_gt = torch.where(valid, gt, torch.ones_like(gt))
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    d1 = _masked_mean((thresh < 1.1).float(), mask, reduce)
    return {"d1": d1, "abs_rel": abs_rel, "rmse": rmse, "l1": l1}
