"""Scale-invariant logarithmic (SiLog) depth loss:

    d = log(target[mask]) - log(pred[mask])
    loss = sqrt(mean(d^2) - lambda * mean(d)^2)

written with masked means over static shapes (no boolean indexing, so no
host sync on the card), in f32, with the JAX package's guards: masked-out
pixels take log(1) and weight 0, the means divide by max(count, eps), and
the square root takes max(value, eps).

``reduce`` (default: none) maps each masked sum to its sum over the ranks
that hold the rest of the batch (``parallel.mesh.global_sum``), so the
loss is the global batch's, as the JAX package computes it on the global
array, and not a mean of per-rank losses.
"""

from __future__ import annotations

import torch


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 eps: float = 1e-12, reduce=_identity) -> torch.Tensor:
    return reduce(torch.sum(x * mask)) / torch.clamp(reduce(torch.sum(mask)),
                                                     min=eps)


def silog_loss(pred: torch.Tensor, target: torch.Tensor,
               valid_mask: torch.Tensor, lambd: float = 0.5,
               eps: float = 1e-12, reduce=_identity) -> torch.Tensor:
    """SiLog loss over valid pixels: a scalar f32 tensor.

    ``pred`` must be strictly positive on valid pixels; ``valid_mask`` is
    boolean or float, of the same shape as ``pred`` and ``target``;
    ``lambd`` is the variance-focus weight (reference default 0.5)."""
    pred = pred.float()
    target = target.float()
    mask = valid_mask.float()
    valid = mask > 0
    safe_pred = torch.where(valid, pred, torch.ones_like(pred))
    safe_target = torch.where(valid, target, torch.ones_like(target))
    diff_log = torch.log(safe_target) - torch.log(safe_pred)
    mean_sq = _masked_mean(diff_log * diff_log, mask, eps, reduce)
    mean = _masked_mean(diff_log, mask, eps, reduce)
    var_focus = mean_sq - lambd * mean * mean
    return torch.sqrt(torch.clamp(var_focus, min=eps))
