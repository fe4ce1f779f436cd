"""Relative-pose regression loss (the JAX package's
``losses/pose_loss.py``, the reference's ``PoseEstimationModule.pose_loss``):

    L = L_t + beta * L_r + reg_weight * L_reg

- L_t: mean over the batch of sum(((t_hat - t) / max(|t|, eps))^2);
- L_r: mean of 1 - <q_hat, q>^2 on normalised quaternions, the prediction
  flipped into the target's hemisphere first (the double cover);
- L_reg: mean of exp(-|q_hat|) on the raw, unnormalised prediction.
"""

from __future__ import annotations

import torch


def pose_loss(pred_pose: torch.Tensor, gt_pose: torch.Tensor,
              beta: float = 1.0, reg_weight: float = 0.1,
              eps: float = 1e-8) -> torch.Tensor:
    """Scalar f32 loss of (B, 7) ``[t, q]`` predictions against targets."""
    pred_pose = pred_pose.float()
    gt_pose = gt_pose.float()
    pred_t, pred_q = pred_pose[:, :3], pred_pose[:, 3:]
    gt_t, gt_q = gt_pose[:, :3], gt_pose[:, 3:]

    pred_q_norm = torch.linalg.vector_norm(pred_q, dim=1, keepdim=True)
    quat_reg = torch.mean(torch.exp(-pred_q_norm))

    pred_qn = pred_q / pred_q_norm.clamp_min(eps)
    gt_qn = gt_q / torch.linalg.vector_norm(gt_q, dim=1,
                                            keepdim=True).clamp_min(eps)

    trans_scale = torch.linalg.vector_norm(gt_t, dim=1,
                                           keepdim=True).clamp_min(eps)
    l_t = torch.mean(torch.sum(torch.square((pred_t - gt_t) / trans_scale),
                               dim=1))

    dot = torch.sum(pred_qn * gt_qn, dim=1)
    pred_qn = torch.where(dot[:, None] < 0, -pred_qn, pred_qn)
    l_r = torch.mean(1.0 - torch.square(torch.sum(pred_qn * gt_qn, dim=1)))
    return l_t + beta * l_r + reg_weight * quat_reg
