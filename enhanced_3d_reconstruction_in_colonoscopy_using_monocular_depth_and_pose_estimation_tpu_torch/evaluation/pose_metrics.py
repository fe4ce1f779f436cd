"""Pose and trajectory metrics: ATE, RTE, ROTE and trajectory composition
(the JAX package's ``evaluation/pose_metrics.py``, the reference's
``eval/evaluation.py``).

``evaluate_trajectory`` takes a flat (N, 7) trajectory in frame order and
evaluates all of it (the reference keeps only the first batch of a
batched one; the JAX package and the port do not copy that).
"""

from __future__ import annotations

import torch

from ..ops import quaternion as quat


def compute_ate(gt_trans: torch.Tensor,
                pred_trans: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error: RMSE of (N, 3) position errors."""
    err = torch.linalg.vector_norm(gt_trans - pred_trans, dim=-1)
    return torch.sqrt(torch.mean(err * err))


def compute_rte(gt_trans: torch.Tensor,
                pred_trans: torch.Tensor) -> torch.Tensor:
    """Relative translation error: mean error of consecutive deltas (NaN
    for fewer than two frames, as in the JAX package)."""
    gt_rel = torch.diff(gt_trans, dim=0)
    pred_rel = torch.diff(pred_trans, dim=0)
    return torch.mean(torch.linalg.vector_norm(gt_rel - pred_rel, dim=-1))


def compute_rote(gt_quats: torch.Tensor,
                 pred_quats: torch.Tensor) -> torch.Tensor:
    """Mean rotation error in degrees between (N, 4) quaternion sequences;
    zero quaternions count as the identity."""
    return torch.mean(quat.geodesic_angle_deg(quat.sanitize(gt_quats),
                                              quat.sanitize(pred_quats)))


def compute_pose_errors(pred_poses: torch.Tensor,
                        gt_poses: torch.Tensor) -> dict[str, torch.Tensor]:
    """ATE, RTE and ROTE of a batch of (B, 7) poses taken as a short
    trajectory: quaternions normalised, predictions flipped into the
    target's hemisphere."""
    pred_poses = pred_poses.float()
    gt_poses = gt_poses.float()
    pred_t, pred_q = pred_poses[:, :3], quat.normalize(pred_poses[:, 3:])
    gt_t, gt_q = gt_poses[:, :3], quat.normalize(gt_poses[:, 3:])
    dot = torch.sum(gt_q * pred_q, dim=1, keepdim=True)
    pred_q = torch.where(dot < 0, -pred_q, pred_q)
    return {"ate": compute_ate(gt_t, pred_t),
            "rte": compute_rte(gt_t, pred_t),
            "rote": compute_rote(gt_q, pred_q)}


def calculate_scale_factor(pred_rel_poses: torch.Tensor,
                           gt_rel_poses: torch.Tensor) -> torch.Tensor:
    """Least-squares scale of the predicted translations onto the target's:
    sum(t_hat . t) / max(sum(t_hat . t_hat), 1e-12)."""
    pred_t = pred_rel_poses[..., :3]
    gt_t = gt_rel_poses[..., :3]
    return torch.sum(pred_t * gt_t) / torch.sum(pred_t * pred_t).clamp_min(
        1e-12)


def evaluate_trajectory(pred_rel_poses: torch.Tensor,
                        gt_rel_poses: torch.Tensor,
                        initial_pose: torch.Tensor | None = None
                        ) -> dict[str, torch.Tensor]:
    """Whole-trajectory metrics of (N, 7) relative poses: scale-align the
    predicted translations, compose both trajectories, then RTE on the
    scaled relative translations, ATE on the absolute positions and ROTE
    on the absolute orientations."""
    pred = torch.as_tensor(pred_rel_poses, dtype=torch.float32)
    gt = torch.as_tensor(gt_rel_poses, dtype=torch.float32).to(pred.device)
    scale = calculate_scale_factor(pred, gt)
    scaled = torch.cat([pred[:, :3] * scale, pred[:, 3:]], dim=1)
    pred_abs = quat.compose_poses(scaled, initial_pose)
    gt_abs = quat.compose_poses(gt, initial_pose)
    return {"rte": compute_rte(scaled[:, :3], gt[:, :3]),
            "ate": compute_ate(gt_abs[:, :3], pred_abs[:, :3]),
            "rote": compute_rote(gt_abs[:, 3:], pred_abs[:, 3:])}
