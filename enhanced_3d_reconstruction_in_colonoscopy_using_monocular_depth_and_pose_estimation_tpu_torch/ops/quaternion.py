"""Quaternion algebra and SE(3) pose composition (the JAX package's
``ops/quaternion.py``).

Quaternions are ``[qx, qy, qz, qw]`` (scalar last), as in the SimCol
``SavedRotationQuaternion_*.txt`` files. Poses are ``[t(3), q(4)]``.

``compose_poses`` chains relative poses into absolute ones. Pose
composition is associative, so it is a Hillis-Steele inclusive scan over
the (t, q) pair: log2(N) rounds of whole-tensor ops, no loop over frames
(the JAX package uses ``jax.lax.associative_scan``; the two sum in other
orders, so they agree to rounding).
"""

from __future__ import annotations

import math

import torch

IDENTITY_QUAT = (0.0, 0.0, 0.0, 1.0)


def normalize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize quaternions along the last axis (safe at zero norm)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def sanitize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Replace (near-)zero quaternions with the identity."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.tensor(IDENTITY_QUAT, dtype=q.dtype, device=q.device)
    return torch.where(n < eps, ident.expand_as(q), q)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate: negate the vector part."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of ``[x, y, z, w]`` quaternions; broadcasts."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([x, y, z, w], dim=-1)


def rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4):
    v' = v + 2 (w (u x v) + u x (u x v))."""
    u, w = q[..., :3], q[..., 3:4]
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (uv * w + uuv)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) ``[x, y, z, w]`` -> rotation matrix (..., 3, 3), as
    ``scipy``'s ``Rotation.from_quat(q).as_matrix()`` (normalised
    first)."""
    x, y, z, w = normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def geodesic_angle_deg(q1: torch.Tensor, q2: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """Rotation angle between two quaternions in degrees,
    2 arccos(|<q1, q2>|) of the normalised pair (double-cover safe)."""
    dot = torch.sum(normalize(q1, eps) * normalize(q2, eps), dim=-1)
    return torch.rad2deg(2.0 * torch.arccos(dot.abs().clamp(0.0, 1.0)))


def relative_pose(pos1: torch.Tensor, quat1: torch.Tensor,
                  pos2: torch.Tensor, quat2: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """Relative pose between consecutive frames, the reference's rule:
    unit-normalised ``pos2 - pos1`` (world frame) and the normalised
    ``q2 * conj(q1)``. Returns ``[t(3), q(4)]``."""
    rel_t = pos2 - pos1
    rel_t = rel_t / (torch.linalg.vector_norm(rel_t, dim=-1, keepdim=True)
                     + eps)
    rel_q = normalize(multiply(quat2, conjugate(quat1)), eps)
    return torch.cat([rel_t, rel_q], dim=-1)


def compose_poses(relative_poses: torch.Tensor,
                  initial_pose: torch.Tensor | None = None) -> torch.Tensor:
    """Chain (N, 7) relative poses into (N+1, 7) absolute ones, starting
    at ``initial_pose`` (7,) or the identity: q_k = q_{k-1} q_rel,
    t_k = t_{k-1} + R(q_{k-1}) t_rel, in float32.

    Each quaternion is sanitised, then normalised: the pair operation is
    associative only for unit quaternions, and raw network outputs are
    not unit."""
    rel = torch.as_tensor(relative_poses, dtype=torch.float32)
    if initial_pose is None:
        initial_pose = torch.tensor([0.0, 0.0, 0.0, *IDENTITY_QUAT])
    init = torch.as_tensor(initial_pose, dtype=torch.float32).to(
        rel.device).reshape(1, 7)
    t = torch.cat([init[:, :3], rel[:, :3]], dim=0)
    q = normalize(sanitize(torch.cat([init[:, 3:], rel[:, 3:]], dim=0)))
    # Hillis-Steele: after the round of offset d, element i holds the
    # composition of elements max(0, i - 2d + 1) .. i.
    for r in range(math.ceil(math.log2(max(t.shape[0], 1)))):
        d = 1 << r
        t = torch.cat([t[:d], t[:-d] + rotate_vector(q[:-d], t[d:])], dim=0)
        q = torch.cat([q[:d], multiply(q[:-d], q[d:])], dim=0)
    return torch.cat([t, q], dim=-1)
