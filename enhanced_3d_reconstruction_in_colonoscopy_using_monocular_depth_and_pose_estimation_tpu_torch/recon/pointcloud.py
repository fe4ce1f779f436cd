"""Depth -> point cloud reconstruction on tensors (the JAX package's
``recon/pointcloud.py``).

Replaces the reference's Open3D pipeline (its ``depth_to_pointcloud.py``):

- ``backproject_depth``: pinhole back-projection with Open3D RGBD
  semantics (``create_from_color_and_depth``: depth / ``depth_scale``,
  truncation at ``depth_trunc``), on the depth tensor's device;
- ``pose_to_matrix``: position + quaternion -> 4x4 (scipy semantics via
  ``ops.quaternion.to_rotation_matrix``);
- ``transform_points``: homogeneous transform (Open3D
  ``PointCloud.transform``);
- ``voxel_downsample``: voxel-grid averaging of points, colours and
  normals (Open3D ``voxel_down_sample``) on the points' device: origin at
  the minimum, f64 averages, normals renormalised.

Invalid pixels (zero or truncated depth) are masked, not dropped:
``backproject_depth`` returns every pixel and a valid mask.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quaternion as quat


def load_intrinsics(path: str) -> tuple[float, float, float, float]:
    """cam.txt (flat 9 or 3x3) -> (fx, fy, cx, cy)."""
    vals = np.loadtxt(path).reshape(3, 3)
    return (float(vals[0, 0]), float(vals[1, 1]), float(vals[0, 2]),
            float(vals[1, 2]))


def pose_to_matrix(position, quaternion) -> torch.Tensor:
    """(3,), (4,) [x, y, z, w] -> (4, 4) f32 homogeneous transform, on the
    quaternion's device."""
    q = torch.as_tensor(quaternion, dtype=torch.float32)
    mat = torch.eye(4, dtype=torch.float32, device=q.device)
    mat[:3, :3] = quat.to_rotation_matrix(q)
    mat[:3, 3] = torch.as_tensor(position, dtype=torch.float32,
                                 device=q.device)
    return mat


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as IEEE division on every device (CUDA turns a
    division by a host scalar into a product with its reciprocal)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def transform_points(points: torch.Tensor,
                     transform: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (4, 4) homogeneous transform: ``points @ R.T + t``, summed
    term by term in f32 (no GEMM, so no TF32 on the card)."""
    rot = transform[:3, :3]
    return (points[:, 0:1] * rot[:, 0] + points[:, 1:2] * rot[:, 1]
            + points[:, 2:3] * rot[:, 2] + transform[:3, 3])


def backproject_depth(depth, fx: float, fy: float, cx: float, cy: float,
                      color=None, depth_scale: float = 1000.0,
                      depth_trunc: float = 3.0, transform=None):
    """Back-project a (H, W) depth image to camera or world points.

    Args:
        depth: (H, W) raw depth tensor or array (e.g. uint16 millimetres;
            divided by ``depth_scale`` like Open3D's RGBD constructor).
            The work runs on its device.
        color: optional (H, W, 3): an integer dtype is scaled by 1/255,
            a floating one is taken as [0, 1] (the dtype decides, like
            Open3D's unconditional uint8 / 255, not the values).
        transform: optional (4, 4) camera-to-world matrix.

    Returns:
        (points (H*W, 3) f32, colours (H*W, 3) f32 or None, valid (H*W,)
        bool): every pixel, with ``0 < z < depth_trunc`` in ``valid``.
    """
    depth = torch.as_tensor(depth)
    dev = depth.device
    z = _div(depth.to(torch.float32), depth_scale)
    h, w = z.shape
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    valid = (z > 0) & (z < depth_trunc)
    x = _div((u - cx) * z, fx)
    y = _div((v - cy) * z, fy)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    if transform is not None:
        pts = transform_points(pts, torch.as_tensor(transform).to(dev))
    cols = None
    if color is not None:
        cols = torch.as_tensor(color).to(dev)
        scale = 1.0 if cols.is_floating_point() else 255.0
        cols = cols.to(torch.float32).reshape(-1, 3) / scale
    return pts, cols, valid.reshape(-1)


def _voxel_ids(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(inverse, counts) of the unique rows of non-negative (N, 3) int64
    voxel keys, in lexicographic row order (``np.unique(axis=0)``'s): one
    packed key per row where it fits 63 bits, else a row-wise unique."""
    span = keys.max(dim=0).values + 1
    sx, sy, sz = (int(s) for s in span.tolist())
    if sx * sy * sz < 2 ** 62:
        packed = (keys[:, 0] * sy + keys[:, 1]) * sz + keys[:, 2]
        _, inverse, counts = torch.unique(packed, return_inverse=True,
                                          return_counts=True)
    else:
        _, inverse, counts = torch.unique(keys, dim=0, return_inverse=True,
                                          return_counts=True)
    return inverse, counts


def voxel_downsample(points: torch.Tensor, voxel_size: float,
                     colors: torch.Tensor | None = None,
                     normals: torch.Tensor | None = None):
    """Voxel-grid average downsampling (Open3D ``voxel_down_sample``) on
    the points' device.

    Points in the same voxel (grid origin at the cloud's minimum) are
    averaged in f64, as are colours and normals; normals are
    renormalised. Returns f32 tensors (points, colours or None, normals
    or None).
    """
    dev = points.device
    pts = points.to(torch.float64)
    if len(pts) == 0:
        return pts.to(torch.float32), colors, normals
    keys = torch.floor(_div(pts - pts.min(dim=0).values, voxel_size)).to(
        torch.int64)
    inverse, counts = _voxel_ids(keys)
    n_vox = len(counts)

    def avg(values):
        out = torch.zeros((n_vox, values.shape[1]), dtype=torch.float64,
                          device=dev)
        out.index_add_(0, inverse, values.to(dev, torch.float64))
        return out / counts[:, None]

    out_pts = avg(pts).to(torch.float32)
    out_cols = avg(colors).to(torch.float32) if colors is not None else None
    out_nrm = None
    if normals is not None:
        out_nrm = avg(normals)
        norm = torch.linalg.vector_norm(out_nrm, dim=1, keepdim=True)
        out_nrm = (out_nrm / torch.clamp_min(norm, 1e-12)).to(torch.float32)
    return out_pts, out_cols, out_nrm
