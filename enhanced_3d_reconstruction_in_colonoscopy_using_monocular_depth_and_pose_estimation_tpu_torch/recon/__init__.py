"""Reconstruction: depth and pose -> point clouds and Poisson meshes (the
JAX package's ``recon``)."""

from .pointcloud import (
    backproject_depth,
    transform_points,
    pose_to_matrix,
    load_intrinsics,
    voxel_downsample,
)
from .ply import write_ply, read_ply

__all__ = [
    "backproject_depth",
    "transform_points",
    "pose_to_matrix",
    "load_intrinsics",
    "voxel_downsample",
    "write_ply",
    "read_ply",
]
