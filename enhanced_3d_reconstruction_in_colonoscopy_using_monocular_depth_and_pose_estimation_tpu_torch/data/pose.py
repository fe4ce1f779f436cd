"""Pose-pair dataset: consecutive RGB-D frames and their relative pose (the
JAX package's ``data/pose.py``, the reference's
``data_processing/pose_estimation.py``).

- Per procedure folder: frames plus ``SavedPosition_*.txt`` (N, 3) and
  ``SavedRotationQuaternion_*.txt`` (N, 4); a folder without them is
  skipped with a warning, and frame-count mismatches truncate to the
  shortest.
- An item is a consecutive pair, channels [rgb1, d1, rgb2, d2]: an
  (8, H, W) f32 input, RGB /255 resized and ImageNet-normalised, depth
  /65535 resized, on the loader's threads (``data.preprocess``'s host
  resize). Batches are NCHW (B, 8, H, W).
- The target is the relative pose (``relative_pose_np``): the unit-norm
  position delta and the normalised ``q2 * conj(q1)``.
- Pairs never straddle procedures, and in validation the blacklisted
  frames are dropped per folder before the pairs are built, so no pair
  spans a removed frame (both as in the JAX package, unlike the
  reference).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from . import io as dio
from .loader import PrefetchLoader
from .preprocess import host_resize_depth, host_resize_image
from ..ops.augment import IMAGENET_MEAN, IMAGENET_STD


def relative_pose_np(p1, q1, p2, q2, eps: float = 1e-8) -> np.ndarray:
    """The reference's relative pose of two frames, ``[t(3), q(4)]``."""
    rel_t = p2 - p1
    rel_t = rel_t / (np.linalg.norm(rel_t) + eps)
    x1, y1, z1, w1 = q1 * np.array([-1.0, -1.0, -1.0, 1.0], np.float32)
    x2, y2, z2, w2 = q2
    rel_q = np.array([
        x2 * w1 + y2 * z1 - z2 * y1 + w2 * x1,
        -x2 * z1 + y2 * w1 + z2 * x1 + w2 * y1,
        x2 * y1 - y2 * x1 + z2 * w1 + w2 * z1,
        -x2 * x1 - y2 * y1 - z2 * z1 + w2 * w1,
    ], np.float32)
    rel_q = rel_q / max(np.linalg.norm(rel_q), eps)
    return np.concatenate([rel_t, rel_q]).astype(np.float32)


class PoseDataset:
    def __init__(self, data_dir: str, data_list: str, size: int, mode: str,
                 ds_type: str = "simcol"):
        if mode not in ("Train", "Val", "Test"):
            raise ValueError("Mode must be one of: 'Train', 'Val', 'Test'")
        self.data_dir = data_dir
        self.size = size
        self.mode = mode
        self.ds_type = ds_type
        self.rgb_paths: list[str] = []
        self.depth_paths: list[str] = []
        self.poses: list[np.ndarray] = []
        self._pair_indices: list[int] = []
        bad = {os.path.join(data_dir, f) for f in dio.BAD_VAL_FRAMES}

        for folder in dio.read_split_list(data_list):
            depth_frames, rgb_frames = dio.load_frames(
                os.path.join(data_dir, folder))
            loaded = dio.load_pose_files(data_dir, folder)
            if loaded is None:
                print(f"Warning: Position file not found for {folder}")
                continue
            positions, orientations = loaded
            n = min(len(positions), len(orientations), len(rgb_frames),
                    len(depth_frames))
            poses = list(np.concatenate([positions[:n], orientations[:n]],
                                        axis=1))
            keep = list(range(n))
            if mode == "Val":
                keep = [i for i in keep if rgb_frames[i] not in bad]
            start = len(self.rgb_paths)
            self.rgb_paths.extend(rgb_frames[i] for i in keep)
            self.depth_paths.extend(depth_frames[i] for i in keep)
            self.poses.extend(poses[i] for i in keep)
            # Pairs of frames consecutive in the original numbering only.
            self._pair_indices.extend(
                start + j for j in range(len(keep) - 1)
                if keep[j + 1] == keep[j] + 1)

    def __len__(self) -> int:
        return len(self._pair_indices)

    def _load_frame(self, idx: int) -> np.ndarray:
        rgb = host_resize_image(dio.decode_rgb(self.rgb_paths[idx]),
                                self.size)
        rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD
        depth = host_resize_depth(
            dio.decode_depth16_png(self.depth_paths[idx]), self.size)
        return np.concatenate([rgb.transpose(2, 0, 1), depth[None]])

    def __getitem__(self, index: int) -> dict[str, Any]:
        idx = self._pair_indices[index]
        inp = np.concatenate([self._load_frame(idx),
                              self._load_frame(idx + 1)]).astype(np.float32)
        pose1, pose2 = self.poses[idx], self.poses[idx + 1]
        target = relative_pose_np(pose1[:3], pose1[3:], pose2[:3], pose2[3:])
        parts = os.path.normpath(self.rgb_paths[idx]).split(os.path.sep)
        return {"dataset": "/".join(parts[-3:-1]), "id": parts[-1],
                "input": inp,       # (8, H, W)
                "target": target}   # (7,)


class PoseDataModule:
    """Loader factory with the reference datamodule's interface."""

    # This process's rank and the world the loaders shard each batch
    # over (set by the entry points; one process by default).
    rank = 0
    world = 1

    def __init__(self, data_dir: str, train_list: str, val_list: str,
                 test_list: str, ds_type: str = "simcol",
                 batch_size: int = 64, num_workers: int = 8, size: int = 518,
                 seed: int = 42, **_unused):
        self.data_dir = data_dir
        self.train_list = train_list
        self.val_list = val_list
        self.test_list = test_list
        self.ds_type = ds_type
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.size = size
        self.seed = seed
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None

    def setup(self, stage: str | None = None) -> None:
        if stage in ("fit", None):
            self.train_dataset = PoseDataset(
                self.data_dir, self.train_list, self.size, "Train",
                self.ds_type)
            self.val_dataset = PoseDataset(
                self.data_dir, self.val_list, self.size, "Val", self.ds_type)
        if stage in ("test", None):
            self.test_dataset = PoseDataset(
                self.data_dir, self.test_list, self.size, "Test",
                self.ds_type)

    def train_loader(self) -> PrefetchLoader:
        return PrefetchLoader(self.train_dataset, self.batch_size,
                              shuffle=True, drop_last=True,
                              num_threads=self.num_workers,
                              rank=self.rank, world=self.world, seed=self.seed)

    def val_loader(self) -> PrefetchLoader:
        # In frame order: the trajectory metrics compose consecutive pairs.
        return PrefetchLoader(self.val_dataset, self.batch_size,
                              shuffle=False, drop_last=False,
                              num_threads=self.num_workers)

    def test_loader(self) -> PrefetchLoader:
        return PrefetchLoader(self.test_dataset, self.batch_size,
                              shuffle=False, drop_last=False,
                              num_threads=self.num_workers)
