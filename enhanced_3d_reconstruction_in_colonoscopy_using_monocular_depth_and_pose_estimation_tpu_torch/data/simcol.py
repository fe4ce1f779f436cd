"""SimCol3D depth dataset + datamodule (the JAX package's
``data/simcol.py``).

- split lists are comma-separated folder names; frames are paired by the
  Depth_/FrameBuffer_ markers; Val drops the bad-frame blacklist;
- the dataset yields raw decoded arrays: /255 and /65535, the resize, the
  augmentation and the normalisation run on the device
  (``data.preprocess.DevicePreprocessor``), unless ``host_resize`` asks
  for [0, 1] f32 at (size, size) from the loader threads.

Samples: {"image": uint8 (H0, W0, 3), "depth": uint16 (H0, W0),
          "dataset": str, "id": str}.
"""

from __future__ import annotations

import os
from typing import Any

from . import io as dio
from .loader import PrefetchLoader
from .preprocess import host_resize_depth, host_resize_image


class SimColDataset:
    def __init__(self, data_dir: str, data_list: str, size: int, mode: str,
                 ds_type: str = "simcol", host_resize: bool = False):
        if mode not in ("Train", "Val", "Test"):
            raise ValueError("Mode must be one of: 'Train', 'Val', 'Test'")
        self.data_dir = data_dir
        self.size = size
        self.mode = mode
        self.ds_type = ds_type
        # host_resize: emit [0,1] f32 at (size, size) from loader threads
        # (needed when batches mix native resolutions, e.g. combined).
        self.host_resize = host_resize

        folders = dio.read_split_list(data_list)
        self.input_paths: list[str] = []
        self.target_paths: list[str] = []
        for folder in folders:
            folder_path = os.path.join(data_dir, folder)
            depth_frames, rgb_frames = dio.load_frames(folder_path)
            self.input_paths.extend(rgb_frames)
            self.target_paths.extend(depth_frames)

        if mode == "Val":
            self.input_paths, self.target_paths, _ = dio.remove_bad_frames(
                data_dir, self.input_paths, self.target_paths)

        if len(self.input_paths) != len(self.target_paths):
            raise ValueError(f"Mismatch in number of images and depths for "
                             f"{mode} set")

    def __len__(self) -> int:
        return len(self.input_paths)

    def sample_meta(self, index: int) -> dict[str, str]:
        parts = os.path.normpath(self.input_paths[index]).split(os.path.sep)
        return {"dataset": "/".join(parts[-3:-1]), "id": parts[-1]}

    def __getitem__(self, index: int) -> dict[str, Any]:
        image = dio.decode_rgb(self.input_paths[index])
        depth = dio.decode_depth16_png(self.target_paths[index])
        if self.host_resize:
            image = host_resize_image(image, self.size)
            depth = host_resize_depth(depth, self.size)
        meta = self.sample_meta(index)
        return {"image": image, "depth": depth,
                "dataset": meta["dataset"], "id": meta["id"],
                "ds_type": self.ds_type}


class SimColDataModule:
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
            self.train_dataset = SimColDataset(
                self.data_dir, self.train_list, self.size, "Train",
                self.ds_type)
            self.val_dataset = SimColDataset(
                self.data_dir, self.val_list, self.size, "Val", self.ds_type)
        if stage in ("test", None):
            self.test_dataset = SimColDataset(
                self.data_dir, self.test_list, self.size, "Test",
                self.ds_type)

    def train_loader(self) -> PrefetchLoader:
        return PrefetchLoader(self.train_dataset, self.batch_size,
                              shuffle=True, drop_last=True,
                              num_threads=self.num_workers,
                              rank=self.rank, world=self.world, seed=self.seed)

    def val_loader(self) -> PrefetchLoader:
        return PrefetchLoader(self.val_dataset, self.batch_size,
                              shuffle=False, drop_last=False,
                              num_threads=self.num_workers,
                              rank=self.rank, world=self.world)

    def test_loader(self) -> PrefetchLoader:
        return PrefetchLoader(self.test_dataset, self.batch_size,
                              shuffle=False, drop_last=False,
                              num_threads=self.num_workers,
                              rank=self.rank, world=self.world)
