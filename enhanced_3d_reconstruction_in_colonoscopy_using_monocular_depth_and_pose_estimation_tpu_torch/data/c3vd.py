"""C3VD depth dataset + datamodule (the JAX package's ``data/c3vd.py``).

``*_color.png`` / ``[0-9]*_*.png`` colour frames are paired with
``{n}_depth.tiff`` (zero-pad fallback) and decoded by the port's readers
(``data.io``: BGR->RGB as cv2 reads them, uint16 colour cut to uint8);
depths are 16-bit, scaled /65535 on the device. Missing folders warn and
are skipped.
"""

from __future__ import annotations

import os
from typing import Any

from . import io as dio
from .loader import PrefetchLoader
from .preprocess import host_resize_depth, host_resize_image


class C3VDDataset:
    def __init__(self, data_dir: str, data_list: str, size: int, mode: str,
                 ds_type: str = "c3vd", host_resize: bool = False):
        if mode not in ("Train", "Val", "Test"):
            raise ValueError("Mode must be one of: 'Train', 'Val', 'Test'")
        self.data_dir = data_dir
        self.size = size
        self.mode = mode
        self.ds_type = ds_type
        self.host_resize = host_resize

        self.images: list[str] = []
        self.depths: list[str] = []
        for folder in dio.read_split_list(data_list):
            folder_path = os.path.join(data_dir, folder)
            if not os.path.exists(folder_path):
                print(f"Warning: Folder does not exist: {folder_path}")
                continue
            imgs, deps = dio.pair_c3vd_folder(folder_path)
            self.images.extend(imgs)
            self.depths.extend(deps)

    def __len__(self) -> int:
        return len(self.images)

    def sample_meta(self, index: int) -> dict[str, str]:
        parts = os.path.normpath(self.images[index]).split(os.path.sep)
        return {"dataset": parts[-3] if len(parts) >= 3 else parts[0],
                "id": os.path.basename(self.images[index]).split(".")[0]}

    def __getitem__(self, index: int) -> dict[str, Any]:
        image = dio.decode_c3vd_color(self.images[index])
        depth = dio.decode_c3vd_depth(self.depths[index])
        if self.host_resize:
            image = host_resize_image(image, self.size)
            depth = host_resize_depth(depth, self.size)
        meta = self.sample_meta(index)
        return {"image": image, "depth": depth,
                "dataset": meta["dataset"], "id": meta["id"],
                "ds_type": self.ds_type}


class C3VDDataModule:

    # This process's rank and the world the loaders shard each batch
    # over (set by the entry points; one process by default).
    rank = 0
    world = 1
    def __init__(self, data_dir: str, train_list: str, val_list: str,
                 test_list: str | None = None, ds_type: str = "c3vd",
                 batch_size: int = 64, num_workers: int = 8, size: int = 518,
                 seed: int = 42, **_unused):
        self.data_dir = data_dir
        self.train_list = train_list
        self.val_list = val_list
        self.test_list = test_list or val_list
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
            self.train_dataset = C3VDDataset(
                self.data_dir, self.train_list, self.size, "Train",
                self.ds_type)
            self.val_dataset = C3VDDataset(
                self.data_dir, self.val_list, self.size, "Val", self.ds_type)
        if stage in ("test", None):
            self.test_dataset = C3VDDataset(
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
