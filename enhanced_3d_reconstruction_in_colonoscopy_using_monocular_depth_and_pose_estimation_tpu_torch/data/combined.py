"""Combined SimCol + C3VD dataset (the JAX package's
``data/combined.py``).

Concatenation with cumulative-length routing and a per-sample ``source``
tag (0 = SimCol, 1 = C3VD). Both children are built with
``host_resize=True``, since their native resolutions differ and a batch
must stack.

Units: C3VD depths are in mm with max 100, SimCol's in cm with max 20.
The combined task trains in cm: ``DevicePreprocessor`` gives each sample
its ``max_depth`` (20 for SimCol, 10 for C3VD) from ``source`` and
scales C3VD depth by 0.1.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .c3vd import C3VDDataset
from .loader import PrefetchLoader
from .simcol import SimColDataset

SIMCOL_SOURCE = 0
C3VD_SOURCE = 1


class CombinedDataset:
    def __init__(self, simcol: SimColDataset, c3vd: C3VDDataset,
                 size: int = 518):
        self.simcol = simcol
        self.c3vd = c3vd
        self.size = size
        self.cumulative_lengths = np.cumsum([len(simcol), len(c3vd)])

    def __len__(self) -> int:
        return int(self.cumulative_lengths[-1])

    def __getitem__(self, index: int) -> dict[str, Any]:
        if index < self.cumulative_lengths[0]:
            sample = self.simcol[index]
            sample["source"] = SIMCOL_SOURCE
        else:
            sample = self.c3vd[index - int(self.cumulative_lengths[0])]
            sample["source"] = C3VD_SOURCE
        return sample


class CombinedDataModule:

    # This process's rank and the world the loaders shard each batch
    # over (set by the entry points; one process by default).
    rank = 0
    world = 1
    def __init__(self, simcol_data_dir: str, simcol_train_list: str,
                 simcol_val_list: str, simcol_test_list: str,
                 c3vd_data_dir: str, c3vd_train_list: str,
                 c3vd_val_list: str, c3vd_test_list: str | None = None,
                 ds_type: str = "combined", batch_size: int = 64,
                 num_workers: int = 8, size: int = 518, seed: int = 42,
                 **_unused):
        self.args = dict(
            simcol=(simcol_data_dir, simcol_train_list, simcol_val_list,
                    simcol_test_list),
            c3vd=(c3vd_data_dir, c3vd_train_list, c3vd_val_list,
                  c3vd_test_list or c3vd_val_list),
        )
        self.ds_type = ds_type
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.size = size
        self.seed = seed
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None

    def _make(self, mode: str, list_idx: int) -> CombinedDataset:
        s_dir, *s_lists = self.args["simcol"]
        c_dir, *c_lists = self.args["c3vd"]
        # Mixed native resolutions -> resize in loader threads so batches
        # stack (same resampling weights as the device path).
        simcol = SimColDataset(s_dir, s_lists[list_idx], self.size, mode,
                               host_resize=True)
        c3vd = C3VDDataset(c_dir, c_lists[list_idx], self.size, mode,
                           host_resize=True)
        return CombinedDataset(simcol, c3vd, self.size)

    def setup(self, stage: str | None = None) -> None:
        if stage in ("fit", None):
            self.train_dataset = self._make("Train", 0)
            self.val_dataset = self._make("Val", 1)
        if stage in ("test", None):
            self.test_dataset = self._make("Test", 2)

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
