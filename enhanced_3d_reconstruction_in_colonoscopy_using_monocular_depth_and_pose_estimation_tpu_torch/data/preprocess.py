"""Batch preparation for depth training and evaluation: the host resize
helpers and the device-side ``DevicePreprocessor``.

``host_resize_image`` and ``host_resize_depth`` turn one decoded frame
into [0, 1] f32 at (size, size) with numpy matmuls in the loader's
threads (batches that mix native resolutions, as combined SimCol + C3VD
does), on the same bicubic antialias weights as the device resize
(``ops.resize._antialias_matrix``).

``DevicePreprocessor`` takes a loader batch (raw uint8 images and uint16
depth, or [0, 1] floats already resized on the host), uploads it, and on
the device divides by 255 and 65535, resizes both to the model size with
the antialiased bicubic resize (``ops.resize``, f32), and augments and
normalises the image (``ops.augment``). As in the JAX package, the
augmentation touches the image only: hflip and affine never move the
depth, a property of the reference that is kept, not fixed. Combined
SimCol + C3VD batches (a ``source`` field) get a per-sample ``max_depth``
and C3VD depths scaled by 0.1 (mm to cm). Each call is a
``train.preprocess`` span in ``core.debug``'s recorder (host time: the
device work it queues runs on after it).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import debug
from ..core.device import resolve_device
from ..ops import augment as aug
from ..ops.resize import _antialias_matrix, resize_antialias


def _host_resize(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) float32 resize via the shared bicubic-antialias
    weights."""
    mat_h = _antialias_matrix(x.shape[0], out_hw[0], "bicubic")
    mat_w = _antialias_matrix(x.shape[1], out_hw[1], "bicubic")
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    y = np.einsum("oh,hwc->owc", mat_h, x.astype(np.float32), optimize=True)
    y = np.einsum("ow,hwc->hoc", mat_w, y, optimize=True)
    return y[..., 0] if squeeze else y


def host_resize_image(img_uint8: np.ndarray, size: int) -> np.ndarray:
    """uint8 RGB -> [0,1] f32 at (size, size)."""
    return _host_resize(img_uint8.astype(np.float32) / 255.0, (size, size))


def host_resize_depth(depth_uint16: np.ndarray, size: int) -> np.ndarray:
    """uint16 depth -> [0,1] f32 at (size, size)."""
    return _host_resize(depth_uint16.astype(np.float32) / 65535.0,
                        (size, size))


class DevicePreprocessor:
    """Loader batches -> model-ready batches on ``device``."""

    def __init__(self, size: int = 518,
                 augment_cfg: aug.AugmentConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.size = size
        self.augment_cfg = augment_cfg or aug.AugmentConfig()
        self.device = resolve_device(device)

    def _to01(self, image: torch.Tensor, depth: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """[0, 1] image (B, S, S, 3) and depth (B, S, S, 1) at the model
        size."""
        if image.dtype == torch.uint8:
            size = (self.size, self.size)
            img01 = resize_antialias(image.float() / 255.0, size)
            dep01 = resize_antialias(depth.float()[..., None] / 65535.0, size)
            return img01, dep01
        return image, depth[..., None] if depth.dim() == 3 else depth

    def __call__(self, batch: dict[str, Any], train: bool,
                 generator: torch.Generator | None = None,
                 max_depths: tuple[float, float] | None = None,
                 aug_params: aug.AugmentParams | None = None,
                 rows: tuple[int, int] | None = None
                 ) -> dict[str, torch.Tensor]:
        """batch: loader output with ``image`` and ``depth`` (numpy or
        tensors). Returns {image, depth[, max_depth, source]} on the device.

        ``train`` augments with draws from ``generator`` (a CPU
        ``torch.Generator``), or with ``aug_params`` given explicitly.
        ``max_depths``: (simcol_max, c3vd_max_in_cm) for batches with a
        ``source`` field. ``rows`` (offset, total) places the batch in a
        global batch whose draws it shares (``ops.augment.augment_batch``)."""
        with debug.span("train.preprocess"):
            return self._prepare(batch, train, generator, max_depths,
                                 aug_params, rows)

    def _prepare(self, batch, train, generator, max_depths, aug_params,
                 rows) -> dict[str, torch.Tensor]:
        image = torch.as_tensor(batch["image"]).to(self.device)
        depth = torch.as_tensor(batch["depth"]).to(self.device)
        if depth.dtype == torch.uint16:
            depth = depth.to(torch.int32)  # uint16 has few kernels
        img01, dep = self._to01(image, depth)
        if train and aug_params is not None:
            img = aug.apply_augment(img01, aug_params)
        elif train:
            if generator is None:
                raise ValueError("train=True needs a generator or "
                                 "aug_params")
            img = aug.augment_batch(img01, generator, self.augment_cfg,
                                    rows)
        else:
            img = aug.preprocess_eval(img01)

        out = {"image": img, "depth": dep}
        if "source" in batch and max_depths is not None:
            source = torch.as_tensor(np.asarray(batch["source"])).to(
                self.device)
            scale = torch.where(source == 1, 0.1, 1.0).float()
            out["depth"] = dep * scale[:, None, None, None]
            out["max_depth"] = torch.where(
                source == 1, max_depths[1], max_depths[0]).float()
            out["source"] = source
        return out
