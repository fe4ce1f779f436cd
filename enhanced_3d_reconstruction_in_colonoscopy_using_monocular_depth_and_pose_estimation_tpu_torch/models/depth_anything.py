"""DepthAnythingV2-style metric depth model (encoder + DPT head) and the
inference pipeline.

``infer_image`` and the batched ``_run_batched_u8`` reproduce the
reference's per-frame semantics: lower-bound aspect-preserving resize to
multiples of 14, ImageNet normalization, forward, bilinear back to the
frame size. Batched serving uploads uint8 BGR and does the flip and /255
on the device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtypes import POLICY_BF16
from ..ops.resize import resize_align_corners, resize_antialias
from .dinov2 import PATCH_SIZE, VIT_ARCHS, DinoViT
from .dpt import DPTHead

MODEL_CONFIGS: dict[str, dict[str, Any]] = {
    "vits": {"encoder": "vits", "features": 64,
             "out_channels": [48, 96, 192, 384]},
    "vitb": {"encoder": "vitb", "features": 128,
             "out_channels": [96, 192, 384, 768]},
    "vitl": {"encoder": "vitl", "features": 256,
             "out_channels": [256, 512, 1024, 1024]},
    "vitg": {"encoder": "vitg", "features": 384,
             "out_channels": [1536, 1536, 1536, 1536]},
    # tiny debug config (not in the reference)
    "vitt": {"encoder": "vitt", "features": 32,
             "out_channels": [16, 32, 48, 64]},
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DepthAnythingV2(nn.Module):
    """Metric monocular depth: ``depth = sigmoid(head(vit(x))) * max_depth``.

    Input: (B, H, W, 3) NHWC, ImageNet-normalized, H/W multiples of 14.
    Output: (B, H, W) depth in [0, max_depth], f32. ``dtype`` is the
    compute dtype of encoder and decoder; parameters stay f32.
    """

    def __init__(self, encoder: str = "vitl", features: int = 256,
                 out_channels: tuple[int, ...] = (256, 512, 1024, 1024),
                 max_depth: float = 20.0,
                 dtype: torch.dtype = POLICY_BF16.compute_dtype):
        super().__init__()
        self.max_depth = max_depth
        self.pretrained = DinoViT(encoder, dtype)
        self.depth_head = DPTHead(VIT_ARCHS[encoder]["embed_dim"], features,
                                  out_channels)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = img.shape
        taps = self.pretrained(img)
        depth01 = self.depth_head(taps, h // PATCH_SIZE, w // PATCH_SIZE)
        return depth01 * self.max_depth


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights: LeCun-normal matrices and conv kernels (as
    the JAX package's flax initialisers), pos-embed N(0, 0.02), zero
    biases and tokens, unit norm scales and LayerScales."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            p.normal_(0.0, 0.02, generator=gen)
        elif p.dim() >= 2 and leaf == "weight":
            transposed = name.startswith("depth_head.resize_layers.") and \
                name.split(".")[2] in ("0", "1")
            fan_in = p.shape[0] if transposed else p[0].numel()
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        elif leaf in ("weight", "gamma"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def build_depth_model(encoder: str, max_depth: float = 20.0,
                      dtype: torch.dtype = POLICY_BF16.compute_dtype,
                      device: str | torch.device = "cuda",
                      seed: int = 0) -> DepthAnythingV2:
    """The ``encoder`` model on ``device`` in eval mode, with seeded random
    weights (load a checkpoint over them with ``models.convert``)."""
    dev = resolve_device(device)
    cfg = MODEL_CONFIGS[encoder]
    with dev:
        model = DepthAnythingV2(cfg["encoder"], cfg["features"],
                                tuple(cfg["out_channels"]), max_depth, dtype)
    return init_random(model, seed).eval()


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _lower_bound_hw(h: int, w: int, target: int,
                    multiple: int = PATCH_SIZE) -> tuple[int, int]:
    """Aspect-preserving resize so min(H', W') >= target, rounded to
    multiples of 14 (DAv2 ``image2tensor`` lower-bound semantics)."""
    scale = max(target / h, target / w)
    def round_up_to(x: float) -> int:
        return int(np.ceil(x / multiple) * multiple)
    def round_to(x: float) -> int:
        r = int(np.round(x / multiple) * multiple)
        if r < target:
            r = round_up_to(x)
        return max(r, multiple)
    return round_to(h * scale), round_to(w * scale)


def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


@torch.inference_mode()
def infer_image(model: DepthAnythingV2, bgr: np.ndarray,
                input_size: int = 518) -> np.ndarray:
    """Reference ``infer_image`` pipeline on one BGR uint8 frame, on the
    model's device: BGR->RGB, /255 on the host, lower-bound resize to
    multiples of 14, normalize, forward, bilinear back to the original
    resolution. Returns f32 depth (H, W) in metric units."""
    dev = _model_device(model)
    rgb01 = torch.from_numpy(
        np.ascontiguousarray(bgr[..., ::-1]).astype(np.float32) / 255.0)
    net_hw = _lower_bound_hw(bgr.shape[0], bgr.shape[1], input_size)
    out = _run_batched(model, rgb01[None].to(dev), net_hw, bgr.shape[:2])
    return out[0].cpu().numpy()


@torch.inference_mode()
def _run_batched(model: DepthAnythingV2, rgb01: torch.Tensor,
                 net_hw: tuple[int, int], out_hw: tuple[int, int]
                 ) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> (B, *out_hw) f32 depth."""
    mean, std = _imagenet(rgb01.device)
    x = resize_antialias(rgb01, net_hw, method="bicubic")
    x = (x - mean) / std
    depth = model(x)
    return resize_align_corners(depth[..., None], tuple(out_hw))[..., 0]


@torch.inference_mode()
def _run_batched_u8(model: DepthAnythingV2, bgr_u8: torch.Tensor,
                    net_hw: tuple[int, int], out_hw: tuple[int, int],
                    readback_f16: bool = False) -> torch.Tensor:
    """uint8-BGR entry: the BGR->RGB flip and /255 run on the device, so
    the host uploads 4x fewer bytes than the f32 form. ``readback_f16``
    halves the depth readback (f16 keeps ~0.01 absolute at the 20 m
    range cap)."""
    rgb01 = bgr_u8.flip(-1).float() / 255.0
    out = _run_batched(model, rgb01, net_hw, out_hw)
    return out.half() if readback_f16 else out


class BatchedRunner:
    """Batched inference for ONE frame resolution on the model's device.

    Frames go up as uint8 in chunks of ``batch_size`` (ragged tails
    zero-padded, so every batch has one shape) and come back as (H, W)
    float depth maps (f16 with ``readback_f16``)."""

    def __init__(self, model: DepthAnythingV2,
                 resolution_hw: tuple[int, int], input_size: int = 518,
                 batch_size: int = 8, readback_f16: bool = False):
        h, w = resolution_hw
        self.model = model
        self.resolution_hw = (h, w)
        self.batch_size = batch_size
        self.readback_f16 = readback_f16
        self.net_hw = _lower_bound_hw(h, w, input_size)
        self.device = _model_device(model)

    def __call__(self, bgr_frames: list[np.ndarray]) -> list[np.ndarray]:
        for f in bgr_frames:
            if f.shape[:2] != self.resolution_hw:
                raise ValueError("BatchedRunner is built for "
                                 f"{self.resolution_hw}; got {f.shape[:2]}")
        outputs: list[np.ndarray] = []
        for arr, n in chunk_bgr_u8(bgr_frames, self.batch_size):
            x = torch.from_numpy(arr).to(self.device)
            depth = _run_batched_u8(self.model, x, self.net_hw,
                                    self.resolution_hw, self.readback_f16)
            outputs.extend(depth[:n].cpu().numpy())
        return outputs


def infer_images_batched(model: DepthAnythingV2,
                         bgr_frames: list[np.ndarray],
                         input_size: int = 518, batch_size: int = 8
                         ) -> list[np.ndarray]:
    """Batched inference over same-resolution BGR uint8 frames."""
    if not bgr_frames:
        return []
    h, w = bgr_frames[0].shape[:2]
    for f in bgr_frames:
        if f.shape[:2] != (h, w):
            raise ValueError("infer_images_batched requires equal "
                             "resolutions; use infer_image for mixed sizes")
    return BatchedRunner(model, (h, w), input_size, batch_size)(bgr_frames)


def chunk_rgb01(bgr_frames: list[np.ndarray], batch_size: int):
    """Yield ``(rgb01 (batch_size, H, W, 3) f32, n_valid)`` chunks: BGR->RGB,
    /255 on the host, zero-padded ragged tails."""
    for start in range(0, len(bgr_frames), batch_size):
        chunk = bgr_frames[start:start + batch_size]
        arr = np.stack([f[..., ::-1] for f in chunk]).astype(np.float32)
        arr /= 255.0
        n = len(chunk)
        if n < batch_size:
            arr = np.concatenate(
                [arr, np.zeros((batch_size - n,) + arr.shape[1:],
                               np.float32)])
        yield arr, n


def chunk_bgr_u8(bgr_frames: list[np.ndarray], batch_size: int):
    """Yield ``(bgr (batch_size, H, W, 3) uint8, n_valid)`` chunks with
    zero-padded ragged tails, the serving upload format. Frames that are
    not uint8 raise (a cast would wrap them silently)."""
    for f in bgr_frames:
        if f.dtype != np.uint8:
            raise TypeError(f"chunk_bgr_u8 takes uint8 frames, got "
                            f"{f.dtype}")
    for start in range(0, len(bgr_frames), batch_size):
        chunk = bgr_frames[start:start + batch_size]
        arr = np.stack(chunk)
        n = len(chunk)
        if n < batch_size:
            arr = np.concatenate(
                [arr, np.zeros((batch_size - n,) + arr.shape[1:],
                               np.uint8)])
        yield arr, n
