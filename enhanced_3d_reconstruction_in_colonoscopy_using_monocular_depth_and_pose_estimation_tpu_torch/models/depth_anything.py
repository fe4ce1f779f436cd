"""DepthAnythingV2-style metric depth model (encoder + DPT head) and the
inference pipeline.

``infer_image`` and the batched ``_run_batched_u8`` reproduce the
reference's per-frame semantics: lower-bound aspect-preserving resize to
multiples of 14, ImageNet normalization, forward, bilinear back to the
frame size. Batched serving uploads uint8 BGR and does the flip and /255
on the device.

``VideoDepthAnything`` is Video Depth Anything (Chen et al., CVPR 2025):
the same encoder and a DPT head with four temporal modules, run on clips
of frames and giving a relative disparity (ReLU, no ``max_depth``).
``ClipRunner`` runs its windows of one frame resolution; the serving
engine's clip mode (``serving/engine.py``, ``serving/clips.py``) cuts
streams into windows and stitches them as VDA's ``infer_video_depth``.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import warnings
from typing import Any

import numpy as np
import torch
from torch import nn

from ..core import debug
from ..core.device import device_cache, resolve_device
from ..core.dtypes import POLICY_BF16
from ..ops.quant import calibrate_scales, frozen_scales
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
    ``grad_checkpoint`` recomputes each encoder block in the backward
    (training mode only).

    The speed dials are fields fixed at build time: ``token_merge`` (the
    ToMe fraction, 0 = off), ``quant_int8`` (W8A8 encoder projections over
    ``quant_scope``; with ``quant_dpt`` also the decoder's wide convs).
    Both are inference-only; the int8 ops raise under autograd.
    """

    def __init__(self, encoder: str = "vitl", features: int = 256,
                 out_channels: tuple[int, ...] = (256, 512, 1024, 1024),
                 max_depth: float = 20.0,
                 dtype: torch.dtype = POLICY_BF16.compute_dtype,
                 grad_checkpoint: bool = False, token_merge: float = 0.0,
                 quant_int8: bool = False, quant_scope: str = "auto",
                 quant_dpt: bool = True):
        super().__init__()
        self.max_depth = max_depth
        self.quant_int8 = quant_int8  # read by the calibrating callers
        self.pretrained = DinoViT(encoder, dtype, grad_checkpoint,
                                  token_merge=token_merge,
                                  quant_int8=quant_int8,
                                  quant_scope=quant_scope)
        self.depth_head = DPTHead(VIT_ARCHS[encoder]["embed_dim"], features,
                                  out_channels,
                                  quant=quant_int8 and quant_dpt)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = img.shape
        taps = self.pretrained(img)
        depth01 = self.depth_head(taps, h // PATCH_SIZE, w // PATCH_SIZE)
        return depth01 * self.max_depth


class VideoDepthAnything(nn.Module):
    """Video Depth Anything (``video_depth.py``'s ``VideoDepthAnything``):
    ``disparity = relu(head_temporal(vit(x)))`` over clips.

    Input: (B, T, H, W, 3) NHWC, ImageNet-normalized, H/W multiples of
    14. Output: (B, T, H, W) f32 relative disparity (>= 0). The head's
    temporal modules attend over each clip's T frames (at most
    ``clip_frames``, the published 32). ``dtype`` is the compute dtype;
    parameters stay f32. Inference only (the temporal op raises under
    autograd)."""

    clip_frames = 32

    def __init__(self, encoder: str = "vitl", features: int = 256,
                 out_channels: tuple[int, ...] = (256, 512, 1024, 1024),
                 dtype: torch.dtype = POLICY_BF16.compute_dtype):
        super().__init__()
        self.pretrained = DinoViT(encoder, dtype)
        self.depth_head = DPTHead(VIT_ARCHS[encoder]["embed_dim"], features,
                                  out_channels, temporal=True,
                                  output="relu")

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = clips.shape
        if t > self.clip_frames:
            raise ValueError(f"clips of {t} frames; the temporal encoding "
                             f"holds {self.clip_frames}")
        taps = self.pretrained(clips.reshape(b * t, h, w, c))
        disp = self.depth_head(taps, h // PATCH_SIZE, w // PATCH_SIZE,
                               frames=t)
        return disp.view(b, t, h, w)


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
            # A ConvTranspose2d weight is (I, O, kh, kw); flax's kernel of
            # the same layer, (kh, kw, I, O), has fan-in I * kh * kw.
            fan_in = (p.shape[0] * p.shape[2] * p.shape[3] if transposed
                      else p[0].numel())
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        elif leaf in ("weight", "gamma"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


_QUANT_SCOPES = ("auto", "all", "mlp", "attn")


def build_depth_model(encoder: str, max_depth: float = 20.0,
                      dtype: torch.dtype = POLICY_BF16.compute_dtype,
                      device: str | torch.device = "cuda",
                      seed: int = 0,
                      grad_checkpoint: bool = False,
                      token_merge: float = 0.0,
                      quant_int8: bool = False) -> DepthAnythingV2:
    """The ``encoder`` model on ``device`` in eval mode, with seeded random
    weights (load a checkpoint over them with ``models.convert``). A
    trainer puts it in ``.train()``; ``grad_checkpoint`` then recomputes
    each encoder block in the backward. ``token_merge`` and ``quant_int8``
    are the speed dials; the int8 scope comes from ``E3D_QUANT_SCOPE``
    (auto, all, mlp or attn; another value raises) and the decoder's int8
    convs from ``E3D_QUANT_DPT`` (on unless "0"), as in the JAX package."""
    scope = os.environ.get("E3D_QUANT_SCOPE", "auto")
    if scope not in _QUANT_SCOPES:
        raise ValueError(f"E3D_QUANT_SCOPE={scope!r}; expected one of "
                         f"{_QUANT_SCOPES}")
    dev = resolve_device(device)
    cfg = MODEL_CONFIGS[encoder]
    with dev:
        model = DepthAnythingV2(
            cfg["encoder"], cfg["features"], tuple(cfg["out_channels"]),
            max_depth, dtype, grad_checkpoint, token_merge=token_merge,
            quant_int8=quant_int8, quant_scope=scope,
            quant_dpt=os.environ.get("E3D_QUANT_DPT", "1") == "1")
    return init_random(model, seed).eval()


def build_vda_model(encoder: str = "vitl",
                    dtype: torch.dtype = POLICY_BF16.compute_dtype,
                    device: str | torch.device = "cuda", seed: int = 0
                    ) -> VideoDepthAnything:
    """The ``encoder`` VDA model on ``device`` in eval mode, with seeded
    random weights as ``build_depth_model`` draws them (the motion
    modules' ``proj_out`` too, which VDA zero-initialises before
    training). VDA's ``model_configs`` are DAv2's widths; the debug
    ``vitt`` takes out_channels (16, 32, 64, 64), as GroupNorm's 32
    groups need motion-module widths of a multiple of 32."""
    cfg = MODEL_CONFIGS[encoder]
    out_channels = ((16, 32, 64, 64) if encoder == "vitt"
                    else tuple(cfg["out_channels"]))
    with resolve_device(device):
        model = VideoDepthAnything(encoder, cfg["features"], out_channels,
                                   dtype)
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


@device_cache(maxsize=8)
def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.inference_mode(False):
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
    depth = model(_normalized(rgb01, net_hw))
    return resize_align_corners(depth[..., None], tuple(out_hw))[..., 0]


def _normalized(rgb01: torch.Tensor, net_hw: tuple[int, int]
                ) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> the network's (B, *net_hw, 3) input:
    the antialiased bicubic resize and ImageNet normalisation."""
    mean, std = _imagenet(rgb01.device)
    x = resize_antialias(rgb01, net_hw, method="bicubic")
    return (x - mean) / std


def rgb01_of_bgr_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """The BGR->RGB flip and /255 of uint8 frames, on their device (the
    serving upload format; on the card the division is a multiply by the
    reciprocal, so it may differ from the host's f32 division in the last
    bit)."""
    return bgr_u8.flip(-1).float() / 255.0


@torch.inference_mode()
def _run_batched_u8(model: DepthAnythingV2, bgr_u8: torch.Tensor,
                    net_hw: tuple[int, int], out_hw: tuple[int, int],
                    readback_f16: bool = False) -> torch.Tensor:
    """uint8-BGR entry: the BGR->RGB flip and /255 run on the device, so
    the host uploads 4x fewer bytes than the f32 form. ``readback_f16``
    halves the depth readback (f16 keeps ~0.01 absolute at the 20 m
    range cap)."""
    out = _run_batched(model, rgb01_of_bgr_u8(bgr_u8), net_hw, out_hw)
    return out.half() if readback_f16 else out


class BatchedRunner:
    """Batched inference for ONE frame resolution on the model's device.

    Frames go up as uint8 in chunks of ``batch_size`` (ragged tails
    zero-padded, so every batch has one shape) and come back as (H, W)
    float depth maps (f16 with ``readback_f16``).

    ``calib_batches`` K > 0 (a ``quant_int8`` model): static int8
    calibration, once, on the first K batches of ``calib_frames``; the
    per-site abs-maxes are kept in ``self.amax`` and every later call runs
    under those frozen scales. Fewer frames than K batches warn; none
    raise.

    ``data_parallel`` (the JAX package's rule): with more than one visible
    card and a batch they divide, each batch is split over one replica of
    the model per card (copies of its weights, made once), with no
    collective; None turns it on exactly then. True with one visible card
    (or a batch the cards do not divide) raises, naming them. Static
    calibration runs on one card: with ``data_parallel`` None it warns and
    stays on one, with True it raises.

    Each chunk's call is recorded in ``core.debug``'s recorder as three
    spans that partition it: ``runner.upload`` (stacking and padding the
    chunk on the host, and the copy to the device), ``runner.launch``
    (issuing the forward: resize, normalisation, model, resize back) and
    ``runner.readback`` (waiting for the card, the copy back, NumPy); and
    by the counters ``runner.rows`` (rows run, padding included) and
    ``runner.padded_rows`` (the zero rows padded in)."""

    def __init__(self, model: DepthAnythingV2,
                 resolution_hw: tuple[int, int], input_size: int = 518,
                 batch_size: int = 8, readback_f16: bool = False,
                 calib_frames: list[np.ndarray] | None = None,
                 calib_batches: int = 0,
                 data_parallel: bool | None = None):
        h, w = resolution_hw
        self.model = model
        self.resolution_hw = (h, w)
        self.batch_size = batch_size
        self.readback_f16 = readback_f16
        self.net_hw = _lower_bound_hw(h, w, input_size)
        self.device = _model_device(model)
        self.amax = None
        n_dev = visible_cards(self.device)
        if data_parallel and (n_dev < 2 or batch_size % n_dev):
            raise ValueError(
                f"data_parallel=True needs more than one visible card "
                f"dividing the batch; {n_dev} visible, batch {batch_size}")
        use_dp = (n_dev > 1 and batch_size % n_dev == 0
                  if data_parallel is None else bool(data_parallel))
        if calib_batches > 0 and use_dp and data_parallel is None:
            warnings.warn("static int8 calibration does not compose with "
                          "multi-device inference; falling back to "
                          "single-chip for this run", stacklevel=2)
            use_dp = False
        if calib_batches > 0 and use_dp:
            raise ValueError("static int8 calibration does not compose "
                             "with multi-device inference yet — pass "
                             "data_parallel=False or drop calib_batches")
        self.replicas = [model]
        if use_dp:
            self.replicas += [copy.deepcopy(model).to(
                torch.device("cuda", i)) for i in range(1, n_dev)]
        if calib_batches > 0:
            if not getattr(model, "quant_int8", False):
                raise ValueError("calib_batches requires quant_int8=True")
            calib_frames = calib_frames or []
            want = calib_batches * batch_size
            if not calib_frames:
                raise ValueError("calib_batches > 0 requires calib_frames")
            if len(calib_frames) < want:
                warnings.warn(
                    f"int8 calibration requested {calib_batches} batches "
                    f"({want} frames) but only {len(calib_frames)} frames "
                    "were available — scales frozen from a smaller set",
                    stacklevel=2)
            self.amax = calibrate_scales(
                self._forward,
                [arr for arr, _ in chunk_bgr_u8(calib_frames[:want],
                                                batch_size)])

    def _upload(self, arr: np.ndarray) -> list[torch.Tensor]:
        """The chunk on the device: one slice per replica's card."""
        return [torch.from_numpy(part).to(_model_device(m))
                for m, part in zip(self.replicas,
                                   np.split(arr, len(self.replicas)))]

    def _launch(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """Each replica's forward on its slice, launched in turn (each
        card runs its own), gathered on the first card."""
        outs = [_run_batched_u8(m, x, self.net_hw, self.resolution_hw,
                                self.readback_f16)
                for m, x in zip(self.replicas, xs)]
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])

    def _forward(self, arr: np.ndarray) -> torch.Tensor:
        return self._launch(self._upload(arr))

    def __call__(self, bgr_frames: list[np.ndarray]) -> list[np.ndarray]:
        for f in bgr_frames:
            if f.shape[:2] != self.resolution_hw:
                raise ValueError("BatchedRunner is built for "
                                 f"{self.resolution_hw}; got {f.shape[:2]}")
        outputs: list[np.ndarray] = []
        size = self.batch_size
        chunks = chunk_bgr_u8(bgr_frames, size)
        for _ in range(-(-len(bgr_frames) // size)):
            with debug.span("runner.upload"):
                arr, n = next(chunks)   # stacked and padded here
                xs = self._upload(arr)
            with debug.span("runner.launch"), (
                    contextlib.nullcontext() if self.amax is None
                    else frozen_scales(self.amax)):
                depth = self._launch(xs)
            with debug.span("runner.readback"):
                outputs.extend(depth[:n].cpu().numpy())
            debug.count("runner.rows", size)
            debug.count("runner.padded_rows", size - n)
        return outputs


class ClipRunner:
    """Windows of ONE frame resolution through a ``VideoDepthAnything``
    on its device, one clip (B = 1) a call.

    ``__call__(frames, carried, pad)``: the window's new uint8 BGR frames
    go up as one stack (``runner.upload``), are resized and normalised on
    the device, follow ``carried`` (the network inputs a window keeps
    from the one before, already on the device) and precede ``pad``
    copies of the stream's last input; the clip runs, and each map goes
    back to frame size, align-corners bilinear (``runner.launch``).
    Returns the window's network inputs (T, h, w, 3) and its maps
    (T, H, W) f32, both on the device; ``readback`` brings maps to host
    memory (``runner.readback``). Counters ``runner.rows`` (positions
    run) and ``runner.padded_rows`` (padding among them)."""

    def __init__(self, model: VideoDepthAnything,
                 resolution_hw: tuple[int, int], input_size: int = 518):
        self.model = model
        self.resolution_hw = tuple(resolution_hw)
        self.net_hw = _lower_bound_hw(*self.resolution_hw, input_size)
        self.device = _model_device(model)

    @torch.inference_mode()
    def __call__(self, bgr_frames: list[np.ndarray],
                 carried: torch.Tensor | None, pad: int,
                 last_input: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        for f in bgr_frames:
            if f.shape[:2] != self.resolution_hw:
                raise ValueError("ClipRunner is built for "
                                 f"{self.resolution_hw}; got {f.shape[:2]}")
        with debug.span("runner.upload"):
            up = (torch.from_numpy(np.stack(bgr_frames)).to(self.device)
                  if bgr_frames else None)
        with debug.span("runner.launch"):
            parts = [] if carried is None else [carried]
            if up is not None:
                parts.append(_normalized(rgb01_of_bgr_u8(up), self.net_hw))
                last_input = parts[-1][-1:]
            if pad:
                if last_input is None:
                    raise ValueError("ClipRunner: padding with no frame")
                parts.append(last_input.expand(pad, *last_input.shape[1:]))
            inputs = torch.cat(parts) if len(parts) > 1 else parts[0]
            disp = self.model(inputs[None])[0]
            maps = resize_align_corners(disp[..., None],
                                        self.resolution_hw)[..., 0]
        debug.count("runner.rows", inputs.shape[0])
        debug.count("runner.padded_rows", pad)
        return inputs, maps

    @staticmethod
    def readback(maps: torch.Tensor) -> list[np.ndarray]:
        with debug.span("runner.readback"):
            return list(maps.cpu().numpy())


def visible_cards(device: torch.device) -> int:
    """The cards a model on ``device`` can spread a batch over (1 off
    CUDA)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


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
