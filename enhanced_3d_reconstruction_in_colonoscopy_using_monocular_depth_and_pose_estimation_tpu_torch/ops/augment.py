"""Training augmentations on the device (torchvision semantics).

After the bicubic resize to the model size: RandomHorizontalFlip,
ColorJitter(brightness .2, contrast .2, saturation .1, hue .2) with its
four ops in a random order per image, RandomAffine(degrees 0, translate
(.1, .1), scale (.1, .9), NEAREST, fill 0), then ImageNet normalisation.
The depth target gets none of them: the geometric augmentations touch the
image only, a property of the reference kept as it is.

The random draws are made in one place, ``draw_augment_params``, from a
``torch.Generator`` on the CPU (so no draw waits for the card), and the
ops take them as explicit values. A test can therefore feed the factors
that another framework's random stream drew.

``apply_augment`` takes one of two paths, by the images' device alone:
images on a CUDA device go through the batched kernels of
``csrc/augment.cu`` (``augment_kernel``: one table of the draws copied to
the card, two launches a call, whatever the batch; it takes float32 and
refuses any other dtype); images on the CPU through the plain version,
``apply_augment_reference``, which runs the ops image by image and is
what the CPU tests hold against the JAX package and the card tests hold
the kernels against. Each call counts its rows on ``core.debug``'s
counter ``augment.kernel_rows`` or ``augment.plain_rows``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import debug
from ..utils import cbuild

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# Order of the colour ops, as numbered in ``AugmentParams.order``.
COLOR_OPS = ("brightness", "contrast", "saturation", "hue")


class AugmentConfig(NamedTuple):
    hflip_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.1
    hue: float = 0.2
    translate: tuple[float, float] = (0.1, 0.1)
    scale_range: tuple[float, float] = (0.1, 0.9)


class AugmentParams(NamedTuple):
    """Per-image draws, (B, ...) CPU tensors."""
    flip: torch.Tensor      # (B,) bool
    factors: torch.Tensor   # (B, 4) f32: brightness, contrast, saturation, hue
    order: torch.Tensor     # (B, 4) int64: a permutation of COLOR_OPS
    translate: torch.Tensor  # (B, 2) f32: (tx, ty) in pixels, rounded
    scale: torch.Tensor     # (B,) f32


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def draw_augment_params(gen: torch.Generator, batch: int,
                        image_hw: tuple[int, int],
                        cfg: AugmentConfig = AugmentConfig()
                        ) -> AugmentParams:
    """Every random value of one batch's augmentation, drawn from ``gen``
    (a CPU generator)."""
    h, w = image_hw
    flip = torch.rand(batch, generator=gen) < cfg.hflip_prob
    factors = torch.stack([
        _uniform(gen, batch, 1 - cfg.brightness, 1 + cfg.brightness),
        _uniform(gen, batch, 1 - cfg.contrast, 1 + cfg.contrast),
        _uniform(gen, batch, 1 - cfg.saturation, 1 + cfg.saturation),
        _uniform(gen, batch, -cfg.hue, cfg.hue)], dim=1)
    order = torch.stack([torch.randperm(4, generator=gen)
                         for _ in range(batch)])
    max_dx, max_dy = cfg.translate[0] * w, cfg.translate[1] * h
    translate = torch.round(torch.stack([
        _uniform(gen, batch, -max_dx, max_dx),
        _uniform(gen, batch, -max_dy, max_dy)], dim=1))
    scale = _uniform(gen, batch, cfg.scale_range[0], cfg.scale_range[1])
    return AugmentParams(flip, factors, order, translate, scale)


# --------------------------- colour ops (HWC, [0,1]) ------------------------


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    # torchvision rgb_to_grayscale weights
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return torch.sum(img * w, dim=-1, keepdim=True)


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    mean = torch.mean(_rgb_to_gray(img))
    return torch.clamp(img * factor + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    gray = _rgb_to_gray(img)
    return torch.clamp(img * factor + (1.0 - factor) * gray, 0.0, 1.0)


def _rgb_to_hsv(img: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, h, zero)
    h = torch.remainder(h / 6.0, 1.0)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices: torch.Tensor) -> torch.Tensor:
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def adjust_hue(img: torch.Tensor, shift) -> torch.Tensor:
    h, s, v = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    return _hsv_to_rgb(torch.remainder(h + shift, 1.0), s, v)


_COLOR_FNS = (adjust_brightness, adjust_contrast, adjust_saturation,
              adjust_hue)


def color_jitter(img: torch.Tensor, factors, order) -> torch.Tensor:
    """ColorJitter on one HWC image: ``factors`` (brightness, contrast,
    saturation, hue shift), applied in ``order`` (indices of COLOR_OPS)."""
    for op in order:
        img = _COLOR_FNS[int(op)](img, factors[int(op)])
    return img


# ------------------------------ geometric ops -------------------------------


def random_affine(img: torch.Tensor, translate, scale) -> torch.Tensor:
    """RandomAffine(degrees=0) on one HWC image with the drawn (tx, ty)
    and scale: NEAREST sampling of the inverse map about the centre, fill
    0 outside."""
    h, w = img.shape[0], img.shape[1]
    f32 = np.float32

    # The map is separable: one source index per output row and column,
    # computed on the host in f32 (true division, round half to even) as
    # the JAX package computes it.
    def axis(n: int, shift: float) -> tuple[torch.Tensor, np.ndarray]:
        c = f32((n - 1) * 0.5)
        src = np.round((np.arange(n, dtype=f32) - c - f32(shift))
                       / f32(scale) + c).astype(np.int64)
        valid = (src >= 0) & (src < n)
        return (torch.from_numpy(np.clip(src, 0, n - 1)).to(img.device),
                valid)

    iy, valid_y = axis(h, translate[1])
    ix, valid_x = axis(w, translate[0])
    valid = torch.from_numpy(valid_y[:, None] & valid_x[None, :]).to(
        img.device)
    out = img.index_select(0, iy).index_select(1, ix)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


# ------------------------------ batch pipeline ------------------------------


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def apply_augment_reference(images: torch.Tensor, params: AugmentParams
                            ) -> torch.Tensor:
    """Plain version of ``apply_augment``: the ops image by image."""
    flips = params.flip.tolist()
    factors = params.factors.tolist()
    orders = params.order.tolist()
    out = []
    for i, img in enumerate(images):
        if flips[i]:
            img = img.flip(1)
        img = color_jitter(img, factors[i], orders[i])
        img = random_affine(img, params.translate[i].tolist(),
                            params.scale[i].item())
        out.append(img)
    return normalize_imagenet(torch.stack(out))


# ------------------------------ batched kernels -----------------------------

_LIB = "augment"
# The kernels' table: int32 words of one image's draws (order, then the
# factors as float bits; ``csrc/augment.cu``'s kHeader), and the pixels
# of kernel A's chunks (kMeanTiles x kTile), one contrast partial each.
_TABLE_HEADER = 16
_MEAN_CHUNK = 8 * 1024


def _affine_axes(n: int, shift: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``random_affine``'s source index along an axis of ``n`` pixels, for
    every image at once: (len(shift), n) int32, -1 where the affine fills.
    The same f32 arithmetic, true division and round half to even, so the
    same indices."""
    f32 = np.float32
    c = f32((n - 1) * 0.5)
    src = np.round((np.arange(n, dtype=f32) - c - shift[:, None])
                   / scale[:, None] + c).astype(np.int64)
    return np.where((src >= 0) & (src < n), src, -1).astype(np.int32)


def augment_tables(params: AugmentParams, b: int, h: int, w: int
                   ) -> np.ndarray:
    """The kernels' table of one call of ``b`` images (layout in
    ``csrc/augment.cu``): per image the order and the factors as the plain
    version rounds them to f32 (brightness, contrast, 1 - contrast,
    saturation, 1 - saturation, hue, each from the float64 value, as
    PyTorch rounds a Python scalar); each output row's source row; each
    output column's source column, the flip folded in (column W - 1 - c of
    the unflipped image); -1 where the affine fills."""
    if any(p.shape[0] != b for p in params):
        raise ValueError(f"apply_augment: {b} images, but draws of shapes "
                         f"{[tuple(p.shape) for p in params]}")
    order = params.order.cpu().numpy()
    if not (np.sort(order, axis=1) == np.arange(4)).all():
        raise ValueError("apply_augment: each row of params.order must be "
                         "a permutation of 0..3")
    f = params.factors.cpu().numpy().astype(np.float64)
    head = np.zeros((b, _TABLE_HEADER), np.int32)
    head[:, :4] = order
    head[:, 4:10] = np.stack(
        [f[:, 0], f[:, 1], 1.0 - f[:, 1], f[:, 2], 1.0 - f[:, 2], f[:, 3]],
        axis=1).astype(np.float32).view(np.int32)
    shift = params.translate.cpu().numpy().astype(np.float32)
    scale = params.scale.cpu().numpy().astype(np.float32)
    rows = _affine_axes(h, shift[:, 1], scale)
    cols = _affine_axes(w, shift[:, 0], scale)
    flip = params.flip.cpu().numpy().astype(bool)[:, None]
    cols = np.where(flip & (cols >= 0), w - 1 - cols, cols)
    return np.concatenate([head.ravel(), rows.ravel(), cols.ravel()])


def takes_kernel(images: torch.Tensor) -> bool:
    """Whether ``apply_augment`` runs ``images`` through the batched
    kernels: whether they are on a CUDA device."""
    return images.device.type == "cuda"


def _bind(lib: ctypes.CDLL):
    fn = lib.e3d_augment
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def augment_kernel(images: torch.Tensor, params: AugmentParams
                   ) -> torch.Tensor:
    """``apply_augment`` by the kernels of ``csrc/augment.cu`` on (B, H, W,
    3) float32 CUDA ``images``: the draws' table copied to the card in one
    piece, then two launches (the contrast means' partial sums, then the
    gather, jitter and normalisation), both counted on
    ``augment_kernel.launches``. Returns (B, H, W, 3) float32,
    contiguous. Raises ValueError on images of another dtype, shape or
    device."""
    if not takes_kernel(images) or images.dtype != torch.float32 \
            or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(f"augment_kernel: images are {images.dtype} of "
                         f"shape {tuple(images.shape)} on {images.device}; "
                         "the kernels take (B, H, W, 3) float32 on a CUDA "
                         "device")
    b, h, w, _ = images.shape
    images = images.contiguous()
    table = torch.from_numpy(augment_tables(params, b, h, w)).to(
        images.device)
    chunks = -(-h * w // _MEAN_CHUNK)
    partial = torch.empty((b, chunks), dtype=torch.float32,
                          device=images.device)
    out = torch.empty_like(images)
    fn = _bind(cbuild.load(_LIB))
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = fn(images.data_ptr(), out.data_ptr(), table.data_ptr(),
                 partial.data_ptr(), b, h, w, chunks, stream)
    if err:
        raise RuntimeError(f"augment launch failed: CUDA error {err}")
    augment_kernel.launches += 2
    return out


augment_kernel.launches = 0


def apply_augment(images: torch.Tensor, params: AugmentParams
                  ) -> torch.Tensor:
    """images: (B, H, W, 3) in [0, 1]. Flip, colour jitter and affine per
    image with the given draws, then ImageNet normalisation: by the
    batched kernels on a CUDA device (float32 only), by the plain version
    on the CPU."""
    if takes_kernel(images):
        out = augment_kernel(images, params)
        debug.count("augment.kernel_rows", images.shape[0])
        return out
    debug.count("augment.plain_rows", images.shape[0])
    return apply_augment_reference(images, params)


def augment_batch(images: torch.Tensor, gen: torch.Generator,
                  cfg: AugmentConfig = AugmentConfig(),
                  rows: tuple[int, int] | None = None) -> torch.Tensor:
    """images: (B, H, W, 3) in [0, 1] (already resized). Returns the
    normalised, augmented batch; the draws come from ``gen``. ``rows``
    (offset, total): the images are rows ``offset ..`` of a global batch
    of ``total`` (one rank's share); the draws are made for all of them,
    so each row gets the one-process run's."""
    offset, total = rows or (0, images.shape[0])
    params = draw_augment_params(gen, total,
                                 (images.shape[1], images.shape[2]), cfg)
    if total != images.shape[0]:
        params = AugmentParams(*(p[offset:offset + images.shape[0]]
                                 for p in params))
    return apply_augment(images, params)


def preprocess_eval(images: torch.Tensor) -> torch.Tensor:
    """Eval-path preprocessing: normalise only (resize happens upstream)."""
    return normalize_imagenet(images)
