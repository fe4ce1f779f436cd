"""Image resizing as separable matrix multiplies.

A resize along one axis is a dense ``(out, in)`` weight matrix applied as a
matmul; the matrices are computed once per shape in numpy (the JAX
package's constructions, copied) and cached on the device.

- ``resize_antialias``: PIL/torchvision ``Resize(..., antialias=True)``
  semantics (half-pixel grid, kernel support scaled by the downscale
  factor; cubic A = -0.5). The data path, run in full f32.
- ``resize_align_corners``: ``F.interpolate(..., align_corners=True)``
  semantics, used inside the DPT decoder (bf16) and for the depth map
  back to frame size (f32).
- ``resize_nearest``: cv2 ``INTER_NEAREST`` semantics.

Precision follows the JAX package: bf16 input takes bf16 operands with f32
accumulation, W pass first, rounding to bf16 between passes; any other
input is resized in f32 (H pass, then W pass) and cast back. Float32
matmuls stay full f32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` is False, its default; this
module sets nothing global.

The public functions take channels-last images (NHWC, HWC or HW) like the
JAX package; ``channels_last=False`` takes (..., H, W) tensors instead, the
decoder's NCHW layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (PIL uses a=-0.5)."""
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    w = np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )
    return w


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.maximum(1.0 - x, 0.0)


_KERNELS = {
    "bicubic": (_cubic_kernel, 2.0),
    "bilinear": (_linear_kernel, 1.0),
}


@functools.lru_cache(maxsize=128)
def _antialias_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out, in) resampling matrix with PIL-style antialias support scaling."""
    kernel_fn, support = _KERNELS[method]
    scale = in_size / out_size
    # Antialias: widen the kernel when downscaling.
    filter_scale = max(scale, 1.0)
    support = support * filter_scale

    out_coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    left = np.floor(out_coords - support).astype(np.int64)
    max_taps = int(np.ceil(2.0 * support)) + 2
    taps = left[:, None] + np.arange(max_taps)[None, :]
    dist = (out_coords[:, None] - taps) / filter_scale
    weights = kernel_fn(dist)
    # PIL drops out-of-bounds taps and renormalizes over the valid window.
    valid = (taps >= 0) & (taps < in_size)
    weights = weights * valid
    taps = np.clip(taps, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), max_taps), taps.ravel()),
              weights.ravel())
    norm = mat.sum(axis=1, keepdims=True)
    mat = mat / np.where(norm == 0, 1.0, norm)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _align_corners_matrix(in_size: int, out_size: int, method: str
                          ) -> np.ndarray:
    """(out, in) matrix for align_corners=True interpolation (no antialias)."""
    kernel_fn, support = _KERNELS[method]
    if out_size == 1:
        out_coords = np.zeros(1, dtype=np.float64)
    elif in_size == 1:
        out_coords = np.zeros(out_size, dtype=np.float64)
    else:
        out_coords = (np.arange(out_size, dtype=np.float64) * (in_size - 1)
                      / (out_size - 1))
    left = np.floor(out_coords - support).astype(np.int64)
    max_taps = int(np.ceil(2.0 * support)) + 2
    taps = left[:, None] + np.arange(max_taps)[None, :]
    dist = out_coords[:, None] - taps
    weights = kernel_fn(dist)
    taps = np.clip(taps, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), max_taps), taps.ravel()),
              weights.ravel())
    norm = mat.sum(axis=1, keepdims=True)
    mat = mat / np.where(norm == 0, 1.0, norm)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _device_matrix(make_matrix, in_size: int, out_size: int, method: str,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A resize matrix on the device, uploaded once per shape. Made outside
    inference mode even when first asked for inside it (serving): a cached
    inference tensor could not be saved for a later training backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(make_matrix(in_size, out_size, method)).to(
            device=device, dtype=dtype)


def _to_hw_last(x: torch.Tensor, channels_last: bool) -> torch.Tensor:
    if not channels_last:
        return x
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2)
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    if x.dim() == 2:
        return x
    raise ValueError(f"expected 2D/3D/4D input, got {tuple(x.shape)}")


def _from_hw_last(y: torch.Tensor, channels_last: bool) -> torch.Tensor:
    if not channels_last:
        return y
    if y.dim() == 4:
        return y.permute(0, 2, 3, 1)
    if y.dim() == 3:
        return y.permute(1, 2, 0)
    return y


def _hw(x: torch.Tensor, channels_last: bool) -> tuple[int, int]:
    if channels_last and x.dim() >= 3:
        return x.shape[-3], x.shape[-2]
    return x.shape[-2], x.shape[-1]


def _apply_separable(x: torch.Tensor, make_matrix, out_hw: tuple[int, int],
                     method: str, channels_last: bool) -> torch.Tensor:
    """Apply the per-axis matrices of ``make_matrix`` to the image axes."""
    h_in, w_in = _hw(x, channels_last)
    h_out, w_out = out_hw
    t = _to_hw_last(x, channels_last)  # (..., H, W)
    dtype = x.dtype
    if dtype == torch.bfloat16:
        # Model path: bf16 x bf16 with f32 accumulation, W pass first.
        a_h = _device_matrix(make_matrix, h_in, h_out, method, dtype, x.device)
        a_w = _device_matrix(make_matrix, w_in, w_out, method, dtype, x.device)
        y = torch.matmul(a_h, torch.matmul(t, a_w.T))
    else:
        # Data path: resampling weights must not be truncated, so f32.
        a_h = _device_matrix(make_matrix, h_in, h_out, method, torch.float32,
                             x.device)
        a_w = _device_matrix(make_matrix, w_in, w_out, method, torch.float32,
                             x.device)
        y = torch.matmul(torch.matmul(a_h, t.float()), a_w.T).to(dtype)
    return _from_hw_last(y, channels_last)


def resize_antialias(x: torch.Tensor, out_hw: tuple[int, int],
                     method: str = "bicubic",
                     channels_last: bool = True) -> torch.Tensor:
    """PIL/torchvision-style antialiased resize."""
    return _apply_separable(x, _antialias_matrix, out_hw, method,
                            channels_last)


def resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int],
                         method: str = "bilinear",
                         channels_last: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(..., align_corners=True)``-style resize."""
    return _apply_separable(x, _align_corners_matrix, out_hw, method,
                            channels_last)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int],
                   channels_last: bool = True) -> torch.Tensor:
    """Nearest-neighbor resize (cv2.INTER_NEAREST semantics)."""
    h_in, w_in = _hw(x, channels_last)
    h_out, w_out = out_hw
    rows = torch.clamp((torch.arange(h_out, device=x.device) * h_in)
                       // h_out, 0, h_in - 1)
    cols = torch.clamp((torch.arange(w_out, device=x.device) * w_in)
                       // w_out, 0, w_in - 1)
    if channels_last and x.dim() >= 3:
        return x.index_select(-3, rows).index_select(-2, cols)
    return x.index_select(-2, rows).index_select(-1, cols)
