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

Kernel K6 (``lerp_resize``, ``csrc/lerp_resize.cu``) is the align-corners
bilinear resize as a 2-tap lerp, the JAX package's
``_lerp_resize_pallas``. ``resize_align_corners`` takes it under the same
``E3D_PALLAS_RESIZE`` knob (read at import into ``_PALLAS_RESIZE``) on the
same conditions: bilinear, 4-D, channels a multiple of 128, both input
sides at least 2. Its plain version is ``lerp_resize_reference``, which is
not the matmul resize: that one rounds its weights to bf16.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..core.device import device_cache
from ..utils import cbuild

# The JAX package's E3D_PALLAS_RESIZE knob: every decoder upsample on K6.
_PALLAS_RESIZE = os.environ.get("E3D_PALLAS_RESIZE", "0") == "1"
_LERP_LIB = "lerp_resize"
_LERP_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@device_cache(maxsize=256)
def _device_matrix(make_matrix, in_size: int, out_size: int, method: str,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A resize matrix on the device, uploaded once per shape (never while
    tracing: ``device_cache``). Made outside inference mode even when
    first asked for inside it (serving): a cached inference tensor could
    not be saved for a later training backward."""
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


def _takes_lerp(x: torch.Tensor, method: str, channels_last: bool) -> bool:
    """The JAX package's conditions for K6: bilinear, 4-D, channels a
    multiple of 128, both input sides at least 2."""
    if not (_PALLAS_RESIZE and method == "bilinear" and x.dim() == 4):
        return False
    c = x.shape[3] if channels_last else x.shape[1]
    return c % 128 == 0 and min(_hw(x, channels_last)) >= 2


def resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int],
                         method: str = "bilinear",
                         channels_last: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(..., align_corners=True)``-style resize; K6
    under ``_PALLAS_RESIZE`` where it applies (NHWC input goes to it as
    the NCHW view of channels-last memory; the decoder's NCHW tensors
    already lie in that memory), else the matmul resize."""
    if _takes_lerp(x, method, channels_last):
        if not channels_last:
            return lerp_resize(x, out_hw)
        y = lerp_resize(x.contiguous().permute(0, 3, 1, 2), out_hw)
        return y.permute(0, 2, 3, 1)
    return _apply_separable(x, _align_corners_matrix, out_hw, method,
                            channels_last)


# ------------------------------------------ K6: bilinear as a 2-tap lerp


@functools.lru_cache(maxsize=256)
def _lerp_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """(lo int32, w0 f32, w1 f32) per output index, from f64 coordinates as
    the JAX package's ``_lerp_taps_static``: w0 = f32(1 - frac), w1 =
    f32(frac); w1 == 0 marks a copy of input ``lo``."""
    if n_out == 1 or n_in == 1:
        lo = np.zeros(n_out, np.int64)
        frac = np.zeros(n_out, np.float64)
    else:
        coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
        lo = np.clip(np.floor(coords).astype(np.int64), 0, n_in - 2)
        frac = coords - lo
    return (lo.astype(np.int32), (1.0 - frac).astype(np.float32),
            frac.astype(np.float32))


@device_cache(maxsize=256)
def _device_taps(n_in: int, n_out: int, device: torch.device
                 ) -> tuple[torch.Tensor, ...]:
    """``_lerp_taps`` on the device, uploaded once per shape (outside
    inference mode, as ``_device_matrix``)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device)
                     for t in _lerp_taps(n_in, n_out))


def _lerp_pass(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """One lerp pass along ``dim``: blend in f32, round to x's dtype."""
    n_in = x.shape[dim]
    lo, w0, w1 = _device_taps(n_in, n_out, x.device)
    lo = lo.long()
    shape = [1] * x.dim()
    shape[dim] = n_out
    w0, w1 = w0.view(shape), w1.view(shape)
    a = x.index_select(dim, lo)
    b = x.index_select(dim, (lo + 1).clamp(max=n_in - 1))
    blend = (a.float() * w0 + b.float() * w1).to(x.dtype)
    return torch.where(w1 == 0, a, blend)


def lerp_resize_reference(x: torch.Tensor, out_hw: tuple[int, int]
                          ) -> torch.Tensor:
    """Plain version of K6 on (..., H, W): the H pass, rounded to x's
    dtype, then the W pass, as the JAX package's two Pallas passes; a pass
    whose size does not change is skipped."""
    h2, w2 = out_hw
    if h2 != x.shape[-2]:
        x = _lerp_pass(x, h2, x.dim() - 2)
    if w2 != x.shape[-1]:
        x = _lerp_pass(x, w2, x.dim() - 1)
    return x


def _bind_lerp(lib: ctypes.CDLL):
    fn = lib.e3d_lerp_resize
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_lerp(x: torch.Tensor) -> None:
    """K6's checks, on metadata alone (the fake implementation makes them
    too)."""
    if x.device.type != "cuda":
        raise ValueError(f"lerp_resize: x on {x.device}; it takes a CUDA "
                         "tensor (or a CPU one for the plain version)")
    if x.dtype not in _LERP_DTYPES:
        raise ValueError(f"lerp_resize: x is {x.dtype}; the kernel takes "
                         "float32 or bfloat16")


@torch.library.custom_op("e3d::lerp_resize", mutates_args=(),
                         device_types="cpu")
def _lerp_op(x: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    """K6 on (N, C, H, W) ``x``, a new (N, C, h2, w2) tensor in
    channels-last memory. This CPU kernel is the plain version."""
    return lerp_resize_reference(x, (h2, w2)).contiguous(
        memory_format=torch.channels_last)


@_lerp_op.register_kernel("cuda")
def _lerp_cuda(x, h2, w2):
    """The launch, counted on ``lerp_resize``; x in another layout is
    copied into channels-last memory first."""
    _check_lerp(x)
    n, c, h, w = x.shape
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.empty((n, c, h2, w2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    rows = (_device_taps(h, h2, x.device) if h2 != h else (None,) * 3)
    cols = (_device_taps(w, w2, x.device) if w2 != w else (None,) * 3)
    ptrs = [None if t is None else t.data_ptr() for t in (*rows, *cols)]
    fn = _bind_lerp(cbuild.load(_LERP_LIB))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), n, c, h, w, h2, w2, *ptrs,
                 _LERP_DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"lerp_resize launch failed: CUDA error {err}")
    lerp_resize.launches += 1
    return y


@_lerp_op.register_fake
def _lerp_fake(x, h2, w2):
    if x.device.type != "cpu":
        _check_lerp(x)
    return torch.empty((x.shape[0], x.shape[1], h2, w2), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def lerp_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Kernel K6: align-corners bilinear resize of (N, C, H, W) ``x`` to
    ``out_hw``.

    CPU tensors take ``lerp_resize_reference``; CUDA tensors (bf16 or
    f32) launch the kernel, adding one to ``lerp_resize.launches``, or
    raise. The kernel reads and writes channels-last memory, the layout
    of the decoder's tensors; ``x`` in another layout is copied into it
    first, and the output is channels-last (on the CPU too). K6 has no
    backward (the JAX package gives it no VJP), so a call autograd would
    record raises."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("lerp_resize (kernel K6) is not differentiable; "
                           "run it under torch.no_grad() or leave "
                           "E3D_PALLAS_RESIZE off")
    if x.dim() != 4:
        raise ValueError(f"lerp_resize: x has shape {tuple(x.shape)}; the "
                         "kernel takes (N, C, H, W)")
    h2, w2 = out_hw
    if (h2, w2) == tuple(x.shape[2:]):
        return x
    return _lerp_op(x, h2, w2)


lerp_resize.launches = 0


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


def _cv2_linear_taps(n_in: int, n_out: int):
    """cv2.INTER_LINEAR's taps along one axis: half-pixel centres, the
    position and its fraction in f64 (the weights rounded to f32 last),
    clamped at both borders."""
    scale = 1.0 / (n_out / n_in)
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    low = i0 < 0
    i0[low], frac[low] = 0, 0
    high = i0 >= n_in - 1
    i0[high], frac[high] = n_in - 1, 0
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (np.float32(1) - frac).astype(np.float32), frac


def resize_linear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes with cv2.INTER_LINEAR
    semantics for float images (half-pixel centres, no antialias, the
    taps' positions computed as cv2 computes them): rows first, then
    columns, in f32."""
    (h_in, w_in), (h_out, w_out) = x.shape[-2:], out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x.clone()
    x = x.to(torch.float32)
    for axis, n_in, n_out in ((-1, w_in, w_out), (-2, h_in, h_out)):
        i0, i1, a0, a1 = (torch.from_numpy(t).to(x.device)
                          for t in _cv2_linear_taps(n_in, n_out))
        shape = (-1, 1) if axis == -2 else (-1,)
        x = (x.index_select(axis, i0) * a0.view(shape)
             + x.index_select(axis, i1) * a1.view(shape))
    return x
