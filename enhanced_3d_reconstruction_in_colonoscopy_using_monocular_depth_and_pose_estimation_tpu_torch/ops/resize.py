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
``_lerp_resize_pallas``. ``resize_align_corners`` takes it on the JAX
package's conditions (bilinear, 4-D, channels a multiple of 128, both
input sides at least 2) wherever ``takes_lerp`` says so: on the card for
every forward that autograd does not record (serving, video, the CLIs,
validation, a teacher, an export trace); under ``E3D_PALLAS_RESIZE=1``
(``_PALLAS_RESIZE``, the JAX package's knob) everywhere, the CPU taking its
plain version; never under ``E3D_PALLAS_RESIZE=0`` (``_NO_PALLAS_RESIZE``,
the opt-out), nor in a recorded forward (K6 has no backward), nor on the
CPU by default (the JAX package's default, the matmul resize). Its plain
version is ``lerp_resize_reference``, which is not the matmul resize: that
one rounds its weights to bf16.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import aligned16, device_cache
from ..utils import cbuild

# The JAX package's E3D_PALLAS_RESIZE knob: "1" puts every decoder upsample
# on K6 (the CPU on its plain version); "0" opts the card out of K6.
_PALLAS_RESIZE = os.environ.get("E3D_PALLAS_RESIZE") == "1"
_NO_PALLAS_RESIZE = os.environ.get("E3D_PALLAS_RESIZE") == "0"
_LERP_LIB = "lerp_resize"
_LERP_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K6's plan: the bytes of source columns a ring slot holds, the stages the
# ring holds (at most 8); the kernel's W and H threads a block (kWThreads +
# kHThreads) and H rows in flight (kHRing); the card's shared memory.
_LERP_SLOT_BYTES = 8192
_LERP_RING = 4
_LERP_THREADS = 384
_LERP_H_RING = 3
_SMEM_PER_SM = 233472     # 228 KB, of which 1 KB is reserved per block
_SMEM_PER_BLOCK = 232448  # 227 KB


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


def takes_lerp(device_type: str, records: bool, shape: tuple[int, ...],
               method: str, channels_last: bool, knob: str | None) -> bool:
    """Whether an align-corners resize of ``shape`` goes to K6. ``knob`` is
    ``E3D_PALLAS_RESIZE``: "1" (K6 wherever the JAX package's conditions
    hold: bilinear, 4-D, channels a multiple of 128, both input sides at
    least 2), "0" (never) or None (unset: K6 on the card, on those
    conditions, when autograd does not record the call, which K6 could
    not differentiate; the CPU keeps the matmul resize)."""
    if knob == "0" or method != "bilinear" or len(shape) != 4:
        return False
    if knob != "1" and (device_type != "cuda" or records):
        return False
    c, hw = ((shape[3], shape[1:3]) if channels_last
             else (shape[1], shape[2:]))
    return c % 128 == 0 and min(hw) >= 2


def _takes_lerp(x: torch.Tensor, method: str, channels_last: bool) -> bool:
    """``takes_lerp`` for ``x`` under the module's knobs."""
    knob = "1" if _PALLAS_RESIZE else "0" if _NO_PALLAS_RESIZE else None
    return takes_lerp(x.device.type,
                      torch.is_grad_enabled() and x.requires_grad,
                      tuple(x.shape), method, channels_last, knob)


def resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int],
                         method: str = "bilinear",
                         channels_last: bool = True) -> torch.Tensor:
    """torch ``F.interpolate(..., align_corners=True)``-style resize; K6
    where ``takes_lerp`` says so (NHWC input goes to it as the NCHW view
    of channels-last memory; the decoder's NCHW tensors already lie in
    that memory), else the matmul resize."""
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


def _pass_taps(n_in: int, n_out: int) -> tuple[np.ndarray, ...]:
    """K6's taps along one axis: ``_lerp_taps``, or copies (lo = index,
    w1 = 0) where the size does not change and the pass is skipped."""
    if n_in == n_out:
        return (np.arange(n_out, dtype=np.int32),
                np.ones(n_out, np.float32), np.zeros(n_out, np.float32))
    return _lerp_taps(n_in, n_out)


class LerpPlan(NamedTuple):
    """K6's tiles, ring and launch (``_lerp_plan``), and its tables."""
    span: int          # output columns a tile spans
    spans: int
    band: int          # output rows a tile holds
    bands: int
    ring: int          # stages (source-row spans) in shared memory
    src_cols: int      # source columns a ring slot holds (the widest span)
    vec: int           # elements an access moves
    threads: int
    grid: int          # persistent blocks
    smem: int          # dynamic shared memory a block, bytes
    tiles: int
    stage_row: np.ndarray    # int32: the source rows some output row reads
    first_stage: np.ndarray  # int32 (h2): index of lo_y in stage_row
    w0_y: np.ndarray
    w1_y: np.ndarray
    lo_x: np.ndarray         # int32 (w2)
    w0_x: np.ndarray
    w1_x: np.ndarray

    def tile(self, t: int) -> tuple[int, slice, slice, slice, slice]:
        """Tile ``t``'s image, output rows and columns, source columns and
        stages (indices into ``stage_row``), as the kernel's ``tile_at``."""
        k, rest = t % self.spans, t // self.spans
        b, img = rest % self.bands, rest // self.bands
        h2, w2 = len(self.first_stage), len(self.lo_x)
        oy0, ox0 = b * self.band, k * self.span
        oy1, ox1 = min(h2, oy0 + self.band), min(w2, ox0 + self.span)
        sx1 = int(self.lo_x[ox1 - 1]) + int(self.w1_x[ox1 - 1] != 0) + 1
        s1 = (int(self.first_stage[oy1 - 1])
              + int(self.w1_y[oy1 - 1] != 0) + 1)
        return (img, slice(oy0, oy1), slice(ox0, ox1),
                slice(int(self.lo_x[ox0]), sx1),
                slice(int(self.first_stage[oy0]), s1))


def _lerp_smem(ring: int, src_cols: int, pixel_bytes: int, span: int
               ) -> int:
    """The kernel's shared memory: 1 KB of alignment slack, the mbarriers
    (256 bytes), ``ring`` stage slots and ``_LERP_H_RING`` H rows of
    ``src_cols`` pixels each (rounded to 128 bytes), the span's 16-byte
    taps."""
    slot = (src_cols * pixel_bytes + 127) // 128 * 128
    return 1024 + 256 + (ring + _LERP_H_RING) * slot + 16 * span


@functools.lru_cache(maxsize=256)
def _lerp_tables(h: int, w: int, h2: int, w2: int
                 ) -> tuple[np.ndarray, ...]:
    """K6's tables: the stages (the source rows some output row reads:
    lo_y, and lo_y + 1 where w1 != 0, so a downscale skips the rest), each
    output row's first stage (the index of its lo_y) and weights, each
    output column's lo_x and weights."""
    lo_y, w0_y, w1_y = _pass_taps(h, h2)
    lo_x, w0_x, w1_x = _pass_taps(w, w2)
    stage_row = np.unique(np.concatenate([lo_y, lo_y[w1_y != 0] + 1])
                          ).astype(np.int32)
    first_stage = np.searchsorted(stage_row, lo_y).astype(np.int32)
    return stage_row, first_stage, w0_y, w1_y, lo_x, w0_x, w1_x


@functools.lru_cache(maxsize=256)
def _lerp_plan(n: int, c: int, h: int, w: int, h2: int, w2: int,
               itemsize: int, sms: int = 132) -> LerpPlan:
    """K6's tile and halo plan for an (n, c, h, w) -> (h2, w2) resize of
    ``itemsize``-byte elements on a card of ``sms`` SMs.

    - Columns: the widest output span whose source columns (its taps and
      the halo column lo_x + 1 where w1 != 0) fit in a ring slot of
      ``_LERP_SLOT_BYTES``; ``src_cols`` is the most any span reads.
    - Rows: a band of output rows reads the stages (``_lerp_tables``) from
      its first row's lo_y to its last row's last.
    - Threads: ``_LERP_THREADS`` (the W and H warps), and a producer warp
      where the stages come by TMA (a pixel of a multiple of 16 bytes: the
      vector path); blocks an SM from shared memory, at most two (the
      kernel's register budget); the grid that many on every SM, at most
      one a tile.
    - The band: the height whose cost (tiles a block walks, times the
      elements a tile moves, halo rows included) is least, the taller on
      a tie.
    """
    tables = _lerp_tables(h, w, h2, w2)
    _, first_stage, _, w1_y, lo_x, _, w1_x = tables
    last_stage = first_stage + (w1_y != 0)
    pixel = c * itemsize
    vec = 16 // itemsize if pixel % 16 == 0 else 1
    threads = _LERP_THREADS + (32 if vec > 1 else 0)

    hi_x = lo_x + (w1_x != 0)  # the last source column each column reads
    cols = max(2, _LERP_SLOT_BYTES // pixel)
    span = w2
    while True:
        starts = np.arange(0, w2, span)
        ends = np.minimum(starts + span, w2) - 1
        src_cols = int((hi_x[ends] - lo_x[starts] + 1).max())
        if src_cols <= cols or span == 1:
            break
        span = max(1, min(span - 1, span * cols // src_cols))
    spans = len(starts)
    smem = _lerp_smem(_LERP_RING, src_cols, pixel, span)
    if smem > _SMEM_PER_BLOCK:
        raise ValueError(f"lerp_resize: {c} channels of {itemsize} bytes "
                         f"need {smem} bytes of shared memory a block, "
                         f"more than the card's {_SMEM_PER_BLOCK}")
    per_sm = max(1, min(2, _SMEM_PER_SM // (smem + 1024)))

    best = None
    for band in sorted({-(-h2 // k) for k in range(1, h2 + 1)}):
        bands = -(-h2 // band)
        tiles = n * spans * bands
        grid = min(tiles, sms * per_sm)
        b0 = np.arange(0, h2, band)
        b1 = np.minimum(b0 + band, h2) - 1
        staged = int((last_stage[b1] - first_stage[b0] + 1).max())
        cost = -(-tiles // grid) * (band * span + staged * src_cols)
        if best is None or cost <= best[0]:
            best = (cost, band, bands, tiles, grid)
    _, band, bands, tiles, grid = best
    return LerpPlan(span, spans, band, bands, _LERP_RING, src_cols, vec,
                    threads, grid, smem, tiles, *tables)


@device_cache(maxsize=256)
def _device_lerp_tables(h: int, w: int, h2: int, w2: int,
                        device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_lerp_tables`` on the device, uploaded once per shape (outside
    inference mode, as ``_device_matrix``)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device)
                     for t in _lerp_tables(h, w, h2, w2))


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
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    """The launch, counted on ``lerp_resize``, on ``_lerp_plan``'s tiles;
    x in another layout (or not 16-byte aligned) is copied into fresh
    channels-last memory first."""
    _check_lerp(x)
    n, c, h, w = x.shape
    x = x.contiguous(memory_format=torch.channels_last)
    if not aligned16(x):
        x = x.clone(memory_format=torch.channels_last)
    y = torch.empty((n, c, h2, w2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    plan = _lerp_plan(n, c, h, w, h2, w2, x.element_size(),
                      _sm_count(x.device.index or 0))
    tables = _device_lerp_tables(h, w, h2, w2, x.device)
    fn = _bind_lerp(cbuild.load(_LERP_LIB))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), n, c, h, w, h2, w2,
                 *(t.data_ptr() for t in tables), plan.span, plan.band,
                 plan.ring, plan.src_cols, plan.threads, plan.grid,
                 plan.smem, _LERP_DTYPES[x.dtype], stream)
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
                           "E3D_PALLAS_RESIZE unset")
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
