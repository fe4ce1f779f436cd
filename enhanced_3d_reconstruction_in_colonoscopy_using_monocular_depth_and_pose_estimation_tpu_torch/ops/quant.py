"""Int8 W8A8 inference: the JAX package's ``ops/quant.py`` on one card.

Symmetric int8 in [-127, 127]: activations get one scale per token row
(per image for convolutions), weights one per output channel; the int8 x
int8 product accumulates in int32 (``torch._int_mm``, cuBLASLt's int8 GEMM
on the card) and is rescaled in f32. Weights are quantized on every
forward, as in the JAX package, so checkpoints stay f32. An inference-only
speed dial: rounding has no gradient, so the quantized ops raise when
autograd would record them.

Two kernels in ``csrc/quant.cu`` do the passes XLA fused around each int8
dot (eager PyTorch would run each as a chain of f32 passes):

- Q1, ``quantize_int8``: the abs-max and quantization of rows (plain
  version ``quantize_int8_reference``);
- Q2, ``dequantize_int32``: the rescale of an int32 accumulator, the bias
  and the cast (plain version ``dequantize_int32_reference``).

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise. Both equal their plain versions bit for bit. Each launch is a
``torch.library`` op (``e3d::quantize_int8``, ``e3d::dequantize_int32``)
whose CPU kernel is the plain version and whose fake implementation makes
the launch's checks, so ``torch.export`` records it and a replay counts
its launches.

Static calibration: ``calibration(tape)`` records each activation site's
abs-max while a forward runs dynamically; ``calibrate_scales`` maxes the
tape over batches; ``frozen_scales(amax)`` (or ``with_frozen_scales``)
then gives each site its frozen per-tensor scale. Sites are identified by
the order of the calls, and a forward that quantizes more or fewer sites
than were calibrated raises. The mode is thread-local and read when each
site runs (eager PyTorch has no trace time).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch
import torch.nn.functional as F

from ..core.device import aligned16
from ..utils import cbuild

_EPS = 1e-8
_LIB = "quant"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHORT_MAX = 4096  # csrc/quant.cu kShortMax: longer rows need scratch

_MODE = threading.local()


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, correctly rounded. The divisor is a tensor
    on amax's device: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which differs in the last bit."""
    amax = torch.clamp_min(amax.float(), _EPS)
    return amax / torch.full_like(amax, 127.0)


@contextlib.contextmanager
def calibration(tape: list):
    """Record one f32 abs-max (a 0-d tensor) per activation quant site
    into ``tape`` while the block runs."""
    _MODE.kind, _MODE.tape = "calib", tape
    try:
        yield
    finally:
        _MODE.kind = None


@contextlib.contextmanager
def frozen_scales(amax: torch.Tensor):
    """Give each activation quant site, in call order, the per-tensor scale
    of its calibrated abs-max ``amax[i]`` (an f32 tensor on the model's
    device). Raises if the block quantizes another number of sites."""
    scales = _scale_of(amax)
    _MODE.kind, _MODE.scales, _MODE.idx = "static", scales, 0
    try:
        yield
        if _MODE.idx != scales.shape[0]:
            raise ValueError(
                f"frozen_scales: forward consumed {_MODE.idx} activation "
                f"quant sites but calibration recorded {scales.shape[0]} — "
                "calibrate with the same model config and batch regime")
    finally:
        _MODE.kind = None


def calibrate_scales(apply_fn, batches, *args) -> torch.Tensor:
    """Per-site activation abs-max of the quantized forward
    ``apply_fn(batch, *args)``, maxed over ``batches``: a (sites,) f32
    tensor on the device the forward ran on."""
    amax = None
    for batch in batches:
        tape: list = []
        with calibration(tape):
            apply_fn(batch, *args)
        if not tape:
            raise ValueError("calibrate_scales: forward hit no int8 "
                             "activation quant sites — is quant enabled?")
        t = torch.stack(tape)
        if amax is not None and t.shape != amax.shape:
            raise ValueError(f"calibrate_scales: {t.shape[0]} activation "
                             f"quant sites in one batch, {amax.shape[0]} in "
                             "another — calibrate in one batch regime")
        amax = t if amax is None else torch.maximum(amax, t)
    if amax is None:
        raise ValueError("calibrate_scales: no calibration batches")
    return amax


def with_frozen_scales(apply_fn, amax: torch.Tensor):
    """``apply_fn`` run under ``frozen_scales(amax)``."""
    def fn(*args, **kwargs):
        with frozen_scales(amax):
            return apply_fn(*args, **kwargs)

    return fn


# ---------------------------------------------------------------- Q1


def quantize_int8_reference(x: torch.Tensor, scale: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of Q1 on (R, K) rows: (q (R, K) int8, scale). Per-row
    scales ``max(amax, 1e-8) / 127`` (R,) f32, or the given (1,) f32
    ``scale`` for every row; q = clip(round(x / scale), -127, 127) in f32,
    rounding half to even."""
    xf = x.float()
    if scale is None:
        scale = _scale_of(xf.abs().amax(dim=1))
        s = scale[:, None]
    else:
        s = scale.view(1, 1)
    return torch.round(xf / s).clamp_(-127, 127).to(torch.int8), scale


def _lib() -> ctypes.CDLL:
    """``csrc/quant.cu``, built at first use, with its entries bound."""
    lib = cbuild.load(_LIB)
    if lib.e3d_quantize_rows.argtypes is None:
        lib.e3d_quantize_rows.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int]
            + [ctypes.c_void_p] * 5)
        lib.e3d_quantize_rows.restype = ctypes.c_int
        lib.e3d_dequant.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 6
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 2)
        lib.e3d_dequant.restype = ctypes.c_int
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_quantize(x: torch.Tensor, scale: torch.Tensor | None) -> None:
    """Q1's checks, on metadata alone (the fake implementation makes them
    too)."""
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"quantize_int8: x is {x.dtype} on {x.device}; the "
                         "kernel takes a float32 or bfloat16 CUDA tensor")
    k = x.shape[1]
    vec = 16 // x.element_size()
    if x.stride(1) != 1 or k % vec or x.stride(0) % vec or not aligned16(x):
        raise ValueError(f"quantize_int8: rows (shape {tuple(x.shape)}, "
                         f"strides {x.stride()}) must have unit column "
                         "stride, 16-byte aligned starts and a length of "
                         "whole 16-byte vectors")
    if scale is not None and (scale.numel() != 1 or scale.device != x.device
                              or scale.dtype != torch.float32):
        raise ValueError("quantize_int8: a given scale is one float32 on "
                         "x's device")


@torch.library.custom_op("e3d::quantize_int8", mutates_args=(),
                         device_types="cpu")
def _quantize_op(x: torch.Tensor, scale: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Q1 on (R, K) rows: (q int8, per-row scales (R,) f32), the scales
    empty when ``scale`` is given (an op returns no input). This CPU
    kernel is the plain version."""
    q, row_scale = quantize_int8_reference(x, scale)
    if scale is not None:
        row_scale = x.new_empty((0,), dtype=torch.float32)
    return q, row_scale


@_quantize_op.register_kernel("cuda")
def _quantize_cuda(x, scale):
    """The launch, counted on ``quantize_int8``."""
    _check_quantize(x, scale)
    r, k = x.shape
    q = torch.empty((r, k), dtype=torch.int8, device=x.device)
    out_scale = torch.empty((r if scale is None else 0,),
                            dtype=torch.float32, device=x.device)
    work = (torch.empty((r,), dtype=torch.int32, device=x.device)
            if scale is None and k > _SHORT_MAX else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.e3d_quantize_rows(
            x.data_ptr(), x.stride(0), r, k, _DTYPES[x.dtype],
            None if scale is None else scale.data_ptr(), q.data_ptr(),
            None if scale is not None else out_scale.data_ptr(),
            None if work is None else work.data_ptr(), _stream(x))
    if err:
        raise RuntimeError(f"quantize_int8 launch failed: CUDA error {err}")
    quantize_int8.launches += 1
    return q, out_scale


@_quantize_op.register_fake
def _quantize_fake(x, scale):
    if x.device.type != "cpu":
        _check_quantize(x, scale)
    r = x.shape[0]
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((r if scale is None else 0,), dtype=torch.float32))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel Q1: symmetric int8 of the rows of ``x`` (R, K), bf16 or f32
    with unit column stride (rows may be strided). Returns (q (R, K) int8,
    scale): per-row scales (R,) f32, or the given (1,) f32 ``scale`` for
    every row (frozen calibration).

    CPU tensors take ``quantize_int8_reference``; CUDA tensors launch the
    kernel, adding one to ``quantize_int8.launches``, or raise. Every
    quantized op starts here, so this is where a call autograd would
    record raises: rounding has no gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int8 quantization (kernel Q1) has no backward; "
                           "the int8 dial is for inference: run under "
                           "torch.no_grad() or leave quant_int8 off")
    if x.dim() != 2:
        raise ValueError(f"quantize_int8: x has shape {tuple(x.shape)}; "
                         "expected (R, K) rows")
    q, row_scale = _quantize_op(x, scale)
    return q, (row_scale if scale is None else scale)


quantize_int8.launches = 0


# ---------------------------------------------------------------- Q2


def _bias_f32(bias: torch.Tensor | None, dtype: torch.dtype,
              cast_first: bool) -> torch.Tensor | None:
    """The bias as Q2 adds it: in f32, or, with ``cast_first``, as a value
    of the output type (the fused attention branch's bias)."""
    if bias is None:
        return None
    return (bias.to(dtype) if cast_first else bias).float().contiguous()


def dequantize_int32_reference(acc: torch.Tensor, xs: torch.Tensor,
                               ws: torch.Tensor, bias: torch.Tensor | None,
                               out_dtype: torch.dtype,
                               cast_first: bool = False) -> torch.Tensor:
    """Plain version of Q2: ``(f32(acc) * xs[row]) * ws[col]``, then ``+
    bias`` in f32 and one cast to ``out_dtype`` or, with ``cast_first``,
    the cast, ``+ bias`` (of ``out_dtype``) and a cast again. ``acc``
    (..., N) int32; ``xs`` f32 holds one scale per group of R / len(xs)
    consecutive rows (per row, per image, or one). Returns a contiguous
    (..., N) tensor."""
    n = acc.shape[-1]
    a = acc.reshape(-1, n).float()
    rows = a.shape[0]
    idx = torch.arange(rows, device=acc.device) // (rows // xs.numel())
    t = (a * xs.reshape(-1)[idx][:, None]) * ws.float()
    if cast_first:
        t = t.to(out_dtype).float()
    b = _bias_f32(bias, out_dtype, cast_first)
    if b is not None:
        t = t + b
    return t.to(out_dtype).reshape(acc.shape)


def _check_dequantize(acc: torch.Tensor, xs: torch.Tensor,
                      ws: torch.Tensor, out_dtype: torch.dtype) -> None:
    """Q2's checks, on metadata alone (the fake implementation makes them
    too)."""
    n = acc.shape[-1]
    strides = acc.stride()[:-1]
    if (acc.device.type != "cuda" or acc.dtype != torch.int32
            or out_dtype not in _DTYPES or acc.dim() not in (2, 4)
            or acc.stride(-1) != 1 or n % 4 or any(s % 4 for s in strides)
            or not aligned16(acc)):
        raise ValueError(f"dequantize_int32: acc {tuple(acc.shape)} "
                         f"{acc.dtype} on {acc.device}, strides "
                         f"{acc.stride()}, output {out_dtype}: the kernel "
                         "takes int32 rows of a multiple of 4 columns with "
                         "unit column stride and 16-byte aligned rows, "
                         "and writes float32 or bfloat16")
    rows = math.prod(acc.shape[:-1])
    if rows % xs.numel() or ws.shape != (n,):
        raise ValueError(f"dequantize_int32: {xs.numel()} row scales for "
                         f"{rows} rows, {tuple(ws.shape)} column scales for "
                         f"{n} columns")


@torch.library.custom_op("e3d::dequantize_int32", mutates_args=(),
                         device_types="cpu")
def _dequantize_op(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                   bias: torch.Tensor | None, out_dtype: torch.dtype,
                   cast_first: bool) -> torch.Tensor:
    """Q2: a new contiguous tensor of acc's shape in ``out_dtype``. This
    CPU kernel is the plain version."""
    return dequantize_int32_reference(acc, xs, ws, bias, out_dtype,
                                      cast_first)


@_dequantize_op.register_kernel("cuda")
def _dequantize_cuda(acc, xs, ws, bias, out_dtype, cast_first):
    """The launch, counted on ``dequantize_int32``."""
    _check_dequantize(acc, xs, ws, out_dtype)
    n = acc.shape[-1]
    dims = (1,) * (4 - acc.dim()) + tuple(acc.shape[:-1])
    strides = (0,) * (4 - acc.dim()) + tuple(acc.stride()[:-1])
    rows = math.prod(dims)
    xs = xs.float().contiguous()
    ws = ws.float().contiguous()
    b = _bias_f32(bias, out_dtype, cast_first)
    out = torch.empty(acc.shape, dtype=out_dtype, device=acc.device)
    lib = _lib()
    with torch.cuda.device(acc.device):
        err = lib.e3d_dequant(
            acc.data_ptr(), *dims, *strides, n, xs.data_ptr(),
            rows // xs.numel(), ws.data_ptr(),
            None if b is None else b.data_ptr(), int(cast_first),
            _DTYPES[out_dtype], out.data_ptr(), _stream(acc))
    if err:
        raise RuntimeError(f"dequantize_int32 launch failed: CUDA error {err}")
    dequantize_int32.launches += 1
    return out


@_dequantize_op.register_fake
def _dequantize_fake(acc, xs, ws, bias, out_dtype, cast_first):
    if acc.device.type != "cpu":
        _check_dequantize(acc, xs, ws, out_dtype)
    return acc.new_empty(acc.shape, dtype=out_dtype)


def dequantize_int32(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                     bias: torch.Tensor | None, out_dtype: torch.dtype,
                     cast_first: bool = False) -> torch.Tensor:
    """Kernel Q2: the function of ``dequantize_int32_reference``. ``acc``
    is (R, N), or (B, H, W, N) with unit column stride and any row strides
    (the crop of a padded convolution's accumulator).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    adding one to ``dequantize_int32.launches``, or raise."""
    return _dequantize_op(acc, xs, ws, bias, out_dtype, cast_first)


dequantize_int32.launches = 0


# ------------------------------------------------- the JAX package's API


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x (R, K) in a layout Q1 reads: unit column stride, 16-byte aligned
    rows (a copy where the view is not)."""
    vec = 16 // x.element_size()
    if (x.stride(1) == 1 and x.stride(0) % vec == 0
            and aligned16(x)):
        return x
    return x.contiguous()


def quantize_activation(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """An activation quant site: Q1 on the rows of ``x`` (R, K) with
    dynamic per-row scales, recording the tensor's abs-max under
    ``calibration`` or taking the next frozen scale under
    ``frozen_scales``."""
    x = _rows(x)
    kind = getattr(_MODE, "kind", None)
    if kind == "static":
        i = _MODE.idx
        if i >= _MODE.scales.shape[0]:
            raise ValueError(
                "frozen_scales: more activation quant sites than the "
                f"{_MODE.scales.shape[0]} calibrated")
        _MODE.idx = i + 1
        return quantize_int8(x, _MODE.scales[i:i + 1])
    if kind == "calib":
        _MODE.tape.append(x.abs().amax().float())
    return quantize_int8(x)


def quantize_axes(x: torch.Tensor, axes: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per index of the axes not in ``axes``
    (the abs-max over ``axes``): (q int8 of x's shape, scale f32 with
    ``axes`` kept as size 1). An activation site (calibration tape, frozen
    scales), as the JAX package's ``quantize_axes``."""
    keep = [d for d in range(x.dim()) if d not in axes]
    perm = keep + list(axes)
    xp = x.permute(perm)
    r = math.prod(x.shape[d] for d in keep)
    q, scale = quantize_activation(xp.reshape(r, -1))
    q = q.reshape(xp.shape).permute(sorted(range(x.dim()),
                                           key=perm.__getitem__))
    shape = [1 if d in axes else x.shape[d] for d in range(x.dim())]
    return q, scale.reshape(shape if scale.numel() == r else [1] * x.dim())


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 over the last axis: (q, scale of shape
    ``x.shape[:-1] + (1,)``)."""
    return quantize_axes(x, (x.dim() - 1,))


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A (K, ...) kernel of the JAX package's layout quantized over its
    first (contracted) axis, one scale per output channel: (q, scale of
    shape ``w.shape[1:]``). Weights are no activation site."""
    k = w.shape[0]
    q, scale = quantize_int8(w.reshape(k, -1).t().contiguous())
    return q.t().reshape(w.shape), scale.reshape(w.shape[1:])


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 by ``torch._int_mm``. On
    the card cuBLASLt needs M > 16 and K and N multiples of 8; other
    shapes raise here, naming them."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int_mm: ({m}, {k}) x ({k}, {n}) int8; the card's "
                         "int8 GEMM needs M > 16 and K, N multiples of 8")
    return torch._int_mm(a, b)


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None,
               cast_first: bool = False) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` in W8A8: ``weight`` (N, K) and
    ``bias`` (N,) in ``nn.Linear``'s layout (f32 parameters), ``x`` (...,
    K). Output (..., N) in x's dtype; the bias is added in f32 before the
    one cast, or after a first cast with ``cast_first`` (the fused
    attention branch's order)."""
    k = x.shape[-1]
    wq, ws = quantize_int8(weight)
    xq, xs = quantize_activation(x.reshape(-1, k))
    acc = int_mm(xq, wq.t())
    y = dequantize_int32(acc, xs, ws, bias, x.dtype, cast_first)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def conv_acc_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                       padding: int) -> torch.Tensor:
    """Plain int32 accumulator of an int8 convolution: ``xq`` (B, H, W, C)
    and ``wq`` (Cout, kh, kw, C) int8 as an f64 ``F.conv2d`` of the
    integer values (exact below 2**53), rounded to int32, (B, Ho, Wo,
    Cout)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 wq.permute(0, 3, 1, 2).double(), stride=stride,
                 padding=padding)
    return y.round().to(torch.int32).permute(0, 2, 3, 1)


def conv_acc_taps(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                  padding: int) -> torch.Tensor:
    """The int32 accumulator of ``conv_acc_reference`` by ``int_mm``.

    The input is zero-padded once to (B, Hp, Wp, C) and read as rows of C;
    tap (dy, dx) of every output position is then the contiguous row slice
    at offset dy * Wp + dx, so the convolution is kh * kw ``int_mm`` calls
    summed in int32 (exact, as XLA's int32 accumulator), and a crop of the
    (B, Hp, Wp, Cout) result, with no im2col copy. A strided convolution
    is computed at stride 1 and subsampled. Returns a strided view."""
    b, h, w, c = xq.shape
    cout, kh, kw, _ = wq.shape
    if kh == kw == 1 and padding == 0:
        acc = int_mm(xq.reshape(-1, c), wq.view(cout, c).t())
        return acc.view(b, h, w, cout)[:, ::stride, ::stride]
    hp, wp = h + 2 * padding, w + 2 * padding
    rows = F.pad(xq, (0, 0, padding, padding, padding, padding)).reshape(-1, c)
    # Output position (b, y, x) at stride 1 is row b*hp*wp + y*wp + x; the
    # last one the crop keeps lies below m, the rows every tap can read.
    m = b * hp * wp - ((kh - 1) * wp + (kw - 1))
    taps = wq.permute(1, 2, 0, 3).contiguous()  # (kh, kw, Cout, C)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            off = dy * wp + dx
            part = int_mm(rows[off:off + m], taps[dy, dx].t())
            acc = part if acc is None else acc.add_(part)
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    return acc.as_strided((b, ho, wo, cout), (hp * wp * cout,
                                              stride * wp * cout,
                                              stride * cout, 1))


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int,
             padding: int) -> torch.Tensor:
    """The int32 accumulator of an int8 convolution: ``conv_acc_taps`` on
    the card, ``conv_acc_reference`` on the CPU."""
    if xq.device.type == "cpu":
        return conv_acc_reference(xq, wq, stride, padding)
    return conv_acc_taps(xq, wq, stride, padding)


def int8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None, stride: int = 1,
              padding: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding)`` in W8A8: ``x`` (B,
    C, H, W) (channels-last memory reads without a copy), ``weight``
    (Cout, C, kh, kw) f32. One activation scale per image (max over H, W,
    C: a convolution mixes positions, so per-pixel scales would not factor
    out of the sum), one weight scale per output channel; bias in f32,
    then the cast to x's dtype. Returns (B, Cout, Ho, Wo) in channels-last
    memory."""
    b, c, h, w = x.shape
    cout, _, kh, kw = weight.shape
    xq, xs = quantize_activation(x.permute(0, 2, 3, 1).reshape(b, -1))
    wq, ws = quantize_int8(_rows(weight.permute(0, 2, 3, 1).reshape(cout,
                                                                     -1)))
    acc = conv_acc(xq.view(b, h, w, c), wq.view(cout, kh, kw, c), stride,
                   padding)
    y = dequantize_int32(acc, xs, ws, bias, x.dtype)
    return y.permute(0, 3, 1, 2)
