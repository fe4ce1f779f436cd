"""Flash attention for the ViT encoder: kernels K1, K4 and K5 (forward),
kernels K2 and K3 (backward), their plain PyTorch versions, and the
autograd Function that ties them together.

``flash_attention`` takes (B, N, H, D) q, k, v and returns
``(o (B, N, H, D), lse (B, H, N) f32)``. On CUDA tensors it launches a
hand-written Hopper kernel in ``csrc/flash_attn_fwd.cu`` (bf16, D in
{32, 64}, unit stride on D, any other strides, so views of the packed qkv
projection go in without copies) or raises; on CPU tensors it computes
``flash_attention_reference``. The kernels mask the ragged edges by index,
so no caller pads the token axis. Which forward kernel runs follows the
JAX package's knobs (``forward_schedule``): K1 by default (a persistent
grid over heads and 192-query tiles, each consumer's softmax running
under its own and the other consumers' products), K4 (``E3D_FLASH_PAIR``:
two heads per block, each K and V tile of both brought by one TMA load)
or K5 (``E3D_FLASH_PIPE`` / ``E3D_FLASH_HLOOP``: a block of heads per
block, walked with or without cross-head overlap). All three are
warp-specialised (a TMA producer warpgroup and ``wgmma`` consumer
warpgroups: three in K1, two in K4 and K5) and read q, k and v by TMA, so
they take only views TMA can read (``_tma_ok``) and raise on others. All three compute the same
function; their sums run in different orders, so their O and LSE agree
with one another to within rounding.

The backward has two schedules, as in the JAX package: K2
(``flash_attention_bwd_fused``, one pass over key blocks, dQ summed across
blocks by bulk f32 reductions) and K3 (``flash_attention_bwd_split``, a dQ
pass and a dK/dV pass, deterministic). ``_BWD_FUSED`` picks between them
from the same ``E3D_FLASH_BWD_FUSED`` knob, read at import; unset, it
names the one measured faster on the H100. Both live in
``csrc/flash_attn_bwd.cu`` (TMA, wgmma, warp specialisation), behind a
preparation kernel (delta, padded LSE) whose plain version is
``bwd_prep_reference``; K2's f32 accumulator goes through a conversion
kernel whose plain version is ``bwd_convert_reference``. Their plain
version as a whole is ``flash_attention_bwd_reference``.

``flash_attention_qkv`` is the differentiable entry: it takes the packed
(B, N, 3, H, D) projection, runs the forward (K1, K4 or K5) on its three
views, and its backward
writes dq, dk and dv straight into the three views of one packed dqkv, so
the backward of the projection gets one contiguous gradient.

Each launch is a ``torch.library`` op (``e3d::flash_attn_fwd`` for K1, K4
and K5, ``e3d::flash_attn_bwd`` for K2 and K3): its CPU kernel is the
plain version, its CUDA kernel the launch (which adds one to the public
function's ``launches``), and its fake implementation makes the launch's
checks on the views' metadata. So ``torch.export`` records each launch as
one node, with the forward schedule fixed at export, a replay counts its
launches as a live call does, and ``core.debug.nan_checks`` sees every
kernel's output.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from ..core.device import aligned16
from ..utils import cbuild

HEAD_DIMS = (32, 64)
_LIB_NAME = "flash_attn_fwd"
_BWD_LIB_NAME = "flash_attn_bwd"
_K1_ENTRY = "e3d_flash_attn_fwd"
_K4_ENTRY = "e3d_flash_attn_fwd_pair"
_K5_ENTRY = "e3d_flash_attn_fwd_heads"
# The backward schedule, the knob of the JAX package's
# ops/flash_attention.py: E3D_FLASH_BWD_FUSED=1 selects K2 (fused), =0 K3
# (split). Unset, the port takes the one measured faster through its
# wrapper at vitl's shape on the H100 (PERF.md, Findings).
_BWD_DEFAULT = "1"
_BWD_FUSED = os.environ.get("E3D_FLASH_BWD_FUSED", _BWD_DEFAULT) == "1"
# The forward schedule, from the same module's knobs: E3D_FLASH_PAIR=1
# selects K4, E3D_FLASH_PIPE=1 or E3D_FLASH_HLOOP=1 K5. All three compute
# K1's function, LSE included, so the backward stays K2 or K3.
_PAIR = os.environ.get("E3D_FLASH_PAIR", "0") == "1"
_PIPE = os.environ.get("E3D_FLASH_PIPE", "0") == "1"
_HLOOP = os.environ.get("E3D_FLASH_HLOOP", "0") == "1"
# Inputs of K5's heads-per-block rule: the JAX package's default query
# block and forward VMEM budget, as constants. Their knobs there are TPU
# settings and do not reach the port.
_BLOCK_Q = 704
_FWD_BUDGET = 768 * 1024


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or f64 if it is f64: the plain versions' working type."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (B, N, H, D), softmax in f32 as the JAX
    package's ``mha_xla``: returns (o in q.dtype, lse (B, H, N) f32; f64
    for f64 inputs)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", _wide(q), _wide(k)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, N, H, D) -> (B, H, N) contiguous
    (the JAX package leaves it to XLA; on the card the backward's
    preparation kernel computes it)."""
    return (_wide(do) * _wide(o)).sum(-1).transpose(1, 2).contiguous()


BWD_TILE = 64  # the backward kernels' query tile


def padded_rows(n: int) -> int:
    """Np: n rounded up to the backward's query tile, the row count of its
    (B, H, Np) LSE and delta buffers and of K2's dQ accumulator."""
    return -(-n // BWD_TILE) * BWD_TILE


def bwd_prep_reference(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                       fused: bool) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor | None]:
    """Plain version of the preparation kernel: (lse2, delta, dq_acc).

    lse2 = LSE * log2(e) and delta = rowsum(dO * O), (B, H, Np) f32, with
    +inf and 0 on the padded rows (so that P = exp2(S scale log2(e) -
    lse2) is 0 there); under K2 (``fused``) also the zeroed (B, H, Np, D)
    f32 dQ accumulator."""
    b, n, h, d = o.shape
    pad = padded_rows(n) - n
    lse2 = torch.nn.functional.pad(lse.float() * math.log2(math.e),
                                   (0, pad), value=math.inf)
    delta = torch.nn.functional.pad(attention_delta(o, do).float(), (0, pad))
    acc = (torch.zeros((b, h, n + pad, d), dtype=torch.float32,
                       device=o.device) if fused else None)
    return lse2, delta, acc


def dq_acc_swizzle(acc: torch.Tensor) -> torch.Tensor:
    """K2's accumulator layout: within each (Np, D) row, 8-value chunk c
    holds logical chunk c ^ (row % 4) (so the kernel's stores from the
    wgmma accumulator hit distinct shared-memory banks). Its own inverse:
    it maps the logical layout to the stored one and back."""
    rows, d = acc.shape[-2:]
    col = torch.arange(d, device=acc.device)
    row = torch.arange(rows, device=acc.device)[:, None] % 4
    idx = ((col // 8) ^ row) * 8 + col % 8
    return torch.gather(acc, -1, idx.expand(acc.shape))


def bwd_convert_reference(dq_acc: torch.Tensor, n: int, scale: float,
                          dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K2's conversion kernel: the (B, H, Np, D) f32
    accumulator of dS K, in the stored layout, as dq = its first n rows
    times ``scale`` in ``dtype``, (B, N, H, D)."""
    dq = dq_acc_swizzle(dq_acc)[:, :, :n] * scale
    return dq.to(dtype).transpose(1, 2)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain backward of attention over (B, N, H, D), in f32 (f64 for f64
    inputs) from the inputs as given, rounded to their dtype only at the
    end:

        P = exp(S scale - LSE),  dV = P^T dO,
        dS = P (dO V^T - delta), delta = rowsum(dO O),
        dQ = dS K scale,         dK = dS^T Q scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (_wide(x) for x in (q, k, v, do))
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - attention_delta(o, do)[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bind(lib: ctypes.CDLL, entry: str):
    """One forward entry: K1 and K4 take (q, k, v, o, lse, B, N, H, D, nine
    strides, scale, stream); K5 takes hb and pipe before the stream."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        tail = ([ctypes.c_int, ctypes.c_int] if entry == _K5_ENTRY else [])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float] + tail
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib: ctypes.CDLL):
    """q, k, v, dO, o, lse, lse2, delta, dq_acc, dq, dk, dv; B, N, Np, H,
    D; 24 strides; fused, scale, stream."""
    fn = lib.e3d_flash_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _layout_ok(x: torch.Tensor) -> bool:
    """16-byte row chunks: unit stride on D, other strides and the base
    address aligned to 8 elements."""
    return (x.stride(3) == 1 and not any(s % 8 for s in x.stride()[:3])
            and aligned16(x))


def _tma_ok(x: torch.Tensor) -> bool:
    """Whether TMA can read the (B, N, H, D) view as it is: unit stride on
    D, every other stride non-zero and a multiple of 16 bytes, the base
    16-byte aligned."""
    size = x.element_size()
    return (x.dim() == 4 and x.stride(3) == 1
            and all(s != 0 and s * size % 16 == 0 for s in x.stride()[:3])
            and aligned16(x))


def _require_tma(what: str, **views: torch.Tensor) -> None:
    """Raise ValueError, naming the strides, for a view TMA cannot read:
    the forward kernels and the backward load q, k and v only by TMA and
    take no other path."""
    for name, x in views.items():
        if not _tma_ok(x):
            raise ValueError(f"{what}: {name} (strides {tuple(x.stride())}, "
                             f"{x.element_size()}-byte elements) is not a "
                             "view TMA can read: unit stride on D, other "
                             "strides non-zero multiples of 16 bytes, "
                             "16-byte aligned base")


def _check(q: torch.Tensor, *others: tuple[str, torch.Tensor]) -> None:
    for name, x in (("q", q), *others):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}; q, k, "
                             "v must lie on one CUDA device (or all on the "
                             "CPU for the plain version)")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} is {x.dtype}; the "
                             "kernel takes bfloat16")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(x.shape)}; expected (B, N, H, D) equal "
                             f"to q's {tuple(q.shape)}")
        if not _layout_ok(x):
            raise ValueError(f"flash_attention: {name} layout (strides "
                             f"{x.stride()}) needs unit stride on D and "
                             "16-byte aligned rows")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    if q.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")


def padded_len(n: int) -> int:
    """The token count the JAX package's forward runs at for n tokens
    (``padded_len`` at its default query block). The port never pads;
    this only feeds ``head_block``."""
    bq = min(_BLOCK_Q, -(-n // 16) * 16)
    return -(-n // bq) * bq


def head_block(bh: int, n: int, d: int) -> int:
    """K5's heads per block for B*H = ``bh`` heads of n tokens, by the JAX
    package's ``_head_block`` rule at its defaults (its padded K+V of a
    head against ``FWD_BUDGET``, shrunk to a divisor of B*H): 2 at vitl's
    518 px. K5's shared memory does not depend on it."""
    per_head = 2 * padded_len(n) * d * 2  # K and V, bf16
    hb = min(max(1, _FWD_BUDGET // per_head), bh)
    while bh % hb:
        hb -= 1
    return hb


def forward_schedule(bh: int) -> str:
    """The forward kernel for B*H = ``bh`` heads on CUDA tensors, in the
    JAX package's ``_fwd`` order: K4 under ``_PAIR`` when B*H is even, then
    K5 under ``_PIPE``, then K5 under ``_HLOOP``, else K1."""
    if _PAIR and bh % 2 == 0:
        return "K4"
    if _PIPE:
        return "K5 pipe"
    if _HLOOP:
        return "K5 hloop"
    return "K1"


def _refuse_autograd(q, k, v) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention is not differentiable (kernels "
                           "K1, K4 and K5 write outside autograd); call "
                           "flash_attention_qkv on the packed projection, "
                           "or run under torch.no_grad()")


def _on_cpu(q, k, v) -> bool:
    return q.device.type == k.device.type == v.device.type == "cpu"


def _launch_fwd(entry: str, q, k, v, *extra) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Checks and one call of a forward entry of ``flash_attn_fwd``."""
    _check(q, ("k", k), ("v", v))
    fn = _bind(cbuild.load(_LIB_NAME), entry)
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, n, h, d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(d),
                 *extra, stream)
    if err < 0:
        raise RuntimeError(f"{entry}: a TMA tensor map could not be encoded "
                           f"(CUresult {-err})")
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return o, lse


# ------------------------------------------------- the launches as ops

# The forward kernels by schedule name: (the public function that counts
# the launch, its ctypes entry).
_FORWARDS = {"K1": ("flash_attention", _K1_ENTRY),
             "K4": ("flash_attention_pair", _K4_ENTRY),
             "K5 pipe": ("flash_attention_heads", _K5_ENTRY),
             "K5 hloop": ("flash_attention_heads", _K5_ENTRY)}


def _check_fwd(q, k, v, kernel: str) -> None:
    """The forward launch's checks, made on the views' metadata alone (so
    the fake implementation makes them too): every kernel reads q, k and
    v by TMA; K4 pairs the B*H heads."""
    if kernel not in _FORWARDS:
        raise ValueError(f"flash_attention: unknown forward kernel "
                         f"{kernel!r}; expected one of {tuple(_FORWARDS)}")
    name = _FORWARDS[kernel][0]
    _require_tma(name, q=q, k=k, v=v)
    if kernel == "K4" and (q.shape[0] * q.shape[2]) % 2:
        raise ValueError(f"flash_attention_pair: B*H = {q.shape[0]} x "
                         f"{q.shape[2]} is odd; K4 pairs heads")
    _check(q, ("k", k), ("v", v))


@torch.library.custom_op("e3d::flash_attn_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kernel: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K1, K4 or K5 (``kernel``, a key of ``_FORWARDS``) on (B, N, H, D)
    q, k, v: (o, lse). This CPU kernel is the plain version, for any
    ``kernel``."""
    o, lse = flash_attention_reference(q, k, v)
    return o.contiguous(), lse.contiguous()


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, kernel):
    """The launch of ``kernel``, counted on its public function."""
    _check_fwd(q, k, v, kernel)
    name, entry = _FORWARDS[kernel]
    extra = ()
    if entry == _K5_ENTRY:
        b, n, h, d = q.shape
        extra = (head_block(b * h, n, d), int(kernel == "K5 pipe"))
    out = _launch_fwd(entry, q, k, v, *extra)
    globals()[name].launches += 1
    return out


@_fwd_op.register_fake
def _fwd_fake(q, k, v, kernel):
    # Every device but the CPU takes the launch's checks: a traced CUDA
    # view fails at export, a meta tensor is refused as at a launch.
    if q.device.type != "cpu":
        _check_fwd(q, k, v, kernel)
    b, n, h, d = q.shape
    return (q.new_empty((b, n, h, d)),
            q.new_empty((b, h, n),
                        dtype=torch.promote_types(q.dtype, torch.float32)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention over (B, N, H, D): (o (B, N, H, D), lse (B, H, N) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    that ``forward_schedule`` names: K1 (adding one to
    ``flash_attention.launches``), K4 or K5 (counted on
    ``flash_attention_pair`` and ``flash_attention_heads``). Each reads q,
    k and v by TMA, so a view TMA cannot read raises before any launch.
    Not differentiable, so it raises, on every device alike, when autograd
    would record it: train through ``flash_attention_qkv``."""
    _refuse_autograd(q, k, v)
    kernel = ("K1" if _on_cpu(q, k, v)
              else forward_schedule(q.shape[0] * q.shape[2]))
    return _fwd_op(q, k, v, kernel)


flash_attention.launches = 0


def flash_attention_pair(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4: K1's function, two heads of the B*H axis per block (B*H
    even), one consumer warpgroup per head. CPU tensors take the plain
    version; CUDA tensors that TMA can read launch K4 and add one to
    ``flash_attention_pair.launches``; anything else raises."""
    _refuse_autograd(q, k, v)
    return _fwd_op(q, k, v, "K4")


flash_attention_pair.launches = 0


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pipe: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K5: K1's function, ``head_block`` heads of the B*H axis and
    128 queries per block, pipelined across heads when ``pipe`` (the JAX
    package's ``E3D_FLASH_PIPE``) or looped (``E3D_FLASH_HLOOP``). CPU
    tensors take the plain version; CUDA tensors that TMA can read launch
    K5 and add one to ``flash_attention_heads.launches``; anything else
    raises."""
    _refuse_autograd(q, k, v)
    return _fwd_op(q, k, v, "K5 pipe" if pipe else "K5 hloop")


flash_attention_heads.launches = 0


def _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, fused: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Checks and one call of ``e3d_flash_attn_bwd``: the preparation
    kernel, then K2's dK/dV kernel with the dQ share and its conversion
    (``fused``), or K3's dQ and dK/dV kernels. dq, dk and dv are bf16
    (B, N, H, D) views; the f32 scratch is allocated here and returned,
    as ``bwd_prep_reference`` lays it out: (lse2, delta, dq_acc)."""
    do = _readable_grad(q, do)
    _check(q, ("k", k), ("v", v), ("o", o), ("dO", do), ("dq", dq),
           ("dk", dk), ("dv", dv))
    _require_tma("flash_attention", q=q, k=k, v=v)
    _check_lse(q, lse)
    b, n, h, d = q.shape
    n_pad = padded_rows(n)
    lse2 = torch.empty((b, h, n_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    acc = (torch.empty((b, h, n_pad, d), dtype=torch.float32,
                       device=q.device) if fused else None)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, do, o, dq, dk, dv) for s in x.stride()[:3]))
    fn = _bind_bwd(cbuild.load(_BWD_LIB_NAME))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
                 delta.data_ptr(), 0 if acc is None else acc.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, n_pad, h,
                 d, strides, int(fused), 1.0 / math.sqrt(d), stream)
    if err < 0:
        raise RuntimeError("flash_attn_bwd: a TMA tensor map could not be "
                           f"encoded (CUresult {-err})")
    if err:
        raise RuntimeError(f"flash_attn_bwd launch failed: CUDA error {err}")
    return lse2, delta, acc


def _readable_grad(q: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """dO as the kernels read it. It comes from autograd and may be
    non-contiguous (or broadcast, with a zero stride, after a sum); a
    layout TMA cannot read is copied once. That is a copy, not a
    fallback: the kernel runs."""
    if do.device == q.device and do.dim() == 4 and not _tma_ok(do):
        return do.contiguous()
    return do


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    b, n, h, _ = q.shape
    if (lse.shape != (b, h, n) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention: lse must be a contiguous "
                         f"(B, H, N) = {(b, h, n)} float32 tensor on q's "
                         f"device, got {tuple(lse.shape)} {lse.dtype}")


@torch.library.custom_op("e3d::flash_attn_bwd", mutates_args=(),
                         device_types="cpu")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            fused: bool) -> torch.Tensor:
    """K2 (``fused``) or K3: a fresh packed dqkv (B, N, 3, H, D) in q's
    dtype. This CPU kernel is the plain backward, for either."""
    return torch.stack(flash_attention_bwd_reference(q, k, v, o, lse, do),
                       dim=2)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, o, lse, do, fused):
    """The launch, into the three views of one dqkv, counted on
    ``flash_attention_bwd_fused`` or ``flash_attention_bwd_split``."""
    b, n, h, d = q.shape
    dqkv = torch.empty((b, n, 3, h, d), dtype=torch.bfloat16,
                       device=q.device)
    _launch_bwd(q, k, v, o, lse, do, *dqkv.unbind(2), fused=fused)
    counter = (flash_attention_bwd_fused if fused
               else flash_attention_bwd_split)
    counter.launches += 1
    return dqkv


@_bwd_op.register_fake
def _bwd_fake(q, k, v, o, lse, do, fused):
    if q.device.type != "cpu":
        _check(q, ("k", k), ("v", v), ("o", o),
               ("dO", _readable_grad(q, do)))
        _require_tma("flash_attention", q=q, k=k, v=v)
        _check_lse(q, lse)
    b, n, h, d = q.shape
    return q.new_empty((b, n, 3, h, d))


def _backward_into(q, k, v, o, lse, do, dq, dk, dv, fused: bool) -> None:
    """The backward op, its three gradients copied into dq, dk, dv (bf16
    (B, N, H, D) views on q's device, checked first)."""
    if q.device.type == "cuda":
        _check(q, ("dq", dq), ("dk", dk), ("dv", dv))
    for out, grad in zip((dq, dk, dv),
                         _bwd_op(q, k, v, o, lse, do, fused).unbind(2)):
        out.copy_(grad)


def flash_attention_bwd_fused(q, k, v, o, lse, do, dq, dk, dv) -> None:
    """Kernel K2: writes dq, dk and dv (bf16 (B, N, H, D) views allowed).
    One pass over key blocks; each block's dQ share is added into an f32
    accumulator by bulk reductions, which a conversion kernel scales and
    rounds into dq. Adds one to ``flash_attention_bwd_fused.launches``.
    The op returns one packed gradient; this copies it into the views."""
    _backward_into(q, k, v, o, lse, do, dq, dk, dv, fused=True)


flash_attention_bwd_fused.launches = 0


def flash_attention_bwd_split(q, k, v, o, lse, do, dq, dk, dv) -> None:
    """Kernel K3: a dQ kernel over query blocks and a dK/dV kernel over key
    blocks, into the bf16 (B, N, H, D) views dq, dk, dv (through the op's
    packed gradient, as K2). Deterministic. Adds one to
    ``flash_attention_bwd_split.launches``."""
    _backward_into(q, k, v, o, lse, do, dq, dk, dv, fused=False)


flash_attention_bwd_split.launches = 0


class FlashAttentionQKV(torch.autograd.Function):
    """Attention of a packed (B, N, 3, H, D) projection, differentiable.

    Forward: ``flash_attention`` (K1, or K4/K5 under their knobs) on the
    three strided views (the plain version on the CPU);
    returns (o, lse) and saves (qkv, o, lse). Backward: the packed dqkv of
    K2 (or K3), or of the plain backward on the CPU.
    Only ``o`` is differentiated, as in the JAX package's custom_vjp."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor):
        o, lse = flash_attention(*qkv.unbind(2))
        ctx.save_for_backward(qkv, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do: torch.Tensor, _dlse):
        qkv, o, lse = ctx.saved_tensors
        return flash_attention_qkv_backward(qkv, o, lse, do)


def flash_attention_qkv_backward(qkv: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor
                                 ) -> torch.Tensor:
    """dqkv (B, N, 3, H, D) of ``FlashAttentionQKV``: the plain backward
    for CPU tensors; K2, or K3 when ``_BWD_FUSED`` is off, for CUDA ones."""
    return _bwd_op(*qkv.unbind(2), o, lse, do, _BWD_FUSED)


def flash_attention_qkv(qkv: torch.Tensor) -> torch.Tensor:
    """Differentiable attention of the packed (B, N, 3, H, D) projection:
    returns o (B, N, H, D)."""
    return FlashAttentionQKV.apply(qkv)[0]
