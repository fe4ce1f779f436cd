"""Flash-attention forward for the ViT encoder: kernel K1 and its plain
PyTorch version.

``flash_attention`` takes (B, N, H, D) q, k, v and returns
``(o (B, N, H, D), lse (B, H, N) f32)``. On CUDA tensors it launches the
hand-written Hopper kernel in ``csrc/flash_attn_fwd.cu`` (bf16, D in
{32, 64}, unit stride on D, any other strides, so views of the packed qkv
projection go in without copies) or raises; on CPU tensors it computes
``flash_attention_reference``. The kernel masks the ragged edges by index,
so no caller pads the token axis.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import cbuild

HEAD_DIMS = (32, 64)
_LIB_NAME = "flash_attn_fwd"


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (B, N, H, D), softmax in f32 as the JAX
    package's ``mha_xla``: returns (o in q.dtype, lse (B, H, N) f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v), lse


def _bind(lib: ctypes.CDLL):
    fn = lib.e3d_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
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
        # 16-byte row chunks: unit stride on D, other strides and the
        # base address aligned to 8 elements.
        if (x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} layout (strides "
                             f"{x.stride()}) needs unit stride on D and "
                             "16-byte aligned rows")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    if q.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention over (B, N, H, D): (o (B, N, H, D), lse (B, H, N) f32).

    CPU tensors take the plain version; CUDA tensors launch kernel K1 and
    add one to ``flash_attention.launches``."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    _check(q, k, v)
    fn = _bind(cbuild.load(_LIB_NAME))
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, n, h, d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(d),
                 stream)
    flash_attention.launches += 1
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    return o, lse


flash_attention.launches = 0
