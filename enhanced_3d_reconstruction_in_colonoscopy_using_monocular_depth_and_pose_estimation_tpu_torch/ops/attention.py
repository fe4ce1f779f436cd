"""Multi-head self-attention for the ViT encoder.

On CUDA tensors attention runs through kernel K1 (``ops/flash_attention``)
and its backward through kernel K2 (or K3); on CPU tensors through their
plain versions. ``set_force_plain`` routes CUDA tensors through the plain
attention too, forward and backward (autograd through the einsums), so a
run can hold the whole model on the kernels against the same model
without them.

``qkv_self_attention(quant=True)`` is the JAX package's fused int8
branch: both projections in W8A8 (``ops/quant.py``: Q1, ``torch._int_mm``,
Q2 with the bf16 bias added after the cast), K1 between them as always.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention_qkv, flash_attention_reference
from .quant import int8_dense

_FORCE_PLAIN = False


def set_force_plain(value: bool) -> None:
    """Test hook: take the plain attention even on CUDA tensors (the
    counterpart of the JAX package's ``set_force_xla``). Under gradient
    checkpointing the backward recomputes each block, so keep the hook set
    until the backward has run."""
    global _FORCE_PLAIN
    _FORCE_PLAIN = value


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Reference attention: (B, N, H, D) -> (B, N, H, D), softmax in f32."""
    return flash_attention_reference(q, k, v)[0]


def qkv_self_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                       b_qkv: torch.Tensor, w_proj: torch.Tensor,
                       b_proj: torch.Tensor, num_heads: int,
                       quant: bool = False) -> torch.Tensor:
    """Self-attention of x (B, N, C) with packed qkv/proj weights in
    ``nn.Linear`` layout: ``w_qkv`` (3C, C), whose rows are ordered as
    ``reshape(3, H, D)``, ``b_qkv`` (3C,), ``w_proj`` (C, C), ``b_proj``
    (C,) or None. ``num_heads`` may be a slice of the heads (tensor
    parallelism: ``w_qkv`` (3HD, C), ``w_proj`` (C, HD)). Computes in
    x.dtype. The one (B, N, 3, H, D) projection goes to
    ``flash_attention_qkv`` as is (q, k and v are its strided views, and
    the backward returns one packed gradient), and the attention output
    (B, N, H, D) feeds ``proj`` as is: no transposes or pads. ``quant``
    takes both projections in W8A8: per-token activation scales (over the
    (H, D) features for ``proj``), per-column weight scales, the product
    cast to x.dtype before its bias of x.dtype is added, as the JAX
    package's fused branch does."""
    b, n, _ = x.shape
    if quant:
        qkv = int8_dense(x, w_qkv, b_qkv, cast_first=True)
    else:
        qkv = F.linear(x, w_qkv.to(x.dtype), b_qkv.to(x.dtype))
    qkv = qkv.view(b, n, 3, num_heads, -1)
    if _FORCE_PLAIN:
        out = mha_plain(*qkv.unbind(2))
    else:
        out = flash_attention_qkv(qkv)
    if quant:
        return int8_dense(out.reshape(b, n, -1), w_proj, b_proj,
                          cast_first=True)
    return F.linear(out.reshape(b, n, -1), w_proj.to(x.dtype),
                    None if b_proj is None else b_proj.to(x.dtype))
