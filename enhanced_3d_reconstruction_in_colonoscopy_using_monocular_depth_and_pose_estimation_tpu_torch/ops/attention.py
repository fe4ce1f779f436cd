"""Multi-head self-attention for the ViT encoder.

On CUDA tensors attention runs through kernel K1 (``ops/flash_attention``),
on CPU tensors through its plain version. ``set_force_plain`` routes CUDA
tensors through the plain version too, so a run can hold the whole model
on the kernel against the same model without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention, flash_attention_reference

_FORCE_PLAIN = False


def set_force_plain(value: bool) -> None:
    """Test hook: take the plain attention even on CUDA tensors (the
    counterpart of the JAX package's ``set_force_xla``)."""
    global _FORCE_PLAIN
    _FORCE_PLAIN = value


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Reference attention: (B, N, H, D) -> (B, N, H, D), softmax in f32."""
    return flash_attention_reference(q, k, v)[0]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """Self-attention over (B, N, H, D) tensors (views allowed)."""
    if _FORCE_PLAIN:
        return mha_plain(q, k, v)
    return flash_attention(q, k, v)[0]


def qkv_self_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                       b_qkv: torch.Tensor, w_proj: torch.Tensor,
                       b_proj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention of x (B, N, C) with packed qkv/proj weights in
    ``nn.Linear`` layout: ``w_qkv`` (3C, C), whose rows are ordered as
    ``reshape(3, H, D)``, ``b_qkv`` (3C,), ``w_proj`` (C, C), ``b_proj``
    (C,). Computes in x.dtype. q, k and v reach the attention as strided
    views of the one (B, N, 3, H, D) projection, and the attention output
    (B, N, H, D) feeds ``proj`` as is: no transposes or pads."""
    b, n, c = x.shape
    qkv = F.linear(x, w_qkv.to(x.dtype), b_qkv.to(x.dtype))
    qkv = qkv.view(b, n, 3, num_heads, c // num_heads)
    out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    return F.linear(out.reshape(b, n, c), w_proj.to(x.dtype),
                    b_proj.to(x.dtype))
