"""Temporal attention for Video Depth Anything's motion modules: attention
over the T frames of a clip at every spatial location and head.

``temporal_attention(qkv, frames)`` takes the packed (B*T, S, 3, H, D)
projection of a clip's tokens (the frames of a clip consecutive on the
first axis, S locations a frame) and returns (B*T, S, H, D): for every
(clip, location, head), softmax(q k^T / sqrt(D)) v over the T frames,
the softmax in f32. The motion modules of VDA-L call it at D = 128
(``layer_3``, ``layer_4``) and D = 32 (``path_4``, ``path_3``), T = 32.

It is the ``torch.library`` op ``e3d::temporal_attn``: its CPU kernel is
the plain version (``temporal_attention_reference``), its CUDA kernel
runs PyTorch's scaled-dot-product attention on strided views of the
projection, one clip at a time (the (S, H, T, D) views of q, k and v need
no copy), and writes the result back in frame order, the one regrouping
copy; each CUDA call adds one to ``temporal_attention.launches``. No
hand-written kernel stands behind it yet: by its bytes it is about 1% of
a VDA-L window on the H100, and a later kernel can take the same op name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _check(qkv: torch.Tensor, frames: int) -> None:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"temporal_attention: qkv has shape "
                         f"{tuple(qkv.shape)}; expected (B*T, S, 3, H, D)")
    if frames < 1 or qkv.shape[0] % frames:
        raise ValueError(f"temporal_attention: {qkv.shape[0]} frames do "
                         f"not split into clips of {frames}")


def temporal_attention_reference(qkv: torch.Tensor, frames: int
                                 ) -> torch.Tensor:
    """Plain attention over the frame axis: (B*T, S, 3, H, D) ->
    (B*T, S, H, D) in qkv's dtype, the logits and softmax in f32 (f64 for
    f64 inputs)."""
    _check(qkv, frames)
    bt, s, _, h, d = qkv.shape
    wide = qkv.to(torch.promote_types(qkv.dtype, torch.float32))
    q, k, v = wide.view(bt // frames, frames, s, 3, h, d).unbind(3)
    logits = torch.einsum("btshd,bushd->bshtu", q, k) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bshtu,bushd->btshd", probs, v.to(qkv.dtype))
    return out.reshape(bt, s, h, d)


@torch.library.custom_op("e3d::temporal_attn", mutates_args=(),
                         device_types="cpu")
def _temporal_op(qkv: torch.Tensor, frames: int) -> torch.Tensor:
    """Attention over clips of ``frames`` frames of the packed projection.
    This CPU kernel is the plain version."""
    return temporal_attention_reference(qkv, frames).contiguous()


@_temporal_op.register_kernel("cuda")
def _temporal_cuda(qkv, frames):
    """Scaled-dot-product attention on each clip's (S, H, T, D) views,
    counted on ``temporal_attention``."""
    _check(qkv, frames)
    bt, s, _, h, d = qkv.shape
    out = torch.empty((bt // frames, frames, s, h, d), dtype=qkv.dtype,
                      device=qkv.device)
    clips = qkv.view(bt // frames, frames, s, 3, h, d)
    for b in range(bt // frames):
        q, k, v = clips[b].permute(2, 1, 3, 0, 4).unbind(0)   # (S, H, T, D)
        o = F.scaled_dot_product_attention(q, k, v)
        out[b].copy_(o.permute(2, 0, 1, 3))
    temporal_attention.launches += 1
    return out.view(bt, s, h, d)


@_temporal_op.register_fake
def _temporal_fake(qkv, frames):
    _check(qkv, frames)
    bt, s, _, h, d = qkv.shape
    return qkv.new_empty((bt, s, h, d))


def temporal_attention(qkv: torch.Tensor, frames: int) -> torch.Tensor:
    """Attention over each clip's ``frames`` frames at every location and
    head of the packed (B*T, S, 3, H, D) projection: (B*T, S, H, D).

    CPU tensors take the plain version; CUDA tensors run the op's CUDA
    kernel and add one to ``temporal_attention.launches``. Inference only:
    a call autograd would record raises."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("temporal_attention is inference-only; run it "
                           "under torch.no_grad()")
    return _temporal_op(qkv, int(frames))


temporal_attention.launches = 0
