"""Video Depth Anything's temporal module (``motion_module/``): attention
over a clip's frames at every location of a DPT feature map.

A ``TemporalModule`` of width C maps x (B*T, C, h, w), the T frames of
each clip consecutive, as VDA's ``TemporalModule`` with one transformer
block of two attention blocks:

- r = x; z = GroupNorm(32 groups, eps 1e-6) of each frame over (C, h, w);
- z as tokens (B*T, h*w, C), then ``proj_in`` (C -> C, with bias);
- for j = 0, 1: z = z + Attn_j(LN_j(z)), where Attn_j adds the sinusoidal
  encoding of each token's frame to its input (``ape``, max_len 32),
  projects it to q, k and v (one packed (3C, C) matrix without bias,
  ``heads`` heads of C / heads), attends over the T frames at each
  location (``ops/temporal_attention.py``: the op ``e3d::temporal_attn``)
  and applies ``to_out`` (C -> C, with bias);
- z = z + FF(LN_ff(z)), FF a GEGLU: ``ff_proj`` C -> 8C, split into (h,
  g), h * GELU(g) (exact), then ``ff_out`` 4C -> C;
- the LayerNorms at torch's default eps 1e-5;
- ``proj_out`` (C -> C), back to (B*T, C, h, w), plus r.

It computes in x's dtype with f32 parameters cast at use, the norms'
statistics in f32 (as the encoder's), and keeps x's memory layout. Each
call is the span ``temporal.module`` in ``core.debug``'s recorder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import debug
from ..ops.temporal_attention import temporal_attention

GROUPS = 32
GROUP_EPS = 1e-6
LN_EPS = 1e-5
MAX_FRAMES = 32
HEADS = 8
ATTENTION_BLOCKS = 2
FF_MULT = 4


def sinusoid_table(frames: int, width: int) -> torch.Tensor:
    """VDA's ``PositionalEncoding``: pe[t, 2i] = sin(t 10000^(-2i/C)),
    pe[t, 2i + 1] = cos(t 10000^(-2i/C)), (frames, width) f32."""
    pos = torch.arange(frames, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, width, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / width))
    pe = torch.zeros(frames, width)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype),
                    None if layer.bias is None else layer.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


class TemporalAttentionBlock(nn.Module):
    """Attention over frames with VDA's absolute encoding: ``to_qkv``
    packs VDA's ``to_q``, ``to_k`` and ``to_v`` (rows ordered as
    (3, heads, C / heads)); ``to_out`` is VDA's ``to_out.0``."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(width, 3 * width, bias=False)
        self.to_out = nn.Linear(width, width)
        self.register_buffer("pe", sinusoid_table(MAX_FRAMES, width),
                             persistent=False)

    def forward(self, z: torch.Tensor, frames: int) -> torch.Tensor:
        bt, s, c = z.shape
        pe = self.pe[:frames].to(z.dtype)
        z = (z.view(bt // frames, frames, s, c) + pe[:, None]).view(bt, s, c)
        qkv = _linear(z, self.to_qkv).view(bt, s, 3, self.heads, -1)
        return _linear(temporal_attention(qkv, frames).reshape(bt, s, c),
                       self.to_out)


class TemporalModule(nn.Module):
    """One motion module of width ``width`` (module docstring)."""

    def __init__(self, width: int):
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, width, eps=GROUP_EPS)
        self.proj_in = nn.Linear(width, width)
        self.attention_blocks = nn.ModuleList(
            TemporalAttentionBlock(width, HEADS)
            for _ in range(ATTENTION_BLOCKS))
        self.norms = nn.ModuleList(nn.LayerNorm(width, eps=LN_EPS)
                                   for _ in range(ATTENTION_BLOCKS))
        self.ff_norm = nn.LayerNorm(width, eps=LN_EPS)
        self.ff_proj = nn.Linear(width, 2 * FF_MULT * width)
        self.ff_out = nn.Linear(FF_MULT * width, width)
        self.proj_out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        with debug.span("temporal.module"):
            bt, c, h, w = x.shape
            z = F.group_norm(x.float(), GROUPS, self.norm.weight,
                             self.norm.bias, self.norm.eps).to(x.dtype)
            z = _linear(z.permute(0, 2, 3, 1).reshape(bt, h * w, c),
                        self.proj_in)
            for attn, norm in zip(self.attention_blocks, self.norms):
                z = z + attn(_layer_norm(z, norm), frames)
            hidden, gate = _linear(_layer_norm(z, self.ff_norm),
                                   self.ff_proj).chunk(2, dim=-1)
            z = z + _linear(hidden * F.gelu(gate), self.ff_out)
            z = _linear(z, self.proj_out)
            return x + z.view(bt, h, w, c).permute(0, 3, 1, 2)
