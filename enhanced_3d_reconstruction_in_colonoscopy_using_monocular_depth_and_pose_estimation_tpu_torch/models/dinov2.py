"""DINOv2 ViT encoder (vits/vitb/vitl, patch 14) with DAv2 feature taps.

Module and parameter names are those of the DAv2 ``.pth`` checkpoints
(``pretrained.blocks.{i}.attn.qkv.weight``, ...), so a reference state dict
loads with ``load_state_dict``. Parameters are f32; each module computes in
the dtype of its input (``DinoViT.dtype``, bf16 on the card):

- patch embed: 14x14/14 conv; cls token; learned pos-embed for a 37x37
  grid (518 px), resized for other grids with torch-bicubic semantics;
- pre-LN blocks (eps 1e-6), exact-GELU MLP (ratio 4), LayerScale;
- taps at the DAv2 block indices, each with the final LayerNorm, returned
  as (patch_tokens, cls_token).

Attention goes through ``ops.attention`` (kernel K1 on the card). The
residual stream is never padded: the kernel masks the ragged token edge
itself. The fused-SwiGLU FFN of vitg, token merging and int8 are not
ported yet.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import POLICY_BF16
from ..ops import attention as attn_ops

VIT_ARCHS: dict[str, dict[str, Any]] = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, ffn="swiglu"),
    # tiny config for tests / dry runs (not in the reference)
    "vitt": dict(embed_dim=64, depth=4, num_heads=2),
}

# DAv2 feature-tap indices per encoder size.
INTERMEDIATE_LAYER_IDX: dict[str, list[int]] = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
    "vitt": [0, 1, 2, 3],
}

PATCH_SIZE = 14
POS_GRID = 37  # pretrained pos-embed grid (518 / 14)
LN_EPS = 1e-6


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (f32 params cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm`` applied in x's dtype (statistics in f32 inside torch)."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return attn_ops.qkv_self_attention(
            x, self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias, self.num_heads)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(layer_norm(x, self.norm1)))
        return x + self.ls2(self.mlp(layer_norm(x, self.norm2)))


def _torch_bicubic_matrix(out_size: int, in_size: int,
                          offset: float = 0.1) -> np.ndarray:
    """(out, in) interpolation matrix matching torch ``F.interpolate``
    bicubic with DINOv2's ``interpolate_offset`` semantics: the scale is
    the GIVEN ``(out + offset) / in`` factor (not out/in), cubic kernel
    A = -0.75, ``antialias=False``, edge-clamped taps."""
    a = -0.75
    scale = float(out_size + offset) / in_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        # cubic convolution weights at distances (1+t, t, 1-t, 2-t)
        d = np.array([1.0 + t, t, 1.0 - t, 2.0 - t])
        ad = np.abs(d)
        wt = np.where(
            ad <= 1.0, (a + 2.0) * ad ** 3 - (a + 3.0) * ad ** 2 + 1.0,
            a * ad ** 3 - 5.0 * a * ad ** 2 + 8.0 * a * ad - 4.0 * a)
        for k in range(4):
            j = min(max(i0 - 1 + k, 0), in_size - 1)
            w[i, j] += wt[k]
    return w


@functools.lru_cache(maxsize=64)
def _bicubic_tensor(out_size: int, in_size: int,
                    device: torch.device) -> torch.Tensor:
    """``_torch_bicubic_matrix`` on the device, uploaded once per shape."""
    return torch.from_numpy(_torch_bicubic_matrix(out_size, in_size)).to(
        device)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int,
                          grid_w: int) -> torch.Tensor:
    """Resize the (1, 1+S*S, C) pos-embed to a (grid_h, grid_w) patch grid
    (bicubic on the patch grid in f32, cls slot kept), with the numerics
    of DINOv2's ``interpolate_pos_encoding``."""
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:]
    n = patch_pe.shape[1]
    src = int(round(float(n) ** 0.5))
    if (grid_h, grid_w) == (src, src):
        return pos_embed
    c = patch_pe.shape[-1]
    grid = patch_pe.reshape(src, src, c).float()
    wh = _bicubic_tensor(grid_h, src, grid.device)
    ww = _bicubic_tensor(grid_w, src, grid.device)
    out = torch.einsum("hm,mnc->hnc", wh, grid)
    out = torch.einsum("wn,hnc->hwc", ww, out).to(pos_embed.dtype)
    return torch.cat([cls_pe, out.reshape(1, grid_h * grid_w, c)], dim=1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH_SIZE, stride=PATCH_SIZE)


class DinoViT(nn.Module):
    """DINOv2 ViT trunk exposing DAv2-style intermediate features."""

    def __init__(self, encoder: str = "vitl",
                 dtype: torch.dtype = POLICY_BF16.compute_dtype):
        super().__init__()
        arch = VIT_ARCHS[encoder]
        if arch.get("ffn", "mlp") != "mlp":
            raise NotImplementedError(f"{encoder}: the SwiGLU FFN is not "
                                      "ported yet")
        dim = arch["embed_dim"]
        pos_grid = POS_GRID if encoder != "vitt" else 4
        self.encoder = encoder
        self.dtype = dtype
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        # In the checkpoints; unused at inference.
        self.mask_token = nn.Parameter(torch.zeros(1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid ** 2, dim))
        self.blocks = nn.ModuleList(Block(dim, arch["num_heads"])
                                    for _ in range(arch["depth"]))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, img: torch.Tensor, tap_indices: list[int] | None = None
                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """img: (B, H, W, 3), H/W multiples of 14, already normalized.

        Returns [(patch_tokens (B, N, C), cls_token (B, C)), ...] per tap,
        each with the final LayerNorm applied."""
        taps = tap_indices or INTERMEDIATE_LAYER_IDX[self.encoder]
        b, h, w, _ = img.shape
        gh, gw = h // PATCH_SIZE, w // PATCH_SIZE
        proj = self.patch_embed.proj
        x = F.conv2d(img.permute(0, 3, 1, 2).to(self.dtype),
                     proj.weight.to(self.dtype), proj.bias.to(self.dtype),
                     stride=PATCH_SIZE)
        x = x.flatten(2).transpose(1, 2)                     # (B, N, C)
        cls = self.cls_token.to(self.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, gh, gw).to(self.dtype)

        outputs: dict[int, torch.Tensor] = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in taps:
                outputs[i] = x
        results = []
        for i in taps:
            y = layer_norm(outputs[i], self.norm)
            results.append((y[:, 1:], y[:, 0]))
        return results
