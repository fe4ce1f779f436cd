"""DPT decoder head for metric depth (NCHW inside).

Module names are the DAv2 checkpoint's (``depth_head.projects.{i}``,
``depth_head.resize_layers.{0,1,3}``, ``depth_head.scratch.layer{k}_rn``,
``depth_head.scratch.refinenet{k}``, ``depth_head.scratch.output_conv1``,
``depth_head.scratch.output_conv2.{0,2}``):

- per-tap 1x1 projection to ``out_channels[i]``;
- resize stack: 4x and 2x transposed convs with kernel = stride, identity,
  stride-2 3x3 conv;
- 3x3 no-bias "scratch" convs to the common ``features`` width;
- four RefineNet-style fusion blocks (ResidualConvUnit x2 + 1x1 out conv,
  bilinear align_corners=True upsampling);
- head: 3x3 conv -> bilinear to (14*ph, 14*pw) -> 3x3 conv -> ReLU ->
  1x1 conv -> sigmoid, the last conv and the sigmoid in f32.

Each conv computes in its input's dtype (bf16 on the card) with f32
parameters cast at use. The f32 head conv is written as a matmul: a
float32 cuDNN convolution would run in TF32 by default. The JAX package's
lane-packing of the head (``PackedStride2Conv``/``PackedPointwiseHead``)
only filled TPU lanes; here those are the plain 3x3 and 1x1 convs with
the same parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_align_corners


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer`` applied in x's dtype (f32 params cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding)


def conv_transpose(x: torch.Tensor, layer: nn.ConvTranspose2d
                   ) -> torch.Tensor:
    return F.conv_transpose2d(x, layer.weight.to(x.dtype),
                              layer.bias.to(x.dtype), layer.stride)


def _resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    return resize_align_corners(x, out_hw, channels_last=False)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv(F.relu(x), self.conv1)
        return conv(F.relu(out), self.conv2) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, has_residual: bool = True):
        super().__init__()
        # refinenet4 takes a single input; its resConfUnit1 in the
        # checkpoints is never used, so it is not built.
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, res: torch.Tensor | None = None,
                out_hw: tuple[int, int] | None = None) -> torch.Tensor:
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (2 * x.shape[-2], 2 * x.shape[-1])
        # The JAX package's order: 1x1 out_conv, then the resize (exact
        # in real arithmetic, not in bf16, so the order is kept).
        return _resize(conv(x, self.out_conv), out_hw)


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int]):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"layer{k}_rn",
                    nn.Conv2d(out_channels[k - 1], features, 3, padding=1,
                              bias=False))
            setattr(self, f"refinenet{k}",
                    FeatureFusionBlock(features, has_residual=k != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    def __init__(self, embed_dim: int, features: int,
                 out_channels: Sequence[int]):
        super().__init__()
        oc = list(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(embed_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(features, oc)

    def forward(self, taps: list[tuple[torch.Tensor, torch.Tensor]],
                patch_h: int, patch_w: int) -> torch.Tensor:
        """taps: 4 x (patch_tokens (B, N, C), cls). Returns (B, 14ph, 14pw)
        f32 in [0, 1] (sigmoid)."""
        assert len(taps) == 4
        outs = []
        for i, (tokens, _cls) in enumerate(taps):
            b, _, c = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, c, patch_h, patch_w)
            x = conv(x, self.projects[i])
            layer = self.resize_layers[i]
            if isinstance(layer, nn.ConvTranspose2d):
                x = conv_transpose(x, layer)
            elif isinstance(layer, nn.Conv2d):
                x = conv(x, layer)
            outs.append(x)

        s = self.scratch
        l1, l2, l3, l4 = (conv(x, getattr(s, f"layer{i + 1}_rn"))
                          for i, x in enumerate(outs))
        path4 = s.refinenet4(l4, None, out_hw=tuple(l3.shape[-2:]))
        path3 = s.refinenet3(path4, l3, out_hw=tuple(l2.shape[-2:]))
        path2 = s.refinenet2(path3, l2, out_hw=tuple(l1.shape[-2:]))
        path1 = s.refinenet1(path2, l1)

        out = conv(path1, s.output_conv1)
        out = _resize(out, (patch_h * 14, patch_w * 14))
        out = conv(out, s.output_conv2[0])
        # Final 1x1 conv and sigmoid in f32 (bf16 sigmoid saturation costs
        # depth resolution), as a matmul over channels: no TF32.
        head = s.output_conv2[2]
        z = torch.einsum("bchw,c->bhw", F.relu(out.float()),
                         head.weight[0, :, 0, 0].float())
        return torch.sigmoid(z + head.bias[0].float())
