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

``temporal=True`` makes it Video Depth Anything's ``DPTHeadTemporal``:
four motion modules (``models/temporal.py``, ``depth_head.motion_modules
.{0..3}``) after the reassembled ``layer_3`` and ``layer_4`` (widths
``out_channels[2]`` and ``[3]``) and after ``refinenet4`` and
``refinenet3`` (width ``features``). The head runs on the B*T frames of
B clips of ``frames`` consecutive frames; only the modules regroup them
by clip. ``output="relu"`` ends in VDA's ReLU (a relative disparity)
instead of the sigmoid. Without motion modules the head issues the same
op calls as the DAv2 head.

Each conv computes in its input's dtype (bf16 on the card) with f32
parameters cast at use. The f32 head conv is written as a matmul: a
float32 cuDNN convolution would run in TF32 by default. The JAX package's
lane-packing of the head (``PackedStride2Conv``/``PackedPointwiseHead``)
only filled TPU lanes; here those are the plain 3x3 and 1x1 convs with
the same parameters.

``quant`` (the int8 dial, a build-time field) runs a convolution in W8A8
(``ops/quant.py::int8_conv``) when both its channel widths are at least
128, the JAX package's ``QConv`` gate: the projections, the stride-2
resize, the scratch convs, the fusion blocks' convs and ``output_conv1``.
The transposed convs and the head's last two convs stay in x's dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import int8_conv
from ..ops.resize import resize_align_corners
from .temporal import TemporalModule


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer`` applied in x's dtype (f32 params cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding)


def qconv(x: torch.Tensor, layer: nn.Conv2d, quant: bool) -> torch.Tensor:
    """``conv``, in W8A8 when ``quant`` and both widths are >= 128."""
    if quant and min(layer.in_channels, layer.out_channels) >= 128:
        return int8_conv(x, layer.weight, layer.bias, layer.stride[0],
                         layer.padding[0])
    return conv(x, layer)


def conv_transpose(x: torch.Tensor, layer: nn.ConvTranspose2d
                   ) -> torch.Tensor:
    return F.conv_transpose2d(x, layer.weight.to(x.dtype),
                              layer.bias.to(x.dtype), layer.stride)


def _resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    return resize_align_corners(x, out_hw, channels_last=False)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, quant: bool = False):
        super().__init__()
        self.quant = quant
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = qconv(F.relu(x), self.conv1, self.quant)
        return qconv(F.relu(out), self.conv2, self.quant) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, has_residual: bool = True,
                 quant: bool = False):
        super().__init__()
        self.quant = quant
        # refinenet4 takes a single input; its resConfUnit1 in the
        # checkpoints is never used, so it is not built.
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features, quant)
        self.resConfUnit2 = ResidualConvUnit(features, quant)
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
        return _resize(qconv(x, self.out_conv, self.quant), out_hw)


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int],
                 quant: bool = False):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"layer{k}_rn",
                    nn.Conv2d(out_channels[k - 1], features, 3, padding=1,
                              bias=False))
            setattr(self, f"refinenet{k}",
                    FeatureFusionBlock(features, k != 4, quant))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    def __init__(self, embed_dim: int, features: int,
                 out_channels: Sequence[int], quant: bool = False,
                 temporal: bool = False, output: str = "sigmoid"):
        super().__init__()
        if output not in ("sigmoid", "relu"):
            raise ValueError(f"DPTHead output {output!r}; expected "
                             "'sigmoid' or 'relu'")
        self.quant = quant
        self.output = output
        oc = list(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(embed_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(features, oc, quant)
        self.motion_modules = (nn.ModuleList(
            TemporalModule(c) for c in (oc[2], oc[3], features, features))
            if temporal else None)

    def forward(self, taps: list[tuple[torch.Tensor, torch.Tensor]],
                patch_h: int, patch_w: int, frames: int = 1
                ) -> torch.Tensor:
        """taps: 4 x (patch_tokens (B, N, C), cls). Returns (B, 14ph, 14pw)
        f32: in [0, 1] (sigmoid) or >= 0 (relu). With motion modules, B is
        a whole number of clips of ``frames`` consecutive frames."""
        assert len(taps) == 4
        mm = self.motion_modules
        outs = []
        for i, (tokens, _cls) in enumerate(taps):
            b, _, c = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, c, patch_h, patch_w)
            x = qconv(x, self.projects[i], self.quant)
            layer = self.resize_layers[i]
            if isinstance(layer, nn.ConvTranspose2d):
                x = conv_transpose(x, layer)
            elif isinstance(layer, nn.Conv2d):
                x = qconv(x, layer, self.quant)
            outs.append(x)
        if mm is not None:
            outs[2] = mm[0](outs[2], frames)
            outs[3] = mm[1](outs[3], frames)

        s = self.scratch
        l1, l2, l3, l4 = (qconv(x, getattr(s, f"layer{i + 1}_rn"),
                                self.quant) for i, x in enumerate(outs))
        path4 = s.refinenet4(l4, None, out_hw=tuple(l3.shape[-2:]))
        if mm is not None:
            path4 = mm[2](path4, frames)
        path3 = s.refinenet3(path4, l3, out_hw=tuple(l2.shape[-2:]))
        if mm is not None:
            path3 = mm[3](path3, frames)
        path2 = s.refinenet2(path3, l2, out_hw=tuple(l1.shape[-2:]))
        path1 = s.refinenet1(path2, l1)

        out = qconv(path1, s.output_conv1, self.quant)
        out = _resize(out, (patch_h * 14, patch_w * 14))
        out = conv(out, s.output_conv2[0])
        # Final 1x1 conv and sigmoid (or ReLU) in f32 (bf16 sigmoid
        # saturation costs depth resolution), as a matmul over channels:
        # no TF32.
        head = s.output_conv2[2]
        z = torch.einsum("bchw,c->bhw", F.relu(out.float()),
                         head.weight[0, :, 0, 0].float())
        z = z + head.bias[0].float()
        return torch.sigmoid(z) if self.output == "sigmoid" else F.relu(z)
