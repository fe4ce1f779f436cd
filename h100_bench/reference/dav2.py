"""Plain float32 Depth-Anything-V2 metric depth: the benchmark's reference.

It follows DAv2's ``metric_depth/depth_anything_v2`` (``dpt.py``,
``dinov2.py``, ``util/blocks.py``) as plain ``torch`` operations on a
state dict in DAv2's layout, with no kernel, cache or batching of the
program under test, and imports nothing of it:

- preprocessing: uint8 BGR -> RGB / 255, an aspect-preserving resize to
  the lower-bound multiple of 14 (DAv2's ``image2tensor``), ImageNet
  normalisation;
- DINOv2: 14 x 14 patch conv, cls token, pos-embed resized with DINOv2's
  ``interpolate_offset`` 0.1 bicubic, pre-LN blocks (eps 1e-6) with
  LayerScale and an exact-GELU MLP or the fused SwiGLU FFN, the taps of
  ``intermediate_layer_idx`` through the final norm;
- DPT: projections, the resize stack, the scratch convs, four fusion
  blocks, the head's align-corners upsample, the last conv and the
  sigmoid, times ``max_depth``;
- the depth map back to the frame's size, bilinear with aligned corners.

Departures from DAv2's code, each the served path's definition:
the preprocessing resize is the antialiased bicubic of PIL (as
``torchvision``'s ``Resize(antialias=True)``), not ``cv2.INTER_CUBIC``;
the map goes back to frame size with aligned corners, not cv2's
``INTER_LINEAR``. ``refinenet4.resConfUnit1`` is in the state dict and
unused, as in DAv2.

Every product runs in float32 with TF32 off. ``fp8=True`` is the control,
the step below the served and trained bf16: each operand of every matrix
product and convolution (weights, activations, the attention scores'
operands and probabilities) is rounded to float8 e4m3 with a per-tensor
scale first, and in a backward each product's output gradient to float8
e5m2, as float8 training does.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0
E5M2_MAX = 57344.0


def lower_bound_hw(h: int, w: int, target: int = 518,
                   multiple: int = 14) -> tuple[int, int]:
    """DAv2 ``Resize(keep_aspect_ratio=True, ensure_multiple_of=14,
    resize_method='lower_bound')``: the scale that brings the shorter side
    to ``target``, each side rounded to a multiple of 14 and never below
    ``target``."""
    scale = max(target / h, target / w)

    def side(x: float) -> int:
        y = int(np.round(x / multiple) * multiple)
        if y < target:
            y = int(math.ceil(x / multiple) * multiple)
        return y

    return side(h * scale), side(w * scale)


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` through the float8 ``dtype`` and back, scaled per tensor so
    that its largest magnitude lands on the format's largest, ``top``."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product in float8 e4m3. The gradient passes through
    (straight through); the product's own output gradient is rounded by
    ``_GradE5M2``."""
    with torch.no_grad():
        rounded = _round(x, torch.float8_e4m3fn, FP8_MAX)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to float8 e5m2
    (the usual format of float8 training's gradients)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def _grad_e5m2(x: torch.Tensor) -> torch.Tensor:
    return _GradE5M2.apply(x) if x.requires_grad else x


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class DAv2:
    """The reference model of one configuration over one state dict."""

    def __init__(self, cfg: dict, state: dict[str, torch.Tensor],
                 fp8: bool = False):
        self.cfg = cfg
        self.sd = {k: v.float() for k, v in state.items()}
        self.q = fp8_round if fp8 else _ident
        self.g = _grad_e5m2 if fp8 else _ident

    # ---------------------------------------------------------- products

    def _linear(self, x, name, bias=True):
        q = self.q
        b = self.sd[name + ".bias"] if bias else None
        return self.g(F.linear(q(x), q(self.sd[name + ".weight"]), b))

    def _conv(self, x, name, stride=1, padding=0, bias=True):
        q = self.q
        b = self.sd.get(name + ".bias") if bias else None
        return self.g(F.conv2d(q(x), q(self.sd[name + ".weight"]), b, stride,
                               padding))

    def _conv_t(self, x, name, stride):
        q = self.q
        return self.g(F.conv_transpose2d(q(x), q(self.sd[name + ".weight"]),
                                         self.sd[name + ".bias"], stride))

    def _ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.sd[name + ".weight"],
                            self.sd[name + ".bias"], self.cfg["ln_eps"])

    # ----------------------------------------------------------- encoder

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.sd["pretrained.pos_embed"]
        m = self.cfg["pos_grid"]
        if (gh, gw) == (m, m):
            return pos
        c = pos.shape[-1]
        grid = pos[:, 1:].reshape(1, m, m, c).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((gh + 0.1) / m,
                                                 (gw + 0.1) / m),
                             mode="bicubic", antialias=False)
        if tuple(grid.shape[-2:]) != (gh, gw):
            raise AssertionError(f"pos-embed grid {tuple(grid.shape)}")
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, c)
        return torch.cat([pos[:, :1], grid], dim=1)

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        cfg, q = self.cfg, self.q
        p = f"pretrained.blocks.{i}."
        b, n, c = x.shape
        heads = cfg["num_heads"]
        hd = c // heads
        h = self._ln(x, p + "norm1")
        qkv = self._linear(h, p + "attn.qkv").reshape(b, n, 3, heads, hd)
        qh, kh, vh = qkv.permute(2, 0, 3, 1, 4)
        att = torch.softmax(self.g(q(qh) @ q(kh).transpose(-1, -2))
                            * hd ** -0.5, dim=-1)
        o = self.g(q(att) @ q(vh)).transpose(1, 2).reshape(b, n, c)
        x = x + self.sd[p + "ls1.gamma"] * self._linear(o, p + "attn.proj")
        h = self._ln(x, p + "norm2")
        if cfg["ffn"] == "swiglu":
            x1, x2 = self._linear(h, p + "mlp.w12").chunk(2, dim=-1)
            h = self._linear(F.silu(x1) * x2, p + "mlp.w3")
        else:
            h = self._linear(F.gelu(self._linear(h, p + "mlp.fc1")),
                             p + "mlp.fc2")
        return x + self.sd[p + "ls2.gamma"] * h

    def encoder(self, img: torch.Tensor) -> list[torch.Tensor]:
        """img (B, 3, H, W) normalised -> the tapped patch tokens
        (B, N, C), each through the final norm."""
        b, _, hh, ww = img.shape
        ps = self.cfg["patch_size"]
        x = self._conv(img, "pretrained.patch_embed.proj", stride=ps)
        x = x.flatten(2).transpose(1, 2)
        cls = self.sd["pretrained.cls_token"].expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self._pos_embed(hh // ps, ww // ps)
        taps = []
        for i in range(self.cfg["depth"]):
            x = self._block(x, i)
            if i in self.cfg["intermediate_layer_idx"]:
                taps.append(self._ln(x, "pretrained.norm")[:, 1:])
        return taps

    # ----------------------------------------------------------- decoder

    def _rcu(self, x, name):
        out = self._conv(F.relu(x), name + ".conv1", padding=1)
        return self._conv(F.relu(out), name + ".conv2", padding=1) + x

    def _fusion(self, k, x, res=None, size=None):
        r = f"depth_head.scratch.refinenet{k}"
        if res is not None:
            x = x + self._rcu(res, r + ".resConfUnit1")
        x = self._rcu(x, r + ".resConfUnit2")
        if size is None:
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=True)
        else:
            x = F.interpolate(x, size=size, mode="bilinear",
                              align_corners=True)
        return self._conv(x, r + ".out_conv")

    def decoder(self, taps: list[torch.Tensor], ph: int, pw: int
                ) -> torch.Tensor:
        """The DPT head: tapped tokens -> depth (B, 14 ph, 14 pw)."""
        h = "depth_head."
        outs = []
        for i, tok in enumerate(taps):
            b, _, c = tok.shape
            x = tok.permute(0, 2, 1).reshape(b, c, ph, pw)
            x = self._conv(x, f"{h}projects.{i}")
            if i == 0:
                x = self._conv_t(x, h + "resize_layers.0", 4)
            elif i == 1:
                x = self._conv_t(x, h + "resize_layers.1", 2)
            elif i == 3:
                x = self._conv(x, h + "resize_layers.3", stride=2, padding=1)
            outs.append(x)
        s = h + "scratch."
        l1, l2, l3, l4 = (self._conv(x, f"{s}layer{k + 1}_rn", padding=1,
                                     bias=False)
                          for k, x in enumerate(outs))
        p4 = self._fusion(4, l4, size=l3.shape[-2:])
        p3 = self._fusion(3, p4, l3, size=l2.shape[-2:])
        p2 = self._fusion(2, p3, l2, size=l1.shape[-2:])
        p1 = self._fusion(1, p2, l1)
        out = self._conv(p1, s + "output_conv1", padding=1)
        out = F.interpolate(out, size=(ph * 14, pw * 14), mode="bilinear",
                            align_corners=True)
        out = F.relu(self._conv(out, s + "output_conv2.0", padding=1))
        out = torch.sigmoid(self._conv(out, s + "output_conv2.2"))
        return out[:, 0] * self.cfg["max_depth"]

    def depth(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised (B, 3, H, W) -> depth (B, H, W) at the network's
        size, differentiable in the state's tensors."""
        ps = self.cfg["patch_size"]
        _, _, hh, ww = x.shape
        return self.decoder(self.encoder(x), hh // ps, ww // ps)

    # ----------------------------------------------------------- served

    @torch.no_grad()
    def depth_of_frames(self, bgr_u8: torch.Tensor,
                        input_size: int = 518) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR frames -> (B, H, W) float32 depth in
        metres, the served path's whole definition."""
        with exact_f32():
            _, fh, fw, _ = bgr_u8.shape
            nh, nw = lower_bound_hw(fh, fw, input_size,
                                    self.cfg["patch_size"])
            rgb = bgr_u8.flip(-1).float().div(255.0).permute(0, 3, 1, 2)
            x = F.interpolate(rgb, size=(nh, nw), mode="bicubic",
                              antialias=True, align_corners=False)
            mean = torch.tensor(IMAGENET_MEAN, device=x.device)
            std = torch.tensor(IMAGENET_STD, device=x.device)
            x = (x - mean[:, None, None]) / std[:, None, None]
            depth = self.depth(x)
            return F.interpolate(depth[:, None], size=(fh, fw),
                                 mode="bilinear", align_corners=True)[:, 0]
