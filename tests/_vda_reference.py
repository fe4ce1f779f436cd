"""Plain PyTorch Video Depth Anything for the CPU tests: the published
model (``video_depth_anything/video_depth.py``, ``dpt_temporal.py``,
``motion_module/``) and its ``infer_video_depth`` windowing, written from
them on a state dict in the published key layout, in float32. It imports
neither the port nor JAX, so the port is held to an independent version.

- ``random_state(cfg, seed)``: every key of a VDA checkpoint of ``cfg``'s
  sizes (``head.motion_modules.<i>.temporal_transformer...``, ``to_q``,
  ``to_k``, ``to_v`` apart, the ``pos_encoder.pe`` buffers), seeded;
- ``VDA(cfg, state)``: ``clip`` (T, h, w, 3) normalised -> (T, h, w)
  relative disparity; ``temporal`` one motion module;
- ``preprocess``: uint8 BGR frames -> the network's normalised input
  (antialiased bicubic to the lower-bound multiple of 14);
- ``infer_video``: a list of frames -> their final aligned maps at frame
  size, VDA's windows of 32 advancing by 22, keyframes carried, the last
  window padded, least-squares alignment, the 8-frame blend.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

WINDOW, OVERLAP, INTERP = 32, 10, 8
KEYFRAMES = [0, 12, 24, 25, 26, 27, 28, 29, 30, 31]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# A small geometry: vitt's trunk, head widths where the motion modules
# run at 64 (layer_3, layer_4) and 32 (path_4, path_3).
TINY = dict(embed_dim=64, depth=4, heads=2, taps=[0, 1, 2, 3], pos_grid=4,
            features=32, out_channels=[16, 32, 64, 64], temporal_heads=8)


def _motion_keys(i: int, c: int) -> list[tuple[str, tuple]]:
    p = f"head.motion_modules.{i}.temporal_transformer."
    b = p + "transformer_blocks.0."
    out = [(p + "norm.weight", (c,)), (p + "norm.bias", (c,)),
           (p + "proj_in.weight", (c, c)), (p + "proj_in.bias", (c,))]
    for j in range(2):
        a = f"{b}attention_blocks.{j}."
        out += [(a + "to_q.weight", (c, c)), (a + "to_k.weight", (c, c)),
                (a + "to_v.weight", (c, c)), (a + "to_out.0.weight", (c, c)),
                (a + "to_out.0.bias", (c,)),
                (a + "pos_encoder.pe", (1, WINDOW, c)),
                (f"{b}norms.{j}.weight", (c,)), (f"{b}norms.{j}.bias", (c,))]
    out += [(b + "ff.net.0.proj.weight", (8 * c, c)),
            (b + "ff.net.0.proj.bias", (8 * c,)),
            (b + "ff.net.2.weight", (c, 4 * c)), (b + "ff.net.2.bias", (c,)),
            (b + "ff_norm.weight", (c,)), (b + "ff_norm.bias", (c,)),
            (p + "proj_out.weight", (c, c)), (p + "proj_out.bias", (c,))]
    return out


def layout(cfg: dict) -> list[tuple[str, tuple]]:
    """(key, shape) of every tensor of a VDA checkpoint of ``cfg``."""
    c, g, f = cfg["embed_dim"], cfg["pos_grid"], cfg["features"]
    oc = cfg["out_channels"]
    t = "pretrained."
    out = [(t + "cls_token", (1, 1, c)), (t + "mask_token", (1, c)),
           (t + "pos_embed", (1, 1 + g * g, c)),
           (t + "patch_embed.proj.weight", (c, 3, 14, 14)),
           (t + "patch_embed.proj.bias", (c,))]
    for i in range(cfg["depth"]):
        b = f"{t}blocks.{i}."
        out += [(b + "norm1.weight", (c,)), (b + "norm1.bias", (c,)),
                (b + "attn.qkv.weight", (3 * c, c)), (b + "attn.qkv.bias", (3 * c,)),
                (b + "attn.proj.weight", (c, c)), (b + "attn.proj.bias", (c,)),
                (b + "ls1.gamma", (c,)), (b + "norm2.weight", (c,)),
                (b + "norm2.bias", (c,)), (b + "mlp.fc1.weight", (4 * c, c)),
                (b + "mlp.fc1.bias", (4 * c,)), (b + "mlp.fc2.weight", (c, 4 * c)),
                (b + "mlp.fc2.bias", (c,)), (b + "ls2.gamma", (c,))]
    out += [(t + "norm.weight", (c,)), (t + "norm.bias", (c,))]
    h = "head."
    for i, o in enumerate(oc):
        out += [(f"{h}projects.{i}.weight", (o, c, 1, 1)),
                (f"{h}projects.{i}.bias", (o,))]
    out += [(h + "resize_layers.0.weight", (oc[0], oc[0], 4, 4)),
            (h + "resize_layers.0.bias", (oc[0],)),
            (h + "resize_layers.1.weight", (oc[1], oc[1], 2, 2)),
            (h + "resize_layers.1.bias", (oc[1],)),
            (h + "resize_layers.3.weight", (oc[3], oc[3], 3, 3)),
            (h + "resize_layers.3.bias", (oc[3],))]
    s = h + "scratch."
    for k in range(1, 5):
        out.append((f"{s}layer{k}_rn.weight", (f, oc[k - 1], 3, 3)))
    for k in range(1, 5):
        r = f"{s}refinenet{k}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                out += [(f"{r}{unit}.{conv}.weight", (f, f, 3, 3)),
                        (f"{r}{unit}.{conv}.bias", (f,))]
        out += [(r + "out_conv.weight", (f, f, 1, 1)), (r + "out_conv.bias", (f,))]
    out += [(s + "output_conv1.weight", (f // 2, f, 3, 3)),
            (s + "output_conv1.bias", (f // 2,)),
            (s + "output_conv2.0.weight", (32, f // 2, 3, 3)),
            (s + "output_conv2.0.bias", (32,)),
            (s + "output_conv2.2.weight", (1, 32, 1, 1)),
            (s + "output_conv2.2.bias", (1,))]
    for i, w in enumerate((oc[2], oc[3], f, f)):
        out += _motion_keys(i, w)
    return out


def sinusoid(frames: int, width: int) -> torch.Tensor:
    pos = torch.arange(frames).unsqueeze(1)
    div = torch.exp(torch.arange(0, width, 2) * (-math.log(10000.0) / width))
    pe = torch.zeros(1, frames, width)
    pe[0, :, 0::2] = torch.sin(pos * div)
    pe[0, :, 1::2] = torch.cos(pos * div)
    return pe


def random_state(cfg: dict, seed: int) -> dict[str, torch.Tensor]:
    """Seeded weights in the published layout: matrices and kernels
    LeCun-normal, biases and tokens N(0, 0.02), norm scales and
    LayerScales near 1, ``pe`` the sinusoid."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, shape in layout(cfg):
        if key.endswith("pos_encoder.pe"):
            state[key] = sinusoid(shape[1], shape[2])
        elif key.endswith("gamma") or (key.endswith(".weight")
                                       and len(shape) == 1):
            state[key] = 1 + 0.1 * torch.randn(shape, generator=gen)
        elif len(shape) >= 2 and key.endswith("weight"):
            fan_in = (shape[0] * shape[2] * shape[3]
                      if "resize_layers.0" in key or "resize_layers.1" in key
                      else math.prod(shape[1:]))
            state[key] = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        else:
            state[key] = 0.02 * torch.randn(shape, generator=gen)
    return state


class VDA:
    """The plain model over a published-layout ``state``."""

    def __init__(self, cfg: dict, state: dict[str, torch.Tensor]):
        self.cfg = cfg
        self.sd = {k: v.float() for k, v in state.items()}

    def _lin(self, x, name, bias=True):
        return F.linear(x, self.sd[name + ".weight"],
                        self.sd[name + ".bias"] if bias else None)

    def _conv(self, x, name, stride=1, padding=0):
        return F.conv2d(x, self.sd[name + ".weight"],
                        self.sd.get(name + ".bias"), stride, padding)

    def _ln(self, x, name, eps):
        return F.layer_norm(x, (x.shape[-1],), self.sd[name + ".weight"],
                            self.sd[name + ".bias"], eps)

    def encoder(self, x):
        """x (B, 3, H, W) -> the tapped patch tokens through the norm."""
        cfg = self.cfg
        b, _, hh, ww = x.shape
        gh, gw = hh // 14, ww // 14
        t = "pretrained."
        x = self._conv(x, t + "patch_embed.proj", stride=14)
        x = x.flatten(2).transpose(1, 2)
        c = x.shape[-1]
        pos = self.sd[t + "pos_embed"]
        m = cfg["pos_grid"]
        grid = pos[:, 1:].reshape(1, m, m, c).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((gh + 0.1) / m,
                                                 (gw + 0.1) / m),
                             mode="bicubic", antialias=False)
        pe = torch.cat([pos[:, :1],
                        grid.permute(0, 2, 3, 1).reshape(1, gh * gw, c)], 1)
        x = torch.cat([self.sd[t + "cls_token"].expand(b, 1, c), x], 1) + pe
        heads = cfg["heads"]
        taps = []
        for i in range(cfg["depth"]):
            p = f"{t}blocks.{i}."
            n = x.shape[1]
            qkv = self._lin(self._ln(x, p + "norm1", 1e-6), p + "attn.qkv")
            q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v)
            o = o.transpose(1, 2).reshape(b, n, c)
            x = x + self.sd[p + "ls1.gamma"] * self._lin(o, p + "attn.proj")
            h = F.gelu(self._lin(self._ln(x, p + "norm2", 1e-6), p + "mlp.fc1"))
            x = x + self.sd[p + "ls2.gamma"] * self._lin(h, p + "mlp.fc2")
            if i in cfg["taps"]:
                taps.append(self._ln(x, t + "norm", 1e-6)[:, 1:])
        return taps

    def temporal(self, x, i: int, frames: int):
        """Motion module ``i`` on x (B*T, C, h, w): VDA's
        ``TemporalTransformer3DModel``, step by step."""
        p = f"head.motion_modules.{i}.temporal_transformer."
        b = p + "transformer_blocks.0."
        bt, c, h, w = x.shape
        heads = self.cfg["temporal_heads"]
        z = F.group_norm(x, 32, self.sd[p + "norm.weight"],
                         self.sd[p + "norm.bias"], 1e-6)
        z = self._lin(z.permute(0, 2, 3, 1).reshape(bt, h * w, c),
                      p + "proj_in")
        for j in range(2):
            a = f"{b}attention_blocks.{j}."
            y = self._ln(z, f"{b}norms.{j}", 1e-5)
            # "(b f) d c -> (b d) f c", then the encoding over frames
            y = y.reshape(bt // frames, frames, h * w, c).transpose(1, 2)
            y = y.reshape(-1, frames, c) + self.sd[a + "pos_encoder.pe"][:, :frames]
            q, k, v = (self._lin(y, a + n, bias=False).reshape(
                y.shape[0], frames, heads, -1).transpose(1, 2)
                for n in ("to_q", "to_k", "to_v"))
            o = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]),
                              dim=-1) @ v
            o = self._lin(o.transpose(1, 2).reshape(-1, frames, c),
                          a + "to_out.0")
            o = o.reshape(bt // frames, h * w, frames, c).transpose(1, 2)
            z = z + o.reshape(bt, h * w, c)
        y = self._lin(self._ln(z, b + "ff_norm", 1e-5), b + "ff.net.0.proj")
        hid, gate = y.chunk(2, dim=-1)
        z = z + self._lin(hid * F.gelu(gate), b + "ff.net.2")
        z = self._lin(z, p + "proj_out")
        return x + z.reshape(bt, h, w, c).permute(0, 3, 1, 2)

    def _rcu(self, x, name):
        out = self._conv(F.relu(x), name + ".conv1", padding=1)
        return self._conv(F.relu(out), name + ".conv2", padding=1) + x

    def _fusion(self, k, x, res=None, size=None):
        r = f"head.scratch.refinenet{k}"
        if res is not None:
            x = x + self._rcu(res, r + ".resConfUnit1")
        x = self._rcu(x, r + ".resConfUnit2")
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True) if size is None else \
            F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self._conv(x, r + ".out_conv")

    def clip(self, x):
        """x (T, h, w, 3) normalised -> (T, h, w) relative disparity."""
        frames, hh, ww, _ = x.shape
        ph, pw = hh // 14, ww // 14
        taps = self.encoder(x.permute(0, 3, 1, 2))
        outs = []
        for i, tok in enumerate(taps):
            y = tok.transpose(1, 2).reshape(frames, -1, ph, pw)
            y = self._conv(y, f"head.projects.{i}")
            if i in (0, 1):
                y = F.conv_transpose2d(y, self.sd[f"head.resize_layers.{i}.weight"],
                                       self.sd[f"head.resize_layers.{i}.bias"],
                                       4 // (i + 1))
            elif i == 3:
                y = self._conv(y, "head.resize_layers.3", 2, 1)
            outs.append(y)
        outs[2] = self.temporal(outs[2], 0, frames)
        outs[3] = self.temporal(outs[3], 1, frames)
        l1, l2, l3, l4 = (F.conv2d(y, self.sd[f"head.scratch.layer{k + 1}_rn.weight"],
                                   None, 1, 1) for k, y in enumerate(outs))
        p4 = self.temporal(self._fusion(4, l4, size=l3.shape[-2:]), 2, frames)
        p3 = self.temporal(self._fusion(3, p4, l3, size=l2.shape[-2:]), 3,
                           frames)
        p2 = self._fusion(2, p3, l2, size=l1.shape[-2:])
        p1 = self._fusion(1, p2, l1)
        out = self._conv(p1, "head.scratch.output_conv1", padding=1)
        out = F.interpolate(out, size=(hh, ww), mode="bilinear",
                            align_corners=True)
        out = F.relu(self._conv(out, "head.scratch.output_conv2.0", padding=1))
        out = F.relu(self._conv(out, "head.scratch.output_conv2.2"))
        return F.relu(out)[:, 0]


def net_hw(h: int, w: int, size: int) -> tuple[int, int]:
    """DAv2's lower-bound resize to multiples of 14."""
    scale = max(size / h, size / w)

    def side(x):
        y = int(np.round(x / 14) * 14)
        return y if y >= size else int(math.ceil(x / 14) * 14)

    return side(h * scale), side(w * scale)


def preprocess(bgr: torch.Tensor, size: int) -> torch.Tensor:
    """(n, H, W, 3) uint8 BGR -> (n, h, w, 3) normalised network input."""
    hh, ww = net_hw(bgr.shape[1], bgr.shape[2], size)
    x = bgr.flip(-1).float().div(255.0).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(hh, ww), mode="bicubic", antialias=True,
                      align_corners=False)
    x = (x - torch.tensor(MEAN)[:, None, None]) / torch.tensor(STD)[:, None, None]
    return x.permute(0, 2, 3, 1)


def scale_shift(pred: np.ndarray, target: np.ndarray) -> tuple[float, float]:
    """VDA's ``compute_scale_and_shift_full`` with a mask of ones, in f64."""
    p, g = pred.astype(np.float64).ravel(), target.astype(np.float64).ravel()
    a00, a01, a11 = (p * p).sum(), p.sum(), float(p.size)
    b0, b1 = (p * g).sum(), g.sum()
    det = a00 * a11 - a01 * a01
    if det == 0:
        return 1.0, 0.0
    return (a11 * b0 - a01 * b1) / det, (-a01 * b0 + a00 * b1) / det


def infer_video(model: VDA, frames: list[np.ndarray], size: int
                ) -> list[np.ndarray]:
    """VDA's ``infer_video_depth`` on uint8 BGR ``frames``: their final
    maps at frame size, f32."""
    fh, fw = frames[0].shape[:2]
    step = WINDOW - OVERLAP
    n = len(frames)
    padded = frames + [frames[-1]] * ((step - n % step) % step + OVERLAP)
    raw, pre = [], None
    with torch.no_grad():
        for start in range(0, n, step):
            x = preprocess(torch.from_numpy(np.stack(
                padded[start:start + WINDOW])), size)
            if pre is not None:
                x[:OVERLAP] = pre[KEYFRAMES]
            disp = model.clip(x)
            maps = F.interpolate(disp[:, None], size=(fh, fw),
                                 mode="bilinear", align_corners=True)[:, 0]
            raw += list(maps.numpy())
            pre = x
    aligned, ref = [], []
    for start in range(0, len(raw), WINDOW):
        if not aligned:
            aligned += raw[:WINDOW]
            ref = [raw[0], raw[12]]
            continue
        s, t = scale_shift(np.stack(raw[start:start + 2]), np.stack(ref))
        fix = [np.maximum(raw[start + i] * np.float32(s) + np.float32(t), 0)
               for i in range(WINDOW)]
        for i in range(INTERP):
            w = np.float32(i / (INTERP - 1))
            aligned[-INTERP + i] = aligned[-INTERP + i] * (1 - w) + fix[2 + i] * w
        aligned += fix[OVERLAP:]
        ref = [ref[0], fix[12]]
    return aligned[:n]
