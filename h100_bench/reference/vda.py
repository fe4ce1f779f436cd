"""Plain float32 Video Depth Anything: the benchmark's reference for the
video cells.

It follows VDA's ``video_depth_anything/video_depth.py``
(``VideoDepthAnything.forward`` and ``infer_video_depth``),
``dpt_temporal.py`` and ``motion_module/`` as plain ``torch`` operations on
a state dict in VDA's published layout (``weights_vda.py``), and builds on
``dav2.py``: its encoder, its decoder's pieces (projections, resize stack,
scratch convs, fusion blocks, products), its preprocessing and its float8
control, which this file imports and does not change. It imports nothing
of the program under test.

- The head is DAv2's with VDA's four motion modules, after the
  reassembled ``layer_3`` and ``layer_4`` and after ``refinenet4`` and
  ``refinenet3``: GroupNorm (32, eps 1e-6), ``proj_in``, two attention
  blocks over the clip's frames (pre-LayerNorm eps 1e-5, the sinusoidal
  encoding of the frame added, 8 heads, ``to_q``/``to_k``/``to_v``
  without bias, ``to_out``), a GEGLU feed-forward, ``proj_out``, the
  residual; the output a ReLU, with no ``max_depth``.
- ``infer_video``: windows of 32 advancing by 22, positions 0-9 of each
  later window the previous window's inputs at [0, 12, 24 ... 31], the
  last window padded with copies of the last frame, each later window
  aligned by VDA's least-squares scale and shift (sums in float64) from
  its positions 0 and 1 to the stored keyframe maps and clamped at 0,
  its positions 2-9 blended into the previous window's last 8 aligned
  maps with weights i / 7; maps at frame size, bilinear with aligned
  corners.

Every product runs in float32 with TF32 off (``dav2.exact_f32``), the
encoder and the head's per-frame parts in chunks of ``chunk`` frames so
that a 32-frame window at 518 x 644 fits. ``fp8=True`` is ``dav2``'s
control: every product's operands, the temporal modules' included,
rounded to float8 e4m3 with a per-tensor scale.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dav2 import DAv2, IMAGENET_MEAN, IMAGENET_STD, exact_f32, lower_bound_hw

WINDOW = 32
OVERLAP = 10
INTERP = 8
KEYFRAMES = [0, 12] + list(range(WINDOW - INTERP, WINDOW))


def sinusoid(frames: int, width: int, device) -> torch.Tensor:
    """VDA's ``PositionalEncoding`` table, (frames, width)."""
    pos = torch.arange(frames, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, width, 2, device=device,
                                 dtype=torch.float32)
                    * (-math.log(10000.0) / width))
    pe = torch.zeros(frames, width, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class VDA(DAv2):
    """The reference VDA of one configuration over a published-layout
    state dict (``head.`` read as DAv2's ``depth_head.``)."""

    def __init__(self, cfg: dict, state: dict[str, torch.Tensor],
                 fp8: bool = False, chunk: int = 8):
        renamed = {("depth_head." + k[len("head."):]
                    if k.startswith("head.") else k): v
                   for k, v in state.items()}
        super().__init__(cfg, renamed, fp8)
        self.chunk = chunk

    def _chunks(self, fn, *xs):
        """``fn`` over frame chunks of ``xs``, concatenated."""
        n = xs[0].shape[0]
        return torch.cat([fn(*(x[i:i + self.chunk] for x in xs))
                          for i in range(0, n, self.chunk)])

    # ------------------------------------------------------------ temporal

    def temporal(self, x: torch.Tensor, i: int, frames: int) -> torch.Tensor:
        """Motion module ``i`` on x (B*T, C, h, w)."""
        p = f"depth_head.motion_modules.{i}.temporal_transformer."
        b = p + "transformer_blocks.0."
        q = self.q
        bt, c, h, w = x.shape
        heads = self.cfg["temporal"]["heads"]
        z = F.group_norm(x, 32, self.sd[p + "norm.weight"],
                         self.sd[p + "norm.bias"], 1e-6)
        z = self._linear(z.permute(0, 2, 3, 1).reshape(bt, h * w, c),
                         p + "proj_in")
        pe = sinusoid(frames, c, x.device)
        for j in range(2):
            a = f"{b}attention_blocks.{j}."
            y = F.layer_norm(z, (c,), self.sd[f"{b}norms.{j}.weight"],
                             self.sd[f"{b}norms.{j}.bias"], 1e-5)
            y = y.reshape(bt // frames, frames, h * w, c).transpose(1, 2)
            y = y.reshape(-1, frames, c) + pe
            qh, kh, vh = (self._linear(y, a + n, bias=False).reshape(
                y.shape[0], frames, heads, -1).transpose(1, 2)
                for n in ("to_q", "to_k", "to_v"))
            att = torch.softmax(self.g(q(qh) @ q(kh).transpose(-1, -2))
                                / math.sqrt(c // heads), dim=-1)
            o = self.g(q(att) @ q(vh)).transpose(1, 2).reshape(-1, frames, c)
            o = self._linear(o, a + "to_out.0")
            o = o.reshape(bt // frames, h * w, frames, c).transpose(1, 2)
            z = z + o.reshape(bt, h * w, c)
        y = F.layer_norm(z, (c,), self.sd[b + "ff_norm.weight"],
                         self.sd[b + "ff_norm.bias"], 1e-5)
        hid, gate = self._linear(y, b + "ff.net.0.proj").chunk(2, dim=-1)
        z = z + self._linear(hid * F.gelu(gate), b + "ff.net.2")
        z = self._linear(z, p + "proj_out")
        return x + z.reshape(bt, h, w, c).permute(0, 3, 1, 2)

    # ---------------------------------------------------------------- head

    def _reassemble(self, taps, ph, pw):
        h = "depth_head."
        outs = []
        for i, tok in enumerate(taps):
            n, _, c = tok.shape
            x = tok.permute(0, 2, 1).reshape(n, c, ph, pw)
            x = self._conv(x, f"{h}projects.{i}")
            if i == 0:
                x = self._conv_t(x, h + "resize_layers.0", 4)
            elif i == 1:
                x = self._conv_t(x, h + "resize_layers.1", 2)
            elif i == 3:
                x = self._conv(x, h + "resize_layers.3", stride=2, padding=1)
            outs.append(x)
        return outs

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        """One clip's normalised frames (T, 3, H, W) -> (T, H, W)
        relative disparity at the network's size."""
        frames, _, hh, ww = x.shape
        ps = self.cfg["patch_size"]
        ph, pw = hh // ps, ww // ps
        s = "depth_head.scratch."
        outs = [torch.cat(parts) for parts in zip(*(
            self._reassemble(self.encoder(x[i:i + self.chunk]), ph, pw)
            for i in range(0, frames, self.chunk)))]
        outs[2] = self.temporal(outs[2], 0, frames)
        outs[3] = self.temporal(outs[3], 1, frames)
        l1, l2, l3, l4 = (
            self._chunks(lambda y, k=k: self._conv(
                y, f"{s}layer{k + 1}_rn", padding=1, bias=False), y)
            for k, y in enumerate(outs))
        p4 = self._chunks(lambda y: self._fusion(4, y, size=l3.shape[-2:]),
                          l4)
        p4 = self.temporal(p4, 2, frames)
        p3 = self._chunks(lambda y, r: self._fusion(3, y, r,
                                                    size=l2.shape[-2:]),
                          p4, l3)
        p3 = self.temporal(p3, 3, frames)

        def tail(y, r2, r1):
            y = self._fusion(2, y, r2, size=r1.shape[-2:])
            y = self._fusion(1, y, r1)
            y = self._conv(y, s + "output_conv1", padding=1)
            y = F.interpolate(y, size=(hh, ww), mode="bilinear",
                              align_corners=True)
            y = F.relu(self._conv(y, s + "output_conv2.0", padding=1))
            return F.relu(self._conv(y, s + "output_conv2.2"))[:, 0]

        return self._chunks(tail, p3, l2, l1)

    # ------------------------------------------------------------- served

    def preprocess(self, bgr_u8: torch.Tensor, input_size: int
                   ) -> torch.Tensor:
        """(n, H, W, 3) uint8 BGR -> (n, 3, h, w) normalised input, as
        ``DAv2.depth_of_frames`` makes it."""
        _, fh, fw, _ = bgr_u8.shape
        nh, nw = lower_bound_hw(fh, fw, input_size, self.cfg["patch_size"])
        rgb = bgr_u8.flip(-1).float().div(255.0).permute(0, 3, 1, 2)
        x = F.interpolate(rgb, size=(nh, nw), mode="bicubic",
                          antialias=True, align_corners=False)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        return (x - mean[:, None, None]) / std[:, None, None]

    @torch.no_grad()
    def infer_video(self, bgr_u8: torch.Tensor, input_size: int = 518,
                    limit: int | None = None) -> list[torch.Tensor]:
        """A stream's (n, H, W, 3) uint8 BGR frames -> the final maps of
        its first ``limit`` frames (all by default; the windows after
        the one that finalises them are not run), (H, W) f32 each on the
        frames' device."""
        n, fh, fw, _ = bgr_u8.shape
        step = WINDOW - OVERLAP
        limit = n if limit is None else min(limit, n)
        raw, pre = [], None
        with exact_f32():
            for start in range(0, n, step):
                # Window k leaves frames below 22k + 24 final.
                if raw and start - step + WINDOW - INTERP >= limit:
                    break
                idx = [min(i, n - 1) for i in range(start, start + WINDOW)]
                x = self.preprocess(bgr_u8[idx], input_size)
                if pre is not None:
                    x[:OVERLAP] = pre[KEYFRAMES]
                maps = F.interpolate(self.clip(x)[:, None], size=(fh, fw),
                                     mode="bilinear", align_corners=True)
                raw.append(maps[:, 0])
                pre = x
        return align_windows(raw)[:limit]


def scale_shift(pred: torch.Tensor, target: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """VDA's ``compute_scale_and_shift_full`` (mask of ones), in float64:
    (s, t) as float32 0-d tensors, (1, 0) if singular."""
    p, g = pred.double().flatten(), target.double().flatten()
    a00, a01, a11 = (p * p).sum(), p.sum(), float(p.numel())
    b0, b1 = (p * g).sum(), g.sum()
    det = a00 * a11 - a01 * a01
    if float(det) == 0.0:
        return (torch.ones((), device=p.device),
                torch.zeros((), device=p.device))
    return (((a11 * b0 - a01 * b1) / det).float(),
            ((a00 * b1 - a01 * b0) / det).float())


def align_windows(raw: list[torch.Tensor]) -> list[torch.Tensor]:
    """VDA's alignment and blend over the windows' (32, H, W) maps, in
    order: every map of the stream in frame order (the padding's last)."""
    aligned: list[torch.Tensor] = []
    ref: list[torch.Tensor] = []
    for maps in raw:
        if not aligned:
            aligned += list(maps)
            ref = [maps[0], maps[12]]
            continue
        s, t = scale_shift(maps[:2], torch.stack(ref))
        fix = (maps * s + t).clamp_min(0.0)
        for i in range(INTERP):
            w = i / (INTERP - 1)
            aligned[-INTERP + i] = aligned[-INTERP + i] * (1 - w) \
                + fix[2 + i] * w
        aligned += list(fix[OVERLAP:])
        ref = [ref[0], fix[12]]
    return aligned
