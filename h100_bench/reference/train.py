"""Plain float32 DAv2 fine-tuning steps: the reference of a training cell.

One step is DAv2 metric-depth fine-tuning as ``train_depth`` runs it, in
plain ``torch`` on a DAv2 state dict, importing nothing of the program:

- the loader's uint8 images and uint16 depths / 255 and / 65535, each
  resized to size x size with the antialiased bicubic (``torchvision``'s
  ``Resize(antialias=True)``); the image then flipped, colour-jittered
  (brightness, contrast, saturation, hue in the drawn order) and
  affine-shifted and scaled (nearest, fill 0) with the given draws, as
  ``torchvision``'s transforms define them, and ImageNet-normalised; the
  depth is not augmented;
- per microbatch, SiLog (lambda 0.5) over the pixels with
  ``min_depth <= gt <= max_depth`` of the reference model's prediction,
  its gradient added into the step's with weight 1 / microbatches;
- the global-norm clip (scaled only when the norm reaches the limit);
- AdamW (b 0.9, 0.999, eps 1e-8, weight decay 0.01) over two groups, the
  encoder (``pretrained.``) and the rest, each at its OneCycle learning
  rate (cosine, ``torch.optim.lr_scheduler.OneCycleLR``'s shape) of the
  step, counted from the traffic's ``start_step``, with moments that
  start empty; a tensor with no gradient (the mask token) takes a zero
  one.

A microbatch's forward runs in chunks (``ref_chunk`` frames): a first
pass without gradients takes SiLog's masked sums, and a second pass
back-propagates each chunk's exact share of the microbatch's loss
(d loss / d d_i = (d_i - lambda mean) / (n loss) at each valid pixel), so
the whole microbatch's activations never need to be held at once.

The colour and affine operations are a copy of the plain versions that
torchvision's semantics define (the same formulas the program's
``ops/augment.py`` uses); the draws are the benchmark's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .dav2 import IMAGENET_MEAN, IMAGENET_STD, DAv2, exact_f32

SILOG_LAMBDA = 0.5
BETAS = (0.9, 0.999)


# ------------------------------------------------------------ augmentation

def _gray(img):
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return torch.sum(img * w, dim=-1, keepdim=True)


def _brightness(img, f):
    return torch.clamp(img * f, 0.0, 1.0)


def _contrast(img, f):
    return torch.clamp(img * f + (1.0 - f) * torch.mean(_gray(img)), 0.0, 1.0)


def _saturation(img, f):
    return torch.clamp(img * f + (1.0 - f) * _gray(img), 0.0, 1.0)


def _hue(img, shift):
    img = torch.clamp(img, 0.0, 1.0)
    r, g, b = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(torch.where(delta > 0, h, zero) / 6.0, 1.0)
    h = torch.remainder(h + shift, 1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - f * s), v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*c):
        out = c[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, c[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


_COLOUR = (_brightness, _contrast, _saturation, _hue)


def _affine(img, tx: float, ty: float, scale: float):
    """RandomAffine(degrees=0) with the drawn shift and scale: the nearest
    source pixel of each output pixel about the centre (f32, round half to
    even), 0 outside."""
    h, w = img.shape[:2]
    f32 = np.float32

    def axis(n, shift):
        c = f32((n - 1) * 0.5)
        src = np.round((np.arange(n, dtype=f32) - c - f32(shift))
                       / f32(scale) + c).astype(np.int64)
        return np.clip(src, 0, n - 1), (src >= 0) & (src < n)

    iy, vy = axis(h, ty)
    ix, vx = axis(w, tx)
    out = img[torch.from_numpy(iy).to(img.device)][
        :, torch.from_numpy(ix).to(img.device)]
    valid = torch.from_numpy(vy[:, None] & vx[None, :]).to(img.device)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def preprocess(images_u8: torch.Tensor, depths_u16: torch.Tensor,
               size: int, draws: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 RGB and (B, H, W) uint16 depth on the device ->
    the augmented, normalised image (B, 3, size, size) and the depth
    target (B, size, size), both float32."""
    img = F.interpolate(images_u8.float().div(255.0).permute(0, 3, 1, 2),
                        size=(size, size), mode="bicubic", antialias=True,
                        align_corners=False).permute(0, 2, 3, 1)
    dep01 = depths_u16.to(torch.int32).float().div(65535.0)[:, None]
    gt = F.interpolate(dep01, size=(size, size), mode="bicubic",
                       antialias=True, align_corners=False)[:, 0]
    out = []
    for i, x in enumerate(img):
        if draws["flip"][i]:
            x = x.flip(1)
        for op in draws["order"][i]:
            x = _COLOUR[int(op)](x, float(draws["factors"][i][int(op)]))
        x = _affine(x, float(draws["translate"][i][0]),
                    float(draws["translate"][i][1]), float(draws["scale"][i]))
        out.append(x)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    x = (torch.stack(out) - mean) / std
    return x.permute(0, 3, 1, 2).contiguous(), gt


# ------------------------------------------------------------- the step

def onecycle(max_lr: float, total_steps: int, pct_start: float,
             div_factor: float, final_div_factor: float = 1e4):
    """OneCycleLR's learning rate at the 0-based step (cosine phases)."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_end = pct_start * total_steps - 1.0
    down_end = total_steps - 1.0

    def cos(a, b, pct):
        return b + (a - b) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def lr(step: int) -> float:
        s = min(float(step), down_end)
        if s <= up_end:
            return cos(initial, max_lr, min(max(s / max(up_end, 1e-12), 0), 1))
        return cos(max_lr, final, min(max((s - up_end)
                                          / max(down_end - up_end, 1e-12),
                                          0), 1))
    return lr


class Trainer:
    """The reference's training state over a DAv2 state dict."""

    def __init__(self, cfg: dict, state: dict[str, torch.Tensor],
                 traffic: dict, fp8: bool = False):
        self.cfg, self.traffic = cfg, traffic
        # The float8 control holds each operand twice (rounded and not)
        # while its graph lives: half the chunk keeps it on the card.
        self.chunk = max(1, int(traffic["ref_chunk"]) // (2 if fp8 else 1))
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in state.items()}
        self.model = DAv2(cfg, self.params, fp8=fp8)
        enc = [p for k, p in self.params.items()
               if k.startswith("pretrained.")]
        dec = [p for k, p in self.params.items()
               if not k.startswith("pretrained.")]
        self.lrs = [onecycle(traffic[k], traffic["total_steps"],
                             traffic["pct_start"], traffic["div_factor"])
                    for k in ("encoder_lr", "decoder_lr")]
        self.opt = torch.optim.AdamW(
            [{"params": enc, "lr": 0.0}, {"params": dec, "lr": 0.0}],
            betas=BETAS, eps=1e-8, weight_decay=0.01)
        self.step_count = int(traffic["start_step"])

    def _microbatch_grad(self, x, gt, weight: float) -> float:
        """Add ``weight`` x the gradient of the microbatch's SiLog; return
        the loss."""
        chunk = self.chunk
        lo, hi = self.traffic["min_depth"], self.cfg["max_depth"]
        s1 = s2 = n = 0.0
        with torch.no_grad():
            for i in range(0, x.shape[0], chunk):
                d, m = self._log_gap(x[i:i + chunk], gt[i:i + chunk], lo, hi)
                s1 += float((d * m).sum())
                s2 += float((d * d * m).sum())
                n += float(m.sum())
        n = max(n, 1e-12)
        mean = s1 / n
        loss = math.sqrt(max(s2 / n - SILOG_LAMBDA * mean * mean, 1e-12))
        for i in range(0, x.shape[0], chunk):
            d, m = self._log_gap(x[i:i + chunk], gt[i:i + chunk], lo, hi)
            coef = (m * (d.detach() - SILOG_LAMBDA * mean) / (n * loss))
            (weight * (coef * d).sum()).backward()
        return loss

    def _log_gap(self, x, gt, lo, hi):
        pred = self.model.depth(x)
        m = ((gt >= lo) & (gt <= hi)).float()
        valid = m > 0
        d = (torch.log(torch.where(valid, gt, torch.ones_like(gt)))
             - torch.log(torch.where(valid, pred, torch.ones_like(pred))))
        return d, m

    def step(self, batches: list[tuple[torch.Tensor, torch.Tensor]]
             ) -> tuple[float, dict[str, float]]:
        """One optimizer step over the microbatches ``(x, gt)``. Returns
        the mean loss and each tensor's clipped gradient norm."""
        with exact_f32():
            self.opt.zero_grad(set_to_none=True)
            losses = [self._microbatch_grad(x, gt, 1.0 / len(batches))
                      for x, gt in batches]
            for p in self.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params.values()]
            norm = float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads])))
            clip = float(self.traffic["clip_norm"])
            if norm >= clip:
                for g in grads:
                    g.mul_(clip / norm)
            for group, lr in zip(self.opt.param_groups, self.lrs):
                group["lr"] = lr(self.step_count)
            grad_norms = {k: float(torch.linalg.vector_norm(p.grad))
                          for k, p in self.params.items()}
            self.opt.step()
            self.step_count += 1
        return sum(losses) / len(losses), grad_norms

    def change_norms(self, start: dict[str, torch.Tensor]) -> dict[str, float]:
        """Each tensor's distance from ``start``."""
        with torch.no_grad():
            return {k: float(torch.linalg.vector_norm(p - start[k].float()))
                    for k, p in self.params.items()}


def leaf_gaps(program: dict[str, float], reference: dict[str, float],
              keep: dict[str, float] | None = None
              ) -> tuple[float, float, int]:
    """Each leaf's gap between the program's norm and the reference's, as
    ``leaf_distances`` scales it (a leaf the program left without a
    reading, with no optimizer state as it never stepped, counts as
    unmoved)."""
    return leaf_distances({k: abs(program.get(k, 0.0) - v)
                           for k, v in reference.items()}, reference, keep)


def leaf_distances(distance: dict[str, float], reference: dict[str, float],
                   keep: dict[str, float] | None = None
                   ) -> tuple[float, float, int]:
    """Each leaf's ``distance`` over the larger of that leaf's
    ``reference`` norm and the median leaf's: the worst leaf's, the median
    leaf's, and the leaves compared. Leaves whose norm in ``keep`` (the
    reference's first gradient; by default ``reference`` itself) is under
    a thousandth of the median's are left out: nought to rounding in the
    reference (a key's bias under softmax, the unused mask token), they
    move under Adam by round-off alone."""
    keep = reference if keep is None else keep
    med = float(np.median(list(reference.values())))
    keep_med = float(np.median(list(keep.values())))
    kept = [k for k, v in keep.items()
            if v >= 1e-3 * keep_med and v > 0 and k in reference]
    if not kept:
        return float("inf"), float("inf"), 0
    gaps = [distance[k] / max(reference[k], med) for k in kept]
    return max(gaps), float(np.median(gaps)), len(kept)
