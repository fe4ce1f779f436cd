"""Video Depth Anything's windowing of a stream, as its
``infer_video_depth`` does it, for the serving engine's clip mode.

A stream's frames run in windows of ``WINDOW`` (32) positions that
advance by ``STEP`` (22) frames:

- the first window holds frames 0-31; window k >= 1 holds, at positions
  0-9, the previous window's network inputs at ``KEYFRAMES`` (0, 12,
  24 ... 31), and at 10-31 the frames 22k + 10 ... 22k + 31;
- window k runs once its frames are in, or, after the stream's end, while
  22k is below the stream's length, its missing frames copies of the
  last;
- window k >= 1 is aligned to the stream by a least-squares scale and
  shift that maps its positions 0 and 1 (the carried keyframes 0 and 12)
  onto the stored aligned maps of those keyframes (``fit_scale_shift``),
  the aligned maps clamped at 0;
- the previous window's last ``INTERP`` (8) aligned maps blend linearly
  into this window's aligned positions 2-9 (the same frames), with
  weights i / 7 on the new maps (``blend``);
- the stored keyframe maps become the first window's position 0 and this
  window's aligned position 12.

A frame's map is final once no later window changes it: positions 0-23
of the first window and 10-23 of a later one at once, the last 8 after
the next window's blend, or at the stream's end. All of it runs on the
maps' device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = 32
OVERLAP = 10
INTERP = 8
STEP = WINDOW - OVERLAP
KEYFRAMES = (0, 12) + tuple(range(WINDOW - INTERP, WINDOW))
ALIGN = OVERLAP - INTERP            # positions fitted: 0 and 1
FINAL_END = WINDOW - INTERP         # positions below are final at once


def fit_scale_shift(pred: torch.Tensor, target: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """VDA's ``compute_scale_and_shift`` over every element (mask all
    ones): the (s, t) minimising |s pred + t - target|^2, its sums in f64
    on the device; (1, 0) where the system is singular. 0-d f32 tensors."""
    p, g = pred.double().flatten(), target.double().flatten()
    a00, a01 = (p * p).sum(), p.sum()
    a11 = torch.tensor(float(p.numel()), dtype=torch.float64,
                       device=p.device)
    b0, b1 = (p * g).sum(), g.sum()
    det = a00 * a11 - a01 * a01
    ok = det != 0
    safe = torch.where(ok, det, torch.ones_like(det))
    s = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.ones_like(det))
    t = torch.where(ok, (a00 * b1 - a01 * b0) / safe, torch.zeros_like(det))
    return s.float(), t.float()


def blend(pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """VDA's ``get_interpolate_frames``: pre[i] (1 - w_i) + post[i] w_i,
    w_i = i / (n - 1)."""
    n = pre.shape[0]
    w = torch.arange(n, dtype=torch.float32, device=pre.device) / (n - 1)
    w = w.view(n, *([1] * (pre.dim() - 1)))
    return pre * (1 - w) + post * w


def stitch(maps: torch.Tensor, first: bool, ref: torch.Tensor | None,
           tail: torch.Tensor | None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor | None]:
    """One window's (WINDOW, H, W) maps against the stream's stored
    keyframe maps ``ref`` (2, H, W) and the previous window's last
    ``INTERP`` aligned maps ``tail``. Returns (the final maps of the
    window's positions from ``OVERLAP`` (0 for the first) to
    ``FINAL_END``, the new ``ref``, the new ``tail``, the previous
    window's waiting frames' final maps, None for the first)."""
    if first:
        return (maps[:FINAL_END], maps[list(KEYFRAMES[:ALIGN])],
                maps[FINAL_END:], None)
    s, t = fit_scale_shift(maps[:ALIGN], ref)
    aligned = (maps[ALIGN:] * s + t).clamp_min_(0.0)    # positions 2-31
    done = blend(tail, aligned[:INTERP])
    new_ref = torch.stack([ref[0], aligned[KEYFRAMES[1] - ALIGN]])
    return (aligned[OVERLAP - ALIGN:FINAL_END - ALIGN], new_ref,
            aligned[FINAL_END - ALIGN:], done)


@dataclass
class Stream:
    """One stream's state in the engine (the batcher's thread alone
    touches it): frames taken and not yet run, the items waiting for the
    next window's blend, the device tensors the next window needs."""
    key: object
    shape: tuple
    # (item, the ns it was taken) of frames not yet run
    pending: list = field(default_factory=list)
    received: int = 0
    windows: int = 0
    ended: bool = False
    carried: torch.Tensor | None = None      # inputs at KEYFRAMES
    last_input: torch.Tensor | None = None   # the last real frame's input
    ref: torch.Tensor | None = None
    tail: torch.Tensor | None = None
    waiting: list = field(default_factory=list)   # items of the tail

    def need(self) -> int:
        """New positions the next window takes."""
        return WINDOW if self.windows == 0 else STEP

    def ready(self) -> bool:
        """Whether the next window can run now."""
        if len(self.pending) >= self.need():
            return True
        return self.ended and STEP * self.windows < self.received

    def done(self) -> bool:
        """Ended, with every window run."""
        return self.ended and not self.ready()
