"""What every traffic generator shares: requests, the window, frames,
depths and augmentation draws from the seed, the sample kept for the
check, and the traced slice's timer.

A traffic file (``traffic/<name>.json``) holds only parameters; its
``generator`` names the file ``generators/<generator>.py`` that drives
the window with them (a closed loop, an open loop of scopes, whole
training steps). A new arrival pattern is a new file there, built from
the pieces here.

Frames are ``frame_hw`` uint8 BGR images from a pool of ``pool`` made on
the device from the seed: a smooth random field (a coarse grid, upsampled)
plus fine noise, so the preprocessing resize has structure to keep.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    index: int                 # order of submission
    frame: int                 # index into the pool
    due: float                 # perf_counter seconds
    submitted: float = 0.0
    done: float = float("inf")
    ok: bool = False
    error: str = ""
    depth: object = None       # kept only for sampled requests


@dataclass
class Window:
    t0: float
    t1: float
    requests: list[Request] = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    lateness_s: list[float] = field(default_factory=list)


def make_frames(seed: int, n: int, hw: tuple[int, int], device) -> list:
    """``n`` (H, W, 3) uint8 frames from ``seed``, made on ``device``."""
    import torch
    import torch.nn.functional as F

    h, w = hw
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    coarse = torch.rand((n, 3, max(2, h // 32), max(2, w // 32)),
                        generator=gen, device=device)
    field_ = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False)
    noise = torch.rand((n, 3, h, w), generator=gen, device=device)
    img = (0.85 * field_ + 0.15 * noise).mul_(255.0).round_().clamp_(0, 255)
    arr = img.to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return list(arr)


class Sampler:
    """The requests whose maps are kept for the check, drawn from the
    seed: ``k`` of the given indices, or, with none given, a reservoir of
    ``k`` over the requests in the order they resolve."""

    def __init__(self, k: int, rng: np.random.Generator,
                 indices: list[int] | None = None):
        self.k, self.rng = k, rng
        self.fixed = None if indices is None else set(
            rng.choice(indices, min(k, len(indices)), replace=False).tolist())
        self.kept: list[Request] = []
        self.seen = 0
        self._lock = threading.Lock()

    def offer(self, req: Request, depth) -> None:
        with self._lock:
            if self.fixed is not None:
                if req.index in self.fixed:
                    req.depth = depth
                    self.kept.append(req)
                return
            self.seen += 1
            if len(self.kept) < self.k:
                slot = len(self.kept)
                self.kept.append(req)
            else:
                slot = int(self.rng.integers(0, self.seen))
                if slot >= self.k:
                    return
                self.kept[slot].depth = None
                self.kept[slot] = req
            req.depth = depth


def resolve(req: Request, fut, sampler: Sampler) -> None:
    req.done = time.perf_counter()
    exc = fut.exception()
    if exc is None:
        req.ok = True
        sampler.offer(req, fut.result())
    else:
        req.error = repr(exc)[:200]


class Slicer:
    """Runs the traced slice from the driving thread: ``on_start`` and
    ``on_stop`` at ``start_s`` and ``start_s + length_s`` seconds into the
    window (nothing without them)."""

    def __init__(self, start_s: float = 0.0, length_s: float = 0.0,
                 on_start=None, on_stop=None):
        self.start_s, self.length_s = start_s, length_s
        self.on_start, self.on_stop = on_start, on_stop
        self.state = 0 if on_start else 2

    def poll(self, elapsed: float) -> None:
        if self.state == 0 and elapsed >= self.start_s:
            self.on_start()
            self.state = 1
        elif self.state == 1 and elapsed >= self.start_s + self.length_s:
            self.on_stop()
            self.state = 2

    def finish(self) -> None:
        if self.state == 1:
            self.on_stop()
        self.state = 2


def drain(reqs: list[Request], grace_s: float) -> None:
    """Wait until every request resolved or ``grace_s`` passed the
    window's close; what is still out then stays missing."""
    deadline = time.perf_counter() + grace_s
    while time.perf_counter() < deadline:
        if all(r.done != float("inf") for r in reqs):
            return
        time.sleep(0.01)


def make_depths(seed: int, n: int, hw: tuple[int, int], device,
                low: int) -> list:
    """``n`` (H, W) uint16 depth maps from ``seed``, made on ``device``:
    smooth random fields between ``low`` and 65535."""
    import torch
    import torch.nn.functional as F

    h, w = hw
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0xDE97)
    coarse = torch.rand((n, 1, max(2, h // 64), max(2, w // 64)),
                        generator=gen, device=device)
    field_ = F.interpolate(coarse, size=(h, w), mode="bicubic",
                           align_corners=False).clamp_(0, 1)
    dep = (low + (65535 - low) * field_).round_().to(torch.int32)
    return list(dep[:, 0].cpu().numpy().astype(np.uint16))


def draw_augment(seed: int, step: int, n: int, hw: tuple[int, int],
                 traffic: dict) -> dict:
    """Every random value of step ``step``'s augmentation of ``n`` images,
    from ``seed``: flip, colour factors and their order, shift (pixels,
    rounded) and scale, over the ranges of ``traffic["augment"]``."""
    a = traffic["augment"]
    rng = np.random.default_rng([int(seed) % (1 << 63), step])
    h, w = hw

    def uni(lo, hi, size):
        return (lo + (hi - lo) * rng.random(size)).astype(np.float32)

    factors = np.stack([
        uni(1 - a["brightness"], 1 + a["brightness"], n),
        uni(1 - a["contrast"], 1 + a["contrast"], n),
        uni(1 - a["saturation"], 1 + a["saturation"], n),
        uni(-a["hue"], a["hue"], n)], axis=1)
    tx, ty = a["translate"][0] * w, a["translate"][1] * h
    return {"flip": rng.random(n) < a["hflip_prob"],
            "factors": factors,
            "order": np.stack([rng.permutation(4) for _ in range(n)]),
            "translate": np.round(np.stack([uni(-tx, tx, n),
                                            uni(-ty, ty, n)], axis=1)),
            "scale": uni(a["scale_range"][0], a["scale_range"][1], n)}
