"""Seeded random weights in Video Depth Anything's published state-dict
layout (``video_depth_anything_<encoder>.pth``).

The layout is ``weights.py``'s DAv2 layout with the head under ``head.``
(VDA's name; DAv2's ``depth_head.``) and VDA's four motion modules,
``head.motion_modules.<i>.temporal_transformer.``, at the widths of
``cfg["temporal"]["widths"]``: GroupNorm, ``proj_in``, one transformer
block of two attention blocks (``to_q``, ``to_k``, ``to_v`` without bias,
``to_out.0``, the sinusoidal ``pos_encoder.pe`` buffer, a LayerNorm
each), a GEGLU feed-forward (``ff.net.0.proj`` C -> 8C, ``ff.net.2``
4C -> C) after ``ff_norm``, and ``proj_out``. The values are drawn as
``weights.make_weights`` draws them (one ``torch.randn`` call of a
generator seeded from ``--seed``, scaled per tensor; norms one and zero);
``proj_out``, zero in VDA's initialisation, is drawn like every other
matrix, so that the modules act under random weights. The last 1 x 1
conv (``head.scratch.output_conv2.2.weight``, 32 -> 1) is drawn and then
taken in absolute value (``OUTPUT``): VDA's output is a ReLU of it over
the ReLU'd features, and with signed weights a seed whose draw weighs
those non-negative features negative gives maps that are zero on nearly
every pixel (one seed in eleven at vitl, a third at vitt), on which the
check would compare noise. Non-negative weights give a live disparity on
every seed, as a trained head's is. The buffers hold VDA's sinusoid.
"""

from __future__ import annotations

import math

import torch

from .reference.vda import sinusoid
from .weights import SMALL_STD, dav2_layout

# Drawn as dav2_layout says, then taken in absolute value.
OUTPUT = "head.scratch.output_conv2.2.weight"


def motion_layout(i: int, c: int, frames: int
                  ) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of motion module ``i`` of width ``c``; init as
    ``weights.dav2_layout``'s, or ``pe`` for the encoding buffers."""
    p = f"head.motion_modules.{i}.temporal_transformer."
    b = p + "transformer_blocks.0."
    out = [(p + "norm.weight", (c,), "one"), (p + "norm.bias", (c,), "zero"),
           (p + "proj_in.weight", (c, c), f"fan_in:{c}"),
           (p + "proj_in.bias", (c,), "small")]
    for j in range(2):
        a = f"{b}attention_blocks.{j}."
        out += [(a + f"to_{x}.weight", (c, c), f"fan_in:{c}") for x in "qkv"]
        out += [(a + "to_out.0.weight", (c, c), f"fan_in:{c}"),
                (a + "to_out.0.bias", (c,), "small"),
                (a + "pos_encoder.pe", (1, frames, c), "pe"),
                (f"{b}norms.{j}.weight", (c,), "one"),
                (f"{b}norms.{j}.bias", (c,), "zero")]
    out += [(b + "ff.net.0.proj.weight", (8 * c, c), f"fan_in:{c}"),
            (b + "ff.net.0.proj.bias", (8 * c,), "small"),
            (b + "ff.net.2.weight", (c, 4 * c), f"fan_in:{4 * c}"),
            (b + "ff.net.2.bias", (c,), "small"),
            (b + "ff_norm.weight", (c,), "one"),
            (b + "ff_norm.bias", (c,), "zero"),
            (p + "proj_out.weight", (c, c), f"fan_in:{c}"),
            (p + "proj_out.bias", (c,), "small")]
    return out


def vda_layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the VDA state dict."""
    out = [(("head." + n[len("depth_head."):]
             if n.startswith("depth_head.") else n), s, init)
           for n, s, init in dav2_layout(cfg)]
    out = [(n, s, "abs_" + init if n == OUTPUT else init)
           for n, s, init in out]
    t = cfg["temporal"]
    for i, c in enumerate(t["widths"]):
        out += motion_layout(i, c, t["max_len"])
    return out


def make_vda_weights(cfg: dict, seed: int, device: torch.device | str
                     ) -> dict[str, torch.Tensor]:
    """The VDA state dict of ``cfg`` from ``seed``, float32 on
    ``device``."""
    layout = vda_layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_random = sum(math.prod(s) for _, s, init in layout
                   if init not in ("one", "zero", "pe"))
    flat = torch.randn(n_random, generator=gen, device=device,
                       dtype=torch.float32)
    state: dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, init in layout:
        n = math.prod(shape)
        if init == "one":
            state[name] = torch.ones(shape, device=device)
        elif init == "zero":
            state[name] = torch.zeros(shape, device=device)
        elif init == "pe":
            state[name] = sinusoid(shape[1], shape[2], device)[None]
        else:
            std = (SMALL_STD if init == "small"
                   else 1.0 / math.sqrt(int(init.split(":")[1])))
            state[name] = flat[off:off + n].view(shape).mul_(std)
            if init.startswith("abs_"):
                state[name].abs_()
            off += n
    return state
