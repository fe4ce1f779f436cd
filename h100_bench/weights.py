"""Seeded random weights in the Depth-Anything-V2 state-dict layout.

The layout is DAv2's ``metric_depth`` checkpoint for one configuration file
(``configs/<name>.json``): the DINOv2 trunk under ``pretrained.`` and the
DPT head under ``depth_head.``, ``refinenet4.resConfUnit1`` included (DAv2
builds it and never runs it). The values are made on the device in one
``torch.randn`` call of a ``torch.Generator`` seeded from ``--seed``, in
float32 (the dtype the served model keeps its parameters in), and scaled
per tensor: LeCun normal for matrices and kernels, N(0, 0.02) for biases,
the cls token and the pos-embed, ones for norm scales and LayerScales,
zeros for norm biases and the unused mask token. The same seed gives the
same tensors, so the program and the reference can each be handed them.
"""

from __future__ import annotations

import math

import torch

SMALL_STD = 0.02


def dav2_layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the DAv2 state dict; init is
    ``fan_in:<n>``, ``small``, ``one`` or ``zero``."""
    c, p, g = cfg["embed_dim"], cfg["patch_size"], cfg["pos_grid"]
    hid, feat, oc = cfg["mlp_hidden"], cfg["features"], cfg["out_channels"]
    out: list[tuple[str, tuple[int, ...], str]] = []

    def dense(name, o, i, k=1, bias=True):
        """A linear layer (k = 0) or a k x k conv, out o, in i."""
        shape = (o, i) if k == 0 else (o, i, k, k)
        out.append((f"{name}.weight", shape, f"fan_in:{i * max(k, 1) ** 2}"))
        if bias:
            out.append((f"{name}.bias", (o,), "small"))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "one"))
        out.append((f"{name}.bias", (n,), "zero"))

    t = "pretrained."
    out.append((t + "cls_token", (1, 1, c), "small"))
    out.append((t + "mask_token", (1, c), "zero"))
    out.append((t + "pos_embed", (1, 1 + g * g, c), "small"))
    dense(t + "patch_embed.proj", c, 3, p)
    for i in range(cfg["depth"]):
        b = f"{t}blocks.{i}."
        norm(b + "norm1", c)
        dense(b + "attn.qkv", 3 * c, c, 0)
        dense(b + "attn.proj", c, c, 0)
        out.append((b + "ls1.gamma", (c,), "one"))
        norm(b + "norm2", c)
        if cfg["ffn"] == "swiglu":
            dense(b + "mlp.w12", 2 * hid, c, 0)
            dense(b + "mlp.w3", c, hid, 0)
        else:
            dense(b + "mlp.fc1", hid, c, 0)
            dense(b + "mlp.fc2", c, hid, 0)
        out.append((b + "ls2.gamma", (c,), "one"))
    norm(t + "norm", c)

    h = "depth_head."
    for i, o in enumerate(oc):
        dense(f"{h}projects.{i}", o, c, 1)
    # Transposed convs hold (in, out, k, k); their fan-in is in * k * k.
    for i, k in ((0, 4), (1, 2)):
        out.append((f"{h}resize_layers.{i}.weight", (oc[i], oc[i], k, k),
                    f"fan_in:{oc[i] * k * k}"))
        out.append((f"{h}resize_layers.{i}.bias", (oc[i],), "small"))
    dense(f"{h}resize_layers.3", oc[3], oc[3], 3)
    s = h + "scratch."
    for k in range(1, 5):
        dense(f"{s}layer{k}_rn", feat, oc[k - 1], 3, bias=False)
    for k in range(1, 5):
        r = f"{s}refinenet{k}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            dense(f"{r}{unit}.conv1", feat, feat, 3)
            dense(f"{r}{unit}.conv2", feat, feat, 3)
        dense(f"{r}out_conv", feat, feat, 1)
    dense(s + "output_conv1", feat // 2, feat, 3)
    dense(s + "output_conv2.0", 32, feat // 2, 3)
    dense(s + "output_conv2.2", 1, 32, 1)
    return out


def make_weights(cfg: dict, seed: int, device: torch.device | str
                 ) -> dict[str, torch.Tensor]:
    """The DAv2 state dict of ``cfg`` from ``seed``, float32 on
    ``device``: one draw of normals for every random tensor, then views
    of it scaled in place."""
    layout = dav2_layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_random = sum(math.prod(s) for _, s, init in layout
                   if init not in ("one", "zero"))
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
        else:
            std = (SMALL_STD if init == "small"
                   else 1.0 / math.sqrt(int(init.split(":")[1])))
            state[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
    return state
