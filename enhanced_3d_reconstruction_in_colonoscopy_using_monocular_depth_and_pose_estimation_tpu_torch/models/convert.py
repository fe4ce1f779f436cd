"""Weights for the port's depth model.

The port's parameter names are the DAv2 ``.pth`` key names, so a reference
checkpoint needs no renaming: ``load_torch_state_dict`` strips the
Lightning ``model.`` prefix and ``load_dav2_state_dict`` drops the one
family of checkpoint keys the model never uses
(``depth_head.scratch.refinenet4.resConfUnit1.*``: refinenet4 has a single
input) before a strict ``load_state_dict``.

``from_jax_params`` carries weights across from the JAX package: it takes
that package's flax params tree (as numpy arrays) and inverts the layout
rules of its ``convert_dav2``:

- conv ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``;
- PixelExpand ``(kh, kw, I, O)`` -> ConvTranspose2d ``(I, O, kh, kw)``;
- Dense ``(I, O)`` -> Linear ``(O, I)``;
- LayerNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .depth_anything import MODEL_CONFIGS
from .dinov2 import VIT_ARCHS

UNUSED_PREFIXES = ("depth_head.scratch.refinenet4.resConfUnit1.",)


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Load a DAv2 ``.pth`` or Lightning ``.ckpt`` state dict (tensors
    only: ``weights_only=True``), stripping the ``model.`` prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in state.items()}


def drop_unused(state: Mapping[str, object]) -> dict[str, object]:
    """``state`` without the checkpoint keys the model does not build."""
    return {k: v for k, v in state.items()
            if not k.startswith(UNUSED_PREFIXES)}


def load_dav2_state_dict(model: nn.Module,
                         state: Mapping[str, object]) -> nn.Module:
    """Load a DAv2 state dict (tensors or numpy arrays) into ``model``,
    strictly, after dropping the unused keys."""
    tensors = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
               for k, v in drop_unused(state).items()}
    model.load_state_dict(tensors, strict=True)
    return model


# First path element of the JAX tree (under "depth_head") -> module path.
def _head_module(name: str) -> str:
    if name.startswith("project_"):
        return f"projects.{name[len('project_'):]}"
    if name.startswith("resize_"):
        return f"resize_layers.{name[len('resize_'):]}"
    if name.startswith("output_conv2_"):
        return f"scratch.output_conv2.{name[len('output_conv2_'):]}"
    return f"scratch.{name}"


def _leaf(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    """Torch leaf name and layout for one flax leaf."""
    leaf = path[-1]
    if leaf == "scale":
        return "weight", value
    if leaf != "kernel":
        return leaf, value
    if value.ndim == 2:
        return "weight", value.T
    if path[0] == "depth_head" and path[1] in ("resize_0", "resize_1"):
        return "weight", value.transpose(2, 3, 0, 1)
    return "weight", value.transpose(3, 2, 0, 1)


def from_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's DAv2 params tree -> the port's state dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple[str, ...]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            full = path + (key,)
            leaf, arr = _leaf(full, np.asarray(value))
            mods = list(full[1:-1])
            if full[0] == "pretrained":
                if mods and mods[0].startswith("blocks_"):
                    mods[0] = f"blocks.{mods[0][len('blocks_'):]}"
                if mods == ["patch_embed"]:
                    mods.append("proj")
            else:
                mods[0] = _head_module(mods[0])
            name = ".".join([full[0], *mods, leaf])
            out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    walk(tree, ())
    return out


def synthetic_dav2_state_dict(encoder: str,
                              seed: int = 0) -> dict[str, np.ndarray]:
    """Random torch-format DAv2 state dict (for tests: every key a DAv2
    checkpoint has, with the true shapes)."""
    rng = np.random.default_rng(seed)
    arch = VIT_ARCHS[encoder]
    cfg = MODEL_CONFIGS[encoder]
    c = arch["embed_dim"]
    f = cfg["features"]
    oc = cfg["out_channels"]
    grid = 37 if encoder != "vitt" else 4

    def r(*shape):
        return (rng.normal(size=shape) * 0.02).astype(np.float32)

    s: dict[str, np.ndarray] = {
        "pretrained.cls_token": r(1, 1, c),
        "pretrained.pos_embed": r(1, 1 + grid * grid, c),
        "pretrained.mask_token": r(1, c),
        "pretrained.patch_embed.proj.weight": r(c, 3, 14, 14),
        "pretrained.patch_embed.proj.bias": r(c),
        "pretrained.norm.weight": 1 + r(c),
        "pretrained.norm.bias": r(c),
    }
    for i in range(arch["depth"]):
        b = f"pretrained.blocks.{i}"
        s |= {
            f"{b}.norm1.weight": 1 + r(c), f"{b}.norm1.bias": r(c),
            f"{b}.attn.qkv.weight": r(3 * c, c), f"{b}.attn.qkv.bias": r(3 * c),
            f"{b}.attn.proj.weight": r(c, c), f"{b}.attn.proj.bias": r(c),
            f"{b}.ls1.gamma": 1 + r(c), f"{b}.ls2.gamma": 1 + r(c),
            f"{b}.norm2.weight": 1 + r(c), f"{b}.norm2.bias": r(c),
            f"{b}.mlp.fc1.weight": r(4 * c, c), f"{b}.mlp.fc1.bias": r(4 * c),
            f"{b}.mlp.fc2.weight": r(c, 4 * c), f"{b}.mlp.fc2.bias": r(c),
        }
    for i in range(4):
        s[f"depth_head.projects.{i}.weight"] = r(oc[i], c, 1, 1)
        s[f"depth_head.projects.{i}.bias"] = r(oc[i])
    s["depth_head.resize_layers.0.weight"] = r(oc[0], oc[0], 4, 4)
    s["depth_head.resize_layers.0.bias"] = r(oc[0])
    s["depth_head.resize_layers.1.weight"] = r(oc[1], oc[1], 2, 2)
    s["depth_head.resize_layers.1.bias"] = r(oc[1])
    s["depth_head.resize_layers.3.weight"] = r(oc[3], oc[3], 3, 3)
    s["depth_head.resize_layers.3.bias"] = r(oc[3])
    for k in range(1, 5):
        s[f"depth_head.scratch.layer{k}_rn.weight"] = r(f, oc[k - 1], 3, 3)
        rf = f"depth_head.scratch.refinenet{k}"
        for unit in (1, 2):
            for conv_i in (1, 2):
                s[f"{rf}.resConfUnit{unit}.conv{conv_i}.weight"] = r(f, f, 3, 3)
                s[f"{rf}.resConfUnit{unit}.conv{conv_i}.bias"] = r(f)
        s[f"{rf}.out_conv.weight"] = r(f, f, 1, 1)
        s[f"{rf}.out_conv.bias"] = r(f)
    s["depth_head.scratch.output_conv1.weight"] = r(f // 2, f, 3, 3)
    s["depth_head.scratch.output_conv1.bias"] = r(f // 2)
    s["depth_head.scratch.output_conv2.0.weight"] = r(32, f // 2, 3, 3)
    s["depth_head.scratch.output_conv2.0.bias"] = r(32)
    s["depth_head.scratch.output_conv2.2.weight"] = r(1, 32, 1, 1)
    s["depth_head.scratch.output_conv2.2.bias"] = r(1)
    return s
