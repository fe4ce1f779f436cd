"""Weights for the port's depth and pose models.

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

``load_vda_state_dict`` loads Video Depth Anything's published
checkpoint (``video_depth_anything_<encoder>.pth``) into a
``VideoDepthAnything``: its head is ``head.`` where DAv2's is
``depth_head.``, and each motion module
(``head.motion_modules.<i>.temporal_transformer.``) becomes the port's
``depth_head.motion_modules.<i>.``, with each
attention block's ``to_q``, ``to_k`` and ``to_v`` packed into one
(3C, C) ``to_qkv`` as the encoder packs its projections, and the
sinusoidal ``pos_encoder.pe`` buffers (which the port recomputes)
dropped after a check of their values.

``from_jax_pose_variables`` does the same for the pose net's
``{"params", "batch_stats"}`` (the inverse of the JAX package's
``convert_pose_net``). The port's pose net has the reference's names, so
a reference pose ``.pth``/``.ckpt`` loads through ``load_torch_state_dict``
and ``load_state_dict`` directly.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..core.dtypes import POLICY_BF16
from .depth_anything import MODEL_CONFIGS, DepthAnythingV2, build_depth_model
from .dinov2 import VIT_ARCHS, swiglu_hidden

UNUSED_PREFIXES = ("depth_head.scratch.refinenet4.resConfUnit1.",)


def load_or_init_depth_model(encoder: str, max_depth: float,
                             load_from: str | None,
                             device: str | torch.device = "cuda",
                             seed: int = 0,
                             dtype: torch.dtype = POLICY_BF16.compute_dtype,
                             token_merge: float = 0.0,
                             quant_int8: bool = False) -> DepthAnythingV2:
    """The ``encoder`` depth model on ``device`` (the card unless the
    caller asks for the CPU), computing in ``dtype`` with the speed dials
    ``token_merge`` and ``quant_int8`` (``build_depth_model``), in eval
    mode, as the JAX package's ``load_or_init_depth_params``: a directory
    is the port's own training output (``core.checkpoint``: the best save
    by val_loss, else the newest), a file is a DAv2 ``.pth`` or Lightning
    ``.ckpt``, and neither gives the seeded random init. A directory of
    the JAX package's Orbax checkpoints raises ``ValueError`` naming the
    converter (``orbax_to_torch.py`` at the repo root): reading Orbax
    needs jax, which the port does not import. A Video Depth Anything
    checkpoint (motion-module keys) raises ``ValueError`` naming
    ``video_depth --model vda``: every per-frame entry point loads here."""
    from ..core.checkpoint import CheckpointManager

    model = build_depth_model(encoder, max_depth=max_depth, dtype=dtype,
                              device=device, seed=seed,
                              token_merge=token_merge, quant_int8=quant_int8)
    if load_from and os.path.isdir(load_from):
        state = CheckpointManager(load_from).read_best()
        if state is None and _looks_like_orbax(load_from):
            raise ValueError(
                f"{load_from} holds Orbax checkpoints of the JAX package; "
                "reading them needs jax: convert them to a torch state "
                "dict first with `python orbax_to_torch.py --kind depth "
                f"-i {load_from} -o model.pth` (at the repo root) and load "
                "model.pth")
        if state is None:
            raise FileNotFoundError(f"no checkpoints in {load_from}")
        model.load_state_dict(state["model"])
    elif load_from:
        state = load_torch_state_dict(load_from)
        if any(k.startswith(_VDA_MM) for k in state):
            raise ValueError(
                f"{load_from} is a Video Depth Anything checkpoint "
                f"({_VDA_MM}*): it runs 32-frame clips of a video, which a "
                "single frame is not; run it with `video_depth --model vda "
                f"--load-from {load_from}`")
        load_dav2_state_dict(model, state)
    else:
        print(f"[{encoder}] no checkpoint given; random init (smoke mode)")
    return model


def load_or_init_vda_model(encoder: str, load_from: str | None,
                           device: str | torch.device = "cuda") -> nn.Module:
    """The ``encoder`` Video Depth Anything model on ``device`` in eval
    mode: a published ``video_depth_anything_<encoder>.pth`` when
    ``load_from`` names one (``load_vda_state_dict``), else the seeded
    random init."""
    from .depth_anything import build_vda_model

    model = build_vda_model(encoder, device=device)
    if load_from:
        load_vda_state_dict(model, load_torch_state_dict(load_from))
    else:
        print(f"[vda {encoder}] no checkpoint given; random init (smoke "
              "mode)")
    return model


def _looks_like_orbax(directory: str) -> bool:
    """Orbax's layout: step directories holding ``_CHECKPOINT_METADATA``
    or ``_METADATA`` files, not the port's ``state.pt``."""
    for root, _, files in os.walk(directory):
        if {"_CHECKPOINT_METADATA", "_METADATA"} & set(files):
            return True
    return False


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


_VDA_MM = "head.motion_modules."
_VDA_TT = ".temporal_transformer."
# VDA's names inside a motion module -> the port's.
_VDA_RENAMES = (("transformer_blocks.0.attention_blocks.", "attention_blocks."),
                ("transformer_blocks.0.norms.", "norms."),
                ("transformer_blocks.0.ff_norm.", "ff_norm."),
                ("transformer_blocks.0.ff.net.0.proj.", "ff_proj."),
                ("transformer_blocks.0.ff.net.2.", "ff_out."),
                ("to_out.0.", "to_out."))


def _vda_key(key: str) -> str:
    """A published VDA key -> the port's (``head.`` -> ``depth_head.``,
    a motion module's path shortened); ``to_q``/``to_k``/``to_v`` keep
    their names (``load_vda_state_dict`` packs them)."""
    if key.startswith(_VDA_MM):
        i, rest = key[len(_VDA_MM):].split(_VDA_TT, 1)
        for old, new in _VDA_RENAMES:
            rest = rest.replace(old, new)
        return f"depth_head.motion_modules.{i}.{rest}"
    if key.startswith("head."):
        return "depth_head." + key[len("head."):]
    return key


def vda_state_dict(state: Mapping[str, object]) -> dict[str, torch.Tensor]:
    """A published VDA state dict -> the port's ``VideoDepthAnything``
    state dict (see the module docstring). A ``pos_encoder.pe`` buffer
    that is not VDA's sinusoid raises."""
    from .temporal import sinusoid_table

    out: dict[str, torch.Tensor] = {}
    qkv: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in drop_unused({_vda_key(k): v
                                   for k, v in state.items()}).items():
        t = value if torch.is_tensor(value) else torch.from_numpy(
            np.asarray(value))
        stem, _, leaf = key.rpartition(".")
        if stem.endswith(".pos_encoder"):
            want = sinusoid_table(t.shape[-2], t.shape[-1])
            if not torch.allclose(t.reshape(want.shape).float().cpu(), want,
                                  atol=1e-5):
                raise ValueError(f"{key}: not the sinusoidal encoding")
            continue
        head, _, proj = stem.rpartition(".")
        if proj in ("to_q", "to_k", "to_v") and leaf == "weight":
            qkv.setdefault(head, {})[proj] = t
            continue
        out[key] = t
    for head, parts in qkv.items():
        out[f"{head}.to_qkv.weight"] = torch.cat(
            [parts[p] for p in ("to_q", "to_k", "to_v")])
    return out


def load_vda_state_dict(model: nn.Module,
                        state: Mapping[str, object]) -> nn.Module:
    """Load a published VDA state dict (``vda_state_dict``) into a
    ``VideoDepthAnything``, strictly."""
    model.load_state_dict(vda_state_dict(state), strict=True)
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


# JAX pose-net module -> the port's (reference) module path.
_POSE_HEAD = {"head_fc1": "pose_head.2", "head_fc2": "pose_head.5",
              "head_fc3": "pose_head.8"}
_POSE_BLOCK = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _pose_module(name: str) -> str:
    if name in _POSE_HEAD:
        return _POSE_HEAD[name]
    if name.startswith("layer"):
        return "backbone." + name.replace("_", ".")
    return f"backbone.{name}"


def from_jax_pose_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's pose-net ``{"params", "batch_stats"}`` -> the
    port's state dict (conv HWIO -> OIHW, Dense (I, O) -> Linear (O, I),
    BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    ``num_batches_tracked`` 0)."""
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for top, node in variables[collection].items():
            module = _pose_module(top)
            for sub, leaves in node.items():
                if not isinstance(leaves, Mapping):  # conv1, bn1, fc, head
                    leaves, sub_path = {sub: leaves}, module
                else:                                # inside a block
                    sub_path = f"{module}.{_POSE_BLOCK.get(sub, sub)}"
                for leaf, value in leaves.items():
                    arr = np.asarray(value, np.float32)
                    if leaf == "kernel":
                        leaf = "weight"
                        arr = arr.T if arr.ndim == 2 else \
                            arr.transpose(3, 2, 0, 1)
                    else:
                        leaf = _BN_LEAVES[leaf]
                    out[f"{sub_path}.{leaf}"] = torch.from_numpy(
                        np.array(arr))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    return out


def synthetic_dav2_state_dict(encoder: str,
                              seed: int = 0) -> dict[str, np.ndarray]:
    """Random torch-format DAv2 state dict (for tests: every key a DAv2
    checkpoint has, with the true shapes; vitg's blocks hold the SwiGLU
    FFN's ``mlp.w12``/``mlp.w3``)."""
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
        }
        if arch.get("ffn", "mlp") == "swiglu":
            hid = swiglu_hidden(c)
            s |= {f"{b}.mlp.w12.weight": r(2 * hid, c),
                  f"{b}.mlp.w12.bias": r(2 * hid),
                  f"{b}.mlp.w3.weight": r(c, hid), f"{b}.mlp.w3.bias": r(c)}
        else:
            s |= {f"{b}.mlp.fc1.weight": r(4 * c, c),
                  f"{b}.mlp.fc1.bias": r(4 * c),
                  f"{b}.mlp.fc2.weight": r(c, 4 * c),
                  f"{b}.mlp.fc2.bias": r(c)}
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
