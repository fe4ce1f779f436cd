"""DINOv2 ViT encoder (vits/vitb/vitl/vitg, patch 14) with DAv2 feature
taps.

Module and parameter names are those of the DAv2 ``.pth`` checkpoints
(``pretrained.blocks.{i}.attn.qkv.weight``, ...), so a reference state dict
loads with ``load_state_dict``. Parameters are f32; each module computes in
the dtype of its input (``DinoViT.dtype``, bf16 on the card):

- patch embed: 14x14/14 conv; cls token; learned pos-embed for a 37x37
  grid (518 px), resized for other grids with torch-bicubic semantics;
- pre-LN blocks (eps 1e-6), LayerScale, and an exact-GELU MLP (ratio 4)
  or, for vitg (``ffn="swiglu"``), DINOv2's fused SwiGLU FFN;
- taps at the DAv2 block indices, each with the final LayerNorm, returned
  as (patch_tokens, cls_token).

Attention goes through ``ops.attention`` (kernels K1 and K2 on the card).
The residual stream is never padded: the kernels mask the ragged token
edge themselves. ``grad_checkpoint`` recomputes each block in the backward
(the JAX package's ``nn.remat(Block)``), in training mode only, whatever
the block's FFN.

The speed dials are ``DinoViT`` fields set at build time, as in the JAX
package: ``token_merge`` merges that fraction of the patch tokens after the
first tap block (``ops/token_merge.py``) and unmerges the later taps after
the final norm; ``quant_int8`` runs the blocks' projections in W8A8
(``ops/quant.py``) over the scope ``quant_scope`` (``auto``, ``all``,
``mlp`` or ``attn``; ``auto`` is ``all`` at a batch of at most 32, else
``mlp``, the JAX package's rule for one device).

Tensor parallelism (``parallel.mesh.TensorParallel``, set on the
modules' ``tp`` slot by ``apply_tensor_parallel``) splits each block over
the model group, Megatron's way: the qkv projection by head (each rank's
slice is ``(3, H/tp, D)``, and attention runs at ``H/tp`` heads), the
MLP's ``fc1`` (SwiGLU's gate and value halves of ``w12`` alike) by output
row, ``proj``/``fc2``/``w3`` by input column, their partial sums added
over the group and their bias added once. Each rank holds only its slice
of those parameters (``apply_tensor_parallel`` replaces them; the
checkpoint layout is the whole tensors, ``parallel.mesh.tp_whole``).
With ``seq_parallel`` the residual stream between blocks holds this
rank's slot of the token axis (``tensor_split`` sizes, no padding): the
stream is gathered before each split projection and reduce-scattered
after it, and the taps are gathered whole.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import device_cache
from ..core.dtypes import POLICY_BF16
from ..ops import attention as attn_ops
from ..ops.quant import int8_dense
from ..ops.token_merge import bipartite_merge, unmerge
from ..parallel import mesh as meshlib

VIT_ARCHS: dict[str, dict[str, Any]] = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, ffn="swiglu"),
    # tiny config for tests / dry runs (not in the reference)
    "vitt": dict(embed_dim=64, depth=4, num_heads=2),
}

# DAv2 feature-tap indices per encoder size.
INTERMEDIATE_LAYER_IDX: dict[str, list[int]] = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
    "vitt": [0, 1, 2, 3],
}

PATCH_SIZE = 14
POS_GRID = 37  # pretrained pos-embed grid (518 / 14)
LN_EPS = 1e-6


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (f32 params cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm`` applied in x's dtype (statistics in f32 inside torch)."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _tp_in(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a split projection: the gathered token axis under
    sequence parallelism, else the replicated stream."""
    if tp.seq_parallel:
        return meshlib.gather_rows(x, tp.group, tp.sizes, dim=1,
                                   partial=True)
    return meshlib.copy_to_partials(x, tp.group)


def _tp_out(y: torch.Tensor, bias: torch.Tensor, tp) -> torch.Tensor:
    """The sum of a row-split projection's partial outputs (this rank's
    token slot under sequence parallelism), its bias added once."""
    if tp.seq_parallel:
        y = meshlib.scatter_rows(y, tp.group, tp.sizes, dim=1)
    else:
        y = meshlib.reduce_to_replicas(y, tp.group)
    return y + bias.to(y.dtype)


def _dense(x: torch.Tensor, weight: torch.Tensor, bias, quant: bool
           ) -> torch.Tensor:
    if quant:
        return int8_dense(x, weight, bias)
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.tp = None

    def tp_width(self) -> tuple[str, int]:
        """What tensor parallelism splits, and its size."""
        return "MLP width", self.fc2.in_features

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        tp = self.tp
        if tp is not None:  # fc1's rows and fc2's columns are this rank's
            h = F.gelu(_dense(_tp_in(x, tp), self.fc1.weight, self.fc1.bias,
                              quant))
            return _tp_out(_dense(h, self.fc2.weight, None, quant),
                           self.fc2.bias, tp)
        if quant:
            h = F.gelu(int8_dense(x, self.fc1.weight, self.fc1.bias))
            return int8_dense(h, self.fc2.weight, self.fc2.bias)
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


def swiglu_hidden(dim: int, ratio: float = 4.0) -> int:
    """DINOv2 SwiGLUFFNFused hidden width: 2/3 of the MLP hidden, rounded
    up to a multiple of 8 (vitg: 1536 -> 4096)."""
    return (int(dim * ratio * 2 / 3) + 7) // 8 * 8


class SwiGLU(nn.Module):
    """Fused-SwiGLU FFN (DINOv2 ``SwiGLUFFNFused``): ``w12`` packs the gate
    and value projections, ``w3`` projects back. The names are the DAv2
    checkpoint keys (``mlp.w12``, ``mlp.w3``)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden_dim)
        self.w3 = nn.Linear(hidden_dim, dim)
        self.tp = None

    def tp_width(self) -> tuple[str, int]:
        return "SwiGLU width", self.w3.in_features

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        tp = self.tp
        if tp is not None:  # this rank's gate and value rows, w3's columns
            x1, x2 = _dense(_tp_in(x, tp), self.w12.weight, self.w12.bias,
                            quant).chunk(2, dim=-1)
            return _tp_out(_dense(F.silu(x1) * x2, self.w3.weight, None,
                                  quant), self.w3.bias, tp)
        if quant:
            x1, x2 = int8_dense(x, self.w12.weight,
                                self.w12.bias).chunk(2, dim=-1)
            return int8_dense(F.silu(x1) * x2, self.w3.weight, self.w3.bias)
        x1, x2 = linear(x, self.w12).chunk(2, dim=-1)
        return linear(F.silu(x1) * x2, self.w3)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.tp = None

    def tp_width(self) -> tuple[str, int]:
        return "heads", self.num_heads

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        tp = self.tp
        if tp is not None:  # qkv's rows (3, H/tp, D) and proj's columns
            y = attn_ops.qkv_self_attention(
                _tp_in(x, tp), self.qkv.weight, self.qkv.bias,
                self.proj.weight, None, self.num_heads // tp.size,
                quant=quant)
            return _tp_out(y, self.proj.bias, tp)
        return attn_ops.qkv_self_attention(
            x, self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias, self.num_heads, quant=quant)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn: str = "mlp"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        if ffn == "swiglu":
            self.mlp = SwiGLU(dim, swiglu_hidden(dim))
        elif ffn == "mlp":
            self.mlp = Mlp(dim, 4 * dim)
        else:
            raise ValueError(f"unknown ffn: {ffn!r}")
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, quant: bool = False,
                scope: str = "auto") -> torch.Tensor:
        """``quant`` takes the projections of ``scope`` in W8A8; ``auto``
        quantizes attention too while the batch is at most 32."""
        if scope == "auto":
            scope = "all" if x.shape[0] <= 32 else "mlp"
        attn_q = quant and scope in ("all", "attn")
        mlp_q = quant and scope in ("all", "mlp")
        x = x + self.ls1(self.attn(layer_norm(x, self.norm1), attn_q))
        return x + self.ls2(self.mlp(layer_norm(x, self.norm2), mlp_q))


def _torch_bicubic_matrix(out_size: int, in_size: int,
                          offset: float = 0.1) -> np.ndarray:
    """(out, in) interpolation matrix matching torch ``F.interpolate``
    bicubic with DINOv2's ``interpolate_offset`` semantics: the scale is
    the GIVEN ``(out + offset) / in`` factor (not out/in), cubic kernel
    A = -0.75, ``antialias=False``, edge-clamped taps."""
    a = -0.75
    scale = float(out_size + offset) / in_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        # cubic convolution weights at distances (1+t, t, 1-t, 2-t)
        d = np.array([1.0 + t, t, 1.0 - t, 2.0 - t])
        ad = np.abs(d)
        wt = np.where(
            ad <= 1.0, (a + 2.0) * ad ** 3 - (a + 3.0) * ad ** 2 + 1.0,
            a * ad ** 3 - 5.0 * a * ad ** 2 + 8.0 * a * ad - 4.0 * a)
        for k in range(4):
            j = min(max(i0 - 1 + k, 0), in_size - 1)
            w[i, j] += wt[k]
    return w


@device_cache(maxsize=64)
def _bicubic_tensor(out_size: int, in_size: int,
                    device: torch.device) -> torch.Tensor:
    """``_torch_bicubic_matrix`` on the device, uploaded once per shape and
    never while tracing (``device_cache``); outside inference mode, so
    training may save it for backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_torch_bicubic_matrix(out_size, in_size)).to(
            device)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int,
                          grid_w: int) -> torch.Tensor:
    """Resize the (1, 1+S*S, C) pos-embed to a (grid_h, grid_w) patch grid
    (bicubic on the patch grid in f32, cls slot kept), with the numerics
    of DINOv2's ``interpolate_pos_encoding``."""
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:]
    n = patch_pe.shape[1]
    src = int(round(float(n) ** 0.5))
    if (grid_h, grid_w) == (src, src):
        return pos_embed
    c = patch_pe.shape[-1]
    grid = patch_pe.reshape(src, src, c).float()
    wh = _bicubic_tensor(grid_h, src, grid.device)
    ww = _bicubic_tensor(grid_w, src, grid.device)
    out = torch.einsum("hm,mnc->hnc", wh, grid)
    out = torch.einsum("wn,hnc->hwc", ww, out).to(pos_embed.dtype)
    return torch.cat([cls_pe, out.reshape(1, grid_h * grid_w, c)], dim=1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH_SIZE, stride=PATCH_SIZE)


class DinoViT(nn.Module):
    """DINOv2 ViT trunk exposing DAv2-style intermediate features. ``ffn``
    overrides the encoder's FFN ("mlp" or "swiglu"); "" takes it from
    ``VIT_ARCHS`` (swiglu for vitg). ``token_merge``, ``quant_int8`` and
    ``quant_scope`` are the speed dials (module docstring)."""

    def __init__(self, encoder: str = "vitl",
                 dtype: torch.dtype = POLICY_BF16.compute_dtype,
                 grad_checkpoint: bool = False, ffn: str = "",
                 token_merge: float = 0.0, quant_int8: bool = False,
                 quant_scope: str = "auto"):
        super().__init__()
        arch = VIT_ARCHS[encoder]
        ffn = ffn or arch.get("ffn", "mlp")
        dim = arch["embed_dim"]
        pos_grid = POS_GRID if encoder != "vitt" else 4
        self.encoder = encoder
        self.dtype = dtype
        self.grad_checkpoint = grad_checkpoint
        self.token_merge = token_merge
        self.quant_int8 = quant_int8
        self.quant_scope = quant_scope
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        # In the checkpoints; unused at inference.
        self.mask_token = nn.Parameter(torch.zeros(1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid ** 2, dim))
        self.blocks = nn.ModuleList(Block(dim, arch["num_heads"], ffn)
                                    for _ in range(arch["depth"]))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.tp = None

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """Patch embed, cls token and pos-embed: (B, 1 + N, C)."""
        b, h, w, _ = img.shape
        gh, gw = h // PATCH_SIZE, w // PATCH_SIZE
        proj = self.patch_embed.proj
        x = F.conv2d(img.permute(0, 3, 1, 2).to(self.dtype),
                     proj.weight.to(self.dtype), proj.bias.to(self.dtype),
                     stride=PATCH_SIZE)
        x = x.flatten(2).transpose(1, 2)                     # (B, N, C)
        cls = self.cls_token.to(self.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        return x + interpolate_pos_embed(self.pos_embed, gh, gw).to(
            self.dtype)

    def forward(self, img: torch.Tensor, tap_indices: list[int] | None = None
                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """img: (B, H, W, 3), H/W multiples of 14, already normalized.

        Returns [(patch_tokens (B, N, C), cls_token (B, C)), ...] per tap,
        each with the final LayerNorm applied."""
        taps = tap_indices or INTERMEDIATE_LAYER_IDX[self.encoder]
        x = self.embed(img)
        tp = self.tp
        seq = tp is not None and tp.seq_parallel
        if seq:
            if self.token_merge > 0:
                raise ValueError("seq_parallel does not compose with "
                                 "token_merge")
            tp.sizes = tp.token_sizes(x.shape[1])
            x = meshlib.slot_of(x, tp.group, tp.sizes, dim=1)

        outputs: dict[int, torch.Tensor] = {}
        remat = (self.grad_checkpoint and self.training
                 and torch.is_grad_enabled())
        dials = (self.quant_int8, self.quant_scope)
        merge_after = min(taps) if self.token_merge > 0 and taps else None
        slot_map = None
        merged_taps: set[int] = set()
        for i, block in enumerate(self.blocks):
            x = checkpoint(block, x, *dials, use_reentrant=False) if remat \
                else block(x, *dials)
            if i in taps:
                outputs[i] = (meshlib.gather_rows(x, tp.group, tp.sizes,
                                                  dim=1) if seq else x)
                if slot_map is not None:
                    merged_taps.add(i)
            if i == merge_after:
                x, slot_map = bipartite_merge(x, self.token_merge)
        results = []
        for i in taps:
            y = layer_norm(outputs[i], self.norm)
            if i in merged_taps:
                y = unmerge(y, slot_map)
            results.append((y[:, 1:], y[:, 0]))
        return results
