"""GPipe and interleaved pipeline parallelism for the ViT trunk (the JAX
package's ``parallel/pipeline.py``).

The ``model`` axis of the mesh is the pipeline: the rank at model index
``d`` is stage ``d``. The schedule is the JAX package's tick loop, written
out by hand:

- the blocks split into ``stages * virtual`` chunks of consecutive
  blocks; stage ``d`` owns chunks ``d, d + S, ...``. A microbatch at ring
  position ``j = tick - m`` sits on stage ``j mod S`` running chunk ``j``
  (``virtual > 1`` is the interleaved schedule and needs ``n_micro <=
  stages``, so no stage has two microbatches due in one tick);
- after each tick every stage hands its output to the next around the
  ring (``isend``/``irecv`` in one batch, wrapped in an autograd function
  whose backward hands the gradient back the other way);
- the DPT head reads four intermediate blocks, so each stage keeps the
  outputs of the tap blocks it owns, in their (tap, microbatch) slot, and
  one all-reduce over the model group merges the slots (each is written
  by exactly one stage);
- bubble ticks compute nothing: they pass on zeros. Every exchanged
  buffer stays on the path to the output (with weight zero where it is
  not used), so every rank runs every exchange's backward, in the same
  order, and no rank waits on a peer that skipped one.

Each rank holds the whole model (the checkpoint layout) and runs only its
own chunks' blocks. The head runs after the schedule on this rank's slot
of the batch when the model group divides the batch (the JAX package's
head over the flattened mesh), else on the whole batch on every stage.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from . import mesh as meshlib


def stack_block_params(vit_state: Mapping[str, torch.Tensor], depth: int
                       ) -> dict[str, torch.Tensor]:
    """``blocks.{i}.<name>`` entries of an encoder state dict, for ``i <
    depth``, stacked into ``<name>`` tensors with a leading ``depth``
    dim."""
    names = [k[len("blocks.0."):] for k in vit_state
             if k.startswith("blocks.0.")]
    return {n: torch.stack([vit_state[f"blocks.{i}.{n}"]
                            for i in range(depth)]) for n in names}


def unstack_block_params(stacked: Mapping[str, torch.Tensor], depth: int
                         ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`stack_block_params`."""
    return {f"blocks.{i}.{n}": t[i] for n, t in stacked.items()
            for i in range(depth)}


class _Ring(torch.autograd.Function):
    """Send ``x`` to the next stage and receive the previous stage's; the
    backward sends the gradient to the previous stage and receives the
    next stage's."""

    @staticmethod
    def forward(ctx, x, nxt, prv):
        ctx.peers = (nxt, prv)
        return _exchange(x, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        nxt, prv = ctx.peers
        return _exchange(g, prv, nxt), None, None


def _exchange(x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst),
                                       dist.P2POp(dist.irecv, out, src)]):
        req.wait()
    return out


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def pipeline_vit_taps(block_apply: Callable[[int, torch.Tensor],
                                            torch.Tensor],
                      depth: int, x: torch.Tensor, taps: list[int],
                      mesh: meshlib.Mesh, stages: int, n_micro: int,
                      virtual: int = 1) -> torch.Tensor:
    """Run ``depth`` blocks as a ``stages``-deep pipeline over the model
    group.

    ``block_apply(i, h)`` applies block ``i``; ``x`` (B, T, C) is this
    rank's data shard of the embedded tokens; ``taps`` are the block
    indices whose outputs feed the head. Returns (n_taps, B, T, C), the
    same on every stage."""
    chunks = stages * virtual
    if depth % chunks:
        raise ValueError(f"depth {depth} not divisible by {stages} stages "
                         f"x {virtual} virtual chunks")
    lpc = depth // chunks
    if mesh.model != stages:
        raise ValueError(f"pipeline stages={stages} != mesh model axis "
                         f"{mesh.model}")
    if virtual > 1 and n_micro > stages:
        raise ValueError(
            f"interleaved schedule needs n_micro <= stages ({n_micro} > "
            f"{stages}): two microbatches would be due on one device in "
            "the same tick")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b * mesh.data} must divide data axis "
                         f"{mesh.data} x microbatches {n_micro}")
    d = mesh.model_index
    ranks = [mesh.data_index * stages + s for s in range(stages)]
    nxt, prv = ranks[(d + 1) % stages], ranks[(d - 1) % stages]
    mb = b // n_micro
    micro = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    slot = {g: k for k, g in enumerate(taps)}
    acc: list[list[torch.Tensor | None]] = [[None] * n_micro for _ in taps]
    grad = torch.is_grad_enabled()
    buf = x.new_zeros((mb,) + tuple(x.shape[1:]))
    if grad:
        buf.requires_grad_(True)
    sink = buf.sum() * 0
    ticks = chunks + n_micro - 1
    for t in range(ticks):
        live = [v for v in range(virtual)
                if 0 <= t - (d + v * stages) < n_micro]
        if live:
            v = live[0]
            m = t - (d + v * stages)
            # Chunk 0 starts a microbatch; every other chunk continues
            # what the ring delivered.
            h = micro[m] + buf * 0 if (d == 0 and v == 0) else buf
            for gid in range((v * stages + d) * lpc,
                             (v * stages + d + 1) * lpc):
                h = block_apply(gid, h)
                if gid in slot:
                    acc[slot[gid]][m] = h
            out = h
        else:
            out = buf * 0
        if t < ticks - 1:
            buf = _Ring.apply(out, nxt, prv) if grad else \
                _exchange(out, nxt, prv)
            sink = sink + buf.sum() * 0
    zeros = x.new_zeros((mb,) + tuple(x.shape[1:]))
    local = torch.stack([torch.cat([a if a is not None else zeros
                                    for a in row]) for row in acc])
    return meshlib.all_reduce_sum(local + sink, mesh.model_group)


def build_pp_depth_forward(model, mesh: meshlib.Mesh, stages: int,
                           n_micro: int, virtual: int = 1):
    """``image -> depth`` of ``model`` (a ``DepthAnythingV2``) with its ViT
    trunk pipelined: the embedding and the head's glue are the model's
    own modules, so the numerics are the plain forward's. Under gradient
    checkpointing each block is recomputed in the backward (the plain
    path's boundary)."""
    from ..models.dinov2 import (INTERMEDIATE_LAYER_IDX, PATCH_SIZE,
                                 layer_norm)

    vit = model.pretrained
    taps = INTERMEDIATE_LAYER_IDX[vit.encoder]
    group = mesh.model_group

    def forward(image: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = image.shape
        x = vit.embed(image)
        remat = vit.grad_checkpoint and vit.training and \
            torch.is_grad_enabled()

        def block_apply(gid: int, t: torch.Tensor) -> torch.Tensor:
            blk = vit.blocks[gid]
            if remat:
                return checkpoint(blk, t, use_reentrant=False)
            return blk(t)

        acts = pipeline_vit_taps(block_apply, len(vit.blocks), x, taps,
                                 mesh, stages, n_micro, virtual)
        b = x.shape[0]
        sizes = meshlib.even_sizes(b, mesh.model)
        shard = mesh.model > 1 and b % mesh.model == 0
        if shard:
            acts = meshlib.slot_of(acts, group, sizes, dim=1)
        results = []
        for k in range(len(taps)):
            y = layer_norm(acts[k], vit.norm)
            results.append((y[:, 1:], y[:, 0]))
        depth = model.depth_head(results, h // PATCH_SIZE,
                                 w // PATCH_SIZE) * model.max_depth
        if shard:
            return meshlib.gather_rows(depth, group, sizes)
        # Every stage computed the whole loss: each keeps 1/stages of its
        # gradient, whose sum over the model group is the gradient.
        return _ScaleGrad.apply(depth, 1.0 / mesh.model)

    return forward
