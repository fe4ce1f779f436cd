#!/usr/bin/env python3
"""Convert the JAX package's Orbax checkpoints into a torch state dict for
the PyTorch port.

The JAX package's training entry points (``train_depth``, ``train_pose``)
write their checkpoints with its ``core.checkpoint.CheckpointManager``:
best-k by val_loss plus a ``latest/`` slot, each step an Orbax directory.
The port reads torch files only (it does not import jax), so this tool,
which needs jax and orbax, turns one saved step into a ``.pth`` that
every port entry point loads (``--load-from``, ``model.load_from``,
``CHECKPOINT_PATH``, ``PoseTask.init_state(weights=...)``):

    python orbax_to_torch.py --kind depth -i checkpoints/simcol/<run> \\
        -o vitl_finetuned.pth [--select best|latest|<step>]

``--select best`` (the default) takes the best save by val_loss, falling
back to the newest when none carries a metric, as the JAX package's
``restore_best_untyped`` does; ``latest`` the newest save across both
stores (``restore_latest_untyped``); a number that step, from whichever
store holds it. Every leaf is read as a host array, so a checkpoint
written on any device mesh converts. ``--kind depth`` writes the DAv2
state dict (``models.convert.from_jax_params`` of the port), ``--kind
pose`` the pose net's with its BatchNorm statistics
(``from_jax_pose_variables``).
"""

from __future__ import annotations

import argparse
import os
import sys

JAX_PACKAGE = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
               "depth_and_pose_estimation_tpu")
PORT = JAX_PACKAGE + "_torch"


def saved_steps(directory: str) -> list[int]:
    """The steps of both stores (the best-k store's step directories and
    ``latest/``'s), read from the directory names."""
    steps = set()
    for store in (directory, os.path.join(directory, "latest")):
        if os.path.isdir(store):
            steps.update(int(d) for d in os.listdir(store)
                         if d.isdigit() and os.path.isdir(
                             os.path.join(store, d)))
    return sorted(steps)


def restore(directory: str, select: str = "best") -> tuple[dict, int]:
    """The untyped tree of the selected save (nested dicts of numpy
    arrays) and its step. A missing directory or step raises before jax
    is imported."""
    import importlib

    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    if select not in ("best", "latest") and \
            int(select) not in saved_steps(directory):
        raise FileNotFoundError(f"no step {int(select)} in {directory} "
                                f"(saved: {saved_steps(directory)})")
    ckpt = importlib.import_module(f"{JAX_PACKAGE}.core.checkpoint")
    mgr = ckpt.CheckpointManager(directory)
    try:
        if select == "best":
            step = mgr.best_step()
            if step is None:
                step = mgr.latest_step()
            tree = mgr.restore_best_untyped()
        elif select == "latest":
            step = mgr.latest_step()
            tree = mgr.restore_latest_untyped()
        else:
            step = int(select)
            stores = [mgr._mgr, mgr._get_latest_mgr(create=False)]
            owner = next((m for m in stores
                          if m is not None and step in m.all_steps()), None)
            if owner is None:
                raise FileNotFoundError(
                    f"no step {step} in {directory} (saved: "
                    f"{sorted(s for m in stores if m for s in m.all_steps())}"
                    ")")
            tree = mgr._restore_untyped(owner, step)
    finally:
        mgr.close()
    if tree is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    if not isinstance(tree, dict):
        tree = dict(vars(tree))
    return tree, int(step)


def convert(tree: dict, kind: str) -> dict:
    """The port's state dict of a restored depth or pose train state."""
    import importlib

    import numpy as np

    conv = importlib.import_module(f"{PORT}.models.convert")

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return np.asarray(node)

    if kind == "depth":
        return conv.from_jax_params(host(tree["params"]))
    if kind == "pose":
        return conv.from_jax_pose_variables(
            {"params": host(tree["params"]),
             "batch_stats": host(tree.get("batch_stats", {}))})
    raise ValueError(f"unknown kind {kind!r}; expected depth or pose")


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", choices=("depth", "pose"), default="depth")
    p.add_argument("-i", "--input", required=True,
                   help="the JAX package's checkpoint directory")
    p.add_argument("-o", "--output", required=True,
                   help="the torch state dict to write (.pth)")
    p.add_argument("--select", default="best",
                   help="best (default), latest, or a step number")
    args = p.parse_args(argv)
    tree, step = restore(args.input, args.select)
    state = convert(tree, args.kind)

    import torch

    out_dir = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(out_dir, exist_ok=True)
    torch.save(state, args.output)
    print(f"[orbax_to_torch] {args.kind} step {step} ({args.select}): "
          f"{len(state)} tensors -> {args.output}")
    return {"step": step, "keys": len(state), "output": args.output}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
