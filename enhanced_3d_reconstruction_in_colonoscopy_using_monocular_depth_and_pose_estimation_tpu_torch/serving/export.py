"""Ahead-of-time export of the serving program (the JAX package's
``serving/export.py`` on ``torch.export``).

The complete inference program (bicubic resize to the network size,
ImageNet normalisation, the forward pass, the align-corners resize back
to the camera resolution: ``models.depth_anything._run_batched``) is
traced once at a fixed (batch, H, W) and saved as a ``torch.export``
artifact. A serving process replays it through ``load_exported``: no
model code and no re-trace, the same graph of ATen ops and kernel ops
(``e3d::*``, ``ops/flash_attention.py``, ``ops/resize.py``,
``ops/quant.py``) every time. The forward schedule (K1, K4 or K5) and the
decoder's resize (K6 where ``ops.resize.takes_lerp`` says so: on the card
by default, being traced without autograd) are fixed at export.

Parameters stay out of the artifact: they are call-time inputs keyed by
state-dict name, so the checkpoint stays the one source of weights. The
example inputs, which hold the parameters too, are dropped before the
save; what remains are the program and its constants (the resize
matrices, a calibrated int8 amax vector).

Artifact layout: ``<path>`` holds the saved program; ``<path>.json``
records the model config, the shapes, the device type it was traced on,
the fixed kernels, and the parameter manifest.

``--train`` has no counterpart: the port's training step runs eagerly,
so there is no compile for a saved step to skip (ROADMAP §3).
"""

from __future__ import annotations

import io
import json
import os
from typing import Mapping

import numpy as np
import torch
from torch import nn


class _Body(nn.Module):
    """``_run_batched``'s body over a registered model, so that
    ``functional_call`` can put call-time params in its place."""

    def __init__(self, model, net_hw: tuple[int, int],
                 out_hw: tuple[int, int]):
        super().__init__()
        self.model = model
        self.net_hw = tuple(net_hw)
        self.out_hw = tuple(out_hw)

    def forward(self, rgb01: torch.Tensor) -> torch.Tensor:
        from ..models.depth_anything import _run_batched

        return _run_batched.__wrapped__(self.model, rgb01, self.net_hw,
                                        self.out_hw)


class _Program(nn.Module):
    """(params, rgb01 (B, H, W, 3) f32 in [0, 1]) -> (B, H, W) f32 depth.

    The body is held outside the module tree, so its weights are no state
    of an exported program; ``amax`` (a calibrated int8 vector) runs the
    body under frozen scales, a constant of the export."""

    def __init__(self, model, net_hw, out_hw, amax=None):
        super().__init__()
        object.__setattr__(self, "_body", _Body(model, net_hw, out_hw))
        object.__setattr__(self, "amax", amax)

    def forward(self, params: dict[str, torch.Tensor],
                rgb01: torch.Tensor) -> torch.Tensor:
        from ..ops.quant import frozen_scales

        named = {"model." + k: v for k, v in params.items()}
        with torch.no_grad():
            if self.amax is None:
                return torch.func.functional_call(self._body, named,
                                                  (rgb01,))
            with frozen_scales(self.amax):
                return torch.func.functional_call(self._body, named,
                                                  (rgb01,))


def _program(model, net_hw: tuple[int, int], out_hw: tuple[int, int]
             ) -> _Program:
    """The exact ``_run_batched`` serving program as a module called
    ``(params, rgb01)``, the params keyed by state-dict name."""
    return _Program(model, net_hw, out_hw)


def lerp_resize_nodes(ep: torch.export.ExportedProgram) -> int:
    """How many K6 launches (``e3d::lerp_resize`` calls) the exported
    program holds, in its graph and every submodule's."""
    target = torch.ops.e3d.lerp_resize.default
    return sum(node.op == "call_function" and node.target is target
               for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for node in gm.graph.nodes)


def _params_device(params: Mapping[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def export_depth_program(model, params: Mapping[str, torch.Tensor],
                         path: str, frame_hw: tuple[int, int],
                         batch_size: int = 8, input_size: int = 518,
                         calib_frames=None, calib_batches: int = 0) -> dict:
    """Export the batched inference program of ``model`` at a fixed camera
    resolution, traced on the device ``params`` (its state dict) lie on.
    Returns the metadata dict (also written to ``<path>.json``).

    ``calib_batches > 0`` (``model.quant_int8`` and ``calib_frames``: BGR
    uint8 frames at ``frame_hw``): static int8 calibration at export time.
    The per-site activation abs-max vector of the first K batches is
    measured live, baked into the exported program as a constant and
    recorded in the sidecar (``int8_calib_amax``); the artifact then
    serves with frozen scales."""
    from ..models.depth_anything import _lower_bound_hw, chunk_rgb01
    from ..models.dinov2 import VIT_ARCHS
    from ..ops.flash_attention import forward_schedule
    from ..ops.quant import calibrate_scales

    h, w = int(frame_hw[0]), int(frame_hw[1])
    net_hw = _lower_bound_hw(h, w, input_size)
    device = _params_device(params)
    prog = _program(model, net_hw, (h, w))

    amax = None
    if calib_batches > 0:
        if not model.quant_int8:
            raise ValueError("calib_batches requires quant_int8=True")
        if not calib_frames:
            raise ValueError("calib_batches > 0 requires calib_frames")
        for fr in calib_frames:
            if tuple(np.shape(fr)[:2]) != (h, w):
                raise ValueError(
                    f"calibration frames must match frame_hw ({h}, {w}); "
                    f"got {np.shape(fr)[:2]}")
        calib = [torch.from_numpy(arr).to(device) for arr, _ in chunk_rgb01(
            list(calib_frames)[:calib_batches * batch_size], batch_size)]
        amax = calibrate_scales(lambda x, p: prog(p, x), calib, params)
        prog = _Program(model, net_hw, (h, w), amax)

    image = torch.zeros((int(batch_size), h, w, 3), dtype=torch.float32,
                        device=device)
    ep = torch.export.export(prog, (dict(params), image), strict=False)
    # The example inputs hold every parameter: they stay out. So do the
    # nodes' Python stack traces, half of the saved graph, and the
    # dtype asserts the trace puts before each cast: a replay checks every
    # input's shape and dtype on entry, and each assert would be one more
    # op to dispatch per cast (about 400 a vitl batch).
    ep.example_inputs = None
    dtype_assert = torch.ops.aten._assert_tensor_metadata.default
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in list(gm.graph.nodes):
                node.meta.pop("stack_trace", None)
                if node.target is dtype_assert:
                    gm.graph.erase_node(node)
            gm.recompile()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    data = buf.getvalue()

    encoder = model.pretrained.encoder
    heads = VIT_ARCHS[encoder]["num_heads"]
    meta = {
        "format": "torch.export",
        "encoder": encoder,
        "max_depth": float(model.max_depth),
        "frame_hw": [h, w],
        "net_hw": list(net_hw),
        "batch_size": int(batch_size),
        "input_size": int(input_size),
        "platforms": [device.type],
        # Every model field that changes the traced graph.
        "dtype": str(model.pretrained.dtype).removeprefix("torch."),
        "quant_int8": bool(model.quant_int8),
        "quant_scope": str(model.pretrained.quant_scope),
        "quant_dpt": bool(model.depth_head.quant),
        "token_merge": float(model.pretrained.token_merge),
        "int8_calib_batches": int(calib_batches),
        "int8_calib_amax": (None if amax is None
                            else [float(v) for v in amax.cpu().numpy()]),
        # The kernels fixed at export: on the CPU every op is its plain
        # version.
        "forward_schedule": (forward_schedule(int(batch_size) * heads)
                             if device.type == "cuda" else "plain"),
        # What the traced program holds: its decoder resizes on K6 or not.
        "pallas_resize": lerp_resize_nodes(ep) > 0,
        "lerp_resize_nodes": lerp_resize_nodes(ep),
        "artifact_bytes": len(data),
        "param_manifest": {k: [list(v.shape),
                               str(v.dtype).removeprefix("torch.")]
                           for k, v in params.items()},
    }
    # Both files atomically, artifact first, then the sidecar: a crash
    # between the two leaves the old sidecar, never a truncated program.
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    tmp = path + ".json.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path + ".json")
    return meta


class ExportedDepthProgram:
    """A loaded export: ``prog(params, rgb01)`` with the sidecar's shape,
    device and manifest checks."""

    def __init__(self, path: str):
        # The kernel ops must be registered before the program loads.
        from ..ops import flash_attention, quant, resize  # noqa: F401

        self.program = torch.export.load(path)
        with open(path + ".json", encoding="utf-8") as f:
            self.meta = json.load(f)
        self._module = self.program.module()

    def __call__(self, params: Mapping[str, torch.Tensor], rgb01
                 ) -> torch.Tensor:
        """params: the state dict the program was exported against, on a
        device of the type it was traced on; rgb01: (batch_size, H, W, 3)
        f32 in [0, 1], numpy or a tensor. Returns (B, H, W) f32 metric
        depth on the params' device."""
        b, h, w = (self.meta["batch_size"], *self.meta["frame_hw"])
        if tuple(np.shape(rgb01)) != (b, h, w, 3):
            raise ValueError(
                f"exported program is fixed-shape ({b}, {h}, {w}, 3); "
                f"got {np.shape(rgb01)}")
        device = _params_device(params)
        traced_on = self.meta["platforms"]
        if device.type not in traced_on:
            raise ValueError(f"exported program was traced on {traced_on}; "
                             f"the params lie on {device.type}")
        manifest = self.meta["param_manifest"]
        missing = sorted(set(manifest) - set(params))
        extra = sorted(set(params) - set(manifest))
        if missing or extra:
            raise ValueError(f"params do not match the export's manifest: "
                             f"missing {missing[:5]}, unexpected "
                             f"{extra[:5]}")
        # The program's inputs in the manifest's (the export's) order.
        ordered = {k: params[k] for k in manifest}
        x = torch.as_tensor(rgb01).to(device=device, dtype=torch.float32)
        with torch.inference_mode():
            return self._module(ordered, x)


def load_exported(path: str) -> ExportedDepthProgram:
    return ExportedDepthProgram(path)


def exported_runner(prog: ExportedDepthProgram,
                    params: Mapping[str, torch.Tensor]):
    """Adapt an exported program to the ``DepthServingEngine`` runner
    contract (``list[BGR uint8] -> list[(H, W) f32 depth]``), padding
    ragged tails to the exported batch size so the artifact's one shape
    serves any request count. Frames go up as uint8 and become RGB in
    [0, 1] on the device, as ``BatchedRunner``'s do, so a replay and the
    live runner see the same inputs."""
    from ..models.depth_anything import chunk_bgr_u8, rgb01_of_bgr_u8

    b = int(prog.meta["batch_size"])
    h, w = prog.meta["frame_hw"]
    device = _params_device(params)

    def run(frames):
        for f in frames:
            if tuple(np.shape(f)) != (h, w, 3):
                raise ValueError(
                    f"exported program serves ({h}, {w}, 3) frames; "
                    f"got {np.shape(f)}")
        out: list[np.ndarray] = []
        for arr, n in chunk_bgr_u8(frames, b):
            rgb01 = rgb01_of_bgr_u8(torch.from_numpy(arr).to(device))
            out.extend(prog(params, rgb01)[:n].cpu().numpy())
        return out

    return run
