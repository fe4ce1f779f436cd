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

The depth training step exports too (``export_train_step``, after the
JAX package's): one optimizer step ``(state, batch) -> (state, metrics)``
over the full grad-accum window, at a fixed microbatch and image size, on
the replicated single-card task. ``torch.export`` cannot trace through
``torch.autograd.grad`` itself, so ``make_fx`` first traces the two
halves of the task's functional step
(``train.depth_task.FunctionalDepthStep``) into graphs of ATen and kernel
ops: one microbatch (its forward, the blocks that gradient checkpointing
recomputes, the backward) and the update (the clip and AdamW); then
``torch.export`` exports each, and both are saved in one archive. The
replay runs the microbatch program once for each microbatch, as
``train_step`` runs them, so the graph does not grow with the window.
The attention forward (K1, or K4/K5 under their knobs) and backward (K2,
or K3 under ``E3D_FLASH_BWD_FUSED=0``) are nodes of the microbatch
program, fixed at export; a training forward keeps the matmul resize, so
the step holds no K6. The parameters, the AdamW moments and the step
stay call-time inputs, and ``ExportedTrainStep`` writes the result back
into a ``DepthTrainState`` in ``torch.optim.AdamW``'s own layout, so the
checkpoint stays the one source of state and an eager step can follow a
replayed one.

Artifact layout: ``<path>`` is a zip of ``microbatch.pt2`` and
``update.pt2``, each a saved program; ``<path>.json`` records the task,
the shapes, the schedule, the device type, the fixed kernels, the
update's chunks and the state manifest.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import time
import zipfile
from typing import Any, Mapping

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
    return op_nodes(ep, torch.ops.e3d.lerp_resize.default)


def op_nodes(ep: torch.export.ExportedProgram, target) -> int:
    """How many calls of the op ``target`` the exported program holds, in
    its graph and every submodule's."""
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
    with _no_stack_traces():
        ep = torch.export.export(prog, (dict(params), image), strict=False)
    data = _saved(ep)

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
    _write(path, data, meta)
    return meta


@contextlib.contextmanager
def _no_stack_traces():
    """``torch.export`` without the Python stack trace of every node. A
    saved artifact drops them anyway (``_saved``), and collecting them
    (some fifty frames and their source lines a node) was half of a
    training-step export's time at vitl on the card's host. A newer
    torch has the switch (``torch.fx.config.do_not_emit_stack_traces``);
    on an older one the traces are captured empty, as when the
    interpreter has no frames."""
    from torch.fx import config
    from torch.utils._traceback import CapturedTraceback

    def empty(*, script=False, cpp=False, skip=0):
        return CapturedTraceback(None)

    saved = (getattr(config, "do_not_emit_stack_traces", None),
             CapturedTraceback.__dict__["extract"])
    config.do_not_emit_stack_traces = True
    CapturedTraceback.extract = staticmethod(empty)
    try:
        yield
    finally:
        CapturedTraceback.extract = saved[1]
        if saved[0] is None:
            del config.do_not_emit_stack_traces
        else:
            config.do_not_emit_stack_traces = saved[0]


def _saved(ep: torch.export.ExportedProgram) -> bytes:
    """``ep`` saved, without what a replay does not need. The example
    inputs hold every parameter: they stay out. So do the nodes' Python
    stack traces, half of the saved graph, and the dtype asserts the trace
    puts before each cast: a replay checks every input's shape and dtype
    on entry, and each assert would be one more op to dispatch per cast
    (about 400 a vitl batch)."""
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
    return buf.getvalue()


def _write(path: str, data: bytes, meta: dict) -> None:
    """Both files atomically, artifact first, then the sidecar: a crash
    between the two leaves the old sidecar, never a truncated program."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    tmp = path + ".json.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path + ".json")


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


# ------------------------------------------------ the training step

_TRAIN_KEYS = ("image", "depth", "max_depth", "weight")
# The two programs of a training-step artifact, by their names in it.
_TRAIN_PROGRAMS = ("microbatch", "update")


def _train_batch_shapes(meta: Mapping[str, Any]) -> dict[str, tuple]:
    """The batch an exported training step takes: key -> shape."""
    a, mb, (h, w) = meta["grad_accum"], meta["microbatch"], meta["image_hw"]
    shapes = {"image": (a, mb, h, w, 3), "depth": (a, mb, h, w, 1)}
    if meta["with_max_depth"]:
        shapes["max_depth"] = (a, mb)
    if meta["with_weight"]:
        shapes["weight"] = (a,)
    return shapes


def _joined(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One chunk's tensors as one flat tensor: their common base when
    they are its consecutive views (the layout a replay leaves behind),
    else a flattened copy. Taking the base keeps a replay that follows a
    replay from holding the moments twice (2.7 GB more at vitl)."""
    from ..train.optim import flatten

    base = tensors[0]._base
    if base is not None and base.dim() == 1 and base.numel() == sum(
            t.numel() for t in tensors):
        offset = base.storage_offset()
        for t in tensors:
            if (t._base is not base or t.storage_offset() != offset
                    or not t.is_contiguous()):
                break
            offset += t.numel()
        else:
            return base
    return flatten(tensors)


def _split(flat: torch.Tensor, like: list[torch.Tensor]
           ) -> list[torch.Tensor]:
    """A flat chunk as views shaped as the tensors of ``like``."""
    return [v.view(t.shape) for v, t in zip(
        flat.split([t.numel() for t in like]), like)]


def _export_traced(fn, example: tuple) -> tuple:
    """``fn`` traced by ``make_fx`` on ``example`` (fake tensors made
    from it: nothing runs), then exported and saved: (ExportedProgram,
    bytes, seconds by stage). ``torch.export`` cannot trace through
    ``torch.autograd.grad`` itself; the ``make_fx`` graph holds the
    backward as the ATen and kernel ops it dispatched. Device constants
    (resize matrices, the schedule table) are real tensors, so the trace
    takes them as constants."""
    from torch.fx.experimental.proxy_tensor import make_fx

    t0 = time.perf_counter()
    gm = make_fx(fn, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*example)
    # The trace's detaches (the gradient leaves, autograd's saved
    # tensors) are aliases with nothing to do in a replay.
    detach = torch.ops.aten.detach.default
    for node in list(gm.graph.nodes):
        if node.target is detach:
            node.replace_all_uses_with(node.args[0])
            gm.graph.erase_node(node)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    t1 = time.perf_counter()
    with _no_stack_traces():
        ep = torch.export.export(gm, example, strict=False)
    t2 = time.perf_counter()
    data = _saved(ep)
    return ep, data, {"trace": t1 - t0, "export": t2 - t1,
                      "save": time.perf_counter() - t2}


def export_train_step(task, state, path: str, microbatch: int,
                      image_hw: tuple[int, int],
                      with_max_depth: bool = False,
                      with_weight: bool = False) -> dict:
    """Export one optimizer step of ``task`` (a ``DepthTask``) on
    ``state`` (its ``DepthTrainState``), traced on the task's device, at
    ``grad_accum`` microbatches of ``microbatch`` images of ``image_hw``,
    the batch holding a per-sample ``max_depth`` (A, mb) and a
    per-microbatch ``weight`` (A,) when asked. The task must be the
    replicated single-card one (``DepthTask.functional_train_step`` names
    what it refuses). Returns the metadata dict (also written to
    ``<path>.json``).

    The artifact holds two programs, the halves of
    ``train.depth_task.FunctionalDepthStep``: ``microbatch`` (the
    parameters and one microbatch in; its gradients and the running sums
    of its loss and metrics out), which a replay runs for each microbatch
    as ``train_step`` runs them (``run_microbatches``: weights on the
    host, gradients summed in order), and ``update`` (the parameters, the
    summed gradients, each chunk's two AdamW moments, the step and the
    sums in; each chunk's new parameters and moments, the step + 1 and
    the metrics out). So the graph a replay loads holds one microbatch's
    forward, recompute and backward, whatever the accumulation. The
    traces run nothing (fake tensors: no kernel launches, no device
    memory) and never write the state. The schedule (``total_steps``)
    is baked in as a table (``train.optim``)."""
    from ..models.dinov2 import VIT_ARCHS
    from ..ops import flash_attention as fa

    step = task.functional_train_step(state)
    chunks = step.optimizer.chunks
    device = task.device
    h, w = int(image_hw[0]), int(image_hw[1])
    a, mb = int(task.grad_accum), int(microbatch)
    params = [p.detach() for p in state.optimizer.params]
    n, c = len(params), len(chunks)

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=device)

    # Distinct tensors: make_fx traces one input per tensor object.
    sums = [f32(0.0) for _ in step.SUMS]
    batch = (torch.zeros((mb, h, w, 3), device=device),
             torch.ones((mb, h, w, 1), device=device),
             torch.full((mb,), task.max_depth, device=device),
             f32(1.0 / a), f32(1.0))

    def microbatch_program(*flat):
        grads, out = step.microbatch(list(flat[:n]), *flat[n:n + 5],
                                     list(flat[n + 5:]))
        return (*grads, *out)

    def update_program(*flat):
        new_p, new_m, new_v, count, metrics = step.update(
            list(flat[:n]), list(flat[n:2 * n]),
            list(flat[2 * n:2 * n + c]), list(flat[2 * n + c:2 * n + 2 * c]),
            flat[2 * n + 2 * c], list(flat[2 * n + 2 * c + 1:-1]), flat[-1])
        return (*new_p, *new_m, *new_v, count,
                *(metrics[k] for k in step.SUMS))

    moments = [torch.zeros(sum(p.numel() for p in params[lo:hi]),
                           dtype=params[lo].dtype, device=device)
               for lo, hi, _ in chunks]
    examples = {
        "microbatch": (*params, *batch, *sums),
        "update": (*params, *(torch.zeros_like(p) for p in params),
                   *moments, *(torch.zeros_like(m) for m in moments),
                   torch.zeros((), dtype=torch.int64, device=device),
                   *sums, f32(1.0 / a))}
    programs = {"microbatch": microbatch_program, "update": update_program}
    exported, seconds, saved = {}, {}, io.BytesIO()
    with zipfile.ZipFile(saved, "w", zipfile.ZIP_STORED) as archive:
        for name in _TRAIN_PROGRAMS:
            exported[name], data, seconds[name] = _export_traced(
                programs[name], examples[name])
            archive.writestr(f"{name}.pt2", data)
    data = saved.getvalue()

    model = state.model
    heads = VIT_ARCHS[task.encoder]["num_heads"]
    on_card = device.type == "cuda"
    sched = task._sched_args
    meta = {
        "kind": "depth_train_step",
        "format": "torch.export",
        "programs": list(_TRAIN_PROGRAMS),
        "encoder": task.encoder,
        "max_depth": float(task.max_depth),
        "min_depth": float(task.min_depth),
        "grad_accum": a,
        "microbatch": mb,
        "image_hw": [h, w],
        "with_max_depth": bool(with_max_depth),
        "with_weight": bool(with_weight),
        "total_steps": int(sched["total_steps"]),
        "schedule": {"encoder_lr": float(task._lrs[0]),
                     "decoder_lr": float(task._lrs[1]),
                     "pct_start": float(sched["pct_start"]),
                     "div_factor": float(sched["div_factor"])},
        "platforms": [device.type],
        "dtype": str(model.pretrained.dtype).removeprefix("torch."),
        "grad_checkpoint": bool(task.grad_checkpoint),
        # The kernels fixed at export: on the CPU every op is its plain
        # version.
        "forward_schedule": (fa.forward_schedule(mb * heads) if on_card
                             else "plain"),
        "backward": ("K2" if fa._BWD_FUSED else "K3") if on_card
        else "plain",
        # The kernel ops of one microbatch (a step runs it A times).
        "kernel_nodes": {
            name: op_nodes(exported["microbatch"],
                           getattr(torch.ops.e3d, name).default)
            for name in ("flash_attn_fwd", "flash_attn_bwd", "lerp_resize")},
        "group_sizes": [len(g["params"])
                        for g in state.optimizer.optimizer.param_groups],
        "chunks": [list(chunk) for chunk in chunks],
        "graph_nodes": {name: len(ep.graph.nodes)
                        for name, ep in exported.items()},
        "artifact_bytes": len(data),
        "seconds": seconds,
        "state_manifest": {
            **{f"{kind}.{name}": [list(p.shape),
                                  str(p.dtype).removeprefix("torch.")]
               for kind in ("model", "exp_avg", "exp_avg_sq")
               for name, p in zip(step.names, params)},
            "step": [[], "int64"]},
    }
    _write(path, data, meta)
    return meta


class ExportedTrainStep:
    """A loaded training-step export: ``step(state, batch) -> (state,
    metrics)`` on a ``DepthTrainState``, with the sidecar's shape,
    device and manifest checks. ``programs`` holds the two loaded
    ``ExportedProgram`` by name.

    The state is updated in place, as ``DepthTask.train_step`` updates it:
    the model's parameters (copied into), the optimizer's ``exp_avg``,
    ``exp_avg_sq`` and ``step`` in ``torch.optim.AdamW``'s state (each
    moment a view of its chunk's flat output, which the next replay
    takes as it is), each group's ``lr`` (the schedule's value at the
    step, as the eager step sets it) and ``state.step``. The metrics are
    the eager step's keys, 0-dim tensors on the device."""

    def __init__(self, path: str):
        # The kernel ops must be registered before the programs load.
        from ..ops import flash_attention, quant, resize  # noqa: F401
        from ..train.optim import onecycle_schedule

        with open(path + ".json", encoding="utf-8") as f:
            self.meta = json.load(f)
        if self.meta.get("kind") != "depth_train_step":
            raise ValueError(f"{path} is not a train-step export "
                             f"(kind={self.meta.get('kind')!r})")
        with zipfile.ZipFile(path) as archive:
            self.programs = {
                name: torch.export.load(io.BytesIO(
                    archive.read(f"{name}.pt2")))
                for name in _TRAIN_PROGRAMS}
        self._modules = {name: ep.module()
                         for name, ep in self.programs.items()}
        sched = self.meta["schedule"]
        self._schedules = [
            onecycle_schedule(sched[k], self.meta["total_steps"],
                              sched["pct_start"], sched["div_factor"])
            for k in ("encoder_lr", "decoder_lr")]

    def _check(self, state, batch: Mapping[str, Any]) -> torch.device:
        """The state's device, after the fixed-shape, device and manifest
        checks."""
        want = _train_batch_shapes(self.meta)
        for k in _TRAIN_KEYS:
            got = tuple(np.shape(batch[k])) if k in batch else None
            if got != want.get(k):
                fixed = {key: list(v) for key, v in want.items()}
                raise ValueError(
                    f"exported train step is fixed-shape {fixed}; got {k} "
                    f"{'missing' if got is None else list(got)}")
        params = state.optimizer.params
        device = params[0].device
        traced_on = self.meta["platforms"]
        if device.type not in traced_on:
            raise ValueError(f"exported train step was traced on "
                             f"{traced_on}; the state lies on {device.type}")
        names = {id(p): n for n, p in state.model.named_parameters()}
        got = {names[id(p)]: [list(p.shape),
                              str(p.dtype).removeprefix("torch.")]
               for p in params}
        manifest = {k[len("model."):]: v
                    for k, v in self.meta["state_manifest"].items()
                    if k.startswith("model.")}
        sizes = [len(g["params"])
                 for g in state.optimizer.optimizer.param_groups]
        if (list(got) != list(manifest) or got != manifest
                or sizes != self.meta["group_sizes"]):
            missing = sorted(set(manifest) - set(got))
            extra = sorted(set(got) - set(manifest))
            changed = [k for k in got if k in manifest
                       and got[k] != manifest[k]]
            raise ValueError(
                "the state does not match the export's manifest: missing "
                f"{missing[:5]}, unexpected {extra[:5]}, changed "
                f"{changed[:5]}, groups {sizes} (export "
                f"{self.meta['group_sizes']})")
        return device

    def __call__(self, state, batch: Mapping[str, Any]):
        """One optimizer step of ``state`` on ``batch`` (numpy arrays or
        tensors of the exported shapes, float32). Returns ``(state,
        metrics)``."""
        from ..train.depth_task import FunctionalDepthStep, run_microbatches
        from ..train.optim import _scalar_dtype

        device = self._check(state, batch)
        opt = state.optimizer.optimizer
        params = state.optimizer.params
        held = [opt.state.get(p) for p in params]
        if any(held) and not all(held):
            raise ValueError("the optimizer holds AdamW state for some "
                             "parameters only")
        if all(held) and any(int(s["step"]) != state.step for s in held):
            raise ValueError(f"the optimizer's AdamW step differs from the "
                             f"state's step {state.step}")
        n = len(params)
        microbatch = self._modules["microbatch"]

        def run(ps, *inputs):
            out = microbatch(*ps, *inputs[:5], *inputs[5])
            return list(out[:n]), list(out[n:])

        tensors = {k: torch.as_tensor(batch[k]).to(device=device,
                                                   dtype=torch.float32)
                   for k in _train_batch_shapes(self.meta)}
        chunks = [params[lo:hi] for lo, hi, _ in self.meta["chunks"]]
        with torch.no_grad():
            grads, sums, inv_a = run_microbatches(run, params, tensors,
                                                  self.meta["max_depth"])
            moments = [
                [_joined([s[key] for s in held[lo:hi]]) if all(held) else
                 torch.zeros(sum(p.numel() for p in ps), dtype=ps[0].dtype,
                             device=device)
                 for ps, (lo, hi, _) in zip(chunks, self.meta["chunks"])]
                for key in ("exp_avg", "exp_avg_sq")]
            count = torch.tensor(state.step, dtype=torch.int64,
                                 device=device)
            out = self._modules["update"](*params, *grads, *moments[0],
                                          *moments[1], count, *sums, inv_a)
            del grads, moments
            c = len(chunks)
            new_p, new_m, new_v = out[:c], out[c:2 * c], out[2 * c:3 * c]
            metrics = dict(zip(FunctionalDepthStep.SUMS, out[3 * c + 1:]))
            torch._foreach_copy_(list(params), [
                v for flat, ps in zip(new_p, chunks)
                for v in _split(flat, ps)])
        step = torch.tensor(float(state.step + 1), dtype=_scalar_dtype())
        for flat_m, flat_v, ps in zip(new_m, new_v, chunks):
            for p, m, v in zip(ps, _split(flat_m, ps), _split(flat_v, ps)):
                opt.state[p] = {"step": step.clone(), "exp_avg": m,
                                "exp_avg_sq": v}
        for group, schedule in zip(opt.param_groups, self._schedules):
            group["lr"] = schedule(state.step)
        state.step += 1
        return state, metrics


def load_exported_train_step(path: str) -> ExportedTrainStep:
    return ExportedTrainStep(path)
