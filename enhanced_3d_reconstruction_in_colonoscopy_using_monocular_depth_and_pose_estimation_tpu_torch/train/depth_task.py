"""Depth fine-tuning task: train and eval steps of DAv2 metric depth.

The JAX package's ``train/depth_task.py`` on one card:

- ``train_step`` takes a batch of (A, mb, ...) tensors, A the
  grad-accumulation chunks, runs forward and backward per chunk (so one
  chunk's activations are live at a time), forms the weighted mean of the
  gradients, clips it by global norm and takes the two-group AdamW /
  OneCycle step (``train.optim``). An optional ``weight`` (A,) lets a
  trailing partial group step on the mean over its real chunks; a chunk
  of weight 0 adds nothing to that mean and is not run.
- the loss is SiLog over the valid mask ``min_depth <= gt <= max_depth``,
  with a per-sample ``max_depth`` when the batch has one (combined SimCol +
  C3VD); metrics are D1/AbsRel/RMSE/L1 of the detached prediction.
- precision follows the ``DtypePolicy``: f32 parameters and optimizer
  state, activations in ``compute_dtype`` (bf16 by default), loss,
  metrics and the depth head's output in f32.

The state is a ``DepthTrainState`` (model, optimizer, step). The step
updates it in place, as the JAX step donates its state, and returns it.

Distillation (``distill_encoder``, then ``set_teacher``): a frozen teacher
``DepthAnythingV2``, outside the train state and with no optimizer state,
runs under ``torch.no_grad()`` on each training chunk, and
``distill_weight * silog(pred, teacher, mask)`` joins the loss, masked to
the teacher's own ``[min_depth, max_depth]``; ``metrics["distill"]``
records the term. The step reads the teacher each time it runs, so a
teacher set after a first step takes effect at the next (the JAX step's
cache key leaves the teacher out and keeps the step built before).

The parallel modes run over a ``parallel.mesh.Mesh`` (``device_mesh``),
one process per card; each rank's batch holds its loader rows:

- data parallelism: the SiLog loss and the metrics are those of the
  global microbatch (the masked sums are reduced over the data group
  before the square root, ``losses.silog``), and the gradients, each
  rank's share of the global loss's, are summed over the data group with
  one all-reduce per step; a batch the loader replicated (a trailing one
  the world does not divide) runs whole on every rank and is reduced
  nowhere;
- ``fsdp``: FSDP2 ``fully_shard`` over the data group, each encoder
  block a unit, parameters of at least ``fsdp_min_size`` elements sharded
  on their largest divisible dim together with their AdamW moments, the
  others replicated; checkpoints hold the whole tensors;
- ``tensor_parallel``: the ranks of a model group gather their rows and
  split each block Megatron's way (``models.dinov2``), each rank holding
  its slice of the split projections and their AdamW moments; ``seq_parallel``
  also splits the residual stream's tokens between blocks (a no-op
  without ``tensor_parallel`` or at ``mesh_model=1``). TP composes with
  FSDP;
- ``pipeline_parallel``: the trunk runs as the GPipe or interleaved
  schedule of ``parallel.pipeline`` over the model group, with the JAX
  package's guards: exclusive with TP, SP, FSDP, the speed dials and
  distillation, ``mesh_model == pipeline_parallel``, and a training
  microbatch must divide ``data x pipe_microbatches`` (an eval batch that
  does not runs the plain forward).

Token merging and int8 (``token_merge``, ``quant_int8``) are inference
dials of the model; the task takes them for its guards.

``train_step`` records in ``core.debug``'s recorder, with the step as
``ident``: a ``train.microbatch`` span for each chunk's forward and
backward, and ``train.optimizer`` (on the card also in device time) for
the gradient sync, the clip, AdamW and the schedule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ..core import debug
from ..core.device import resolve_device
from ..core.dtypes import DtypePolicy, POLICY_BF16
from ..evaluation.depth_metrics import (DEPTH_METRIC_NAMES as METRIC_KEYS,
                                        compute_depth_errors)
from ..losses.silog import silog_loss
from ..models.convert import drop_unused
from ..models.depth_anything import DepthAnythingV2, build_depth_model
from ..parallel import mesh as meshlib
from .optim import (DepthOptimizer, FunctionalClippedAdamW,
                    make_depth_optimizer, onecycle_schedule)


@dataclasses.dataclass
class DepthTrainState:
    model: DepthAnythingV2
    optimizer: DepthOptimizer
    step: int = 0
    tp: meshlib.TensorParallel | None = None

    def state_dict(self) -> dict[str, Any]:
        """Model, optimizer and step in the unsharded layout, whatever
        the mesh (under FSDP or TP every rank must call it: it
        gathers)."""
        return {"model": {k: meshlib.tp_whole(meshlib.full(v), k, self.tp)
                          for k, v in self.model.state_dict().items()},
                "optimizer": self._optimizer_state(
                    self.optimizer.state_dict(),
                    lambda v, k: meshlib.tp_whole(meshlib.full(v), k,
                                                  self.tp)),
                "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Load an unsharded state into this state's layout."""
        model_sd = {k: meshlib.tp_slice(v, k, self.tp)
                    for k, v in state["model"].items()}
        opt_sd = self._optimizer_state(
            state["optimizer"], lambda v, k: meshlib.tp_slice(v, k, self.tp))
        sharded = any(hasattr(p, "device_mesh")
                      for p in self.model.parameters())
        if sharded:
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, set_model_state_dict)

            set_model_state_dict(self.model, model_sd,
                                 options=StateDictOptions(
                                     full_state_dict=True))
            self.optimizer.load_state_dict(_shard_optimizer_state(
                opt_sd, self.optimizer.params))
        else:
            self.model.load_state_dict(model_sd)
            self.optimizer.load_state_dict(opt_sd)
        self.step = int(state["step"])

    def _optimizer_state(self, sd: Mapping[str, Any], fn) -> dict:
        """``sd`` with ``fn(moment, parameter name)`` applied to each
        moment of a parameter's shape."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        names = [names[id(p)] for p in self.optimizer.params]
        return {**sd, "state": {
            i: {k: fn(v, names[int(i)]) if torch.is_tensor(v) and v.dim()
                else meshlib.full(v) if torch.is_tensor(v) else v
                for k, v in s.items()}
            for i, s in sd["state"].items()}}


def _shard_optimizer_state(sd: Mapping[str, Any], params) -> dict:
    """An unsharded optimizer state dict with each moment laid out as its
    parameter (a DTensor under FSDP)."""
    from torch.distributed.tensor import distribute_tensor

    state = {}
    for i, s in sd["state"].items():
        p = params[int(i)]
        state[i] = {
            k: (distribute_tensor(v.to(p.device), p.device_mesh, p.placements)
                if hasattr(p, "device_mesh") and torch.is_tensor(v)
                and v.shape == p.shape else v)
            for k, v in s.items()}
    return {**sd, "state": state}


class DepthTask:
    """Owns the configuration, the optimizer recipe and the steps of depth
    fine-tuning on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(
        self,
        encoder: str = "vitl",
        min_depth: float = 1e-6,
        max_depth: float = 20.0,
        encoder_lr: float = 5e-6,
        decoder_lr: float = 5e-5,
        pct_start: float = 0.1,
        div_factor: float = 1e9,
        total_steps: int = 1000,
        grad_accum: int = 4,
        clip_norm: float = 1.0,
        policy: DtypePolicy = POLICY_BF16,
        grad_checkpoint: bool = True,
        device: str | torch.device = "cuda",
        distill_encoder: str | None = None,
        distill_weight: float = 1.0,
        device_mesh: meshlib.Mesh | None = None,
        tensor_parallel: bool = False,
        fsdp: bool = False,
        fsdp_min_size: int | None = None,
        token_merge: float = 0.0,
        quant_int8: bool = False,
        seq_parallel: bool = False,
        pipeline_parallel: int = 0,
        pipe_microbatches: int = 0,
        pipe_virtual: int = 1,
    ):
        self.device = resolve_device(device)
        self.mesh = device_mesh or meshlib.build_mesh(device=self.device)
        mesh = self.mesh
        # The JAX package's guards, in its order.
        self.pipeline_parallel = int(pipeline_parallel)
        if self.pipeline_parallel > 1:
            if tensor_parallel or seq_parallel or fsdp:
                raise ValueError("pipeline_parallel is mutually exclusive "
                                 "with tensor_parallel/seq_parallel/fsdp")
            if token_merge > 0 or quant_int8:
                raise ValueError("pipeline_parallel does not compose with "
                                 "token_merge/quant_int8")
            if mesh.model != self.pipeline_parallel:
                raise ValueError(
                    f"pipeline_parallel={self.pipeline_parallel} needs "
                    f"mesh_model={self.pipeline_parallel} (got "
                    f"{mesh.model})")
            self.pipe_microbatches = (int(pipe_microbatches)
                                      or self.pipeline_parallel)
            self.pipe_virtual = max(1, int(pipe_virtual))
        if distill_encoder is not None and self.pipeline_parallel > 1:
            raise ValueError("distill_encoder does not compose with "
                             "pipeline_parallel")
        self.tp = (meshlib.TensorParallel(
            mesh.model_group, mesh.model, mesh.model_index,
            bool(seq_parallel)) if tensor_parallel and mesh.model > 1
            else None)
        self.fsdp = bool(fsdp) and mesh.data > 1
        self.fsdp_min_size = (meshlib.FSDP_MIN_SIZE if fsdp_min_size is None
                              else int(fsdp_min_size))
        refusal = gloo_refusal(self.device, meshlib.backend(), self.fsdp,
                               self.pipeline_parallel)
        if refusal:
            raise RuntimeError(refusal)
        self._replicated_params: set = set()
        self._tp_split: list[bool] = []
        self.encoder = encoder
        self.distill_encoder = distill_encoder
        self.distill_weight = float(distill_weight)
        self.teacher: DepthAnythingV2 | None = None
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.policy = policy
        self.grad_checkpoint = grad_checkpoint
        self.grad_accum = int(grad_accum)
        self._sched_args = dict(total_steps=total_steps, pct_start=pct_start,
                                div_factor=div_factor)
        self._lrs = (encoder_lr, decoder_lr)
        self._clip_norm = clip_norm

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int = 0,
                   pretrained_params: Mapping[str, Any] | None = None
                   ) -> DepthTrainState:
        """A seeded model in training mode, its optimizer and step 0.

        ``pretrained_params`` is a DAv2 state dict (tensors or numpy arrays,
        e.g. ``models.convert.from_jax_params`` output); an encoder-only one
        merges over the random init (``_merge_params``)."""
        model = build_depth_model(self.encoder, self.max_depth,
                                  self.policy.compute_dtype, self.device,
                                  seed, self.grad_checkpoint)
        if pretrained_params is not None:
            model.load_state_dict(_merge_params(model.state_dict(),
                                                pretrained_params))
        self.prepare(model)
        if self.fsdp:
            self._replicated_params = meshlib.apply_fsdp(
                model, self.mesh, self.fsdp_min_size,
                units=model.pretrained.blocks)
        model.train()
        optimizer = make_depth_optimizer(
            model, *self._lrs, clip_norm=self._clip_norm, **self._sched_args)
        if self.fsdp or self.tp is not None:
            names = {id(p): n for n, p in model.named_parameters()}
            self._tp_split = [self.tp is not None and meshlib.tp_split(
                names[id(p)]) is not None for p in optimizer.params]
            optimizer.norm_fn = self._sharded_grad_norm
        if self.fsdp:
            # The replicated parameters are plain tensors beside the
            # sharded DTensors; AdamW's multi-tensor path cannot mix them.
            for group in optimizer.optimizer.param_groups:
                group["foreach"] = False
        return DepthTrainState(model, optimizer, 0, self.tp)

    def prepare(self, model: DepthAnythingV2) -> DepthAnythingV2:
        """Set the task's tensor-parallel plan on ``model``, keeping this
        rank's slice of each split parameter (a model built outside the
        task, such as ``test_depth``'s, runs under the mesh after
        this)."""
        meshlib.apply_tensor_parallel(model, self.tp)
        return model

    def lr_table(self) -> dict[str, np.ndarray]:
        """Per-step LR of both groups (float32), for logging."""
        steps = range(self._sched_args["total_steps"])
        return {name: np.asarray([onecycle_schedule(lr, **self._sched_args)(s)
                                  for s in steps], np.float32)
                for name, lr in zip(("encoder", "decoder"), self._lrs)}

    def set_teacher(self, teacher_params: Mapping[str, Any]) -> None:
        """Install frozen teacher weights (a DAv2 state dict of the
        ``distill_encoder`` model) for distillation. The teacher is built
        here, in eval mode, with no gradient and no optimizer state; its
        weights are copies, never the student's tensors."""
        if self.distill_encoder is None:
            raise ValueError("task was built without distill_encoder")
        teacher = build_depth_model(self.distill_encoder, self.max_depth,
                                    self.policy.compute_dtype, self.device)
        teacher.load_state_dict(_merge_params(teacher.state_dict(),
                                              teacher_params))
        self.teacher = teacher.requires_grad_(False).eval()

    # ------------------------------------------------------------- loss core

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _rows(self, batch: Mapping[str, Any], keys, lead: int = 0
              ) -> tuple[dict[str, torch.Tensor], bool, int]:
        """This rank's data shard of ``keys`` (its model group's rows,
        gathered on dim ``lead``), whether the batch is sharded over the
        ranks, and the global batch."""
        replicated = bool(batch.get("_replicated", False))
        out = {k: self._tensor(batch[k]) for k in keys if k in batch}
        rows = out[keys[0]].shape[lead]
        sharded = self.mesh.world > 1 and not replicated
        if sharded and self.mesh.model > 1:
            out = {k: meshlib.gather_rows(v, self.mesh.model_group, dim=lead)
                   for k, v in out.items()}
        return out, sharded, rows * (self.mesh.world if sharded else 1)

    def _reduce(self, sharded: bool):
        """The masked sums' reduction: over the data group for a sharded
        batch, none for a replicated one."""
        if sharded and self.mesh.data_group is not None:
            return functools.partial(meshlib.global_sum,
                                     group=self.mesh.data_group)
        return _identity

    def _forward(self, model: DepthAnythingV2, image: torch.Tensor,
                 global_b: int, train: bool = False) -> torch.Tensor:
        """The model's forward, through the pipeline when it is on. A
        training microbatch the pipeline cannot split raises; an eval
        batch runs the plain forward (the same numerics)."""
        if self.pipeline_parallel > 1:
            divisor = self.mesh.data * self.pipe_microbatches
            if global_b % divisor == 0:
                from ..parallel.pipeline import build_pp_depth_forward

                return build_pp_depth_forward(
                    model, self.mesh, self.pipeline_parallel,
                    self.pipe_microbatches, self.pipe_virtual)(image)
            if train:
                raise ValueError(
                    f"pipeline_parallel={self.pipeline_parallel}: train "
                    f"microbatch {global_b} must divide data axis "
                    f"{self.mesh.data} x pipe_microbatches "
                    f"{self.pipe_microbatches}")
        return model(image)

    def _loss_and_metrics(self, model: DepthAnythingV2, image: torch.Tensor,
                          depth: torch.Tensor, max_depth: torch.Tensor,
                          distill: bool = False, reduce=None,
                          global_b: int | None = None, train: bool = False
                          ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """SiLog and the metrics (of the global batch, through
        ``reduce``); with ``distill`` and a teacher set, the distillation
        term too."""
        reduce = reduce or _identity
        pred = self._forward(model, image,
                             image.shape[0] if global_b is None else global_b,
                             train)                          # (b, h, w) f32
        gt = depth[..., 0] if depth.dim() == 4 else depth
        maxd = max_depth[:, None, None]
        mask = (gt >= self.min_depth) & (gt <= maxd)
        loss = silog_loss(pred, gt, mask, reduce=reduce)
        metrics = compute_depth_errors(pred.detach(), gt, mask, reduce=reduce)
        if distill and self.teacher is not None:
            # Soft targets from the frozen teacher, the same SiLog distance
            # as the hard loss, masked to the teacher's range (values below
            # min_depth would hit the loss's log guard).
            with torch.no_grad():
                t_pred = self.teacher(image)
            t_mask = (t_pred >= self.min_depth) & (t_pred <= maxd)
            term = silog_loss(pred, t_pred, t_mask, reduce=reduce)
            loss = loss + self.distill_weight * term
            metrics["distill"] = term.detach()
        return loss, metrics

    def _max_depth(self, batch: Mapping[str, Any], shape) -> torch.Tensor:
        if "max_depth" in batch:
            return self._tensor(batch["max_depth"]).float()
        return torch.full(shape, self.max_depth, dtype=torch.float32,
                          device=self.device)

    # ------------------------------------------------------------ train step

    def train_step(self, state: DepthTrainState, batch: Mapping[str, Any]
                   ) -> tuple[DepthTrainState, dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (``image`` (A, mb, H, W, 3),
        ``depth`` (A, mb, H, W[, 1]), optional ``max_depth`` (A, mb) and
        ``weight`` (A,)). Returns the state and the weighted-mean ``loss``
        and metrics, as scalar tensors on the device (reading them
        syncs)."""
        rows, sharded, global_b = self._rows(
            batch, ("image", "depth", "max_depth"), lead=1)
        image, depth = rows["image"], rows["depth"]
        accum, mb = image.shape[:2]
        maxd = (rows["max_depth"].float() if "max_depth" in rows else
                self._max_depth(batch, (accum, mb)))
        weights = (torch.as_tensor(batch["weight"]).tolist()
                   if "weight" in batch else [1.0] * accum)
        inv_a = 1.0 / max(sum(weights), 1e-6)
        reduce = self._reduce(sharded)

        model, optimizer = state.model, state.optimizer
        model.train()
        optimizer.zero_grad()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum = zero
        keys = METRIC_KEYS + (("distill",) if self.teacher is not None
                              else ())
        met_sum = {k: zero for k in keys}
        for a, w in enumerate(weights):
            if w == 0.0:
                continue
            with debug.span("train.microbatch", state.step):
                loss, metrics = self._loss_and_metrics(
                    model, image[a], depth[a], maxd[a], distill=True,
                    reduce=reduce, global_b=global_b, train=True)
                # Gradients of the weighted mean: each chunk's backward
                # adds w * inv_a times its gradient into .grad.
                (loss * (w * inv_a)).backward()
                loss_sum = loss_sum + loss.detach() * w
                met_sum = {k: met_sum[k] + metrics[k] * w for k in keys}
        with debug.span("train.optimizer", state.step,
                        device=self.device.type == "cuda"):
            self._sync_grads(model, sharded)
            optimizer.step(state.step)
        state.step += 1
        out = {k: v * inv_a for k, v in met_sum.items()}
        out["loss"] = loss_sum * inv_a
        return state, out

    def functional_train_step(self, state: DepthTrainState
                              ) -> FunctionalDepthStep:
        """``train_step`` of ``state``'s model and optimizer as a function
        of tensors (``FunctionalDepthStep``), the step that
        ``serving.export.export_train_step`` traces. Only the replicated
        single-card step has one: a task on a mesh of several ranks,
        under FSDP, TP or the pipeline, with a teacher, or a model with
        a speed dial raises ValueError naming it."""
        model = state.model
        reasons = [what for on, what in (
            (self.mesh.world > 1, f"a mesh of {self.mesh.world} ranks"),
            (self.fsdp, "fsdp"), (self.tp is not None, "tensor_parallel"),
            (self.pipeline_parallel > 1, "pipeline_parallel"),
            (self.distill_encoder is not None or self.teacher is not None,
             "a distillation teacher"),
            (model.pretrained.token_merge > 0, "token_merge"),
            (model.quant_int8, "quant_int8")) if on]
        if reasons:
            raise ValueError("the functional training step is the "
                             "replicated single-card step; this task has "
                             + ", ".join(reasons))
        return FunctionalDepthStep(self, state)

    def _sync_grads(self, model: DepthAnythingV2, sharded: bool) -> None:
        """Sum each rank's share of the gradient: over the data group for
        a sharded batch (FSDP's reduce-scatter already did its own
        parameters), and over the model group for what the model group
        split: every parameter under the pipeline (each stage ran its own
        blocks and its slot of the head); under sequence parallelism the
        encoder's replicated parameters but its final norm (each rank ran
        its slot of the tokens). Tensor parallelism's split projections
        hold whole gradients of this rank's slices, its replicated
        parameters the same gradient on every rank."""
        mesh = self.mesh
        if mesh.world == 1:
            return
        # A parameter this rank did not use (a pipeline stage's embedding
        # off stage 0) has no gradient: its share is zero, and every rank
        # must send the same tensors.
        params = list(model.named_parameters())
        for _, p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if sharded and mesh.data_group is not None:
            meshlib.sum_grads(
                [p.grad for _, p in params
                 if not self.fsdp or p in self._replicated_params],
                mesh.data_group)
            if self.fsdp:
                # FSDP's reduce-scatter averages over the data group (the
                # right reduction for a replicated batch); a sharded
                # batch's shares are summed.
                for _, p in params:
                    if p not in self._replicated_params:
                        meshlib.local(p.grad).mul_(mesh.data)
        if mesh.model_group is None:
            return
        if self.pipeline_parallel > 1:
            split = params
        elif self.tp is not None and self.tp.seq_parallel:
            split = [(n, p) for n, p in params
                     if n.startswith("pretrained.")
                     and not n.startswith("pretrained.norm.")
                     and meshlib.tp_split(n) is None]
        else:
            return
        meshlib.sum_grads([meshlib.local(p.grad) for _, p in split],
                          mesh.model_group)

    def _sharded_grad_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm under FSDP and TP: each gradient's
        squares summed over the groups its parameter is sharded on (FSDP's
        over the data group, TP's split projections over the model group),
        a replicated one's counted once."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sq = [zero] * 4        # replicated, FSDP, TP, FSDP and TP
        for g, split in zip(grads, self._tp_split):
            k = int(hasattr(g, "to_local")) + 2 * int(split)
            sq[k] = sq[k] + meshlib.local(g).float().square().sum()
        on_data = torch.stack([sq[1], sq[3]])
        meshlib.sum_grads([on_data], self.mesh.data_group)
        on_model = torch.stack([sq[2], on_data[1]])
        meshlib.sum_grads([on_model], self.mesh.model_group)
        return (sq[0] + on_data[0] + on_model.sum()).sqrt()

    # ------------------------------------------------------------- eval step

    @torch.no_grad()
    def eval_step(self, model: DepthAnythingV2, batch: Mapping[str, Any]
                  ) -> dict[str, torch.Tensor]:
        """``batch``: ``image`` (B, H, W, 3), ``depth`` (B, H, W[, 1]),
        optional ``max_depth`` (B,). Returns scalar loss and metrics."""
        rows, sharded, global_b = self._rows(batch,
                                             ("image", "depth", "max_depth"))
        image = rows["image"]
        maxd = (rows["max_depth"].float() if "max_depth" in rows else
                self._max_depth(batch, (image.shape[0],)))
        loss, metrics = self._loss_and_metrics(
            model, image, rows["depth"], maxd,
            reduce=self._reduce(sharded), global_b=global_b)
        metrics["loss"] = loss
        return metrics

    @torch.no_grad()
    def eval_step_combined(self, model: DepthAnythingV2,
                           batch: Mapping[str, Any]
                           ) -> dict[str, torch.Tensor]:
        """Overall and per-source (``SimCol/``, ``C3VD/``) metrics of one
        forward over a combined batch (``source`` 0 or 1, ``max_depth``
        (B,)). C3VD l1/rmse are scaled x10 back to mm (training runs in
        the /10 cm convention); ``<source>/count`` counts its samples."""
        rows, sharded, global_b = self._rows(
            batch, ("image", "depth", "max_depth", "source"))
        reduce = self._reduce(sharded)
        pred = self._forward(model, rows["image"], global_b)
        depth = rows["depth"]
        gt = depth[..., 0] if depth.dim() == 4 else depth
        maxd = rows["max_depth"].float()[:, None, None]
        mask = (gt >= self.min_depth) & (gt <= maxd)
        source = rows["source"]
        out = {"loss": silog_loss(pred, gt, mask, reduce=reduce)}
        out.update(compute_depth_errors(pred, gt, mask, reduce=reduce))
        for name, sid in (("SimCol", 0), ("C3VD", 1)):
            metrics = compute_depth_errors(
                pred, gt, mask & (source[:, None, None] == sid),
                reduce=reduce)
            scale = 10.0 if sid == 1 else 1.0
            out[f"{name}/l1"] = metrics["l1"] * scale
            out[f"{name}/rmse"] = metrics["rmse"] * scale
            out[f"{name}/abs_rel"] = metrics["abs_rel"]
            out[f"{name}/d1"] = metrics["d1"]
            out[f"{name}/count"] = reduce(torch.sum(source == sid).float())
        return out

    @torch.no_grad()
    def eval_step_per_sample(self, model: DepthAnythingV2,
                             batch: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
        """Per-sample loss and metrics, a dict of (B,) tensors, for the
        per-procedure collectors of ``cli/test_depth.py``: true per-sample
        values, as in the JAX package (the reference appends the batch's
        metric once per sample). ``batch`` as for ``eval_step``; under a
        mesh the rows are this rank's data shard (its model group's
        rows)."""
        rows, _, global_b = self._rows(batch,
                                       ("image", "depth", "max_depth"))
        image = rows["image"]
        pred = self._forward(model, image, global_b)
        depth = rows["depth"]
        gt = depth[..., 0] if depth.dim() == 4 else depth
        maxd = (rows["max_depth"].float() if "max_depth" in rows else
                self._max_depth(batch, (image.shape[0],)))
        rows = []
        for pred_i, gt_i, maxd_i in zip(pred, gt, maxd):
            mask = (gt_i >= self.min_depth) & (gt_i <= maxd_i)
            row = compute_depth_errors(pred_i, gt_i, mask)
            row["loss"] = silog_loss(pred_i, gt_i, mask)
            rows.append(row)
        return {k: torch.stack([row[k] for row in rows]) for k in rows[0]}


class _Microbatch(torch.nn.Module):
    """One microbatch's loss, metrics and gradients, run under
    ``functional_call``: the backward, and the blocks it recomputes under
    gradient checkpointing, read the call-time parameters too."""

    def __init__(self, task: DepthTask, model: DepthAnythingV2):
        super().__init__()
        self.model = model
        object.__setattr__(self, "task", task)

    def forward(self, leaves, image, depth, maxd, scale):
        loss, metrics = self.task._loss_and_metrics(self.model, image, depth,
                                                    maxd, train=True)
        grads = torch.autograd.grad(loss * scale, leaves, allow_unused=True)
        return loss.detach(), metrics, grads


class FunctionalDepthStep:
    """``DepthTask.train_step`` as functions of tensors, in the two parts
    that ``serving.export.export_train_step`` traces:

        microbatch(params, image, depth, max_depth, scale, weight, sums)
            -> (grads, sums)
        update(params, grads, exp_avg, exp_avg_sq, count, sums, inv_a)
            -> (params, exp_avg, exp_avg_sq, count + 1, metrics)

    ``params`` and the gradients are lists in ``names`` order (the
    optimizer's); the moments and the new parameters are one flat tensor
    per chunk of ``optimizer`` (``train.optim.FunctionalClippedAdamW``);
    ``count`` is ``state.step`` as an int64 0-dim tensor; ``sums`` are the
    weighted sums of the loss and the metrics so far (``SUMS`` order);
    ``scale``, ``weight`` and ``inv_a`` are float32 0-dim tensors. One
    microbatch (``image`` (mb, H, W, 3), ``depth`` (mb, H, W, 1),
    ``max_depth`` (mb,)) gives the gradient of its loss times ``scale``
    and adds its loss and metrics times ``weight`` to ``sums``; the update
    clips the summed gradients, takes the AdamW step and returns the
    weighted means. Nothing is mutated; the model's own parameters are
    never read.

    ``step(params, exp_avg, exp_avg_sq, count, batch)`` (the instance
    called) composes them over a batch as ``train_step`` does
    (``run_microbatches``), with the same arithmetic, op for op."""

    SUMS = ("loss", *METRIC_KEYS)

    def __init__(self, task: DepthTask, state: DepthTrainState):
        self.task = task
        names = {id(p): n for n, p in state.model.named_parameters()}
        self.names = [names[id(p)] for p in state.optimizer.params]
        self.optimizer = FunctionalClippedAdamW(
            state.optimizer, task._sched_args["total_steps"])
        self._microbatch = _Microbatch(task, state.model)

    def microbatch(self, params, image, depth, max_depth, scale, weight,
                   sums):
        leaves = [p.detach().requires_grad_() for p in params]
        named = {"model." + n: p for n, p in zip(self.names, leaves)}
        self._microbatch.model.train()
        loss, metrics, grads = torch.func.functional_call(
            self._microbatch, named, (leaves, image, depth, max_depth,
                                      scale))
        # ``.grad`` holds each gradient in its parameter's (contiguous)
        # layout, and the clip's per-tensor norms reduce in layout order;
        # ``autograd.grad`` hands some back transposed. A parameter the
        # loss does not reach (``mask_token``) gets zeros, as the eager
        # optimizer gives it.
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for g, p in zip(grads, params)]
        values = (loss, *(metrics[k] for k in METRIC_KEYS))
        return grads, [s + v * weight for s, v in zip(sums, values)]

    def update(self, params, grads, exp_avg, exp_avg_sq, count, sums,
               inv_a):
        new_p, new_m, new_v, _ = self.optimizer.update(
            params, grads, exp_avg, exp_avg_sq, count)
        return (new_p, new_m, new_v, count + 1,
                {k: s * inv_a for k, s in zip(self.SUMS, sums)})

    def __call__(self, params, exp_avg, exp_avg_sq, count, batch):
        grads, sums, inv_a = run_microbatches(
            self.microbatch, params, batch, self.task.max_depth)
        return self.update(params, grads, exp_avg, exp_avg_sq, count, sums,
                           inv_a)


def run_microbatches(microbatch, params, batch: Mapping[str, Any],
                     max_depth: float):
    """``train_step``'s loop over the A microbatches of ``batch``
    (tensors on the parameters' device), each through ``microbatch`` (the
    signature of ``FunctionalDepthStep.microbatch``): the weights read on
    the host, a microbatch of weight 0 skipped, the gradients summed in
    microbatch order as ``.backward()`` sums them into ``.grad``. Returns
    ``(grads, sums, inv_a)``, the inputs of the update."""
    image, depth = batch["image"], batch["depth"]
    accum, mb = image.shape[:2]
    device = image.device
    maxd = (batch["max_depth"].float() if "max_depth" in batch else
            torch.full((accum, mb), max_depth, dtype=torch.float32,
                       device=device))
    weights = (torch.as_tensor(batch["weight"]).tolist()
               if "weight" in batch else [1.0] * accum)
    inv_a = 1.0 / max(sum(weights), 1e-6)

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=device)

    sums = [f32(0.0) for _ in FunctionalDepthStep.SUMS]
    grads = None
    for a, w in enumerate(weights):
        if w == 0.0:
            continue
        g, sums = microbatch(params, image[a], depth[a], maxd[a],
                             f32(w * inv_a), f32(w), sums)
        if grads is None:
            grads = g
        else:
            torch._foreach_add_(grads, g)
    if grads is None:
        grads = [torch.zeros_like(p) for p in params]
    return grads, sums, f32(inv_a)


def gloo_refusal(device: torch.device, backend: str | None, fsdp: bool,
                 pipeline_parallel: int) -> str | None:
    """Why a mode cannot run on ``device`` over ``backend``, else None.
    gloo moves CUDA tensors only by all-reduce, broadcast and barrier:
    FSDP's all-gather and reduce-scatter crash the process, and the
    pipeline's send/recv fail, on an H100."""
    if device.type != "cuda" or backend != "gloo":
        return None
    for on, what in ((fsdp, "fsdp (all-gather, reduce-scatter)"),
                     (pipeline_parallel > 1,
                      "pipeline_parallel (send/recv)")):
        if on:
            return (f"{what} needs collectives of CUDA tensors that the "
                    "gloo backend does not have; run one process per card "
                    "on nccl")
    return None


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _merge_params(base: Mapping[str, torch.Tensor],
                  overlay: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``base`` (a state dict) with the entries of ``overlay`` (converted
    DAv2 weights, possibly encoder-only) in place of its own, cast to
    their dtype. Keys the model does not have raise."""
    out = dict(base)
    for key, value in drop_unused(overlay).items():
        if key not in base:
            raise KeyError(f"pretrained weight {key!r} is not a parameter "
                           "of the model")
        t = value if torch.is_tensor(value) else torch.from_numpy(
            np.asarray(value))
        if t.shape != base[key].shape:
            raise ValueError(f"pretrained weight {key!r} has shape "
                             f"{tuple(t.shape)}, the model "
                             f"{tuple(base[key].shape)}")
        out[key] = t.to(dtype=base[key].dtype)
    return out
