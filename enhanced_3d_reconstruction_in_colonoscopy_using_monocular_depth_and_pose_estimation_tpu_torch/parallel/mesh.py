"""The process mesh and the collectives of the parallel modes (the JAX
package's ``parallel/mesh.py``).

One process drives one card (or one CPU worker). ``init_distributed``
joins the processes that ``torchrun`` started into one process group;
``build_mesh`` lays them out as the JAX package's 2-D ``('data',
'model')`` mesh, rank ``r`` at ``(r // model, r % model)``:

- the loaders shard every global batch over all ranks (``rank`` and
  ``world``), as the JAX package's loader shards it over processes; the
  ranks of one ``model`` group then gather their rows (``gather_rows``),
  so each group holds one ``data`` shard of the batch, as a batch
  sharded over the data axis and replicated over the model axis;
- gradients and the loss's sums are reduced over the ``data`` group;
  tensor parallelism (``TensorParallel``) and the pipeline
  (``parallel/pipeline.py``) communicate over the ``model`` group.

A single process without ``trainer.distributed`` makes no process group,
and every function here is then the identity: the mesh is 1x1.

The gathers and reductions that carry gradients are autograd functions.
A gather is an all-reduce of a zero-filled buffer that holds each rank's
rows in its own slot: gloo has no all-gather for CUDA tensors, and the
slots may differ in size (a token axis split with ``tensor_split``
semantics), at twice the bytes of an all-gather.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Sequence

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# torchrun's environment.
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: str | torch.device = "cuda",
                     required: bool = False) -> torch.device:
    """Join the process group that ``torchrun`` set up; returns this
    rank's device.

    Runs when ``required`` (``trainer.distributed=true``) or when the
    environment holds a world of more than one process; otherwise it is a
    no-op and returns ``device``. The environment must hold ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``, and ``MASTER_ADDR`` and
    ``MASTER_PORT`` unless ``E3D_DIST_INIT`` gives another rendezvous
    (such as ``file:///path``); a missing one raises naming it. The
    backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU, unless
    ``E3D_DIST_BACKEND`` names one. On CUDA, ``LOCAL_RANK`` picks the
    card, and a rank beyond the visible cards raises."""
    dev = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return _rank_device(dev)
    if not required and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return dev
    init = os.environ.get("E3D_DIST_INIT")
    need = ENV_VARS[:3] if init else ENV_VARS
    missing = [v for v in need if v not in os.environ]
    if missing:
        raise RuntimeError(
            "trainer.distributed=true needs torchrun's environment; "
            f"missing {', '.join(missing)} (launch with torchrun "
            "--nproc-per-node N)")
    dev = _rank_device(dev)
    backend = os.environ.get("E3D_DIST_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(f"LOCAL_RANK {local} but only {n} visible "
                           "CUDA device(s)")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; -1 means 'all remaining ranks'."""
    data: int = -1
    model: int = 1


class Mesh:
    """The ``('data', 'model')`` layout of the world's ranks, with the
    process groups of this rank's data and model groups (None when a group
    holds this rank alone) and, when there is a process group, the
    ``DeviceMesh`` FSDP shards over."""

    def __init__(self, data: int, model: int, device: torch.device):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.device = device
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.world = data * model
        self.data_index, self.model_index = divmod(self.rank, model)
        self.device_mesh = None
        self.data_group = self.model_group = None
        if self.distributed:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(
                device.type, (data, model),
                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
            if data > 1:
                self.data_group = self.device_mesh.get_group(DATA_AXIS)
            if model > 1:
                self.model_group = self.device_mesh.get_group(MODEL_AXIS)

    @property
    def data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model(self) -> int:
        return self.shape[MODEL_AXIS]

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def flag_any(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set (a MAX all-reduce)."""
        if not self.distributed:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=_comm_device(self.device))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def data_rows(self, batch_rows: int, replicated: bool
                  ) -> tuple[int, int]:
        """(first global row, global batch) of this rank's data shard for
        a loader batch of ``batch_rows`` local rows."""
        if replicated or self.world == 1:
            return 0, batch_rows
        per = batch_rows * self.model
        return self.data_index * per, per * self.data

    def loader_rows(self, batch_rows: int, replicated: bool
                    ) -> tuple[int, int]:
        """(first global row, global batch) of this rank's own loader
        rows."""
        if replicated or self.world == 1:
            return 0, batch_rows
        return self.rank * batch_rows, batch_rows * self.world


def backend() -> str | None:
    """The process group's backend, None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def _comm_device(device: torch.device) -> torch.device:
    """Where a small control tensor must live for the backend."""
    return device if backend() == "nccl" else torch.device("cpu")


def build_mesh(spec: MeshSpec | None = None,
               device: str | torch.device = "cpu") -> Mesh:
    """The ``(data, model)`` mesh over the world's ranks (one rank when no
    process group exists)."""
    spec = spec or MeshSpec()
    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    model = spec.model if spec.model > 0 else 1
    data = spec.data if spec.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(data, model, torch.device(device))


# ------------------------------------------------------------ collectives


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``, forward and backward (the transpose of a sum of
    replicas that each feed a different part of the loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceToReplicas(torch.autograd.Function):
    """Sum of partial results over ``group`` whose sum every rank then
    uses alike: the gradient passes through unchanged (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToPartials(torch.autograd.Function):
    """A replicated input to per-rank partial computations: identity
    forward, gradients summed over ``group`` (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather(x: torch.Tensor, group, sizes: Sequence[int], dim: int
            ) -> torch.Tensor:
    idx = _index(group)
    x = x.movedim(dim, 0)
    buf = x.new_zeros((sum(sizes),) + tuple(x.shape[1:]))
    start = sum(sizes[:idx])
    buf[start:start + sizes[idx]] = x
    dist.all_reduce(buf, group=group)
    return buf.movedim(0, dim)


def _slot(x: torch.Tensor, group, sizes: Sequence[int], dim: int
          ) -> torch.Tensor:
    idx = _index(group)
    return x.narrow(dim, sum(sizes[:idx]), sizes[idx])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes, dim, partial):
        ctx.args = (group, sizes, dim, partial)
        return _gather(x, group, sizes, dim)

    @staticmethod
    def backward(ctx, g):
        group, sizes, dim, partial = ctx.args
        if partial:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=group)
        return _slot(g, group, sizes, dim).contiguous(), None, None, None, \
            None


class _Scatter(torch.autograd.Function):
    """Partial results summed over ``group``, of which each rank keeps its
    slot (a reduce-scatter); the backward gathers the slots' gradients."""

    @staticmethod
    def forward(ctx, x, group, sizes, dim):
        ctx.args = (group, sizes, dim)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return _slot(y, group, sizes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, sizes, dim = ctx.args
        return _gather(g.contiguous(), group, sizes, dim), None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` with the sum's gradient (identity alone)."""
    return x if _size(group) == 1 else _AllReduce.apply(x, group)


def reduce_to_replicas(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceToReplicas.apply(x, group)


def copy_to_partials(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyToPartials.apply(x, group)


def even_sizes(n: int, parts: int) -> list[int]:
    """Slot sizes of ``n`` rows over ``parts`` ranks, ``tensor_split``
    style: the first ``n % parts`` slots hold one row more."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def gather_rows(x: torch.Tensor, group, sizes: Sequence[int] | None = None,
                dim: int = 0, partial: bool = False) -> torch.Tensor:
    """Every rank's slot of ``dim`` concatenated in rank order (equal
    slots unless ``sizes``). Backward: this rank's slot of the gradient,
    summed over the group first when the ranks' uses of the result are
    ``partial`` (each computes a different part of the loss from it)."""
    n = _size(group)
    if n == 1:
        return x
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * n
    if not torch.is_grad_enabled() or not x.requires_grad:
        with torch.no_grad():
            return _gather(x, group, sizes, dim)
    return _Gather.apply(x, group, sizes, dim, partial)


def scatter_rows(x: torch.Tensor, group, sizes: Sequence[int],
                 dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of per-rank partial ``x``, this rank's slot
    of ``dim`` kept."""
    if _size(group) == 1:
        return x
    return _Scatter.apply(x, group, list(sizes), dim)


def slot_of(x: torch.Tensor, group, sizes: Sequence[int], dim: int = 0
            ) -> torch.Tensor:
    """This rank's slot of a replicated ``x`` (no communication)."""
    if _size(group) == 1:
        return x
    return _slot(x, group, list(sizes), dim)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose gradient reaches only this
    rank's ``x``: summing the ranks' gradients afterwards gives the
    gradient of any function of the global sums. No backward
    communication."""
    if _size(group) == 1:
        return x
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    return x + (total - x.detach())


def sum_grads(tensors: Iterable[torch.Tensor], group) -> None:
    """Sum gradients (or any tensors) in place over ``group`` with one
    all-reduce of their concatenation."""
    tensors = [t for t in tensors if t is not None]
    if _size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


# ------------------------------------------------------- tensor parallel

# Megatron's split of the ViT blocks (``models.dinov2``), by parameter
# name: the dim split and the number of packed parts along it.
# Column-parallel on qkv, fc1 and w12 (output rows), row-parallel on proj,
# fc2 and w3 (input columns; their bias is added once, after the sum, and
# is not split). qkv packs q, k and v, and w12 the gate and value halves:
# each part is split alike, so a rank's qkv slice is (3, H/tp, D) and
# attention runs at H/tp heads.
_TP_SPLIT = {"attn.qkv.weight": (0, 3), "attn.qkv.bias": (0, 3),
             "mlp.fc1.weight": (0, 1), "mlp.fc1.bias": (0, 1),
             "mlp.w12.weight": (0, 2), "mlp.w12.bias": (0, 2),
             "attn.proj.weight": (1, 1), "mlp.fc2.weight": (1, 1),
             "mlp.w3.weight": (1, 1)}


@dataclasses.dataclass
class TensorParallel:
    """The model group's split of the ViT blocks, set on the blocks'
    modules by ``apply_tensor_parallel``. ``seq_parallel`` shards the
    residual stream on the token axis between blocks (unevenly when the
    group does not divide the tokens); ``sizes`` holds the current
    forward's token slots."""
    group: object
    size: int
    index: int
    seq_parallel: bool = False
    sizes: list[int] = dataclasses.field(default_factory=list)

    def token_sizes(self, n: int) -> list[int]:
        return even_sizes(n, self.size)


def tp_split(name: str) -> tuple[int, int] | None:
    """(dim, packed parts) of a parameter the plan splits, else None."""
    for suffix, split in _TP_SPLIT.items():
        if name.endswith("." + suffix):
            return split
    return None


def tp_slice(t: torch.Tensor, name: str, tp: TensorParallel | None
             ) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` of parameter ``name``
    (``t`` itself when the plan does not split it)."""
    split = tp_split(name) if tp is not None else None
    if split is None:
        return t
    dim, parts = split
    v = t.movedim(dim, 0)
    v = v.reshape(parts, tp.size, -1, *v.shape[1:])[:, tp.index]
    return v.reshape(-1, *v.shape[2:]).movedim(0, dim).contiguous()


@torch.no_grad()
def tp_whole(t: torch.Tensor, name: str, tp: TensorParallel | None
             ) -> torch.Tensor:
    """The whole tensor of parameter ``name`` from every rank's slice
    ``t`` (collective over the model group: every rank calls it alike);
    ``t`` itself when the plan does not split it."""
    split = tp_split(name) if tp is not None else None
    if split is None:
        return t
    dim, parts = split
    v = t.movedim(dim, 0)
    v = v.reshape(parts, 1, -1, *v.shape[1:])
    buf = v.new_zeros((parts, tp.size) + tuple(v.shape[2:]))
    buf[:, tp.index:tp.index + 1] = v
    dist.all_reduce(buf, group=tp.group)
    return buf.reshape(-1, *buf.shape[3:]).movedim(0, dim).contiguous()


def apply_tensor_parallel(model: nn.Module, tp: TensorParallel | None
                          ) -> None:
    """Set ``tp`` on every module of ``model`` that has a ``tp`` slot (the
    encoder, its attention and FFN modules) and replace each parameter the
    plan splits by this rank's slice (``tp_slice``), so a rank holds, and
    its optimizer keeps moments of, only its share. None leaves the model
    whole. A width the group does not divide raises."""
    if tp is None:
        return
    for m in model.modules():
        if hasattr(m, "tp_width"):
            what, n = m.tp_width()
            if n % tp.size:
                raise ValueError(f"tensor_parallel: {what} {n} is not "
                                 f"divisible by mesh_model={tp.size}")
    for name, p in list(model.named_parameters()):
        if tp_split(name) is not None:
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(
                tp_slice(p.detach(), name, tp).clone(),
                requires_grad=p.requires_grad))
    for m in model.modules():
        if hasattr(m, "tp"):
            m.tp = tp


# ------------------------------------------------------------------- FSDP

# Parameters smaller than this stay replicated under FSDP: sharding a few
# KB trades an all-gather for no memory.
FSDP_MIN_SIZE = 2 ** 15


def fsdp_dim(shape: Sequence[int], ndata: int,
             min_size: int = FSDP_MIN_SIZE) -> int | None:
    """The dim FSDP shards a parameter on (the JAX package's
    ``fsdp_spec``): the largest one the data axis divides; None for a
    parameter below ``min_size`` elements or with no such dim."""
    n = 1
    for d in shape:
        n *= d
    if ndata <= 1 or n < min_size:
        return None
    best = None
    for dim, extent in enumerate(shape):
        if extent % ndata == 0 and extent >= ndata:
            if best is None or extent > shape[best]:
                best = dim
    return best


def apply_fsdp(model: nn.Module, mesh: Mesh, min_size: int = FSDP_MIN_SIZE,
               units: Iterable[nn.Module] = ()) -> set[nn.Parameter]:
    """FSDP2 ``fully_shard`` over the data group: each of ``units`` (the
    encoder blocks) and then ``model``. A parameter is sharded on
    ``fsdp_dim``; one below ``min_size`` or with no divisible dim stays
    replicated (FSDP ignores it, and the step all-reduces its gradient).
    Returns the replicated ones."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    ndata = mesh.data
    keep = {p for p in model.parameters()
            if fsdp_dim(tuple(p.shape), ndata, min_size) is None}

    def placement(p: nn.Parameter):
        return Shard(fsdp_dim(tuple(p.shape), ndata, min_size) or 0)

    dm = mesh.device_mesh[DATA_AXIS]
    for unit in list(units) + [model]:
        fully_shard(unit, mesh=dm, shard_placement_fn=placement,
                    ignored_params=keep & set(unit.parameters()) or None)
    return keep


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor (collective: every rank calls it alike), or
    the tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t
