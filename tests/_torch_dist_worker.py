"""Worker of the port's multi-rank CPU tests (gloo, one process per rank).

Run as: python -m tests._torch_dist_worker <scenario> <rank> <world>
        <dir>

``<dir>`` holds the process group's rendezvous file, the scenario's inputs
written by the parent (``inputs.pt``) and each rank's result
(``out_<rank>.pt``). The worker imports torch and the port only, never
jax. The scenarios (``SCENARIOS``) run the port's steps under each mode
and save what the parent holds against the one-rank run and the JAX
package.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

PORT = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
        "and_pose_estimation_tpu_torch")

HW = 56
TASK_ARGS = dict(encoder="vitt", min_depth=1e-6, max_depth=20.0,
                 encoder_lr=1e-3, decoder_lr=3e-3, pct_start=0.3,
                 div_factor=25.0, clip_norm=1.0, total_steps=10,
                 grad_accum=2)
POSE_ARGS = dict(lr=1e-4, beta=1.0, cycle_momentum=True, total_steps=10,
                 pct_start=0.3, div_factor=25.0)


def depth_batches(steps: int = 2, accum: int = 2, mb: int = 4,
                  seed: int = 0, uneven: bool = False):
    """(steps, accum, mb, HW, HW, 3) images and (.., HW, HW) depths, with
    invalid pixels; ``uneven`` leaves the first half of every microbatch
    mostly invalid, so the ranks' valid-pixel counts differ."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (steps, accum, mb, HW, HW, 3)).astype(
        np.float32)
    depths = rng.uniform(0.5, 18.0, (steps, accum, mb, HW, HW)).astype(
        np.float32)
    bad = rng.uniform(size=depths.shape)
    depths[bad < 0.05] = 0.0
    depths[bad > 0.95] = 25.0
    if uneven:
        depths[:, :, :mb // 2][bad[:, :, :mb // 2] < 0.8] = 0.0
    return images, depths


def pose_batch(b: int = 4, hw: int = 64, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 8, hw, hw)).astype(np.float32)
    target = np.concatenate([rng.normal(size=(b, 3)),
                             rng.normal(size=(b, 4))], 1).astype(np.float32)
    return x, target


def rows_of(x, rank: int, world: int, axis: int = 0):
    """The loader's contiguous share of ``x`` for ``rank``."""
    per = x.shape[axis] // world
    return np.take(x, range(rank * per, (rank + 1) * per), axis=axis)


# --------------------------------------------------------------- scenarios

# Gradient checkpointing is on where the blocks communicate, so their
# collectives also run in the recompute (the numerics are the same).
DEPTH_MODES = {
    # name: (mesh (data, model), DepthTask knobs)
    "dp": ((2, 1), {}),
    "fsdp": ((2, 1), dict(fsdp=True, fsdp_min_size=1024)),
    "tp": ((1, 2), dict(tensor_parallel=True, grad_checkpoint=True)),
    "tpsp": ((1, 2), dict(tensor_parallel=True, seq_parallel=True,
                          grad_checkpoint=True)),
    "tpfsdp": ((2, 2), dict(tensor_parallel=True, fsdp=True,
                            fsdp_min_size=1024, grad_checkpoint=True)),
}


def _depth_run(mode: str, inputs: dict, rank: int, world: int,
               uneven: bool = False) -> dict:
    from importlib import import_module

    meshlib = import_module(f"{PORT}.parallel.mesh")
    DepthTask = import_module(f"{PORT}.train.depth_task").DepthTask
    POLICY_F32 = import_module(f"{PORT}.core.dtypes").POLICY_F32

    shape, knobs = DEPTH_MODES[mode]
    mesh = meshlib.build_mesh(meshlib.MeshSpec(*shape), "cpu")
    task = DepthTask(policy=POLICY_F32, device="cpu", device_mesh=mesh,
                     **{"grad_checkpoint": False, **TASK_ARGS, **knobs})
    state = task.init_state(0, pretrained_params=inputs["params0"])
    images, depths = depth_batches(uneven=uneven)
    out = {"losses": [], "metrics": [], "states": []}
    for s in range(images.shape[0]):
        batch = {"image": torch.from_numpy(rows_of(images[s], rank, world,
                                                   axis=1)),
                 "depth": torch.from_numpy(rows_of(depths[s], rank, world,
                                                   axis=1))}
        state, m = task.train_step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_cloned(state.state_dict()))
    # What this rank holds: its slices under TP, its shards under FSDP.
    out["numel"] = sum(meshlib.local(p).numel()
                       for p in state.model.parameters())
    return out, task, state


def _cloned(tree):
    """A copy of a state dict (its tensors alias the live parameters)."""
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cloned(v) for v in tree]
    return tree.clone() if torch.is_tensor(tree) else tree


def scenario_parallel(rank: int, world: int, inputs: dict) -> dict:
    """DP, FSDP, TP and TP+SP (2 ranks), DP on uneven valid pixels, pose
    DP with dropout off and on."""
    out = {}
    for mode in ("dp", "fsdp", "tp", "tpsp"):
        out[mode] = _depth_run(mode, inputs, rank, world)[0]
    out["dp_uneven"] = _depth_run("dp", inputs, rank, world, uneven=True)[0]
    out["pose"] = {d: _pose_run(rank, world, inputs, d)
                   for d in (False, True)}
    return out


def _pose_run(rank: int, world: int, inputs: dict, dropout: bool) -> dict:
    from importlib import import_module

    meshlib = import_module(f"{PORT}.parallel.mesh")
    PoseTask = import_module(f"{PORT}.train.pose_task").PoseTask

    mesh = meshlib.build_mesh(meshlib.MeshSpec(world, 1), "cpu")
    task = PoseTask(device="cpu", device_mesh=mesh, dropout=dropout,
                    **POSE_ARGS)
    state = task.init_state(seed=2, weights=inputs["pose0"])
    x, target = pose_batch()
    out = {"losses": [], "metrics": [], "states": []}
    for _ in range(2):
        state, m = task.train_step(state, {
            "input": rows_of(x, rank, world),
            "target": rows_of(target, rank, world)})
        out["losses"].append(float(m["loss"]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_cloned(state.model.state_dict()))
    return out


def scenario_pipeline(rank: int, world: int, inputs: dict) -> dict:
    """The taps of ``pipeline_vit_taps`` (GPipe and interleaved), the
    pipelined forward's gradient, one pipelined ``DepthTask`` step and
    the eval fallback, at mesh (world // 2, 2); on four ranks also the
    TP+FSDP steps at (2, 2) and their checkpoint."""
    from importlib import import_module

    meshlib = import_module(f"{PORT}.parallel.mesh")
    pipeline = import_module(f"{PORT}.parallel.pipeline")
    DepthTask = import_module(f"{PORT}.train.depth_task").DepthTask
    POLICY_F32 = import_module(f"{PORT}.core.dtypes").POLICY_F32
    da = import_module(f"{PORT}.models.depth_anything")

    data = world // 2
    mesh = meshlib.build_mesh(meshlib.MeshSpec(data, 2), "cpu")
    model = da.build_depth_model("vitt", dtype=torch.float32, device="cpu")
    model.load_state_dict(inputs["params0"])
    vit = model.pretrained
    x = torch.from_numpy(inputs["tokens"])          # (B, T, C) global
    b = x.shape[0] // data
    x_local = x[mesh.data_index * b:(mesh.data_index + 1) * b]
    out = {}
    with torch.no_grad():
        for virtual in (1, 2):
            out[f"taps_v{virtual}"] = pipeline.pipeline_vit_taps(
                lambda g, h: vit.blocks[g](h), 4, x_local, [0, 1, 2, 3],
                mesh, 2, 2, virtual)

    # Gradient of a fixed linear function of the pipelined depth.
    images = torch.from_numpy(inputs["images"])
    w = torch.from_numpy(inputs["weights"])
    bi = images.shape[0] // data
    rows = slice(mesh.data_index * bi, (mesh.data_index + 1) * bi)
    for virtual in (1, 2):
        model.zero_grad()
        depth = pipeline.build_pp_depth_forward(model, mesh, 2, 2,
                                                virtual)(images[rows])
        (depth * w[rows]).sum().backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        meshlib.sum_grads(grads, mesh.model_group)
        meshlib.sum_grads(grads, mesh.data_group)
        out[f"grads_v{virtual}"] = {n: g.clone() for (n, _), g in
                                    zip(model.named_parameters(), grads)}

    # One pipelined DepthTask step; then the eval fallback.
    task = DepthTask(policy=POLICY_F32, grad_checkpoint=True, device="cpu",
                     device_mesh=mesh, pipeline_parallel=2,
                     pipe_microbatches=int(inputs["n_micro"]),
                     pipe_virtual=int(inputs["virtual"]), **TASK_ARGS)
    state = task.init_state(0, pretrained_params=inputs["params0"])
    images, depths = depth_batches(steps=1)
    batch = {"image": torch.from_numpy(rows_of(images[0], rank, world, 1)),
             "depth": torch.from_numpy(rows_of(depths[0], rank, world, 1))}
    state, m = task.train_step(state, batch)
    out["step_loss"] = float(m["loss"])
    out["step_state"] = _cloned(state.state_dict()["model"])
    try:
        task.train_step(state, {
            "image": torch.from_numpy(images[0][:, :3]),
            "depth": torch.from_numpy(depths[0][:, :3]),
            "_replicated": True})
        out["train_guard"] = None
    except ValueError as exc:
        out["train_guard"] = str(exc)
    # An eval batch of 3 rows that every rank holds: the plain forward.
    out["eval_fallback"] = {k: float(v) for k, v in task.eval_step(
        state.model, {"image": torch.from_numpy(images[0][0, :3]),
                      "depth": torch.from_numpy(depths[0][0, :3]),
                      "_replicated": True}).items()}
    out["eval_model"] = _cloned(state.model.state_dict())
    if world == 4:
        ckpt = import_module(f"{PORT}.core.checkpoint")
        loop = import_module(f"{PORT}.train.loop")
        out["tpfsdp"], task, state = _depth_run("tpfsdp", inputs, rank,
                                                world)
        mgr = ckpt.CheckpointManager(inputs["ckpt_dir"])
        loop._save(mgr, task.mesh, state.step, state, {"val_loss": 1.0})
        # Resume under the same mesh: the whole tensors back into shards.
        fresh = task.init_state(7)
        mgr.restore_latest(fresh)
        out["tpfsdp_resumed"] = _cloned(fresh.state_dict())
    return out


def scenario_preempt(rank: int, world: int, inputs: dict) -> list:
    """Each of ``inputs["runs"]`` in turn, in this process: ``fit_depth``
    (or ``fit_pose``) on the fixture; rank 0 SIGTERMs itself while its
    loader yields batch ``fire_at`` (so that batch's step trains first).
    ``resume`` continues to ``max_steps``."""
    return [_preempt_run(rank, world, run) for run in inputs["runs"]]


def _preempt_run(rank: int, world: int, inputs: dict) -> dict:
    from importlib import import_module

    ckptlib = import_module(f"{PORT}.core.checkpoint")
    meshlib = import_module(f"{PORT}.parallel.mesh")
    loop = import_module(f"{PORT}.train.loop")
    POLICY_F32 = import_module(f"{PORT}.core.dtypes").POLICY_F32

    mesh = meshlib.build_mesh(meshlib.MeshSpec(world, 1), "cpu")
    kind = inputs["kind"]
    fire = inputs["fire_at"] if rank == 0 and not inputs["resume"] else None
    if kind == "depth":
        dm = import_module(f"{PORT}.data.simcol").SimColDataModule(
            data_dir=inputs["fixture"],
            train_list=f"{inputs['fixture']}/train.txt",
            val_list=f"{inputs['fixture']}/val.txt",
            test_list=f"{inputs['fixture']}/test.txt",
            batch_size=2, num_workers=1, size=HW, seed=7)
        task = import_module(f"{PORT}.train.depth_task").DepthTask(
            policy=POLICY_F32, grad_checkpoint=False, device="cpu",
            device_mesh=mesh, **{**TASK_ARGS, "grad_accum": 1})
        fit = loop.fit_depth
        kw = dict(val_check_interval=0.5, seed=7)
    else:
        dm = import_module(f"{PORT}.data.pose").PoseDataModule(
            data_dir=inputs["fixture"],
            train_list=f"{inputs['fixture']}/train.txt",
            val_list=f"{inputs['fixture']}/val.txt",
            test_list=f"{inputs['fixture']}/test.txt",
            batch_size=2, num_workers=1, size=64, seed=7)
        task = import_module(f"{PORT}.train.pose_task").PoseTask(
            device="cpu", device_mesh=mesh, **POSE_ARGS)
        fit = loop.fit_pose
        kw = dict(seed=7)
    dm.rank, dm.world = mesh.rank, mesh.world
    state = fit(task, _Firing(dm, fire), max_epochs=3,
                log_dir=os.path.join(inputs["dir"], f"logs{rank}"),
                ckpt_dir=inputs["ckpt_dir"], max_steps=inputs["max_steps"],
                resume=inputs["resume"], patience=inputs["patience"], **kw)
    mgr = ckptlib.CheckpointManager(inputs["ckpt_dir"])
    return {"step": state.step, "latest_step": mgr.latest_step(),
            "metrics": mgr.latest_metrics(),
            "steps_saved": sorted(
                d for d in os.listdir(inputs["ckpt_dir"]) if d.isdigit())}


class _Firing:
    """A datamodule whose train loader SIGTERMs this process while it
    yields batch ``fire`` (None: never)."""

    def __init__(self, inner, fire: int | None):
        self._inner = inner
        self._fire = fire

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def train_loader(self):
        inner = self._inner.train_loader()
        fire = self._fire

        class Loader:
            def __len__(self):
                return len(inner)

            def __iter__(self):
                for i, b in enumerate(inner):
                    if i == fire:
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b

        return Loader()


def scenario_cli(rank: int, world: int, inputs: dict) -> dict:
    """``cli.train_depth.main`` and then ``cli.test_depth.main`` on the
    fixture, as torchrun would start them."""
    from importlib import import_module

    os.chdir(inputs["cwd"])
    train = import_module(f"{PORT}.cli.train_depth")
    test = import_module(f"{PORT}.cli.test_depth")
    run = train.main(inputs["train_argv"])
    os.environ["CHECKPOINT_PATH"] = run["ckpt_dir"]
    results = test.main(inputs["test_argv"])
    return {"run": run, "results": results}


@contextlib.contextmanager
def one_thread():
    """torch on one thread in this process meanwhile: the references are
    tiny, and spare threads only spin beside the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def start(scenario: str, world: int, workdir: str, inputs: dict):
    """Start ``scenario`` on ``world`` gloo ranks; returns a function of
    a timeout that waits for them and returns each rank's result, so the
    parent can compute its references meanwhile."""
    import subprocess

    os.makedirs(workdir, exist_ok=True)
    for name in ["pg"] + [f"out_{r}.pt" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._torch_dist_worker", scenario,
         str(r), str(world), workdir], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]

    def finish(timeout: int = 600) -> list:
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(
                    errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        failed = [f"rank {r} (exit {p.returncode}):\n{log[-3000:]}"
                  for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode != 0]
        assert not failed, "\n".join(failed)
        return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                           weights_only=False) for r in range(world)]

    return finish


SCENARIOS = {"parallel": scenario_parallel, "pipeline": scenario_pipeline,
             "preempt": scenario_preempt, "cli": scenario_cli}


def main() -> None:
    scenario, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    if world > 1:  # one process makes no process group
        os.environ.update(
            RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
            E3D_DIST_INIT="file://" + os.path.join(workdir, "pg"))
        meshlib = __import__(f"{PORT}.parallel.mesh", fromlist=["mesh"])
        meshlib.init_distributed("cpu", required=True)
    result = SCENARIOS[scenario](rank, world, inputs)
    torch.save(result, os.path.join(workdir, f"out_{rank}.pt"))
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    assert "jax" not in sys.modules


if __name__ == "__main__":
    main()
