"""The port's parallel modes on gloo CPU ranks against the one-rank run
and the JAX package.

Two ranks (one launch) take two ``DepthTask`` steps of grad-accum 2 on a
global microbatch of 4 under DP (2, 1), FSDP (2, 1), TP (1, 2) and TP+SP
(1, 2), once more under DP on a batch whose ranks hold very different
valid-pixel counts (a mean of per-rank SiLog losses would differ from the
global one), and two pose steps under DP (BatchNorm over the global
batch, dropout off and on). TP+FSDP needs four ranks: it runs in
``tests/test_torch_pipeline.py``'s four-rank launch. Gradient
checkpointing is on under TP, so every block's collectives also
run in the recompute.

Tolerances (fixed before the runs): N ranks against one, the loss within
rtol 1e-5 and every parameter within twice the learning rates of the
steps taken, with at most 1% of its elements beyond 1e-6 of the largest
learning rate (Adam turns a gradient at rounding level into an update of
either sign; the rule of ``tests/test_torch_kernels_cuda.py``'s pose step);
against the JAX package, the loss within rtol 2e-4
(``tests/test_torch_depth_task.py``) and every parameter within 2 lr; the
pose step also by the 1% count (see
``test_dp_step_matches_the_jax_dp_step`` for the depth step).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.core.dtypes import POLICY_F32 as J_F32
from e3d_tpu.models.convert import convert_dav2, convert_pose_net
from e3d_tpu.parallel import mesh as jmesh
from e3d_tpu.train import DepthTask as JaxDepthTask
from e3d_tpu.train.depth_task import DepthTrainState as JaxDepthTrainState
from e3d_tpu.train.pose_task import PoseTask as JaxPoseTask
from e3d_tpu.train.pose_task import PoseTrainState as JaxPoseTrainState
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.dtypes import POLICY_F32
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import (
    from_jax_params, from_jax_pose_variables)
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.parallel import mesh as meshlib
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import (
    DepthTask, gloo_refusal)
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.pose_task import PoseTask
from tests._torch_dist_worker import (POSE_ARGS, TASK_ARGS,
                                      depth_batches, one_thread, pose_batch,
                                      start)


def params_close(got: dict, want: dict, lr_sum: float, lr_max: float
                 ) -> None:
    """Every parameter within 2 x ``lr_sum``; at most 1% of the elements
    beyond 1e-6 x ``lr_max``."""
    flipped = total = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")):
            continue
        diff = (torch.as_tensor(got[key]).float()
                - torch.as_tensor(value).float()).abs()
        assert diff.max().item() <= 2.0 * lr_sum * 1.01 + 1e-7, key
        flipped += int((diff > 1e-6 * lr_max + 1e-8).sum())
        total += diff.numel()
    assert flipped <= 0.01 * total, (flipped, total)


def _lrs(task, steps: int) -> tuple[float, float]:
    table = task.lr_table()
    per_step = [max(float(table["encoder"][s]), float(table["decoder"][s]))
                for s in range(steps)]
    return sum(per_step), max(per_step)


def _one_rank(params0, uneven=False):
    task = DepthTask(policy=POLICY_F32, grad_checkpoint=False, device="cpu",
                     **TASK_ARGS)
    state = task.init_state(0, pretrained_params=params0)
    images, depths = depth_batches(uneven=uneven)
    losses, states = [], []
    for s in range(images.shape[0]):
        state, m = task.train_step(state, {
            "image": torch.from_numpy(images[s]),
            "depth": torch.from_numpy(depths[s])})
        losses.append(float(m["loss"]))
        states.append({k: v.clone() for k, v in
                       state.model.state_dict().items()})
    return task, losses, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with one_thread():
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    """The port's seeded weights are every run's (the JAX DP task at mesh
    (2, 1) starts from them through the JAX package's ``convert_dav2``);
    the launch runs while this process computes the one-rank references
    and the JAX steps."""
    params0 = {k: v.clone() for k, v in DepthTask(
        policy=POLICY_F32, device="cpu", **TASK_ARGS).init_state(0)
        .model.state_dict().items()}
    pose0 = {k: v.clone() for k, v in PoseTask(
        device="cpu", dropout=False, **POSE_ARGS).init_state(seed=2)
        .model.state_dict().items()}
    two = start("parallel", 2, str(tmp_path_factory.mktemp("parallel2")),
                {"params0": params0, "pose0": pose0})
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=2, model=1),
                            devices=jax.devices()[:2])
    jtask = JaxDepthTask(policy=J_F32, grad_checkpoint=False,
                         device_mesh=mesh, **TASK_ARGS)
    params = jax.tree.map(jnp.asarray, convert_dav2(
        {k: v.numpy() for k, v in params0.items()}, "vitt"))
    with jax.default_matmul_precision("highest"):
        jtask._optimizer = jtask._opt_factory(params)
        jstate = JaxDepthTrainState(params, jtask._optimizer.init(params),
                                    jnp.zeros((), jnp.int32))
        jstate = jax.device_put(jstate, jtask.state_shardings(jstate))
    # The JAX steps compile in threads of their own (XLA's compiler
    # releases the GIL), beside the port's references.
    with ThreadPoolExecutor(2) as pool:
        depth = pool.submit(_jax_depth_step, jtask, jstate)
        pose = pool.submit(_jax_pose_step, pose0)
        out = {"params0": params0, "pose0": pose0,
               "one": _one_rank(params0),
               "one_uneven": _one_rank(params0, True),
               "jax_depth": depth.result(), "jax_pose": pose.result()}
    return {**out, "ranks": two()}


def _jax_depth_step(jtask, jstate):
    """The JAX DP step's loss, metrics and parameters."""
    images, depths = depth_batches()
    with jax.default_matmul_precision("highest"):
        jstate, jm = jtask.train_step(
            jstate, {"image": jnp.asarray(images[0]),
                     "depth": jnp.asarray(depths[0])})
    return ({k: float(v) for k, v in jm.items()},
            from_jax_params(jax.tree.map(np.array, jstate.params)))


def _jax_pose_step(pose0):
    """The JAX pose step at mesh (2, 1), dropout off, from ``pose0``."""
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=2, model=1),
                            devices=jax.devices()[:2])
    jtask = JaxPoseTask(policy=J_F32, device_mesh=mesh, dropout=False,
                        **POSE_ARGS)
    variables = convert_pose_net({
        k: v.numpy() for k, v in pose0.items()
        if not k.endswith("num_batches_tracked")})
    jstate = JaxPoseTrainState(
        variables["params"], variables["batch_stats"],
        jtask.optimizer.init(variables["params"]), jnp.zeros((), jnp.int32),
        jax.random.PRNGKey(0))
    x, target = pose_batch()
    with jax.default_matmul_precision("highest"):
        jstate, jm = jtask.train_step(
            jstate, {"input": jnp.asarray(x.transpose(0, 2, 3, 1)),
                     "target": jnp.asarray(target)})
    return ({k: float(v) for k, v in jm.items()},
            from_jax_pose_variables(jax.tree.map(np.array, {
                "params": jstate.params,
                "batch_stats": jstate.batch_stats})))


@pytest.mark.parametrize("mode", ["dp", "fsdp", "tp", "tpsp", "dp_uneven"])
def test_two_rank_step_matches_one_rank(runs, mode):
    task, losses, states = runs["one_uneven" if mode == "dp_uneven"
                                else "one"]
    r0, r1 = runs["ranks"][0][mode], runs["ranks"][1][mode]
    assert r0["losses"] == r1["losses"]  # every rank holds the global loss
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    lr_sum, lr_max = _lrs(task, 2)
    for s in range(2):
        params_close(r0["states"][s]["model"], states[s],
                     *_lrs(task, s + 1))
    # Checkpoints are whole tensors on every rank, in one layout.
    for key, value in r1["states"][-1]["model"].items():
        assert value.shape == states[-1][key].shape, key
    # The optimizer's moments are whole plain tensors too, under FSDP as
    # under DP.
    moments = r0["states"][-1]["optimizer"]["state"].values()
    assert sorted(tuple(m["exp_avg"].shape) for m in moments) == sorted(
        tuple(v.shape) for v in states[-1].values())
    assert all(type(m["exp_avg"]) is torch.Tensor for m in moments)
    assert lr_sum > lr_max > 0
    # Under TP each rank holds half of each split projection (and its
    # optimizer the moments of that half); under DP the whole model.
    whole = sum(v.numel() for v in states[-1].values())
    split = sum(v.numel() for k, v in states[-1].items()
                if meshlib.tp_split(k) is not None)
    if mode in ("tp", "tpsp"):
        assert r0["numel"] == r1["numel"] == whole - split // 2
    elif mode != "fsdp":
        assert r0["numel"] == whole


def test_dp_step_matches_the_jax_dp_step(runs):
    """The port's 2-rank DP step against the JAX step at mesh (2, 1) on
    the same global batch and weights: the loss and metrics within 2e-4,
    every parameter within 2 lr. The 1e-6-lr count is a rule within one
    framework: at random init many of the encoder's gradients sit at f32
    rounding level, Adam turns each into a full step of either sign, and
    optax and torch round the update in another order; the one-process
    gradients and updates are held to the JAX package's in
    ``tests/test_torch_depth_task.py``, and the 2-rank step to the
    one-process one here."""
    jm, want = runs["jax_depth"]
    got = runs["ranks"][0]["dp"]
    np.testing.assert_allclose(got["losses"][0], jm["loss"], rtol=2e-4)
    for k in ("d1", "abs_rel", "rmse", "l1"):
        np.testing.assert_allclose(got["metrics"][0][k], jm[k], rtol=2e-4,
                                   err_msg=k)
    lr_sum, _ = _lrs(runs["one"][0], 1)
    for key, value in want.items():
        diff = (got["states"][0]["model"][key] - value).abs()
        assert diff.max().item() <= 2.0 * lr_sum * 1.01 + 1e-7, key


@pytest.mark.parametrize("dropout", [False, True])
def test_pose_dp_matches_one_rank(runs, dropout):
    """BatchNorm over the global batch (its running statistics too) and,
    with dropout on, the masks of the global batch's rows."""
    task = PoseTask(device="cpu", dropout=dropout, **POSE_ARGS)
    state = task.init_state(seed=2, weights=runs["pose0"])
    x, target = pose_batch()
    losses = []
    for _ in range(2):
        state, m = task.train_step(state, {"input": x, "target": target})
        losses.append(float(m["loss"]))
    got = runs["ranks"][0]["pose"][dropout]
    assert got["losses"] == runs["ranks"][1]["pose"][dropout]["losses"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = state.model.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["states"][-1][key], value,
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    lr = task.lr_table()
    params_close(got["states"][-1], want, float(lr[0] + lr[1]),
                 float(lr[1]))


def test_pose_dp_matches_the_jax_dp_step(runs):
    """The first pose DP step (dropout off) against the JAX step at mesh
    (2, 1): loss, metrics, BatchNorm statistics and parameters (the 1%
    count holds here: the pose net's gradients are not at rounding
    level)."""
    jm, want = runs["jax_pose"]
    got = runs["ranks"][0]["pose"][False]
    np.testing.assert_allclose(got["losses"][0], jm["loss"], rtol=2e-4)
    for k in ("ate", "rte", "rote"):
        np.testing.assert_allclose(got["metrics"][0][k], jm[k], rtol=1e-4,
                                   err_msg=k)
    mine = got["states"][0]
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(mine[key], value.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    lr0 = float(PoseTask(device="cpu", **POSE_ARGS).lr_table()[0])
    params_close(mine, want, lr0, lr0)


@pytest.mark.parametrize("device,backend,knobs,what", [
    ("cuda", "gloo", dict(fsdp=True), "fsdp (all-gather, reduce-scatter)"),
    ("cuda", "gloo", dict(pipeline_parallel=2),
     "pipeline_parallel (send/recv)"),
    ("cuda", "gloo", {}, None),
    ("cuda", "nccl", dict(fsdp=True, pipeline_parallel=2), None),
    ("cpu", "gloo", dict(fsdp=True, pipeline_parallel=2), None),
])
def test_gloo_refuses_what_it_cannot_move_on_the_card(device, backend, knobs,
                                                      what):
    """FSDP and the pipeline need collectives of CUDA tensors that gloo
    does not have: two ranks on one card stop with this message (the
    refusal ``chip_smoke.py`` requires of those runs); DP and TP, the
    CPU and NCCL run."""
    got = gloo_refusal(torch.device(device), backend,
                       knobs.get("fsdp", False),
                       knobs.get("pipeline_parallel", 0))
    if what is None:
        assert got is None
    else:
        assert got == (f"{what} needs collectives of CUDA tensors that "
                       "the gloo backend does not have; run one process "
                       "per card on nccl")


@pytest.mark.parametrize("spec", [(-1, 2), (4, 1), (3, 2)])
def test_mesh_size_errors_match_the_jax_package(spec):
    """One process: the JAX package's message for the same shape on one
    device."""
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(jmesh.MeshSpec(*spec), devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        meshlib.build_mesh(meshlib.MeshSpec(*spec))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knobs", [
    dict(pipeline_parallel=2, tensor_parallel=True),
    dict(pipeline_parallel=2, seq_parallel=True),
    dict(pipeline_parallel=2, fsdp=True),
    dict(pipeline_parallel=2, token_merge=0.3),
    dict(pipeline_parallel=2, quant_int8=True),
    dict(pipeline_parallel=2),
    dict(pipeline_parallel=2, distill_encoder="vitt"),
])
def test_mode_guards_match_the_jax_package(knobs):
    """The pipeline's guards, with the JAX package's messages (a one-rank
    mesh, so ``mesh_model`` is 1 where the guards reach it)."""
    jknobs = dict(knobs)
    with pytest.raises(ValueError) as want:
        JaxDepthTask(encoder="vitt", policy=J_F32,
                     device_mesh=jmesh.build_mesh(
                         jmesh.MeshSpec(1, 1), devices=jax.devices()[:1]),
                     **jknobs)
    with pytest.raises(ValueError) as got:
        DepthTask(encoder="vitt", policy=POLICY_F32, device="cpu", **knobs)
    assert str(got.value) == str(want.value)


def test_batched_runner_data_parallel_resolves_like_the_jax_package(
        monkeypatch):
    """One visible device: ``data_parallel=None`` is off (the JAX
    package's ``n_dev > 1`` rule) and True raises naming the count. With
    two cards (patched), static calibration keeps the JAX package's
    warning (None: one card) and error (True)."""
    import warnings

    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as da

    model = da.build_depth_model("vitt", dtype=torch.float32, device="cpu",
                                 quant_int8=True)
    frames = [np.random.default_rng(i).integers(0, 256, (28, 28, 3),
                                                 dtype=np.uint8)
              for i in range(2)]
    runner = da.BatchedRunner(model, (28, 28), input_size=28, batch_size=2)
    assert len(runner.replicas) == 1 and len(runner(frames)) == 2
    with pytest.raises(ValueError, match="1 visible, batch 2"):
        da.BatchedRunner(model, (28, 28), input_size=28, batch_size=2,
                         data_parallel=True)
    monkeypatch.setattr(da, "visible_cards", lambda device: 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner = da.BatchedRunner(model, (28, 28), input_size=28,
                                  batch_size=2, calib_frames=frames,
                                  calib_batches=1)
    assert len(runner.replicas) == 1 and runner.amax is not None
    assert any("single-chip" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="does not compose with "
                       "multi-device inference yet"):
        da.BatchedRunner(model, (28, 28), input_size=28, batch_size=2,
                         calib_frames=frames, calib_batches=1,
                         data_parallel=True)
