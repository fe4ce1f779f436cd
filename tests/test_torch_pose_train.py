"""Pose training in the port against the JAX package on the CPU: the pose
optimizer (OneCycle, clip, AdamW, the cycled b1), ``PoseTask.train_step``,
``PoseDataset`` pairs and targets, and ``cli.train_pose`` end to end.

Tolerances, f32 on both sides (JAX at ``highest``): optimizer parameters
1e-6 (a few f32 steps of unit-scale parameters: the same arithmetic,
rounded in another order, over 20 steps of fixed gradients; b1 values
1e-7); the train step's loss 1e-5 relative, its updated
BatchNorm statistics 1e-5 relative and 1e-6 absolute (0.1 of batch means
near zero), its batch metrics 1e-4 (ATE/RTE/ROTE of
predictions that agree to 1e-5). The updated parameters: Adam's first step
moves each element by about +-lr, so an element whose gradient is at f32
noise level may move either way; all others must agree to 1e-6 of lr, and
those, where the two gradients' signs differ, are at most 1% of the
elements. Dataset inputs 1e-6 (the same host resize in numpy), targets
exact.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.core.dtypes import POLICY_F32 as J_F32
from e3d_tpu.data import pose as jpose
from e3d_tpu.parallel import mesh as meshlib
from e3d_tpu.train import optim as joptim
from e3d_tpu.models.convert import convert_pose_net
from e3d_tpu.train.pose_task import PoseTask as JaxPoseTask
from e3d_tpu.train.pose_task import PoseTrainState as JaxPoseTrainState
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.cli import train_pose
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data import pose as tpose
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.data.synthetic import make_simcol_fixture
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import from_jax_pose_variables
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train import optim as toptim
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.pose_task import PoseTask

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
SCHED = dict(total_steps=20, pct_start=0.3, div_factor=25.0)


@pytest.mark.parametrize("cycle", [True, False], ids=["cycled", "fixed"])
def test_pose_optimizer_matches_optax(cycle):
    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32)}
    layer = torch.nn.Linear(5, 6)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(init["w"]))
        layer.bias.copy_(torch.from_numpy(init["b"]))
    topt = toptim.make_pose_optimizer(layer, 1e-2, cycle_momentum=cycle,
                                      **SCHED)
    jopt = joptim.make_pose_optimizer(1e-2, cycle_momentum=cycle, **SCHED)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    momentum = toptim.onecycle_momentum_schedule(20, 0.3)
    for step in range(SCHED["total_steps"]):
        # Every third step's gradient exceeds the clip norm.
        scale = 3.0 if step % 3 == 0 else 0.05
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in init.items()}
        layer.weight.grad = torch.from_numpy(grads["w"])
        layer.bias.grad = torch.from_numpy(grads["b"])
        topt.step(step)
        updates, jstate = update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(jparams["w"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {step}")
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(jparams["b"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {step}")
        b1 = topt.optimizer.param_groups[0]["betas"][0]
        if cycle:
            jb1 = float(jstate[1].hyperparams["b1"])
            np.testing.assert_allclose(b1, jb1, atol=1e-7)
            np.testing.assert_allclose(
                jb1, float(joptim.onecycle_momentum_schedule(20, 0.3)(step)),
                atol=1e-7)
            assert b1 == momentum(step)
        else:
            assert b1 == 0.9
    if cycle:  # 0.95 -> 0.85 at the LR's peak -> back toward 0.95
        values = [momentum(s) for s in range(20)]
        assert values[0] == pytest.approx(0.95)
        assert min(values) == pytest.approx(0.85)
        assert values[-1] == pytest.approx(0.95)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_pose_train_step_matches_jax():
    """One ``PoseTask.train_step`` at 32x32, f32, dropout off, cycled b1,
    from the same weights, the JAX step's result read back through
    ``from_jax_pose_variables``."""
    args = dict(lr=1e-4, beta=1.0, cycle_momentum=True, dropout=False,
                total_steps=10, pct_start=0.3, div_factor=25.0)
    mesh = meshlib.build_mesh(meshlib.MeshSpec(data=1, model=1),
                              devices=jax.devices()[:1])
    jtask = JaxPoseTask(policy=J_F32, device_mesh=mesh, **args)
    task = PoseTask(device="cpu", **args)
    # The port's seeded weights, carried to the JAX package by its own
    # converter: the JAX state starts from them.
    state = task.init_state(seed=2)
    variables = convert_pose_net({
        k: v.numpy() for k, v in state.model.state_dict().items()
        if not k.endswith("num_batches_tracked")})
    jstate = JaxPoseTrainState(
        variables["params"], variables["batch_stats"],
        jtask.optimizer.init(variables["params"]), jnp.zeros((), jnp.int32),
        jax.random.PRNGKey(0))
    before = _flat(variables["params"])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32, 32, 8)).astype(np.float32)
    target = np.concatenate([rng.normal(size=(4, 3)),
                             rng.normal(size=(4, 4))], 1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jtask.train_step(
            jstate, {"input": jnp.asarray(x), "target": jnp.asarray(target)})
    state, metrics = task.train_step(
        state, {"input": x.transpose(0, 3, 1, 2), "target": target})
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), rtol=1e-5)
    for k in ("ate", "rte", "rote"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    want = from_jax_pose_variables({"params": jstate.params,
                                    "batch_stats": jstate.batch_stats})
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key], value.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    lr0 = task.lr_table()[0]
    flipped = total = 0
    for key, value in want.items():
        if key.endswith(("weight", "bias")) and "running" not in key:
            diff = np.abs(got[key] - value.numpy())
            assert diff.max() <= 2.0 * lr0 * 1.01 + 1e-7, key
            flipped += int(np.sum(diff > 1e-6 * lr0 + 1e-8))
            total += diff.size
    assert total == sum(v.size for v in before.values())
    assert flipped <= 0.01 * total, (flipped, total)


def test_pose_dataset_matches_jax(tmp_path, monkeypatch):
    root = make_simcol_fixture(str(tmp_path / "sim"), n_procedures=3,
                               frames_per_proc=5, hw=40, seed=3)
    lists = {m: os.path.join(root, f"{m.lower()}.txt")
             for m in ("Train", "Val")}
    # One blacklisted validation frame in the middle of a procedure: its
    # two pairs go, the pairs on either side stay.
    bad = ("SyntheticColon_I/Frames_S2/FrameBuffer_0002.png",)
    monkeypatch.setattr(tpose.dio, "BAD_VAL_FRAMES", bad)
    monkeypatch.setattr(jpose.dio, "BAD_VAL_FRAMES", bad)
    for mode, n_pairs in (("Train", 4), ("Val", 2 + 4)):
        got = tpose.PoseDataset(root, lists[mode], 28, mode)
        want = jpose.PoseDataset(root, lists[mode], 28, mode)
        assert len(got) == len(want) == n_pairs, mode
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert (g["dataset"], g["id"]) == (w["dataset"], w["id"])
            assert g["input"].shape == (8, 28, 28)
            np.testing.assert_allclose(g["input"],
                                       w["input"].transpose(2, 0, 1),
                                       atol=1e-6)
            np.testing.assert_array_equal(g["target"], w["target"])
    ids = [tpose.PoseDataset(root, lists["Val"], 28, "Val")[i]["id"]
           for i in range(2)]
    assert ids == ["FrameBuffer_0000.png", "FrameBuffer_0003.png"]
    dm = tpose.PoseDataModule(root, lists["Train"], lists["Val"],
                              lists["Val"], batch_size=2, num_workers=2,
                              size=28)
    dm.setup("fit")
    batch = next(iter(dm.train_loader()))
    assert batch["input"].shape == (2, 8, 28, 28)
    assert batch["input"].dtype == np.float32


def test_train_pose_cli_end_to_end(tmp_path, monkeypatch):
    """``train_pose --device cpu``: two steps, a checkpoint holding the
    BatchNorm statistics, the snapshot, ``pose_results.json`` with finite
    per-procedure and overall metrics; then a resumed run goes on from
    step 2."""
    root = make_simcol_fixture(str(tmp_path / "sim"), n_procedures=3,
                               frames_per_proc=5, hw=40, seed=4)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    monkeypatch.setenv("E3D_RESULTS_DIR", str(tmp_path / "results"))
    overrides = [f"dataset.data_dir={root}",
                 f"dataset.train_list={root}/train.txt",
                 f"dataset.val_list={root}/val.txt",
                 f"dataset.test_list={root}/test.txt",
                 "dataset.batch_size=2", "dataset.num_workers=2",
                 "dataset.size=28", "trainer.max_epochs=1",
                 "trainer.log_every_n_steps=1", "--device", "cpu"]
    out = train_pose.main(overrides + ["++trainer.max_steps=2"])
    with open(tmp_path / "results" / "pose_results.json",
              encoding="utf-8") as f:
        written = json.load(f)
    assert sorted(written["procedure_metrics"]) == [
        "SyntheticColon_I/S2", "SyntheticColon_I/S3"]
    values = [v for m in written["procedure_metrics"].values()
              for v in m.values()] + list(written["overall_metrics"].values())
    assert len(values) == 9 and all(math.isfinite(v) for v in values)
    assert os.path.exists(os.path.join(out["run_dir"], ".hydra",
                                       "config.yaml"))
    saved = torch.load(os.path.join(out["ckpt_dir"], "2", "state.pt"),
                       weights_only=True)
    assert saved["step"] == 2
    assert int(saved["model"]["backbone.bn1.num_batches_tracked"]) == 2
    assert not torch.equal(saved["model"]["backbone.bn1.running_var"],
                           torch.ones(64))
    out = train_pose.main(overrides + ["++trainer.max_steps=3",
                                       "++trainer.resume=true"])
    assert os.path.exists(os.path.join(out["ckpt_dir"], "3", "state.pt")) \
        or os.path.exists(os.path.join(out["ckpt_dir"], "latest", "3",
                                       "state.pt"))


def test_train_pose_refuses_the_parallel_knobs(tmp_path, monkeypatch):
    """The parallel knobs are no longer refused: ``mesh_model=2`` in one
    process raises the JAX package's mesh message for one device, before
    anything is written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("E3D_CONFIG_ROOT", CONFIG_ROOT)
    with pytest.raises(ValueError) as want:
        meshlib.build_mesh(meshlib.MeshSpec(model=2),
                           devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        train_pose.main(["++trainer.mesh_model=2", "--device", "cpu"])
    assert str(got.value) == str(want.value) == "mesh 0x2 != 1 devices"
    assert not (tmp_path / "configs").exists()
