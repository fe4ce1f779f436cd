"""The port's pipeline (``parallel/pipeline.py``) on gloo CPU ranks against
the JAX package's and the plain forward, and TP+FSDP on four ranks.

Two ranks run mesh (1, 2), four ranks mesh (2, 2) (one launch each), both
while this process computes the references. vitt has 4 blocks, so the
schedules are GPipe (2 stages of 2 blocks) and interleaved (``virtual=2``:
4 chunks of one block, two laps of the ring), both with 2 microbatches.

Tolerances (fixed before the runs): the taps within 1e-5 of max|tap| of
the JAX function's at the same mesh shape; the pipelined gradient within
1e-4 of the plain one in relative norm; one pipelined ``DepthTask`` step
(gradient checkpointing on) against the port's one-rank step (loss rtol
1e-5, parameters within 2 lr with at most 1% of elements beyond 1e-6 lr)
and against the JAX package's pipelined step (loss rtol 2e-4, parameters
within 2 lr); the eval fallback within 1e-6 of the plain eval; TP+FSDP
at (2, 2) against one rank by the same step rule, and its checkpoint
restored under TP+FSDP and in one rank equal to what was saved.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.core.dtypes import POLICY_F32 as J_F32
from e3d_tpu.models.convert import convert_dav2
from e3d_tpu.models.dinov2 import Block as JaxBlock
from e3d_tpu.parallel import mesh as jmesh
from e3d_tpu.parallel.pipeline import pipeline_vit_taps as jax_taps
from e3d_tpu.parallel.pipeline import stack_block_params as jax_stack
from e3d_tpu.train import DepthTask as JaxDepthTask
from e3d_tpu.train.depth_task import DepthTrainState as JaxDepthTrainState
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.checkpoint import CheckpointManager
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.dtypes import POLICY_F32
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import from_jax_params
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.parallel.pipeline import (
    stack_block_params, unstack_block_params)
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask
from tests._torch_dist_worker import (HW, TASK_ARGS, depth_batches,
                                      one_thread, start)
from tests.test_torch_parallel import _lrs, params_close

TOKENS = 1 + (HW // 14) ** 2


def _inputs(params0, world, ckpt_dir=None):
    rng = np.random.default_rng(5)
    return {"params0": params0,
            "tokens": rng.normal(size=(4, TOKENS, 64)).astype(np.float32),
            "images": rng.normal(size=(4, HW, HW, 3)).astype(np.float32),
            "weights": rng.normal(size=(4, HW, HW)).astype(np.float32),
            "n_micro": 2, "virtual": 1 if world == 2 else 2,
            "ckpt_dir": ckpt_dir}


def _one_rank_step(params0, steps=1):
    task = DepthTask(policy=POLICY_F32, grad_checkpoint=False, device="cpu",
                     **TASK_ARGS)
    state = task.init_state(0, pretrained_params=params0)
    images, depths = depth_batches(steps=steps)
    losses, states = [], []
    for s in range(steps):
        state, m = task.train_step(state, {
            "image": torch.from_numpy(images[s]),
            "depth": torch.from_numpy(depths[s])})
        losses.append(float(m["loss"]))
        states.append({k: v.clone() for k, v in
                       state.model.state_dict().items()})
    return task, state, losses, states


def _plain_grads(params0, inputs):
    model = build_depth_model("vitt", dtype=torch.float32, device="cpu")
    model.load_state_dict(params0)
    depth = model(torch.from_numpy(inputs["images"]))
    (depth * torch.from_numpy(inputs["weights"])).sum().backward()
    return {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def _jax_taps(jparams, tokens, data, virtual):
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data, 2),
                            devices=jax.devices()[:2 * data])
    block = JaxBlock(64, 2, jnp.float32)
    return np.asarray(jax_taps(
        lambda p, h: block.apply({"params": p}, h),
        jax_stack(jparams["pretrained"], 4), jnp.asarray(tokens),
        [0, 1, 2, 3], mesh, 2, 2, virtual))


def _jax_pipeline_step(jparams):
    """One JAX ``DepthTask`` step with the trunk pipelined over mesh
    (1, 2), from ``jparams``."""
    mesh = jmesh.build_mesh(jmesh.MeshSpec(1, 2), devices=jax.devices()[:2])
    jtask = JaxDepthTask(policy=J_F32, grad_checkpoint=False,
                         device_mesh=mesh, pipeline_parallel=2,
                         pipe_microbatches=2, **TASK_ARGS)
    images, depths = depth_batches(steps=1)
    with jax.default_matmul_precision("highest"):
        jtask._optimizer = jtask._opt_factory(jparams)
        jstate = JaxDepthTrainState(jparams, jtask._optimizer.init(jparams),
                                    jnp.zeros((), jnp.int32))
        jstate = jax.device_put(jstate, jtask.state_shardings(jstate))
        jstate, jm = jtask.train_step(
            jstate, {"image": jnp.asarray(images[0]),
                     "depth": jnp.asarray(depths[0])})
    return float(jm["loss"]), from_jax_params(
        jax.tree.map(np.array, jstate.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with one_thread():
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    task = DepthTask(policy=POLICY_F32, device="cpu", **TASK_ARGS)
    params0 = {k: v.clone() for k, v in
               task.init_state(0).model.state_dict().items()}
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    inputs = {w: _inputs(params0, w, ckpt_dir) for w in (2, 4)}
    launches = {w: start("pipeline", w,
                         str(tmp_path_factory.mktemp(f"pipe{w}")),
                         inputs[w]) for w in (2, 4)}
    jparams = jax.tree.map(jnp.asarray, convert_dav2(
        {k: v.numpy() for k, v in params0.items()}, "vitt"))
    # The JAX programs compile in threads of their own (XLA's compiler
    # releases the GIL), beside the port's references.
    with ThreadPoolExecutor(5) as pool:
        taps = {(d, v): pool.submit(_jax_taps, jparams, inputs[2]["tokens"],
                                    d, v) for d in (1, 2) for v in (1, 2)}
        step = pool.submit(_jax_pipeline_step, jparams)
        out = {"params0": params0, "inputs": inputs, "ckpt_dir": ckpt_dir,
               "one": _one_rank_step(params0),
               "one2": _one_rank_step(params0, steps=2),
               "plain_grads": _plain_grads(params0, inputs[2]),
               "jax_taps": {k: f.result() for k, f in taps.items()},
               "jax_step": step.result()}
    out["ranks"] = {w: launches[w]() for w in (2, 4)}
    return out


def test_stack_unstack_round_trip():
    model = build_depth_model("vitt", dtype=torch.float32, device="cpu")
    sd = model.pretrained.state_dict()
    stacked = stack_block_params(sd, 4)
    assert stacked["attn.qkv.weight"].shape == (4, 192, 64)
    back = unstack_block_params(stacked, 4)
    blocks = {k: v for k, v in sd.items() if k.startswith("blocks.")}
    assert set(back) == set(blocks)
    for k, v in blocks.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("virtual", [1, 2])
def test_taps_match_the_jax_pipeline(runs, world, virtual):
    """Every rank's taps (its data shard's rows) against the JAX
    function's at the same mesh shape."""
    data = world // 2
    want = runs["jax_taps"][(data, virtual)]
    b = want.shape[1] // data
    scale = np.abs(want).max()
    for rank, got in enumerate(runs["ranks"][world]):
        d = rank // 2
        np.testing.assert_allclose(
            got[f"taps_v{virtual}"].numpy(), want[:, d * b:(d + 1) * b],
            rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("virtual", [1, 2])
def test_pipelined_gradient_matches_the_plain_forward(runs, world, virtual):
    want = runs["plain_grads"]
    got = runs["ranks"][world][0][f"grads_v{virtual}"]
    err = torch.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in want.items()))
    norm = torch.sqrt(sum((w ** 2).sum() for w in want.values()))
    assert norm > 0 and err <= 1e-4 * norm, (err.item(), norm.item())


@pytest.mark.parametrize("world", [2, 4])
def test_pipelined_step_matches_one_rank(runs, world):
    """GPipe at (1, 2), interleaved at (2, 2)."""
    task, _, losses, states = runs["one"]
    ranks = runs["ranks"][world]
    assert len({r["step_loss"] for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["step_loss"], losses[0], rtol=1e-5)
    params_close(ranks[0]["step_state"], states[0], *_lrs(task, 1))


def test_pipelined_step_matches_the_jax_pipelined_step(runs):
    loss, want = runs["jax_step"]
    got = runs["ranks"][2][0]
    np.testing.assert_allclose(got["step_loss"], loss, rtol=2e-4)
    lr_sum, _ = _lrs(runs["one"][0], 1)
    for key, value in want.items():
        diff = (got["step_state"][key] - value).abs()
        assert diff.max().item() <= 2.0 * lr_sum * 1.01 + 1e-7, key


@pytest.mark.parametrize("world", [2, 4])
def test_train_guard_and_eval_fallback(runs, world):
    """A training microbatch the pipeline cannot split raises the JAX
    package's message; such an eval batch runs the plain forward."""
    data = world // 2
    for r in runs["ranks"][world]:
        assert r["train_guard"] == (
            f"pipeline_parallel=2: train microbatch 3 must divide data axis "
            f"{data} x pipe_microbatches 2")
    got = runs["ranks"][world][0]
    task = DepthTask(policy=POLICY_F32, grad_checkpoint=False, device="cpu",
                     **TASK_ARGS)
    model = build_depth_model("vitt", dtype=torch.float32, device="cpu")
    model.load_state_dict(got["eval_model"])
    images, depths = depth_batches(steps=1)
    want = task.eval_step(model, {"image": torch.from_numpy(images[0, 0, :3]),
                                  "depth": torch.from_numpy(depths[0, 0, :3])})
    for k, v in want.items():
        np.testing.assert_allclose(got["eval_fallback"][k], float(v),
                                   rtol=1e-6, err_msg=k)


def test_tp_fsdp_on_four_ranks_and_its_checkpoint_in_one_rank(runs):
    """TP+FSDP at mesh (2, 2) equals the one-rank steps, and the
    checkpoint it saves (whole tensors) restores into a one-rank run,
    optimizer moments included, which then steps on."""
    task, _, losses, states = runs["one2"]
    ranks = runs["ranks"][4]
    got = ranks[0]["tpfsdp"]
    assert all(r["tpfsdp"]["losses"] == got["losses"] for r in ranks)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for s in range(2):
        params_close(got["states"][s]["model"], states[s],
                     *_lrs(task, s + 1))

    # Restored under TP+FSDP (the moments back into shards), the state
    # gathers to what was saved.
    saved = got["states"][-1]
    for r in ranks:
        resumed = r["tpfsdp_resumed"]
        assert resumed["step"] == 2
        for key, value in saved["model"].items():
            assert torch.equal(resumed["model"][key], value), key
        for i, moments in saved["optimizer"]["state"].items():
            for k, v in moments.items():
                assert torch.equal(resumed["optimizer"]["state"][i][k],
                                   v), (i, k)

    fresh = DepthTask(policy=POLICY_F32, grad_checkpoint=True,
                      device="cpu", **TASK_ARGS)
    state = fresh.init_state(5)
    assert CheckpointManager(runs["ckpt_dir"]).restore_latest(state)
    assert state.step == 2
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, got["states"][-1]["model"][key]), key
    moments = state.optimizer.optimizer.state
    assert len(moments) == len(list(state.model.parameters()))
    for p in state.model.parameters():
        assert moments[p]["exp_avg"].shape == p.shape
    images, depths = depth_batches(steps=1, seed=3)
    state, m = fresh.train_step(state, {"image": torch.from_numpy(images[0]),
                                        "depth": torch.from_numpy(depths[0])})
    assert np.isfinite(m["loss"].item()) and state.step == 3
