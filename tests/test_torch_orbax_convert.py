"""``orbax_to_torch.py``: the JAX package's ``CheckpointManager`` output
(a vitt ``DepthTrainState`` and a pose state) into torch state dicts that
the port loads.

The JAX package saves three steps of each (max_to_keep 2: steps 1 and 2 in
the best-k store, step 3 in ``latest/``), each with its own weights; the
converter's ``best``, ``latest`` and a given step each pick their save.
The converted weights are ``from_jax_params`` / ``from_jax_pose_variables``
of the saved ones bit for bit (``tests/test_torch_convert.py``'s rule), and
the port's models loaded from the files (``load_or_init_depth_model``, the
pose net) give the JAX forward's outputs at f32 within 5e-4 (depth, metres;
``tests/test_torch_depth_anything.py``) and 1e-4 (the pose vector).
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from e3d_tpu.models.convert import convert_dav2, convert_pose_net
from e3d_tpu.models.depth_anything import build_depth_model as jax_build
from e3d_tpu.models.resnet_pose import PoseEstimationNet as JaxPoseNet
from e3d_tpu.train.depth_task import DepthTrainState as JaxDepthTrainState
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import (
    from_jax_params, from_jax_pose_variables, load_or_init_depth_model)
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.depth_anything import build_depth_model
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.resnet_pose import build_pose_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 56
# step: (val_loss, weight scale)
SAVES = {1: (2.0, 1.0), 2: (1.0, 1.1), 3: (3.0, 1.2)}


def _scaled(tree, scale):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) * scale, tree)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both managers' directories, with each step's params."""
    root = tmp_path_factory.mktemp("orbax")
    depth0 = convert_dav2({k: v.numpy() for k, v in build_depth_model(
        "vitt", dtype=torch.float32, device="cpu", seed=3).state_dict()
        .items()}, "vitt")
    pose0 = convert_pose_net({
        k: v.numpy() for k, v in build_pose_model(device="cpu", seed=4)
        .state_dict().items() if not k.endswith("num_batches_tracked")})
    opt = optax.adamw(1e-4)
    out = {"depth": str(root / "depth"), "pose": str(root / "pose"),
           "depth_params": {}, "pose_vars": {}}
    dmgr = JaxCheckpointManager(out["depth"], max_to_keep=2)
    pmgr = JaxCheckpointManager(out["pose"], max_to_keep=2)
    for step, (val, scale) in SAVES.items():
        params = _scaled(depth0, scale)
        out["depth_params"][step] = params
        dmgr.save(step, JaxDepthTrainState(
            params, opt.init(params), jnp.asarray(step, jnp.int32)),
            {"val_loss": val})
        variables = {"params": _scaled(pose0["params"], scale),
                     "batch_stats": _scaled(pose0["batch_stats"], scale)}
        out["pose_vars"][step] = variables
        pmgr.save(step, {**variables,
                         "opt_state": opt.init(variables["params"]),
                         "step": np.asarray(step, np.int32)},
                  {"val_loss": val})
    dmgr.close()
    pmgr.close()
    return out


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _convert(kind, src, dst, select):
    """The tool's ``main`` in this process (its command line runs in
    ``test_the_command_line_names_a_missing_step``)."""
    return _tool().main(["--kind", kind, "-i", src, "-o", dst, "--select",
                         select])


@functools.lru_cache(maxsize=None)
def _jax_forward(kind):
    if kind == "depth":
        return jax.jit(jax_build("vitt", max_depth=20.0,
                                 dtype=jnp.float32).apply)
    return jax.jit(functools.partial(JaxPoseNet().apply, train=False))


@pytest.mark.parametrize("select,step", [("best", 2), ("latest", 3),
                                         ("1", 1)])
def test_depth_checkpoint_converts_and_loads(saved, select, step, tmp_path):
    dst = str(tmp_path / "depth.pth")
    assert _convert("depth", saved["depth"], dst, select)["step"] == step
    params = saved["depth_params"][step]
    want = from_jax_params(params)
    got = torch.load(dst, weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model = load_or_init_depth_model("vitt", 20.0, dst, device="cpu",
                                     dtype=torch.float32)
    img = np.random.default_rng(step).normal(size=(2, HW, HW, 3)).astype(
        np.float32)
    with torch.no_grad():
        depth = model(torch.from_numpy(img)).numpy()
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(_jax_forward("depth")({"params": params},
                                                    jnp.asarray(img)))
    np.testing.assert_allclose(depth, expected, atol=5e-4)


@pytest.mark.parametrize("select,step", [("best", 2), ("latest", 3),
                                         ("1", 1)])
def test_pose_checkpoint_converts_and_loads(saved, select, step, tmp_path):
    dst = str(tmp_path / "pose.pth")
    assert _convert("pose", saved["pose"], dst, select)["step"] == step
    variables = saved["pose_vars"][step]
    got = torch.load(dst, weights_only=True)
    want = from_jax_pose_variables(variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    net = build_pose_model(device="cpu")
    net.load_state_dict(got)
    x = np.random.default_rng(step).normal(size=(2, 64, 64, 8)).astype(
        np.float32)
    with torch.no_grad():
        pose = net.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(_jax_forward("pose")(variables,
                                                   jnp.asarray(x)))
    np.testing.assert_allclose(pose, expected, atol=1e-4)


def test_the_command_line_names_a_missing_step(saved, tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "orbax_to_torch.py"), "-i",
         saved["depth"], "-o", str(tmp_path / "x.pth"), "--select", "7"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0 and "no step 7" in out.stderr
