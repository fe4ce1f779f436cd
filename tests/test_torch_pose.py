"""The port's pose pieces against the JAX package's on the CPU: the
quaternion ops (and scipy), ``compose_poses``, ``pose_loss``, the pose
metrics, ``PoseEstimationNet`` (eval and train forward, running statistics
included) through ``from_jax_pose_variables``, and the reference-named
torch golden of ``tests/test_pose_net_parity.py`` loading directly.

Tolerances, f32 on both sides (JAX at ``highest``): 1e-6 on one quaternion
op of unit-scale inputs; 1e-3 degrees on angles (arccos amplifies f32
rounding near |dot| = 1); ``compose_poses`` over 512 steps, whose
positions reach tens of units and whose scans sum in other orders
(Hillis-Steele here, ``associative_scan`` there): 1e-4 relative and 2e-3
absolute, against JAX and against a float64 frame-by-frame loop; losses
and metrics 1e-5 relative; the pose net's outputs 1e-4 absolute (outputs
of unit scale through 18 convolutions) and its running statistics 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import e3d_tpu  # noqa: F401
from e3d_tpu.evaluation import pose_metrics as jmetrics
from e3d_tpu.losses.pose_loss import pose_loss as jax_pose_loss
from e3d_tpu.models.convert import convert_pose_net
from e3d_tpu.models.resnet_pose import PoseEstimationNet as JaxPoseNet
from e3d_tpu.ops import quaternion as jquat
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.evaluation import pose_metrics as tmetrics
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.losses.pose_loss import pose_loss
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import resnet_pose
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import from_jax_pose_variables
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quaternion as tquat
from tests.test_pose_net_parity import build_torch_model


def _quats(rng, n, unit=True):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True) if unit else q


def _both(fn_name, *args):
    """``fn_name`` of the port (torch) and of the JAX package on the same
    float32 arrays, as numpy."""
    got = getattr(tquat, fn_name)(*(torch.from_numpy(a) for a in args))
    want = getattr(jquat, fn_name)(*(jnp.asarray(a) for a in args))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("fn", ["normalize", "conjugate", "multiply",
                                "rotate_vector", "to_rotation_matrix",
                                "geodesic_angle_deg", "relative_pose"])
def test_quaternion_ops_match_jax_and_scipy(fn):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 32), _quats(rng, 32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    p1, p2 = (rng.normal(size=(32, 3)).astype(np.float32) for _ in range(2))
    args = {"normalize": (_quats(rng, 32, unit=False),), "conjugate": (q1,),
            "multiply": (q1, q2), "rotate_vector": (q1, v),
            "to_rotation_matrix": (_quats(rng, 32, unit=False),),
            "geodesic_angle_deg": (q1, q2),
            "relative_pose": (p1, q1, p2, q2)}[fn]
    got, want = _both(fn, *args)
    tol = 1e-3 if fn == "geodesic_angle_deg" else 1e-6
    np.testing.assert_allclose(got, want, atol=tol)
    scipy_value = {
        "multiply": lambda: (Rotation.from_quat(q1)
                             * Rotation.from_quat(q2)).as_quat(),
        "rotate_vector": lambda: Rotation.from_quat(q1).apply(v),
        "to_rotation_matrix": lambda: Rotation.from_quat(
            args[0]).as_matrix(),
        "geodesic_angle_deg": lambda: np.degrees((
            Rotation.from_quat(q1).inv() * Rotation.from_quat(q2)
        ).magnitude()),
    }.get(fn)
    if scipy_value is not None:
        expected = scipy_value()
        if fn == "multiply":  # the double cover: compare up to sign
            got = got * np.sign(np.sum(got * expected, axis=1,
                                       keepdims=True))
        np.testing.assert_allclose(got, expected, atol=tol)


def test_sanitize_matches_jax():
    q = _quats(np.random.default_rng(1), 6, unit=False)
    q[[1, 4]] = 0.0
    q[2] = 1e-9
    got, want = _both("sanitize", q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[1, 2, 4]], [[0, 0, 0, 1]] * 3)


def _compose_loop(rel, init):
    """Frame by frame in float64 with scipy: q <- q q_rel (zero
    quaternions as the identity), t <- t + R(q) t_rel."""
    t, q = init[:3].astype(np.float64), init[3:].astype(np.float64)
    out = [np.concatenate([t, q / np.linalg.norm(q)])]
    for row in rel.astype(np.float64):
        qr = row[3:] if np.linalg.norm(row[3:]) >= 1e-8 else \
            np.array([0.0, 0.0, 0.0, 1.0])
        rot = Rotation.from_quat(q)
        t = t + rot.apply(row[:3])
        q = (rot * Rotation.from_quat(qr)).as_quat()
        out.append(np.concatenate([t, q]))
    return np.stack(out)


def test_compose_poses_over_512_steps_matches_jax_and_a_loop():
    rng = np.random.default_rng(2)
    rel = np.concatenate([rng.normal(size=(512, 3)),
                          rng.normal(size=(512, 4)) * 0.2
                          + [0.0, 0.0, 0.0, 1.0]], axis=1).astype(np.float32)
    rel[rng.choice(512, 16, replace=False), 3:] = 0.0  # zero quaternions
    init = np.array([0.5, -1.0, 2.0, 0.1, 0.2, 0.3, 0.9], np.float32)
    got = tquat.compose_poses(torch.from_numpy(rel),
                              torch.from_numpy(init)).numpy()
    want = np.asarray(jax.jit(jquat.compose_poses)(jnp.asarray(rel),
                                                   jnp.asarray(init)))
    assert got.shape == (513, 7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    loop = _compose_loop(rel, init)
    sign = np.sign(np.sum(got[:, 3:] * loop[:, 3:], axis=1, keepdims=True))
    np.testing.assert_allclose(got[:, :3], loop[:, :3], rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(got[:, 3:] * sign, loop[:, 3:], atol=2e-3)
    # Without an initial pose the chain starts at the identity.
    got0 = tquat.compose_poses(torch.from_numpy(rel[:5])).numpy()
    np.testing.assert_allclose(got0[0], [0, 0, 0, 0, 0, 0, 1])
    np.testing.assert_allclose(
        got0, _compose_loop(rel[:5], np.array([0, 0, 0, 0, 0, 0, 1.0])),
        atol=1e-5)


def _poses(rng, n):
    return np.concatenate([rng.normal(size=(n, 3)),
                           rng.normal(size=(n, 4))], axis=1).astype(
        np.float32)


def test_pose_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred, gt = _poses(rng, 16), _poses(rng, 16)
    pred[:4, 3:] = -gt[:4, 3:]  # the double cover: no rotation loss
    for beta in (1.0, 0.5):
        got = pose_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                        beta=beta)
        want = jax_pose_loss(jnp.asarray(pred), jnp.asarray(gt), beta=beta)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("fn", ["compute_pose_errors", "evaluate_trajectory"])
def test_pose_metrics_match_jax(fn):
    rng = np.random.default_rng(4)
    pred, gt = _poses(rng, 24) * 0.3, _poses(rng, 24) * 0.3
    pred[5, 3:] = 0.0
    got = getattr(tmetrics, fn)(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jax.jit(getattr(jmetrics, fn))(jnp.asarray(pred), jnp.asarray(gt))
    assert sorted(got) == sorted(want) == ["ate", "rote", "rte"]
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    scale = tmetrics.calculate_scale_factor(torch.from_numpy(pred),
                                            torch.from_numpy(gt))
    np.testing.assert_allclose(scale.item(), float(
        jmetrics.calculate_scale_factor(jnp.asarray(pred), jnp.asarray(gt))),
        rtol=1e-6)


@pytest.fixture(scope="module")
def pose_net_case():
    """The port's seeded weights (running statistics perturbed) carried to
    the JAX package by its own ``convert_pose_net``, and the JAX net's
    eval output, train output and updated statistics on one input, from
    one compiled function."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 64, 64, 8)).astype(np.float32)
    base = resnet_pose.build_pose_model(dropout=False, device="cpu", seed=3)
    state = {k: v.numpy() for k, v in base.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            state[k] = state[k] + rng.uniform(0.0, 0.5, state[k].shape
                                              ).astype(np.float32)
    variables = convert_pose_net(state)
    jnet = JaxPoseNet(in_channels=8, dropout=False)

    def both(v, x):
        out_eval = jnet.apply(v, x, train=False)
        out_train, mutated = jnet.apply(v, x, train=True,
                                        mutable=["batch_stats"])
        return out_eval, out_train, mutated["batch_stats"]

    with jax.default_matmul_precision("highest"):
        outs = jax.jit(both)(variables, jnp.asarray(x))
    return state, variables, x, jax.tree_util.tree_map(np.asarray, outs)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pose_net_matches_jax(train, pose_net_case):
    """The JAX net's variables through ``from_jax_pose_variables`` (the
    inverse of the JAX package's ``convert_pose_net``, exactly): the same
    outputs, and in training the same updated running means and (biased)
    running variances."""
    state, variables, x, (out_eval, out_train, stats) = pose_net_case
    weights = from_jax_pose_variables(variables)
    for key, value in state.items():
        np.testing.assert_array_equal(weights[key].numpy(), value,
                                      err_msg=key)
    model = resnet_pose.build_pose_model(dropout=False, device="cpu")
    model.load_state_dict(weights, strict=True)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = out_train if train else out_eval
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if train:
        want_stats = from_jax_pose_variables({"params": {},
                                              "batch_stats": stats})
        got_stats = model.state_dict()
        for key, value in want_stats.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got_stats[key].numpy(),
                                           value.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=key)
        assert int(got_stats["backbone.bn1.num_batches_tracked"]) == 1


def test_reference_state_dict_loads_directly():
    """The torch golden (the reference's ``PoseEstimationNet`` names,
    ``num_batches_tracked`` included) loads with ``load_state_dict`` and
    gives the same poses. In training the running mean moves as torch's,
    and the running variance takes the biased batch variance where torch
    takes the unbiased one: n/(n-1) apart in the batch term."""
    torch.manual_seed(0)
    golden = build_torch_model(torch, torch.nn)
    with torch.no_grad():
        for m in golden.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    model = resnet_pose.build_pose_model(dropout=False, device="cpu")
    model.load_state_dict(golden.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 8, 48, 48)).astype(np.float32))
    golden.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), golden(x).numpy(),
                                   atol=1e-5)
    before = {k: v.clone() for k, v in golden.state_dict().items()}
    golden.train()
    model.train()
    for i in (1, 4, 7):  # the golden's dropout off, as the port's
        golden.pose_head[i].p = 0.0
    with torch.no_grad():
        golden(x)
        model(x)
    got, ref = model.state_dict(), golden.state_dict()
    key = "backbone.bn1"
    n = 2 * 24 * 24  # batch x the stem's 24x24 output
    np.testing.assert_allclose(got[f"{key}.running_mean"].numpy(),
                               ref[f"{key}.running_mean"].numpy(),
                               rtol=1e-5, atol=1e-6)
    kept = 0.9 * before[f"{key}.running_var"]
    np.testing.assert_allclose(
        (got[f"{key}.running_var"] - kept).numpy(),
        ((ref[f"{key}.running_var"] - kept) * (n - 1) / n).numpy(),
        rtol=1e-4, atol=1e-7)
    assert not torch.allclose(got[f"{key}.running_var"],
                              ref[f"{key}.running_var"], rtol=0, atol=1e-7)
