"""Port's DinoViT taps against the JAX package's, vitt, on the native pos
grid, a square and a non-square interpolated grid.

Oracles: JAX f32 at ``default_matmul_precision("highest")`` on its XLA
attention path, and JAX under ``set_force_fused(True)``, where the
pad-once stream and the Pallas flash kernel (interpret mode) run. The
port never pads; both must agree on the valid tokens.

Tolerances: f32 checks the algorithm, 1e-4 on LayerNorm-ed taps of unit
scale (XLA and torch sum in other orders through four blocks). bf16
rounds every activation to 8 bits of mantissa, in places that differ
between flax and torch (LayerNorm affine in f32 vs bf16, bias added after
vs inside the matmul); four blocks of that on unit-scale taps: 0.15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.models.dinov2 import DinoViT as JaxDinoViT
from e3d_tpu.ops import attention as jattn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import from_jax_params
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.dinov2 import DinoViT

HW = [(56, 56), (70, 70), (56, 84)]  # grids 4x4 (native), 5x5, 4x6


def _pair(dtype: str):
    jmodel = JaxDinoViT("vitt", dtype=getattr(jnp, dtype))
    params = jmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 56, 56, 3), np.float32))["params"]
    sd = from_jax_params({"pretrained": jax.tree_util.tree_map(np.asarray,
                                                               params)})
    tmodel = DinoViT("vitt", getattr(torch, dtype))
    tmodel.load_state_dict({k[len("pretrained."):]: v for k, v in sd.items()},
                           strict=True)
    return jmodel, params, tmodel


def _compare(jtaps, ttaps, tol):
    assert len(jtaps) == len(ttaps) == 4
    for (jp, jc), (tp, tc) in zip(jtaps, ttaps):
        assert tuple(tp.shape) == jp.shape and tuple(tc.shape) == jc.shape
        np.testing.assert_allclose(tp.float().numpy(),
                                   np.asarray(jp, np.float32), atol=tol)
        np.testing.assert_allclose(tc.float().numpy(),
                                   np.asarray(jc, np.float32), atol=tol)


@pytest.mark.parametrize("hw", HW)
def test_taps_match_jax_f32(hw):
    jmodel, params, tmodel = _pair("float32")
    img = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jtaps = jmodel.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        ttaps = tmodel(torch.from_numpy(img))
    _compare(jtaps, ttaps, 1e-4)


@pytest.mark.parametrize("hw", [(56, 56), (56, 84)])
def test_taps_match_jax_fused_pallas_path(hw):
    jmodel, params, tmodel = _pair("float32")
    img = np.random.default_rng(2).normal(size=(2, *hw, 3)).astype(np.float32)
    jattn.set_force_fused(True)
    try:
        with jax.default_matmul_precision("highest"):
            jtaps = jmodel.apply({"params": params}, jnp.asarray(img))
    finally:
        jattn.set_force_fused(False)
    with torch.no_grad():
        ttaps = tmodel(torch.from_numpy(img))
    _compare(jtaps, ttaps, 1e-4)


def test_taps_match_jax_bf16():
    jmodel, params, tmodel = _pair("bfloat16")
    img = np.random.default_rng(3).normal(size=(2, 56, 84, 3)).astype(
        np.float32)
    jtaps = jmodel.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        ttaps = tmodel(torch.from_numpy(img))
    assert ttaps[0][0].dtype == torch.bfloat16
    _compare(jtaps, ttaps, 0.15)
