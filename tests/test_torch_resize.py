"""Port's resizes against the JAX package's, NHWC, f32 and bf16, up and
down.

Tolerances: f32 is the algorithm check (both sides run full-f32 matmuls
over the same numpy-built matrices): 1e-5 on values in [0, 1]. bf16 runs
bf16 operands with f32 accumulation and rounds to bf16 between the two
passes on both sides, but sums in another order, so a value may land one
bf16 ulp apart (3.9e-3 in [0.5, 1)): 8e-3. Nearest is a gather: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import resize as jresize
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tresize

TOL = {"float32": 1e-5, "bfloat16": 8e-3}
SHAPES = {"down": ((2, 47, 61, 3), (28, 42)), "up": ((2, 13, 9, 5), (30, 25))}


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,method", [
    ("resize_antialias", "bicubic"), ("resize_antialias", "bilinear"),
    ("resize_align_corners", "bilinear")])
def test_resize_matches_jax(name, method, dtype, direction):
    shape, out_hw = SHAPES[direction]
    x = _image(shape)
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(getattr(jresize, name)(
            jnp.asarray(x, getattr(jnp, dtype)), out_hw, method=method),
            np.float32)
    got = getattr(tresize, name)(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 out_hw, method=method)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (shape[0], *out_hw, shape[3])
    np.testing.assert_allclose(got.float().numpy(), expected,
                               atol=TOL[dtype])


@pytest.mark.parametrize("direction", ["down", "up"])
def test_resize_nearest_matches_jax(direction):
    shape, out_hw = SHAPES[direction]
    x = _image(shape)
    expected = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw))
    got = tresize.resize_nearest(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, expected)
    # HW and HWC inputs take the same gather.
    np.testing.assert_array_equal(
        tresize.resize_nearest(torch.from_numpy(x[0, ..., 0]), out_hw)
        .numpy(), expected[0, ..., 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channels_first_matches_channels_last(dtype):
    """The decoder resizes NCHW tensors; same numbers as the NHWC form."""
    x = torch.from_numpy(_image((2, 11, 17, 4))).to(dtype)
    nhwc = tresize.resize_align_corners(x, (22, 34))
    nchw = tresize.resize_align_corners(x.permute(0, 3, 1, 2), (22, 34),
                                        channels_last=False)
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), nhwc, rtol=0,
                               atol=0)


def test_hw_and_hwc_inputs():
    x = _image((19, 23, 3))
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(jresize.resize_antialias(jnp.asarray(x),
                                                       (10, 12)))
        expected_hw = np.asarray(jresize.resize_antialias(
            jnp.asarray(x[..., 0]), (10, 12)))
    got = tresize.resize_antialias(torch.from_numpy(x), (10, 12)).numpy()
    got_hw = tresize.resize_antialias(torch.from_numpy(x[..., 0]),
                                      (10, 12)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5)
    np.testing.assert_allclose(got_hw, expected_hw, atol=1e-5)
