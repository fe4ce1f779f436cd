"""Kernel K6's plain version (``lerp_resize_reference``, NCHW) against the
JAX package's Pallas lerp resize (``_lerp_resize_pallas``, NHWC) in
interpret mode, and the port's dispatch of ``resize_align_corners``.

Both blend in f32 with the same f32 weights (from f64 coordinates) and
round the H pass to the input dtype before the W pass. XLA's CPU compiler
contracts the JAX blend ``a w0 + b w1`` into a fused multiply-add for
part of the elements (about a fifth of them in f32, measured), which
skips one f32 rounding; the plain version, like K6, rounds both products.
A blend is a convex combination of the inputs, so every element is held
to one ulp of the dtype at the inputs' scale (max |x|). In bf16 the
skipped rounding flips the final rounding of 0.1-0.2% of the elements, so
at least 99% must agree bit for bit: a missing rounding of the H pass
would move far more. Shapes are small: the interpreter unrolls per output
row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import resize as jrs
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as trs

MANTISSA = {"bfloat16": 7, "float32": 23}


def _agrees(got: np.ndarray, want: np.ndarray, x: np.ndarray,
            dtype: str) -> bool:
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    exact = (diff == 0).mean() >= (0.99 if dtype == "bfloat16" else 0.0)
    return bool((diff <= np.abs(x).max() * 2.0 ** -MANTISSA[dtype]).all()
                and exact)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,out_hw", [
    ((1, 19, 19, 128), (37, 37)),   # the decoder's first upsample
    ((1, 12, 20, 128), (12, 41)),   # H unchanged: the W pass only
    ((1, 21, 17, 128), (10, 17)),   # a downsample, W unchanged
    ((2, 5, 6, 128), (9, 4)),       # up along H, down along W
])
def test_plain_version_matches_jax_kernel(shape, out_hw, dtype):
    rng = np.random.default_rng(sum(shape) + sum(out_hw))
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jrs._lerp_resize_pallas(
        jnp.asarray(x, getattr(jnp, dtype)), out_hw, interpret=True)
        .astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = trs.lerp_resize_reference(xt, out_hw)
    assert got.dtype == xt.dtype and got.shape == (shape[0], shape[3],
                                                   *out_hw)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert _agrees(got, want, x, dtype)
    # The CPU wrapper of K6 is its plain version.
    torch.testing.assert_close(trs.lerp_resize(xt.contiguous(), out_hw)
                               .permute(0, 2, 3, 1).float(),
                               torch.from_numpy(got), rtol=0, atol=0)


def test_taps_are_the_jax_taps():
    for n_in, n_out in ((19, 37), (296, 518), (7, 3), (1, 5), (5, 1)):
        lo, w0, w1 = trs._lerp_taps(n_in, n_out)
        jlo, jfrac = jrs._lerp_taps_static(n_in, n_out)
        assert lo.tolist() == list(jlo)
        np.testing.assert_array_equal(w1, np.float32(jfrac))
        np.testing.assert_array_equal(
            w0, (1.0 - np.asarray(jfrac)).astype(np.float32))


@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = trs.lerp_resize

    def fake(x, out_hw):
        calls.append(tuple(x.shape))
        return real(x, out_hw)

    monkeypatch.setattr(trs, "lerp_resize", fake)
    return calls


@pytest.mark.parametrize("knob", [True, False])
def test_dispatch_conditions(knob, spy, monkeypatch):
    """K6 under the knob on the JAX package's conditions (bilinear, 4-D,
    channels % 128 == 0, both input sides >= 2); else the matmul resize."""
    monkeypatch.setattr(trs, "_PALLAS_RESIZE", knob)
    g = torch.Generator().manual_seed(0)
    nchw = torch.randn((1, 128, 6, 7), generator=g).bfloat16()
    out = trs.resize_align_corners(nchw, (11, 13), channels_last=False)
    nhwc = trs.resize_align_corners(nchw.permute(0, 2, 3, 1), (11, 13))
    taken = [(1, 128, 6, 7)] * 2 if knob else []
    assert spy == taken
    if knob:
        want = trs.lerp_resize_reference(nchw, (11, 13))
        assert torch.equal(out, want)
        assert torch.equal(nhwc.permute(0, 3, 1, 2), want)
    spy.clear()
    for x, kw in ((nchw[:, :64], {"channels_last": False}),   # channels
                  (nchw[0], {"channels_last": False}),        # 3-D
                  (nchw[:, :, :1], {"channels_last": False}),  # H of 1
                  (nchw, {"channels_last": False, "method": "bicubic"})):
        got = trs.resize_align_corners(x, (5, 9), **kw)
        want = trs._apply_separable(x, trs._align_corners_matrix, (5, 9),
                                    kw.get("method", "bilinear"), False)
        assert torch.equal(got, want)
    assert spy == []


def test_no_backward_and_no_plain_version_off_the_cpu():
    x = torch.zeros((1, 128, 4, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        trs.lerp_resize(x, (7, 7))
    with torch.no_grad():
        assert trs.lerp_resize(x, (7, 7)).shape == (1, 128, 7, 7)
    meta = torch.empty((1, 128, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trs.lerp_resize(meta, (7, 7))
