"""The port's int8 W8A8 (``ops/quant.py``: the plain versions of kernels
Q1 and Q2, the int8 products, static calibration) and its wiring through
the model, ``BatchedRunner`` and the serving engine, against the JAX
package's ``ops/quant.py`` on the CPU, on inputs made from a seed with
numpy.

Tolerances: quantized values, scales and int32 accumulators are exact
(bit-equal); the rescaled outputs lie within 1 ulp of their type, since
XLA on the CPU may contract the rescale and the bias into one fma. The
whole vitt model in f32 (the JAX side on its fused attention branch, the
Pallas kernel in interpret mode): the two sides' f32 activations differ
by summation order, and where such a difference crosses a rounding
boundary of the quantizer a value moves by one int8 step; measured, the
depth maps then move. Measured: 2e-5 m max on these seeded weights; with
the JAX package's own initialisation one such flip moved int8 + merging
by 2.9e-3 m max, 2.4e-4 m mean on a 20 m range. The bound is 1e-2 m max
and 1e-3 m mean, against dials that move the maps by 0.036 m (int8) and
0.86 m (merging) on average. Calibrated abs-maxes: 1e-5 relative.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.models import build_depth_model as jax_build
from e3d_tpu.models.convert import convert_dav2
from e3d_tpu.ops import attention as jattn
from e3d_tpu.ops import quant as jq
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant as tq
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.serving.engine import DepthServingEngine


def _normal(shape, seed, dtype="float32"):
    """Seeded normal values, exact in ``dtype`` (bf16 rounded once)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _t(x, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))


def _eq(t, j):
    np.testing.assert_array_equal(t.float().numpy() if t.is_floating_point()
                                  else t.numpy(), np.asarray(j))


def _ulp(t, j, maxulp=1):
    if t.dtype == torch.bfloat16:
        a = t.float().numpy()
        b = np.asarray(jnp.asarray(j, jnp.float32))
        # one bf16 step of the larger magnitude
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert np.all(np.abs(a - b) <= maxulp * step)
    else:
        np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j),
                                        maxulp=maxulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_axes_cols_match_jax(dtype):
    x = _normal((2, 9, 64), 0, dtype) * 3.0
    x[0, 3] = 0.0  # an all-zero row takes the 1e-8 floor
    q, s = tq.quantize_rows(_t(x, dtype))
    jq_, js = jq.quantize_rows(_j(x, dtype))
    _eq(q, jq_)
    _eq(s, js)
    assert tuple(s.shape) == js.shape == (2, 9, 1)
    # The proj site: one scale per (b, n) over (h, d), JAX's layout.
    o = _normal((2, 4, 9, 16), 1, dtype)
    q, s = tq.quantize_axes(_t(o, dtype), (1, 3))
    jq_, js = jq.quantize_axes(_j(o, dtype), (1, 3))
    _eq(q, jq_)
    _eq(s, js)
    w = _normal((64, 48), 2)
    q, s = tq.quantize_cols(_t(w))
    jq_, js = jq.quantize_cols(_j(w))
    _eq(q, jq_)
    _eq(s, js)


def test_q1_plain_frozen_scale_and_half_even_rounding():
    # x / scale lands on halves: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0
    scale = torch.tensor([1.0])
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 3.49]])
    q, s = tq.quantize_int8(x, scale)
    assert q.tolist() == [[0, 2, 2, 0, -2, 127, -127, 3]]
    assert s is scale
    # frozen: every row on the given scale, as JAX's static branch
    xr = _normal((5, 32), 3)
    amax = jnp.asarray([1.7], jnp.float32)
    with jq.frozen_scales(amax):
        jq_, js = jq.quantize_rows(_j(xr))
    with tq.frozen_scales(torch.tensor([1.7])):
        q, s = tq.quantize_rows(_t(xr))
    _eq(q, jq_)
    _eq(s, js)


@pytest.mark.parametrize("cast_first", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q2_plain_matches_jax_rescale(dtype, cast_first):
    rng = np.random.default_rng(4)
    acc = rng.integers(-2**20, 2**20, (12, 40), dtype=np.int32)
    xs = rng.uniform(1e-3, 1e-1, (12, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (40,)).astype(np.float32)
    bias = rng.normal(size=(40,)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    if cast_first:  # the fused attention branch: cast, then a bias of dtype
        want = (jnp.asarray(acc).astype(jnp.float32) * xs * ws).astype(jdt) \
            + jnp.asarray(bias).astype(jdt)
    else:  # int8_dense / int8_conv: bias in f32, one cast
        want = (jnp.asarray(acc).astype(jnp.float32) * xs * ws
                + jnp.asarray(bias)).astype(jdt)
    got = tq.dequantize_int32(torch.from_numpy(acc), torch.from_numpy(xs[:, 0]),
                              torch.from_numpy(ws), torch.from_numpy(bias),
                              getattr(torch, dtype), cast_first)
    assert got.dtype == getattr(torch, dtype) and got.shape == (12, 40)
    _ulp(got, want)
    # one scale for all rows (frozen), and one per group of rows (images)
    got = tq.dequantize_int32(torch.from_numpy(acc), torch.tensor([0.5]),
                              torch.from_numpy(ws), None, torch.float32)
    _ulp(got, jnp.asarray(acc).astype(jnp.float32) * 0.5 * ws)
    got = tq.dequantize_int32(torch.from_numpy(acc).view(3, 2, 2, 40),
                              torch.from_numpy(xs[:3, 0]),
                              torch.from_numpy(ws), None, torch.float32)
    want = (jnp.asarray(acc).reshape(3, 2, 2, 40).astype(jnp.float32)
            * xs[:3, 0][:, None, None, None] * ws)
    _ulp(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(dtype):
    x = _normal((2, 24, 64), 5, dtype)
    kernel = _normal((64, 96), 6) * 0.1
    bias = _normal((96,), 7)
    want = jq.int8_dense(_j(x, dtype), _j(kernel), _j(bias))
    got = tq.int8_dense(_t(x, dtype), _t(kernel.T), _t(bias))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 24, 96)
    # The int32 accumulators, from each side's own quantized operands.
    jxq, _ = jq.quantize_rows(_j(x, dtype))
    jwq, _ = jq.quantize_cols(_j(kernel))
    jacc = jax.lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    xq, _ = tq.quantize_int8(_t(x, dtype).reshape(-1, 64))
    wq, _ = tq.quantize_int8(_t(kernel.T))
    _eq(tq.int_mm(xq, wq.t()).view(2, 24, 96), jacc)
    _ulp(got, want)


@pytest.mark.parametrize("kh,stride,padding", [(3, 1, 1), (3, 2, 1),
                                               (1, 1, 0)])
def test_int8_conv_matches_jax(kh, stride, padding):
    x = _normal((2, 9, 11, 16), 8)          # NHWC, JAX's layout
    kernel = _normal((kh, kh, 16, 24), 9) * 0.2   # HWIO
    bias = _normal((24,), 10)
    pad = ((padding, padding),) * 2
    want = jq.int8_conv(_j(x), _j(kernel), _j(bias), (stride, stride), pad)
    xt = _t(x).permute(0, 3, 1, 2)          # NCHW view, channels-last
    wt = _t(kernel).permute(3, 2, 0, 1).contiguous()  # OIHW
    got = tq.int8_conv(xt, wt, _t(bias), stride, padding)
    assert tuple(got.shape) == (want.shape[0], want.shape[3], want.shape[1],
                                want.shape[2])
    _ulp(got.permute(0, 2, 3, 1).contiguous(), want)
    # Quantized operands and int32 accumulators, bit for bit; the card's
    # tap form (int_mm over row slices) against the f64 plain version.
    jxq, _ = jq.quantize_axes(_j(x), (1, 2, 3))
    wf = jnp.asarray(kernel)
    jws = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-8) / 127.0
    jwq = jnp.clip(jnp.round(wf / jws), -127, 127).astype(jnp.int8)
    jacc = jax.lax.conv_general_dilated(
        jxq, jwq, (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    xq, _ = tq.quantize_int8(_t(x).reshape(2, -1))
    wq, ws = tq.quantize_int8(wt.permute(0, 2, 3, 1).reshape(24, -1)
                              .contiguous())
    _eq(xq.view(2, 9, 11, 16), jxq)
    _eq(wq.view(24, kh, kh, 16).permute(1, 2, 3, 0), jwq)
    _eq(ws, jws)
    args = (xq.view(2, 9, 11, 16), wq.view(24, kh, kh, 16), stride, padding)
    _eq(tq.conv_acc_reference(*args), jacc)
    _eq(tq.conv_acc_taps(*args), jacc)


def test_quantized_ops_raise_under_autograd():
    w = torch.zeros(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tq.int8_dense(torch.ones(2, 8), w)
    with torch.no_grad():
        tq.int8_dense(torch.ones(2, 8), w)


# ------------------------------------------------------------- the model


IMG = _normal((2, 56, 56, 3), 11)


@pytest.fixture(scope="module")
def pair():
    """The port's seeded vitt weights as its state dict and as the JAX
    package's params (its own converter)."""
    sd = tda.build_depth_model("vitt", 20.0, torch.float32, "cpu",
                               seed=0).state_dict()
    params = convert_dav2({k: v.numpy() for k, v in sd.items()}, "vitt")
    return jax.tree_util.tree_map(jnp.asarray, params), sd


def _jax_model(**dials):
    m = jax_build("vitt", max_depth=20.0, dtype=jnp.float32, **dials)
    return lambda img, p: m.apply({"params": p}, img)


def _port_model(sd, **dials):
    m = tda.build_depth_model("vitt", 20.0, torch.float32, "cpu", **dials)
    m.load_state_dict(sd)
    return m


def _fused():
    """The JAX package's fused branch (the graph it runs on the TPU), its
    Pallas kernel in interpret mode, at full f32 matmul precision."""
    import contextlib

    stack = contextlib.ExitStack()
    jattn.set_force_fused(True)
    stack.callback(jattn.set_force_fused, False)
    stack.enter_context(jax.default_matmul_precision("highest"))
    return stack


def _close(got, want):
    d = np.abs(got - want)
    assert d.max() <= 1e-2 and d.mean() <= 1e-3, (d.max(), d.mean())
    return d.mean()


@pytest.mark.parametrize("dials", [
    dict(token_merge=0.25), dict(quant_int8=True, token_merge=0.25)],
    ids=["merge", "int8+merge"])
def test_model_dials_match_jax(pair, dials):
    params, sd = pair
    with _fused():
        want = np.asarray(jax.jit(_jax_model(**dials))(IMG, params))
    with torch.no_grad():
        got = _port_model(sd, **dials)(torch.from_numpy(IMG)).numpy()
        base = _port_model(sd)(torch.from_numpy(IMG)).numpy()
    # the dial engaged: the maps move far more than the two sides differ
    assert np.abs(got - base).mean() > 10 * _close(got, want)


def test_int8_dynamic_calibrated_and_frozen_match_jax(pair):
    """int8 under the auto scope (dynamic scales), the calibration tape
    (sites in the same order, abs-maxes within 1e-5), and the model on the
    frozen scales; a forward with more or fewer sites raises."""
    params, sd = pair
    batches = [IMG, _normal((2, 56, 56, 3), 12)]
    jmodel = _jax_model(quant_int8=True)

    def tapped(img, p):
        tape = []
        with jq.calibration(tape):
            depth = jmodel(img, p)
        return depth, jnp.stack(tape)

    with _fused():
        run = jax.jit(tapped)
        (want, t0), (_, t1) = (run(b, params) for b in batches)
        jamax = np.maximum(np.asarray(t0), np.asarray(t1))
        frozen = np.asarray(jax.jit(jq.with_frozen_scales(
            jmodel, jnp.asarray(jamax)))(IMG, params))
    model = _port_model(sd, quant_int8=True)
    with torch.no_grad():
        got = model(torch.from_numpy(IMG)).numpy()
        base = _port_model(sd)(torch.from_numpy(IMG)).numpy()
        assert np.abs(got - base).mean() > 10 * _close(got, np.asarray(want))
        amax = tq.calibrate_scales(model, [torch.from_numpy(b)
                                           for b in batches])
        # 4 vitt blocks x (qkv, proj, fc1, fc2); the decoder's convs are
        # narrower than 128 channels, so none is quantized.
        assert amax.shape == jamax.shape == (16,)
        np.testing.assert_allclose(amax.numpy(), jamax, rtol=1e-5)
        got = tq.with_frozen_scales(model, amax)(torch.from_numpy(IMG))
        _close(got.numpy(), frozen)
        with pytest.raises(ValueError, match="calibration recorded 17"):
            with tq.frozen_scales(torch.cat([amax, amax[:1]])):
                model(torch.from_numpy(IMG))
        with pytest.raises(ValueError, match="more activation quant sites"):
            with tq.frozen_scales(amax[:15]):
                model(torch.from_numpy(IMG))


def test_auto_scope_follows_the_batch(pair):
    _, sd = pair
    model = _port_model(sd, quant_int8=True)
    img = torch.from_numpy(_normal((33, 28, 28, 3), 13))
    for batch, sites in ((32, 16), (33, 8)):  # all; MLP only above 32
        tape = []
        with torch.no_grad(), tq.calibration(tape):
            model(img[:batch])
        assert len(tape) == sites


# ------------------------------------------ BatchedRunner and the engine


FRAMES = [np.random.default_rng(20 + i).integers(0, 256, (48, 48, 3),
                                                 dtype=np.uint8)
          for i in range(4)]


def test_batched_runner_calibrates_once(pair):
    _, sd = pair
    model = _port_model(sd, quant_int8=True)
    with pytest.warns(UserWarning, match="only 4 frames"):
        runner = tda.BatchedRunner(model, (48, 48), 42, 2,
                                   calib_frames=FRAMES, calib_batches=3)
    assert runner.amax.shape == (16,)
    maps = runner(FRAMES)
    assert len(maps) == 4 and all(np.isfinite(m).all() for m in maps)
    with pytest.raises(ValueError, match="requires calib_frames"):
        tda.BatchedRunner(model, (48, 48), 42, 2, calib_batches=1)
    with pytest.raises(ValueError, match="requires quant_int8"):
        tda.BatchedRunner(_port_model(sd), (48, 48), 42, 2,
                          calib_frames=FRAMES, calib_batches=1)


def test_engine_calibrates_a_held_backlog_when_idle(pair):
    """4 frames at batch 2 under calib_batches=4: two full batches are
    held for calibration and no more frames come. The JAX package's
    worker would wait for a ninth frame forever; the port's calibrates
    on what it holds after max_delay_s, without close()."""
    _, sd = pair
    model = _port_model(sd, quant_int8=True)
    engine = DepthServingEngine(model, input_size=42, batch_size=2,
                                max_delay_s=0.05, device="cpu",
                                calib_batches=4)
    try:
        t0 = time.monotonic()
        maps = [f.result(timeout=30) for f in engine.submit_many(FRAMES)]
        assert time.monotonic() - t0 < 30
        assert all(m.shape == (48, 48) and np.isfinite(m).all()
                   for m in maps)
        frozen = engine._runners[(48, 48, 3)]
        assert frozen.amax is not None
        # later batches go through the frozen runner, equal to it
        again = engine.submit_many(FRAMES[:2])
        np.testing.assert_array_equal(again[0].result(timeout=30),
                                      frozen(FRAMES[:2])[0])
    finally:
        engine.close()
    assert engine.stats()["failed"] == 0
    with pytest.raises(ValueError, match="quant_int8"):
        DepthServingEngine(_port_model(sd), device="cpu", calib_batches=2)
