"""The slice end to end: uint8 BGR frames -> metric depth through the
port's ``_run_batched_u8`` against the JAX package's, plus the serving
engine and the upload format.

Tolerances: f32 end to end within 5e-4 m of the JAX package, the bound
its own HF parity test uses (``tests/test_depth_anything_parity.py``).
In bf16 both sides round every activation to bf16, in places that differ
(LayerNorm affine, bias inside or after the matmul, P before or after the
softmax division); at random weights the DPT head amplifies that to tenths
of a metre (0.12 m max, 0.02 m mean measured on vitt; bf16 against f32
on one side alone is of the same size), so bf16 is bounded at 0.5 m max
and 0.05 m mean on a 20 m range: a wiring fault moves whole maps by
metres.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.models import build_depth_model as jax_build
from e3d_tpu.core import dtypes as jdtypes
from e3d_tpu.models import depth_anything as jda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import dtypes as tdtypes
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models.convert import load_dav2_state_dict, from_jax_params
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.serving.engine import DepthServingEngine

FRAME_HW = (60, 80)
INPUT_SIZE = 56  # -> network input (56, 70), a 4x5 patch grid


def _pair(encoder: str, dtype: str):
    jmodel = jax_build(encoder, max_depth=20.0, dtype=getattr(jnp, dtype))
    params = jmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 56, 56, 3), np.float32))["params"]
    tmodel = tda.build_depth_model(encoder, 20.0, getattr(torch, dtype),
                                   device="cpu")
    load_dav2_state_dict(tmodel, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _frames(n: int, hw=FRAME_HW, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, *hw, 3),
                                                dtype=np.uint8)


def _jax_depth(jmodel, params, frames, precision="highest"):
    net_hw = jda._lower_bound_hw(*frames.shape[1:3], INPUT_SIZE)
    with jax.default_matmul_precision(precision):
        return np.asarray(jda._run_batched_u8(
            params, jnp.asarray(frames), net_hw, frames.shape[1:3],
            jda._ModelThunk(jmodel)))


@pytest.mark.parametrize("encoder", ["vitt", "vits"])
def test_run_batched_u8_matches_jax_f32(encoder):
    jmodel, params, tmodel = _pair(encoder, "float32")
    frames = _frames(2)
    expected = _jax_depth(jmodel, params, frames)
    net_hw = tda._lower_bound_hw(*FRAME_HW, INPUT_SIZE)
    assert net_hw == (56, 70)
    got = tda._run_batched_u8(tmodel, torch.from_numpy(frames), net_hw,
                              FRAME_HW)
    assert got.dtype == torch.float32 and got.shape == (2, *FRAME_HW)
    np.testing.assert_allclose(got.numpy(), expected, atol=5e-4)


def test_run_batched_u8_matches_jax_bf16():
    jmodel, params, tmodel = _pair("vitt", "bfloat16")
    frames = _frames(2, seed=1)
    expected = _jax_depth(jmodel, params, frames, precision="default")
    got = tda._run_batched_u8(tmodel, torch.from_numpy(frames),
                              tda._lower_bound_hw(*FRAME_HW, INPUT_SIZE),
                              FRAME_HW).numpy()
    diff = np.abs(got - expected)
    assert diff.max() <= 0.5 and diff.mean() <= 0.05, (diff.max(),
                                                      diff.mean())


def test_infer_image_matches_jax():
    jmodel, params, tmodel = _pair("vitt", "float32")
    frame = _frames(1, hw=(50, 66), seed=2)[0]
    with jax.default_matmul_precision("highest"):
        expected = jda.infer_image(jmodel, params, frame,
                                   input_size=INPUT_SIZE)
    got = tda.infer_image(tmodel, frame, input_size=INPUT_SIZE)
    assert got.shape == (50, 66)
    np.testing.assert_allclose(got, expected, atol=5e-4)


def test_engine_serves_what_the_runner_computes():
    """Two resolutions interleaved, ragged batches, drain on close: every
    future resolves to the BatchedRunner's map for that frame."""
    _, _, tmodel = _pair("vitt", "float32")
    small, large = _frames(5, seed=3), _frames(3, hw=(70, 56), seed=4)
    frames = [small[0], large[0], small[1], small[2], large[1], small[3],
              large[2], small[4]]
    with DepthServingEngine(tmodel, input_size=INPUT_SIZE, batch_size=4,
                            max_delay_s=0.01, device="cpu") as engine:
        futures = engine.submit_many(frames)
    results = [f.result(timeout=0) for f in futures]
    stats = engine.stats()
    assert stats["submitted"] == stats["completed"] == 8
    assert stats["failed"] == 0
    expected = {}
    for arr in (small, large):
        runner = tda.BatchedRunner(tmodel, arr.shape[1:3], INPUT_SIZE, 4)
        for f, d in zip(arr, runner(list(arr))):
            expected[f.tobytes()] = d
    for frame, depth in zip(frames, results):
        np.testing.assert_allclose(depth, expected[frame.tobytes()],
                                   atol=1e-5)
    engine.reset_stats()
    assert engine.stats()["completed"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(small[0])


def test_runner_f16_readback():
    _, _, tmodel = _pair("vitt", "float32")
    frames = list(_frames(3, seed=5))
    f32 = tda.BatchedRunner(tmodel, FRAME_HW, INPUT_SIZE, 2)(frames)
    f16 = tda.BatchedRunner(tmodel, FRAME_HW, INPUT_SIZE, 2,
                            readback_f16=True)(frames)
    assert len(f16) == 3 and f16[0].dtype == np.float16
    # f16 keeps ~0.01 absolute at the 20 m range cap.
    np.testing.assert_allclose(np.stack(f16), np.stack(f32), atol=1e-2)


def test_chunk_bgr_u8_rejects_other_dtypes():
    frames = list(_frames(3))
    chunks = list(tda.chunk_bgr_u8(frames, 2))
    assert [n for _, n in chunks] == [2, 1]
    assert chunks[1][0].shape == (2, *FRAME_HW, 3)
    assert not chunks[1][0][1].any()
    for bad in (np.float32, np.uint16, np.int64):
        with pytest.raises(TypeError, match="uint8"):
            list(tda.chunk_bgr_u8([frames[0].astype(bad)], 2))
    for (a, n), (b, m) in zip(tda.chunk_rgb01(frames, 2),
                              jda.chunk_rgb01(frames, 2)):
        assert n == m
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["16-mixed", "bf16-mixed", "bf16",
                                       "32-true", "32", "fp32"])
def test_dtype_policy_matches_jax(precision):
    jpol = jdtypes.policy_from_precision(precision)
    tpol = tdtypes.policy_from_precision(precision)
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert (str(getattr(tpol, field)).removeprefix("torch.")
                == np.dtype(getattr(jpol, field)).name)
    with pytest.raises(ValueError, match="unknown precision"):
        tdtypes.policy_from_precision("64-true")
    model = tda.build_depth_model("vitt", device="cpu")
    assert model.pretrained.dtype == tdtypes.POLICY_BF16.compute_dtype


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tda.build_depth_model("vitt")
    _, _, tmodel = _pair("vitt", "float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        DepthServingEngine(tmodel)
