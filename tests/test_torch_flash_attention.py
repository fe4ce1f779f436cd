"""Port's flash-attention forward (kernel K1's plain version on the CPU)
against the JAX package's Pallas kernel in interpret mode.

Tolerances: f32 inputs check the algorithm (2e-5, the JAX package's own
flash-vs-XLA bound). With bf16 inputs the JAX kernel rounds the
unnormalised probabilities to bf16 before PV while the plain version
rounds the normalised ones, and both round O to bf16: 2e-2 allows a few
bf16 ulps at |o| <= 1 (one ulp is 3.9e-3 in [0.5, 1)). LSE is f32 in
both: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import flash_attention as jfa
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core.device import resolve_device
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import attention as tattn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops.flash_attention import flash_attention

O_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4


def _qkv(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_lse(q, k, v, dtype):
    """LSE of the JAX forward kernel ``_fwd`` on valid rows, (B, H, N)."""
    b, n, h, d = q.shape
    np_ = jfa.padded_len(n)

    def to3(x):
        x = jnp.swapaxes(jnp.asarray(x, dtype), 1, 2).reshape(b * h, n, d)
        return jnp.pad(x, ((0, 0), (0, np_ - n), (0, 0)))

    _, lse = jfa._fwd(to3(q), to3(k), to3(v), 1.0 / d ** 0.5, n,
                      interpret=True)
    return np.asarray(lse)[:, :n, 0].reshape(b, h, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 130])
@pytest.mark.parametrize("d", [32, 64])
def test_forward_matches_jax_kernel(d, n, dtype):
    q, k, v = _qkv(2, n, 3, d, seed=n + d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(jfa.flash_attention(
            *(jnp.asarray(x, jdt) for x in (q, k, v)), interpret=True),
            np.float32)
        expected_lse = _jax_lse(q, k, v, jdt)
    o, lse = flash_attention(*(torch.from_numpy(x).to(tdt)
                               for x in (q, k, v)))
    assert o.dtype == tdt and o.shape == (2, n, 3, d)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, n)
    np.testing.assert_allclose(o.float().numpy(), expected,
                               atol=O_TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), expected_lse, atol=LSE_TOL)


def test_strided_views_match_contiguous():
    """The encoder hands q, k, v over as views of one packed (B, N, 3, H,
    D) projection; the result must not depend on the layout."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(2, 70, 3, 4, 32))
                           .astype(np.float32))
    views = qkv.unbind(2)
    o, lse = flash_attention(*views)
    o2, lse2 = flash_attention(*(x.contiguous() for x in views))
    torch.testing.assert_close(o, o2)
    torch.testing.assert_close(lse, lse2)


def test_force_plain_hook_restores():
    gen = torch.Generator().manual_seed(0)
    x, w_qkv, b_qkv, w_proj, b_proj = (
        torch.randn(s, generator=gen) * 0.1
        for s in ((1, 9, 64), (192, 64), (192,), (64, 64), (64,)))
    tattn.set_force_plain(True)
    try:
        forced = tattn.qkv_self_attention(x, w_qkv, b_qkv, w_proj, b_proj, 2)
    finally:
        tattn.set_force_plain(False)
    assert not tattn._FORCE_PLAIN
    torch.testing.assert_close(forced, tattn.qkv_self_attention(
        x, w_qkv, b_qkv, w_proj, b_proj, 2))


def test_non_cpu_tensors_never_take_the_plain_version():
    """Tensors off the CPU launch the kernel or raise; they are never
    quietly computed by the plain version (meta tensors stand in for a
    device this machine lacks)."""
    q = torch.empty(1, 16, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forward_refuses_to_be_recorded_by_autograd(device):
    """K1 writes outside autograd, so a call that autograd would record
    raises on every device rather than return a graph-less output."""
    q = torch.zeros(1, 16, 2, 64, device=device)
    with pytest.raises(RuntimeError, match="flash_attention_qkv"):
        flash_attention(q, q, q.requires_grad_(True))
    with torch.no_grad():
        if device == "cpu":
            assert flash_attention(q, q, q)[0].shape == q.shape


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        flash_attention(*(torch.zeros(1, 8, 1, 32, device="cuda")
                          for _ in range(3)))
