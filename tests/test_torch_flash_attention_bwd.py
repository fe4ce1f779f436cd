"""Port's flash-attention backward (the plain version of kernels K2 and K3,
as the CPU runs it) and its autograd Function, against ``jax.grad``
through the JAX package's Pallas kernels in interpret mode.

Tolerances: f32 at 3e-4 absolute, the JAX package's own bound for its
backward kernels against XLA autodiff (``tests/test_flash_attention.py``);
the port's pieces against each other in f32 at 1e-5 (the same arithmetic
in another order); ``gradcheck`` in f64 at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import flash_attention as jfa
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import attention as tattn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import flash_attention as tfa

GRAD_TOL = 3e-4


def _case(b, n, h, d, seed):
    """A packed (B, N, 3, H, D) qkv and a cotangent for O, f32 numpy."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3, h, d)).astype(np.float32)
    g = rng.normal(size=(b, n, h, d)).astype(np.float32)
    return qkv, g


def _jax_grads(qkv, g):
    """d<O, g>/d(q, k, v) through the JAX Pallas kernels (interpret)."""
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, interpret=True)
        return jnp.sum(o * g)

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    return [np.asarray(x) for x in grads]


def _port_grads(qkv, g) -> torch.Tensor:
    x = torch.from_numpy(qkv).requires_grad_(True)
    o = tfa.flash_attention_qkv(x)
    (o * torch.from_numpy(g)).sum().backward()
    return x.grad


@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K3"])
@pytest.mark.parametrize("n", [150, 128])
@pytest.mark.parametrize("d", [32, 64])
def test_backward_matches_jax_kernels(d, n, fused, monkeypatch):
    monkeypatch.setattr(jfa, "_BWD_FUSED", fused)
    monkeypatch.setattr(tfa, "_BWD_FUSED", fused)
    qkv, g = _case(2, n, 2, d, seed=n + d)
    expected = _jax_grads(qkv, g)
    dqkv = _port_grads(qkv, g)
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.float32
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(dqkv[:, :, i].numpy(), expected[i],
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_plain_backward_passes_gradcheck():
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(1, 5, 3, 2, 4))).requires_grad_(
        True)
    assert torch.autograd.gradcheck(tfa.flash_attention_qkv, (qkv,))


def test_packed_gradient_matches_three_separate_grads():
    """The Function's one packed dqkv against autograd through the plain
    attention with q, k and v as three separate leaves."""
    qkv, g = _case(2, 37, 3, 32, seed=1)
    dqkv = _port_grads(qkv, g)
    leaves = [torch.from_numpy(np.ascontiguousarray(qkv[:, :, i]))
              .requires_grad_(True) for i in range(3)]
    (tattn.mha_plain(*leaves) * torch.from_numpy(g)).sum().backward()
    for i, leaf in enumerate(leaves):
        torch.testing.assert_close(dqkv[:, :, i], leaf.grad, atol=1e-5,
                                   rtol=1e-5)


def test_backward_reference_parts():
    """delta = rowsum(dO * O) as (B, H, N), and dV = P^T dO with
    P = exp(S scale - LSE) rows summing to one."""
    qkv, g = _case(1, 20, 2, 32, seed=2)
    q, k, v = (torch.from_numpy(qkv[:, :, i]) for i in range(3))
    do = torch.from_numpy(g)
    o, lse = tfa.flash_attention(q, k, v)
    delta = tfa.attention_delta(o, do)
    assert delta.shape == (1, 2, 20) and delta.is_contiguous()
    torch.testing.assert_close(delta, (o * do).sum(-1).transpose(1, 2))
    _, _, dv = tfa.flash_attention_bwd_reference(q, k, v, o, lse,
                                                 torch.ones_like(do))
    # With dO = 1, dV_j = sum_i P_ij: the column sums, which total N.
    torch.testing.assert_close(dv.sum(1)[..., 0], torch.full((1, 2), 20.0),
                               atol=1e-4, rtol=0)


def test_force_plain_routes_attention_through_autograd():
    """``set_force_plain`` keeps the encoder's attention on the plain
    einsums, forward and backward; both routes give the same gradient."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 11, 64)).astype(np.float32))
    w_qkv, b_qkv, w_proj, b_proj = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
        .requires_grad_(True)
        for s in ((192, 64), (192,), (64, 64), (64,)))

    def grads(plain: bool):
        for p in (w_qkv, b_qkv, w_proj, b_proj):
            p.grad = None
        tattn.set_force_plain(plain)
        try:
            out = tattn.qkv_self_attention(x, w_qkv, b_qkv, w_proj, b_proj, 2)
        finally:
            tattn.set_force_plain(False)
        out.square().sum().backward()
        return [p.grad.clone() for p in (w_qkv, b_qkv, w_proj, b_proj)]

    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K3"])
def test_non_cpu_tensors_never_take_the_plain_backward(fused, monkeypatch):
    """Off the CPU the backward launches K2/K3 or raises (meta tensors
    stand in for a device this machine lacks)."""
    monkeypatch.setattr(tfa, "_BWD_FUSED", fused)
    qkv = torch.empty(1, 16, 3, 2, 64, dtype=torch.bfloat16, device="meta")
    o = torch.empty(1, 16, 2, 64, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_qkv_backward(qkv, o, lse, o)


def test_bwd_knob_is_read_from_the_environment():
    """E3D_FLASH_BWD_FUSED=0 and =1 force K3 and K2, read at import (in a
    fresh process, importing the module again under each setting); unset,
    the port takes the backward measured faster on the H100: K2 (PERF.md,
    Findings)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = ("import importlib, os\n"
             "from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
             "depth_and_pose_estimation_tpu_torch.ops import flash_attention "
             "as f\n"
             "for value in ('0', '1', None):\n"
             "    os.environ.pop('E3D_FLASH_BWD_FUSED', None)\n"
             "    if value is not None:\n"
             "        os.environ['E3D_FLASH_BWD_FUSED'] = value\n"
             "    print(importlib.reload(f)._BWD_FUSED)\n")
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "True", "True"], \
        out.stdout + out.stderr
