"""The port's forward schedules K4 (paired heads) and K5 (head-looped,
pipelined or not) on the CPU, where each wrapper takes the plain version,
against the JAX package's Pallas kernels in interpret mode: ``_fwd_pair``
directly, and ``_fwd`` with the JAX module's ``_PIPE`` and then ``_HLOOP``
set. Plus the port's dispatch order and its environment knobs.

Shapes: B 2, H 2 (so B*H = 4 heads, in pairs and in one head block), D 32
and 64, N 64 and a ragged N of 50 valid tokens that the JAX side pads to
64. Only valid rows are compared. Tolerances as
``tests/test_torch_flash_attention.py``: f32 inputs check the algorithm
(2e-5 on O, 1e-4 on LSE); bf16 inputs 2e-2 on O (the JAX kernels round the
unnormalised probabilities to bf16 before PV, the plain version the
normalised ones; a few bf16 ulps at |o| <= 1).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import flash_attention as jfa
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import flash_attention as tfa

O_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
B, H = 2, 2


def _qkv(n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, d)).astype(np.float32)
            for _ in range(3)]


def _to3(x, dtype, np_):
    """(B, N, H, D) numpy -> the JAX kernels' padded (B*H, Np, D)."""
    b, n, h, d = x.shape
    x = jnp.swapaxes(jnp.asarray(x, dtype), 1, 2).reshape(b * h, n, d)
    return jnp.pad(x, ((0, 0), (0, np_ - n), (0, 0)))


def _jax_forward(kind, q, k, v, dtype, monkeypatch):
    """The JAX kernel's (O (B, N, H, D), LSE (B, H, N)) on valid rows."""
    b, n, h, d = q.shape
    np_ = jfa.padded_len(n)
    args = [_to3(x, dtype, np_) for x in (q, k, v)]
    scale = 1.0 / d ** 0.5
    with jax.default_matmul_precision("highest"):
        if kind == "pair":
            o, lse = jfa._fwd_pair(*args, scale, n, interpret=True)
        else:
            monkeypatch.setattr(jfa, "_PIPE", kind == "pipe")
            monkeypatch.setattr(jfa, "_HLOOP", kind == "hloop")
            o, lse = jfa._fwd(*args, scale, n, interpret=True)
    o = np.asarray(o, np.float32)[:, :n].reshape(b, h, n, d)
    return o.transpose(0, 2, 1, 3), np.asarray(lse)[:, :n, 0].reshape(b, h, n)


def _port_forward(kind, q, k, v, dtype, monkeypatch):
    monkeypatch.setattr(tfa, "_PAIR", kind == "pair")
    monkeypatch.setattr(tfa, "_PIPE", kind == "pipe")
    monkeypatch.setattr(tfa, "_HLOOP", kind == "hloop")
    tdt = getattr(torch, dtype)
    o, lse = tfa.flash_attention(*(torch.from_numpy(x).to(tdt)
                                   for x in (q, k, v)))
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(64, 64), (50, 32), (50, 64)])
@pytest.mark.parametrize("kind", ["pair", "pipe", "hloop"])
def test_variant_matches_jax_kernel(kind, n, d, dtype, monkeypatch):
    q, k, v = _qkv(n, d, seed=n + d)
    ran = []
    if kind == "pipe":
        real = jfa._fwd_kernel_pipe

        def spy(*args, **kwargs):
            ran.append(kwargs["hb"])
            return real(*args, **kwargs)

        monkeypatch.setattr(jfa, "_fwd_kernel_pipe", spy)
    want_o, want_lse = _jax_forward(kind, q, k, v, getattr(jnp, dtype),
                                    monkeypatch)
    if kind == "pipe":
        assert ran and ran[0] == B * H  # the pipelined body, 4 heads in one
    o, lse = _port_forward(kind, q, k, v, dtype, monkeypatch)
    assert o.shape == (B, n, H, d) and lse.shape == (B, H, n)
    np.testing.assert_allclose(o, want_o, atol=O_TOL[dtype])
    np.testing.assert_allclose(lse, want_lse, atol=LSE_TOL)


def test_dispatch_order(monkeypatch):
    """The JAX package's ``_fwd`` order: PAIR (even B*H only), then PIPE,
    then HLOOP, then K1."""
    for flag in ("_PAIR", "_PIPE", "_HLOOP"):
        monkeypatch.setattr(tfa, flag, False)
    assert tfa.forward_schedule(128) == "K1"
    monkeypatch.setattr(tfa, "_HLOOP", True)
    assert tfa.forward_schedule(128) == "K5 hloop"
    monkeypatch.setattr(tfa, "_PIPE", True)
    assert tfa.forward_schedule(128) == "K5 pipe"
    monkeypatch.setattr(tfa, "_PAIR", True)
    assert tfa.forward_schedule(128) == "K4"
    assert tfa.forward_schedule(3) == "K5 pipe"
    monkeypatch.setattr(tfa, "_PIPE", False)
    monkeypatch.setattr(tfa, "_HLOOP", False)
    assert tfa.forward_schedule(15) == "K1"


@pytest.mark.parametrize("bh,n,d", [(128, 1370, 64), (4, 50, 32),
                                    (12, 257, 64), (7, 1370, 64),
                                    (96, 2000, 64)])
def test_head_block_is_the_jax_rule(bh, n, d):
    """K5's heads per block: 2 at vitl's 518 px (B*H 128, N 1370)."""
    assert tfa.padded_len(n) == jfa.padded_len(n)
    assert tfa.head_block(bh, n, d) == jfa._head_block(
        bh, jfa.padded_len(n), d, 2, budget=jfa.FWD_BUDGET)


def test_wrappers_take_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(40, 32, seed=3))
    ro, rlse = tfa.flash_attention_reference(q, k, v)
    counts = (tfa.flash_attention_pair.launches,
              tfa.flash_attention_heads.launches)
    for o, lse in (tfa.flash_attention_pair(q, k, v),
                   tfa.flash_attention_heads(q, k, v, pipe=True),
                   tfa.flash_attention_heads(q, k, v, pipe=False)):
        torch.testing.assert_close(o, ro)
        torch.testing.assert_close(lse, rlse)
    assert (tfa.flash_attention_pair.launches,
            tfa.flash_attention_heads.launches) == counts


def test_variants_refuse_meta_tensors_and_autograd():
    """Off the CPU the wrappers launch or raise (meta tensors stand in for
    a device this machine lacks); under autograd they raise."""
    q = torch.empty(1, 16, 3, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="odd"):
        tfa.flash_attention_pair(q, q, q)
    for pipe in (True, False):
        with pytest.raises(ValueError, match="CUDA device"):
            tfa.flash_attention_heads(q, q, q, pipe=pipe)
    x = torch.zeros(1, 16, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention_qkv"):
        tfa.flash_attention_pair(x, x, x)


@pytest.mark.parametrize("kind", ["k1", "pair", "pipe", "hloop"])
@pytest.mark.parametrize("view", ["zero stride", "misaligned stride"])
def test_variants_refuse_views_tma_cannot_read(view, kind, monkeypatch):
    """K1, K4 and K5 load q, k and v only by TMA, so off the CPU a view
    with a zero stride or a stride that is not a multiple of 16 bytes
    raises a ValueError naming its strides, before any build (meta tensors
    stand in for the card; the packed projection's views pass)."""
    def no_build(name):
        raise AssertionError(f"built {name} for a view the kernel refuses")

    monkeypatch.setattr(tfa.cbuild, "load", no_build)
    q, k, v = torch.empty(2, 16, 3, 2, 64, dtype=torch.bfloat16,
                          device="meta").unbind(2)
    assert all(tfa._tma_ok(x) for x in (q, k, v))
    if view == "zero stride":
        bad = k[:, :1].expand_as(k)
    else:  # rows of 68 elements: a head stride of 136 bytes
        bad = torch.empty(2, 16, 2, 68, dtype=torch.bfloat16,
                          device="meta")[..., :64]
    for flag in ("_PAIR", "_PIPE", "_HLOOP"):
        monkeypatch.setattr(tfa, flag, False)
    call = {"k1": tfa.flash_attention,
            "pair": tfa.flash_attention_pair,
            "pipe": lambda *x: tfa.flash_attention_heads(*x, pipe=True),
            "hloop": lambda *x: tfa.flash_attention_heads(*x, pipe=False)}
    counts = (tfa.flash_attention.launches,
              tfa.flash_attention_pair.launches,
              tfa.flash_attention_heads.launches)
    with pytest.raises(ValueError,
                       match=r"k \(strides .*\) is not a view TMA can read"):
        call[kind](q, bad, v)
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_pair.launches,
            tfa.flash_attention_heads.launches) == counts


def test_k1_takes_any_view_on_the_cpu():
    """On the CPU the default forward takes the plain version whatever the
    view's strides: a broadcast k (a zero stride, which the card's TMA
    refuses) gives the plain result of its contiguous copy, and nothing
    counts as a launch."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(24, 32, seed=4))
    bad = k[:, :1].expand_as(k)
    assert not tfa._tma_ok(bad)
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, bad, v)
    ro, rlse = tfa.flash_attention_reference(q, bad.contiguous(), v)
    torch.testing.assert_close(o, ro)
    torch.testing.assert_close(lse, rlse)
    assert tfa.flash_attention.launches == before


_PROBE = """
import sys
sys.modules["jax"] = None
from {pkg}.ops import flash_attention as fa, resize as rz
print(fa._PAIR, fa._PIPE, fa._HLOOP, rz._PALLAS_RESIZE,
      fa.forward_schedule(128), fa.head_block(128, 1370, 64))
"""


@pytest.mark.parametrize("env,want", [
    ({}, "False False False False K1 2"),
    ({"E3D_FLASH_PAIR": "1", "E3D_PALLAS_RESIZE": "1"},
     "True False False True K4 2"),
    ({"E3D_FLASH_PIPE": "1"}, "False True False False K5 pipe 2"),
    ({"E3D_FLASH_HLOOP": "1"}, "False False True False K5 hloop 2"),
    # The JAX package's TPU block and VMEM knobs do not reach the port.
    ({"E3D_FLASH_BLOCK_Q": "128", "E3D_FLASH_FWD_BUDGET_KB": "64"},
     "False False False False K1 2"),
])
def test_environment_sets_the_port_flags(env, want):
    """The knobs are read at import, from the JAX package's variable
    names, with no JAX in the process; K5's heads per block (2 at vitl's
    518 px) follows the JAX package's defaults whatever its TPU knobs
    say."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items()
            if k not in ("E3D_FLASH_PAIR", "E3D_FLASH_PIPE",
                         "E3D_FLASH_HLOOP", "E3D_PALLAS_RESIZE",
                         "E3D_FLASH_BLOCK_Q", "E3D_FLASH_FWD_BUDGET_KB")}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(pkg=tfa.__name__.rsplit(
            ".", 2)[0])],
        cwd=root, env=dict(base, PYTHONPATH=root, **env),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want
