"""The steps around the port's backward kernels, on the CPU: the plain
versions of the preparation kernel (delta and LSE * log2(e) in padded
(B, H, Np) rows) and of K2's conversion kernel (its f32 dQ accumulator
to dq), and the wrapper's test of which views TMA reads as they are.

Tolerances: delta against the JAX package's f32 ``jnp.sum(g * out, -1)``
(``_bwd_fused``) at 1e-5, the same products summed in another order; dq
from the accumulator against the plain backward's at 1e-5 in f32 (the
same sum in another order, then one scale); exact where only the layout
moves values.
"""

import math

import jax.numpy as jnp
import numpy as np
import torch

import e3d_tpu  # noqa: F401
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import flash_attention as tfa


def test_padded_rows():
    assert [tfa.padded_rows(n) for n in (1, 50, 64, 65, 130, 1370)] == \
        [64, 64, 64, 128, 192, 1408]


def test_prep_reference_matches_jax_delta_and_pads_the_rows():
    """Odd B*H and N = 130: delta against the JAX package's sum, LSE2 =
    LSE * log2(e), and on the 62 padded rows LSE2 = +inf (so P = 0 there,
    which a zero-filled LSE would not give) and delta = 0."""
    b, n, h, d = 3, 130, 5, 32
    rng = np.random.default_rng(0)
    out = rng.normal(size=(b, n, h, d)).astype(np.float32)
    g = rng.normal(size=(b, n, h, d)).astype(np.float32)
    lse = rng.normal(size=(b, h, n)).astype(np.float32)
    want = np.asarray(jnp.sum(jnp.asarray(g) * jnp.asarray(out), axis=-1))

    lse2, delta, acc = tfa.bwd_prep_reference(
        torch.from_numpy(out), torch.from_numpy(g), torch.from_numpy(lse),
        fused=True)
    assert lse2.shape == delta.shape == (b, h, 192)
    assert lse2.dtype == delta.dtype == torch.float32
    np.testing.assert_allclose(delta[..., :n].numpy(),
                               want.transpose(0, 2, 1), atol=1e-5)
    assert (delta[..., n:] == 0).all()
    torch.testing.assert_close(lse2[..., :n],
                               torch.from_numpy(lse) * math.log2(math.e))
    assert torch.isposinf(lse2[..., n:]).all()
    assert (torch.exp2(torch.tensor(30.0) - lse2[..., n:]) == 0).all()
    assert acc.shape == (b, h, 192, d) and not acc.any()
    assert tfa.bwd_prep_reference(
        torch.from_numpy(out), torch.from_numpy(g), torch.from_numpy(lse),
        fused=False)[2] is None


def test_accumulator_swizzle_is_its_own_inverse():
    acc = torch.arange(2 * 128 * 64, dtype=torch.float32).view(2, 128, 64)
    stored = tfa.dq_acc_swizzle(acc)
    assert not torch.equal(stored, acc)
    assert torch.equal(tfa.dq_acc_swizzle(stored), acc)
    # Row r keeps its values; its 8-value chunk c holds chunk c ^ (r % 4).
    assert torch.equal(stored.sort(-1).values, acc)
    assert torch.equal(stored[0, 3, :8], acc[0, 3, 24:32])


def test_convert_reference_gives_the_plain_backwards_dq():
    """K2's schedule in plain f32: each 128-key block adds its dS K share
    into the (B, H, Np, D) accumulator in the stored layout; the
    conversion's plain version turns the sum into the plain backward's
    dq, (B, N, H, D)."""
    b, n, h, d = 2, 150, 3, 64
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, n, h, d))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = tfa.flash_attention_reference(q, k, v)
    dq, _, _ = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do)

    scale = d ** -0.5
    lse2, delta, acc = tfa.bwd_prep_reference(o, do, lse, fused=True)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.exp2(s * math.log2(math.e) - lse2[..., :n, None])
    ds = p * (torch.einsum("bnhd,bmhd->bhnm", do, v)
              - delta[..., :n, None])
    pad = tfa.padded_rows(n) - n
    for k0 in range(0, n, 128):
        share = torch.einsum("bhnm,bmhd->bhnd", ds[..., k0:k0 + 128],
                             k[:, k0:k0 + 128])
        acc += tfa.dq_acc_swizzle(
            torch.nn.functional.pad(share, (0, 0, 0, pad)))
    got = tfa.bwd_convert_reference(acc, n, scale, torch.float32)
    assert got.shape == (b, n, h, d)
    torch.testing.assert_close(got, dq, atol=1e-5, rtol=1e-5)
    bf = tfa.bwd_convert_reference(acc, n, scale, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))


def test_tma_ok_reads_the_packed_views_and_refuses_the_rest():
    for d in (32, 64):
        qkv = torch.empty(2, 50, 3, 4, d, dtype=torch.bfloat16)
        assert all(tfa._tma_ok(x) for x in qkv.unbind(2))
    x = torch.empty(2, 50, 4, 64, dtype=torch.bfloat16)
    assert tfa._tma_ok(x)
    # Memory in (B, H, N, D) order: strides still 16-byte multiples.
    assert tfa._tma_ok(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert not tfa._tma_ok(x[:, :1].expand_as(x))  # a zero stride
    assert not tfa._tma_ok(x.transpose(2, 3))      # D not unit-stride
    flat = torch.empty(x.numel() + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    assert not tfa._tma_ok(flat[1:1 + x.numel()].view(x.shape))
    assert tfa._tma_ok(flat[8:8 + x.numel()].view(x.shape))
    # Rows 136 bytes apart are not a multiple of 16; 144 are.
    assert not tfa._tma_ok(torch.empty(2, 50, 4, 68,
                                       dtype=torch.bfloat16)[..., :64])
    assert tfa._tma_ok(torch.empty(2, 50, 4, 72,
                                   dtype=torch.bfloat16)[..., :64])
