"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA Hopper card and the CUDA toolkit; without a
card they skip. They import neither JAX nor the JAX package, so a machine
without JAX runs them, from the root of the checkout, past the JAX-side
``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are those of ``chip_smoke.py``: O is bf16 in both versions,
and the kernel rounds the unnormalised probabilities to bf16 before PV
where the plain version rounds the normalised ones, so a few bf16 ulps at
|o| <= 1 (2e-2); LSE is f32 in both and differs only in summation order
(1e-3). The backward kernels round P and dS to bf16 before the products
that consume them, the plain backward computes in f32 from the same bf16
inputs: their largest difference may be 2e-2 of the largest |gradient|.
The int8 passes Q1 and Q2 and the int8 conv's int32 accumulator are
exact: they must equal their plain versions bit for bit. The batched
augmentation differs from its plain version only in the order of two sums
(1e-4 on the normalised output; ``_check_augment`` says why), and its
filled pixels are exact.
"""

import itertools
from time import perf_counter_ns

import pytest
import torch

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import debug
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import attention as tattn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import augment as taug
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import flash_attention as fa
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)

BWD_TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _packed_qkv(b, n, h, d, seed, card):
    gen = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=card,
                      dtype=torch.bfloat16)
    return qkv.unbind(2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 130, 3, 32), (2, 200, 4, 64),
                                   (1, 37, 2, 64), (3, 64, 5, 32),
                                   (2, 1370, 24, 64)])
def test_kernel_matches_plain(shape, card):
    q, k, v = _packed_qkv(*shape, seed=sum(shape), card=card)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = flash_attention_reference(q, k, v)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    q, k, v = _packed_qkv(1, 16, 2, 64, seed=0, card=card)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(x[..., :48] for x in (q, k, v)))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k.cpu(), v)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention_qkv"):
        flash_attention(torch.zeros_like(q, requires_grad=True), k, v)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_vitt_model_on_kernel_matches_plain_attention(card):
    """The whole vitt model (bf16, D = 32) on the card, against the same
    model with the plain attention: the depth maps agree to within bf16
    rounding, and only the kernel path counts launches."""
    model = tda.build_depth_model("vitt", dtype=torch.bfloat16, device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    frames = torch.randint(0, 256, (2, 60, 80, 3), generator=gen,
                           device=card, dtype=torch.uint8)
    net_hw = tda._lower_bound_hw(60, 80, 56)
    before = flash_attention.launches
    kernel = tda._run_batched_u8(model, frames, net_hw, (60, 80))
    assert flash_attention.launches == before + 4  # one per vitt block
    tattn.set_force_plain(True)
    try:
        plain = tda._run_batched_u8(model, frames, net_hw, (60, 80))
    finally:
        tattn.set_force_plain(False)
    assert flash_attention.launches == before + 4
    assert torch.isfinite(kernel).all()
    diff = (kernel - plain).abs()
    # vitt at random weights: 4 bf16 blocks, depth range 20 m.
    assert diff.max().item() <= 0.5 and diff.mean().item() <= 0.05


def _bwd_case(b, n, h, d, seed, card):
    """A packed qkv, the K1 forward's o and lse, and a random dO."""
    gen = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=card,
                      dtype=torch.bfloat16)
    o, lse = flash_attention(*qkv.unbind(2))
    do = torch.randn((b, n, h, d), generator=gen, device=card,
                     dtype=torch.bfloat16)
    return qkv, o, lse, do


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


# vitl's shape (a ragged last 128-key block), vitg's (24 heads), an exact
# multiple of the tiles, one shorter than a tile, an odd B*H at D 32, and
# others.
BWD_SHAPES = [(8, 1370, 16, 64), (2, 1370, 24, 64), (2, 256, 4, 64),
              (1, 50, 2, 64), (3, 130, 5, 32), (2, 128, 4, 64),
              (1, 37, 2, 64), (2, 200, 3, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K3"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernels_match_plain(shape, fused, card, monkeypatch):
    monkeypatch.setattr(fa, "_BWD_FUSED", fused)
    qkv, o, lse, do = _bwd_case(*shape, seed=sum(shape), card=card)
    counter = (fa.flash_attention_bwd_fused if fused
               else fa.flash_attention_bwd_split)
    before = counter.launches
    dqkv = fa.flash_attention_qkv_backward(qkv, o, lse, do)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    ref = fa.flash_attention_bwd_reference(*qkv.unbind(2), o, lse, do)
    for name, got, want in zip("qkv", dqkv.unbind(2), ref):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, want) <= BWD_TOL, (name, _rel_err(got, want))


@pytest.mark.cuda
def test_split_backward_is_deterministic(card, monkeypatch):
    monkeypatch.setattr(fa, "_BWD_FUSED", False)
    qkv, o, lse, do = _bwd_case(2, 130, 3, 64, seed=5, card=card)
    a = fa.flash_attention_qkv_backward(qkv, o, lse, do)
    b = fa.flash_attention_qkv_backward(qkv, o, lse, do)
    assert torch.equal(a, b)


def _within_one_ulp(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Elementwise at most one bf16 step apart, wherever the values stand
    above f32 summation noise (2^-12 of the largest |value|)."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    ok = ((a - b).abs() <= ulp) | (big < 2.0 ** -12 * big.max())
    return bool(ok.all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1370, 16, 64), (3, 130, 5, 32)])
def test_backward_kernels_repeat(shape, card, monkeypatch):
    """K3 gives the same bits twice. K2's dk and dv too; its dq is summed
    by bulk reductions that land in another order from run to run, so it
    may move by one bf16 step."""
    qkv, o, lse, do = _bwd_case(*shape, seed=6, card=card)
    runs = {}
    for fused in (True, False):
        monkeypatch.setattr(fa, "_BWD_FUSED", fused)
        runs[fused] = [fa.flash_attention_qkv_backward(qkv, o, lse, do)
                       for _ in range(2)]
    assert torch.equal(*runs[False])
    (dq0, dk0, dv0), (dq1, dk1, dv1) = (r.unbind(2) for r in runs[True])
    assert torch.equal(dk0, dk1) and torch.equal(dv0, dv1)
    assert _within_one_ulp(dq0, dq1)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K3"])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (3, 130, 5, 32)])
def test_backward_kernels_take_a_broadcast_grad(shape, fused, card,
                                                monkeypatch):
    """A dO with a zero stride (autograd's gradient of a sum) is copied
    once for TMA and gives the plain backward's gradient."""
    monkeypatch.setattr(fa, "_BWD_FUSED", fused)
    qkv, o, lse, do = _bwd_case(*shape, seed=7, card=card)
    row = do[:, :1].expand_as(do)
    assert not fa._tma_ok(row)
    dqkv = fa.flash_attention_qkv_backward(qkv, o, lse, row)
    ref = fa.flash_attention_bwd_reference(*qkv.unbind(2), o, lse, row)
    for name, got, want in zip("qkv", dqkv.unbind(2), ref):
        assert _rel_err(got, want) <= BWD_TOL, (name, _rel_err(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (3, 130, 5, 32)])
def test_prep_and_convert_kernels_match_plain(shape, card):
    """The preparation kernel's padded LSE2 and delta against
    ``bwd_prep_reference`` (+inf and 0 past N), and K2's dq against the
    conversion's plain version applied to the accumulator the kernels
    left: the same f32 values scaled and rounded, so the same bits."""
    qkv, o, lse, do = _bwd_case(*shape, seed=8, card=card)
    q, k, v = qkv.unbind(2)
    dq, dk, dv = torch.empty_like(qkv).unbind(2)
    lse2, delta, acc = fa._launch_bwd(q, k, v, o, lse, do, dq, dk, dv,
                                      fused=True)
    torch.cuda.synchronize()
    want_lse2, want_delta, _ = fa.bwd_prep_reference(o, do, lse, fused=True)
    n = shape[1]
    assert lse2.shape == want_lse2.shape == (shape[0], shape[2],
                                             fa.padded_rows(n))
    assert torch.isinf(lse2[..., n:]).all() and (lse2[..., n:] > 0).all()
    assert (delta[..., n:] == 0).all()
    torch.testing.assert_close(lse2[..., :n], want_lse2[..., :n],
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(delta, want_delta, rtol=1e-4, atol=1e-4)
    scale = shape[3] ** -0.5
    assert torch.equal(dq, fa.bwd_convert_reference(acc, n, scale,
                                                    torch.bfloat16))


@pytest.mark.cuda
def test_backward_takes_a_non_contiguous_grad(card, monkeypatch):
    """dO with a transposed layout (and a broadcast one) is read or copied,
    never refused, and gives the gradient of the contiguous dO."""
    monkeypatch.setattr(fa, "_BWD_FUSED", True)
    qkv, o, lse, do = _bwd_case(1, 70, 2, 64, seed=3, card=card)
    want = fa.flash_attention_qkv_backward(qkv, o, lse, do)
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
    got = fa.flash_attention_qkv_backward(qkv, o, lse, do_t)
    assert _rel_err(got, want) <= 1e-2
    row = do[:, :1].expand_as(do)
    got = fa.flash_attention_qkv_backward(qkv, o, lse, row)
    want = fa.flash_attention_qkv_backward(qkv, o, lse, row.contiguous())
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_backward_rejects_what_it_does_not_take(card):
    qkv, o, lse, do = _bwd_case(1, 16, 2, 64, seed=0, card=card)
    q, k, v = qkv.unbind(2)
    dq, dk, dv = torch.empty_like(qkv).unbind(2)
    scratch = torch.zeros(q.shape, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_bwd_split(q, k, v, o, lse, do.half(), dq, dk, dv)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_fused(q, k, v, o, lse, do.cpu(), dq, dk, dv)
    misaligned = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                             device=card)[1:].view(q.shape)
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention_bwd_split(q, k, v, o, lse, do, misaligned, dk,
                                     dv)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_split(q, k, v, o, lse.transpose(1, 2), do,
                                     dq, dk, dv)
    # dq is the bf16 view for both kernels; K2's f32 scratch is the
    # wrapper's own.
    with pytest.raises(ValueError, match="bfloat16"):
        fa._launch_bwd(q, k, v, o, lse, do, scratch, dk, dv, fused=True)
    # q, k and v are read by TMA as they are: a broadcast one is refused.
    before = fa.flash_attention_bwd_fused.launches
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_bwd_fused(q, k[:, :1].expand_as(k), v, o, lse,
                                     do, dq, dk, dv)
    assert fa.flash_attention_bwd_fused.launches == before


def _vitt_grads(card, plain: bool, dtype=torch.bfloat16):
    """Gradients of a SiLog-like loss of the vitt model on the card."""
    model = tda.build_depth_model("vitt", dtype=dtype, device=card,
                                  seed=0).train()
    gen = torch.Generator(device=card).manual_seed(2)
    img = torch.randn((2, 56, 70, 3), generator=gen, device=card)
    tattn.set_force_plain(plain)
    try:
        pred = model(img)
    finally:
        tattn.set_force_plain(False)
    loss = torch.log(pred + 1e-3).square().mean()
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_every_qkv_parameter_gets_a_gradient_on_the_kernels(card):
    """The attention backward goes through K2: every attn.qkv weight and
    bias gets a finite, non-zero gradient (a non-differentiable kernel
    call would leave them at None)."""
    before = fa.flash_attention_bwd_fused.launches
    grads = _vitt_grads(card, plain=False)
    assert fa.flash_attention_bwd_fused.launches == before + 4
    qkv = {n: g for n, g in grads.items() if ".attn.qkv." in n}
    assert len(qkv) == 8
    for name, g in qkv.items():
        assert g is not None, name
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


@pytest.mark.cuda
def test_vitt_gradients_on_kernels_match_plain_attention(card):
    """The flattened gradient of the model on K1/K2 against the same model
    on the plain attention, both bf16, with the plain bf16 gradient's own
    distance from f32 as the yardstick."""
    def flat(grads):
        return torch.cat([g.flatten() for n, g in sorted(grads.items())
                          if g is not None and "mask_token" not in n])

    kernel = flat(_vitt_grads(card, plain=False))
    plain = flat(_vitt_grads(card, plain=True))
    f32 = flat(_vitt_grads(card, plain=True, dtype=torch.float32))
    d_kf = (kernel - f32).norm() / f32.norm()
    d_pf = (plain - f32).norm() / f32.norm()
    cos = torch.nn.functional.cosine_similarity(kernel, f32, dim=0)
    assert d_kf <= 1.5 * d_pf + 1e-3, (d_kf.item(), d_pf.item())
    assert cos >= 0.99, cos.item()


def _vitt_train(card, plain: bool, fused: bool = True):
    """Two optimizer steps of a vitt DepthTask on the card (bf16, gradient
    checkpointing, accum 2): losses, final parameters, launch counts."""
    import numpy as np

    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask

    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, 2, 2, 56, 70, 3)).astype(np.float32)
    depths = rng.uniform(0.5, 18.0, (2, 2, 2, 56, 70)).astype(np.float32)
    task = DepthTask("vitt", encoder_lr=1e-4, decoder_lr=1e-4,
                     div_factor=25.0, total_steps=2, grad_accum=2,
                     device=card)
    state = task.init_state(0)
    counts = (fa.flash_attention.launches,
              fa.flash_attention_bwd_fused.launches,
              fa.flash_attention_bwd_split.launches)
    tattn.set_force_plain(plain)
    fa._BWD_FUSED, knob = fused, fa._BWD_FUSED
    try:
        losses = []
        for s in range(2):
            state, m = task.train_step(state, {"image": images[s],
                                               "depth": depths[s]})
            losses.append(m["loss"].item())
    finally:
        tattn.set_force_plain(False)
        fa._BWD_FUSED = knob
    launches = tuple(after - before for after, before in zip(
        (fa.flash_attention.launches, fa.flash_attention_bwd_fused.launches,
         fa.flash_attention_bwd_split.launches), counts))
    return losses, state.model.state_dict(), launches


def _vitt_train_init(card):
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.depth_task import DepthTask

    return DepthTask("vitt", device=card).init_state(0).model.state_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K3"])
def test_vitt_train_step_on_kernels_matches_plain_attention(card, fused):
    """Two DepthTask steps on K1 and K2 (or K3) against the same steps on
    the plain attention: 4 blocks x 2 chunks x 2 steps = 16 backward
    launches, twice as many K1 (forward and recompute); losses within bf16
    rounding (5e-2 relative at random weights); parameters finite and
    moved by both. (The gradients themselves are compared in
    ``test_vitt_gradients_on_kernels_match_plain_attention``: Adam's
    sign-like first steps would hide their difference here.)"""
    losses, params, launches = _vitt_train(card, plain=False, fused=fused)
    assert launches == ((32, 16, 0) if fused else (32, 0, 16))
    p_losses, p_params, p_launches = _vitt_train(card, plain=True)
    assert p_launches == (0, 0, 0)
    assert all(torch.isfinite(torch.tensor(losses)))
    for a, b in zip(losses, p_losses):
        assert abs(a - b) <= 5e-2 * abs(b), (losses, p_losses)
    init = _vitt_train_init(card)
    for k, v in params.items():
        assert torch.isfinite(v).all(), k
    moved = [k for k in params if not torch.equal(params[k], init[k])]
    p_moved = [k for k in params if not torch.equal(p_params[k], init[k])]
    assert moved == p_moved and len(moved) >= len(params) - 1


# --------------------------------------- K1, K4, K5: forward schedules

VARIANTS = {
    "K1": lambda q, k, v: flash_attention(q, k, v),  # the knobs are off
    "K4": lambda q, k, v: fa.flash_attention_pair(q, k, v),
    "K5_pipe": lambda q, k, v: fa.flash_attention_heads(q, k, v, pipe=True),
    "K5_hloop": lambda q, k, v: fa.flash_attention_heads(q, k, v,
                                                         pipe=False),
}


def _variant_counter(name):
    return {"K1": flash_attention, "K4": fa.flash_attention_pair}.get(
        name, fa.flash_attention_heads)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(8, 1370, 16, 64), (8, 1370, 24, 64),
                                   (2, 130, 3, 32), (3, 50, 4, 64),
                                   (1, 37, 2, 32)])
def test_forward_variants_match_plain_and_k1(shape, variant, card):
    """K1, K4 and K5 (both schedules) against the plain version, and K4
    and K5 against K1: the same function, but K1 sums in another order
    (its softmax scales each score by one fma and takes ex2.approx; K4's
    tiles are 64 queries), so not the same bits. All round O to bf16 from
    f32 sums: O within max|O_K1| / 64 (two to four bf16 steps of the
    largest output), LSE within 1e-3. The shapes cover vitl's, vitg's (24
    heads, B*H = 192 for K5's head blocks and K4's pairs), D 32, a ragged
    N shorter than a tile, and an odd H whose head pairs straddle batch
    rows (2, 130, 3, 32)."""
    q, k, v = _packed_qkv(*shape, seed=sum(shape) + 7, card=card)
    counter = _variant_counter(variant)
    before = counter.launches
    o, lse = VARIANTS[variant](q, k, v)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ro, rlse = flash_attention_reference(q, k, v)
    assert o.shape == q.shape and lse.shape == (shape[0], shape[2], shape[1])
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3
    o1, lse1 = flash_attention(q, k, v)
    k1_tol = o1.float().abs().max().item() / 64
    assert (o.float() - o1.float()).abs().max().item() <= k1_tol
    assert (lse - lse1).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(8, 1370, 16, 64), (2, 130, 3, 32)])
def test_forward_variants_repeat(shape, variant, card):
    """K1, K4 and K5 give the same bits from call to call: every sum has
    one order (no atomics)."""
    q, k, v = _packed_qkv(*shape, seed=sum(shape) + 8, card=card)
    o0, lse0 = VARIANTS[variant](q, k, v)
    o1, lse1 = VARIANTS[variant](q, k, v)
    assert torch.equal(o0, o1) and torch.equal(lse0, lse1)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_variants_refuse_views_tma_cannot_read(variant, card):
    """K1, K4 and K5 read q, k and v only by TMA: a broadcast k (a zero
    stride) raises, naming its strides, and nothing launches, neither the
    kernel nor K1."""
    q, k, v = _packed_qkv(2, 70, 4, 64, seed=4, card=card)
    counts = (_variant_counter(variant).launches, flash_attention.launches)
    with pytest.raises(ValueError, match=r"k \(strides .*TMA"):
        VARIANTS[variant](q, k[:, :1].expand_as(k), v)
    assert (_variant_counter(variant).launches,
            flash_attention.launches) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K3"])
@pytest.mark.parametrize("shape", [(8, 1370, 16, 64), (2, 130, 3, 32),
                                   (1, 37, 2, 64)])
def test_default_forward_feeds_both_backwards(shape, fused, card,
                                              monkeypatch):
    """FlashAttentionQKV on K1 and K2 (or K3) against the plain backward
    of the plain forward: K1's LSE drives either backward to the plain
    gradient, within the backward's tolerance."""
    gen = torch.Generator(device=card).manual_seed(12)
    qkv = torch.randn((shape[0], shape[1], 3, *shape[2:]), generator=gen,
                      device=card, dtype=torch.bfloat16)
    do = torch.randn(shape, generator=gen, device=card, dtype=torch.bfloat16)
    monkeypatch.setattr(fa, "_BWD_FUSED", fused)
    counter = (fa.flash_attention_bwd_fused if fused
               else fa.flash_attention_bwd_split)
    before = (flash_attention.launches, counter.launches)
    x = qkv.clone().requires_grad_(True)
    fa.flash_attention_qkv(x).backward(do)
    assert (flash_attention.launches, counter.launches) == \
        (before[0] + 1, before[1] + 1)
    q, k, v = qkv.unbind(2)
    ro, rlse = flash_attention_reference(q, k, v)
    ref = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do)
    for name, g, w in zip("qkv", x.grad.unbind(2), ref):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


@pytest.mark.cuda
def test_head_block_and_odd_pairs(card, monkeypatch):
    """K5 takes the JAX rule's two heads per block at vitl's 518 px; K4
    refuses an odd B*H, and under the pair knob an odd B*H runs K1."""
    assert fa.head_block(8 * 16, 1370, 64) == 2
    q, k, v = _packed_qkv(1, 40, 3, 64, seed=9, card=card)
    with pytest.raises(ValueError, match="odd"):
        fa.flash_attention_pair(q, k, v)
    monkeypatch.setattr(fa, "_PAIR", True)
    counts = (flash_attention.launches, fa.flash_attention_pair.launches)
    flash_attention(q, k, v)
    assert (flash_attention.launches, fa.flash_attention_pair.launches) == \
        (counts[0] + 1, counts[1])


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["_PAIR", "_PIPE", "_HLOOP"])
def test_knobs_dispatch_the_forward(knob, card, monkeypatch):
    monkeypatch.setattr(fa, knob, True)
    q, k, v = _packed_qkv(2, 70, 4, 64, seed=2, card=card)
    counter = fa.flash_attention_pair if knob == "_PAIR" else \
        fa.flash_attention_heads
    counts = (flash_attention.launches, counter.launches)
    flash_attention(q, k, v)
    assert (flash_attention.launches, counter.launches) == \
        (counts[0], counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["_PAIR", "_PIPE", "_HLOOP"])
@pytest.mark.parametrize("shape", [(8, 1370, 16, 64), (2, 130, 3, 32)])
def test_pair_forward_feeds_the_backward(shape, knob, card, monkeypatch):
    """FlashAttentionQKV with K4 (or K5, pipelined or looped) forward and
    K2 backward gives K1 + K2's dqkv: each forward's LSE drives the
    backward."""
    gen = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn((shape[0], shape[1], 3, *shape[2:]), generator=gen,
                      device=card, dtype=torch.bfloat16)
    do = torch.randn(shape, generator=gen, device=card, dtype=torch.bfloat16)
    monkeypatch.setattr(fa, "_BWD_FUSED", True)

    def grads(on: bool):
        monkeypatch.setattr(fa, knob, on)
        x = qkv.clone().requires_grad_(True)
        fa.flash_attention_qkv(x).backward(do)
        return x.grad

    counter = fa.flash_attention_pair if knob == "_PAIR" else \
        fa.flash_attention_heads
    before = (counter.launches, flash_attention.launches)
    got = grads(True)
    assert (counter.launches, flash_attention.launches) == \
        (before[0] + 1, before[1])
    want = grads(False)
    for name, g, w in zip("qkv", got.unbind(2), want.unbind(2)):
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


# ------------------------------------------------ K6: bilinear lerp resize

DPT_RESIZES = [((8, 256, 19, 19), (37, 37)), ((8, 256, 37, 37), (74, 74)),
               ((8, 256, 74, 74), (148, 148)),
               ((8, 256, 148, 148), (296, 296)),
               ((8, 128, 296, 296), (518, 518))]
# vitg's: the fusion upsamples at 384 channels, the head's at 192.
VITG_RESIZES = [((8, 384, 19, 19), (37, 37)), ((8, 384, 37, 37), (74, 74)),
                ((8, 384, 74, 74), (148, 148)),
                ((8, 384, 148, 148), (296, 296)),
                ((8, 192, 296, 296), (518, 518))]


def _ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """At most one ulp of want's dtype apart, element by element."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    diff = (got.float() - want.float()).abs()
    return bool((diff <= want.float().abs() * 2.0 ** -mant + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,out_hw", DPT_RESIZES + VITG_RESIZES + [
    ((2, 128, 20, 30), (20, 61)), ((2, 128, 33, 17), (16, 17)),
    ((1, 128, 9, 9), (4, 25)), ((2, 384, 33, 40), (16, 77)),
    ((1, 128, 40, 300), (41, 517)), ((1, 12, 9, 9), (5, 17)),
    ((2, 12, 33, 9), (16, 20))])
def test_lerp_resize_matches_plain(shape, out_hw, dtype, card):
    """K6 on channels-last memory, the decoder's, against the plain
    version: vitl's and vitg's decoder resizes, one axis unchanged,
    align-corners downscales (rows no output reads are not staged), 517
    columns that no span divides, and 12 channels (a pixel of 24 bytes in
    bf16: the one-element path; 48 in f32: the vector path)."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tres

    gen = torch.Generator(device=card).manual_seed(shape[2])
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    before = tres.lerp_resize.launches
    with torch.no_grad():
        y = tres.lerp_resize(x, out_hw)
    torch.cuda.synchronize()
    assert tres.lerp_resize.launches == before + 1
    assert y.shape == (*shape[:2], *out_hw) and y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _ulp_ok(y, tres.lerp_resize_reference(x, out_hw))


@pytest.mark.cuda
def test_lerp_resize_dispatch_and_refusals(card, monkeypatch):
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tres

    x = torch.randn((1, 128, 6, 6), device=card, dtype=torch.bfloat16)
    monkeypatch.setattr(tres, "_PALLAS_RESIZE", True)
    before = tres.lerp_resize.launches
    with torch.no_grad():
        tres.resize_align_corners(x, (11, 11), channels_last=False)
        nhwc = tres.resize_align_corners(x.permute(0, 2, 3, 1), (11, 11))
        tres.resize_align_corners(x[:, :1], (11, 11), channels_last=False)
    assert tres.lerp_resize.launches == before + 2
    assert torch.equal(nhwc.permute(0, 3, 1, 2),
                       tres.lerp_resize(x, (11, 11)))
    with pytest.raises(RuntimeError, match="not differentiable"):
        tres.lerp_resize(x.float().requires_grad_(True), (11, 11))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tres.lerp_resize(x.half(), (11, 11))
    # Another layout is copied into channels-last memory for the kernel.
    xt = x.transpose(2, 3)
    with torch.no_grad():
        y = tres.lerp_resize(xt, (11, 11))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, tres.lerp_resize(
        xt.contiguous(memory_format=torch.channels_last), (11, 11)))
    assert _ulp_ok(y, tres.lerp_resize_reference(xt, (11, 11)))


@pytest.mark.cuda
@pytest.mark.parametrize("opt_out", [False, True])
def test_decoder_takes_k6_unless_recorded(opt_out, card, monkeypatch):
    """A vitl forward on the card launches K6 at its five decoder resizes
    when autograd does not record it, none when it does (a training
    forward keeps the matmul resize, K6 having no backward), and none
    under the opt-out (``E3D_PALLAS_RESIZE=0``, through its module
    flag)."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tres

    monkeypatch.setattr(tres, "_PALLAS_RESIZE", False)
    monkeypatch.setattr(tres, "_NO_PALLAS_RESIZE", opt_out)
    model = tda.build_depth_model("vitl", device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    img = torch.rand((2, 56, 70, 3), generator=gen, device=card)
    before = tres.lerp_resize.launches
    with torch.no_grad():
        served = model(img)
    torch.cuda.synchronize()
    assert tres.lerp_resize.launches == before + (0 if opt_out else 5)
    before = tres.lerp_resize.launches
    trained = model(img)
    trained.float().mean().backward()
    torch.cuda.synchronize()
    assert tres.lerp_resize.launches == before
    assert served.shape == trained.shape == (2, 56, 70)
    assert bool(served.isfinite().all())
    grads = [p.grad for p in model.depth_head.parameters()]
    assert all(g is not None and bool(g.isfinite().all()) for g in grads)


@pytest.mark.cuda
def test_pose_train_step_on_card_matches_cpu(card):
    """One ``PoseTask.train_step`` ('32-true', TF32 off, dropout off) from
    the same weights and batch on the card and on the CPU. cuDNN and the
    CPU's convolutions sum in other orders: the loss within 1e-4
    relative; the clipped gradient (all parameters) within 1e-2 in
    relative norm (BatchNorm's backward reduces in f32 on the card and in
    f64 on the CPU, and random weights amplify the difference: 4.1e-3 on
    this batch, where TF32 puts the card's gradient 0.1 from an f64 one,
    as ``chip_smoke.py``'s pose parity phase prints); the running
    statistics within 1e-4 relative and 1e-5 absolute. Adam's
    first step moves every element by about +-lr, so the parameters agree
    to 2 lr (an element whose gradient is at rounding level may go either
    way) and at most 1% of them differ by more than 1e-6 lr; then the
    eval-mode poses of the updated nets within 1e-3."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.train.pose_task import PoseTask

    gen = torch.Generator().manual_seed(0)
    batch = {"input": torch.randn((8, 8, 64, 64), generator=gen),
             "target": torch.randn((8, 7), generator=gen)}
    args = dict(dropout=False, cycle_momentum=True, total_steps=10)
    cpu_task = PoseTask(device="cpu", **args)
    cpu = cpu_task.init_state(seed=0)
    gpu_task = PoseTask(device=card, **args)
    gpu = gpu_task.init_state(weights={
        k: v.clone() for k, v in cpu.model.state_dict().items()})
    tf32 = torch.backends.cudnn.allow_tf32
    cpu, cpu_m = cpu_task.train_step(cpu, batch)
    gpu, gpu_m = gpu_task.train_step(gpu, batch)
    assert torch.backends.cudnn.allow_tf32 == tf32  # restored
    _, cpu_pred = cpu_task.eval_step(cpu, batch)
    _, gpu_pred = gpu_task.eval_step(gpu, batch)
    assert abs(gpu_m["loss"].item() - cpu_m["loss"].item()) <= \
        1e-4 * abs(cpu_m["loss"].item())
    g_cpu = torch.cat([p.grad.flatten() for p in cpu.model.parameters()])
    g_gpu = torch.cat([p.grad.flatten().cpu()
                       for p in gpu.model.parameters()])
    assert (g_gpu - g_cpu).norm() <= 1e-2 * g_cpu.norm()
    lr0 = float(cpu_task.lr_table()[0])
    flipped = total = 0
    for (name, p_cpu), p_gpu in zip(cpu.model.named_parameters(),
                                    gpu.model.parameters()):
        diff = (p_gpu.detach().cpu() - p_cpu.detach()).abs()
        assert diff.max().item() <= 2.0 * lr0 * 1.01 + 1e-7, name
        flipped += int((diff > 1e-6 * lr0 + 1e-8).sum())
        total += diff.numel()
    assert flipped <= 0.01 * total, (flipped, total)
    sd_cpu, sd_gpu = cpu.model.state_dict(), gpu.model.state_dict()
    for key in sd_cpu:
        if key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sd_gpu[key].cpu(), sd_cpu[key],
                                       rtol=1e-4, atol=1e-5, msg=key)
    assert (gpu_pred.cpu() - cpu_pred).abs().max().item() <= 1e-3


def _sphere_cloud(n=20000, seed=3):
    import numpy as np

    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


@pytest.mark.cuda
def test_backproject_and_voxel_grid_on_card_match_cpu(card):
    """Reconstruction's device work on the card against the CPU: the same
    points to 1e-6 (both divide as IEEE division), the same masks and
    colours, and the same voxel averages."""
    import numpy as np

    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch import recon

    rng = np.random.default_rng(0)
    depth = torch.from_numpy(rng.integers(0, 4000, (475, 475)).astype(
        np.int32))
    color = torch.from_numpy(rng.integers(0, 256, (475, 475, 3),
                                          dtype=np.uint8))
    q = rng.normal(size=4)
    mat = recon.pose_to_matrix(torch.tensor(rng.normal(size=3)),
                               torch.tensor(q / np.linalg.norm(q)))
    out = {}
    for dev in ("cpu", card):
        pts, cols, valid = recon.backproject_depth(
            depth.to(dev), 156.0, 156.0, 237.0, 237.0, color=color.to(dev),
            transform=mat.to(dev))
        vox = recon.voxel_downsample(pts[valid], 0.01, colors=cols[valid])
        out[str(dev)] = [t.cpu() for t in (pts, cols, valid, *vox[:2])]
    (p0, c0, v0, vp0, vc0), (p1, c1, v1, vp1, vc1) = out["cpu"], out["cuda"]
    assert torch.equal(v0, v1)
    torch.testing.assert_close(p1, p0, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(c1, c0, atol=1e-7, rtol=0)
    assert vp0.shape == vp1.shape and len(vp0) > 1000
    torch.testing.assert_close(vp1, vp0, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(vc1, vc0, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", ["0", "1"])
def test_poisson_mesh_on_card_matches_cpu(sparse, card, monkeypatch):
    """``poisson_mesh`` at grid depth 7 on the card against the CPU:
    vertex counts within 1%, every vertex within 0.05 of a grid spacing
    of the other mesh, both ways (the FFTs and the scatter-adds sum in
    other orders; f16 readback)."""
    from scipy.spatial import cKDTree

    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.recon import poisson

    monkeypatch.setenv("E3D_POISSON_SPARSE", sparse)
    pts = _sphere_cloud()
    cpu_v, cpu_t = poisson.poisson_mesh(pts, pts, grid_depth=7, device="cpu")
    gpu_v, gpu_t = poisson.poisson_mesh(pts, pts, grid_depth=7, device=card)
    assert len(cpu_v) > 1000 and gpu_t.max() < len(gpu_v)
    assert abs(len(gpu_v) - len(cpu_v)) <= 0.01 * len(cpu_v)
    spacing = float((pts.max(0) - pts.min(0)).max()) * 1.1 / 127
    assert cKDTree(cpu_v).query(gpu_v)[0].max() <= 0.05 * spacing
    assert cKDTree(gpu_v).query(cpu_v)[0].max() <= 0.05 * spacing


# ------------------------------------------- the speed dials (Q1, Q2)


def _rows(r, k, dtype, seed, card, scale=3.0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn((r, k), generator=gen, device=card) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,k", [(10960, 1024), (300, 4096), (17, 64),
                                 (3, 8192), (2, 37 * 37 * 256 + 64)])
def test_quantize_int8_matches_plain_bit_for_bit(r, k, dtype, card):
    """Q1 on token and weight rows (one block a row) and on long rows
    (a whole image of a decoder conv: two passes), per-row scales and a
    given frozen scale, with a strided row view."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant

    x = _rows(r, k, dtype, r + k, card)
    x[0] = 0  # the 1e-8 floor
    before = quant.quantize_int8.launches
    q, s = quant.quantize_int8(x)
    torch.cuda.synchronize()
    assert quant.quantize_int8.launches == before + 1
    rq, rs = quant.quantize_int8_reference(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    given = torch.tensor([2.5 / 127], device=card)
    q, s = quant.quantize_int8(x, given)
    assert torch.equal(q, quant.quantize_int8_reference(x, given)[0])
    assert s is given
    if k >= 16:
        view = x[:, 8:]  # rows at a stride of k, not k - 8
        assert torch.equal(quant.quantize_int8(view)[0],
                           quant.quantize_int8_reference(view)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("cast_first", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_int32_matches_plain_bit_for_bit(dtype, cast_first, card):
    """Q2 on a dense accumulator (per-row scales, bias) and on a strided
    crop of a padded conv accumulator (per-image scales, no bias)."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant

    gen = torch.Generator(device=card).manual_seed(7)
    acc = torch.randint(-2**22, 2**22, (10960, 3072), generator=gen,
                        device=card, dtype=torch.int32)
    xs = torch.rand(10960, generator=gen, device=card) * 1e-2
    ws = torch.rand(3072, generator=gen, device=card) * 1e-2
    bias = torch.randn(3072, generator=gen, device=card)
    before = quant.dequantize_int32.launches
    out = quant.dequantize_int32(acc, xs, ws, bias, dtype, cast_first)
    torch.cuda.synchronize()
    assert quant.dequantize_int32.launches == before + 1
    assert torch.equal(out, quant.dequantize_int32_reference(
        acc, xs, ws, bias, dtype, cast_first))
    crop = torch.randint(-2**22, 2**22, (8, 39, 39, 264), generator=gen,
                         device=card, dtype=torch.int32)[:, :37:2, :37:2,
                                                         :256]
    out = quant.dequantize_int32(crop, xs[:8], ws[:256], None, dtype)
    assert out.shape == (8, 19, 19, 256) and out.is_contiguous()
    assert torch.equal(out, quant.dequantize_int32_reference(
        crop, xs[:8], ws[:256], None, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,stride,padding", [
    ((2, 37, 37, 256), 3, 1, 1), ((2, 37, 37, 1024), 3, 2, 1),
    ((2, 19, 19, 256), 1, 1, 0)])
def test_int8_conv_accumulator_matches_f64_plain(shape, k, stride, padding,
                                                 card):
    """The tap form of the int8 conv (int_mm over row slices of the padded
    input, summed in int32) equals the f64 plain convolution exactly, and
    the whole int8 conv equals its CPU run."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant

    gen = torch.Generator(device=card).manual_seed(sum(shape))
    xq = torch.randint(-127, 128, shape, generator=gen, device=card,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (256, k, k, shape[3]), generator=gen,
                       device=card, dtype=torch.int8)
    acc = quant.conv_acc(xq, wq, stride, padding)
    assert torch.equal(acc, quant.conv_acc_reference(xq, wq, stride,
                                                     padding))
    x = torch.randn((shape[0], shape[3], *shape[1:3]), generator=gen,
                    device=card).to(memory_format=torch.channels_last)
    w = torch.randn((256, shape[3], k, k), generator=gen, device=card) * 0.05
    b = torch.randn(256, generator=gen, device=card)
    with torch.no_grad():
        got = quant.int8_conv(x.bfloat16(), w, b, stride, padding)
        want = quant.int8_conv(x.bfloat16().cpu(), w.cpu(), b.cpu(), stride,
                               padding)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_int_mm_transposed_operand_and_cpu_agree(card):
    """torch._int_mm on the card with mat2 as the transpose of a row-major
    (N, K) weight (the layout the port passes) and as a row-major (K, N)
    copy: both equal the CPU's int32 product."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant

    gen = torch.Generator(device=card).manual_seed(3)
    a = torch.randint(-127, 128, (300, 1024), generator=gen, device=card,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (768, 1024), generator=gen, device=card,
                      dtype=torch.int8)
    want = torch._int_mm(a.cpu(), w.cpu().t())
    assert torch.equal(quant.int_mm(a, w.t()).cpu(), want)
    assert torch.equal(quant.int_mm(a, w.t().contiguous()).cpu(), want)
    with pytest.raises(ValueError, match="M > 16"):
        quant.int_mm(a[:16], w.t())


@pytest.mark.cuda
def test_speed_dials_on_card(card):
    """vitl-width blocks are too big for a unit test: a vits model at 98
    px with both dials. The merged forward repeats bit for bit from call
    to call (the merge has no atomics); the int8 forward launches Q1 and
    Q2 once per site (twice Q1: weights and activations) and K1 once per
    block, and the quantized ops raise under autograd."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant

    model = tda.build_depth_model("vits", device="cuda", quant_int8=True,
                                  token_merge=0.3)
    x = torch.randn((2, 98, 98, 3), device=card,
                    generator=torch.Generator(device=card).manual_seed(0))
    q1, q2, k1 = (quant.quantize_int8.launches,
                  quant.dequantize_int32.launches, flash_attention.launches)
    with torch.no_grad():
        a = model(x)
        b = model(x)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    # vits: 12 blocks x (qkv, proj, fc1, fc2), and the DPT convs with both
    # widths >= 128: projects 2 and 3 (384 -> 192, 384) and the stride-2
    # resize (384 -> 384); features 64 keep the rest out.
    sites = 12 * 4 + 3
    assert quant.dequantize_int32.launches - q2 == 2 * sites
    assert quant.quantize_int8.launches - q1 == 2 * 2 * sites
    assert flash_attention.launches - k1 == 2 * 12
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)


# --------------------------------- the batched training augmentation

AUG_TOL = 1e-4


def _draws(seed, n, hw, scale_range=(0.1, 0.9)):
    """The fine-tuning recipe's augmentation draws for ``n`` images
    (``scale_range`` replaced), from a seeded CPU generator."""
    return taug.draw_augment_params(
        torch.Generator().manual_seed(seed), n, hw,
        taug.AugmentConfig(scale_range=scale_range))


def _check_augment(images, params):
    """The kernels against the plain per-image path on the same card.

    Tolerance ``AUG_TOL`` (1e-4) on the normalised output. Every multiply,
    add and divide of the kernels is an IEEE-rounded op of its own, as in
    the plain chain of PyTorch ops (no FMA contraction, no approximate
    divide), so the two differ only where sums are taken in another order:
    the contrast mean (a fixed-order sum of per-chunk partials against
    PyTorch's reduction over the flipped image) and a pixel's three gray
    products. A mean a few float32 ulps apart moves a pixel by at most
    |1 - contrast| <= 0.2 times that, and the HSV round trip is continuous
    in its input, so the outputs stay within a few ulps of 1 / std (about
    1e-6); 1e-4 leaves room above that and stays far below the 2e-4 that
    the plain path keeps from the JAX package. A filled pixel involves no
    sum at all and must be exact: (0 - mean) / std."""
    b, h, w, _ = images.shape
    before = taug.augment_kernel.launches
    got = taug.augment_kernel(images, params)
    torch.cuda.synchronize()
    assert taug.augment_kernel.launches == before + 2
    want = taug.apply_augment_reference(images, params)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.is_contiguous()
    assert (got - want).abs().max().item() <= AUG_TOL
    table = taug.augment_tables(params, b, h, w)
    n = b * taug._TABLE_HEADER
    rows = torch.from_numpy(table[n:n + b * h].reshape(b, h)).to(images.device)
    cols = torch.from_numpy(table[n + b * h:].reshape(b, w)).to(images.device)
    fill = (rows[:, :, None] < 0) | (cols[:, None, :] < 0)
    assert torch.equal(got[fill], want[fill])
    return got, fill


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(64, 518, 518), (7, 40, 50), (5, 1, 37)],
                         ids=["finetune", "40x50", "1-row"])
def test_augment_kernels_match_plain(b, h, w, card):
    gen = torch.Generator(device=card).manual_seed(h * w)
    # As after the bicubic resize: a little outside [0, 1].
    images = torch.rand((b, h, w, 3), generator=gen, device=card) * 1.1 - 0.05
    _check_augment(images, _draws(3170000000 + h * w, b, (h, w)))


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [True, False], ids=["all-flip", "no-flip"])
def test_augment_kernels_every_colour_order(flip, card):
    """The 24 orders of the four colour ops, one image each."""
    params = _draws(11, 24, (48, 56))
    params = params._replace(
        flip=torch.full((24,), flip),
        order=torch.tensor(list(itertools.permutations(range(4)))))
    gen = torch.Generator(device=card).manual_seed(12)
    images = torch.rand((24, 48, 56, 3), generator=gen, device=card)
    _check_augment(images, params)


@pytest.mark.cuda
def test_augment_kernels_mostly_fill(card):
    """Scale 0.1: about 99% of each output is the affine's fill."""
    params = _draws(13, 16, (96, 80), scale_range=(0.1, 0.1))
    gen = torch.Generator(device=card).manual_seed(14)
    images = torch.rand((16, 96, 80, 3), generator=gen, device=card)
    _, fill = _check_augment(images, params)
    assert fill.float().mean().item() > 0.95


@pytest.mark.cuda
def test_augment_kernels_repeat_bit_for_bit(card):
    params = _draws(15, 32, (518, 518))
    gen = torch.Generator(device=card).manual_seed(16)
    images = torch.rand((32, 518, 518, 3), generator=gen, device=card)
    first = taug.augment_kernel(images, params)
    again = taug.augment_kernel(images, params)
    assert torch.equal(first, again)
    # An image's mean does not depend on the batch it comes in.
    alone = taug.augment_kernel(images[5:6], taug.AugmentParams(
        *(p[5:6] for p in params)))
    assert torch.equal(alone[0], first[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_augment_dispatch_by_dtype(dtype, card):
    """Images on the card take the kernels whatever their dtype: float32
    runs them (two launches, its rows counted on ``augment.kernel_rows``);
    any other dtype is refused with a ValueError before any launch, and
    no row is counted on either path."""
    params = _draws(17, 3, (20, 26))
    images = torch.rand((3, 20, 26, 3), device=card).to(dtype)
    assert taug.takes_kernel(images)
    t0 = perf_counter_ns()
    before = taug.augment_kernel.launches
    kernel = dtype == torch.float32
    if kernel:
        got = taug.apply_augment(images, params)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and torch.isfinite(got).all()
    else:
        with pytest.raises(ValueError, match="float32"):
            taug.apply_augment(images, params)
    assert taug.augment_kernel.launches == before + 2 * kernel
    counted = {name: sum(c.n for c in debug.counts(name, t0))
               for name in ("augment.kernel_rows", "augment.plain_rows")}
    assert counted == {"augment.kernel_rows": 3 * kernel,
                       "augment.plain_rows": 0}


# ------------------------------------------- the kernels as torch ops


def _op_cases(card):
    """Each ``e3d::`` op's arguments on the card, with the plain version
    of the same call and the counter its launch adds to."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant as tq
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tres

    q, k, v = _packed_qkv(2, 130, 4, 64, seed=11, card=card)
    o, lse = flash_attention(q, k, v)
    gen = torch.Generator(device=card).manual_seed(12)
    do = torch.randn(q.shape, generator=gen, device=card,
                     dtype=torch.bfloat16)
    x6 = torch.randn((1, 128, 9, 9), generator=gen, device=card).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    rows = torch.randn((40, 256), generator=gen, device=card)
    acc = torch.randint(-2 ** 20, 2 ** 20, (40, 64), generator=gen,
                        device=card, dtype=torch.int32)
    xs = torch.rand(40, generator=gen, device=card)
    ws = torch.rand(64, generator=gen, device=card)
    return {
        "K1": (fa._fwd_op, (q, k, v, "K1"), flash_attention,
               lambda: flash_attention_reference(q, k, v)),
        "K4": (fa._fwd_op, (q, k, v, "K4"), fa.flash_attention_pair,
               lambda: flash_attention_reference(q, k, v)),
        "K5": (fa._fwd_op, (q, k, v, "K5 pipe"), fa.flash_attention_heads,
               lambda: flash_attention_reference(q, k, v)),
        "K2": (fa._bwd_op, (q, k, v, o, lse, do, True),
               fa.flash_attention_bwd_fused,
               lambda: torch.stack(fa.flash_attention_bwd_reference(
                   q, k, v, o, lse, do), 2)),
        "K3": (fa._bwd_op, (q, k, v, o, lse, do, False),
               fa.flash_attention_bwd_split,
               lambda: torch.stack(fa.flash_attention_bwd_reference(
                   q, k, v, o, lse, do), 2)),
        "K6": (tres._lerp_op, (x6, 17, 33), tres.lerp_resize,
               lambda: tres.lerp_resize_reference(x6, (17, 33))),
        "Q1": (tq._quantize_op, (rows, None), tq.quantize_int8,
               lambda: tq.quantize_int8_reference(rows)),
        "Q2": (tq._dequantize_op, (acc, xs, ws, None, torch.bfloat16,
                                   False), tq.dequantize_int32,
               lambda: tq.dequantize_int32_reference(acc, xs, ws, None,
                                                     torch.bfloat16)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["K1", "K4", "K5", "K2", "K3", "K6", "Q1",
                                  "Q2"])
def test_ops_launch_their_kernels(name, card):
    """Each op's CUDA kernel launches the kernel (one count on its public
    function) and agrees with the plain version: the attention within
    the tolerances above, K6 within one bf16 step, Q1 and Q2 bit for
    bit. Its fake implementation gives the real output's metadata."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, counter, plain = _op_cases(card)[name]
    before = counter.launches
    out = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = plain()
    got = out if isinstance(out, tuple) else (out,)
    want = want if isinstance(want, tuple) else (want,)
    if name in ("Q1", "Q2"):
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
    elif name == "K6":
        assert _ulp_ok(got[0], want[0])
    elif name in ("K2", "K3"):
        assert _rel_err(got[0], want[0]) <= BWD_TOL
    else:
        assert (got[0].float() - want[0].float()).abs().max() <= 2e-2
        assert (got[1] - want[1]).abs().max() <= 1e-3
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, g in zip(fake, got):
        assert (f.shape, f.dtype, f.stride()) == (g.shape, g.dtype,
                                                  g.stride()), name


@pytest.mark.cuda
def test_exported_replay_counts_its_launches(card, tmp_path):
    """A vitt program exported on the card replays through K1 (one launch
    a block, counted inside the op) and equals the live program."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.serving import export as texport

    model = tda.build_depth_model("vitt", 20.0, device=card)
    params = model.state_dict()
    path = str(tmp_path / "vitt.pt2")
    meta = texport.export_depth_program(model, params, path, (60, 80),
                                        batch_size=2, input_size=56)
    assert meta["platforms"] == ["cuda"] and meta["forward_schedule"] == "K1"
    prog = texport.load_exported(path)
    x = torch.rand((2, 60, 80, 3), generator=torch.Generator().manual_seed(
        0)).numpy()
    before = flash_attention.launches
    got = prog(params, x)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 4  # vitt: four blocks
    live = texport._program(model, tuple(meta["net_hw"]), (60, 80))(
        params, torch.from_numpy(x).to(card))
    assert type(live) is torch.Tensor and live.device.type == "cuda"
    assert (got - live).abs().max() <= 1e-3 * max(live.abs().max(), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(1702, 128), (437, 128), (6808, 32),
                                 (1702, 32)])
def test_temporal_attn_matches_plain(s, d, card):
    """``e3d::temporal_attn`` on the card (SDPA on the clip's strided
    views) against its plain version, at VDA-L's motion-module shapes
    (T = 32, 8 heads; D 128 at layer_3 and layer_4, 32 at path_4 and
    path_3): bf16 outputs within a few bf16 ulps of max |o|, one launch
    counted a call, bit for bit from call to call."""
    from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device=card).manual_seed(s + d)
    qkv = torch.randn((32, s, 3, 8, d), generator=gen, device=card,
                      dtype=torch.bfloat16)
    before = ta.temporal_attention.launches
    with torch.no_grad():
        got = ta.temporal_attention(qkv, 32)
        again = ta.temporal_attention(qkv, 32)
        want = ta.temporal_attention_reference(qkv, 32)
    assert ta.temporal_attention.launches == before + 2
    assert got.shape == (32, s, 8, d) and got.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale
    assert torch.equal(got, again)
