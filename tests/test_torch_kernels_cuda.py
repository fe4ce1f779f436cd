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
(1e-3).
"""

import pytest
import torch

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.models import depth_anything as tda
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import attention as tattn
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)


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
                                   (1, 37, 2, 64), (3, 64, 5, 32)])
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
