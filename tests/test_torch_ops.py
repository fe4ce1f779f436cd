"""The kernels as ``torch.library`` ops (``e3d::*``), on the CPU.

``torch.library.opcheck`` runs each op's CPU kernel (its plain version)
against its schema, its fake implementation (shapes, dtypes and strides
of every output, dynamic shapes included) and its autograd registration,
at a tiny shape. The fake implementations also make the launches' checks
on CUDA views: under ``FakeTensorMode`` (no card needed) a view a kernel
refuses raises while tracing, as it would at the launch, so a bad view
fails at export and not at replay. The ops against their plain versions
on the card, and the counts a replay adds, are in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import flash_attention as fa
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import quant as tq
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as tres


def _t(*shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def _cases():
    q, k, v = (_t(1, 9, 2, 32, seed=i) for i in range(3))
    o, lse = fa.flash_attention_reference(q, k, v)
    do = _t(1, 9, 2, 32, seed=3)
    acc = torch.from_numpy(np.random.default_rng(4).integers(
        -1000, 1000, (6, 8), dtype=np.int32))
    return {
        "K1": (fa._fwd_op, (q, k, v, "K1")),
        "K4": (fa._fwd_op, (q, k, v, "K4")),
        "K5 pipe": (fa._fwd_op, (q, k, v, "K5 pipe")),
        "K5 hloop": (fa._fwd_op, (q, k, v, "K5 hloop")),
        "K2": (fa._bwd_op, (q, k, v, o.contiguous(), lse, do, True)),
        "K3": (fa._bwd_op, (q, k, v, o.contiguous(), lse, do, False)),
        "K6": (tres._lerp_op, (_t(2, 8, 5, 6, seed=5), 7, 3)),
        "K6 bf16": (tres._lerp_op, (_t(1, 4, 3, 9, seed=6,
                                       dtype=torch.bfloat16), 5, 9)),
        "Q1": (tq._quantize_op, (_t(5, 16, seed=7), None)),
        "Q1 frozen": (tq._quantize_op, (_t(5, 16, seed=8),
                                        torch.tensor([0.05]))),
        "Q2": (tq._dequantize_op, (acc, torch.rand(6), torch.rand(8),
                                   torch.rand(8), torch.bfloat16, True)),
        "Q2 per tensor": (tq._dequantize_op, (acc, torch.rand(1),
                                              torch.rand(8), None,
                                              torch.float32, False)),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_opcheck(name):
    op, args = _cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_cpu_kernels_are_the_plain_versions():
    """Through the ops, the public functions on CPU tensors give their
    plain versions (K6's output in channels-last memory)."""
    q, k, v = (_t(1, 9, 2, 32, seed=i) for i in range(3))
    for got, want in zip(fa.flash_attention(q, k, v),
                         fa.flash_attention_reference(q, k, v)):
        assert torch.equal(got, want)
    x = _t(1, 8, 5, 6, seed=9)
    y = tres.lerp_resize(x, (7, 3))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, tres.lerp_resize_reference(x, (7, 3)))
    assert tres.lerp_resize(x, (5, 6)) is x  # no pass, no op
    rows = _t(5, 16, seed=10)
    scale = torch.tensor([0.05])
    q8, s = tq.quantize_int8(rows, scale)
    assert s is scale
    assert torch.equal(q8, tq.quantize_int8_reference(rows, scale)[0])


def _fake_cuda(*shape, dtype=torch.bfloat16, strides=None):
    if strides is None:
        return torch.empty(shape, dtype=dtype, device="cuda")
    return torch.empty_strided(shape, strides, dtype=dtype, device="cuda")


@pytest.mark.parametrize("case,match", [
    ("broadcast k", "not a view TMA can read"),
    ("f32 q", "kernel takes bfloat16"),
    ("odd K4", "K4 pairs heads"),
    ("head dim 48", "head dim 48"),
    ("backward lse", "lse must be a contiguous"),
    ("K6 half", "float32 or bfloat16"),
    ("Q1 ragged rows", "whole 16-byte vectors"),
    ("Q2 scales", "row scales"),
])
def test_fake_implementations_check_cuda_views(case, match):
    """A traced CUDA view that its kernel refuses raises at trace time,
    with the launch's own message."""
    with FakeTensorMode():
        q = _fake_cuda(1, 16, 3, 64)
        calls = {
            "broadcast k": lambda: fa._fwd_op(
                q, _fake_cuda(1, 16, 3, 64, strides=(0, 192, 64, 1)), q,
                "K1"),
            "f32 q": lambda: fa._fwd_op(q.float(), q, q, "K1"),
            "odd K4": lambda: fa._fwd_op(q, q, q, "K4"),
            "head dim 48": lambda: fa._fwd_op(*[_fake_cuda(1, 16, 2, 48)]
                                              * 3, "K5 pipe"),
            "backward lse": lambda: fa._bwd_op(
                q, q, q, q, _fake_cuda(1, 16, 3, dtype=torch.float32), q,
                True),
            "K6 half": lambda: tres._lerp_op(
                _fake_cuda(1, 128, 4, 4, dtype=torch.half), 7, 7),
            "Q1 ragged rows": lambda: tq._quantize_op(
                _fake_cuda(4, 12), None),
            "Q2 scales": lambda: tq._dequantize_op(
                _fake_cuda(4, 8, dtype=torch.int32),
                _fake_cuda(3, dtype=torch.float32),
                _fake_cuda(8, dtype=torch.float32), None, torch.float32,
                False),
        }
        with pytest.raises(ValueError, match=match):
            calls[case]()


def test_fake_outputs_on_cuda_views():
    """The metadata a traced program sees: K1's (o, lse), the backward's
    packed dqkv, K6's channels-last output, Q1's int8 and scales."""
    with FakeTensorMode():
        qkv = _fake_cuda(2, 16, 3, 4, 64)
        q, k, v = qkv.unbind(2)
        o, lse = fa._fwd_op(q, k, v, "K1")
        assert (o.shape, o.dtype) == ((2, 16, 4, 64), torch.bfloat16)
        assert (lse.shape, lse.dtype) == ((2, 4, 16), torch.float32)
        dqkv = fa._bwd_op(q, k, v, o, lse, o, True)
        assert dqkv.shape == qkv.shape and dqkv.is_contiguous()
        y = tres._lerp_op(_fake_cuda(1, 128, 4, 4), 7, 9)
        assert y.shape == (1, 128, 7, 9)
        assert y.is_contiguous(memory_format=torch.channels_last)
        q8, s = tq._quantize_op(_fake_cuda(4, 16, dtype=torch.float32),
                                None)
        assert (q8.dtype, s.shape) == (torch.int8, (4,))
