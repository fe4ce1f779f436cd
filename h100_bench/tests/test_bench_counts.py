"""counts.py against the kernel table's operations and bytes at vitl,
batch 8, 518 px (1370 tokens)."""

import json

import pytest

from h100_bench import counts
from h100_bench.tests.helpers import BENCH


def _cfg(name):
    with open(BENCH / "configs" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def test_k1_k2_k6_at_vitl_batch_8():
    cfg = _cfg("dav2-vitl")
    n = counts.tokens(cfg, (518, 518))
    assert n == 1370
    flops, nbytes = counts.attn_fwd_work(8, n, 16, 64)
    assert flops == pytest.approx(61.5e9, rel=1e-3)
    assert nbytes == pytest.approx(90.5e6, rel=1e-3)
    flops, nbytes = counts.attn_bwd_work(8, n, 16, 64)
    assert flops == pytest.approx(153.8e9, rel=1e-3)
    assert nbytes == pytest.approx(180.3e6, rel=1e-3)
    k6 = sum(counts.resize_work(*r)[1]
             for r in counts.dpt_resizes(cfg, (518, 518), 8))
    assert k6 == pytest.approx(1325e6, rel=1e-3)


@pytest.mark.parametrize("name,hw,encoder,decoder", [
    ("dav2-vitl", (518, 518), 1.0136e12, 0.2792e12),
    ("dav2-vitl", (518, 644), 1.3157e12, 0.3468e12),
    ("dav2-vitg", (518, 518), 3.5667e12, 0.9411e12),
])
def test_forward_flops(name, hw, encoder, decoder):
    cfg = _cfg(name)
    assert counts.encoder_flops(cfg, hw) == pytest.approx(encoder, rel=1e-3)
    assert counts.decoder_flops(cfg, hw) == pytest.approx(decoder, rel=1e-3)


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert counts.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    calls = [({}, 2.0), ({}, 2.0)]
    share = counts.roofline_share(calls, lambda a, r: (989e12, 0.0), None)
    assert share == pytest.approx(50.0)
    assert counts.roofline_share([], lambda a, r: (1, 1), None) is None
