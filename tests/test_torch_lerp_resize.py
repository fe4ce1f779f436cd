"""Kernel K6's plain version (``lerp_resize_reference``, NCHW) against the
JAX package's Pallas lerp resize (``_lerp_resize_pallas``, NHWC) in
interpret mode; the kernel's tile plan (``_lerp_plan``) emulated in torch
and held bit for bit to the plain version; and the port's dispatch of
``resize_align_corners`` (``takes_lerp``: K6 on the card when autograd
does not record, the matmul resize otherwise and on the CPU).

Both blend in f32 with the same f32 weights (from f64 coordinates) and
round the H pass to the input dtype before the W pass. XLA's CPU compiler
contracts the JAX blend ``a w0 + b w1`` into a fused multiply-add for
part of the elements (about a fifth of them in f32, measured), which
skips one f32 rounding; the plain version, like K6, rounds both products.
A blend is a convex combination of the inputs, so every element is held
to one ulp of the dtype at the inputs' scale (max |x|). In bf16 the
skipped rounding flips the final rounding of 0.1-0.2% of the elements, so
at least 99% must agree bit for bit: a missing rounding of the H pass
would move far more. Shapes are small: the interpreter unrolls per output
row.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e3d_tpu  # noqa: F401
from e3d_tpu.ops import resize as jrs
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.ops import resize as trs

MANTISSA = {"bfloat16": 7, "float32": 23}


def _agrees(got: np.ndarray, want: np.ndarray, x: np.ndarray,
            dtype: str) -> bool:
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    exact = (diff == 0).mean() >= (0.99 if dtype == "bfloat16" else 0.0)
    return bool((diff <= np.abs(x).max() * 2.0 ** -MANTISSA[dtype]).all()
                and exact)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,out_hw", [
    ((1, 19, 19, 128), (37, 37)),   # the decoder's first upsample
    ((1, 12, 20, 128), (12, 41)),   # H unchanged: the W pass only
    ((1, 21, 17, 128), (10, 17)),   # a downsample, W unchanged
    ((2, 5, 6, 128), (9, 4)),       # up along H, down along W
])
def test_plain_version_matches_jax_kernel(shape, out_hw, dtype):
    rng = np.random.default_rng(sum(shape) + sum(out_hw))
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jrs._lerp_resize_pallas(
        jnp.asarray(x, getattr(jnp, dtype)), out_hw, interpret=True)
        .astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = trs.lerp_resize_reference(xt, out_hw)
    assert got.dtype == xt.dtype and got.shape == (shape[0], shape[3],
                                                   *out_hw)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert _agrees(got, want, x, dtype)
    # The CPU wrapper of K6 is its plain version.
    torch.testing.assert_close(trs.lerp_resize(xt.contiguous(), out_hw)
                               .permute(0, 2, 3, 1).float(),
                               torch.from_numpy(got), rtol=0, atol=0)


def test_taps_are_the_jax_taps():
    for n_in, n_out in ((19, 37), (296, 518), (7, 3), (1, 5), (5, 1)):
        lo, w0, w1 = trs._lerp_taps(n_in, n_out)
        jlo, jfrac = jrs._lerp_taps_static(n_in, n_out)
        assert lo.tolist() == list(jlo)
        np.testing.assert_array_equal(w1, np.float32(jfrac))
        np.testing.assert_array_equal(
            w0, (1.0 - np.asarray(jfrac)).astype(np.float32))


@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = trs.lerp_resize

    def fake(x, out_hw):
        calls.append(tuple(x.shape))
        return real(x, out_hw)

    monkeypatch.setattr(trs, "lerp_resize", fake)
    return calls


@pytest.mark.parametrize("knob", [True, False])
def test_dispatch_conditions(knob, spy, monkeypatch):
    """K6 under the knob on the JAX package's conditions (bilinear, 4-D,
    channels % 128 == 0, both input sides >= 2); else the matmul resize."""
    monkeypatch.setattr(trs, "_PALLAS_RESIZE", knob)
    g = torch.Generator().manual_seed(0)
    nchw = torch.randn((1, 128, 6, 7), generator=g).bfloat16()
    out = trs.resize_align_corners(nchw, (11, 13), channels_last=False)
    nhwc = trs.resize_align_corners(nchw.permute(0, 2, 3, 1), (11, 13))
    taken = [(1, 128, 6, 7)] * 2 if knob else []
    assert spy == taken
    if knob:
        want = trs.lerp_resize_reference(nchw, (11, 13))
        assert torch.equal(out, want)
        assert torch.equal(nhwc.permute(0, 3, 1, 2), want)
    spy.clear()
    for x, kw in ((nchw[:, :64], {"channels_last": False}),   # channels
                  (nchw[0], {"channels_last": False}),        # 3-D
                  (nchw[:, :, :1], {"channels_last": False}),  # H of 1
                  (nchw, {"channels_last": False, "method": "bicubic"})):
        got = trs.resize_align_corners(x, (5, 9), **kw)
        want = trs._apply_separable(x, trs._align_corners_matrix, (5, 9),
                                    kw.get("method", "bilinear"), False)
        assert torch.equal(got, want)
    assert spy == []


def test_no_backward_and_no_plain_version_off_the_cpu():
    x = torch.zeros((1, 128, 4, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        trs.lerp_resize(x, (7, 7))
    with torch.no_grad():
        assert trs.lerp_resize(x, (7, 7)).shape == (1, 128, 7, 7)
    meta = torch.empty((1, 128, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trs.lerp_resize(meta, (7, 7))


# ---------------------------------------------- K6's tiles, emulated in torch

def _emulate_tiles(x: torch.Tensor, out_hw: tuple[int, int],
                   plan) -> torch.Tensor:
    """K6's tiled computation on (N, C, H, W) ``x`` from its plan, as the
    kernel walks it. Per tile: (1) stage the band's source rows, each
    holding the tile's source columns alone, through a ring of
    ``plan.ring`` slots (a stage enters once every stage before it but
    ``ring - 1`` is dead, and a row reads only stages in the ring);
    (2) per output row, blend its two stages into an H row in x's dtype;
    (3) the W pass reads only the H rows, through the span's taps
    relative to the tile's first source column."""
    n, c, h, w = x.shape
    h2, w2 = out_hw
    nhwc = x.permute(0, 2, 3, 1)
    y = torch.full((n, h2, w2, c), float("nan"), dtype=x.dtype)
    written = torch.zeros((n, h2, w2), dtype=torch.int32)
    for t in range(plan.tiles):
        img, rows, cols, src, stages = plan.tile(t)
        assert 0 <= src.start < src.stop <= w
        assert src.stop - src.start <= plan.src_cols
        # (1) The ring, by stage index: which stages are resident when.
        ring, nxt = set(), stages.start
        for oy in range(rows.start, rows.stop):
            a = int(plan.first_stage[oy])
            b = a + int(plan.w1_y[oy] != 0)
            ring = {s for s in ring if s >= a}
            while nxt < stages.stop and nxt < a + plan.ring:
                ring.add(nxt)
                nxt += 1
            assert len(ring) <= plan.ring and a in ring and b in ring
        assert nxt == stages.stop
        staged = nhwc[img, torch.from_numpy(
            plan.stage_row[stages]).long(), src]
        # (2) The H rows.
        a = torch.from_numpy(plan.first_stage[rows] - stages.start).long()
        wy1 = torch.from_numpy(plan.w1_y[rows])[:, None, None]
        wy0 = torch.from_numpy(plan.w0_y[rows])[:, None, None]
        b = (a + (wy1[:, 0, 0] != 0).long())
        lo, hi = staged[a], staged[b]
        hrows = torch.where(wy1 == 0, lo, (lo.float() * wy0 + hi.float()
                                           * wy1).to(x.dtype))
        # (3) The W pass.
        lx = torch.from_numpy(plan.lo_x[cols] - src.start).long()
        wx0 = torch.from_numpy(plan.w0_x[cols])[None, :, None]
        wx1 = torch.from_numpy(plan.w1_x[cols])[None, :, None]
        assert bool((lx[wx1[0, :, 0] != 0] + 1 < hrows.shape[1]).all())
        lo = hrows[:, lx]
        hi = hrows[:, (lx + 1).clamp(max=hrows.shape[1] - 1)]
        y[img, rows, cols] = torch.where(
            wx1 == 0, lo, (lo.float() * wx0 + hi.float() * wx1).to(x.dtype))
        written[img, rows, cols] += 1
    assert bool((written == 1).all())  # every output once
    return y.permute(0, 3, 1, 2)


TILED_SHAPES = [
    # vitl's five decoder resizes, batch 1
    ((1, 256, 19, 19), (37, 37)), ((1, 256, 37, 37), (74, 74)),
    ((1, 256, 74, 74), (148, 148)), ((1, 256, 148, 148), (296, 296)),
    ((1, 128, 296, 296), (518, 518)),
    # vitg's 384- and 192-channel resizes
    ((1, 384, 148, 148), (296, 296)), ((1, 192, 296, 296), (518, 518)),
    # align-corners downscales: rows that no output reads are not staged
    ((2, 128, 33, 17), (16, 17)), ((1, 128, 9, 9), (4, 25)),
    # no span divides 517 output columns; one axis unchanged
    ((1, 128, 40, 300), (41, 517)), ((2, 128, 20, 30), (20, 61)),
    # 12 channels: the one-element path
    ((2, 12, 9, 9), (5, 17)),
]


@contextlib.contextmanager
def _one_thread():
    """The emulation runs thousands of small ops, the plain version a few
    large ones: both on one intra-op thread, so that test workers sharing
    the CPU do not contend for their threads (with eight threads each, a
    shape took minutes instead of a second)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,out_hw", TILED_SHAPES)
def test_tiled_plan_is_bit_equal_to_the_plain_version(shape, out_hw, dtype):
    """The kernel's tiles, ring and halo (``_lerp_plan`` at the shape's
    full width), emulated, give ``lerp_resize_reference`` bit for bit.
    Channels never mix, so the data holds at most 32 of them: the plan
    decides which rows and columns each tile reads, at the full width."""
    g = torch.Generator().manual_seed(sum(shape))
    n, c, h, w = shape
    x = torch.randn((n, min(c, 32), h, w), generator=g).to(dtype)
    plan = trs._lerp_plan(*shape, *out_hw, x.element_size())
    assert plan.tiles == n * plan.spans * plan.bands
    assert plan.smem <= trs._SMEM_PER_BLOCK
    assert plan.threads == 384 + (32 if plan.vec > 1 else 0)
    with _one_thread():
        got = _emulate_tiles(x, out_hw, plan)
        want = trs.lerp_resize_reference(x, out_hw)
    assert torch.equal(got, want)


def test_plan_stages_only_the_rows_read():
    """A downscale stages only the rows some output row reads; the
    decoder's widths fit the card's shared memory two blocks to an SM."""
    plan = trs._lerp_plan(2, 128, 33, 17, 16, 17, 2)
    lo, _, w1 = trs._lerp_taps(33, 16)
    read = set(lo.tolist()) | {int(r) + 1 for r, f in zip(lo, w1) if f}
    assert plan.stage_row.tolist() == sorted(read) and len(read) < 33
    for c, itemsize in ((128, 2), (256, 2), (384, 2), (192, 2), (384, 4)):
        for hw, out in ((19, 37), (148, 296), (296, 518)):
            p = trs._lerp_plan(8, c, hw, hw, out, out, itemsize)
            assert 2 * (p.smem + 1024) <= trs._SMEM_PER_SM, (c, hw, p.smem)
            assert p.grid <= min(p.tiles, 132 * 2)


@pytest.mark.parametrize("device,records,knob,want", [
    ("cuda", False, None, True),    # served, video, CLIs, validation
    ("cuda", True, None, False),    # a training forward: the matmul resize
    ("cpu", False, None, False),    # the CPU: the JAX package's default
    ("cpu", True, None, False),
    ("cuda", False, "0", False),    # the opt-out: the matmul resize
    ("cuda", False, "1", True),
    ("cpu", False, "1", True),      # the JAX knob: K6's plain version
])
def test_dispatch_rule(device, records, knob, want):
    shape = (8, 256, 37, 37)
    assert trs.takes_lerp(device, records, shape, "bilinear", False,
                          knob) is want
    assert trs.takes_lerp(device, records, (8, 37, 37, 256), "bilinear",
                          True, knob) is want
    # The JAX package's conditions hold whatever the device and knob.
    for bad, method, last in (((8, 64, 37, 37), "bilinear", False),
                              ((256, 37, 37), "bilinear", False),
                              ((8, 256, 1, 37), "bilinear", False),
                              (shape, "bicubic", False)):
        assert not trs.takes_lerp(device, records, bad, method, last, knob)


@pytest.mark.parametrize("flags,knob", [
    ({}, None), ({"_PALLAS_RESIZE": True}, "1"),
    ({"_NO_PALLAS_RESIZE": True}, "0")])
def test_module_flags_reach_the_rule(flags, knob, monkeypatch):
    """``_takes_lerp`` reads the knob from the module flags, and whether
    autograd records the call from the tensor and the grad mode."""
    seen = []
    monkeypatch.setattr(trs, "_PALLAS_RESIZE", False)
    monkeypatch.setattr(trs, "_NO_PALLAS_RESIZE", False)
    for k, v in flags.items():
        monkeypatch.setattr(trs, k, v)
    monkeypatch.setattr(trs, "takes_lerp",
                        lambda *args: seen.append(args) or False)
    x = torch.zeros((1, 128, 4, 4), requires_grad=True)
    trs.resize_align_corners(x, (7, 7), channels_last=False)
    with torch.no_grad():
        trs.resize_align_corners(x, (7, 7), channels_last=False)
    assert seen == [("cpu", True, (1, 128, 4, 4), "bilinear", False, knob),
                    ("cpu", False, (1, 128, 4, 4), "bilinear", False, knob)]
