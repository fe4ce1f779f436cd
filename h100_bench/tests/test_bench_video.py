"""The video cell's generator, check and readers on the CPU: a tiny Video
Depth Anything (vitt's trunk, motion modules at 64 and 32) behind the
engine's clip mode, two short procedures at a time, its final maps held
to the reference's windowed run."""

import json
import math
import time

import pytest
import torch

from h100_bench import calibrate_faults, counts_vda, harness, video
from h100_bench.tests.helpers import BENCH, ROOT, TINY_CONFIG, _metrics
from h100_bench.weights_vda import vda_layout

SEED = 2**33 + 11
TINY_VDA = {**TINY_CONFIG, "name": "tiny-vda", "out_channels": [16, 32, 64, 64],
            "temporal": {"heads": 8, "widths": [64, 64, 32, 32],
                         "max_len": 32},
            "window": 32}


def _spec(**traffic):
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        manifest = json.load(f)
    with open(BENCH / "traffic" / "video_backlog.json",
              encoding="utf-8") as f:
        base = json.load(f)
    with open(BENCH / "limits" / "vda-vitl-video-backlog.json",
              encoding="utf-8") as f:
        limits = json.load(f)
    base.update(frame_hw=[40, 52], pool=8, input_size=42,
                procedure_frames=60, ahead=40, warmup_windows=1,
                check_frames=30, check_procedures=2, grace_s=30,
                trace_slice_s=0.5, **traffic)
    return dict(cell=dict(name="tiny-video", chips=1), config=TINY_VDA,
                traffic=base, limits={**limits, "checked_frames_min": 30},
                **_metrics(manifest, "vda-vitl-video-backlog"))


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_layout_loads_into_the_port_strictly():
    """The published layout, less the encoding buffers and DAv2's unused
    unit, is the port's parameters one for one (the load is strict)."""
    model = video.build({"config": TINY_VDA}, SEED, "cpu")
    n_layout = sum(math.prod(s) for n, s, init in vda_layout(TINY_VDA)
                   if init != "pe" and "refinenet4.resConfUnit1" not in n)
    assert sum(p.numel() for p in model.parameters()) == n_layout


def test_video_cell_runs_and_checks_on_the_cpu():
    spec = _spec()
    res = video.run(spec, SEED, 4.0, False, "cpu", time.perf_counter())
    run = res.run
    assert res.correct, res.checks
    assert res.checks["checked_frames"]["value"] == 30
    assert res.checks["missing_frames"]["value"] == 0
    assert res.checks["map_rel_err"]["value"] < 0.05
    reqs = run.window.requests
    assert reqs and all(r.ok for r in reqs)
    # Every procedure's frames resolved in order of position.
    by_proc = {}
    for r in reqs:
        by_proc.setdefault(r.proc, []).append(r.pos)
    assert all(v == list(range(len(v))) for v in by_proc.values())
    assert harness.load_reader("served_fps")(run) > 0


@pytest.mark.parametrize("side", ["temporal_off", "control"])
def test_faults_and_control_fail_the_video_check(side):
    """The motion modules skipped, and the float8 control in place of the
    checked maps, come out not correct from the cell's own check, on its
    ``map_rel_err`` with every checked map in. (``no_carry`` moves the
    tiny model's maps too little to fail here: its 30 checked frames take
    one alignment, over a pool of 8 frames; it fails at vitl's size.)"""
    spec = _spec()
    with calibrate_faults.planted("" if side == "control" else side):
        res = video.run(spec, SEED, 4.0, False, "cpu", time.perf_counter())
    if side == "control":
        ok, checks = calibrate_faults.control_check({"_run": res.run}, SEED)
    else:
        ok, checks = res.correct, res.checks
    assert checks["checked_frames"]["value"] == 30
    assert checks["missing_frames"]["value"] == 0
    assert not ok
    err = checks["map_rel_err"]
    assert err["value"] > err["limit"], err


def test_video_readers_read_the_window():
    spec = _spec()
    res = video.run(spec, SEED, 3.0, True, "cpu", time.perf_counter())
    run = res.run
    assert run.extra["pre"]["units"] > 0
    got = {m["name"]: harness.load_reader(m["name"])(run)
           for m in spec["per_layer"]}
    assert got["mfu.video"] > 0
    assert 0 < got["carried_share.video"] < 100 * 10 / 32 + 1e-9
    assert got["stitch_ms.video"] > 0
    flops, nbytes = counts_vda.temporal_attn_work(64, 12, 8, 8, 32)
    assert flops == 4.0 * 2 * 12 * 8 * 32 * 32 * 8
    assert nbytes == 4 * 64 * 12 * 8 * 8 * 2


@pytest.mark.parametrize("seed", [0, 5, 6, 8])
def test_seeded_maps_are_live(seed):
    """The tiny reference's maps on seeds whose signed last conv left
    them zero on 80-99.9% of pixels: with that conv's weights taken in
    absolute value, every window's maps are positive nearly everywhere."""
    import numpy as np

    from h100_bench import loadgen
    from h100_bench.reference.dav2 import exact_f32
    from h100_bench.reference.vda import VDA
    from h100_bench.weights_vda import OUTPUT, make_vda_weights

    state = make_vda_weights(TINY_VDA, seed, "cpu")
    assert bool((state[OUTPUT] >= 0).all())
    ref = VDA(TINY_VDA, state)
    frames = loadgen.make_frames(seed, 8, (40, 52), "cpu")
    with exact_f32(), torch.no_grad():
        maps = ref.clip(ref.preprocess(torch.from_numpy(np.stack(frames)),
                                       42))
    assert float((maps == 0).float().mean()) < 0.05
