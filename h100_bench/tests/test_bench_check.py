"""The check that decides ``correct``: the reference against the port, the
control, and runs with the served path broken underneath.

The tiny model stands in for vitl at a size a CPU test holds; it is held
to vitl-serve-backlog's limit. The port computes in bf16 on the CPU as on
the card, so a sound run's error is rounding's alone."""

import importlib

import numpy as np
import pytest
import torch

from h100_bench import harness, loadgen, serving
from h100_bench.reference.dav2 import DAv2, lower_bound_hw
from h100_bench.tests.helpers import TINY_CONFIG, tiny_spec
from h100_bench.weights import dav2_layout, make_weights

PORT = harness.PORT
SEED = 2**33 + 7


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _port_model(dtype):
    da = importlib.import_module(f"{PORT}.models.depth_anything")
    convert = importlib.import_module(f"{PORT}.models.convert")
    model = da.build_depth_model("vitt", device="cpu", dtype=dtype)
    return da, convert.load_dav2_state_dict(
        model, make_weights(TINY_CONFIG, SEED, "cpu"))


def test_layout_is_the_ports_state_dict_and_dav2s_unused_unit():
    _, model = _port_model(torch.float32)
    ours = {n: s for n, s, _ in dav2_layout(TINY_CONFIG)}
    port = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert {n: ours[n] for n in port} == port
    assert sorted(set(ours) - set(port)) == sorted(
        f"depth_head.scratch.refinenet4.resConfUnit1.{c}.{p}"
        for c in ("conv1", "conv2") for p in ("weight", "bias"))


@pytest.mark.parametrize("hw", [(70, 84), (61, 75)])
def test_reference_is_the_ports_served_path_in_f32(hw):
    da, model = _port_model(torch.float32)
    frames = torch.from_numpy(np.stack(loadgen.make_frames(SEED, 2, hw,
                                                           "cpu")))
    net = da._lower_bound_hw(*hw, 56)
    assert net == lower_bound_hw(*hw, 56)
    got = da._run_batched_u8(model, frames, net, hw)
    want = DAv2(TINY_CONFIG, make_weights(TINY_CONFIG, SEED, "cpu")
                ).depth_of_frames(frames, 56)
    assert float((got - want).abs().max()) < 1e-3


def test_control_fails_the_limit():
    limit = tiny_spec()["limits"]["map_rel_err"]
    state = make_weights(TINY_CONFIG, SEED, "cpu")
    frames = torch.from_numpy(np.stack(loadgen.make_frames(SEED, 8, (61, 75),
                                                           "cpu")))
    ref = DAv2(TINY_CONFIG, state).depth_of_frames(frames, 56)
    ctl = DAv2(TINY_CONFIG, state, fp8=True).depth_of_frames(frames, 56)
    spread = (ref - ref.mean(dim=(1, 2), keepdim=True)).abs().mean(dim=(1, 2))
    rel = serving.relative_error((ctl - ref).abs().mean(dim=(1, 2)).tolist(),
                                 spread.tolist())
    assert rel > 1.5 * limit


def _alter(runner_call):
    def call(self, frames):
        return [d + 1.0 for d in runner_call(self, frames)]
    return call


def _half(runner_call):
    def call(self, frames):
        half = runner_call(self, frames[:max(1, len(frames) // 2)])
        return [half[i % len(half)] for i in range(len(frames))]
    return call


@pytest.mark.parametrize("fault,generator", [
    (None, "closed_loop"), (None, "open_loop"),
    ("alter", "closed_loop"), ("half", "closed_loop"),
    ("alter", "open_loop")])
def test_a_run_with_the_served_path_broken_is_not_correct(
        monkeypatch, fault, generator):
    da = importlib.import_module(f"{PORT}.models.depth_anything")
    if fault:
        wrap = {"alter": _alter, "half": _half}[fault]
        monkeypatch.setattr(da.BatchedRunner, "__call__",
                            wrap(da.BatchedRunner.__call__))
    out = harness.run_cell(tiny_spec(generator), SEED, 1.0, False, "cpu")
    assert out["checks"]["checked_frames"]["value"] >= 8
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_a_short_vitl_run_on_the_card_is_correct(card):
    out = harness.run_cell(harness.cell_spec("vitl-serve-backlog"), SEED,
                           3.0, False, "cuda")
    assert out["correct"], out["checks"]
