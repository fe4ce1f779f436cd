"""The readers of the port's own spans and counts (``program_spans``):
only the window's part before the traced slice is read, a ring that
dropped an entry inside it gives None, and the means and the padding's
share are exact; then traced tiny runs report them as numbers."""

import importlib

import pytest
import torch

from h100_bench import harness, loadgen, program_spans
from h100_bench.tests.helpers import tiny_spec, tiny_train_spec

debug = importlib.import_module(f"{harness.PORT}.core.debug")

T0 = 100.0          # the window's start, perf_counter seconds
PRE = 2.0           # the window's seconds before the slice
S = 1_000_000_000   # nanoseconds a second


def _run(units: int = 2):
    return harness.Run({}, "cpu", 0.0, loadgen.Window(T0, T0 + 10.0),
                       extra={"pre": {"seconds": PRE, "units": units}})


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def rec(monkeypatch):
    r = debug.Recorder(capacity=64)
    monkeypatch.setattr(program_spans, "recorder", lambda: r)
    return r


def _spans(rec, name, *edges_s, device_ms=None):
    """Spans ``name`` over each (start, end) in seconds."""
    for k, (a, b) in enumerate(edges_s):
        rec.record(name, round(a * S), round(b * S))
        if device_ms is not None:
            rec.spans(name, round(a * S), round(b * S))[-1].device_ms = \
                device_ms[k]


# Spans that straddle the window's start or the slice's, or lie after it,
# beside two inside it of 2 and 4 ms.
STRADDLING = ((99.9, 100.01), (100.5, 100.502), (101.0, 101.004),
              (101.999, 102.003), (102.5, 102.6))


@pytest.mark.parametrize("metric, span", [
    ("upload_ms.serve", "runner.upload"),
    ("launch_ms.serve", "runner.launch"),
    ("readback_ms.serve", "runner.readback"),
    ("upload_ms.live", "runner.upload"),
    ("launch_ms.live", "runner.launch"),
    ("readback_ms.live", "runner.readback"),
    ("queue_wait_ms.live", "engine.queue"),
    ("collect_ms.live", "engine.collect"),
])
def test_a_mean_reads_the_spans_before_the_slice(rec, metric, span):
    _spans(rec, span, *STRADDLING)
    _spans(rec, "other", (100.1, 100.2))
    assert harness.load_reader(metric)(_run()) == pytest.approx(3.0,
                                                                abs=1e-9)


def test_pad_share_is_the_padded_rows_share(rec, monkeypatch):
    stamps = iter([99.0, 99.0, 100.1, 100.1, 100.2, 100.2, 100.3, 100.3,
                   102.5, 102.5])
    monkeypatch.setattr(debug, "perf_counter_ns",
                        lambda: round(next(stamps) * S))
    for rows, pad in ((8, 8), (8, 4), (8, 3), (8, 5), (8, 0)):
        rec.count("runner.rows", rows)
        rec.count("runner.padded_rows", pad)
    assert harness.load_reader("pad_share.live")(_run()) == 50.0


def test_preprocess_is_host_ms_a_step(rec):
    _spans(rec, "train.preprocess", (99.0, 99.5), (100.1, 100.2),
           (100.9, 101.05), (101.9, 102.1))
    assert harness.load_reader("preprocess_ms.train")(_run(units=2)) \
        == pytest.approx(125.0)


def test_optim_is_device_ms_a_step(rec):
    _spans(rec, "train.optimizer", (99.0, 99.1), (100.2, 100.21),
           (101.2, 101.21), (102.2, 102.21), device_ms=[50.0, 5.0, 7.0, 90])
    assert harness.load_reader("optim_ms.train")(_run()) == pytest.approx(6.0)
    # A span with no device time (a CPU run) gives none.
    _spans(rec, "train.optimizer", (101.5, 101.51))
    assert harness.load_reader("optim_ms.train")(_run()) is None


def test_drops_inside_the_interval_give_none(monkeypatch):
    small = debug.Recorder(capacity=4)
    monkeypatch.setattr(program_spans, "recorder", lambda: small)
    _spans(small, "runner.upload", (99.0, 99.1), (99.2, 99.3),
           (100.5, 100.502), (101.0, 101.004), (101.1, 101.104),
           (101.2, 101.204))
    # What the ring dropped ended before the window: it still covers it.
    assert small.dropped() == 2
    assert harness.load_reader("upload_ms.serve")(_run()) == pytest.approx(
        3.5)
    _spans(small, "runner.upload", (101.3, 101.302))
    assert harness.load_reader("upload_ms.serve")(_run()) is None


def test_nothing_to_read_gives_none(rec, monkeypatch):
    readers = ["upload_ms.serve", "pad_share.live", "queue_wait_ms.live",
               "preprocess_ms.train", "optim_ms.train"]
    assert all(harness.load_reader(m)(_run()) is None for m in readers)
    _spans(rec, "runner.upload", (100.5, 100.502))
    untraced = harness.Run({}, "cpu", 0.0, loadgen.Window(T0, T0 + 10.0))
    assert harness.load_reader("upload_ms.serve")(untraced) is None
    # A port without the recorder (an older commit).
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert all(harness.load_reader(m)(_run()) is None for m in readers)


@pytest.mark.parametrize("generator, names", [
    ("closed_loop", ["upload_ms.serve", "launch_ms.serve",
                     "readback_ms.serve"]),
    ("open_loop", ["upload_ms.live", "launch_ms.live", "readback_ms.live",
                   "pad_share.live", "queue_wait_ms.live",
                   "collect_ms.live"]),
])
def test_a_traced_tiny_serving_run_reports_them(generator, names):
    out = harness.run_cell(tiny_spec(generator, trace_slice_s=0.2), 7, 1.2,
                           True, "cpu")
    got = out["metrics"]
    assert all(got[m]["value"] > 0 for m in names), got
    if generator == "open_loop":
        # The counters and the engine's fill count the same batches, but
        # for one that straddles the slice's start.
        batches = out["_run"].extra["pre"]["units"]
        fill = got["engine_fill.live"]["value"]
        assert got["pad_share.live"]["value"] == pytest.approx(
            100.0 * (4 - fill) / 4, abs=100.0 / batches)


def test_a_traced_tiny_training_run_reports_preprocessing():
    out = harness.run_cell(tiny_train_spec(dtype="float32"), 7, 3.0, True,
                           "cpu")
    assert out["_run"].extra["pre"]["units"] >= 1
    got = out["metrics"]
    assert got["preprocess_ms.train"]["value"] > 0
    # The CPU has no device time to read.
    assert "optim_ms.train" not in got
