"""BENCHMARK.json against the rules its cells and metrics keep, and every
name in it resolved to its file."""

import json
import re

import pytest

from h100_bench import harness
from h100_bench.tests.helpers import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["h100_bench"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_every_name_resolves(manifest):
    for cfg in manifest["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith("h100_bench/")
    for cell in manifest["workloads"]:
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
        spec = harness.cell_spec(cell["name"])
        gen = harness.load_generator(spec["traffic"]["generator"])
        assert callable(gen.run)
        assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
        assert spec["config"]["name"] == cell["config"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_names_and_units(manifest):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in manifest[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for cell in manifest["workloads"]:
        assert NAME.match(cell["traffic"]) and cell["chips"] == 1
        assert 1 <= len(cell["why"]) <= 200
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for cell in manifest["workloads"]:
        spec = harness.cell_spec(cell["name"])
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            # A per-layer metric lists only cells that report what it moves.
            assert m["moves"] in e2e and m["moves"] in reported


def test_layers_and_sources(manifest):
    for m in manifest["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    # Each share of a peak or a roofline is in percent.
    for m in manifest["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fit_a_full_check(manifest):
    rs = manifest["run_seconds"]
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 180 + 1200 <= 43200
