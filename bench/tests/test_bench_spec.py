"""Cells, configs, mixes and metrics are found by name, and one added as
files of its own (the fixture folder) runs with no edit elsewhere."""
import json
import pathlib

import pytest

from bench.harness import spec
from bench.tests.conftest import FIXTURE_BENCHMARK, FIXTURES, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_every_workload_has_its_files(w):
    cell = spec.load_cell(w["name"])
    assert cell["config_name"] == w["config"]
    assert cell["traffic_name"] == w["traffic"]
    assert "end_to_end" not in cell and "per_layer" not in cell
    e2e, per_layer = spec.cell_metrics(BENCHMARK, w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        mod = spec.metric_reader(m)
        assert callable(mod.read) and mod.UNIT


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["source"] == c["source"]
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert pathlib.Path(c["file"]).parts[0] in BENCHMARK["paths"]


def test_metric_units_match_benchmark():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert spec.metric_reader(m["name"]).UNIT == m["unit"], m["name"]


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: set(m.get("workloads", ())) for m in
           BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]


def test_fixture_cell_found_without_edit():
    cell = spec.load_cell("tiny-dense.decode", [FIXTURES])
    assert cell["config"]["hidden_size"] == 64
    assert cell["traffic"]["arrivals"]["kind"] == "at_once"
    with pytest.raises(KeyError):
        spec.load_cell("tiny-dense.decode")


def test_fixture_metric_found_without_edit():
    rec = {"kind": "serve", "ticks": [{"wall_s": 0.5, "decode_rows": 2,
                                       "decode": 1}] * 3}
    got = spec.read_metrics(["ticks_in_window"], rec, [FIXTURES])
    assert got == {"ticks_in_window": {"value": 3.0, "unit": "ticks"}}


def test_cell_metrics_come_from_the_benchmark_file():
    """A cell reports each metric whose ``workloads`` lists it, and each
    that lists none; a metric added there reaches a cell with no edit to
    the cell's file."""
    fx = spec.load_benchmark(FIXTURE_BENCHMARK)
    assert spec.cell_metrics(fx, "tiny-dense.decode") == (
        ["out_tok_s", "itl_p95_ms", "setup_s"],
        ["decode_rows_per_tick.decode", "tick_mfu.decode",
         "ticks_in_window"])
    assert spec.cell_metrics(fx, "tiny-dense.prefill") == (
        ["ttft_p80_ms", "setup_s"],
        ["queue_ticks_p90.prefill", "tick_mfu.prefill"])
    with pytest.raises(KeyError):
        spec.cell_metrics(fx, "starcoder2-3b.decode.mxint4")


def test_reader_with_nothing_to_read_is_left_out():
    assert spec.read_metrics(["device_idle.decode"], {"kind": "serve"}) == {}
