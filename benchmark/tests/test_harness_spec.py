"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from benchmark import harness
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.cell_spec(ROOT, cell)
    assert spec.limits and spec.traffic["loop"]
    assert (ROOT / "benchmark" / "loops"
            / f"{spec.traffic['loop']}.py").exists()
    assert harness.driver_of(spec, 1, "cpu").work_unit in ("solve", "step")
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(harness.reader(metric))


def test_names_units_and_layers():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert data["events_per_row"]["value"] > 0
