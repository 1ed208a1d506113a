"""The comparison that decides ``correct``, at test size on the CPU: a
sound run passes; with the timed path broken underneath (the solve
returns its start, half of the realisations are left out of the mean, an
answer is altered where it is produced, the CLI's unstable count is off by
one: :mod:`benchmark.faults`) and with the control in the program's place,
the same numbers fail the cell's limits."""

import json
import time

import pytest

from benchmark import answers, faults, harness
from benchmark.loops import cli_sweep, staged_solve
from conftest import ROOT, small_spec

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
BROKEN = [(cell, fault) for cell in CELLS for fault in faults.FAULTS
          if faults.applies(fault, small_spec(cell).traffic["loop"])]


def run(workload, monkeypatch, spec=None):
    spec = spec or small_spec(workload)
    loop = staged_solve if spec.traffic["loop"] == "staged_solve" else cli_sweep
    monkeypatch.setattr(loop.Driver, "warm_up", lambda self: None)
    out = harness.run_cell(ROOT, workload, 20260101, 0.0, False, "cpu",
                           time.perf_counter(), spec=spec)
    return out["result"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, monkeypatch):
    result = run(workload, monkeypatch)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", BROKEN)
def test_broken_program_is_not_correct(workload, fault, monkeypatch):
    spec = small_spec(workload)
    faults.plant(fault, spec.traffic["loop"], monkeypatch.setattr)
    result = run(workload, monkeypatch, spec)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, monkeypatch):
    spec = small_spec(workload)
    loop = staged_solve if spec.traffic["loop"] == "staged_solve" else cli_sweep
    driver = loop.Driver(spec.config, spec.traffic, 20260102, "cpu")
    records, _, _ = harness.run_window(driver, 0.0, "cpu")
    if hasattr(driver, "finish"):
        driver.finish(records)
    ok, checks = answers.compare(driver.control(records), spec.limits)
    driver.release()
    assert not ok, checks
