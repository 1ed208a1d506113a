"""The four-card cell ``n512_continuation_shard4`` resolves by name: its
configuration, traffic, loop and metrics; the loop refuses any number of
cards but four before it starts a rank; the new readers give nothing on a
window with no work; the cell at test size runs on four gloo ranks
with rank 0 in this process, the all-reduces a step counted; a fault
planted here is found by name (the loop plants it on the other ranks);
and the loop's control, its Newton batched, fails the cell's limits."""

import json
import time
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from armadillocudalinearinterpolation_torch.parallel import sharding
from benchmark import answers, faults, harness
from benchmark.loops import cli_sweep, sharded_sweep
from benchmark.reference import edmap
from conftest import ROOT, small_spec

CELL = "n512_continuation_shard4"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("allreduce_share.step", "allreduces.step")


def test_the_cell_resolves_by_name():
    spec = harness.cell_spec(ROOT, CELL)
    assert spec.cell["chips"] == 4
    assert spec.config["name"] == "ring_n512_r4000_f32"
    assert spec.config["n_real"] == 4000 and spec.config["reduced"] == []
    assert spec.traffic["loop"] == "sharded_sweep"
    assert spec.traffic["flags"][-2:] == ["--shard", "4"]
    assert spec.traffic["events_per_row"]["value"] > 0
    assert set(spec.limits) == {"claim_gap", "unconverged_share",
                                "stability_mismatch"}
    assert {m["name"] for m in spec.end_to_end} == {"step_s", "setup_s"}
    layer = {m["name"] for m in spec.per_layer}
    # k1_roofline.step counts a launch's rows from the configuration's R,
    # not a rank's block: the cell leaves it out
    assert set(NEW) <= layer and "k1_roofline.step" not in layer


def test_the_cell_keeps_the_one_card_cell_s_model_and_flags():
    """Only R and the shard differ from ``n512_fast_family``."""
    one = harness.cell_spec(ROOT, "n512_fast_family")
    four = harness.cell_spec(ROOT, CELL)
    differ = {k for k in one.config if one.config[k] != four.config.get(k)}
    assert differ <= {"name", "source", "deployment", "n_real", "assumed",
                      "events_per_row"}
    assert four.traffic["flags"] == one.traffic["flags"] + ["--shard", "4"]
    for key in ("start", "warm_up_steps", "checked", "stability_margin"):
        assert four.traffic[key] == one.traffic[key]


@pytest.mark.parametrize("metric", NEW)
def test_the_new_metrics_resolve_and_read_rank_0(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["workloads"] == [CELL] and entry["layer"] == "parallel"
    assert entry["moves"] == "step_s"
    assert callable(harness.reader(metric))


@pytest.mark.parametrize("metric", NEW)
def test_the_new_metrics_give_nothing_on_a_window_with_no_work(metric):
    empty = SimpleNamespace(kernels=[], busy_s=0.0, window_s=1.0)
    for trace in (None, empty):
        ctx = SimpleNamespace(trace=trace, window_s=1.0, work=0, before={},
                              after={}, units=0)
        assert harness.reader(metric)(ctx) is None


def test_allreduce_share_reads_nccl_all_reduce_kernels():
    kernels = [("ncclDevKernel_AllReduce_Sum_f64_RING_LL(x)", 0.0, 2e5),
               ("ncclDevKernel_AllReduce_Sum_f64_RING_LL(x)", 1e5, 2e5),
               ("void evolve_kernel<float>(...)", 0.0, 5e5),
               ("ncclDevKernel_AllGather_RING_LL(x)", 6e5, 1e5)]
    ctx = SimpleNamespace(trace=SimpleNamespace(kernels=kernels),
                          window_s=1.0)
    assert harness.reader("allreduce_share.step")(ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("chips", [1, 2, 8])
def test_the_loop_refuses_other_than_four_cards(chips):
    spec = small_spec(CELL)
    with pytest.raises(ValueError, match="on 4 cards"):
        sharded_sweep.Driver(spec.config, spec.traffic, 1, "cpu",
                             chips=chips)
    assert not dist.is_initialized()


def test_the_cell_at_test_size_runs_on_four_ranks(monkeypatch):
    """Four gloo ranks, rank 0 here (untraced: the CPU's plain evolve
    makes a trace of millions of ops): the sweeps' answers pass the
    check, every rank's card record merges into the CPU's, the
    all-reduces are counted, and the pool is gone afterwards."""
    spec = small_spec(CELL)
    monkeypatch.setattr(cli_sweep.Driver, "warm_up", lambda self: None)
    before = sharding.ALL_REDUCES
    out = harness.run_cell(ROOT, CELL, 20260107, 0.0, False, "cpu",
                           time.perf_counter(), spec=spec)
    result = out["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    assert result["device"]["count"] == 1
    assert set(result["metrics"]) == {"step_s", "setup_s"}
    assert sharding.ALL_REDUCES > before
    assert not dist.is_initialized()
    ctx = SimpleNamespace(work=2, before={"all_reduces": before},
                          after={"all_reduces": sharding.ALL_REDUCES})
    assert harness.reader("allreduces.step")(ctx) == (
        sharding.ALL_REDUCES - before) / 2


def test_a_planted_fault_is_found_by_name(monkeypatch):
    assert sharded_sweep.planted() == []
    faults.plant("half_batch", "sharded_sweep", monkeypatch.setattr)
    faults.plant("unchanged", "sharded_sweep", monkeypatch.setattr)
    assert sorted(sharded_sweep.planted()) == ["half_batch", "unchanged"]


def test_newton_batch_ends_each_problem_as_alone():
    """The control's batched Newton against the reference's one problem
    at a time, in bfloat16 storage and in the draw's own precision."""
    spec = small_spec(CELL)
    m = answers.reference_model(spec.config)
    means = [13.3589, 13.4589]
    rates = torch.stack([answers.draw_rates(
        spec.config, b, torch.Generator().manual_seed(i), "cpu")
        for i, b in enumerate(means)])
    starts = torch.tensor([spec.traffic["start"]["guess"],
                           [0.5004, 0.5755, 10.9955]])
    for store in (torch.bfloat16, None):
        alone = [edmap.newton(m, starts[p], means[p], rates[p], tol=1e-4,
                              max_iter=2, eps=1e-2, store=store)[2]
                 for p in range(2)]
        assert sharded_sweep.newton_batch(
            m, starts, means, rates, tol=1e-4, max_iter=2, eps=1e-2,
            store=store) == alone


def test_the_control_at_test_size_is_not_correct(monkeypatch):
    """The cell's own loop on four gloo ranks: the program's answers pass
    the limits and the control's (the reference in bfloat16 storage)
    fail them."""
    spec = small_spec(CELL)
    monkeypatch.setattr(cli_sweep.Driver, "warm_up", lambda self: None)
    driver = harness.driver_of(spec, 20260108, "cpu")
    try:
        records, _, _ = harness.run_window(driver, 0.0, "cpu")
        driver.finish(records)
    finally:
        driver.release()
    assert not dist.is_initialized()
    program = driver.check(records)
    program["unconverged_share"] = 100.0 * sum(
        r["failed"] for r in records) / sum(r["attempted"] for r in records)
    ok, checks = answers.compare(program, spec.limits)
    assert ok, checks
    ok, checks = answers.compare(driver.control(records), spec.limits)
    assert not ok, checks
