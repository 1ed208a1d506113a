"""The port's spans and K1's counters (``utils/profiling.py``) on the CPU,
and the benchmark's idle readers that put the device's idle time down to
the spans (``benchmark/spans.py``).

The map runs at N=512, R=2 and a horizon of 0.25: its plain evolve then
records ~12k profiler events an evaluation, against ~43k at the default
horizon, and the residual is finite."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.cli import driver
from armadillocudalinearinterpolation_torch.utils import profiling
from benchmark.metrics import (cli_idle, device_idle, k1_events_per_row,
                               k1_fallback_share, map_idle, solver_idle,
                               unspanned_idle)
from benchmark.spans import idle_by_layer, layer_of
from benchmark.trace import TraceData

SMALL = dict(n_neurons=512, n_real=2, t_horizon=0.25, dtype="float64")
GUESS = (0.3310, 0.6914, 1.3557)
IDLE_READERS = (cli_idle, solver_idle, map_idle, unspanned_idle)


def small_map():
    cfg = pt.ModelConfig(**SMALL)
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64")
    return pt.make_residual_fn(cfg, params, 0, device="cpu")


def spans_of(prof, name):
    """``(start_us, end_us)`` of every host event called ``name``."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_profiler_makes_no_record_function(monkeypatch):
    """With no profiler recording, neither a span nor a spanned function
    makes a ``record_function``, and a Newton solve on the map (every
    span of the solvers and the map) runs through."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    with profiling.span("cli.step"):
        pass
    assert profiling.spanned("map.eval")(lambda x: x + 1)(1) == 2
    F = small_map()
    res = pt.newton_solve(F, torch.tensor(GUESS, dtype=torch.float64),
                          pt.NewtonConfig(tolerance=1e-12, max_iterations=1,
                                          fd_epsilon=1e-7))
    assert res.iterations == 1


def test_newton_spans_nest():
    """Under a CPU profiler, a Newton solve on the port's map records one
    ``solvers.iteration`` a Newton iteration, each inside the solve's
    ``solvers.newton`` and each holding its Jacobian, its linear solve
    and map evaluations."""
    F = small_map()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = pt.newton_solve(F, torch.tensor(GUESS, dtype=torch.float64),
                              pt.NewtonConfig(tolerance=1e-12,
                                              max_iterations=2,
                                              fd_epsilon=1e-7))
    assert res.iterations == 2
    newton = spans_of(prof, "solvers.newton")
    iterations = spans_of(prof, "solvers.iteration")
    evals = spans_of(prof, "map.eval")
    assert len(newton) == 1 and len(iterations) == res.iterations
    # the solve's first residual, then a Jacobian stack and a step each
    assert len(evals) == 1 + 2 * res.iterations
    for it in iterations:
        assert inside(it, newton[0])
        assert sum(inside(e, it) for e in evals) == 2
        for name in ("solvers.jacobian", "solvers.linear_solve"):
            assert sum(inside(s, it) for s in spans_of(prof, name)) == 1
    for name in ("map.lift", "map.restrict", "map.mean"):
        assert len(spans_of(prof, name)) == len(evals)


def test_cli_one_step_profile_holds_the_spans(tmp_path, capsys):
    """``--steps 1 --profile``: the Chrome trace holds the CLI's step with
    its solver's iteration inside, and the map's evaluations inside that,
    on one thread and one timeline."""
    prof = tmp_path / "prof"
    argv = ["--cpu", "--neurons", "512", "--realisations", "2",
            "--horizon", "0.25", "--dtype", "float64", "--tol", "1e-12",
            "--fd-eps", "1e-7", "--max-iter", "1", "--steps", "1",
            "--quiet", "--profile", str(prof)]
    assert driver.main(argv) == 0
    assert f"profiler trace written to {prof}/" in capsys.readouterr().out
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and layer_of(str(e.get("name", ""))):
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    for name in ("cli.setup", "cli.smoke", "cli.step", "cli.predict",
                 "solvers.newton", "solvers.iteration", "map.eval"):
        assert name in spans, name
    step, = spans["cli.step"]
    iteration, = spans["solvers.iteration"]
    assert inside(iteration, step) and iteration[2] == step[2]
    assert sum(inside(e, iteration) for e in spans["map.eval"]) == 2
    # the smoke evaluation comes before the step, inside cli.smoke
    smoke, = spans["cli.smoke"]
    assert smoke[1] <= step[0]
    assert sum(inside(e, smoke) for e in spans["map.eval"]) == 1


def test_k1_counters_sum_rows_events_and_fallbacks():
    """The counters' sums: every launch's rows and events, and of the
    windowed launches their rows, events and fallback events."""
    c = profiling.K1Counters()
    assert c.snapshot() == {"launches": 0, "rows": 0, "events": 0,
                            "windowed_rows": 0, "windowed_events": 0,
                            "fallback_events": 0}
    c.count(torch.tensor([3, 4], dtype=torch.int32))
    c.count(torch.tensor([5, 6, 7], dtype=torch.int32),
            torch.tensor([1, 0, 2], dtype=torch.int32))
    assert c.snapshot() == {"launches": 2, "rows": 5, "events": 25,
                            "windowed_rows": 3, "windowed_events": 18,
                            "fallback_events": 3}
    c.reset()
    assert c.snapshot()["events"] == 0


def host(start, end, name):
    return (float(start), float(end), name)


def synthetic_trace():
    """A 10-ms window (times in us): kernels at [0, 1000], [2000, 3000],
    [5000, 6000] and [8000, 9000], so the device idles 6 ms in four gaps;
    a ``cli.step`` from 0 to 7500 holding a ``solvers.iteration`` from
    1000 to 4000 with a ``map.eval`` from 2500 to 3600, then 1000 short
    ``aten::`` events from 3600 to 4000 and ``aten::sum`` over
    [6000, 6500]; after the step the host is in no span."""
    kernels = [("k", s, 1000.0) for s in (0.0, 2000.0, 5000.0, 8000.0)]
    hosts = [host(0, 7500, "cli.step"), host(1000, 4000, "solvers.iteration"),
             host(2500, 3600, "map.eval"), host(6000, 6500, "aten::sum"),
             host(9500, 10000, "aten::copy_")]
    hosts += [host(3600 + 0.4 * k, 3600 + 0.4 * k + 0.2, "aten::view")
              for k in range(1000)]
    hosts.sort()
    busy = 4000.0 / 1e6
    return TraceData(window_s=0.01, busy_s=busy, kernels=kernels, ops=[],
                     host=hosts)


def test_idle_readers_split_the_gaps_by_layer():
    """Each idle gap goes to the innermost program span around its middle:
    [1000, 2000] to the solver's iteration, [3000, 5000] (middle 4000, the
    iteration's end) to the iteration, [6000, 8000] to the CLI's step,
    whose span opened more than 400 host events earlier, [9000, 10000]
    to none.  The four shares add up to ``device_idle``."""
    trace = synthetic_trace()
    assert trace._doing(7000.0) == "host outside any recorded op"
    by = idle_by_layer(trace)
    assert by == pytest.approx({"cli": 0.002, "solvers": 0.003, "map": 0.0,
                                "parallel": 0.0, None: 0.001}, abs=1e-12)
    ctx = SimpleNamespace(trace=trace, window_s=trace.window_s)
    shares = [r.read(ctx) for r in IDLE_READERS]
    assert shares == pytest.approx([20.0, 30.0, 0.0, 10.0])
    assert sum(shares) == pytest.approx(device_idle.read(ctx))


def test_idle_of_a_nested_map_span():
    """A gap inside ``map.eval`` inside ``solvers.iteration`` goes to the
    map; the spans may close in any order of their starts."""
    kernels = [("k", 0.0, 100.0), ("k", 300.0, 100.0)]
    hosts = sorted([host(0, 400, "solvers.iteration"),
                    host(50, 120, "map.lift"), host(150, 350, "map.eval"),
                    host(160, 170, "aten::add")])
    trace = TraceData(window_s=0.0004, busy_s=0.0002, kernels=kernels,
                      ops=[], host=hosts)
    assert idle_by_layer(trace)["map"] == pytest.approx(0.0002)


def test_readers_without_a_trace_or_spans_give_nothing():
    """An untraced run, or a trace that holds no program span (a program
    that records none), gives no idle share; no K1 launch, no counter
    share."""
    untraced = SimpleNamespace(trace=None, window_s=1.0)
    for r in IDLE_READERS + (k1_events_per_row, k1_fallback_share):
        assert r.read(untraced) is None
    bare = TraceData(window_s=0.01, busy_s=0.001,
                     kernels=[("k", 0.0, 1000.0)], ops=[],
                     host=[host(0, 10000, "aten::mul")])
    ctx = SimpleNamespace(trace=bare, window_s=0.01)
    for r in IDLE_READERS:
        assert r.read(ctx) is None
    profiling.K1_COUNTERS.reset()
    assert k1_events_per_row.read(ctx) is None
    assert k1_fallback_share.read(ctx) is None
