"""One run of one cell: set-up, the measured window, the metrics, the
check of the answers, and the result line.

Everything a cell is made of is found by name:

* the cell in ``BENCHMARK.json``'s ``workloads``, and its limits in
  ``benchmark/workloads/<cell>.json``;
* its configuration in ``benchmark/configs/<config>.json``;
* its traffic mix in ``benchmark/traffic/<traffic>.json``, whose
  ``"loop"`` names the general driver in ``benchmark/loops/<loop>.py``;
* each metric's reader in ``benchmark/metrics/<name>.py``, or, for a name
  with a dot (one quantity split by the end-to-end metric it moves), in
  ``benchmark/metrics/<name before the dot>.py``.

A later cell, configuration, traffic mix or metric adds files and entries;
it edits none of these.

The cards a run used are measured, not assumed.  ``driver_of`` builds a
loop's ``Driver(config, traffic, seed, device, chips=...)`` with the cell's
``chips``; a loop that runs on one card refuses any other number.  After
the window, before ``Driver.release()``, the harness takes one record for
each card the run put work on: its index, its name and its peak of
allocated memory (``local_devices``).  A loop whose ranks live in other
processes reports its cards through an optional ``Driver.devices()``,
which gathers every rank's ``local_devices`` (its own included), so the
per-card memory comes from every rank; without the hook the harness reads
its own process.  The result's ``device`` then gives the distinct cards'
one ``kind``, their ``count``, the fullest card's ``memory_peak_bytes``
and the cards themselves (``per_device``), and a run on fewer cards than
its cell's ``chips``, or on cards of more than one kind, prints no result
(``run.py``).  The device trace (``busy_s`` and the trace's metrics) and
the program's spans and counters are read in the harness process alone,
so a multi-card loop runs its rank 0 in that process; the other ranks'
spans stay unread.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import answers
from benchmark.trace import TraceData

BENCH = Path(__file__).resolve().parent
# Top-level modules that must never be loaded by a run of the port.
FORBIDDEN = ("jax", "jaxlib", "flax", "armadillocudalinearinterpolation_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return workload in metric.get("workloads", [workload])
    return SimpleNamespace(
        name=workload, cell=cell,
        config=load_json(root / config["file"]),
        traffic=load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(BENCH / "workloads" / f"{workload}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read(ctx)`` of metric ``name``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"benchmark_metric_{name}").read


def driver_of(spec, seed: int, device):
    loop = importlib.import_module(f"benchmark.loops.{spec.traffic['loop']}")
    return loop.Driver(spec.config, spec.traffic, seed, device,
                       chips=spec.cell["chips"])


def local_devices(device) -> list:
    """One record for each card this process put work on: ``index``,
    ``name``, ``uuid`` and ``memory_peak_bytes``, the allocator's peak.  A
    visible card counts where that peak is above 0 (reading a card's
    allocator statistics creates no context on it).  On the CPU, one
    record of the CPU."""
    if torch.device(device).type != "cuda":
        return [{"index": 0, "name": "cpu", "uuid": "cpu",
                 "memory_peak_bytes": 0}]
    out = []
    for i in range(torch.cuda.device_count()):
        peak = torch.cuda.max_memory_allocated(i)
        if peak > 0:
            props = torch.cuda.get_device_properties(i)
            out.append({"index": i, "name": props.name,
                        "uuid": str(props.uuid),
                        "memory_peak_bytes": int(peak)})
    return out


def device_report(records: list, platform: str) -> dict:
    """The result's ``device`` from the records of every process of the
    run.  A card (by its uuid) that several processes used counts once,
    with the sum of their peaks."""
    cards = {}
    for r in records:
        card = cards.setdefault(r["uuid"], {"index": r["index"],
                                            "name": r["name"],
                                            "memory_peak_bytes": 0})
        card["memory_peak_bytes"] += int(r["memory_peak_bytes"])
    per = sorted(cards.values(), key=lambda c: c["index"])
    return {"platform": platform,
            "kind": ", ".join(sorted({c["name"] for c in per})),
            "count": len(per),
            "memory_peak_bytes": max((c["memory_peak_bytes"] for c in per),
                                     default=0),
            "per_device": per}


def device_fault(dev: dict, chips: int):
    """Why the run's cards do not stand for a cell on ``chips`` cards
    (fewer of them, or more than one kind), or None."""
    used = "; ".join(f"card {c['index']} {c['name']} peak "
                     f"{c['memory_peak_bytes']} B"
                     for c in dev["per_device"]) or "none"
    if dev["count"] < chips:
        return (f"the cell needs {chips} card(s) and the run used "
                f"{dev['count']}: {used}")
    if len({c["name"] for c in dev["per_device"]}) > 1:
        return f"the run's cards are of more than one kind: {used}"
    return None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(driver, seconds: float, device):
    """Whole units (solves or sweeps) until ``seconds`` have passed:
    ``(records, window_s, unit_s)``."""
    records, unit_s = [], []
    sync(device)
    t0 = time.perf_counter()
    k = 0
    while True:
        t = time.perf_counter()
        records.append(driver.unit(k))
        sync(device)
        now = time.perf_counter()
        unit_s.append(now - t)
        k += 1
        if now - t0 >= seconds:
            break
    return records, now - t0, unit_s


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, spec=None) -> dict:
    """Run the cell once and return ``{"result", "lines", "chips"}``: the
    result object (its ``checks`` key last), the lines of the checks and
    the cards the cell asks for."""
    spec = spec or cell_spec(root, workload)
    driver = driver_of(spec, seed, device)
    driver.warm_up()
    sync(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    before = driver.counters()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if
                                         torch.device(device).type == "cuda"
                                         else [])
        prof = profile(activities=acts, record_shapes=True)
        prof.__enter__()
    records, window_s, unit_s = run_window(driver, seconds, device)
    if prof is not None:
        prof.__exit__(None, None, None)
    after = driver.counters()
    cards = (driver.devices() if hasattr(driver, "devices")
             else local_devices(device))
    if hasattr(driver, "finish"):
        driver.finish(records)
    work = sum(r["work"] for r in records)
    failed = sum(r["failed"] for r in records)
    attempted = sum(r["attempted"] for r in records)
    tdata = TraceData.of(prof, window_s) if prof is not None else None
    prof = None
    ctx = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, work=work,
        work_unit=driver.work_unit, records=records, before=before,
        after=after, trace=tdata, config=spec.config, traffic=spec.traffic,
        units=len(records))
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lines = [f"units {len(records)}, work {work} {driver.work_unit}s, "
             f"window {window_s!r} s, unit seconds: median "
             f"{statistics.median(unit_s)!r}, min {min(unit_s)!r}, max "
             f"{max(unit_s)!r}"]

    # the program's state goes before the reference runs on the card
    driver.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check(records)
    numbers["unconverged_share"] = 100.0 * failed / max(attempted, 1)
    correct, checks = answers.compare(numbers, spec.limits)
    dev = device_report(cards, "gpu" if torch.device(device).type == "cuda"
                        else "cpu")
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if tdata is not None:
        dev["busy_s"] = tdata.busy_s
        dev["window_s"] = tdata.window_s
        result["breakdown"] = tdata.breakdown()
    result["checks"] = checks
    lines += [f"check {k}: {v['value']!r} against the limit {v['limit']!r}"
              for k, v in checks.items()]
    return {"result": result, "lines": lines, "chips": spec.cell["chips"]}

