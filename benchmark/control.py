"""Readings of a cell's numbers for the program and for its control, on
several seeds, to set the cell's limits from (see ``PERF.md``).

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds <n> <n> ... [--fault <name>]

For each seed it runs the cell's window (as ``run.py`` does, untimed),
prints the program's numbers, then the control's: the computation in the
nearest precision below the configuration's, put in the program's place
(each loop's ``Driver.control``).  With ``--fault`` it plants that fault
of :mod:`benchmark.faults` in the program first and prints only the
program's numbers, as the fault reads them at the cell's own size.  One
JSON line per seed and side.  It needs a CUDA card, as a run does; the
benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import faults  # noqa: E402


def readings(spec, seed: int, seconds: float, device,
             fault=None) -> list:
    """The program's and the control's numbers on one seed; with
    ``fault`` planted, the program's alone."""
    from benchmark import harness
    driver = harness.driver_of(spec, seed, device)
    driver.warm_up()
    records, _, _ = harness.run_window(driver, seconds, device)
    if hasattr(driver, "finish"):
        driver.finish(records)
    attempted = sum(r["attempted"] for r in records)
    program = driver.check(records)
    program["unconverged_share"] = (100.0 * sum(r["failed"] for r in records)
                                    / max(attempted, 1))
    if fault:
        driver.release()
        return [{"seed": seed, "side": f"fault:{fault}", **program}]
    control = driver.control(records)
    driver.release()
    return [{"seed": seed, "side": "program", **program},
            {"seed": seed, "side": "control", **control}]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=faults.FAULTS)
    a = p.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("error: the control runs on a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(ROOT, a.workload)
    if a.fault:
        faults.plant(a.fault, spec.traffic["loop"])
    for seed in a.seeds:
        t = time.perf_counter()
        for line in readings(spec, seed, a.seconds, "cuda", a.fault):
            print(json.dumps(dict(line, workload=a.workload,
                                  seconds=time.perf_counter() - t)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
