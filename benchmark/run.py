"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It needs a CUDA card (as many as the cell
asks for) and never falls back to the CPU; a run that used fewer cards
than its cell's ``chips``, or cards of more than one kind, prints no
result (``benchmark.harness``).  Set-up (imports, the kernels'
build into the checkout's ``build/kernels/`` on its first run or their
load, the draws, a warm-up of the cell's own shapes) counts as
``setup_s``; then whole solves or sweeps run until ``--seconds`` have
passed.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from
``torch.profiler``.  Once the window has closed the answers are checked
against the plain reference (:mod:`benchmark.answers`).  The last lines
on standard error are the numbers compared, each with its limit; the last
line on standard output is the result object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# one host thread a library: the host's share of a unit then swings less
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(out: dict) -> int:
    """Print the checks' lines on standard error and the result line on
    standard output, unless a forbidden module (JAX or the JAX package)
    has been loaded by then, by the window, a metric reader or the
    check: then name it and print no result (exit code 3); or unless the
    run used fewer cards than its cell's ``chips``, or cards of more than
    one kind: then name the cards it used and print no result (exit code
    4)."""
    from benchmark.harness import device_fault, forbidden_modules
    from benchmark.yardstick import nvidia_smi
    result = dict(out["result"])
    result["metrics"] = {k: v for k, v in result["metrics"].items()
                         if math.isfinite(v["value"])}
    checks = result.pop("checks")
    result["card"] = nvidia_smi()
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print("error: modules that the port's run must not load: "
              + ", ".join(found), file=sys.stderr)
        return 3
    fault = device_fault(result["device"], out["chips"])
    if fault:
        print(f"error: {fault}", file=sys.stderr)
        return 4
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.update(THREADS)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.harness import cell_spec, run_cell

    torch.set_num_threads(1)
    spec = cell_spec(ROOT, args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    return emit(run_cell(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START, spec=spec))


if __name__ == "__main__":
    sys.exit(main())
