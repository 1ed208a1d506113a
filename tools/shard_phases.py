#!/usr/bin/env python3
"""``chip_smoke.py``'s ``oracle`` and ``shard`` phases alone, then the card
cases of the sharding tests, on one CUDA card.

    python3 tools/shard_phases.py

Builds the kernels, runs the ``oracle`` phase, the CLI's 3 unsharded
config-5 steps that the ``shard`` phase holds its ``--shard 2`` run
against, and the ``shard`` phase (each phase prints its JSON row), then
``tests/test_torch_sharding_cuda.py`` (marker ``cuda``, without
``conftest.py``).  A quicker check of the sharded paths than the whole
script.  Exits 1 when a phase or the tests failed.
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    import chip_smoke as cs
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch import _build
    from armadillocudalinearinterpolation_torch.cli import driver
    from armadillocudalinearinterpolation_torch.utils.checkpoint import (
        ContinuationCheckpoint)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    print("build", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda")
    failed = []
    try:
        cs.oracle_phase(pt, torch, dev, smi)
    except cs.CheckFailed as e:
        failed.append(f"oracle: {e}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc, _ = cs.run_cli(driver, cs.config5_cli_argv() + cs.CLI_EPS
                           + ["--steps", "3", "--checkpoint", tmp])
        print("cli rc", rc, time.perf_counter() - t0, flush=True)
        steps = [{"converged": s.converged, "solution": s.solution.tolist()}
                 for s in ContinuationCheckpoint(tmp).load_all()]
    try:
        cs.shard(pt, torch, dev, smi, steps)
    except cs.CheckFailed as e:
        failed.append(f"shard: {e}")
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                        "-p", "no:cacheprovider",
                        "tests/test_torch_sharding_cuda.py", "-m", "cuda",
                        "-q", "-x"], cwd=ROOT, capture_output=True,
                       text=True)
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    if r.returncode:
        failed.append(f"card tests: rc {r.returncode}")
    for line in failed:
        print("FAILED", line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
