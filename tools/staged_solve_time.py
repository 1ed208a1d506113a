#!/usr/bin/env python3
"""Wall time of config 4's staged solve, and the replay kernel's (K2's)
launches in it, on one CUDA card.

    python3 tools/staged_solve_time.py [checkout]

Imports the port, and the ``chip_smoke.py`` beside it for config 4's
constants, from ``checkout`` (default: this script's repository), so that
two checkouts can be compared in turns on one card (parent, change,
change, parent).  Builds the kernels first (not timed), then runs
``newton_solve_staged`` at config 4 (N=4096, R=64, f64, sigma 0.1,
``evolve_window=512``, to 1e-8) from the ``Driver.cu`` guess (cold: the
first solve of the process) and three times from the guess + 1e-3 (warm),
each timed by the host clock to a synchronise; then one more warm solve
under ``torch.profiler``: the rows and device µs of each K2 launch, K1's
device time and the union of all device work.  Prints one JSON object.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("staged_solve_time: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch import _build
    from armadillocudalinearinterpolation_torch.model import replay_cuda
    from torch.profiler import ProfilerActivity, profile
    _build.load_library()
    dev = torch.device("cuda")
    cfg = pt.ModelConfig(**cs.CONFIG4)
    params = pt.MapParams.create(cs.BETA, cs.SIGMA, dtype="float64",
                                 device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    z0 = torch.tensor(cs.INITIAL_GUESS, dtype=torch.float32, device=dev)

    def solve(z):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.newton_solve_staged(cfg, params, z, beta=beta,
                                     tolerance=cs.STAGED_TOL)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    cold, res = solve(z0)
    warm = [solve(z0 + 1e-3)[0] for _ in range(3)]

    rows = []
    replay = replay_cuda.replay_events_cuda

    def counted(cfg_, sched, n_sched, v0, s0, beta_, init_ind, **kw):
        n_real = kw.get("n_real")
        rows.append(v0.shape[0] * (beta_.shape[0] if n_real is None
                                   else n_real))
        return replay(cfg_, sched, n_sched, v0, s0, beta_, init_ind, **kw)
    replay_cuda.replay_events_cuda = counted
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(z0 + 1e-3)
    finally:
        replay_cuda.replay_events_cuda = replay
    k2, k1_us, spans = [], 0.0, []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not cs.is_device_work(e):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "replay_kernel" in e.name:
            k2.append(e.time_range.elapsed_us())
        elif "evolve_kernel" in e.name:
            k1_us += e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    print(json.dumps({
        "checkout": str(root), "converged": bool(res.converged),
        "residual_norm": float(res.residual_norm), "cold_s": cold,
        "warm_s": warm, "k2_rows": rows, "k2_device_us": k2,
        "k1_device_us": k1_us, "profiled_device_busy_s": busy / 1e6,
        "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
