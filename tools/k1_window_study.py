#!/usr/bin/env python3
"""Device time and fallback share of the evolve kernel (K1) with its
certified window, against the same kernel on every lane, on one CUDA card.

    python3 tools/k1_window_study.py [--checkout DIR] [--repeats 5]

Cases: config 3's map evaluation (1024 rows x 1024 lanes from the
``Driver.cu`` guess, f32, W=128), the fast wave family's FD stencil (4
points x 1000 realisations x 512 lanes from ``--guess 0.4988 0.5761
11.0139`` at beta 13.3589, forward steps of 1e-2, f32, W=128) and config
4's stencil (4 points x 64 realisations x 4096 lanes from the ``Driver.cu``
guess, steps of 1e-6, f32 and f64, W=512); sigma 0.1, the draw of seed 0.
For each: K1's ms by CUDA events around one launch (median of
``--repeats`` after two warm launches), windowed and on every lane, and
the same as device microseconds an event (the launch's time over its
events a row: the rows run side by side, each row's events one after
another), the share of windowed events that fell back to every lane, and
whether every windowed row equals its every-lane row.  Also the registers
and spill bytes of each instantiation of the checkout's K1 as the
package's flags compile it (``tools/kernel_resources.py``; needs
``nvcc``).  ``--checkout`` loads the package of another checkout (unpack
the parent with ``git archive``); run two checkouts in turns in one call
(parent, change, change, parent) to compare them.  Prints one JSON object
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DRIVER_GUESS = (0.3310, 0.6914, 1.3557)
FAST_FAMILY = (0.4988, 0.5761, 11.0139)
# (name, N, realisations, guess, beta, points, FD step, W, dtype)
CASES = (("config3_map", 1024, 1024, DRIVER_GUESS, 13.0589, 1, 0.0, 128,
          "float32"),
         ("fast_family_stencil", 512, 1000, FAST_FAMILY, 13.3589, 4, 1e-2,
          128, "float32"),
         ("config4_stencil_f32", 4096, 64, DRIVER_GUESS, 13.0589, 4, 1e-6,
          512, "float32"),
         ("config4_stencil_f64", 4096, 64, DRIVER_GUESS, 13.0589, 4, 1e-6,
          512, "float64"))
FIELDS = ("last_ind", "last_time", "crossed_ind", "crossed_time", "accept",
          "n_events")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def registers(package: Path) -> dict:
    """Registers, stack frame and spills of each K1 instantiation of the
    package at ``package``."""
    sys.path.insert(0, str(ROOT / "tools"))
    from kernel_resources import source_resources
    return {name: res for name, res in
            source_resources(package / "csrc" / "evolve.cu").items()
            if "evolve_kernel" in name}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("k1_window_study: needs a CUDA card", file=sys.stderr)
        return 2
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.model import evolve_cuda
    dev = torch.device("cuda")

    def ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    out = {"checkout": str(Path(args.checkout).resolve()),
           "package": pt.__file__, "card": card(),
           "registers": registers(Path(pt.__file__).parent), "cases": {}}
    for name, N, R, guess, beta0, P, eps, W, dtype in CASES:
        cfg = pt.ModelConfig(n_neurons=N, n_real=R, dtype=dtype,
                             evolve_window=W)
        params = pt.MapParams.create(beta0, 0.1, dtype=dtype, device=dev)
        beta = pt.sample_beta(cfg, params,
                              torch.Generator(device=dev).manual_seed(0))
        z0 = torch.tensor(guess, dtype=cfg.torch_dtype, device=dev)
        Z = torch.cat([z0[None], z0[None] + eps * torch.eye(
            3, dtype=cfg.torch_dtype, device=dev)])[:P]
        ii = pt.initial_spike_indices(cfg, Z).contiguous()
        v0, s0 = (x.contiguous() for x in pt.lift(cfg, params,
                                                    pt.z_to_u(Z)))
        fb = torch.zeros(P * R, dtype=torch.int32, device=dev)
        case = {"rows": P * R, "lanes": N, "init_ind": ii.tolist()}
        results = {}
        for label, c in (("windowed", cfg),
                         ("full_lane", cfg.with_(evolve_window=0))):
            def launch():
                results[label] = evolve_cuda.evolve_ensemble_cuda(
                    c, v0, s0, beta, ii,
                    fallbacks=fb if c.evolve_window else None)
            for _ in range(2):
                launch()
            times = [ms(launch) for _ in range(args.repeats)]
            case[f"{label}_ms"] = statistics.median(times)
            case[f"{label}_ms_all"] = times
        rw, rf = results["windowed"], results["full_lane"]
        events = int(rw.n_events.sum())
        case["events_per_row"] = events / (P * R)
        for label in results:
            case[f"{label}_us_per_event"] = (
                1e3 * case[f"{label}_ms"] / case["events_per_row"])
        case["fallback_share_pct"] = 100.0 * int(fb.sum()) / events
        case["rows_equal_full_lane"] = all(
            torch.equal(getattr(rw, f), getattr(rf, f)) for f in FIELDS)
        out["cases"][name] = case
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
