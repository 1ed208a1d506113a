#!/usr/bin/env python3
"""Device time of the replay kernel (K2) by block size on one CUDA card.

    python3 tools/replay_layout_study.py [--threads 256,512]
        [--cases config4_64_rows,...]

The measurements behind ``model/replay_cuda.py::replay_layout``.  K2 runs
a row on one CTA of ``threads`` threads (warp 0 posts the events, the
other warps sweep the lanes).  For each case (config 4's 64-row replay of
the guess's own log, its 256-row forward stencil on the guess's log, and
two rows at N=8448, whose row does not fit one CTA's shared memory and
stays in device memory) and each block size of ``THREADS``: K2's
device time by ``torch.profiler`` (mean of 3 calls), the µs per event
(device time over the mean logged events per row), whether every row
equals the default block size's (every field), and why a launch was refused
where one was.  The options narrow the sweep.  Prints one JSON object with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THREADS = (128, 256, 512, 1024)
# (name, N, realisations, points, max_events); the points are the guess and
# its forward stencil, all replaying the guess's log
CASES = (("config4_64_rows", 4096, 64, 1, 4096),
         ("config4_256_rows", 4096, 64, 4, 4096),
         ("device_memory_n8448", 8448, 2, 1, 2 * 8448))


def kernel_us(cs, fn, torch):
    """K2's device µs per call (its entry in the profile), or None."""
    _, per_kernel = cs.device_us(fn, torch, n=3)
    found = [us for name, us in per_kernel.items() if "replay_kernel" in name]
    return found[0] if found else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default=",".join(map(str, THREADS)))
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    opts = ap.parse_args()
    threads_swept = [int(t) for t in opts.threads.split(",")]
    cases = [c for c in CASES if c[0] in opts.cases.split(",")]
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("replay_layout_study: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                              replay_cuda)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    optin = evolve_cuda.shared_optin_bytes(dev)
    replay_layout = replay_cuda.replay_layout
    rows_out = []
    for name, N, R, P, max_events in cases:
        cfg = pt.ModelConfig(n_neurons=N, n_real=R, dtype="float64",
                             root_tol=1e-12, max_events=max_events,
                             evolve_window=512)
        params = pt.MapParams.create(cs.BETA, cs.SIGMA, dtype="float64",
                                     device=dev)
        beta = pt.sample_beta(cfg, params,
                              torch.Generator(device=dev).manual_seed(0))
        Z = cs.fd_stack(torch, dev, torch.float64, cs.STENCIL_EPS)[:P]
        ii = pt.initial_spike_indices(cfg, Z).contiguous()
        v0, s0 = (x.contiguous() for x in pt.lift(cfg, params,
                                                    pt.z_to_u(Z)))
        sched, n_ev = pt.compute_schedule(cfg, v0[:1], s0[:1], beta, ii[:1])
        args = (cfg, sched, n_ev, v0, s0, beta, ii[0].contiguous())
        M, rows = cfg.n_spikes, P * R
        events = float(torch.clamp(n_ev, max=sched.shape[1]).double().mean())

        def call():
            return replay_cuda.replay_events_cuda(*args)
        default = replay_layout(N, M, rows, props.multi_processor_count,
                                optin, props.shared_memory_per_multiprocessor)
        row = {"case": name, "N": N, "rows": rows,
               "events_per_row_mean": events,
               "row_in_shared": evolve_cuda.row_fits_shared(
                   N, M, torch.float64, "replay", optin),
               "default_threads": default, "layouts": []}
        try:
            ref = call()
            us = kernel_us(cs, call, torch)
        except RuntimeError as exc:
            ref, us = None, None
            row["default_refused"] = repr(exc)
        row["default_device_us"] = us
        row["default_us_per_event"] = None if us is None else us / events
        for threads in threads_swept:
            entry = {"threads": threads}
            # the wrapper takes its block size from replay_layout
            replay_cuda.replay_layout = lambda *_, t=threads: t
            try:
                res = call()
                torch.cuda.synchronize()
                us = kernel_us(cs, call, torch)
            except RuntimeError as exc:
                entry["refused"] = repr(exc)
                row["layouts"].append(entry)
                continue
            finally:
                replay_cuda.replay_layout = replay_layout
            entry["equal_to_default"] = ref is not None and all(
                bool(torch.equal(getattr(res, f), getattr(ref, f)))
                for f in ref._fields)
            entry["device_us"] = us
            entry["us_per_event"] = None if us is None else us / events
            row["layouts"].append(entry)
        rows_out.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"replay_layout_study": rows_out,
                      "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
