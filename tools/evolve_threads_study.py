#!/usr/bin/env python3
"""Device time of the evolve kernel (K1) by threads per row on one CUDA
card.

    python3 tools/evolve_threads_study.py

The measurements behind ``model/evolve_cuda.py::default_threads``.  K1 runs
one CTA per row; its threads stride over the row's lanes, and each event
ends in a block-wide argmin with its barriers.  For each case (the
``Driver.cu`` slice's FD stack of 3000 rows, config 3's map evaluation,
config 4's f32 discovery pass of 64 rows and its f64 Newton stage of 256
rows, each every lane and with a window of 128 or 512 lanes), every thread
count in ``THREADS``: the kernel's device time by ``torch.profiler`` (mean
of 3 calls) and whether its rows equal those of the default block (or why
the launch was refused).  More threads a row also stand in for splitting a
row across SMs: where a 64-row pass stops speeding up with more threads on
its SM, its event is bound by its serial chain, which a split across a
cluster would lengthen by a cluster barrier an event.
Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THREADS = (64, 128, 256, 512, 1024)
# (name, N, realisations, points, dtype, window)
CASES = (("slice_fd_stack", 512, 1000, 3, "float32", 128),
         ("config3_map", 1024, 1024, 1, "float32", 128),
         ("config4_discovery", 4096, 64, 1, "float32", 512),
         ("config4_f64_stage", 4096, 64, 4, "float64", 512))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("evolve_threads_study: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.model import evolve_cuda
    dev = torch.device("cuda")
    default_threads = evolve_cuda.default_threads
    rows = []
    for name, N, R, P, dtype, W in CASES:
        cfg = pt.ModelConfig(n_neurons=N, n_real=R, dtype=dtype)
        params = pt.MapParams.create(cs.BETA, cs.SIGMA, dtype=dtype,
                                     device=dev)
        beta = pt.sample_beta(cfg, params,
                              torch.Generator(device=dev).manual_seed(0))
        Z = cs.fd_stack(torch, dev, cfg.torch_dtype, 1e-6)[:P]
        ii = pt.initial_spike_indices(cfg, Z).contiguous()
        v0, s0 = (x.contiguous() for x in pt.lift(cfg, params,
                                                    pt.z_to_u(Z)))
        for window in (0, W):
            c = cfg.with_(evolve_window=window)
            ref = evolve_cuda.evolve_ensemble_cuda(c, v0, s0, beta, ii)
            row = {"case": name, "N": N, "rows": P * R, "dtype": dtype,
                   "evolve_window": window,
                   "default_threads": default_threads(
                       N, P * R, torch.cuda.get_device_properties(
                           dev).multi_processor_count, cfg.torch_dtype)}

            def call():
                return evolve_cuda.evolve_ensemble_cuda(c, v0, s0, beta, ii)
            for threads in THREADS:
                # the wrapper takes its block size from default_threads
                evolve_cuda.default_threads = lambda *_, t=threads: t
                try:
                    res = call()
                    us = cs.device_us(call, torch, n=3)[0]
                except RuntimeError as exc:   # more registers than a block has
                    row[f"device_ms_{threads}"] = repr(exc)
                    continue
                finally:
                    evolve_cuda.default_threads = default_threads
                row[f"device_ms_{threads}"] = None if us is None else us / 1e3
                row[f"equal_{threads}"] = all(
                    bool(torch.equal(getattr(res, f), getattr(ref, f)))
                    for f in ref._fields)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"evolve_threads_study": rows, "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
