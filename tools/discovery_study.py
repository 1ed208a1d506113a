#!/usr/bin/env python3
"""Which discovery pass the staged solve needs, on one CUDA card.

    python3 tools/discovery_study.py [--neurons 4096] [--realisations 64]
                                     [--max-events 4096]

At config 4 by default (N=4096, R=64, f64, sigma 0.1, the seed-0 draw of
``chip_smoke.py``), or at the N, R and event-log bound given, it prints one
JSON object with:

* the drift of the f32 evolve's crossing times from the fp64 evolve's, at
  the fp64 root, on rows with the same outcome;
* rows where the replay of the f32 discovery log and the direct fp64 evolve
  disagree, and the two maps' residuals there, for discovery passes that
  stop at ``T`` (the JAX package's), at ``T + DISCOVERY_MARGIN`` (the
  port's) and in fp64;
* the times of one discovery pass in f32 and in fp64 (CUDA events);
* ``newton_solve_staged`` to 1e-8 from the ``Driver.cu`` guess and from it
  + 1e-3 with each discovery pass: wall, iterations, the replay map's
  residual and the direct fp64 map's at the solution.

Imports no JAX; needs the port's kernels (built at first use).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GUESS = (0.3310, 0.6914, 1.3557)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--neurons", type=int, default=4096)
    p.add_argument("--realisations", type=int, default=64)
    p.add_argument("--max-events", type=int, default=4096)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("discovery_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.model import (
        emap, evolve_cuda, replay, replay_cuda)

    dev = torch.device("cuda")
    cfg = pt.ModelConfig(n_neurons=args.neurons, n_real=args.realisations,
                         dtype="float64", root_tol=1e-12,
                         max_events=args.max_events)
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64", device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    E = replay.schedule_width(cfg)
    F_direct = pt.make_residual_fn(cfg, params, 0, device=dev, beta=beta,
                                   evolve_backend="cuda")
    F_replay = pt.make_residual_fn(cfg, params, 0, device=dev, beta=beta,
                                   evolve_backend="replay")

    def norm(F, z):
        return float(torch.linalg.vector_norm(F(z)))

    def lifted(z):
        Z = torch.as_tensor(z, dtype=torch.float64, device=dev)[None]
        v0, s0 = pt.lift(cfg, params, pt.z_to_u(Z))
        return (v0.contiguous(), s0.contiguous(),
                pt.initial_spike_indices(cfg, Z).contiguous())

    def cuda_ms(fn):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    # the direct fp64 map's root, by central FD Newton from the guess
    root = pt.newton_solve(F_direct, torch.tensor(GUESS, dtype=torch.float64,
                                                  device=dev),
                           pt.NewtonConfig(tolerance=1e-8, max_iterations=10,
                                           fd_epsilon=1e-5,
                                           fd_mode="central"))
    v0, s0, ii = lifted(root.solution)
    r32 = evolve_cuda.evolve_ensemble_cuda(
        replay.schedule_config(cfg), v0.float(), s0.float(), beta.float(),
        ii)
    r64 = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii)
    same = ((r32.crossed_ind == r64.crossed_ind).all(1)
            & (r32.last_ind == r64.last_ind).all(1))
    drift = (r32.crossed_time.double() - r64.crossed_time)[same].abs()
    out = {"card": torch.cuda.get_device_name(0),
           "config": {"n_neurons": cfg.n_neurons, "n_real": cfg.n_real,
                      "max_events": cfg.max_events,
                      "discovery_margin": replay.DISCOVERY_MARGIN},
           "direct_root": {"solution": root.solution.tolist(),
                           "iterations": root.iterations,
                           "residual_norm": root.residual_norm},
           "f32_crossing_drift_at_root": {"median": float(drift.median()),
                                          "max": float(drift.max()),
                                          "rows": int(same.sum())}}

    def f64_discovery(cfg_, v0_, s0_, beta_, ii_, n_real=None):
        res, sched = evolve_cuda.evolve_ensemble_cuda(
            cfg_, v0_.contiguous(), s0_.contiguous(), beta_.contiguous(),
            ii_.contiguous(), record_schedule=replay.schedule_width(cfg_),
            n_real=n_real)
        return sched, res.n_events

    margin, f32_discovery = replay.DISCOVERY_MARGIN, replay.compute_schedule
    variants = {"f32_stop_at_T": (0.0, f32_discovery),
                "f32_margin": (margin, f32_discovery),
                "f64": (margin, f64_discovery)}
    for name, (m, discover) in variants.items():
        replay.DISCOVERY_MARGIN = m
        replay.compute_schedule = emap.compute_schedule = discover
        try:
            sched, n_ev = discover(cfg, v0, s0, beta, ii)
            rep = replay_cuda.replay_events_cuda(cfg, sched, n_ev, v0, s0,
                                                 beta, ii[0])
            row = {"rows_rejected_by_replay_only": int(
                       (r64.accept & ~rep.accept).sum()),
                   "replay_norm_at_direct_root": norm(F_replay,
                                                      root.solution),
                   "discovery_ms": cuda_ms(lambda: discover(cfg, v0, s0,
                                                            beta, ii))}
            z0 = torch.tensor(GUESS, dtype=torch.float32, device=dev)
            for start, z in (("guess", z0), ("guess+1e-3", z0 + 1e-3)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = pt.newton_solve_staged(cfg, params, z, beta=beta,
                                             tolerance=1e-8)
                torch.cuda.synchronize()
                row[start] = {"wall_s": time.perf_counter() - t0,
                              "converged": res.converged,
                              "iterations": res.iterations,
                              "replay_norm": res.residual_norm,
                              "direct_norm": norm(F_direct, res.solution),
                              "solution": res.solution.tolist()}
            out[name] = row
        finally:
            replay.DISCOVERY_MARGIN = margin
            replay.compute_schedule = emap.compute_schedule = f32_discovery
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
