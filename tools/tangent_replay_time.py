#!/usr/bin/env python3
"""Time the tangent replay kernel (K2T) at config 4 on one CUDA card.

    python3 tools/tangent_replay_time.py [checkout]

Config 4 (N=4096, R=64, f64, sigma 0.1, root_tol 1e-12, max_events 4096,
``evolve_window=512``) at the ``Driver.cu`` guess: K2T at D=4 (three Z
directions and the beta axis) and D=3 on the f32 discovery's order, and K2
on the same inputs; per kernel the median of 5 calls by CUDA events and
the device µs by ``torch.profiler`` (``chip_smoke.device_us``).  Runs the
package of ``checkout`` (this repository by default), so that two versions
can be timed in turns in one call on one card; ``chip_smoke.py`` is loaded
from this repository.  Prints one JSON object.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    checkout = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, str(checkout))
    import torch
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.model import emap, replay_cuda
    from armadillocudalinearinterpolation_torch.model.replay import (
        compute_schedule)
    dev = torch.device("cuda")
    f64 = torch.float64
    cfg = pt.ModelConfig(**cs.CONFIG4)
    params = pt.MapParams.create(cs.BETA, cs.SIGMA, dtype="float64",
                                 device=dev)
    noise = pt.sample_noise(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    beta = pt.beta_from_noise(cfg, params, noise).contiguous()
    z = torch.tensor(cs.INITIAL_GUESS, dtype=f64, device=dev)[None]
    ii = pt.initial_spike_indices(cfg, z).contiguous()
    out = {"checkout": str(checkout), "card": cs.nvidia_smi()}
    for D in (4, 3):
        eye = torch.eye(D, dtype=f64, device=dev)
        dp = (eye[:, 3:].reshape(D, 1) if D == 4
              else torch.zeros(D, 1, dtype=f64, device=dev))
        _, _, v0, s0, dv0, ds0 = emap.lift_tangents(
            cfg, params, z, eye[:, None, :3], dp[:, :, None])
        sched, n_ev = compute_schedule(cfg, v0, s0, beta, ii)
        dbeta = emap.rate_tangents(cfg, beta, noise, dp,
                                   "beta" if D == 4 else None)
        args = (cfg, sched, n_ev, v0, s0, beta, ii, dv0, ds0, dbeta)

        def run():
            return replay_cuda.replay_events_tangent_cuda(*args)
        run()
        ms = statistics.median(cs.cuda_ms(run, torch)[0] for _ in range(5))
        _, per = cs.device_us(run, torch, n=3)
        out[f"k2t_D{D}"] = {"ms": ms, "device_us": next(
            (v for k, v in per.items() if "replay_tangent_kernel" in k),
            None)}
    k2 = args[:7]
    out["k2_ms"] = statistics.median(cs.cuda_ms(
        lambda: replay_cuda.replay_events_cuda(*k2), torch)[0]
        for _ in range(5))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
