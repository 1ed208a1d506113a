#!/usr/bin/env python3
"""The config-3 map wall and the warm config-4 staged solve of two
checkouts, in turns in one process, on one CUDA card.

    python3 tools/turns_wall.py [checkout] --against OTHER [--rounds 2]

Imports ``armadillocudalinearinterpolation_torch`` from ``checkout``
(default: this script's repository) and from ``OTHER`` (under another
module name), builds both kernel libraries (not timed), and runs each
package's config-3 map evaluation (N=1024, R=1024, f32, sigma 0.1,
``evolve_window=128``, the draw of seed 0, at the ``Driver.cu`` guess;
the median of 6 evaluations, CUDA events around each) and its warm
config-4 staged solve (``newton_solve_staged`` at N=4096, R=64, f64,
sigma 0.1, ``evolve_window=512`` to 1e-8 from the guess + 1e-3, after one
cold solve from the guess; host clock to a synchronise) in turns: OTHER,
checkout, checkout, OTHER, ``--rounds`` times.  Configurations and
constants come from this repository's ``chip_smoke.py``.  Prints one JSON
object: every wall, and the medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

PKG = "armadillocudalinearinterpolation_torch"
ROOT = Path(__file__).resolve().parent.parent


def load_as(name: str, checkout: Path):
    spec = importlib.util.spec_from_file_location(
        name, checkout / PKG / "__init__.py",
        submodule_search_locations=[str(checkout / PKG)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def walls(pkg, cs, torch, dev):
    """``(map_ms, solve_s)``: the config-3 map's median of 6 and one warm
    config-4 solve of ``pkg``, and the solve's result."""
    cfg3 = pkg.ModelConfig(n_neurons=cs.MAP_N, n_real=cs.MAP_R,
                           dtype="float32", evolve_window=cs.MAP_WINDOW)
    p3 = pkg.MapParams.create(cs.BETA, cs.SIGMA, dtype="float32", device=dev)
    F = pkg.make_residual_fn(cfg3, p3, 0, device=dev)
    z3 = torch.tensor(cs.INITIAL_GUESS, dtype=torch.float32, device=dev)
    F(z3)
    map_ms = statistics.median(cs.cuda_ms(lambda: F(z3), torch)[0]
                               for _ in range(6))
    cfg4 = pkg.ModelConfig(**cs.CONFIG4)
    p4 = pkg.MapParams.create(cs.BETA, cs.SIGMA, dtype="float64", device=dev)
    beta = pkg.sample_beta(cfg4, p4,
                           torch.Generator(device=dev).manual_seed(0))
    z4 = torch.tensor(cs.INITIAL_GUESS, dtype=torch.float32,
                      device=dev) + 1e-3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pkg.newton_solve_staged(cfg4, p4, z4, beta=beta,
                                  tolerance=cs.STAGED_TOL)
    torch.cuda.synchronize()
    return map_ms, time.perf_counter() - t0, res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=str(ROOT))
    ap.add_argument("--against", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("turns_wall: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pkgs = {"other": load_as("other_pkg", Path(a.against).resolve()),
            "checkout": load_as("checkout_pkg", Path(a.checkout).resolve())}
    for name, pkg in pkgs.items():
        sys.modules[pkg.__name__ + "._build"].load_library()
        cfg4 = pkg.ModelConfig(**cs.CONFIG4)
        p4 = pkg.MapParams.create(cs.BETA, cs.SIGMA, dtype="float64",
                                  device=dev)
        pkg.newton_solve_staged(  # the cold solve of each package
            cfg4, p4, torch.tensor(cs.INITIAL_GUESS, dtype=torch.float32,
                                   device=dev),
            beta=pkg.sample_beta(cfg4, p4, torch.Generator(
                device=dev).manual_seed(0)), tolerance=cs.STAGED_TOL)
    out = {k: {"config3_map_ms": [], "config4_warm_solve_s": [],
               "converged": []} for k in pkgs}
    for _ in range(a.rounds):
        for name in ("other", "checkout", "checkout", "other"):
            map_ms, solve_s, res = walls(pkgs[name], cs, torch, dev)
            out[name]["config3_map_ms"].append(map_ms)
            out[name]["config4_warm_solve_s"].append(solve_s)
            out[name]["converged"].append(bool(res.converged))
    for v in out.values():
        v["medians"] = {k: statistics.median(v[k]) for k in (
            "config3_map_ms", "config4_warm_solve_s")}
    print(json.dumps({"checkout": str(Path(a.checkout).resolve()),
                      "against": str(Path(a.against).resolve()),
                      "walls": out, "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
