#!/usr/bin/env python3
"""End-to-end walls of two checkouts, in turns in one process, on one CUDA
card.

    python3 tools/turns_wall.py [checkout] --against OTHER [--rounds 2]
        [--sweep-steps 30] [--walk]

Imports ``armadillocudalinearinterpolation_torch`` from ``checkout``
(default: this script's repository) and from ``OTHER`` (under another
module name), builds both kernel libraries (not timed), and runs, for each
package in turns (OTHER, checkout, checkout, OTHER, ``--rounds`` times):

- the config-3 map evaluation (N=1024, R=1024, f32, sigma 0.1,
  ``evolve_window=128``, the draw of seed 0, at the ``Driver.cu`` guess;
  the median of 6 evaluations, CUDA events around each) and its lift
  alone (``pkg.lift`` of the point, median of 6);
- the warm config-4 staged solve (``newton_solve_staged`` at N=4096,
  R=64, f64, sigma 0.1, ``evolve_window=512`` to 1e-8 from the guess +
  1e-3, after one cold solve from the guess; host clock to a
  synchronise);
- one exact Jacobian at config 4 (``F.value_and_jacobian`` at the guess,
  noise of seed 0) and its lift tangents (``emap.lift_tangents``, D=3),
  medians of 5 (CUDA events);
- config 5 (N=512, R=1024, f32, sigma 0.1, W=128): one warm step on the
  slow family at the FD step 3e-4 split as ``chip_smoke.py``'s
  ``warm_step_breakdown`` splits it (``lift_ms``), and the first
  ``--sweep-steps`` steps of ``sweep_100pt`` (s/step);

and with ``--walk`` the artifact's arclength walk (``chip_smoke.py``'s
``walkers`` plan: N=512, R=4, sigma 0, f64, 70 steps with
``--stability``) through each package's ``cli.driver.main``, once each in
the same order.  Configurations and constants come from this repository's
``chip_smoke.py``.  Prints one JSON object: every wall, and the medians.
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


def walls(pkg, cs, torch, dev, sweep_steps):
    """One turn of ``pkg``: the walls of the module docstring, as a
    dict, and the config-4 solve's result."""
    emap = sys.modules[pkg.__name__ + ".model.emap"]
    cfg3 = pkg.ModelConfig(n_neurons=cs.MAP_N, n_real=cs.MAP_R,
                           dtype="float32", evolve_window=cs.MAP_WINDOW)
    p3 = pkg.MapParams.create(cs.BETA, cs.SIGMA, dtype="float32", device=dev)
    F = pkg.make_residual_fn(cfg3, p3, 0, device=dev)
    z3 = torch.tensor(cs.INITIAL_GUESS, dtype=torch.float32, device=dev)
    U3 = pkg.z_to_u(z3)
    F(z3)
    out = {"config3_map_ms": statistics.median(
        cs.cuda_ms(lambda: F(z3), torch)[0] for _ in range(6)),
        "config3_lift_ms": statistics.median(
            cs.cuda_ms(lambda: pkg.lift(cfg3, p3, U3), torch)[0]
            for _ in range(6))}
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
    out["config4_warm_solve_s"] = time.perf_counter() - t0
    F4 = pkg.make_residual_fn(cfg4, p4, 0, device=dev)
    zj = torch.tensor(cs.INITIAL_GUESS, dtype=torch.float64, device=dev)
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    zero = torch.zeros(3, 1, 1, dtype=torch.float64, device=dev)
    for key, fn in (("config4_exact_jacobian_ms",
                     lambda: F4.value_and_jacobian(zj)),
                    ("config4_lift_tangents_ms",
                     lambda: emap.lift_tangents(cfg4, p4, zj[None],
                                                eye[:, None], zero))):
        fn()
        out[key] = statistics.median(cs.cuda_ms(fn, torch)[0]
                                     for _ in range(5))
    cfg5 = pkg.ModelConfig(**cs.CONFIG5)
    counters = {"evaluations": 0}
    slow = cs.sweep_solver(pkg, dev, cfg5, pkg.NewtonConfig(
        **dict(cs.SWEEP_NEWTON, fd_epsilon=cs.SLICE_FD_EPSILON)), counters)
    first = slow(cs.BETA, torch.tensor(cs.INITIAL_GUESS,
                                       dtype=torch.float32, device=dev))
    step = cs.warm_step_breakdown(pkg, torch, emap, slow,
                                  cs.BETA + cs.SWEEP_BETA_STEP,
                                  first.solution)
    out["config5_warm_step_ms"] = step["wall_ms_median_of_3"]
    out["config5_lift_ms"] = step["lift_ms"]
    out["config5_idle_share"] = step["idle_share"]
    solve = cs.sweep_solver(pkg, dev, cfg5, pkg.NewtonConfig(
        **cs.SWEEP_NEWTON), counters)
    steps, cs.SWEEP_STEPS = cs.SWEEP_STEPS, sweep_steps
    try:
        run = cs.run_sweep(pkg, torch, dev, solve, True)
    finally:
        cs.SWEEP_STEPS = steps
    out["config5_sweep_100pt_s_per_step"] = run["s_per_step"]
    out["config5_sweep_n_conv"] = run["n_conv"]
    return out, res


def walk_s(pkg, cs, torch) -> dict:
    """The artifact's arclength walk through ``pkg``'s CLI: wall, rc and
    steps."""
    import tempfile
    import importlib
    driver = importlib.import_module(pkg.__name__ + ".cli.driver")
    checkpoint = sys.modules[pkg.__name__ + ".utils.checkpoint"]
    with tempfile.TemporaryDirectory() as d:
        argv = cs.WALK_SMALL + cs.WALK_ROOT + [
            "--arclength", "--fd-mode", "exact", "--tol", "1e-9",
            "--max-iter", "12", "--ds", "0.3", "--steps", "70",
            "--stability", "--quiet", "--checkpoint", d]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, _ = cs.run_cli(driver, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(checkpoint.ContinuationCheckpoint(d).load_all())
    return {"wall_s": wall, "rc": rc, "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=str(ROOT))
    ap.add_argument("--against", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep-steps", type=int, default=30)
    ap.add_argument("--walk", action="store_true")
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
    out = {k: {"converged": []} for k in pkgs}
    order = ("other", "checkout", "checkout", "other")
    for _ in range(a.rounds):
        for name in order:
            turn, res = walls(pkgs[name], cs, torch, dev, a.sweep_steps)
            for k, v in turn.items():
                out[name].setdefault(k, []).append(v)
            out[name]["converged"].append(bool(res.converged))
    if a.walk:
        for name in order:
            out[name].setdefault("artifact_walk", []).append(
                walk_s(pkgs[name], cs, torch))
    for v in out.values():
        v["medians"] = {k: statistics.median(x) for k, x in v.items()
                        if x and isinstance(x[0], float)}
    print(json.dumps({"checkout": str(Path(a.checkout).resolve()),
                      "against": str(Path(a.against).resolve()),
                      "walls": out, "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
