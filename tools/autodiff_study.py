#!/usr/bin/env python3
"""The map's Jacobian by PyTorch's own forward-mode AD against its exact
Jacobian, on one CUDA card (or on the CPU with ``--cpu``).

    python3 tools/autodiff_study.py [--checkout DIR] [--neurons N]
        [--realisations R] [--sigma S] [--backend B] [--root-tol T] [--cpu]

Imports ``armadillocudalinearinterpolation_torch`` from ``DIR`` (default:
this script's repository), closes the map over a draw made from seed 0 at
the configuration given (f64; default N=512, R=4, sigma 0.1, the default
``root_tol``) and takes, at the point (0.3262, 0.7194, 1.3690):

- ``F.value_and_jacobian(Z)``, the exact Jacobian (the reference);
- column 0 by ``torch.autograd.forward_ad`` and by ``torch.func.jvp``;
- ``torch.func.jacfwd(F)(Z)``, and ``solvers.newton.jacfwd_cols(F)(Z)``
  where the checkout has it;

each with its wall in ms (host clock around work that ends in a
synchronise; the second of two calls), its K1 and K2T launches and its
largest relative difference from the exact Jacobian (``max |a - b| /
max |b|``).  A route that raises records its error.  Prints one JSON
object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

PKG = "armadillocudalinearinterpolation_torch"
Z_POINT = (0.3262, 0.7194, 1.3690)


def load(checkout: Path):
    spec = importlib.util.spec_from_file_location(
        PKG, checkout / PKG / "__init__.py",
        submodule_search_locations=[str(checkout / PKG)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PKG] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--neurons", type=int, default=512)
    ap.add_argument("--realisations", type=int, default=4)
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--root-tol", type=float, default=1e-6)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.autograd.forward_ad as fwAD
    if not args.cpu and not torch.cuda.is_available():
        print("autodiff_study: no CUDA card (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    pt = load(args.checkout.resolve())
    evolve_cuda = sys.modules[PKG + ".model.evolve_cuda"]
    replay_cuda = sys.modules[PKG + ".model.replay_cuda"]
    newton = sys.modules[PKG + ".solvers.newton"]
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = pt.ModelConfig(n_neurons=args.neurons, n_real=args.realisations,
                         dtype="float64", root_tol=args.root_tol)
    params = pt.MapParams.create(13.0589, args.sigma, dtype="float64")
    F = pt.make_residual_fn(cfg, params, 0, device=dev,
                            evolve_backend=args.backend)
    Z = torch.tensor(Z_POINT, dtype=torch.float64, device=dev)
    e0 = torch.zeros_like(Z)
    e0[0] = 1.0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def forward_ad():
        with fwAD.dual_level():
            out = F(fwAD.make_dual(Z, e0))
            return fwAD.unpack_dual(out).tangent

    routes = {
        "value_and_jacobian": lambda: F.value_and_jacobian(Z)[1],
        "forward_ad_column0": forward_ad,
        "func_jvp_column0": lambda: torch.func.jvp(F, (Z,), (e0,))[1],
        "func_jacfwd": lambda: torch.func.jacfwd(F)(Z),
    }
    if hasattr(newton, "jacfwd_cols"):
        routes["jacfwd_cols"] = lambda: newton.jacfwd_cols(F)(Z)
    out = {"checkout": str(args.checkout), "device": str(dev),
           "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "torch": torch.__version__,
           "config": {"n_neurons": args.neurons,
                      "n_real": args.realisations, "sigma": args.sigma,
                      "root_tol": args.root_tol, "backend": args.backend},
           "routes": {}}
    want = None
    for name, fn in routes.items():
        rec = {}
        try:
            for _ in range(2):
                evolve_cuda.LAUNCHES = replay_cuda.TANGENT_LAUNCHES = 0
                sync()
                t0 = time.perf_counter()
                got = fn()
                sync()
                rec["ms"] = (time.perf_counter() - t0) * 1e3
            rec["k1_launches"] = evolve_cuda.LAUNCHES
            rec["k2t_launches"] = replay_cuda.TANGENT_LAUNCHES
            got = got.detach()
            if want is None:
                want = got
            ref = want if got.ndim == 2 else want[:, 0]
            rec["value"] = got.cpu().tolist()
            rec["max_rel_diff"] = float((got - ref).abs().max()
                                        / ref.abs().max())
        except Exception as e:  # a route that raises is a finding
            rec["error"] = f"{type(e).__name__}: {e}"[:400]
        out["routes"][name] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
