"""Deep-tolerance continuation on the port: the reference's production
loop at 1e-8.

The reference's commented-out sweep (``Driver.cu:86-114``) steps ``beta``
by 0.1, Newton-solves each point to 1e-4 in double and counts unstable
eigenvalues.  This example runs the same loop at 1e-8 with the port's
staged solver (``solvers/staged.py``): an f32 Newton on the evolve kernel
(K1), a frozen-schedule Newton on the fp64 replay kernel (K2; the one-
sided stencil) and a frozen-Jacobian polish, as ``examples/deep_sweep.py``
does for the JAX package.  Each step warm-starts from the previous root,
draws its heterogeneity from a generator reseeded per step (the
reference's ``PostProcess -> SetNewSeed``) and reads stability from the
exported stage-2 Jacobian.  ``--shard N`` runs every solve over N ranks
that split the realisations (:mod:`armadillocudalinearinterpolation_torch.
parallel`): the same roots up to the reassociated ensemble sum.  Runs on
the CUDA card; ``--cpu`` takes the plain PyTorch kernels.  Imports no JAX.

Run:  python examples/deep_sweep_torch.py [--cpu] [--steps N]
      [--realisations R] [--shard N]
(CPU at --steps 1 --realisations 4: about half a minute.)
"""

import argparse
import sys
from pathlib import Path

import torch

try:
    import armadillocudalinearinterpolation_torch as pt
except ModuleNotFoundError:                      # run from a source checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.parallel import (ShardGroup,
                                                             run_ranks)


def sweep(n_steps: int, n_real: int, device: str, sharded: bool) -> list:
    """The sweep; returns one line per step (printed by the caller)."""
    cfg = pt.ModelConfig(n_neurons=512, n_real=n_real, dtype="float64",
                         root_tol=1e-12, max_events=2048)
    group = ShardGroup(cfg.n_real) if sharded else None
    device = torch.device(device)
    Z = torch.tensor([0.3310, 0.6914, 1.3557], dtype=torch.float64,
                     device=device)                       # Driver.cu:24
    beta = 13.0589                                        # Driver.cu:16
    lines = []
    for step in range(n_steps):
        params = pt.MapParams.create(beta, 0.0, dtype="float64",
                                     device=device)
        gen = torch.Generator(device=device).manual_seed(step)
        res = pt.newton_solve_staged(cfg, params, Z, seed=gen,
                                     device=device, tolerance=1e-8,
                                     group=group)
        if not res.converged:
            lines.append(f"step {step}: did not converge at beta={beta:.4f}"
                         f" (|r|={res.residual_norm:.3e}): branch end")
            return lines
        ev = pt.compute_eigenvalues(None, res.solution,
                                    pt.ProblemType.EQUATION_FREE,
                                    jacobian=res.jacobian)
        n_unstable = pt.count_unstable(ev, pt.ProblemType.EQUATION_FREE)
        lines.append(f"step {step}: beta={beta:.4f} "
                     f"|r|={res.residual_norm:.2e} "
                     f"Z={[round(float(z), 6) for z in res.solution]} "
                     f"unstable={int(n_unstable)}")
        # warm start and reseed, as the reference loop does
        Z = res.solution
        beta += 0.1
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch kernels)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--realisations", type=int, default=8)
    ap.add_argument("--shard", type=int, default=0, metavar="N",
                    help="solve over N ranks (0 or 1: unsharded)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA card: pass --cpu", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    if args.shard > 1:
        lines = run_ranks(sweep, args.shard, args.steps, args.realisations,
                          device, True, device=device)[0]
    else:
        lines = sweep(args.steps, args.realisations, device, False)
    print("\n".join(lines))
    return 0 if len(lines) == args.steps and "branch end" not in lines[-1] \
        else 1


if __name__ == "__main__":
    sys.exit(main())
