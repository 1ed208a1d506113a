"""Quickstart for the PyTorch/CUDA port: solve, analyse and continue the
event-driven map.

Mirrors the reference driver's flow (``Driver.cu:11-126``: build the map,
smoke-test ``ComputeF``, Newton-solve, check stability, step the
parameter) through the port's public API, as ``examples/quickstart.py``
does for the JAX package.  It runs on the CUDA card (the hand-written
kernels, built with ``nvcc`` at first use); ``--cpu`` runs the kernels'
plain PyTorch versions instead.  Imports no JAX.

Run:  python examples/quickstart_torch.py [--cpu] [--neurons N]
      [--realisations R]
(CPU at --realisations 4: about a minute.)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch kernels)")
    ap.add_argument("--neurons", type=int, default=512)
    ap.add_argument("--realisations", type=int, default=64)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA card: pass --cpu", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    # ------------------------------------------------------------ setup --
    # Model constants live in a frozen config (the reference's
    # parameters.hpp); (beta, sigma) are the continuation parameters.
    cfg = pt.ModelConfig(n_neurons=args.neurons, n_real=args.realisations,
                         dtype="float64")
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64",
                                 device=device)
    # Driver.cu:24 initial guess: (wave speed c, spike offsets 2 and 3)
    Z0 = torch.tensor([0.3310, 0.6914, 1.3557], dtype=torch.float64,
                      device=device)

    # ---------------------------------------------------------- the map --
    # One heterogeneity draw, reused by every evaluation (common random
    # numbers: the reference's ResetSeed before each ComputeF).
    F = pt.make_residual_fn(cfg, params, 0, device=device)
    print(f"smoke test |F(Z0)| = {float(torch.linalg.vector_norm(F(Z0))):.6e}")

    # ---------------------------------------------------------- solving --
    ncfg = pt.NewtonConfig(tolerance=1e-10, max_iterations=15,
                           fd_epsilon=1e-7)
    res = pt.newton_solve(F, Z0, ncfg)
    print(f"newton: converged={res.converged} iters={res.iterations} "
          f"|F|={res.residual_norm:.3e}")
    print(f"solution (c, x2, x3) = {res.solution.tolist()}")

    # -------------------------------------------------------- stability --
    n_unstable = pt.num_unstable_eigenvalues(
        F, res.solution, pt.ProblemType.EQUATION_FREE,
        jacobian=res.jacobian)
    print(f"unstable eigenvalues: {int(n_unstable)}")

    # ------------------------------------------------ deep-tolerance solve --
    # The staged recipe (f32 Newton on K1 -> frozen-schedule Newton on the
    # fp64 replay K2 -> frozen-Jacobian polish) reaches |F| <= 1e-8; the
    # draw is passed so that it solves the same realisation as above.
    deep = pt.newton_solve_staged(cfg, params, Z0, beta=F.beta,
                                  tolerance=1e-8)
    print(f"staged: converged={deep.converged} |F|={deep.residual_norm:.3e}")

    # ------------------------------------------------------- sweep step --
    params2 = pt.MapParams.create(13.1589, 0.1, dtype="float64",
                                  device=device)
    step2 = pt.newton_solve_staged(cfg, params2, deep.solution,
                                   beta=pt.beta_from_noise(cfg, params2,
                                                           F.noise),
                                   tolerance=1e-8)
    print(f"sweep step beta=13.1589: converged={step2.converged} "
          f"|F|={step2.residual_norm:.3e}")

    # For production sweeps, sharding over ranks (--shard), branch
    # switching, fold and boundary tracking and checkpoints, use the CLI:
    #   python -m armadillocudalinearinterpolation_torch.cli.driver --help
    return 0 if deep.converged and step2.converged else 1


if __name__ == "__main__":
    sys.exit(main())
