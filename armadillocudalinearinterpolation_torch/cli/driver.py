"""Continuation driver: the reference application as a CLI, on the card.

Reference: ``Driver.cu:11-126``: set up the problem at ``beta = 13.0589``,
smoke-test ``ComputeF``, Newton-solve from the known initial guess, then (the
commented-out production loop, ``Driver.cu:86-114``) sweep ``beta`` in steps
of 0.1, checking stability at every converged point.  The port of the JAX
package's ``cli/driver.py``: every knob is a flag, the sweep checkpoints each
step (:mod:`..utils.checkpoint`, the JAX package's format) and resumes.

The CLI runs on the CUDA card; ``--cpu`` runs it on the CPU (the plain
PyTorch versions of the kernels).  Without ``--cpu`` and without a card it
exits 2: it never carries on on the CPU.

Reseeding (the reference's ``PostProcess -> SetNewSeed``,
``EventDrivenMap.cu:343-346``): step ``i`` of a sweep draws its ``(R, N)``
heterogeneity from a ``torch.Generator`` on the run's device seeded with
:func:`step_seed` ``(seed, i)``, and that one draw serves every solve of the
step (the retry too).  A resumed sweep therefore draws what an
uninterrupted one drew without replaying earlier draws; the JAX package
instead splits its key once per completed step and fast-forwards the splits
on resume.  A resumed sweep also restores the secant predictor's pair from
the checkpoint, so its steps repeat the uninterrupted sweep's.

The walkers (``--arclength``, ``--track-fold``, ``--enumerate-branches``,
``--track-boundary``; :mod:`..analysis`) hold ONE noise draw for the whole
walk, from a generator seeded with ``step_seed(seed, 0)``: the draw at
parameter ``(beta, sigma)`` is ``beta + sigma * noise`` (common random
numbers, as the JAX CLI's walkers keep one unsplit key).  Exact Jacobians
(``--fd-mode exact``, ``--stage2-fd exact``) need ``--dtype float64``.

Run:  python -m armadillocudalinearinterpolation_torch.cli.driver --help

``--shard N`` (the JAX package's mesh-sharded solves) runs on N ranks
that split the realisations (a :class:`..parallel.sharding.RankPool`
started for the run, this process rank 0, the others spawned): NCCL
where every rank has a card of its own,
gloo on the CPU or where ranks share a card.  Every rank makes the step's
full draw from the same seed and keeps its rows, so the numbers are the
unsharded run's up to the reassociated ensemble sum.  Rank 0 alone prints,
writes checkpoints, stage dumps (of the whole ensemble, on its own) and
profiles.  It shards the sweep (plain, ``--staged`` and the frozen modes)
and the frozen arclength and branch correctors; elsewhere it is ignored
with a warning, as in the JAX CLI.  A caller that runs many sweeps passes
``main(argv, pool=...)`` a pool of N ranks that it keeps: the ranks then
outlive the run.  The draw goes to ranks 1 .. N-1 pickled.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import (MapParams, ModelConfig, NewtonConfig, ProblemType,
                compute_eigenvalues, count_unstable, event_driven_map,
                make_residual_fn, newton_solve, sample_beta)
from ..model.emap import beta_from_noise, sample_noise
from ..solvers.staged import (FROZEN_MODES, newton_solve_frozen,
                              newton_solve_staged)
from ..utils.checkpoint import ContinuationCheckpoint, ContinuationStep
from ..utils.debug import dump_map_stages
from ..utils.profiling import span, trace

WALKERS = ("arclength", "track_fold", "track_boundary", "enumerate_branches")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="edmap-continue",
        description="Equation-free event-driven-map Newton continuation "
                    "(PyTorch/CUDA)")
    # model (reference parameters.hpp + EventDrivenMap sizes)
    p.add_argument("--neurons", type=int, default=512,
                   help="neurons per realisation (reference: 1024/512)")
    p.add_argument("--realisations", type=int, default=64,
                   help="Monte-Carlo realisations (reference: 1000)")
    p.add_argument("--spikes", type=int, default=3)
    p.add_argument("--beta", type=float, default=13.0589,
                   help="initial mean synaptic rate (Driver.cu:16)")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="heterogeneity std-dev (SetParameterStdDev)")
    p.add_argument("--horizon", type=float, default=5.0)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain PyTorch "
                        "versions); without it the CLI needs a CUDA card")
    # initial guess (Driver.cu:24)
    p.add_argument("--guess", type=float, nargs="+",
                   default=[0.3310, 0.6914, 1.3557])
    # newton (Driver.cu:28-37)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--max-iter", type=int, default=10)
    p.add_argument("--fd-eps", type=float, default=1e-2)
    p.add_argument("--fd-mode",
                   choices=["forward", "central", "exact", "frozen",
                            "frozen-fwd"],
                   default="forward",
                   help="Jacobian mode: forward or central FD on the map; "
                        "exact = the map's exact Jacobian (the fp64 tangent "
                        "replay of the point's firing order, K2T on the "
                        "card; needs --dtype float64); frozen/frozen-fwd = "
                        "fused residual + frozen-schedule FD on the fp64 "
                        "replay map (solvers/staged.py newton_solve_frozen;"
                        " the walkers route them to the frozen bordered "
                        "corrector)")
    p.add_argument("--evolve-backend",
                   choices=["auto", "cuda", "torch", "replay"],
                   default="auto",
                   help="event-loop backend: auto = the CUDA kernel on the "
                        "card, the plain PyTorch evolve on the CPU; cuda = "
                        "the kernel (card only); torch = the plain evolve; "
                        "replay = f32 discovery + fp64 schedule replay")
    p.add_argument("--max-events", type=int, default=None,
                   help="event-log bound of the schedule replay "
                        "(ModelConfig.max_events; ~1.5x the expected event "
                        "count, e.g. 1024 at 512 neurons, 4096 at 4096)")
    p.add_argument("--root-tol", type=float, default=None,
                   help="event-time root-find tolerance (ModelConfig."
                        "root_tol; default 1e-6 = reference parameters.hpp"
                        "). --staged tightens it to 1e-4x --tol by itself")
    p.add_argument("--evolve-window", type=int, default=0,
                   help="certified root-find window in lanes (multiple of "
                        "128; 0 = all lanes); its results equal every "
                        "lane's")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="shard solves over N ranks started here (the "
                        "realisation axis, torch.distributed: NCCL with a "
                        "card per rank, else gloo; the same numbers up to "
                        "the reassociated ensemble sum). Applies to the "
                        "sweep (plain, --staged, frozen modes) and the "
                        "frozen --arclength/--enumerate-branches "
                        "correctors. 0 or 1 = unsharded")
    p.add_argument("--staged", action="store_true",
                   help="solve each sweep step with the staged hybrid-"
                        "precision recipe (f32 Newton -> frozen-schedule "
                        "Newton on the fp64 replay -> frozen-Jacobian "
                        "polish; solvers/staged.py); reaches --tol 1e-8; "
                        "requires --dtype float64")
    p.add_argument("--stage2-fd",
                   choices=["frozen-fwd", "frozen", "exact", "central"],
                   default=None,
                   help="--staged accurate-stage Jacobian mode: frozen-fwd "
                        "(the default) = one-sided frozen-schedule FD, one "
                        "(n+1)-point replay per iteration; frozen = the "
                        "central (2n+1)-point stencil, the default under "
                        "--stability, which eigendecomposes the exported "
                        "Jacobian; exact = exact Jacobians (K2T), the "
                        "default with --evolve-backend cuda or torch; "
                        "central = plain central FD on the full map")
    p.add_argument("--damping", type=float, default=1.0)
    p.add_argument("--quiet", action="store_true")
    # continuation (Driver.cu:86-114)
    p.add_argument("--steps", type=int, default=1,
                   help="continuation steps (reference loop: 100)")
    p.add_argument("--beta-step", type=float, default=0.1)
    p.add_argument("--predict", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="secant predictor for the sweep warm start "
                        "(extrapolate the guess from the two previous "
                        "converged solutions); --no-predict restores the "
                        "reference's plain previous-solution warm start "
                        "(Driver.cu:107-109)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the per-step draws (see step_seed)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="directory for per-step checkpoint (resumable)")
    p.add_argument("--resume", action="store_true",
                   help="resume a sweep from --checkpoint")
    p.add_argument("--debug-dump", type=str, default=None,
                   help="dump every map stage to this directory (.npy)")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run to "
                        "this directory (trace.json): the program's spans "
                        "(cli.*, solvers.*, map.*) around its ops and the "
                        "card's kernels, on one timeline")
    p.add_argument("--stability", action="store_true",
                   help="eigenvalue analysis at each converged point")
    # pseudo-arclength mode (beyond the reference: rounds the folds the
    # naive beta-stepping loop at Driver.cu:86-114 dies at)
    p.add_argument("--arclength", action="store_true",
                   help="pseudo-arclength continuation in (Z, beta) instead "
                        "of naive beta stepping; tracks branches through "
                        "folds")
    p.add_argument("--ds", type=float, default=0.1,
                   help="initial arclength step (adaptive)")
    p.add_argument("--direction", type=float, default=1.0,
                   help="+1: start toward increasing beta; -1: decreasing")
    p.add_argument("--arc-param", choices=["beta", "sigma"], default="beta",
                   help="arclength continuation axis: walk beta holding "
                        "--sigma fixed, or walk sigma holding --beta fixed")
    p.add_argument("--allow-branch-jump", action="store_true",
                   help="disable the corrector step-distance guard: near a "
                        "fold Newton may tunnel to a different solution "
                        "branch (branch-discovery mode)")
    p.add_argument("--enumerate-branches", action="store_true",
                   help="branch-switching enumeration: walk the seed branch "
                        "both ways (guarded), probe each branch end with "
                        "unguarded discovery steps, and walk every new "
                        "family found; --steps bounds each walk")
    p.add_argument("--max-branches", type=int, default=4,
                   help="walk budget for --enumerate-branches")
    p.add_argument("--track-boundary", action="store_true",
                   help="trace the wave family's existence boundary "
                        "beta*(sigma) over --sigma-values "
                        "(analysis/boundary.py)")
    p.add_argument("--sigma-values", type=float, nargs="+",
                   default=[0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5],
                   help="sigma grid for --track-boundary and --track-fold, "
                        "in walk order")
    p.add_argument("--boundary-direction", type=float, default=1.0,
                   help="+1: upper beta boundary; -1: lower")
    p.add_argument("--track-fold", action="store_true",
                   help="continue a smooth fold in two parameters over "
                        "--sigma-values by the Moore-Spence system; "
                        "--guess/--beta must be a near-fold point "
                        "(analysis/fold.py; needs --dtype float64)")
    return p


def step_seed(seed: int, step: int) -> int:
    """The generator seed of sweep step ``step``: ``seed * 2**32 + step``,
    modulo ``2**64`` (distinct for every step below ``2**32``)."""
    return (seed * (1 << 32) + step) % (1 << 64)


def step_draws(cfg, seed: int, device) -> Callable:
    """The sweep's default draws: ``draw(step, params)`` returns the
    ``(R, N)`` draw of step ``step`` at ``params``, from a
    ``torch.Generator`` on ``device`` seeded with ``step_seed(seed,
    step)``."""
    device = torch.device(device)

    def draw(step: int, params) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(
            step_seed(seed, step))
        return sample_beta(cfg, params, gen, device=device)
    return draw


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def predicted_retry_needed(res) -> bool:
    """Whether a secant-PREDICTED sweep step must be retried from the plain
    reference warm start (``Driver.cu:107-109``).

    Any failure qualifies: hard (non-finite iterate: damping-1 Newton from
    an off-branch extrapolation can go straight to NaN, which the sweep's
    non-finite hard-stop would misread as the branch end) or soft (finite
    non-convergence: recording the extrapolated FAILED iterate would seed
    the next step's warm start and compound the miss, diverging from the
    reference loop's behavior).  A genuine branch end fails the retry too,
    so nothing real is masked: the step just costs one extra solve, and
    only on the first failure after a converged pair (a failed step resets
    the predictor)."""
    return not (bool(res.converged) and np.isfinite(_host(res.solution)).all())


def main(argv=None, *, draw: Optional[Callable] = None,
         noise=None, pool=None) -> int:
    """Run the CLI on ``argv``; returns the exit code.

    ``draw(step, params)``, if given, replaces the per-step draws of
    :func:`step_draws`, and ``noise`` (an ``(R, N)`` array) the walkers'
    noise (the parity tests pass the JAX package's draws and noise).
    ``pool``, a :class:`..parallel.sharding.RankPool` of ``--shard``
    ranks on the run's device, runs a sharded run on its ranks in place
    of a pool started for the run.
    """
    with span("cli.setup"):
        args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device is available; the CLI runs on the "
              "card (pass --cpu to run on the CPU)", file=sys.stderr)
        return 2
    if args.shard < 0:
        return _error(f"error: --shard must be >= 0; got {args.shard}")
    if args.shard > args.realisations:
        return _error(f"error: --shard {args.shard} ranks for "
                      f"{args.realisations} realisations: a rank would "
                      "hold none")
    if args.shard > 1 and shard_ignored(args):
        # fold remaps to central FD (Moore-Spence rows), boundary pins the
        # exact f64 path, and the non-frozen walkers' correctors do not
        # shard: say so instead of silently walking unsharded
        print("warning: --shard is ignored here (only the frozen "
              "arclength/branch correctors shard: --arclength/"
              "--enumerate-branches with --fd-mode frozen or frozen-fwd)",
              file=sys.stderr)
        args.shard = 0
    if args.shard <= 1:
        return _profiled_run(args, draw, noise)
    device = "cpu" if args.cpu else "cuda"
    if pool is None:
        from ..parallel import RankPool
        with RankPool(args.shard, device) as own:
            return own.run(_rank_run, args, draw, noise)
    if (pool.world_size, pool.device_type) != (args.shard, device):
        return _error(f"error: --shard {args.shard} on {device} cannot "
                      f"run on a pool of {pool.world_size} rank(s) on "
                      f"{pool.device_type}")
    return pool.run(_rank_run, args, draw, noise)


def shard_ignored(args) -> bool:
    """Whether ``--shard`` has no sharded path in this mode: the fold and
    boundary trackers, and the arclength and branch walkers without a
    frozen corrector (the JAX CLI's ``cli/driver.py:400-411``)."""
    return bool(args.track_fold or args.track_boundary or (
        (args.arclength or args.enumerate_branches)
        and args.fd_mode not in FROZEN_MODES))


def _profiled_run(args, draw, noise, sharded: bool = False) -> int:
    if args.profile:
        with trace(args.profile):
            rc = _run(args, draw, noise, sharded)
        print(f"profiler trace written to {args.profile}/")
        return rc
    return _run(args, draw, noise, sharded)


def _rank_run(args, draw, noise) -> int:
    """One rank of a ``--shard`` run: rank 0 prints and profiles, the
    others run silent (an error still reaches the parent, which stops
    every rank and raises it)."""
    import torch.distributed as dist
    if dist.get_rank() > 0:
        sys.stdout = sys.stderr = open(os.devnull, "w")
        args.profile = None
    return _profiled_run(args, draw, noise, sharded=True)


def _error(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def _run(args, draw: Optional[Callable] = None, noise=None,
         sharded: bool = False) -> int:
    with span("cli.setup"):
        if args.max_events is not None and args.max_events <= 0:
            raise SystemExit(f"--max-events must be positive, "
                             f"got {args.max_events}")
        if args.staged and args.dtype != "float64":
            return _error("error: --staged solves in the accurate dtype; "
                          "pass --dtype float64")
        walker = next((f for f in WALKERS if getattr(args, f)), None)
        if args.dtype != "float64" and (
                args.fd_mode == "exact" or args.stage2_fd == "exact"
                or args.track_fold):
            what = ("--track-fold" if args.track_fold
                    and args.fd_mode != "exact" else "exact Jacobians")
            return _error(f"error: {what} need the fp64 tangent replay; "
                          "pass --dtype float64")
        if args.cpu and args.evolve_backend == "cuda":
            return _error("error: --evolve-backend cuda runs the kernel on "
                          "the card; drop --cpu (or use auto or torch)")
        frozen = args.fd_mode in FROZEN_MODES
        direct = args.evolve_backend in ("cuda", "torch")
        frozen_solve = (args.stage2_fd in FROZEN_MODES if args.staged
                        else frozen)
        if frozen_solve and direct:
            # the frozen solver runs the fp64 replay unconditionally, so an
            # explicit direct backend would be silently ignored and the sweep
            # would converge on a residual it never evaluated
            return _error(
                "error: the frozen modes solve on the fp64 replay map; they "
                f"cannot honor --evolve-backend {args.evolve_backend}. Drop "
                "the backend flag (or use a forward/central mode with it).")

        dev = torch.device("cpu" if args.cpu else "cuda")
        cfg = ModelConfig(n_neurons=args.neurons, n_real=args.realisations,
                          n_spikes=args.spikes, t_horizon=args.horizon,
                          evolve_window=args.evolve_window, dtype=args.dtype,
                          **({"max_events": args.max_events}
                             if args.max_events is not None else {}),
                          **({"root_tol": args.root_tol}
                             if args.root_tol is not None else {}))
        ncfg = NewtonConfig(tolerance=args.tol, max_iterations=args.max_iter,
                            fd_epsilon=args.fd_eps, damping=args.damping,
                            print_output=not args.quiet, fd_mode=args.fd_mode)
        if len(args.guess) != args.spikes:
            return _error(f"error: --guess needs {args.spikes} values")
        group = None
        if sharded:
            from ..parallel import ShardGroup
            group = ShardGroup(cfg.n_real)
        # rank 0 alone writes checkpoints and dumps
        writer = group is None or group.rank == 0
        Z = torch.tensor(args.guess, dtype=cfg.torch_dtype, device=dev)
        beta = args.beta
        if draw is None:
            draw = step_draws(cfg, args.seed, dev)
        # the walkers' one noise for the whole walk
        if walker and noise is None:
            noise = sample_noise(cfg, torch.Generator(device=dev).manual_seed(
                step_seed(args.seed, 0)), device=dev)
        elif walker:
            noise = torch.as_tensor(np.asarray(noise), dtype=cfg.torch_dtype,
                                    device=dev)

        ckpt = (ContinuationCheckpoint(args.checkpoint) if args.checkpoint
                else None)
        start = 0
        # Secant predictor state (beyond the reference's plain warm start,
        # Driver.cu:107-109): the pair is strictly TWO CONSECUTIVE CONVERGED
        # SOLUTIONS, never the caller's initial guess (a guess->solution
        # "secant" is a Newton correction, not a branch tangent: at N=512 R=4
        # f64 it extrapolated step 1 into the coexisting fast family's basin),
        # and a failed step resets it.  When the pair is live, Z itself is the
        # newer converged solution, so one "two steps back" value suffices.
        Z_conv_prev = None   # converged solution two steps back
        Z_is_conv = False    # current Z is a converged solution (not a guess)
        if args.resume:
            if ckpt is None:
                return _error("error: --resume requires --checkpoint")
            done = ckpt.load_all()
            if done and args.arclength:
                # restart FROM the last accepted point: its 'beta' field holds
                # the walked parameter (the walker's predictor moves it), and
                # the walk keeps its one noise
                last = done[-1]
                start = last.index + 1
                beta = last.beta
                Z = torch.tensor(last.solution, dtype=cfg.torch_dtype,
                                 device=dev)
                print(f"resuming arclength walk at step {start} "
                      f"(param={beta:.4f})")
            elif done:
                last = done[-1]
                start = last.index + 1
                beta = last.beta + args.beta_step
                Z = torch.tensor(last.solution, dtype=cfg.torch_dtype,
                                 device=dev)
                # the predictor's state after the last step, as the
                # uninterrupted loop left it
                Z_is_conv = bool(last.converged)
                if (Z_is_conv and len(done) > 1 and done[-2].converged
                        and done[-2].index == last.index - 1):
                    Z_conv_prev = torch.tensor(
                        done[-2].solution, dtype=cfg.torch_dtype, device=dev)
                print(f"resuming at step {start} (beta={beta:.4f})")

        if args.staged:
            # the staged recipe carries its own stage budgets/damping/FD setup
            # (solvers/staged.py); flag knobs that would otherwise silently
            # not take effect
            parser = build_parser()
            ignored = [f for f in ("max_iter", "fd_eps", "fd_mode", "damping")
                       if getattr(args, f) != parser.get_default(f)]
            if ignored:
                flags = ", ".join("--" + f.replace("_", "-") for f in ignored)
                print(f"warning: {flags} ignored with --staged (the staged "
                      "recipe uses its own stage configs; see "
                      "solvers/staged.py)", file=sys.stderr)
            if walker:
                # the walkers dispatch before the staged solve and use their
                # own correctors
                print(f"warning: --staged is ignored with "
                      f"--{walker.replace('_', '-')} (walkers use their own "
                      "correctors; pass --fd-mode frozen for the fused "
                      "frozen-outcome corrector on the replay map)",
                      file=sys.stderr)
        elif args.stage2_fd is not None:
            print("warning: --stage2-fd only takes effect with --staged",
                  file=sys.stderr)
        if (not args.staged and args.fd_mode in ("forward", "central")
                and args.fd_eps >= cfg.dx):
            # (the frozen modes are exempt: they difference the frozen-outcome
            # smooth piece, with no seeding staircase in range, and their
            # radius is clamped)
            # The map's spike-index seeding quantises with the grid, so an FD
            # stencil wider than one cell straddles O(dx) staircase steps and
            # can poison the Jacobian (observed: divergence at N=1024 with the
            # reference's default eps=1e-2).  The reference never hits this
            # because its grid (N=512) is coarser than its epsilon.
            print(f"warning: --fd-eps {args.fd_eps:g} >= grid spacing "
                  f"dx={cfg.dx:.2e}; the FD Jacobian may straddle the map's "
                  "seeding staircase. Consider --fd-eps below dx/4 or "
                  "--fd-mode central.", file=sys.stderr)

        # Smoke test, as in Driver.cu:58-59.  Under --staged and the frozen
        # modes the accurate backend is the replay ("auto" resolves there in
        # the library), so probe THAT.
        smoke_backend = args.evolve_backend
        if (args.staged or frozen) and smoke_backend == "auto":
            smoke_backend = "replay"
        if args.arclength and args.arc_param == "sigma":
            # on a sigma walk the resumed value in `beta` IS the sigma; the
            # held mean rate stays --beta
            params = MapParams.create(args.beta, beta if start > 0
                                      else args.sigma, dtype=args.dtype,
                                      device=dev)
        else:
            params = MapParams.create(beta, args.sigma, dtype=args.dtype,
                                      device=dev)
    with span("cli.smoke"):
        t0 = time.perf_counter()
        f0 = event_driven_map(cfg, params,
                              beta_from_noise(cfg, params, noise) if walker
                              else draw(start, params), Z,
                              evolve_backend=smoke_backend, group=group)
        print("ComputeF smoke test: |f| = "
              f"{float(torch.linalg.vector_norm(f0)):.6e} "
              f"({time.perf_counter() - t0:.2f}s incl. kernel build)")

    if args.debug_dump and writer:
        dump_map_stages(cfg, params, draw(start, params), Z, args.debug_dump)
        print(f"stage dumps written to {args.debug_dump}/")

    if args.track_fold:
        return run_fold(args, cfg, ncfg, noise, Z, beta)
    if args.track_boundary:
        return run_boundary(args, cfg, ncfg, noise, Z, beta)
    if args.enumerate_branches:
        return run_enumerate(args, cfg, ncfg, noise, Z, beta, group)
    if args.arclength:
        return run_arclength(args, cfg, ncfg, noise, Z, beta, ckpt, start,
                             group)

    if args.staged:
        # An unspecified --stage2-fd resolves to the library default
        # (frozen-fwd on the replay; exact on a direct evolve), EXCEPT
        # under --stability on the replay: that eigendecomposes the
        # exported stage-2 Jacobian, where the central frozen stencil's
        # ~3e-7 accuracy (against frozen-fwd's ~3e-6) is the better grade
        # near a stability boundary.
        stage2_fd = args.stage2_fd
        if stage2_fd is None and not direct:
            stage2_fd = "frozen" if args.stability else "frozen-fwd"
        # None defers to the library's backend-aware default; an EXPLICIT
        # flag always builds a config.  An exact stage 2 drives to the
        # polish target itself (one more quadratic iteration beats the
        # polish crawling from the capture range), as the library default
        stage2_ncfg = None
        if args.stage2_fd is not None or stage2_fd == "frozen":
            exact = stage2_fd == "exact"
            stage2_ncfg = NewtonConfig(
                tolerance=(0.9 if exact else 5.0) * args.tol,
                max_iterations=8 if exact else 6,
                fd_mode=stage2_fd,
                fd_epsilon=1e-5 if stage2_fd == "frozen" else 1e-6)

        def solve(p, b, z):
            return newton_solve_staged(cfg, p, z, beta=b,
                                       tolerance=args.tol,
                                       stage2_ncfg=stage2_ncfg,
                                       evolve_backend=args.evolve_backend,
                                       group=group)
    elif frozen:
        # fused frozen-outcome solves on the fp64 replay map: one batched
        # stencil replay per iteration, host-driven
        def solve(p, b, z):
            return newton_solve_frozen(cfg, p, b, z, ncfg, group)
    else:
        def solve(p, b, z):
            F = make_residual_fn(cfg, p, 0, device=dev, beta=b,
                                 evolve_backend=args.evolve_backend,
                                 group=group)
            return newton_solve(F, z, ncfg)

    # (bench.py's sweep deliberately differs on FAILED steps: it retries
    # from the last converged iterate under one draw, while this loop
    # follows the reference and warm-starts from whatever the failed solve
    # returned, and reseeds)
    for i in range(start, start + args.steps):
        with span("cli.step"):
            params = MapParams.create(beta, args.sigma, dtype=args.dtype,
                                      device=dev)
            b = draw(i, params)      # one draw serves every solve of step i
            with span("cli.predict"):
                predicted = args.predict and Z_conv_prev is not None
                guess = Z + (Z - Z_conv_prev) if predicted else Z
            res = solve(params, b, guess)
            with span("cli.predict"):
                retry = predicted and predicted_retry_needed(res)
            if retry:
                how = ("diverged" if not np.isfinite(_host(res.solution)).all()
                       else "did not converge")
                print(f"step {i}: predicted guess {how}; retrying with the "
                      "plain warm start")
                res = solve(params, b, Z)
            sol = _host(res.solution)
            ok = bool(res.converged)
            print(f"step {i}: beta={beta:.4f} converged={ok} "
                  f"iters={int(res.iterations)} "
                  f"|r|={float(res.residual_norm):.3e} "
                  f"Z={np.array2string(sol, precision=5)}")
            if not np.isfinite(sol).all():
                # The branch has ended (no accepted realisations / diverged
                # solve).  Stop cleanly; the checkpoint holds every prior step.
                print(f"step {i}: solution is non-finite — stopping the "
                      f"sweep (branch end or solver failure at "
                      f"beta={beta:.4f})")
                return 1

            n_unstable = None
            eigenvalues = None
            if args.stability:
                with span("cli.stability"):
                    # A 0-iteration GENERIC solve exports the identity
                    # placeholder, not a real Jacobian: fall back to finite
                    # differences then.  The staged and frozen solvers
                    # always export a real one, so theirs is used
                    # unconditionally (the FD fallback at --fd-eps would sit
                    # in the seeding-staircase regime they avoid).
                    exported_real = (int(res.iterations) > 0 or args.staged
                                     or frozen)
                    ev = compute_eigenvalues(
                        make_residual_fn(cfg, params, 0, device=dev, beta=b,
                                         evolve_backend=args.evolve_backend,
                                         group=group),
                        res.solution, ProblemType.EQUATION_FREE,
                        jacobian=res.jacobian if exported_real else None,
                        epsilon=args.fd_eps)
                    eigenvalues = np.asarray(ev)
                    n_unstable = int(count_unstable(ev,
                                                    ProblemType.EQUATION_FREE))
                    verdict = "unstable" if n_unstable else "stable"
                    print("  eigenvalues: "
                          f"{np.array2string(eigenvalues, precision=4)}"
                          f" -> {verdict} ({n_unstable} unstable)")

            if ckpt is not None and writer:
                with span("cli.checkpoint"):
                    ckpt.save(ContinuationStep(
                        index=i, beta=beta, solution=sol,
                        residual_norm=float(res.residual_norm), converged=ok,
                        n_unstable=n_unstable, eigenvalues=eigenvalues))

            # Prepare the next step (Driver.cu:107-109).  Z updates
            # unconditionally like the reference loop; the predictor pair only
            # extends across consecutive converged steps.
            beta += args.beta_step
            if ok:
                Z_conv_prev = Z if Z_is_conv else None
                Z_is_conv = True
            else:
                Z_conv_prev = None
                Z_is_conv = False
            Z = res.solution

    return 0


def _walk_params(args, p: float, device) -> MapParams:
    """The map parameters at walked value ``p`` (``--arc-param``)."""
    if args.arc_param == "sigma":
        return MapParams.create(args.beta, p, dtype=args.dtype,
                                device=device)
    return MapParams.create(p, args.sigma, dtype=args.dtype, device=device)


def run_arclength(args, cfg, ncfg, noise, Z, beta, ckpt, start,
                  group=None) -> int:
    """Pseudo-arclength branch walk (``--arclength``); ``group`` shards
    the frozen corrector."""
    from ..analysis.continuation import continue_branch

    # on resume keep walking the same way: the secant of the last two
    # checkpointed points (a fresh +param tangent would walk backward after
    # a fold)
    tangent0 = None
    if args.resume and ckpt is not None:
        prev = ckpt.load_all()
        if len(prev) >= 2:
            ya = np.concatenate([prev[-2].solution, [prev[-2].beta]])
            yb = np.concatenate([prev[-1].solution, [prev[-1].beta]])
            d = yb - ya
            tangent0 = torch.as_tensor(d / np.linalg.norm(d),
                                       dtype=cfg.torch_dtype,
                                       device=noise.device)
    # on a sigma walk the checkpointed 'beta' field holds the walked sigma:
    # a resumed start value lives in `beta`, the held mean rate is --beta
    if args.arc_param == "sigma":
        walk_beta0 = args.beta
        walk_sigma = beta if start > 0 else args.sigma
    else:
        walk_beta0, walk_sigma = beta, args.sigma

    def on_step(i, step):
        with span("cli.step"):
            b = float(step.y[-1])
            sol = _host(step.y[:-1])
            # --quiet (uniform across walkers): no per-step lines; the summary,
            # the checkpoint and the stability analysis still run
            if not args.quiet:
                print(f"arc step {start + i}: {args.arc_param}={b:.4f} "
                      f"iters={int(step.iterations)} "
                      f"|r|={float(step.residual_norm):.3e} "
                      f"Z={np.array2string(sol, precision=5)}", flush=True)
            n_unstable = None
            eigenvalues = None
            if args.stability:
                with span("cli.stability"):
                    ev = compute_eigenvalues(
                        make_residual_fn(
                            cfg, _walk_params(args, b, noise.device), 0,
                            device=noise.device, noise=noise,
                            evolve_backend=args.evolve_backend, group=group),
                        step.y[:-1], ProblemType.EQUATION_FREE,
                        epsilon=args.fd_eps)
                    eigenvalues = np.asarray(ev)
                    n_unstable = int(count_unstable(ev,
                                                    ProblemType.EQUATION_FREE))
                    if not args.quiet:
                        print(f"  -> {'unstable' if n_unstable else 'stable'} "
                              f"({n_unstable} unstable)")
            if ckpt is not None and (group is None or group.rank == 0):
                with span("cli.checkpoint"):
                    ckpt.save(ContinuationStep(
                        index=start + i, beta=b, solution=sol,
                        residual_norm=float(step.residual_norm),
                        converged=bool(step.converged), n_unstable=n_unstable,
                        eigenvalues=eigenvalues))

    steps = continue_branch(
        cfg, noise, Z, walk_beta0, sigma=walk_sigma, param=args.arc_param,
        ds=args.ds, n_steps=args.steps, direction=args.direction, ncfg=ncfg,
        evolve_backend=args.evolve_backend,
        max_step_factor=None if args.allow_branch_jump else 4.0,
        tangent0=tangent0, callback=on_step, group=group)
    print(f"arclength: {len(steps)} accepted steps"
          + ("" if len(steps) == args.steps else " (branch end reached)"))
    return 0


def run_fold(args, cfg, ncfg, noise, Z, beta) -> int:
    """Two-parameter fold continuation (``--track-fold``)."""
    from ..analysis.fold import null_direction, track_fold

    # the initial null direction from the exact Jacobian at the near-fold
    # guess
    F = make_residual_fn(cfg, MapParams.create(beta, args.sigma_values[0],
                                               dtype=args.dtype,
                                               device=noise.device),
                         0, device=noise.device, noise=noise,
                         evolve_backend=args.evolve_backend)
    v0 = null_direction(F.value_and_jacobian(Z)[1])
    acc = []

    def save():
        # incremental: a killed trace keeps its prefix
        os.makedirs(args.checkpoint, exist_ok=True)
        np.savez(os.path.join(args.checkpoint, "fold.npz"),
                 sigma=np.array([p.sigma for p in acc]),
                 beta=np.array([p.beta for p in acc]),
                 Z=np.stack([p.Z for p in acc]),
                 v=np.stack([p.v for p in acc]),
                 residual_norm=np.array([p.residual_norm for p in acc]))

    def on_point(pt):
        if not args.quiet:
            print(f"sigma={pt.sigma:.4f}: beta_fold = {pt.beta:.5f} "
                  f"(c={float(pt.Z[0]):.4f}, |H|={pt.residual_norm:.2e})",
                  flush=True)
        acc.append(pt)
        if args.checkpoint:
            save()

    pts = track_fold(cfg, noise, _host(Z), v0, beta, args.sigma_values,
                     ncfg=ncfg, evolve_backend=args.evolve_backend,
                     callback=on_point)
    print(f"fold curve: {len(pts)}/{len(args.sigma_values)} sigma values "
          "traced")
    if args.checkpoint and pts:
        print(f"fold curve written to {args.checkpoint}/fold.npz")
    return 0


def run_boundary(args, cfg, ncfg, noise, Z, beta) -> int:
    """Two-parameter existence-boundary trace (``--track-boundary``)."""
    from ..analysis.boundary import track_existence_boundary

    acc = []

    def save():
        os.makedirs(args.checkpoint, exist_ok=True)
        np.savez(os.path.join(args.checkpoint, "boundary.npz"),
                 sigma=np.array([p.sigma for p in acc]),
                 beta_star=np.array([p.beta_star for p in acc]),
                 beta_fail=np.array([p.beta_fail for p in acc]),
                 fail_verified=np.array([p.fail_verified for p in acc]),
                 Z=np.stack([p.Z for p in acc]),
                 residual_norm=np.array([p.residual_norm for p in acc]))

    def on_point(pt):
        if not args.quiet:
            tag = "verified" if pt.fail_verified else "UNVERIFIED"
            print(f"sigma={pt.sigma:.4f}: beta* = {pt.beta_star:.4f} "
                  f"(fail at {pt.beta_fail:.4f} {tag}, "
                  f"c={float(pt.Z[0]):.4f}, |r|={pt.residual_norm:.2e})",
                  flush=True)
        acc.append(pt)
        if args.checkpoint:
            save()

    pts = track_existence_boundary(
        cfg, noise, _host(Z), beta, args.sigma_values,
        direction=args.boundary_direction, ncfg=ncfg,
        evolve_backend=args.evolve_backend, callback=on_point)
    print(f"boundary: {len(pts)}/{len(args.sigma_values)} sigma values "
          "traced")
    if args.checkpoint and pts:
        print(f"boundary written to {args.checkpoint}/boundary.npz")
    return 0


def run_enumerate(args, cfg, ncfg, noise, Z, beta, group=None) -> int:
    """Branch-switching enumeration (``--enumerate-branches``); ``group``
    shards the frozen corrector."""
    from ..analysis.branches import enumerate_branches

    beta0, sigma = ((beta, args.sigma) if args.arc_param == "beta"
                    else (args.beta, args.sigma))

    def on_step(b, i, step):
        print(f"branch {b} step {i}: {args.arc_param}={float(step.y[-1]):.4f}"
              f" iters={int(step.iterations)}"
              f" |r|={float(step.residual_norm):.3e}"
              f" Z={np.array2string(_host(step.y[:-1]), precision=5)}",
              flush=True)

    branches = enumerate_branches(
        cfg, noise, _host(Z), beta0, sigma=sigma, param=args.arc_param,
        ds=args.ds, n_steps=args.steps, ncfg=ncfg,
        evolve_backend=args.evolve_backend, max_branches=args.max_branches,
        callback=None if args.quiet else on_step, group=group)

    for b, br in enumerate(branches):
        end = "step limit" if br.hit_step_limit else "branch end"
        p, c = br.points[:, -1], br.points[:, 0]
        print(f"branch {b} [{br.origin}]: {len(br.points)} points, "
              f"{args.arc_param} in [{p.min():.4f}, {p.max():.4f}], "
              f"c in [{c.min():.4f}, {c.max():.4f}] ({end})")
        if args.checkpoint and (group is None or group.rank == 0):
            os.makedirs(args.checkpoint, exist_ok=True)
            np.savez(os.path.join(args.checkpoint, f"branch_{b}.npz"),
                     points=br.points, origin=br.origin,
                     hit_step_limit=br.hit_step_limit)
    if args.checkpoint:
        print(f"branches written to {args.checkpoint}/branch_*.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
