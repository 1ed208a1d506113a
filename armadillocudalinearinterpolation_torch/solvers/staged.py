"""Staged hybrid-precision Newton: the map solved to ``|F| <= 1e-8``.

Three stages, as in the JAX package's ``solvers/staged.py``:

  1. **f32 stage**: :func:`.newton.newton_solve` with central FD on the
     f32 map (K1 on the card) takes the iterate to the f32 residual floor.
  2. **Accurate stage**: on a direct evolve (``"cuda"``, ``"torch"``) by
     default Newton with exact Jacobians (``fd_mode="exact"``: K1's fp64
     log and one K2T launch an iteration) down to ``0.9 * tolerance``; on
     the replay, by default the **frozen-schedule stage**
     (:func:`newton_solve_frozen`): per
     iteration one f32 discovery pass fixes the discrete outcome (K1 with
     its firing-order log), and one fp64 replay of ``(n+1)`` (or
     ``(2n+1)``) points x R rows (K2) gives ``F(x)`` and an FD Jacobian of
     the smooth piece around it.  It stops inside the polish's capture
     range (``stage2_tolerance``, by default ``5 * tolerance``).
  3. **Frozen-Jacobian polish** (:func:`.newton.frozen_jacobian_polish`):
     each step one accurate map evaluation (discovery + replay), keeping
     the best iterate, down to the target.

The draw is made once, at the accurate dtype; stage 1 takes it cast to
f32, so all stages solve ONE realisation of the stochastic map.  The port
runs eagerly: there are no cached programs, no cache identity guards and
no ahead-of-time warm-up.

``group=`` (a :class:`..parallel.sharding.ShardGroup`; the JAX package's
``mesh=``) shards every stage over the ranks: each rank runs K1, K2 and
K2T on its block of realisations (its rows of every stencil point) and
the ensemble sums are all-reduced, so every rank takes the same steps on
the same ``f``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

from ..config import MapParams, ModelConfig, NewtonConfig
from ..model.emap import (compute_discrete_outcome,
                          frozen_schedule_map_batched, make_residual_fn,
                          sample_beta)
from ..model.replay import schedule_config
from ..utils.profiling import span, spanned
from .criterion import residual_norm_criterion
from .linalg import solve_dense
from .newton import (NewtonResult, _print_footer, _print_header,
                     _print_iteration, central_fd_jacobian, exact_jacobian,
                     frozen_jacobian_polish, newton_solve)

FROZEN_MODES = ("frozen", "frozen-fwd")


def _norm(f: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(f))


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def frozen_epsilon(ncfg: NewtonConfig) -> float:
    """The frozen stencil's FD radius: ``ncfg.fd_epsilon`` inside the
    window where the FD Jacobian of the smooth piece is accurate, forward
    ``[1e-8, 1e-5]`` and central ``[1e-7, 1e-4]`` (measured by the JAX
    package at N=512 f64); outside it the default 1e-6 (forward) or 1e-5
    (central), not the window's edge."""
    fwd = ncfg.fd_mode == "frozen-fwd"
    lo, hi, default = (1e-8, 1e-5, 1e-6) if fwd else (1e-7, 1e-4, 1e-5)
    return ncfg.fd_epsilon if lo <= ncfg.fd_epsilon <= hi else default


@spanned("solvers.newton")
def frozen_newton_loop(evaluate: Callable, x0: torch.Tensor,
                       ncfg: NewtonConfig, eps: float, *, backtrack: bool,
                       score: Optional[Callable] = None,
                       fill: Optional[Callable] = None) -> NewtonResult:
    """Host Newton loop over a fused ``evaluate(x, eps) -> (F, J)``.

    A non-finite Jacobian (an FD probe across a fire/no-fire boundary whose
    rows all drop) is re-evaluated once at ``eps / 8``; the divergence
    cutoff ``ncfg.divergence_factor`` counts a NaN norm as diverged.

    ``backtrack=True``: each iteration tries the full step and up to 3
    halvings while the residual grows, and keeps the best candidate.  With
    ``score`` (``z -> (F(z), aux)``, one replay row) trials after the first
    are scored, and the winning scored trial's ``(F, J)`` comes from
    ``fill(z, eps, aux)`` (which reuses its discovered outcome; a
    non-finite fill is re-evaluated as ``evaluate`` is).  When every
    candidate is worse, the Jacobian is refreshed at ``eps / 8`` and the
    trial repeated once; if that fails too, the best candidate is taken.
    ``backtrack=False``: plain damped steps.
    """
    test = residual_norm_criterion(ncfg.tolerance)
    dt_ = x0.dtype

    @spanned("solvers.jacobian")
    def ev(z, ep):
        f_, j_ = evaluate(z, ep)
        if not _finite(j_):
            f_, j_ = evaluate(z, ep / 8.0)
        return f_, j_

    if ncfg.print_output:
        _print_header(ncfg.max_iterations, ncfg.tolerance)
    x = x0
    f, jac = ev(x, eps)
    norm = norm0 = _norm(f)
    history = [norm]
    if ncfg.print_output:
        _print_iteration(0, norm)
    converged = test(norm)
    it = 0

    def attempt(x, direction, norm_ref):
        """Backtracking trial: the best ``(norm, x, f, jac, aux)`` seen."""
        best = None
        scale = float(ncfg.damping)
        for i in range(4):
            x_try = x + scale * direction
            if i == 0 or score is None:
                (f_new, jac_new), aux = ev(x_try, eps), None
            else:
                (f_new, aux), jac_new = score(x_try), None
            n_try = _norm(f_new)
            # a NaN best gives way to any finite candidate
            if (best is None or best[0] != best[0]
                    or (n_try == n_try and n_try < best[0])):
                best = (n_try, x_try, f_new, jac_new, aux)
            if n_try == n_try and n_try <= norm_ref:
                break
            scale *= 0.5
        if best[3] is None:
            # a scored trial won: one fused evaluation gives its Jacobian
            # and the authoritative F
            if fill is not None and best[4] is not None:
                with span("solvers.jacobian"):
                    f_b, jac_b = fill(best[1], eps, best[4])
                if not _finite(jac_b):
                    f_b, jac_b = ev(best[1], eps)
            else:
                f_b, jac_b = ev(best[1], eps)
            best = (_norm(f_b), best[1], f_b, jac_b, None)
        return best

    while it < ncfg.max_iterations and not converged:
        if (ncfg.divergence_factor != math.inf
                and not norm <= ncfg.divergence_factor * norm0):
            break
        with span("solvers.iteration"):
            if backtrack:
                best = attempt(x, solve_dense(jac, -f), norm)
                if not best[0] <= norm:
                    with span("solvers.jacobian"):
                        f_r, jac_r = evaluate(x, eps / 8.0)
                    if _finite(jac_r):
                        best_r = attempt(x, solve_dense(jac_r, -f_r), norm)
                        if (best_r[0] == best_r[0]
                                and not best_r[0] >= best[0]):
                            best = best_r
                norm, x, f, jac, _ = best
            else:
                x = x + float(ncfg.damping) * solve_dense(jac, -f)
                f, jac = ev(x, eps)
                norm = _norm(f)
            it += 1
            history.append(norm)
            if ncfg.print_output:
                _print_iteration(it, norm)
            converged = test(norm)

    if ncfg.print_output:
        _print_footer(it, converged)
    history += [math.nan] * (ncfg.max_iterations + 1 - len(history))
    return NewtonResult(solution=x, converged=converged, iterations=it,
                        residual_norm=norm,
                        residual_history=torch.tensor(history, dtype=dt_),
                        jacobian=jac, residual=f)


def newton_solve_frozen(cfg: ModelConfig, params: MapParams,
                        beta: torch.Tensor, x0: torch.Tensor,
                        ncfg: NewtonConfig, group=None) -> NewtonResult:
    """Newton on the replay map with a fused residual + frozen-schedule FD
    Jacobian.

    Per evaluation: one f32 discovery pass at ``x``
    (:func:`..model.emap.compute_discrete_outcome`), then one replay of the
    stencil ``[x, x + eps e_i]`` (``fd_mode="frozen-fwd"``, ``n + 1``
    points) or ``[x, x + eps e_i, x - eps e_i]`` (``"frozen"``, ``2n + 1``)
    around that outcome (:func:`..model.emap.frozen_schedule_map_batched`):
    ``F(x)`` exactly, and the FD Jacobian of the smooth piece, with the
    radius :func:`frozen_epsilon`.  Backtracking trials are scored by a
    one-point replay.  Even a 0-iteration solve exports a real Jacobian.

    Args:
      cfg: model config at the accurate dtype.
      beta: the ``(R, N)`` draw, on the device to run on.
      x0: initial iterate.
      ncfg: tolerance, max_iterations, damping, print_output,
        divergence_factor, fd_mode and fd_epsilon.
      group: shard discovery and replay over its ranks (``beta`` is the
        full draw on every rank).
    """
    if ncfg.fd_mode not in FROZEN_MODES:
        raise ValueError(f"newton_solve_frozen takes fd_mode in "
                         f"{FROZEN_MODES}; got {ncfg.fd_mode!r}")
    n = x0.shape[0]
    dt_, dev = cfg.torch_dtype, beta.device
    fwd = ncfg.fd_mode == "frozen-fwd"
    eye = torch.eye(n, dtype=dt_, device=dev)

    def fused(z, ep, outcome):
        ep_t = torch.tensor(ep, dtype=dt_, device=dev)
        e = ep_t * eye
        pts = (torch.cat([z[None, :], z[None, :] + e]) if fwd else
               torch.cat([z[None, :], z[None, :] + e, z[None, :] - e]))
        vals = frozen_schedule_map_batched(cfg, params, beta, pts, *outcome,
                                           group=group)
        f = vals[0]
        jac = ((vals[1:] - f).T / ep_t if fwd
               else (vals[1:n + 1] - vals[n + 1:]).T / (2.0 * ep_t))
        return f, jac

    def evaluate(z, ep):
        return fused(z, ep, compute_discrete_outcome(cfg, params, beta, z,
                                                     group))

    def score(z):
        outcome = compute_discrete_outcome(cfg, params, beta, z, group)
        return (frozen_schedule_map_batched(cfg, params, beta, z[None, :],
                                            *outcome, group=group)[0],
                outcome)

    return frozen_newton_loop(evaluate, x0.to(dtype=dt_, device=dev), ncfg,
                              frozen_epsilon(ncfg), backtrack=True,
                              score=score, fill=fused)


def _resolve_staged(cfg: ModelConfig, tolerance: float,
                    stage1_ncfg: Optional[NewtonConfig],
                    stage2_ncfg: Optional[NewtonConfig],
                    stage2_tolerance: Optional[float], evolve_backend: str):
    """The staged recipe's defaults: ``(cfg, cfg32, stage1_ncfg,
    stage2_ncfg, evolve_backend)``.

    ``root_tol`` tightens to ``1e-4 * tolerance`` (crossing times feed the
    restriction directly); stage 1 defaults to 6 iterations of central FD
    at eps 1e-3; stage 2 on the replay backend to ``"frozen-fwd"`` at eps
    1e-6, budget 6, tolerance ``5 * tolerance``.  ``"auto"`` resolves to
    ``"replay"``.  The direct evolve (``"cuda"``, ``"torch"``: the JAX
    package's ``"xla"``) defaults to exact Jacobians with tolerance ``0.9 *
    tolerance`` and budget 8, as the JAX package does: with exact
    Jacobians one more quadratic iteration is cheaper than the polish
    crawling from the capture range.  ``"exact"`` runs on every backend.
    A frozen mode needs the replay backend.
    """
    if evolve_backend == "auto":
        evolve_backend = "replay"
    cfg = cfg.with_(root_tol=min(cfg.root_tol, 1e-4 * tolerance))
    cfg32 = schedule_config(cfg)
    if stage1_ncfg is None:
        stage1_ncfg = NewtonConfig(tolerance=tolerance, max_iterations=6,
                                   fd_epsilon=1e-3, fd_mode="central")
    if stage2_tolerance is None:
        stage2_tolerance = (0.9 * tolerance if stage2_ncfg is None
                            and evolve_backend != "replay"
                            else 5.0 * tolerance)
    if stage2_ncfg is None:
        if evolve_backend == "replay":
            stage2_ncfg = NewtonConfig(tolerance=stage2_tolerance,
                                       max_iterations=6,
                                       fd_mode="frozen-fwd", fd_epsilon=1e-6)
        else:
            stage2_ncfg = NewtonConfig(tolerance=stage2_tolerance,
                                       max_iterations=8, fd_mode="exact",
                                       fd_epsilon=1e-6)
    if stage2_ncfg.fd_mode in FROZEN_MODES and evolve_backend != "replay":
        raise ValueError(
            f"stage2_ncfg.fd_mode={stage2_ncfg.fd_mode!r} runs the fp64 "
            f"replay, but evolve_backend={evolve_backend!r} was requested: "
            "stage 2 would converge on the replay residual while the polish "
            "and the converged flag use the requested backend's.  Use "
            "evolve_backend='replay' with the frozen modes, or "
            "fd_mode='exact'/'central'/'forward' with this backend.")
    return cfg, cfg32, stage1_ncfg, stage2_ncfg, evolve_backend


@spanned("solvers.staged")
def newton_solve_staged(cfg: ModelConfig, params: MapParams,
                        Z0: torch.Tensor, *,
                        beta: Optional[torch.Tensor] = None,
                        seed: Union[int, torch.Generator] = 0,
                        device=None,
                        tolerance: float = 1e-8,
                        stage1_ncfg: Optional[NewtonConfig] = None,
                        stage2_ncfg: Optional[NewtonConfig] = None,
                        stage2_tolerance: Optional[float] = None,
                        polish_iterations: int = 40,
                        evolve_backend: str = "replay",
                        basin_radius: float = 1.0,
                        group=None) -> NewtonResult:
    """Solve the map to ``tolerance`` by the staged recipe.

    Args:
      cfg: model config at the accurate dtype (``float64``).
      params: map parameters, shared by every stage.
      Z0: initial guess, any float dtype.
      beta: the ``(R, N)`` draw at the accurate dtype; by default drawn
        once from ``seed`` (an int or a ``torch.Generator``) on ``device``.
      device: where to run; ``beta``'s device if given, else ``"cuda"``.
      tolerance: final residual-norm target of the accurate map.
      stage1_ncfg, stage2_ncfg, stage2_tolerance: stage solvers (defaults
        in :func:`_resolve_staged`).
      polish_iterations: the polish's budget of map evaluations.
      evolve_backend: the accurate map's evolve, ``"replay"`` (default;
        ``"auto"`` resolves to it), or the direct evolve ``"cuda"`` /
        ``"torch"``.
      basin_radius: max-norm distance from ``Z0`` beyond which a converged
        result still triggers the rescue pass (``math.inf`` disables it).
      group: a :class:`..parallel.sharding.ShardGroup`: every stage sharded
        over its ranks; each rank passes (or draws from ``seed``) the same
        full draw and gets the same result.

    Returns:
      :class:`NewtonResult` of the best polished iterate; ``iterations`` is
      the total over all stages and ``converged`` reflects ``tolerance``.

    A result above ``tolerance``, out of the gauge domain (positions
    ``c * z`` outside ``(0, 2L)``) or farther than ``basin_radius`` from
    ``Z0`` triggers a rescue pass from ``Z0`` on the accurate stages, and
    the better of the two results wins (converged in domain and nearer
    first, then the lower residual, NaN-aware).
    """
    cfg, cfg32, stage1_ncfg, stage2_ncfg, evolve_backend = _resolve_staged(
        cfg, tolerance, stage1_ncfg, stage2_ncfg, stage2_tolerance,
        evolve_backend)
    if beta is None:
        device = torch.device("cuda" if device is None else device)
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))
        beta = sample_beta(cfg, params, gen, device=device)
    else:
        device = beta.device if device is None else torch.device(device)
        beta = beta.to(dtype=cfg.torch_dtype, device=device).contiguous()
    dt_acc = cfg.torch_dtype
    z_guess = Z0.to(dtype=dt_acc, device=device)

    # stage 1 on the accurate draw cast to f32: the same realisation
    params32 = MapParams(beta=params.beta.to(torch.float32),
                         sigma=params.sigma.to(torch.float32))
    F32 = make_residual_fn(
        cfg32, params32, 0, device=device, beta=beta.to(torch.float32),
        evolve_backend="torch" if evolve_backend == "torch" else "auto",
        group=group)
    with span("solvers.stage1"):
        r32 = newton_solve(F32, Z0.to(dtype=torch.float32, device=device),
                           stage1_ncfg)
    # a non-finite or 0-iteration stage 1 falls back to the guess at full
    # precision
    if _finite(r32.solution) and r32.iterations > 0:
        handoff, stage1_iters = r32.solution.to(dt_acc), r32.iterations
    else:
        handoff, stage1_iters = z_guess, 0

    F_acc = make_residual_fn(cfg, params, 0, device=device, beta=beta,
                             evolve_backend=evolve_backend, group=group)
    frozen = stage2_ncfg.fd_mode in FROZEN_MODES

    def accurate_solve(x_start):
        """Stage 2 and the polish from ``x_start``: ``(pol, jac, iters)``."""
        with span("solvers.stage2"):
            if frozen:
                res = newton_solve_frozen(cfg, params, beta, x_start,
                                          stage2_ncfg, group)
            else:
                res = newton_solve(F_acc, x_start, stage2_ncfg)
            # a diverged stage 2 must not poison the polish
            x2 = res.solution if _finite(res.solution) else x_start
            jac = res.jacobian
            if res.iterations == 0 and not frozen:
                # stage 2 met its tolerance at entry and exported the
                # identity placeholder: one real Jacobian for the polish
                with span("solvers.jacobian"):
                    jac = (exact_jacobian(F_acc, x2)
                           if stage2_ncfg.fd_mode == "exact" else
                           central_fd_jacobian(F_acc, x2,
                                               stage2_ncfg.fd_epsilon))
        pol = frozen_jacobian_polish(F_acc, x2, jac,
                                     max_iterations=polish_iterations,
                                     tolerance=0.9 * tolerance)
        return pol, jac, res.iterations + pol.iterations

    def in_domain(z) -> bool:
        """Gauge-domain validity: finite, ``c > 0`` and spike positions
        ``c * z_i`` inside ``(0, 2L)`` (``Z[1:]`` are time offsets)."""
        zz = z.detach().double().cpu()
        if not (_finite(zz) and float(zz[0]) > 0.0):
            return False
        pos = zz[0] * zz[1:]
        return bool((pos > 0.0).all() and (pos < 2.0 * cfg.half_width).all())

    def dist(z) -> float:
        """Max-norm distance from the guess (inf if non-finite)."""
        zz = z.detach().double().cpu()
        if not _finite(zz):
            return math.inf
        return float((zz - Z0.detach().double().cpu()).abs().max())

    pol, jac, acc_iters = accurate_solve(handoff)
    if ((not pol.residual_norm <= tolerance or not in_domain(pol.solution)
         or dist(pol.solution) > basin_radius) and stage1_iters > 0):
        # rescue: the f32 stage can hand off into another basin; re-solve
        # from the caller's guess on the accurate stages
        with span("solvers.rescue"):
            pol_r, jac_r, iters_r = accurate_solve(z_guess)
        acc_iters += iters_r
        nr, n0 = pol_r.residual_norm, pol.residual_norm
        if (nr <= tolerance and in_domain(pol_r.solution)
                and (not in_domain(pol.solution)
                     or dist(pol_r.solution) < dist(pol.solution))):
            pol, jac = pol_r, jac_r
        elif nr < n0 or (nr == nr and n0 != n0):
            pol, jac = pol_r, jac_r

    return NewtonResult(solution=pol.solution,
                        converged=pol.residual_norm <= tolerance,
                        iterations=stage1_iters + acc_iters,
                        residual_norm=pol.residual_norm,
                        residual_history=pol.residual_history,
                        jacobian=jac, residual=pol.residual)
