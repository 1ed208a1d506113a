"""Two-parameter existence-boundary tracking (bifurcation-set mapping).

The port of the JAX package's ``analysis/boundary.py``.  A grazing-type
branch end is non-smooth (a trajectory loses its threshold crossing
tangentially and the event count changes), so it is not solved for: for
each value of the second parameter the tracker re-converges an interior
point by fixed-parameter Newton, walks the arclength corrector into the
boundary until its adaptive step collapses (the corrector's step guard
refuses tunnels to the coexisting family), and then measures the failure
side of the bracket with beta-pinned corrector probes
(:func:`_verify_bracket`).

The tracker pins the direct fp64 evolve: the replay imposes the f32 pass's
firing order, which regularises exactly the grazing transitions this
module resolves (the JAX package observed a replay walk passing the
f64 map's end at beta 16.0144 up to ~16.55).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import MapParams, NewtonConfig, ModelConfig
from ..model.emap import check_backend, make_residual_fn
from ..solvers.newton import newton_solve
from ..solvers.staged import FROZEN_MODES
from .continuation import (BoundResidual, continue_branch,
                           make_extended_residual_held)


class BoundaryPoint(NamedTuple):
    """One point on the existence boundary ``beta*(sigma)``."""

    sigma: float
    beta_star: float          # last converged beta (the boundary, inside)
    beta_fail: float          # nearest beta where the corrector probe FAILED
    Z: np.ndarray             # converged solution at (beta_star, sigma)
    residual_norm: float
    # True when the failure at ``beta_fail`` was measured (a beta-pinned
    # corrector probe did not converge there); False only if the probe
    # budget ran out while the probes kept converging
    fail_verified: bool = False


def _make_prober(cfg: ModelConfig, noise: torch.Tensor, ncfg: NewtonConfig,
                 evolve_backend: str, family_guard: float) -> Callable:
    """The fixed-parameter solve of the interior re-convergence."""
    dt_, dev = cfg.torch_dtype, noise.device

    def prober(beta: float, sigma: float, Z0, c_ref):
        F = make_residual_fn(cfg, MapParams.create(beta, sigma,
                                                   dtype=cfg.dtype,
                                                   device=dev),
                             0, device=dev, noise=noise,
                             evolve_backend=evolve_backend)
        res = newton_solve(F, torch.as_tensor(np.asarray(Z0, dtype=float),
                                              dtype=dt_, device=dev), ncfg)
        sol = res.solution.detach().cpu().numpy()
        ok = (bool(res.converged) and bool(np.all(np.isfinite(sol)))
              # family continuity: refuse a solve that tunnelled to a
              # coexisting wave family (speeds differ by ~0.19 at overlap)
              and (c_ref is None or abs(float(sol[0]) - c_ref)
                   < family_guard))
        return ok, sol, float(res.residual_norm)

    return prober


def _make_bracket_step(cfg: ModelConfig, noise: torch.Tensor,
                       ncfg: NewtonConfig, evolve_backend: str) -> Callable:
    """The beta-pinned corrector ``(y_prev, y0, sigma, ds) ->
    NewtonResult``: the arclength row is ``dot(y - y_prev, e_beta) - ds``
    with an UNsigned pin, so the probe's side lives in ``ds`` alone."""
    dt_, dev = cfg.torch_dtype, noise.device
    Gh = make_extended_residual_held(cfg, noise, param="beta",
                                     evolve_backend=evolve_backend)
    pin = torch.zeros(cfg.n_spikes + 1, dtype=dt_, device=dev)
    pin[-1] = 1.0

    def step(y_prev, y0, sigma, ds):
        y_prev = torch.as_tensor(y_prev, dtype=dt_, device=dev)
        y0 = torch.as_tensor(y0, dtype=dt_, device=dev)
        ds = torch.as_tensor(float(ds), dtype=dt_, device=dev)
        return newton_solve(BoundResidual(Gh, y_prev, pin, ds, float(sigma)),
                            y0, ncfg)

    return step


def _verify_bracket(step, dt_, family_guard: float, sigma: float,
                    sgn: float, bisect_tol: float, beta_star: float,
                    Z_star: np.ndarray, rnorm: float,
                    t_end: Optional[np.ndarray], *, max_probes: int = 8):
    """Measure the failure side of the boundary bracket at one sigma.

    Runs beta-pinned corrector probes (``step`` from
    :func:`_make_bracket_step`) at ``beta_star + sgn * bisect_tol``, Z
    free, warm-started along the walk tangent where there is one.  A probe
    that converges on the family moves the boundary out and is probed
    again.  Returns ``(beta_star, Z_star, rnorm, beta_fail, verified)``.
    """
    verified = False
    for _ in range(max_probes):
        y_star = np.concatenate([np.asarray(Z_star, dtype=float),
                                 [float(beta_star)]])
        # predictor: Z along the walk tangent, scaled to the probed beta
        # advance; beta lands on the probed value
        if t_end is not None and abs(t_end[-1]) > 1e-3:
            y0 = y_star + (bisect_tol / abs(t_end[-1])) * np.asarray(t_end)
            y0[-1] = beta_star + sgn * bisect_tol
        else:
            y0 = y_star.copy()
            y0[-1] += sgn * bisect_tol
        res = step(y_star, y0, sigma, sgn * bisect_tol)
        sol = res.solution.detach().cpu().numpy()
        ok = (bool(res.converged) and bool(np.all(np.isfinite(sol)))
              and abs(float(sol[0]) - float(Z_star[0])) < family_guard)
        if not ok:
            verified = True
            break
        # the probe converged on the family: the boundary is this far out
        beta_star = float(sol[-1])
        Z_star = sol[:-1]
        rnorm = float(res.residual_norm)
        t_end = None  # the tangent is stale after an extension
    return beta_star, Z_star, rnorm, beta_star + sgn * bisect_tol, verified


def track_existence_boundary(cfg: ModelConfig, noise: torch.Tensor, Z0,
                             beta0, sigma_values: Sequence[float], *,
                             direction: float = +1.0,
                             bracket: float = 0.5,
                             bisect_tol: float = 2e-3,
                             backoff: float = 0.25,
                             family_guard: float = 0.08,
                             ncfg: Optional[NewtonConfig] = None,
                             evolve_backend: str = "auto",
                             max_steps: int = 80,
                             callback: Optional[Callable] = None
                             ) -> list[BoundaryPoint]:
    """Trace the existence boundary ``beta*(sigma)`` of one wave family.

    Args:
      noise: the ``(R, N)`` noise of the whole trace.
      Z0, beta0: a converged point inside the family at
        ``sigma_values[0]``.
      sigma_values: values of the second parameter, in walk order; each
        warm-starts from the previous boundary point.
      direction: +1 the upper boundary (largest beta), -1 the lower.
      bracket: first and largest arclength step of the boundary walk.
      bisect_tol: resolution; the walk's minimum step is a quarter of it
        and the bracket is then measured (:func:`_verify_bracket`).
      backoff: how far inside the previous boundary the next sigma's
        interior solve starts.
      family_guard: largest jump in ``c = Z[0]`` the interior solve takes.
      max_steps: per-sigma cap on arclength steps; hitting it raises.
      callback: ``f(BoundaryPoint)`` per traced point.

    The corrector is exact by default, with a divergence cutoff of 1e4
    (the probes that must fail run away in 2-3 steps); a frozen mode is
    taken as exact, and ``"replay"`` as the direct evolve (see the module
    docstring).  Returns a point per sigma traced; the trace stops where
    the family's interior no longer converges.
    """
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12,
                            fd_mode="exact")
    if ncfg.divergence_factor == float("inf"):
        ncfg = dataclasses.replace(ncfg, divergence_factor=1e4)
    if ncfg.fd_mode in FROZEN_MODES:
        ncfg = dataclasses.replace(ncfg, fd_mode="exact")
    check_backend(evolve_backend)
    if evolve_backend == "replay":
        evolve_backend = "auto"
    sgn = 1.0 if direction >= 0 else -1.0
    dt_ = cfg.torch_dtype
    probe = _make_prober(cfg, noise, ncfg, evolve_backend, family_guard)
    bracket_step = _make_bracket_step(cfg, noise, ncfg, evolve_backend)

    Z_in = np.asarray(Z0.detach().cpu() if isinstance(Z0, torch.Tensor)
                      else Z0, dtype=float)
    beta_in = float(beta0)
    c_ref = None
    out: list[BoundaryPoint] = []

    for sigma in sigma_values:
        sigma = float(sigma)
        # 1) interior re-convergence at this sigma
        ok, sol, rnorm = probe(beta_in, sigma, Z_in, c_ref)
        if not ok:
            # one retry from deeper inside before the family counts as gone
            beta_try = beta_in - sgn * backoff
            ok, sol, rnorm = probe(beta_try, sigma, Z_in, c_ref)
            if not ok:
                break
            beta_in = beta_try
        Z_in, c_ref = sol, float(sol[0])

        # 2) the guarded arclength walk into the boundary
        steps = continue_branch(
            cfg, noise, Z_in, beta_in, sigma=sigma, param="beta",
            ds=bracket, n_steps=max_steps, direction=sgn, ncfg=ncfg,
            evolve_backend=evolve_backend, min_ds=0.25 * bisect_tol,
            max_ds=bracket)
        if len(steps) == max_steps:
            raise RuntimeError(
                f"boundary walk at sigma={sigma} did not terminate within "
                f"{max_steps} steps (last beta={float(steps[-1].y[-1])}): "
                "increase max_steps or bracket")
        if steps:
            y_end = steps[-1].y.detach().cpu().numpy()
            beta_star, Z_star = float(y_end[-1]), y_end[:-1]
            rnorm = float(steps[-1].residual_norm)
            t_end = steps[-1].tangent.detach().cpu().numpy()
        else:
            # the boundary is closer than the minimum step: the interior
            # point is the boundary point at this resolution
            beta_star, Z_star, t_end = beta_in, Z_in, None

        # 3) measure the bracket's failure side
        beta_star, Z_star, rnorm, beta_fail, verified = _verify_bracket(
            bracket_step, dt_, family_guard, sigma, sgn, bisect_tol,
            beta_star, Z_star, rnorm, t_end)
        pt = BoundaryPoint(sigma=sigma, beta_star=beta_star,
                           beta_fail=beta_fail, Z=Z_star,
                           residual_norm=rnorm, fail_verified=verified)
        out.append(pt)
        if callback is not None:
            callback(pt)
        # the next sigma warm-starts just inside this boundary
        Z_in, beta_in = Z_star, beta_star - sgn * backoff
    return out
