"""Pseudo-arclength continuation of map fixed points.

The port of the JAX package's ``analysis/continuation.py``.  The
parameter joins the unknowns, ``y = (Z, p)`` with ``p`` the walked
parameter (``"beta"``, the mean rate, or ``"sigma"``, the heterogeneity),
and each step solves the bordered system

    F(Z; p) = 0                          (n equations)
    <y - y_prev, tangent> - ds = 0       (the arclength row)

so the walk passes folds, where ``dZ/dp`` blows up but ``dy/ds`` stays
finite.  The exact corrector takes the bordered Jacobian ``[J_Z  J_p;
tangent^T]`` from ONE ``value_and_jacobian(param=...)`` of the map (one
tangent replay of ``n + 1`` directions: K2T on the card); the frozen
corrector (:func:`make_arclength_step_frozen`) from one f32 discovery and
one ``(2(n+1)+1)``-point frozen replay with a parameter point per point.

Common random numbers: a walk holds ONE ``(R, N)`` noise, and the draw at
parameter ``(beta, sigma)`` is ``beta + sigma * noise``, so ``dF/dsigma``
is the derivative of one realisation of the map.  The port runs eagerly:
the JAX package's cached programs and their identity guards have no
counterpart.

Sharding (``group=``, a :class:`..parallel.sharding.ShardGroup`), as in
the JAX package, covers the frozen bordered corrector only: each rank
discovers and replays its block of realisations of every stencil point.
A group with another corrector is refused.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import MapParams, ModelConfig, NewtonConfig
from ..model.emap import (beta_from_noise, compute_discrete_outcome,
                          check_backend, event_driven_map,
                          frozen_schedule_map_batched, make_residual_fn)
from ..solvers.newton import NewtonResult, newton_solve
from ..solvers.staged import FROZEN_MODES, frozen_newton_loop


class ArcStep(NamedTuple):
    """One converged point on the branch."""

    y: torch.Tensor           # (n + 1,): (Z..., param)
    tangent: torch.Tensor     # (n + 1,) unit tangent used for the next step
    converged: bool
    iterations: int
    residual_norm: float


def params_of(param: str, p, fixed, cfg: ModelConfig,
              device) -> MapParams:
    """The map parameters at walked value ``p`` (a scalar or a ``(P,)``
    tensor) with the other parameter held at ``fixed``."""
    dt_ = cfg.torch_dtype
    p = torch.as_tensor(p, dtype=dt_, device=device)
    fixed = torch.full_like(p, float(fixed))
    return (MapParams(beta=p, sigma=fixed) if param == "beta"
            else MapParams(beta=fixed, sigma=p))


def _check_param(param: str) -> None:
    if param not in ("beta", "sigma"):
        raise ValueError(f"param must be 'beta' or 'sigma', got {param!r}")


class ExtendedResidualHeld:
    """The bordered residual with the held parameter as a call argument:
    ``G(y, y_prev, tangent, ds, fixed)`` for one point ``(n + 1,)`` or a
    stack ``(P, n + 1)`` (each point at its own walked value: one evolve
    of ``P * R`` rows with their own rates), and
    ``G.value_and_jacobian(y, y_prev, tangent, ds, fixed)``, the exact
    bordered Jacobian."""

    def __init__(self, cfg: ModelConfig, noise: torch.Tensor, *,
                 param: str = "beta", evolve_backend: str = "auto"):
        _check_param(param)
        check_backend(evolve_backend)
        self.cfg, self.param = cfg, param
        self.noise = noise.to(dtype=cfg.torch_dtype).contiguous()
        self.evolve_backend = evolve_backend

    def _arc(self, y, y_prev, tangent, ds):
        return (y - y_prev) @ tangent - ds

    def __call__(self, y, y_prev, tangent, ds, fixed) -> torch.Tensor:
        params = params_of(self.param, y[..., -1], fixed, self.cfg,
                           self.noise.device)
        f = event_driven_map(self.cfg, params,
                             beta_from_noise(self.cfg, params, self.noise),
                             y[..., :-1], evolve_backend=self.evolve_backend)
        arc = self._arc(y, y_prev, tangent, ds)
        return torch.cat([f, arc[..., None].to(f.dtype)], dim=-1)

    def value_and_jacobian(self, y, y_prev, tangent, ds, fixed):
        F = make_residual_fn(
            self.cfg, params_of(self.param, y[-1], fixed, self.cfg,
                                self.noise.device),
            0, device=self.noise.device, noise=self.noise,
            evolve_backend=self.evolve_backend)
        f, J = F.value_and_jacobian(y[:-1], param=self.param)
        arc = self._arc(y, y_prev, tangent, ds)
        return (torch.cat([f, arc[None].to(f.dtype)]),
                torch.cat([J, tangent[None, :].to(J.dtype)]))


def make_extended_residual_held(cfg: ModelConfig, noise: torch.Tensor, *,
                                param: str = "beta",
                                evolve_backend: str = "auto"
                                ) -> ExtendedResidualHeld:
    """:class:`ExtendedResidualHeld` (the JAX package's function of the
    same name): the held parameter is a call argument."""
    return ExtendedResidualHeld(cfg, noise, param=param,
                                evolve_backend=evolve_backend)


class ExtendedResidual:
    """``G(y, y_prev, tangent, ds)`` at a fixed held value; with
    ``value_and_jacobian`` as :class:`ExtendedResidualHeld`."""

    def __init__(self, held: ExtendedResidualHeld, fixed: float):
        self.held, self.fixed = held, float(fixed)

    def __call__(self, y, y_prev, tangent, ds):
        return self.held(y, y_prev, tangent, ds, self.fixed)

    def value_and_jacobian(self, y, y_prev, tangent, ds):
        return self.held.value_and_jacobian(y, y_prev, tangent, ds,
                                            self.fixed)


def make_extended_residual(cfg: ModelConfig, noise: torch.Tensor, fixed, *,
                           param: str = "beta",
                           evolve_backend: str = "auto") -> ExtendedResidual:
    """Residual of the bordered system ``G(y) = (F(Z; p), arc(y))``.

    ``param`` selects the continuation parameter, ``"beta"`` or
    ``"sigma"``; ``fixed`` is the held value of the other.  Both partials
    are exact: ``d beta_draw / d sigma`` is the walk's frozen noise.
    """
    return ExtendedResidual(make_extended_residual_held(
        cfg, noise, param=param, evolve_backend=evolve_backend), fixed)


class BoundResidual:
    """``y -> G(y, *args)`` for the Newton solver, with the exact
    Jacobian where ``G`` has one."""

    def __init__(self, G, *args):
        self.G, self.args = G, args
        if hasattr(G, "value_and_jacobian"):
            self.value_and_jacobian = (
                lambda y: G.value_and_jacobian(y, *self.args))

    def __call__(self, y):
        return self.G(y, *self.args)


def arclength_step(G, y_prev: torch.Tensor, tangent: torch.Tensor, ds,
                   ncfg: NewtonConfig) -> NewtonResult:
    """One predictor-corrector step: Euler predictor and Newton corrector.

    ``ncfg.fd_mode="exact"`` is the natural choice (the bordered Jacobian
    comes from one exact evaluation); finite differences work too.
    """
    ds = torch.as_tensor(ds, dtype=y_prev.dtype, device=y_prev.device)
    return newton_solve(BoundResidual(G, y_prev, tangent, ds),
                        y_prev + ds * tangent, ncfg)


def initial_tangent(n: int, direction: float = 1.0, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """Start along the parameter axis (the naive sweep's direction)."""
    t = torch.zeros(n + 1, dtype=dtype, device=device)
    t[-1] = direction
    return t


def next_tangent(y_new: torch.Tensor, y_prev: torch.Tensor,
                 old_tangent: torch.Tensor) -> torch.Tensor:
    """Secant tangent, oriented to keep walking the same way."""
    d = y_new - y_prev
    t = d / torch.linalg.vector_norm(d)
    return -t if float(t @ old_tangent) < 0 else t


def make_arclength_step(cfg: ModelConfig, noise: torch.Tensor, fixed,
                        param: str, ncfg: NewtonConfig,
                        evolve_backend: str = "auto",
                        group=None) -> Callable:
    """The corrector ``(y_prev, tangent, ds) -> NewtonResult`` of a walk at
    held value ``fixed``: the frozen bordered corrector for the frozen
    modes, else :func:`arclength_step` on the extended residual (the JAX
    package's ``make_arclength_step_jit`` and its frozen counterpart).
    Only the frozen corrector takes a ``group``."""
    if ncfg.fd_mode in FROZEN_MODES:
        return make_arclength_step_frozen(cfg, noise, fixed, param, ncfg,
                                          group=group)
    check_group(ncfg, group)
    G = make_extended_residual(cfg, noise, fixed, param=param,
                               evolve_backend=evolve_backend)

    def step(y_prev, tangent, ds):
        return arclength_step(G, y_prev, tangent, ds, ncfg)
    return step


def check_group(ncfg: NewtonConfig, group) -> None:
    """Refuse a group with a corrector that does not shard (the JAX
    package's ``continuation.py:297-304``)."""
    if group is not None and ncfg.fd_mode not in FROZEN_MODES:
        raise ValueError(
            "sharded branch walks need a frozen corrector: pass "
            f"fd_mode in {FROZEN_MODES} (got {ncfg.fd_mode!r}) or no group")


def make_arclength_step_frozen(cfg: ModelConfig, noise: torch.Tensor, fixed,
                               param: str, ncfg: NewtonConfig,
                               group=None) -> Callable:
    """The bordered corrector with a fused frozen-outcome FD Jacobian, for
    ``ncfg.fd_mode`` ``"frozen"`` or ``"frozen-fwd"`` (both difference the
    central stencil).

    Per corrector iteration: one f32 discovery pass at the current ``y``
    fixes the discrete outcome, then ONE replay of the ``(2(n+1)+1)``
    points ``[y, y + eps e_i, y - eps e_i]``, each at its own walked value
    (the draws ``p + sigma * noise`` row by row), gives the residual and
    the central-FD partials in ``Z`` and the parameter.  The arclength row
    is exact: its Jacobian row is the tangent.  No backtracking: walkers
    probe past branch ends by design and count on failing correctors
    being cheap.

    ``group``: each rank discovers and replays its block of realisations
    (``noise`` is the full noise on every rank); the sums are all-reduced.
    """
    _check_param(param)
    dev, dt_ = noise.device, cfg.torch_dtype
    noise = noise.to(dtype=dt_).contiguous()
    n1 = cfg.n_spikes + 1
    # the radius window of newton_solve_frozen's central stencil
    eps_f = ncfg.fd_epsilon
    eps_f = 1e-5 if (eps_f > 1e-4 or eps_f < 1e-7) else eps_f

    def step(y_prev, tangent, ds) -> NewtonResult:
        y_prev = torch.as_tensor(y_prev, dtype=dt_, device=dev)
        tangent = torch.as_tensor(tangent, dtype=dt_, device=dev)
        ds = torch.as_tensor(ds, dtype=dt_, device=dev)

        def evaluate(y, ep):
            params = params_of(param, y[-1], fixed, cfg, dev)
            outcome = compute_discrete_outcome(
                cfg, params, beta_from_noise(cfg, params, noise), y[:-1],
                group)
            ep_t = torch.tensor(ep, dtype=dt_, device=dev)
            e = ep_t * torch.eye(n1, dtype=dt_, device=dev)
            pts = torch.cat([y[None], y[None] + e, y[None] - e])
            Fv = frozen_schedule_map_batched(
                cfg, params_of(param, pts[:, -1], fixed, cfg, dev), None,
                pts[:, :-1], *outcome, noise=noise, params_batched=True,
                group=group)
            JF = (Fv[1:n1 + 1] - Fv[n1 + 1:]).T / (2.0 * ep_t)
            arc = (y - y_prev) @ tangent - ds
            return (torch.cat([Fv[0], arc[None]]),
                    torch.cat([JF, tangent[None, :]]))

        return frozen_newton_loop(evaluate, y_prev + ds * tangent, ncfg,
                                  eps_f, backtrack=False)
    return step


def continue_branch(cfg: ModelConfig, noise: torch.Tensor, Z0, beta0, *,
                    sigma=0.0, param: str = "beta",
                    ds: float = 0.1, n_steps: int = 100,
                    direction: float = 1.0,
                    ncfg: Optional[NewtonConfig] = None,
                    evolve_backend: str = "auto",
                    min_ds: float = 1e-4, max_ds: float = 0.5,
                    grow: float = 1.3, shrink: float = 0.5,
                    max_step_factor: Optional[float] = 4.0,
                    tangent0=None, callback=None, reject_hook=None,
                    step: Optional[Callable] = None,
                    group=None) -> list[ArcStep]:
    """Walk a solution branch with adaptive pseudo-arclength steps.

    Starts from a converged point ``(Z0, beta0)`` and returns the accepted
    :class:`ArcStep` list.  The step halves on a failed corrector (and
    retries) and grows after fast convergence (3 iterations or fewer).

    Args:
      noise: the walk's ``(R, N)`` noise (common random numbers); it fixes
        the device.
      param: ``"beta"`` walks the mean rate holding ``sigma``; ``"sigma"``
        walks the heterogeneity holding ``beta0`` (start value ``sigma``).
      ncfg: the corrector; exact Jacobians to 1e-9 in 12 iterations by
        default.
      max_step_factor: reject a converged corrector point farther than
        ``factor * ds`` from the previous point and retry smaller (the
        arclength row pins only the projection on the tangent, so near a
        fold Newton can tunnel to another branch); None allows such jumps.
      tangent0: the first tangent (a resumed walk's secant); the parameter
        axis times ``direction`` by default.
      callback: ``f(step_index, ArcStep)`` per accepted point.
      reject_hook: ``f(y)`` with every corrector solution that converged
        but was rejected by ``max_step_factor`` (an observed tunnel).
      step: a corrector of :func:`make_arclength_step` to use (the branch
        enumerator shares one); built from the other arguments if None.
      group: shard the frozen corrector over its ranks (a frozen
        ``ncfg.fd_mode`` only; another is refused).
    """
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12,
                            fd_mode="exact")
    _check_param(param)
    check_group(ncfg, group)
    dt_, dev = cfg.torch_dtype, noise.device
    fixed, free0 = (sigma, beta0) if param == "beta" else (beta0, sigma)
    if step is None:
        step = make_arclength_step(cfg, noise, fixed, param, ncfg,
                                   evolve_backend, group)
    y = torch.cat([torch.as_tensor(Z0, dtype=dt_, device=dev).reshape(-1),
                   torch.tensor([float(free0)], dtype=dt_, device=dev)])
    tangent = (torch.as_tensor(tangent0, dtype=dt_, device=dev)
               if tangent0 is not None
               else initial_tangent(y.shape[0] - 1, direction, dt_, dev))
    out: list[ArcStep] = []
    cur_ds = float(ds)

    for i in range(n_steps):
        while True:
            res = step(y, tangent, cur_ds)
            ok = bool(res.converged) and bool(
                torch.isfinite(res.solution).all())
            if ok and max_step_factor is not None:
                dist = float(torch.linalg.vector_norm(res.solution - y))
                ok = dist <= max_step_factor * cur_ds
                if not ok and reject_hook is not None:
                    reject_hook(res.solution.detach().cpu().numpy())
            if ok or cur_ds <= min_ds:
                break
            cur_ds = max(min_ds, cur_ds * shrink)
        if not ok:
            break  # branch end, or the corrector fails even at min step
        tangent = next_tangent(res.solution, y, tangent)
        y = res.solution
        arc = ArcStep(y=y, tangent=tangent, converged=bool(res.converged),
                      iterations=int(res.iterations),
                      residual_norm=float(res.residual_norm))
        out.append(arc)
        if callback is not None:
            callback(i, arc)
        if int(res.iterations) <= 3:
            cur_ds = min(max_ds, cur_ds * grow)
    return out

