"""Damped Newton fixed-point solver with finite-difference or exact
Jacobians.

PyTorch runs eagerly, so the iteration is a plain host loop.  The
Jacobian's ``n`` (forward) or ``2n`` (central) perturbed evaluations go to
the residual oracle as ONE ``(n, n)`` or ``(2n, n)`` stack, which the
event-driven map evaluates in one evolve launch: one Newton iteration costs
two map evaluations.  ``fd_mode="exact"`` takes the residual's own exact
Jacobian (``F.value_and_jacobian``, :class:`..model.emap.ResidualFn`: one
tangent replay, K2T on the card), the caller's ``jacobian_fn``, or for any
other callable its forward-mode Jacobian (:func:`jacfwd_cols`), as the
JAX solver takes any differentiable callable.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import NewtonConfig
from ..utils.profiling import span, spanned
from .criterion import Criterion, residual_norm_criterion
from .linalg import solve_dense


class NewtonResult(NamedTuple):
    """Outcome of :func:`newton_solve`."""

    solution: torch.Tensor          # (n,) final iterate
    converged: bool
    iterations: int
    residual_norm: float            # final ||r||
    residual_history: torch.Tensor  # (max_iterations + 1,) on the CPU, NaN-padded
    jacobian: torch.Tensor          # (n, n) last Jacobian (identity if 0 iters)
    residual: torch.Tensor          # (n,) final residual


def fd_jacobian(F: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                f: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Forward-difference Jacobian ``jac[:, i] = (F(x + eps e_i) - f) / eps``,
    with all ``n`` perturbed points evaluated as one stack."""
    n = x.shape[0]
    eps = torch.tensor(epsilon, dtype=x.dtype, device=x.device)
    perturbed = x[None, :] + eps * torch.eye(n, dtype=x.dtype, device=x.device)
    df = F(perturbed)                   # (n, n): row i = F(x + eps e_i)
    return (df - f[None, :]).T / eps


def central_fd_jacobian(F: Callable[[torch.Tensor], torch.Tensor],
                        x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Central-difference Jacobian, all ``2n`` points as one stack."""
    n = x.shape[0]
    eps = torch.tensor(epsilon, dtype=x.dtype, device=x.device)
    e = eps * torch.eye(n, dtype=x.dtype, device=x.device)
    vals = F(torch.cat([x[None, :] + e, x[None, :] - e]))    # (2n, n)
    return (vals[:n] - vals[n:]).T / (2.0 * eps)


class JacobianUnavailable(RuntimeError):
    """An exact Jacobian that does not exist at the point asked for (the
    map's discrete outcome there cannot be differentiated as computed):
    :func:`newton_solve` stops at that iterate, not converged."""


def jacfwd_cols(F: Callable[..., torch.Tensor]
                ) -> Callable[..., torch.Tensor]:
    """The forward-mode Jacobian of ``F`` in its first argument (the JAX
    package's ``jacfwd_cols``): ``jac(x, *args)`` is ``dF(x, *args)/dx``,
    ``(m, n)`` for an ``(m,)`` output of an ``(n,)`` point, the extra
    arguments held as constants.

    It is ``torch.func.jacfwd`` (a vmap of ``jvp``).  The JAX package
    takes its ``n`` columns one ``jvp`` at a time because on the TPU a
    vmap over tangents through the replay's event loop ran ~25x slower
    than the columns; here the map's evolve receives the ``n`` tangents as
    one batch and replays them as the ``D`` axis of one tangent replay
    (one K2T launch on the card; :mod:`..model.autodiff`), so the vmapped
    shape is the right one.  ``F`` may be any callable that PyTorch can
    differentiate forward, the map of
    :func:`..model.emap.make_residual_fn` and compositions of it
    included."""
    def jac(x: torch.Tensor, *args) -> torch.Tensor:
        return torch.func.jacfwd(lambda xx: F(xx, *args))(x)
    return jac


def exact_jacobian(F: Callable, x: torch.Tensor) -> torch.Tensor:
    """The exact Jacobian of ``F`` at ``x``: ``F.value_and_jacobian(x)[1]``
    where ``F`` offers it (a residual of
    :func:`..model.emap.make_residual_fn`: one tangent replay), else
    :func:`jacfwd_cols` over ``F``."""
    vaj = getattr(F, "value_and_jacobian", None)
    return jacfwd_cols(F)(x) if vaj is None else vaj(x)[1]


def _print_header(max_iterations, tolerance):
    bar = "-" * 48
    print(bar)
    print(" Attempt to solve nonlinear problem with Newton Method")
    print(f" max number of iterations = {max_iterations}")
    print(f" tolerance = {tolerance}")
    print(bar)
    print(f"{'Iteration':>10}{'error estimate':>25}")


def _print_iteration(iteration, norm):
    print(f"{int(iteration):>10}{float(norm):>25.6e}")


def _print_footer(iterations, converged):
    print("-" * 48)
    verb = "converged" if bool(converged) else "failed to converge"
    print(f"The method {verb} after {int(iterations)} iterations")


def print_iteration_table(result: NewtonResult, cfg: NewtonConfig) -> None:
    """Print a finished solve's iteration log in the reference's format."""
    _print_header(cfg.max_iterations, cfg.tolerance)
    for it in range(result.iterations + 1):
        _print_iteration(it, result.residual_history[it])
    _print_footer(result.iterations, result.converged)


def _check_fd_mode(cfg: NewtonConfig) -> None:
    """Unknown modes fail loudly: an unrecognised ``fd_mode`` would
    silently take the forward-FD branch, in particular ``"frozen"``, which
    only the map-aware entry points implement."""
    if cfg.fd_mode not in ("forward", "central", "exact"):
        raise ValueError(
            f"fd_mode {cfg.fd_mode!r} is not supported by the generic "
            "Newton solver (use 'forward', 'central' or 'exact'; "
            "'frozen'/'frozen-fwd' live in solvers.staged."
            "newton_solve_frozen and analysis.continuation."
            "make_arclength_step_frozen)")


@spanned("solvers.newton")
def newton_solve(
    F: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    cfg: NewtonConfig,
    *,
    jacobian_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    criterion: Optional[Criterion] = None,
    jacobian0: Optional[torch.Tensor] = None,
) -> NewtonResult:
    """Solve ``F(x) = 0`` by damped Newton iteration.

    Args:
      F: residual oracle taking ``(n,)`` or a ``(P, n)`` stack.
      x0: initial guess; fixes dtype and device.
      cfg: tolerance, max_iterations, fd_epsilon, damping, print_output
        (prints the reference's table live), fd_mode and
        divergence_factor.
      jacobian_fn: optional analytic Jacobian ``x -> (n, n)``; with
        ``fd_mode="exact"`` and none given, :func:`exact_jacobian`
        (``F.value_and_jacobian``, or forward-mode AD over a callable that
        has none).
      criterion: convergence test on the residual norm; the absolute test at
        ``cfg.tolerance`` by default.
      jacobian0: optional warm-start Jacobian (quasi-Newton with refresh on
        failure): each iteration first steps with the carried Jacobian at
        one evaluation and computes a fresh one only when that step misses
        ``|F| <= 0.9 |F|``.  The exported Jacobian always belongs to this
        map: if every carried step was accepted it is recomputed at the
        final iterate.
    """
    test = criterion if criterion is not None else residual_norm_criterion(
        cfg.tolerance)
    _check_fd_mode(cfg)
    n = x0.shape[0]
    dt_, dev = x0.dtype, x0.device
    log = cfg.print_output

    @spanned("solvers.jacobian")
    def fresh_jacobian(x, f):
        if jacobian_fn is not None:
            return jacobian_fn(x)
        if cfg.fd_mode == "exact":
            return exact_jacobian(F, x)
        if cfg.fd_mode == "central":
            return central_fd_jacobian(F, x, cfg.fd_epsilon)
        return fd_jacobian(F, x, f, cfg.fd_epsilon)

    def step(jac, x, f):
        x_new = x + cfg.damping * solve_dense(jac, -f)
        f_new = F(x_new)
        return x_new, f_new, float(torch.linalg.vector_norm(f_new))

    x = x0
    f = F(x)
    norm = norm0 = float(torch.linalg.vector_norm(f))
    history = [norm0]
    converged = test(norm0)
    it = 0
    jac = (jacobian0.to(dtype=dt_, device=dev) if jacobian0 is not None
           else torch.eye(n, dtype=dt_, device=dev))
    stale = jacobian0 is not None
    if log:
        _print_header(cfg.max_iterations, cfg.tolerance)
        _print_iteration(0, norm0)

    while it < cfg.max_iterations and not converged:
        # early-divergence cutoff; a NaN norm compares False and stops too
        if (cfg.divergence_factor != math.inf
                and not norm <= cfg.divergence_factor * norm0):
            break
        with span("solvers.iteration"):
            try:
                if jacobian0 is None:
                    jac = fresh_jacobian(x, f)
                    x, f, norm = step(jac, x, f)
                else:
                    x_try, f_try, n_try = step(jac, x, f)
                    if n_try <= 0.9 * norm:
                        x, f, norm = x_try, f_try, n_try
                    else:
                        jac = fresh_jacobian(x, f)
                        stale = False
                        x, f, norm = step(jac, x, f)
            except JacobianUnavailable as e:
                if log:
                    print(f" stopped: {e}")
                break
            it += 1
            history.append(norm)
            converged = test(norm)
            if log:
                _print_iteration(it, norm)

    if stale:
        jac = fresh_jacobian(x, f)
    if log:
        _print_footer(it, converged)
    history += [math.nan] * (cfg.max_iterations + 1 - len(history))
    return NewtonResult(solution=x, converged=converged, iterations=it,
                        residual_norm=norm,
                        residual_history=torch.tensor(history, dtype=dt_),
                        jacobian=jac, residual=f)


@spanned("solvers.polish")
def frozen_jacobian_polish(
    F: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    jacobian: torch.Tensor,
    *,
    max_iterations: int = 8,
    tolerance: float = 0.0,
) -> NewtonResult:
    """Quasi-Newton polish with a frozen Jacobian, keeping the best iterate.

    Near a root of a piecewise-smooth residual full Newton stops contracting
    at the scale of the map's discontinuities (event reordering, ~1e-8 at
    N=4096) and bounces between them.  This polish reuses one Jacobian (the
    smooth part's slope), so each step is one map evaluation, steps from the
    best iterate so far with a cycle of dampings (a fixed Jacobian on a
    jumpy landscape can lock into a 2-cycle), and returns the lowest-norm
    iterate it visited.  ``residual_norm`` is a plain ``|F(solution)|``;
    ``converged`` means the tolerance was met (with the default 0.0 the
    polish is best effort and reports not converged).
    """
    x = x0
    best_x, best_f, best_norm = x0, None, math.inf
    dampings = (1.0, 0.5, 1.5, 0.75, 1.25, 0.35, 0.9, 1.1)
    it = 0
    for it in range(max_iterations + 1):
        f = F(x)
        norm = float(torch.linalg.vector_norm(f))
        # `best_f is None`: a NaN first residual must still populate best_f,
        # so the polish degrades to returning (x0, nan, not converged)
        if norm < best_norm or best_f is None:
            best_x, best_f, best_norm = x, f, norm
        if norm <= tolerance or it == max_iterations:
            break
        damp = dampings[it % len(dampings)]
        x = best_x + damp * solve_dense(jacobian, -best_f)
    history = torch.full((max_iterations + 1,), math.nan, dtype=x0.dtype)
    history[0] = best_norm
    return NewtonResult(solution=best_x, converged=best_norm <= tolerance,
                        iterations=it, residual_norm=best_norm,
                        residual_history=history, jacobian=jacobian,
                        residual=best_f)
