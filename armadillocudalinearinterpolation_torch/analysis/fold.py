"""Two-parameter fold tracking (the smooth-fold curve in the parameter
plane).

The port of the JAX package's ``analysis/fold.py``.  A quadratic fold
satisfies the Moore-Spence system in ``w = (Z, v, beta)``:

    F(Z; beta, sigma) = 0          (n equations: on the branch)
    J(Z; beta, sigma) v = 0        (n equations: J singular along v)
    v.v - 1 = 0                    (v normalised)

which is regular at the fold although ``J`` is singular there, so damped
Newton converges on it.  ``J v`` is one exact directional derivative of
the map (:func:`..model.emap.map_jvp`: one tangent replay direction, K2T
on the card, with ``v`` as the ``Z`` seed); the extended system's own
Jacobian, which holds second derivatives of the map, is taken by central
finite differences over its ``2n + 1`` unknowns, so a whole stencil is one
evolve and one tangent replay of ``2(2n + 1)`` points.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import MapParams, ModelConfig, NewtonConfig
from ..model.emap import check_backend, map_jvp
from ..solvers.newton import newton_solve


class FoldPoint(NamedTuple):
    """One point on the fold curve ``beta_fold(sigma)``."""

    sigma: float
    beta: float               # fold location in the walked parameter
    Z: np.ndarray             # solution at the fold
    v: np.ndarray             # unit null vector of dF/dZ at the fold
    residual_norm: float      # of the extended system
    converged: bool


def make_fold_residual(cfg: ModelConfig, noise: torch.Tensor, *,
                       evolve_backend: str = "auto") -> Callable:
    """Extended-system residual ``H(w, sigma)`` with ``w = (Z, v, beta)``,
    for one point ``(2n + 1,)`` or a stack ``(P, 2n + 1)`` (each point at
    its own beta: one evolve of ``P * R`` rows with their own rates)."""
    n = cfg.n_spikes
    dt_ = cfg.torch_dtype
    check_backend(evolve_backend)
    noise = noise.to(dtype=dt_).contiguous()

    def H(w: torch.Tensor, sigma) -> torch.Tensor:
        ws = w[None] if w.ndim == 1 else w
        P = ws.shape[0]
        params = MapParams(beta=ws[:, 2 * n].to(dt_),
                           sigma=torch.full((P,), float(sigma), dtype=dt_,
                                            device=ws.device))
        f, jv = map_jvp(cfg, params, noise, ws[:, :n], ws[None, :, n:2 * n],
                        evolve_backend=evolve_backend)
        v = ws[:, n:2 * n]
        out = torch.cat([f, jv[0], ((v * v).sum(-1) - 1.0)[:, None]], dim=1)
        return out[0] if w.ndim == 1 else out

    return H


def null_direction(jacobian) -> np.ndarray:
    """Unit right-singular vector for the smallest singular value of J:
    the initial guess of the fold system's null vector."""
    if isinstance(jacobian, torch.Tensor):
        jacobian = jacobian.detach().cpu().numpy()
    _, _, vt = np.linalg.svd(np.asarray(jacobian))
    return vt[-1]


def solve_fold(cfg: ModelConfig, noise: torch.Tensor, Z0, v0, beta0, sigma,
               *, ncfg: Optional[NewtonConfig] = None,
               evolve_backend: str = "auto") -> FoldPoint:
    """Newton-solve the extended fold system at fixed ``sigma``.  The
    system's Jacobian is central FD (an exact one would need second
    derivatives): an ``exact`` or frozen ``ncfg`` is pinned to central FD
    at eps 1e-6, its other fields kept."""
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-8, max_iterations=20,
                            fd_epsilon=1e-6, fd_mode="central")
    if ncfg.fd_mode in ("exact", "frozen", "frozen-fwd"):
        ncfg = dataclasses.replace(ncfg, fd_mode="central", fd_epsilon=1e-6)
    dt_, dev = cfg.torch_dtype, noise.device
    H = make_fold_residual(cfg, noise, evolve_backend=evolve_backend)
    w0 = torch.cat([torch.as_tensor(np.asarray(Z0, dtype=float), dtype=dt_),
                    torch.as_tensor(np.asarray(v0, dtype=float), dtype=dt_),
                    torch.tensor([float(beta0)], dtype=dt_)]).to(dev)
    res = newton_solve(lambda ww: H(ww, sigma), w0, ncfg)
    n = cfg.n_spikes
    sol = res.solution.detach().cpu().numpy()
    return FoldPoint(sigma=float(sigma), beta=float(sol[2 * n]),
                     Z=sol[:n], v=sol[n:2 * n],
                     residual_norm=float(res.residual_norm),
                     converged=bool(res.converged))


def track_fold(cfg: ModelConfig, noise: torch.Tensor, Z0, v0, beta0,
               sigma_values: Sequence[float], *,
               ncfg: Optional[NewtonConfig] = None,
               evolve_backend: str = "auto",
               callback: Optional[Callable] = None) -> list[FoldPoint]:
    """Continue the fold curve over ``sigma_values``, each solve
    warm-started from the previous fold point.  Stops at the first failure
    (the fold may leave the window or meet the grazing boundary); the
    returned prefix is valid."""
    out: list[FoldPoint] = []
    Z, v, beta = Z0, v0, beta0
    for sigma in sigma_values:
        pt = solve_fold(cfg, noise, Z, v, beta, float(sigma), ncfg=ncfg,
                        evolve_backend=evolve_backend)
        if not (pt.converged and np.all(np.isfinite(pt.Z))
                and np.isfinite(pt.beta)):
            break
        out.append(pt)
        if callback is not None:
            callback(pt)
        Z, v, beta = pt.Z, pt.v, pt.beta
    return out
