"""Branch enumeration: branch-switching continuation.

The port of the JAX package's ``analysis/branches.py``: a worklist walks
every discovered branch in both directions with the guarded corrector (no
silent family jumps), harvests the corrector solutions the guard rejected
(observed tunnels to another family) and, at each branch end, fires
unguarded discovery steps of growing length; a landing point far from the
end and not on a known branch seeds a new walk.  Points are told apart in
the bifurcation-diagram plane ``(parameter, c)``, ``c = Z[0]`` the wave
speed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig, NewtonConfig
from ..model.emap import check_backend
from .continuation import check_group, continue_branch, make_arclength_step


class Branch(NamedTuple):
    """One fully walked branch segment."""

    points: np.ndarray        # (K, n+1) accepted y = (Z..., param) per step
    origin: str               # how this walk was seeded (provenance)
    hit_step_limit: bool      # False: it ended at a genuine branch end


def _diagram_coords(y: np.ndarray) -> np.ndarray:
    """A point's projection on the bifurcation-diagram plane (param, c)."""
    return np.asarray([y[-1], y[0]], dtype=float)


def is_known(y, known_pts: list[np.ndarray], tol: float) -> bool:
    """Whether ``y`` lies within ``tol`` of a recorded branch point, by
    Euclidean distance in the ``(parameter, c)`` plane (two families at
    one parameter differ in speed; the gauge-fixed offsets are ignored)."""
    if not known_pts:
        return False
    d = _diagram_coords(np.asarray(y))
    pts = np.stack(known_pts)
    return bool(np.min(np.linalg.norm(pts - d, axis=1)) < tol)


def enumerate_branches(cfg: ModelConfig, noise: torch.Tensor, Z0, beta0, *,
                       sigma=0.0, param: str = "beta",
                       ds: float = 0.1, n_steps: int = 100,
                       ncfg: Optional[NewtonConfig] = None,
                       evolve_backend: str = "auto",
                       max_branches: int = 4,
                       jump_ds_factors=(0.02, 0.1, 0.5, 1.0, 2.0, 4.0, 8.0),
                       jump_min_dist: float = 0.3,
                       dedupe_tol: float = 0.05,
                       callback: Optional[Callable] = None,
                       group=None, **walk_kw) -> list[Branch]:
    """Enumerate the solution families reachable from ``(Z0, beta0)``.

    Walks the seed branch both ways with the guarded corrector; new
    families come from the walks' tunnels (``reject_hook``) and from end
    probes of ``ds * factor`` past each branch end.  A candidate at least
    ``jump_min_dist`` from its walk and not within ``dedupe_tol`` of a
    recorded point seeds a new walk (both ways for a tunnel, onward only
    for an end probe).  Stops when the worklist drains or
    ``max_branches`` walks are accepted.

    Args:
      noise: the ``(R, N)`` noise of every walk (common random numbers).
      beta0, sigma, param: as :func:`.continuation.continue_branch`.
      callback: ``f(branch_index, step_index, ArcStep)`` per step.
      group: shard the frozen corrector over its ranks (a frozen
        ``ncfg.fd_mode`` only, as the JAX package's ``branches.py:129-135``;
        another is refused).
      **walk_kw: passed to :func:`.continuation.continue_branch`.

    Returns:
      The :class:`Branch` list in discovery order; ``hit_step_limit``
      False means the corrector failed there even at the minimum step.
    """
    if ncfg is None:
        ncfg = NewtonConfig(tolerance=1e-9, max_iterations=12,
                            fd_mode="exact")
    dt_, dev = cfg.torch_dtype, noise.device
    check_backend(evolve_backend)
    check_group(ncfg, group)
    fixed, free0 = (sigma, beta0) if param == "beta" else (beta0, sigma)
    # one corrector for every walk and every end probe
    probe = make_arclength_step(cfg, noise, fixed, param, ncfg,
                                evolve_backend, group)

    known_pts: list[np.ndarray] = []
    branches: list[Branch] = []
    z0 = np.asarray(Z0.detach().cpu() if isinstance(Z0, torch.Tensor)
                    else Z0, dtype=float)
    # worklist: (Z_start, free_start, direction, origin, tangent0)
    work = [(z0, float(free0), +1.0, "seed+", None),
            (z0, float(free0), -1.0, "seed-", None)]

    def queue_seed(y_new: np.ndarray, origin: str, tangent0=None) -> bool:
        """Queue a discovery candidate if it is new: with ``tangent0`` (an
        end probe's jump) only onward, since the reverse walk would
        re-cross the probed end; a tunnel both ways."""
        if is_known(y_new, known_pts, dedupe_tol):
            return False
        work.append((y_new[:-1], float(y_new[-1]), +1.0, origin + "+",
                     tangent0))
        if tangent0 is None:
            work.append((y_new[:-1], float(y_new[-1]), -1.0, origin + "-",
                         None))
        known_pts.append(_diagram_coords(y_new))
        return True

    while work and len(branches) < max_branches:
        Zs, ps, direction, origin, tan0 = work.pop(0)
        b_idx = len(branches)
        cb = ((lambda i, s: callback(b_idx, i, s))
              if callback is not None else None)
        walk_beta0, walk_sigma = ((ps, fixed) if param == "beta"
                                  else (fixed, ps))
        tunnels: list[np.ndarray] = []
        steps = continue_branch(
            cfg, noise, Zs, walk_beta0, sigma=walk_sigma, param=param,
            ds=ds, n_steps=n_steps, direction=direction, ncfg=ncfg,
            evolve_backend=evolve_backend, callback=cb, tangent0=tan0,
            reject_hook=tunnels.append, step=probe, **walk_kw)
        if not steps:
            continue
        pts = np.stack([s.y.detach().cpu().numpy() for s in steps])
        branches.append(Branch(points=pts, origin=origin,
                               hit_step_limit=len(steps) == n_steps))
        known_pts.extend(_diagram_coords(p) for p in pts)

        # a tunnel must clear the same minimum distance from the walked
        # branch as an end probe, or a long step along the SAME family
        # would seed a re-walk of a known branch
        walk_dc = np.stack([_diagram_coords(p) for p in pts])
        for y_t in tunnels:
            d_t = _diagram_coords(np.asarray(y_t))
            if float(np.min(np.linalg.norm(walk_dc - d_t, axis=1))
                     ) < jump_min_dist:
                continue
            if queue_seed(np.asarray(y_t), f"tunnel@{origin}:"):
                break  # one new family per walk end is plenty
        if len(steps) == n_steps:
            continue  # no branch end reached: nothing to probe

        y_end, t_end = steps[-1].y, steps[-1].tangent
        for factor in jump_ds_factors:
            res = probe(y_end, t_end, factor * ds)
            if not (bool(res.converged)
                    and bool(torch.isfinite(res.solution).all())):
                continue
            y_new = res.solution.detach().cpu().numpy()
            d = y_new - y_end.detach().cpu().numpy()
            if (np.linalg.norm(d) >= jump_min_dist
                    and queue_seed(y_new, f"jump@{origin}:{factor:g}ds",
                                   tangent0=torch.as_tensor(
                                       d / np.linalg.norm(d), dtype=dt_,
                                       device=dev))):
                break
    return branches
