"""Faults planted in the program underneath a run: the CPU tests of the
check see ``correct`` come out false with each, and ``control.py --fault``
reads each at a cell's own size on the card.

* ``unchanged``: the solve returns its start, its state never moved;
* ``half_batch``: half of the realisations are left out of the ensemble
  mean, the mean taken over the rest;
* ``altered``: every answer is moved by 1e-3 where the solver produces it;
* ``stability``: the CLI's unstable count is off by one where it is
  produced (only in cells whose traffic records a count).
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered", "stability")


def applies(fault: str, loop: str) -> bool:
    """Whether a cell driven by ``loop`` can have ``fault``."""
    return fault != "stability" or loop == "cli_sweep"


def unchanged(x0, beta=None):
    """A solve whose state never moves: it returns its start."""
    from armadillocudalinearinterpolation_torch.solvers.newton import (
        NewtonResult)
    if beta is not None and beta.dtype == torch.float64:
        x0 = x0.to(torch.float64)
    return NewtonResult(solution=x0, converged=False, iterations=0,
                        residual_norm=float("nan"),
                        residual_history=torch.zeros(1),
                        jacobian=torch.eye(x0.shape[0], dtype=x0.dtype),
                        residual=x0 * float("nan"))


def altered(solve):
    def wrapped(*args, **kw):
        res = solve(*args, **kw)
        return res._replace(solution=res.solution + 1e-3)
    return wrapped


def half_batch(mean):
    def wrapped(positions, accept, group=None):
        R = positions.shape[-2]
        return mean(positions[..., :R // 2, :], accept[..., :R // 2], group)
    return wrapped


def off_by_one(count):
    def wrapped(*args, **kw):
        return count(*args, **kw) + 1
    return wrapped


def plant(fault: str, loop: str, set_attr=setattr) -> None:
    """Plant ``fault`` in the program for a cell driven by ``loop``;
    ``set_attr(obj, name, value)`` does the replacing (the tests pass
    ``monkeypatch.setattr``, which undoes it)."""
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.cli import driver as cli
    from armadillocudalinearinterpolation_torch.model import emap
    if not applies(fault, loop):
        raise ValueError(f"a {loop} cell cannot have the fault {fault!r}")
    if fault == "half_batch":
        set_attr(emap, "masked_ensemble_mean",
                 half_batch(emap.masked_ensemble_mean))
    elif fault == "stability":
        set_attr(cli, "count_unstable", off_by_one(cli.count_unstable))
    elif loop == "staged_solve":
        set_attr(pt, "newton_solve_staged", (
            lambda cfg, params, Z0, **kw: unchanged(Z0, kw.get("beta")))
            if fault == "unchanged" else altered(pt.newton_solve_staged))
    elif fault == "unchanged":
        set_attr(cli, "newton_solve", lambda F, x0, ncfg, **kw: unchanged(x0))
    else:
        set_attr(cli, "newton_solve", altered(cli.newton_solve))
