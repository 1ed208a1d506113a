"""Rank workers of the sharding tests.

The ranks of a :class:`RankPool` other than rank 0 (the test process) are
started with the ``spawn`` method and import this module by name: it
imports torch and the port only, never JAX or ``conftest.py``.  Each case
function makes its :class:`ShardGroup` and returns tensors on the CPU;
:func:`run_cases` runs a list of cases in one call of the ranks.
"""

import os

import torch
import torch.distributed as dist

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.analysis.continuation import (
    initial_tangent, make_arclength_step_frozen)
from armadillocudalinearinterpolation_torch.parallel import (
    ShardGroup, event_driven_map_sharded, sharded_newton_solve)
from armadillocudalinearinterpolation_torch.solvers.staged import (
    newton_solve_frozen)


def run_cases(cases):
    """``cases``: ``[(name, function name, kwargs)]``; returns ``{name:
    result}`` of this rank."""
    return {name: globals()[fn](**kw) for name, fn, kw in cases}


def _solution(res):
    return {"solution": res.solution.cpu(), "converged": bool(res.converged),
            "iterations": int(res.iterations),
            "residual_norm": float(res.residual_norm)}


def sharded_map(cfg, params, beta, Z, P=1):
    g = ShardGroup(cfg.n_real)
    f = event_driven_map_sharded(cfg, params, beta, Z, g)
    # this rank's rows of a (P * R, 1) row index
    index = torch.arange(P * cfg.n_real, dtype=torch.float64)[:, None]
    return {"f": f.cpu(), "block": (g.lo, g.hi), "reduces": g.reduces,
            "rows": g.rows(index, P).flatten().long()}


def frozen_stencil(cfg, params, beta, z, pts):
    g = ShardGroup(cfg.n_real)
    outcome = pt.compute_discrete_outcome(cfg, params, beta, z, g)
    f = pt.frozen_schedule_map_batched(cfg, params, beta, pts, *outcome,
                                       group=g)
    return {"f": f.cpu(), "schedule_rows": int(outcome[0].shape[0]),
            "reduces": g.reduces}


def frozen_solve(cfg, params, beta, z, ncfg):
    return _solution(newton_solve_frozen(cfg, params, beta, z, ncfg,
                                         ShardGroup(cfg.n_real)))


def staged_solve(cfg, params, beta, z, kw):
    return _solution(pt.newton_solve_staged(
        cfg, params, z, beta=beta, group=ShardGroup(cfg.n_real), **kw))


def arclength_step(cfg, noise, y0, ds, ncfg):
    step = make_arclength_step_frozen(cfg, noise, 0.0, "beta", ncfg,
                                      group=ShardGroup(cfg.n_real))
    return _solution(step(y0, initial_tangent(3, 1.0, torch.float64), ds))


def newton(cfg, params, beta, z, ncfg):
    return _solution(sharded_newton_solve(cfg, params, beta, z, ncfg,
                                          ShardGroup(cfg.n_real)))


def exact_jacobian(cfg, params, noise, z, param):
    g = ShardGroup(cfg.n_real)
    F = pt.make_residual_fn(cfg, params, 0, device=noise.device, noise=noise,
                            group=g)
    f, J = F.value_and_jacobian(z, param=param)
    return {"f": f.cpu(), "J": J.cpu(), "reduces": g.reduces}


def whereabouts():
    """This rank's process and device."""
    return {"rank": dist.get_rank(), "pid": os.getpid(),
            "device": str(_rank_device())}


def _rank_device():
    """This rank's card under NCCL, else the CPU."""
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def reduce_twice(n_real):
    """Two all-reduces of three float64 ones; the second's sums."""
    g = ShardGroup(n_real)
    ones = torch.ones(3, dtype=torch.float64, device=_rank_device())
    g.all_reduce(ones)
    return g.all_reduce(ones)[0].cpu()


def raise_on_rank(n_real, rank):
    """Rank ``rank`` raises before the collective the others wait in."""
    g = ShardGroup(n_real)
    if g.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    out = g.all_reduce(torch.zeros(3, dtype=torch.float64,
                                   device=_rank_device()))
    return out[0].cpu()


def group_of(n_real):
    g = ShardGroup(n_real)
    return (g.lo, g.hi)


def _launches():
    from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                              replay_cuda)
    return {"k1": evolve_cuda.LAUNCHES, "k2": replay_cuda.LAUNCHES,
            "k2t": replay_cuda.TANGENT_LAUNCHES}


def _zero_launches():
    from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                              replay_cuda)
    evolve_cuda.LAUNCHES = replay_cuda.LAUNCHES = 0
    replay_cuda.TANGENT_LAUNCHES = 0


def card_draw(cfg, params, seed):
    """The draw of ``seed`` on this rank's card (the same on every rank)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    params = pt.MapParams(beta=params.beta.to(dev), sigma=params.sigma.to(dev))
    return dev, params, pt.sample_beta(
        cfg, params, torch.Generator(device=dev).manual_seed(seed))


def card_map(cfg, params, seed, Z):
    """The sharded map on the card, with this rank's kernel launches."""
    dev, params, beta = card_draw(cfg, params, seed)
    g = ShardGroup(cfg.n_real)
    _zero_launches()
    f = event_driven_map_sharded(cfg, params, beta, Z.to(dev), g)
    return {"f": f.cpu(), "backend": g.backend, "launches": _launches()}


def card_staged(cfg, params, seed, Z, kw):
    """The sharded staged solve on the card, with this rank's launches."""
    dev, params, beta = card_draw(cfg, params, seed)
    _zero_launches()
    res = pt.newton_solve_staged(cfg, params, Z.to(dev), beta=beta,
                                 group=ShardGroup(cfg.n_real), **kw)
    return {**_solution(res), "launches": _launches()}
