"""Restrict: linear interpolation of spike crossings at the time horizon,
and the masked Monte-Carlo mean.

The reference's reduction pair overwrote realisation 0's accept flag with
the total count; here count and mask are separate values.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..utils.profiling import spanned
from .evolve import EvolveResult


@spanned("map.restrict")
def restrict_positions(cfg: ModelConfig, res: EvolveResult) -> torch.Tensor:
    """Interpolated crossing position ``x(T)`` per (row, spike):

        x(T) = x0 + (T - t0) * (x1 - x0) / (t1 - t0)

    with ``x = -L + dx * ind`` of the last pre-``T`` and first post-``T``
    events.  Returns the shape of ``res.last_time``.
    """
    dt_ = res.last_time.dtype
    x0 = -cfg.half_width + cfg.dx * res.last_ind.to(dt_)
    x1 = -cfg.half_width + cfg.dx * res.crossed_ind.to(dt_)
    t0 = res.last_time
    t1 = res.crossed_time
    return x0 + (cfg.t_horizon - t0) * (x1 - x0) / (t1 - t0)


def masked_sums(positions: torch.Tensor, accept: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sums, count)``: the float64 sums ``(..., M)`` of the restricted
    positions ``(..., R, M)`` over the accepted realisations (``accept``
    ``(..., R)`` bool), and their float64 counts ``(...)``.

    Float32 positions are summed in float64, which rounds far below
    float32's precision: the float32 mean then does not move with the
    order of the terms (an FD Jacobian at step ``eps`` would amplify a
    reassociated float32 sum by ``1 / eps``), so a sharded ensemble gives
    the unsharded mean.  The JAX package sums in the positions' dtype.
    """
    mask = accept.to(positions.dtype)
    return ((positions * mask[..., None]).sum(dim=-2, dtype=torch.float64),
            mask.sum(dim=-1, dtype=torch.float64))


def reduce_mean(sums: torch.Tensor, count: torch.Tensor, group=None,
                *extra: torch.Tensor) -> tuple:
    """``(sums / count, count, *extra)``, where with a ``group`` (a
    :class:`..parallel.sharding.ShardGroup` whose ranks hold the other
    realisations) ``sums``, ``count`` and the float64 tensors ``extra``
    are first summed over the ranks in ONE all-reduce."""
    if group is not None:
        sums, count, *extra = group.all_reduce(sums, count, *extra)
    return (sums / count[..., None], count, *extra)


@spanned("map.mean")
def masked_ensemble_mean(positions: torch.Tensor, accept: torch.Tensor,
                         group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo mean over accepted realisations.

    Args:
      positions: ``(..., R, M)`` restricted positions.
      accept: ``(..., R)`` bool accept flags.
      group: a :class:`..parallel.sharding.ShardGroup` whose ranks hold the
        other realisations (:func:`reduce_mean`).

    Returns:
      ``(mean, count)`` of shapes ``(..., M)`` and ``(...)``, in the
      positions' dtype (summed by :func:`masked_sums`).  A zero count
      gives a NaN mean: a map at unphysical parameters fails loudly.
    """
    mean, count = reduce_mean(*masked_sums(positions, accept), group)
    return mean.to(positions.dtype), count.to(positions.dtype)
