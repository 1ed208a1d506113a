"""Restrict: linear interpolation of spike crossings at the time horizon,
and the masked Monte-Carlo mean.

The reference's reduction pair overwrote realisation 0's accept flag with
the total count; here count and mask are separate values.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from .evolve import EvolveResult


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


def masked_ensemble_mean(positions: torch.Tensor, accept: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo mean over accepted realisations.

    Args:
      positions: ``(..., R, M)`` restricted positions.
      accept: ``(..., R)`` bool accept flags.

    Returns:
      ``(mean, count)`` of shapes ``(..., M)`` and ``(...)``.  A zero
      count gives a NaN mean: a map at unphysical parameters fails loudly.
    """
    mask = accept.to(positions.dtype)
    count = mask.sum(dim=-1)
    return (positions * mask[..., None]).sum(dim=-2) / count[..., None], count
