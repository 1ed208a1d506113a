"""Lift: closed-form traveling-wave initial condition ``(v, s)``.

The reference's lift samples a *mirrored* coordinate ``x_i = L - dx*i``
while every other stage uses ``x_i = -L + dx*i``; the closed forms are
evaluated at the mirrored coordinate so every index-based stage agrees with
the reference.  The lift uses the *mean* rate ``beta``: heterogeneity
enters only in evolve.

Every function takes a leading batch of points: ``U`` of shape
``(..., n_spikes + 1)`` lifts to ``(..., n_neurons)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ModelConfig, MapParams


def _lift_voltage_term(x, c, u, beta, a, b):
    """One (a, b) exponential-pair contribution to the voltage profile:
    ``(pos_branch, neg_branch)`` selected on ``x - c*u > 0``."""
    cb = c * b
    boundary = (a * beta * c) / ((beta + cb) * (1.0 + cb)) * torch.exp(
        u * (1.0 + cb)) * torch.exp(-b * c * u)
    homog = (a * beta * c / (1.0 - beta)) * torch.exp(beta * u) * (
        1.0 / (beta + cb) + 1.0 / (cb - beta)) * (
            torch.exp((x / c) * (1.0 - beta)) - torch.exp(u * (1.0 - beta)))
    partic = (a * beta * c / ((cb - beta) * (1.0 - cb))) * torch.exp(
        b * c * u) * (torch.exp(x * (1.0 - cb) / c)
                      - torch.exp(c * u * (1.0 - cb) / c))
    pos = boundary + homog - partic
    neg = (a * beta * c) / ((beta + cb) * (1.0 + cb)) * torch.exp(
        x * (1.0 + cb) / c) * torch.exp(-b * c * u)
    return pos, neg


def _lift_synapse_term(x, c, u, beta, a, b):
    """One (a, b) contribution to the synaptic profile: ``(ahead, behind)``."""
    cb = c * b
    ahead = beta * a * (c / (beta + cb)) * torch.exp(b * (x - c * u))
    behind = ((2.0 * a / b) * (beta / (1.0 - (beta * beta) / (cb * cb)))
              * torch.exp(-(beta / c) * (x - c * u))
              - beta * a * (c / (cb - beta)) * torch.exp(b * (c * u - x)))
    return ahead, behind


def lift(cfg: ModelConfig, params: MapParams, U: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form lift of ``U = (c, u_1..u_M)`` to ``(v, s)``.

    Args:
      U: ``(..., n_spikes + 1)`` gauge-fixed state: speed then offsets.

    Returns:
      ``(v, s)`` of shape ``(..., n_neurons)`` in ``U``'s dtype and device.
    """
    dt_, dev = U.dtype, U.device
    i = torch.arange(cfg.n_neurons, dtype=dt_, device=dev)
    x = cfg.half_width - cfg.dx * i
    c = U[..., :1]
    beta = params.beta.to(dtype=dt_, device=dev)

    v_acc = torch.zeros(U.shape[:-1] + (cfg.n_neurons,), dtype=dt_,
                        device=dev)
    s_acc = torch.zeros_like(v_acc)
    zero = torch.zeros((), dtype=dt_, device=dev)
    for m in range(1, cfg.n_spikes + 1):
        u = U[..., m:m + 1]
        ahead = (x - c * u) > 0.0

        p1, n1 = _lift_voltage_term(x, c, u, beta, cfg.a1, cfg.b1)
        p2, n2 = _lift_voltage_term(x, c, u, beta, cfg.a2, cfg.b2)
        dummy_v = torch.where(ahead, p1 - p2, n1 - n2) * torch.exp(-x / c)
        v_acc = v_acc + dummy_v - torch.where(
            ahead, torch.exp(-(x - c * u) / c), zero)

        s1a, s1b = _lift_synapse_term(x, c, u, beta, cfg.a1, cfg.b1)
        s2a, s2b = _lift_synapse_term(x, c, u, beta, cfg.a2, cfg.b2)
        behind_spike = (c * u - x) > 0.0
        s_acc = s_acc + torch.where(behind_spike, s1a - s2a, s1b - s2b)

    v = cfg.drive + v_acc
    # clamp super-threshold sites to the reset value
    v = v * (v < cfg.vth).to(dt_)
    return v, s_acc


def initial_spike_indices(cfg: ModelConfig, Z: torch.Tensor) -> torch.Tensor:
    """Grid index just left of each spike's initial position ``-c * Z[m]``.

    Spike 0 pins to the grid midpoint; spike ``m >= 1`` takes the largest
    ``i`` with ``-L + dx*i < -Z[0] * Z[m]``, and never exceeds the previous
    spike's index (the reference scans downward from it).  The ``ceil`` runs
    in ``Z``'s dtype.

    Args:
      Z: ``(..., n_spikes)`` reduced state.

    Returns:
      ``(..., n_spikes)`` int32.
    """
    c = Z[..., :1]
    pos = -c * Z[..., 1:cfg.n_spikes]
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which can move the ceil
    dx = torch.tensor(cfg.dx, dtype=Z.dtype, device=Z.device)
    raw = torch.ceil((pos + cfg.half_width) / dx).to(torch.int32) - 1
    idx = torch.clamp(raw, 0, cfg.n_neurons - 1)
    inds = [torch.full(Z.shape[:-1], cfg.n_neurons // 2, dtype=torch.int32,
                       device=Z.device)]
    for m in range(cfg.n_spikes - 1):
        inds.append(torch.minimum(idx[..., m], inds[-1]))
    return torch.stack(inds, dim=-1)
