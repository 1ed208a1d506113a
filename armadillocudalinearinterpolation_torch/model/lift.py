"""Lift: closed-form traveling-wave initial condition ``(v, s)``.

The reference's lift samples a *mirrored* coordinate ``x_i = L - dx*i``
while every other stage uses ``x_i = -L + dx*i``; the closed forms are
evaluated at the mirrored coordinate so every index-based stage agrees with
the reference.  The lift uses the *mean* rate ``beta``: heterogeneity
enters only in evolve.

Every function takes a leading batch of points: ``U`` of shape
``(..., n_spikes + 1)`` lifts to ``(..., n_neurons)``.  :func:`lift` runs
the kernel K9 (``csrc/lift.cu``, :mod:`.lift_cuda`) on CUDA tensors and
:func:`lift_plain`, the loop over the spikes, on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ModelConfig, MapParams
from ..utils.profiling import spanned
from .evolve_cuda import config_key


def _lift_voltage_term(x, c, u, beta, a, b):
    """One (a, b) exponential-pair contribution to the voltage profile:
    ``(pos_branch, neg_branch)`` selected on ``x - c*u > 0``.  Written
    with methods (``.exp()``), so that it also runs on the dual numbers of
    :func:`.lift_cuda.lift_tangent_plain`."""
    cb = c * b
    boundary = (a * beta * c) / ((beta + cb) * (1.0 + cb)) * (
        u * (1.0 + cb)).exp() * (-b * c * u).exp()
    homog = (a * beta * c / (1.0 - beta)) * (beta * u).exp() * (
        1.0 / (beta + cb) + 1.0 / (cb - beta)) * (
            ((x / c) * (1.0 - beta)).exp() - (u * (1.0 - beta)).exp())
    partic = (a * beta * c / ((cb - beta) * (1.0 - cb))) * (
        b * c * u).exp() * ((x * (1.0 - cb) / c).exp()
                            - (c * u * (1.0 - cb) / c).exp())
    pos = boundary + homog - partic
    neg = (a * beta * c) / ((beta + cb) * (1.0 + cb)) * (
        x * (1.0 + cb) / c).exp() * (-b * c * u).exp()
    return pos, neg


def _lift_synapse_term(x, c, u, beta, a, b):
    """One (a, b) contribution to the synaptic profile: ``(ahead, behind)``."""
    cb = c * b
    ahead = beta * a * (c / (beta + cb)) * (b * (x - c * u)).exp()
    behind = ((2.0 * a / b) * (beta / (1.0 - (beta * beta) / (cb * cb)))
              * (-(beta / c) * (x - c * u)).exp()
              - beta * a * (c / (cb - beta)) * (b * (c * u - x)).exp())
    return ahead, behind


@spanned("map.lift")
def lift(cfg: ModelConfig, params: MapParams, U: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form lift of ``U = (c, u_1..u_M)`` to ``(v, s)``: one launch
    of K9 on CUDA tensors, through
    :class:`.autodiff.DifferentiableLift` (forward-differentiable, its
    tangents from K9T; it launches or raises), and :func:`lift_plain` on
    the CPU.

    Args:
      params: ``params.beta``, the mean rate, 0-dim or one per point
        (broadcasting against ``U[..., :1]``, as :func:`.emap.point_params`
        gives it).
      U: ``(..., n_spikes + 1)`` gauge-fixed state: speed then offsets.

    Returns:
      ``(v, s)`` of shape ``(..., n_neurons)`` in ``U``'s dtype and device.
    """
    beta = params.beta.to(dtype=U.dtype, device=U.device)
    if U.device.type != "cuda":
        return lift_plain(cfg, beta, U)
    from .autodiff import DifferentiableLift
    lead = U.shape[:-1]
    v, s = DifferentiableLift.apply(
        U.reshape(-1, U.shape[-1]).contiguous(),
        beta.expand(*lead, 1).reshape(-1), config_key(cfg))
    return v.reshape(*lead, -1), s.reshape(*lead, -1)


def lift_plain(cfg: ModelConfig, beta: torch.Tensor, U: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lift as plain PyTorch, a loop over the spikes (the JAX
    package's ``model/lift.py:66-100``): the CPU path of :func:`lift` and
    the plain version of K9.

    Args:
      beta: the mean rate in ``U``'s dtype and device, 0-dim or
        broadcasting against ``U[..., :1]``.
      U: ``(..., n_spikes + 1)`` gauge-fixed state: speed then offsets.
        ``U`` and ``beta`` may also be :class:`.lift_cuda.Dual` numbers.

    Returns:
      ``(v, s)`` of shape ``(..., n_neurons)`` in ``U``'s dtype and device.
    """
    dt_, dev = U.dtype, U.device
    i = torch.arange(cfg.n_neurons, dtype=dt_, device=dev)
    x = cfg.half_width - cfg.dx * i
    c = U[..., :1]

    v_acc = torch.zeros(U.shape[:-1] + (cfg.n_neurons,), dtype=dt_,
                        device=dev)
    s_acc = torch.zeros_like(v_acc)
    zero = torch.zeros((), dtype=dt_, device=dev)
    for m in range(1, cfg.n_spikes + 1):
        u = U[..., m:m + 1]
        ahead = (x - c * u) > 0.0

        p1, n1 = _lift_voltage_term(x, c, u, beta, cfg.a1, cfg.b1)
        p2, n2 = _lift_voltage_term(x, c, u, beta, cfg.a2, cfg.b2)
        dummy_v = (p1 - p2).where(ahead, n1 - n2) * (-x / c).exp()
        v_acc = v_acc + dummy_v - (-(x - c * u) / c).exp().where(ahead, zero)

        s1a, s1b = _lift_synapse_term(x, c, u, beta, cfg.a1, cfg.b1)
        s2a, s2b = _lift_synapse_term(x, c, u, beta, cfg.a2, cfg.b2)
        behind_spike = (c * u - x) > 0.0
        s_acc = s_acc + (s1a - s2a).where(behind_spike, s1b - s2b)

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
