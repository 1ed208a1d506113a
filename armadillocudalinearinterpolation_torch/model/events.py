"""Event-time root finder: next threshold crossing of the LIF trajectory.

Between network events the membrane evolves as

    v(t) = v0 e^{-t} + I (1 - e^{-t}) + s0 (e^{-beta t} - e^{-t}) / (1 - beta)

and ``event_time`` solves ``v(t) = vth`` by Newton iteration from ``t = 0``
after a closed-form fire/no-fire decision; non-firing neurons return the
sentinel ``|t| + 100``.  Elementwise over arbitrary shapes.  These are the
plain versions of the per-lane arithmetic in ``csrc/evolve.cu``; both follow
the same formulas in the same operation order.

:func:`event_time_jvp` is the event time's tangent by the implicit function
theorem, an explicit function on tensors (the JAX package's custom JVP of
``event_time``): the exact Jacobians (:mod:`.replay`'s tangent replay, K2T)
are built from it.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig


def membrane_fun(t, v0, s0, beta, cfg: ModelConfig):
    """Residual ``v(t) - vth``."""
    emt = torch.exp(-t)
    return (v0 * emt + cfg.drive * (1.0 - emt)
            + s0 * emt / (1.0 - beta) * (torch.exp((1.0 - beta) * t) - 1.0)
            - cfg.vth)


def membrane_dfun(t, v0, s0, beta, cfg: ModelConfig):
    """Time derivative of :func:`membrane_fun`."""
    emt = torch.exp(-t)
    embt = torch.exp(-t * (beta - 1.0))
    return (cfg.drive * emt - v0 * emt + s0 * emt * embt
            + (s0 * emt * (embt - 1.0)) / (beta - 1.0))


def fire_decision(v0, s0, beta, cfg: ModelConfig):
    """Closed-form test whether the trajectory can reach threshold.

    For ``s0 < 0`` the fractional power is NaN and the comparison is False:
    a NaN decision means "no fire".
    """
    # The constant is a tensor on the operands' device: CUDA turns division
    # by (or of) a Python scalar into a multiplication by a reciprocal,
    # which rounds differently from the true division the kernel does.
    gap = torch.tensor(cfg.vth - cfg.drive, dtype=s0.dtype, device=s0.device)
    q = torch.pow(s0 / gap, 1.0 / beta)
    rhs = (cfg.vth * q + cfg.drive * (1.0 - q)
           - gap / (beta - 1.0) * (s0 / gap - q))
    return v0 > rhs


def event_time(v0, s0, beta, cfg: ModelConfig):
    """Next firing time per neuron, with no-fire sentinel.

    Each lane runs plain undamped Newton from ``t = 0`` while
    ``|f| > root_tol``, for at most ``counter_max`` steps; non-firers start
    from ``f = 0`` and never iterate.  Returns ``|t| + 100 * (1 - decision)``.
    """
    dt_ = v0.dtype
    decision = fire_decision(v0, s0, beta, cfg)
    t = torch.zeros_like(v0)
    f = membrane_fun(t, v0, s0, beta, cfg) * decision.to(dt_)
    for _ in range(cfg.counter_max):
        active = torch.abs(f) > cfg.root_tol
        if not bool(active.any()):
            break
        df = membrane_dfun(t, v0, s0, beta, cfg)
        t = torch.where(active, t - f / df, t)
        f = torch.where(active, membrane_fun(t, v0, s0, beta, cfg), f)
    return torch.abs(t) + 100.0 * (1.0 - decision.to(dt_))


def event_time_jvp(v0, s0, beta, dv0, ds0, dbeta, cfg: ModelConfig, *,
                   root=None, form: str = "evolve", fires=None):
    """The event time and its tangent along ``(dv0, ds0, dbeta)``:
    ``dt*/dtheta = -(df/dtheta) / (df/dt)`` at the root ``t*``.

    ``form="evolve"`` is the JAX package's rule for :func:`event_time`
    (``model/events.py:97-138`` there): the root is ``event_time``'s, the
    partials are those of :func:`membrane_fun`, and a non-firing lane (the
    constant sentinel) has tangent 0; ``fires`` replaces the lanes' own
    fire decision where the caller knows it (the evolve's logged time:
    ``root < 100``).  ``form="shared"`` takes the partials
    of the shared-exponential form ``v e_t + I (1 - e_t) + s (e_b - e_t) /
    (1 - b) - vth`` (``e_t = exp(-t)``, ``e_b = exp(-b t)``), the form of
    the replay's root-find, at a given polished ``root`` (every lane taken
    as firing; the caller masks).  The tangents may carry leading axes
    (directions) that broadcast against the primal.

    Returns ``(t, dt)``.
    """
    if form == "shared":
        if root is None:
            raise ValueError("form='shared' needs the polished root")
        t = root
        e_t = torch.exp(-t)
        e_b = torch.exp(-beta * t)
        f_t = (cfg.drive - v0) * e_t + s0 * (e_t - beta * e_b) / (1.0 - beta)
        f_s = (e_b - e_t) / (1.0 - beta)
        f_b = s0 * (f_s - t * e_b) / (1.0 - beta)
        return t, -(e_t * dv0 + f_s * ds0 + f_b * dbeta) / f_t
    if form != "evolve":
        raise ValueError(f"form must be 'evolve' or 'shared'; got {form!r}")
    tau = event_time(v0, s0, beta, cfg) if root is None else root
    decision = fire_decision(v0, s0, beta, cfg) if fires is None else fires
    t = torch.where(decision, tau, torch.zeros_like(tau))
    u = 1.0 - beta
    emt = torch.exp(-t)
    ebt = torch.exp(u * t)
    g = (ebt - 1.0) / u
    f_t = (cfg.drive * emt - v0 * emt + s0 * emt * ebt
           + (s0 * emt * (ebt - 1.0)) / (beta - 1.0))
    f_v = emt
    f_s = emt * g
    f_b = s0 * emt * ((ebt - 1.0) - t * u * ebt) / (u * u)
    dtan = -(f_v * dv0 + f_s * ds0 + f_b * dbeta) / f_t
    return tau, torch.where(decision, dtan, torch.zeros_like(dtan))
