"""The event-driven map ``F(Z)`` of the ring network, written plainly in
PyTorch: the benchmark's reference.

It follows the reference program (kyle-wedgwood/ArmadilloCUDALinearInterpolation:
``EventDrivenMap.cu``'s lift, event loop and restriction, with
``parameters.hpp``'s constants) and the deviations from it that the port
keeps on purpose: the lowest index wins a tie for the next event, an event
belongs to the nearest tracked trajectory (lowest id on ties), the reset
voltage is 0, and the accept mask and count are separate.  It imports
nothing of the program under test and takes nothing the program made: the
caller hands it the points, the draws of the rates, and the constants of
the configuration's file.

Every function runs in any float dtype on any device.  The benchmark runs
it in float64 to judge the program's answers; the controls run it in a
lower precision: ``store=torch.bfloat16`` keeps every lane's state (the
lift, the rates, ``v`` and ``s`` after each event) rounded to bfloat16
while the arithmetic runs in the points' dtype, as bfloat16 storage with
float32 arithmetic does.  Rows are independent: each has its own initial state,
its own rates and its own events, and a row's loop stops once all its
trajectories have crossed the horizon ``T`` or its time reaches ``2T``.

Between events a lane's voltage and synaptic input evolve as

    v(t) = v e^{-t} + I (1 - e^{-t}) + s e^{-t} (e^{(1 - b) t} - 1) / (1 - b)
    s(t) = s e^{-b t}

and the next event of a row is the earliest threshold crossing over its
lanes, found by Newton's method from ``t = 0`` on the lanes whose
closed-form fire decision says they can reach the threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Model(NamedTuple):
    """The constants of one configuration (the configuration file's
    ``model`` group)."""

    n_neurons: int
    n_spikes: int
    vth: float
    drive: float
    a1: float
    a2: float
    b1: float
    b2: float
    half_width: float
    t_horizon: float
    root_tol: float
    counter_max: int

    @staticmethod
    def of(model: dict) -> "Model":
        return Model(**{k: model[k] for k in Model._fields})

    @property
    def dx(self) -> float:
        return 2.0 * self.half_width / self.n_neurons


class Outcome(NamedTuple):
    """A row's spike bookkeeping once its loop has stopped."""

    last_ind: torch.Tensor      # (rows, M) last firing lane before T
    last_time: torch.Tensor     # (rows, M)
    cross_ind: torch.Tensor     # (rows, M) first firing lane after T
    cross_time: torch.Tensor    # (rows, M)
    accept: torch.Tensor        # (rows,) every trajectory crossed T
    n_events: torch.Tensor      # (rows,)


def spike_indices(m: Model, Z: torch.Tensor) -> torch.Tensor:
    """``(P, M)`` grid indices of the spikes of the points ``Z`` ``(P,
    M)``: spike 0 at ``N // 2``; spike ``k >= 1`` at the largest ``i``
    with ``-L + i dx < -c Z[k]``, never past spike ``k - 1``."""
    c = Z[:, :1]
    dx = torch.tensor(m.dx, dtype=Z.dtype, device=Z.device)
    raw = torch.ceil((-c * Z[:, 1:] + m.half_width) / dx).long() - 1
    idx = raw.clamp(0, m.n_neurons - 1)
    cols = [torch.full((Z.shape[0],), m.n_neurons // 2, dtype=torch.long,
                       device=Z.device)]
    for k in range(m.n_spikes - 1):
        cols.append(torch.minimum(idx[:, k], cols[-1]))
    return torch.stack(cols, dim=1)


def _voltage_pair(x, c, u, beta, a, b):
    """One exponential pair's voltage profile ahead of and behind a spike
    at offset ``u``."""
    cb = c * b
    front = a * beta * c / ((beta + cb) * (1.0 + cb))
    boundary = front * torch.exp(u * (1.0 + cb)) * torch.exp(-b * c * u)
    homog = (a * beta * c / (1.0 - beta) * torch.exp(beta * u)
             * (1.0 / (beta + cb) + 1.0 / (cb - beta))
             * (torch.exp(x / c * (1.0 - beta)) - torch.exp(u * (1.0 - beta))))
    partic = (a * beta * c / ((cb - beta) * (1.0 - cb)) * torch.exp(b * c * u)
              * (torch.exp(x * (1.0 - cb) / c) - torch.exp(u * (1.0 - cb))))
    ahead = boundary + homog - partic
    behind = front * torch.exp(x * (1.0 + cb) / c) * torch.exp(-b * c * u)
    return ahead, behind


def _synapse_pair(x, c, u, beta, a, b):
    """One exponential pair's synaptic profile ahead of and behind a
    spike."""
    cb = c * b
    ahead = beta * a * c / (beta + cb) * torch.exp(b * (x - c * u))
    behind = (2.0 * a / b * beta / (1.0 - beta * beta / (cb * cb))
              * torch.exp(-beta / c * (x - c * u))
              - beta * a * c / (cb - beta) * torch.exp(b * (c * u - x)))
    return ahead, behind


def lift(m: Model, beta_mean: torch.Tensor, Z: torch.Tensor):
    """The travelling-wave state ``(v, s)`` ``(P, N)`` of the points ``Z``
    ``(P, M)`` at the mean rates ``beta_mean`` ``(P,)``: the closed forms
    of the reference's lift, sampled at the mirrored coordinate ``x_i = L
    - i dx``; spike 1 sits at offset 0, spike ``k > 1`` at ``Z[k - 1]``."""
    dt_, dev = Z.dtype, Z.device
    x = m.half_width - m.dx * torch.arange(m.n_neurons, dtype=dt_,
                                           device=dev)
    c = Z[:, :1]
    beta = beta_mean.to(dt_)[:, None]
    offsets = torch.cat([torch.zeros_like(c), Z[:, 1:]], dim=1)
    v = torch.zeros(Z.shape[0], m.n_neurons, dtype=dt_, device=dev)
    s = torch.zeros_like(v)
    for k in range(m.n_spikes):
        u = offsets[:, k:k + 1]
        front = x - c * u > 0.0
        p1, n1 = _voltage_pair(x, c, u, beta, m.a1, m.b1)
        p2, n2 = _voltage_pair(x, c, u, beta, m.a2, m.b2)
        v = (v + torch.where(front, p1 - p2, n1 - n2) * torch.exp(-x / c)
             - torch.where(front, torch.exp(-(x - c * u) / c),
                           torch.zeros_like(x)))
        s1a, s1b = _synapse_pair(x, c, u, beta, m.a1, m.b1)
        s2a, s2b = _synapse_pair(x, c, u, beta, m.a2, m.b2)
        s = s + torch.where(c * u - x > 0.0, s1a - s2a, s1b - s2b)
    v = m.drive + v
    return torch.where(v < m.vth, v, torch.zeros_like(v)), s


def fire_decision(m: Model, v, s, b):
    """Whether each lane can reach the threshold before its input decays
    (13 operations a lane); ``s < 0`` gives NaN, which is no fire."""
    gap = torch.tensor(m.vth - m.drive, dtype=v.dtype, device=v.device)
    q = torch.pow(s / gap, 1.0 / b)
    rhs = m.vth * q + m.drive * (1.0 - q) - gap / (b - 1.0) * (s / gap - q)
    return v > rhs


def _membrane(m: Model, t, v, s, b):
    e = torch.exp(-t)
    return (v * e + m.drive * (1.0 - e)
            + s * e / (1.0 - b) * (torch.exp((1.0 - b) * t) - 1.0) - m.vth)


def _membrane_dt(m: Model, t, v, s, b):
    e = torch.exp(-t)
    eb = torch.exp(-t * (b - 1.0))
    return (m.drive * e - v * e + s * e * eb
            + s * e * (eb - 1.0) / (b - 1.0))


def crossing_times(m: Model, v, s, b):
    """Newton's method from ``t = 0`` on the firing lanes (1-D tensors),
    while ``|f| > root_tol``, for at most ``counter_max`` steps."""
    t = torch.zeros_like(v)
    f = _membrane(m, t, v, s, b)
    for _ in range(m.counter_max):
        active = f.abs() > m.root_tol
        if not bool(active.any()):
            break
        t = torch.where(active, t - f / _membrane_dt(m, t, v, s, b), t)
        f = torch.where(active, _membrane(m, t, v, s, b), f)
    return t.abs()


def kick_table(m: Model, dtype, device) -> torch.Tensor:
    """``w(d) dx`` for ring index distances ``d = 0 .. N - 1``."""
    d = torch.arange(m.n_neurons, device=device)
    dist = torch.minimum(d, m.n_neurons - d).to(dtype) * m.dx
    return (m.a1 * torch.exp(-m.b1 * dist)
            - m.a2 * torch.exp(-m.b2 * dist)) * m.dx


def advance(m: Model, v, s, b, dt, j, lane, wtab):
    """Every lane of each row by its event: ``dt`` ``(rows, 1)`` and the
    firing lane ``j`` ``(rows, 1)`` (20 operations a lane)."""
    e = torch.exp(-dt)
    one_b = 1.0 - b
    v_new = (v * e + m.drive * (1.0 - e)
             + s * e / one_b * (torch.exp(one_b * dt) - 1.0))
    v_new = torch.where(lane == j, torch.zeros_like(v_new), v_new)
    d = (lane - j).abs()
    w = wtab[torch.minimum(d, m.n_neurons - d)]
    s_new = s * torch.exp(-b * dt) + b * w
    return v_new, s_new


def _stored(x, store):
    return x if store is None else x.to(store).to(x.dtype)


def evolve(m: Model, v0, s0, rates, ind0, store=None) -> Outcome:
    """The event loop of ``(rows, N)`` initial states ``v0``, ``s0`` under
    the rates ``rates`` ``(rows, N)``, tracking the spikes that start at
    the lanes ``ind0`` ``(rows, M)``; ``store``: the dtype the lanes'
    state is kept in between events (None: their own)."""
    dt_, dev = v0.dtype, v0.device
    rows, N = v0.shape
    M, T = m.n_spikes, m.t_horizon
    v, s, b = v0.clone(), s0.clone(), rates
    t = torch.zeros(rows, dtype=dt_, device=dev)
    last_ind = ind0.clone()
    cross_ind = ind0.clone()
    last_time = torch.zeros(rows, M, dtype=dt_, device=dev)
    cross_time = torch.full((rows, M), 2.0 * T, dtype=dt_, device=dev)
    crossed = torch.zeros(rows, M, dtype=torch.bool, device=dev)
    n_events = torch.zeros(rows, dtype=torch.long, device=dev)
    lane = torch.arange(N, device=dev)[None, :]
    traj = torch.arange(M, device=dev)[None, :]
    wtab = kick_table(m, dt_, dev)
    sentinel = torch.tensor(100.0, dtype=dt_, device=dev)
    while True:
        live = ~crossed.all(dim=1) & (t < 2.0 * T)
        if not bool(live.any()):
            break
        fires = fire_decision(m, v, s, b) & live[:, None]
        r, c = fires.nonzero(as_tuple=True)
        times = sentinel.expand(rows, N).clone()
        times[r, c] = crossing_times(m, v[r, c], s[r, c], b[r, c])
        j = times.argmin(dim=1, keepdim=True)       # lowest lane on ties
        dt = times.gather(1, j)
        v_new, s_new = advance(m, v, s, b, dt, j, lane, wtab)
        t_new = t + dt[:, 0]
        v = _stored(torch.where(live[:, None], v_new, v), store)
        s = _stored(torch.where(live[:, None], s_new, s), store)
        t = torch.where(live, t_new, t)
        k = (j - last_ind).abs().argmin(dim=1, keepdim=True)
        own = traj == k
        fresh = ~crossed.gather(1, k)[:, 0]
        after = t_new > T
        is_cross = (fresh & after & live)[:, None] & own
        is_last = (fresh & ~after & live)[:, None] & own
        last_ind = torch.where(is_last, j, last_ind)
        last_time = torch.where(is_last, t_new[:, None], last_time)
        cross_ind = torch.where(is_cross, j, cross_ind)
        cross_time = torch.where(is_cross, t_new[:, None], cross_time)
        crossed = crossed | is_cross
        n_events = n_events + live.long()
    return Outcome(last_ind, last_time, cross_ind, cross_time,
                   crossed.all(dim=1), n_events)


def residual(m: Model, Z: torch.Tensor, beta_mean: torch.Tensor,
             rates: torch.Tensor, *, outcome: bool = False, store=None):
    """``F`` at the points ``Z`` ``(P, M)``, each with its mean rate
    ``beta_mean[p]`` (the lift's) and its draw ``rates[p]`` ``(R, N)``:
    lift, evolve the ``P R`` rows, restrict each spike's crossing of ``T``
    by linear interpolation, average over the accepted realisations, and
    return ``f = -c (0, Z[1:]) - mean + c T`` ``(P, M)``; with ``outcome``
    also the rows' :class:`Outcome`; ``store`` as in :func:`evolve`."""
    P, R = rates.shape[0], rates.shape[1]
    M, T = m.n_spikes, m.t_horizon
    v0, s0 = lift(m, beta_mean, Z)
    ind0 = spike_indices(m, Z)
    res = evolve(m, _stored(v0, store).repeat_interleave(R, dim=0),
                 _stored(s0, store).repeat_interleave(R, dim=0),
                 _stored(rates.reshape(P * R, -1).to(Z.dtype), store),
                 ind0.repeat_interleave(R, dim=0), store)
    x0 = -m.half_width + m.dx * res.last_ind.to(Z.dtype)
    x1 = -m.half_width + m.dx * res.cross_ind.to(Z.dtype)
    pos = x0 + (T - res.last_time) * (x1 - x0) / (res.cross_time
                                                   - res.last_time)
    acc = res.accept.reshape(P, R)
    pos = torch.where(acc[..., None], pos.reshape(P, R, M),
                      torch.zeros_like(pos.reshape(P, R, M)))
    mean = pos.sum(dim=1) / acc.sum(dim=1, keepdim=True).to(Z.dtype)
    c = Z[:, :1]
    U = torch.cat([torch.zeros_like(c), Z[:, 1:]], dim=1)
    f = -c * U - mean + c * T
    return (f, res) if outcome else f


def newton(m: Model, z0: torch.Tensor, beta_mean: float,
           rates: torch.Tensor, *, tol: float, max_iter: int, eps: float,
           store=None):
    """Newton's method with forward differences at step ``eps`` (the
    CLI's solve, with no predictor), from ``z0`` ``(M,)``: each iteration
    evaluates ``F`` at ``z`` and its ``M`` perturbations in one call.
    Returns ``(z, |F(z)|, converged, iterations)``; stops early on a
    non-finite iterate."""
    M = z0.shape[0]
    mean = torch.full((M + 1,), beta_mean, dtype=z0.dtype, device=z0.device)
    stack = rates[None].expand(M + 1, *rates.shape)
    e = eps * torch.eye(M, dtype=z0.dtype, device=z0.device)
    z, it = z0, 0
    while True:
        f = residual(m, torch.cat([z[None], z[None] + e]), mean, stack,
                     store=store)
        norm = float(torch.linalg.vector_norm(f[0]))
        if norm <= tol or it == max_iter or norm != norm:
            return z, norm, norm <= tol, it
        jac = (f[1:] - f[0]).T / eps
        z = z + torch.linalg.solve(jac, -f[0])
        it += 1
