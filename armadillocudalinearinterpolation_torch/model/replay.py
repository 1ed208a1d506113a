"""Schedule replay: the accurate evolve as a replay of a known firing order,
in native fp64.

Two passes, as in the JAX package's ``model/replay.py`` but without its
double-float layer (the card has fp64):

1. **Discovery** (:func:`compute_schedule`): the evolve runs once in f32
   and keeps the discrete outcome, the firing order of every row (K1 with
   its log on the card, the plain evolve on the CPU).
2. **Replay** (:func:`replay_events`): given the order, each event time is
   the threshold crossing of ONE known lane per row, a scalar root-find
   seeded by the f32 event time and polished twice by Newton in fp64; then
   every lane advances by the closed form in fp64.

A row's replay stops once all its trajectories have crossed ``T``, as the
evolve stops it; events logged past that point change nothing.  The
discovery pass logs until every trajectory has fired after ``T +
DISCOVERY_MARGIN`` (:func:`discovery_config`), so that the f32 pass's drift
(measured up to 4.2e-5 in crossing times at N=4096 on an H100) cannot end a
log before the fp64 replay has seen every crossing.  The JAX package's
discovery stops at ``T`` itself: there a row whose f32 crossing lands just
before ``T`` while its fp64 crossing lands just after is rejected, which at
config 4 (N=4096, R=64) moved the replay map up to 1.2e-5 off the direct
fp64 map near its root and stalled the staged solve at 3.3e-6.

Consistency guards reject a row (``accept = False``):

* a log that overflowed (``n_sched > E``);
* a misfire: the scheduled lane's f32 seed is the no-fire sentinel
  (``dt32 >= 100``; a grazing event where the f32 pass and the fp64 state
  disagree), so the row takes a harmless step of f32(0.05) instead;
* a scheduled lane outside ``[0, N)``; the row stops there.

Row layout, as in the evolve: row ``p * R + r`` replays point ``p``'s lift
under realisation ``r``.  A schedule of ``R`` rows (one discovery pass)
serves every point; one of ``P * R`` rows gives each row its own.
``init_ind`` is ``(M,)``, one seeding shared by every point (the frozen
outcome), or ``(P, M)``.

:func:`replay_events` is the plain version of the K2 kernel
(``csrc/replay.cu``, :mod:`.replay_cuda`): the CPU path, and the kernel's
oracle on the card; both follow the same formulas in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from .coupling import mexican_hat
from .events import event_time, event_time_jvp, membrane_dfun
from .evolve import EvolveResult, beta_rows
from .evolve_batched import evolve_ensemble_batched
from .evolve_cuda import evolve_ensemble_cuda

# The step a misfiring row takes: the JAX replay's f32 0.05, exactly.
MISFIRE_DT = float(torch.tensor(0.05, dtype=torch.float32))
# How far past T the discovery pass keeps logging (time units): ~500 times
# the f32 drift measured at N=4096, ~14 more events per row there.
DISCOVERY_MARGIN = 0.02


def schedule_width(cfg: ModelConfig) -> int:
    """Columns of the firing-order log: ``max_events`` rounded up to a
    multiple of 128, as the JAX package rounds it, so that a row overflows
    here exactly where it overflows there."""
    return -(-cfg.max_events // 128) * 128


def schedule_config(cfg: ModelConfig) -> ModelConfig:
    """The f32 configuration of the replay's root-find seeds."""
    return cfg.with_(dtype="float32", root_tol=max(cfg.root_tol, 1e-6))


def discovery_config(cfg: ModelConfig) -> ModelConfig:
    """The configuration of the f32 discovery pass: the seeds' config with
    the horizon moved ``DISCOVERY_MARGIN`` later."""
    return schedule_config(cfg).with_(
        t_horizon=cfg.t_horizon + DISCOVERY_MARGIN)


def kick_table(cfg: ModelConfig, device=None) -> torch.Tensor:
    """``w(d) * dx`` in fp64 for ring index distances ``d = 0 .. N/2``: the
    values the fp64 evolve's analytic kick takes (``model/evolve.py``)."""
    d = torch.arange(cfg.n_neurons // 2 + 1, dtype=torch.float64,
                     device=device)
    return mexican_hat(d * cfg.dx, cfg) * cfg.dx


def check_replay_inputs(cfg: ModelConfig, sched, n_sched, v0, s0, beta,
                        init_ind, n_real=None) -> None:
    """Shapes, dtypes and devices shared by both replay versions."""
    N, M = cfg.n_neurons, cfg.n_spikes
    if v0.ndim != 2 or v0.shape[1] != N or s0.shape != v0.shape:
        raise ValueError(f"v0 and s0 must both be (P, {N}); got "
                         f"{tuple(v0.shape)} and {tuple(s0.shape)}")
    if beta.ndim != 2 or beta.shape[1] != N:
        raise ValueError(f"beta must be (R, {N}) or (P * R, {N}); got "
                         f"{tuple(beta.shape)}")
    P = v0.shape[0]
    R, _ = beta_rows(beta, P, n_real)
    if sched.ndim != 2 or sched.shape[0] not in (R, P * R) \
            or sched.shape[1] < 1:
        raise ValueError(f"sched must be ({R}, E) or ({P * R}, E) with E >= "
                         f"1; got {tuple(sched.shape)}")
    if tuple(n_sched.shape) != (sched.shape[0],):
        raise ValueError(f"n_sched must be ({sched.shape[0]},); got "
                         f"{tuple(n_sched.shape)}")
    if tuple(init_ind.shape) not in ((M,), (1, M), (P, M)):
        raise ValueError(f"init_ind must be ({M},) or ({P}, {M}); got "
                         f"{tuple(init_ind.shape)}")
    for name, x in (("sched", sched), ("n_sched", n_sched),
                    ("init_ind", init_ind)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32; got {x.dtype}")
    if not (v0.dtype == s0.dtype == beta.dtype
            and v0.dtype in (torch.float32, torch.float64)):
        raise TypeError("v0, s0 and beta must share one dtype, float32 or "
                        f"float64; got {v0.dtype}, {s0.dtype}, {beta.dtype}")
    if len({t.device for t in (sched, n_sched, v0, s0, beta,
                               init_ind)}) != 1:
        raise ValueError("sched, n_sched, v0, s0, beta and init_ind must be "
                         "on one device")


def check_tangent_inputs(cfg: ModelConfig, v0, beta, dv0, ds0, base, dp,
                         n_real=None, sched=None, times=None) -> int:
    """Shapes of the tangent replay's directions, its rate tangents
    ``(base, dp)`` and its time log; returns ``D``."""
    P, N = v0.shape
    R, _ = beta_rows(beta, P, n_real)
    if dv0.ndim != 3 or dv0.shape[1:] != (P, N) or ds0.shape != dv0.shape:
        raise ValueError(f"dv0 and ds0 must both be (D, {P}, {N}); got "
                         f"{tuple(dv0.shape)} and {tuple(ds0.shape)}")
    D = dv0.shape[0]
    if D < 1:
        raise ValueError("the tangent replay needs at least one direction")
    if tuple(dp.shape) != (D, P):
        raise ValueError(f"dp must be ({D}, {P}); got {tuple(dp.shape)}")
    if base is not None and tuple(base.shape) != (R, N):
        raise ValueError(f"base must be ({R}, {N}) or None; got "
                         f"{tuple(base.shape)}")
    if times is not None and times.shape != sched.shape:
        raise ValueError(f"times must be shaped as sched, "
                         f"{tuple(sched.shape)}; got {tuple(times.shape)}")
    for name, x in (("dv0", dv0), ("ds0", ds0), ("base", base), ("dp", dp),
                    ("times", times)):
        if x is not None and (x.dtype != torch.float64
                              or x.device != v0.device):
            raise TypeError(f"{name} must be float64 on {v0.device}; got "
                            f"{x.dtype} on {x.device}")
    return D


def _membrane_shared(t, v, s, b, cfg: ModelConfig):
    """Residual ``v(t) - vth`` in the shared-exponential form
    ``v e_t + I (1 - e_t) + s (e_b - e_t) / (1 - b) - vth``, ``e_t =
    exp(-t)``, ``e_b = exp(-b t)``: the form of the replay's advance."""
    e_t = torch.exp(-t)
    e_b = torch.exp(-b * t)
    return (v * e_t + cfg.drive * (1.0 - e_t) + s * (e_b - e_t) / (1.0 - b)
            - cfg.vth)


def _replay(cfg: ModelConfig, sched, n_sched, v0, s0, beta, init_ind,
            n_real, tangents, times=None):
    """The replay loop of :func:`replay_events` and, with ``tangents =
    (dv0, ds0, base, dp)``, of :func:`replay_events_tangent`: the primal
    lines are the same either way.  ``times``: the event times of the
    evolve that logged ``sched``, taken in place of the root-find.
    Returns ``(result, d_last, d_crossed)`` (the tangents None without
    ``tangents``)."""
    f64, dev, out_dt = torch.float64, v0.device, v0.dtype
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), cfg.n_spikes
    rows, E = P * R, sched.shape[1]
    T = cfg.t_horizon
    cfg32 = schedule_config(cfg)
    v = v0.to(f64).repeat_interleave(R, dim=0)
    s = s0.to(f64).repeat_interleave(R, dim=0)
    b = beta.to(f64) if per_row else beta.to(f64).repeat(P, 1)
    sch = sched.repeat(rows // sched.shape[0], 1)
    tms = None if times is None else times.repeat(rows // sched.shape[0], 1)
    ns = n_sched.repeat(rows // sched.shape[0])
    ii = init_ind.reshape(-1, M)
    last_ind = ii.repeat_interleave(rows // ii.shape[0], dim=0)
    crossed_ind = last_ind.clone()
    last_time = torch.zeros(rows, M, dtype=f64, device=dev)
    crossed_time = torch.full((rows, M), 2.0 * T, dtype=f64, device=dev)
    crossed = torch.zeros(rows, M, dtype=torch.bool, device=dev)
    t = torch.zeros(rows, dtype=f64, device=dev)
    n_live = torch.clamp(ns, max=E)
    consistent = ns <= E
    stopped = torch.zeros(rows, dtype=torch.bool, device=dev)
    wtab = kick_table(cfg, dev)
    lane = torch.arange(N, device=dev)[None, :]
    traj = torch.arange(M, device=dev)[None, :]
    if tangents is not None:
        dv0, ds0, base, dp = tangents
        D = dv0.shape[0]
        dv = dv0.repeat_interleave(R, dim=1)                 # (D, rows, N)
        ds = ds0.repeat_interleave(R, dim=1)
        # the rates' tangent of row p * R + r: dp[d, p] * base[r]
        db = (torch.zeros(D, rows, N, dtype=f64, device=dev)
              if base is None else (dp[:, :, None, None] * base[None, None])
              .reshape(D, rows, N))
        tt = torch.zeros(D, rows, dtype=f64, device=dev)
        one = torch.ones((), dtype=f64, device=dev)
        d_last = torch.zeros(D, rows, M, dtype=f64, device=dev)
        d_crossed = torch.zeros(D, rows, M, dtype=f64, device=dev)

    for k in range(int(n_live.max()) if rows else 0):
        j = sch[:, k]
        bad = (j < 0) | (j >= N)
        live = (k < n_live) & ~stopped & ~crossed.all(dim=1)
        consistent = consistent & ~(bad & live)
        stopped = stopped | (bad & live)
        live = live & ~bad
        jj = torch.clamp(j, 0, N - 1).long()[:, None]

        vj, sj, bj = (torch.gather(x, 1, jj)[:, 0] for x in (v, s, b))
        if times is None:
            # scalar root-find of the scheduled lane: f32 seed, two fp64
            # polishes
            dt32 = event_time(vj.float(), sj.float(), bj.float(), cfg32)
            misfire = dt32 >= 100.0
            dt = torch.where(misfire, MISFIRE_DT, dt32.to(f64))
            for _ in range(2):
                f = _membrane_shared(dt, vj, sj, bj, cfg)
                fp = membrane_dfun(dt, vj, sj, bj, cfg)
                fp = torch.where(torch.abs(fp) > 1e-12, fp, 1.0)
                dt = dt - f / fp
            # a misfire's polish iterates on a rootless residual: pin it
            # back so no NaN reaches the row; a live row's dt is never
            # clamped
            dt = torch.where(misfire, MISFIRE_DT, dt)
            consistent = consistent & ~(misfire & live)
        else:
            # the evolve's own time, as it took it (no misfire: the evolve
            # fired this lane at this time)
            dt = tms[:, k]

        # closed-form advance, reset of the firing lane, ring kick
        dtc = dt[:, None]
        e_t = torch.exp(-dtc)
        e_b = torch.exp(-b * dtc)
        v_new = v * e_t + cfg.drive * (1.0 - e_t) + s * (e_b - e_t) / (1.0 - b)
        v_new = torch.where(lane == jj, 0.0, v_new)
        d = torch.abs(lane - jj)
        w = wtab[torch.minimum(d, N - d)]
        s_new = s * e_b + b * w
        t_new = t + dt

        livec = live[:, None]
        if tangents is not None:
            # d(dt) by the implicit function theorem at the polished root
            # (0 for a misfire, whose dt is pinned), or by the evolve's own
            # rule at its logged time (0 where no lane fired, the sentinel
            # >= 100); then the advance's partials in v, s, b and dt; the
            # reset lane's v has tangent 0
            dj = [torch.gather(x, 2, jj[None].expand(D, -1, -1))[..., 0]
                  for x in (dv, ds, db)]
            if times is None:
                ddt = torch.where(misfire, 0.0, event_time_jvp(
                    vj, sj, bj, *dj, cfg, root=dt, form="shared")[1])
            else:
                ddt = event_time_jvp(vj, sj, bj, *dj, cfg, root=dt,
                                     form="evolve", fires=dt < 100.0)[1]
            ddtc = ddt[..., None]
            inv = one / (1.0 - b)
            q = (e_b - e_t) * inv
            de_t = -e_t * ddtc
            de_b = -e_b * (db * dtc + b * ddtc)
            dq = ((de_b - de_t) + q * db) * inv
            dv_new = (dv * e_t + v * de_t - cfg.drive * de_t + ds * q
                      + s * dq)
            dv_new = torch.where(lane == jj, 0.0, dv_new)
            ds_new = ds * e_b + s * de_b + db * w
            dv = torch.where(livec, dv_new, dv)
            ds = torch.where(livec, ds_new, ds)
            tt_new = tt + ddt
            tt = torch.where(live, tt_new, tt)
        v = torch.where(livec, v_new, v)
        s = torch.where(livec, s_new, s)
        t = torch.where(live, t_new, t)

        # bookkeeping, as in the evolve
        m = torch.argmin(torch.abs(j[:, None] - last_ind), dim=1)
        onehot = traj == m[:, None]
        fresh = ~torch.gather(crossed, 1, m[:, None])[:, 0]
        after = t_new > T
        is_cross = (fresh & after & live)[:, None] & onehot
        is_last = (fresh & ~after & live)[:, None] & onehot
        jc, tc = j[:, None], t_new[:, None]
        last_ind = torch.where(is_last, jc, last_ind)
        last_time = torch.where(is_last, tc, last_time)
        crossed_ind = torch.where(is_cross, jc, crossed_ind)
        crossed_time = torch.where(is_cross, tc, crossed_time)
        crossed = crossed | is_cross
        if tangents is not None:
            d_last = torch.where(is_last, tt_new[..., None], d_last)
            d_crossed = torch.where(is_cross, tt_new[..., None], d_crossed)

    accept = crossed.all(dim=1) & consistent
    result = EvolveResult(last_ind=last_ind, last_time=last_time.to(out_dt),
                          crossed_ind=crossed_ind,
                          crossed_time=crossed_time.to(out_dt),
                          accept=accept, n_events=ns.clone())
    if tangents is None:
        return result, None, None
    # a rejected row's times enter no mean: its tangents are 0
    keep = accept[None, :, None]
    return (result, torch.where(keep, d_last, 0.0),
            torch.where(keep, d_crossed, 0.0))


def replay_events(cfg: ModelConfig, sched: torch.Tensor,
                  n_sched: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                  beta: torch.Tensor, init_ind: torch.Tensor, *,
                  n_real=None) -> EvolveResult:
    """Replay a recorded firing order in fp64 (plain version of K2).

    Args:
      sched: ``(R, E)`` or ``(P * R, E)`` int32 firing-order log.
      n_sched: its int32 event counts, one per schedule row.
      v0, s0: ``(P, N)`` lifted states, float32 or float64.
      beta: ``(R, N)`` rates, in the dtype of ``v0``; or ``(P * R, N)``,
        one row per replay row (points with their own parameters), with
        ``n_real=R``.
      init_ind: ``(M,)`` or ``(P, M)`` int32 initial spike indices.

    Returns:
      :class:`EvolveResult` over ``P * R`` rows, times in ``v0.dtype``
      (f32 inputs are evolved in fp64 and rounded at the end);
      ``n_events`` is ``n_sched`` per row and ``accept`` also requires the
      row to be consistent (see the module docstring).  A row stops at
      ``min(n_sched, E)`` events or once all its trajectories have crossed.
    """
    check_replay_inputs(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real)
    return _replay(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real,
                   None)[0]


def replay_events_tangent(cfg: ModelConfig, sched: torch.Tensor,
                          n_sched: torch.Tensor, v0: torch.Tensor,
                          s0: torch.Tensor, beta: torch.Tensor,
                          init_ind: torch.Tensor, dv0: torch.Tensor,
                          ds0: torch.Tensor, base: Optional[torch.Tensor],
                          dp: torch.Tensor, *, n_real=None,
                          times: Optional[torch.Tensor] = None):
    """:func:`replay_events` with ``D`` forward tangents (plain version of
    K2T): the exact derivative of the replay's smooth piece on its frozen
    schedule.

    The replay is run as :func:`replay_events` runs it (its primal
    outputs are equal bit for bit) while ``D`` tangents of ``(v, s, t)``
    ride along: per event ``d(dt)`` by
    :func:`.events.event_time_jvp` (the root-find's shared-exponential
    form, at the polished root; 0 for a misfire), the closed-form
    advance's partials in ``v``, ``s``, ``b`` and ``dt``, 0 on the reset
    lane, ``db * w(d)`` from the kick, and ``t``'s tangent summing
    ``d(dt)``.  The tangents of ``last_time`` and ``crossed_time`` are
    taken where the times are recorded; a rejected row's are 0.

    With ``times``, the time log of the evolve that wrote ``sched``, each
    event takes the evolve's own ``dt`` (no root-find, no misfire) and
    ``d(dt)`` by the evolve's rule at that time
    (``event_time_jvp(form="evolve")``; 0 where no lane fired): the
    primal times are then the evolve's bit for bit, and the tangents are
    those of the trajectory that gave them, whatever ``cfg.root_tol``.

    Args:
      dv0, ds0: ``(D, P, N)`` float64 tangents of the lifts.
      base, dp: the rates' tangents.  Row ``p * R + r`` of the draw moves
        by ``dp[d, p] * base[r]`` along direction ``d``: ``base`` is the
        ``(R, N)`` float64 ones along the beta axis, the frozen noise along
        the sigma axis, or None (no rate moves); ``dp`` is ``(D, P)``
        float64.
      times: None, or the ``(R, E)`` / ``(P * R, E)`` float64 time log
        beside ``sched`` (:func:`.evolve.evolve_ensemble`'s
        ``event_times``).
      The rest as :func:`replay_events` takes them.

    Returns:
      ``(result, d_last_time, d_crossed_time)``: the
      :class:`EvolveResult` and two ``(D, P * R, M)`` float64 tensors.
    """
    check_replay_inputs(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real)
    check_tangent_inputs(cfg, v0, beta, dv0, ds0, base, dp, n_real, sched,
                         times)
    return _replay(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real,
                   (dv0, ds0, base, dp), times)


def select_replay(device: torch.device):
    """The replay for tensors on ``device``: K2 on a CUDA device (it
    launches or raises), the plain version elsewhere."""
    if device.type == "cuda":
        from .replay_cuda import replay_events_cuda
        return replay_events_cuda
    return replay_events


def select_replay_tangent(device: torch.device):
    """The tangent replay for tensors on ``device``: K2T on a CUDA device
    (it launches or raises), the plain version elsewhere."""
    if device.type == "cuda":
        from .replay_cuda import replay_events_tangent_cuda
        return replay_events_tangent_cuda
    return replay_events_tangent


def compute_schedule(cfg: ModelConfig, v0: torch.Tensor, s0: torch.Tensor,
                     beta: torch.Tensor, init_ind: torch.Tensor, *,
                     n_real=None):
    """The f32 discovery pass: ``(schedule, n_events)`` of ``P * R`` rows.

    Inputs as :func:`.evolve.evolve_ensemble` takes them (``(P, N)``
    lifts, ``(R, N)`` rates, ``(P, M)`` indices), in any float dtype; the
    pass runs on their f32 rounding under :func:`discovery_config` (with
    ``cfg.evolve_window``), on K1 with its log for CUDA tensors and on the
    plain evolve otherwise.  The
    log is :func:`schedule_width` columns wide, int32, in lane indices;
    ``n_events`` counts the pass's events up to its (later) horizon.
    ``beta`` may be ``(P * R, N)`` with ``n_real=R``.
    """
    cfg32 = discovery_config(cfg)
    v32, s32, b32 = (x.to(torch.float32).contiguous() for x in (v0, s0, beta))
    evolve = (evolve_ensemble_cuda if v0.device.type == "cuda"
              else evolve_ensemble_batched)
    res32, sched = evolve(cfg32, v32, s32, b32, init_ind.contiguous(),
                          record_schedule=schedule_width(cfg), n_real=n_real)
    return sched, res32.n_events


def evolve_ensemble_replay(cfg: ModelConfig, v0: torch.Tensor,
                           s0: torch.Tensor, beta: torch.Tensor,
                           init_ind: torch.Tensor, *,
                           n_real=None) -> EvolveResult:
    """Two-pass evolve, a drop-in for :func:`.evolve.evolve_ensemble`:
    the f32 discovery pass, then the fp64 replay of each row's own
    schedule (K1 with its log and K2 on the card)."""
    sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind,
                                   n_real=n_real)
    replay = select_replay(v0.device)
    return replay(cfg, sched, n_ev, v0.contiguous(), s0.contiguous(),
                  beta.contiguous(), init_ind.contiguous(), n_real=n_real)
