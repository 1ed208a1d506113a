"""Evolve: the event-driven network loop, plain PyTorch version.

One loop over ``(rows, N)`` tensors with a per-row live mask.  A row is one
(point, realisation) pair: row ``p * R + r`` evolves point ``p``'s lift
``(v0[p], s0[p])`` under realisation ``r``'s rates ``beta[r]``.  Per event:

  1. every neuron proposes its next firing time (:func:`.events.event_time`);
  2. an argmin picks the row's event, lowest neuron index on ties;
  3. all states advance analytically by ``dt``; the firing neuron resets to
     0 and every neuron takes the ring kick ``beta * w(|i - j|)``, with the
     kernel recomputed analytically;
  4. the event is classified to the nearest tracked trajectory (lowest id
     on ties) and recorded as last-before-``T`` or first-after-``T``;
  5. a row stops when all its trajectories have crossed ``T`` or ``t``
     reaches ``2T``; it is accepted only if all trajectories crossed.

With ``record_schedule = E > 0`` the loop also logs the firing order, the
input of the schedule replay (:mod:`.replay`): event ``k < E`` of a row
writes its lane at column ``k``; a row with more events keeps counting
``n_events`` and logs nothing more (the replay rejects it through
``n_events > E``); columns past a row's events stay 0.  Given
``event_times``, a ``(rows, E)`` float64 tensor, the loop also writes there
each logged event's ``dt`` as it took it (the time log: the exact tangent
replay takes these times in place of its own root-find, so that ``J`` is
taken on the trajectory that gave ``F``).

This is the plain version of the CUDA kernel in ``csrc/evolve.cu``
(:mod:`.evolve_cuda`) with every lane evaluated: the CPU path, and the
kernel's oracle on the card.  :func:`event_loop` takes the event selection
(steps 1-2) as an argument, so that the windowed version
(:mod:`.evolve_batched`) runs the same loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..config import ModelConfig
from .events import event_time


class EvolveResult(NamedTuple):
    """Per-row spike bookkeeping after evolution to (past) ``T``."""

    last_ind: torch.Tensor      # (rows, M) int32, last firing site before T
    last_time: torch.Tensor     # (rows, M) last firing time before T
    crossed_ind: torch.Tensor   # (rows, M) int32, first firing site after T
    crossed_time: torch.Tensor  # (rows, M) first firing time after T
    accept: torch.Tensor        # (rows,) bool, all trajectories crossed T
    n_events: torch.Tensor      # (rows,) int32 event count


def beta_rows(beta: torch.Tensor, P: int, n_real=None):
    """``(R, per_row)`` of a draw ``beta`` for ``P`` points: ``R =
    n_real`` (``beta.shape[0]`` if it is None), and whether ``beta`` is
    ``(P * R, N)``, one row of rates per evolve row (points with their own
    parameters), rather than ``(R, N)`` shared by the points."""
    R = beta.shape[0] if n_real is None else int(n_real)
    if R < 1 or beta.shape[0] not in (R, P * R):
        raise ValueError(f"beta must have {R} or {P * R} rows (n_real="
                         f"{R}, P={P}); got {beta.shape[0]}")
    return R, beta.shape[0] != R


def check_evolve_inputs(cfg: ModelConfig, v0, s0, beta, init_ind,
                        n_real=None) -> None:
    """Shapes, dtypes and devices shared by both evolve versions."""
    N, M = cfg.n_neurons, cfg.n_spikes
    if v0.ndim != 2 or v0.shape[1] != N or s0.shape != v0.shape:
        raise ValueError(f"v0 and s0 must both be (P, {N}); got "
                         f"{tuple(v0.shape)} and {tuple(s0.shape)}")
    if beta.ndim != 2 or beta.shape[1] != N:
        raise ValueError(f"beta must be (R, {N}) or (P * R, {N}); got "
                         f"{tuple(beta.shape)}")
    beta_rows(beta, v0.shape[0], n_real)
    if tuple(init_ind.shape) != (v0.shape[0], M):
        raise ValueError(f"init_ind must be ({v0.shape[0]}, {M}); got "
                         f"{tuple(init_ind.shape)}")
    if init_ind.dtype != torch.int32:
        raise TypeError(f"init_ind must be int32; got {init_ind.dtype}")
    if not (v0.dtype == s0.dtype == beta.dtype
            and v0.dtype in (torch.float32, torch.float64)):
        raise TypeError("v0, s0 and beta must share one dtype, float32 or "
                        f"float64; got {v0.dtype}, {s0.dtype}, {beta.dtype}")
    if len({t.device for t in (v0, s0, beta, init_ind)}) != 1:
        raise ValueError("v0, s0, beta and init_ind must be on one device")


def check_event_times(event_times: Optional[torch.Tensor], rows: int,
                      E: int, device: torch.device) -> None:
    """The time log's buffer, where one is given, is a contiguous ``(rows,
    E)`` float64 tensor on ``device``, with ``E > 0``; it is zero-filled."""
    if event_times is None:
        return
    if (E < 1 or tuple(event_times.shape) != (rows, E)
            or event_times.dtype != torch.float64
            or event_times.device != device
            or not event_times.is_contiguous()):
        raise ValueError(f"event_times must be a contiguous ({rows}, {E}) "
                         f"float64 tensor on {device}, with record_schedule "
                         f"> 0; got {tuple(event_times.shape)} "
                         f"{event_times.dtype} on {event_times.device}")
    event_times.zero_()


def select_full(cfg: ModelConfig, v: torch.Tensor, s: torch.Tensor,
                b: torch.Tensor):
    """Steps 1-2 over every lane: ``(dt (rows, 1), j (rows,) int32)``."""
    times = event_time(v, s, b, cfg)                     # (rows, N)
    j = torch.argmin(times, dim=1).to(torch.int32)       # lowest on ties
    return torch.gather(times, 1, j[:, None].long()), j


def evolve_ensemble(cfg: ModelConfig, v0: torch.Tensor, s0: torch.Tensor,
                    beta: torch.Tensor, init_ind: torch.Tensor,
                    record_schedule: int = 0, *, n_real=None,
                    event_times: Optional[torch.Tensor] = None
                    ) -> Union[EvolveResult,
                               Tuple[EvolveResult, torch.Tensor]]:
    """Ensemble evolve of ``P`` points x ``R`` realisations.

    Args:
      v0, s0: ``(P, N)`` lifted states, one per point.
      beta: ``(R, N)`` per-realisation synaptic rates (shared by all
        points), or ``(P * R, N)``, one row per evolve row, with
        ``n_real=R``.
      init_ind: ``(P, M)`` int32 initial spike indices, one row per point.
      record_schedule: ``E > 0`` also returns the ``(P * R, E)`` int32
        firing-order log.
      event_times: None, or a ``(P * R, E)`` float64 tensor (with
        ``record_schedule = E``) that receives each logged event's ``dt``.

    Returns:
      :class:`EvolveResult` over ``P * R`` rows; row ``p * R + r`` is point
      ``p`` under realisation ``r``.  With ``record_schedule`` the pair
      ``(result, schedule)``.
    """
    return event_loop(cfg, v0, s0, beta, init_ind, record_schedule,
                      lambda v, s, b, last_ind, live: select_full(cfg, v, s,
                                                                  b),
                      n_real=n_real, event_times=event_times)


def event_loop(cfg: ModelConfig, v0: torch.Tensor, s0: torch.Tensor,
               beta: torch.Tensor, init_ind: torch.Tensor,
               record_schedule: int, select: Callable, n_real=None,
               event_times: Optional[torch.Tensor] = None):
    """The loop of :func:`evolve_ensemble`, whose event selection is
    ``select(v, s, b, last_ind, live) -> (dt (rows, 1), j (rows,) int32)``
    on the ``(rows, N)`` states, the ``(rows, M)`` tracked indices and the
    ``(rows,)`` live mask."""
    check_evolve_inputs(cfg, v0, s0, beta, init_ind, n_real)
    E = int(record_schedule)
    dt_, dev = v0.dtype, v0.device
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), cfg.n_spikes
    rows = P * R
    check_event_times(event_times, rows, E, dev)
    T = cfg.t_horizon
    b = beta if per_row else beta.repeat(P, 1)               # (rows, N)
    v = v0.repeat_interleave(R, dim=0)
    s = s0.repeat_interleave(R, dim=0)
    t = torch.zeros(rows, dtype=dt_, device=dev)
    last_ind = init_ind.repeat_interleave(R, dim=0)
    crossed_ind = last_ind.clone()
    last_time = torch.zeros(rows, M, dtype=dt_, device=dev)
    crossed_time = torch.full((rows, M), 2.0 * T, dtype=dt_, device=dev)
    crossed = torch.zeros(rows, M, dtype=torch.bool, device=dev)
    n_events = torch.zeros(rows, dtype=torch.int32, device=dev)
    sched = torch.zeros(rows, max(E, 0), dtype=torch.int32, device=dev)
    lane = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    traj = torch.arange(M, device=dev)[None, :]

    while True:
        live = ~crossed.all(dim=1) & (t < 2.0 * T)           # (rows,)
        if not bool(live.any()):
            break
        dt, j = select(v, s, b, last_ind, live)

        emt = torch.exp(-dt)
        v_new = (v * emt + cfg.drive * (1.0 - emt)
                 + s * emt / (1.0 - b) * (torch.exp((1.0 - b) * dt) - 1.0))
        v_new = torch.where(lane == j[:, None], 0.0, v_new)
        d = torch.abs(lane - j[:, None])
        dist = torch.minimum(d, N - d).to(dt_) * cfg.dx
        wrow = (cfg.a1 * torch.exp(-cfg.b1 * dist)
                - cfg.a2 * torch.exp(-cfg.b2 * dist)) * cfg.dx
        s_new = s * torch.exp(-b * dt) + b * wrow
        t_new = t + dt[:, 0]

        livec = live[:, None]
        v = torch.where(livec, v_new, v)
        s = torch.where(livec, s_new, s)
        t = torch.where(live, t_new, t)

        m = torch.argmin(torch.abs(j[:, None] - last_ind), dim=1)  # (rows,)
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
        if E > 0:
            log = live & (n_events < E)
            col = torch.clamp(n_events, max=E - 1).long()[:, None]
            sched.scatter_(1, col, torch.where(
                log, j, torch.gather(sched, 1, col)[:, 0])[:, None])
            if event_times is not None:
                event_times.scatter_(1, col, torch.where(
                    log[:, None], dt.to(event_times.dtype),
                    torch.gather(event_times, 1, col)))
        n_events = n_events + live.to(torch.int32)

    result = EvolveResult(last_ind=last_ind, last_time=last_time,
                          crossed_ind=crossed_ind, crossed_time=crossed_time,
                          accept=crossed.all(dim=1), n_events=n_events)
    return (result, sched) if E > 0 else result
