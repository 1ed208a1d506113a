"""The evolve with the certified window, plain PyTorch version.

The counterpart of the JAX package's ``model/evolve_batched.py``: the same
event loop as :func:`.evolve.evolve_ensemble` (:func:`.evolve.event_loop`),
whose per-event root-find runs on at most ``W = cfg.evolve_window`` lanes
around the row's tracked spikes instead of on all ``N``:

- the window is the one run of ``W`` lanes from ``(min(last_ind) - pad)
  mod N``, with ``pad = min(64, W // 4)`` (:func:`window_pad`), in a row
  whose initial tracked indices that run holds (:func:`one_run_holds`);
  in any other row it is the union of ``M = cfg.n_spikes`` runs, one per
  tracked spike ``m``, each of ``Wm = W // M`` lanes (:func:`window_lanes`)
  from ``(last_ind[m] - window_pad(Wm)) mod N``; a lane in two runs is in
  the window once.  A row keeps its geometry from its first event to its
  last, and each run moves with the tracked indices;
- its event is the lexicographic minimum of (time, lane index) over the
  window: the lowest lane wins ties, as in the full pass, also where a
  window wraps past ``N - 1``;
- between kicks ``v' <= -v + I + max(s, 0)``, so an out-of-window lane
  cannot cross threshold before ``t_lb = log((I + s+ - v) / (I + s+ -
  vth))`` (``+inf`` if ``I + s+ <= vth``; ``0`` where ``beta <= 0``, whose
  synapse need not decay), with the floors ``1e-300`` (f64) or ``1e-30``
  (f32) under both logarithm arguments.  If the window's time is at most
  the smallest bound, the windowed event is the global one; otherwise
  (or if a bound is NaN) the row evaluates every lane for that event
  (:func:`.evolve.select_full`).  The fallback is per row.

Where a tracked spike lies outside the one run, the JAX package's
``select_event_windowed`` keeps that run anyway: a tracked spike that
never fires again (the fast wave family keeps one at index 0 while its two
live fronts run from lanes 231-256 to 444-468) drags it off the fronts,
and 92% of the family's events fell back to every lane.  One run per
tracked spike follows each front.  A row whose spikes start inside the one
run keeps it, as configs 3 and 4 do: there the runs' union would leave the
certificate more lanes than the threads' stride, and choosing the
geometry at every event cost the kernel's f32 rows at config 4 5% on an
H100.  The events are the same either way; only the fallbacks differ.

The certificate is taken as ``log`` of the smallest ratio ``(I + s+ - v) /
(I + s+ - vth)`` rather than the smallest ``log``: the same number where
``log`` is monotone, one ``log`` per row instead of one per lane, as the
kernel computes it.

The window is exact: the results equal the full pass's in every row.  It
is the plain version of the windowed CUDA kernel (``csrc/evolve.cu`` with
``W > 0``), fallback counts included; ``evolve_ensemble_batched`` with
``cfg.evolve_window == 0`` is the full pass itself.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import ModelConfig
from .events import event_time
from .evolve import EvolveResult, event_loop, evolve_ensemble, select_full


def window_pad(W: int) -> int:
    """Lanes of a run of ``W`` lanes before its tracked index."""
    return min(64, W // 4)


def window_lanes(W: int, M: int) -> int:
    """Lanes of each of the ``M`` tracked spikes' runs when they share
    ``W``: ``W // M``, and at least one."""
    return max(1, W // M)


def pad_columns(idx: torch.Tensor, L: int) -> torch.Tensor:
    """``idx`` widened to ``L`` columns by repeats of its first column."""
    extra = L - idx.shape[1]
    return torch.cat([idx, idx[:, :1].expand(-1, extra)], dim=1) if extra \
        else idx


def certificate_ratio(cfg: ModelConfig, v: torch.Tensor, s: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Per lane, the ratio whose ``log`` bounds its next crossing time from
    below: ``(cap - v) / (cap - vth)`` with ``cap = I + max(s, 0)``, the
    floors under both; ``+inf`` where ``cap <= vth``; ``1`` (bound 0) where
    ``b <= 0``.  NaN states give NaN (``torch.maximum`` keeps it)."""
    floor = 1e-300 if v.dtype == torch.float64 else 1e-30
    cap = cfg.drive + torch.clamp(s, min=0.0)
    denom = cap - cfg.vth
    ratio = torch.where(denom > 0.0,
                        torch.clamp(cap - v, min=floor)
                        / torch.clamp(denom, min=floor),
                        torch.full_like(v, float("inf")))
    return torch.where(b > 0.0, ratio, torch.ones_like(v))


def one_run_holds(cfg: ModelConfig, last_ind: torch.Tensor) -> torch.Tensor:
    """Per row, whether the one run of ``W`` lanes from ``(min(last_ind) -
    window_pad(W)) mod N`` holds every tracked index: ``(rows,)`` bool."""
    N, W = cfg.n_neurons, cfg.evolve_window
    li = last_ind.long()
    start = torch.remainder(li.min(dim=1).values - window_pad(W), N)
    return (torch.remainder(li - start[:, None], N) < W).all(dim=1)


def select_windowed(cfg: ModelConfig, v: torch.Tensor, s: torch.Tensor,
                    b: torch.Tensor, last_ind: torch.Tensor,
                    live: torch.Tensor, runs: torch.Tensor,
                    fallbacks: Optional[torch.Tensor] = None):
    """Steps 1-2 of the event on the window, certified, with the per-row
    fallback to every lane: ``(dt (rows, 1), j (rows,) int32)``.  Adds 1 to
    ``fallbacks[row]`` for each live row that fell back.

    ``runs`` (``(rows,)`` bool) marks the rows whose window is one run of
    :func:`window_lanes` lanes per tracked spike, so that a spike that no
    longer fires holds no other spike's front out of the window; the
    others take the one run of ``W`` lanes from their lowest tracked
    index.  The evolve marks the rows whose initial tracked indices that
    one run does not hold (:func:`one_run_holds`; see the module's
    docstring)."""
    rows, N = v.shape
    W, M = cfg.evolve_window, last_ind.shape[1]
    li = last_ind.long()
    start = torch.remainder(li.min(dim=1).values - window_pad(W), N)
    Wm = window_lanes(W, M)
    starts = torch.remainder(li - window_pad(Wm), N)            # (rows, M)
    # both geometries' lanes side by side, L columns each (a lane may
    # repeat, which moves no minimum)
    L = max(W, M * Wm)
    one = torch.remainder(start[:, None] + torch.arange(W, device=v.device),
                          N)
    per = torch.remainder(starts[:, :, None]
                          + torch.arange(Wm, device=v.device),
                          N).reshape(rows, M * Wm)
    widx = torch.where(runs[:, None], pad_columns(per, L),
                       pad_columns(one, L))
    times = event_time(torch.gather(v, 1, widx), torch.gather(s, 1, widx),
                       torch.gather(b, 1, widx), cfg)
    # lexicographic (time, lane) minimum, NaN first (torch.amin keeps NaN)
    dt = torch.amin(times, dim=1, keepdim=True)
    tie = (times == dt) | (times.isnan() & dt.isnan())
    j = torch.where(tie, widx, N).min(dim=1).values.to(torch.int32)

    in_window = torch.zeros(rows, N, dtype=torch.bool,
                            device=v.device).scatter_(1, widx, True)
    ratio = torch.where(in_window, torch.full_like(v, float("inf")),
                        certificate_ratio(cfg, v, s, b))
    bound = torch.log(torch.amin(ratio, dim=1, keepdim=True))
    redo = live & ~(dt <= bound)[:, 0]
    if bool(redo.any()):
        r = torch.nonzero(redo)[:, 0]
        dt_full, j_full = select_full(cfg, v[r], s[r], b[r])
        dt = dt.index_put((r,), dt_full)
        j = j.index_put((r,), j_full)
        if fallbacks is not None:
            fallbacks += redo.to(fallbacks.dtype)
    return dt, j


def evolve_ensemble_batched(cfg: ModelConfig, v0: torch.Tensor,
                            s0: torch.Tensor, beta: torch.Tensor,
                            init_ind: torch.Tensor, record_schedule: int = 0,
                            *, fallbacks: Optional[torch.Tensor] = None,
                            n_real=None,
                            event_times: Optional[torch.Tensor] = None
                            ) -> Union[EvolveResult,
                                       Tuple[EvolveResult, torch.Tensor]]:
    """:func:`.evolve.evolve_ensemble` with the root-find on
    ``cfg.evolve_window`` lanes (every lane when it is 0): the same
    arguments and results.

    ``fallbacks``, if given, is a ``(P * R,)`` int32 tensor that receives
    each row's count of events that fell back to every lane.  ``beta`` may
    be ``(P * R, N)`` with ``n_real=R``, and ``event_times`` receives the
    time log (see :func:`.evolve.evolve_ensemble`).
    """
    if fallbacks is not None:
        fallbacks.zero_()
    if not cfg.evolve_window:
        return evolve_ensemble(cfg, v0, s0, beta, init_ind, record_schedule,
                               n_real=n_real, event_times=event_times)
    runs = []       # each row's geometry, decided at its first event

    def select(v, s, b, last_ind, live):
        if not runs:
            runs.append(~one_run_holds(cfg, last_ind))
        return select_windowed(cfg, v, s, b, last_ind, live, runs[0],
                               fallbacks)

    return event_loop(cfg, v0, s0, beta, init_ind, record_schedule, select,
                      n_real=n_real, event_times=event_times)
