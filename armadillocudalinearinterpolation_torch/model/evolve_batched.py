"""The evolve with the certified window, plain PyTorch version.

The counterpart of the JAX package's ``model/evolve_batched.py``: the same
event loop as :func:`.evolve.evolve_ensemble` (:func:`.evolve.event_loop`),
whose per-event root-find runs on a window of ``W = cfg.evolve_window``
lanes around the row's wave packet instead of on all ``N``:

- the window starts at ``start = (min(last_ind) - pad_b) mod N``, with
  ``pad_b = min(64, W // 4)`` (:func:`window_pad`), and runs ``W`` lanes
  cyclically;
- its event is the lexicographic minimum of (time, lane index) over the
  window: the lowest lane wins ties, as in the full pass, also where the
  window wraps past ``N - 1``;
- between kicks ``v' <= -v + I + max(s, 0)``, so an out-of-window lane
  cannot cross threshold before ``t_lb = log((I + s+ - v) / (I + s+ -
  vth))`` (``+inf`` if ``I + s+ <= vth``; ``0`` where ``beta <= 0``, whose
  synapse need not decay), with the floors ``1e-300`` (f64) or ``1e-30``
  (f32) under both logarithm arguments.  If the window's time is at most
  the smallest bound, the windowed event is the global one; otherwise
  (or if a bound is NaN) the row evaluates every lane for that event
  (:func:`.evolve.select_full`).  The fallback is per row.

The certificate is taken as ``log`` of the smallest ratio ``(I + s+ - v) /
(I + s+ - vth)`` rather than the smallest ``log``: the same number where
``log`` is monotone, one ``log`` per row instead of one per lane, as the
kernel computes it.

The window is exact: the results equal the full pass's in every row.  It
is the plain version of the windowed CUDA kernel (``csrc/evolve.cu`` with
``W > 0``); ``evolve_ensemble_batched`` with ``cfg.evolve_window == 0`` is
the full pass itself.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import ModelConfig
from .events import event_time
from .evolve import EvolveResult, event_loop, evolve_ensemble, select_full


def window_pad(W: int) -> int:
    """Lanes of the window before the row's lowest tracked index."""
    return min(64, W // 4)


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


def select_windowed(cfg: ModelConfig, v: torch.Tensor, s: torch.Tensor,
                    b: torch.Tensor, last_ind: torch.Tensor,
                    live: torch.Tensor,
                    fallbacks: Optional[torch.Tensor] = None):
    """Steps 1-2 of the event on the window, certified, with the per-row
    fallback to every lane: ``(dt (rows, 1), j (rows,) int32)``.  Adds 1 to
    ``fallbacks[row]`` for each live row that fell back."""
    rows, N = v.shape
    W = cfg.evolve_window
    lane = torch.arange(N, dtype=torch.int64, device=v.device)
    start = torch.remainder(last_ind.min(dim=1).values.long()
                            - window_pad(W), N)                 # (rows,)
    widx = torch.remainder(start[:, None] + lane[None, :W], N)   # (rows, W)
    times = event_time(torch.gather(v, 1, widx), torch.gather(s, 1, widx),
                       torch.gather(b, 1, widx), cfg)
    # lexicographic (time, lane) minimum, NaN first (torch.amin keeps NaN)
    dt = torch.amin(times, dim=1, keepdim=True)
    tie = (times == dt) | (times.isnan() & dt.isnan())
    j = torch.where(tie, widx, N).min(dim=1).values.to(torch.int32)

    out_lane = torch.remainder(lane[None, :] - start[:, None], N) >= W
    ratio = torch.where(out_lane, certificate_ratio(cfg, v, s, b),
                        torch.full_like(v, float("inf")))
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
    return event_loop(cfg, v0, s0, beta, init_ind, record_schedule,
                      lambda v, s, b, last_ind, live: select_windowed(
                          cfg, v, s, b, last_ind, live, fallbacks),
                      n_real=n_real, event_times=event_times)
