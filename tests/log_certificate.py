"""The certified window's fallbacks under the JAX package's form of the
certificate, for the tests of the port's windowed evolve (plain and
kernel), which take it as ``log`` of the smallest ratio instead.

``log_form_fallbacks`` runs the port's event loop on every lane and counts,
at each event of each live row, whether the per-lane form (the JAX
package's ``model/evolve_batched.py:117-132``: the minimum over the
out-of-window lanes of ``log((I + s+ - v) / (I + s+ - vth))``, ``0`` where
``beta <= 0``) would send the row to every lane.  The every-lane run takes
the same events as the windowed one, so a windowed run whose per-row
fallback counts equal these took the same decisions.  Imports no JAX.
"""

import torch

from armadillocudalinearinterpolation_torch.model.events import event_time
from armadillocudalinearinterpolation_torch.model.evolve import (event_loop,
                                                                 select_full)
from armadillocudalinearinterpolation_torch.model.evolve_batched import (
    window_pad)


def log_form_fallbacks(cfg, v0, s0, beta, init_ind):
    """``(P * R,)`` int32 count of each row's events that the per-lane log
    certificate fails, on ``v0``'s device."""
    W = cfg.evolve_window
    counts = torch.zeros(v0.shape[0] * beta.shape[0], dtype=torch.int32,
                         device=v0.device)

    def select(v, s, b, last_ind, live):
        N = v.shape[1]
        lane = torch.arange(N, device=v.device)
        start = torch.remainder(last_ind.min(dim=1).values.long()
                                - window_pad(W), N)
        widx = torch.remainder(start[:, None] + lane[None, :W], N)
        dt_w = event_time(torch.gather(v, 1, widx), torch.gather(s, 1, widx),
                          torch.gather(b, 1, widx), cfg).amin(dim=1)
        floor = 1e-300 if v.dtype == torch.float64 else 1e-30
        cap = cfg.drive + torch.clamp(s, min=0.0)
        denom = cap - cfg.vth
        lb = torch.where(denom > 0.0,
                         torch.log(torch.clamp(cap - v, min=floor)
                                   / torch.clamp(denom, min=floor)),
                         torch.full_like(v, float("inf")))
        lb = torch.where(b > 0.0, lb, torch.zeros_like(lb))
        rel = torch.remainder(lane[None, :] - start[:, None], N)
        lb_out = torch.where(rel < W, torch.full_like(lb, float("inf")),
                             lb).amin(dim=1)
        counts.add_((live & ~(dt_w <= lb_out)).to(torch.int32))
        return select_full(cfg, v, s, b)

    event_loop(cfg, v0, s0, beta, init_ind, 0, select)
    return counts
