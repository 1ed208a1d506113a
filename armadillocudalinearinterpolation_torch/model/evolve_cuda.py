"""The ensemble evolve as a hand-written CUDA kernel (``csrc/evolve.cu``).

:func:`evolve_ensemble_cuda` takes the same arguments and returns the same
:class:`.evolve.EvolveResult` as the plain version
:func:`.evolve.evolve_ensemble`, for float32 and float64 tensors on a CUDA
device.  It launches on the current stream, does not synchronise, and
raises on any input the kernel does not take; there is no fallback.
``LAUNCHES`` counts its launches (read it as ``evolve_cuda.LAUNCHES``).
``record_schedule = E > 0`` adds the kernel's firing-order log, as the
plain version returns it.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .. import _build
from ..config import ModelConfig
from .evolve import EvolveResult, check_evolve_inputs

LAUNCHES = 0

_ENTRY = {torch.float32: "atorch_evolve_f32",
          torch.float64: "atorch_evolve_f64"}


def evolve_ensemble_cuda(cfg: ModelConfig, v0: torch.Tensor,
                         s0: torch.Tensor, beta: torch.Tensor,
                         init_ind: torch.Tensor, record_schedule: int = 0
                         ) -> Union[EvolveResult,
                                    Tuple[EvolveResult, torch.Tensor]]:
    """Ensemble evolve of ``P`` points x ``R`` realisations on the card.

    Args:
      v0, s0: ``(P, N)`` lifted states.
      beta: ``(R, N)`` per-realisation rates.
      init_ind: ``(P, M)`` int32 initial spike indices.
      record_schedule: ``E > 0`` also returns the ``(P * R, E)`` int32
        firing-order log.

    Returns:
      :class:`EvolveResult` over ``P * R`` rows, row ``p * R + r`` for
      point ``p`` and realisation ``r``; with ``record_schedule`` the pair
      ``(result, schedule)``.
    """
    global LAUNCHES
    check_evolve_inputs(cfg, v0, s0, beta, init_ind)
    E = int(record_schedule)
    if E < 0:
        raise ValueError(f"record_schedule must be >= 0; got {E}")
    if v0.device.type != "cuda":
        raise ValueError("evolve_ensemble_cuda needs CUDA tensors; got "
                         f"{v0.device} (use the plain evolve on the CPU)")
    for name, x in (("v0", v0), ("s0", s0), ("beta", beta),
                    ("init_ind", init_ind)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, N = v0.shape
    R, M = beta.shape[0], cfg.n_spikes
    dev, dt_ = v0.device, v0.dtype
    last_ind = torch.empty(P * R, M, dtype=torch.int32, device=dev)
    last_time = torch.empty(P * R, M, dtype=dt_, device=dev)
    crossed_ind = torch.empty(P * R, M, dtype=torch.int32, device=dev)
    crossed_time = torch.empty(P * R, M, dtype=dt_, device=dev)
    accept = torch.empty(P * R, dtype=torch.bool, device=dev)
    n_events = torch.empty(P * R, dtype=torch.int32, device=dev)
    sched = (torch.zeros(P * R, E, dtype=torch.int32, device=dev) if E
             else None)

    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _ENTRY[dt_])(
            v0.data_ptr(), s0.data_ptr(), init_ind.data_ptr(),
            beta.data_ptr(), last_ind.data_ptr(), last_time.data_ptr(),
            crossed_ind.data_ptr(), crossed_time.data_ptr(),
            accept.data_ptr(), n_events.data_ptr(),
            sched.data_ptr() if E else None, P, R, N, M, E, cfg.counter_max,
            cfg.vth, cfg.drive, cfg.vth - cfg.drive, cfg.a1, cfg.a2, cfg.b1,
            cfg.b2, cfg.dx, cfg.t_horizon, cfg.root_tol, stream)
    _build.check(lib, code, "evolve kernel launch")
    LAUNCHES += 1
    result = EvolveResult(last_ind=last_ind, last_time=last_time,
                          crossed_ind=crossed_ind, crossed_time=crossed_time,
                          accept=accept, n_events=n_events)
    return (result, sched) if E else result
