"""The schedule replay as a hand-written CUDA kernel (``csrc/replay.cu``,
K2).

:func:`replay_events_cuda` takes the same arguments and returns the same
:class:`.evolve.EvolveResult` as the plain version
:func:`.replay.replay_events`, for float32 or float64 states on a CUDA
device (the arithmetic is fp64 either way).  It launches on the current
stream, does not synchronise, and raises on any input the kernel does not
take; there is no fallback.  ``LAUNCHES`` counts its launches (read it as
``replay_cuda.LAUNCHES``).  A row that does not fit one CTA's shared memory
(:func:`.evolve_cuda.row_fits_shared`) keeps its state in a scratch of
device memory that the wrapper allocates; the kernel body is the same.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import ModelConfig
from .evolve import EvolveResult
from .evolve_cuda import row_fits_shared, shared_optin_bytes
from .replay import check_replay_inputs, kick_table, schedule_config

LAUNCHES = 0

_ENTRY = {torch.float32: "atorch_replay_f32",
          torch.float64: "atorch_replay_f64"}


def replay_events_cuda(cfg: ModelConfig, sched: torch.Tensor,
                       n_sched: torch.Tensor, v0: torch.Tensor,
                       s0: torch.Tensor, beta: torch.Tensor,
                       init_ind: torch.Tensor) -> EvolveResult:
    """Replay a recorded firing order on the card, one CTA per row.

    Args:
      sched: ``(R, E)`` or ``(P * R, E)`` int32 firing-order log.
      n_sched: its int32 event counts, one per schedule row.
      v0, s0: ``(P, N)`` lifted states; beta: ``(R, N)`` rates; float32
        or float64, one dtype.
      init_ind: ``(M,)`` or ``(P, M)`` int32 initial spike indices.

    Returns:
      :class:`EvolveResult` over ``P * R`` rows, times in ``v0.dtype``.
    """
    global LAUNCHES
    check_replay_inputs(cfg, sched, n_sched, v0, s0, beta, init_ind)
    for name, x in (("sched", sched), ("n_sched", n_sched), ("v0", v0),
                    ("s0", s0), ("beta", beta), ("init_ind", init_ind)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v0.device.type != "cuda":
        raise ValueError("replay_events_cuda needs CUDA tensors; got "
                         f"{v0.device} (use the plain replay on the CPU)")
    P, N = v0.shape
    R, M = beta.shape[0], cfg.n_spikes
    S, E = sched.shape
    Q = init_ind.numel() // M
    rows, dev, dt_ = P * R, v0.device, v0.dtype
    last_ind = torch.empty(rows, M, dtype=torch.int32, device=dev)
    last_time = torch.empty(rows, M, dtype=dt_, device=dev)
    crossed_ind = torch.empty(rows, M, dtype=torch.int32, device=dev)
    crossed_time = torch.empty(rows, M, dtype=dt_, device=dev)
    accept = torch.empty(rows, dtype=torch.bool, device=dev)
    wtab = kick_table(cfg, dev)
    cfg32 = schedule_config(cfg)
    scratch = (None if row_fits_shared(N, M, torch.float64, "replay",
                                       shared_optin_bytes(dev)) else
               torch.empty(rows * 3 * N, dtype=torch.float64, device=dev))

    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _ENTRY[dt_])(
            v0.data_ptr(), s0.data_ptr(), beta.data_ptr(), sched.data_ptr(),
            n_sched.data_ptr(), init_ind.data_ptr(), wtab.data_ptr(),
            last_ind.data_ptr(), last_time.data_ptr(),
            crossed_ind.data_ptr(), crossed_time.data_ptr(),
            accept.data_ptr(),
            None if scratch is None else scratch.data_ptr(), P, R, N, M, E,
            S, Q, cfg32.counter_max,
            cfg.vth, cfg.drive, cfg.vth - cfg.drive, cfg.t_horizon,
            cfg32.root_tol, stream)
    _build.check(lib, code, "replay kernel launch")
    LAUNCHES += 1
    return EvolveResult(last_ind=last_ind, last_time=last_time,
                        crossed_ind=crossed_ind, crossed_time=crossed_time,
                        accept=accept, n_events=n_sched.repeat(rows // S))
