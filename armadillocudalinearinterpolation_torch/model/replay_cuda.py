"""The schedule replay as a hand-written CUDA kernel (``csrc/replay.cu``,
K2).

:func:`replay_events_cuda` takes the same arguments and returns the same
:class:`.evolve.EvolveResult` as the plain version
:func:`.replay.replay_events`, for float32 or float64 states on a CUDA
device (the arithmetic is fp64 either way).  It launches on the current
stream, does not synchronise, and raises on any input the kernel does not
take, and on a launch the card refuses; there is no fallback.
``LAUNCHES`` counts its launches (read it as ``replay_cuda.LAUNCHES``).

The launch is one CTA a row, of :func:`replay_layout`'s threads, always.
A row that does not fit one CTA's shared memory
(:func:`.evolve_cuda.row_fits_shared`) keeps its state in a scratch of
device memory that the wrapper allocates; the kernel body is the same.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import ModelConfig
from .evolve import EvolveResult
from .evolve_cuda import (SHARED_OPTIN_BYTES, row_elems, row_fits_shared,
                          row_shared_bytes, shared_optin_bytes)
from .replay import check_replay_inputs, kick_table, schedule_config

LAUNCHES = 0

_ENTRY = {torch.float32: "atorch_replay_f32",
          torch.float64: "atorch_replay_f64"}

# Threads of one K2 CTA at most, and of all its CTAs on one SM: its
# __launch_bounds__(512, 2) holds it to 64 registers a thread, so the
# register file holds 1024 of its threads.
MAX_THREADS = 512
THREADS_PER_SM = 1024
# One H100 SM's shared memory (228 KB): the default of replay_layout's
# ``shared_per_sm`` where no card is asked (the wrapper passes its card's).
SHARED_PER_SM = 233_472
# what each resident CTA reserves of an SM's shared memory beside its own
SHARED_RESERVED_PER_CTA = 1024


def replay_layout(N: int, M: int, rows: int, sms: int,
                  optin: int = SHARED_OPTIN_BYTES,
                  shared_per_sm: int = SHARED_PER_SM) -> int:
    """Threads a CTA of K2 for ``rows`` rows of ``N`` lanes and ``M``
    trajectories, one CTA a row, on a card of ``sms`` SMs whose blocks may
    opt in to ``optin`` bytes of shared memory, of ``shared_per_sm`` an SM.

    The CTAs that one SM has to hold for every row to be resident in one
    wave (as far as its shared memory lets it) share ``THREADS_PER_SM``
    threads; no CTA has more than ``MAX_THREADS``, nor more sweep threads
    than lanes (rounded up to a warp), and each has the event warp and at
    least one sweep warp."""
    per_cta = row_shared_bytes(N, M, torch.float64, "replay")
    if not row_fits_shared(N, M, torch.float64, "replay", optin):
        per_cta -= row_elems(N) * 8          # the row in device memory
    by_shared = shared_per_sm // (per_cta + SHARED_RESERVED_PER_CTA)
    resident = max(1, min(-(-rows // sms), by_shared))
    threads = min(THREADS_PER_SM // resident // 32 * 32, MAX_THREADS,
                  32 + -(-N // 32) * 32)
    return max(64, threads)


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
    optin = shared_optin_bytes(dev)
    props = torch.cuda.get_device_properties(dev)
    threads = replay_layout(N, M, rows, props.multi_processor_count, optin,
                            props.shared_memory_per_multiprocessor)
    scratch = (None if row_fits_shared(N, M, torch.float64, "replay", optin)
               else torch.empty(rows * 3 * N, dtype=torch.float64,
                                device=dev))

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
            S, Q, threads, cfg32.counter_max,
            cfg.vth, cfg.drive, cfg.vth - cfg.drive, cfg.t_horizon,
            cfg32.root_tol, stream)
    _build.check(lib, code, "replay kernel launch")
    LAUNCHES += 1
    return EvolveResult(last_ind=last_ind, last_time=last_time,
                        crossed_ind=crossed_ind, crossed_time=crossed_time,
                        accept=accept, n_events=n_sched.repeat(rows // S))
