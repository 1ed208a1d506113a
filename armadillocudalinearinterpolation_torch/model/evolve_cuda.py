"""The ensemble evolve as a hand-written CUDA kernel (``csrc/evolve.cu``).

:func:`evolve_ensemble_cuda` takes the same arguments and returns the same
:class:`.evolve.EvolveResult` as the plain versions
:func:`.evolve.evolve_ensemble` and, with ``cfg.evolve_window > 0``,
:func:`.evolve_batched.evolve_ensemble_batched` (the certified window), for
float32 and float64 tensors on a CUDA device.  It launches on the current
stream, does not synchronise, and raises on any input the kernel does not
take; there is no fallback.  ``LAUNCHES`` counts its launches (read it as
``evolve_cuda.LAUNCHES``).  ``record_schedule = E > 0`` adds the kernel's
firing-order log, as the plain version returns it.

A row whose state does not fit one CTA's shared memory
(:func:`row_fits_shared`) runs in a scratch of device memory that the
wrapper allocates; the kernel body is the same.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import _build
from ..config import ModelConfig
from .evolve import EvolveResult, check_evolve_inputs
from .evolve_batched import window_pad

LAUNCHES = 0

_ENTRY = {torch.float32: "atorch_evolve_f32",
          torch.float64: "atorch_evolve_f64"}

# Dynamic shared memory one block may opt in to on an H100 (and H200): the
# default limit of row_fits_shared; the wrappers pass their card's own.
SHARED_OPTIN_BYTES = 232_448


def row_elems(N: int) -> int:
    """Values of one row's state: ``v``, ``s``, ``beta`` (``N`` each) and
    the kick table (``N // 2 + 1``)."""
    return 3 * N + N // 2 + 1


def row_shared_bytes(N: int, M: int, dtype: torch.dtype, kind: str) -> int:
    """Dynamic shared memory of one CTA that keeps its row in shared
    memory, counting every array of ``smem_bytes`` in ``csrc/evolve.cu``
    (``kind="evolve"``, values of ``dtype``) or ``csrc/replay.cu``
    (``kind="replay"``, always float64): the row and kick table, the
    per-trajectory times, indices and flags, and the scalars (the evolve's
    also three 32-slot tables for its block reduction; the replay's the
    two-slot mailbox of its events)."""
    if kind == "evolve":
        item = torch.empty((), dtype=dtype).element_size()
        return (row_elems(N) + 2 * M + 32 + 32 + 4) * item \
            + (3 * M + 32 + 4) * 4
    if kind == "replay":
        return (row_elems(N) + 2 * M + 2) * 8 + (3 * M + 2) * 4
    raise ValueError(f"kind must be 'evolve' or 'replay'; got {kind!r}")


def default_threads(N: int, rows: int, sms: int, dtype: torch.dtype) -> int:
    """Threads of the CTA of one row of ``N`` lanes in a launch of ``rows``
    rows of ``dtype`` on ``sms`` SMs: about 1024 threads an SM in all for
    float32 and 512 for float64 (whose registers leave room for fewer), as
    a power of two from 64 to 512, and no more than the lanes need.

    A row's events run one after another, each ending in a block-wide
    argmin: where the rows fill the card (config 3: 1024 rows) fewer
    threads a row shorten that chain, and where they do not (config 4's
    64-row discovery pass) more threads share the row's lanes; every row
    stays resident in one wave (``tools/evolve_threads_study.py``)."""
    budget = 512 if dtype == torch.float64 else 1024
    per_row = max(1, sms * budget // max(rows, 1))
    threads = min(512, max(64, 1 << (per_row.bit_length() - 1)))
    return min(threads, -(-N // 32) * 32)


def row_fits_shared(N: int, M: int, dtype: torch.dtype, kind: str,
                    limit: int = SHARED_OPTIN_BYTES) -> bool:
    """Whether a row of ``N`` lanes and ``M`` trajectories runs with its
    state in shared memory (else in device memory) on a card whose blocks
    may opt in to ``limit`` bytes of it."""
    return row_shared_bytes(N, M, dtype, kind) <= limit


def shared_optin_bytes(dev: torch.device) -> int:
    """The dynamic shared memory one block may opt in to on ``dev``."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def evolve_ensemble_cuda(cfg: ModelConfig, v0: torch.Tensor,
                         s0: torch.Tensor, beta: torch.Tensor,
                         init_ind: torch.Tensor, record_schedule: int = 0,
                         *, fallbacks: Optional[torch.Tensor] = None
                         ) -> Union[EvolveResult,
                                    Tuple[EvolveResult, torch.Tensor]]:
    """Ensemble evolve of ``P`` points x ``R`` realisations on the card.

    Args:
      v0, s0: ``(P, N)`` lifted states.
      beta: ``(R, N)`` per-realisation rates.
      init_ind: ``(P, M)`` int32 initial spike indices.
      record_schedule: ``E > 0`` also returns the ``(P * R, E)`` int32
        firing-order log.
      fallbacks: ``None``, or a ``(P * R,)`` int32 CUDA tensor that
        receives each row's count of windowed events that fell back to
        every lane.

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
    if fallbacks is not None and (fallbacks.shape != (P * R,)
                                  or fallbacks.dtype != torch.int32
                                  or fallbacks.device != dev
                                  or not fallbacks.is_contiguous()):
        raise ValueError(f"fallbacks must be a contiguous ({P * R},) int32 "
                         f"tensor on {dev}")
    W = cfg.evolve_window
    last_ind = torch.empty(P * R, M, dtype=torch.int32, device=dev)
    last_time = torch.empty(P * R, M, dtype=dt_, device=dev)
    crossed_ind = torch.empty(P * R, M, dtype=torch.int32, device=dev)
    crossed_time = torch.empty(P * R, M, dtype=dt_, device=dev)
    accept = torch.empty(P * R, dtype=torch.bool, device=dev)
    n_events = torch.empty(P * R, dtype=torch.int32, device=dev)
    sched = (torch.zeros(P * R, E, dtype=torch.int32, device=dev) if E
             else None)
    scratch = (None if row_fits_shared(N, M, dt_, "evolve",
                                       shared_optin_bytes(dev)) else
               torch.empty(P * R * row_elems(N), dtype=dt_, device=dev))

    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _ENTRY[dt_])(
            v0.data_ptr(), s0.data_ptr(), init_ind.data_ptr(),
            beta.data_ptr(), last_ind.data_ptr(), last_time.data_ptr(),
            crossed_ind.data_ptr(), crossed_time.data_ptr(),
            accept.data_ptr(), n_events.data_ptr(),
            sched.data_ptr() if E else None,
            None if scratch is None else scratch.data_ptr(),
            None if fallbacks is None else fallbacks.data_ptr(),
            P, R, N, M, E, W, window_pad(W) if W else 0,
            default_threads(N, P * R, torch.cuda.get_device_properties(
                dev).multi_processor_count, dt_),
            cfg.counter_max, cfg.vth, cfg.drive, cfg.vth - cfg.drive, cfg.a1,
            cfg.a2, cfg.b1, cfg.b2, cfg.dx, cfg.t_horizon, cfg.root_tol,
            stream)
    _build.check(lib, code, "evolve kernel launch")
    LAUNCHES += 1
    result = EvolveResult(last_ind=last_ind, last_time=last_time,
                          crossed_ind=crossed_ind, crossed_time=crossed_time,
                          accept=accept, n_events=n_events)
    return (result, sched) if E else result
