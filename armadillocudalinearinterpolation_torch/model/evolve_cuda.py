"""The ensemble evolve as a hand-written CUDA kernel (``csrc/evolve.cu``,
K1), registered as the op ``atorch::evolve`` (:func:`evolve_op`).

The op is functional (it returns new tensors) and picks its kernel by
device: K1 for CUDA tensors, the plain version
(:func:`.evolve_batched.evolve_ensemble_batched`) for CPU ones; a CUDA
tensor never reaches the plain version.  Its fake kernel gives the output
shapes, so the op traces under fake tensors.  The launch itself is a
``ctypes`` call into the library that :mod:`.._build` compiles with nvcc.

:func:`evolve_ensemble_cuda` takes the same arguments and returns the same
:class:`.evolve.EvolveResult` as the plain versions
:func:`.evolve.evolve_ensemble` and, with ``cfg.evolve_window > 0``,
:func:`.evolve_batched.evolve_ensemble_batched` (the certified window), for
float32 and float64 tensors on a CUDA device.  It launches on the current
stream, does not synchronise, and raises on any input the kernel does not
take; there is no fallback.  ``LAUNCHES`` counts its launches (read it as
``evolve_cuda.LAUNCHES``); while a profiler records, each launch also
adds its rows, events and fallback events to
:data:`..utils.profiling.K1_COUNTERS`.  ``record_schedule = E > 0`` adds
the kernel's firing-order log, as the plain version returns it, and
``event_times`` its time log.

A row whose state does not fit one CTA's shared memory
(:func:`row_fits_shared`) runs in a scratch of device memory that the
wrapper allocates; the kernel body is the same.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Optional, Tuple, Union

import torch

from .. import _build
from ..config import ModelConfig
from ..utils import profiling
from .evolve import (EvolveResult, beta_rows, check_event_times,
                     check_evolve_inputs)
from .evolve_batched import evolve_ensemble_batched, window_pad

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
    per-trajectory times, indices and flags (the evolve's tracked indices
    and flags in two copies, by the event's parity), and the evolve's two
    slots of three per-warp tables for its block reduction and each warp's
    ranked window starts, for 32 warps (16 for float64, whose CTA takes at
    most 512 threads), or the replay's scalars and the two-slot mailbox of
    its events.  The tangent kernel's CTAs are counted by
    :func:`.replay_cuda.tangent_shared_bytes`."""
    if kind == "evolve":
        item = torch.empty((), dtype=dtype).element_size()
        warps = 16 if item == 8 else 32
        return (row_elems(N) + 2 * M + 4 * warps) * item \
            + (5 * M + 2 * warps + warps * M) * 4
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
                         *, fallbacks: Optional[torch.Tensor] = None,
                         n_real=None,
                         event_times: Optional[torch.Tensor] = None
                         ) -> Union[EvolveResult,
                                    Tuple[EvolveResult, torch.Tensor]]:
    """Ensemble evolve of ``P`` points x ``R`` realisations on the card
    (the op ``atorch::evolve`` on CUDA tensors; CPU tensors are refused).

    Args:
      v0, s0: ``(P, N)`` lifted states.
      beta: ``(R, N)`` per-realisation rates, or ``(P * R, N)`` (one row
        per evolve row) with ``n_real=R``.
      init_ind: ``(P, M)`` int32 initial spike indices.
      record_schedule: ``E > 0`` also returns the ``(P * R, E)`` int32
        firing-order log.
      fallbacks: ``None``, or a ``(P * R,)`` int32 CUDA tensor that
        receives each row's count of windowed events that fell back to
        every lane.
      event_times: None, or a ``(P * R, E)`` float64 CUDA tensor (with
        ``record_schedule = E``) that receives each logged event's ``dt``
        (the time log; see :func:`.evolve.evolve_ensemble`).

    Returns:
      :class:`EvolveResult` over ``P * R`` rows, row ``p * R + r`` for
      point ``p`` and realisation ``r``; with ``record_schedule`` the pair
      ``(result, schedule)``.
    """
    if v0.device.type != "cuda":
        raise ValueError("evolve_ensemble_cuda needs CUDA tensors; got "
                         f"{v0.device} (use the plain evolve on the CPU)")
    P = v0.shape[0]
    R = n_real_of(beta, n_real)
    if fallbacks is not None and (fallbacks.shape != (P * R,)
                                  or fallbacks.dtype != torch.int32
                                  or fallbacks.device != v0.device
                                  or not fallbacks.is_contiguous()):
        raise ValueError(f"fallbacks must be a contiguous ({P * R},) int32 "
                         f"tensor on {v0.device}")
    E = int(record_schedule)
    check_event_times(event_times, P * R, E, v0.device)
    out = evolve_op(config_key(cfg), v0, s0, beta, init_ind, R, E,
                    event_times is not None, fallbacks is not None)
    if fallbacks is not None:
        fallbacks.copy_(out[8])
    if event_times is not None:
        event_times.copy_(out[7])
    result = EvolveResult(*out[:6])
    return (result, out[6]) if E else result


def n_real_of(beta: torch.Tensor, n_real) -> int:
    """The realisations R an op takes: ``n_real``, or ``beta``'s rows (the
    op's kernels check that they fit the inputs)."""
    return beta.shape[0] if n_real is None else int(n_real)


@functools.lru_cache(maxsize=None)
def config_key(cfg: ModelConfig) -> str:
    """``cfg`` as the string the ops take (an op's arguments are tensors
    and scalars); :func:`config_of` inverts it."""
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


@functools.lru_cache(maxsize=None)
def config_of(key: str) -> ModelConfig:
    """The :class:`ModelConfig` of :func:`config_key`'s string."""
    return ModelConfig(**json.loads(key))


def _evolve_outputs(v0, init_ind, n_real, record_schedule, event_times,
                    fallbacks):
    """The op's nine outputs, uninitialised on ``v0``'s device: the
    result's six, the log (``(rows, E)``, E = 0 without one), the time
    log (``(rows, E)``, or ``(rows, 0)``) and the fallback counts
    (``(rows,)``, or ``(0,)``)."""
    rows, M = v0.shape[0] * n_real, init_ind.shape[-1]
    E, i32 = record_schedule, torch.int32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=v0.device)
    return (empty((rows, M), i32), empty((rows, M), v0.dtype),
            empty((rows, M), i32), empty((rows, M), v0.dtype),
            empty((rows,), torch.bool), empty((rows,), i32),
            empty((rows, E), i32),
            empty((rows, E if event_times else 0), torch.float64),
            empty((rows if fallbacks else 0,), i32))


@torch.library.custom_op("atorch::evolve", mutates_args=(),
                         device_types="cuda")
def evolve_op(cfg: str, v0: torch.Tensor, s0: torch.Tensor,
              beta: torch.Tensor, init_ind: torch.Tensor, n_real: int,
              record_schedule: int, event_times: bool, fallbacks: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as an op: ``cfg`` a :func:`config_key` string, ``n_real`` the
    realisations R, ``record_schedule`` E >= 0 the log's width, and
    whether to return the time log and the fallback counts.  Returns the
    :class:`EvolveResult`'s six tensors, the log, the time log and the
    fallback counts (:func:`_evolve_outputs` gives the shapes).  Its CUDA
    kernel launches K1 on the current stream (no synchronise) and raises
    on any input the kernel does not take; its CPU kernel is the plain
    version, :func:`.evolve_batched.evolve_ensemble_batched`."""
    global LAUNCHES
    c = config_of(cfg)
    check_evolve_inputs(c, v0, s0, beta, init_ind, n_real)
    E = int(record_schedule)
    if E < 0:
        raise ValueError(f"record_schedule must be >= 0; got {E}")
    for name, x in (("v0", v0), ("s0", s0), ("beta", beta),
                    ("init_ind", init_ind)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), c.n_spikes
    dev, dt_ = v0.device, v0.dtype
    out = _evolve_outputs(v0, init_ind, R, E, event_times, fallbacks)
    if E:
        out[6].zero_()
    if event_times:
        out[7].zero_()
    W = c.evolve_window
    scratch = (None if row_fits_shared(N, M, dt_, "evolve",
                                       shared_optin_bytes(dev)) else
               torch.empty(P * R * row_elems(N), dtype=dt_, device=dev))
    # while a profiler records, a windowed launch always stores its rows'
    # fallback counts, into a scratch if the caller did not ask for them
    counted = profiling.recording()
    fb = out[8] if fallbacks else None
    if counted and W and fb is None:
        fb = torch.empty(P * R, dtype=torch.int32, device=dev)

    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _ENTRY[dt_])(
            v0.data_ptr(), s0.data_ptr(), init_ind.data_ptr(),
            beta.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), out[3].data_ptr(), out[4].data_ptr(),
            out[5].data_ptr(), out[6].data_ptr() if E else None,
            out[7].data_ptr() if event_times else None,
            None if scratch is None else scratch.data_ptr(),
            None if fb is None else fb.data_ptr(),
            P, R, N, M, E, W, window_pad(W) if W else 0, int(per_row),
            default_threads(N, P * R, torch.cuda.get_device_properties(
                dev).multi_processor_count, dt_),
            c.counter_max, c.vth, c.drive, c.vth - c.drive, c.a1,
            c.a2, c.b1, c.b2, c.dx, c.t_horizon, c.root_tol,
            stream)
    _build.check(lib, code, "evolve kernel launch")
    LAUNCHES += 1
    if counted:
        profiling.K1_COUNTERS.count(out[5], fb if W else None)
    return out


@evolve_op.register_kernel("cpu")
def _evolve_plain(cfg, v0, s0, beta, init_ind, n_real, record_schedule,
                  event_times, fallbacks):
    c = config_of(cfg)
    E = int(record_schedule)
    rows = v0.shape[0] * n_real
    times = (torch.zeros(rows, E, dtype=torch.float64) if event_times
             else torch.zeros(rows, 0, dtype=torch.float64))
    fb = torch.zeros(rows if fallbacks else 0, dtype=torch.int32)
    out = evolve_ensemble_batched(
        c, v0, s0, beta, init_ind, E, fallbacks=fb if fallbacks else None,
        n_real=n_real, event_times=times if event_times else None)
    res, sched = out if E else (out, torch.zeros(rows, 0,
                                                 dtype=torch.int32))
    return (*res, sched, times, fb)


@evolve_op.register_fake
def _evolve_fake(cfg, v0, s0, beta, init_ind, n_real, record_schedule,
                 event_times, fallbacks):
    return _evolve_outputs(v0, init_ind, n_real, record_schedule,
                           event_times, fallbacks)
