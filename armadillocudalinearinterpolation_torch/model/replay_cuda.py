"""The schedule replay as a hand-written CUDA kernel (``csrc/replay.cu``,
K2).

:func:`replay_events_cuda` takes the same arguments and returns the same
:class:`.evolve.EvolveResult` as the plain version
:func:`.replay.replay_events`, for float32 or float64 states on a CUDA
device (the arithmetic is fp64 either way).  It launches on the current
stream, does not synchronise, and raises on any input the kernel does not
take, and on a launch the card refuses; there is no fallback.
``LAUNCHES`` counts its launches (read it as ``replay_cuda.LAUNCHES``).

:func:`replay_events_tangent_cuda` is K2T, the same replay with ``D``
forward tangents (the exact Jacobian's kernel; plain version
:func:`.replay.replay_events_tangent`): one CTA per (row, direction), of
:func:`replay_layout`'s threads (``kind="tangent"``);
``TANGENT_LAUNCHES`` counts its launches.

The launch is one CTA a row, of :func:`replay_layout`'s threads, always.
A row that does not fit one CTA's shared memory
(:func:`.evolve_cuda.row_fits_shared`) keeps its state in a scratch of
device memory that the wrapper allocates; the kernel body is the same.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import ModelConfig
from .evolve import EvolveResult, beta_rows
from .evolve_cuda import (SHARED_OPTIN_BYTES, row_elems, row_fits_shared,
                          row_shared_bytes, shared_optin_bytes)
from .replay import (check_replay_inputs, check_tangent_inputs, kick_table,
                     schedule_config)

LAUNCHES = 0
TANGENT_LAUNCHES = 0

_ENTRY = {torch.float32: "atorch_replay_f32",
          torch.float64: "atorch_replay_f64"}
_TANGENT_ENTRY = {torch.float32: "atorch_replay_tangent_f32",
                  torch.float64: "atorch_replay_tangent_f64"}

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
# K2T's __launch_bounds__(512, 1) lets it take up to 128 registers a
# thread: the register file holds 512 of its threads an SM.
TANGENT_THREADS_PER_SM = 512


def replay_layout(N: int, M: int, rows: int, sms: int,
                  optin: int = SHARED_OPTIN_BYTES,
                  shared_per_sm: int = SHARED_PER_SM,
                  kind: str = "replay") -> int:
    """Threads a CTA of K2 (``kind="replay"``) for ``rows`` rows of ``N``
    lanes and ``M`` trajectories, one CTA a row, or of K2T
    (``kind="tangent"``, ``rows`` counting one CTA a row and direction), on
    a card of ``sms`` SMs whose blocks may opt in to ``optin`` bytes of
    shared memory, of ``shared_per_sm`` an SM.

    The CTAs that one SM has to hold for every row to be resident in one
    wave (as far as its shared memory lets it) share ``THREADS_PER_SM``
    (K2T: ``TANGENT_THREADS_PER_SM``) threads; no CTA has more than
    ``MAX_THREADS``, nor more sweep threads than lanes (rounded up to a
    warp), and each has the event warp and at least one sweep warp."""
    per_cta = row_shared_bytes(N, M, torch.float64, kind)
    if not row_fits_shared(N, M, torch.float64, kind, optin):
        per_cta -= row_elems(N, kind) * 8    # the row in device memory
    by_shared = shared_per_sm // (per_cta + SHARED_RESERVED_PER_CTA)
    resident = max(1, min(-(-rows // sms), by_shared))
    per_sm = THREADS_PER_SM if kind == "replay" else TANGENT_THREADS_PER_SM
    threads = min(per_sm // resident // 32 * 32, MAX_THREADS,
                  32 + -(-N // 32) * 32)
    return max(64, threads)


def replay_events_cuda(cfg: ModelConfig, sched: torch.Tensor,
                       n_sched: torch.Tensor, v0: torch.Tensor,
                       s0: torch.Tensor, beta: torch.Tensor,
                       init_ind: torch.Tensor, *,
                       n_real=None) -> EvolveResult:
    """Replay a recorded firing order on the card, one CTA per row.

    Args:
      sched: ``(R, E)`` or ``(P * R, E)`` int32 firing-order log.
      n_sched: its int32 event counts, one per schedule row.
      v0, s0: ``(P, N)`` lifted states; beta: ``(R, N)`` rates, or ``(P *
        R, N)`` with ``n_real=R``; float32 or float64, one dtype.
      init_ind: ``(M,)`` or ``(P, M)`` int32 initial spike indices.

    Returns:
      :class:`EvolveResult` over ``P * R`` rows, times in ``v0.dtype``.
    """
    global LAUNCHES
    check_replay_inputs(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real)
    for name, x in (("sched", sched), ("n_sched", n_sched), ("v0", v0),
                    ("s0", s0), ("beta", beta), ("init_ind", init_ind)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v0.device.type != "cuda":
        raise ValueError("replay_events_cuda needs CUDA tensors; got "
                         f"{v0.device} (use the plain replay on the CPU)")
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), cfg.n_spikes
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
            S, Q, int(per_row), threads, cfg32.counter_max,
            cfg.vth, cfg.drive, cfg.vth - cfg.drive, cfg.t_horizon,
            cfg32.root_tol, stream)
    _build.check(lib, code, "replay kernel launch")
    LAUNCHES += 1
    return EvolveResult(last_ind=last_ind, last_time=last_time,
                        crossed_ind=crossed_ind, crossed_time=crossed_time,
                        accept=accept, n_events=n_sched.repeat(rows // S))


def replay_events_tangent_cuda(cfg: ModelConfig, sched: torch.Tensor,
                               n_sched: torch.Tensor, v0: torch.Tensor,
                               s0: torch.Tensor, beta: torch.Tensor,
                               init_ind: torch.Tensor, dv0: torch.Tensor,
                               ds0: torch.Tensor, dbeta: torch.Tensor, *,
                               n_real=None):
    """K2T: the replay with ``D`` forward tangents on the card, one CTA
    per (row, direction).

    Takes and returns what :func:`.replay.replay_events_tangent` does:
    ``(result, d_last_time, d_crossed_time)``, the tangents ``(D, P * R,
    M)`` float64.  The primal outputs equal :func:`replay_events_cuda`'s
    bit for bit (the same per-lane code).  Raises on any input the kernel
    does not take and on a launch the card refuses; there is no fallback.
    """
    global TANGENT_LAUNCHES
    check_replay_inputs(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real)
    D = check_tangent_inputs(cfg, v0, beta, dv0, ds0, dbeta, n_real)
    for name, x in (("sched", sched), ("n_sched", n_sched), ("v0", v0),
                    ("s0", s0), ("beta", beta), ("init_ind", init_ind),
                    ("dv0", dv0), ("ds0", ds0), ("dbeta", dbeta)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v0.device.type != "cuda":
        raise ValueError("replay_events_tangent_cuda needs CUDA tensors; "
                         f"got {v0.device} (use the plain tangent replay on "
                         "the CPU)")
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), cfg.n_spikes
    S, E = sched.shape
    Q = init_ind.numel() // M
    rows, dev, dt_ = P * R, v0.device, v0.dtype
    f64 = torch.float64
    last_ind = torch.empty(rows, M, dtype=torch.int32, device=dev)
    last_time = torch.empty(rows, M, dtype=dt_, device=dev)
    crossed_ind = torch.empty(rows, M, dtype=torch.int32, device=dev)
    crossed_time = torch.empty(rows, M, dtype=dt_, device=dev)
    accept = torch.empty(rows, dtype=torch.bool, device=dev)
    d_last = torch.empty(D, rows, M, dtype=f64, device=dev)
    d_crossed = torch.empty(D, rows, M, dtype=f64, device=dev)
    wtab = kick_table(cfg, dev)
    cfg32 = schedule_config(cfg)
    optin = shared_optin_bytes(dev)
    props = torch.cuda.get_device_properties(dev)
    threads = replay_layout(N, M, rows * D, props.multi_processor_count,
                            optin, props.shared_memory_per_multiprocessor,
                            "tangent")
    scratch = (None if row_fits_shared(N, M, f64, "tangent", optin)
               else torch.empty(rows * D * 6 * N, dtype=f64, device=dev))

    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _TANGENT_ENTRY[dt_])(
            v0.data_ptr(), s0.data_ptr(), beta.data_ptr(), dv0.data_ptr(),
            ds0.data_ptr(), dbeta.data_ptr(), sched.data_ptr(),
            n_sched.data_ptr(), init_ind.data_ptr(), wtab.data_ptr(),
            last_ind.data_ptr(), last_time.data_ptr(),
            crossed_ind.data_ptr(), crossed_time.data_ptr(),
            accept.data_ptr(), d_last.data_ptr(), d_crossed.data_ptr(),
            None if scratch is None else scratch.data_ptr(), P, R, N, M, E,
            S, Q, D, int(per_row), threads, cfg32.counter_max,
            cfg.vth, cfg.drive, cfg.vth - cfg.drive, cfg.t_horizon,
            cfg32.root_tol, stream)
    _build.check(lib, code, "tangent replay kernel launch")
    TANGENT_LAUNCHES += 1
    result = EvolveResult(last_ind=last_ind, last_time=last_time,
                          crossed_ind=crossed_ind, crossed_time=crossed_time,
                          accept=accept, n_events=n_sched.repeat(rows // S))
    return result, d_last, d_crossed
