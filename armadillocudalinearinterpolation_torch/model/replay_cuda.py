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
:func:`.replay.replay_events_tangent`): the primal once a row for all ``D``
directions, the row's lanes split over a thread-block cluster of
:func:`replay_layout`'s CTAs (``kind="tangent"``: the smallest cluster whose
CTAs hold their share of the row in shared memory, or a pair where a row
of one CTA would leave most of the card idle);
``TANGENT_LAUNCHES`` counts its launches.

Both are ops, ``atorch::replay`` (:func:`replay_op`) and
``atorch::replay_tangent`` (:func:`replay_tangent_op`): functional (they
return new tensors), with a fake kernel for the output shapes, and
dispatched by device, the kernel for CUDA tensors and the plain version
for CPU ones (a CUDA tensor never reaches the plain version).  K2T's op
also has a vmap rule that folds a batch of tangents into its ``D`` axis,
so ``torch.func.jacfwd`` over the map launches K2T once
(:func:`replay_tangent`).  The launches are ``ctypes`` calls into the
library that :mod:`.._build` compiles with nvcc.

K2's launch is one CTA a row, of :func:`replay_layout`'s threads, always.
A row that does not fit one CTA's shared memory
(:func:`.evolve_cuda.row_fits_shared`; for K2T, a cluster of 8) keeps its
state in a scratch of device memory that the wrapper allocates; the
kernel body is the same.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..config import ModelConfig
from .evolve import EvolveResult, beta_rows
from .evolve_cuda import (SHARED_OPTIN_BYTES, config_key, config_of,
                          n_real_of, row_elems, row_fits_shared,
                          row_shared_bytes, shared_optin_bytes)
from .replay import (check_replay_inputs, check_tangent_inputs, kick_table,
                     replay_events, replay_events_tangent, schedule_config)

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
# the cluster sizes K2T takes: a row's lanes over 1 to 8 CTAs (8 is the
# portable limit)
CLUSTER_SIZES = (1, 2, 4, 8)
# K2T splits a row that fits one CTA over a pair where each CTA keeps at
# least this many lanes and the pairs make one wave: the cluster barrier
# then costs less than the sweep of the other half (tools/k2t_study.py on
# an H100: N=2048 gains, N=512 and 1024 lose)
TANGENT_PAIR_MIN_LANES = 1024


class TangentLayout(NamedTuple):
    """K2T's launch: ``cluster`` CTAs a row of ``threads`` each, every one
    holding its share of the row's lanes in shared memory (``in_shared``),
    or one CTA a row (``cluster`` 1) with the row in device memory."""

    cluster: int
    threads: int
    in_shared: bool


def tangent_shared_bytes(N: int, M: int, D: int, C: int,
                         in_shared: bool = True) -> int:
    """Dynamic shared memory of one K2T CTA in a cluster of ``C``, counting
    every array of ``tangent_smem_bytes`` in ``csrc/replay.cu``: its
    ``ceil(N / C)`` lanes of v, s, beta, the rates' tangent base and the
    ``D`` pairs (dv, ds), and the ``N // 2 + 1`` kick table (none of which
    where the row is in device memory); the times and their ``D`` tangents
    of each of ``M`` trajectories, last and crossed; the two-slot mailbox
    (dt and ``D`` d(dt)); t's ``D`` tangents and the ``D`` dp of the
    row's point; and the int bookkeeping.  All float64."""
    lanes = -(-N // C)
    row = (4 + 2 * D) * lanes + N // 2 + 1 if in_shared else 0
    return (row + 2 * M + 2 * D * M + 2 + 4 * D) * 8 + (3 * M + 2) * 4


def replay_layout(N: int, M: int, rows: int, sms: int,
                  optin: int = SHARED_OPTIN_BYTES,
                  shared_per_sm: int = SHARED_PER_SM,
                  kind: str = "replay", D: int = 1):
    """The launch of K2 (``kind="replay"``: threads a CTA, one CTA a row)
    or of K2T (``kind="tangent"``: a :class:`TangentLayout`) for ``rows``
    rows of ``N`` lanes and ``M`` trajectories (and K2T's ``D``
    directions) on a card of ``sms`` SMs whose blocks may opt in to
    ``optin`` bytes of shared memory, of ``shared_per_sm`` an SM.

    K2T's cluster is the smallest of :data:`CLUSTER_SIZES` whose CTAs hold
    their share of the row and its directions in shared memory
    (:func:`tangent_shared_bytes`), else one CTA with the row in device
    memory; where that smallest is 1, a pair if each of its CTAs keeps
    :data:`TANGENT_PAIR_MIN_LANES` lanes and ``2 * rows`` CTAs fit the
    ``sms`` (a larger cluster than fit needs is not taken: clusters of 4
    place in two waves where ``4 * rows`` CTAs would fit).  The CTAs that one SM has to hold for every row to be resident
    in one wave (as far as its shared memory lets it) share
    ``THREADS_PER_SM`` (K2T: ``TANGENT_THREADS_PER_SM``) threads; no CTA
    has more than ``MAX_THREADS``, nor more sweep threads than its lanes
    (rounded up to a warp), and each has the event warp and at least one
    sweep warp."""
    if kind == "tangent":
        cluster = next((c for c in CLUSTER_SIZES
                        if tangent_shared_bytes(N, M, D, c) <= optin), None)
        in_shared = cluster is not None
        cluster = cluster or 1
        if (in_shared and cluster == 1 and 2 * rows <= sms
                and N // 2 >= TANGENT_PAIR_MIN_LANES):
            cluster = 2
        per_cta = tangent_shared_bytes(N, M, D, cluster, in_shared)
        lanes, ctas, per_sm = -(-N // cluster), rows * cluster, \
            TANGENT_THREADS_PER_SM
    elif kind == "replay":
        per_cta = row_shared_bytes(N, M, torch.float64, kind)
        if not row_fits_shared(N, M, torch.float64, kind, optin):
            per_cta -= row_elems(N) * 8    # the row in device memory
        lanes, ctas, per_sm = N, rows, THREADS_PER_SM
    else:
        raise ValueError(f"kind must be 'replay' or 'tangent'; got {kind!r}")
    threads = block_threads(per_cta, lanes, ctas, sms, shared_per_sm,
                            per_sm)
    if kind == "replay":
        return threads
    return TangentLayout(cluster, threads, in_shared)


def block_threads(per_cta: int, lanes: int, ctas: int, sms: int,
                  shared_per_sm: int, per_sm: int) -> int:
    """Threads of each of ``ctas`` CTAs of ``per_cta`` bytes of shared
    memory and ``lanes`` lanes on ``sms`` SMs: the CTAs one SM holds for
    one wave (as far as its ``shared_per_sm`` bytes let it) share
    ``per_sm`` threads, within ``MAX_THREADS``, the event warp and one
    sweep warp, and no more sweep threads than lanes."""
    by_shared = shared_per_sm // (per_cta + SHARED_RESERVED_PER_CTA)
    resident = max(1, min(-(-ctas // sms), by_shared))
    return max(64, min(per_sm // resident // 32 * 32, MAX_THREADS,
                       32 + -(-lanes // 32) * 32))


def replay_events_cuda(cfg: ModelConfig, sched: torch.Tensor,
                       n_sched: torch.Tensor, v0: torch.Tensor,
                       s0: torch.Tensor, beta: torch.Tensor,
                       init_ind: torch.Tensor, *,
                       n_real=None) -> EvolveResult:
    """Replay a recorded firing order on the card, one CTA per row (the
    op ``atorch::replay`` on CUDA tensors; CPU tensors are refused).

    Args:
      sched: ``(R, E)`` or ``(P * R, E)`` int32 firing-order log.
      n_sched: its int32 event counts, one per schedule row.
      v0, s0: ``(P, N)`` lifted states; beta: ``(R, N)`` rates, or ``(P *
        R, N)`` with ``n_real=R``; float32 or float64, one dtype.
      init_ind: ``(M,)`` or ``(P, M)`` int32 initial spike indices.

    Returns:
      :class:`EvolveResult` over ``P * R`` rows, times in ``v0.dtype``.
    """
    if v0.device.type != "cuda":
        raise ValueError("replay_events_cuda needs CUDA tensors; got "
                         f"{v0.device} (use the plain replay on the CPU)")
    return EvolveResult(*replay_op(config_key(cfg), sched, n_sched, v0, s0,
                                   beta, init_ind,
                                   n_real_of(beta, n_real)))


def _check_contiguous(**tensors) -> None:
    for name, x in tensors.items():
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _replay_outputs(v0, rows: int, M: int):
    """K2's outputs before its launch: the :class:`EvolveResult`'s first
    five tensors, uninitialised, on ``v0``'s device."""
    i32, dev, dt_ = torch.int32, v0.device, v0.dtype
    return (torch.empty(rows, M, dtype=i32, device=dev),
            torch.empty(rows, M, dtype=dt_, device=dev),
            torch.empty(rows, M, dtype=i32, device=dev),
            torch.empty(rows, M, dtype=dt_, device=dev),
            torch.empty(rows, dtype=torch.bool, device=dev))


@torch.library.custom_op("atorch::replay", mutates_args=(),
                         device_types="cuda")
def replay_op(cfg: str, sched: torch.Tensor, n_sched: torch.Tensor,
              v0: torch.Tensor, s0: torch.Tensor, beta: torch.Tensor,
              init_ind: torch.Tensor, n_real: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 as an op (``cfg`` a :func:`.evolve_cuda.config_key` string,
    ``n_real`` the realisations R): the :class:`EvolveResult`'s six
    tensors.  Its CUDA kernel launches K2 on the current stream (no
    synchronise) and raises on any input the kernel does not take and on
    a launch the card refuses; its CPU kernel is the plain version,
    :func:`.replay.replay_events`."""
    global LAUNCHES
    c = config_of(cfg)
    check_replay_inputs(c, sched, n_sched, v0, s0, beta, init_ind, n_real)
    _check_contiguous(sched=sched, n_sched=n_sched, v0=v0, s0=s0, beta=beta,
                      init_ind=init_ind)
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), c.n_spikes
    S, E = sched.shape
    Q = init_ind.numel() // M
    rows, dev, dt_ = P * R, v0.device, v0.dtype
    out = _replay_outputs(v0, rows, M)
    wtab = kick_table(c, dev)
    cfg32 = schedule_config(c)
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
            *(x.data_ptr() for x in out),
            None if scratch is None else scratch.data_ptr(), P, R, N, M, E,
            S, Q, int(per_row), threads, cfg32.counter_max,
            c.vth, c.drive, c.vth - c.drive, c.t_horizon,
            cfg32.root_tol, stream)
    _build.check(lib, code, "replay kernel launch")
    LAUNCHES += 1
    return (*out, n_sched.repeat(rows // S))


@replay_op.register_kernel("cpu")
def _replay_plain(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real):
    return tuple(replay_events(config_of(cfg), sched, n_sched, v0, s0, beta,
                               init_ind, n_real=n_real))


@replay_op.register_fake
def _replay_fake(cfg, sched, n_sched, v0, s0, beta, init_ind, n_real):
    rows = v0.shape[0] * n_real
    return (*_replay_outputs(v0, rows, init_ind.shape[-1]),
            n_sched.new_empty(rows))


def replay_events_tangent_cuda(cfg: ModelConfig, sched: torch.Tensor,
                               n_sched: torch.Tensor, v0: torch.Tensor,
                               s0: torch.Tensor, beta: torch.Tensor,
                               init_ind: torch.Tensor, dv0: torch.Tensor,
                               ds0: torch.Tensor,
                               base: Optional[torch.Tensor],
                               dp: torch.Tensor, *, n_real=None,
                               times: Optional[torch.Tensor] = None):
    """K2T: the replay with ``D`` forward tangents on the card, the primal
    once a row, the row's lanes over a cluster of :func:`replay_layout`'s
    CTAs (the op ``atorch::replay_tangent`` on CUDA tensors; CPU tensors
    are refused).

    Takes and returns what :func:`.replay.replay_events_tangent` does:
    ``(result, d_last_time, d_crossed_time)``, the tangents ``(D, P * R,
    M)`` float64; ``times``, the direct evolve's time log, replaces the
    root-find.  Without it the primal outputs equal
    :func:`replay_events_cuda`'s bit for bit (the same per-lane code).
    Raises on any input the kernel does not take and on a launch the card
    refuses (a cluster it cannot place included); there is no fallback.
    """
    if v0.device.type != "cuda":
        raise ValueError("replay_events_tangent_cuda needs CUDA tensors; "
                         f"got {v0.device} (use the plain tangent replay on "
                         "the CPU)")
    return replay_tangent(cfg, sched, n_sched, v0, s0, beta, init_ind, dv0,
                          ds0, base, dp, n_real=n_real, times=times)


def replay_tangent(cfg: ModelConfig, sched, n_sched, v0, s0, beta, init_ind,
                   dv0, ds0, base, dp, *, n_real=None, times=None):
    """The op ``atorch::replay_tangent`` on tensors of any device (K2T for
    CUDA ones, :func:`.replay.replay_events_tangent` for CPU ones), with
    its arguments and results as :func:`replay_events_tangent_cuda` takes
    and returns them.  Under ``torch.func.vmap`` the op's vmap rule folds a
    batch of ``dv0``, ``ds0`` and ``dp`` into the ``D`` axis: one launch
    for the whole batch."""
    out = replay_tangent_op(config_key(cfg), sched, n_sched, v0, s0, beta,
                            init_ind, dv0, ds0, base, dp, times,
                            n_real_of(beta, n_real))
    return EvolveResult(*out[:6]), out[6], out[7]


@torch.library.custom_op("atorch::replay_tangent", mutates_args=(),
                         device_types="cuda")
def replay_tangent_op(cfg: str, sched: torch.Tensor, n_sched: torch.Tensor,
                      v0: torch.Tensor, s0: torch.Tensor, beta: torch.Tensor,
                      init_ind: torch.Tensor, dv0: torch.Tensor,
                      ds0: torch.Tensor, base: Optional[torch.Tensor],
                      dp: torch.Tensor, times: Optional[torch.Tensor],
                      n_real: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """K2T as an op: the :class:`EvolveResult`'s six tensors and the ``(D,
    P * R, M)`` float64 tangents of the last and crossed times.  Its CUDA
    kernel launches K2T on the current stream (no synchronise) and raises
    on any input the kernel does not take and on a launch the card
    refuses; its CPU kernel is the plain version,
    :func:`.replay.replay_events_tangent`."""
    global TANGENT_LAUNCHES
    c = config_of(cfg)
    check_replay_inputs(c, sched, n_sched, v0, s0, beta, init_ind, n_real)
    D = check_tangent_inputs(c, v0, beta, dv0, ds0, base, dp, n_real,
                             sched, times)
    _check_contiguous(sched=sched, n_sched=n_sched, v0=v0, s0=s0, beta=beta,
                      init_ind=init_ind, dv0=dv0, ds0=ds0, base=base, dp=dp,
                      times=times)
    P, N = v0.shape
    (R, per_row), M = beta_rows(beta, P, n_real), c.n_spikes
    S, E = sched.shape
    Q = init_ind.numel() // M
    rows, dev, dt_ = P * R, v0.device, v0.dtype
    f64 = torch.float64
    out = _replay_outputs(v0, rows, M)
    d_last = torch.empty(D, rows, M, dtype=f64, device=dev)
    d_crossed = torch.empty(D, rows, M, dtype=f64, device=dev)
    wtab = kick_table(c, dev)
    cfg32 = schedule_config(c)
    props = torch.cuda.get_device_properties(dev)
    layout = replay_layout(N, M, rows, props.multi_processor_count,
                           shared_optin_bytes(dev),
                           props.shared_memory_per_multiprocessor,
                           "tangent", D)
    scratch = (None if layout.in_shared
               else torch.empty(rows * (4 + 2 * D) * N, dtype=f64,
                                device=dev))

    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, _TANGENT_ENTRY[dt_])(
            v0.data_ptr(), s0.data_ptr(), beta.data_ptr(), dv0.data_ptr(),
            ds0.data_ptr(), None if base is None else base.data_ptr(),
            dp.data_ptr(), None if times is None else times.data_ptr(),
            sched.data_ptr(), n_sched.data_ptr(), init_ind.data_ptr(),
            wtab.data_ptr(), *(x.data_ptr() for x in out),
            d_last.data_ptr(), d_crossed.data_ptr(),
            None if scratch is None else scratch.data_ptr(), P, R, N, M, E,
            S, Q, D, layout.cluster, int(per_row), layout.threads,
            cfg32.counter_max, c.vth, c.drive, c.vth - c.drive,
            c.t_horizon, cfg32.root_tol, stream)
    _build.check(lib, code, "tangent replay kernel launch")
    TANGENT_LAUNCHES += 1
    return (*out, n_sched.repeat(rows // S), d_last, d_crossed)


@replay_tangent_op.register_kernel("cpu")
def _replay_tangent_plain(cfg, sched, n_sched, v0, s0, beta, init_ind, dv0,
                          ds0, base, dp, times, n_real):
    res, d_last, d_crossed = replay_events_tangent(
        config_of(cfg), sched, n_sched, v0, s0, beta, init_ind, dv0, ds0,
        base, dp, n_real=n_real, times=times)
    return (*res, d_last, d_crossed)


@replay_tangent_op.register_fake
def _replay_tangent_fake(cfg, sched, n_sched, v0, s0, beta, init_ind, dv0,
                         ds0, base, dp, times, n_real):
    rows, M = v0.shape[0] * n_real, init_ind.shape[-1]
    tangent = (dv0.shape[0], rows, M)
    return (*_replay_outputs(v0, rows, M), n_sched.new_empty(rows),
            dv0.new_empty(tangent), dv0.new_empty(tangent))


def _replay_tangent_vmap(info, in_dims, cfg, sched, n_sched, v0, s0, beta,
                         init_ind, dv0, ds0, base, dp, times, n_real):
    """The vmap rule of ``atorch::replay_tangent``: a batch of ``B``
    tangents ``dv0``, ``ds0`` (``(B, D, P, N)``) and ``dp`` (``(B, D,
    P)``), any of them unbatched (then shared by the batch), runs as ONE
    op call of ``B * D`` directions; the tangents come back ``(B, D, P *
    R, M)`` and the primal outputs unbatched.  The primal inputs cannot be
    batched (a batch of points is a ``(P, n)`` stack of the map)."""
    names = ("sched", "n_sched", "v0", "s0", "beta", "init_ind", "base",
             "times")
    dims = dict(zip(("cfg", "sched", "n_sched", "v0", "s0", "beta",
                     "init_ind", "dv0", "ds0", "base", "dp", "times",
                     "n_real"), in_dims))
    batched = [n for n in names if dims[n] is not None]
    if batched:
        raise NotImplementedError(
            f"vmap over the tangent replay's {', '.join(batched)}: only the "
            "tangents dv0, ds0 and dp can be batched (evaluate a batch of "
            "points as a (P, n) stack)")
    B = info.batch_size

    def fold(x, dim):
        x = (x.expand(B, *x.shape) if dim is None
             else x.movedim(dim, 0))
        return x.reshape(B * x.shape[1], *x.shape[2:]).contiguous()

    dv0f, ds0f, dpf = (fold(x, dims[n]) for x, n in ((dv0, "dv0"),
                                                     (ds0, "ds0"),
                                                     (dp, "dp")))
    out = replay_tangent_op(cfg, sched, n_sched, v0, s0, beta, init_ind,
                            dv0f, ds0f, base, dpf, times, n_real)
    tangents = [t.reshape(B, -1, *t.shape[1:]) for t in out[6:]]
    return (*out[:6], *tangents), (None,) * 6 + (0, 0)


torch.library.register_vmap("atorch::replay_tangent", _replay_tangent_vmap)


def tangent_clusters(layout: TangentLayout, N: int, M: int, D: int, *,
                     per_row: bool = False, logged: bool = False) -> int:
    """How many clusters of ``layout`` the current card holds at once for
    K2T's f64 variant at ``N`` lanes, ``M`` trajectories and ``D``
    directions a row (``cudaOccupancyMaxActiveClusters``): a launch of
    ``rows`` rows runs in ``ceil(rows / clusters)`` waves.  A report for
    ``chip_smoke.py`` and ``tools/k2t_study.py``; no launch asks it."""
    out = ctypes.c_int(0)
    lib = _build.load_library()
    code = lib.atorch_replay_tangent_clusters(
        int(not layout.in_shared), int(per_row), int(logged), N, M, D,
        layout.cluster, layout.threads, ctypes.byref(out))
    _build.check(lib, code, "K2T cluster occupancy")
    return out.value
