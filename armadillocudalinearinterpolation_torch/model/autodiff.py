"""The map's evolve under PyTorch's forward-mode AD.

The evolve is an event loop: each event time is a root found by Newton
iterations, and PyTorch's AD through the plain loop differentiates those
iterates, not the root (at the default ``root_tol`` 1e-6 a column of the
map's Jacobian moves by ~1e-3 relative); on the card the kernels are
``ctypes`` launches, which AD cannot see at all.  The JAX package puts a
custom JVP on the event time (its ``model/events.py:59-97``), so that
``jax.jvp`` over its map is the implicit-function derivative at the root
the evolve took.  Here two ``torch.autograd.Function`` s put the same rule
around the whole evolve:

- :class:`DirectEvolve` (``"auto"``, ``"cuda"``, ``"torch"``: K1 or the
  plain evolve) records, when an input carries a tangent, the firing-order
  log and the time log (:func:`direct_schedule`); its ``jvp`` is the
  tangent replay of that log at the logged times (K2T through the op
  ``atorch::replay_tangent``), as :func:`.emap.map_jvp` takes it, and
  refuses where the replay reaches another discrete outcome
  (:class:`..solvers.newton.JacobianUnavailable`);
- :class:`ReplayEvolve` (``"replay"``: the f32 discovery, then K2) takes
  its ``jvp`` from the tangent replay of the discovery's log with its own
  root-find, whose primal is K2's bit for bit.

The lift before them is :class:`DifferentiableLift` on the card: K9
through the op ``atorch::lift``, its ``jvp`` from K9T
(``atorch::lift_tangent``, whose vmap rule takes every direction of a
``jacfwd`` in one launch).

Their outputs are the :class:`.evolve.EvolveResult`'s: ``last_time`` and
``crossed_time`` carry tangents, the indices, ``accept`` and ``n_events``
none.  Under ``torch.func.jacfwd`` the ``D`` tangent directions reach the
tangent replay as one batch, which the op's vmap rule folds into K2T's
``D`` axis: one launch for the whole Jacobian.

:func:`differentiable_evolve` runs the evolve as it ran before (no log,
no time log, no extra launch) unless an input carries a tangent or
requires a gradient.  Reverse mode raises (as in the JAX package, whose
evolve is a ``while_loop``), and so do a float32 configuration with a
tangent, a tangent on the rates ``beta`` and a sharded map with a tangent;
``F.value_and_jacobian`` (:class:`.emap.ResidualFn`) takes the rates'
directions and the sharded map.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

from ..config import ModelConfig
from ..solvers.newton import JacobianUnavailable
from .evolve import EvolveResult
from .lift_cuda import lift_op, lift_tangent_op
from .replay import compute_schedule, schedule_width, select_replay
from .replay_cuda import replay_tangent


def has_tangent(x: torch.Tensor) -> bool:
    """Whether ``x`` carries a forward tangent, from
    ``torch.autograd.forward_ad`` or a ``torch.func`` transform."""
    return fwAD.unpack_dual(x).tangent is not None


def direct_schedule(cfg: ModelConfig, evolve: Callable, v0, s0, beta,
                    init_ind):
    """The direct evolve with its firing-order log and time log:
    ``(result, schedule, times)``, the logs wide enough for every row's
    events (a row past :func:`.replay.schedule_width` columns is run again
    with wider logs, so that no row of the direct map is rejected by the
    replay of its own log)."""
    rows = v0.shape[0] * cfg.n_real
    E = schedule_width(cfg)
    for _ in range(2):
        times = torch.empty(rows, E, dtype=torch.float64, device=v0.device)
        res, sched = evolve(cfg, v0, s0, beta, init_ind, record_schedule=E,
                            n_real=cfg.n_real, event_times=times)
        need = int(res.n_events.max()) if res.n_events.numel() else 0
        if need <= E:
            break
        E = -(-need // 128) * 128
    return res, sched, times


def outcome_mismatch(res: EvolveResult, res_t: EvolveResult) -> torch.Tensor:
    """The rows where a tangent replay's discrete outcome differs from the
    direct evolve's whose log it replayed: accept, or on an accepted row
    the recorded trajectory slots.  Where any row differs, ``J`` would
    belong to another smooth piece than ``F``: the callers raise
    :func:`outcome_error`.  (The replay takes the evolve's logged
    times, so its times are the evolve's bit for bit and the two outcomes
    cannot part; the check stays as the guard of that contract.)"""
    slots = ((res.last_ind == res_t.last_ind)
             & (res.crossed_ind == res_t.crossed_ind)).all(dim=1)
    return (res.accept != res_t.accept) | (res.accept & ~slots)


def outcome_error(n_bad: int) -> JacobianUnavailable:
    """The error for ``n_bad`` rows of :func:`outcome_mismatch`."""
    return JacobianUnavailable(
        "the tangent replay of the fp64 evolve's firing order reached "
        f"another discrete outcome on {n_bad} row(s) (accept or recorded "
        "slots differ); its Jacobian would not be the direct map's: take "
        "evolve_backend='replay' at this point")


def _tangent_replay(cfg: ModelConfig, sched, n_events, v0, s0, beta,
                    init_ind, dv0, ds0, times):
    """One direction ``(dv0, ds0)`` (``(P, N)``; None is 0) through the
    tangent replay op: ``(result, d_last, d_crossed)``, the tangents ``(P
    * R, M)``.  Under ``vmap`` the directions are a batch, which the op
    runs as its ``D`` axis."""
    dv0 = torch.zeros_like(v0) if dv0 is None else dv0
    ds0 = torch.zeros_like(s0) if ds0 is None else ds0
    dp = torch.zeros(1, v0.shape[0], dtype=torch.float64, device=v0.device)
    res, d_last, d_crossed = replay_tangent(
        cfg, sched, n_events, v0, s0, beta, init_ind,
        dv0[None].contiguous(), ds0[None].contiguous(), None, dp,
        n_real=cfg.n_real, times=times)
    return res, d_last[0], d_crossed[0]


class DifferentiableLift(torch.autograd.Function):
    """The lift of the ``(P, n_spikes + 1)`` points ``U`` under their
    ``(P,)`` mean rates ``beta`` (``cfg`` a :func:`.evolve_cuda.config_key`
    string) through the op ``atorch::lift`` (K9 on the card), with its
    ``jvp`` from ``atorch::lift_tangent`` (K9T): the tangents of ``U`` and
    ``beta``, either of which may be absent, in one launch, and under
    ``torch.func.jacfwd`` every direction in that launch.  Outputs ``(v0,
    s0)``, each ``(P, n_neurons)``."""

    @staticmethod
    def forward(U, beta, cfg):
        return lift_op(cfg, U, beta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        U, beta, cfg = inputs
        ctx.cfg = cfg
        ctx.save_for_forward(U, beta)

    @staticmethod
    def jvp(ctx, dU, dbeta, _):
        U, beta = ctx.saved_tensors
        dU = torch.zeros_like(U) if dU is None else dU
        dbeta = torch.zeros_like(beta) if dbeta is None else dbeta
        _, _, dv0, ds0 = lift_tangent_op(ctx.cfg, U, beta, dU[None],
                                         dbeta[None])
        return dv0[0], ds0[0]

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the lift kernel has no reverse mode (nor has the map's "
            "evolve): differentiate forward (torch.func.jvp, "
            "torch.func.jacfwd or torch.autograd.forward_ad)")

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(
            "vmap over the lift's points: lift them as one (P, n_spikes + "
            "1) stack (one launch)")


class _Evolve(torch.autograd.Function):
    """What both evolves share: the outputs' differentiability, and the
    refusal of reverse mode and of a vmap over the map's points."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        v0, s0, beta, init_ind, cfg, _, record = inputs
        ctx.cfg = cfg
        ctx.mark_non_differentiable(*(x for x in (output[0], output[2],
                                                  *output[4:])
                                      if x is not None))
        if record:
            ctx.save_for_forward(v0, s0, beta, init_ind, *output)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the map's evolve has no reverse mode (nor has the JAX "
            "package's, a while_loop): differentiate it forward "
            "(torch.func.jvp, torch.func.jacfwd, jacfwd_cols or "
            "torch.autograd.forward_ad)")

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(
            "vmap over the map's points: evaluate them as a (P, n) stack "
            "(one evolve launch)")


class DirectEvolve(_Evolve):
    """The direct evolve ``evolve`` (K1 or the plain version) of ``(v0,
    s0)`` under ``beta``; with ``record``, also its logs, on which
    :meth:`jvp` replays the tangents.  Outputs: the six fields of the
    :class:`EvolveResult`, the log and the time log (None without
    ``record``)."""

    @staticmethod
    def forward(v0, s0, beta, init_ind, cfg, evolve, record):
        if not record:
            return (*evolve(cfg, v0, s0, beta, init_ind, n_real=cfg.n_real),
                    None, None)
        res, sched, times = direct_schedule(cfg, evolve, v0, s0, beta,
                                            init_ind)
        return (*res, sched, times)

    @staticmethod
    def jvp(ctx, dv0, ds0, *_):
        v0, s0, beta, init_ind, *out = ctx.saved_tensors
        res, sched, times = EvolveResult(*out[:6]), out[6], out[7]
        res_t, d_last, d_crossed = _tangent_replay(
            ctx.cfg, sched, res.n_events, v0, s0, beta, init_ind, dv0, ds0,
            times)
        n_bad = int(outcome_mismatch(res, res_t).sum())
        if n_bad:
            raise outcome_error(n_bad)
        return None, d_last, None, d_crossed, None, None, None, None


class ReplayEvolve(_Evolve):
    """The ``"replay"`` backend's evolve of ``(v0, s0)`` under ``beta``:
    the f32 discovery pass, then K2 (or the plain replay) of its log.
    Outputs: the six fields of the :class:`EvolveResult` and the log, on
    which :meth:`jvp` replays the tangents with its own root-find (the
    same primal as K2's, bit for bit), and None."""

    @staticmethod
    def forward(v0, s0, beta, init_ind, cfg, evolve, record):
        R = cfg.n_real
        sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind,
                                       n_real=R)
        res = select_replay(v0.device)(cfg, sched, n_ev, v0, s0, beta,
                                       init_ind, n_real=R)
        return (*res, sched, None)

    @staticmethod
    def jvp(ctx, dv0, ds0, *_):
        v0, s0, beta, init_ind, *out = ctx.saved_tensors
        _, d_last, d_crossed = _tangent_replay(
            ctx.cfg, out[6], out[5], v0, s0, beta, init_ind, dv0, ds0, None)
        return None, d_last, None, d_crossed, None, None, None, None


def differentiable_evolve(cfg: ModelConfig, v0: torch.Tensor,
                          s0: torch.Tensor, beta: torch.Tensor,
                          init_ind: torch.Tensor, *, evolve_backend: str,
                          evolve: Callable,
                          sharded: bool = False) -> EvolveResult:
    """The map's evolve of the ``(P, N)`` lifts ``(v0, s0)`` under
    ``beta`` with ``evolve`` (:func:`.emap.select_evolve`'s for
    ``evolve_backend``), forward-differentiable: through
    :class:`ReplayEvolve` on ``"replay"``, :class:`DirectEvolve` on the
    others, where an input carries a tangent or requires a gradient, and
    as ``evolve`` itself otherwise.

    Raises, where an input carries a tangent, ``NotImplementedError`` for
    a ``sharded`` map or a tangent on ``beta`` and ``ValueError`` for a
    float32 configuration."""
    xs = (v0, s0, beta)
    tangent = any(has_tangent(x) for x in xs)
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in xs)
    if not (tangent or grad):
        return evolve(cfg, v0, s0, beta, init_ind, n_real=cfg.n_real)
    if tangent:
        if sharded:
            raise NotImplementedError(
                "forward AD of a sharded map (group=) is not offered: take "
                "F.value_and_jacobian, which reduces the tangents over the "
                "ranks")
        if has_tangent(beta):
            raise NotImplementedError(
                "a tangent on the rates beta: the tangent replay moves the "
                "rates along one base per realisation only; take "
                "F.value_and_jacobian(Z, param='beta' or 'sigma')")
        if cfg.dtype != "float64":
            raise ValueError(
                "forward AD of the map needs a float64 configuration "
                f"(cfg.dtype={cfg.dtype!r}): its tangents are fp64; pass "
                "dtype='float64'")
    fn = ReplayEvolve if evolve_backend == "replay" else DirectEvolve
    return EvolveResult(*fn.apply(v0, s0, beta, init_ind, cfg, evolve,
                                  tangent)[:6])
