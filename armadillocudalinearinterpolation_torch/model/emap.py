"""The event-driven map ``F(Z)``: lift -> evolve -> restrict -> mean ->
residual.

Batched evaluation takes the place of ``vmap``: ``Z`` may be one point
``(n,)`` or a stack ``(P, n)``.  A stack lifts every point and runs ONE
evolve over all ``P * R`` rows, so a finite-difference Jacobian costs one
evolve launch.  The points of a stack share the draw ``beta`` (common random
numbers) and differ in ``v0``, ``s0`` and the initial spike indices.

Common random numbers: :func:`make_residual_fn` draws ``beta`` once and
reuses it for every evaluation, as the reference reseeds its generator to a
fixed seed before every evaluation.

The accurate map of the staged solver runs on the ``"replay"`` backend (an
f32 discovery pass, then the fp64 replay of its firing order,
:mod:`.replay`).  Between evaluations the map's only non-smooth content is
that discrete outcome: :func:`compute_discrete_outcome` returns it at one
point, and :func:`frozen_schedule_map_batched` evaluates the smooth piece
around it at a whole stencil of points in one replay.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from ..config import ModelConfig, MapParams
from .evolve import EvolveResult
from .evolve_batched import evolve_ensemble_batched
from .evolve_cuda import evolve_ensemble_cuda
from .lift import initial_spike_indices, lift
from .replay import compute_schedule, evolve_ensemble_replay, select_replay
from .restrict import masked_ensemble_mean, restrict_positions

EVOLVE_BACKENDS = ("auto", "cuda", "torch", "replay")


class MapDiagnostics(NamedTuple):
    """Per-stage intermediates; for a stack every field has a leading
    ``P`` axis."""

    v0: torch.Tensor               # (N,)
    s0: torch.Tensor               # (N,)
    init_ind: torch.Tensor         # (M,) int32
    evolve: EvolveResult           # fields (R, M) and (R,)
    positions: torch.Tensor        # (R, M)
    accept_count: torch.Tensor     # ()
    u_mean: torch.Tensor           # (M,)


def z_to_u(Z: torch.Tensor) -> torch.Tensor:
    """Gauge fixing ``Z -> U = (c, 0, Z1, ..)``: spike 1 pinned at offset 0."""
    return torch.cat([Z[..., :1], torch.zeros_like(Z[..., :1]), Z[..., 1:]],
                     dim=-1)


def u_to_z(U: torch.Tensor) -> torch.Tensor:
    """Inverse gauge map."""
    return torch.cat([U[..., :1], U[..., 2:]], dim=-1)


def sample_beta(cfg: ModelConfig, params: MapParams,
                generator: torch.Generator, *, device=None) -> torch.Tensor:
    """Heterogeneous synaptic rates ``beta = mean + sigma * N(0, 1)``, shape
    ``(n_real, n_neurons)``, drawn from ``generator`` on ``device`` (the
    generator's own device by default)."""
    device = generator.device if device is None else torch.device(device)
    noise = torch.randn((cfg.n_real, cfg.n_neurons), generator=generator,
                        dtype=cfg.torch_dtype, device=device)
    mean = params.beta.to(dtype=cfg.torch_dtype, device=device)
    sigma = params.sigma.to(dtype=cfg.torch_dtype, device=device)
    return mean + sigma * noise


def select_evolve(evolve_backend: str, device: torch.device) -> Callable:
    """Resolve the evolve backend: ``"auto"`` is the kernel for CUDA tensors
    and the plain version for CPU ones; ``"cuda"`` is the kernel (which
    raises on CPU tensors); ``"torch"`` is the plain version anywhere;
    ``"replay"`` is the two-pass evolve (f32 discovery, fp64 replay: K1
    with its log and K2 for CUDA tensors, the plain versions for CPU
    ones).  The kernel and the plain version
    (:func:`.evolve_batched.evolve_ensemble_batched`) both run the
    certified window of ``cfg.evolve_window`` lanes, or every lane where it
    is 0."""
    if evolve_backend not in EVOLVE_BACKENDS:
        raise ValueError(f"unknown evolve_backend: {evolve_backend!r} "
                         f"(expected one of {EVOLVE_BACKENDS})")
    if evolve_backend == "replay":
        return evolve_ensemble_replay
    if evolve_backend == "cuda" or (evolve_backend == "auto"
                                    and device.type == "cuda"):
        return evolve_ensemble_cuda
    return evolve_ensemble_batched


def run_pipeline(cfg: ModelConfig, params: MapParams, Z: torch.Tensor,
                 beta: torch.Tensor, *, evolve_backend: str = "auto"):
    """The lift -> evolve -> restrict stages for a stack ``Z`` of shape
    ``(P, n_spikes)``.

    Returns ``(U, init_ind, v0, s0, evolve_result, positions)`` with
    leading ``P`` axes; the evolve result and positions cover ``P * R``
    rows.
    """
    Z = Z.to(dtype=cfg.torch_dtype, device=beta.device)
    U = z_to_u(Z)
    init_ind = initial_spike_indices(cfg, Z)
    v0, s0 = lift(cfg, params, U)
    evolve = select_evolve(evolve_backend, beta.device)
    res = evolve(cfg, v0.contiguous(), s0.contiguous(), beta,
                 init_ind.contiguous())
    return U, init_ind, v0, s0, res, restrict_positions(cfg, res)


def assemble_residual(cfg: ModelConfig, U: torch.Tensor,
                      u_mean: torch.Tensor) -> torch.Tensor:
    """``f = -c U[1:] - U_T + c T``."""
    c = U[..., :1]
    return -c * U[..., 1:] - u_mean + c * cfg.t_horizon


def event_driven_map(cfg: ModelConfig, params: MapParams,
                     beta: torch.Tensor, Z: torch.Tensor, *,
                     with_diagnostics: bool = False,
                     evolve_backend: str = "auto"):
    """Evaluate the map residual ``f = F(Z)``.

    Args:
      beta: ``(n_real, n_neurons)`` heterogeneity draw (:func:`sample_beta`);
        it fixes the device and takes the place of the JAX package's key.
      Z: ``(n_spikes,)`` reduced state ``(c, z_1, ..)``, or a ``(P,
        n_spikes)`` stack evaluated in one evolve launch.
      with_diagnostics: also return :class:`MapDiagnostics`.
      evolve_backend: ``"auto"``, ``"cuda"``, ``"torch"`` or ``"replay"``
        (:func:`select_evolve`).

    Returns:
      ``f`` of the shape of ``Z``, and the diagnostics if asked for.
    """
    Z = torch.as_tensor(Z)
    single = Z.ndim == 1
    Zs = Z[None, :] if single else Z
    if beta.shape != (cfg.n_real, cfg.n_neurons) or beta.dtype != cfg.torch_dtype:
        raise ValueError(f"beta must be ({cfg.n_real}, {cfg.n_neurons}) "
                         f"{cfg.torch_dtype}; got {tuple(beta.shape)} "
                         f"{beta.dtype}")
    P, R, M = Zs.shape[0], cfg.n_real, cfg.n_spikes
    U, init_ind, v0, s0, res, positions = run_pipeline(
        cfg, params, Zs, beta, evolve_backend=evolve_backend)
    positions = positions.reshape(P, R, M)
    u_mean, count = masked_ensemble_mean(positions, res.accept.reshape(P, R))
    f = assemble_residual(cfg, U, u_mean)
    if not with_diagnostics:
        return f[0] if single else f

    evolve = EvolveResult(*(x.reshape((P, R) + x.shape[1:]) for x in res))
    diag = MapDiagnostics(v0=v0, s0=s0, init_ind=init_ind, evolve=evolve,
                          positions=positions, accept_count=count,
                          u_mean=u_mean)
    if single:
        diag = MapDiagnostics(
            *(EvolveResult(*(x[0] for x in d)) if isinstance(d, EvolveResult)
              else d[0] for d in diag))
        return f[0], diag
    return f, diag


def compute_discrete_outcome(cfg: ModelConfig, params: MapParams,
                             beta: torch.Tensor, Z: torch.Tensor):
    """The map's discrete outcome at one point ``Z`` (``(n_spikes,)``):
    ``(schedule, n_events, init_ind)``, the ``(R, E)`` int32 firing order
    of the f32 discovery pass, its ``(R,)`` event counts and the ``(M,)``
    seeding indices, for :func:`frozen_schedule_map_batched`."""
    Zs = Z.to(dtype=cfg.torch_dtype, device=beta.device)[None, :]
    init_ind = initial_spike_indices(cfg, Zs)
    v0, s0 = lift(cfg, params, z_to_u(Zs))
    sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind)
    return sched, n_ev, init_ind[0]


def frozen_schedule_map_batched(cfg: ModelConfig, params: MapParams,
                                beta: torch.Tensor, Zs: torch.Tensor,
                                sched: torch.Tensor, n_sched: torch.Tensor,
                                init_ind: torch.Tensor) -> torch.Tensor:
    """The smooth piece of ``F`` around one frozen discrete outcome, at a
    ``(P, n_spikes)`` stack of points, in ONE replay of ``P * R`` rows.

    Every point is lifted, then replays the shared ``schedule`` with the
    shared seeding ``init_ind`` (not its own: recomputing the indices per
    point would be another function, and an FD stencil across it would jump
    across grid cells).  At the point the outcome was discovered at, this
    is ``event_driven_map(..., evolve_backend="replay")``.

    Returns:
      ``(P, n_spikes)`` residuals.
    """
    P, R, M = Zs.shape[0], cfg.n_real, cfg.n_spikes
    U = z_to_u(Zs.to(dtype=cfg.torch_dtype, device=beta.device))
    v0, s0 = lift(cfg, params, U)
    replay = select_replay(beta.device)
    res = replay(cfg, sched, n_sched, v0.contiguous(), s0.contiguous(),
                 beta, init_ind)
    positions = restrict_positions(cfg, res).reshape(P, R, M)
    u_mean, _ = masked_ensemble_mean(positions, res.accept.reshape(P, R))
    return assemble_residual(cfg, U, u_mean)


def frozen_schedule_map(cfg: ModelConfig, params: MapParams,
                        beta: torch.Tensor, Z: torch.Tensor,
                        sched: torch.Tensor, n_sched: torch.Tensor,
                        init_ind: torch.Tensor) -> torch.Tensor:
    """:func:`frozen_schedule_map_batched` at one point ``(n_spikes,)``."""
    return frozen_schedule_map_batched(cfg, params, beta, Z[None, :], sched,
                                       n_sched, init_ind)[0]


def make_residual_fn(cfg: ModelConfig, params: MapParams,
                     seed_or_generator: Union[int, torch.Generator], *,
                     device, beta: Optional[torch.Tensor] = None,
                     evolve_backend: str = "auto"
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Close the map over one draw into a residual oracle ``F: Z -> f``.

    The draw ``beta`` is made once on ``device`` (from a ``torch.Generator``
    seeded with ``seed_or_generator``, or that generator itself) and reused
    by every evaluation; ``beta=`` injects a given draw instead.  ``F``
    takes one point ``(n,)`` or a stack ``(P, n)``.
    """
    device = torch.device(device)
    if beta is None:
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))
        beta = sample_beta(cfg, params, gen, device=device)
    else:
        beta = beta.to(dtype=cfg.torch_dtype, device=device).contiguous()
    select_evolve(evolve_backend, device)   # reject a bad name up front

    def F(Z: torch.Tensor) -> torch.Tensor:
        return event_driven_map(cfg, params, beta, Z,
                                evolve_backend=evolve_backend)
    return F
