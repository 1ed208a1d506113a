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

Exact Jacobians (:func:`map_jvp`, ``F.value_and_jacobian``): the map's
smooth piece at a point is differentiated forward, with no finite
differences: the lift's tangents by K9T (``atorch::lift_tangent``; on
the CPU the plain lift on dual numbers), the evolve's by the tangent
replay (K2T on the card, :func:`.replay.replay_events_tangent` on the
CPU) of the point's own firing order (on a direct backend the fp64
evolve's log with its time log, so that the tangents ride on the
trajectory that gives ``F``, at its own
``root_tol`` event times; the f32 discovery's log on ``"replay"``, whose
``F`` is the tangent replay's own primal), and the restriction's by
``torch.func.jvp``.

Points with their own parameters: where ``params.beta`` and
``params.sigma`` are ``(P,)`` tensors (one per point of a stack), the draw
is ``(P * R, N)``, ``params.beta[p] + params.sigma[p] * noise[r]`` from one
``(R, N)`` ``noise`` (common random numbers), and every evolve row has its
own rates.

Sharding (``group=``, a :class:`..parallel.sharding.ShardGroup`): every
rank takes the full draw and the same points, keeps its own block of
realisations (:meth:`~..parallel.sharding.ShardGroup.rows`), runs lift,
evolve and restriction on them, and adds its masked position sums and
accept counts into ONE all-reduce before the division; every rank returns
the same ``f``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from ..config import ModelConfig, MapParams
from ..utils.profiling import span, spanned
from .autodiff import (differentiable_evolve, direct_schedule,
                       outcome_error, outcome_mismatch)
from .evolve import EvolveResult
from .evolve_batched import evolve_ensemble_batched
from .evolve_cuda import evolve_ensemble_cuda
from .lift import initial_spike_indices, lift
from .lift_cuda import lift_tangent
from .replay import (compute_schedule, evolve_ensemble_replay,
                     select_replay, select_replay_tangent)
from .restrict import (masked_ensemble_mean, masked_sums, reduce_mean,
                       restrict_positions)

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


def sample_noise(cfg: ModelConfig, generator: torch.Generator, *,
                 device=None) -> torch.Tensor:
    """The ``(n_real, n_neurons)`` standard normal noise of a draw, from
    ``generator`` on ``device`` (the generator's own device by default)."""
    device = generator.device if device is None else torch.device(device)
    return torch.randn((cfg.n_real, cfg.n_neurons), generator=generator,
                       dtype=cfg.torch_dtype, device=device)


def beta_from_noise(cfg: ModelConfig, params: MapParams,
                    noise: torch.Tensor) -> torch.Tensor:
    """The draw ``mean + sigma * noise``: ``(R, N)`` for one parameter
    point, ``(P * R, N)`` (row ``p * R + r``) where ``params`` holds
    ``(P,)`` tensors."""
    dt_, dev = cfg.torch_dtype, noise.device
    mean = params.beta.to(dtype=dt_, device=dev)
    sigma = params.sigma.to(dtype=dt_, device=dev)
    if mean.ndim == 0 and sigma.ndim == 0:
        return mean + sigma * noise
    P = max(mean.numel(), sigma.numel())
    draw = (mean.reshape(-1, 1, 1) + sigma.reshape(-1, 1, 1) * noise[None])
    return draw.expand(P, *noise.shape).reshape(-1, noise.shape[1])


def sample_beta(cfg: ModelConfig, params: MapParams,
                generator: torch.Generator, *, device=None) -> torch.Tensor:
    """Heterogeneous synaptic rates ``beta = mean + sigma * N(0, 1)``, shape
    ``(n_real, n_neurons)``, drawn from ``generator`` on ``device`` (the
    generator's own device by default)."""
    return beta_from_noise(cfg, params, sample_noise(cfg, generator,
                                                     device=device))


def point_params(params: MapParams, P: int) -> MapParams:
    """``params`` as the lift broadcasts them over a stack of ``P`` points:
    0-dim tensors as they are, ``(P,)`` tensors as ``(P, 1)``."""
    if params.beta.ndim == 0 and params.sigma.ndim == 0:
        return params
    return MapParams(beta=params.beta.reshape(-1, 1).expand(P, 1),
                     sigma=params.sigma.reshape(-1, 1).expand(P, 1))


def differentiable_backend(evolve_backend: str) -> str:
    """The backend an exact Jacobian differentiates for ``evolve_backend``
    (the JAX package's ``emap.py:89-100``, where the Pallas evolve has no
    JVP).  Every backend of the port differentiates: a direct one
    (``"auto"``, ``"cuda"``, ``"torch"``) by the tangent replay of the fp64
    evolve's own firing order, ``"replay"`` by that of its f32 discovery
    pass; so the name is validated (:func:`check_backend`) and returned as
    it is."""
    check_backend(evolve_backend)
    return evolve_backend


def check_backend(evolve_backend: str) -> None:
    """Refuse a name that is not one of ``EVOLVE_BACKENDS``."""
    if evolve_backend not in EVOLVE_BACKENDS:
        raise ValueError(f"unknown evolve_backend: {evolve_backend!r} "
                         f"(expected one of {EVOLVE_BACKENDS})")


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
    check_backend(evolve_backend)
    if evolve_backend == "replay":
        return evolve_ensemble_replay
    if evolve_backend == "cuda" or (evolve_backend == "auto"
                                    and device.type == "cuda"):
        return evolve_ensemble_cuda
    return evolve_ensemble_batched


def run_pipeline(cfg: ModelConfig, params: MapParams, Z: torch.Tensor,
                 beta: torch.Tensor, *, evolve_backend: str = "auto",
                 sharded: bool = False):
    """The lift -> evolve -> restrict stages for a stack ``Z`` of shape
    ``(P, n_spikes)``.

    Returns ``(U, init_ind, v0, s0, evolve_result, positions)`` with
    leading ``P`` axes; the evolve result and positions cover ``P * R``
    rows.  ``beta`` is ``(R, N)``, or ``(P * R, N)`` for points with their
    own parameters (``params`` of ``(P,)`` tensors).  Every stage is
    forward-differentiable: the lift (on the card through
    :class:`.autodiff.DifferentiableLift`) and the restriction as torch
    ops, the evolve through :func:`.autodiff.differentiable_evolve`
    (``sharded``: this is one rank's block of a sharded map, which refuses
    a tangent).
    """
    Z = Z.to(dtype=cfg.torch_dtype, device=beta.device)
    U = z_to_u(Z)
    init_ind = initial_spike_indices(cfg, Z)
    v0, s0 = lift(cfg, point_params(params, Z.shape[0]), U)
    res = differentiable_evolve(
        cfg, v0.contiguous(), s0.contiguous(), beta.contiguous(),
        init_ind.contiguous(), evolve_backend=evolve_backend,
        evolve=select_evolve(evolve_backend, beta.device), sharded=sharded)
    return U, init_ind, v0, s0, res, restrict_positions(cfg, res)


def assemble_residual(cfg: ModelConfig, U: torch.Tensor,
                      u_mean: torch.Tensor) -> torch.Tensor:
    """``f = -c U[1:] - U_T + c T``."""
    c = U[..., :1]
    return -c * U[..., 1:] - u_mean + c * cfg.t_horizon


@spanned("map.eval")
def event_driven_map(cfg: ModelConfig, params: MapParams,
                     beta: torch.Tensor, Z: torch.Tensor, *,
                     with_diagnostics: bool = False,
                     evolve_backend: str = "auto", group=None):
    """Evaluate the map residual ``f = F(Z)``.

    Args:
      beta: ``(n_real, n_neurons)`` heterogeneity draw (:func:`sample_beta`);
        it fixes the device and takes the place of the JAX package's key.
        For a stack whose points have their own parameters (``params`` of
        ``(P,)`` tensors) the ``(P * n_real, n_neurons)`` draw of
        :func:`beta_from_noise`.
      Z: ``(n_spikes,)`` reduced state ``(c, z_1, ..)``, or a ``(P,
        n_spikes)`` stack evaluated in one evolve launch.
      with_diagnostics: also return :class:`MapDiagnostics`.
      evolve_backend: ``"auto"``, ``"cuda"``, ``"torch"`` or ``"replay"``
        (:func:`select_evolve`).
      group: a :class:`..parallel.sharding.ShardGroup`: this rank evolves
        its block of the realisations and the mean is all-reduced (the
        diagnostics then hold this rank's rows).

    Returns:
      ``f`` of the shape of ``Z``, and the diagnostics if asked for.
    """
    Z = torch.as_tensor(Z)
    single = Z.ndim == 1
    Zs = Z[None, :] if single else Z
    P, R, M = Zs.shape[0], cfg.n_real, cfg.n_spikes
    if (beta.ndim != 2 or beta.shape[0] not in (R, P * R)
            or beta.shape[1] != cfg.n_neurons
            or beta.dtype != cfg.torch_dtype):
        raise ValueError(f"beta must be ({R}, {cfg.n_neurons}) "
                         f"{cfg.torch_dtype} (or ({P * R}, {cfg.n_neurons}) "
                         f"for points with their own parameters); got "
                         f"{tuple(beta.shape)} {beta.dtype}")
    if group is not None:
        cfg, beta = group.localize(cfg, beta, P=P)
        R = cfg.n_real
    U, init_ind, v0, s0, res, positions = run_pipeline(
        cfg, params, Zs, beta, evolve_backend=evolve_backend,
        sharded=group is not None)
    positions = positions.reshape(P, R, M)
    u_mean, count = masked_ensemble_mean(positions, res.accept.reshape(P, R),
                                         group)
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


@spanned("map.discovery")
def compute_discrete_outcome(cfg: ModelConfig, params: MapParams,
                             beta: torch.Tensor, Z: torch.Tensor, group=None):
    """The map's discrete outcome at one point ``Z`` (``(n_spikes,)``):
    ``(schedule, n_events, init_ind)``, the ``(R, E)`` int32 firing order
    of the f32 discovery pass, its ``(R,)`` event counts and the ``(M,)``
    seeding indices, for :func:`frozen_schedule_map_batched`.  With a
    ``group`` the schedule covers this rank's realisations only (the
    firing order is per row: discovery needs no collective); pass the same
    group to :func:`frozen_schedule_map_batched`."""
    if group is not None:
        cfg, beta = group.localize(cfg, beta)
    Zs = Z.to(dtype=cfg.torch_dtype, device=beta.device)[None, :]
    init_ind = initial_spike_indices(cfg, Zs)
    v0, s0 = lift(cfg, params, z_to_u(Zs))
    sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind)
    return sched, n_ev, init_ind[0]


@spanned("map.eval")
def frozen_schedule_map_batched(cfg: ModelConfig, params: MapParams,
                                beta: torch.Tensor, Zs: torch.Tensor,
                                sched: torch.Tensor, n_sched: torch.Tensor,
                                init_ind: torch.Tensor, *,
                                noise: Optional[torch.Tensor] = None,
                                params_batched: bool = False,
                                group=None) -> torch.Tensor:
    """The smooth piece of ``F`` around one frozen discrete outcome, at a
    ``(P, n_spikes)`` stack of points, in ONE replay of ``P * R`` rows.

    Every point is lifted, then replays the shared ``schedule`` with the
    shared seeding ``init_ind`` (not its own: recomputing the indices per
    point would be another function, and an FD stencil across it would jump
    across grid cells).  At the point the outcome was discovered at, this
    is ``event_driven_map(..., evolve_backend="replay")``.

    ``params_batched=True``: ``params`` holds ``(P,)`` tensors, one
    parameter point per point (the bordered correctors walk a parameter),
    and the draws are made from the ``(R, N)`` ``noise`` (``beta`` is then
    unused and may be None): one replay of ``P * R`` rows, each with its
    own rates.

    ``group``: ``sched`` and ``n_sched`` are this rank's (from
    :func:`compute_discrete_outcome` with the same group); the rank
    replays its block of realisations of every point and the mean is
    all-reduced.

    Returns:
      ``(P, n_spikes)`` residuals.
    """
    P = Zs.shape[0]
    if group is not None:
        cfg, noise, beta = group.localize(cfg, noise, beta, P=P)
    R, M = cfg.n_real, cfg.n_spikes
    if params_batched:
        if noise is None:
            raise ValueError("params_batched needs the draw's noise")
        beta = beta_from_noise(cfg, params, noise)
    U = z_to_u(Zs.to(dtype=cfg.torch_dtype, device=beta.device))
    v0, s0 = lift(cfg, point_params(params, P), U)
    replay = select_replay(beta.device)
    res = replay(cfg, sched, n_sched, v0.contiguous(), s0.contiguous(),
                 beta.contiguous(), init_ind, n_real=R)
    positions = restrict_positions(cfg, res).reshape(P, R, M)
    u_mean, _ = masked_ensemble_mean(positions, res.accept.reshape(P, R),
                                     group)
    return assemble_residual(cfg, U, u_mean)


def frozen_schedule_map(cfg: ModelConfig, params: MapParams,
                        beta: torch.Tensor, Z: torch.Tensor,
                        sched: torch.Tensor, n_sched: torch.Tensor,
                        init_ind: torch.Tensor) -> torch.Tensor:
    """:func:`frozen_schedule_map_batched` at one point ``(n_spikes,)``."""
    return frozen_schedule_map_batched(cfg, params, beta, Z[None, :], sched,
                                       n_sched, init_ind)[0]


def _masked_sums(cfg: ModelConfig, res: EvolveResult, P: int):
    """``(h, count)``: ``h(last_time, crossed_time)`` is the ``(P,
    n_spikes)`` sum of the restricted positions over the accepted rows of
    the discrete outcome of ``res`` (indices and accept held fixed), the
    function whose ``torch.func.jvp`` is the restriction's tangent;
    ``count`` the ``(P,)`` accept counts (:func:`.restrict.masked_sums`)."""
    R, M = cfg.n_real, cfg.n_spikes
    accept = res.accept.reshape(P, R)

    def h(last_time, crossed_time):
        out = EvolveResult(last_ind=res.last_ind, last_time=last_time,
                           crossed_ind=res.crossed_ind,
                           crossed_time=crossed_time, accept=res.accept,
                           n_events=res.n_events)
        return masked_sums(restrict_positions(cfg, out).reshape(P, R, M),
                           accept)[0]
    return h, accept.sum(dim=-1, dtype=torch.float64)


def lift_tangents(cfg: ModelConfig, params: MapParams, Zs: torch.Tensor,
                  dZ: torch.Tensor, dpb: torch.Tensor):
    """The lifts of a stack ``Zs`` ``(P, n)`` and their tangents along
    ``D`` directions: ``dZ`` ``(D, P, n)`` of the points and ``dpb``
    ``(D, P, 1)`` of the mean rate ``params.beta`` (the lift's only
    parameter), all directions in one call of the op
    ``atorch::lift_tangent`` (one K9T launch on the card; the plain
    loop on dual numbers on the CPU).  Returns ``(U, dU, v0, s0, dv0,
    ds0)``, the lifts ``(P, N)`` and their tangents ``(D, P, N)``."""
    P = Zs.shape[0]
    # the mean rate, one per point, shared or not
    pb = params.beta.to(dtype=Zs.dtype, device=Zs.device).reshape(
        -1).expand(P)
    U, dU = z_to_u(Zs), z_to_u(dZ)
    with span("map.lift"):
        v0, s0, dv0, ds0 = lift_tangent(cfg, U, pb, dU,
                                        dpb.reshape(dpb.shape[0], P))
    return U, dU, v0, s0, dv0, ds0


def rate_base(cfg: ModelConfig, noise: Optional[torch.Tensor],
              param: Optional[str], device) -> Optional[torch.Tensor]:
    """The base of the draw's tangents along the walked parameter: along
    a direction whose parameter tangent at point ``p`` is ``dp[d, p]``,
    realisation ``r``'s rates move by ``dp[d, p] * base[r]``.  ``base`` is
    the ``(R, N)`` float64 ones along the beta axis, the frozen noise along
    sigma, and None without a parameter direction (the tangent replay's
    ``base``)."""
    if param is None:
        return None
    if param == "beta":
        return torch.ones(cfg.n_real, cfg.n_neurons, dtype=torch.float64,
                          device=device)
    return noise.to(torch.float64).contiguous()


def map_jvp(cfg: ModelConfig, params: MapParams, noise: torch.Tensor,
            Zs: torch.Tensor, dZ: torch.Tensor,
            dparam: Optional[torch.Tensor] = None, *,
            param: Optional[str] = None, evolve_backend: str = "auto",
            beta: Optional[torch.Tensor] = None, group=None):
    """The map at a stack of points and its derivatives along ``D``
    directions, exact (no finite differences).

    Args:
      params: one parameter point (0-dim tensors) or one per point
        (``(P,)`` tensors).
      noise: the ``(R, N)`` noise of the draw (the draw is ``params.beta +
        params.sigma * noise``); None where ``beta`` is given and no sigma
        direction is asked for.
      Zs: ``(P, n)`` points.
      dZ: ``(D, P, n)`` tangents of the points.
      dparam: ``(D, P)`` tangents of the walked parameter ``param``
        (``"beta"``: the mean rate, entering the lift and the draw;
        ``"sigma"``: entering the draw through the noise), or None.
      evolve_backend: a direct backend (``"auto"``, ``"cuda"``,
        ``"torch"``) takes the schedule from the fp64 evolve's own log and
        ``F`` from that evolve (the direct map); ``"replay"`` takes the f32
        discovery's log and ``F`` from the tangent replay's primal (the
        replay map).
      beta: the draw itself, in place of ``noise`` (no sigma direction).
      group: a :class:`..parallel.sharding.ShardGroup`: this rank replays
        its block of the realisations; with the accept mask held fixed the
        mean's tangent is the all-reduced masked tangent sum over the same
        global count, so the masked sums, their tangents, the counts and
        the outcome check's count go into ONE all-reduce.  The lift's
        tangents are replicated.

    Returns:
      ``(F (P, n), JV (D, P, n))``.  Float64 configurations only: the
      tangents are fp64 (K2T's arithmetic), and an exact Jacobian of the
      f32 map is not offered.
    """
    if cfg.dtype != "float64":
        raise ValueError("exact Jacobians need a float64 configuration "
                         f"(cfg.dtype={cfg.dtype!r}); pass dtype='float64'")
    if param not in (None, "beta", "sigma"):
        raise ValueError(f"param must be None, 'beta' or 'sigma'; got "
                         f"{param!r}")
    check_backend(evolve_backend)
    f64 = torch.float64
    dev = (noise if noise is not None else beta).device
    Zs = Zs.to(dtype=f64, device=dev)
    P, D = Zs.shape[0], dZ.shape[0]
    if group is not None:
        cfg, noise, beta = group.localize(cfg, noise, beta, P=P)
    R = cfg.n_real
    dZ = dZ.to(dtype=f64, device=dev)
    dp = (torch.zeros(D, P, dtype=f64, device=dev) if dparam is None
          else dparam.to(dtype=f64, device=dev).expand(D, P))
    if beta is None:
        if noise is None:
            raise ValueError("map_jvp needs the draw's noise or the draw")
        beta = beta_from_noise(cfg, params, noise)
    elif param == "sigma":
        raise ValueError("a sigma direction needs the draw's noise")
    beta = beta.contiguous()
    base = rate_base(cfg, noise, param, dev)
    U, dU, v0, s0, dv0, ds0 = lift_tangents(
        cfg, params, Zs, dZ, dp[:, :, None] if param == "beta"
        else torch.zeros(D, P, 1, dtype=f64, device=dev))
    init_ind = initial_spike_indices(cfg, Zs).contiguous()

    # the firing order and the tangent replay of it
    if evolve_backend == "replay":
        sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind,
                                       n_real=R)
        res, times = None, None
    else:
        # the direct evolve's time log: the tangents ride on the
        # trajectory that gives F, at its own (root_tol) event times
        res, sched, times = direct_schedule(
            cfg, select_evolve(evolve_backend, dev), v0, s0, beta, init_ind)
        n_ev = res.n_events
    tangent = select_replay_tangent(dev)
    res_t, d_last, d_crossed = tangent(
        cfg, sched.contiguous(), n_ev.contiguous(), v0, s0, beta, init_ind,
        dv0, ds0, base, dp.contiguous(), n_real=R, times=times)
    if res is None:
        res, n_bad = res_t, torch.zeros((), dtype=f64, device=dev)
    else:
        n_bad = outcome_mismatch(res, res_t).sum(dtype=f64)

    # the restriction's tangent: indices and accept take none
    with span("map.jvp"):
        h, count = _masked_sums(cfg, res, P)
        times = (res.last_time, res.crossed_time)
        sums = h(*times)
        dsums = torch.func.vmap(lambda a, b: torch.func.jvp(
            h, times, (a, b))[1])(d_last, d_crossed)
    with span("map.mean"):
        u_mean, count, dsums, n_bad = reduce_mean(sums, count, group,
                                                  dsums, n_bad)
    if float(n_bad):
        raise outcome_error(int(n_bad))
    with span("map.jvp"):
        du_mean = dsums / count[..., None]
        f = assemble_residual(cfg, U, u_mean)
        jv = torch.func.vmap(lambda a, b: torch.func.jvp(
            lambda U_, u_: assemble_residual(cfg, U_, u_), (U, u_mean),
            (a, b))[1])(dU, du_mean)
    return f, jv


class ResidualFn:
    """The map closed over one draw, ``F: Z -> f`` (one point ``(n,)`` or
    a stack ``(P, n)``), with its exact Jacobian:
    ``F.value_and_jacobian(Z, param=None)``.

    Attributes: ``cfg``, ``params``, ``beta`` (the ``(R, N)`` draw),
    ``noise`` (its ``(R, N)`` noise, or None where only the draw was
    given), ``evolve_backend`` and ``group`` (a
    :class:`..parallel.sharding.ShardGroup`, or None).
    """

    def __init__(self, cfg: ModelConfig, params: MapParams,
                 beta: torch.Tensor, noise: Optional[torch.Tensor],
                 evolve_backend: str, group=None):
        self.cfg, self.params = cfg, params
        self.beta, self.noise = beta, noise
        self.evolve_backend = evolve_backend
        self.group = group

    def __call__(self, Z: torch.Tensor) -> torch.Tensor:
        return event_driven_map(self.cfg, self.params, self.beta, Z,
                                evolve_backend=self.evolve_backend,
                                group=self.group)

    @spanned("map.eval")
    def value_and_jacobian(self, Z: torch.Tensor,
                           param: Optional[str] = None):
        """``(F(Z), J)`` at one point ``(n,)``: ``J`` is ``(n, n)``, or
        ``(n, n + 1)`` with the last column ``dF/dbeta`` (``param="beta"``)
        or ``dF/dsigma`` (``"sigma"``); exact, by one tangent replay of
        ``n`` (or ``n + 1``) directions (:func:`map_jvp`).  ``F`` is the
        map's own value at ``Z`` on this backend."""
        Z = Z.to(dtype=self.cfg.torch_dtype, device=self.beta.device)
        n = Z.shape[0]
        D = n + (param is not None)
        eye = torch.eye(D, dtype=torch.float64, device=Z.device)
        f, jv = map_jvp(self.cfg, self.params, self.noise, Z[None],
                        eye[:, None, :n],
                        eye[:, n:].reshape(D, 1) if param else None,
                        param=param, evolve_backend=self.evolve_backend,
                        beta=self.beta if self.noise is None else None,
                        group=self.group)
        return f[0], jv[:, 0, :].T


def make_residual_fn(cfg: ModelConfig, params: MapParams,
                     seed_or_generator: Union[int, torch.Generator], *,
                     device, beta: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     evolve_backend: str = "auto",
                     group=None) -> ResidualFn:
    """Close the map over one draw into a residual oracle ``F: Z -> f``
    (a :class:`ResidualFn`, which also offers the exact Jacobian).

    The noise is made once on ``device`` (from a ``torch.Generator``
    seeded with ``seed_or_generator``, or that generator itself) and the
    draw ``params.beta + params.sigma * noise`` reused by every
    evaluation; ``noise=`` injects a given ``(R, N)`` noise, ``beta=`` a
    given draw (then ``dF/dsigma`` is not offered).  ``F`` takes one point
    ``(n,)`` or a stack ``(P, n)``.  ``group``: every evaluation is
    sharded over its ranks (:func:`event_driven_map`); every rank makes
    the same full draw and keeps its rows at each call.
    """
    device = torch.device(device)
    if beta is not None and noise is not None:
        raise ValueError("pass the draw (beta=) or its noise (noise=), not "
                         "both")
    if beta is None:
        if noise is None:
            gen = seed_or_generator
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator(device=device).manual_seed(int(gen))
            noise = sample_noise(cfg, gen, device=device)
        else:
            noise = noise.to(dtype=cfg.torch_dtype, device=device)
        noise = noise.contiguous()
        beta = beta_from_noise(cfg, params, noise).contiguous()
    else:
        beta = beta.to(dtype=cfg.torch_dtype, device=device).contiguous()
    select_evolve(evolve_backend, device)   # reject a bad name up front
    return ResidualFn(cfg, params, beta, noise, evolve_backend, group)
