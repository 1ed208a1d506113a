"""The port's map under PyTorch's own forward-mode AD (``model/autodiff.py``,
the ops of ``model/evolve_cuda.py`` and ``model/replay_cuda.py``), on the
CPU: ``torch.func.jvp``, ``torch.func.jacfwd``, ``jacfwd_cols`` and
``torch.autograd.forward_ad`` over ``make_residual_fn``'s map against JAX
``jax.jvp`` / ``jacfwd_cols`` over its ``"xla"`` evolve at the default
root_tol (N=512, R=4, f64, sigma 0.1, the JAX noise fed to both), and
against the port's own ``F.value_and_jacobian`` on the direct and the
replay backend; the refusals (f32, a rate tangent, a sharded map, reverse
mode); ``torch.library.opcheck`` of the three ops; the tangent replay op's
vmap rule; the evolve's launches without a tangent; and exact Newton on a
plain composite callable against the JAX exact-mode solve.

Never through PyTorch's AD of the plain loop itself: the Functions hand the
tangents to the tangent replay.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from torch_parity import INITIAL_GUESS, configs, jx, params, pt, to_numpy
from armadillocudalinearinterpolation_tpu.solvers.newton import (
    jacfwd_cols as jax_jacfwd_cols)
from armadillocudalinearinterpolation_torch.model import (autodiff, emap,
                                                          evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.evolve_batched import (
    evolve_ensemble_batched)
from armadillocudalinearinterpolation_torch.model.replay import (
    compute_schedule, replay_events, replay_events_tangent)

KEY = jax.random.PRNGKey(0)
N, R = 512, 4
Z_REF = (0.3262, 0.7194, 1.3690)
# the JAX test's bar for the map's Jacobian (tests/test_exact_jacobian.py)
JACOBIAN_ATOL = 1e-7
# the same tangents by two routes of the port: relative to the largest entry
SAME_RTOL = 1e-12
ROUTES = ("func_jvp", "forward_ad", "jacfwd", "jacfwd_cols")


def jax_noise(R_, N_) -> np.ndarray:
    return np.asarray(jax.random.normal(KEY, (R_, N_), dtype=jnp.float64))


def residual(backend, dtype="float64", n_neurons=N, n_real=R, **kw):
    """The port's map at the default root_tol, closed over the JAX noise."""
    _, pcfg = configs(dtype=dtype, n_neurons=n_neurons, n_real=n_real, **kw)
    _, pp = params(sigma=0.1, dtype=dtype)
    return pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                               noise=torch.tensor(jax_noise(n_real,
                                                            n_neurons)),
                               evolve_backend=backend)


def along(route, F, Z, dZ):
    """``dF(Z)/dZ . dZ`` by one of the four routes (``jacfwd`` and
    ``jacfwd_cols`` contract their Jacobian with ``dZ``)."""
    if route == "func_jvp":
        return torch.func.jvp(F, (Z,), (dZ,))[1]
    if route == "forward_ad":
        with fwAD.dual_level():
            return fwAD.unpack_dual(F(fwAD.make_dual(Z, dZ))).tangent
    jac = (torch.func.jacfwd(F) if route == "jacfwd"
           else pt.jacfwd_cols(F))(Z)
    return torch.tensordot(jac, dZ, dims=Z.ndim)


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def jax_loose_root():
    """JAX at the default root_tol: ``jax.jvp`` along e0 and
    ``jacfwd_cols`` through the "xla" evolve at Z_REF."""
    jcfg, _ = configs(n_neurons=N, n_real=R)
    jp, _ = params(sigma=0.1)
    jF = jx.make_residual_fn(jcfg, jp, KEY, evolve_backend="xla")
    z = jnp.asarray(Z_REF, jnp.float64)
    col0 = jax.jit(lambda y: jax.jvp(jF, (y,), (jnp.eye(3)[0],))[1])(z)
    return np.asarray(col0), np.asarray(jax.jit(jax_jacfwd_cols(jF))(z))


@pytest.mark.parametrize("route", ROUTES)
def test_autodiff_matches_jax_at_the_default_root_tol(jax_loose_root, route):
    """The fault this module repairs: torch.func.jvp through the plain
    loop differentiated the Newton iterates of each event time and sat
    1.1e-2 from JAX's column at root_tol 1e-6.  Every route now matches
    JAX jax.jvp (column 0) and jacfwd_cols (all columns) within 1e-7."""
    col0, J_jax = jax_loose_root
    F = residual("torch")
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    if route in ("jacfwd", "jacfwd_cols"):
        J = (torch.func.jacfwd(F) if route == "jacfwd"
             else pt.jacfwd_cols(F))(Z)
        np.testing.assert_allclose(to_numpy(J), J_jax, rtol=0,
                                   atol=JACOBIAN_ATOL)
    got = along(route, F, Z, torch.eye(3, dtype=torch.float64)[0])
    np.testing.assert_allclose(to_numpy(got), col0, rtol=0,
                               atol=JACOBIAN_ATOL)


@pytest.fixture(scope="module", params=["torch", "replay"])
def exact(request):
    """The map on one backend, a point and a stack of two, and each
    point's ``value_and_jacobian``."""
    F = residual(request.param)
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    Zs = torch.stack([Z, torch.tensor(INITIAL_GUESS, dtype=torch.float64)])
    return F, Z, Zs, [F.value_and_jacobian(z) for z in Zs]


@pytest.mark.parametrize("stack", [False, True], ids=["point", "stack"])
@pytest.mark.parametrize("route", ROUTES)
def test_autodiff_matches_value_and_jacobian(exact, route, stack):
    """Every route equals the exact Jacobian of F.value_and_jacobian
    (one tangent replay of the same log) within 1e-12 relative, on a
    point and on a (2, 3) stack (one evolve of both points, whose
    Jacobian is block diagonal); the primal is F's own value."""
    F, Z, Zs, vj = exact
    dZ = torch.tensor([[0.3, -1.0, 0.5], [1.0, 0.25, -0.75]],
                      dtype=torch.float64)
    if not stack:
        want = vj[0][1] @ dZ[0]
        got = along(route, F, Z, dZ[0])
    else:
        want = torch.stack([J @ d for (_, J), d in zip(vj, dZ)])
        got = along(route, F, Zs, dZ)
    assert got.shape == want.shape
    assert rel(got, want) <= SAME_RTOL
    if route == "func_jvp":
        f, _ = torch.func.jvp(F, (Zs if stack else Z,),
                              (dZ if stack else dZ[0],))
        want_f = torch.stack([v[0] for v in vj]) if stack else vj[0][0]
        assert torch.equal(f, want_f)


def test_jacfwd_of_a_stack_is_block_diagonal(exact):
    F, _, Zs, vj = exact
    J = torch.func.jacfwd(F)(Zs)                      # (2, 3, 2, 3)
    for p in range(2):
        assert rel(J[p, :, p, :], vj[p][1]) <= SAME_RTOL
        assert torch.equal(J[p, :, 1 - p, :],
                           torch.zeros(3, 3, dtype=torch.float64))


def test_refuses_float32():
    F = residual("torch", dtype="float32", n_real=2)
    Z = torch.tensor(Z_REF, dtype=torch.float32)
    with pytest.raises(ValueError, match="float64"):
        torch.func.jvp(F, (Z,), (torch.ones_like(Z),))
    F(Z)                                  # without a tangent it evaluates


@pytest.mark.parametrize("backend", ["torch", "replay"])
def test_refuses_a_rate_tangent(backend):
    F = residual(backend, n_real=2)
    Z = torch.tensor(Z_REF, dtype=torch.float64)

    def of_rates(b):
        return pt.event_driven_map(F.cfg, F.params, b, Z,
                                   evolve_backend=backend)
    with pytest.raises(NotImplementedError, match="value_and_jacobian"):
        torch.func.jvp(of_rates, (F.beta,), (torch.ones_like(F.beta),))


def test_refuses_a_sharded_map():
    """group= with a tangent is refused (F.value_and_jacobian reduces the
    tangents over the ranks); one gloo rank in this process."""
    import torch.distributed as dist
    from armadillocudalinearinterpolation_torch.parallel import ShardGroup
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1)
        try:
            plain = residual("torch", n_real=2)
            F = pt.make_residual_fn(plain.cfg, plain.params, 0,
                                    device="cpu", noise=plain.noise,
                                    evolve_backend="torch",
                                    group=ShardGroup(2))
            Z = torch.tensor(Z_REF, dtype=torch.float64)
            with pytest.raises(NotImplementedError,
                               match="value_and_jacobian"):
                torch.func.jvp(F, (Z,), (torch.ones_like(Z),))
            assert torch.equal(F(Z), plain(Z))
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("how", ["backward", "jacrev"])
def test_refuses_reverse_mode(how):
    F = residual("torch", n_real=2)
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="reverse mode"):
        if how == "backward":
            F(Z.clone().requires_grad_()).sum().backward()
        else:
            torch.func.jacrev(F)(Z)


def small_case(logged):
    """Inputs of the three ops at N=64, R=2, one point: a config key, the
    lifts, the draw, the indices, the f32 discovery's log (or the fp64
    evolve's log and time log) and D=3 tangent directions."""
    _, pcfg = configs(n_neurons=64, n_real=2, max_events=128)
    _, pp = params(sigma=0.1)
    Z = torch.tensor([INITIAL_GUESS], dtype=torch.float64)
    v0, s0 = (x.contiguous() for x in pt.lift(pcfg, pp, pt.z_to_u(Z)))
    ii = pt.initial_spike_indices(pcfg, Z).contiguous()
    beta = pt.beta_from_noise(pcfg, pp, torch.tensor(jax_noise(2, 64)))
    times = None
    if logged:
        res, sched, times = autodiff.direct_schedule(
            pcfg, evolve_ensemble_batched, v0, s0, beta, ii)
        n_ev = res.n_events
    else:
        sched, n_ev = compute_schedule(pcfg, v0, s0, beta, ii, n_real=2)
    gen = torch.Generator().manual_seed(3)
    dv, ds = (torch.randn(3, 1, 64, generator=gen, dtype=torch.float64)
              for _ in range(2))
    dp = torch.zeros(3, 1, dtype=torch.float64)
    return (pcfg, evolve_cuda.config_key(pcfg), v0, s0, beta, ii, sched,
            n_ev, times, dv, ds, dp)


@pytest.mark.parametrize("op", ["evolve", "evolve_logged", "replay",
                                "replay_tangent", "replay_tangent_logged"])
def test_opcheck(op):
    """torch.library.opcheck of K1, K2 and K2T's ops at N=64, R=2 (their
    CPU kernels: schema, fake kernel, autograd registration, tracing)."""
    (_, key, v0, s0, beta, ii, sched, n_ev, times, dv, ds,
     dp) = small_case(op.endswith("logged"))
    if op.startswith("evolve"):
        logged = op == "evolve_logged"
        fn = evolve_cuda.evolve_op
        args = (key, v0, s0, beta, ii, 2, 128 if logged else 0, logged,
                logged)
    elif op == "replay":
        fn, args = replay_cuda.replay_op, (key, sched, n_ev, v0, s0, beta,
                                           ii, 2)
    else:
        fn = replay_cuda.replay_tangent_op
        args = (key, sched, n_ev, v0, s0, beta, ii, dv, ds, None, dp, times,
                2)
    result = torch.library.opcheck(fn, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_cpu_kernels_are_the_plain_versions():
    """On CPU tensors each op runs its plain version: equal outputs."""
    (pcfg, key, v0, s0, beta, ii, sched, n_ev, times, dv, ds,
     dp) = small_case(True)
    out = torch.ops.atorch.evolve(key, v0, s0, beta, ii, 2, 128, True, True)
    t = torch.zeros(2, 128, dtype=torch.float64)
    fb = torch.zeros(2, dtype=torch.int32)
    res, log = evolve_ensemble_batched(pcfg, v0, s0, beta, ii, 128,
                                       fallbacks=fb, n_real=2,
                                       event_times=t)
    for a, b in zip(out, (*res, log, t, fb)):
        assert torch.equal(a, b)
    got = torch.ops.atorch.replay(key, sched, n_ev, v0, s0, beta, ii, 2)
    for a, b in zip(got, replay_events(pcfg, sched, n_ev, v0, s0, beta, ii,
                                       n_real=2)):
        assert torch.equal(a, b)
    got = torch.ops.atorch.replay_tangent(key, sched, n_ev, v0, s0, beta, ii,
                                          dv, ds, None, dp, times, 2)
    res, d_last, d_crossed = replay_events_tangent(
        pcfg, sched, n_ev, v0, s0, beta, ii, dv, ds, None, dp, n_real=2,
        times=times)
    for a, b in zip(got, (*res, d_last, d_crossed)):
        assert torch.equal(a, b)


def test_vmap_folds_directions_into_one_tangent_replay(monkeypatch):
    """A vmap over the tangent replay's directions is ONE call of the op
    with D = the batch (its CPU kernel counted), equal to the call with
    all D directions at once; a batch over a primal input is refused."""
    (pcfg, _, v0, s0, beta, ii, sched, n_ev, times, dv, ds,
     dp) = small_case(True)
    calls = []

    def counted(*a, **kw):
        calls.append(a[7].shape[0])
        return replay_events_tangent(*a, **kw)
    monkeypatch.setattr(replay_cuda, "replay_events_tangent", counted)
    whole = replay_cuda.replay_tangent(pcfg, sched, n_ev, v0, s0, beta, ii,
                                       dv, ds, None, dp, n_real=2,
                                       times=times)
    got = torch.func.vmap(lambda a, b: replay_cuda.replay_tangent(
        pcfg, sched, n_ev, v0, s0, beta, ii, a[None], b[None], None,
        dp[:1], n_real=2, times=times)[1][0])(dv, ds)
    assert calls == [3, 3]
    assert torch.equal(got, whole[1])
    with pytest.raises(NotImplementedError, match="v0"):
        torch.func.vmap(lambda v: replay_cuda.replay_tangent(
            pcfg, sched, n_ev, v[None], s0, beta, ii, dv, ds, None, dp,
            n_real=2, times=times)[1])(v0.expand(2, -1))


@pytest.mark.parametrize("backend", ["torch", "replay"])
def test_jacfwd_runs_one_tangent_replay_and_no_extra_evolve(monkeypatch,
                                                            backend):
    """Without a tangent the map's evolve is the call it was (no log, no
    time log, no tangent replay); under jacfwd the evolve runs once with
    its log (the direct backend: and its time log) and the tangent replay
    once, for all three columns."""
    evolves, tangents = [], []
    real_select = emap.select_evolve

    def select(backend_, device):
        fn = real_select(backend_, device)

        def spy(*a, **kw):
            evolves.append((kw.get("record_schedule", 0),
                            kw.get("event_times") is not None))
            return fn(*a, **kw)
        return spy
    real_tangent = replay_cuda.replay_events_tangent

    def counted(*a, **kw):
        tangents.append(a[7].shape[0])
        return real_tangent(*a, **kw)
    monkeypatch.setattr(emap, "select_evolve", select)
    monkeypatch.setattr(replay_cuda, "replay_events_tangent", counted)
    F = residual(backend, n_real=2)
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    F(Z)
    F(torch.stack([Z, Z + 1e-3]))
    assert tangents == []
    if backend == "torch":
        assert evolves == [(0, False), (0, False)]
        evolves.clear()
        torch.func.jacfwd(F)(Z)
        assert len(evolves) == 1 and evolves[0][0] > 0 and evolves[0][1]
    else:
        torch.func.jacfwd(F)(Z)
    assert tangents == [3]


def test_newton_exact_mode_on_a_composite_callable_matches_jax():
    """newton_solve(fd_mode="exact") on a plain callable built on the map
    (no value_and_jacobian: jacfwd_cols) converges, as the JAX exact-mode
    solve of the same composite does, to its solution within 1e-9."""
    jcfg, pcfg = configs(n_neurons=N, n_real=R)
    jp, pp = params(sigma=0.1)
    jF = jx.make_residual_fn(jcfg, jp, KEY, evolve_backend="xla")
    z_shift = np.asarray(Z_REF)
    ncfg = dict(tolerance=1e-10, max_iterations=10, fd_mode="exact")
    want = jax.jit(lambda z: jx.newton_solve(
        lambda y: jF(y) + 0.05 * (y - z_shift) ** 2, z,
        jx.NewtonConfig(**ncfg)))(jnp.asarray(INITIAL_GUESS, jnp.float64))
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                            noise=torch.tensor(jax_noise(R, N)))
    shift = torch.tensor(Z_REF, dtype=torch.float64)
    got = pt.newton_solve(lambda y: F(y) + 0.05 * (y - shift) ** 2,
                          torch.tensor(INITIAL_GUESS, dtype=torch.float64),
                          pt.NewtonConfig(**ncfg))
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(to_numpy(got.solution),
                               np.asarray(want.solution), rtol=0, atol=1e-9)
