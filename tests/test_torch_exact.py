"""Port parity of exact Jacobians: the event time's IFT tangent, the plain
tangent replay (K2T's plain version), per-row rates in the plain evolve
and replay, the map's exact Jacobian on the direct backend against JAX
``jacfwd_cols`` through its ``"xla"`` evolve (N=512, R=4, f64, sigma 0.1,
the JAX noise fed to both), Newton's exact mode against the JAX solve, and
the staged solver's exact stage 2 on the direct evolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import INITIAL_GUESS, configs, params, pt, to_numpy
from armadillocudalinearinterpolation_tpu.model import events as jevents
from armadillocudalinearinterpolation_tpu.model.emap import (
    event_driven_map as jax_map)
from armadillocudalinearinterpolation_tpu.model.lift import lift as jlift
from armadillocudalinearinterpolation_tpu.solvers.newton import jacfwd_cols
from armadillocudalinearinterpolation_torch.model import events as pevents
from armadillocudalinearinterpolation_torch.model.evolve_batched import (
    evolve_ensemble_batched)
from armadillocudalinearinterpolation_torch.model.replay import (
    compute_schedule, replay_events, replay_events_tangent)
from armadillocudalinearinterpolation_torch.solvers import staged

KEY = jax.random.PRNGKey(0)
Z_REF = (0.3262, 0.7194, 1.3690)
# the JAX test's bars (tests/test_exact_jacobian.py:39-69): the same form
# to rounding, the shared form against central FD; the map's Jacobian
# against JAX jacfwd
SAME_FORM_RTOL = 1e-12
FD_RTOL, FD_ATOL = 1e-5, 1e-7
JACOBIAN_ATOL = 1e-7


def jax_noise(R, N, key=KEY) -> np.ndarray:
    """The JAX draw's noise: ``sample_beta`` is ``beta + sigma *`` this."""
    return np.asarray(jax.random.normal(key, (R, N), dtype=jnp.float64))


def firing_state(root_tol=1e-13):
    """A lifted state with firing and non-firing lanes (the JAX test's)."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=root_tol)
    jparams, _ = params(sigma=0.0)
    U = jnp.array([0.3262, 0.0, 0.7194, 1.3690], jnp.float64)
    v0, s0 = jlift(jcfg, jparams, U)
    beta = jnp.full_like(v0, 13.0589)
    return jcfg, pcfg, v0, s0, beta


@pytest.mark.parametrize("argi", [0, 1, 2], ids=["v0", "s0", "beta"])
def test_event_time_jvp_matches_jax(argi):
    """form="evolve" is JAX's custom JVP of event_time: the same root and
    the same partials, on firing lanes to 1e-12; 0 on non-firing lanes."""
    jcfg, pcfg, v0, s0, beta = firing_state()
    args = [v0, s0, beta]

    def f(x):
        a = list(args)
        a[argi] = x
        return jevents.event_time(*a, jcfg)

    _, want = jax.jvp(f, (args[argi],), (jnp.ones_like(args[argi]),))
    tv = [torch.tensor(np.asarray(x)) for x in args]
    tans = [torch.zeros_like(tv[0]) for _ in range(3)]
    tans[argi] = torch.ones_like(tv[0])
    tau, got = pevents.event_time_jvp(*tv, *tans, pcfg)
    dec = np.asarray(jevents.fire_decision(v0, s0, beta, jcfg))
    assert dec.any() and not dec.all()
    np.testing.assert_allclose(to_numpy(got)[dec], np.asarray(want)[dec],
                               rtol=SAME_FORM_RTOL, atol=0)
    assert np.all(to_numpy(got)[~dec] == 0.0)
    np.testing.assert_allclose(to_numpy(tau),
                               np.asarray(jevents.event_time(v0, s0, beta,
                                                             jcfg)),
                               rtol=SAME_FORM_RTOL)


@pytest.mark.parametrize("argi", [0, 1, 2], ids=["v0", "s0", "beta"])
def test_event_time_jvp_shared_form_matches_fd(argi):
    """form="shared" at the fp64-polished root of the replay's residual
    against central FD of that root (eps 1e-7), on lanes whose fire
    decision holds across the stencil."""
    _, pcfg, v0, s0, beta = firing_state()
    tv = [torch.tensor(np.asarray(x)) for x in (v0, s0, beta)]

    def root(a):
        t = pevents.event_time(*a, pcfg)
        for _ in range(3):
            e_t, e_b = torch.exp(-t), torch.exp(-a[2] * t)
            f = (a[0] * e_t + pcfg.drive * (1 - e_t)
                 + a[1] * (e_b - e_t) / (1 - a[2]) - pcfg.vth)
            fp = pevents.membrane_dfun(t, *a, pcfg)
            t = t - f / fp
        return t

    eps = 1e-7
    up, dn = list(tv), list(tv)
    up[argi] = tv[argi] + eps
    dn[argi] = tv[argi] - eps
    fd = (root(up) - root(dn)) / (2 * eps)
    tans = [torch.zeros_like(tv[0]) for _ in range(3)]
    tans[argi] = torch.ones_like(tv[0])
    _, got = pevents.event_time_jvp(*tv, *tans, pcfg, root=root(tv),
                                    form="shared")
    both = (pevents.fire_decision(*tv, pcfg) & pevents.fire_decision(
        *up, pcfg) & pevents.fire_decision(*dn, pcfg)).numpy()
    assert both.any()
    np.testing.assert_allclose(to_numpy(got)[both], to_numpy(fd)[both],
                               rtol=FD_RTOL, atol=FD_ATOL)


def replay_case(P=2, R=3, per_row=True):
    """The plain replay's inputs at N=512: P points around the guess, each
    at its own beta (per-row rates) or one shared draw, and D = 4
    directions (two Z seeds, the beta axis, the sigma axis).  The rates'
    tangents come as ``(bases, dp)``: the base of the beta axis (ones) and
    of the sigma axis (the noise), each with its ``(D, P)`` parameter
    tangents (one call of the tangent replay takes one base); ``db`` is the
    ``(D, P * R, N)`` tangent of the draw they make together, for FD."""
    _, pcfg = configs(n_neurons=512, n_real=R, root_tol=1e-12,
                      max_events=2048)
    f64 = torch.float64
    noise = torch.tensor(jax_noise(R, 512))
    mean = 13.0589 + 0.02 * torch.arange(P, dtype=f64)
    mp = pt.MapParams(beta=mean if per_row else mean[0],
                      sigma=torch.full((P,), 0.1, dtype=f64) if per_row
                      else torch.tensor(0.1, dtype=f64))
    beta = pt.beta_from_noise(pcfg, mp, noise)
    Z = (torch.tensor(INITIAL_GUESS, dtype=f64)[None]
         + 1e-3 * torch.arange(P, dtype=f64)[:, None])
    v0, s0 = pt.lift(pcfg, pt.MapParams(beta=mean[:, None], sigma=0.1),
                     pt.z_to_u(Z))
    ii = pt.initial_spike_indices(pcfg, Z)
    sched, n_ev = compute_schedule(pcfg, v0, s0, beta, ii, n_real=R)
    gen = torch.Generator().manual_seed(3)
    dv = torch.zeros(4, P, 512, dtype=f64)
    ds = torch.zeros_like(dv)
    dv[:2] = 1e-2 * torch.randn(2, P, 512, generator=gen, dtype=f64)
    ds[:2] = 1e-2 * torch.randn(2, P, 512, generator=gen, dtype=f64)
    bases = {}
    for d, base in ((2, torch.ones(R, 512, dtype=f64)), (3, noise)):
        dp = torch.zeros(4, P, dtype=f64)
        dp[d] = 1.0
        bases[d] = (base, dp)
    db = torch.zeros(4, P * R, 512, dtype=f64)
    db[2] = 1.0
    db[3] = noise.repeat(P, 1)
    return pcfg, sched, n_ev, v0, s0, beta, ii, dv, ds, bases, db, R


@pytest.fixture(scope="module")
def tangent_replay():
    """The case and the plain tangent replay of it, once with each base:
    ``{2: ..., 3: ...}`` (the beta axis' call serves the Z seeds too)."""
    case = replay_case()
    pcfg, sched, n_ev, v0, s0, beta, ii, dv, ds, bases, _, R = case
    return case, {d: replay_events_tangent(pcfg, sched, n_ev, v0, s0, beta,
                                           ii, dv, ds, *bases[d], n_real=R)
                  for d in bases}


def test_replay_tangent_primal_equals_replay(tangent_replay):
    (pcfg, sched, n_ev, v0, s0, beta, ii, *_, R), runs = tangent_replay
    res = runs[2][0]
    want = replay_events(pcfg, sched, n_ev, v0, s0, beta, ii, n_real=R)
    assert bool(res.accept.all())
    for name in want._fields:
        assert torch.equal(getattr(res, name), getattr(want, name)), name


@pytest.mark.parametrize("d", [0, 1, 2, 3],
                         ids=["z_seed_a", "z_seed_b", "beta", "sigma"])
def test_replay_tangent_matches_frozen_fd(tangent_replay, d):
    """Each direction's time tangents against central FD of the plain
    replay on the same frozen schedule (eps 1e-6): rtol 1e-5."""
    (pcfg, sched, n_ev, v0, s0, beta, ii, dv, ds, _, db, R), runs = \
        tangent_replay
    _, d_last, d_crossed = runs[3 if d == 3 else 2]
    eps = 1e-6
    rp = replay_events(pcfg, sched, n_ev, v0 + eps * dv[d], s0 + eps * ds[d],
                       beta + eps * db[d], ii, n_real=R)
    rm = replay_events(pcfg, sched, n_ev, v0 - eps * dv[d], s0 - eps * ds[d],
                       beta - eps * db[d], ii, n_real=R)
    for got, a, b in ((d_last[d], rp.last_time, rm.last_time),
                      (d_crossed[d], rp.crossed_time, rm.crossed_time)):
        np.testing.assert_allclose(to_numpy(got), to_numpy((a - b)
                                                           / (2 * eps)),
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("which", ["evolve", "replay"])
def test_per_row_rates_equal_a_loop_over_points(which):
    """(P * R, N) rates with n_real=R: the plain windowed evolve and the
    plain replay equal one call per point with that point's (R, N)."""
    pcfg, sched, n_ev, v0, s0, beta, ii, *_, R = replay_case(P=3, R=2)
    pcfg = pcfg.with_(evolve_window=128)
    if which == "evolve":
        got = evolve_ensemble_batched(pcfg, v0, s0, beta, ii, n_real=R)
        parts = [evolve_ensemble_batched(pcfg, v0[p:p + 1], s0[p:p + 1],
                                         beta[p * R:(p + 1) * R],
                                         ii[p:p + 1]) for p in range(3)]
    else:
        got = replay_events(pcfg, sched, n_ev, v0, s0, beta, ii, n_real=R)
        parts = [replay_events(pcfg, sched[p * R:(p + 1) * R],
                               n_ev[p * R:(p + 1) * R], v0[p:p + 1],
                               s0[p:p + 1], beta[p * R:(p + 1) * R],
                               ii[p:p + 1]) for p in range(3)]
    for name in got._fields:
        assert torch.equal(getattr(got, name), torch.cat(
            [getattr(x, name) for x in parts])), name


@pytest.fixture(scope="module")
def jax_jacobian():
    """JAX jacfwd_cols through the "xla" evolve at N=512, R=4, sigma 0.1
    (root_tol 1e-13, as tests/test_exact_jacobian.py), with the beta and
    sigma columns: (F, J (3, 5))."""
    jcfg, _ = configs(n_neurons=512, n_real=4, root_tol=1e-13)

    def G(y):
        return jax_map(jcfg, jax.tree.map(jnp.asarray, type(
            params()[0])(beta=y[3], sigma=y[4])), KEY, y[:3],
            evolve_backend="xla")

    y = jnp.asarray(Z_REF + (13.0589, 0.1), jnp.float64)
    return np.asarray(G(y)), np.asarray(jax.jit(jacfwd_cols(G))(y))


@pytest.mark.parametrize("param", [None, "beta", "sigma"])
def test_exact_jacobian_matches_jax_direct(jax_jacobian, param):
    """The port's direct-backend Jacobian (the plain fp64 evolve's log and
    the plain tangent replay) against JAX jacfwd through its direct evolve,
    with the same noise: atol 1e-7 (measured gap ~1e-9), and F equal to the
    port's own F(Z) bit for bit."""
    f_j, J_j = jax_jacobian
    _, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-13)
    _, pp = params(sigma=0.1)
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                            noise=torch.tensor(jax_noise(4, 512)),
                            evolve_backend="torch")
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    f, J = F.value_and_jacobian(Z, param=param)
    assert torch.equal(f, F(Z))
    np.testing.assert_allclose(to_numpy(f), f_j, rtol=0, atol=1e-9)
    cols = {None: [0, 1, 2], "beta": [0, 1, 2, 3], "sigma": [0, 1, 2, 4]}
    np.testing.assert_allclose(to_numpy(J), J_j[:, cols[param]], rtol=0,
                               atol=JACOBIAN_ATOL)


@pytest.mark.parametrize("param", [None, "beta", "sigma"])
def test_exact_jacobian_replay_backend_matches_jax_direct(jax_jacobian,
                                                          param):
    """The port's replay-backend Jacobian (the f32 discovery's log, which
    here is the JAX discovery's order: the port's later horizon changes no
    event before T) against JAX jacfwd through its direct evolve: atol 1e-7
    (measured ~8e-12).  The JAX df64 replay's own jacfwd sits 2.2e-5 off
    both (test below), inside the 1e-4 its own suite holds it to."""
    f_j, J_j = jax_jacobian
    _, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-13)
    _, pp = params(sigma=0.1)
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                            noise=torch.tensor(jax_noise(4, 512)),
                            evolve_backend="replay")
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    f, J = F.value_and_jacobian(Z, param=param)
    assert torch.equal(f, F(Z))
    np.testing.assert_allclose(to_numpy(f), f_j, rtol=0, atol=1e-9)
    cols = {None: [0, 1, 2], "beta": [0, 1, 2, 3], "sigma": [0, 1, 2, 4]}
    np.testing.assert_allclose(to_numpy(J), J_j[:, cols[param]], rtol=0,
                               atol=JACOBIAN_ATOL)


@pytest.mark.slow
def test_exact_jacobian_replay_backend_matches_jax_replay():
    """Against JAX jacfwd through its df64 replay (90 s on the CPU; the
    JAX suite marks its replay jacfwd test slow too), at the JAX suite's
    own bar for that Jacobian (tests/test_replay.py:271: 1e-4)."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-13)
    import armadillocudalinearinterpolation_tpu as jx

    def G(y):
        return jax_map(jcfg, jx.MapParams(beta=y[3], sigma=jnp.asarray(
            0.1, jnp.float64)), KEY, y[:3], evolve_backend="replay")

    want = np.asarray(jax.jit(jacfwd_cols(G))(
        jnp.asarray(Z_REF + (13.0589,), jnp.float64)))
    _, pp = params(sigma=0.1)
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                            noise=torch.tensor(jax_noise(4, 512)),
                            evolve_backend="replay")
    _, J = F.value_and_jacobian(torch.tensor(Z_REF, dtype=torch.float64),
                                param="beta")
    np.testing.assert_allclose(to_numpy(J), want, rtol=0, atol=1e-4)


def test_exact_mode_refuses_float32_and_plain_callables():
    """The f32 map's exact Jacobian is refused.  A plain callable, refused
    until the port had forward-mode AD, now takes its Jacobian from
    ``jacfwd_cols``, as the JAX solver does: ``z * z - 2`` solves to
    sqrt(2)."""
    _, pcfg = configs(dtype="float32", n_neurons=512, n_real=2)
    _, pp = params(sigma=0.1, dtype="float32")
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        F.value_and_jacobian(torch.tensor(Z_REF, dtype=torch.float32))
    res = pt.newton_solve(lambda z: z * z - 2.0,
                          torch.ones(1, dtype=torch.float64),
                          pt.NewtonConfig(fd_mode="exact", tolerance=1e-12))
    assert res.converged
    assert float(res.solution[0]) == pytest.approx(2.0 ** 0.5, abs=1e-12)
    assert float(res.jacobian[0, 0]) == pytest.approx(2.0 * 2.0 ** 0.5,
                                                      abs=1e-6)


def test_newton_exact_mode_matches_jax():
    """newton_solve(fd_mode="exact") converges quadratically from the
    Driver.cu guess (the JAX test's bar: |F| < 1e-10, the last step gains
    more than 3 digits) to the JAX exact-mode solution within 1e-9."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-13)
    jp, pp = params(sigma=0.0)
    ncfg = pt.NewtonConfig(tolerance=1e-10, max_iterations=10,
                           fd_mode="exact")
    import armadillocudalinearinterpolation_tpu as jx
    jF = jx.make_residual_fn(jcfg, jp, KEY, evolve_backend="xla")
    want = jax.jit(lambda z: jx.newton_solve(jF, z, jx.NewtonConfig(
        tolerance=1e-10, max_iterations=10, fd_mode="exact")))(
            jnp.asarray(INITIAL_GUESS, jnp.float64))
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                            noise=torch.tensor(jax_noise(4, 512)))
    got = pt.newton_solve(F, torch.tensor(INITIAL_GUESS,
                                          dtype=torch.float64), ncfg)
    assert got.converged and got.residual_norm < 1e-10
    h = to_numpy(got.residual_history)
    assert h[got.iterations - 1] / max(h[got.iterations], 1e-16) > 1e3
    np.testing.assert_allclose(to_numpy(got.solution),
                               np.asarray(want.solution), rtol=0, atol=1e-9)


def test_staged_direct_backend_defaults_to_exact():
    """On the direct evolve the staged recipe's stage 2 is exact (budget
    8, 0.9 x tolerance, as the JAX default), and the solve converges at
    N=512, R=4, sigma 0 (RNG-free)."""
    _, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-6)
    got = staged._resolve_staged(pcfg, 1e-8, None, None, None, "torch")
    assert (got[3].fd_mode, got[3].max_iterations) == ("exact", 8)
    assert got[3].tolerance == pytest.approx(0.9e-8)
    _, pp = params(sigma=0.0)
    beta = torch.full((4, 512), 13.0589, dtype=torch.float64)
    res = pt.newton_solve_staged(pcfg, pp, torch.tensor(INITIAL_GUESS),
                                 beta=beta, tolerance=1e-8,
                                 evolve_backend="torch")
    assert res.converged and res.residual_norm <= 1e-8
    F = pt.make_residual_fn(pcfg.with_(root_tol=1e-12), pp, 0, device="cpu",
                            beta=beta, evolve_backend="torch")
    assert float(torch.linalg.vector_norm(F(res.solution))) <= 1e-8


@pytest.mark.parametrize("fault", ["accept", "slot"])
def test_direct_jacobian_refuses_a_replay_of_another_outcome(monkeypatch,
                                                             fault):
    """On a direct backend J comes from the tangent replay of the fp64
    evolve's log: a replay that accepts another row, or records another
    trajectory slot on an accepted row, than the evolve did is refused
    (the tangent replay's outcome is altered here to force it)."""
    from armadillocudalinearinterpolation_torch.model import emap
    _, pcfg = configs(n_neurons=512, n_real=2, root_tol=1e-12)
    _, pp = params(sigma=0.1)
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                            noise=torch.tensor(jax_noise(2, 512)),
                            evolve_backend="torch")
    Z = torch.tensor(Z_REF, dtype=torch.float64)
    select = emap.select_replay_tangent

    def altered(device):
        tangent = select(device)

        def run(*a, **kw):
            res, d_last, d_crossed = tangent(*a, **kw)
            assert bool(res.accept[0])
            if fault == "accept":
                accept = res.accept.clone()
                accept[0] = False
                res = res._replace(accept=accept)
            else:
                last = res.last_ind.clone()
                last[0, 0] = (last[0, 0] + 1) % pcfg.n_neurons
                res = res._replace(last_ind=last)
            return res, d_last, d_crossed
        return run

    F.value_and_jacobian(Z)
    monkeypatch.setattr(emap, "select_replay_tangent", altered)
    with pytest.raises(pt.JacobianUnavailable,
                       match="another discrete outcome"):
        F.value_and_jacobian(Z)
    # exact Newton stops there, not converged, after no step
    res = pt.newton_solve(F, Z + 1e-3, pt.NewtonConfig(fd_mode="exact"))
    assert not res.converged and res.iterations == 0
