"""Port parity of exact Jacobians at the default root tolerance (1e-6): the
direct backend's tangents ride on the trajectory that gives ``F``.

The direct evolve writes its time log (each event's ``dt`` as it took it,
Newton to ``root_tol``) beside its firing order, and the tangent replay
takes those times and differentiates them by the evolve's own IFT rule,
as JAX ``jacfwd`` does through its evolve.  Held here at the near-fold
point of ``tests/test_fold.py`` (N=512, R=4, f64, beta 20.32), where a
replay that polished its own roots sat 2.3e-4 (relative) off the JAX
Jacobian: the map's Jacobian against JAX ``jacfwd_cols`` through
``"xla"``, and the plain tangent replay with the time log against the JAX
evolve's ``jvp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, pt, to_numpy
import armadillocudalinearinterpolation_tpu as jx
from armadillocudalinearinterpolation_tpu.model.coupling import (
    coupling_kernel)
from armadillocudalinearinterpolation_tpu.model.emap import (
    event_driven_map as jax_map)
from armadillocudalinearinterpolation_tpu.model.evolve import (
    evolve_ensemble as jax_evolve)
from armadillocudalinearinterpolation_tpu.solvers.newton import jacfwd_cols
from armadillocudalinearinterpolation_torch.model.evolve import (
    evolve_ensemble)
from armadillocudalinearinterpolation_torch.model.replay import (
    replay_events_tangent)

KEY = jax.random.PRNGKey(0)
Z_FOLD, BETA_FOLD, SIGMA = (0.59145, 0.57176, 10.07225), 20.32, 0.0
ROOT_TOL = 1e-6                       # the ModelConfig default
# the JAX test's bar for the map's Jacobian (tests/test_torch_exact.py;
# measured 2.8e-11 here, 1.5e-3 before the time log)
JACOBIAN_ATOL = 1e-7
# the time tangents against the JAX evolve's jvp, relative to the largest
# (measured 6.6e-12)
TANGENT_RTOL = 1e-10


def noise() -> np.ndarray:
    return np.asarray(jax.random.normal(KEY, (4, 512), dtype=jnp.float64))


@pytest.fixture(scope="module")
def jax_jacobian():
    """JAX jacfwd_cols through the "xla" evolve at the default root_tol,
    with the beta and sigma columns: (F, J (3, 5))."""
    jcfg, _ = configs(n_neurons=512, n_real=4, root_tol=ROOT_TOL)

    def G(y):
        return jax_map(jcfg, jx.MapParams(beta=y[3], sigma=y[4]), KEY,
                       y[:3], evolve_backend="xla")

    y = jnp.asarray(Z_FOLD + (BETA_FOLD, SIGMA), jnp.float64)
    return np.asarray(G(y)), np.asarray(jax.jit(jacfwd_cols(G))(y))


@pytest.mark.parametrize("param", [None, "beta", "sigma"])
def test_direct_jacobian_matches_jax_at_loose_roots(jax_jacobian, param):
    """The port's direct-backend Jacobian (the plain evolve's logs and the
    plain tangent replay) against JAX jacfwd through its direct evolve at
    root_tol 1e-6: atol 1e-7; F equal to the port's F(Z) bit for bit."""
    f_j, J_j = jax_jacobian
    _, pcfg = configs(n_neurons=512, n_real=4, root_tol=ROOT_TOL)
    F = pt.make_residual_fn(
        pcfg, pt.MapParams.create(BETA_FOLD, SIGMA, dtype="float64"), 0,
        device="cpu", noise=torch.tensor(noise()), evolve_backend="torch")
    Z = torch.tensor(Z_FOLD, dtype=torch.float64)
    f, J = F.value_and_jacobian(Z, param=param)
    assert torch.equal(f, F(Z))
    np.testing.assert_allclose(to_numpy(f), f_j, rtol=0, atol=1e-9)
    cols = {None: [0, 1, 2], "beta": [0, 1, 2, 3], "sigma": [0, 1, 2, 4]}
    np.testing.assert_allclose(to_numpy(J), J_j[:, cols[param]], rtol=0,
                               atol=JACOBIAN_ATOL)


def test_tangent_replay_with_time_log_matches_jax_evolve():
    """The plain evolve's firing order and time log, replayed with two
    tangents (a random lift direction; the beta axis), against the JAX
    "xla" evolve's jvp along the same directions at root_tol 1e-6: the
    primal times equal the evolve's bit for bit, the time tangents agree to
    1e-10 relative on the accepted rows."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=ROOT_TOL)
    f64 = torch.float64
    Z = torch.tensor(Z_FOLD, dtype=f64)[None]
    mp = pt.MapParams.create(BETA_FOLD, 0.0, dtype="float64")
    v0, s0 = pt.lift(pcfg, mp, pt.z_to_u(Z))
    ii = pt.initial_spike_indices(pcfg, Z)
    beta = torch.full((4, 512), BETA_FOLD, dtype=f64)
    gen = torch.Generator().manual_seed(5)
    dv = torch.zeros(2, 1, 512, dtype=f64)
    ds = torch.zeros_like(dv)
    dv[0] = 1e-2 * torch.randn(1, 512, generator=gen, dtype=f64)
    ds[0] = 1e-2 * torch.randn(1, 512, generator=gen, dtype=f64)
    dp = torch.tensor([[0.0], [1.0]], dtype=f64)

    E = 2048
    times = torch.empty(4, E, dtype=f64)
    res, sched = evolve_ensemble(pcfg, v0, s0, beta, ii, record_schedule=E,
                                 event_times=times)
    assert int(res.n_events.max()) <= E and bool(res.accept.any())
    res_t, d_last, d_crossed = replay_events_tangent(
        pcfg, sched, res.n_events, v0, s0, beta, ii, dv, ds,
        torch.ones(4, 512, dtype=f64), dp, times=times)
    for name in ("last_time", "crossed_time", "last_ind", "crossed_ind",
                 "accept"):
        assert torch.equal(getattr(res_t, name), getattr(res, name)), name

    w = coupling_kernel(jcfg)
    jv0, js0, jb = (jnp.asarray(to_numpy(x)) for x in (v0[0], s0[0], beta))
    jii = jnp.asarray(to_numpy(ii[0]))

    def times_of(v, s, b):
        out = jax_evolve(jcfg, w, v, s, b, jii)
        return out.last_time, out.crossed_time

    keep = to_numpy(res.accept)
    for d in range(2):
        _, (t_last, t_crossed) = jax.jvp(
            times_of, (jv0, js0, jb),
            (jnp.asarray(to_numpy(dv[d, 0])), jnp.asarray(to_numpy(ds[d, 0])),
             jnp.full_like(jb, float(dp[d, 0]))))
        want = np.concatenate([np.asarray(t_last)[keep],
                               np.asarray(t_crossed)[keep]])
        got = np.concatenate([to_numpy(d_last[d])[keep],
                              to_numpy(d_crossed[d])[keep]])
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TANGENT_RTOL * scale)
