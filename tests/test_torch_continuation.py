"""Port parity of pseudo-arclength continuation: the tangents, the arc row
of the extended residual, three exact-corrector steps of continue_branch
against the JAX walk (N=512, R=4, f64, sigma 0: RNG-free), the step
rejection and shrink, a sigma walk, and the frozen bordered corrector
against the exact one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, pt, to_numpy
from armadillocudalinearinterpolation_tpu.analysis import (
    continuation as jcont)
from armadillocudalinearinterpolation_torch.analysis import continuation
from armadillocudalinearinterpolation_torch.model.emap import sample_noise

KEY = jax.random.PRNGKey(0)
# the converged fixed point at N=512 (tests/test_continuation.py)
Z_ROOT = (0.32623663, 0.71936722, 1.36899475)
WALK_ATOL = 1e-7


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    noise = torch.tensor(np.asarray(jax.random.normal(
        KEY, (4, 512), dtype=jnp.float64)))
    return jcfg, pcfg, noise


def test_initial_and_next_tangent():
    t0 = continuation.initial_tangent(3, 1.0)
    assert t0.shape == (4,)
    np.testing.assert_allclose(to_numpy(t0), [0, 0, 0, 1])
    y0 = torch.zeros(4, dtype=torch.float64)
    y1 = torch.tensor([0.0, 0.0, 0.0, -0.5], dtype=torch.float64)
    t1 = continuation.next_tangent(y1, y0, t0)
    want = jcont.next_tangent(jnp.asarray(y1), jnp.asarray(y0),
                              jnp.asarray(t0))
    np.testing.assert_allclose(to_numpy(t1), np.asarray(want), rtol=1e-15)
    assert float(t1 @ t0) > 0


@pytest.mark.parametrize("param", ["beta", "sigma"])
def test_extended_residual_arc_row(setup, param):
    """At ds = 0 and y = y_prev the arc row vanishes; the map rows equal
    the map at that parameter, and the exact bordered Jacobian's last row
    is the tangent."""
    _, pcfg, noise = setup
    fixed = 0.0 if param == "beta" else 13.0589
    G = continuation.make_extended_residual(pcfg, noise, fixed, param=param)
    y = torch.tensor(Z_ROOT + ((13.0589 if param == "beta" else 0.0),),
                     dtype=torch.float64)
    t = continuation.initial_tangent(3, 1.0)
    ds = torch.tensor(0.0, dtype=torch.float64)
    g = G(y, y, t, ds)
    assert g.shape == (4,) and float(g[-1]) == 0.0
    F = pt.make_residual_fn(pcfg, pt.MapParams.create(13.0589, 0.0,
                                                      dtype="float64"),
                            0, device="cpu", noise=noise)
    assert torch.equal(g[:3], F(y[:3]))
    g2, J = G.value_and_jacobian(y, y, t, ds)
    assert torch.equal(g2, g) and J.shape == (4, 4)
    assert torch.equal(J[-1], t)


@pytest.fixture(scope="module")
def walks(setup):
    jcfg, pcfg, noise = setup
    want = jcont.continue_branch(jcfg, KEY, jnp.asarray(Z_ROOT, jnp.float64),
                                 13.0589, ds=0.3, n_steps=3)
    got = continuation.continue_branch(
        pcfg, noise, torch.tensor(Z_ROOT, dtype=torch.float64), 13.0589,
        ds=0.3, n_steps=3)
    return got, want


def test_three_steps_match_jax(walks):
    """Three exact-corrector steps from the fixed point: the same accepted
    points as the JAX walk within 1e-7, beta and c increasing."""
    got, want = walks
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.converged and a.residual_norm < 1e-8
        np.testing.assert_allclose(to_numpy(a.y), np.asarray(b.y), rtol=0,
                                   atol=WALK_ATOL)
        np.testing.assert_allclose(to_numpy(a.tangent), np.asarray(b.tangent),
                                   rtol=0, atol=1e-6)
    betas = [float(s.y[-1]) for s in got]
    assert betas[0] > 13.0589 and betas == sorted(betas)
    assert [float(s.y[0]) for s in got] == sorted(float(s.y[0]) for s in got)


def test_step_rejection_and_shrink(setup):
    """An absurd step fails the corrector: the walk retries at half the
    step down to min_ds (observed through the corrector's calls) instead
    of emitting an unconverged point; whatever it accepts is converged and
    finite."""
    _, pcfg, noise = setup
    ncfg = pt.NewtonConfig(tolerance=1e-9, max_iterations=3, fd_mode="exact",
                           divergence_factor=1e3)
    inner = continuation.make_arclength_step(pcfg, noise, 0.0, "beta", ncfg)
    seen = []

    def step(y, t, ds):
        seen.append(ds)
        return inner(y, t, ds)

    steps = continuation.continue_branch(
        pcfg, noise, torch.tensor(Z_ROOT, dtype=torch.float64), 13.0589,
        ds=50.0, n_steps=1, ncfg=ncfg, step=step, min_ds=6.25)
    assert seen == [50.0, 25.0, 12.5, 6.25]
    for s in steps:
        assert s.converged and bool(torch.isfinite(s.y).all())


def test_sigma_walk(setup):
    """Continuation in the heterogeneity at fixed beta: sigma rises from 0
    over two exact steps, every point converged."""
    _, pcfg, noise = setup
    steps = continuation.continue_branch(
        pcfg, noise, torch.tensor(Z_ROOT, dtype=torch.float64), 13.0589,
        sigma=0.0, param="sigma", ds=0.2, n_steps=2)
    assert len(steps) == 2
    sigmas = [float(s.y[-1]) for s in steps]
    assert sigmas[0] > 0.0 and sigmas == sorted(sigmas)
    assert all(s.residual_norm < 1e-8 for s in steps)


@pytest.mark.slow
def test_frozen_corrector_matches_exact(setup):
    """The frozen bordered corrector (one discovery and one 9-point frozen
    replay with a parameter point per point, per iteration) accepts the
    same points as the exact corrector on the replay map, to 5e-8 (the
    JAX test's bar, tests/test_continuation.py:119); frozen-fwd routes to
    it too."""
    _, pcfg, noise = setup
    Z0 = torch.tensor(Z_ROOT, dtype=torch.float64)
    ncfg_x = pt.NewtonConfig(tolerance=1e-9, max_iterations=12,
                             fd_mode="exact")
    ref = continuation.continue_branch(pcfg, noise, Z0, 13.0589, ds=0.3,
                                       n_steps=2, ncfg=ncfg_x,
                                       evolve_backend="replay")
    for mode, n in (("frozen", 2), ("frozen-fwd", 1)):
        froz = continuation.continue_branch(
            pcfg, noise, Z0, 13.0589, ds=0.3, n_steps=n,
            ncfg=pt.NewtonConfig(tolerance=1e-9, max_iterations=12,
                                 fd_mode=mode, fd_epsilon=1e-5))
        assert len(froz) == n
        for a, b in zip(froz, ref):
            assert a.converged and a.residual_norm <= 1e-9
            np.testing.assert_allclose(to_numpy(a.y), to_numpy(b.y),
                                       rtol=0, atol=5e-8)


def test_noise_draw_is_the_torch_generator_s(setup):
    """sample_noise with a seeded generator is what make_residual_fn draws
    from that seed: the walker CLI's noise and the sweep's draw agree."""
    _, pcfg, _ = setup
    pp = pt.MapParams.create(13.0589, 0.1, dtype="float64")
    noise = sample_noise(pcfg, torch.Generator().manual_seed(5))
    F = pt.make_residual_fn(pcfg, pp, 5, device="cpu")
    assert torch.equal(F.noise, noise)
    assert torch.equal(F.beta, pt.sample_beta(
        pcfg, pp, torch.Generator().manual_seed(5)))
