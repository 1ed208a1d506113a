"""Port parity of the model blocks: coupling, lift, spike seeding, the
event-time pieces, restriction, the ensemble mean and residual assembly,
f64, against the JAX package at rtol = atol = 1e-12, on numpy-seeded
inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (INITIAL_GUESS, configs, jx, params, pt, to_jax,
                          to_numpy, to_torch)
from armadillocudalinearinterpolation_tpu.model import events as jev
from armadillocudalinearinterpolation_tpu.model.coupling import (
    coupling_row as jax_coupling_row)
from armadillocudalinearinterpolation_torch import interop
from armadillocudalinearinterpolation_torch.model import events as pev

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def both():
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    jp, pp = params(sigma=0.1)
    return jcfg, pcfg, jp, pp


@pytest.fixture(scope="module")
def lanes():
    """Numpy-seeded per-lane states that fire, do not fire, and have a
    negative synapse (the NaN-power path)."""
    rng = np.random.default_rng(0)
    v0 = rng.uniform(0.0, 0.99, 256)
    s0 = rng.uniform(-0.5, 5.0, 256)
    beta = 13.0589 + 0.1 * rng.standard_normal(256)
    return v0, s0, beta


def test_coupling_kernel_matches_jax(both):
    jcfg, pcfg, _, _ = both
    np.testing.assert_allclose(to_numpy(pt.coupling_kernel(pcfg)),
                               np.asarray(jx.coupling_kernel(jcfg)), **TOL)
    x = np.linspace(-3.0, 3.0, 101)
    np.testing.assert_allclose(
        to_numpy(pt.mexican_hat(torch.tensor(x), pcfg)),
        np.asarray(jx.mexican_hat(jnp.asarray(x), jcfg)), **TOL)


@pytest.mark.parametrize("j", [0, 1, 255, 256, 511])
def test_coupling_row_matches_jax(both, j):
    jcfg, pcfg, _, _ = both
    np.testing.assert_allclose(
        to_numpy(pt.coupling_row(pt.coupling_kernel(pcfg), j)),
        np.asarray(jax_coupling_row(jx.coupling_kernel(jcfg), jnp.int32(j))),
        **TOL)


@pytest.mark.parametrize("z", [INITIAL_GUESS, (0.33, 0.5, 1.7),
                               (0.29, 0.8, 1.2)])
def test_lift_matches_jax(both, z):
    jcfg, pcfg, jp, pp = both
    z = np.asarray(z)
    vj, sj = jx.lift(jcfg, jp, jx.z_to_u(jnp.asarray(z)))
    vp, sp = pt.lift(pcfg, pp, pt.z_to_u(torch.tensor(z)))
    np.testing.assert_allclose(to_numpy(vp), np.asarray(vj), **TOL)
    np.testing.assert_allclose(to_numpy(sp), np.asarray(sj), **TOL)


def test_lift_of_a_stack_is_the_lift_of_each_point(both):
    _, pcfg, _, pp = both
    Z = torch.tensor([INITIAL_GUESS, (0.33, 0.5, 1.7)], dtype=torch.float64)
    vs, ss = pt.lift(pcfg, pp, pt.z_to_u(Z))
    assert vs.shape == ss.shape == (2, pcfg.n_neurons)
    for p in range(2):
        v1, s1 = pt.lift(pcfg, pp, pt.z_to_u(Z[p]))
        assert torch.equal(vs[p], v1) and torch.equal(ss[p], s1)


@pytest.mark.parametrize("z", [INITIAL_GUESS, (0.33, 0.5, 1.7),
                               (0.3, 1.5, 0.4), (0.25, -0.3, 2.0)])
def test_initial_spike_indices_match_jax(both, z):
    jcfg, pcfg, _, _ = both
    got = pt.initial_spike_indices(pcfg, torch.tensor(z, dtype=torch.float64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        to_numpy(got),
        np.asarray(jx.initial_spike_indices(jcfg, jnp.asarray(z))))


def test_membrane_pieces_match_jax(both, lanes):
    jcfg, pcfg, _, _ = both
    v0, s0, beta = lanes
    t = np.random.default_rng(1).uniform(0.0, 2.0, v0.shape)
    for jf, pf in ((jev.membrane_fun, pev.membrane_fun),
                   (jev.membrane_dfun, pev.membrane_dfun)):
        np.testing.assert_allclose(
            to_numpy(pf(*map(torch.tensor, (t, v0, s0, beta)), pcfg)),
            np.asarray(jf(*map(jnp.asarray, (t, v0, s0, beta)), jcfg)), **TOL)
    dj = np.asarray(jev.fire_decision(*map(jnp.asarray, (v0, s0, beta)), jcfg))
    dp = to_numpy(pev.fire_decision(*map(torch.tensor, (v0, s0, beta)), pcfg))
    np.testing.assert_array_equal(dp, dj)
    assert dj.any() and not dj.all()


def test_event_time_matches_jax(both, lanes):
    jcfg, pcfg, _, _ = both
    v0, s0, beta = lanes
    tj = np.asarray(jx.event_time(*map(jnp.asarray, (v0, s0, beta)), jcfg))
    tp = to_numpy(pt.event_time(*map(torch.tensor, (v0, s0, beta)), pcfg))
    np.testing.assert_allclose(tp, tj, **TOL)
    assert (tp >= 100.0).any() and (tp < 100.0).any()


def test_restriction_and_mean_match_jax(both):
    jcfg, pcfg, _, _ = both
    rng = np.random.default_rng(2)
    R, M = 6, 3
    last_ind = rng.integers(200, 300, (R, M)).astype(np.int32)
    crossed_ind = last_ind + rng.integers(1, 5, (R, M)).astype(np.int32)
    last_time = rng.uniform(4.5, 5.0, (R, M))
    crossed_time = rng.uniform(5.0, 5.5, (R, M))
    accept = np.array([True, False, True, True, False, True])
    n_events = np.full(R, 400, np.int32)
    fields = (last_ind, last_time, crossed_ind, crossed_time, accept, n_events)
    from armadillocudalinearinterpolation_tpu.model.evolve import (
        EvolveResult as JaxEvolveResult)
    pos_j = jx.restrict_positions(
        jcfg, JaxEvolveResult(*map(jnp.asarray, fields)))
    pos_p = pt.restrict_positions(pcfg, pt.EvolveResult(*map(to_torch, fields)))
    np.testing.assert_allclose(to_numpy(pos_p), np.asarray(pos_j), **TOL)
    mj, cj = jx.masked_ensemble_mean(pos_j, jnp.asarray(accept))
    mp, cp = pt.masked_ensemble_mean(pos_p, torch.tensor(accept))
    np.testing.assert_allclose(to_numpy(mp), np.asarray(mj), **TOL)
    assert float(cp) == float(cj) == 4.0


def test_mean_over_no_accepted_realisation_is_nan():
    mean, count = pt.masked_ensemble_mean(torch.ones(3, 2),
                                          torch.zeros(3, dtype=torch.bool))
    assert float(count) == 0.0 and torch.isnan(mean).all()


def test_gauge_maps_and_residual_assembly_match_jax(both):
    jcfg, pcfg, _, _ = both
    z = np.asarray(INITIAL_GUESS)
    uj, up = jx.z_to_u(jnp.asarray(z)), pt.z_to_u(torch.tensor(z))
    np.testing.assert_array_equal(to_numpy(up), np.asarray(uj))
    np.testing.assert_array_equal(to_numpy(pt.u_to_z(up)), z)
    u_mean = np.random.default_rng(3).uniform(1.0, 2.0, 3)
    from armadillocudalinearinterpolation_tpu.model.emap import (
        assemble_residual as jax_assemble)
    from armadillocudalinearinterpolation_torch.model.emap import (
        assemble_residual as pt_assemble)
    np.testing.assert_allclose(
        to_numpy(pt_assemble(pcfg, up, torch.tensor(u_mean))),
        np.asarray(jax_assemble(jcfg, uj, jnp.asarray(u_mean))), **TOL)


def test_config_crosses_over_with_its_validation():
    jcfg = jx.ModelConfig(n_neurons=512, n_real=8, evolve_window=256,
                          dtype="float64")
    pcfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    assert isinstance(pcfg, pt.ModelConfig)
    assert pcfg.torch_dtype == torch.float64 and pcfg.dx == jcfg.dx
    np.testing.assert_allclose(to_numpy(pcfg.grid()), np.asarray(jcfg.grid()),
                               **TOL)
    ncfg = interop.config_from_fields(dataclasses.asdict(
        jx.NewtonConfig(tolerance=1e-8, fd_mode="central")))
    assert ncfg == pt.NewtonConfig(tolerance=1e-8, fd_mode="central")
    for bad in (dict(vr=0.1), dict(evolve_window=100), dict(n_real=0),
                dict(dtype="float16")):
        with pytest.raises(ValueError):
            pt.ModelConfig(**bad)


@pytest.mark.parametrize("knob", [dict(evolve_warm_start=True),
                                  dict(replay_exp_mode="cond"),
                                  dict(replay_jvp="f32")])
def test_config_from_fields_rejects_a_knob_left_out(knob):
    fields = dataclasses.asdict(jx.ModelConfig(n_neurons=512, **knob))
    with pytest.raises(ValueError, match=next(iter(knob))):
        interop.config_from_fields(fields)


def test_params_and_tensors_cross_over():
    pp = interop.params_from_numpy(np.float64(13.0589), 0.1, dtype="float32")
    assert pp.beta.dtype == torch.float32 and float(pp.sigma) == np.float32(0.1)
    a = np.arange(6.0).reshape(2, 3)[:, ::2]
    t = interop.tensor_from_numpy(a, "float32")
    assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(t), a)
    np.testing.assert_array_equal(np.asarray(to_jax(t)), a)
