"""The port's binding of the native fp64 oracle (``oracle.py``, built from
``native/edmap_oracle.cpp`` into ``build/oracle/``) against the JAX
package's binding and against the port's own f64 map, mirroring
``tests/test_oracle.py:27-81``: at sigma = 0 the two independently written
maps agree to fp64 rounding and the two Newton solvers land on one fixed
point."""

import shutil

import numpy as np
import pytest
import torch

from torch_parity import INITIAL_GUESS, configs, params
import armadillocudalinearinterpolation_torch as pt

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable")

from armadillocudalinearinterpolation_tpu import oracle as jax_oracle  # noqa: E402
from armadillocudalinearinterpolation_torch import oracle  # noqa: E402

Z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)


@pytest.fixture(scope="module")
def case():
    """``tests/conftest.py``'s fixtures: N=512, R=4, f64, beta 13.0589,
    sigma 0, the Driver.cu guess."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    jp, pp = params(sigma=0.0)
    return jcfg, pcfg, jp, pp


@pytest.mark.parametrize("sigma, seed", [(0.0, 0), (0.3, 7)])
def test_binding_equals_the_jax_binding(case, sigma, seed):
    """Same source, same flags, same compiler: the two bindings' residuals
    are equal bit for bit, with and without heterogeneity."""
    jcfg, pcfg, _, _ = case
    jp, pp = params(sigma=sigma)
    want = jax_oracle.compute_f(jcfg, jp, np.asarray(INITIAL_GUESS),
                                seed=seed)
    got = oracle.compute_f(pcfg, pp, Z, seed=seed)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_map_matches_the_oracle_at_sigma_zero(case):
    """sigma = 0: the port's f64 map (the plain evolve on the CPU) against
    the oracle at 1e-12, with the restricted positions and accept flags."""
    _, pcfg, _, pp = case
    beta = torch.full((pcfg.n_real, pcfg.n_neurons), 13.0589,
                      dtype=torch.float64)
    f, d = pt.event_driven_map(pcfg, pp, beta, Z, with_diagnostics=True)
    f_cpp, pos, acc = oracle.compute_f(pcfg, pp, Z, with_diagnostics=True)
    torch.testing.assert_close(f, f_cpp, rtol=0, atol=1e-12)
    torch.testing.assert_close(d.positions, pos, rtol=0, atol=1e-12)
    assert torch.equal(d.evolve.accept, acc)


def test_newton_solvers_reach_one_fixed_point(case):
    _, pcfg, _, pp = case
    res_cpp = oracle.newton_solve(pcfg, pp, Z, tol=1e-10, max_iterations=15,
                                  fd_eps=1e-7)
    assert res_cpp["converged"]
    beta = torch.full((pcfg.n_real, pcfg.n_neurons), 13.0589,
                      dtype=torch.float64)
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu", beta=beta)
    res = pt.newton_solve(F, Z, pt.NewtonConfig(
        tolerance=1e-10, max_iterations=15, fd_epsilon=1e-7))
    assert res.converged
    torch.testing.assert_close(res_cpp["solution"], res.solution, rtol=0,
                               atol=1e-10)


def test_seeded_heterogeneity_is_deterministic(case):
    _, pcfg, _, _ = case
    _, pp = params(sigma=0.3)
    fa = oracle.compute_f(pcfg, pp, Z, seed=7)
    fb = oracle.compute_f(pcfg, pp, Z, seed=7)
    fc = oracle.compute_f(pcfg, pp, Z, seed=8)
    assert torch.equal(fa, fb)
    assert (fa != fc).any()


def test_thread_count_invariant(case):
    """Per-realisation seeding: the result does not depend on the pool."""
    _, pcfg, _, _ = case
    _, pp = params(sigma=0.3)
    assert torch.equal(oracle.compute_f(pcfg, pp, Z, seed=3, n_threads=1),
                       oracle.compute_f(pcfg, pp, Z, seed=3, n_threads=4))


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(oracle.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        oracle.build()
