"""Port parity of the solvers and the stability count: FD Jacobians, damped
and quasi Newton, the reference's iteration table, the 3x3 solve and the
eigenvalue criteria against the JAX package, and the whole slice (map ->
Newton -> stability) at f64, N=512, R=4, sigma=0.1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (INITIAL_GUESS, configs, jax_draw, jx, params, pt,
                          to_numpy)
from armadillocudalinearinterpolation_tpu.solvers.linalg import (
    solve_dense as jax_solve_dense)
from armadillocudalinearinterpolation_torch import interop
from armadillocudalinearinterpolation_torch.solvers.linalg import solve_dense

TOL = dict(rtol=1e-12, atol=1e-12)
# a forward or central difference divides last-bit differences of F (the two
# frameworks sum x @ A.T in different orders) by eps = 1e-4
FD_TOL = dict(rtol=0, atol=1e-10)
A = np.array([[3.0, 1.0, 0.5], [0.2, 2.0, -0.3], [0.1, -0.4, 1.5]])
B = np.array([1.0, -2.0, 0.5])


def smooth(x, mat, b):
    """A smooth 3-unknown residual with one root near the origin; takes one
    point ``(3,)`` or a stack ``(P, 3)``."""
    return x @ mat.T + 0.1 * x ** 3 - b


def F_torch(x):
    return smooth(x, torch.tensor(A), torch.tensor(B))


def F_jax(x):
    return smooth(x, jnp.asarray(A), jnp.asarray(B))


X0 = np.array([0.3, -0.2, 0.7])


@pytest.mark.parametrize("central", [False, True])
def test_fd_jacobians_match_jax(central):
    x = torch.tensor(X0)
    if central:
        got = pt.central_fd_jacobian(F_torch, x, 1e-4)
        ref = jx.solvers.newton.central_fd_jacobian(F_jax, jnp.asarray(X0),
                                                    1e-4)
    else:
        got = pt.fd_jacobian(F_torch, x, F_torch(x), 1e-4)
        ref = jx.fd_jacobian(F_jax, jnp.asarray(X0), F_jax(jnp.asarray(X0)),
                             1e-4)
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref), **FD_TOL)


def test_fd_jacobian_evaluates_one_stack():
    """n perturbed points go to F as one (n, n) stack, 2n for central."""
    shapes = []

    def F(x):
        shapes.append(tuple(x.shape))
        return F_torch(x)

    x = torch.tensor(X0)
    pt.fd_jacobian(F, x, F_torch(x), 1e-3)
    pt.central_fd_jacobian(F, x, 1e-3)
    assert shapes == [(3, 3), (6, 3)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(damping=0.5),
    dict(fd_mode="central"),
    dict(divergence_factor=1.5, damping=3.0),
    dict(jacobian0=A + 0.3 * np.eye(3)),
])
def test_newton_matches_jax_on_a_smooth_problem(kw):
    kw = dict(kw)
    j0 = kw.pop("jacobian0", None)
    ncfg = dict(tolerance=1e-11, max_iterations=12, fd_epsilon=1e-6, **kw)
    got = pt.newton_solve(F_torch, torch.tensor(X0), pt.NewtonConfig(**ncfg),
                          jacobian0=None if j0 is None else torch.tensor(j0))
    ref = jax.jit(lambda z: jx.newton_solve(
        F_jax, z, jx.NewtonConfig(**ncfg),
        jacobian0=None if j0 is None else jnp.asarray(j0)))(
            jnp.asarray(X0))
    assert got.converged == bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    np.testing.assert_allclose(to_numpy(got.residual_history),
                               np.asarray(ref.residual_history),
                               rtol=1e-6, atol=1e-13)
    # the over-damped run (damping 3) diverges, which amplifies last-bit
    # differences of F step by step
    np.testing.assert_allclose(to_numpy(got.solution),
                               np.asarray(ref.solution), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(to_numpy(got.jacobian),
                               np.asarray(ref.jacobian), rtol=1e-6,
                               atol=1e-8)


def test_unknown_and_exact_fd_modes_raise():
    """An unknown mode raises.  Exact mode on a plain callable (it has no
    value_and_jacobian), refused until the port had forward-mode AD, now
    takes jacfwd_cols and follows the JAX exact-mode solve: the same
    iterations, solution and Jacobian."""
    x = torch.tensor(X0)
    got = pt.newton_solve(F_torch, x, pt.NewtonConfig(fd_mode="exact",
                                                      tolerance=1e-12))
    ref = jx.newton_solve(F_jax, jnp.asarray(X0), jx.NewtonConfig(
        fd_mode="exact", tolerance=1e-12))
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    for a, b in ((got.solution, ref.solution), (got.jacobian, ref.jacobian)):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **TOL)
    with pytest.raises(ValueError, match="fd_mode"):
        pt.newton_solve(F_torch, x, pt.NewtonConfig(fd_mode="frozen"))


def test_live_table_is_the_references_format(capsys):
    ncfg = dict(tolerance=1e-10, max_iterations=8, fd_epsilon=1e-6)
    got = pt.newton_solve(F_torch, torch.tensor(X0),
                          pt.NewtonConfig(print_output=True, **ncfg))
    live = capsys.readouterr().out
    pt.print_iteration_table(got, pt.NewtonConfig(**ncfg))
    assert capsys.readouterr().out == live
    jx.solvers.newton.print_iteration_table(got, jx.NewtonConfig(**ncfg))
    assert capsys.readouterr().out == live
    assert "converged after" in live


def test_dense_solve_matches_jax_and_gives_nan_when_singular():
    b = np.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(
        to_numpy(solve_dense(torch.tensor(A), torch.tensor(b))),
        np.asarray(jax_solve_dense(jnp.asarray(A), jnp.asarray(b))), **TOL)
    sing = torch.tensor([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 1.0]])
    assert torch.isnan(solve_dense(sing, torch.ones(3))).all()


@pytest.mark.parametrize("ptype", ["FLOW", "MAP", "EQUATION_FREE"])
def test_stability_count_matches_jax(ptype):
    jac = np.array([[-0.5, 2.0, 0.0], [-2.0, -0.5, 0.0], [0.0, 0.0, 0.3]])
    got = pt.compute_eigenvalues(None, None, getattr(pt.ProblemType, ptype),
                                 jacobian=torch.tensor(jac))
    ref = jx.compute_eigenvalues(None, None, getattr(jx.ProblemType, ptype),
                                 jacobian=jnp.asarray(jac))
    np.testing.assert_allclose(np.sort_complex(got),
                               np.sort_complex(np.asarray(ref)), **TOL)
    assert pt.count_unstable(got, getattr(pt.ProblemType, ptype)) == int(
        jx.analysis.stability.count_unstable(
            np.asarray(ref), getattr(jx.ProblemType, ptype)))
    nan = torch.full((3, 3), float("nan"))
    assert np.isnan(pt.compute_eigenvalues(None, None, jacobian=nan)).all()


def test_criteria():
    assert pt.residual_norm_criterion(1e-4)(1e-4)
    assert not pt.residual_norm_criterion(1e-4)(2e-4)
    assert pt.relative_criterion(1e-2, 3.0)(0.03)
    assert not pt.relative_criterion(1e-2, 3.0)(0.031)


def test_slice_f64_matches_jax():
    """Driver.cu's program at f64, N=512, R=4, sigma=0.1, tolerance 1e-8,
    eps 1e-6, from its guess, on the JAX draw: both packages converge to the
    same fixed point (1e-8) with the same unstable count.  The JAX run
    takes 4 iterations to (0.32620969, 0.72045714, 1.37033187), 1 unstable
    eigenvalue."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    jp, pp = params(sigma=0.1)
    jn = jx.NewtonConfig(tolerance=1e-8, max_iterations=10, fd_epsilon=1e-6)
    pn = interop.config_from_fields(dataclasses.asdict(jn))
    z0 = np.asarray(INITIAL_GUESS)

    Fj = jx.make_residual_fn(jcfg, jp, jax.random.PRNGKey(0),
                             evolve_backend="xla")
    rj = jax.jit(lambda z: jx.newton_solve(Fj, z, jn))(jnp.asarray(z0))
    nj = int(jx.num_unstable_eigenvalues(
        Fj, rj.solution, jx.ProblemType.EQUATION_FREE, jacobian=rj.jacobian))

    Fp = pt.make_residual_fn(pcfg, pp, 0, device="cpu",
                             beta=interop.tensor_from_numpy(
                                 jax_draw(jcfg, jp)))
    rp = pt.newton_solve(Fp, torch.tensor(z0), pn)
    n_port = pt.num_unstable_eigenvalues(Fp, rp.solution,
                                      pt.ProblemType.EQUATION_FREE,
                                      jacobian=rp.jacobian)

    assert bool(rj.converged) and rp.converged
    assert rp.residual_norm <= 1e-8
    np.testing.assert_allclose(to_numpy(rp.solution), np.asarray(rj.solution),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(to_numpy(rp.solution),
                               [0.32620969, 0.72045714, 1.37033187],
                               rtol=0, atol=1e-7)
    assert n_port == nj == 1
