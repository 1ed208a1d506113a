"""Port parity of fold tracking: the Moore-Spence residual against the JAX
one at a near-fold point (its ``J v`` rows one exact tangent-replay
direction with ``v`` as the Z seed), the null direction, and (slow, as
tests/test_fold.py) the fold solve landing at beta = 20.3245.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, pt, to_numpy
from armadillocudalinearinterpolation_tpu.analysis import fold as jfold
from armadillocudalinearinterpolation_torch.analysis import fold

KEY = jax.random.PRNGKey(0)
# the near-fold point of the fast family (tests/test_fold.py)
Z_FOLD, BETA_FOLD = (0.59145, 0.57176, 10.07225), 20.32
# the J v rows are O(1): 1e-9 relative (measured 8e-10)
RESIDUAL_RTOL, RESIDUAL_ATOL = 1e-9, 1e-12


def setup_at(root_tol):
    """Both packages' configurations at ``root_tol`` and the JAX noise.
    At the default 1e-6 the direct evolve's roots are loose: the port's
    J v rows ride on that evolve's own event times (its time log), as the
    JAX jacfwd does (before the time log they sat 1.1e-4 apart, relative,
    here, and the fold solve wandered)."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=root_tol)
    noise = np.asarray(jax.random.normal(KEY, (4, 512), dtype=jnp.float64))
    return jcfg, pcfg, noise


@pytest.fixture(scope="module")
def setup():
    return setup_at(1e-12)


@pytest.mark.parametrize("root_tol, sigma", [
    (1e-12, 0.0), (1e-12, 0.1), (1e-6, 0.0), (1e-6, 0.1)],
    ids=["0.0", "0.1", "root_tol_1e-6-0.0", "root_tol_1e-6-0.1"])
def test_fold_residual_matches_jax(root_tol, sigma):
    """H(w, sigma) at one point, and at a stack of two points each at its
    own beta (the FD stencil's layout), against the JAX residual: 1e-9
    relative, at root_tol 1e-12 and at the default 1e-6."""
    jcfg, pcfg, noise = setup_at(root_tol)
    v = np.array([0.3, -0.5, 0.8])
    v = v / np.linalg.norm(v)
    w = np.concatenate([Z_FOLD, v, [BETA_FOLD]])
    w2 = w.copy()
    w2[-1] += 1e-3
    w2[0] += 1e-4
    Hj = jfold.make_fold_residual(jcfg, KEY)
    want = [np.asarray(Hj(jnp.asarray(x), sigma)) for x in (w, w2)]
    H = fold.make_fold_residual(pcfg, torch.tensor(noise))
    got = H(torch.tensor(w), sigma)
    stack = H(torch.tensor(np.stack([w, w2])), sigma)
    np.testing.assert_allclose(to_numpy(got), want[0], rtol=RESIDUAL_RTOL,
                               atol=RESIDUAL_ATOL)
    np.testing.assert_allclose(to_numpy(stack), np.stack(want),
                               rtol=RESIDUAL_RTOL, atol=RESIDUAL_ATOL)
    assert got.shape == (7,)


def test_null_direction_matches_jax():
    J = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.1], [0.5, 0.1, 0.2]])
    got = fold.null_direction(torch.tensor(J))
    want = jfold.null_direction(J)
    np.testing.assert_allclose(abs(got @ want), 1.0, rtol=1e-12)


def solve_fold_from_the_near_fold_point(pcfg, noise):
    """From the near-fold point with the exact Jacobian's null direction,
    central FD at 1e-6 to |H| <= 1e-6: the fold at beta 20.3245 within
    5e-3 (the JAX test's bars, tests/test_fold.py)."""
    noise = torch.tensor(noise)
    F = pt.make_residual_fn(pcfg, pt.MapParams.create(BETA_FOLD, 0.0,
                                                      dtype="float64"),
                            0, device="cpu", noise=noise)
    _, J = F.value_and_jacobian(torch.tensor(Z_FOLD, dtype=torch.float64))
    sv = np.linalg.svd(to_numpy(J))[1]
    assert sv[-1] < 0.1 < sv[-2]
    ncfg = pt.NewtonConfig(tolerance=1e-6, max_iterations=12,
                           fd_epsilon=1e-6, fd_mode="central")
    p = fold.solve_fold(pcfg, noise, Z_FOLD, fold.null_direction(J),
                        BETA_FOLD, 0.0, ncfg=ncfg)
    assert p.converged and abs(p.beta - 20.3245) < 5e-3
    assert p.residual_norm < 1e-6
    np.testing.assert_allclose(np.linalg.norm(p.v), 1.0, rtol=1e-9)


@pytest.mark.slow
def test_solve_fold_lands_on_the_fold(setup):
    _, pcfg, noise = setup
    solve_fold_from_the_near_fold_point(pcfg, noise)


@pytest.mark.slow
def test_solve_fold_lands_on_the_fold_at_the_default_root_tol():
    """The same solve at the ModelConfig default root_tol (1e-6), where
    tests/test_fold.py runs the JAX one."""
    _, pcfg, noise = setup_at(1e-6)
    assert pcfg.root_tol == pt.ModelConfig().root_tol
    solve_fold_from_the_near_fold_point(pcfg, noise)
