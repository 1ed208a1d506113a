"""Port parity of branch enumeration and boundary tracking: ``is_known``
in the diagram plane against the JAX function, the beta-pinned bracket
probe of ``_verify_bracket`` (tests/test_boundary.py:20), and (slow, as
the JAX suite) the sigma = 0 boundary at beta* = 16.0144.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, pt
from armadillocudalinearinterpolation_tpu.analysis import (
    branches as jbranches)
from armadillocudalinearinterpolation_torch.analysis import (boundary,
                                                             branches)

KEY = jax.random.PRNGKey(0)
Z0 = (0.32623663, 0.71936722, 1.36899475)


@pytest.fixture(scope="module")
def setup():
    _, pcfg = configs(n_neurons=512, n_real=4)
    noise = torch.tensor(np.asarray(jax.random.normal(
        KEY, (4, 512), dtype=jnp.float64)))
    return pcfg, noise


def test_is_known_diagram_plane():
    """The JAX test's cases, and agreement with the JAX function on random
    points and tolerances."""
    known = [np.array([13.0, 0.33])]
    assert branches.is_known(np.array([0.33, 0.70, 1.37, 13.0]), known,
                             tol=0.05)
    assert branches.is_known(np.array([0.33, 9.90, 9.99, 13.01]), known,
                             tol=0.05)
    assert not branches.is_known(np.array([0.45, 0.70, 1.37, 13.0]), known,
                                 tol=0.05)
    assert not branches.is_known(np.array([0.33, 0.70, 1.37, 14.0]), known,
                                 tol=0.05)
    assert not branches.is_known(np.array([0.33, 0.70, 1.37, 13.0]), [],
                                 tol=0.05)
    rng = np.random.default_rng(0)
    pts = [rng.uniform(0, 1, 2) for _ in range(5)]
    for _ in range(50):
        y, tol = rng.uniform(0, 1, 4), rng.uniform(0.01, 0.5)
        assert branches.is_known(y, pts, tol) == jbranches.is_known(y, pts,
                                                                    tol)


def test_bracket_probe_lands_on_the_failure_side(setup):
    """The probe's side lives in ds alone (an unsigned pin): deep inside
    the family both probes converge with beta EXACTLY tol away on the
    asked side, and _verify_bracket reports that side."""
    pcfg, noise = setup
    ncfg = pt.NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    step = boundary._make_bracket_step(pcfg, noise, ncfg, "auto")
    y_prev = np.array(Z0 + (13.0589,))
    for sgn in (+1.0, -1.0):
        y0 = y_prev.copy()
        y0[-1] += sgn * 0.05
        res = step(y_prev, y0, 0.0, sgn * 0.05)
        assert res.converged
        assert float(res.solution[-1]) == 13.0589 + sgn * 0.05
        bs, _, _, bf, _ = boundary._verify_bracket(
            step, torch.float64, 0.08, 0.0, sgn, 0.05, 13.0589,
            np.asarray(Z0), 0.0, None, max_probes=1)
        assert bf == bs + sgn * 0.05


@pytest.mark.slow
def test_tracks_sigma0_grazing_boundary(setup):
    """The tracker at sigma = 0 with a 0.1-wide bracket contains the slow
    family's grazing end beta* = 16.0144 (tests/test_boundary.py:47-63)."""
    pcfg, noise = setup
    ncfg = pt.NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    seen = []
    pts = boundary.track_existence_boundary(
        pcfg, noise, np.asarray(Z0), 13.0589, [0.0], bracket=0.5,
        bisect_tol=0.1, ncfg=ncfg, callback=seen.append)
    assert len(pts) == 1 and seen == [pts[0]]
    p = pts[0]
    assert (p.beta_star <= 16.0144 <= p.beta_fail
            or abs(p.beta_star - 16.0144) < 0.1)
    assert 0 < p.beta_fail - p.beta_star <= 0.2 + 1e-12
    assert abs(float(p.Z[0]) - 0.345) < 0.05
    assert p.residual_norm < 1e-8 and np.all(np.isfinite(p.Z))


def test_enumerates_both_seed_directions(setup):
    """Two guarded walks of two steps from the seed, one each way
    (tests/test_branches.py)."""
    pcfg, noise = setup
    ncfg = pt.NewtonConfig(tolerance=1e-9, max_iterations=12, fd_mode="exact")
    walked = branches.enumerate_branches(
        pcfg, noise, np.asarray(Z0), 13.0589, sigma=0.0, ds=0.2, n_steps=2,
        ncfg=ncfg, max_branches=2, jump_ds_factors=(2.0,))
    up = next(b for b in walked if b.origin == "seed+")
    dn = next(b for b in walked if b.origin == "seed-")
    assert up.hit_step_limit and dn.hit_step_limit
    assert up.points[-1, -1] > 13.0589 > dn.points[-1, -1]
    for b in walked:
        assert np.all(np.isfinite(b.points))
        assert np.all(b.points[:, 0] > 0.05) and np.all(b.points[:, 0] < 2.0)
