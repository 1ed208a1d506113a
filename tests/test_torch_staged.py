"""Port parity of the staged solver: the frozen-Jacobian polish and the
frozen Newton loop on synthetic residuals against the JAX functions, the
staged recipe's defaults, the shared draw of stage 1, the frozen solve and
one staged solve at N=512, R=4, sigma 0 (RNG-free: R does not change the
map) against the JAX package's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import INITIAL_GUESS, configs, params, pt, to_numpy
from armadillocudalinearinterpolation_tpu.solvers import newton as jnewton
from armadillocudalinearinterpolation_tpu.solvers import staged as jstaged
from armadillocudalinearinterpolation_torch.model import emap as pemap
from armadillocudalinearinterpolation_torch.solvers import staged

KEY = jax.random.PRNGKey(0)
# the fixed point of tests/test_replay.py:370 (N=512, sigma 0, f64)
REPLAY_ROOT = (0.32623663, 0.71936722, 1.36899475)


def synthetic(xp):
    """A 2-D residual with a staircase of 1e-7 steps (the jumpy landscape
    the polish exists for), written once for both array libraries."""
    def F(x):
        smooth = xp.stack([xp.arctan(x[0]) + 0.1 * x[1] - 0.2,
                           x[1] ** 3 + x[1] - 0.5 + 0.05 * x[0]])
        return smooth + 1e-7 * xp.floor(x * 1e4) - 1e-7 * x * 1e4
    return F


J_FROZEN = np.array([[0.9, 0.1], [0.05, 1.6]])


@pytest.mark.parametrize("x0, tolerance, iters", [
    ((0.0, 0.0), 1e-12, 12),      # polishes to the staircase floor
    ((0.0, 0.0), 0.0, 5),         # best effort: never converged
    ((0.3, 0.4), 1e-6, 8),        # meets the tolerance early
    ((math.nan, 0.0), 1e-6, 4),   # NaN first residual
])
def test_frozen_jacobian_polish_matches_jax(x0, tolerance, iters):
    got = pt.frozen_jacobian_polish(
        synthetic(torch), torch.tensor(x0, dtype=torch.float64),
        torch.tensor(J_FROZEN), max_iterations=iters, tolerance=tolerance)
    want = jnewton.frozen_jacobian_polish(
        synthetic(jnp), jnp.asarray(x0, jnp.float64), jnp.asarray(J_FROZEN),
        max_iterations=iters, tolerance=tolerance)
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.residual_norm, float(want.residual_norm),
                               rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(to_numpy(got.solution),
                               np.asarray(want.solution), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_numpy(got.residual_history),
                               np.asarray(want.residual_history), rtol=1e-9,
                               atol=1e-15)


def arctan_problem(xp, calls, poison_fill=False, poison_first_jac=False):
    """1-D arctan from x0 = 3: the full Newton step overshoots, so the
    backtracking trials after the first are scored."""
    def jac(z):
        return (1.0 / (1.0 + z * z))[:, None]

    def evaluate(z, ep):
        calls["evaluate"].append(float(ep))
        if poison_first_jac and len(calls["evaluate"]) == 1:
            return xp.arctan(z), jac(z) * math.nan
        return xp.arctan(z), jac(z)

    def score(z):
        calls["score"] += 1
        return xp.arctan(z), ("outcome",)

    def fill(z, ep, aux):
        assert aux == ("outcome",)
        calls["fill"] += 1
        if poison_fill and calls["fill"] == 1:
            return xp.arctan(z), jac(z) * math.nan
        return xp.arctan(z), jac(z)
    return evaluate, score, fill


def run_loops(ncfg_kw, backtrack=True, **poison):
    """The port's and the JAX frozen Newton loop on the same problem:
    ``[(port_result, port_calls), (jax_result, jax_calls)]``."""
    import armadillocudalinearinterpolation_tpu as jx
    calls = [{"evaluate": [], "score": 0, "fill": 0} for _ in range(2)]
    ev, sc, fi = arctan_problem(torch, calls[0], **poison)
    got = staged.frozen_newton_loop(
        ev, torch.tensor([3.0], dtype=torch.float64),
        pt.NewtonConfig(**ncfg_kw), 1e-6, backtrack=backtrack, score=sc,
        fill=fi)
    ev, sc, fi = arctan_problem(jnp, calls[1], **poison)
    want = jstaged.frozen_newton_loop(
        ev, jnp.array([3.0], jnp.float64), jx.NewtonConfig(**ncfg_kw),
        jnp.float64, jnp.asarray(1e-6, jnp.float64), backtrack=backtrack,
        score=sc, fill=fi)
    return [(got, calls[0]), (want, calls[1])]


@pytest.mark.parametrize("case", ["backtrack", "nan_fill", "nan_jacobian",
                                  "plain_diverges"])
def test_frozen_newton_loop_matches_jax(case):
    """Backtracking with scored trials and fill; the scored winner's NaN
    fill re-evaluated as ``ev`` does (tests/test_staged.py:351); a
    non-finite first Jacobian retried at eps/8; plain damped steps stopped
    by the NaN-inclusive divergence cutoff.  Same iterates, history and
    calls as the JAX loop."""
    kw = dict(tolerance=1e-10, max_iterations=12)
    poison, backtrack = {}, True
    if case == "nan_fill":
        poison = {"poison_fill": True}
    elif case == "nan_jacobian":
        poison = {"poison_first_jac": True}
    elif case == "plain_diverges":
        kw["divergence_factor"] = 10.0
        backtrack = False
    (got, calls), (want, jcalls) = run_loops(kw, backtrack, **poison)
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(to_numpy(got.solution),
                               np.asarray(want.solution), rtol=1e-12)
    np.testing.assert_allclose(to_numpy(got.residual_history),
                               np.asarray(want.residual_history), rtol=1e-12)
    assert calls == jcalls
    if case == "plain_diverges":
        assert not got.converged and got.iterations < 12
    else:
        assert got.converged and calls["score"] > 0
        assert np.isfinite(to_numpy(got.jacobian)).all()
    if case == "nan_fill":
        assert calls["fill"] >= 1 and len(calls["evaluate"]) >= 2
    if case == "nan_jacobian":
        assert calls["evaluate"][:2] == [1e-6, 1e-6 / 8.0]


def test_resolve_staged_defaults_match_jax():
    """The recipe's defaults on the replay backend equal the JAX ones;
    "auto" resolves to "replay"; a frozen mode on the direct evolve raises
    ValueError in both packages.  On the direct evolve both default to
    an exact stage 2 with the same tolerance and budget."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-6)
    for backend in ("replay", "auto"):
        got = staged._resolve_staged(pcfg, 1e-8, None, None, None, backend)
        want = jstaged._resolve_staged(jcfg, 1e-8, None, None, None, backend)
        assert got[0].root_tol == want[0].root_tol == 1e-12
        assert (got[1].dtype, got[1].root_tol) == (want[1].dtype,
                                                   want[1].root_tol)
        for g, w in zip(got[2:4], want[2:4]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert got[3].fd_mode == "frozen-fwd" and got[3].tolerance == 5e-8
        assert got[4] == want[4] == "replay"
    got = staged._resolve_staged(pcfg, 1e-8, None, None, None, "torch")
    want = jstaged._resolve_staged(jcfg, 1e-8, None, None, None, "xla")
    assert (got[3].tolerance, got[3].max_iterations) == (
        want[3].tolerance, want[3].max_iterations)
    assert (got[3].fd_mode, want[3].fd_mode) == ("exact", "exact")
    frozen = dict(tolerance=5e-7, max_iterations=6, fd_mode="frozen",
                  fd_epsilon=1e-5)
    with pytest.raises(ValueError, match="replay"):
        staged._resolve_staged(pcfg, 1e-7, None, pt.NewtonConfig(**frozen),
                               None, "cuda")
    import armadillocudalinearinterpolation_tpu as jx
    with pytest.raises(ValueError, match="replay"):
        jstaged._resolve_staged(jcfg, 1e-7, None, jx.NewtonConfig(**frozen),
                                None, "xla")


@pytest.mark.parametrize("mode, eps, want", [
    ("frozen-fwd", 1e-6, 1e-6), ("frozen-fwd", 1e-8, 1e-8),
    ("frozen-fwd", 1e-5, 1e-5), ("frozen-fwd", 1e-4, 1e-6),
    ("frozen-fwd", 1e-2, 1e-6), ("frozen-fwd", 1e-9, 1e-6),
    ("frozen", 1e-5, 1e-5), ("frozen", 1e-4, 1e-4), ("frozen", 1e-7, 1e-7),
    ("frozen", 1e-3, 1e-5), ("frozen", 1e-8, 1e-5)])
def test_frozen_epsilon_window(mode, eps, want):
    """solvers/staged.py:169-174 of the JAX package: out-of-window radii
    reset to the default, not to the window's edge."""
    assert staged.frozen_epsilon(pt.NewtonConfig(fd_mode=mode,
                                                 fd_epsilon=eps)) == want


def test_frozen_solve_refuses_other_modes():
    _, pcfg = configs(n_neurons=256, n_real=2)
    with pytest.raises(ValueError, match="fd_mode"):
        pt.newton_solve_frozen(pcfg, params(sigma=0.0)[1],
                               torch.ones(2, 256, dtype=torch.float64),
                               torch.tensor(INITIAL_GUESS),
                               pt.NewtonConfig(fd_mode="central"))


def test_stage1_takes_the_accurate_draw_cast_to_f32(monkeypatch):
    """The draw is made once at the accurate dtype and stage 1 solves it
    cast to f32 (tests/test_staged.py:326): a fresh f32 draw would be
    another realisation of the map."""
    _, pcfg = configs(n_neurons=256, n_real=2)
    _, pp = params(sigma=0.1)
    seen = {}

    class Stop(Exception):
        pass

    def spy(cfg, params_, seed, *, device, beta=None, evolve_backend,
            group=None):
        seen.update(cfg=cfg, beta=beta, backend=evolve_backend, group=group)
        raise Stop

    monkeypatch.setattr(staged, "make_residual_fn", spy)
    with pytest.raises(Stop):
        pt.newton_solve_staged(pcfg, pp, torch.tensor(INITIAL_GUESS),
                               seed=7, device="cpu")
    draw = pemap.sample_beta(pcfg, pp, torch.Generator().manual_seed(7))
    assert seen["cfg"].dtype == "float32" and seen["cfg"].root_tol == 1e-6
    assert seen["beta"].dtype == torch.float32
    assert torch.equal(seen["beta"], draw.float())
    assert seen["backend"] == "auto" and seen["group"] is None


@pytest.fixture(scope="module")
def sigma0():
    jcfg, pcfg = configs(n_neurons=512, n_real=4, root_tol=1e-12,
                         max_events=2048)
    jp, pp = params(sigma=0.0)
    return jcfg, pcfg, jp, pp, torch.full((4, 512), 13.0589,
                                          dtype=torch.float64)


def test_frozen_solve_reaches_the_replay_root(sigma0):
    """newton_solve_frozen (central stencil) from the Driver.cu guess
    converges within 5e-5 of the fixed point of tests/test_replay.py:370,
    and a fresh replay map confirms the residual."""
    _, pcfg, _, pp, beta = sigma0
    res = pt.newton_solve_frozen(
        pcfg, pp, beta, torch.tensor(INITIAL_GUESS),
        pt.NewtonConfig(tolerance=1e-9, max_iterations=8, fd_mode="frozen",
                        fd_epsilon=1e-5))
    assert res.converged and res.iterations <= 6
    np.testing.assert_allclose(to_numpy(res.solution), REPLAY_ROOT,
                               atol=5e-5)
    f = pt.event_driven_map(pcfg, pp, beta, res.solution,
                            evolve_backend="replay")
    assert float(torch.linalg.vector_norm(f)) <= 1e-9


def test_staged_solve_matches_jax(sigma0):
    """newton_solve_staged at tolerance 1e-7 from the Driver.cu guess
    converges, in domain, to the root the JAX package's staged solve finds
    (within 5e-5), confirmed by a fresh replay map.  From this guess the
    f32 stage hands both packages off to the coexisting root ~0.04 from
    REPLAY_ROOT in spike spacing (the basin note of the JAX
    ``newton_solve_staged``), the same speed."""
    jcfg, pcfg, jp, pp, beta = sigma0
    z0 = torch.tensor(INITIAL_GUESS)
    res = pt.newton_solve_staged(pcfg, pp, z0, beta=beta, tolerance=1e-7)
    import armadillocudalinearinterpolation_tpu as jx
    want = jx.newton_solve_staged(jcfg, jp, KEY, jnp.asarray(INITIAL_GUESS),
                                  tolerance=1e-7)
    assert res.converged and bool(want.converged)
    assert res.residual_norm <= 1e-7
    sol = to_numpy(res.solution)
    np.testing.assert_allclose(sol, np.asarray(want.solution), atol=5e-5)
    assert sol[0] > 0 and np.all(sol[0] * sol[1:] > 0) \
        and np.all(sol[0] * sol[1:] < 2 * pcfg.half_width)
    assert abs(sol[0] - REPLAY_ROOT[0]) < 1e-3
    f = pt.event_driven_map(pcfg, pp, beta, res.solution,
                            evolve_backend="replay")
    assert float(torch.linalg.vector_norm(f)) <= 1e-7
