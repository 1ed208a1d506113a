"""The sharded solvers on the CPU: the frozen stencil and its Newton, the
staged solve (frozen and exact stage 2), the frozen arclength corrector,
the plain Newton and the exact Jacobian over 2 gloo ranks, against the
same calls unsharded (the JAX package's ``tests/test_shard_map.py:73,109,
139`` and ``tests/test_sharding.py:51``).

One start of the ranks runs every case (``torch_shard_workers.run_cases``,
torch and the port only); the unsharded runs are here.  The sums over the
ranks reassociate the ensemble mean, so results agree to the bars of the
JAX package's sharded tests, never bit for bit; every rank must return the
same result.  N=512 with R=8 (R=4 for the exact stage 2) keeps the plain
CPU kernels to seconds a solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import INITIAL_GUESS, configs, jax_draw, params, to_torch
import torch_shard_workers as workers
import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_tpu.model import emap as jemap
from armadillocudalinearinterpolation_tpu.parallel import make_mesh
from armadillocudalinearinterpolation_torch.analysis.continuation import (
    initial_tangent, make_arclength_step_frozen)
from armadillocudalinearinterpolation_torch.parallel import run_ranks
from armadillocudalinearinterpolation_torch.solvers.staged import (
    newton_solve_frozen)

F64 = torch.float64
Z0 = torch.tensor(INITIAL_GUESS, dtype=F64)
ROOT = torch.tensor([0.32623663, 0.71936722, 1.36899475], dtype=F64)


def setup(n_real, sigma, **kw):
    cfg = pt.ModelConfig(n_neurons=512, n_real=n_real, dtype="float64",
                         **kw)
    params = pt.MapParams.create(13.0589, sigma, dtype="float64")
    noise = pt.sample_noise(cfg, torch.Generator().manual_seed(0))
    return cfg, params, noise, pt.beta_from_noise(cfg, params, noise)


FROZEN = setup(8, 0.1, root_tol=1e-12, max_events=2048)
# the frozen-stencil case of the JAX package (``test_shard_map.py:73``):
# its configuration and the draw of PRNGKey(0) in both packages
JAX_FROZEN = configs(n_neurons=512, n_real=8, root_tol=1e-12,
                     max_events=2048) + params(sigma=0.1)
EXACT = setup(4, 0.1)
PLAIN = setup(8, 0.0)
STENCIL = torch.cat([Z0[None], Z0[None] + 1e-5 * torch.eye(3, dtype=F64),
                     Z0[None] - 1e-5 * torch.eye(3, dtype=F64)])
NCFG_FROZEN = pt.NewtonConfig(tolerance=5e-8, max_iterations=8,
                              fd_mode="frozen", fd_epsilon=1e-5)
STAGED = {"frozen": (FROZEN, dict(tolerance=1e-7, stage2_ncfg=pt.NewtonConfig(
              tolerance=5e-7, max_iterations=6, fd_mode="frozen",
              fd_epsilon=1e-5))),
          "exact": (EXACT, dict(tolerance=1e-8, evolve_backend="torch"))}
NCFG_ARC = pt.NewtonConfig(tolerance=1e-9, max_iterations=12,
                           fd_mode="frozen", fd_epsilon=1e-5)
Y0 = torch.cat([ROOT, torch.tensor([13.0589], dtype=F64)])
NCFG_PLAIN = pt.NewtonConfig(tolerance=1e-9, max_iterations=12,
                             fd_epsilon=1e-7)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case on 2 ranks, one start."""
    cfg, params, noise, beta = FROZEN
    cases = [
        ("stencil", "frozen_stencil", dict(cfg=cfg, params=params,
                                           beta=beta, z=Z0, pts=STENCIL)),
        ("stencil_jax_draw", "frozen_stencil", dict(
            cfg=JAX_FROZEN[1], params=JAX_FROZEN[3],
            beta=to_torch(jax_draw(JAX_FROZEN[0], JAX_FROZEN[2])), z=Z0,
            pts=STENCIL)),
        ("frozen_solve", "frozen_solve", dict(cfg=cfg, params=params,
                                              beta=beta, z=Z0,
                                              ncfg=NCFG_FROZEN)),
        ("arclength", "arclength_step", dict(cfg=cfg, noise=noise, y0=Y0,
                                             ds=0.3, ncfg=NCFG_ARC)),
        ("newton", "newton", dict(cfg=PLAIN[0], params=PLAIN[1],
                                  beta=PLAIN[3], z=Z0, ncfg=NCFG_PLAIN)),
        ("exact_j", "exact_jacobian", dict(cfg=EXACT[0], params=EXACT[1],
                                           noise=EXACT[2], z=ROOT,
                                           param="beta")),
    ] + [(f"staged_{name}", "staged_solve",
          dict(cfg=case[0], params=case[1], beta=case[3], z=Z0, kw=kw))
         for name, (case, kw) in STAGED.items()]
    return run_ranks(workers.run_cases, 2, cases, device="cpu",
                     workdir=str(tmp_path_factory.mktemp("ranks")))


def on_every_rank(outs, name):
    """Rank 0's result, after checking the other rank's is the same."""
    first = outs[0][name]
    for key, value in first.items():
        other = outs[1][name][key]
        assert (torch.equal(value, other) if isinstance(value, torch.Tensor)
                else value == other), (name, key)
    return first


def test_frozen_stencil_sharded_matches_unsharded(sharded):
    """Each rank discovers and replays its rows of the 7-point stencil
    (K2's path): 1e-13, one all-reduce for the stencil."""
    cfg, params, _, beta = FROZEN
    got = on_every_rank(sharded, "stencil")
    outcome = pt.compute_discrete_outcome(cfg, params, beta, Z0)
    want = pt.frozen_schedule_map_batched(cfg, params, beta, STENCIL,
                                          *outcome)
    torch.testing.assert_close(got["f"], want, rtol=0, atol=1e-13)
    assert got["schedule_rows"] == cfg.n_real // 2
    assert got["reduces"] == 1


def test_frozen_stencil_sharded_matches_jax_sharded(sharded):
    """The port's sharded frozen stencil (2 ranks, each discovering its
    own rows) on the JAX draw against the JAX package's frozen stencil
    with its rows sharded over the 8-device virtual mesh (``row_mesh``).
    JAX runs eagerly: compiled, its df64 replay moves by ~3e-7 from the
    eager one (``test_shard_map.py:40-48``), and the port's replay follows
    the eager chain.  The bar is the port's frozen-stencil bar against
    JAX (``test_torch_replay.py``): 1e-12."""
    jcfg, _, jp, _ = JAX_FROZEN
    key = jax.random.PRNGKey(0)
    z = jnp.asarray(INITIAL_GUESS)
    outcome = jax.jit(lambda zz: jemap.compute_discrete_outcome(
        jcfg, jp, key, zz))(z)
    want = np.asarray(jemap.frozen_schedule_map_batched(
        jcfg, jp, key, jnp.asarray(STENCIL.numpy()), *outcome,
        row_mesh=make_mesh({"real": 8})))
    got = on_every_rank(sharded, "stencil_jax_draw")
    np.testing.assert_allclose(got["f"].numpy(), want, rtol=0, atol=1e-12)
    assert got["reduces"] == 1


def test_frozen_solve_sharded_matches_unsharded(sharded):
    cfg, params, _, beta = FROZEN
    got = on_every_rank(sharded, "frozen_solve")
    want = newton_solve_frozen(cfg, params, beta, Z0, NCFG_FROZEN)
    assert got["converged"] and want.converged
    torch.testing.assert_close(got["solution"], want.solution, rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("stage2", ["frozen", "exact"])
def test_staged_solve_sharded_matches_unsharded(sharded, stage2):
    """The whole staged recipe over 2 ranks: stage 1 (K1 f32), stage 2
    frozen on the replay (K2) or exact on the direct evolve (K2T), the
    polish and the rescue decisions on reduced values."""
    (cfg, params, _, beta), kw = STAGED[stage2]
    got = on_every_rank(sharded, f"staged_{stage2}")
    want = pt.newton_solve_staged(cfg, params, Z0, beta=beta, **kw)
    assert got["converged"] and want.converged
    torch.testing.assert_close(got["solution"], want.solution, rtol=0,
                               atol=1e-7)


def test_arclength_frozen_corrector_sharded(sharded):
    cfg, _, noise, _ = FROZEN
    got = on_every_rank(sharded, "arclength")
    step = make_arclength_step_frozen(cfg, noise, 0.0, "beta", NCFG_ARC)
    want = step(Y0, initial_tangent(3, 1.0, F64), 0.3)
    assert got["converged"] and want.converged
    torch.testing.assert_close(got["solution"], want.solution, rtol=0,
                               atol=5e-9)


def test_sharded_newton_converges(sharded):
    """``tests/test_sharding.py:51``: the sharded Newton converges near
    the Driver.cu guess, and to the unsharded root."""
    cfg, params, _, beta = PLAIN
    got = on_every_rank(sharded, "newton")
    assert got["converged"]
    np.testing.assert_allclose(got["solution"].numpy(),
                               [0.331, 0.6914, 1.3557], atol=0.05)
    want = pt.newton_solve(pt.make_residual_fn(cfg, params, 0, device="cpu",
                                               beta=beta), Z0, NCFG_PLAIN)
    torch.testing.assert_close(got["solution"], want.solution, rtol=0,
                               atol=1e-10)


def test_sharded_exact_jacobian_matches_unsharded(sharded):
    """``value_and_jacobian`` with the beta column: the tangent replay of
    each rank's rows, the masked tangent sums over the same global count,
    one all-reduce with the outcome check."""
    cfg, params, noise, _ = EXACT
    got = on_every_rank(sharded, "exact_j")
    F = pt.make_residual_fn(cfg, params, 0, device="cpu", noise=noise)
    f, J = F.value_and_jacobian(ROOT, param="beta")
    torch.testing.assert_close(got["f"], f, rtol=0, atol=1e-13)
    scale = float(J.abs().max())
    assert float((got["J"] - J).abs().max()) <= 1e-12 * scale
    assert got["reduces"] == 1
