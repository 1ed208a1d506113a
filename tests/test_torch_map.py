"""Port parity of the event-driven map ``F(Z)``: the residual, a stacked
evaluation and the per-stage diagnostics against the JAX package's map on
its XLA evolve (f64, same draw), and the port's backend selection and
hygiene."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (INITIAL_GUESS, configs, jax_draw, jx, params, pt,
                          to_numpy, to_torch)
from armadillocudalinearinterpolation_torch.model import evolve_cuda

ATOL = 1e-10
POINTS = np.array([INITIAL_GUESS, (0.3262, 0.7205, 1.3703),
                   (0.3310, 0.7014, 1.3557)])


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    jp, pp = params(sigma=0.1)
    beta = jax_draw(jcfg, jp)
    F = jax.jit(jax.vmap(lambda z: jx.event_driven_map(
        jcfg, jp, jax.random.PRNGKey(0), z, evolve_backend="xla")))
    return jcfg, pcfg, jp, pp, beta, np.asarray(F(jnp.asarray(POINTS)))


def test_stacked_map_matches_jax_and_single_points(setup):
    """One (P, n) evaluation (one evolve over P*R rows) equals the JAX map
    at every point, and the port's own single-point calls."""
    _, pcfg, _, pp, beta, f_jax = setup
    F = pt.make_residual_fn(pcfg, pp, 0, device="cpu", beta=to_torch(beta),
                            evolve_backend="torch")
    f_stack = F(torch.tensor(POINTS))
    assert f_stack.shape == POINTS.shape
    np.testing.assert_allclose(to_numpy(f_stack), f_jax, rtol=0, atol=ATOL)
    for p in range(2):
        f_one = F(torch.tensor(POINTS[p]))
        assert f_one.shape == (3,)
        np.testing.assert_allclose(to_numpy(f_one), f_jax[p], rtol=0,
                                   atol=ATOL)


def test_diagnostics_match_jax(setup):
    jcfg, pcfg, jp, pp, beta, _ = setup
    z = POINTS[0]
    fj, dj = jx.event_driven_map(jcfg, jp, jax.random.PRNGKey(0),
                                 jnp.asarray(z), with_diagnostics=True,
                                 evolve_backend="xla")
    fp, dp = pt.event_driven_map(pcfg, pp, to_torch(beta), torch.tensor(z),
                                 with_diagnostics=True, evolve_backend="auto")
    np.testing.assert_allclose(to_numpy(fp), np.asarray(fj), rtol=0,
                               atol=ATOL)
    for name in ("v0", "s0", "positions", "u_mean"):
        np.testing.assert_allclose(to_numpy(getattr(dp, name)),
                                   np.asarray(getattr(dj, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(to_numpy(dp.init_ind),
                                  np.asarray(dj.init_ind))
    np.testing.assert_array_equal(to_numpy(dp.evolve.accept),
                                  np.asarray(dj.evolve.accept))
    assert float(dp.accept_count) == float(dj.accept_count) == 4.0


def test_residual_fn_draws_once_from_its_generator():
    """Common random numbers: one draw per residual oracle, reused by every
    evaluation; the same seed gives the same draw."""
    _, pcfg = configs(n_neurons=256, n_real=2)
    _, pp = params(sigma=0.1)
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(7))
    assert beta.shape == (2, 256) and beta.dtype == torch.float64
    assert float((beta - 13.0589).abs().max()) < 1.0
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)
    F = pt.make_residual_fn(pcfg, pp, 7, device="cpu")
    f1 = F(z)
    assert torch.equal(f1, F(z))
    assert torch.equal(f1, pt.event_driven_map(pcfg, pp, beta, z))
    G = pt.make_residual_fn(pcfg, pp, torch.Generator().manual_seed(7),
                            device="cpu")
    assert torch.equal(f1, G(z))


def test_auto_backend_on_cpu_runs_the_plain_evolve():
    _, pcfg = configs(n_neurons=256, n_real=2)
    _, pp = params(sigma=0.1)
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(0))
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)
    before = evolve_cuda.LAUNCHES
    f_auto = pt.event_driven_map(pcfg, pp, beta, z, evolve_backend="auto")
    f_plain = pt.event_driven_map(pcfg, pp, beta, z, evolve_backend="torch")
    assert torch.equal(f_auto, f_plain)
    assert evolve_cuda.LAUNCHES == before


def test_backend_cuda_on_cpu_tensors_raises_and_bad_names_are_refused():
    _, pcfg = configs(n_neurons=256, n_real=2)
    _, pp = params(sigma=0.1)
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(0))
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        pt.event_driven_map(pcfg, pp, beta, z, evolve_backend="cuda")
    with pytest.raises(ValueError, match="evolve_backend"):
        pt.event_driven_map(pcfg, pp, beta, z, evolve_backend="xla")
    with pytest.raises(ValueError, match="evolve_backend"):
        pt.make_residual_fn(pcfg, pp, 0, device="cpu", evolve_backend="pallas")
    with pytest.raises(ValueError, match="beta"):
        pt.event_driven_map(pcfg, pp, beta[:1], z)


def test_port_never_imports_jax():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, armadillocudalinearinterpolation_torch as p; "
            "import armadillocudalinearinterpolation_torch.interop; "
            "import armadillocudalinearinterpolation_torch.ops.interp_cuda; "
            "import armadillocudalinearinterpolation_torch.ops.interp1d_cuda; "
            "import armadillocudalinearinterpolation_torch.model.replay; "
            "import armadillocudalinearinterpolation_torch.model.replay_cuda; "
            "import armadillocudalinearinterpolation_torch.model.evolve_batched; "
            "import armadillocudalinearinterpolation_torch.solvers.staged; "
            "import armadillocudalinearinterpolation_torch.cli.driver; "
            "import armadillocudalinearinterpolation_torch.utils.checkpoint; "
            "import armadillocudalinearinterpolation_torch.utils.debug; "
            "import armadillocudalinearinterpolation_torch.utils.profiling; "
            "import armadillocudalinearinterpolation_torch.analysis.continuation; "
            "import armadillocudalinearinterpolation_torch.analysis.fold; "
            "import armadillocudalinearinterpolation_torch.analysis.branches; "
            "import armadillocudalinearinterpolation_torch.analysis.boundary; "
            "import armadillocudalinearinterpolation_torch.parallel.sharding; "
            "import armadillocudalinearinterpolation_torch.oracle; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'armadillocudalinearinterpolation_tpu'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
