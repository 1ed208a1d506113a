"""The port's CLI walker modes and exact Jacobians on the CPU:
``--arclength`` (its checkpoint in the JAX package's format, read by the
JAX ``ContinuationCheckpoint``, and a JAX walk's checkpoint resumed by the
port) and ``--fd-mode exact``, N=512, R=4, f64, sigma 0; the other walker
modes are in tests/test_torch_walkers_cli_modes.py.
"""

import numpy as np
import pytest

from armadillocudalinearinterpolation_torch.cli import driver
from armadillocudalinearinterpolation_torch.utils.checkpoint import (
    ContinuationCheckpoint)
from armadillocudalinearinterpolation_tpu.utils.checkpoint import (
    ContinuationCheckpoint as JaxCheckpoint)

ARGS = ["--cpu", "--neurons", "512", "--realisations", "4",
        "--dtype", "float64"]
ROOT = ["--guess", "0.32623663", "0.71936722", "1.36899475"]
ARC = ARGS + ROOT + ["--arclength", "--ds", "0.3", "--fd-mode", "exact",
                     "--tol", "1e-9"]


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """Two arclength steps into a checkpoint, with per-step lines."""
    path = tmp_path_factory.mktemp("arc")
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(ARC + ["--steps", "2", "--checkpoint", str(path)])
    return rc, buf.getvalue(), path


def test_cli_arclength(walk):
    rc, out, path = walk
    assert rc == 0
    assert "arc step 0" in out and "arc step 1" in out
    assert "arclength: 2 accepted steps" in out
    steps = ContinuationCheckpoint(path).load_all()
    assert len(steps) == 2 and steps[-1].beta > steps[0].beta > 13.0589
    assert all(s.converged and s.residual_norm <= 1e-9 for s in steps)


def test_arclength_checkpoint_reads_in_jax(walk):
    """The port's walk checkpoint is the JAX package's format."""
    _, _, path = walk
    got = JaxCheckpoint(path).load_all()
    mine = ContinuationCheckpoint(path).load_all()
    assert [s.index for s in got] == [0, 1]
    for a, b in zip(got, mine):
        assert a.beta == b.beta
        np.testing.assert_array_equal(a.solution, b.solution)


def test_port_resumes_a_jax_arclength_checkpoint(tmp_path, capsys):
    """A one-step JAX walk's checkpoint, resumed for one more step by the
    port and (in a copy) by the JAX CLI: the port reads the JAX file and
    takes the same step (sigma 0, RNG-free; one checkpointed point, so
    both restart along +beta) within 1e-7."""
    import shutil
    from armadillocudalinearinterpolation_tpu.cli import driver as jdriver
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jdriver.main(ARC + ["--steps", "1", "--quiet", "--checkpoint",
                               str(jax_dir)]) == 0
    shutil.copytree(jax_dir, port_dir)
    assert jdriver.main(ARC + ["--steps", "1", "--quiet", "--resume",
                               "--checkpoint", str(jax_dir)]) == 0
    capsys.readouterr()
    assert driver.main(ARC + ["--steps", "1", "--quiet", "--resume",
                              "--checkpoint", str(port_dir)]) == 0
    assert "resuming arclength walk at step 1" in capsys.readouterr().out
    got = ContinuationCheckpoint(port_dir).load_all()
    want = JaxCheckpoint(jax_dir).load_all()
    assert [s.index for s in got] == [s.index for s in want] == [0, 1]
    np.testing.assert_allclose(got[1].solution, want[1].solution, rtol=0,
                               atol=1e-7)
    assert abs(got[1].beta - want[1].beta) <= 1e-7


def test_cli_fd_mode_exact(capsys):
    """A sweep step with exact Jacobians converges and returns 0."""
    rc = driver.main(ARGS + ["--fd-mode", "exact", "--tol", "1e-9",
                             "--steps", "1", "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "step 0: beta=13.0589 converged=True" in out


def test_cli_walkers_refuse_f32_exact(capsys):
    assert driver.main(ARGS[:-1] + ["float32", "--track-fold"]) == 2
    assert "float64" in capsys.readouterr().err
