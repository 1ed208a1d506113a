"""The port's checkpoint (``utils/checkpoint.py``): the JAX package's
durability contract, and its on-disk format read across both packages."""

import warnings

import numpy as np
import pytest

from armadillocudalinearinterpolation_torch.utils import checkpoint as port
from armadillocudalinearinterpolation_tpu.utils import checkpoint as jaxck


def test_checkpoint_roundtrip(tmp_path):
    ck = port.ContinuationCheckpoint(tmp_path / "c")
    ck.save(port.ContinuationStep(index=0, beta=13.0,
                                  solution=np.arange(3.0),
                                  residual_norm=1e-9, converged=True,
                                  n_unstable=1,
                                  eigenvalues=np.array([1 + 1j, 2, 3])))
    last = ck.last()
    assert last.index == 0
    np.testing.assert_array_equal(last.solution, np.arange(3.0))
    np.testing.assert_array_equal(last.eigenvalues, np.array([1 + 1j, 2, 3]))
    assert port.ContinuationCheckpoint(tmp_path / "empty").last() is None


def test_checkpoint_tolerates_truncated_tail(tmp_path):
    """A crash mid-append leaves one truncated final line; load_all skips it,
    and the next save newline-terminates it instead of merging into it."""
    ck = port.ContinuationCheckpoint(tmp_path / "c")
    ck.save(port.ContinuationStep(index=0, beta=13.0, solution=np.zeros(3),
                                  residual_norm=1e-9, converged=True))
    ck.save(port.ContinuationStep(index=1, beta=13.1, solution=np.ones(3),
                                  residual_norm=1e-9, converged=True))
    with open(tmp_path / "c" / "steps.jsonl", "a") as f:
        f.write('{"index": 2, "beta":')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        steps = ck.load_all()
    assert [s.index for s in steps] == [0, 1]

    ck.save(port.ContinuationStep(index=2, beta=13.2, solution=2 * np.ones(3),
                                  residual_norm=1e-9, converged=True))
    ck.save(port.ContinuationStep(index=3, beta=13.3, solution=3 * np.ones(3),
                                  residual_norm=1e-9, converged=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the fragment line warns
        steps = ck.load_all()
        assert [s.index for s in steps] == [0, 1, 2, 3]
        assert ck.last().index == 3
    np.testing.assert_array_equal(steps[2].solution, 2 * np.ones(3))


def test_checkpoint_tolerates_truncated_final_payload(tmp_path):
    """An unreadable FINAL npz drops that step for redo; unreadable
    mid-history payloads are data loss and raise."""
    ck = port.ContinuationCheckpoint(tmp_path / "c")
    for i in range(3):
        ck.save(port.ContinuationStep(index=i, beta=13.0 + i, converged=True,
                                      solution=i * np.ones(3),
                                      residual_norm=1e-9))
    npz2 = tmp_path / "c" / "step_00002.npz"
    npz2.write_bytes(npz2.read_bytes()[:20])      # torn final payload
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        steps = ck.load_all()
        assert [s.index for s in steps] == [0, 1]
        last = ck.last()
        assert last.index == 1                    # falls back one step
    np.testing.assert_array_equal(last.solution, np.ones(3))
    (tmp_path / "c" / "step_00000.npz").unlink()
    with pytest.raises(ValueError, match="mid-history"):
        ck.load_all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="mid-history"):
            npz1 = tmp_path / "c" / "step_00001.npz"
            npz1.write_bytes(npz1.read_bytes()[:20])
            ck.last()


def _steps(module):
    return [
        module.ContinuationStep(index=0, beta=13.0589,
                                solution=np.array([0.3262, 0.7195, 1.3690]),
                                residual_norm=1.1e-9, converged=True,
                                n_unstable=1,
                                eigenvalues=np.array([8.58 + 0j, 0.73,
                                                      0.08 + 0.5j])),
        module.ContinuationStep(index=1, beta=13.1589,
                                solution=np.array([0.3269, 0.7188, np.nan]),
                                residual_norm=float("nan"), converged=False),
    ]


@pytest.mark.parametrize("writer, reader", [(jaxck, port), (port, jaxck)],
                         ids=["jax_to_port", "port_to_jax"])
def test_checkpoint_reads_across_packages(tmp_path, writer, reader):
    """A checkpoint written by either package loads in the other, every
    field equal (NaN where it was NaN; absent eigenvalues stay None)."""
    ck = writer.ContinuationCheckpoint(tmp_path / "c")
    for step in _steps(writer):
        ck.save(step)
    got = reader.ContinuationCheckpoint(tmp_path / "c").load_all()
    want = _steps(writer)
    assert [s.index for s in got] == [0, 1]
    for g, w in zip(got, want):
        assert (g.index, g.beta, g.converged, g.n_unstable) == (
            w.index, w.beta, w.converged, w.n_unstable)
        np.testing.assert_array_equal(g.residual_norm, w.residual_norm)
        np.testing.assert_array_equal(g.solution, w.solution)
        if w.eigenvalues is None:
            assert g.eigenvalues is None
        else:
            np.testing.assert_array_equal(g.eigenvalues, w.eigenvalues)
    last = reader.ContinuationCheckpoint(tmp_path / "c").last()
    assert last.index == 1 and not last.converged
