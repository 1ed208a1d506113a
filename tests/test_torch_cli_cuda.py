"""The port's CLI on the card: the same sweep through the CUDA evolve
kernel and through the plain PyTorch evolve on the card.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_cuda.py -m cuda
"""

import pytest
import torch

from armadillocudalinearinterpolation_torch.cli import driver
from armadillocudalinearinterpolation_torch.model import evolve_cuda
from armadillocudalinearinterpolation_torch.utils.checkpoint import (
    ContinuationCheckpoint)

pytestmark = pytest.mark.cuda

# N=512, R=64, f32, sigma 0.1, the certified window of 128 lanes, 3 steps.
# The FD step is chip_smoke.py's 3e-4: with the Driver.cu step of 1e-2 the
# first steps do not converge (ROADMAP Queue 3), and the iterates of two
# failing solves on maps that differ by f32 rounding need not stay close.
ARGS = ["--neurons", "512", "--realisations", "64", "--dtype", "float32",
        "--sigma", "0.1", "--evolve-window", "128", "--fd-eps", "3e-4",
        "--steps", "3", "--quiet"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CLI's kernels have no CPU mode")
    return torch.device("cuda")


def test_cli_kernel_sweep_matches_plain_evolve_sweep(card, tmp_path):
    """The same converged flags, and Z within 1e-5: the kernel and the
    plain evolve agree to 2e-5 on the residual at f32 (chip_smoke.py's
    bar), and each solve converges to 1e-4 from the same guess."""
    sweeps = {}
    for backend in ("cuda", "torch"):
        ck = tmp_path / backend
        before = evolve_cuda.LAUNCHES
        assert driver.main(ARGS + ["--evolve-backend", backend,
                                   "--checkpoint", str(ck)]) == 0
        launched = evolve_cuda.LAUNCHES - before
        assert (launched > 0) == (backend == "cuda")
        sweeps[backend] = ContinuationCheckpoint(ck).load_all()
    got, want = sweeps["cuda"], sweeps["torch"]
    assert [s.index for s in got] == [s.index for s in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert g.converged == w.converged
        assert abs(g.solution - w.solution).max() <= 1e-5, (g, w)
    assert any(s.converged for s in got)
