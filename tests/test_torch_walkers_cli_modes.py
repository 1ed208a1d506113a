"""The port's CLI modes ``--track-fold``, ``--enumerate-branches`` and
``--track-boundary`` on the CPU at small budgets (N=512, R=4, f64,
sigma 0): the plumbing, the summaries and the ``--quiet`` contract.  The
walks' numbers are held in tests/test_torch_fold.py and
tests/test_torch_boundary.py.
"""

from armadillocudalinearinterpolation_torch.cli import driver

ARGS = ["--cpu", "--neurons", "512", "--realisations", "4",
        "--dtype", "float64"]
ROOT = ["--guess", "0.32623663", "0.71936722", "1.36899475"]


def test_cli_track_fold(tmp_path, capsys):
    """--track-fold from the near-fold point: the initial null direction
    from the exact Jacobian, the Moore-Spence solve (a short budget here;
    the converged fold is the slow test of tests/test_torch_fold.py), the
    summary line, rc 0."""
    rc = driver.main(ARGS + [
        "--guess", "0.59145", "0.57176", "10.07225", "--beta", "20.32",
        "--track-fold", "--sigma-values", "0.0", "--fd-mode", "central",
        "--fd-eps", "1e-6", "--tol", "1e-6", "--max-iter", "2",
        "--checkpoint", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fold curve:" in out and "/1 sigma values traced" in out


def test_cli_enumerate_and_boundary_quiet(tmp_path, capsys):
    """--enumerate-branches with one one-step walk writes its branch file;
    --track-boundary from the fixed point with a one-iteration corrector
    budget (the walk stops at once and the bracket is probed at the seed;
    the boundary itself is the slow test of tests/test_torch_boundary.py):
    both rc 0, --quiet keeps only the summaries."""
    rc = driver.main(ARGS + ROOT + [
        "--enumerate-branches", "--max-branches", "1", "--steps", "1",
        "--ds", "0.2", "--fd-mode", "exact", "--tol", "1e-9", "--quiet",
        "--checkpoint", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "branch 0 [seed+]: 1 points" in out
    assert "step 0:" not in out
    assert (tmp_path / "branch_0.npz").exists()
    rc = driver.main(ARGS + ROOT + [
        "--track-boundary", "--sigma-values", "0.0", "--fd-mode", "exact",
        "--tol", "1e-9", "--max-iter", "1", "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0 and "boundary: 1/1 sigma values traced" in out
    assert "sigma=" not in out
