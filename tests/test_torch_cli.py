"""The port's CLI (``cli/driver.py``) on the CPU: its refusals, the secant
predictor's rules, resume, and its sweep against the JAX package's CLI on
the same per-step draws."""

import contextlib
import io
import json
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from torch_parity import configs, jx, to_torch
from armadillocudalinearinterpolation_tpu.cli import driver as jax_driver
from armadillocudalinearinterpolation_tpu.model.emap import (
    sample_beta as jax_sample_beta)
from armadillocudalinearinterpolation_torch.cli import driver
from armadillocudalinearinterpolation_torch.utils.checkpoint import (
    ContinuationCheckpoint)
from armadillocudalinearinterpolation_torch.utils.debug import STAGES

ARGS = ["--neurons", "512", "--realisations", "4", "--dtype", "float64",
        "--tol", "1e-8", "--fd-eps", "1e-7", "--quiet"]
CPU = ["--cpu"] + ARGS


@pytest.mark.parametrize("argv, message", [
    (CPU + ["--guess", "0.3", "0.7"], "--guess needs 3 values"),
    (CPU + ["--resume"], "--resume requires --checkpoint"),
    (["--cpu", "--staged", "--quiet"], "--dtype float64"),
    (CPU + ["--fd-mode", "exact", "--dtype", "float32"], "float64"),
    (CPU + ["--staged", "--stage2-fd", "exact", "--dtype", "float32"],
     "float64"),
    (CPU + ["--fd-mode", "frozen", "--evolve-backend", "torch"], "replay"),
    (CPU + ["--evolve-backend", "cuda"], "card"),
    (CPU + ["--shard", "8"], "a rank would hold none"),
    (CPU + ["--shard", "-1"], "--shard must be >= 0"),
], ids=["guess_arity", "resume_without_checkpoint", "staged_f32",
        "fd_mode_exact", "stage2_exact", "frozen_direct_backend",
        "cuda_backend_on_cpu", "shard_above_realisations",
        "negative_shard"])
def test_cli_refusals(argv, message, capsys):
    """Each refusal exits 2 with its message, before any map evaluation."""
    assert driver.main(argv) == 2
    out = capsys.readouterr()
    assert message in out.err
    assert "smoke test" not in out.out


@pytest.mark.parametrize("flag", [
    ["--aot-warmup"], ["--replay-jvp", "df64"], ["--replay-jvp", "f32"],
    ["--replay-exp-mode", "small"], ["--replay-exp-mode", "hoisted"],
    ["--replay-exp-mode", "cond"]])
def test_cli_refuses_unported_flags(flag, capsys):
    """A flag of the JAX CLI that the port never takes (the TPU knobs) is
    refused by argparse with rc 2, never silently ignored."""
    with pytest.raises(SystemExit) as exit_:
        driver.main(CPU + flag)
    assert exit_.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_flags_are_the_jax_cli_s_but_the_tpu_knobs():
    """The two parsers' flags differ by exactly the three TPU knobs
    (ROADMAP "Not to port"); ``--shard`` is in both."""
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    jax_flags = flags(jax_driver.build_parser())
    port_flags = flags(driver.build_parser())
    assert jax_flags - port_flags == {"--aot-warmup", "--replay-exp-mode",
                                      "--replay-jvp"}
    assert port_flags - jax_flags == set()
    assert "--shard" in port_flags


def test_cli_without_cpu_needs_a_card(monkeypatch, capsys):
    """Without --cpu and without a CUDA device the CLI exits non-zero with
    its message; it does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert driver.main(ARGS) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "--cpu" in out.err
    assert "smoke test" not in out.out


def test_predicted_retry_needed_covers_soft_failures():
    """A predicted sweep step retries the plain warm start on ANY failure:
    finite non-convergence included, not just NaN; tensors and arrays."""
    ok = SimpleNamespace(converged=True, solution=np.array([1.0, 2.0]))
    soft = SimpleNamespace(converged=False, solution=np.array([1.0, 2.0]))
    hard = SimpleNamespace(converged=False,
                           solution=torch.tensor([np.nan, 2.0]))
    weird = SimpleNamespace(converged=True, solution=torch.tensor([np.inf]))
    assert not driver.predicted_retry_needed(ok)
    assert driver.predicted_retry_needed(soft)
    assert driver.predicted_retry_needed(hard)
    assert driver.predicted_retry_needed(weird)


def test_step_seeds_are_distinct_and_fixed():
    seeds = {driver.step_seed(s, i) for s in range(3) for i in range(100)}
    assert len(seeds) == 300
    assert driver.step_seed(0, 7) == 7
    assert 0 <= driver.step_seed(-1, 0) < 2 ** 64


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """A 3-step f64 sweep at sigma 0 from the Driver.cu guess, with the
    predictor on and a checkpoint: the JAX package's
    test_cli_predictor_stays_on_branch (4 steps there) on the port, cut to
    3 steps to stay near 30 s on one CPU worker.  Step 2 is the first
    predicted step."""
    ck = tmp_path_factory.mktemp("uninterrupted")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(CPU + ["--steps", "3", "--beta-step", "0.1",
                                "--checkpoint", str(ck)])
    return rc, buf.getvalue(), ck


def test_cli_predictor_stays_on_branch(uninterrupted):
    """Every converged solution stays on the slow family (z_2 ~ 1.37, the
    fast family has z_2 ~ 11), and every step converges, the predicted one
    without a retry."""
    rc, out, _ = uninterrupted
    assert rc == 0
    assert out.count("converged=True") == 3
    assert "predicted guess" not in out
    zs = [[float(x) for x in m.group(1).split()]
          for m in re.finditer(r"Z=\[([^\]]+)\]", out)]
    assert len(zs) == 3
    for z in zs:
        assert z[2] < 2.0, f"basin hop to the fast family: {z}"


def test_cli_resume_repeats_the_uninterrupted_step(uninterrupted, tmp_path,
                                                   capsys):
    """2 steps, then --resume for 1: the resume line, indices 0-2, and
    step 2 (the predicted one) equal to the uninterrupted sweep's bit for
    bit: the step's draw depends on (seed, step) only, and the predictor's
    pair is restored from the checkpoint."""
    _, _, ck_full = uninterrupted
    ck = str(tmp_path / "c")
    assert driver.main(CPU + ["--steps", "2", "--checkpoint", ck]) == 0
    capsys.readouterr()
    assert driver.main(CPU + ["--steps", "1", "--checkpoint", ck,
                              "--resume"]) == 0
    assert "resuming at step 2 (beta=13.2589)" in capsys.readouterr().out
    steps = ContinuationCheckpoint(ck).load_all()
    full = ContinuationCheckpoint(ck_full).load_all()
    assert [s.index for s in steps] == [s.index for s in full] == [0, 1, 2]
    for s, f in zip(steps, full):
        assert s.beta == f.beta and s.converged == f.converged
        np.testing.assert_array_equal(s.solution, f.solution)
        assert s.residual_norm == f.residual_norm


def test_cli_debug_dump_and_profile(tmp_path, capsys):
    """--steps 0 runs the smoke test only; --debug-dump writes every stage
    of that evaluation and --profile a Chrome trace of the run."""
    dump, prof = tmp_path / "dump", tmp_path / "prof"
    assert driver.main(CPU + ["--sigma", "0.1", "--steps", "0",
                              "--debug-dump", str(dump),
                              "--profile", str(prof)]) == 0
    out = capsys.readouterr().out
    norm = float(re.search(r"\|f\| = (\S+)", out).group(1))
    assert f"stage dumps written to {dump}/" in out
    assert f"profiler trace written to {prof}/" in out
    for stage in STAGES:
        assert (dump / f"{stage}.npy").exists(), stage
    residual = np.load(dump / "residual.npy")
    assert float(np.linalg.norm(residual)) == pytest.approx(norm, rel=1e-6)
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


# The parity sweep: both CLIs at N=512, R=4, f64, sigma 0.1, tolerance
# 1e-8, forward FD at 1e-7, with stability: 2 steps in the fast tier,
# 3 (the second predicted step's draw and guess) in the slow one, which
# takes ~40 s on one CPU worker (the JAX CLI ~17 s of it).  Bars: the two
# packages' maps agree to ~1e-12 on one draw (tests/test_torch_map.py holds
# them to 1e-10), so Newton lands on the same iterates to ~1e-10; the
# Jacobian is a forward difference at 1e-7, so map differences of 1e-12
# move its entries by ~1e-5 at most, and the eigenvalues by less: 1e-4.
PARITY = ARGS + ["--sigma", "0.1", "--stability"]


def jax_step_draws():
    """The JAX CLI's draw of each step: ``sample_beta`` under the key split
    once per completed step (its cli/driver.py), at that step's beta."""
    jcfg, _ = configs(n_neurons=512, n_real=4)
    keys = [jax.random.PRNGKey(0)]
    for _ in range(8):
        keys.append(jax.random.split(keys[-1])[0])

    def draw(step, params):
        jp = jx.MapParams.create(float(params.beta), float(params.sigma),
                                 dtype="float64")
        return to_torch(np.asarray(jax_sample_beta(jcfg, jp, keys[step])))
    return draw


@pytest.mark.parametrize("steps", [2, pytest.param(3, marks=pytest.mark.slow)])
def test_cli_sweep_matches_jax_cli(steps, tmp_path, capsys):
    ck_jax, ck_port = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = PARITY + ["--steps", str(steps)]
    assert jax_driver.main(argv + ["--checkpoint", ck_jax]) == 0
    assert driver.main(["--cpu"] + argv + ["--checkpoint", ck_port],
                       draw=jax_step_draws()) == 0
    out = capsys.readouterr().out
    assert out.count("converged=True") == 2 * steps
    want = ContinuationCheckpoint(ck_jax).load_all()
    got = ContinuationCheckpoint(ck_port).load_all()
    assert [s.index for s in got] == [s.index for s in want] == list(
        range(steps))
    for g, w in zip(got, want):
        assert g.beta == w.beta
        assert g.converged == w.converged
        assert g.n_unstable == w.n_unstable
        np.testing.assert_allclose(g.solution, w.solution, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(np.sort_complex(g.eigenvalues),
                                   np.sort_complex(w.eigenvalues), rtol=0,
                                   atol=1e-4)
