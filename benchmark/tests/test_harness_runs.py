"""A run without a card fails with no result; nothing the harness loads
pulls in JAX or the JAX package."""

import importlib
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

GUARD = """
import importlib, json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
import benchmark.harness as h, benchmark.answers, benchmark.trace
import benchmark.yardstick, benchmark.reference.edmap, benchmark.control
import benchmark.events_per_row
for p in sorted(Path({root!r}, "benchmark", "loops").glob("*.py")):
    importlib.import_module("benchmark.loops." + p.stem)
for p in sorted(Path({root!r}, "benchmark", "metrics").glob("*.py")):
    h.reader(p.stem)
import armadillocudalinearinterpolation_torch.cli.driver
print(json.dumps(sorted(sys.modules)))
"""


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "n512_fast_family", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "metrics" not in out.stderr


def test_nothing_loads_jax():
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT))],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert "armadillocudalinearinterpolation_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax",
                       "armadillocudalinearinterpolation_tpu"}


def test_a_reader_that_loads_jax_gives_no_result(tmp_path, monkeypatch,
                                                   capsys):
    """A module named ``jax`` that a metric reader loads after the window
    refuses the run: the result line is never printed."""
    import time

    from benchmark import harness
    from benchmark.loops import cli_sweep
    from conftest import small_spec

    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))

    def loads_jax(ctx):
        importlib.import_module("jax")
        return None

    monkeypatch.setattr(harness, "reader", lambda name: loads_jax)
    monkeypatch.setattr(cli_sweep.Driver, "warm_up", lambda self: None)
    monkeypatch.setattr("benchmark.yardstick.nvidia_smi", lambda: "card")
    spec = small_spec("n512_fast_family")
    run = harness.load_module(ROOT / "benchmark" / "run.py", "benchmark_run")
    try:
        out = harness.run_cell(ROOT, spec.name, 20260103, 0.0, False, "cpu",
                               time.perf_counter(), spec=spec)
        capsys.readouterr()
        assert run.emit(out) == 3
        printed = capsys.readouterr()
        assert printed.out == ""
        assert "jax" in printed.err and "check" not in printed.err
    finally:
        sys.modules.pop("jax", None)
