"""The port's example twins (``examples/quickstart_torch.py``,
``examples/deep_sweep_torch.py``) run on the CPU at their smallest
setting, each in a subprocess that must exit 0 and print its key lines.
The examples import no JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def run_example(name, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"      # one core each, as the test workers
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--cpu", *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_quickstart_twin():
    out = run_example("quickstart_torch.py", "--realisations", "4")
    assert re.search(r"^newton: converged=True", out, re.M), out
    assert re.search(r"^unstable eigenvalues: \d", out, re.M), out
    assert re.search(r"^staged: converged=True \|F\|=", out, re.M), out
    assert re.search(r"^sweep step beta=13.1589: converged=True", out,
                     re.M), out


@pytest.mark.parametrize("shard", [[], ["--shard", "2"]],
                         ids=["unsharded", "shard2"])
def test_deep_sweep_twin(shard):
    out = run_example("deep_sweep_torch.py", "--steps", "1",
                      "--realisations", "4", *shard)
    line = re.search(r"^step 0: beta=13.0589 \|r\|=(\S+) Z=.* unstable=\d$",
                     out, re.M)
    assert line, out
    assert float(line.group(1)) <= 1e-8
