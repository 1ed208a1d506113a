"""Shared pieces of the benchmark's CPU tests: the checkout's root on the
path, one torch thread a worker, and the cells at test size."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)


def small_spec(workload: str):
    """The cell's spec at test size: N=512 and a few realisations; one
    problem of the pool, or sweeps of two steps; two answers checked."""
    from benchmark import harness
    spec = harness.cell_spec(ROOT, workload)
    c = spec.config
    c["model"]["n_neurons"] = 512
    if c["n_real"] == 64:
        c.update(n_real=4, evolve_window=128, max_events=1024)
        spec.traffic["pool"] = 1
    else:
        c["n_real"] = 8
        flags = spec.traffic["flags"]
        flags[flags.index("--steps") + 1] = "2"
    spec.traffic["checked"] = 2
    return spec


@pytest.fixture
def root():
    return ROOT
