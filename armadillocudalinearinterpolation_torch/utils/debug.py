"""Per-stage debug dumps: the reference's ``test*.dat`` subsystem as .npy.

Reference: ``SetDebugFlag`` gates D2H copies of every pipeline stage to text
files (``EventDrivenMap.cu:406-503``); ``BuildCouplingKernel`` always writes
``test.dat`` (``:122-127``).  Here dumps are opt-in, and the stage names
mirror the reference's file names so a side-by-side comparison is
mechanical.  The port writes the same ``<stage>.npy`` files as the JAX
package's ``utils/debug.py``, so :func:`compare_dumps` compares a dump of
either package with a dump of the other.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from ..config import MapParams, ModelConfig
from ..model.coupling import coupling_kernel
from ..model.emap import event_driven_map

# stage -> reference dump file it mirrors
STAGES = {
    "coupling": "test.dat",
    "init_spike_ind": "testInitLastSpikeInd.dat",
    "lift_v": "testLift.dat (col 1)",
    "lift_s": "testLift.dat (col 2)",
    "last_spike_ind": "testLastSpikeInd.dat",
    "last_spike_time": "testLastSpikeTime.dat",
    "crossed_spike_ind": "testCrossedSpikeInd.dat",
    "crossed_spike_time": "testCrossedSpikeTime.dat",
    "accept": "testAcceptFlag.dat",
    "averages": "testAverages.dat",
    "averaged": "testAveraged.dat",
}


def dump_map_stages(cfg: ModelConfig, params: MapParams, beta: torch.Tensor,
                    Z: torch.Tensor, out_dir: str | os.PathLike) -> dict:
    """Evaluate the map once at ``Z`` under the ``(R, N)`` draw ``beta``
    (which fixes the device) and write every stage to
    ``out_dir/<stage>.npy``.

    Returns the dict of host arrays for programmatic use.
    """
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    f, d = event_driven_map(cfg, params, beta, Z, with_diagnostics=True)
    stages = {
        "coupling": coupling_kernel(cfg, device=beta.device),
        "init_spike_ind": d.init_ind,
        "lift_v": d.v0,
        "lift_s": d.s0,
        "last_spike_ind": d.evolve.last_ind,
        "last_spike_time": d.evolve.last_time,
        "crossed_spike_ind": d.evolve.crossed_ind,
        "crossed_spike_time": d.evolve.crossed_time,
        "accept": d.evolve.accept,
        "averages": d.positions,
        "averaged": d.u_mean,
        "residual": f,
    }
    host = {k: v.detach().cpu().numpy() for k, v in stages.items()}
    for name, arr in host.items():
        np.save(out / f"{name}.npy", arr)
    return host


def compare_dumps(dir_a: str | os.PathLike, dir_b: str | os.PathLike,
                  *, rtol: float = 0.0, atol: float = 1e-10) -> dict:
    """Compare two stage-dump directories (e.g. a JAX package dump and a
    port dump, or the CPU fp64 path and the card's f32 one).

    The golden-file workflow the reference supported only by eyeballing
    ``test*.dat`` in MATLAB (SURVEY.md §4).  Returns per-stage max absolute
    differences; raises ``AssertionError`` listing stages out of tolerance.
    """
    a, b = pathlib.Path(dir_a), pathlib.Path(dir_b)
    report = {}
    bad = []
    only_b = {p.name for p in b.glob("*.npy")} - {p.name for p in a.glob("*.npy")}
    for name in sorted(only_b):
        bad.append(f"{pathlib.Path(name).stem}: missing in {a}")
    for f in sorted(a.glob("*.npy")):
        g = b / f.name
        if not g.exists():
            bad.append(f"{f.stem}: missing in {b}")
            continue
        x = np.load(f).astype(np.float64)
        y = np.load(g).astype(np.float64)
        if x.shape != y.shape:
            bad.append(f"{f.stem}: shape {x.shape} vs {y.shape}")
            continue
        # NaN-pattern mismatches (one side rejected all realisations ->
        # NaN mean, the other finite) are exactly what nanmax would drop:
        # the reported error must name them, not show a misleading finite
        # (or 0.0) max over the remaining slots
        nan_mismatch = int(np.sum(np.isnan(x) != np.isnan(y)))
        both = ~(np.isnan(x) | np.isnan(y))
        err = float(np.max(np.abs(x[both] - y[both]))) if both.any() else 0.0
        report[f.stem] = err
        if not np.allclose(x, y, rtol=rtol, atol=atol, equal_nan=True):
            msg = f"{f.stem}: max|diff|={err:.3e}"
            if nan_mismatch:
                msg += f" + {nan_mismatch} NaN-pattern mismatches"
            bad.append(msg)
    if bad:
        raise AssertionError("stage dumps differ: " + "; ".join(bad))
    return report
