"""What decides ``correct``: the draws both sides take, the reference's
numbers about the program's answers, and their comparison with the
cell's limits.

The program is handed the draws of the rates that :func:`draw_rates`
makes from the run's seed; once the measured window has closed, the
reference (:mod:`benchmark.reference.edmap`, float64) makes the same draws
again, evaluates the map at the program's answers, and the numbers below
are compared with the limits of the cell's file in
``benchmark/workloads/``:

* ``claim_gap``: the largest gap, over the checked answers, between the
  residual ``|F(Z)|`` (2-norm) of the reference map at the answer, under
  its own draw, and the residual the program reported with it.  The
  checked answers are drawn from those the program reported as converged:
  such an answer claims a residual under the tolerance, and is wrong where
  that claim is not the map's.  An answer reported as not converged claims
  nothing (far from a root the f32 map and the reference part by the
  discrete outcome) and counts in ``unconverged_share``;
* ``unconverged_share``: the share in % of the window's answers that the
  program reported as not converged (the harness counts it);
* ``stability_mismatch``: at the checked answers whose stability the
  program recorded, how many unstable counts differ from the count of the
  reference's forward-difference Jacobian (the program's step), where the
  reference's spectrum has no eigenvalue modulus within ``margin`` of 1
  (there the count is not determined by the map).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np
import torch

from benchmark.reference import edmap
from benchmark.yardstick import stream_seed

# rows x lanes of one block of the reference's evaluation
BLOCK_ELEMENTS = 1 << 24


def program_config(config: dict) -> dict:
    """The keyword arguments of the program's ``ModelConfig``."""
    keys = ("n_neurons", "n_spikes", "vth", "vr", "a1", "a2", "b1", "b2",
            "drive", "half_width", "t_horizon", "root_tol", "counter_max")
    out = {k: config["model"][k] for k in keys}
    out.update(n_real=config["n_real"], dtype=config["dtype"],
               evolve_window=config["evolve_window"],
               max_events=config["max_events"])
    return out


def draw_rates(config: dict, mean, gen: torch.Generator,
               device) -> torch.Tensor:
    """The ``(R, N)`` rates ``mean + sigma * noise`` of one draw, in the
    configuration's dtype, with the noise from ``gen`` on ``device``;
    ``mean`` is a float or a 0-dim tensor of that dtype."""
    dtype = getattr(torch, config["dtype"])
    noise = torch.randn((config["n_real"], config["model"]["n_neurons"]),
                        generator=gen, dtype=dtype, device=device)
    return (torch.as_tensor(mean, dtype=dtype, device=device)
            + torch.tensor(config["sigma"], dtype=dtype, device=device)
            * noise)


def sample(items: list, n: int, seed: int) -> list:
    """The answers a run checks: the one with the largest reported
    residual, and a draw from the seed of the rest, ``n`` in all."""
    if not items:
        return []
    worst = max(range(len(items)), key=lambda i: items[i]["residual_norm"])
    rest = [i for i in range(len(items)) if i != worst]
    rng = random.Random(stream_seed(seed, "sample"))
    return [items[i] for i in [worst] + rng.sample(
        rest, min(len(rest), n - 1))]


def reference_model(config: dict) -> edmap.Model:
    return edmap.Model.of(config["model"])


def _blocks(n_points: int, per_point: int):
    step = max(1, BLOCK_ELEMENTS // per_point)
    return [slice(i, min(i + step, n_points))
            for i in range(0, n_points, step)]


def reference_residuals(config: dict, Z: torch.Tensor, means: Sequence,
                        draws: torch.Tensor,
                        dtype=torch.float64) -> torch.Tensor:
    """``F`` of the reference at the points ``Z`` ``(P, M)``, point ``p``
    under its mean rate ``means[p]`` and its draw ``draws[p]`` ``(R, N)``,
    in blocks of points, in ``dtype``, on the draws' device."""
    m = reference_model(config)
    dev = draws.device
    Z = Z.to(dtype=dtype, device=dev)
    mean = torch.tensor([float(b) for b in means], dtype=dtype, device=dev)
    out = []
    for blk in _blocks(Z.shape[0], draws.shape[1] * draws.shape[2]):
        out.append(edmap.residual(m, Z[blk], mean[blk],
                                  draws[blk].to(dtype)))
    return torch.cat(out).cpu()


def claim_gap(f: torch.Tensor, claimed: Sequence[float]) -> float:
    """The largest ``| |f_p| - claimed[p] |`` over the points (NaN if any
    is NaN)."""
    gap = (torch.linalg.vector_norm(f.double(), dim=1)
           - torch.tensor(claimed, dtype=torch.float64)).abs()
    return float(gap.max()) if not gap.isnan().any() else math.nan


def solve_numbers(config: dict, Z: torch.Tensor, claimed: Sequence[float],
                  means: Sequence, draws: torch.Tensor) -> dict:
    """``claim_gap`` of checked solves."""
    return {"claim_gap": claim_gap(
        reference_residuals(config, Z, means, draws), claimed)}


def unstable_count(jacobian: np.ndarray, margin: float):
    """The equation-free map's unstable count from a Jacobian (the
    eigenvalues of ``I + J`` of modulus above 1), and whether every
    modulus lies farther than ``margin`` from 1."""
    lam = np.abs(np.linalg.eigvals(np.eye(jacobian.shape[0]) + jacobian))
    return int((lam > 1.0).sum()), bool((np.abs(lam - 1.0) > margin).all())


def sweep_numbers(config: dict, Z: torch.Tensor, claimed: Sequence[float],
                  means: Sequence, draws: torch.Tensor, eps: float,
                  counts: Sequence[Optional[int]], margin: float) -> dict:
    """``claim_gap`` and ``stability_mismatch`` of checked sweep
    steps: each point with its forward-difference stencil at ``eps``, in
    one evaluation of the reference."""
    P, M = Z.shape
    pts = (Z.double()[:, None, :]
           + torch.cat([torch.zeros(1, M, dtype=torch.float64),
                        eps * torch.eye(M, dtype=torch.float64)])[None])
    f = reference_residuals(
        config, pts.reshape(-1, M), [b for b in means for _ in range(M + 1)],
        draws.repeat_interleave(M + 1, dim=0)).reshape(P, M + 1, M)
    mismatch = 0
    for p in range(P):
        if counts[p] is None:
            continue
        jac = ((f[p, 1:] - f[p, 0]).T / eps).numpy()
        want, settled = unstable_count(jac, margin)
        mismatch += int(settled and want != counts[p])
    return {"claim_gap": claim_gap(f[:, 0], claimed),
            "stability_mismatch": float(mismatch)}


def launch_counters() -> dict:
    """The port's own launch counters of K1, K2, K2T and K9."""
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, lift_cuda, replay_cuda)
    return {"k1_launches": evolve_cuda.LAUNCHES,
            "k2_launches": replay_cuda.LAUNCHES,
            "k2t_launches": replay_cuda.TANGENT_LAUNCHES,
            "k9_launches": lift_cuda.LAUNCHES}


def compare(numbers: dict, limits: dict):
    """``(correct, checks)``: every number at or under its limit (a NaN
    fails), and ``{name: {"value", "limit"}}`` in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = ok and value <= limit
        checks[name] = {"value": value if math.isfinite(value)
                        else str(value), "limit": limit}
    return ok, checks
