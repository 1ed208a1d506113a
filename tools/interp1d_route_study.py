#!/usr/bin/env python3
"""Whole-route times of the 1-D entry points' two routes on one CUDA card.

    python3 tools/interp1d_route_study.py

The measurements behind ``ops/interp1d_cuda.py``'s routes (the entry
points take the direct kernels; the sorted routes are reached through
``lerp1d_binned`` and ``method="sorted"``): for every table
size in ``NODES`` (1k to ``MAX_TABLE``), query count in ``QUERIES``
(131072 to 10M) and query distribution (uniform over the table and a
margin; the same values already sorted; clustered: normal around one node
with 1% of the table's width), seeded with numpy,

- uniform nodes: ``torch.sort`` of the batches + K4 (``lerp1d_binned``
  with the entry's batch count) against K3 (``lerp1d_cuda``);
- non-uniform nodes (gaps 0.1 + U[0, 1)): the sort + K5 (``Interp1d`` with
  ``method="sorted"``) against K5 direct (``method="direct"``);

each route's result against the other's (they compute the same values:
0.0 required), then the device time of one call (``torch.profiler``, every
kernel the call launches, mean of 5 calls) and its wall time (CUDA events
around the Python call, median of 10 warm calls).  Prints one JSON object:
the table of rows, for each kind the shapes where the sorted route's
device time beats the direct one's, and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NODES = (1024, 4096, 8193, 16384, 65536)
QUERIES = (131_072, 1_048_576, 2_097_152, 10_000_000)
DISTRIBUTIONS = ("uniform", "sorted", "clustered")


def queries(np, dist, Q, lo, hi, seed):
    rng = np.random.default_rng(seed)
    if dist == "clustered":
        q = rng.normal(lo + 0.37 * (hi - lo), 0.01 * (hi - lo), Q)
    else:
        q = rng.uniform(lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo), Q)
    if dist == "sorted":
        q = np.sort(q)
    return q.astype(np.float32)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("interp1d_route_study: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from armadillocudalinearinterpolation_torch.ops import interp1d_cuda as i1
    dev = torch.device("cuda")
    rows, sorted_wins = [], {"lerp1d": [], "interp1d": []}
    for n in NODES:
        fp_h, x0, dx = cs.sin_table(n)
        xp_h, fpn_h = cs.gap_nodes(n, 12)
        fp = torch.from_numpy(fp_h).to(dev)
        table = i1.make_interp1d(torch.from_numpy(xp_h).to(dev),
                                 torch.from_numpy(fpn_h).to(dev))
        lims = i1.uniform_lims(x0, dx)
        for Q in QUERIES:
            nb = i1._pow2_batches(Q)
            for dist in DISTRIBUTIONS:
                qu = torch.from_numpy(queries(np, dist, Q, -3.0, 3.0,
                                              n + Q)).to(dev)
                qn = torch.from_numpy(queries(np, dist, Q, 0.0,
                                              float(xp_h[-1]), n + Q)).to(dev)
                routes = {
                    "lerp1d_direct": lambda: i1.lerp1d_cuda(qu, fp, *lims),
                    "lerp1d_sorted": lambda: i1.lerp1d_binned(
                        qu, fp, x0, dx, n_batches=nb),
                    "interp1d_direct": lambda: table(qn, method="direct"),
                    "interp1d_sorted": lambda: table(qn, method="sorted"),
                }
                row = {"nodes": n, "queries": Q, "distribution": dist,
                       "n_batches": nb}
                for kind in ("lerp1d", "interp1d"):
                    a, b = routes[f"{kind}_direct"](), routes[f"{kind}_sorted"]()
                    err = cs.nan_aware_err(a, b)
                    cs.require(err == 0.0, f"{kind} routes differ by {err} "
                               f"at {n} nodes, {Q} {dist} queries")
                    for route in ("direct", "sorted"):
                        fn = routes[f"{kind}_{route}"]
                        row[f"{kind}_{route}_device_us"] = cs.device_us(
                            fn, torch)[0]
                        row[f"{kind}_{route}_ms"] = cs.timed(fn, torch,
                                                             n=10)[0]
                    t_sorted = row[f"{kind}_sorted_device_us"]
                    t_direct = row[f"{kind}_direct_device_us"]
                    if None not in (t_sorted, t_direct) and t_sorted < t_direct:
                        sorted_wins[kind].append([n, Q, dist])
                rows.append(row)
                del qu, qn
    print(json.dumps({"interp1d_route_study": rows,
                      "sorted_route_wins_on_the_device": sorted_wins,
                      "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
