#!/usr/bin/env python3
"""K5's bodies by table size and query distribution on one CUDA card.

    python3 tools/interp1d_body_study.py [checkout] [--nodes 4096,65536]
        [--distributions uniform,sorted]

Imports ``armadillocudalinearinterpolation_torch`` from ``checkout``
(default: this script's repository), so that the parent and the change
compare in one run on one card (run it once for each, in turns).  For
every node count in ``NODES`` (non-uniform nodes, gaps 0.1 + U[0, 1), as
the bench makes them) and query distribution (uniform over the table and a
5% margin; the same values already sorted; clustered: normal around one
node with 1% of the table's width), 2,097,152 queries seeded with numpy:

- the direct mode, ``interp1d_cuda(table, q)``, with the body it ran;
- the sorted mode's kernel on batches :func:`sort_batches` made
  beforehand (the entry's batch count), with the body it ran;

each against the plain version (0.0 required), its device µs by
``torch.profiler`` (mean of 5 calls) and its bound: the bytes the mode
moves (direct: the queries, ``nodes``, ``bucket`` and the output; sorted:
also ``order``) at 3.35 TB/s.  A checkout without named bodies reports
``"body": null``.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NODES = (1024, 4096, 8192, 12672, 12673, 65536)
QUERIES = 2_097_152
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
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=str(ROOT))
    ap.add_argument("--nodes", default=",".join(map(str, NODES)))
    ap.add_argument("--distributions", default=",".join(DISTRIBUTIONS))
    a = ap.parse_args()
    checkout = Path(a.checkout).resolve()
    node_counts = [int(v) for v in a.nodes.split(",")]
    distributions = a.distributions.split(",")
    # this repository's chip_smoke.py (its helpers import nothing at load
    # time), then the package from the checkout
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("interp1d_body_study: needs a CUDA card", file=sys.stderr)
        return 2
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.ops import interp1d_cuda as i1
    assert Path(pt.__file__).resolve().is_relative_to(checkout)
    dev = torch.device("cuda")
    bodies = getattr(i1, "BODIES", None)

    def run(fn):
        before = dict(bodies) if bodies is not None else {}
        out = fn()
        torch.cuda.synchronize()
        ran = [k for k in before if bodies[k] != before[k]]
        return out, (ran[0] if ran else None)

    rows = []
    Q = QUERIES
    nb = i1._pow2_batches(Q)
    for n in node_counts:
        xp_h, fp_h = cs.gap_nodes(n, 12)
        table = pt.make_interp1d(torch.from_numpy(xp_h).to(dev),
                                 torch.from_numpy(fp_h).to(dev))
        for dist in distributions:
            q = torch.from_numpy(queries(np, dist, Q, 0.0, float(xp_h[-1]),
                                         n + 7)).to(dev)
            qs, order = i1.sort_batches(q, nb)

            def direct():
                return i1.interp1d_cuda(table, q)

            def sorted_():
                try:
                    return i1.interp1d_cuda(table, qs, order, Q, nb)
                except TypeError:        # a checkout without n_batches
                    return i1.interp1d_cuda(table, qs, order, Q)

            want = i1.interp1d_plain(table, q)
            row = {"nodes": n, "buckets": table.m, "S": table.S,
                   "queries": Q, "distribution": dist, "n_batches": nb}
            for mode, fn, io in (
                    ("direct", direct, (q, table.nodes, table.bucket)),
                    ("sorted", sorted_, (qs, order, table.nodes,
                                         table.bucket))):
                out, body = run(fn)
                err = cs.nan_aware_err(out, want)
                cs.require(err == 0.0, f"{mode} differs from plain by {err} "
                           f"at {n} nodes, {dist} queries")
                b_ms, _ = cs.bound(cs.nbytes(*io, out), 0, "float32")
                dev_us = cs.device_us(fn, torch)[0]
                row[mode] = {"body": body, "device_us": dev_us,
                             "bound_us": b_ms * 1e3,
                             "share_of_bound": (b_ms * 1e3 / dev_us
                                                if dev_us else None)}
            rows.append(row)
            del q, qs, order, want
    print(json.dumps({"checkout": str(checkout),
                      "interp1d_body_study": rows,
                      "card": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
