#!/usr/bin/env python3
"""K6, the f64 bilinear call, on one CUDA card: device time, single-call
time and host time, beside ``grid_sample``'s f64 call.

    python3 tools/bilinear_f64_study.py [checkout]

Imports ``armadillocudalinearinterpolation_torch`` from ``checkout``
(default: this script's repository), so that the parent, the change and
copies of the package with another kernel constant (``build/variants/<v>``,
made with ``sed``) compare in one run on one card.  At the bench's f64 leg
(16 grids of 256 x 256, 16384 queries a grid, f64, seeded as
``chip_smoke.py`` seeds it): ``bilinear_batched_f64`` against ``f64_plain``
and the host-double formula; its device µs by ``torch.profiler`` (mean of
5 calls), its single-call ms (CUDA events around one Python call, median of
20 warm) and back-to-back ms (mean of 20), the same for ``grid_sample``
(border padding, ``align_corners=True``, coordinates normalised
beforehand), the two single calls again in turns (one of each a round, 20
rounds), and the host µs per call of ``f64_cuda`` and of the entry on a
1 x 8 x 8 grid (1000 calls).  Prints one JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    checkout = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    # this repository's chip_smoke.py (its helpers import nothing at load
    # time), then the package from the checkout
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    import torch
    if not torch.cuda.is_available():
        print("bilinear_f64_study: needs a CUDA card", file=sys.stderr)
        return 2
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic
    assert Path(pt.__file__).resolve().is_relative_to(checkout)
    dev = torch.device("cuda")
    shape = cs.INTERP_F64
    p64, g64 = cs.interp_inputs(torch, dev, shape, torch.float64, 2)
    out = pt.bilinear_batched_f64(p64, g64)
    torch.cuda.synchronize()
    errs = {"vs_plain": cs.max_abs(out, ic.f64_plain(p64, g64)),
            "vs_host_double": cs.max_abs(out, cs.host_double(p64, g64))}
    H, W = shape[1:3]
    g4 = g64[:, None]
    q4 = torch.stack([p64[..., 1] / (W - 1) * 2 - 1,
                      p64[..., 0] / (H - 1) * 2 - 1], dim=-1)[:, None]

    def grid_sample():
        return torch.nn.functional.grid_sample(
            g4, q4, mode="bilinear", padding_mode="border",
            align_corners=True)[:, 0, 0]

    calls = {"entry": lambda: pt.bilinear_batched_f64(p64, g64),
             "grid_sample": grid_sample}
    row = {"checkout": str(checkout), "shape": shape, "max_abs_err": errs}
    for key, fn in calls.items():
        single, b2b = cs.timed(fn, torch)
        dev_us, kernels = cs.device_us(fn, torch)
        row[key] = {"ms_median_of_20": single,
                    "ms_back_to_back_mean_of_20": b2b,
                    "device_us": dev_us, "device_us_by_kernel": kernels}
    pT, gT = cs.interp_inputs(torch, dev, (1, 8, 8, 2), torch.float64, 5)
    row["ms_median_of_20_in_turns"] = cs.timed_in_turns(calls, torch)
    row["host_us_per_call_of_1000"] = {
        "f64_cuda": cs.host_us(lambda: ic.f64_cuda(pT, gT), torch),
        "bilinear_batched_f64": cs.host_us(
            lambda: pt.bilinear_batched_f64(pT, gT), torch)}
    row["bound_ms"] = cs.bound(cs.nbytes(p64, g64, out),
                               cs.BILINEAR_OPS_PER_QUERY * out.numel(),
                               "float64")[0]
    row["card"] = cs.nvidia_smi()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
