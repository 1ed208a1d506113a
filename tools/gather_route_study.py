#!/usr/bin/env python3
"""Device time of K7's two bodies (staged and direct) across grid counts,
grid sizes and grid types, on one CUDA card.

    python3 tools/gather_route_study.py

The measurements behind ``ops/interp_cuda.py``'s route between the bodies
(``gather_body``): for each shape, seeded N(0, 1) grids and 16384 uniform
queries per grid (as ``chip_smoke.py`` draws them), both bodies checked
against the plain version, then each timed by ``torch.profiler`` (device
time per call, mean of 10 calls).  Prints one JSON object: per shape the
staged body's bands and query parts, the route's choice (bands, 0 for the
direct body), and the device µs of each body.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
QUERIES = 16384
SHAPES = [(B, 256, 256, dt) for dt in ("f32", "bf16")
          for B in (4, 8, 16, 32, 64, 128)] + [
    (16, 128, 128, "f32"), (64, 128, 128, "f32"), (16, 300, 300, "f32"),
    (64, 300, 300, "f32"), (16, 512, 512, "bf16"), (64, 512, 512, "f32"),
    (16, 440, 1024, "f32")]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("gather_route_study: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for B, H, W, dt in SHAPES:
        p, g = cs.interp_inputs(torch, dev, (B, H, W, QUERIES),
                                torch.float32, 0)
        if dt == "bf16":
            g = ic.bf16_grid(g)
        want = ic.gather_plain(p, g)
        bands = ic.staged_bands(H, W, g.element_size())
        row = {"bands": bands,
               "parts": ic.staged_parts(B, bands, sms) if bands else None,
               "route": ic.gather_body(p, g)}
        for body in ("staged", "direct"):
            if body == "staged" and not bands:
                continue
            err = float((ic.gather_cuda(p, g, body=body) - want).abs().max())
            cs.require(err <= cs.INTERP_BARS["f32_vs_plain"],
                       f"{body} body at {B}x{H}x{W} {dt}: {err}")
            row[f"{body}_device_us"] = cs.device_us(
                lambda: ic.gather_cuda(p, g, body=body), torch, n=10)[0]
        rows[f"{B}x{H}x{W}_{dt}"] = row
        del p, g, want
    print(json.dumps({"gather_route_study": rows, "queries_per_grid":
                      QUERIES, "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
