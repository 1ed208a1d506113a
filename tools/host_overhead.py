#!/usr/bin/env python3
"""Host time per call of the 2-D bilinear wrappers, and of the pieces of a
launch, on one CUDA card.

    python3 tools/host_overhead.py [checkout]

Imports ``armadillocudalinearinterpolation_torch`` from ``checkout``
(default: this script's repository), so that two checkouts can be compared
in one run on one card.  Each wrapper is called 1000 times back to back on a
1 x 8 x 8 grid with 2 queries, where the device time is negligible; the host
clock (``time.perf_counter``) around the calls, with one synchronise after
them, gives the host µs per call.  Prints one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

N = 1000


def per_call_us(fn, torch) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / N * 1e6


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("host_overhead: needs a CUDA card", file=sys.stderr)
        return 2
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch import _build
    from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic
    dev = torch.device("cuda")
    p = torch.rand(1, 2, 2, device=dev) * 7
    g = torch.randn(1, 8, 8, device=dev)
    p64, g64 = p.double(), g.double()
    lib = _build.load_library()
    calls = {
        "gather_cuda": lambda: ic.gather_cuda(p, g),
        "f64_cuda": lambda: ic.f64_cuda(p64, g64),
        "bilinear_batched_full": lambda: pt.bilinear_batched(p, g),
        "bilinear_batched_binned": lambda: pt.bilinear_batched(
            p, g, method="binned"),
        "bilinear_batched_f64": lambda: pt.bilinear_batched_f64(p64, g64),
        # the pieces of a launch
        "load_library": _build.load_library,
        "device_context": lambda: torch.cuda.device(dev).__enter__(),
        "current_stream_of_device": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "empty_1x2": lambda: torch.empty(1, 2, device=dev),
        "data_ptr": p.data_ptr,
        "ctypes_call_no_launch": lambda: lib.atorch_bilinear_f64(
            p64.data_ptr(), g64.data_ptr(), 0, 1, 0, 8, 8, 0),
    }
    us = {k: per_call_us(fn, torch) for k, fn in calls.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"checkout": str(root), "host_us_per_call": us,
                      "calls": N, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
