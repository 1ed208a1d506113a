#!/usr/bin/env python3
"""Host time per call of the 2-D bilinear wrappers, of K1's, K2's and
K2T's wrappers, and of the pieces of a launch, on one CUDA card.

    python3 tools/host_overhead.py [checkout] [--against parent_checkout]

Imports ``armadillocudalinearinterpolation_torch`` from ``checkout``
(default: this script's repository), so that two checkouts can be compared
in one run on one card.  Each wrapper is called 1000 times back to back on a
1 x 8 x 8 grid with 2 queries, where the device time is negligible; the host
clock (``time.perf_counter``) around the calls, with one synchronise after
them, gives the host µs per call.  The pieces of the f64 entry's launch
path (``f64_*``) are timed where the checkout has them; a piece the
checkout lacks is left out.  Where the checkout's K1, K2 and K2T are
``torch.library`` ops, each is also timed through the op (the dispatcher)
and as the op's CUDA kernel called alone (``map_ops``, from
``chip_smoke.map_op_calls``: N=256, one row, K1 to a horizon of 0.01, K2
and K2T on an empty log).  With ``--against``, the other checkout's
package is loaded beside it in the same process (under another module
name) and the wrappers of the two are timed in turns, seven rounds each,
once fresh and once after a ``torch.profiler`` session over a large f64
call (as ``chip_smoke.py`` measures its host times after profiling), so
that the host's drift between processes cancels.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 1000
ROUNDS = 7
PKG = "armadillocudalinearinterpolation_torch"


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


def load_as(name: str, checkout: Path):
    """The package of ``checkout`` imported as the module ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, checkout / PKG / "__init__.py",
        submodule_search_locations=[str(checkout / PKG)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def wrapper_calls(pkg, p, g):
    """The host-bound wrapper calls of one package on tiny inputs."""
    ic = sys.modules[pkg.__name__ + ".ops.interp_cuda"]
    p64, g64 = p.double(), g.double()
    return {"f64_cuda": lambda: ic.f64_cuda(p64, g64),
            "bilinear_batched_f64": lambda: pkg.bilinear_batched_f64(p64,
                                                                     g64),
            "gather_cuda": lambda: ic.gather_cuda(p, g),
            "bilinear_batched_full": lambda: pkg.bilinear_batched(p, g)}


def map_wrapper_calls(pkg, inputs):
    """K1's, K2's and K2T's wrappers of one package on ``inputs`` (those
    of ``chip_smoke.map_op_calls``' size)."""
    ec = sys.modules[pkg.__name__ + ".model.evolve_cuda"]
    rc = sys.modules[pkg.__name__ + ".model.replay_cuda"]
    cfg, v0, s0, beta, ii, sched, n0, dv, dp = inputs
    return {"evolve_ensemble_cuda": lambda: ec.evolve_ensemble_cuda(
                cfg, v0, s0, beta, ii),
            "replay_events_cuda": lambda: rc.replay_events_cuda(
                cfg, sched, n0, v0, s0, beta, ii),
            "replay_events_tangent_cuda": lambda:
                rc.replay_events_tangent_cuda(cfg, sched, n0, v0, s0, beta,
                                              ii, dv, dv, None, dp)}


def map_inputs(pt, torch, dev):
    f64 = torch.float64
    cfg = pt.ModelConfig(n_neurons=256, n_real=1, dtype="float64",
                         t_horizon=0.01)
    params = pt.MapParams.create(13.0589, 0.0, dtype="float64", device=dev)
    Z = torch.tensor([[0.3310, 0.6914, 1.3557]], dtype=f64, device=dev)
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params, pt.z_to_u(Z)))
    return (cfg, v0, s0, torch.full((1, 256), 13.0589, dtype=f64,
                                    device=dev),
            pt.initial_spike_indices(cfg, Z).contiguous(),
            torch.zeros(1, 128, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.ones(3, 1, 256, dtype=f64, device=dev),
            torch.zeros(3, 1, dtype=f64, device=dev))


def in_turns(torch, change, parent, p, g) -> dict:
    """Median host µs per call of each wrapper of both packages, timed in
    turns (parent, change) for ROUNDS rounds."""
    return calls_in_turns(torch, wrapper_calls(parent, p, g),
                          wrapper_calls(change, p, g))


def calls_in_turns(torch, a, b) -> dict:
    """Median host µs per call of each call of ``a`` (the parent's) and
    ``b`` (the change's), timed in turns for ROUNDS rounds."""
    out = {}
    for key in a:
        ta, tb = [], []
        for _ in range(ROUNDS):
            ta.append(per_call_us(a[key], torch))
            tb.append(per_call_us(b[key], torch))
        pa, pb = statistics.median(ta), statistics.median(tb)
        out[key] = {"parent_us": pa, "change_us": pb,
                    "change_below_parent": 1 - pb / pa}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?",
                    default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--against", default=None)
    a = ap.parse_args()
    root = Path(a.checkout).resolve()
    # this repository's chip_smoke.py (its helpers import nothing at load
    # time), then the package from the checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
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
    # the f64 entry's launch path, piece by piece (the C function called
    # with Q = 0 returns before the launch; with Q = 2 it launches K6)
    f64_fn = lib.atorch_bilinear_f64
    out = torch.empty(1, 2, dtype=torch.float64, device=dev)
    ptrs = (p64.data_ptr(), g64.data_ptr(), out.data_ptr())
    stream = torch._C._cuda_getCurrentRawStream(0)
    calls.update({
        "f64_new_empty_1x2": lambda: p64.new_empty((1, 2)),
        "f64_get_device": p64.get_device,
        "f64_raw_device": torch._C._cuda_getDevice,
        "f64_ctypes_call_no_launch": lambda: f64_fn(*ptrs, 1, 0, 8, 8,
                                                        stream),
        "f64_ctypes_call_launch": lambda: f64_fn(*ptrs, 1, 2, 8, 8,
                                                     stream),
    })
    if hasattr(ic, "_f64_dims"):
        calls["f64_dims"] = lambda: ic._f64_dims(p64, g64)
    if hasattr(_build, "entry"):
        calls["f64_bound_entry"] = lambda: _build.entry(
            "atorch_bilinear_f64")
        calls["f64_launch_helper_no_launch"] = lambda: _build.launch(
            f64_fn, "f64", 0, *ptrs, 1, 0, 8, 8)
    us = {k: per_call_us(fn, torch) for k, fn in calls.items()}
    row = {"checkout": str(root), "host_us_per_call": us, "calls": N}
    ec = sys.modules[pt.__name__ + ".model.evolve_cuda"]
    if hasattr(ec, "evolve_op"):
        row["map_ops"] = {}
        for name, (op, alone) in cs.map_op_calls(pt, torch, dev).items():
            t_alone, t_op = [], []
            for _ in range(ROUNDS):
                t_alone.append(per_call_us(alone, torch))
                t_op.append(per_call_us(op, torch))
            row["map_ops"][name] = {
                "kernel_alone_us": statistics.median(t_alone),
                "through_op_us": statistics.median(t_op)}
    if a.against:
        parent = load_as("parent_pkg", Path(a.against).resolve())
        row["against"] = str(Path(a.against).resolve())
        inputs = map_inputs(pt, torch, dev)
        row["map_wrappers_in_turns"] = calls_in_turns(
            torch, map_wrapper_calls(parent, inputs),
            map_wrapper_calls(pt, inputs))
        row["in_turns_fresh"] = in_turns(torch, pt, parent, p, g)
        # a profiler session over the bench's f64 leg, as chip_smoke.py
        # runs before it measures host times
        pb, gb = cs.interp_inputs(torch, dev, cs.INTERP_F64, torch.float64,
                                  2)
        for pkg in (parent, pt):
            cs.device_us(lambda: pkg.bilinear_batched_f64(pb, gb), torch)
        del pb, gb
        row["in_turns_after_profile"] = in_turns(torch, pt, parent, p, g)
    row["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
