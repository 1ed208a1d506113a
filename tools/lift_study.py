#!/usr/bin/env python3
"""K9 and K9T of two or more checkouts, in turns in one process, on one
CUDA card.

    python3 tools/lift_study.py [--against CHECKOUT ...] [--rounds 3]
        [--calls 20] [--hot]

Loads each checkout's ``_build.py`` alone (under its own module name:
the checkouts' ``torch.library`` ops share their names, so the ops of two
packages cannot live in one process) and builds its kernel library (not
timed), then calls each library's C entry points (``atorch_lift_f32``,
``atorch_lift_f64``, ``atorch_lift_tangent_f64``, whose arguments no
checkout has changed) directly on the same CUDA tensors, at the shapes of
``chip_smoke.py``'s ``LIFT_CASES`` and ``LIFT_TANGENT_CASES`` with its
inputs (the ``Driver.cu`` guess and its forward-FD neighbours at 1e-3, one
rate; K9T along the unit directions of Z and, at D=4, the rate).  In each
of ``--rounds`` rounds the checkouts run in turns, this one first and then
the others, then back (this, others, others, this): device µs a call by
``torch.profiler`` (``chip_smoke.device_us`` over ``--calls`` calls) and
the median of ``--calls`` single calls by CUDA events.  Beside them, a
one-element fill (a one-launch floor, timed the same way).  Every output
is compared with this checkout's (equal bits) and with the plain lift
(``lift_plain``; the share of equal bits).  With ``--hot`` every timing
follows ~20 ms of float32 matrix products (4096 x 4096), as a lift on the
map's path follows milliseconds of the evolve's work, to compare the card
after load with the card after idling.  Also each checkout's registers
and spill bytes of ``csrc/lift.cu``'s kernels
(``tools/kernel_resources.py``).  Prints one JSON object.

To compare with the parent, unpack it into an ignored directory first:
``git archive HEAD | tar -x -C build/parent``, then ``--against
build/parent``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "armadillocudalinearinterpolation_torch"


def load_file(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(pt, cs, torch, dev):
    """``{name: (kind, cfg, args)}``: K9's ``(U, beta, P, N, M, stride)``
    and K9T's ``(U, beta, dU, dbeta, P, N, M, D, stride)`` at
    ``chip_smoke.py``'s shapes, and the plain outputs."""
    from armadillocudalinearinterpolation_torch.model import emap
    from armadillocudalinearinterpolation_torch.model.lift import lift_plain
    out = {}
    for name, (N, P, dtype) in cs.LIFT_CASES.items():
        cfg = pt.ModelConfig(n_neurons=N, n_real=1, dtype=dtype)
        U = emap.z_to_u(cs.fd_stack(torch, dev, cfg.torch_dtype, 1e-3)[:P])
        beta = torch.full((1,), cs.BETA, dtype=U.dtype, device=dev)
        out[name] = ("k9", cfg, (U, beta.expand(P)),
                     lift_plain(cfg, beta, U))
    for name, (N, P, D) in cs.LIFT_TANGENT_CASES.items():
        cfg = pt.ModelConfig(n_neurons=N, n_real=1, dtype="float64")
        Z = cs.fd_stack(torch, dev, torch.float64, 1e-3)[:P]
        eye = torch.eye(D, dtype=torch.float64, device=dev)
        dU = emap.z_to_u(eye[:, None, :3].expand(D, P, 3)).contiguous()
        db = eye[:, 3:].sum(-1, keepdim=True).expand(D, P).contiguous()
        beta = torch.full((1,), cs.BETA, dtype=torch.float64, device=dev)
        out[name] = ("k9t", cfg, (emap.z_to_u(Z), beta.expand(P), dU, db),
                     None)
    return out


def launcher(build, kind, cfg, args, torch):
    """A call of one checkout's kernel on ``args`` into outputs of its
    own, and those outputs."""
    consts = (cfg.a1, cfg.a2, cfg.b1, cfg.b2, cfg.drive, cfg.vth,
              cfg.half_width, cfg.dx)
    U, beta = args[:2]
    P, N, M = U.shape[0], cfg.n_neurons, cfg.n_spikes
    dev = U.device.index or 0
    v0 = torch.empty(P, N, dtype=U.dtype, device=U.device)
    s0 = torch.empty_like(v0)
    if kind == "k9":
        entry = build.entry("atorch_lift_f32" if U.dtype == torch.float32
                            else "atorch_lift_f64")
        ptrs = (U.data_ptr(), beta.data_ptr(), v0.data_ptr(), s0.data_ptr(),
                P, N, M, 0)
        outs = (v0, s0)
    else:
        dU, db = args[2:]
        D = dU.shape[0]
        dv0 = torch.empty(D, P, N, dtype=U.dtype, device=U.device)
        ds0 = torch.empty_like(dv0)
        entry = build.entry("atorch_lift_tangent_f64")
        ptrs = (U.data_ptr(), beta.data_ptr(), dU.data_ptr(), db.data_ptr(),
                v0.data_ptr(), s0.data_ptr(), dv0.data_ptr(),
                ds0.data_ptr(), P, N, M, D, 0)
        outs = (v0, s0, dv0, ds0)
    return (lambda: build.launch(entry, f"{kind} launch", dev, *ptrs,
                                 *consts)), outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--hot", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lift_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    cs = load_file("chip_smoke", ROOT / "chip_smoke.py")
    resources = load_file("kernel_resources",
                          ROOT / "tools" / "kernel_resources.py")
    import armadillocudalinearinterpolation_torch as pt
    dev = torch.device("cuda")
    checkouts = {"this": ROOT, **{str(Path(p)): Path(p).resolve()
                                  for p in a.against}}
    builds = {}
    for k, (label, path) in enumerate(checkouts.items()):
        builds[label] = load_file(f"lift_build_{k}", path / PKG / "_build.py")
        builds[label].load_library()
    order = list(checkouts) + list(reversed(checkouts))
    one = torch.zeros(1, device=dev)
    big = torch.randn(4096, 4096, device=dev)

    def heat():
        if a.hot:
            for _ in range(10):
                big @ big
    report = {"card": cs.nvidia_smi(), "device": torch.cuda.get_device_name(0),
              "order_each_round": order, "rounds": a.rounds,
              "calls": a.calls, "hot": a.hot, "cases": {},
              "registers": {label: {
                  name: res for name, res in resources.source_resources(
                      path / PKG / "csrc" / "lift.cu").items()
                  if "lift" in name} for label, path in checkouts.items()}}
    floor = []
    for name, (kind, cfg, args, plain) in cases(pt, cs, torch, dev).items():
        calls = {label: launcher(b, kind, cfg, args, torch)
                 for label, b in builds.items()}
        row = {label: {"device_us": [], "ms": []} for label in builds}
        for _ in range(a.rounds):
            for label in order:
                fn = calls[label][0]
                heat()
                row[label]["device_us"].append(
                    cs.device_us(fn, torch, n=a.calls)[0])
                heat()
                row[label]["ms"].append(cs.timed(fn, torch, n=a.calls)[0])
            heat()
            floor.append(cs.device_us(lambda: one.fill_(1.0), torch,
                                      n=a.calls)[0])
        torch.cuda.synchronize()
        ref = calls["this"][1]
        for label, (_, outs) in calls.items():
            r = row[label]
            r["device_us_median"] = statistics.median(r["device_us"])
            r["ms_median"] = statistics.median(r["ms"])
            r["equal_to_this"] = all(torch.equal(x, y)
                                     for x, y in zip(outs, ref))
            if plain is not None:
                r["equal_bits_share_vs_plain"] = float(sum(
                    (x == y).sum() for x, y in zip(outs, plain))) / (
                        2 * outs[0].numel())
        report["cases"][name] = row
    report["one_launch_floor_device_us"] = floor
    report["one_launch_floor_device_us_median"] = statistics.median(floor)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
