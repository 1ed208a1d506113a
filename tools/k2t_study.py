#!/usr/bin/env python3
"""K2T's layouts at config 4, and K1, K2 and K2T against another checkout,
on one CUDA card.

    python3 tools/k2t_study.py [--checkout DIR] [--against CHECKOUT]
                               [--rounds 10] [--layouts 2s,4s,8s,1d]
                               [--neurons 4096] [--rows 64] [--sigma 0.1]

Config 4 (``chip_smoke.CONFIG4``: N=4096, R=64, f64, sigma 0.1) at the
``Driver.cu`` guess, the tangents of ``F.value_and_jacobian``'s directions
(three Z seeds, and the beta axis at D=4):

* ``modes``: K2T at D=4 and D=3 on the f32 discovery's order (root-find
  mode, the replay backend) and on the fp64 direct evolve's order and time
  log (logged mode, the direct backend), at the layout's cluster: ms by
  CUDA events (median of ``--rounds``) and device µs by ``torch.profiler``
  (``chip_smoke.device_us``), with the launch's layout and waves;
* ``layouts``: K2T at D=4 and D=3, root-find mode, under each layout
  forced by replacing ``replay_cuda.replay_layout`` as a test does:
  clusters of 2, 4 and 8 in shared memory and one CTA a row with the row
  and its tangents in device memory (the alternative that keeps 64 CTAs);
* ``against`` (with ``--against``): the other checkout's package, loaded
  beside this one under another module name, and this one's, called in
  turns (one call of each a round, ``chip_smoke.timed_in_turns``): K1 at
  config 3 (N=1024, R=1024, f32, ``evolve_window=128``, one evaluation's
  evolve), K2 at config 4 (64 rows) and K2T at D=4 and D=3 (root-find
  mode; a checkout whose K2T takes a ``dbeta`` tensor gets one).

``--checkout`` times the package of another checkout (a variant of the
kernel, say) as this one; ``--layouts`` names the forced layouts (cluster
size, ``s`` for shared or ``d`` for device memory; empty: none);
``--neurons``, ``--rows`` and ``--sigma`` change config 4's N, R and
sigma (``--neurons 512 --rows 4 --sigma 0``: the walkers' shape; every
lane where N is not above config 4's window).
``chip_smoke.py`` is loaded from this repository.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "armadillocudalinearinterpolation_torch"


def load_as(name: str, checkout: Path):
    """The package of ``checkout`` imported as the module ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, checkout / PKG / "__init__.py",
        submodule_search_locations=[str(checkout / PKG)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def config4_case(pt, cs, torch, dev, D, N=4096, R=64, sigma=None):
    """K2T's arguments at config 4 for ``D`` directions: ``(args,
    logged)``, root-find mode on the f32 discovery's order, and (for a
    checkout with the time log) ``(args, kwargs)`` on the fp64 direct
    evolve's order and time log, else None.  The rates' tangents are the
    base and dp, or the older ``dbeta`` tensor."""
    emap = sys.modules[pt.__name__ + ".model.emap"]
    replay = sys.modules[pt.__name__ + ".model.replay"]
    evolve_cuda = sys.modules[pt.__name__ + ".model.evolve_cuda"]
    f64 = torch.float64
    window = cs.CONFIG4["evolve_window"]
    cfg = pt.ModelConfig(**{**cs.CONFIG4, "n_neurons": N, "n_real": R,
                            "evolve_window": window if N > window else 0})
    params = pt.MapParams.create(
        cs.BETA, cs.SIGMA if sigma is None else sigma, dtype="float64",
        device=dev)
    noise = pt.sample_noise(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    beta = pt.beta_from_noise(cfg, params, noise).contiguous()
    z = torch.tensor(cs.INITIAL_GUESS, dtype=f64, device=dev)[None]
    ii = pt.initial_spike_indices(cfg, z).contiguous()
    eye = torch.eye(D, dtype=f64, device=dev)
    dp = (eye[:, 3:].reshape(D, 1) if D == 4
          else torch.zeros(D, 1, dtype=f64, device=dev)).contiguous()
    _, _, v0, s0, dv0, ds0 = emap.lift_tangents(
        cfg, params, z, eye[:, None, :3], dp[:, :, None])
    sched, n_ev = replay.compute_schedule(cfg, v0, s0, beta, ii)
    base = torch.ones(cfg.n_real, cfg.n_neurons, dtype=f64, device=dev)
    tangent = sys.modules[pt.__name__ + ".model.replay_cuda"]
    if "dp" in inspect.signature(
            tangent.replay_events_tangent_cuda).parameters:
        extra = (base if D == 4 else None, dp)
    else:
        extra = ((dp[:, 0, None, None] * base[None]).contiguous(),)
    args = (cfg, sched, n_ev, v0, s0, beta, ii, dv0, ds0, *extra)
    logged = None
    if hasattr(emap, "direct_schedule") and len(extra) == 2:
        res, dsched, times = emap.direct_schedule(
            cfg, evolve_cuda.evolve_ensemble_cuda, v0, s0, beta, ii)
        logged = ((cfg, dsched, res.n_events, v0, s0, beta, ii, dv0, ds0,
                   *extra), {"times": times})
    return args, logged


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--checkout", type=Path, default=ROOT)
    ap.add_argument("--layouts", default="2s,4s,8s,1d")
    ap.add_argument("--neurons", type=int, default=4096)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--sigma", type=float, default=None)
    opts = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("k2t_study: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pt = load_as("pt_this", opts.checkout.resolve())
    rc = sys.modules["pt_this.model.replay_cuda"]
    out = {"card": cs.nvidia_smi(), "rounds": opts.rounds,
           "checkout": str(opts.checkout), "neurons": opts.neurons,
           "rows": opts.rows,
           "sigma": cs.SIGMA if opts.sigma is None else opts.sigma}
    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin

    def ms_and_us(fn):
        fn()
        ms = statistics.median(cs.cuda_ms(fn, torch)[0]
                               for _ in range(opts.rounds))
        _, per = cs.device_us(fn, torch, n=3)
        return ms, next((v for k, v in per.items()
                         if "replay_tangent_kernel" in k), None)

    def layout_of(D):
        return rc.replay_layout(N, 3, R, props.multi_processor_count,
                                optin,
                                props.shared_memory_per_multiprocessor,
                                "tangent", D)

    N, R = opts.neurons, opts.rows
    cases = {D: config4_case(pt, cs, torch, dev, D, N, R, opts.sigma)
             for D in (4, 3)}
    modes = {}
    for D, (args, logged) in cases.items():
        layout = layout_of(D)
        clusters = rc.tangent_clusters(layout, N, 3, D)
        for mode, (a, kw) in (("root_find", (args, {})), ("logged", logged)):
            ms, us = ms_and_us(
                lambda: rc.replay_events_tangent_cuda(*a, **kw))
            modes[f"{mode}_D{D}"] = {
                "ms": ms, "device_us": us, "layout": layout._asdict(),
                "clusters_at_once": clusters,
                "waves": -(-R // max(1, clusters))}
    out["modes"] = modes

    layouts = {}
    forced_list = [(int(x[:-1]), x[-1] == "s")
                   for x in opts.layouts.split(",") if x]
    real = rc.replay_layout
    try:
        for D, (args, logged) in cases.items():
            for cluster, in_shared in forced_list:
                own = layout_of(D)
                # the threads the layout's rule gives this cluster
                threads = rc.block_threads(
                    rc.tangent_shared_bytes(N, 3, D, cluster, in_shared),
                    -(-N // cluster), R * cluster,
                    props.multi_processor_count,
                    props.shared_memory_per_multiprocessor,
                    rc.TANGENT_THREADS_PER_SM)
                forced = rc.TangentLayout(cluster, threads, in_shared)
                where = "shared" if in_shared else "device"
                for mode, (a, kw) in (("root_find", (args, {})),
                                      ("logged", logged)):
                    rc.replay_layout = (lambda *_a, _f=forced, **_k: _f)
                    try:
                        ms, us = ms_and_us(
                            lambda: rc.replay_events_tangent_cuda(*a, **kw))
                        clusters = rc.tangent_clusters(forced, N, 3, D)
                        entry = {"ms": ms, "device_us": us,
                                 "layout": forced._asdict(),
                                 "clusters_at_once": clusters,
                                 "waves": -(-R // max(1, clusters)),
                                 "default": forced == own}
                    except RuntimeError as err:
                        entry = {"layout": forced._asdict(),
                                 "refused": str(err)[:200]}
                    finally:
                        rc.replay_layout = real
                    layouts[f"{mode}_D{D}_C{cluster}_{where}"] = entry
    finally:
        rc.replay_layout = real
    out["layouts"] = layouts

    if opts.against is not None:
        other = load_as("pt_other", opts.against.resolve())
        ocases = {D: config4_case(other, cs, torch, dev, D)[0]
                  for D in (4, 3)}
        fns = {}
        for tag, pkg in (("this", pt), ("other", other)):
            ev = sys.modules[pkg.__name__ + ".model.evolve_cuda"]
            rp = sys.modules[pkg.__name__ + ".model.replay_cuda"]
            cfg3 = pkg.ModelConfig(n_neurons=cs.MAP_N, n_real=cs.MAP_R,
                                   dtype="float32",
                                   evolve_window=cs.MAP_WINDOW)
            p3 = pkg.MapParams.create(cs.BETA, cs.SIGMA, dtype="float32",
                                      device=dev)
            b3 = pkg.sample_beta(cfg3, p3,
                                 torch.Generator(device=dev).manual_seed(0))
            z0 = torch.tensor(cs.INITIAL_GUESS, dtype=torch.float32,
                              device=dev)[None]
            v3, s3 = pkg.lift(cfg3, p3, pkg.z_to_u(z0))
            ii3 = pkg.initial_spike_indices(cfg3, z0).contiguous()
            k1 = (cfg3, v3.contiguous(), s3.contiguous(), b3, ii3)
            c4 = {D: cases[D][0] if pkg is pt else ocases[D]
                  for D in (4, 3)}
            fns[f"k1_config3_{tag}"] = (
                lambda ev=ev, k1=k1: ev.evolve_ensemble_cuda(*k1))
            fns[f"k2_config4_{tag}"] = (
                lambda rp=rp, a=c4[4]: rp.replay_events_cuda(*a[:7]))
            for D in (4, 3):
                fns[f"k2t_D{D}_{tag}"] = (
                    lambda rp=rp, a=c4[D]: rp.replay_events_tangent_cuda(*a))
        order = sorted(fns, key=lambda k: (k.rsplit("_", 1)[0],
                                           k.endswith("other")))
        # this, other; then other, this: each kernel's pair in both orders
        rounds = {k: [] for k in fns}
        for r in range(opts.rounds):
            for i in range(0, len(order), 2):
                pair = order[i:i + 2] if r % 2 == 0 else order[i:i + 2][::-1]
                for k in pair:
                    rounds[k].append(cs.cuda_ms(fns[k], torch)[0])
        out["against"] = {"checkout": str(opts.against),
                          "ms_median": {k: statistics.median(v)
                                        for k, v in rounds.items()},
                          "ms_all": rounds}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
