#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds the evolve
kernel against its plain PyTorch version on the card (f32 and f64, and at
the shapes the slice gives it), runs the reference's
``Driver.cu`` program through the public API (``make_residual_fn`` ->
``newton_solve`` -> ``num_unstable_eigenvalues`` at N=512, R=1000, f32),
and times one map evaluation at N=1024, R=1024.  Then the batched 2-D
bilinear path (``interp2d``): ``bilinear_batched`` at BASELINE config 2
(64 grids of 256x256, 1M queries, f32; ``method="auto"`` -> the gather
kernel), its large-grid leg (8 x 1024x1024, 1M queries; ``auto`` -> the
bin-window kernel) and its fp64 leg (``bilinear_batched_f64``, 16 x
256x256); each kernel against its plain version and a host-double oracle,
and timed.  Each phase prints one JSON object; any failed check raises and
the script exits non-zero.  The last line is ``{"ok": true, "device":
{...}}``; before it come the card's name and power limit as ``nvidia-smi``
prints them and a ``{"kernels": [...]}`` line.  Imports no JAX.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "armadillocudalinearinterpolation_torch"

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)       # Driver.cu initial guess
BETA, SIGMA = 13.0589, 0.1
# f64 fixed point of the JAX package at sigma=0.1, N=512, R=4 (CPU)
REFERENCE_POINT = (0.3262, 0.7205, 1.3703)
# sizes: the slice at the reference's scale, the map timing at config 3
SLICE_N, SLICE_R = 512, 1000
# Driver.cu differences with eps = 1e-2.  From its guess the JAX package's
# forward-FD Newton does not converge in 10 iterations with that step (CPU,
# N=512: R=4 in f32 and f64 at sigma 0 and 0.1, and R=1000 in f32 at sigma
# 0.1), and converges in 2-4 iterations with 3e-4 in every one of those.
SLICE_FD_EPSILON = 3e-4
MAP_N, MAP_R = 1024, 1024
TARGETS = {"float64": {"identical": 0.99, "time": 1e-9, "residual": 1e-8},
           "float32": {"identical": 0.95, "time": None, "residual": 2e-5}}
# interp2d: BASELINE config 2 (bench.py:120-149) and its fp64 and large-grid
# legs (bench.py:249-319), as (grids, H, W, queries per grid)
INTERP_F32 = (64, 256, 256, 16384)
INTERP_LARGE = (8, 1024, 1024, 131072)
INTERP_F64 = (16, 256, 256, 16384)
INTERP_SMALL = (2, 64, 128, 1501)      # with out-of-range queries
INTERP_ONE_BIN = (1, 256, 256, 4096)   # every query in [40, 41)^2
# kernel vs plain: the same operation order without fused multiply-adds
# (expect 0.0); bf16 grid vs exact (tests/test_interp_pallas.py:79); f64
# (:203); f32 vs the host-double formula: rounding of three lerps of N(0,1)
# values is a few 1e-7
INTERP_BARS = {"f32_vs_plain": 1e-6, "bf16_vs_exact": 0.05, "f64": 1e-13,
               "f32_vs_host_double": 1e-5}
INTERP_SRC = f"{PKG}/csrc/interp2d.cu"
INTERP_TPU = "armadillocudalinearinterpolation_tpu/ops/interp_pallas.py"


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, torch):
    """Wall time of ``fn()`` on the card in ms, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def fd_stack(torch, dev, dtype, eps):
    """The Driver.cu guess and its three forward-FD perturbations."""
    z0 = torch.tensor(INITIAL_GUESS, dtype=dtype, device=dev)
    return torch.cat([z0[None], z0[None] + eps * torch.eye(
        3, dtype=dtype, device=dev)])


def kernel_vs_plain(pt, torch, dev, dtype: str, n_real: int, Z):
    """K1 and its plain version on the same inputs: the lifts of the stack
    ``Z`` at N=512 under the seed-0 draw of ``n_real`` realisations."""
    from armadillocudalinearinterpolation_torch.model import emap, evolve_cuda
    from armadillocudalinearinterpolation_torch.model.evolve import (
        evolve_ensemble)
    cfg = pt.ModelConfig(n_neurons=SLICE_N, n_real=n_real, dtype=dtype)
    params = pt.MapParams.create(BETA, SIGMA, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    beta = pt.sample_beta(cfg, params, gen, device=dev)
    P = Z.shape[0]
    U = emap.z_to_u(Z)
    init_ind = pt.initial_spike_indices(cfg, Z).contiguous()
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params, U))

    k_ms, rk = cuda_ms(lambda: evolve_cuda.evolve_ensemble_cuda(
        cfg, v0, s0, beta, init_ind), torch)
    p_ms, rp = cuda_ms(lambda: evolve_ensemble(cfg, v0, s0, beta, init_ind),
                       torch)

    same = ((rk.last_ind == rp.last_ind).all(1)
            & (rk.crossed_ind == rp.crossed_ind).all(1)
            & (rk.accept == rp.accept) & (rk.n_events == rp.n_events))
    if bool(same.any()):
        dtime = max(float((rk.last_time - rp.last_time)[same].abs().max()),
                    float((rk.crossed_time - rp.crossed_time)[same]
                          .abs().max()))
    else:
        dtime = math.inf

    def residual(res):
        pos = pt.restrict_positions(cfg, res).reshape(P, n_real, 3)
        mean, _ = pt.masked_ensemble_mean(pos, res.accept.reshape(P, -1))
        return emap.assemble_residual(cfg, U, mean)

    fk, fp = residual(rk), residual(rp)
    dres = float((fk - fp).abs().max())
    row = {"phase": "kernel_vs_plain", "dtype": dtype, "N": SLICE_N,
           "R": n_real, "P": P, "rows": int(same.numel()),
           "identical_share": float(same.float().mean()),
           "max_time_diff_identical_rows": dtime,
           "max_residual_diff": dres,
           "residual_finite": bool(torch.isfinite(fk).all()),
           "kernel_ms_single_call": k_ms, "plain_ms_single_call": p_ms,
           "targets": TARGETS[dtype]}
    emit(row)
    tg, what = TARGETS[dtype], f"{dtype} P={P} R={n_real}"
    require(row["residual_finite"], f"{what}: non-finite residual")
    require(row["identical_share"] >= tg["identical"],
            f"{what}: identical rows {row['identical_share']:.4f} < "
            f"{tg['identical']}")
    if tg["time"] is not None:
        require(dtime <= tg["time"], f"{what}: time diff {dtime} > "
                f"{tg['time']}")
    require(dres <= tg["residual"], f"{what}: residual diff {dres} > "
            f"{tg['residual']}")
    return row


def run_slice(pt, torch, dev):
    """The Driver.cu program through the public API, on the kernel."""
    from armadillocudalinearinterpolation_torch.model import evolve_cuda
    cfg = pt.ModelConfig(n_neurons=SLICE_N, n_real=SLICE_R, dtype="float32")
    params = pt.MapParams.create(BETA, SIGMA, dtype="float32", device=dev)
    ncfg = pt.NewtonConfig(tolerance=1e-4, max_iterations=10,
                           fd_epsilon=SLICE_FD_EPSILON, print_output=True)
    F = pt.make_residual_fn(cfg, params, 0, device=dev)
    evals = 0

    def counted(Z):
        nonlocal evals
        evals += 1
        return F(Z)

    z0 = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    evolve_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    res = pt.newton_solve(counted, z0, ncfg)
    n_unstable = pt.num_unstable_eigenvalues(
        counted, res.solution, pt.ProblemType.EQUATION_FREE,
        jacobian=res.jacobian)
    ev = pt.compute_eigenvalues(counted, res.solution,
                                pt.ProblemType.EQUATION_FREE,
                                jacobian=res.jacobian)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = evolve_cuda.LAUNCHES

    sol = res.solution.double().cpu()
    dist = float((sol - torch.tensor(REFERENCE_POINT,
                                     dtype=torch.float64)).abs().max())
    row = {"phase": "slice", "N": SLICE_N, "R": SLICE_R, "dtype": "float32",
           "converged": res.converged, "iterations": res.iterations,
           "residual_norm": res.residual_norm,
           "residual_history": [float(x) for x in
                                res.residual_history[:res.iterations + 1]],
           "solution": sol.tolist(), "distance_to_reference": dist,
           "eigenvalues": [[float(e.real), float(e.imag)] for e in ev],
           "n_unstable": n_unstable, "map_evaluations": evals,
           "evolve_launches": launches, "wall_s": wall}
    emit(row)
    require(res.converged, "slice: Newton did not converge")
    require(res.residual_norm <= 1e-4, "slice: |F| > 1e-4")
    require(bool(torch.isfinite(sol).all()), "slice: non-finite solution")
    require(dist <= 2e-2, f"slice: solution {dist} from the reference point")
    require(launches == evals, f"slice: {launches} kernel launches for "
            f"{evals} map evaluations")
    return row


def map_eval(pt, torch, dev, smi: str):
    """One map evaluation at config 3 (N=1024, R=1024, sigma=0.1, f32):
    the kernel against the plain version on the card, in turns."""
    cfg = pt.ModelConfig(n_neurons=MAP_N, n_real=MAP_R, dtype="float32")
    params = pt.MapParams.create(BETA, SIGMA, dtype="float32", device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    Fk = pt.make_residual_fn(cfg, params, 0, device=dev, beta=beta,
                             evolve_backend="cuda")
    Fp = pt.make_residual_fn(cfg, params, 0, device=dev, beta=beta,
                             evolve_backend="torch")
    z0 = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    fk, fp = Fk(z0), Fp(z0)                   # warm-up
    torch.cuda.synchronize()
    k_ms, p_ms = [], []
    for i in range(6):
        k_ms.append(cuda_ms(lambda: Fk(z0), torch)[0])
        if i < 3:
            p_ms.append(cuda_ms(lambda: Fp(z0), torch)[0])

    # one kernel evaluation, layer by layer
    from armadillocudalinearinterpolation_torch.model import emap, evolve_cuda
    from armadillocudalinearinterpolation_torch.model.evolve import (
        evolve_ensemble)
    from armadillocudalinearinterpolation_torch.solvers.linalg import (
        solve_dense)
    U = emap.z_to_u(z0[None])
    init_ind, (v0, s0) = (pt.initial_spike_indices(cfg, z0[None]),
                          pt.lift(cfg, params, U))
    res = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, init_ind)

    def restrict():
        pos = pt.restrict_positions(cfg, res).reshape(1, MAP_R, -1)
        mean, _ = pt.masked_ensemble_mean(pos, res.accept.reshape(1, -1))
        return emap.assemble_residual(cfg, U, mean)

    jac = torch.eye(3, device=dev) + 0.1
    stages = {
        "lift": lambda: (pt.initial_spike_indices(cfg, z0[None]),
                         pt.lift(cfg, params, U)),
        "evolve": lambda: evolve_cuda.evolve_ensemble_cuda(
            cfg, v0, s0, beta, init_ind),
        "restrict_mean_residual": restrict,
        "newton_solve_3x3": lambda: solve_dense(jac, fk),
    }
    layers = {name: statistics.median(cuda_ms(fn, torch)[0]
                                      for _ in range(5))
              for name, fn in stages.items()}
    # the plain evolve alone, on the same inputs as the kernel's "evolve"
    plain_evolve = statistics.median(
        cuda_ms(lambda: evolve_ensemble(cfg, v0, s0, beta, init_ind),
                torch)[0] for _ in range(3))
    row = {"phase": "map_eval", "N": MAP_N, "R": MAP_R, "dtype": "float32",
           "kernel_ms_median": statistics.median(k_ms),
           "kernel_ms": k_ms,
           "plain_ms_median": statistics.median(p_ms), "plain_ms": p_ms,
           "residual_diff": float((fk - fp).abs().max()),
           "layers_ms_median_of_5": layers,
           "plain_evolve_ms_median_of_3": plain_evolve,
           "card": smi}
    emit(row)
    require(bool(torch.isfinite(fk).all()), "map_eval: non-finite residual")
    return row


def interp_inputs(torch, dev, shape, dtype, seed, lo=0.0, hi=None):
    """Seeded N(0, 1) grids and queries uniform in ``[lo, hi)`` (default
    ``[0, H-1)``, as bench.py draws them), made with numpy, on the card."""
    import numpy as np
    B, H, W, Q = shape
    rng = np.random.default_rng(seed)
    hi = H - 1.0 if hi is None else hi
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    grids = rng.standard_normal((B, H, W)).astype(np_dtype)
    pts = rng.uniform(lo, hi, (B, Q, 2)).astype(np_dtype)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(grids).to(dev)


def host_double(pts, grids):
    """The 4-term bilinear formula in numpy float64
    (tests/test_interp_pallas.py:191-203), as a CPU tensor."""
    import numpy as np
    import torch
    g = grids.cpu().double().numpy()
    p = pts.cpu().double().numpy()
    B, H, W = g.shape
    r = np.clip(p[..., 0], 0, H - 1.0)
    c = np.clip(p[..., 1], 0, W - 1.0)
    r0 = np.clip(np.floor(r).astype(int), 0, H - 2)
    c0 = np.clip(np.floor(c).astype(int), 0, W - 2)
    tr, tc = r - r0, c - c0
    bi = np.arange(B)[:, None]
    return torch.from_numpy((1 - tr) * (1 - tc) * g[bi, r0, c0]
                            + (1 - tr) * tc * g[bi, r0, c0 + 1]
                            + tr * (1 - tc) * g[bi, r0 + 1, c0]
                            + tr * tc * g[bi, r0 + 1, c0 + 1])


def max_abs(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def timed(fn, torch, n=20):
    """Median ms of ``n`` warm single calls (CUDA events around each), and
    the mean ms of ``n`` calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    single = statistics.median(cuda_ms(fn, torch)[0] for _ in range(n))
    total, _ = cuda_ms(lambda: [fn() for _ in range(n)], torch)
    return single, total / n


def interp2d(pt, torch, dev, smi: str):
    """The batched 2-D bilinear path: the three legs through the public
    entry points with the launch counts set to 0 just before each and read
    just after; each kernel against its plain version; timings."""
    from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic
    launches = ic.LAUNCHES
    f32, f64 = torch.float32, torch.float64
    p32, g32 = interp_inputs(torch, dev, INTERP_F32, f32, 0)
    pL, gL = interp_inputs(torch, dev, INTERP_LARGE, f32, 1)
    p64, g64 = interp_inputs(torch, dev, INTERP_F64, f64, 2)
    torch.cuda.synchronize()

    def drive(fn):
        for k in launches:
            launches[k] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, dict(launches)

    out32, route32 = drive(lambda: pt.bilinear_batched(p32, g32))
    outL, routeL = drive(lambda: pt.bilinear_batched(pL, gL))
    out64, route64 = drive(lambda: pt.bilinear_batched_f64(p64, g64))
    for name, out, shape, dtype in (("config 2", out32, INTERP_F32, f32),
                                    ("1024^2", outL, INTERP_LARGE, f32),
                                    ("fp64", out64, INTERP_F64, f64)):
        require(out.shape == shape[:1] + shape[3:] and out.dtype == dtype
                and bool(torch.isfinite(out).all()),
                f"interp2d {name}: shape {tuple(out.shape)}, {out.dtype}, "
                "or non-finite values")
    require(route32 == {"bilinear_gather": 1, "bilinear_binned": 0,
                        "bilinear_f64": 0},
            f"interp2d: auto at 256^2 launched {route32}, not the gather")
    require(routeL == {"bilinear_gather": 0, "bilinear_binned": 1,
                       "bilinear_f64": 0},
            f"interp2d: auto at 1024^2 launched {routeL}, not the binned")
    require(route64 == {"bilinear_gather": 0, "bilinear_binned": 0,
                        "bilinear_f64": 1},
            f"interp2d: the f64 leg launched {route64}")

    # each kernel against its plain version at the legs' shapes
    exact32 = ic.gather_plain(p32, g32)
    bf32 = ic.bf16_grid(g32)
    out_bf = pt.bilinear_batched(p32, g32, precision="bf16")
    binsL = ic.bin_queries(pL, *INTERP_LARGE[1:3])
    bfL = ic.bf16_grid(gL)
    out_bfL = ic.binned_cuda(pL, bfL, binsL)
    pO, gO = interp_inputs(torch, dev, INTERP_ONE_BIN, f32, 3, 40.0, 41.0)
    binsO = ic.bin_queries(pO, *INTERP_ONE_BIN[1:3])
    outO = pt.bilinear_batched(pO, gO, method="binned")
    # out-of-range queries at a smaller shape, through all three kernels
    pS, gS = interp_inputs(torch, dev, INTERP_SMALL, f32, 4, -3.0,
                           INTERP_SMALL[2] + 3.0)
    refS = host_double(pS, gS)
    outS = {m: pt.bilinear_batched(pS, gS, method=m)
            for m in ("full", "binned")}
    outS64 = pt.bilinear_batched_f64(pS, gS)
    plain, host, f64_bar = "f32_vs_plain", "f32_vs_host_double", "f64"
    checks = {   # name: (kernel's result, reference, bar)
        "gather_vs_plain": (out32, exact32, plain),
        "gather_bf16_vs_plain": (out_bf, ic.gather_plain(p32, bf32), plain),
        "bf16_vs_exact": (out_bf, exact32, "bf16_vs_exact"),
        "binned_vs_plain": (outL, ic.binned_plain(pL, gL, binsL), plain),
        "binned_vs_plain_gather": (outL, ic.gather_plain(pL, gL), plain),
        "binned_bf16_vs_plain": (out_bfL, ic.binned_plain(pL, bfL, binsL),
                                 plain),
        "binned_one_bin_vs_plain": (outO, ic.binned_plain(pO, gO, binsO),
                                    plain),
        "f64_vs_plain": (out64, ic.f64_plain(p64, g64), f64_bar),
        "f64_vs_host_double": (out64, host_double(p64, g64), f64_bar),
        "small_full_vs_plain": (outS["full"], ic.gather_plain(pS, gS),
                                plain),
        "small_full_vs_host_double": (outS["full"], refS, host),
        "small_binned_vs_plain": (outS["binned"], ic.gather_plain(pS, gS),
                                  plain),
        "small_binned_vs_host_double": (outS["binned"], refS, host),
        "small_f64_vs_plain": (outS64, ic.f64_plain(pS.double(),
                                                    gS.double()), f64_bar),
        "small_f64_vs_host_double": (outS64, refS, f64_bar),
    }
    bars = INTERP_BARS
    errs = {}
    for key, (got, want, bar) in checks.items():
        errs[key] = max_abs(got, want)
        require(errs[key] <= bars[bar],
                f"interp2d {key}: {errs[key]} > {bars[bar]}")
    one_bin_count = int(torch.diff(binsO.offsets, dim=1).max())
    require(one_bin_count == INTERP_ONE_BIN[3],
            f"interp2d one-bin case: largest bin holds {one_bin_count}")

    # times, kernel beside plain on the same inputs: (call, leg)
    calls = {
        "gather": (lambda: ic.gather_cuda(p32, g32), INTERP_F32),
        "gather_plain": (lambda: ic.gather_plain(p32, g32), INTERP_F32),
        "gather_bf16": (lambda: ic.gather_cuda(p32, bf32), INTERP_F32),
        "gather_bf16_plain": (lambda: ic.gather_plain(p32, bf32),
                              INTERP_F32),
        "config2_entry_auto": (lambda: pt.bilinear_batched(p32, g32),
                               INTERP_F32),
        "config2_entry_bf16": (
            lambda: pt.bilinear_batched(p32, g32, precision="bf16"),
            INTERP_F32),
        "binned": (lambda: ic.binned_cuda(pL, gL, binsL), INTERP_LARGE),
        "binned_plain": (lambda: ic.binned_plain(pL, gL, binsL),
                         INTERP_LARGE),
        "binning_1024": (lambda: ic.bin_queries(pL, 1024, 1024),
                         INTERP_LARGE),
        "large_entry_auto": (lambda: pt.bilinear_batched(pL, gL),
                             INTERP_LARGE),
        "gather_at_1024": (lambda: ic.gather_cuda(pL, gL), INTERP_LARGE),
        "gather_plain_at_1024": (lambda: ic.gather_plain(pL, gL),
                                 INTERP_LARGE),
        "f64": (lambda: ic.f64_cuda(p64, g64), INTERP_F64),
        "f64_plain": (lambda: ic.f64_plain(p64, g64), INTERP_F64),
    }
    times = {k: timed(fn, torch) for k, (fn, _) in calls.items()}
    rate = {k: leg[0] * leg[3] / (times[k][0] * 1e-3) / 1e6
            for k, (_, leg) in calls.items()}
    row = {"phase": "interp2d", "shapes": {"f32": INTERP_F32,
                                           "large": INTERP_LARGE,
                                           "f64": INTERP_F64},
           "launches": {"config2_auto": route32, "large_auto": routeL,
                        "f64": route64},
           "max_abs_err": errs, "bars": bars,
           "one_bin_largest_bin": one_bin_count,
           "ms_median_of_20": {k: v[0] for k, v in times.items()},
           "ms_back_to_back_mean_of_20": {k: v[1] for k, v in times.items()},
           "mq_per_s": rate, "card": smi}
    emit(row)

    def entry(name, line, key, launched, err_keys):
        return {"name": name, "route": "cuda", "source": INTERP_SRC,
                "replaces": f"{INTERP_TPU}:{line}", "launches": launched,
                "max_abs_err": max(errs[k] for k in err_keys),
                "ms": times[key][0], "plain_ms": times[key + "_plain"][0]}

    return [
        entry("bilinear_gather", 871, "gather", route32["bilinear_gather"],
              ["gather_vs_plain", "gather_bf16_vs_plain",
               "small_full_vs_plain"]),
        entry("bilinear_binned", 670, "binned", routeL["bilinear_binned"],
              ["binned_vs_plain", "binned_bf16_vs_plain",
               "binned_one_bin_vs_plain", "small_binned_vs_plain"]),
        entry("bilinear_f64", 556, "f64", route64["bilinear_f64"],
              ["f64_vs_plain", "small_f64_vs_plain"]),
    ]


def main() -> int:
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG}/ is not beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().relative_to(ROOT))})

    kernels = {"name": "evolve_kernel", "route": "cuda",
               "source": f"{PKG}/csrc/evolve.cu",
               "replaces": "armadillocudalinearinterpolation_tpu/model/"
                           "evolve_pallas.py:101"}
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # R=64 at eps 1e-2 in both types; then the shapes the slice gives the
    # kernel: its guess alone and its 3-point FD stack, at R=1000
    slice_stack = fd_stack(torch, dev, f32, SLICE_FD_EPSILON)
    checks = [
        kernel_vs_plain(pt, torch, dev, "float32", 64,
                        fd_stack(torch, dev, f32, 1e-2)),
        kernel_vs_plain(pt, torch, dev, "float64", 64,
                        fd_stack(torch, dev, f64, 1e-2)),
        kernel_vs_plain(pt, torch, dev, "float32", SLICE_R, slice_stack[:1]),
        kernel_vs_plain(pt, torch, dev, "float32", SLICE_R, slice_stack[1:]),
    ]
    kernels["max_abs_err"] = max(c["max_residual_diff"] for c in checks)
    kernels["launches"] = run_slice(pt, torch, dev)["evolve_launches"]
    m = map_eval(pt, torch, dev, smi)
    kernels["ms"] = m["layers_ms_median_of_5"]["evolve"]
    kernels["plain_ms"] = m["plain_evolve_ms_median_of_3"]

    interp_kernels = interp2d(pt, torch, dev, smi)

    print(smi, flush=True)
    emit({"kernels": [kernels, *interp_kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
