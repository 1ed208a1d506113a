#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds the evolve
kernel against its plain PyTorch version on the card (f32 and f64, every
lane and with the certified window, and at the shapes the slice gives it),
runs the reference's ``Driver.cu`` program through the public API
(``make_residual_fn`` -> ``newton_solve`` -> ``num_unstable_eigenvalues`` at
N=512, R=1000, f32), and times one map evaluation at config 3 (N=1024,
R=1024, ``evolve_window=128`` as the JAX bench runs it) beside the same
evaluation on every lane, requiring every row of the two equal.  Then the
lift (``lift``): K9 through ``pt.lift`` and K9T through
``emap.lift_tangents`` at the shapes configs 3, 4 and 5 and the exact
Jacobian give them, against the plain lift and ``torch.func`` over it
(f64 1e-12, f32 1e-6, tangents 1e-12 relative, with the share of equal
bits), K9T's primal against K9's, each timed beside its plain version with
its device µs and bound; every path after it counts K9's launches, and
every exact one K9T's.  Then the
batched 2-D
bilinear path (``interp2d``): ``bilinear_batched`` at BASELINE config 2
(64 grids of 256x256, 1M queries, f32; ``method="auto"`` -> the gather
kernel), its large-grid leg (8 x 1024x1024, 1M queries; ``auto`` -> the
bin-window kernel) and its fp64 leg (``bilinear_batched_f64``, 16 x
256x256); which body of the gather kernel each leg ran (staged or direct);
the device binning against the plain binning (equal offsets, the same ids
in every bin, no sort kernel in the profiled ``auto`` call); each kernel and
body against its plain version and a host-double oracle; times warm and
with the L2 flushed before each call, device time by ``torch.profiler``
beside ``grid_sample``'s, and the host time per wrapper call and per
``bilinear_batched_f64`` call.  Then the 1-D
family (``interp1d``): ``lerp1d`` at BASELINE
config 1 (1000 nodes, 10M queries; the uniform-grid kernel), at 65536 nodes
with 2M queries (the same kernel: the card study of
``tools/interp1d_route_study.py`` found no shape where a sorted route
wins), ``lerp1d_binned`` there (the sorted-batch kernel) and
``make_interp1d`` on 4096 non-uniform nodes with 2M queries (the
non-uniform kernel, direct and on the sorted route, each mode with the
body it ran and its own bound: the bytes of its own call's tensors), the
non-uniform kernel at 1024, 4096 and 65536 nodes in both modes, with small
tables and extreme queries through all three
kernels; each kernel against its plain version and ``numpy.interp`` in
float64, and timed, with ``grid_sample`` on a 1 x n image beside the
uniform-grid kernels.  Then the launch-size repairs (``repairs``): 65536
grids through every 2-D kernel, ``lerp1d_binned`` with 70000 batches, and
the evolve and replay kernels at N above one CTA's shared memory (rows in
device memory), each against its plain version.  Then the staged Newton to
``|F| <= 1e-8`` (``staged``) at BASELINE config 4 (N=4096, R=64, f64, sigma
0.1, ``evolve_window=512``): the evolve kernel's firing-order log against
the same kernel on every lane and the plain log, the replay kernel
(K2) against the plain replay at 64 and 256 rows with the threads a CTA
each took, K2's device time and µs per event there and its registers
(``tools/kernel_resources.py``), the replay against the
direct fp64 evolve, ``newton_solve_staged`` from the ``Driver.cu`` guess
(cold) and from the guess + 1e-3 (warm) with the residual recomputed,
iterations per stage, launches, the warm solve on every lane beside it,
one accurate map evaluation split into
discovery and replay, K2's device time and the card's idle share by
``torch.profiler``.  Then BASELINE config 5 (``sweep``, the JAX bench's
``sweep_100pt`` and ``sweep_plain``): K1 against its plain windowed version
at the sweep's shapes, 100 steps of ``beta += 0.1`` at N=512, R=1024, f32,
sigma 0.1 with the window of 128 lanes, with the secant predictor and
without, through ``make_residual_fn`` -> ``newton_solve`` and a trailing
batch of spectra: s/step, converged steps, the first failure after a
converged step, unstable counts, iterations, map evaluations, K1 launches,
rows and window fallbacks, and one warm step split into K1, the lift and
the rest with the card's idle share.  Then the port's CLI (``cli``,
``cli.driver.main``) on the card: config 5's shapes with ``--stability``
and a checkpoint for 3 steps, ``--resume`` for 1 (equal to an
uninterrupted 4-step run's step 3) at the slice's FD step of 3e-4 (at
config 5's 1e-2 the CLI stops on a non-finite step 0, recorded beside),
and ``--staged --dtype float64`` at config 4 for 2 steps.  Then exact
Jacobians at config 4 (``exact``): the tangent replay kernel (K2T) against
its plain version at D=3 and D=4 (the beta column), 64 rows, at the guess
and an FD point, on the f32 discovery's order with its own root-find (its
primal against K2's, 0.0) and on the fp64 direct evolve's order and time
log (its primal times K1's own), and so again at the walkers' shape (N=512,
R=4, sigma 0, the default root_tol; one CTA a row) at the artifact's root
and the fold's point, its Jacobian against central FD of the frozen-schedule
map (1e-5 relative), its layout (cluster, threads, waves), device time in
both modes at D=3 and 4, µs per event, registers and bound (its lane
update counted from the SASS by ``tools/kernel_resources.py``), K1's
fp64 log with and without its time log in turns, and
``newton_solve_staged`` on the
direct evolve (the exact stage 2 by default) from the guess and the guess
+ 1e-3, and on the replay with an exact stage 2 beside the frozen-fwd
default, each to 1e-8 recomputed by a fresh map.  Then the map under
PyTorch's forward-mode AD (``autodiff``: the evolve as ``autograd.Function``
s, K1, K2 and K2T as ``torch.library`` ops): ``jacfwd_cols``,
``torch.func.jacfwd`` and ``forward_ad`` against ``value_and_jacobian``
(1e-12 relative) at config 4 and N=512, R=4 on the direct and the replay
backend, each route's wall and launches (one K2T a ``jacfwd``), a map
evaluation without a tangent (K1 alone), and the host µs a call of K1,
K2 and K2T through their ops against the op's kernel alone.  Then the walkers
(``walkers``) through ``cli.driver.main``: the artifact's arclength walk
(N=512, R=4, sigma 0, f64, 70 steps with ``--stability``) against
``artifacts/arclength_fold/`` (first three solutions to 1e-6, the end at
beta 16.01445 to 1e-3, every accepted |r| <= 1e-9), ``--track-fold`` at
the default root tolerance (the fold at 20.3245 to 5e-3),
``--enumerate-branches`` and
``--track-boundary`` (the bracket around 16.0144) under a wall cap, and
three arclength steps at config 4 with the exact and the frozen corrector.
Early on, K1 f64 at sigma 0 is held to the native fp64 oracle
(``oracle``: ``oracle.py`` builds ``native/edmap_oracle.cpp`` with g++) at
``tests/test_oracle.py``'s configuration, 1e-12.  Last, ensemble sharding
(``shard``, ``parallel/sharding.py``): config 3 over 2 gloo ranks sharing
the card and over a world of 1 on NCCL against the unsharded evaluation,
config 4's staged solves (the replay default and an exact stage 2: K1, K2
and K2T in every rank) over 2 ranks against the same solves unsharded,
and the CLI with ``--shard 2`` at config 5's flags in its own process
against the ``cli`` phase's steps, with walls and the all-reduce's ms.
Every ``kernels`` entry carries its bound (bytes or
operations over the H100 SXM data sheet's peaks) and, where one PyTorch
call computes the same function, that call's time (``library_ms``).  Each
phase prints one JSON object; any failed check raises and the script exits
non-zero.  The last line is ``{"ok": true, "device":
{...}}``; before it come the card's name and power limit as ``nvidia-smi``
prints them and a ``{"kernels": [...]}`` line.  Imports no JAX.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
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
MAP_WINDOW = 128                       # config 3's evolve_window (bench.py:405)
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
# operations per query of a bilinear lookup (clamps, floors, weights, three
# lerps) and of a 1-D one; the interpolation bounds are set by the bytes
BILINEAR_OPS_PER_QUERY = 21
# operations per query of the binning: clamps, truncations, corner clamps,
# the bin's divisions, minimums and index
BIN_OPS_PER_QUERY = 14
LERP_OPS_PER_QUERY = 10
INTERP_TPU = "armadillocudalinearinterpolation_tpu/ops/interp_pallas.py"
# interp1d: BASELINE config 1 and the JAX bench's 1-D stages
# (bench.py:152-243), as (nodes, queries)
LERP_CONFIG1 = (1000, 10_000_000)      # sin table on [-3, 3], queries there
LERP_64K = (65536, 2_097_152)          # the same, 64k nodes
INTERP_NONUNIFORM = (4096, 2_097_152)  # gaps 0.1 + U[0, 1), fp sin(0.05 x)
SMALL_TABLES = (2, 129, 4096)          # with out-of-range and extreme queries
K5_NODES = (1024, 4096, 65536)         # K5's bodies by table size, 2M queries
SMALL_QUERIES = 5001
EXTREME = (1e30, -1e30, 1e12, -1e12, math.inf, -math.inf, math.nan)
# kernel vs plain: the same operation order without fused multiply-adds
# (expect 0.0); vs numpy.interp in float64 on the same f32 inputs: the JAX
# tests' bars (tests/test_interp_pallas.py:40,103,117,135)
INTERP1D_BARS = {"vs_plain": 1e-6, "vs_numpy": 1e-5,
                 "dense_cluster_vs_numpy": 1e-4}
INTERP1D_SRC = f"{PKG}/csrc/interp1d.cu"
# staged: BASELINE config 4 (bench.py:426-503): N=4096, R=64, f64, sigma
# 0.1, root_tol 1e-12, max_events 4096, Newton to |F| <= 1e-8 from the
# Driver.cu guess (f32, as the JAX bench passes it) and from it + 1e-3,
# with the JAX config's certified window of 512 lanes (bench.py:438-439).
CONFIG4 = {"n_neurons": 4096, "n_real": 64, "dtype": "float64",
           "root_tol": 1e-12, "max_events": 4096, "evolve_window": 512}
STAGED_TOL = 1e-8
STENCIL_EPS = 1e-6                     # the frozen-fwd stencil's default
# K2 vs plain: the same fp64 formulas without FMA (expect 0.0); the replay
# vs the direct fp64 evolve (tests/test_replay.py:51); the replay map's
# residual vs the direct map's; K1's log: the f32 row and residual bars of
# TARGETS
STAGED_BARS = {"k2_vs_plain_time": 1e-12, "replay_vs_direct_time": 1e-10,
               "replay_vs_direct_residual": 1e-5, "log_identical_rows": 0.95,
               "log_residual": 2e-5}
REPLAY_SRC = f"{PKG}/csrc/replay.cu"
# sweep: BASELINE config 5 (bench.py::bench_sweep_100pt, bench.py:718-720):
# N=512, R=1024, f32, sigma 0.1, the certified window of 128 lanes, Newton
# to 1e-4 in at most 10 iterations with forward FD at the Driver.cu step of
# 1e-2 (which does not converge from the Driver.cu guess, in the JAX
# package either: the bench records n_conv and first_fail_beta), 100 steps
# of beta += 0.1 from 13.0589.  z_2 >= 2 marks the coexisting fast wave
# family (tests/test_cli_and_utils.py:221); from the Driver.cu guess the
# sweep converges first on it, so the guard asks that the converged
# solutions of both sweeps share one family (no hop by either warm start).
CONFIG5 = {"n_neurons": 512, "n_real": 1024, "dtype": "float32",
           "evolve_window": 128}
SWEEP_NEWTON = {"tolerance": 1e-4, "max_iterations": 10, "fd_epsilon": 1e-2}
SWEEP_STEPS, SWEEP_BETA_STEP, SWEEP_FAST_FAMILY_Z2 = 100, 0.1, 2.0
# cli: the resumed step against the uninterrupted run's; one draw a step
# and the restored predictor make them the same computation
CLI_RESUME_BAR = 1e-6
# Peaks of one H100 SXM (NVIDIA's data sheet): memory, and float32 and
# float64 outside the tensor cores, in bytes/s and operations/s.
PEAK = {"bytes": 3.35e12, "float32": 67e12, "float64": 34e12}
# Operations per lane and event.  K1, counted from csrc/events.cuh and
# evolve.cu with each exp, log or pow as one operation and the event-time
# Newton steps of firing lanes left out, so the bound is a lower bound; on
# each lane it evaluates (every lane, or the window's and every lane of an
# event that fell back): fire decision 14, first residual and its test 23,
# argmin 2; on every lane: advance 13, kick-table index 3, synapse 6; on
# each lane outside the window: the certificate's ratio and minimum 9.
K1_EVAL_OPS, K1_ADVANCE_OPS, K1_CERT_OPS = 39, 22, 9
# K2: the fp64-pipe instructions of its per-lane body (replay_lane.cuh's
# advance and kick_weight: one exp, one division, the advance and the kick;
# exp and division are instruction sequences on this card), counted in the SASS
# that cuobjdump shows of the package's build for sm_90a by
# tools/kernel_resources.py on an H100 machine: 21 DFMA (two operations
# each), 7 DMUL, 8 DADD, 1 MUFU.RCP64H, 1 DSETP.  The root-find of each
# event (one lane) is left out.
K2_OPS_PER_LANE_EVENT = 59
# exact: config 4's shapes; K2T against its plain version (the same fp64
# formulas in the same order, no FMA: relative to the tangent's size) and
# its primal against K2 (0.0); K2T's Jacobian against central FD of the
# frozen-schedule map at eps 1e-5 (relative to |J|)
EXACT_BARS = {"k2t_vs_plain_relative": 1e-12, "k2t_primal_vs_k2": 0.0,
              "jacobian_vs_frozen_fd_relative": 1e-5}
EXACT_FD_EPS = 1e-5
K2T_SRC_LINE = "armadillocudalinearinterpolation_tpu/model/replay.py:724"
# autodiff: the map's forward-mode AD against its exact Jacobian, the same
# tangent replay of the same log (relative to |J|)
AUTODIFF_BAR = 1e-12
# walkers: the artifact's arclength walk (artifacts/README.md:112-118) at
# N=512, R=4, sigma 0, f64 from the Driver.cu fixed point; its first three
# solutions against artifacts/arclength_fold/step_0000{0,1,2}.npz and its
# last accepted beta against the artifact's grazing end 16.01445; the fold
# from tests/test_fold.py's near-fold point; the boundary bracket of
# tests/test_boundary.py:47-63; then three arclength steps at config 4
WALK_SMALL = ["--neurons", "512", "--realisations", "4", "--sigma", "0",
              "--dtype", "float64"]
WALK_ROOT = ["--guess", "0.32623663", "0.71936722", "1.36899475",
             "--beta", "13.0589"]
# the walkers' model (WALK_SMALL at the default root_tol) and two of their
# points, each (Z, beta): K2T against its plain version at their shape
WALK_CONFIG = {"n_neurons": 512, "n_real": 4, "dtype": "float64"}
WALK_POINTS = {"artifact_root": ((0.32623663, 0.71936722, 1.36899475),
                                 13.0589),
               "fold_point": ((0.59145, 0.57176, 10.07225), 20.32)}
WALK_BARS = {"artifact_solution": 1e-6, "artifact_end_beta": 1e-3,
             "walk_residual": 1e-9, "fold_beta": 5e-3,
             "boundary_beta": 0.1}
ARTIFACT_END_BETA, FOLD_BETA, BOUNDARY_BETA = 16.01445, 20.3245, 16.0144
WALKER_WALL_CAP_S = 240
CONFIG4_ARC = {"steps": 3, "ds": 0.1, "tolerance": 1e-7}
# shard: config 3 (MAP_*) over 2 gloo ranks sharing the card and over a
# world of 1 on NCCL against the unsharded evaluation on the same draw, at
# the f32 residual bar of TARGETS; config 4's staged solves over 2 ranks
# (the replay default, K1 and K2, and the replay with an exact stage 2, K1,
# K2T and K2) against the same solves unsharded; the CLI with --shard 2 at
# config 5's flags against the cli phase's unsharded steps
SHARD_WORLD, SHARD_MAP_EVALS, SHARD_CLI_STEPS = 2, 5, 3
SHARD_BARS = {"config3_residual": 2e-5, "config4_solution": 1e-8,
              "config4_residual": STAGED_TOL, "cli_solution": 1e-5}
# oracle: K1 f64 at sigma 0 against the native fp64 oracle (oracle.py) at
# tests/test_oracle.py's fixtures (tests/conftest.py: N=512, R=4), at the
# Driver.cu guess and at the converged root, 1e-12 (tests/test_oracle.py:31)
ORACLE_CONFIG = {"n_neurons": 512, "n_real": 4, "dtype": "float64"}
ORACLE_POINTS = {"guess": INITIAL_GUESS,
                 "root": (0.32623663, 0.71936722, 1.36899475)}
ORACLE_BAR = 1e-12
# lift (K9, K9T): the shapes the main path gives them, as (N, points,
# dtype): config 3's map evaluation and its forward-FD stack, config 4's
# frozen-fwd stencil (f64) and config 5's FD stack; K9T as (N, points, D):
# config 4's exact Jacobian (D=3, and D=4 with the beta column) and the
# walkers' (N=512).  Bars: K9 against the plain lift (the same operations
# in the same order) f64 1e-12 and f32 1e-6 relative; K9T against
# torch.func over the plain lift 1e-12 relative (max |a - b| / max |b|).
LIFT_CASES = {"config3_map": (MAP_N, 1, "float32"),
              "config3_fd_stack": (MAP_N, 4, "float32"),
              "config4_frozen_fwd": (4096, 4, "float64"),
              "config5_fd_stack": (512, 4, "float32")}
LIFT_TANGENT_CASES = {"config4_D3": (4096, 1, 3), "config4_D4": (4096, 1, 4),
                      "walkers_D4": (512, 1, 4)}
LIFT_BARS = {"float64": 1e-12, "float32": 1e-6, "tangent": 1e-12}
LIFT_SRC = f"{PKG}/csrc/lift.cu"
LIFT_TPU = "armadillocudalinearinterpolation_tpu/model/lift.py:66"
# K9's operations, counted from csrc/lift.cu's body (each sum,
# difference, product, quotient, negation, comparison and exp one
# operation; the branch a select keeps), as the function needs them: per
# site 9 (the coordinate, the decay exp(-x/c), the drive, the clamp); per
# site and spike 10 (c u, the tests, the sums); the voltage pair ahead of
# the spike 2 x 15 and its reset 4, or behind it 2 x 7; the synapse pair
# behind the spike 2 x 3, else 2 x 7; and per point and spike the
# site-free factors of both pairs, 2 x 48 (csrc/lift.cu's Spike).
K9_OPS = (9, 10, 34, 14, 6, 14, 96)
# K9T's operations a direction beyond the primal: the tangents of the same
# body on its dual number, each operator as it does it (a product of two
# duals 3: b' a + a' b; a dual times a scalar 1; a quotient 3: (a' - b' q)
# / b; a scalar over a dual 3: -(b' q) / b; a reciprocal 3: -a' (r r); an
# exp 1: a' e; a sum, difference or negation 1; a dual plus a scalar and a
# comparison 0), in the same places: per site 5; per site and spike 11;
# ahead 2 x 25 and the reset 6, behind 2 x 12; the synapse pair 2 x 5 or
# 2 x 13; per point and spike 2 x 107.  The function needs the primal once
# and these D times: K9T recomputes the primal a direction and the
# site-free factors a CTA, which the bound does not count.
K9T_TANGENT_OPS = (5, 11, 56, 24, 10, 26, 214)
# repairs: more grids than one launch dimension holds, more 1-D batches,
# and N above one CTA's shared memory (f64 evolve: 8273, replay: 8297)
REPAIR_GRIDS = (65536, 6, 9, 5)
REPAIR_BATCHES = (1000, 140_001, 70_000)   # nodes, queries, batches
REPAIR_EVOLVE_N, REPAIR_REPLAY_N, REPAIR_R = 10240, 8448, 2


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


def bound(n_bytes: float, n_ops: float, dtype: str):
    """Least time in ms for ``n_bytes`` moved and ``n_ops`` operations of
    ``dtype`` at the card's peaks, and which of the two bounds it."""
    t_bytes = n_bytes / PEAK["bytes"] * 1e3
    t_ops = n_ops / PEAK[dtype] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def is_device_work(e) -> bool:
    """Whether a profiler event is device work (a kernel, copy or set), not
    an annotation the profiler draws on the device's timeline."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep"))


def device_profile(fn, torch):
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activities).
    Returns ``(out, kernels, busy_ms)``: device time by kernel name as
    ``{name: [launches, total_us]}`` and the union of the device events'
    time ranges.  Profiling costs host time: set busy_ms against an
    unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels, spans = {}, []
    for e in prof.events():
        if not is_device_work(e):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return out, kernels, busy / 1e3


def fd_stack(torch, dev, dtype, eps):
    """The Driver.cu guess and its three forward-FD perturbations."""
    z0 = torch.tensor(INITIAL_GUESS, dtype=dtype, device=dev)
    return torch.cat([z0[None], z0[None] + eps * torch.eye(
        3, dtype=dtype, device=dev)])


def evolve_residual(pt, cfg, Z, res):
    """The map residual of a stack ``Z`` from its evolve result."""
    from armadillocudalinearinterpolation_torch.model import emap
    P = Z.shape[0]
    pos = pt.restrict_positions(cfg, res).reshape(P, -1, cfg.n_spikes)
    mean, _ = pt.masked_ensemble_mean(pos, res.accept.reshape(P, -1))
    return emap.assemble_residual(cfg, pt.z_to_u(Z), mean)


def identical_rows(a, b, events=True):
    """Rows with the same discrete outcome; ``events=False`` leaves out the
    event counts (a replay reports its log's)."""
    same = ((a.last_ind == b.last_ind).all(1)
            & (a.crossed_ind == b.crossed_ind).all(1) & (a.accept == b.accept))
    return same & (a.n_events == b.n_events) if events else same


def time_diff(a, b, rows) -> float:
    if not bool(rows.any()):
        return math.inf
    return max(float((a.last_time - b.last_time)[rows].abs().max()),
               float((a.crossed_time - b.crossed_time)[rows].abs().max()))


def kernel_vs_plain(pt, torch, dev, dtype: str, n_real: int, Z, window=0):
    """K1 and its plain version on the same inputs: the lifts of the stack
    ``Z`` at N=512 under the seed-0 draw of ``n_real`` realisations, on
    every lane or with the certified window of ``window`` lanes."""
    from armadillocudalinearinterpolation_torch.model import (
        emap, evolve_cuda, lift_cuda)
    from armadillocudalinearinterpolation_torch.model.evolve_batched import (
        evolve_ensemble_batched)
    cfg = pt.ModelConfig(n_neurons=SLICE_N, n_real=n_real, dtype=dtype,
                         evolve_window=window)
    params = pt.MapParams.create(BETA, SIGMA, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    beta = pt.sample_beta(cfg, params, gen, device=dev)
    P = Z.shape[0]
    U = emap.z_to_u(Z)
    init_ind = pt.initial_spike_indices(cfg, Z).contiguous()
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params, U))

    k_ms, rk = cuda_ms(lambda: evolve_cuda.evolve_ensemble_cuda(
        cfg, v0, s0, beta, init_ind), torch)
    p_ms, rp = cuda_ms(lambda: evolve_ensemble_batched(cfg, v0, s0, beta,
                                                       init_ind), torch)

    same = identical_rows(rk, rp)
    dtime = time_diff(rk, rp, same)
    fk, fp = evolve_residual(pt, cfg, Z, rk), evolve_residual(pt, cfg, Z, rp)
    dres = float((fk - fp).abs().max())
    row = {"phase": "kernel_vs_plain", "dtype": dtype, "N": SLICE_N,
           "R": n_real, "P": P, "window": window, "rows": int(same.numel()),
           "identical_share": float(same.float().mean()),
           "max_time_diff_identical_rows": dtime,
           "max_residual_diff": dres,
           "residual_finite": bool(torch.isfinite(fk).all()),
           "kernel_ms_single_call": k_ms, "plain_ms_single_call": p_ms,
           "targets": TARGETS[dtype]}
    emit(row)
    tg, what = TARGETS[dtype], f"{dtype} P={P} R={n_real} W={window}"
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
    """The Driver.cu program through the public API, on the kernels."""
    from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                              lift_cuda)
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
    evolve_cuda.LAUNCHES = lift_cuda.LAUNCHES = 0
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
    launches, lifts = evolve_cuda.LAUNCHES, lift_cuda.LAUNCHES

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
           "evolve_launches": launches, "lift_launches": lifts,
           "wall_s": wall}
    emit(row)
    require(res.converged, "slice: Newton did not converge")
    require(res.residual_norm <= 1e-4, "slice: |F| > 1e-4")
    require(bool(torch.isfinite(sol).all()), "slice: non-finite solution")
    require(dist <= 2e-2, f"slice: solution {dist} from the reference point")
    require(launches == evals == lifts, f"slice: {launches} K1 and {lifts} "
            f"K9 launches for {evals} map evaluations")
    return row


def k1_ops(N: int, window: int, events: int, fallbacks: int) -> int:
    """K1's operations for ``events`` events of N lanes: every lane
    evaluated (``window`` 0), or the window's lanes, the certificate on the
    rest and every lane again for each event that fell back."""
    if not window:
        return events * N * (K1_EVAL_OPS + K1_ADVANCE_OPS)
    return (events * (window * K1_EVAL_OPS + (N - window) * K1_CERT_OPS
                      + N * K1_ADVANCE_OPS)
            + fallbacks * N * K1_EVAL_OPS)


def map_eval(pt, torch, dev, smi: str):
    """One map evaluation at config 3 (N=1024, R=1024, sigma=0.1, f32, the
    certified window of 128 lanes): the kernel against the plain windowed
    version on the card, in turns, and the kernel on every lane beside it,
    which must give every row equal.  The launch count is set to 0 just
    before the first windowed evaluation and read just after."""
    from armadillocudalinearinterpolation_torch.model import (
        emap, evolve_cuda, lift_cuda)
    from armadillocudalinearinterpolation_torch.model.evolve import (
        evolve_ensemble)
    from armadillocudalinearinterpolation_torch.model.evolve_batched import (
        evolve_ensemble_batched)
    from armadillocudalinearinterpolation_torch.solvers.linalg import (
        solve_dense)
    cfg = pt.ModelConfig(n_neurons=MAP_N, n_real=MAP_R, dtype="float32",
                         evolve_window=MAP_WINDOW)
    cfg_full = cfg.with_(evolve_window=0)
    params = pt.MapParams.create(BETA, SIGMA, dtype="float32", device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    Fk, Fk_full, Fp = (pt.make_residual_fn(c, params, 0, device=dev,
                                           beta=beta, evolve_backend=b)
                       for c, b in ((cfg, "cuda"), (cfg_full, "cuda"),
                                    (cfg, "torch")))
    z0 = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    evolve_cuda.LAUNCHES = lift_cuda.LAUNCHES = 0
    fk = Fk(z0)
    torch.cuda.synchronize()
    launches, lifts = evolve_cuda.LAUNCHES, lift_cuda.LAUNCHES
    fk_full, fp = Fk_full(z0), Fp(z0)          # and warm-up
    torch.cuda.synchronize()
    k_ms, full_ms, p_ms = [], [], []
    for i in range(6):
        k_ms.append(cuda_ms(lambda: Fk(z0), torch)[0])
        full_ms.append(cuda_ms(lambda: Fk_full(z0), torch)[0])
        if i < 3:
            p_ms.append(cuda_ms(lambda: Fp(z0), torch)[0])

    # one kernel evaluation, layer by layer, windowed and on every lane
    U = emap.z_to_u(z0[None])
    init_ind, (v0, s0) = (pt.initial_spike_indices(cfg, z0[None]),
                          pt.lift(cfg, params, U))
    fallbacks = torch.zeros(MAP_R, dtype=torch.int32, device=dev)
    res = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, init_ind,
                                           fallbacks=fallbacks)
    res_full = evolve_cuda.evolve_ensemble_cuda(cfg_full, v0, s0, beta,
                                                init_ind)
    same = identical_rows(res, res_full) & (
        (res.last_time == res_full.last_time).all(1)
        & (res.crossed_time == res_full.crossed_time).all(1))
    identical_share = float(same.float().mean())

    def restrict():
        pos = pt.restrict_positions(cfg, res).reshape(1, MAP_R, -1)
        mean, _ = pt.masked_ensemble_mean(pos, res.accept.reshape(1, -1))
        return emap.assemble_residual(cfg, U, mean)

    jac = torch.eye(3, device=dev) + 0.1
    evolve = {
        "evolve": lambda: evolve_cuda.evolve_ensemble_cuda(
            cfg, v0, s0, beta, init_ind),
        "evolve_full_lane": lambda: evolve_cuda.evolve_ensemble_cuda(
            cfg_full, v0, s0, beta, init_ind)}
    stages = {
        "lift": lambda: (pt.initial_spike_indices(cfg, z0[None]),
                         pt.lift(cfg, params, U)),
        **evolve,
        "restrict_mean_residual": restrict,
        "newton_solve_3x3": lambda: solve_dense(jac, fk),
    }
    layers = {name: statistics.median(cuda_ms(fn, torch)[0]
                                      for _ in range(5))
              for name, fn in stages.items()}
    device = {name: device_us(fn, torch, n=3)[0]
              for name, fn in evolve.items()}
    # the plain evolves alone, on the same inputs as the kernel's
    plain = {
        "windowed": statistics.median(cuda_ms(
            lambda: evolve_ensemble_batched(cfg, v0, s0, beta, init_ind),
            torch)[0] for _ in range(3)),
        "full_lane": statistics.median(cuda_ms(
            lambda: evolve_ensemble(cfg_full, v0, s0, beta, init_ind),
            torch)[0] for _ in range(3))}
    events, n_fallbacks = int(res.n_events.sum()), int(fallbacks.sum())
    row = {"phase": "map_eval", "N": MAP_N, "R": MAP_R, "dtype": "float32",
           "evolve_window": MAP_WINDOW, "launches": launches,
           "lift_launches": lifts,
           "kernel_ms_median": statistics.median(k_ms),
           "kernel_ms": k_ms,
           "full_lane_ms_median": statistics.median(full_ms),
           "full_lane_ms": full_ms,
           "plain_ms_median": statistics.median(p_ms), "plain_ms": p_ms,
           "residual_diff": float((fk - fp).abs().max()),
           "residual_diff_full_lane": float((fk - fk_full).abs().max()),
           "windowed_vs_full_lane_identical_rows": identical_share,
           "layers_ms_median_of_5": layers,
           "evolve_device_us_mean_of_3": device,
           "plain_evolve_ms_median_of_3": plain,
           "evolve_events_total": events,
           "evolve_fallbacks_total": n_fallbacks,
           "evolve_bytes": nbytes(v0, s0, beta, init_ind, *res),
           "card": smi}
    emit(row)
    require(bool(torch.isfinite(fk).all()), "map_eval: non-finite residual")
    require(identical_share == 1.0, "map_eval: the windowed K1 differs from "
            f"the full-lane K1 in {1 - identical_share:.4%} of rows")
    require(bool(torch.equal(fk, fk_full)),
            "map_eval: windowed and full-lane residuals differ")
    require(row["residual_diff"] <= TARGETS["float32"]["residual"],
            f"map_eval: kernel vs plain residual {row['residual_diff']}")
    require(launches == 1, f"map_eval: {launches} K1 launches for one "
            "evaluation")
    require(lifts == 1, f"map_eval: {lifts} K9 launches for one evaluation")
    return row


def lift_ops(torch, cfg, U, counts=K9_OPS) -> int:
    """The lift's operations on the ``(P, n_spikes + 1)`` points ``U`` by
    ``counts`` (``K9_OPS``, or ``K9T_TANGENT_OPS`` for one direction's
    tangents): for each point and spike, its sites ahead of the spike and
    behind it, as these inputs have them."""
    site, spike, ahead_, behind_, syn_behind, syn_else, factors = counts
    N = cfg.n_neurons
    x = cfg.half_width - cfg.dx * torch.arange(N, dtype=U.dtype,
                                               device=U.device)
    c = U[:, :1]
    sites = U.shape[0] * N
    ops = sites * site + U.shape[0] * cfg.n_spikes * factors
    for m in range(1, cfg.n_spikes + 1):
        cu = c * U[:, m:m + 1]
        ahead = int((x - cu > 0).sum())
        behind = int((cu - x > 0).sum())
        ops += (sites * spike + ahead * ahead_ + (sites - ahead) * behind_
                + behind * syn_behind + (sites - behind) * syn_else)
    return ops


def lift_through_the_map(pt, torch, dev) -> dict:
    """The map at the Driver.cu guess through K9 and through the plain
    lift (``emap.lift`` replaced), at config 3 (f32, W=128) and config 4
    (f64); at config 4 also the exact Jacobian through K9T and through
    ``torch.func`` over the plain lift (``emap.lift_tangents`` replaced
    by its earlier form)."""
    from armadillocudalinearinterpolation_torch.model import emap
    from armadillocudalinearinterpolation_torch.model.lift import lift_plain

    def plain_lift(cfg, params, U):
        return lift_plain(cfg, params.beta.to(dtype=U.dtype,
                                              device=U.device), U)

    def plain_lift_tangents(cfg, params, Zs, dZ, dpb):
        pb = params.beta.to(dtype=Zs.dtype, device=Zs.device).reshape(
            -1, 1).expand(Zs.shape[0], 1)

        def lift_of(u, b):
            return lift_plain(cfg, b, u)
        U, dU = emap.z_to_u(Zs), emap.z_to_u(dZ)
        dv0, ds0 = torch.func.vmap(lambda du, db: torch.func.jvp(
            lift_of, (U, pb), (du, db))[1])(dU, dpb)
        return (U, dU, *(x.contiguous() for x in (*lift_of(U, pb), dv0,
                                                   ds0)))

    out = {}
    real = emap.lift, emap.lift_tangents
    for name, kw in (("config3", dict(n_neurons=MAP_N, n_real=MAP_R,
                                      dtype="float32",
                                      evolve_window=MAP_WINDOW)),
                     ("config4", CONFIG4)):
        cfg = pt.ModelConfig(**kw)
        params = pt.MapParams.create(BETA, SIGMA, dtype=cfg.dtype,
                                     device=dev)
        F = pt.make_residual_fn(cfg, params, 0, device=dev)
        z = torch.tensor(INITIAL_GUESS, dtype=cfg.torch_dtype, device=dev)
        f_k9 = F(z)
        J_k9 = F.value_and_jacobian(z)[1] if name == "config4" else None
        emap.lift, emap.lift_tangents = plain_lift, plain_lift_tangents
        try:
            f_plain = F(z)
            J_plain = (F.value_and_jacobian(z)[1] if name == "config4"
                       else None)
        finally:
            emap.lift, emap.lift_tangents = real
        out[name] = {"dtype": cfg.dtype,
                     "residual_diff": max_abs(f_k9, f_plain),
                     "residual_equal": bool(torch.equal(f_k9, f_plain))}
        if J_k9 is not None:
            out[name]["jacobian_rel_diff"] = rel_diff(J_k9, J_plain)
    return out


def lift_phase(pt, torch, dev, smi: str):
    """K9 and K9T at the shapes the main path gives them (``LIFT_CASES``,
    ``LIFT_TANGENT_CASES``): K9 through ``pt.lift`` (the map's entry: one
    rate expanded over the points) against the plain lift on the same
    inputs, with the share of equal bits; K9T through
    ``emap.lift_tangents`` (the exact Jacobian's entry) against
    ``torch.func`` over the plain lift (the parent's ``lift_tangents``),
    its primal against K9's (equal bits required); each warm and back to
    back (``timed``), beside the plain version, device µs by
    ``torch.profiler``, K9's host µs a call through ``pt.lift`` and through
    its op alone, and the bound from the bytes and this run's
    operations; K9 equal to the plain lift in every bit at every shape; a
    one-launch floor beside K9 (a one-element fill, timed as K9 is, a
    yardstick the port never calls); each kernel's registers and spill
    bytes (``tools/kernel_resources.py``, none spilled); then the map
    through K9 against the map through the plain lift at the evolve's
    residual bars, and the exact Jacobian through K9T against the one
    through ``torch.func`` at 1e-12 (:func:`lift_through_the_map`).
    Returns the two ``kernels`` entries without launches."""
    from armadillocudalinearinterpolation_torch.model import emap, lift_cuda
    from armadillocudalinearinterpolation_torch.model.lift import lift_plain

    def points(P, dtype):
        return emap.z_to_u(fd_stack(torch, dev, dtype, 1e-3)[:P])

    k9 = {}
    for name, (N, P, dtype) in LIFT_CASES.items():
        cfg = pt.ModelConfig(n_neurons=N, n_real=1, dtype=dtype)
        params = pt.MapParams.create(BETA, SIGMA, dtype=dtype, device=dev)
        U = points(P, cfg.torch_dtype)
        v0, s0 = pt.lift(cfg, params, U)
        want = lift_plain(cfg, params.beta, U)
        ms, ms_b2b = timed(lambda: pt.lift(cfg, params, U), torch)
        plain_ms, _ = timed(lambda: lift_plain(cfg, params.beta, U), torch,
                            n=5)
        us, per_kernel = device_us(lambda: pt.lift(cfg, params, U), torch)
        beta = params.beta.reshape(1).expand(P)
        host = {"lift": host_us(lambda: pt.lift(cfg, params, U), torch),
                "op": host_us(lambda: lift_cuda.lift_op(
                    lift_cuda.config_key(cfg), U, beta), torch)}
        b_ms, b_by = bound(nbytes(U, params.beta, v0, s0),
                           lift_ops(torch, cfg, U), dtype)
        k9[name] = {
            "N": N, "points": P, "dtype": dtype,
            "rel_diff": max(rel_diff(a, b) for a, b in zip((v0, s0), want)),
            "max_abs_err": max(max_abs(a, b) for a, b in zip((v0, s0),
                                                             want)),
            "equal_bits_share": float(sum((a == b).sum() for a, b in zip(
                (v0, s0), want))) / (2 * v0.numel()),
            "ms": ms, "ms_back_to_back": ms_b2b, "plain_ms": plain_ms,
            "device_us": us, "device_us_by_kernel": per_kernel,
            "host_us_per_call": host, "bound_ms": b_ms, "bound_by": b_by}
    k9t = {}
    for name, (N, P, D) in LIFT_TANGENT_CASES.items():
        cfg = pt.ModelConfig(n_neurons=N, n_real=1, dtype="float64")
        params = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
        Z = fd_stack(torch, dev, torch.float64, 1e-3)[:P]
        eye = torch.eye(D, dtype=torch.float64, device=dev)
        dZ = eye[:, None, :3].expand(D, P, 3).contiguous()
        dpb = eye[:, None, 3:].sum(-1, keepdim=True).expand(D, P, 1)
        dpb = dpb.contiguous()
        U, dU, v0, s0, dv0, ds0 = emap.lift_tangents(cfg, params, Z, dZ, dpb)
        beta = params.beta.reshape(1).expand(P)
        db = dpb[..., 0]

        def plain():
            def lift_of(u, b):
                return lift_plain(cfg, b[:, None], u)
            return torch.func.vmap(lambda a, b: torch.func.jvp(
                lift_of, (U, beta), (a, b))[1])(dU, db)
        dv, ds = plain()
        k9_out = lift_cuda.lift_op(lift_cuda.config_key(cfg), U, beta)

        def kernel():
            return lift_cuda.lift_tangent(cfg, U, beta, dU, db)
        ms, ms_b2b = timed(kernel, torch)
        plain_ms, _ = timed(plain, torch, n=5)
        us, per_kernel = device_us(kernel, torch)
        b_ms, b_by = bound(
            nbytes(U, params.beta, dU, db, v0, s0, dv0, ds0),
            lift_ops(torch, cfg, U) + D * lift_ops(torch, cfg, U,
                                                   K9T_TANGENT_OPS),
            "float64")
        k9t[name] = {
            "N": N, "points": P, "directions": D,
            "rel_diff": max(max(rel_diff(a[d], b[d]) for d in range(D))
                            for a, b in ((dv0, dv), (ds0, ds))),
            "max_abs_err": max(max_abs(dv0, dv), max_abs(ds0, ds)),
            "primal_equals_k9": bool(torch.equal(v0, k9_out[0])
                                     and torch.equal(s0, k9_out[1])),
            "ms": ms, "ms_back_to_back": ms_b2b, "plain_ms": plain_ms,
            "device_us": us, "device_us_by_kernel": per_kernel,
            "bound_ms": b_ms, "bound_by": b_by}
    one = torch.zeros(1, device=dev)
    floor_us, floor_kernels = device_us(lambda: one.fill_(1.0), torch)
    registers = lift_registers()
    through = lift_through_the_map(pt, torch, dev)
    emit({"phase": "lift", "bars": LIFT_BARS, "k9": k9, "k9t": k9t,
          "one_launch_floor_device_us": floor_us,
          "one_launch_floor_kernels": floor_kernels,
          "registers": registers, "through_the_map": through, "card": smi})
    spilled = [k for k, r in registers.items() if r["spill_store_bytes"]]
    require(len(registers) == 9 and not spilled,
            f"lift: spill stores in {spilled} ({registers})")
    for name, r in through.items():
        require(r["residual_diff"] <= TARGETS[r["dtype"]]["residual"],
                f"lift {name}: the map through K9 is {r['residual_diff']} "
                "from the map through the plain lift")
    require(through["config4"]["jacobian_rel_diff"] <= LIFT_BARS["tangent"],
            "lift: the exact Jacobian through K9T is "
            f"{through['config4']['jacobian_rel_diff']} from the one "
            "through torch.func")
    for name, r in k9.items():
        require(r["rel_diff"] <= LIFT_BARS[r["dtype"]],
                f"lift {name}: K9 is {r['rel_diff']} from the plain lift")
        require(r["equal_bits_share"] == 1.0,
                f"lift {name}: K9 equals the plain lift in "
                f"{r['equal_bits_share']} of its bits, not all")
    for name, r in k9t.items():
        require(r["rel_diff"] <= LIFT_BARS["tangent"],
                f"lift {name}: K9T is {r['rel_diff']} from torch.func")
        require(r["primal_equals_k9"], f"lift {name}: K9T's primal differs "
                "from K9's")

    def entry(kname, cases, head, shape, **extra):
        c = cases[head]
        return {"name": kname, "route": "cuda", "source": LIFT_SRC,
                "replaces": LIFT_TPU,
                "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None, "device_us": c["device_us"],
                "shape": shape, "by_case": cases,
                "registers": {k: r for k, r in registers.items()
                              if k.startswith(kname)}, **extra}
    return (entry("lift_kernel", k9, "config3_map",
                  "config 3's map evaluation: 1 point x N=1024, f32",
                  one_launch_floor_device_us=floor_us),
            entry("lift_tangent_kernel", k9t, "config4_D3",
                  "config 4's exact Jacobian: 1 point x N=4096, D=3, f64"))


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
    # the second back-to-back run: the first grows the caching allocator to
    # hold n outputs at once
    for _ in range(2):
        total, _ = cuda_ms(lambda: [fn() for _ in range(n)], torch)
    return single, total / n


def timed_in_turns(fns, torch, n=20):
    """Median ms of ``n`` warm single calls of each of ``fns`` (a dict),
    called in turns, one of each a round, so that the host's drift during
    the rounds falls on all of them alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            ms[k].append(cuda_ms(fn, torch)[0])
    return {k: statistics.median(v) for k, v in ms.items()}


def timed_cold(fn, torch, flush, n=10):
    """Median ms of ``n`` single calls, each after ``flush()`` has written
    more than the 50 MB L2 (so the call finds its inputs in DRAM)."""
    fn()
    ms = []
    for _ in range(n):
        flush()
        torch.cuda.synchronize()
        ms.append(cuda_ms(fn, torch)[0])
    return statistics.median(ms)


def device_us(fn, torch, n=5, tries=4):
    """Device time per call in µs by ``torch.profiler`` over ``n`` calls,
    with the time by kernel name, or ``(None, {})`` if no profile of
    ``tries`` holds a device event ("not measured"; ``main`` fails a run
    in which an entry of the ``kernels`` line has none).

    A profile misses some device events, most often the first kernels of a
    profile, and now and then all of them: so the ``n`` timed calls follow
    ``n`` untimed ones in the profiler's warmup step, an empty profile is
    taken again, and each kernel counts as its mean time over the events
    recorded times its launches per call (events over ``n``, rounded),
    which one missed event does not bias."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kern = {}
        for e in prof.events():
            if is_device_work(e):
                k = kern.setdefault(e.name, [0, 0.0])
                k[0] += 1
                k[1] += e.time_range.elapsed_us()
        if kern:
            per_call = {name: us / count * max(1, round(count / n))
                        for name, (count, us) in kern.items()}
            return sum(per_call.values()), per_call
    return None, {}


def host_us(fn, torch, n=1000):
    """Host µs per call of ``fn`` over ``n`` calls issued back to back at a
    size where the device time is negligible (perf_counter)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def same_bin_members(torch, got, want):
    """Whether two binnings with equal offsets hold the same query ids in
    every bin (the order inside a bin is free)."""
    B, Q = want.order.shape
    k = torch.arange(Q, dtype=torch.int32, device=want.order.device).expand(
        B, Q).contiguous()
    bin_k = torch.searchsorted(want.offsets[:, 1:].contiguous(), k,
                               right=True)

    def keys(bins):
        return torch.sort(bin_k * Q + bins.order.long(), dim=1).values
    return bool(torch.equal(keys(got), keys(want)))


def interp2d(pt, torch, dev, smi: str):
    """The batched 2-D bilinear path: the legs through the public entry
    points with the launch and body counts set to 0 just before each and
    read just after; each kernel against its plain version; the device
    binning against the plain binning; timings warm and with the L2
    flushed, device time by the profiler, host time per call."""
    from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic
    launches, bodies = ic.LAUNCHES, ic.BODIES
    f32, f64 = torch.float32, torch.float64
    p32, g32 = interp_inputs(torch, dev, INTERP_F32, f32, 0)
    pL, gL = interp_inputs(torch, dev, INTERP_LARGE, f32, 1)
    p64, g64 = interp_inputs(torch, dev, INTERP_F64, f64, 2)
    torch.cuda.synchronize()

    def drive(fn):
        for d in (launches, bodies):
            for k in d:
                d[k] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in {**launches, **bodies}.items() if v}

    legs = {
        "config2_auto": lambda: pt.bilinear_batched(p32, g32),
        "config2_bf16": lambda: pt.bilinear_batched(p32, g32,
                                                    precision="bf16"),
        "large_auto": lambda: pt.bilinear_batched(pL, gL),
        "large_full": lambda: pt.bilinear_batched(pL, gL, method="full"),
        "f64": lambda: pt.bilinear_batched_f64(p64, g64),
    }
    outs, routes = {}, {}
    for name, fn in legs.items():
        outs[name], routes[name] = drive(fn)
    want_routes = {
        "config2_auto": {"bilinear_gather": 1, "gather_staged": 1},
        "config2_bf16": {"bilinear_gather": 1, "gather_staged": 1},
        "large_auto": {"bilinear_binning": 1, "bilinear_binned": 1,
                       "binned_async": 1},
        "large_full": {"bilinear_gather": 1, "gather_direct": 1},
        "f64": {"bilinear_f64": 1},
    }
    for name, out in outs.items():
        shape = INTERP_F64 if name == "f64" else (
            INTERP_LARGE if name.startswith("large") else INTERP_F32)
        dtype = f64 if name == "f64" else f32
        require(out.shape == shape[:1] + shape[3:] and out.dtype == dtype
                and bool(torch.isfinite(out).all()),
                f"interp2d {name}: shape {tuple(out.shape)}, {out.dtype}, "
                "or non-finite values")
        require(routes[name] == want_routes[name],
                f"interp2d {name}: launched {routes[name]}, not "
                f"{want_routes[name]}")
    out32, out_bf = outs["config2_auto"], outs["config2_bf16"]
    outL, out64 = outs["large_auto"], outs["f64"]

    # the device binning against the plain binning on the same queries
    binsL = ic.bin_queries_cuda(pL, *INTERP_LARGE[1:3])
    plain_binsL = ic.bin_queries(pL, *INTERP_LARGE[1:3])
    pO, gO = interp_inputs(torch, dev, INTERP_ONE_BIN, f32, 3, 40.0, 41.0)
    binsO = ic.bin_queries_cuda(pO, *INTERP_ONE_BIN[1:3])
    plain_binsO = ic.bin_queries(pO, *INTERP_ONE_BIN[1:3])
    binning = {}
    for name, got, want in (("1024^2", binsL, plain_binsL),
                            ("one_bin", binsO, plain_binsO)):
        binning[name] = {
            "offsets_equal": bool(torch.equal(got.offsets, want.offsets)),
            "same_ids_in_every_bin": same_bin_members(torch, got, want),
            "pairs_follow_ids": bool(torch.equal(
                got.pairs, torch.gather(
                    pO if name == "one_bin" else pL, 1,
                    got.order.long()[..., None].expand(-1, -1, 2))))}
        require(all(binning[name].values()),
                f"interp2d binning {name}: {binning[name]}")

    # each kernel and body against its plain version at the legs' shapes
    exact32 = ic.gather_plain(p32, g32)
    bf32 = ic.bf16_grid(g32)
    bfL = ic.bf16_grid(gL)
    out_bfL = ic.binned_cuda(bfL, binsL)
    outO = pt.bilinear_batched(pO, gO, method="binned")
    # out-of-range queries at a smaller shape, through every kernel
    pS, gS = interp_inputs(torch, dev, INTERP_SMALL, f32, 4, -3.0,
                           INTERP_SMALL[2] + 3.0)
    refS = host_double(pS, gS)
    outS = {m: pt.bilinear_batched(pS, gS, method=m)
            for m in ("full", "binned")}
    outS_direct = ic.gather_cuda(pS, gS, body="direct")
    outS64 = pt.bilinear_batched_f64(pS, gS)
    plain, host, f64_bar = "f32_vs_plain", "f32_vs_host_double", "f64"
    checks = {   # name: (kernel's result, reference, bar)
        "gather_vs_plain": (out32, exact32, plain),
        "gather_direct_vs_plain": (ic.gather_cuda(p32, g32, body="direct"),
                                   exact32, plain),
        "gather_bf16_vs_plain": (out_bf, ic.gather_plain(p32, bf32), plain),
        "gather_bf16_direct_vs_plain": (
            ic.gather_cuda(p32, bf32, body="direct"),
            ic.gather_plain(p32, bf32), plain),
        "bf16_vs_exact": (out_bf, exact32, "bf16_vs_exact"),
        "gather_at_1024_vs_plain": (outs["large_full"],
                                    ic.gather_plain(pL, gL), plain),
        "binned_vs_plain": (outL, ic.binned_plain(gL, binsL), plain),
        "binned_vs_plain_gather": (outL, ic.gather_plain(pL, gL), plain),
        "binned_bf16_vs_plain": (out_bfL, ic.binned_plain(bfL, binsL),
                                 plain),
        "binned_bf16_vs_exact": (out_bfL, outL, "bf16_vs_exact"),
        "binned_one_bin_vs_plain": (outO, ic.binned_plain(gO, binsO),
                                    plain),
        "f64_vs_plain": (out64, ic.f64_plain(p64, g64), f64_bar),
        "f64_vs_host_double": (out64, host_double(p64, g64), f64_bar),
        "small_full_vs_plain": (outS["full"], ic.gather_plain(pS, gS),
                                plain),
        "small_full_vs_host_double": (outS["full"], refS, host),
        "small_direct_vs_plain": (outS_direct, ic.gather_plain(pS, gS),
                                  plain),
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
    # the binning's offsets are integers and equal exactly (required above)
    errs["binning_vs_plain"] = max(
        max_abs(binsL.offsets, plain_binsL.offsets),
        max_abs(binsO.offsets, plain_binsO.offsets))
    one_bin_count = int(torch.diff(binsO.offsets, dim=1).max())
    require(one_bin_count == INTERP_ONE_BIN[3],
            f"interp2d one-bin case: largest bin holds {one_bin_count}")

    # the one PyTorch call that computes the same function, timed as a
    # yardstick and used nowhere in the port: grid_sample with border
    # padding on coordinates normalised to [-1, 1] (normalised beforehand)
    def normalised(pts, grids):
        H, W = grids.shape[1:]
        return grids[:, None], torch.stack(
            [pts[..., 1] / (W - 1) * 2 - 1,
             pts[..., 0] / (H - 1) * 2 - 1], dim=-1)[:, None]

    def grid_sample(g4, q4):
        return torch.nn.functional.grid_sample(
            g4, q4, mode="bilinear", padding_mode="border",
            align_corners=True)[:, 0, 0]

    gs_in = {"gather": normalised(p32, g32), "binned": normalised(pL, gL),
             "f64": normalised(p64, g64)}

    # times, kernel beside plain on the same inputs: (call, leg)
    calls = {
        "gather": (lambda: ic.gather_cuda(p32, g32), INTERP_F32),
        "gather_direct": (lambda: ic.gather_cuda(p32, g32, body="direct"),
                          INTERP_F32),
        "gather_plain": (lambda: ic.gather_plain(p32, g32), INTERP_F32),
        "gather_bf16": (lambda: ic.gather_cuda(p32, bf32), INTERP_F32),
        "gather_bf16_direct": (lambda: ic.gather_cuda(p32, bf32,
                                                      body="direct"),
                               INTERP_F32),
        "gather_bf16_plain": (lambda: ic.gather_plain(p32, bf32),
                              INTERP_F32),
        "config2_entry_auto": (lambda: pt.bilinear_batched(p32, g32),
                               INTERP_F32),
        "config2_entry_bf16": (
            lambda: pt.bilinear_batched(p32, g32, precision="bf16"),
            INTERP_F32),
        "binned": (lambda: ic.binned_cuda(gL, binsL), INTERP_LARGE),
        "binned_plain": (lambda: ic.binned_plain(gL, binsL), INTERP_LARGE),
        "binning": (lambda: ic.bin_queries_cuda(pL, 1024, 1024),
                    INTERP_LARGE),
        "binning_plain": (lambda: ic.bin_queries(pL, 1024, 1024),
                          INTERP_LARGE),
        "large_entry_auto": (lambda: pt.bilinear_batched(pL, gL),
                             INTERP_LARGE),
        "gather_at_1024": (lambda: ic.gather_cuda(pL, gL), INTERP_LARGE),
        "gather_plain_at_1024": (lambda: ic.gather_plain(pL, gL),
                                 INTERP_LARGE),
        "f64": (lambda: ic.f64_cuda(p64, g64), INTERP_F64),
        "f64_plain": (lambda: ic.f64_plain(p64, g64), INTERP_F64),
        "f64_entry": (lambda: pt.bilinear_batched_f64(p64, g64),
                      INTERP_F64),
    }
    for key in gs_in:
        calls[f"grid_sample_{key}"] = (
            lambda a=gs_in[key]: grid_sample(*a),
            {"gather": INTERP_F32, "binned": INTERP_LARGE,
             "f64": INTERP_F64}[key])
    times = {k: timed(fn, torch) for k, (fn, _) in calls.items()}
    rate = {k: leg[0] * leg[3] / (times[k][0] * 1e-3) / 1e6
            for k, (_, leg) in calls.items()}
    f64_turns = timed_in_turns({k: calls[k][0] for k in (
        "f64_entry", "grid_sample_f64")}, torch)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cold_keys = ("gather", "gather_direct", "gather_bf16",
                 "gather_bf16_direct", "config2_entry_auto", "binned",
                 "binning", "large_entry_auto", "gather_at_1024", "f64",
                 "grid_sample_gather", "grid_sample_binned",
                 "grid_sample_f64")
    cold = {k: timed_cold(calls[k][0], torch, flush_buf.zero_)
            for k in cold_keys}
    del flush_buf
    dev_keys = ("gather", "gather_direct", "gather_bf16",
                "gather_bf16_direct", "binned", "binning",
                "large_entry_auto", "gather_at_1024", "f64",
                "grid_sample_gather", "grid_sample_binned",
                "grid_sample_f64")
    dev_us, dev_kernels = {}, {}
    for k in dev_keys:
        dev_us[k], dev_kernels[k] = device_us(calls[k][0], torch)
    sorts = [k for k in dev_kernels["large_entry_auto"]
             if "sort" in k.lower()]
    require(not sorts, f"interp2d: the profiled auto call ran sorts {sorts}")
    require(len(dev_kernels["large_entry_auto"]) == 4,
            "interp2d: the 1024^2 auto call ran "
            f"{list(dev_kernels['large_entry_auto'])}, not the three "
            "binning kernels and K8")

    # host work per wrapper call, at a size where the device is idle
    pT, gT = interp_inputs(torch, dev, (1, 8, 8, 2), f32, 5)
    pT64, gT64 = pT.double(), gT.double()
    binsT = ic.bin_queries_cuda(pT, 8, 8)
    host = {"gather_cuda": host_us(lambda: ic.gather_cuda(pT, gT), torch),
            "bin_queries_cuda": host_us(
                lambda: ic.bin_queries_cuda(pT, 8, 8), torch),
            "binned_cuda": host_us(lambda: ic.binned_cuda(gT, binsT),
                                   torch),
            "f64_cuda": host_us(lambda: ic.f64_cuda(pT64, gT64), torch),
            "bilinear_batched_f64": host_us(
                lambda: pt.bilinear_batched_f64(pT64, gT64), torch),
            "bilinear_batched_full": host_us(
                lambda: pt.bilinear_batched(pT, gT), torch),
            "bilinear_batched_binned": host_us(
                lambda: pt.bilinear_batched(pT, gT, method="binned"),
                torch)}

    library = {k: {"ms": times[f"grid_sample_{k}"][0],
                   "device_us": dev_us[f"grid_sample_{k}"],
                   "max_abs_err_vs_kernel": max_abs(
                       grid_sample(*gs_in[k]), out)}
               for k, out in (("gather", out32), ("binned", outL),
                              ("f64", out64))}
    row = {"phase": "interp2d", "shapes": {"f32": INTERP_F32,
                                           "large": INTERP_LARGE,
                                           "f64": INTERP_F64},
           "launches": routes,
           "staged_bands": {
               "config2_f32": ic.gather_body(p32, g32),
               "config2_bf16": ic.gather_body(p32, bf32),
               "1024_f32": ic.gather_body(pL, gL)},
           "binning_vs_plain": binning,
           "max_abs_err": errs, "bars": bars,
           "one_bin_largest_bin": one_bin_count,
           "ms_median_of_20": {k: v[0] for k, v in times.items()},
           "ms_back_to_back_mean_of_20": {k: v[1] for k, v in times.items()},
           "ms_l2_flushed_median_of_10": cold,
           "device_us_per_call": dev_us,
           "device_us_by_kernel": dev_kernels,
           "host_us_per_call_of_1000": host,
           # K6's entry against grid_sample's f64 call, single calls in
           # turns
           "f64_entry_vs_grid_sample_ms_in_turns": f64_turns,
           "mq_per_s": rate, "library_grid_sample": library, "card": smi}
    emit(row)

    def entry(name, line, key, launched, err_keys, io, dtype, lib,
              ops=BILINEAR_OPS_PER_QUERY):
        queries = outs["f64" if key == "f64" else (
            "large_auto" if key in ("binned", "binning")
            else "config2_auto")].numel()
        b_ms, b_by = bound(nbytes(*io), ops * queries, dtype)
        return {"name": name, "route": "cuda", "source": INTERP_SRC,
                "replaces": f"{INTERP_TPU}:{line}", "launches": launched,
                "max_abs_err": max(errs[k] for k in err_keys),
                "ms": times[key][0], "plain_ms": times[key + "_plain"][0],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library[lib]["ms"] if lib else None,
                "ms_l2_flushed": cold[key], "device_us": dev_us[key],
                "library_device_us": (library[lib]["device_us"] if lib
                                      else None)}

    binning_entry = entry(
        "bilinear_binning", 787, "binning",
        routes["large_auto"]["bilinear_binning"], ["binning_vs_plain"],
        (pL, binsL.pairs, binsL.order, binsL.offsets), "float32", None,
        BIN_OPS_PER_QUERY)
    return [
        entry("bilinear_gather", 871, "gather",
              routes["config2_auto"]["bilinear_gather"],
              ["gather_vs_plain", "gather_direct_vs_plain",
               "gather_bf16_vs_plain", "gather_bf16_direct_vs_plain",
               "gather_at_1024_vs_plain", "small_full_vs_plain",
               "small_direct_vs_plain"], (p32, g32, out32), "float32",
              "gather"),
        entry("bilinear_binned", 670, "binned",
              routes["large_auto"]["bilinear_binned"],
              ["binned_vs_plain", "binned_bf16_vs_plain",
               "binned_one_bin_vs_plain", "small_binned_vs_plain"],
              (gL, binsL.pairs, binsL.order, binsL.offsets, outL),
              "float32", "binned"),
        binning_entry,
        {**entry("bilinear_f64", 556, "f64", routes["f64"]["bilinear_f64"],
                 ["f64_vs_plain", "small_f64_vs_plain"], (p64, g64, out64),
                 "float64", "f64"),
         "entry_ms": times["f64_entry"][0],
         "entry_vs_library_ms_in_turns": f64_turns,
         "host_us_per_call": {k: host[k] for k in ("f64_cuda",
                                                   "bilinear_batched_f64")}},
    ]


def sin_table(n):
    """The bench's uniform table: ``sin`` at ``n`` nodes on [-3, 3], f32,
    with its ``x0`` and ``dx``."""
    import numpy as np
    return np.sin(np.linspace(-3, 3, n)).astype(np.float32), -3.0, \
        6.0 / (n - 1)


def gap_nodes(n, seed, g0=0.1, scale=0.05):
    """Non-uniform nodes from gaps ``g0 + U[0, 1)`` and ``fp = sin(scale *
    xp)``, f32 (bench.py:220-224)."""
    import numpy as np
    gaps = (g0 + np.random.default_rng(seed).uniform(0, 1, n - 1)).astype(
        np.float32)
    xp = np.concatenate([[0.0], np.cumsum(gaps)]).astype(np.float32)
    return xp, np.sin(scale * xp).astype(np.float32)


def dense_cluster():
    """tests/test_interp_pallas.py:125-131: 100 nodes within 2e-2."""
    import numpy as np
    xp = np.concatenate([np.linspace(0.0, 1.0, 50),
                         1.0 + np.linspace(1e-4, 2e-2, 100),
                         np.linspace(1.1, 10.0, 30)]).astype(np.float32)
    fp = np.random.default_rng(0).standard_normal(xp.shape[0]).astype(
        np.float32)
    return xp, fp


def uniform_queries(Q, lo, hi, seed, extreme=False):
    """Seeded f32 queries uniform in ``[lo, hi)``, the extreme values
    first if asked."""
    import numpy as np
    q = np.random.default_rng(seed).uniform(lo, hi, Q)
    if extreme:
        q[:len(EXTREME)] = EXTREME
    return q.astype(np.float32)


def nan_aware_err(got, want) -> float:
    """Max |got - want| where ``want`` is not NaN; inf if the NaNs differ."""
    import torch
    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    if got.shape != want.shape or not torch.equal(got.isnan(), want.isnan()):
        return math.inf
    ok = ~want.isnan()
    return float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) else 0.0


def interp1d(pt, torch, dev, smi: str):
    """The 1-D family: the legs through the public entry points with the
    launch counts set to 0 just before each and read just after (``lerp1d``
    and ``make_interp1d``'s direct routes, ``lerp1d_binned`` and the sorted
    non-uniform route, with K5's body counts); each kernel against its
    plain version and numpy.interp; timings, device time by the profiler;
    K5's two modes each with its own bound, and K5 by table size."""
    import numpy as np
    from armadillocudalinearinterpolation_torch.ops import interp1d_cuda as i1
    launches = i1.LAUNCHES
    f32 = torch.float32

    def on_card(a):
        return torch.from_numpy(a).to(dev)

    (n1, Q1), (nK, QK), (nN, QN) = LERP_CONFIG1, LERP_64K, INTERP_NONUNIFORM
    fp1_h, x0, dx1 = sin_table(n1)
    q1_h = uniform_queries(Q1, -3.0, 3.0, 10)
    fpK_h, _, dxK = sin_table(nK)
    qK_h = uniform_queries(QK, -3.0, 3.0, 11)
    xpN_h, fpN_h = gap_nodes(nN, 12)
    qN_h = uniform_queries(QN, -1.0, float(xpN_h[-1]) + 1.0, 13)
    fp1, q1, fpK, qK = map(on_card, (fp1_h, q1_h, fpK_h, qK_h))
    xpN, fpN, qN = map(on_card, (xpN_h, fpN_h, qN_h))
    tableN = pt.make_interp1d(xpN, fpN)
    torch.cuda.synchronize()

    def drive(fn):
        for d in (launches, i1.BODIES):
            for k in d:
                d[k] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, dict(launches)

    def bodies_run():
        return {k: v for k, v in i1.BODIES.items() if v}

    nbK, nbN = i1._pow2_batches(QK), i1._pow2_batches(QN)
    out1, route1 = drive(lambda: pt.lerp1d(q1, fp1, x0, dx1))
    outK, routeK = drive(lambda: pt.lerp1d(qK, fpK, x0, dxK))
    outKb, routeKb = drive(lambda: pt.lerp1d_binned(qK, fpK, x0, dxK,
                                                    n_batches=nbK))
    outNa, routeNa = drive(lambda: tableN(qN))
    bodyNa = bodies_run()
    outN, routeN = drive(lambda: tableN(qN, method="sorted"))
    bodyN = bodies_run()
    # K5's bodies at 4096 nodes: the tables in shared memory (direct), one
    # CTA a batch (sorted)
    require(bodyNa == {"interp1d_shared": 1} and bodyN == {
                "interp1d_batch": 1},
            f"interp1d non-uniform: bodies {bodyNa} (direct) and {bodyN} "
            "(sorted)")
    for name, out, Q in (("config 1", out1, Q1), ("64k", outK, QK),
                         ("64k binned", outKb, QK),
                         ("non-uniform", outNa, QN),
                         ("non-uniform sorted", outN, QN)):
        require(out.shape == (Q,) and out.dtype == f32
                and bool(torch.isfinite(out).all()),
                f"interp1d {name}: shape {tuple(out.shape)}, {out.dtype}, "
                "or non-finite values")
    for name, route, key in (("config 1", route1, "lerp1d"),
                             ("64k", routeK, "lerp1d"),
                             ("64k binned", routeKb, "lerp1d_sorted"),
                             ("non-uniform", routeNa, "interp1d"),
                             ("non-uniform sorted", routeN, "interp1d")):
        want = {k: int(k == key) for k in launches}
        require(route == want, f"interp1d {name}: launched {route}, not "
                f"one {key}")

    # each kernel against its plain version at the legs' shapes, and
    # against numpy.interp in float64 on the same f32 inputs
    lims1, limsK = i1.uniform_lims(x0, dx1), i1.uniform_lims(x0, dxK)
    qsK, orderK = i1.sort_batches(qK, nbK)
    qsN, orderN = i1.sort_batches(qN, nbN)
    outK3 = i1.lerp1d_cuda(qK, fpK, *limsK)
    outN_direct = i1.interp1d_cuda(tableN, qN)

    def numpy_uniform(q_h, fp_h, dx):
        return np.interp(q_h.astype(np.float64),
                         x0 + dx * np.arange(fp_h.shape[0]),
                         fp_h.astype(np.float64))

    plain, ref, dense = "vs_plain", "vs_numpy", "dense_cluster_vs_numpy"
    checks = {   # name: (kernel's result, reference, bar)
        "lerp1d_vs_plain": (out1, i1.lerp1d_plain(q1, fp1, *lims1), plain),
        "lerp1d_vs_numpy": (out1, numpy_uniform(q1_h, fp1_h, dx1), ref),
        "lerp1d_sorted_vs_plain": (outKb, i1.lerp1d_sorted_plain(
            qsK, orderK, fpK, *limsK, QK), plain),
        "lerp1d_sorted_vs_numpy": (outKb, numpy_uniform(qK_h, fpK_h, dxK),
                                   ref),
        "lerp1d_at_64k_vs_plain": (outK3, i1.lerp1d_plain(qK, fpK, *limsK),
                                   plain),
        "lerp1d_at_64k_vs_sorted": (outK3, outKb, plain),
        "lerp1d_64k_entry_vs_sorted": (outK, outKb, plain),
        "interp1d_sorted_vs_plain": (outN, i1.interp1d_plain(
            tableN, qsN, orderN, QN), plain),
        "interp1d_sorted_vs_numpy": (outN, np.interp(
            qN_h.astype(np.float64), xpN_h.astype(np.float64),
            fpN_h.astype(np.float64)), ref),
        "interp1d_vs_plain": (outN_direct, i1.interp1d_plain(tableN, qN),
                              plain),
        "interp1d_vs_sorted": (outN_direct, outN, plain),
        "interp1d_entry_vs_sorted": (outNa, outN, plain),
    }
    # small tables with out-of-range, extreme and NaN queries, through all
    # three kernels (the sorted ones over padded batches)
    small_launches = dict(launches)
    for n in SMALL_TABLES:
        fp_h, _, dx = sin_table(n)
        q_h = uniform_queries(SMALL_QUERIES, -4.0, 4.0, n, extreme=True)
        fp, q = on_card(fp_h), on_card(q_h)
        lims = i1.uniform_lims(x0, dx)
        qs, order = i1.sort_batches(q, 8)
        want = numpy_uniform(q_h, fp_h, dx)
        k3 = i1.lerp1d_cuda(q, fp, *lims)
        k4 = i1.lerp1d_sorted_cuda(qs, order, fp, *lims, SMALL_QUERIES, 8)
        checks[f"small_lerp1d_{n}_vs_plain"] = (
            k3, i1.lerp1d_plain(q, fp, *lims), plain)
        checks[f"small_lerp1d_{n}_vs_numpy"] = (k3, want, ref)
        checks[f"small_lerp1d_sorted_{n}_vs_plain"] = (
            k4, i1.lerp1d_sorted_plain(qs, order, fp, *lims, SMALL_QUERIES),
            plain)
        checks[f"small_lerp1d_sorted_{n}_vs_numpy"] = (k4, want, ref)
        xp_h, fpn_h = gap_nodes(n, 20 + n)
        table = pt.make_interp1d(on_card(xp_h), on_card(fpn_h))
        q_h = uniform_queries(SMALL_QUERIES, -1.0, float(xp_h[-1]) + 1.0,
                              n, extreme=True)
        q = on_card(q_h)
        qs, order = i1.sort_batches(q, 8)
        want = np.interp(q_h.astype(np.float64), xp_h.astype(np.float64),
                         fpn_h.astype(np.float64))
        k5 = i1.interp1d_cuda(table, q)
        k5s = i1.interp1d_cuda(table, qs, order, SMALL_QUERIES, 8)
        checks[f"small_interp1d_{n}_vs_plain"] = (
            k5, i1.interp1d_plain(table, q), plain)
        checks[f"small_interp1d_{n}_vs_numpy"] = (k5, want, ref)
        checks[f"small_interp1d_sorted_{n}_vs_plain"] = (
            k5s, i1.interp1d_plain(table, qs, order, SMALL_QUERIES), plain)
        checks[f"small_interp1d_sorted_{n}_vs_numpy"] = (k5s, want, ref)
    xp_h, fpn_h = dense_cluster()
    table = pt.make_interp1d(on_card(xp_h), on_card(fpn_h))
    q_h = uniform_queries(7777, 0.9, 1.2, 14)
    k5 = i1.interp1d_cuda(table, on_card(q_h))
    checks["dense_cluster_vs_plain"] = (
        k5, i1.interp1d_plain(table, on_card(q_h)), plain)
    checks["dense_cluster_vs_numpy"] = (k5, np.interp(
        q_h.astype(np.float64), xp_h.astype(np.float64),
        fpn_h.astype(np.float64)), dense)
    torch.cuda.synchronize()
    small_launches = {k: launches[k] - small_launches[k] for k in launches}
    require(small_launches == {"lerp1d": 3, "lerp1d_sorted": 3,
                               "interp1d": 7},
            f"interp1d small tables: launched {small_launches}")

    bars = INTERP1D_BARS
    errs = {}
    for key, (got, want, bar) in checks.items():
        errs[key] = nan_aware_err(got, want)
        require(errs[key] <= bars[bar],
                f"interp1d {key}: {errs[key]} > {bars[bar]}")

    # K5 at 1024, 4096 and 65536 non-uniform nodes x 2M uniform queries,
    # both modes, each with the body it ran, against the plain version;
    # each mode's bound from the bytes of its own call's tensors
    by_nodes = {}
    for n in K5_NODES:
        xp_h, fpn_h = gap_nodes(n, 12)
        table = pt.make_interp1d(on_card(xp_h), on_card(fpn_h))
        q = on_card(uniform_queries(QN, -1.0, float(xp_h[-1]) + 1.0, 13))
        qs, order = i1.sort_batches(q, nbN)
        want = i1.interp1d_plain(table, q)
        rec = {"S": table.S, "buckets": table.m}
        for mode, fn, io in (
                ("direct", lambda: i1.interp1d_cuda(table, q),
                 (q, table.nodes, table.bucket)),
                ("sorted", lambda: i1.interp1d_cuda(table, qs, order, QN,
                                                    nbN),
                 (qs, order, table.nodes, table.bucket))):
            before = dict(i1.BODIES)
            out = fn()
            torch.cuda.synchronize()
            ran = [k for k, v in i1.BODIES.items() if v != before[k]]
            key = f"interp1d_{n}_{mode}_vs_plain"
            errs[key] = nan_aware_err(out, want)
            require(errs[key] <= bars["vs_plain"],
                    f"interp1d {key}: {errs[key]} > {bars['vs_plain']}")
            b_ms, _ = bound(nbytes(*io, out), LERP_OPS_PER_QUERY * QN,
                            "float32")
            d_us = device_us(fn, torch)[0]
            rec[mode] = {"body": ran, "device_us": d_us, "bound_ms": b_ms,
                         "share_of_bound": (b_ms * 1e3 / d_us if d_us
                                            else None)}
        by_nodes[n] = rec
        del table, q, qs, order, want, out
    require(by_nodes[65536]["direct"]["body"] == ["interp1d_readonly"]
            and by_nodes[4096]["direct"]["body"] == ["interp1d_shared"],
            f"interp1d: K5's direct bodies by nodes {by_nodes}")

    # times, kernel beside plain on the same inputs: (call, queries)
    calls = {
        "lerp1d": (lambda: i1.lerp1d_cuda(q1, fp1, *lims1), Q1),
        "lerp1d_plain": (lambda: i1.lerp1d_plain(q1, fp1, *lims1), Q1),
        "config1_entry": (lambda: pt.lerp1d(q1, fp1, x0, dx1), Q1),
        "lerp1d_sorted": (lambda: i1.lerp1d_sorted_cuda(
            qsK, orderK, fpK, *limsK, QK, nbK), QK),
        "lerp1d_sorted_plain": (lambda: i1.lerp1d_sorted_plain(
            qsK, orderK, fpK, *limsK, QK), QK),
        "sort_64k": (lambda: i1.sort_batches(qK, nbK), QK),
        "64k_entry": (lambda: pt.lerp1d(qK, fpK, x0, dxK), QK),
        "64k_binned_entry": (lambda: pt.lerp1d_binned(
            qK, fpK, x0, dxK, n_batches=nbK), QK),
        "lerp1d_at_64k": (lambda: i1.lerp1d_cuda(qK, fpK, *limsK), QK),
        "lerp1d_at_64k_plain": (lambda: i1.lerp1d_plain(qK, fpK, *limsK),
                                QK),
        "interp1d_sorted": (lambda: i1.interp1d_cuda(
            tableN, qsN, orderN, QN, nbN), QN),
        "interp1d_sorted_plain": (lambda: i1.interp1d_plain(
            tableN, qsN, orderN, QN), QN),
        "sort_nonuniform": (lambda: i1.sort_batches(qN, nbN), QN),
        "nonuniform_entry": (lambda: tableN(qN), QN),
        "nonuniform_sorted_entry": (lambda: tableN(qN, method="sorted"),
                                    QN),
        "interp1d": (lambda: i1.interp1d_cuda(tableN, qN), QN),
        "interp1d_plain": (lambda: i1.interp1d_plain(tableN, qN), QN),
    }
    # a back-to-back run holds 20 outputs of 40 MB at config 1: grow the
    # caching allocator first, so that no timing pays for cudaMalloc
    timed(calls["lerp1d"][0], torch)
    times = {k: timed(fn, torch) for k, (fn, _) in calls.items()}
    rate = {k: Q / (times[k][0] * 1e-3) / 1e9 for k, (_, Q) in calls.items()}
    dev_keys = ("lerp1d", "lerp1d_sorted", "sort_64k", "64k_entry",
                "64k_binned_entry", "lerp1d_at_64k", "interp1d_sorted",
                "sort_nonuniform", "nonuniform_entry",
                "nonuniform_sorted_entry", "interp1d")
    dev_us = {k: device_us(calls[k][0], torch)[0] for k in dev_keys}

    # the one PyTorch call that computes K3's and K4's function, timed as a
    # yardstick and used nowhere in the port: grid_sample on a 1 x n image,
    # border padding, align_corners=True, the queries normalised to [-1, 1]
    # beforehand.  K5's non-uniform nodes have no such single call.
    def grid_sample_1d(fp, q, dx):
        u = (q - x0) / (dx * (fp.shape[0] - 1)) * 2 - 1
        return fp[None, None, None], torch.stack(
            [u, torch.zeros_like(u)], dim=-1)[None, None]

    def grid_sample(img, grid):
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True)[0, 0, 0]

    library = {}
    for key, (fp, q, dx, out) in {"lerp1d": (fp1, q1, dx1, out1),
                                  "lerp1d_sorted": (fpK, qK, dxK, outKb)
                                  }.items():
        args = grid_sample_1d(fp, q, dx)
        library[key] = {
            "ms": timed(lambda a=args: grid_sample(*a), torch)[0],
            "device_us": device_us(lambda a=args: grid_sample(*a),
                                   torch)[0],
            "max_abs_err_vs_kernel": nan_aware_err(grid_sample(*args),
                                                   out)}
        del args
    # K5's two modes at 4096 x 2M, each with its own call's bound: direct
    # moves the queries, the tables and the output; sorted also the int64
    # order
    k5_modes = {}
    for mode, key, body, io in (
            ("direct", "interp1d", bodyNa,
             (qN, tableN.nodes, tableN.bucket, outN_direct)),
            ("sorted", "interp1d_sorted", bodyN,
             (qsN, orderN, tableN.nodes, tableN.bucket, outN))):
        b_ms, b_by = bound(nbytes(*io), LERP_OPS_PER_QUERY * QN, "float32")
        k5_modes[mode] = {
            "body": list(body), "device_us": dev_us[key],
            "ms_median_of_20": times[key][0],
            "ms_back_to_back_mean_of_20": times[key][1],
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms * 1e3 / dev_us[key]}
    row = {"phase": "interp1d",
           "k5_modes": k5_modes, "k5_by_nodes": by_nodes,
           "shapes": {"config1": LERP_CONFIG1, "64k": LERP_64K,
                      "nonuniform": INTERP_NONUNIFORM,
                      "small_tables": SMALL_TABLES},
           "launches": {"config1": route1, "64k": routeK,
                        "64k_binned": routeKb, "nonuniform": routeNa,
                        "nonuniform_sorted": routeN,
                        "small": small_launches},
           "n_batches": {"64k": nbK, "nonuniform": nbN},
           "nonuniform_S": tableN.S, "nonuniform_m": tableN.m,
           "max_abs_err": errs, "bars": bars,
           "ms_median_of_20": {k: v[0] for k, v in times.items()},
           "ms_back_to_back_mean_of_20": {k: v[1] for k, v in times.items()},
           "device_us_per_call": dev_us,
           "sort_share_of_sorted_entry": {
               "64k": times["sort_64k"][0] / times["64k_binned_entry"][0],
               "nonuniform": (times["sort_nonuniform"][0]
                              / times["nonuniform_sorted_entry"][0])},
           "gq_per_s": rate, "library_grid_sample": library,
           "library_none": {"interp1d_kernel": "non-uniform nodes: no "
                            "single PyTorch call computes it"},
           "card": smi}
    emit(row)

    def entry(name, line, key, launched, err_keys, io):
        # io: the timed call's inputs and output; the queries come first
        b_ms, b_by = bound(nbytes(*io), LERP_OPS_PER_QUERY * io[0].numel(),
                           "float32")
        return {"name": name, "route": "cuda", "source": INTERP1D_SRC,
                "replaces": f"{INTERP_TPU}:{line}", "launches": launched,
                "max_abs_err": max(errs[k] for k in err_keys),
                "ms": times[key][0], "plain_ms": times[key + "_plain"][0],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library[key]["ms"] if key in library else None,
                "device_us": dev_us[key],
                "library_device_us": (library[key]["device_us"]
                                      if key in library else None)}

    def vs_plain(part):
        return [k for k in errs if part in k and k.endswith("_vs_plain")]

    return [
        entry("lerp1d_kernel", 246, "lerp1d",
              route1["lerp1d"] + routeK["lerp1d"],
              [k for k in vs_plain("lerp1d_") if "sorted" not in k],
              (q1, fp1, out1)),
        entry("lerp1d_sorted_kernel", 138, "lerp1d_sorted",
              routeKb["lerp1d_sorted"],
              vs_plain("lerp1d_sorted"), (qsK, orderK, fpK, outKb)),
        # the direct mode, the entry point's default, with the sorted
        # mode's figures beside it
        {**entry("interp1d_kernel", 344, "interp1d",
                 routeNa["interp1d"] + routeN["interp1d"],
                 vs_plain("interp1d") + ["dense_cluster_vs_plain"],
                 (qN, tableN.nodes, tableN.bucket, outN_direct)),
         "body": list(bodyNa), "sorted": k5_modes["sorted"],
         "by_nodes": by_nodes},
    ]


def repairs(pt, torch, dev):
    """The launch-size repairs, each through its public entry point with
    the launch counts set to 0 just before and read just after, against the
    plain versions: 65536 grids through both K7 bodies, the binning and K8,
    and K6; ``lerp1d_binned`` with 70000 batches; K1 (every lane and
    windowed) at f64 N=10240 and K2 at N=8448, whose rows do not fit one
    CTA's shared memory."""
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, replay_cuda)
    from armadillocudalinearinterpolation_torch.model.evolve import (
        evolve_ensemble)
    from armadillocudalinearinterpolation_torch.model.replay import (
        replay_events)
    from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic
    from armadillocudalinearinterpolation_torch.ops import interp1d_cuda as i1

    def drive(fn):
        for d in (ic.LAUNCHES, ic.BODIES, i1.LAUNCHES):
            for k in d:
                d[k] = 0
        evolve_cuda.LAUNCHES = replay_cuda.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {**ic.LAUNCHES, **ic.BODIES, **i1.LAUNCHES,
                  "evolve_kernel": evolve_cuda.LAUNCHES,
                  "replay_kernel": replay_cuda.LAUNCHES}
        return out, {k: v for k, v in counts.items() if v}

    B, H, W, Q = REPAIR_GRIDS
    p32, g32 = interp_inputs(torch, dev, REPAIR_GRIDS, torch.float32, 6,
                             -3.0, W + 3.0)
    p64, g64 = p32.double(), g32.double()
    n1, Q1, nb1 = REPAIR_BATCHES
    fp_h, x0, dx = sin_table(n1)
    fp1 = torch.from_numpy(fp_h).to(dev)
    q1 = torch.from_numpy(uniform_queries(Q1, -3.5, 3.5, 15,
                                          extreme=True)).to(dev)
    legs = {
        "grids_full": lambda: pt.bilinear_batched(p32, g32, method="full"),
        "grids_direct": lambda: ic.gather_cuda(p32, g32, body="direct"),
        "grids_binned": lambda: pt.bilinear_batched(p32, g32,
                                                    method="binned"),
        "grids_f64": lambda: pt.bilinear_batched_f64(p64, g64),
        "batches": lambda: pt.lerp1d_binned(q1, fp1, x0, dx,
                                            n_batches=nb1),
    }
    outs, launched = {}, {}
    for name, fn in legs.items():
        outs[name], launched[name] = drive(fn)
    want32 = ic.gather_plain(p32, g32)
    errs = {"grids_full": max_abs(outs["grids_full"], want32),
            "grids_direct": max_abs(outs["grids_direct"], want32),
            "grids_binned": max_abs(outs["grids_binned"], want32),
            "grids_f64": max_abs(outs["grids_f64"], ic.f64_plain(p64, g64)),
            "batches": nan_aware_err(outs["batches"], i1.lerp1d_plain(
                q1, fp1, *i1.uniform_lims(x0, dx)))}
    bars = {"grids_full": INTERP_BARS["f32_vs_plain"],
            "grids_direct": INTERP_BARS["f32_vs_plain"],
            "grids_binned": INTERP_BARS["f32_vs_plain"],
            "grids_f64": INTERP_BARS["f64"],
            "batches": INTERP1D_BARS["vs_plain"]}
    want_launches = {
        "grids_full": {"bilinear_gather": 1, "gather_staged": 1},
        "grids_direct": {"bilinear_gather": 1, "gather_direct": 1},
        "grids_binned": {"bilinear_binning": 1, "bilinear_binned": 1,
                         "binned_sync": 1},
        "grids_f64": {"bilinear_f64": 1},
        "batches": {"lerp1d_sorted": 1}}
    for name in legs:
        require(errs[name] <= bars[name],
                f"repairs {name}: {errs[name]} > {bars[name]}")
        require(launched[name] == want_launches[name],
                f"repairs {name}: launched {launched[name]}, not "
                f"{want_launches[name]}")

    # K1 and K2 with their rows in device memory, on the Driver.cu guess
    large = {}
    for kind, N in (("evolve", REPAIR_EVOLVE_N), ("replay", REPAIR_REPLAY_N)):
        cfg = pt.ModelConfig(n_neurons=N, n_real=REPAIR_R, dtype="float64",
                             root_tol=1e-12, max_events=2 * N)
        require(not evolve_cuda.row_fits_shared(
                    N, cfg.n_spikes, torch.float64, kind,
                    evolve_cuda.shared_optin_bytes(dev)),
                f"repairs: a row of {N} lanes fits shared memory")
        params = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
        beta = pt.sample_beta(cfg, params,
                              torch.Generator(device=dev).manual_seed(0))
        z = torch.tensor(INITIAL_GUESS, dtype=torch.float64, device=dev)[None]
        ii = pt.initial_spike_indices(cfg, z).contiguous()
        v0, s0 = (x.contiguous() for x in pt.lift(cfg, params,
                                                    pt.z_to_u(z)))
        if kind == "evolve":
            k_ms, (rk, cnt) = cuda_ms(lambda: drive(
                lambda: evolve_cuda.evolve_ensemble_cuda(
                    cfg, v0, s0, beta, ii)), torch)
            rw, cnt_w = drive(lambda: evolve_cuda.evolve_ensemble_cuda(
                cfg.with_(evolve_window=512), v0, s0, beta, ii))
            p_ms, rp = cuda_ms(lambda: evolve_ensemble(cfg, v0, s0, beta,
                                                       ii), torch)
            windowed_equal = bool(identical_rows(rw, rk).all()
                                  and torch.equal(rw.last_time, rk.last_time)
                                  and torch.equal(rw.crossed_time,
                                                  rk.crossed_time))
            require(windowed_equal and cnt_w == {"evolve_kernel": 1},
                    "repairs: the windowed K1 at large N differs from K1")
        else:
            sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
            k_ms, (rk, cnt) = cuda_ms(lambda: drive(
                lambda: replay_cuda.replay_events_cuda(
                    cfg, sched, n_ev, v0, s0, beta, ii[0])), torch)
            p_ms, rp = cuda_ms(lambda: replay_events(
                cfg, sched, n_ev, v0, s0, beta, ii[0]), torch)
        same = bool(identical_rows(rk, rp).all())
        d = time_diff(rk, rp, torch.ones_like(rk.accept))
        bar = 1e-9 if kind == "evolve" else STAGED_BARS["k2_vs_plain_time"]
        large[kind] = {"N": N, "R": REPAIR_R, "launched": cnt,
                       "identical_ints": same, "max_time_diff": d,
                       "events": [int(rk.n_events.min()),
                                  int(rk.n_events.max())],
                       "accepted": int(rk.accept.sum()),
                       "kernel_ms_first_call": k_ms, "plain_ms": p_ms}
        require(cnt == {f"{kind}_kernel": 1},
                f"repairs: large-N {kind} launched {cnt}")
        require(same and d <= bar,
                f"repairs: large-N {kind} vs plain: {large[kind]}")
    row = {"phase": "repairs", "grids": REPAIR_GRIDS,
           "batches": REPAIR_BATCHES, "launches": launched,
           "max_abs_err": errs, "bars": bars, "large_n": large}
    emit(row)
    return row


def staged(pt, torch, dev, smi: str):
    """The staged Newton to 1e-8 at config 4: the solve from the guess
    (cold) and from the guess + 1e-3 (warm) through ``newton_solve_staged``
    with the launch counts set to 0 just before and read just after and
    the residual recomputed by a fresh replay map, and the warm solve on
    every lane beside it; K1's windowed log against K1 on every lane and
    the plain windowed log; K2 against its plain version; the replay
    against the direct fp64 evolve; the timings and the profiles."""
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, lift_cuda, replay_cuda)
    from armadillocudalinearinterpolation_torch.model.evolve_batched import (
        evolve_ensemble_batched)
    from armadillocudalinearinterpolation_torch.model.replay import (
        compute_schedule, discovery_config, replay_events, schedule_width)
    from armadillocudalinearinterpolation_torch.solvers import staged as st
    bars = STAGED_BARS
    cfg = pt.ModelConfig(**CONFIG4)
    cfg_full = cfg.with_(evolve_window=0)
    cfg32, E = discovery_config(cfg), schedule_width(cfg)
    N, R = cfg.n_neurons, cfg.n_real
    params = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    guess = torch.tensor(INITIAL_GUESS, dtype=torch.float64, device=dev)
    stencil = torch.cat([guess[None], guess[None] + STENCIL_EPS * torch.eye(
        3, dtype=torch.float64, device=dev)])
    ii = pt.initial_spike_indices(cfg, stencil).contiguous()
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params,
                                                pt.z_to_u(stencil)))
    v32, s32, b32 = (x.float().contiguous() for x in (v0[:1], s0[:1], beta))
    torch.cuda.synchronize()

    # the solve first, while no config-4 launch has run in this process
    # ("cold"), then from the guess + 1e-3 ("warm"), through the public
    # entry point; iterations per stage are read by wrapping the stage
    # functions the entry point calls
    stages = []
    wrapped = {}
    for fname in ("newton_solve", "newton_solve_frozen",
                  "frozen_jacobian_polish"):
        def wrap(*a, _f=getattr(st, fname), _n=fname, **kw):
            r = _f(*a, **kw)
            stages.append((_n, r.iterations, r.residual_norm))
            return r
        wrapped[fname] = getattr(st, fname)
        setattr(st, fname, wrap)
    z0 = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    solves = {}
    try:
        for name, z, c in (("cold", z0, cfg), ("warm", z0 + 1e-3, cfg),
                           ("warm_full_lane", z0 + 1e-3, cfg_full)):
            stages.clear()
            evolve_cuda.LAUNCHES = replay_cuda.LAUNCHES = 0
            lift_cuda.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pt.newton_solve_staged(c, params, z, beta=beta,
                                         tolerance=STAGED_TOL)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"evolve_kernel": evolve_cuda.LAUNCHES,
                        "replay_kernel": replay_cuda.LAUNCHES,
                        "lift_kernel": lift_cuda.LAUNCHES}
            sol = res.solution
            f = pt.event_driven_map(cfg, params, beta, sol,
                                    evolve_backend="replay")
            zz = sol.double().cpu()
            pos = zz[0] * zz[1:]
            solves[name] = {
                "wall_s": wall, "converged": res.converged,
                "iterations": res.iterations,
                "residual_norm": res.residual_norm,
                "recomputed_norm": float(torch.linalg.vector_norm(f)),
                "solution": zz.tolist(),
                "distance_to_guess": float(
                    (zz - torch.tensor(INITIAL_GUESS)).abs().max()),
                "in_domain": bool(torch.isfinite(zz).all() and zz[0] > 0
                                  and (pos > 0).all()
                                  and (pos < 2 * cfg.half_width).all()),
                "stages": [list(s) for s in stages], "launches": launches}
    finally:
        for fname, fn in wrapped.items():
            setattr(st, fname, fn)

    # K1's windowed log on the guess's f32 discovery pass, against K1 on
    # every lane (every row and entry equal) and the plain windowed log
    log_fallbacks = torch.zeros(R, dtype=torch.int32, device=dev)
    log_ms, (rk, sk) = cuda_ms(lambda: evolve_cuda.evolve_ensemble_cuda(
        cfg32, v32, s32, b32, ii[:1], record_schedule=E,
        fallbacks=log_fallbacks), torch)
    full_log_ms, (rf, sf) = cuda_ms(lambda: evolve_cuda.evolve_ensemble_cuda(
        cfg32.with_(evolve_window=0), v32, s32, b32, ii[:1],
        record_schedule=E), torch)
    plain_log_ms, (rp, sp) = cuda_ms(lambda: evolve_ensemble_batched(
        cfg32, v32, s32, b32, ii[:1], record_schedule=E), torch)
    full_same = identical_rows(rk, rf) & (
        (rk.last_time == rf.last_time).all(1)
        & (rk.crossed_time == rf.crossed_time).all(1))
    full_share = float(full_same.float().mean())
    require(full_share == 1.0 and bool(torch.equal(sk, sf)),
            f"staged: the windowed K1 log differs from the full-lane K1 "
            f"log ({full_share:.4%} of rows equal)")
    same = identical_rows(rk, rp)
    log_share = float(same.float().mean())
    log_same = bool(torch.equal(sk[same], sp[same]))
    log_res = float((evolve_residual(pt, cfg32, stencil[:1].float(), rk)
                     - evolve_residual(pt, cfg32, stencil[:1].float(), rp))
                    .abs().max())
    require(log_share >= bars["log_identical_rows"],
            f"staged: K1 log identical rows {log_share}")
    require(log_same, "staged: K1's log differs from the plain log on rows "
            "with the same outcome")
    require(log_res <= bars["log_residual"],
            f"staged: K1 log residual diff {log_res}")

    # K2 against the plain replay: the guess (64 rows) and the forward
    # stencil around it (256 rows), on K1's log; the threads each shape
    # takes, K2's own device time and its µs per event (over the mean
    # logged events per row)
    sched, n_ev = sk, rk.n_events
    props = torch.cuda.get_device_properties(dev)
    optin = evolve_cuda.shared_optin_bytes(dev)
    events_per_row = float(torch.clamp(n_ev, max=E).double().mean())
    k2 = {}
    for name, P in (("64_rows", 1), ("256_rows", 4)):
        args = (cfg, sched, n_ev, v0[:P], s0[:P], beta, ii[0])
        k_ms, rep_k = cuda_ms(lambda: replay_cuda.replay_events_cuda(*args),
                              torch)
        p_ms, rep_p = cuda_ms(lambda: replay_events(*args), torch)
        ints = bool(torch.equal(identical_rows(rep_k, rep_p),
                                torch.ones_like(rep_k.accept)))
        d = time_diff(rep_k, rep_p, torch.ones_like(rep_k.accept))
        _, per_kernel = device_us(
            lambda: replay_cuda.replay_events_cuda(*args), torch, n=3)
        us = next((v for k, v in per_kernel.items() if "replay_kernel" in k),
                  None)
        k2[name] = {"identical_ints": ints, "max_time_diff": d,
                    "kernel_ms_first_call": k_ms, "plain_ms": p_ms,
                    "accepted": int(rep_k.accept.sum()),
                    "threads": replay_cuda.replay_layout(
                        N, cfg.n_spikes, P * R, props.multi_processor_count,
                        optin, props.shared_memory_per_multiprocessor),
                    "device_us": us, "events_per_row_mean": events_per_row,
                    "us_per_event": None if us is None
                    else us / events_per_row}
        require(ints, f"staged: K2 {name}: indices or accept differ")
        require(d <= bars["k2_vs_plain_time"], f"staged: K2 {name}: {d}")
        if P == 1:
            rep64, args64, plain64_ms = rep_k, args, p_ms

    # the replay against the direct fp64 evolve (K1 in f64, with its log):
    # K2 replaying the f64 evolve's own firing order holds it to 1e-10
    # (tests/test_replay.py:41-52); the f32 discovery order can differ from
    # it at near-simultaneous firings, a neighbouring smooth piece of the
    # map, so on that order only the residual is held (to 1e-5)
    direct, sched64 = evolve_cuda.evolve_ensemble_cuda(
        cfg, v0[:1], s0[:1], beta, ii[:1], record_schedule=E)
    rep_f64 = replay_cuda.replay_events_cuda(cfg, sched64, direct.n_events,
                                             v0[:1], s0[:1], beta, ii[0])
    same_f64 = identical_rows(rep_f64, direct)
    d_time = time_diff(rep_f64, direct, same_f64)
    same_d = identical_rows(rep64, direct, events=False)
    same_log = same_d & (sched == sched64).all(1)
    d_res = float((evolve_residual(pt, cfg, stencil[:1], rep64)
                   - evolve_residual(pt, cfg, stencil[:1], direct))
                  .abs().max())
    require(float(same_f64.float().mean()) >= 0.99,
            "staged: the replay of the f64 log changed outcomes")
    require(d_time <= bars["replay_vs_direct_time"],
            f"staged: replay vs direct f64 evolve times {d_time}")
    require(d_res <= bars["replay_vs_direct_residual"],
            f"staged: replay vs direct f64 residual {d_res}")
    vs_direct = {
        "f64_log": {"identical_share": float(same_f64.float().mean()),
                    "max_time_diff": d_time},
        "f32_log": {"identical_share": float(same_d.float().mean()),
                    "rows_with_the_f64_order": int(same_log.sum()),
                    "log_entries_equal_share": float(
                        (sched == sched64).float().mean()),
                    "max_time_diff_same_order": time_diff(rep64, direct,
                                                          same_log),
                    "max_time_diff_other_order": time_diff(
                        rep64, direct, same_d & ~same_log),
                    "residual_delta": d_res}}

    # one accurate map evaluation at the solution, and its two passes
    sol = torch.tensor(solves["cold"]["solution"], dtype=torch.float64,
                       device=dev)
    ii_sol = pt.initial_spike_indices(cfg, sol[None]).contiguous()
    v_sol, s_sol = (x.contiguous() for x in pt.lift(cfg, params,
                                                      pt.z_to_u(sol[None])))
    sched_sol, n_sol = compute_schedule(cfg, v_sol, s_sol, beta, ii_sol)
    parts = {
        "map_eval": lambda: pt.event_driven_map(cfg, params, beta, sol,
                                                evolve_backend="replay"),
        "discovery": lambda: compute_schedule(cfg, v_sol, s_sol, beta,
                                              ii_sol),
        "replay_64_rows": lambda: replay_cuda.replay_events_cuda(
            cfg, sched_sol, n_sol, v_sol, s_sol, beta, ii_sol),
        "replay_256_rows": lambda: replay_cuda.replay_events_cuda(
            cfg, sched, n_ev, v0, s0, beta, ii[0]),
    }
    eval_ms = {k: statistics.median(cuda_ms(fn, torch)[0] for _ in range(5))
               for k, fn in parts.items()}
    k2_ms = statistics.median(cuda_ms(lambda: replay_cuda.replay_events_cuda(
        *args64), torch)[0] for _ in range(5))

    # device time of K2 per launch and the card's idle share of a warm
    # solve, against the same solve's unprofiled wall
    prof = {}
    try:
        _, kern, _ = device_profile(lambda: [replay_cuda.replay_events_cuda(
            *args64) for _ in range(3)], torch)
        n, us = next(v for k, v in kern.items() if "replay_kernel" in k)
        prof["k2_device_us_per_launch_64_rows"] = us / n
        t0 = time.perf_counter()
        pt.newton_solve_staged(cfg, params, z0 + 1e-3, beta=beta,
                               tolerance=STAGED_TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, kern, busy = device_profile(lambda: pt.newton_solve_staged(
            cfg, params, z0 + 1e-3, beta=beta, tolerance=STAGED_TOL), torch)
        prof["warm_unprofiled_wall_s"] = wall
        prof["warm_device_busy_s"] = busy / 1e3
        prof["warm_idle_share"] = 1.0 - busy / 1e3 / wall
        prof["warm_kernels"] = {
            k: {"launches": v[0], "device_us": v[1]} for k, v in
            sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]}
        _, kern, busy = device_profile(lambda: pt.newton_solve_staged(
            cfg_full, params, z0 + 1e-3, beta=beta, tolerance=STAGED_TOL),
            torch)
        prof["warm_full_lane_device_busy_s"] = busy / 1e3
        prof["warm_full_lane_kernels"] = {
            k: {"launches": v[0], "device_us": v[1]} for k, v in
            sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]}
    except Exception as exc:           # measurement only; checks are above
        prof["error"] = repr(exc)

    events64 = int(torch.clamp(n_ev, max=E).sum())
    b_ms, b_by = bound(nbytes(*args64[1:]) + nbytes(*rep64),
                       K2_OPS_PER_LANE_EVENT * events64 * N, "float64")
    row = {"phase": "staged", "config": CONFIG4, "sigma": SIGMA,
           "beta": BETA, "tolerance": STAGED_TOL, "bars": bars,
           "log": {"identical_share": log_share, "same_log_on_same_rows":
                   log_same, "residual_diff": log_res,
                   "windowed_vs_full_lane_identical_rows": full_share,
                   "fallbacks": int(log_fallbacks.sum()),
                   "events": int(rk.n_events.sum()),
                   "kernel_ms": log_ms, "full_lane_kernel_ms": full_log_ms,
                   "plain_ms": plain_log_ms,
                   "events_per_row": [int(rk.n_events.min()),
                                      int(rk.n_events.max())]},
           "k2_vs_plain": k2, "replay_vs_direct_f64": vs_direct,
           "solves": solves, "accurate_eval_ms_median_of_5": eval_ms,
           "k2_ms_median_of_5_64_rows": k2_ms, "profile": prof,
           "k2_bound_ms_64_rows": b_ms, "card": smi}
    emit(row)
    for name, s in solves.items():
        require(s["converged"] and s["recomputed_norm"] <= STAGED_TOL,
                f"staged {name}: not converged to {STAGED_TOL} "
                f"(recomputed |F| {s['recomputed_norm']})")
        require(s["in_domain"], f"staged {name}: solution out of domain")
        require(s["distance_to_guess"] <= 1.0,
                f"staged {name}: solution outside basin_radius")
        require(min(s["launches"].values()) > 0,
                f"staged {name}: a kernel was not launched: "
                f"{s['launches']}")
    replay_entry = {
        "name": "replay_kernel", "route": "cuda", "source": REPLAY_SRC,
        "replaces": "armadillocudalinearinterpolation_tpu/model/"
                    "replay.py:244",
        "launches": solves["cold"]["launches"]["replay_kernel"],
        "max_abs_err": max(v["max_time_diff"] for v in k2.values()),
        "ms": k2_ms, "plain_ms": plain64_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "device_us": k2["64_rows"]["device_us"],
        "k2_device_us": {k: v["device_us"] for k, v in k2.items()},
        "us_per_event": {k: v["us_per_event"] for k, v in k2.items()},
        "threads": {k: v["threads"] for k, v in k2.items()},
        "registers": replay_registers()}
    log_info = {"launches": solves["cold"]["launches"]["evolve_kernel"],
                "lift_launches": solves["cold"]["launches"]["lift_kernel"],
                "identical_share": log_share,
                "windowed_vs_full_lane_identical_rows": full_share,
                "ms_config4_f32": log_ms,
                "full_lane_ms_config4_f32": full_log_ms,
                "plain_ms_config4_f32": plain_log_ms}
    return replay_entry, log_info


def sweep_solver(pt, dev, cfg, ncfg, counters):
    """``solve(beta, z0)``: one config-5 step through the public API, the
    map closed over the seed-0 draw at that beta (one noise draw for the
    whole sweep, as ``bench.py`` keys every step with ``PRNGKey(0)``);
    ``counters["evaluations"]`` counts the map evaluations."""
    def solve(beta_val, z0):
        params = pt.MapParams.create(beta_val, SIGMA, dtype=cfg.dtype,
                                     device=dev)
        F = pt.make_residual_fn(cfg, params, 0, device=dev)

        def counted(Z):
            counters["evaluations"] += 1
            return F(Z)
        return pt.newton_solve(counted, z0, ncfg)
    return solve


def count_fallbacks(torch, emap):
    """Replace the map's K1 wrapper with one that passes each launch a
    fallbacks tensor (every row's count of windowed events that fell back
    to every lane) and keeps it with the rows' event counts.  Returns
    ``(log, restore)``; ``log`` holds one ``(fallbacks, n_events)`` pair of
    ``(P * R,)`` int32 device tensors per launch."""
    real = emap.evolve_ensemble_cuda
    log = []

    def counted(cfg, v0, s0, beta, init_ind, record_schedule=0,
                n_real=None):
        R = beta.shape[0] if n_real is None else n_real
        fb = torch.zeros(v0.shape[0] * R, dtype=torch.int32,
                         device=v0.device)
        out = real(cfg, v0, s0, beta, init_ind, record_schedule,
                   fallbacks=fb, n_real=n_real)
        log.append((fb, (out[0] if record_schedule else out).n_events))
        return out

    emap.evolve_ensemble_cuda = counted

    def restore():
        emap.evolve_ensemble_cuda = real
    return log, restore


def fallback_stats(torch, log) -> dict:
    """K1's rows, events and window fallbacks over the launches of
    ``log``: totals, the share of row events that fell back, the most in
    one launch and in one row."""
    fb = torch.stack([f.sum() for f, _ in log]).cpu()
    events = int(torch.stack([e.sum() for _, e in log]).sum())
    return {"k1_rows": sum(f.numel() for f, _ in log),
            "k1_events": events, "k1_fallbacks_total": int(fb.sum()),
            "k1_fallback_share": int(fb.sum()) / max(events, 1),
            "k1_fallbacks_most_in_one_launch": int(fb.max()),
            "k1_launches_with_fallbacks": int((fb > 0).sum()),
            "k1_fallbacks_most_in_one_row": max(int(f.max())
                                                for f, _ in log)}


def run_sweep(pt, torch, dev, solve, predict: bool):
    """``bench.py::bench_sweep_100pt`` on the port: 100 steps of beta +=
    0.1 from 13.0589, the secant predictor from two consecutive converged
    solutions (``predict``), one host readback a step (the solution; the
    solver's converged flag is already on the host), the Jacobians kept
    on the card and the spectra in one trailing host batch.  As in
    ``bench.py`` (and unlike the CLI, which follows ``Driver.cu``), a
    failed step keeps the last converged iterate as the next warm start."""
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    z_prev, z_is_conv = None, False
    beta_val, n_conv, first_fail_beta, iterations = BETA, 0, None, 0
    jacs, conv_flags, solutions = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SWEEP_STEPS):
        guess = z + (z - z_prev) if (predict and z_prev is not None) else z
        res = solve(beta_val, guess)
        sol = res.solution.cpu()                # the one readback a step
        ok = bool(res.converged) and bool(torch.isfinite(sol).all())
        jacs.append(res.jacobian)
        conv_flags.append(ok)
        iterations += res.iterations
        if ok:
            z_prev = z if z_is_conv else None
            z, z_is_conv = res.solution, True
            n_conv += 1
            solutions.append((round(beta_val, 4), sol.tolist()))
        else:
            # the branch end: the first failure AFTER a converged step
            if first_fail_beta is None and n_conv > 0:
                first_fail_beta = round(beta_val, 4)
            z_prev, z_is_conv = None, False
        beta_val += SWEEP_BETA_STEP
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0

    t0 = time.perf_counter()
    unstable = []
    for j in torch.stack(jacs).cpu():
        if not bool(torch.isfinite(j).all()):
            unstable.append(-1)       # non-finite Jacobian past the branch end
            continue
        ev = pt.compute_eigenvalues(None, None, pt.ProblemType.EQUATION_FREE,
                                    jacobian=j)
        unstable.append(pt.count_unstable(ev, pt.ProblemType.EQUATION_FREE))
    t_spectra = time.perf_counter() - t0
    return {"predict": predict,
            "s_per_step": (t_solve + t_spectra) / SWEEP_STEPS,
            "solve_s_per_step": t_solve / SWEEP_STEPS,
            "spectra_s": t_spectra, "n_conv": n_conv,
            "first_fail_beta": first_fail_beta,
            "unstable_steps": sum(1 for u in unstable if u > 0),
            "unstable": unstable, "conv_flags": conv_flags,
            "newton_iterations": iterations, "solutions": solutions}


def family(z) -> str:
    """The wave family of a solution ``(c, z_1, z_2)``: ``"slow"`` (z_2 ~
    1.37) or ``"fast"`` (z_2 ~ 11; tests/test_cli_and_utils.py:221-239)."""
    return "slow" if z[2] < SWEEP_FAST_FAMILY_Z2 else "fast"


def warm_step_breakdown(pt, torch, emap, solve, beta_val, z0):
    """One warm config-5 step: its unprofiled wall (median of 3), the
    lift's share (each lift call timed with a synchronise before and
    after) and K1's window fallbacks in a separate run, K1's device time
    and the card's busy time by ``torch.profiler``, and the idle share
    against the unprofiled wall."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(beta_val, z0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3

    real_lift, lifts = emap.lift, []

    def timed_lift(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_lift(*a, **kw)
        torch.cuda.synchronize()
        lifts.append(time.perf_counter() - t0)
        return out
    emap.lift = timed_lift
    log, restore = count_fallbacks(torch, emap)
    try:
        res = solve(beta_val, z0)
    finally:
        emap.lift = real_lift
        restore()
    _, kern, busy_ms = device_profile(lambda: solve(beta_val, z0), torch)
    k1 = [v for k, v in kern.items() if "evolve_kernel" in k]
    k1_ms = sum(us for _, us in k1) / 1e3
    lift_ms = sum(lifts) * 1e3
    stats = fallback_stats(torch, log)
    return {"beta": round(beta_val, 4), "iterations": res.iterations,
            "converged": bool(res.converged),
            "family": family(res.solution.tolist()),
            "wall_ms_median_of_3": wall_ms,
            "lift_calls": len(lifts), "lift_ms": lift_ms,
            "k1_launches": sum(n for n, _ in k1), "k1_device_ms": k1_ms,
            "other_ms": wall_ms - lift_ms - k1_ms,
            "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "k1_fallback_share": stats["k1_fallback_share"],
            "top_kernels": {k: {"launches": v[0], "device_us": v[1]}
                            for k, v in sorted(kern.items(),
                                               key=lambda kv: -kv[1][1])[:4]}}


def sweep(pt, torch, dev, smi):
    """BASELINE config 5 (``bench.py::bench_sweep_100pt``): N=512, R=1024,
    f32, sigma 0.1, ``evolve_window=128``, Newton to 1e-4 in at most 10
    iterations with forward FD at eps 1e-2 from the ``Driver.cu`` guess, 100
    steps of beta += 0.1, with the predictor (``sweep_100pt``) and without
    (``sweep_plain``), one warm solve outside the timed window.  K1 is held
    to the plain windowed evolve at the sweep's shapes first; the launch
    count is set to 0 just before the two sweeps and read just after; every
    K1 launch of the sweeps reports its window fallbacks.  The family
    guard: every converged solution of both sweeps lies on one wave family
    (z_2 < 2, or the coexisting family's z_2 ~ 11), so neither warm start
    hops from one family to the other.  Then one warm step is split into
    K1, the lift and the rest on each family: the sweep's (from its first
    converged solution) and the slow family's, reached by the slice's FD
    step of 3e-4."""
    from armadillocudalinearinterpolation_torch.model import (
        emap, evolve_cuda, lift_cuda)
    cfg = pt.ModelConfig(**CONFIG5)
    ncfg = pt.NewtonConfig(**SWEEP_NEWTON)
    stack = fd_stack(torch, dev, torch.float32, ncfg.fd_epsilon)
    checks = [kernel_vs_plain(pt, torch, dev, "float32", cfg.n_real, Z,
                              cfg.evolve_window)
              for Z in (stack[:1], stack[1:])]
    counters = {"evaluations": 0}
    solve = sweep_solver(pt, dev, cfg, ncfg, counters)
    guess = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    solve(BETA, guess)                          # warm, outside the timing
    runs = []
    log, restore = count_fallbacks(torch, emap)
    try:
        torch.cuda.synchronize()
        evolve_cuda.LAUNCHES = lift_cuda.LAUNCHES = 0
        for predict in (True, False):
            counters["evaluations"], start, k1_before = 0, len(log), \
                evolve_cuda.LAUNCHES
            run = run_sweep(pt, torch, dev, solve, predict)
            run.update({"map_evaluations": counters["evaluations"],
                        "k1_launches": evolve_cuda.LAUNCHES - k1_before,
                        **fallback_stats(torch, log[start:])})
            fams = [family(z) for _, z in run["solutions"]]
            run["families"] = {f: fams.count(f) for f in set(fams)}
            runs.append(run)
        launches, lifts = evolve_cuda.LAUNCHES, lift_cuda.LAUNCHES
    finally:
        restore()
    breakdown = {}
    first = next((s for r in runs for s in r["solutions"]), None)
    if first is not None:
        breakdown["sweep_family"] = warm_step_breakdown(
            pt, torch, emap, solve, first[0] + SWEEP_BETA_STEP,
            torch.tensor(first[1], dtype=torch.float32, device=dev))
    slow_solve = sweep_solver(pt, dev, cfg, pt.NewtonConfig(
        **dict(SWEEP_NEWTON, fd_epsilon=SLICE_FD_EPSILON)), counters)
    slow = slow_solve(BETA, guess)
    breakdown["slow_family_fd_3e-4"] = warm_step_breakdown(
        pt, torch, emap, slow_solve, BETA + SWEEP_BETA_STEP, slow.solution)
    row = {"phase": "sweep", "config": CONFIG5, "sigma": SIGMA,
           "newton": SWEEP_NEWTON, "steps": SWEEP_STEPS, "launches": launches,
           "lift_launches": lifts,
           "k1_vs_plain": [{k: c[k] for k in (
               "P", "identical_share", "max_residual_diff",
               "kernel_ms_single_call", "plain_ms_single_call")}
               for c in checks],
           "runs": {("sweep_100pt" if r["predict"] else "sweep_plain"):
                    {k: v for k, v in r.items() if k != "solutions"}
                    for r in runs},
           "first_converged": {("sweep_100pt" if r["predict"] else
                                "sweep_plain"): r["solutions"][:1]
                               for r in runs},
           "warm_step": breakdown, "card": smi}
    emit(row)
    fams = {f for r in runs for f in r["families"]}
    require(len(fams) <= 1, f"sweep: converged solutions on both wave "
            f"families: {[r['families'] for r in runs]}")
    for r in runs:
        name = "sweep_100pt" if r["predict"] else "sweep_plain"
        require(r["k1_launches"] > 0, f"sweep {name}: K1 was not launched")
    require(launches == len(log), f"sweep: {launches} K1 launches, "
            f"{len(log)} with their fallbacks counted")
    require(lifts > 0, "sweep: K9 was not launched")
    require(bool(slow.converged) and family(slow.solution.tolist()) == "slow",
            "sweep: the slow-family solve at FD step 3e-4 did not converge "
            "there")
    return row


def config5_cli_argv():
    """The CLI's flags for config 5 with ``--stability``, before the FD
    step and the step count."""
    return ["--neurons", str(CONFIG5["n_neurons"]),
            "--realisations", str(CONFIG5["n_real"]),
            "--dtype", CONFIG5["dtype"], "--sigma", str(SIGMA),
            "--evolve-window", str(CONFIG5["evolve_window"]),
            "--tol", str(SWEEP_NEWTON["tolerance"]),
            "--max-iter", str(SWEEP_NEWTON["max_iterations"]),
            "--stability", "--quiet"]


CLI_EPS = ["--fd-eps", str(SLICE_FD_EPSILON)]


def run_cli(driver, argv):
    """``driver.main(argv)`` with its standard output captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(argv)
    return rc, buf.getvalue()


def cli(pt, torch, dev, smi):
    """The port's CLI (``cli.driver.main``) on the card, with the launch
    counts set to 0 just before and read just after: (i) config 5's flags
    with ``--stability`` for 3 steps into a checkpoint, then ``--resume``
    for 1, against an uninterrupted 4-step run (step 3 equal to 1e-6), at
    the slice's FD step of 3e-4; (ii) ``--staged --dtype float64`` at
    config 4 for 2 steps with ``--stability``, both converged, K2
    launched.  Config 5's own FD step of 1e-2 runs one step beside them:
    the CLI warm-starts from what a failed solve returned (``Driver.cu``),
    and from the ``Driver.cu`` guess that solve ends non-finite on this
    card, so the CLI stops with rc 1 there; its rc and lines are recorded,
    and an rc 1 must come with the non-finite stop."""
    from armadillocudalinearinterpolation_torch.cli import driver
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, lift_cuda, replay_cuda)
    from armadillocudalinearinterpolation_torch.utils.checkpoint import (
        ContinuationCheckpoint)
    c5 = config5_cli_argv()
    c4 = ["--staged", "--dtype", "float64",
          "--neurons", str(CONFIG4["n_neurons"]),
          "--realisations", str(CONFIG4["n_real"]), "--sigma", str(SIGMA),
          "--evolve-window", str(CONFIG4["evolve_window"]),
          "--max-events", str(CONFIG4["max_events"]),
          "--root-tol", str(CONFIG4["root_tol"]), "--tol", str(STAGED_TOL),
          "--steps", "2", "--stability", "--quiet"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: str(Path(tmp) / k) for k in ("resumed", "full", "staged")}
        eps = CLI_EPS
        plan = {"first_3": c5 + eps + ["--steps", "3", "--checkpoint",
                                       dirs["resumed"]],
                "resume_1": c5 + eps + ["--steps", "1", "--checkpoint",
                                        dirs["resumed"], "--resume"],
                "uninterrupted_4": c5 + eps + ["--steps", "4", "--checkpoint",
                                               dirs["full"]],
                "staged_config4": c4 + ["--checkpoint", dirs["staged"]],
                "config5_fd_1e-2": c5 + ["--fd-eps", str(
                    SWEEP_NEWTON["fd_epsilon"]), "--steps", "1"]}
        torch.cuda.synchronize()
        evolve_cuda.LAUNCHES = replay_cuda.LAUNCHES = 0
        lift_cuda.LAUNCHES = lift_cuda.TANGENT_LAUNCHES = 0
        for name, argv in plan.items():
            k1, k2 = evolve_cuda.LAUNCHES, replay_cuda.LAUNCHES
            t0 = time.perf_counter()
            rc, out = run_cli(driver, argv)
            torch.cuda.synchronize()
            runs[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                          "k1_launches": evolve_cuda.LAUNCHES - k1,
                          "k2_launches": replay_cuda.LAUNCHES - k2,
                          "lines": [ln for ln in out.splitlines()
                                    if ln.startswith(("step", "resuming",
                                                      "ComputeF", "  eig"))]}
        launches = {"evolve_kernel_windowed": evolve_cuda.LAUNCHES,
                    "replay_kernel": replay_cuda.LAUNCHES,
                    "lift_kernel": lift_cuda.LAUNCHES,
                    "lift_tangent_kernel": lift_cuda.TANGENT_LAUNCHES}
        steps = {k: ContinuationCheckpoint(d).load_all()
                 for k, d in dirs.items()}
    resumed, full, staged_steps = (steps["resumed"], steps["full"],
                                   steps["staged"])
    diff = (float(abs(resumed[3].solution - full[3].solution).max())
            if len(resumed) == len(full) == 4 else math.inf)
    row = {"phase": "cli", "runs": runs, "launches": launches,
           "resumed_vs_uninterrupted_step3_max_diff": diff,
           "indices": {k: [s.index for s in v] for k, v in steps.items()},
           "config5_fd_3e-4_converged": [s.converged for s in full],
           "config5_fd_3e-4_first_3": [
               {"converged": s.converged, "solution": s.solution.tolist()}
               for s in resumed[:SHARD_CLI_STEPS]],
           "config5_fd_3e-4_n_unstable": [s.n_unstable for s in full],
           "staged": [{"beta": s.beta, "converged": s.converged,
                       "residual_norm": s.residual_norm,
                       "n_unstable": s.n_unstable,
                       "solution": s.solution.tolist()}
                      for s in staged_steps], "card": smi}
    emit(row)
    for name, r in runs.items():
        if name == "config5_fd_1e-2":
            require(r["rc"] == 0 or (r["rc"] == 1 and any(
                "solution is non-finite" in ln for ln in r["lines"])),
                f"cli {name}: rc {r['rc']} without the non-finite stop")
        else:
            require(r["rc"] == 0, f"cli {name}: rc {r['rc']}")
    require(any(ln.startswith("resuming at step 3 (beta=13.3589)")
                for ln in runs["resume_1"]["lines"]),
            "cli: no resume line for step 3")
    require(row["indices"]["resumed"] == [0, 1, 2, 3],
            f"cli: resumed indices {row['indices']['resumed']}")
    require(diff <= CLI_RESUME_BAR, f"cli: resumed step 3 differs from the "
            f"uninterrupted run's by {diff}")
    require(len(staged_steps) == 2
            and all(s.converged for s in staged_steps),
            "cli: the staged config-4 steps did not both converge")
    require(runs["staged_config4"]["k2_launches"] > 0,
            "cli: the staged run launched no K2")
    require(min(r["k1_launches"] for r in runs.values()) > 0,
            "cli: a run launched no K1")
    return row


def resources_tool():
    spec = importlib.util.spec_from_file_location(
        "kernel_resources", ROOT / "tools" / "kernel_resources.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@functools.lru_cache(maxsize=1)
def replay_resources() -> dict:
    """``tools/kernel_resources.py``'s report of ``csrc/replay.cu``: one
    ``nvcc -Xptxas -v`` of it for the run."""
    return resources_tool().source_resources(ROOT / REPLAY_SRC)


def replay_registers(kernel: str = "replay_kernel") -> dict:
    """Registers and spill bytes of each variant of K2 (``kernel=
    "replay_kernel"``) or K2T (``"replay_tangent_kernel"``), as
    ``tools/kernel_resources.py`` reads them from ``nvcc -Xptxas -v`` with
    the package's flags."""
    out = {}
    key = kernel + "<"
    for name, res in replay_resources().items():
        if key in name:
            start = name.index(key)
            out[name[start:name.index(">", start) + 1]] = res
    return out


def lift_registers() -> dict:
    """Registers and spill bytes of K9's six variants (16, 32 or 64 sites
    a CTA; float or double) and K9T's three, keyed by their template
    (``lift_kernel<...>``, ``lift_tangent_kernel<...>``), as
    ``tools/kernel_resources.py`` reads them from one ``nvcc -Xptxas -v``
    of ``csrc/lift.cu``."""
    out = {}
    for name, res in resources_tool().source_resources(
            ROOT / LIFT_SRC).items():
        for key in ("lift_kernel<", "lift_tangent_kernel<"):
            if key in name:
                start = name.index(key)
                out[name[start:name.index(">", start) + 1]] = res
    return out


def launch_counts():
    """The kernels' launch counters of the map path: K1, K2, K2T, K9 and
    K9T."""
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, lift_cuda, replay_cuda)
    return {"evolve_kernel": evolve_cuda.LAUNCHES,
            "replay_kernel": replay_cuda.LAUNCHES,
            "replay_tangent_kernel": replay_cuda.TANGENT_LAUNCHES,
            "lift_kernel": lift_cuda.LAUNCHES,
            "lift_tangent_kernel": lift_cuda.TANGENT_LAUNCHES}


def zero_launch_counts():
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, lift_cuda, replay_cuda)
    evolve_cuda.LAUNCHES = replay_cuda.LAUNCHES = 0
    replay_cuda.TANGENT_LAUNCHES = 0
    lift_cuda.LAUNCHES = lift_cuda.TANGENT_LAUNCHES = 0


def rel_diff(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def k2t_cases(pt, torch, dev, cfg, params, beta, z) -> dict:
    """K2T's arguments at ``z`` for D=4 (the Z directions and the beta
    column) and D=3 (the Z directions), keyed ``(mode, D)``: root-find
    mode on the f32 discovery's order (the replay backend), and logged
    mode on the fp64 direct evolve's order and time log (the direct
    backend), each ``(args, kwargs, primal)`` with ``primal`` what its
    primal must equal: None for K2's (root-find) or the direct evolve's
    result (logged)."""
    from armadillocudalinearinterpolation_torch.model import (
        emap, evolve_cuda, lift_cuda)
    from armadillocudalinearinterpolation_torch.model.replay import (
        compute_schedule)
    f64 = torch.float64
    R, N = cfg.n_real, cfg.n_neurons
    ii = pt.initial_spike_indices(cfg, z[None]).contiguous()
    base = torch.ones(R, N, dtype=f64, device=dev)
    cases = {}
    for D in (4, 3):
        eye = torch.eye(D, dtype=f64, device=dev)
        dp = (eye[:, 3:].reshape(D, 1) if D == 4
              else torch.zeros(D, 1, dtype=f64, device=dev)).contiguous()
        _, _, v0, s0, dv0, ds0 = emap.lift_tangents(
            cfg, params, z[None], eye[:, None, :3], dp[:, :, None])
        if D == 4:
            sched, n_ev = compute_schedule(cfg, v0, s0, beta, ii)
            res_d, sched_d, times_d = emap.direct_schedule(
                cfg, evolve_cuda.evolve_ensemble_cuda, v0, s0, beta, ii)
        tail = (dv0, ds0, base if D == 4 else None, dp)
        cases[("root_find", D)] = ((cfg, sched, n_ev, v0, s0, beta, ii,
                                    *tail), {}, None)
        cases[("logged", D)] = ((cfg, sched_d, res_d.n_events, v0, s0, beta,
                                 ii, *tail), {"times": times_d}, res_d)
    return cases


def k2t_against_plain(torch, cases, bars, where: str):
    """K2T on each of :func:`k2t_cases` against the plain tangent replay:
    its primal equal to K2's (root-find mode) or to the direct evolve's
    (logged mode), and to the plain version's, and its tangents within
    ``bars["k2t_vs_plain_relative"]`` of the plain version's.  The plain
    version runs once a mode at D=4 (its first three directions are the
    D=3 launch's, each direction computed on its own).  Returns the
    entries keyed ``"{mode}_D{D}"`` and the plain version's ms a mode."""
    from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                              replay_cuda)
    from armadillocudalinearinterpolation_torch.model.replay import (
        replay_events_tangent)
    out, wants, plain_ms = {}, {}, {}
    for (mode, D), (args, kw, res_d) in cases.items():
        k_ms, got = cuda_ms(
            lambda: replay_cuda.replay_events_tangent_cuda(*args, **kw),
            torch)
        if res_d is None:
            k2 = replay_cuda.replay_events_cuda(*args[:7])
            primal = all(torch.equal(getattr(got[0], f), getattr(k2, f))
                         for f in k2._fields)
        else:
            primal = all(torch.equal(getattr(got[0], f), getattr(res_d, f))
                         for f in ("last_ind", "last_time", "crossed_ind",
                                   "crossed_time", "accept"))
        cfg, v0 = args[0], args[3]
        props = torch.cuda.get_device_properties(v0.device)
        layout = replay_cuda.replay_layout(
            cfg.n_neurons, cfg.n_spikes, v0.shape[0] * cfg.n_real,
            props.multi_processor_count,
            evolve_cuda.shared_optin_bytes(v0.device),
            props.shared_memory_per_multiprocessor, "tangent", D)
        entry = {"kernel_ms_first_call": k_ms, "layout": layout._asdict(),
                 "accepted": int(got[0].accept.sum()),
                 "primal_equals": primal,
                 "primal_against": "K2" if res_d is None else
                 "K1 f64 (its own times)"}
        if mode not in wants:
            plain_ms[mode], wants[mode] = cuda_ms(
                lambda: replay_events_tangent(*args, **kw), torch)
            entry["plain_ms"] = plain_ms[mode]
            entry["primal_equals_plain"] = all(
                torch.equal(getattr(got[0], f), getattr(wants[mode][0], f))
                for f in got[0]._fields)
            require(entry["primal_equals_plain"], f"exact: K2T {where} "
                    f"{mode} D=4 primal differs from the plain tangent "
                    "replay")
        want = wants[mode]
        entry["tangent_rel_diff"] = max(
            rel_diff(got[1], want[1][:D]), rel_diff(got[2], want[2][:D]))
        entry["tangent_max_abs_diff"] = max(
            float((got[1] - want[1][:D]).abs().max()),
            float((got[2] - want[2][:D]).abs().max()))
        out[f"{mode}_D{D}"] = entry
        require(primal, f"exact: K2T {where} {mode} D={D} primal differs "
                f"from {entry['primal_against']}'s")
        require(entry["tangent_rel_diff"] <= bars["k2t_vs_plain_relative"],
                f"exact: K2T {where} {mode} D={D} tangents "
                f"{entry['tangent_rel_diff']}")
    return out, plain_ms


def exact(pt, torch, dev, smi: str):
    """Exact Jacobians at config 4: K2T against its plain version at D=3
    (the Z directions) and D=4 (with the beta column), 64 rows, at the
    guess and an FD point, in root-find mode (its primal against K2) and
    with the direct evolve's time log (its primal times against K1's), and
    so at the walkers' shape (``WALK_CONFIG``, ``WALK_POINTS``); K2T's Jacobian
    against central FD of the frozen-schedule map; K2T's layout, device
    time in both modes, bound, registers; K1's fp64 log with and without
    its time log in turns; then the main path, with the launch counts set to 0
    just before and read just after: ``newton_solve_staged`` on the direct
    evolve (exact stage 2 by default) from the guess and the guess + 1e-3,
    the residual recomputed by a fresh direct map, and on the replay with
    an exact stage 2 beside the frozen-fwd default."""
    from armadillocudalinearinterpolation_torch.model import (
        emap, evolve_cuda, replay_cuda)
    from armadillocudalinearinterpolation_torch.model.replay import (
        compute_schedule, schedule_width)
    from armadillocudalinearinterpolation_torch.solvers import staged as st
    bars = EXACT_BARS
    f64 = torch.float64
    cfg = pt.ModelConfig(**CONFIG4)
    N, R, E = cfg.n_neurons, cfg.n_real, schedule_width(cfg)
    params = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
    noise = pt.sample_noise(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    beta = pt.beta_from_noise(cfg, params, noise).contiguous()
    guess = torch.tensor(INITIAL_GUESS, dtype=f64, device=dev)

    # K2T against the plain tangent replay at config 4, at the guess and an
    # FD point, and at the walkers' shape (N=512, R=4, sigma 0, the
    # default root_tol), at the artifact's root and the fold's point, each
    # launch at its own layout
    k2t, plain_ms = {}, {}
    for name, z in (("guess", guess), ("fd_point", guess + EXACT_FD_EPS
                                       * torch.eye(3, dtype=f64,
                                                   device=dev)[0])):
        got_cases = k2t_cases(pt, torch, dev, cfg, params, beta, z)
        if name == "guess":
            cases = got_cases
        part, ms = k2t_against_plain(torch, got_cases, bars,
                                     f"config 4 {name}")
        k2t.update({f"{name}_{k}": v for k, v in part.items()})
        plain_ms.update({f"{name}_{k}": v for k, v in ms.items()})
    cfg_w = pt.ModelConfig(**WALK_CONFIG)
    for name, (z, b) in WALK_POINTS.items():
        p_w = pt.MapParams.create(b, 0.0, dtype="float64", device=dev)
        beta_w = pt.beta_from_noise(cfg_w, p_w, pt.sample_noise(
            cfg_w, torch.Generator(device=dev).manual_seed(0),
            device=dev)).contiguous()
        got_cases = k2t_cases(pt, torch, dev, cfg_w, p_w, beta_w,
                              torch.tensor(z, dtype=f64, device=dev))
        part, _ = k2t_against_plain(torch, got_cases, bars,
                                    f"walkers {name}")
        k2t.update({f"walkers_{name}_{k}": v for k, v in part.items()})
    args4 = cases[("root_find", 4)][0]
    plain4_ms = plain_ms["guess_root_find"]

    # K2T's Jacobian (the replay map's, beta column included) against
    # central FD of the frozen-schedule map on the same discovered order
    F_rep = pt.make_residual_fn(cfg, params, 0, device=dev, noise=noise,
                                evolve_backend="replay")
    _, J = F_rep.value_and_jacobian(guess, param="beta")
    outcome = pt.compute_discrete_outcome(cfg, params, beta, guess)
    e = EXACT_FD_EPS * torch.eye(3, dtype=f64, device=dev)
    vals = pt.frozen_schedule_map_batched(
        cfg, params, beta, torch.cat([guess + e, guess - e]), *outcome)
    pb = torch.tensor([BETA + EXACT_FD_EPS, BETA - EXACT_FD_EPS], dtype=f64,
                      device=dev)
    vb = pt.frozen_schedule_map_batched(
        cfg, pt.MapParams(beta=pb, sigma=torch.full_like(pb, SIGMA)), None,
        guess[None].repeat(2, 1), *outcome, noise=noise, params_batched=True)
    J_fd = torch.cat([(vals[:3] - vals[3:]).T, (vb[0] - vb[1])[:, None]],
                     dim=1) / (2 * EXACT_FD_EPS)
    j_rel = float((J - J_fd).abs().max() / J.abs().max())
    require(j_rel <= bars["jacobian_vs_frozen_fd_relative"],
            f"exact: K2T's Jacobian vs frozen central FD {j_rel}")

    # K2T's time at D=4 and D=3 in both modes: CUDA events (median of 5)
    # and the profiler's device time; its layout and waves; K2 on the same
    # inputs beside it; µs per event
    props = torch.cuda.get_device_properties(dev)
    events = int(torch.clamp(args4[2], max=E).sum())
    events_per_row = events / R
    times_k2t = {}
    for (mode, D), (args, kw, _) in cases.items():
        run = (lambda a=args, k=kw:
               replay_cuda.replay_events_tangent_cuda(*a, **k))
        ms = statistics.median(cuda_ms(run, torch)[0] for _ in range(5))
        _, per = device_us(run, torch, n=3)
        us = next((v for k, v in per.items()
                   if "replay_tangent_kernel" in k), None)
        layout = replay_cuda.replay_layout(
            N, cfg.n_spikes, R, props.multi_processor_count,
            evolve_cuda.shared_optin_bytes(dev),
            props.shared_memory_per_multiprocessor, "tangent", D)
        clusters = replay_cuda.tangent_clusters(layout, N, cfg.n_spikes, D,
                                                logged=mode == "logged")
        times_k2t[f"{mode}_D{D}"] = {
            "ms": ms, "device_us": us, "layout": layout._asdict(),
            "clusters_at_once": clusters,
            "waves": -(-R // max(1, clusters)),
            "us_per_event": None if us is None else us / events_per_row}
    k2_args = args4[:7]
    k2_ms = statistics.median(cuda_ms(
        lambda: replay_cuda.replay_events_cuda(*k2_args), torch)[0]
        for _ in range(5))
    _, per = device_us(lambda: replay_cuda.replay_events_cuda(*k2_args),
                       torch, n=3)
    k2_us = next((v for k, v in per.items() if "replay_kernel" in k
                  and "tangent" not in k), None)
    # K1 f64 at config 4's direct log (64 rows, W=512) with and without
    # its time log, in turns: what the log costs the kernel
    v4, s4, ii = args4[3], args4[4], args4[6]
    k1_turns = timed_in_turns({
        "with_time_log": lambda: emap.direct_schedule(
            cfg, evolve_cuda.evolve_ensemble_cuda, v4, s4, beta, ii),
        "order_only": lambda: evolve_cuda.evolve_ensemble_cuda(
            cfg, v4, s4, beta, ii, record_schedule=E, n_real=R)}, torch,
        n=5)
    # the operations a lane and event: the primal advance once and the
    # tangents of D directions (the probe of K2T's lane update, D
    # compiled in)
    tool = resources_tool()
    lanes = {D: tool.lane_update("tangent", D) for D in (4, 3)}
    ops = {"primal": tool.lane_update("replay")["fp64_ops"],
           "per_lane_event_D4": lanes[4]["fp64_ops"],
           "per_lane_event_D3": lanes[3]["fp64_ops"], "directions": 4}
    ops["per_lane_event"] = ops["per_lane_event_D4"]
    out4 = replay_cuda.replay_events_tangent_cuda(*args4)
    b_ms, b_by = bound(nbytes(*(x for x in args4[1:] if x is not None))
                       + nbytes(*out4[0], out4[1], out4[2]),
                       ops["per_lane_event"] * events * N, "float64")
    b3_ms, _ = bound(0, ops["per_lane_event_D3"] * events * N, "float64")

    # the main path: staged solves with the launch counts set to 0 just
    # before and read just after each
    stages = []
    wrapped = {}
    for fname in ("newton_solve", "newton_solve_frozen",
                  "frozen_jacobian_polish"):
        def wrap(*a, _f=getattr(st, fname), _n=fname, **kw):
            r = _f(*a, **kw)
            stages.append((_n, r.iterations, r.residual_norm))
            return r
        wrapped[fname] = getattr(st, fname)
        setattr(st, fname, wrap)
    z0 = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    exact2 = pt.NewtonConfig(tolerance=0.9 * STAGED_TOL, max_iterations=8,
                             fd_mode="exact")
    plan = (("direct_guess", z0, "cuda", None),
            ("direct_warm", z0 + 1e-3, "cuda", None),
            ("replay_exact_stage2", z0, "replay", exact2),
            ("replay_frozen_fwd_default", z0, "replay", None))
    solves, path_launches = {}, {}
    try:
        for name, z, backend, ncfg2 in plan:
            stages.clear()
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            res = pt.newton_solve_staged(cfg, params, z, beta=beta,
                                         tolerance=STAGED_TOL,
                                         evolve_backend=backend,
                                         stage2_ncfg=ncfg2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            for k, v in launches.items():
                path_launches[k] = path_launches.get(k, 0) + v
            f = pt.event_driven_map(cfg, params, beta, res.solution,
                                    evolve_backend=backend)
            solves[name] = {
                "wall_s": wall, "converged": res.converged,
                "iterations": res.iterations,
                "residual_norm": res.residual_norm,
                "recomputed_norm": float(torch.linalg.vector_norm(f)),
                "solution": res.solution.double().cpu().tolist(),
                "stages": [list(x) for x in stages], "launches": launches}
    finally:
        for fname, fn in wrapped.items():
            setattr(st, fname, fn)

    # one exact stage-2 Jacobian at the solution, split: the direct
    # evolve's fp64 log (K1), the lift's tangents, K2T, and the rest
    # (restriction tangents, host); and the replay backend's discovery
    sol = torch.tensor(solves["direct_guess"]["solution"], dtype=f64,
                       device=dev)
    F_dir = pt.make_residual_fn(cfg, params, 0, device=dev, noise=noise,
                                evolve_backend="cuda")
    eye = torch.eye(3, dtype=f64, device=dev)
    zero = torch.zeros(3, 1, 1, dtype=f64, device=dev)
    parts = {
        "value_and_jacobian_direct": lambda: F_dir.value_and_jacobian(sol),
        "value_and_jacobian_replay": lambda: F_rep.value_and_jacobian(sol),
        "lift_tangents": lambda: emap.lift_tangents(
            cfg, params, sol[None], eye[:, None], zero)}
    _, _, v_s, s_s, dv_s, ds_s = parts["lift_tangents"]()
    ii_s = pt.initial_spike_indices(cfg, sol[None]).contiguous()
    parts["fp64_log_k1"] = lambda: emap.direct_schedule(
        cfg, evolve_cuda.evolve_ensemble_cuda, v_s, s_s, beta, ii_s)
    res_s, sched_s, times_s = parts["fp64_log_k1"]()
    dp_s = torch.zeros(3, 1, dtype=f64, device=dev)
    parts["k2t_D3"] = lambda: replay_cuda.replay_events_tangent_cuda(
        cfg, sched_s, res_s.n_events, v_s, s_s, beta, ii_s, dv_s, ds_s,
        None, dp_s, times=times_s)
    parts["discovery_f32"] = lambda: compute_schedule(cfg, v_s, s_s, beta,
                                                      ii_s)
    breakdown = {k: statistics.median(cuda_ms(fn, torch)[0]
                                      for _ in range(5))
                 for k, fn in parts.items()}
    breakdown["rest_direct"] = breakdown["value_and_jacobian_direct"] - (
        breakdown["fp64_log_k1"] + breakdown["lift_tangents"]
        + breakdown["k2t_D3"])

    entry = {
        "name": "replay_tangent_kernel", "route": "cuda",
        "source": REPLAY_SRC, "replaces": K2T_SRC_LINE,
        "launches": path_launches["replay_tangent_kernel"],
        "max_abs_err": max(v["tangent_max_abs_diff"] for v in k2t.values()),
        "ms": times_k2t["root_find_D4"]["ms"], "plain_ms": plain4_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_us": times_k2t["root_find_D4"]["device_us"],
        "shape": f"config 4: {R} rows x N={N}, D=4 directions, root-find "
                 "mode (the replay backend)",
        "bound_ms_D3": b3_ms, "by_mode": times_k2t,
        "plain_ms_logged": plain_ms["guess_logged"],
        "k2_ms_same_inputs": k2_ms, "k2_device_us_same_inputs": k2_us,
        "k1_f64_log_ms_in_turns": k1_turns,
        "events_per_row_mean": events_per_row,
        "layout": times_k2t["root_find_D4"]["layout"],
        "waves": times_k2t["root_find_D4"]["waves"],
        "lane_update": lanes, "bound_ops": ops,
        "registers": replay_registers("replay_tangent_kernel")}
    row = {"phase": "exact", "config": CONFIG4, "sigma": SIGMA,
           "beta": BETA, "bars": bars, "k2t_vs_plain": k2t,
           "jacobian_vs_frozen_fd_relative": j_rel,
           "jacobian": J.cpu().tolist(), "solves": solves,
           "exact_jacobian_ms_median_of_5": breakdown,
           "launches": path_launches, "k2t": entry, "card": smi}
    emit(row)
    for name, s_ in solves.items():
        require(s_["converged"] and s_["recomputed_norm"] <= STAGED_TOL,
                f"exact {name}: not converged to {STAGED_TOL} "
                f"(recomputed |F| {s_['recomputed_norm']})")
    for name in ("direct_guess", "direct_warm", "replay_exact_stage2"):
        require(solves[name]["launches"]["replay_tangent_kernel"] > 0,
                f"exact {name}: K2T was not launched")
        require(solves[name]["launches"]["evolve_kernel"] > 0,
                f"exact {name}: K1 was not launched")
    return entry, path_launches, solves["direct_guess"]["solution"]


def map_op_calls(pt, torch, dev) -> dict:
    """K1, K2, K2T, K9 and K9T at a size where the device time is
    negligible (N=256, one row, f64; K1 to a horizon of 0.01, K2 and K2T on
    an empty log, K9T at D=3),
    each as ``(through_op, kernel_alone)``: the public wrapper, which calls
    the op through PyTorch's dispatcher, and the op's CUDA kernel called
    as a Python function (the checks, the allocations and the ``ctypes``
    launch), for :func:`host_us`."""
    from armadillocudalinearinterpolation_torch.model import (
        evolve_cuda, lift_cuda, replay_cuda)
    f64 = torch.float64
    cfg = pt.ModelConfig(n_neurons=256, n_real=1, dtype="float64",
                         t_horizon=0.01)
    params = pt.MapParams.create(BETA, 0.0, dtype="float64", device=dev)
    Z = torch.tensor([INITIAL_GUESS], dtype=f64, device=dev)
    U, rate = pt.z_to_u(Z), params.beta.reshape(1)
    dU = torch.ones(3, 1, 4, dtype=f64, device=dev)
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params, U))
    ii = pt.initial_spike_indices(cfg, Z).contiguous()
    beta = torch.full((1, 256), BETA, dtype=f64, device=dev)
    sched = torch.zeros(1, 128, dtype=torch.int32, device=dev)
    n0 = torch.zeros(1, dtype=torch.int32, device=dev)
    dv = torch.ones(3, 1, 256, dtype=f64, device=dev)
    dp = torch.zeros(3, 1, dtype=f64, device=dev)
    key = evolve_cuda.config_key(cfg)
    ops = {
        "evolve_kernel": (evolve_cuda.evolve_op,
                          (key, v0, s0, beta, ii, 1, 0, False, False)),
        "replay_kernel": (replay_cuda.replay_op,
                          (key, sched, n0, v0, s0, beta, ii, 1)),
        "replay_tangent_kernel": (
            replay_cuda.replay_tangent_op,
            (key, sched, n0, v0, s0, beta, ii, dv, dv, None, dp, None, 1)),
        "lift_kernel": (lift_cuda.lift_op, (key, U, rate)),
        "lift_tangent_kernel": (lift_cuda.lift_tangent_op,
                                (key, U, rate, dU, dp))}
    return {name: (functools.partial(op, *args),
                   functools.partial(op._init_fn, *args))
            for name, (op, args) in ops.items()}


def autodiff(pt, torch, dev, smi: str):
    """The map under PyTorch's forward-mode AD (``model/autodiff.py``: the
    evolve's ``autograd.Function`` s, K1, K2 and K2T as ops) at config 4
    and at the walkers' N=512, R=4 (f64, sigma 0.1, the draw of seed 0, at
    the Driver.cu guess), on the direct (``"auto"``) and the replay
    backend: ``jacfwd_cols(F)(Z)``, ``torch.func.jacfwd(F)(Z)`` and
    ``torch.autograd.forward_ad`` (three columns) against
    ``F.value_and_jacobian(Z)`` within ``AUTODIFF_BAR`` relative; each
    route's wall (CUDA events, medians of 5 in turns) and its K1, K2,
    K2T, K9 and K9T launches (one K2T, one K9 and one K9T a ``jacfwd``
    required, one K9T and no K9 for ``value_and_jacobian``), the launch
    counts of ``jacfwd_cols`` at config 4 set to 0 just before and read
    just after; a map evaluation without a tangent (K1 and K9 once, no K2T
    or K9T); and the host µs a call of K1, K2, K2T, K9 and K9T through
    their ops against the op's kernel called alone (:func:`map_op_calls`,
    1000 calls each, in turns)."""
    import torch.autograd.forward_ad as fwAD
    from armadillocudalinearinterpolation_torch.solvers.newton import (
        jacfwd_cols)
    f64 = torch.float64
    params = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
    Z = torch.tensor(INITIAL_GUESS, dtype=f64, device=dev)
    eye = torch.eye(3, dtype=f64, device=dev)

    def forward_ad(F):
        cols = []
        for e in eye:
            with fwAD.dual_level():
                cols.append(fwAD.unpack_dual(F(fwAD.make_dual(Z, e)))
                            .tangent)
        return torch.stack(cols, dim=1)

    cases, path = {}, {}
    for shape, cfg in (("config4", pt.ModelConfig(**CONFIG4)),
                       ("walkers", pt.ModelConfig(
                           n_neurons=512, n_real=4, dtype="float64"))):
        for backend in ("auto", "replay"):
            F = pt.make_residual_fn(cfg, params, 0, device=dev,
                                    evolve_backend=backend)
            routes = {
                "value_and_jacobian": lambda: F.value_and_jacobian(Z)[1],
                "jacfwd_cols": lambda: jacfwd_cols(F)(Z),
                "func_jacfwd": lambda: torch.func.jacfwd(F)(Z),
                "forward_ad_3_columns": lambda: forward_ad(F)}
            J = {k: fn() for k, fn in routes.items()}
            case = {"rel_diff": {k: float((J[k] - J["value_and_jacobian"])
                                          .abs().max()
                                          / J["value_and_jacobian"].abs()
                                          .max()) for k in J},
                    "ms_median_of_5": timed_in_turns(routes, torch, n=5),
                    "launches": {}}
            for k, fn in routes.items():
                torch.cuda.synchronize()
                zero_launch_counts()
                fn()
                torch.cuda.synchronize()
                case["launches"][k] = launch_counts()
            zero_launch_counts()
            F(Z)
            torch.cuda.synchronize()
            case["launches"]["map_without_tangent"] = launch_counts()
            if shape == "config4":
                path[backend] = case["launches"]["jacfwd_cols"]
            cases[f"{shape}_{backend}"] = case
    host = {}
    for name, (op, alone) in map_op_calls(pt, torch, dev).items():
        turns = {"through_op": [], "kernel_alone": []}
        for _ in range(5):
            turns["through_op"].append(host_us(op, torch))
            turns["kernel_alone"].append(host_us(alone, torch))
        host[name] = {k: statistics.median(v) for k, v in turns.items()}
        host[name]["dispatcher_us"] = (host[name]["through_op"]
                                       - host[name]["kernel_alone"])
    emit({"phase": "autodiff", "config4": CONFIG4, "sigma": SIGMA,
          "beta": BETA, "bar": AUTODIFF_BAR, "cases": cases,
          "host_us_per_call_median_of_5": host, "card": smi})
    for name, case in cases.items():
        for k, d in case["rel_diff"].items():
            require(d <= AUTODIFF_BAR, f"autodiff {name}: {k} is {d} "
                    "from value_and_jacobian")
        for k in ("jacfwd_cols", "func_jacfwd"):
            got = {n: case["launches"][k][n] for n in (
                "replay_tangent_kernel", "lift_kernel", "lift_tangent_kernel")}
            require(set(got.values()) == {1}, f"autodiff {name}: {k} "
                    f"launched K2T, K9 and K9T {got} times")
        vj = case["launches"]["value_and_jacobian"]
        require(vj["lift_tangent_kernel"] == 1 and vj["lift_kernel"] == 0,
                f"autodiff {name}: value_and_jacobian launched {vj}")
        plain = case["launches"]["map_without_tangent"]
        require(plain == {"evolve_kernel": 1, "replay_tangent_kernel": 0,
                          "replay_kernel": int(name.endswith("replay")),
                          "lift_kernel": 1, "lift_tangent_kernel": 0},
                f"autodiff {name}: a map evaluation without a tangent "
                f"launched {plain}")
    return path, host


def walkers(pt, torch, dev, smi: str, z_config4):
    """The walkers through ``cli.driver.main`` on the card, with the launch
    counts set to 0 just before and read just after: the artifact's
    arclength walk (first three solutions, last beta, every |r|), the fold
    from the near-fold point, branch enumeration and the sigma = 0
    boundary under a wall cap; then three arclength steps at config 4
    (N=4096, R=64, sigma 0.1) from the staged solution, with the exact and
    the frozen corrector, s/step each."""
    import numpy as np
    from armadillocudalinearinterpolation_torch.cli import driver
    from armadillocudalinearinterpolation_torch.utils.checkpoint import (
        ContinuationCheckpoint)
    bars = WALK_BARS
    runs = {}
    zero_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        d = {k: str(Path(tmp) / k) for k in ("arc", "fold", "enum", "bnd")}
        plan = {
            "arclength_artifact": WALK_SMALL + WALK_ROOT + [
                "--arclength", "--fd-mode", "exact", "--tol", "1e-9",
                "--max-iter", "12", "--ds", "0.3", "--steps", "70",
                "--stability", "--quiet", "--checkpoint", d["arc"]],
            "track_fold": WALK_SMALL + [
                "--guess", "0.59145", "0.57176", "10.07225", "--beta",
                "20.32", "--track-fold", "--sigma-values", "0",
                "--fd-mode", "central", "--fd-eps", "1e-6", "--tol", "1e-6",
                "--max-iter", "12", "--quiet", "--checkpoint", d["fold"]],
            "enumerate_branches": WALK_SMALL + WALK_ROOT + [
                "--enumerate-branches", "--max-branches", "2", "--steps",
                "3", "--ds", "0.3", "--fd-mode", "exact", "--tol", "1e-9",
                "--max-iter", "12", "--quiet", "--checkpoint", d["enum"]],
            "track_boundary": WALK_SMALL + WALK_ROOT + [
                "--track-boundary", "--sigma-values", "0", "--fd-mode",
                "exact", "--tol", "1e-9", "--max-iter", "12", "--quiet",
                "--checkpoint", d["bnd"]]}
        for name, argv in plan.items():
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, out = run_cli(driver, argv)
            torch.cuda.synchronize()
            runs[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                          "launches": {k: v - before[k] for k, v in
                                       launch_counts().items()},
                          "summary": [ln for ln in out.splitlines()
                                      if not ln.startswith(("ComputeF",))]}
        cli_launches = launch_counts()
        arc = ContinuationCheckpoint(d["arc"]).load_all()
        # a run that traced nothing writes no file: empty arrays, so the
        # row below is printed before the checks fail
        empty = {"beta": np.zeros(0), "beta_star": np.zeros(0),
                 "beta_fail": np.zeros(0)}
        files = {k: Path(d[k]) / f for k, f in (("fold", "fold.npz"),
                                                 ("bnd", "boundary.npz"))}
        fold, bnd = (dict(np.load(f)) if f.exists() else dict(empty)
                     for f in files.values())
        n_branches = len(list(Path(d["enum"]).glob("branch_*.npz")))
    art = [np.load(ROOT / "artifacts" / "arclength_fold"
                   / f"step_{i:05d}.npz")["solution"] for i in range(3)]
    sol_diff = (max(float(np.abs(arc[i].solution - art[i]).max())
                    for i in range(3)) if len(arc) >= 3 else math.inf)
    end_beta = arc[-1].beta if arc else math.nan
    worst_r = max((s.residual_norm for s in arc), default=math.inf)

    # three arclength steps at config 4 from the staged solution
    cfg4 = pt.ModelConfig(**CONFIG4)
    noise = pt.sample_noise(cfg4, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    z4 = torch.tensor(z_config4, dtype=torch.float64, device=dev)
    big = {}
    for corrector, mode in (("exact", "exact"), ("frozen", "frozen")):
        ncfg = pt.NewtonConfig(tolerance=CONFIG4_ARC["tolerance"],
                               max_iterations=12, fd_mode=mode,
                               fd_epsilon=1e-5)
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = pt.continue_branch(cfg4, noise, z4, BETA, sigma=SIGMA,
                                   ds=CONFIG4_ARC["ds"],
                                   n_steps=CONFIG4_ARC["steps"], ncfg=ncfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        big[corrector] = {
            "accepted": len(steps), "wall_s": wall,
            "s_per_step": wall / max(1, len(steps)),
            "iterations": [s.iterations for s in steps],
            "residual_norms": [s.residual_norm for s in steps],
            "betas": [float(s.y[-1]) for s in steps],
            "launches": {k: v - before[k] for k, v in
                         launch_counts().items()}}
    launches = launch_counts()
    row = {"phase": "walkers", "bars": bars, "runs": runs,
           "artifact_first_three_max_diff": sol_diff,
           "artifact_walk_steps": len(arc), "artifact_end_beta": end_beta,
           "artifact_walk_worst_residual": worst_r,
           "fold_beta": fold["beta"].tolist(),
           "boundary": {k: v.tolist() for k, v in bnd.items()
                        if k != "Z"},
           "branches": n_branches, "config4_arclength": big,
           "launches_cli": cli_launches,
           "launches_config4": {k: launches[k] - cli_launches[k]
                                for k in launches}, "card": smi}
    emit(row)
    for name, r in runs.items():
        require(r["rc"] == 0, f"walkers {name}: rc {r['rc']}")
    for name in ("enumerate_branches", "track_boundary"):
        require(runs[name]["wall_s"] <= WALKER_WALL_CAP_S,
                f"walkers {name}: {runs[name]['wall_s']} s over the cap")
    require(sol_diff <= bars["artifact_solution"],
            f"walkers: the first three steps differ from the artifact by "
            f"{sol_diff}")
    require(abs(end_beta - ARTIFACT_END_BETA) <= bars["artifact_end_beta"],
            f"walkers: the walk ended at beta {end_beta}")
    require(worst_r <= bars["walk_residual"],
            f"walkers: an accepted step had |r| {worst_r}")
    require(len(fold["beta"]) == 1 and abs(float(fold["beta"][0])
                                           - FOLD_BETA) <= bars["fold_beta"],
            f"walkers: fold at {fold['beta']}")
    require(len(bnd["beta_star"]) == 1, "walkers: no boundary point")
    b_star, b_fail = float(bnd["beta_star"][0]), float(bnd["beta_fail"][0])
    require(b_star <= BOUNDARY_BETA <= b_fail
            or abs(b_star - BOUNDARY_BETA) < bars["boundary_beta"],
            f"walkers: boundary bracket [{b_star}, {b_fail}]")
    require(n_branches == 2, f"walkers: {n_branches} branches enumerated")
    for corrector, r in big.items():
        require(r["accepted"] == CONFIG4_ARC["steps"]
                and max(r["residual_norms"]) <= CONFIG4_ARC["tolerance"],
                f"walkers: config-4 {corrector} walk {r['accepted']} steps")
    require(cli_launches["replay_tangent_kernel"] > 0
            and cli_launches["evolve_kernel"] > 0,
            f"walkers: the CLI runs launched {cli_launches}")
    require(big["frozen"]["launches"]["replay_kernel"] > 0
            and big["exact"]["launches"]["replay_tangent_kernel"] > 0,
            "walkers: a config-4 corrector launched no K2 / K2T")
    return row


def shard_config3(pt, torch, dev, group, n_evals):
    """Config 3's map on the card, sharded over ``group`` (None: one
    process): ``n_evals`` timed evaluations after a warm-up, with the launch
    counts set to 0 just before and read just after."""
    cfg = pt.ModelConfig(n_neurons=MAP_N, n_real=MAP_R, dtype="float32",
                         evolve_window=MAP_WINDOW)
    params = pt.MapParams.create(BETA, SIGMA, dtype="float32", device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    F = pt.make_residual_fn(cfg, params, 0, device=dev, beta=beta,
                            evolve_backend="cuda", group=group)
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    F(z)
    torch.cuda.synchronize()
    if group is not None:
        group.reduces, group.reduce_seconds = 0, 0.0
    zero_launch_counts()
    walls = []
    for _ in range(n_evals):
        t0 = time.perf_counter()
        f = F(z)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"f": f.cpu().tolist(), "wall_ms": walls,
           "wall_ms_median": statistics.median(walls),
           "launches": launch_counts()}
    if group is not None:
        out.update(block=[group.lo, group.hi], backend=group.backend,
                   allreduces=group.reduces,
                   allreduce_ms_mean=group.reduce_seconds * 1e3
                   / group.reduces)
    return out


def shard_config4(pt, torch, dev, group):
    """Config 4's staged solves to 1e-8 on the card, sharded over
    ``group`` (None: one process), each twice (a rank's first solve pays
    its process's first uses; the second is timed as warm) with the launch
    counts set to 0 just before the warm solve and read just after: the
    replay default (K1, K2) and the replay with an exact stage 2 (K1, K2T,
    K2)."""
    cfg = pt.ModelConfig(**CONFIG4)
    params = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
    beta = pt.sample_beta(cfg, params,
                          torch.Generator(device=dev).manual_seed(0))
    z0 = torch.tensor(INITIAL_GUESS, dtype=torch.float32, device=dev)
    exact2 = pt.NewtonConfig(tolerance=0.9 * STAGED_TOL, max_iterations=8,
                             fd_mode="exact")
    out = {}
    for name, ncfg2 in (("replay_frozen_fwd_default", None),
                        ("replay_exact_stage2", exact2)):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            if group is not None:
                group.reduces, group.reduce_seconds = 0, 0.0
            zero_launch_counts()
            t0 = time.perf_counter()
            res = pt.newton_solve_staged(cfg, params, z0, beta=beta,
                                         tolerance=STAGED_TOL,
                                         stage2_ncfg=ncfg2, group=group)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"wall_s": walls[1], "wall_s_first": walls[0],
                     "launches": launch_counts(),
                     "converged": res.converged,
                     "iterations": res.iterations,
                     "residual_norm": res.residual_norm,
                     "solution": res.solution.double().cpu().tolist()}
        if group is not None:
            out[name].update(allreduces=group.reduces,
                             allreduce_ms_total=group.reduce_seconds * 1e3)
    return out


def shard_rank(with_config4: bool):
    """One rank of the ``shard`` phase (started by ``run_ranks``): config
    3's map over this rank's rows, then config 4's staged solves."""
    import torch
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_torch.parallel import ShardGroup
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"config3": shard_config3(pt, torch, dev, ShardGroup(MAP_R),
                                    SHARD_MAP_EVALS)}
    if with_config4:
        out["config4"] = shard_config4(pt, torch, dev,
                                       ShardGroup(CONFIG4["n_real"]))
    return out


def shard(pt, torch, dev, smi: str, cli_steps):
    """Ensemble sharding on the one card: config 3 over 2 gloo ranks
    sharing it and over a world of 1 on NCCL (the path of one card per
    rank), each against the unsharded evaluation on the same draw (f32
    residual bar), every rank the same ``f``; config 4's staged solves
    over 2 ranks against the same solves unsharded (converged, |F| <= 1e-8
    recomputed by a fresh unsharded replay map, solutions within 1e-8);
    the CLI with ``--shard 2`` at config 5's flags for 3 steps, in its own
    process, against the cli phase's unsharded steps (``cli_steps``).
    Walls, the all-reduce's ms and each rank's K1, K2 and K2T launches (the
    counts set to 0 in each rank just before its path, read just after).
    One card: no gain is expected."""
    from armadillocudalinearinterpolation_torch.parallel import run_ranks
    from armadillocudalinearinterpolation_torch.utils.checkpoint import (
        ContinuationCheckpoint)
    bars = SHARD_BARS
    unsharded = {"config3": shard_config3(pt, torch, dev, None,
                                          SHARD_MAP_EVALS),
                 "config4": shard_config4(pt, torch, dev, None)}
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, SHARD_WORLD, True, device="cuda")
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = run_ranks(shard_rank, 1, False, device="cuda")[0]
    nccl_s = time.perf_counter() - t0

    f3 = torch.tensor(unsharded["config3"]["f"])
    config3 = {}
    for name, outs in (("gloo_2", ranks), ("nccl_1", [nccl])):
        fs = [torch.tensor(o["config3"]["f"]) for o in outs]
        config3[name] = {
            "max_abs_diff": float((fs[0] - f3).abs().max()),
            "every_rank_same_f": all(torch.equal(f, fs[0]) for f in fs),
            "backend": outs[0]["config3"]["backend"],
            "blocks": [o["config3"]["block"] for o in outs],
            "wall_ms_median_rank0": outs[0]["config3"]["wall_ms_median"],
            "allreduce_ms_mean_rank0":
                outs[0]["config3"]["allreduce_ms_mean"],
            "allreduces_rank0": outs[0]["config3"]["allreduces"],
            "launches": [o["config3"]["launches"] for o in outs]}

    cfg4 = pt.ModelConfig(**CONFIG4)
    params4 = pt.MapParams.create(BETA, SIGMA, dtype="float64", device=dev)
    beta4 = pt.sample_beta(cfg4, params4,
                           torch.Generator(device=dev).manual_seed(0))
    config4 = {}
    for name, want in unsharded["config4"].items():
        got = [o["config4"][name] for o in ranks]
        sol = torch.tensor(got[0]["solution"], dtype=torch.float64,
                           device=dev)
        f = pt.event_driven_map(cfg4, params4, beta4, sol,
                                evolve_backend="replay")
        config4[name] = {
            "converged": [g["converged"] for g in got],
            "iterations": got[0]["iterations"],
            "iterations_unsharded": want["iterations"],
            "residual_norm": got[0]["residual_norm"],
            "recomputed_norm": float(torch.linalg.vector_norm(f)),
            "solution_diff_vs_unsharded": float(max(
                abs(a - b) for a, b in zip(got[0]["solution"],
                                           want["solution"]))),
            "every_rank_same_solution": all(
                g["solution"] == got[0]["solution"] for g in got),
            "wall_s_rank0": got[0]["wall_s"],
            "wall_s_unsharded": want["wall_s"],
            "wall_s_first_rank0": got[0]["wall_s_first"],
            "wall_s_first_unsharded": want["wall_s_first"],
            "allreduces_rank0": got[0]["allreduces"],
            "allreduce_ms_total_rank0": got[0]["allreduce_ms_total"],
            "launches": [g["launches"] for g in got],
            "launches_unsharded": want["launches"]}

    with tempfile.TemporaryDirectory() as tmp:
        argv = config5_cli_argv() + CLI_EPS + [
            "--steps", str(SHARD_CLI_STEPS), "--checkpoint", tmp,
            "--shard", str(SHARD_WORLD)]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli.driver",
                               *argv], cwd=ROOT, capture_output=True,
                              text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        steps = ContinuationCheckpoint(tmp).load_all() \
            if proc.returncode == 0 else []
    cli_diff = (max(float(abs(s.solution - torch.tensor(
        ref["solution"]).numpy()).max()) for s, ref in zip(steps, cli_steps))
        if len(steps) == len(cli_steps) == SHARD_CLI_STEPS else math.inf)
    cli_row = {"rc": proc.returncode, "wall_s": cli_s,
               "converged": [s.converged for s in steps],
               "converged_unsharded": [s["converged"] for s in cli_steps],
               "max_solution_diff_vs_cli_phase": cli_diff,
               "backend_line": [ln for ln in proc.stderr.splitlines()
                                if ln.startswith("sharding:")],
               "lines": [ln for ln in proc.stdout.splitlines()
                         if ln.startswith(("step", "ComputeF"))]}

    launches = {}
    for o in ranks:
        for part in (o["config3"]["launches"],
                     *(r["launches"] for r in o["config4"].values())):
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    row = {"phase": "shard", "world": SHARD_WORLD, "bars": bars,
           "config3": config3,
           "config3_unsharded_wall_ms_median":
               unsharded["config3"]["wall_ms_median"],
           "config4": config4, "cli": cli_row,
           "spawn_and_run_s": {"gloo_2": gloo_s, "nccl_1": nccl_s},
           "launches": launches, "card": smi}
    emit(row)
    for name, r in config3.items():
        require(r["max_abs_diff"] <= bars["config3_residual"]
                and r["every_rank_same_f"],
                f"shard config 3 {name}: {r['max_abs_diff']} from the "
                f"unsharded f, same on every rank: {r['every_rank_same_f']}")
    require(config3["gloo_2"]["backend"] == "gloo"
            and config3["nccl_1"]["backend"] == "nccl",
            f"shard backends: {config3['gloo_2']['backend']}, "
            f"{config3['nccl_1']['backend']}")
    for name, r in config4.items():
        require(all(r["converged"]) and r["every_rank_same_solution"]
                and r["recomputed_norm"] <= bars["config4_residual"],
                f"shard config 4 {name}: converged {r['converged']}, "
                f"recomputed |F| {r['recomputed_norm']}")
        require(r["solution_diff_vs_unsharded"] <= bars["config4_solution"],
                f"shard config 4 {name}: {r['solution_diff_vs_unsharded']} "
                "from the unsharded solution")
    require(proc.returncode == 0, f"shard cli: rc {proc.returncode}\n"
            f"{proc.stderr[-3000:]}")
    require(cli_diff <= bars["cli_solution"]
            and cli_row["converged"] == cli_row["converged_unsharded"],
            f"shard cli: {cli_diff} from the cli phase's steps")
    for k in ("evolve_kernel", "replay_kernel", "replay_tangent_kernel"):
        require(launches.get(k, 0) > 0, f"shard: no {k} launched in the "
                "ranks")
    return row


def oracle_phase(pt, torch, dev, smi: str):
    """K1 f64 at sigma 0 against the native fp64 oracle (``oracle.py``, a
    separate C++ map built with g++ from ``native/edmap_oracle.cpp``) at
    ``tests/test_oracle.py``'s configuration, 1e-12 at each point, with
    the launch counts set to 0 just before the K1 evaluations and read just
    after."""
    from armadillocudalinearinterpolation_torch import oracle
    cfg = pt.ModelConfig(**ORACLE_CONFIG)
    params = pt.MapParams.create(BETA, 0.0, dtype="float64", device=dev)
    beta = torch.full((cfg.n_real, cfg.n_neurons), BETA,
                      dtype=torch.float64, device=dev)
    Z = torch.tensor(list(ORACLE_POINTS.values()), dtype=torch.float64,
                     device=dev)
    torch.cuda.synchronize()
    zero_launch_counts()
    f = pt.event_driven_map(cfg, params, beta, Z, evolve_backend="cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    t0 = time.perf_counter()
    want = [oracle.compute_f(cfg, params, z.cpu()) for z in Z]
    oracle_s = time.perf_counter() - t0
    diffs = {name: float((f[i].cpu() - want[i]).abs().max())
             for i, name in enumerate(ORACLE_POINTS)}
    row = {"phase": "oracle", "config": ORACLE_CONFIG, "bar": ORACLE_BAR,
           "max_abs_diff": diffs, "f_k1": f.cpu().tolist(),
           "f_oracle": [w.tolist() for w in want],
           "oracle_build_and_eval_s": oracle_s, "launches": launches,
           "card": smi}
    emit(row)
    require(launches["evolve_kernel"] > 0, "oracle: K1 was not launched")
    for name, d in diffs.items():
        require(d <= ORACLE_BAR, f"oracle: K1 f64 at {name} is {d} from "
                "the oracle")
    return row


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

    k1 = {"route": "cuda", "source": f"{PKG}/csrc/evolve.cu",
          "replaces": "armadillocudalinearinterpolation_tpu/model/"
                      "evolve_pallas.py:101", "library_ms": None}
    full = {"name": "evolve_kernel", **k1}
    windowed = {"name": "evolve_kernel_windowed", **k1}
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # R=64 at eps 1e-2 in both types, every lane and windowed; then the
    # shapes the slice gives the kernel: its guess alone and its 3-point FD
    # stack, at R=1000
    slice_stack = fd_stack(torch, dev, f32, SLICE_FD_EPSILON)
    checks = [
        kernel_vs_plain(pt, torch, dev, dtype, 64,
                        fd_stack(torch, dev, t, 1e-2), window)
        for window in (0, MAP_WINDOW) for dtype, t in (("float32", f32),
                                                       ("float64", f64))
    ] + [
        kernel_vs_plain(pt, torch, dev, "float32", SLICE_R, slice_stack[:1]),
        kernel_vs_plain(pt, torch, dev, "float32", SLICE_R, slice_stack[1:]),
    ]
    for entry, windowed_checks in ((full, False), (windowed, True)):
        entry["max_abs_err"] = max(c["max_residual_diff"] for c in checks
                                   if bool(c["window"]) == windowed_checks)
    sl = run_slice(pt, torch, dev)
    slice_launches = sl["evolve_launches"]
    m = map_eval(pt, torch, dev, smi)
    lift_kernel, lift_tangent_kernel = lift_phase(pt, torch, dev, smi)
    events = m["evolve_events_total"]
    for entry, layer, plain, window, fallbacks in (
            (full, "evolve_full_lane", "full_lane", 0, 0),
            (windowed, "evolve", "windowed", MAP_WINDOW,
             m["evolve_fallbacks_total"])):
        entry["ms"] = m["layers_ms_median_of_5"][layer]
        entry["plain_ms"] = m["plain_evolve_ms_median_of_3"][plain]
        entry["bound_ms"], entry["bound_by"] = bound(
            m["evolve_bytes"], k1_ops(MAP_N, window, events, fallbacks),
            "float32")
        entry["device_us"] = m["evolve_device_us_mean_of_3"][layer]
        entry["evolve_window"] = window

    orc = oracle_phase(pt, torch, dev, smi)
    interp_kernels = interp2d(pt, torch, dev, smi)
    interp1d_kernels = interp1d(pt, torch, dev, smi)
    repairs(pt, torch, dev)
    replay_kernel, log = staged(pt, torch, dev, smi)
    sw = sweep(pt, torch, dev, smi)
    cl = cli(pt, torch, dev, smi)
    tangent_kernel, ex_launches, z_config4 = exact(pt, torch, dev, smi)
    ad_launches, ad_host = autodiff(pt, torch, dev, smi)
    wk = walkers(pt, torch, dev, smi, z_config4)
    sh = shard(pt, torch, dev, smi, cl["config5_fd_3e-4_first_3"])
    # K1 runs on five paths: the Driver.cu slice (every lane), the config-3
    # map evaluation, the staged solve's f32 stage and discovery passes
    # (with its firing-order log), the config-5 sweeps and the CLI, all
    # four windowed; K2 on the staged solve and the CLI's staged run
    # (the walkers' CLI runs are at N=512 on every lane, their config-4
    # steps windowed); the oracle check runs K1 f64 on every lane, the
    # shard phase's ranks K1 windowed (config 3 and 4), K2 and K2T; the
    # autodiff phase's jacfwd_cols at config 4 K1 windowed, K2 and K2T
    full["launches_by_path"] = {
        "slice": slice_launches,
        "walkers": wk["launches_cli"]["evolve_kernel"],
        "oracle": orc["launches"]["evolve_kernel"]}
    full["launches"] = sum(full["launches_by_path"].values())
    windowed["launches_by_path"] = {
        "map_eval": m["launches"], "staged": log["launches"],
        "sweep": sw["launches"],
        "cli": cl["launches"]["evolve_kernel_windowed"],
        "exact": ex_launches["evolve_kernel"],
        "autodiff": sum(c["evolve_kernel"] for c in ad_launches.values()),
        "walkers": wk["launches_config4"]["evolve_kernel"],
        "shard": sh["launches"]["evolve_kernel"]}
    windowed["launches"] = sum(windowed["launches_by_path"].values())
    windowed["log"] = log
    windowed["config5"] = {
        "k1_vs_plain": sw["k1_vs_plain"],
        "fallbacks": {name: {k: r[k] for k in (
            "k1_rows", "k1_events", "k1_fallbacks_total",
            "k1_fallback_share", "k1_fallbacks_most_in_one_launch")}
            for name, r in sw["runs"].items()}}
    windowed["max_abs_err"] = max(
        windowed["max_abs_err"],
        *(c["max_residual_diff"] for c in sw["k1_vs_plain"]))
    replay_kernel["launches_by_path"] = {
        "staged": replay_kernel["launches"],
        "cli": cl["launches"]["replay_kernel"],
        "exact": ex_launches["replay_kernel"],
        "autodiff": ad_launches["replay"]["replay_kernel"],
        "walkers": wk["launches_cli"]["replay_kernel"]
        + wk["launches_config4"]["replay_kernel"],
        "shard": sh["launches"]["replay_kernel"]}
    replay_kernel["launches"] = sum(
        replay_kernel["launches_by_path"].values())
    kernels = [full, windowed]

    tangent_kernel["launches_by_path"] = {
        "exact": ex_launches["replay_tangent_kernel"],
        "autodiff": sum(c["replay_tangent_kernel"]
                        for c in ad_launches.values()),
        "walkers": wk["launches_cli"]["replay_tangent_kernel"]
        + wk["launches_config4"]["replay_tangent_kernel"],
        "shard": sh["launches"]["replay_tangent_kernel"]}
    tangent_kernel["launches"] = sum(
        tangent_kernel["launches_by_path"].values())
    # K9 runs wherever the map is lifted, K9T wherever an exact Jacobian
    # is taken (exact, autodiff, the walkers' exact correctors, the shard
    # phase's exact stage 2); each path's counts set to 0 just before it
    # and read just after
    lift_kernel["launches_by_path"] = {
        "slice": sl["lift_launches"], "map_eval": m["lift_launches"],
        "staged": log["lift_launches"], "sweep": sw["lift_launches"],
        "cli": cl["launches"]["lift_kernel"],
        "exact": ex_launches["lift_kernel"],
        "autodiff": sum(c["lift_kernel"] for c in ad_launches.values()),
        "walkers": wk["launches_cli"]["lift_kernel"]
        + wk["launches_config4"]["lift_kernel"],
        "shard": sh["launches"]["lift_kernel"],
        "oracle": orc["launches"]["lift_kernel"]}
    lift_tangent_kernel["launches_by_path"] = {
        "cli": cl["launches"]["lift_tangent_kernel"],
        "exact": ex_launches["lift_tangent_kernel"],
        "autodiff": sum(c["lift_tangent_kernel"]
                        for c in ad_launches.values()),
        "walkers": wk["launches_cli"]["lift_tangent_kernel"]
        + wk["launches_config4"]["lift_tangent_kernel"],
        "shard": sh["launches"]["lift_tangent_kernel"]}
    for entry, paths in ((lift_kernel, lift_kernel["launches_by_path"]),
                         (lift_tangent_kernel, {
                             k: v for k, v in lift_tangent_kernel[
                                 "launches_by_path"].items() if k != "cli"})):
        entry["launches"] = sum(entry["launches_by_path"].values())
        idle = [k for k, v in paths.items() if not v]
        require(not idle, f"{entry['name']} was not launched on {idle}")
    for entry, op in ((full, "evolve_kernel"), (windowed, "evolve_kernel"),
                      (replay_kernel, "replay_kernel"),
                      (tangent_kernel, "replay_tangent_kernel"),
                      (lift_kernel, "lift_kernel"),
                      (lift_tangent_kernel, "lift_tangent_kernel")):
        entry["op_host_us"] = ad_host[op]
    kernels = [*kernels, *interp_kernels, *interp1d_kernels, replay_kernel,
               tangent_kernel, lift_kernel, lift_tangent_kernel]
    missing = [k["name"] for k in kernels if k["device_us"] is None]
    require(not missing, f"no device time measured for {missing}")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
