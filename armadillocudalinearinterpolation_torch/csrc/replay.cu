// Fixed-schedule replay on Hopper (sm_90a): the accurate evolve in native
// fp64, for float or double states.
//
// Replaces: armadillocudalinearinterpolation_tpu/model/replay.py::
// _replay_events_impl, an XLA while loop in double-float arithmetic (not a
// pallas_call).  The plain PyTorch version of the same function is
// armadillocudalinearinterpolation_torch/model/replay.py::replay_events.
//
// Per event the row knows which lane fires (the f32 discovery pass logged
// it), so the event time is ONE scalar root-find: the f32 event time of
// that lane (events.cuh) as the seed, then two Newton polishes in fp64.  A
// seed that is the no-fire sentinel (>= 100) is a misfire: the row steps
// by f32(0.05) and is rejected.  Then every lane advances by the closed
// form, the firing lane resets and the ring kick w(|i - j|) * beta_i is
// added, and the event is classified as K1 classifies it.
//
// What bounds it: a chain of events, each a root-find (an f32 Newton of up
// to counter_max steps and two fp64 polishes of three exp and two divisions
// each, on one thread) and a sweep over the row's lanes (one fp64 exp, one
// fp64 division and the advance and kick per lane, ~59 fp64 operations),
// against the card's fp64 peak outside the tensor cores.  On an H100 the
// root-find chain of one thread, ~3 us an event, bounds a launch of one
// row an SM (config 4's 64 rows); the sweep bounds two rows an SM.
//
// Layout (model/replay_cuda.py::replay_layout picks the threads): one CTA
// a row (one point x one realisation) keeps v, s and beta in fp64, and the
// kick table, in opt-in dynamic shared memory.  Warp 0 is the event warp
// and the other warps sweep.  In step k the sweep warps apply event k to
// every lane except j_{k+1}, the next scheduled lane, while thread 0
// applies event k to that lane, runs event k+1's root-find on it,
// classifies event k+1, decides whether the row stops and posts (dt_{k+1},
// flags) in the mailbox slot of that event's parity.  One barrier ends the
// step, so an event costs the longer of the root-find and the sweep, not
// their sum.  Both sides update a lane through advance(), so the lane the
// root-find reads is, bit for bit, the lane the sequential order would have
// had.  No sweep follows the last event: the final v and s are not outputs.
//
// Where a row does not fit (N above 8,297), v, s and beta stay in a (rows,
// 3N) scratch in device memory that the wrapper allocates and the kick
// table is read where the wrapper keeps it; the same kernel body runs on
// those pointers.  The row stops at its own min(n_sched, E) events, at a
// scheduled lane outside [0, N), or once all its trajectories have crossed
// T (later events change no output).
//
// Semantics follow model/replay.py operation by operation.  Build without
// --use_fast_math and with --fmad=false (see events.cuh).  K2T, the same
// replay with forward tangents, is this kernel's body (replay_body) with
// the tangent compiled in; see below.

#include <stdint.h>

#include <cooperative_groups.h>

#include "events.cuh"
#include "replay_lane.cuh"

namespace {

namespace cg = cooperative_groups;

// the step a misfiring row takes: the JAX replay's f32 0.05
constexpr double kMisfireDt = (double)0.05f;
// Most threads of a CTA, and the CTAs of that size an SM holds: at most
// 64 registers a thread, so two CTAs of 512 fit one SM's register file
// (1024 threads an SM, the budget model/replay_cuda.py::replay_layout
// counts with).  Bounded by 512 alone, ptxas picks 64 registers here all
// the same, with 12-44 bytes of spills (tools/kernel_resources.py); the
// second bound makes that a guarantee the layout can count on.
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;
// flags an event posts beside its dt
constexpr int kStop = 1;           // the row stops at this event
constexpr int kReject = 2;         // a misfire or a lane out of range

// v e_t + I (1 - e_t) + s (e_b - e_t) / (1 - b) - vth, e_t = exp(-t),
// e_b = exp(-b t): the residual in the form of the advance below
__device__ __forceinline__ double membrane_shared(double t, double v,
                                                  double s, double b,
                                                  double drive, double vth) {
  const double e_t = ::exp(-t);
  const double e_b = ::exp(-b * t);
  return v * e_t + drive * (1.0 - e_t) + s * (e_b - e_t) / (1.0 - b) - vth;
}

// ---------------------------------------------------------------------------
// K2T: the replay with D forward tangents (the exact Jacobian's kernel).
//
// Replaces: jax.jacfwd through _replay_events_impl (model/replay.py:724-747
// of the JAX package).  Plain version: model/replay.py::
// replay_events_tangent.  It is K2's body (replay_body below, with
// kTangent) on the primal (v, s) and every direction's tangent pair (dv,
// ds): the primal is computed once a row for all D directions.  The
// direction's rate tangent is dp[d, p] * base[r] (0 for a Z direction, the
// ones along the beta axis, the frozen noise along sigma): one base row
// and D scalars a point, not D rows.
//
// What bounds it: the sweep, per lane and event the primal's 59 fp64
// operations once, one reciprocal shared by the directions and ~24 more a
// direction (167 at D=4; tools/kernel_resources.py counts them), against
// the card's fp64 peak; on an H100 at config 4 a CTA's sweep of 2048 lanes
// takes ~4.5 us an event, the event chain ~2.8 us without its root-find
// and more with it (PERF.md).  At config 4 (N=4096, D=4) the
// row and its directions take 96 bytes a lane, 384 KB a row: more than one
// CTA's 227 KB.  So a row's lanes are split over a thread-block cluster of
// C CTAs (model/replay_cuda.py::replay_layout picks C: the smallest that
// fits, 2 at config 4, whose 64 rows make 128 CTAs, one wave on 132 SMs;
// where a row fits one CTA, 1, or a pair where each CTA keeps 1024 lanes
// and the pairs make one wave).  CTA c of a cluster holds lanes [c L, c L
// + L), L = ceil(N / C): their v, s, beta, base and each direction's dv, ds,
// and the whole kick table.  The CTA that holds event k+1's lane runs the
// event chain on its warp 0 (apply event k to that lane, the root-find or
// the logged dt, d(dt), classify: lane d takes direction d, so the chain
// does not grow with D) and posts (dt, d(dt)[D], flags) into every CTA's
// mailbox through distributed shared memory; one cluster barrier ends the
// event, and the owner changes from event to event.  Warp 0 of every CTA
// keeps the row's bookkeeping (t, its tangents, the recorded slots) by
// applying each event it did not post from its mailbox, so whichever CTA
// posts next has it; rank 0 writes the outputs.  Each CTA sweeps its own
// lanes: the primal's exp(-b dt) and lane update once (advance()'s lines,
// so the primal equals K2's bit for bit), then the D tangent updates.  The
// firing lane's v resets to 0 (tangent 0); the kick adds db * w(d); t's
// tangent accumulates d(dt), and last_time / crossed_time take it where
// the event is recorded.  A misfire pins dt, so its d(dt) is 0.
//
// d(dt): by the implicit function theorem at the polished root (the
// partials of the root-find's shared-exponential form), or, with the
// evolve's time log (kLogged: the direct evolve's dt of each event, taken
// in place of the root-find), by the evolve's own rule at that dt (the
// partials of model/events.py::membrane_fun; 0 where no lane fired, the
// sentinel dt >= 100): then the times are the evolve's bit for bit and the
// tangents are those of the trajectory that gave F.
//
// A row that does not fit a cluster of 8 keeps its arrays in a (rows, (4 +
// 2 D) N) scratch in device memory and reads the wrapper's kick table; the
// same body runs on those pointers.

// K2T's direction data: all null (D = 0) for K2.
struct Tangents {
  const double* dv0;     // (D, P, N) tangents of the lifts
  const double* ds0;     // (D, P, N)
  const double* base;    // (R, N) the rates' tangent base, or null (0)
  const double* dp;      // (D, P) the parameter's tangent at each point
  const double* times;   // (S, E) the evolve's time log (kLogged)
  double* d_last_out;    // (D, rows, M)
  double* d_crossed_out; // (D, rows, M)
  int D;
};

// The partials of the event residual at its root dt, in the event-time
// tangent -(f_v dv + f_s ds + f_b db) / f_t: of the replay's
// shared-exponential form v e_t + I (1 - e_t) + s (e_b - e_t) / (1 - b) -
// vth (model/events.py::event_time_jvp, form "shared"), or of the evolve's
// form (form "evolve", kEvolveForm).
struct Partials {
  double f_v, f_s, f_b, f_t;
};

template <bool kEvolveForm>
__device__ __forceinline__ Partials event_partials(double dt, double v,
                                                   double s, double b,
                                                   double drive) {
  if constexpr (kEvolveForm) {
    const double u = 1.0 - b;
    const double emt = ::exp(-dt);
    const double ebt = ::exp(u * dt);
    const double g = (ebt - 1.0) / u;
    const double f_t = drive * emt - v * emt + s * emt * ebt
                       + (s * emt * (ebt - 1.0)) / (b - 1.0);
    return {emt, emt * g, s * emt * ((ebt - 1.0) - dt * u * ebt) / (u * u),
            f_t};
  } else {
    const double e_t = ::exp(-dt);
    const double e_b = ::exp(-b * dt);
    const double f_t = (drive - v) * e_t + s * (e_t - b * e_b) / (1.0 - b);
    const double f_s = (e_b - e_t) / (1.0 - b);
    return {e_t, f_s, s * (f_s - dt * e_b) / (1.0 - b), f_t};
  }
}

// Threads of a K2T CTA at most, one CTA an SM: up to 128 registers a thread
// (model/replay_cuda.py::replay_layout counts 512 threads an SM for it).
constexpr int kTangentMinBlocks = 1;
// cluster sizes K2T takes (the portable limit is 8)
constexpr int kMaxCluster = 8;

// The body of K2 and, with kTangent, of K2T (the cluster, the direction
// arrays, the d(dt) mailbox slots and the time tangents compile out of
// K2).  kBetaPerRow: beta is (P*R, N), one row of rates per row, else (R,
// N) shared by the P points (a template parameter: the shared case compiles
// to the kernel without it).  kLogged (K2T): dt from the evolve's time log.
template <typename T, bool kRowInGlobal, bool kBetaPerRow, bool kTangent,
          bool kLogged>
__device__ __forceinline__ void replay_body(
    const T* __restrict__ v0, const T* __restrict__ s0,
    const T* __restrict__ beta, const int* __restrict__ sched,
    const int* __restrict__ n_sched, const int* __restrict__ init_ind,
    const double* __restrict__ wtab, int R, int N, int M, int E, int S,
    int Q, const Consts& c, int* __restrict__ last_ind_out,
    T* __restrict__ last_time_out, int* __restrict__ crossed_ind_out,
    T* __restrict__ crossed_time_out, bool* __restrict__ accept_out,
    double* __restrict__ row_scratch, const Tangents& tg) {
  extern __shared__ __align__(16) unsigned char smem[];
  // K2T: the row is a cluster of C CTAs, rank `rank` holding nl lanes from
  // lo; K2: one CTA a row, every lane
  int C = 1, rank = 0;
  if constexpr (kTangent) {
    C = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int row = kTangent ? (int)blockIdx.x / C : (int)blockIdx.x;
  const int L = kTangent ? (N + C - 1) / C : N;
  const int lo = kTangent ? rank * L : 0;
  const int nl = kTangent ? max(0, min(L, N - lo)) : N;
  const int D = kTangent ? tg.D : 0;
  const int rows = kTangent ? (int)gridDim.x / C : 0;
  // row arrays: v, s, beta and, for K2T, the rates' tangent base and dv, ds
  // of each direction; `stride` values apart (the CTA's L lanes in shared
  // memory, the row's N in device memory)
  const int stride = kTangent && !kRowInGlobal ? L : N;
  double* shared = reinterpret_cast<double*>(smem);
  double* v = kRowInGlobal
                  ? row_scratch + (size_t)row * (kTangent ? 4 + 2 * D : 3) * N
                        + lo
                  : shared;
  double* s = v + stride;
  double* b = s + stride;
  double* bs = b + stride;                 // K2T only, as dv and ds
  double* dv = bs + stride;
  double* ds = dv + (size_t)D * stride;
  // N/2 + 1 kick weights: a copy beside the row, or the wrapper's table
  double* w_copy = kTangent ? ds + (size_t)D * stride : b + N;
  const double* w = kRowInGlobal ? wtab : w_copy;
  double* small = kRowInGlobal ? shared : w_copy + (N / 2 + 1);
  double* last_time = small;
  double* crossed_time = last_time + M;
  double* d_last = crossed_time + M;       // K2T only: [D][M] each
  double* d_crossed = d_last + D * M;
  // [2] by the event's parity: dt and, for K2T, [2][D] d(dt)
  double* mbox_dt = (kTangent ? d_crossed + D * M : crossed_time + M);
  double* mbox_ddt = mbox_dt + 2;
  double* tt = mbox_ddt + 2 * D;           // K2T: t's tangents [D]
  double* dpp = tt + D;                    // K2T: dp at the row's point [D]
  int* last_ind = reinterpret_cast<int*>((kTangent ? dpp + D : mbox_dt + 2));
  int* crossed_ind = last_ind + M;
  int* crossed = crossed_ind + M;
  int* mbox_flags = crossed + M;           // [2]

  const int p = row / R, r = row % R, sr = row % S, q = p % Q;
  const int br = kBetaPerRow ? row : r;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < nl; i += nthr) {
    const int g = lo + i;
    v[i] = (double)v0[(size_t)p * N + g];
    s[i] = (double)s0[(size_t)p * N + g];
    b[i] = (double)beta[(size_t)br * N + g];
    if constexpr (kTangent) {
      const size_t P = rows / R;
      bs[i] = tg.base ? tg.base[(size_t)r * N + g] : 0.0;
      for (int d = 0; d < D; ++d) {
        dv[(size_t)d * stride + i] = tg.dv0[((size_t)d * P + p) * N + g];
        ds[(size_t)d * stride + i] = tg.ds0[((size_t)d * P + p) * N + g];
      }
    }
  }
  if (!kRowInGlobal)
    for (int d = tid; d <= N / 2; d += nthr) w_copy[d] = wtab[d];
  const int ns = n_sched[sr];
  const int n_live = ns < E ? ns : E;
  const double drive = c.drive, vth = c.vth, t_horizon = c.t_horizon;
  const int* row_sched = sched + (size_t)sr * E;
  // the running event time (K2: thread 0's; K2T: each lane of warp 0's)
  // and thread 0's consistency
  double t = 0.0;
  bool consistent = ns <= E;             // an overflowed log rejects
  if (tid == 0) {
    for (int m = 0; m < M; ++m) {
      last_ind[m] = crossed_ind[m] = init_ind[(size_t)q * M + m];
      last_time[m] = 0.0;
      crossed_time[m] = 2.0 * t_horizon;
      crossed[m] = 0;
    }
  }
  if constexpr (kTangent) {
    for (int d = tid; d < D; d += nthr) {
      dpp[d] = tg.dp[(size_t)d * (rows / R) + p];
      tt[d] = 0.0;
      for (int m = 0; m < M; ++m)
        d_last[d * M + m] = d_crossed[d * M + m] = 0.0;
    }
  }

  // the CTA of the row that holds lane j (rank 0 for a lane out of range:
  // it posts the stop)
  auto owner = [&](int j) { return (j < 0 || j >= N) ? 0 : j / L; };
  // the end of a step: the CTA's barrier, or the cluster's (K2T, C > 1)
  auto step_barrier = [&]() {
    if constexpr (kTangent) {
      if (C > 1) {
        cg::this_cluster().sync();
        return;
      }
    }
    __syncthreads();
  };
  // Event j at dt with d(dt) (K2T): t and its tangents move on, the event
  // is classified and recorded.  K2: thread 0; K2T: warp 0, every lane
  // keeping t, lane 0 classifying and lane d taking direction d.  Returns
  // the slot recorded or -1.
  auto record = [&](int j, double dt, const double* ddt) {
    const double t_new = t + dt;
    t = t_new;
    int mm;
    if constexpr (kTangent) {
      const int lane = tid & 31;
      mm = lane == 0 ? classify_event(j, t_new, t_horizon, M, last_ind,
                                      last_time, crossed_ind, crossed_time,
                                      crossed)
                     : -1;
      mm = __shfl_sync(0xffffffffu, mm, 0);
      double* into = t_new > t_horizon ? d_crossed : d_last;
      for (int d = lane; d < D; d += 32) {
        tt[d] = tt[d] + ddt[d];
        if (mm >= 0) into[d * M + mm] = tt[d];
      }
      __syncwarp();
    } else {
      mm = classify_event(j, t_new, t_horizon, M, last_ind, last_time,
                          crossed_ind, crossed_time, crossed);
    }
    return mm;
  };
  // Warp 0 of K2T: post (dt, d(dt) of each direction, flags) in slot
  // `slot` of the mailbox of every CTA of the row, one value a lane (ddt
  // null: the flags alone)
  auto post = [&](int slot, double dt, const double* ddt, int flags) {
    cg::cluster_group cluster = cg::this_cluster();
    const int items = ddt != nullptr ? D + 2 : 1;
    for (int x = tid & 31; x < C * items; x += 32) {
      const int cr = x / items, item = x % items;
      if (item == items - 1)
        cluster.map_shared_rank(mbox_flags, cr)[slot] = flags;
      else if (item == D)
        cluster.map_shared_rank(mbox_dt, cr)[slot] = dt;
      else
        cluster.map_shared_rank(mbox_ddt, cr)[slot * D + item] = ddt[item];
    }
  };

  // The CTA that holds lane j_kn posts event kn (K2: thread 0; K2T: warp
  // 0, lane d taking direction d).  Its lane out of range stops the row;
  // else it applies event kn - 1 (j_prev, dt_prev and, for K2T, the d(dt)
  // in its slot) to the lane, runs the root-find (or reads the logged dt),
  // takes d(dt) of every direction (K2T), classifies the event and posts
  // (dt, d(dt), flags).
  auto post_event = [&](int kn, int j_prev, double dt_prev, double e_t,
                        double de) {
    const int slot = kn & 1;
    const int j = row_sched[kn];
    if (j < 0 || j >= N) {
      if constexpr (kTangent)
        post(slot, 0.0, nullptr, kStop | kReject);
      else
        mbox_flags[slot] = kStop | kReject;
      return;
    }
    const int li = j - lo;
    double vj = v[li], sj = s[li];
    const double bj = b[li];
    if (kn > 0) {
      if constexpr (kTangent) {
        // lane d advances direction d's tangent of the lane; every lane
        // the primal (the same values), which lane 0 writes
        const double wd = kick_weight(w, j, j_prev, N);
        const double* ddt_prev = mbox_ddt + (slot ^ 1) * D;
        const double e_b = ::exp(-bj * dt_prev);
        const double inv = 1.0 / (1.0 - bj);
        const double q = (e_b - e_t) * inv;
        for (int d = tid & 31; d < D; d += 32) {
          const size_t o = (size_t)d * stride + li;
          double dvj = dv[o], dsj = ds[o];
          tangent_step(dvj, dsj, vj, sj, bj, dpp[d] * bs[li], ddt_prev[d],
                       wd, j == j_prev, dt_prev, e_t, e_b, q, inv, drive);
          dv[o] = dvj;
          ds[o] = dsj;
        }
        advance(vj, sj, bj, wd, j == j_prev, dt_prev, e_t, de);
        if ((tid & 31) == 0) {
          v[li] = vj;
          s[li] = sj;
        }
      } else {
        advance(vj, sj, bj, kick_weight(w, j, j_prev, N), j == j_prev,
                dt_prev, e_t, de);
        v[li] = vj;
        s[li] = sj;
      }
    }
    double dt;
    bool misfire = false;
    if constexpr (kLogged) {
      dt = tg.times[(size_t)sr * E + kn];
    } else {
      const float dt32 =
          event_time<float>((float)vj, (float)sj, (float)bj, c);
      misfire = dt32 >= 100.0f;
      dt = misfire ? kMisfireDt : (double)dt32;
      for (int it = 0; it < 2; ++it) {
        const double f = membrane_shared(dt, vj, sj, bj, drive, vth);
        double fp = membrane_df(vj, sj, bj, ::exp(-dt),
                                ::exp((1.0 - bj) * dt), drive);
        fp = ::fabs(fp) > 1e-12 ? fp : 1.0;
        dt = dt - f / fp;
      }
      if (misfire) dt = kMisfireDt;
    }
    double* ddt = nullptr;
    if constexpr (kTangent) {
      // d(dt) of each direction, written in this CTA's own slot first
      ddt = mbox_ddt + slot * D;
      const bool fires = kLogged ? dt < 100.0 : !misfire;
      const Partials f = event_partials<kLogged>(dt, vj, sj, bj, drive);
      for (int d = tid & 31; d < D; d += 32) {
        const size_t o = (size_t)d * stride + li;
        ddt[d] = fires ? -(f.f_v * dv[o] + f.f_s * ds[o]
                           + f.f_b * (dpp[d] * bs[li])) / f.f_t
                       : 0.0;
      }
    }
    if constexpr (kTangent) __syncwarp();
    record(j, dt, ddt);
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) all_crossed = all_crossed && crossed[m];
    // all crossed: the advance would change nothing
    if constexpr (kTangent) {
      post(slot, dt, ddt,
           (all_crossed ? kStop : 0) | (misfire ? kReject : 0));
    } else {
      mbox_dt[slot] = dt;
      mbox_flags[slot] = (all_crossed ? kStop : 0) | (misfire ? kReject : 0);
    }
  };

  step_barrier();
  if (n_live > 0) {
    if ((kTangent ? tid < 32 : tid == 0)
        && (!kTangent || owner(row_sched[0]) == rank))
      post_event(0, 0, 0.0, 0.0, 0.0);
    step_barrier();
  }
  for (int k = 0; k < n_live; ++k) {
    const int slot = k & 1;
    const int flags = mbox_flags[slot];
    const double dt = mbox_dt[slot];
    const int j = row_sched[k];
    if (tid == 0 && (flags & kReject)) consistent = false;
    if constexpr (kTangent) {
      // every CTA but the poster's: event k's bookkeeping from the mailbox
      if (tid < 32 && owner(j) != rank && j >= 0 && j < N)
        record(j, dt, mbox_ddt + slot * D);
    }
    if ((flags & kStop) || k + 1 == n_live) break;
    const double e_t = ::exp(-dt);
    const double de = drive * (1.0 - e_t);
    if (tid >= 32) {
      // the sweep: event k on every lane but the next one's
      const int j_next = row_sched[k + 1];
      for (int i = tid - 32; i < nl; i += nthr - 32) {
        if (i + lo == j_next) continue;
        if constexpr (kTangent) {
          advance_directions(v, s, b, bs, dv, ds, stride, i, D, dpp,
                             mbox_ddt + slot * D,
                             kick_weight(w, i + lo, j, N), i + lo == j, dt,
                             e_t, de, drive);
        } else {
          double vi = v[i], si = s[i];
          advance(vi, si, b[i], kick_weight(w, i, j, N), i == j, dt, e_t,
                  de);
          v[i] = vi;
          s[i] = si;
        }
      }
    } else if ((kTangent ? tid < 32 : tid == 0)
               && (!kTangent || owner(row_sched[k + 1]) == rank)) {
      post_event(k + 1, j, dt, e_t, de);
    }
    step_barrier();
  }

  if (tid == 0 && rank == 0) {
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) {
      const size_t o = (size_t)row * M + m;
      last_ind_out[o] = last_ind[m];
      last_time_out[o] = (T)last_time[m];
      crossed_ind_out[o] = crossed_ind[m];
      crossed_time_out[o] = (T)crossed_time[m];
      all_crossed = all_crossed && crossed[m];
    }
    const bool ok = all_crossed && consistent;
    if constexpr (kTangent) {
      // a rejected row's tangents are 0, as its times enter no mean
      for (int d = 0; d < D; ++d)
        for (int m = 0; m < M; ++m) {
          const size_t od = ((size_t)d * rows + row) * M + m;
          tg.d_last_out[od] = ok ? d_last[d * M + m] : 0.0;
          tg.d_crossed_out[od] = ok ? d_crossed[d * M + m] : 0.0;
        }
    }
    accept_out[row] = ok;
  }
  // no CTA of a cluster leaves while another may still read its mailbox
  if constexpr (kTangent) step_barrier();
}

template <typename T, bool kRowInGlobal, bool kBetaPerRow>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
replay_kernel(const T* __restrict__ v0, const T* __restrict__ s0,
              const T* __restrict__ beta, const int* __restrict__ sched,
              const int* __restrict__ n_sched,
              const int* __restrict__ init_ind,
              const double* __restrict__ wtab, int R, int N, int M, int E,
              int S, int Q, Consts c, int* __restrict__ last_ind_out,
              T* __restrict__ last_time_out, int* __restrict__ crossed_ind_out,
              T* __restrict__ crossed_time_out, bool* __restrict__ accept_out,
              double* __restrict__ row_scratch) {
  replay_body<T, kRowInGlobal, kBetaPerRow, false, false>(
      v0, s0, beta, sched, n_sched, init_ind, wtab, R, N, M, E, S, Q, c,
      last_ind_out, last_time_out, crossed_ind_out, crossed_time_out,
      accept_out, row_scratch, Tangents{});
}

template <typename T, bool kRowInGlobal, bool kBetaPerRow, bool kLogged>
__global__ void __launch_bounds__(kMaxThreads, kTangentMinBlocks)
replay_tangent_kernel(const T* __restrict__ v0, const T* __restrict__ s0,
                      const T* __restrict__ beta,
                      const int* __restrict__ sched,
                      const int* __restrict__ n_sched,
                      const int* __restrict__ init_ind,
                      const double* __restrict__ wtab, int R, int N, int M,
                      int E, int S, int Q, Consts c,
                      int* __restrict__ last_ind_out,
                      T* __restrict__ last_time_out,
                      int* __restrict__ crossed_ind_out,
                      T* __restrict__ crossed_time_out,
                      bool* __restrict__ accept_out,
                      double* __restrict__ row_scratch, Tangents tg) {
  replay_body<T, kRowInGlobal, kBetaPerRow, true, kLogged>(
      v0, s0, beta, sched, n_sched, init_ind, wtab, R, N, M, E, S, Q, c,
      last_ind_out, last_time_out, crossed_ind_out, crossed_time_out,
      accept_out, row_scratch, tg);
}

// Dynamic shared memory of one CTA of K2; model/evolve_cuda.py::
// row_shared_bytes counts the same arrays.
size_t smem_bytes(int N, int M, bool row_in_global) {
  const size_t row = 3 * (size_t)N + (size_t)(N / 2 + 1);
  return ((row_in_global ? 0 : row) + 2 * (size_t)M + 2) * sizeof(double)
         + (3 * (size_t)M + 2) * sizeof(int);
}

// Dynamic shared memory of one CTA of K2T in a cluster of C: its L =
// ceil(N / C) lanes of v, s, beta, base and D pairs (dv, ds), the kick
// table, the D + 1 times of each trajectory twice, the mailbox (dt and D
// d(dt), two slots), t's D tangents and the D dp, and the int bookkeeping;
// model/replay_cuda.py::tangent_shared_bytes counts the same arrays.
size_t tangent_smem_bytes(int N, int M, int D, int C, bool row_in_global) {
  const size_t L = ((size_t)N + C - 1) / C;
  const size_t row = (4 + 2 * (size_t)D) * L + (size_t)(N / 2 + 1);
  return ((row_in_global ? 0 : row) + 2 * (size_t)M + 2 * (size_t)D * M + 2
          + 4 * (size_t)D) * sizeof(double)
         + (3 * (size_t)M + 2) * sizeof(int);
}

template <typename T>
int launch(const void* v0, const void* s0, const void* beta,
           const void* sched, const void* n_sched, const void* init_ind,
           const void* wtab, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* row_scratch, int P, int R, int N, int M, int E, int S,
           int Q, int beta_per_row, int threads, const Consts& c,
           void* stream) {
  const long long rows = (long long)P * R;
  if (P < 1 || R < 1 || N < 1 || M < 1 || E < 1 || S < 1 || Q < 1
      || rows % S != 0 || P % Q != 0 || rows > 0x7fffffffLL || threads < 64
      || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const size_t shmem = smem_bytes(N, M, global);
  auto kernel = global ? (beta_per_row ? replay_kernel<T, true, true>
                                       : replay_kernel<T, true, false>)
                       : (beta_per_row ? replay_kernel<T, false, true>
                                       : replay_kernel<T, false, false>);
  const int err = set_shared_memory(kernel, shmem);
  if (err != 0) return err;
  kernel<<<(unsigned)rows, threads, shmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(s0),
      static_cast<const T*>(beta), static_cast<const int*>(sched),
      static_cast<const int*>(n_sched), static_cast<const int*>(init_ind),
      static_cast<const double*>(wtab), R, N, M, E, S, Q, c,
      static_cast<int*>(last_ind), static_cast<T*>(last_time),
      static_cast<int*>(crossed_ind), static_cast<T*>(crossed_time),
      static_cast<bool*>(accept), static_cast<double*>(row_scratch));
  return (int)cudaGetLastError();
}

// The K2T variant for rows in device memory or not, per-row rates or not,
// and the time log or the root-find.
template <typename T>
auto tangent_kernel(bool global, bool per_row, bool logged) {
  using K = decltype(&replay_tangent_kernel<T, false, false, false>);
  static const K table[8] = {
      replay_tangent_kernel<T, false, false, false>,
      replay_tangent_kernel<T, false, false, true>,
      replay_tangent_kernel<T, false, true, false>,
      replay_tangent_kernel<T, false, true, true>,
      replay_tangent_kernel<T, true, false, false>,
      replay_tangent_kernel<T, true, false, true>,
      replay_tangent_kernel<T, true, true, false>,
      replay_tangent_kernel<T, true, true, true>};
  return table[(global ? 4 : 0) + (per_row ? 2 : 0) + (logged ? 1 : 0)];
}

// The launch configuration of K2T: rows * C CTAs in clusters of C.
struct TangentLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
};

void tangent_launch(TangentLaunch& l, long long rows, int C, int threads,
                    size_t shmem, void* stream) {
  l = TangentLaunch{};
  l.config.gridDim = dim3((unsigned)(rows * C));
  l.config.blockDim = dim3((unsigned)threads);
  l.config.dynamicSmemBytes = shmem;
  l.config.stream = (cudaStream_t)stream;
  l.attribute.id = cudaLaunchAttributeClusterDimension;
  l.attribute.val.clusterDim.x = (unsigned)C;
  l.attribute.val.clusterDim.y = 1;
  l.attribute.val.clusterDim.z = 1;
  l.config.attrs = &l.attribute;
  l.config.numAttrs = 1;
}

bool tangent_shape_ok(int P, int R, int N, int M, int E, int S, int Q, int D,
                      int C, int threads) {
  const long long rows = (long long)P * R;
  return P >= 1 && R >= 1 && N >= 1 && M >= 1 && E >= 1 && S >= 1 && Q >= 1
         && rows % S == 0 && P % Q == 0 && D >= 1 && D <= 65535 && C >= 1
         && C <= kMaxCluster && (C & (C - 1)) == 0
         && rows * C <= 0x7fffffffLL && threads >= 64
         && threads <= kMaxThreads && threads % 32 == 0;
}

template <typename T>
int launch_tangent(const void* v0, const void* s0, const void* beta,
                   const void* sched, const void* n_sched,
                   const void* init_ind, const void* wtab, void* last_ind,
                   void* last_time, void* crossed_ind, void* crossed_time,
                   void* accept, void* row_scratch, int P, int R, int N,
                   int M, int E, int S, int Q, int D, int C,
                   int beta_per_row, int threads, const Consts& c,
                   const Tangents& tg, void* stream) {
  if (!tangent_shape_ok(P, R, N, M, E, S, Q, D, C, threads)
      || (row_scratch != nullptr && C != 1))
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const size_t shmem = tangent_smem_bytes(N, M, D, C, global);
  auto kernel = tangent_kernel<T>(global, beta_per_row, tg.times != nullptr);
  const int err = set_shared_memory(kernel, shmem);
  if (err != 0) return err;
  TangentLaunch l;
  tangent_launch(l, (long long)P * R, C, threads, shmem, stream);
  const cudaError_t launched = cudaLaunchKernelEx(
      &l.config, kernel, static_cast<const T*>(v0),
      static_cast<const T*>(s0), static_cast<const T*>(beta),
      static_cast<const int*>(sched), static_cast<const int*>(n_sched),
      static_cast<const int*>(init_ind), static_cast<const double*>(wtab), R,
      N, M, E, S, Q, c, static_cast<int*>(last_ind),
      static_cast<T*>(last_time), static_cast<int*>(crossed_ind),
      static_cast<T*>(crossed_time), static_cast<bool*>(accept),
      static_cast<double*>(row_scratch), tg);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace

// root_tol is the seed's (f32) tolerance; counter_max bounds its Newton.
// row_scratch: NULL keeps each row in shared memory; else P*R*3N doubles of
// device memory for the rows.  beta_per_row: 0 = beta is (R, N), shared by
// the P points; 1 = (P*R, N), one row of rates per row.  threads: a CTA's
// threads, a multiple of 32 from 64 to 512 (warp 0 posts the events, the
// others sweep).
#define ATORCH_REPLAY(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* beta,       \
                      const void* sched, const void* n_sched,                 \
                      const void* init_ind, const void* wtab, void* last_ind, \
                      void* last_time, void* crossed_ind, void* crossed_time, \
                      void* accept, void* row_scratch, int P, int R, int N,   \
                      int M, int E, int S, int Q, int beta_per_row,           \
                      int threads,                                            \
                      int counter_max, double vth, double drive, double gap,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, 0.0, 0.0, 0.0, 0.0, 0.0, t_horizon,      \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, beta, sched, n_sched, init_ind, wtab, last_ind, \
                     last_time, crossed_ind, crossed_time, accept,            \
                     row_scratch, P, R, N, M, E, S, Q, beta_per_row, threads, \
                     c, stream);                                              \
  }

ATORCH_REPLAY(atorch_replay_f32, float)
ATORCH_REPLAY(atorch_replay_f64, double)

// K2T: the arguments of K2 plus dv0, ds0 ((D, P, N) doubles), base ((R, N)
// doubles, or NULL), dp ((D, P) doubles), times (NULL, or the (S, E)
// doubles of the evolve's time log beside sched) and the outputs d_last,
// d_crossed ((D, P*R, M) doubles); C: the CTAs of a row's cluster (1, 2, 4
// or 8); row_scratch: NULL, or P*R*(4 + 2D)*N doubles (then C = 1).
#define ATORCH_REPLAY_TANGENT(NAME, T)                                        \
  extern "C" int NAME(const void* v0, const void* s0, const void* beta,       \
                      const void* dv0, const void* ds0, const void* base,     \
                      const void* dp, const void* times, const void* sched,   \
                      const void* n_sched, const void* init_ind,              \
                      const void* wtab, void* last_ind, void* last_time,      \
                      void* crossed_ind, void* crossed_time, void* accept,    \
                      void* d_last, void* d_crossed, void* row_scratch,       \
                      int P, int R, int N, int M, int E, int S, int Q, int D, \
                      int C, int beta_per_row, int threads, int counter_max,  \
                      double vth, double drive, double gap, double t_horizon, \
                      double root_tol, void* stream) {                        \
    const Consts c{vth, drive, gap, 0.0, 0.0, 0.0, 0.0, 0.0, t_horizon,      \
                   root_tol, counter_max};                                    \
    const Tangents tg{static_cast<const double*>(dv0),                        \
                      static_cast<const double*>(ds0),                        \
                      static_cast<const double*>(base),                       \
                      static_cast<const double*>(dp),                         \
                      static_cast<const double*>(times),                      \
                      static_cast<double*>(d_last),                           \
                      static_cast<double*>(d_crossed), D};                    \
    return launch_tangent<T>(v0, s0, beta, sched, n_sched, init_ind, wtab,   \
                             last_ind, last_time, crossed_ind, crossed_time,  \
                             accept, row_scratch, P, R, N, M, E, S, Q, D, C,  \
                             beta_per_row, threads, c, tg, stream);           \
  }

ATORCH_REPLAY_TANGENT(atorch_replay_tangent_f32, float)
ATORCH_REPLAY_TANGENT(atorch_replay_tangent_f64, double)

// The dynamic shared memory of one K2T CTA (the count the launch takes).
extern "C" int atorch_replay_tangent_smem_bytes(int N, int M, int D, int C,
                                                int row_in_global) {
  return (int)tangent_smem_bytes(N, M, D, C, row_in_global != 0);
}

// How many clusters of C CTAs of the f64 K2T variant (rows in device
// memory, per-row rates, the time log) the card holds at once, at `threads`
// a CTA and N lanes, M trajectories and D directions a row, into *out.
extern "C" int atorch_replay_tangent_clusters(int row_in_global, int per_row,
                                              int logged, int N, int M,
                                              int D, int C, int threads,
                                              int* out) {
  if (C < 1 || C > kMaxCluster || threads < 64 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = tangent_smem_bytes(N, M, D, C, row_in_global != 0);
  auto kernel = tangent_kernel<double>(row_in_global, per_row, logged);
  const int err = set_shared_memory(kernel, shmem);
  if (err != 0) return err;
  TangentLaunch l;
  tangent_launch(l, 1, C, threads, shmem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.config);
}
