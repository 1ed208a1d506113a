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

#include "events.cuh"

namespace {

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

// Event (j, dt) on one lane with state (vi, si), rate bi and kick weight
// wd = w(|lane - j|): the closed-form advance (e_t = exp(-dt) and de =
// drive (1 - e_t) are the same for every lane), the reset if the lane
// fires, the ring kick.  The one lane update of the kernel.
__device__ __forceinline__ void advance(double& vi, double& si, double bi,
                                        double wd, bool fires, double dt,
                                        double e_t, double de) {
  const double e_b = ::exp(-bi * dt);
  const double vn = vi * e_t + de + si * (e_b - e_t) / (1.0 - bi);
  vi = fires ? 0.0 : vn;
  si = si * e_b + bi * wd;
}

__device__ __forceinline__ double kick_weight(const double* w, int lane,
                                              int j, int N) {
  const int d = abs(lane - j);
  return w[min(d, N - d)];
}

// ---------------------------------------------------------------------------
// K2T: the replay with D forward tangents (the exact Jacobian's kernel).
//
// Replaces: jax.jacfwd through _replay_events_impl (model/replay.py:724-747
// of the JAX package).  Plain version: model/replay.py::
// replay_events_tangent.  One CTA per (row, direction): blockIdx.x is the
// row, blockIdx.y the direction.  It is K2's body (replay_body below, with
// kTangent) on the primal (v, s) and one tangent pair (dv, ds) of its
// direction, with the direction's rate tangent db (0 for a Z direction, 1
// for the beta axis, the frozen noise for the sigma axis).  Thread 0 also
// computes the event time's tangent d(dt) by the implicit function theorem
// at the polished root (event_dt_tangent: the partials of the root-find's
// own shared-exponential form) and posts it in the mailbox beside (dt,
// flags).  The sweep advances the primal and the tangent of each lane in
// one pass (advance_tangent; the primal arithmetic is advance()'s,
// operation by operation, so the primal outputs equal K2's bit for bit).
// The firing lane's v resets to 0 (tangent 0); the kick adds db * w(d);
// t's tangent accumulates d(dt), and last_time / crossed_time take it
// where the event is recorded.  A misfire pins dt, so its d(dt) is 0.  The
// CTA of direction 0 writes the primal outputs.
//
// Shared memory per row: v, s, beta, dv, ds, db (6N doubles) and the kick
// table; a row that does not fit keeps the six arrays in a (rows * D, 6N)
// scratch in device memory and reads the wrapper's kick table.

// d(dt) at the root dt of v e_t + I (1 - e_t) + s (e_b - e_t) / (1 - b)
// - vth: -(f_v dv + f_s ds + f_b db) / f_t, with e_t = exp(-dt), e_b =
// exp(-b dt) (model/events.py::event_time_jvp, form "shared")
__device__ __forceinline__ double event_dt_tangent(double dt, double v,
                                                   double s, double b,
                                                   double dv, double ds,
                                                   double db, double drive) {
  const double e_t = ::exp(-dt);
  const double e_b = ::exp(-b * dt);
  const double f_t = (drive - v) * e_t + s * (e_t - b * e_b) / (1.0 - b);
  const double f_s = (e_b - e_t) / (1.0 - b);
  const double f_b = s * (f_s - dt * e_b) / (1.0 - b);
  return -(e_t * dv + f_s * ds + f_b * db) / f_t;
}

// advance() and its tangent along one direction: the primal lines are
// advance()'s (bit for bit); de_t = -e_t d(dt), de_b = -e_b (db dt + b
// d(dt)).
__device__ __forceinline__ void advance_tangent(double& vi, double& si,
                                                double bi, double& dvi,
                                                double& dsi, double dbi,
                                                double wd, bool fires,
                                                double dt, double ddt,
                                                double e_t, double de,
                                                double drive) {
  const double e_b = ::exp(-bi * dt);
  const double vn = vi * e_t + de + si * (e_b - e_t) / (1.0 - bi);
  // one division for the tangent: q = (e_b - e_t) / (1 - b) and its
  // derivative ((de_b - de_t) + q db) / (1 - b) by one reciprocal
  const double inv = 1.0 / (1.0 - bi);
  const double q = (e_b - e_t) * inv;
  const double de_t = -e_t * ddt;
  const double de_b = -e_b * (dbi * dt + bi * ddt);
  const double dq = ((de_b - de_t) + q * dbi) * inv;
  const double dvn = dvi * e_t + vi * de_t - drive * de_t + dsi * q + si * dq;
  const double dsn = dsi * e_b + si * de_b + dbi * wd;
  vi = fires ? 0.0 : vn;
  si = si * e_b + bi * wd;
  dvi = fires ? 0.0 : dvn;
  dsi = dsn;
}

// Threads of a K2T CTA at most, one CTA an SM: up to 128 registers a thread
// (model/replay_cuda.py::replay_layout counts 512 threads an SM for it).
constexpr int kTangentMinBlocks = 1;

// The body of K2 and, with kTangent, of K2T (the tangent arrays, the d(dt)
// mailbox slots and the time tangents compile out of K2).  kBetaPerRow:
// beta is (P*R, N), one row of rates per row, else (R, N) shared by the P
// points (a template parameter: the shared case compiles to the kernel
// without it).  K2T's dbeta is (D, rows of beta, N) and dv0, ds0 are (D,
// P, N).
template <typename T, bool kRowInGlobal, bool kBetaPerRow, bool kTangent>
__device__ __forceinline__ void replay_body(
    const T* __restrict__ v0, const T* __restrict__ s0,
    const T* __restrict__ beta, const int* __restrict__ sched,
    const int* __restrict__ n_sched, const int* __restrict__ init_ind,
    const double* __restrict__ wtab, int R, int N, int M, int E, int S,
    int Q, const Consts& c, int* __restrict__ last_ind_out,
    T* __restrict__ last_time_out, int* __restrict__ crossed_ind_out,
    T* __restrict__ crossed_time_out, bool* __restrict__ accept_out,
    double* __restrict__ row_scratch, const double* __restrict__ dv0,
    const double* __restrict__ ds0, const double* __restrict__ dbeta,
    double* __restrict__ d_last_out, double* __restrict__ d_crossed_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // row arrays: v, s, beta and, for K2T, dv, ds, db
  constexpr int kArrays = kTangent ? 6 : 3;
  const int row = blockIdx.x;
  const int dir = kTangent ? (int)blockIdx.y : 0;
  const int rows = kTangent ? (int)gridDim.x : 0;
  double* shared = reinterpret_cast<double*>(smem);
  double* v = kRowInGlobal
                  ? row_scratch + ((size_t)dir * rows + row) * kArrays * N
                  : shared;
  double* s = v + N;
  double* b = s + N;
  double* dv = b + N;                      // K2T only, as ds and db
  double* ds = dv + N;
  double* db = ds + N;
  // N/2 + 1 kick weights: a copy beside the row, or the wrapper's table
  double* w_copy = (kTangent ? db : b) + N;
  const double* w = kRowInGlobal ? wtab : w_copy;
  double* small = kRowInGlobal ? shared : w_copy + (N / 2 + 1);
  double* last_time = small;
  double* crossed_time = last_time + M;
  double* d_last = crossed_time + M;       // K2T only, as d_crossed
  double* d_crossed = d_last + M;
  // [2] each, by the event's parity: dt and, for K2T, d(dt)
  double* mbox_dt = (kTangent ? d_crossed : crossed_time) + M;
  double* mbox_ddt = mbox_dt + 2;
  int* last_ind = reinterpret_cast<int*>((kTangent ? mbox_ddt : mbox_dt) + 2);
  int* crossed_ind = last_ind + M;
  int* crossed = crossed_ind + M;
  int* mbox_flags = crossed + M;           // [2]

  const int p = row / R, r = row % R, sr = row % S, q = p % Q;
  const int br = kBetaPerRow ? row : r;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < N; i += nthr) {
    v[i] = (double)v0[(size_t)p * N + i];
    s[i] = (double)s0[(size_t)p * N + i];
    b[i] = (double)beta[(size_t)br * N + i];
    if constexpr (kTangent) {
      const size_t pr = (size_t)dir * (rows / R) + p;
      dv[i] = dv0[pr * N + i];
      ds[i] = ds0[pr * N + i];
      db[i] = dbeta[((size_t)dir * (kBetaPerRow ? rows : R) + br) * N + i];
    }
  }
  if (!kRowInGlobal)
    for (int d = tid; d <= N / 2; d += nthr) w_copy[d] = wtab[d];
  const int ns = n_sched[sr];
  const int n_live = ns < E ? ns : E;
  const double drive = c.drive, vth = c.vth, t_horizon = c.t_horizon;
  const int* row_sched = sched + (size_t)sr * E;
  // thread 0's running event time, its tangent (K2T) and consistency
  double t = 0.0, tt = 0.0;
  bool consistent = ns <= E;             // an overflowed log rejects
  if (tid == 0) {
    for (int m = 0; m < M; ++m) {
      last_ind[m] = crossed_ind[m] = init_ind[(size_t)q * M + m];
      last_time[m] = 0.0;
      crossed_time[m] = 2.0 * t_horizon;
      if constexpr (kTangent) d_last[m] = d_crossed[m] = 0.0;
      crossed[m] = 0;
    }
  }

  // Thread 0: post event kn in its mailbox slot.  Its lane out of range
  // stops the row; else thread 0 applies event kn - 1 (j_prev, dt_prev and
  // its tangent ddt_prev) to the lane, runs the root-find, takes d(dt)
  // (K2T), classifies the event (recording t's tangent with the time) and
  // posts (dt, d(dt), flags).
  auto post_event = [&](int kn, int j_prev, double dt_prev, double ddt_prev,
                        double e_t, double de) {
    const int slot = kn & 1;
    const int j = row_sched[kn];
    if (j < 0 || j >= N) {
      mbox_flags[slot] = kStop | kReject;
      return;
    }
    double vj = v[j], sj = s[j];
    const double bj = b[j];
    double dvj = 0.0, dsj = 0.0, dbj = 0.0;
    if constexpr (kTangent) {
      dvj = dv[j];
      dsj = ds[j];
      dbj = db[j];
    }
    if (kn > 0) {
      if constexpr (kTangent) {
        advance_tangent(vj, sj, bj, dvj, dsj, dbj,
                        kick_weight(w, j, j_prev, N), j == j_prev, dt_prev,
                        ddt_prev, e_t, de, drive);
        dv[j] = dvj;
        ds[j] = dsj;
      } else {
        advance(vj, sj, bj, kick_weight(w, j, j_prev, N), j == j_prev,
                dt_prev, e_t, de);
      }
      v[j] = vj;
      s[j] = sj;
    }
    const float dt32 = event_time<float>((float)vj, (float)sj, (float)bj, c);
    const bool misfire = dt32 >= 100.0f;
    double dt = misfire ? kMisfireDt : (double)dt32;
    for (int it = 0; it < 2; ++it) {
      const double f = membrane_shared(dt, vj, sj, bj, drive, vth);
      double fp = membrane_df(vj, sj, bj, ::exp(-dt), ::exp((1.0 - bj) * dt),
                              drive);
      fp = ::fabs(fp) > 1e-12 ? fp : 1.0;
      dt = dt - f / fp;
    }
    if (misfire) dt = kMisfireDt;
    const double t_new = t + dt;
    t = t_new;
    const int mm = classify_event(j, t_new, t_horizon, M, last_ind,
                                  last_time, crossed_ind, crossed_time,
                                  crossed);
    if constexpr (kTangent) {
      const double ddt =
          misfire ? 0.0
                  : event_dt_tangent(dt, vj, sj, bj, dvj, dsj, dbj, drive);
      tt = tt + ddt;
      if (mm >= 0) (t_new > t_horizon ? d_crossed : d_last)[mm] = tt;
      mbox_ddt[slot] = ddt;
    }
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) all_crossed = all_crossed && crossed[m];
    // all crossed: the advance would change nothing
    mbox_dt[slot] = dt;
    mbox_flags[slot] = (all_crossed ? kStop : 0) | (misfire ? kReject : 0);
  };

  __syncthreads();
  if (n_live > 0) {
    if (tid == 0) post_event(0, 0, 0.0, 0.0, 0.0, 0.0);
    __syncthreads();
  }
  for (int k = 0; k < n_live; ++k) {
    const int slot = k & 1;
    const int flags = mbox_flags[slot];
    const double dt = mbox_dt[slot];
    double ddt = 0.0;
    if constexpr (kTangent) ddt = mbox_ddt[slot];
    const int j = row_sched[k];
    if (tid == 0 && (flags & kReject)) consistent = false;
    if ((flags & kStop) || k + 1 == n_live) break;
    const double e_t = ::exp(-dt);
    const double de = drive * (1.0 - e_t);
    if (tid >= 32) {
      // the sweep: event k on every lane but the next one's
      const int j_next = row_sched[k + 1];
      for (int i = tid - 32; i < N; i += nthr - 32) {
        if (i == j_next) continue;
        double vi = v[i], si = s[i];
        if constexpr (kTangent) {
          double dvi = dv[i], dsi = ds[i];
          advance_tangent(vi, si, b[i], dvi, dsi, db[i],
                          kick_weight(w, i, j, N), i == j, dt, ddt, e_t, de,
                          drive);
          dv[i] = dvi;
          ds[i] = dsi;
        } else {
          advance(vi, si, b[i], kick_weight(w, i, j, N), i == j, dt, e_t,
                  de);
        }
        v[i] = vi;
        s[i] = si;
      }
    } else if (tid == 0) {
      post_event(k + 1, j, dt, ddt, e_t, de);
    }
    __syncthreads();
  }

  if (tid == 0) {
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) {
      if (dir == 0) {
        const size_t o = (size_t)row * M + m;
        last_ind_out[o] = last_ind[m];
        last_time_out[o] = (T)last_time[m];
        crossed_ind_out[o] = crossed_ind[m];
        crossed_time_out[o] = (T)crossed_time[m];
      }
      all_crossed = all_crossed && crossed[m];
    }
    const bool ok = all_crossed && consistent;
    if constexpr (kTangent) {
      // a rejected row's tangents are 0, as its times enter no mean
      for (int m = 0; m < M; ++m) {
        const size_t od = ((size_t)dir * rows + row) * M + m;
        d_last_out[od] = ok ? d_last[m] : 0.0;
        d_crossed_out[od] = ok ? d_crossed[m] : 0.0;
      }
    }
    if (dir == 0) accept_out[row] = ok;
  }
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
  replay_body<T, kRowInGlobal, kBetaPerRow, false>(
      v0, s0, beta, sched, n_sched, init_ind, wtab, R, N, M, E, S, Q, c,
      last_ind_out, last_time_out, crossed_ind_out, crossed_time_out,
      accept_out, row_scratch, nullptr, nullptr, nullptr, nullptr, nullptr);
}

template <typename T, bool kRowInGlobal, bool kBetaPerRow>
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
                      double* __restrict__ row_scratch,
                      const double* __restrict__ dv0,
                      const double* __restrict__ ds0,
                      const double* __restrict__ dbeta,
                      double* __restrict__ d_last_out,
                      double* __restrict__ d_crossed_out) {
  replay_body<T, kRowInGlobal, kBetaPerRow, true>(
      v0, s0, beta, sched, n_sched, init_ind, wtab, R, N, M, E, S, Q, c,
      last_ind_out, last_time_out, crossed_ind_out, crossed_time_out,
      accept_out, row_scratch, dv0, ds0, dbeta, d_last_out, d_crossed_out);
}

// Dynamic shared memory of one CTA of K2, or of K2T (tangent);
// model/evolve_cuda.py::row_shared_bytes counts the same arrays.
size_t smem_bytes(int N, int M, bool row_in_global, bool tangent) {
  const size_t row = (tangent ? 6 : 3) * (size_t)N + (size_t)(N / 2 + 1);
  return ((row_in_global ? 0 : row) + (tangent ? 4 : 2) * (size_t)M
          + (tangent ? 4 : 2)) * sizeof(double)
         + (3 * (size_t)M + 2) * sizeof(int);
}

// K2 (D = 0) or K2T (D directions, dv0 ... d_crossed given)
template <typename T>
int launch(const void* v0, const void* s0, const void* beta,
           const void* sched, const void* n_sched, const void* init_ind,
           const void* wtab, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* row_scratch, int P, int R, int N, int M, int E, int S,
           int Q, int beta_per_row, int threads, const Consts& c,
           void* stream, int D = 0, const void* dv0 = nullptr,
           const void* ds0 = nullptr, const void* dbeta = nullptr,
           void* d_last = nullptr, void* d_crossed = nullptr) {
  const long long rows = (long long)P * R;
  if (P < 1 || R < 1 || N < 1 || M < 1 || E < 1 || S < 1 || Q < 1
      || rows % S != 0 || P % Q != 0 || rows > 0x7fffffffLL || threads < 64
      || threads > kMaxThreads || threads % 32 || D < 0 || D > 65535)
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const bool tangent = D > 0;
  const size_t shmem = smem_bytes(N, M, global, tangent);
  if (!tangent) {
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
  } else {
    auto kernel =
        global ? (beta_per_row ? replay_tangent_kernel<T, true, true>
                               : replay_tangent_kernel<T, true, false>)
               : (beta_per_row ? replay_tangent_kernel<T, false, true>
                               : replay_tangent_kernel<T, false, false>);
    const int err = set_shared_memory(kernel, shmem);
    if (err != 0) return err;
    kernel<<<dim3((unsigned)rows, (unsigned)D), threads, shmem,
             (cudaStream_t)stream>>>(
        static_cast<const T*>(v0), static_cast<const T*>(s0),
        static_cast<const T*>(beta), static_cast<const int*>(sched),
        static_cast<const int*>(n_sched), static_cast<const int*>(init_ind),
        static_cast<const double*>(wtab), R, N, M, E, S, Q, c,
        static_cast<int*>(last_ind), static_cast<T*>(last_time),
        static_cast<int*>(crossed_ind), static_cast<T*>(crossed_time),
        static_cast<bool*>(accept), static_cast<double*>(row_scratch),
        static_cast<const double*>(dv0), static_cast<const double*>(ds0),
        static_cast<const double*>(dbeta), static_cast<double*>(d_last),
        static_cast<double*>(d_crossed));
  }
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

// K2T: the arguments of K2 plus dv0, ds0 ((D, P, N) doubles), dbeta ((D,
// R, N) or (D, P*R, N) doubles, by beta_per_row) and the outputs d_last,
// d_crossed ((D, P*R, M) doubles); row_scratch: NULL, or P*R*D*6N doubles.
#define ATORCH_REPLAY_TANGENT(NAME, T)                                        \
  extern "C" int NAME(const void* v0, const void* s0, const void* beta,       \
                      const void* dv0, const void* ds0, const void* dbeta,    \
                      const void* sched, const void* n_sched,                 \
                      const void* init_ind, const void* wtab, void* last_ind, \
                      void* last_time, void* crossed_ind, void* crossed_time, \
                      void* accept, void* d_last, void* d_crossed,            \
                      void* row_scratch, int P, int R, int N, int M, int E,   \
                      int S, int Q, int D, int beta_per_row, int threads,     \
                      int counter_max, double vth, double drive, double gap,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, 0.0, 0.0, 0.0, 0.0, 0.0, t_horizon,      \
                   root_tol, counter_max};                                    \
    if (D < 1) return (int)cudaErrorInvalidValue;                             \
    return launch<T>(v0, s0, beta, sched, n_sched, init_ind, wtab, last_ind, \
                     last_time, crossed_ind, crossed_time, accept,            \
                     row_scratch, P, R, N, M, E, S, Q, beta_per_row, threads, \
                     c, stream, D, dv0, ds0, dbeta, d_last, d_crossed);       \
  }

ATORCH_REPLAY_TANGENT(atorch_replay_tangent_f32, float)
ATORCH_REPLAY_TANGENT(atorch_replay_tangent_f64, double)
