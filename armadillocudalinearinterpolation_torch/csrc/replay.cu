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
// --use_fast_math and with --fmad=false (see events.cuh).

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

template <typename T, bool kRowInGlobal>
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  double* shared = reinterpret_cast<double*>(smem);
  double* v = kRowInGlobal ? row_scratch + (size_t)row * 3 * N : shared;
  double* s = v + N;
  double* b = s + N;
  // N/2 + 1 kick weights: a copy beside the row, or the wrapper's table
  double* w_copy = b + N;
  const double* w = kRowInGlobal ? wtab : w_copy;
  double* small = kRowInGlobal ? shared : w_copy + (N / 2 + 1);
  double* last_time = small;
  double* crossed_time = last_time + M;
  double* mbox_dt = crossed_time + M;      // [2]: by the event's parity
  int* last_ind = reinterpret_cast<int*>(mbox_dt + 2);
  int* crossed_ind = last_ind + M;
  int* crossed = crossed_ind + M;
  int* mbox_flags = crossed + M;           // [2]

  const int p = row / R, r = row % R, sr = row % S, q = p % Q;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < N; i += nthr) {
    v[i] = (double)v0[(size_t)p * N + i];
    s[i] = (double)s0[(size_t)p * N + i];
    b[i] = (double)beta[(size_t)r * N + i];
  }
  if (!kRowInGlobal)
    for (int d = tid; d <= N / 2; d += nthr) w_copy[d] = wtab[d];
  const int ns = n_sched[sr];
  const int n_live = ns < E ? ns : E;
  const double drive = c.drive, vth = c.vth, t_horizon = c.t_horizon;
  const int* row_sched = sched + (size_t)sr * E;
  // thread 0's running event time and consistency
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

  // Thread 0: post event kn in its mailbox slot.  Its lane out of range
  // stops the row; else thread 0 applies event kn - 1 (j_prev, dt_prev) to
  // the lane, runs the root-find, classifies the event and posts (dt,
  // flags).
  auto post_event = [&](int kn, int j_prev, double dt_prev, double e_t,
                        double de) {
    const int slot = kn & 1;
    const int j = row_sched[kn];
    if (j < 0 || j >= N) {
      mbox_flags[slot] = kStop | kReject;
      return;
    }
    double vj = v[j], sj = s[j];
    const double bj = b[j];
    if (kn > 0) {
      advance(vj, sj, bj, kick_weight(w, j, j_prev, N), j == j_prev,
              dt_prev, e_t, de);
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
    classify_event(j, t_new, t_horizon, M, last_ind, last_time, crossed_ind,
                   crossed_time, crossed);
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) all_crossed = all_crossed && crossed[m];
    // all crossed: the advance would change nothing
    mbox_dt[slot] = dt;
    mbox_flags[slot] = (all_crossed ? kStop : 0) | (misfire ? kReject : 0);
  };

  __syncthreads();
  if (n_live > 0) {
    if (tid == 0) post_event(0, 0, 0.0, 0.0, 0.0);
    __syncthreads();
  }
  for (int k = 0; k < n_live; ++k) {
    const int slot = k & 1;
    const int flags = mbox_flags[slot];
    const double dt = mbox_dt[slot];
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
        advance(vi, si, b[i], kick_weight(w, i, j, N), i == j, dt, e_t, de);
        v[i] = vi;
        s[i] = si;
      }
    } else if (tid == 0) {
      post_event(k + 1, j, dt, e_t, de);
    }
    __syncthreads();
  }

  if (tid == 0) {
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) {
      const size_t o = (size_t)row * M + m;
      last_ind_out[o] = last_ind[m];
      last_time_out[o] = (T)last_time[m];
      crossed_ind_out[o] = crossed_ind[m];
      crossed_time_out[o] = (T)crossed_time[m];
      all_crossed = all_crossed && crossed[m];
    }
    accept_out[row] = all_crossed && consistent;
  }
}

// Dynamic shared memory of one CTA; model/evolve_cuda.py::row_shared_bytes
// counts the same arrays.
size_t smem_bytes(int N, int M, bool row_in_global) {
  const size_t row = 3 * (size_t)N + (size_t)(N / 2 + 1);
  return ((row_in_global ? 0 : row) + 2 * (size_t)M + 2) * sizeof(double)
         + (3 * (size_t)M + 2) * sizeof(int);
}

template <typename T>
int launch(const void* v0, const void* s0, const void* beta,
           const void* sched, const void* n_sched, const void* init_ind,
           const void* wtab, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* row_scratch, int P, int R, int N, int M, int E, int S,
           int Q, int threads, const Consts& c, void* stream) {
  const long long rows = (long long)P * R;
  if (P < 1 || R < 1 || N < 1 || M < 1 || E < 1 || S < 1 || Q < 1
      || rows % S != 0 || P % Q != 0 || rows > 0x7fffffffLL || threads < 64
      || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const size_t shmem = smem_bytes(N, M, global);
  auto kernel = global ? replay_kernel<T, true> : replay_kernel<T, false>;
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

}  // namespace

// root_tol is the seed's (f32) tolerance; counter_max bounds its Newton.
// row_scratch: NULL keeps each row in shared memory; else P*R*3N doubles of
// device memory for the rows.  threads: a CTA's threads, a multiple of 32
// from 64 to 512 (warp 0 posts the events, the others sweep).
#define ATORCH_REPLAY(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* beta,       \
                      const void* sched, const void* n_sched,                 \
                      const void* init_ind, const void* wtab, void* last_ind, \
                      void* last_time, void* crossed_ind, void* crossed_time, \
                      void* accept, void* row_scratch, int P, int R, int N,   \
                      int M, int E, int S, int Q, int threads,                \
                      int counter_max, double vth, double drive, double gap,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, 0.0, 0.0, 0.0, 0.0, 0.0, t_horizon,      \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, beta, sched, n_sched, init_ind, wtab, last_ind, \
                     last_time, crossed_ind, crossed_time, accept,            \
                     row_scratch, P, R, N, M, E, S, Q, threads, c, stream);   \
  }

ATORCH_REPLAY(atorch_replay_f32, float)
ATORCH_REPLAY(atorch_replay_f64, double)
