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
// added, and one thread classifies the event as K1 does.
//
// What bounds it: the lanes' work is one fp64 exp, one fp64 division and
// ~17 other fp64 and index operations per lane per event (the kick reads a
// table of w(d) dx, d = 0 .. N/2, kept in shared memory beside the row),
// against the card's 34 TFLOP/s fp64 peak outside the tensor cores; and
// each event starts with the serial root-find of one thread (an f32 Newton
// of up to counter_max steps and two fp64 polishes, each a few exp), whose
// latency no lane can hide, and two barriers.
//
// Layout: one CTA per row (one point x one realisation); v, s and beta of
// the row in fp64 and the kick table in opt-in dynamic shared memory
// (112 KB at N=4096, so two CTAs fit on an SM); threads stride over the
// lanes.  Where the row does not fit (N above 8,297), v, s and beta stay
// in a (rows, 3N) scratch in device memory that the wrapper allocates and
// the kick table is read where the wrapper keeps it; the same kernel body
// runs on those pointers.  The row stops at its own min(n_sched, E)
// events, or once all its trajectories have crossed T (later events change
// no output).
//
// Semantics follow model/replay.py operation by operation.  Build without
// --use_fast_math and with --fmad=false (see events.cuh).

#include <stdint.h>

#include "events.cuh"

namespace {

// the step a misfiring row takes: the JAX replay's f32 0.05
constexpr double kMisfireDt = (double)0.05f;

// v e_t + I (1 - e_t) + s (e_b - e_t) / (1 - b) - vth, e_t = exp(-t),
// e_b = exp(-b t): the residual in the form of the advance below
__device__ __forceinline__ double membrane_shared(double t, double v,
                                                  double s, double b,
                                                  double drive, double vth) {
  const double e_t = ::exp(-t);
  const double e_b = ::exp(-b * t);
  return v * e_t + drive * (1.0 - e_t) + s * (e_b - e_t) / (1.0 - b) - vth;
}

template <typename T, bool kRowInGlobal>
__global__ void replay_kernel(const T* __restrict__ v0,
                              const T* __restrict__ s0,
                              const T* __restrict__ beta,
                              const int* __restrict__ sched,
                              const int* __restrict__ n_sched,
                              const int* __restrict__ init_ind,
                              const double* __restrict__ wtab, int R, int N,
                              int M, int E, int S, int Q, Consts c,
                              int* __restrict__ last_ind_out,
                              T* __restrict__ last_time_out,
                              int* __restrict__ crossed_ind_out,
                              T* __restrict__ crossed_time_out,
                              bool* __restrict__ accept_out,
                              double* __restrict__ row_scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* big = kRowInGlobal ? row_scratch + (size_t)blockIdx.x * 3 * N
                             : reinterpret_cast<double*>(smem);
  double* v = big;
  double* s = v + N;
  double* b = s + N;
  // N/2 + 1 kick weights: a copy beside the row, or the wrapper's table
  double* w_copy = b + N;
  const double* w = kRowInGlobal ? wtab : w_copy;
  double* last_time = kRowInGlobal ? reinterpret_cast<double*>(smem)
                                   : w_copy + (N / 2 + 1);
  double* crossed_time = last_time + M;
  double* scal = crossed_time + M;         // [0] t, [1] dt
  int* last_ind = reinterpret_cast<int*>(scal + 2);
  int* crossed_ind = last_ind + M;
  int* crossed = crossed_ind + M;
  int* iscal = crossed + M;                // [0] j, [1] stop, [2] consistent

  const int row = blockIdx.x;
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
  if (tid == 0) {
    for (int m = 0; m < M; ++m) {
      last_ind[m] = crossed_ind[m] = init_ind[(size_t)q * M + m];
      last_time[m] = 0.0;
      crossed_time[m] = 2.0 * t_horizon;
      crossed[m] = 0;
    }
    scal[0] = 0.0;
    iscal[1] = 0;
    iscal[2] = ns <= E;                    // an overflowed log rejects
  }
  __syncthreads();

  const int* row_sched = sched + (size_t)sr * E;
  for (int k = 0; k < n_live; ++k) {
    // 1. one thread: root-find of the scheduled lane, and the bookkeeping
    if (tid == 0) {
      const int j = row_sched[k];
      if (j < 0 || j >= N) {
        iscal[1] = 1;
        iscal[2] = 0;
      } else {
        const double vj = v[j], sj = s[j], bj = b[j];
        const float dt32 = event_time<float>((float)vj, (float)sj,
                                             (float)bj, c);
        const bool misfire = dt32 >= 100.0f;
        double dt = misfire ? kMisfireDt : (double)dt32;
        for (int it = 0; it < 2; ++it) {
          const double f = membrane_shared(dt, vj, sj, bj, drive, vth);
          double fp = membrane_df(vj, sj, bj, ::exp(-dt),
                                  ::exp((1.0 - bj) * dt), drive);
          fp = ::fabs(fp) > 1e-12 ? fp : 1.0;
          dt = dt - f / fp;
        }
        if (misfire) {
          dt = kMisfireDt;
          iscal[2] = 0;
        }
        const double t_new = scal[0] + dt;
        scal[0] = t_new;
        scal[1] = dt;
        iscal[0] = j;
        classify_event(j, t_new, t_horizon, M, last_ind, last_time,
                       crossed_ind, crossed_time, crossed);
        bool all_crossed = true;
        for (int m = 0; m < M; ++m) all_crossed = all_crossed && crossed[m];
        if (all_crossed) iscal[1] = 1;   // the advance would change nothing
      }
    }
    __syncthreads();
    if (iscal[1]) break;
    const double dt = scal[1];
    const int j = iscal[0];

    // 2. every lane: closed-form advance, reset, ring kick
    const double e_t = ::exp(-dt);
    for (int i = tid; i < N; i += nthr) {
      const double vi = v[i], si = s[i], bi = b[i];
      const double e_b = ::exp(-bi * dt);
      double vn = vi * e_t + drive * (1.0 - e_t)
                  + si * (e_b - e_t) / (1.0 - bi);
      if (i == j) vn = 0.0;
      const int d = abs(i - j);
      v[i] = vn;
      s[i] = si * e_b + bi * w[min(d, N - d)];
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
    accept_out[row] = all_crossed && iscal[2];
  }
}

// Dynamic shared memory of one CTA; model/evolve_cuda.py::row_fits_shared
// counts the same arrays.
size_t smem_bytes(int N, int M, bool row_in_global) {
  const size_t row = 3 * (size_t)N + (size_t)(N / 2 + 1);
  return ((row_in_global ? 0 : row) + 2 * (size_t)M + 2) * sizeof(double)
         + (3 * (size_t)M + 3) * sizeof(int);
}

template <typename T>
int launch(const void* v0, const void* s0, const void* beta,
           const void* sched, const void* n_sched, const void* init_ind,
           const void* wtab, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* row_scratch, int P, int R, int N, int M, int E, int S,
           int Q, const Consts& c, void* stream) {
  const long long rows = (long long)P * R;
  if (P < 1 || R < 1 || N < 1 || M < 1 || E < 1 || S < 1 || Q < 1
      || rows % S != 0 || P % Q != 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const size_t shmem = smem_bytes(N, M, global);
  auto kernel = global ? replay_kernel<T, true> : replay_kernel<T, false>;
  const int err = set_shared_memory(kernel, shmem);
  if (err != 0) return err;
  const int threads = N >= 256 ? 256 : ((N + 31) / 32) * 32;
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
// device memory for the rows.
#define ATORCH_REPLAY(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* beta,       \
                      const void* sched, const void* n_sched,                 \
                      const void* init_ind, const void* wtab, void* last_ind, \
                      void* last_time, void* crossed_ind, void* crossed_time, \
                      void* accept, void* row_scratch, int P, int R, int N,   \
                      int M, int E, int S,                                    \
                      int Q, int counter_max, double vth, double drive,       \
                      double gap, double t_horizon, double root_tol,          \
                      void* stream) {                                         \
    const Consts c{vth, drive, gap, 0.0, 0.0, 0.0, 0.0, 0.0, t_horizon,      \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, beta, sched, n_sched, init_ind, wtab, last_ind, \
                     last_time, crossed_ind, crossed_time, accept,            \
                     row_scratch, P, R, N, M, E, S, Q, c, stream);            \
  }

ATORCH_REPLAY(atorch_replay_f32, float)
ATORCH_REPLAY(atorch_replay_f64, double)
