// Event-driven ensemble evolve on Hopper (sm_90a), float and double.
//
// Replaces: armadillocudalinearinterpolation_tpu/model/evolve_pallas.py::
// _evolve_kernel, the whole event loop of a block of realisations.  The
// plain PyTorch version of the same function is
// armadillocudalinearinterpolation_torch/model/evolve.py::evolve_ensemble.
//
// What bounds it: each event costs every lane a fire decision (one pow), a
// Newton root-find for the lanes that fire (two exp per step), and the
// advance and ring kick (five exp), so the loop is bound by transcendentals;
// and each event needs one block-wide argmin over (time, index) pairs with
// its __syncthreads before any lane can advance.  A row runs ~400 events one
// after another at N=512, ~3500 at N=4096.
//
// Layout: one CTA per row (one point x one realisation), as in the CUDA
// original's EvolveKernel.  v, s and beta of the row stay in shared memory
// for the whole loop; threads stride over the neurons, so N need not equal
// blockDim.  Rows are independent, so a CTA leaves its loop as soon as its
// own row stops, with no lockstep masking.  The argmin is a warp shuffle on
// (time, index) pairs, then one warp over the per-warp winners: three
// barriers per event.  One thread keeps the row's bookkeeping.
//
// Firing-order log (evolve_pallas.py:148-154,475-482): given a non-null
// `sched`, the bookkeeping thread writes sched[row * E + k] = j for the
// row's event k < E, so the log holds only the lanes the row really fired;
// a row with more than E events keeps counting n_events and logs nothing
// past column E - 1 (the replay rejects it through n_events > E).  The
// wrapper zero-fills the log.
//
// Semantics follow model/events.py and model/evolve.py operation by
// operation (the shared per-lane arithmetic is in events.cuh).

#include <stdint.h>

#include "events.cuh"

namespace {

// A row that has not stopped after this many events is stopped unaccepted
// rather than left to spin: t grows by a nonnegative dt per event, and a
// physical row needs a few thousand.
constexpr int kEventGuard = 1 << 24;

// (time, index) order of torch.argmin: NaN first, then smaller time, then
// lower index.
template <typename T>
__device__ __forceinline__ bool before(T ta, int ia, T tb, int ib) {
  const bool na = isnan(ta), nb = isnan(tb);
  if (na || nb) return na && (!nb || ia < ib);
  return ta < tb || (ta == tb && ia < ib);
}

template <typename T>
__device__ __forceinline__ void warp_argmin(T& t, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ot = __shfl_down_sync(0xffffffffu, t, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (before(ot, oi, t, i)) {
      t = ot;
      i = oi;
    }
  }
}

template <typename T>
__global__ void evolve_kernel(const T* __restrict__ v0,
                              const T* __restrict__ s0,
                              const int* __restrict__ init_ind,
                              const T* __restrict__ beta, int R, int N, int M,
                              Consts c, int* __restrict__ last_ind_out,
                              T* __restrict__ last_time_out,
                              int* __restrict__ crossed_ind_out,
                              T* __restrict__ crossed_time_out,
                              bool* __restrict__ accept_out,
                              int* __restrict__ n_events_out,
                              int* __restrict__ sched, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* v = reinterpret_cast<T*>(smem);
  T* s = v + N;
  T* b = s + N;
  T* last_time = b + N;
  T* crossed_time = last_time + M;
  T* red_t = crossed_time + M;            // 32 per-warp winners
  T* scal = red_t + 32;                   // [0] t, [1] dt
  int* last_ind = reinterpret_cast<int*>(scal + 2);
  int* crossed_ind = last_ind + M;
  int* crossed = crossed_ind + M;
  int* red_i = crossed + M;               // 32
  int* iscal = red_i + 32;                // [0] j, [1] done, [2] n_events

  const int row = blockIdx.x;
  const int p = row / R, r = row % R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane_id = tid & 31, nwarps = (nthr + 31) >> 5;

  for (int i = tid; i < N; i += nthr) {
    v[i] = v0[(size_t)p * N + i];
    s[i] = s0[(size_t)p * N + i];
    b[i] = beta[(size_t)r * N + i];
  }
  const T T_h = T(c.t_horizon), two_T = T(2) * T(c.t_horizon);
  if (tid == 0) {
    for (int m = 0; m < M; ++m) {
      last_ind[m] = crossed_ind[m] = init_ind[(size_t)p * M + m];
      last_time[m] = T(0);
      crossed_time[m] = two_T;
      crossed[m] = 0;
    }
    scal[0] = T(0);
    iscal[1] = 0;
    iscal[2] = 0;
  }
  __syncthreads();

  const T drive = T(c.drive), dx = T(c.dx);
  const T a1 = T(c.a1), a2 = T(c.a2), nb1 = T(c.neg_b1), nb2 = T(c.neg_b2);

  while (!iscal[1]) {
    // 1. every lane proposes its firing time; keep this thread's best
    T bt = T(INFINITY);
    int bi = 0x7fffffff;
    for (int i = tid; i < N; i += nthr) {
      const T ti = event_time(v[i], s[i], b[i], c);
      if (before(ti, i, bt, bi)) {
        bt = ti;
        bi = i;
      }
    }
    // 2. block argmin, lowest index on ties
    warp_argmin(bt, bi);
    if (lane_id == 0) {
      red_t[warp] = bt;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bt = lane_id < nwarps ? red_t[lane_id] : T(INFINITY);
      bi = lane_id < nwarps ? red_i[lane_id] : 0x7fffffff;
      warp_argmin(bt, bi);
      if (lane_id == 0) {
        scal[1] = bt;
        iscal[0] = bi;
      }
    }
    __syncthreads();
    const T dt = scal[1];
    const int j = iscal[0];

    // 3. analytic advance, reset of the firing lane, ring kick
    const T emt = xexp(-dt);
    for (int i = tid; i < N; i += nthr) {
      const T vi = v[i], si = s[i], bi_ = b[i];
      T vn = vi * emt + drive * (T(1) - emt)
             + si * emt / (T(1) - bi_) * (xexp((T(1) - bi_) * dt) - T(1));
      if (i == j) vn = T(0);
      const int d = abs(i - j);
      const T dist = T(min(d, N - d)) * dx;
      const T w = (a1 * xexp(nb1 * dist) - a2 * xexp(nb2 * dist)) * dx;
      v[i] = vn;
      s[i] = si * xexp(-bi_ * dt) + bi_ * w;
    }

    // 4. bookkeeping: nearest trajectory (lowest id on ties), last or
    //    crossed, and the stop test
    if (tid == 0) {
      const T t_new = scal[0] + dt;
      scal[0] = t_new;
      classify_event(j, t_new, T_h, M, last_ind, last_time, crossed_ind,
                     crossed_time, crossed);
      // firing-order log: event k = iscal[2], written before the count moves
      if (sched != nullptr && iscal[2] < E)
        sched[(size_t)row * E + iscal[2]] = j;
      const int nev = iscal[2] + 1;
      iscal[2] = nev;
      bool all_crossed = true;
      for (int m = 0; m < M; ++m) all_crossed = all_crossed && crossed[m];
      iscal[1] = all_crossed || !(t_new < two_T) || nev >= kEventGuard;
    }
    __syncthreads();
  }

  if (tid == 0) {
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) {
      const size_t o = (size_t)row * M + m;
      last_ind_out[o] = last_ind[m];
      last_time_out[o] = last_time[m];
      crossed_ind_out[o] = crossed_ind[m];
      crossed_time_out[o] = crossed_time[m];
      all_crossed = all_crossed && crossed[m];
    }
    accept_out[row] = all_crossed;
    n_events_out[row] = iscal[2];
  }
}

template <typename T>
size_t smem_bytes(int N, int M) {
  return (3 * (size_t)N + 2 * (size_t)M + 32 + 2) * sizeof(T)
         + (3 * (size_t)M + 32 + 3) * sizeof(int);
}

template <typename T>
int launch(const void* v0, const void* s0, const void* init_ind,
           const void* beta, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* n_events, void* sched, int P, int R, int N, int M, int E,
           const Consts& c, void* stream) {
  if (P < 1 || R < 1 || N < 1 || M < 1 || (sched != nullptr && E < 1))
    return (int)cudaErrorInvalidValue;
  const size_t shmem = smem_bytes<T>(N, M);
  const int err = set_shared_memory(evolve_kernel<T>, shmem);
  if (err != 0) return err;
  const int threads = N >= 256 ? 256 : ((N + 31) / 32) * 32;
  const long long rows = (long long)P * R;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  evolve_kernel<T><<<(unsigned)rows, threads, shmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(s0),
      static_cast<const int*>(init_ind), static_cast<const T*>(beta), R, N,
      M, c, static_cast<int*>(last_ind), static_cast<T*>(last_time),
      static_cast<int*>(crossed_ind), static_cast<T*>(crossed_time),
      static_cast<bool*>(accept), static_cast<int*>(n_events),
      static_cast<int*>(sched), E);
  return (int)cudaGetLastError();
}

}  // namespace

#define ATORCH_EVOLVE(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* init_ind,   \
                      const void* beta, void* last_ind, void* last_time,      \
                      void* crossed_ind, void* crossed_time, void* accept,    \
                      void* n_events, void* sched, int P, int R, int N,       \
                      int M, int E, int counter_max, double vth,              \
                      double drive, double gap,                               \
                      double a1, double a2, double b1, double b2, double dx,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, a1, a2, -b1, -b2, dx, t_horizon,          \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, init_ind, beta, last_ind, last_time,             \
                     crossed_ind, crossed_time, accept, n_events, sched, P,   \
                     R, N, M, E, c, stream);                                  \
  }

ATORCH_EVOLVE(atorch_evolve_f32, float)
ATORCH_EVOLVE(atorch_evolve_f64, double)

extern "C" const char* atorch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
