// Event-driven ensemble evolve on Hopper (sm_90a), float and double.
//
// Replaces: armadillocudalinearinterpolation_tpu/model/evolve_pallas.py::
// _evolve_kernel, the whole event loop of a block of realisations, with its
// certified window (select_event_windowed) and firing-order log.  The plain
// PyTorch versions of the same function are
// armadillocudalinearinterpolation_torch/model/evolve.py::evolve_ensemble
// (every lane) and model/evolve_batched.py::evolve_ensemble_batched (the
// window).
//
// What bounds it: each event costs every evaluated lane a fire decision
// (one pow) and a Newton root-find for the lanes that fire (two exp per
// step), and every lane the closed-form advance (two exp); and each event
// needs one block-wide argmin over (time, index) pairs with its
// __syncthreads before any lane can advance.  A row runs ~400 events one
// after another at N=512, ~3500 at N=4096.  So the design cuts the lane
// work per event and keeps the serial part short:
// - the certified window (W > 0): the root-find runs on W lanes from
//   start = (min(last_ind) - pad_b) mod N, cyclically; every other lane
//   only adds its ODE-comparison bound to a block minimum (one division:
//   the bound log(cap - v) - log(cap - vth) is taken as the log of the
//   smallest ratio, one log per row).  If the windowed event time is at
//   most the bound, it is the global event; otherwise the row evaluates
//   every lane for that event, through the same select_full as W = 0.
//   Each CTA owns one row, so the window is anchored per row and moves
//   with it: no persistent rolls, no hysteresis, no block-wide fallback.
// - the kick table: w(d) = (a1 e^{-b1 d dx} - a2 e^{-b2 d dx}) dx for
//   d <= N/2, computed once per row with the very expression the per-lane
//   kick used, so the advance reads it instead of two exp per lane.
//
// Layout: one CTA per row (one point x one realisation), as in the CUDA
// original's EvolveKernel; threads stride over the lanes, so N need not
// equal blockDim.  The row's v, s, beta and kick table (3N + N/2 + 1
// values) stay in shared memory where they fit; where they do not (large
// N), the row keeps them in a (rows, 3N + N/2 + 1) scratch in device memory
// that the wrapper allocates (resident rows x row bytes stays in the 50 MB
// L2), and the same kernel body runs on those pointers.  The argmin is a
// warp shuffle on (time, index) pairs, then one warp over the per-warp
// winners: three barriers per event.  One thread keeps the row's
// bookkeeping.
//
// Firing-order log (evolve_pallas.py:148-154,475-482): given a non-null
// `sched`, the bookkeeping thread writes sched[row * E + k] = j for the
// row's event k < E, so the log holds only the lanes the row really fired;
// a row with more than E events keeps counting n_events and logs nothing
// past column E - 1 (the replay rejects it through n_events > E).  The
// wrapper zero-fills the log.  Given a non-null `times` beside it (the time
// log), the same thread writes the event's dt, as the row took it, in fp64
// at times[row * E + k]: the exact tangent replay reads these times in
// place of its own root-find.
//
// Semantics follow model/events.py, model/evolve.py and
// model/evolve_batched.py operation by operation (the shared per-lane
// arithmetic is in events.cuh).

#include <stdint.h>

#include "events.cuh"

namespace {

// A row that has not stopped after this many events is stopped unaccepted
// rather than left to spin: t grows by a nonnegative dt per event, and a
// physical row needs a few thousand.
constexpr int kEventGuard = 1 << 24;

// slots of the row's shared scalars
constexpr int kT = 0, kDt = 1, kRmin = 2;               // scal[4]
constexpr int kJ = 0, kDone = 1, kEvents = 2, kFallbacks = 3;  // iscal[4]

__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return ::log(x); }

// (time, index) order of torch.argmin: NaN first, then smaller time, then
// lower index.
template <typename T>
__device__ __forceinline__ bool before(T ta, int ia, T tb, int ib) {
  const bool na = isnan(ta), nb = isnan(tb);
  if (na || nb) return na && (!nb || ia < ib);
  return ta < tb || (ta == tb && ia < ib);
}

// torch.amin's minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return isnan(a) ? a : ((isnan(b) || b < a) ? b : a);
}

// torch.maximum against a number that is not NaN: a NaN stays
template <typename T>
__device__ __forceinline__ T nan_max(T x, T lo) {
  return (isnan(x) || x > lo) ? x : lo;
}

template <typename T>
__device__ __forceinline__ void warp_argmin(T& t, int& i, T& r) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ot = __shfl_down_sync(0xffffffffu, t, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    r = nan_min(r, __shfl_down_sync(0xffffffffu, r, off));
    if (before(ot, oi, t, i)) {
      t = ot;
      i = oi;
    }
  }
}

// The out-of-window certificate of one lane as a ratio: its crossing time
// is at least log(ratio) (model/evolve_batched.py::certificate_ratio).
// Between kicks v' <= -v + I + max(s, 0), so with cap = I + max(s, 0) the
// lane cannot reach vth before log((cap - v) / (cap - vth)); never (+inf)
// if cap <= vth; and the bound needs beta > 0 (else ratio 1, bound 0).
template <typename T>
__device__ __forceinline__ T certificate_ratio(T v, T s, T b, T drive, T vth,
                                               T floor) {
  const T cap = drive + nan_max(s, T(0));
  const T denom = cap - vth;
  const T r = denom > T(0) ? nan_max(cap - v, floor) / nan_max(denom, floor)
                           : T(INFINITY);
  return b > T(0) ? r : T(1);
}

// w(d) dx for ring distance d: the expression the per-lane kick computes
template <typename T>
__device__ __forceinline__ T kick_weight(int d, const Consts& c) {
  const T dx = T(c.dx);
  const T dist = T(d) * dx;
  return (T(c.a1) * xexp(T(c.neg_b1) * dist)
          - T(c.a2) * xexp(T(c.neg_b2) * dist)) * dx;
}

// The row's state: v, s, beta and the kick table (shared or device memory)
// and the small shared part.
template <typename T>
struct Row {
  T *v, *s, *b, *w;
  T *last_time, *crossed_time, *red_t, *red_r, *scal;
  int *last_ind, *crossed_ind, *crossed, *red_i, *iscal;
};

// Block-wide (time, index) argmin of the threads' (bt, bi) and NaN-first
// minimum of their r, into scal[kDt], iscal[kJ], scal[kRmin].  Two barriers;
// every thread may read the result after it.
template <typename T>
__device__ void block_select(T bt, int bi, T r, const Row<T>& row) {
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  warp_argmin(bt, bi, r);
  if (lane_id == 0) {
    row.red_t[warp] = bt;
    row.red_i[warp] = bi;
    row.red_r[warp] = r;
  }
  __syncthreads();
  if (warp == 0) {
    bt = lane_id < nwarps ? row.red_t[lane_id] : T(INFINITY);
    bi = lane_id < nwarps ? row.red_i[lane_id] : 0x7fffffff;
    r = lane_id < nwarps ? row.red_r[lane_id] : T(INFINITY);
    warp_argmin(bt, bi, r);
    if (lane_id == 0) {
      row.scal[kDt] = bt;
      row.iscal[kJ] = bi;
      row.scal[kRmin] = r;
    }
  }
  __syncthreads();
}

// The event over every lane: each lane proposes its firing time, lowest
// index on ties.  The whole event of W = 0 and the fallback of W > 0.
template <typename T>
__device__ void select_full(const Row<T>& row, int N, const Consts& c) {
  T bt = T(INFINITY);
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const T ti = event_time(row.v[i], row.s[i], row.b[i], c);
    if (before(ti, i, bt, bi)) {
      bt = ti;
      bi = i;
    }
  }
  block_select(bt, bi, T(INFINITY), row);
}

// The event over the window of W lanes from start (cyclic), certified by
// the other lanes' bound; falls back to select_full.
template <typename T>
__device__ void select_windowed(const Row<T>& row, int N, int M, int W,
                                int pad_b, const Consts& c) {
  int lo = row.last_ind[0];
  for (int m = 1; m < M; ++m) lo = min(lo, row.last_ind[m]);
  int start = (lo - pad_b) % N;
  if (start < 0) start += N;
  T bt = T(INFINITY);
  int bi = 0x7fffffff;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    int i = start + k;
    if (i >= N) i -= N;
    const T ti = event_time(row.v[i], row.s[i], row.b[i], c);
    if (before(ti, i, bt, bi)) {
      bt = ti;
      bi = i;
    }
  }
  const T drive = T(c.drive), vth = T(c.vth);
  const T floor = sizeof(T) == 8 ? T(1e-300) : T(1e-30);
  T r = T(INFINITY);
  for (int k = threadIdx.x; k < N - W; k += blockDim.x) {
    int i = start + W + k;
    if (i >= N) i -= N;
    r = nan_min(r, certificate_ratio(row.v[i], row.s[i], row.b[i], drive,
                                     vth, floor));
  }
  block_select(bt, bi, r, row);
  // the same values for every thread: the branch is block-uniform.  A NaN
  // bound fails (the full pass would put a NaN time first).
  if (!(row.scal[kDt] <= xlog(row.scal[kRmin]))) {
    select_full(row, N, c);
    if (threadIdx.x == 0) row.iscal[kFallbacks] += 1;
  }
}

// Elements of a row's v, s, beta and kick table.
__host__ __device__ __forceinline__ size_t row_elems(int N) {
  return 3 * (size_t)N + (size_t)(N / 2 + 1);
}

template <typename T, bool kRowInGlobal>
__global__ void evolve_kernel(const T* __restrict__ v0,
                              const T* __restrict__ s0,
                              const int* __restrict__ init_ind,
                              const T* __restrict__ beta, int R, int N, int M,
                              int W, int pad_b, int beta_per_row, Consts c,
                              int* __restrict__ last_ind_out,
                              T* __restrict__ last_time_out,
                              int* __restrict__ crossed_ind_out,
                              T* __restrict__ crossed_time_out,
                              bool* __restrict__ accept_out,
                              int* __restrict__ n_events_out,
                              int* __restrict__ sched, int E,
                              double* __restrict__ times,
                              T* __restrict__ row_scratch,
                              int* __restrict__ fallbacks_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_id = blockIdx.x;
  T* big = kRowInGlobal ? row_scratch + (size_t)row_id * row_elems(N)
                        : reinterpret_cast<T*>(smem);
  T* small = kRowInGlobal ? reinterpret_cast<T*>(smem) : big + row_elems(N);
  Row<T> row;
  row.v = big;
  row.s = row.v + N;
  row.b = row.s + N;
  row.w = row.b + N;                       // N/2 + 1 kick weights
  row.last_time = small;
  row.crossed_time = row.last_time + M;
  row.red_t = row.crossed_time + M;        // 32 per-warp winners
  row.red_r = row.red_t + 32;              // 32 per-warp bounds
  row.scal = row.red_r + 32;               // [kT] t, [kDt] dt, [kRmin]
  row.last_ind = reinterpret_cast<int*>(row.scal + 4);
  row.crossed_ind = row.last_ind + M;
  row.crossed = row.crossed_ind + M;
  row.red_i = row.crossed + M;             // 32
  row.iscal = row.red_i + 32;              // [kJ], [kDone], [kEvents], ...

  const int p = row_id / R, r = row_id % R;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int i = tid; i < N; i += nthr) {
    row.v[i] = v0[(size_t)p * N + i];
    row.s[i] = s0[(size_t)p * N + i];
    row.b[i] = beta[(size_t)(beta_per_row ? row_id : r) * N + i];
  }
  for (int d = tid; d <= N / 2; d += nthr) row.w[d] = kick_weight<T>(d, c);
  const T T_h = T(c.t_horizon), two_T = T(2) * T(c.t_horizon);
  if (tid == 0) {
    for (int m = 0; m < M; ++m) {
      row.last_ind[m] = row.crossed_ind[m] = init_ind[(size_t)p * M + m];
      row.last_time[m] = T(0);
      row.crossed_time[m] = two_T;
      row.crossed[m] = 0;
    }
    row.scal[kT] = T(0);
    row.iscal[kDone] = 0;
    row.iscal[kEvents] = 0;
    row.iscal[kFallbacks] = 0;
  }
  __syncthreads();

  const T drive = T(c.drive);
  while (!row.iscal[kDone]) {
    // 1-2. the row's event (dt, j): lowest index on ties
    if (W > 0)
      select_windowed(row, N, M, W, pad_b, c);
    else
      select_full(row, N, c);
    const T dt = row.scal[kDt];
    const int j = row.iscal[kJ];

    // 3. analytic advance, reset of the firing lane, ring kick
    const T emt = xexp(-dt);
    for (int i = tid; i < N; i += nthr) {
      const T vi = row.v[i], si = row.s[i], bi_ = row.b[i];
      T vn = vi * emt + drive * (T(1) - emt)
             + si * emt / (T(1) - bi_) * (xexp((T(1) - bi_) * dt) - T(1));
      if (i == j) vn = T(0);
      const int d = abs(i - j);
      row.v[i] = vn;
      row.s[i] = si * xexp(-bi_ * dt) + bi_ * row.w[min(d, N - d)];
    }

    // 4. bookkeeping: nearest trajectory (lowest id on ties), last or
    //    crossed, and the stop test
    if (tid == 0) {
      const T t_new = row.scal[kT] + dt;
      row.scal[kT] = t_new;
      classify_event(j, t_new, T_h, M, row.last_ind, row.last_time,
                     row.crossed_ind, row.crossed_time, row.crossed);
      // firing-order log: event k = iscal[kEvents], written before the
      // count moves
      const int k = row.iscal[kEvents];
      if (sched != nullptr && k < E) sched[(size_t)row_id * E + k] = j;
      if (times != nullptr && k < E) times[(size_t)row_id * E + k] = dt;
      const int nev = k + 1;
      row.iscal[kEvents] = nev;
      bool all_crossed = true;
      for (int m = 0; m < M; ++m) all_crossed = all_crossed && row.crossed[m];
      row.iscal[kDone] = all_crossed || !(t_new < two_T) || nev >= kEventGuard;
    }
    __syncthreads();
  }

  if (tid == 0) {
    bool all_crossed = true;
    for (int m = 0; m < M; ++m) {
      const size_t o = (size_t)row_id * M + m;
      last_ind_out[o] = row.last_ind[m];
      last_time_out[o] = row.last_time[m];
      crossed_ind_out[o] = row.crossed_ind[m];
      crossed_time_out[o] = row.crossed_time[m];
      all_crossed = all_crossed && row.crossed[m];
    }
    accept_out[row_id] = all_crossed;
    n_events_out[row_id] = row.iscal[kEvents];
    if (fallbacks_out != nullptr)
      fallbacks_out[row_id] = row.iscal[kFallbacks];
  }
}

// Dynamic shared memory of one CTA; model/evolve_cuda.py::row_fits_shared
// counts the same arrays.
template <typename T>
size_t smem_bytes(int N, int M, bool row_in_global) {
  const size_t small = (2 * (size_t)M + 32 + 32 + 4) * sizeof(T)
                       + (3 * (size_t)M + 32 + 4) * sizeof(int);
  return small + (row_in_global ? 0 : row_elems(N) * sizeof(T));
}

template <typename T>
int launch(const void* v0, const void* s0, const void* init_ind,
           const void* beta, void* last_ind, void* last_time,
           void* crossed_ind, void* crossed_time, void* accept,
           void* n_events, void* sched, void* times, void* row_scratch,
           void* fallbacks,
           int P, int R, int N, int M, int E, int W, int pad_b,
           int beta_per_row, int threads, const Consts& c, void* stream) {
  if (P < 1 || R < 1 || N < 1 || M < 1 || (sched != nullptr && E < 1) ||
      (times != nullptr && sched == nullptr) ||
      W < 0 || W >= N || pad_b < 0 || pad_b >= N || threads < 32 ||
      threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const bool global = row_scratch != nullptr;
  const size_t shmem = smem_bytes<T>(N, M, global);
  auto kernel = global ? evolve_kernel<T, true> : evolve_kernel<T, false>;
  const int err = set_shared_memory(kernel, shmem);
  if (err != 0) return err;
  const long long rows = (long long)P * R;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)rows, threads, shmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(s0),
      static_cast<const int*>(init_ind), static_cast<const T*>(beta), R, N,
      M, W, pad_b, beta_per_row, c, static_cast<int*>(last_ind),
      static_cast<T*>(last_time), static_cast<int*>(crossed_ind),
      static_cast<T*>(crossed_time), static_cast<bool*>(accept),
      static_cast<int*>(n_events), static_cast<int*>(sched), E,
      static_cast<double*>(times), static_cast<T*>(row_scratch),
      static_cast<int*>(fallbacks));
  return (int)cudaGetLastError();
}

}  // namespace

// times: NULL, or P*R*E doubles beside a non-null sched (the time log).
// row_scratch: NULL keeps each row in shared memory; else P*R*(3N + N/2 +
// 1) values of device memory for the rows.  W = 0: every lane; else the
// certified window of W lanes, anchored pad_b lanes before the row's
// lowest tracked index.  fallbacks: NULL, or P*R ints, each row's count of
// windowed events that fell back to every lane.  beta_per_row: 0 = beta is
// (R, N), shared by the P points; 1 = (P*R, N), one row of rates per row.
// threads: the CTA's threads, a multiple of 32 up to 1024.
#define ATORCH_EVOLVE(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* init_ind,   \
                      const void* beta, void* last_ind, void* last_time,      \
                      void* crossed_ind, void* crossed_time, void* accept,    \
                      void* n_events, void* sched, void* times,               \
                      void* row_scratch, void* fallbacks, int P, int R,       \
                      int N, int M, int E,                                    \
                      int W, int pad_b, int beta_per_row, int threads,        \
                      int counter_max,                                        \
                      double vth, double drive, double gap,                   \
                      double a1, double a2, double b1, double b2, double dx,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, a1, a2, -b1, -b2, dx, t_horizon,          \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, init_ind, beta, last_ind, last_time,             \
                     crossed_ind, crossed_time, accept, n_events, sched,      \
                     times, row_scratch, fallbacks, P, R, N, M, E, W, pad_b,  \
                     beta_per_row, threads, c, stream);                       \
  }

ATORCH_EVOLVE(atorch_evolve_f32, float)
ATORCH_EVOLVE(atorch_evolve_f64, double)

extern "C" const char* atorch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
