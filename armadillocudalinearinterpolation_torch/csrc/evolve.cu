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
// after another.
//
// Layout: one CTA per row (one point x one realisation), as in the CUDA
// original's EvolveKernel.  v, s and beta of the row stay in shared memory
// for the whole loop; threads stride over the neurons, so N need not equal
// blockDim.  Rows are independent, so a CTA leaves its loop as soon as its
// own row stops, with no lockstep masking.  The argmin is a warp shuffle on
// (time, index) pairs, then one warp over the per-warp winners: three
// barriers per event.  One thread keeps the row's bookkeeping.
//
// Semantics follow model/events.py and model/evolve.py operation by
// operation.  Build without --use_fast_math (it changes exp and pow and
// flushes denormals) and with --fmad=false, so that no multiply-add is fused
// where the plain version rounds twice.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Consts {
  double vth, drive, gap, a1, a2, neg_b1, neg_b2, dx, t_horizon, root_tol;
  int counter_max;
};

// A row that has not stopped after this many events is stopped unaccepted
// rather than left to spin: t grows by a nonnegative dt per event, and a
// physical row needs a few hundred.
constexpr int kEventGuard = 1 << 24;

// The math library's full-precision functions, pinned per type (what
// PyTorch's elementwise kernels call).
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return ::exp(x); }
__device__ __forceinline__ float xpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double xpow(double x, double y) {
  return ::pow(x, y);
}
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return ::fabs(x); }

template <typename T>
__device__ __forceinline__ T membrane_f(T v, T s, T b, T emt, T e1mb,
                                        T drive, T vth) {
  // v0 e^{-t} + I (1 - e^{-t}) + s0 e^{-t} / (1 - b) (e^{(1-b)t} - 1) - vth
  return v * emt + drive * (T(1) - emt) + s * emt / (T(1) - b) * (e1mb - T(1))
         - vth;
}

template <typename T>
__device__ __forceinline__ T membrane_df(T v, T s, T b, T emt, T embt,
                                         T drive) {
  return drive * emt - v * emt + s * emt * embt
         + (s * emt * (embt - T(1))) / (b - T(1));
}

// Next firing time of one lane, |t| + 100 (1 - decision).
template <typename T>
__device__ T event_time(T v, T s, T b, const Consts& c) {
  const T vth = T(c.vth), drive = T(c.drive), gap = T(c.gap);
  const T tol = T(c.root_tol);
  // fire/no-fire decision; pow of a negative base is NaN and NaN compares
  // false, so such a lane does not fire
  const T q = xpow(s / gap, T(1) / b);
  const T rhs = vth * q + drive * (T(1) - q) - gap / (b - T(1)) * (s / gap - q);
  const bool decision = v > rhs;
  // e^{(1-b)t} and e^{-t(b-1)} are the same number, so f and f' share the
  // two exponentials of the current iterate
  T t = T(0);
  T emt = xexp(-t);
  T e1 = xexp((T(1) - b) * t);
  T f = membrane_f(v, s, b, emt, e1, drive, vth) * T(decision ? 1 : 0);
  for (int k = 0; k < c.counter_max && xabs(f) > tol; ++k) {
    const T df = membrane_df(v, s, b, emt, e1, drive);
    t = t - f / df;
    emt = xexp(-t);
    e1 = xexp((T(1) - b) * t);
    f = membrane_f(v, s, b, emt, e1, drive, vth);
  }
  return xabs(t) + T(100) * (T(1) - T(decision ? 1 : 0));
}

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
                              int* __restrict__ n_events_out) {
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
      int mm = 0, dmin = abs(j - last_ind[0]);
      for (int m = 1; m < M; ++m) {
        const int dm = abs(j - last_ind[m]);
        if (dm < dmin) {
          dmin = dm;
          mm = m;
        }
      }
      if (!crossed[mm]) {
        if (t_new > T_h) {
          crossed_time[mm] = t_new;
          crossed_ind[mm] = j;
          crossed[mm] = 1;
        } else {
          last_time[mm] = t_new;
          last_ind[mm] = j;
        }
      }
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
           void* n_events, int P, int R, int N, int M, const Consts& c,
           void* stream) {
  if (P < 1 || R < 1 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const size_t shmem = smem_bytes<T>(N, M);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (shmem > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(evolve_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = N >= 256 ? 256 : ((N + 31) / 32) * 32;
  const long long rows = (long long)P * R;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  evolve_kernel<T><<<(unsigned)rows, threads, shmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(v0), static_cast<const T*>(s0),
      static_cast<const int*>(init_ind), static_cast<const T*>(beta), R, N,
      M, c, static_cast<int*>(last_ind), static_cast<T*>(last_time),
      static_cast<int*>(crossed_ind), static_cast<T*>(crossed_time),
      static_cast<bool*>(accept), static_cast<int*>(n_events));
  return (int)cudaGetLastError();
}

}  // namespace

#define ATORCH_EVOLVE(NAME, T)                                                \
  extern "C" int NAME(const void* v0, const void* s0, const void* init_ind,   \
                      const void* beta, void* last_ind, void* last_time,      \
                      void* crossed_ind, void* crossed_time, void* accept,    \
                      void* n_events, int P, int R, int N, int M,             \
                      int counter_max, double vth, double drive, double gap,  \
                      double a1, double a2, double b1, double b2, double dx,  \
                      double t_horizon, double root_tol, void* stream) {      \
    const Consts c{vth, drive, gap, a1, a2, -b1, -b2, dx, t_horizon,          \
                   root_tol, counter_max};                                    \
    return launch<T>(v0, s0, init_ind, beta, last_ind, last_time,             \
                     crossed_ind, crossed_time, accept, n_events, P, R, N, M, \
                     c, stream);                                              \
  }

ATORCH_EVOLVE(atorch_evolve_f32, float)
ATORCH_EVOLVE(atorch_evolve_f64, double)

extern "C" const char* atorch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
