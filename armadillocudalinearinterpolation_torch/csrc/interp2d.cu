// Batched 2-D bilinear interpolation on Hopper (sm_90a): three kernels.
//
// Replaces, in armadillocudalinearinterpolation_tpu/ops/interp_pallas.py:
//   bilinear_gather_kernel<float, G>  _bilinear_kernel2 (:871, K7), the
//                                     method="full" path;
//   bilinear_binned_kernel<G>         _bilinear_binned_kernel (:670, K8), the
//                                     method="binned" path;
//   bilinear_gather_kernel<double, .> _gather8_kernel (:556, K6) and the f64
//                                     blend after it (:652-661),
//                                     bilinear_batched_f64.
// Their plain PyTorch versions are gather_plain, binned_plain and f64_plain
// in armadillocudalinearinterpolation_torch/ops/interp_cuda.py.
//
// What bounds them: bytes and latency, not arithmetic.  A query reads its
// (row, col) pair (8 B; 16 B in f64), four grid corners, and writes one
// value, for about twenty flops.  The TPU has no fast gather, so its
// kernels turned the lookup into tent-weight matmuls (with bf16 hi/lo
// splits for f32 accuracy, hi/lo f32 tables for f64, query sub-tiling, and
// sorts around the binned kernel).  The card gathers from L2 and shared
// memory directly, so none of that is carried over:
// - gather: one thread per query, blocks over (Q, B).  The pair is one
//   vector load; the corners come from the grid in device memory.  At
//   config 2 (64 grids of 256x256 f32, 16.8 MB) every grid sits in the
//   50 MB L2, so the corner loads mostly hit L2 and DRAM sees the query
//   stream and one pass over the grids.
// - binned: one CTA per (grid, bin).  It stages its bin's
//   (be_r+1) x (be_c+1) window (at most 121 x 121 f32, 58 KB: dynamic shared
//   memory above 48 KB by opt-in) once, then loops over however many
//   queries the bin holds -- no capacity, so every query stays exact even
//   if all of them fall in one bin -- and writes each result straight to
//   out[b, qid], so no restore sort is needed.  The bin order comes from a
//   plain PyTorch sort outside (interp_cuda.bin_queries).
// - f64: the gather kernel in double throughout (native fp64).
// precision="bf16" hands the f32 kernels a bf16 copy of the grid (the top
// 16 bits of each f32, masked): half the grid bytes; the blend stays f32.
//
// Semantics follow ops/interp.py operation by operation: clamp (NaN stays
// NaN, as in torch.clamp), floor, corner clamped to [0, H-2] x [0, W-2],
// fractions, then lerp(g00, g01, tc), lerp(g10, g11, tc), lerp(top, bot, tr).
// Build with --fmad=false and without --use_fast_math, so that no
// multiply-add is fused where the plain version rounds twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int floor_int(float x) { return (int)floorf(x); }
__device__ __forceinline__ int floor_int(double x) { return (int)::floor(x); }

__device__ __forceinline__ float load_grid(const float* g, size_t i) {
  return __ldg(g + i);
}
__device__ __forceinline__ float load_grid(const uint16_t* g, size_t i) {
  return __uint_as_float((unsigned)__ldg(g + i) << 16);
}
__device__ __forceinline__ double load_grid(const double* g, size_t i) {
  return __ldg(g + i);
}

template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T t) {
  return a + t * (b - a);
}

// Upper-left corner (r0, c0) and fractions (tr, tc) of a query.
template <typename T>
struct Corner {
  int r0, c0;
  T tr, tc;
};

template <typename T>
__device__ __forceinline__ Corner<T> corner(T pr, T pc, int H, int W) {
  const T r = clampv(pr, T(0), T(H - 1));
  const T c = clampv(pc, T(0), T(W - 1));
  Corner<T> k;
  k.r0 = min(max(floor_int(r), 0), H - 2);
  k.c0 = min(max(floor_int(c), 0), W - 2);
  k.tr = r - T(k.r0);
  k.tc = c - T(k.c0);
  return k;
}

template <typename T, typename G>
__global__ void bilinear_gather_kernel(
    const typename Pair<T>::type* __restrict__ pts, const G* __restrict__ grids,
    T* __restrict__ out, int Q, int H, int W) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const size_t i = (size_t)blockIdx.y * Q + q;
  const typename Pair<T>::type p = pts[i];
  const Corner<T> k = corner(p.x, p.y, H, W);
  const G* g = grids + (size_t)blockIdx.y * H * W + (size_t)k.r0 * W + k.c0;
  const T g00 = load_grid(g, 0), g01 = load_grid(g, 1);
  const T g10 = load_grid(g, W), g11 = load_grid(g, (size_t)W + 1);
  const T top = lerp(g00, g01, k.tc);
  const T bot = lerp(g10, g11, k.tc);
  out[i] = lerp(top, bot, k.tr);
}

template <typename G>
__global__ void bilinear_binned_kernel(
    const float2* __restrict__ pts, const G* __restrict__ grids,
    const long long* __restrict__ order, const long long* __restrict__ offsets,
    float* __restrict__ out, int Q, int H, int W, int nbins, int nbc, int be_r,
    int be_c) {
  extern __shared__ float win[];
  const int bin = blockIdx.x, b = blockIdx.y;
  const long long lo = offsets[(size_t)b * (nbins + 1) + bin];
  const long long hi = offsets[(size_t)b * (nbins + 1) + bin + 1];
  if (lo >= hi) return;  // empty bin; the same for the whole CTA
  const int rb = (bin / nbc) * be_r, cb = (bin % nbc) * be_c;
  const int wc = be_c + 1, n_win = (be_r + 1) * wc;
  const G* g = grids + (size_t)b * H * W;
  // nodes past the grid's last row or column are never read by a query
  for (int e = threadIdx.x; e < n_win; e += blockDim.x) {
    const int gr = rb + e / wc, gc = cb + e % wc;
    win[e] = (gr < H && gc < W) ? load_grid(g, (size_t)gr * W + gc) : 0.f;
  }
  __syncthreads();
  const long long* ord = order + (size_t)b * Q;
  for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const size_t i = (size_t)b * Q + (size_t)ord[k];
    const float2 p = pts[i];
    const Corner<float> c = corner(p.x, p.y, H, W);
    // corner relative to the window; the clamp only keeps a query binned
    // elsewhere (a NaN coordinate) inside shared memory
    const int lr = min(max(c.r0 - rb, 0), be_r - 1);
    const int lc = min(max(c.c0 - cb, 0), be_c - 1);
    const float* w = win + lr * wc + lc;
    const float top = lerp(w[0], w[1], c.tc);
    const float bot = lerp(w[wc], w[wc + 1], c.tc);
    out[i] = lerp(top, bot, c.tr);
  }
}

int check_common(const void* pts, size_t pair_bytes, int B, int Q, int H,
                 int W) {
  if (B < 0 || Q < 0 || H < 2 || W < 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)pts % pair_bytes != 0) return (int)cudaErrorMisalignedAddress;
  return (int)cudaSuccess;
}

template <typename T, typename G>
int launch_gather(const void* pts, const void* grids, void* out, int B, int Q,
                  int H, int W, void* stream) {
  using P = typename Pair<T>::type;
  const int err = check_common(pts, sizeof(P), B, Q, H, W);
  if (err != cudaSuccess || B == 0 || Q == 0) return err;
  const dim3 grid((unsigned)(((long long)Q + kThreads - 1) / kThreads),
                  (unsigned)B);
  bilinear_gather_kernel<T, G><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const P*>(pts), static_cast<const G*>(grids),
      static_cast<T*>(out), Q, H, W);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_binned(const void* pts, const void* grids, const void* order,
                  const void* offsets, void* out, int B, int Q, int H, int W,
                  int nbins, int nbc, int be_r, int be_c, void* stream) {
  int err = check_common(pts, sizeof(float2), B, Q, H, W);
  if (err != cudaSuccess) return err;
  if (nbins < 1 || nbc < 1 || be_r < 1 || be_c < 1 || nbins % nbc != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return (int)cudaSuccess;
  const size_t shmem = (size_t)(be_r + 1) * (be_c + 1) * sizeof(float);
  int dev = 0, max_optin = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = (int)cudaDeviceGetAttribute(
      &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (shmem > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(bilinear_binned_kernel<G>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)shmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)nbins, (unsigned)B);
  bilinear_binned_kernel<G><<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(pts), static_cast<const G*>(grids),
      static_cast<const long long*>(order),
      static_cast<const long long*>(offsets), static_cast<float*>(out), Q, H,
      W, nbins, nbc, be_r, be_c);
  return (int)cudaGetLastError();
}

}  // namespace

// grid_bf16 != 0: grids holds the bf16 copy (uint16 bit patterns).
extern "C" int atorch_bilinear_gather(const void* pts, const void* grids,
                                      void* out, int B, int Q, int H, int W,
                                      int grid_bf16, void* stream) {
  return grid_bf16
             ? launch_gather<float, uint16_t>(pts, grids, out, B, Q, H, W,
                                              stream)
             : launch_gather<float, float>(pts, grids, out, B, Q, H, W,
                                           stream);
}

extern "C" int atorch_bilinear_binned(const void* pts, const void* grids,
                                      const void* order, const void* offsets,
                                      void* out, int B, int Q, int H, int W,
                                      int nbins, int nbc, int be_r, int be_c,
                                      int grid_bf16, void* stream) {
  return grid_bf16
             ? launch_binned<uint16_t>(pts, grids, order, offsets, out, B, Q,
                                       H, W, nbins, nbc, be_r, be_c, stream)
             : launch_binned<float>(pts, grids, order, offsets, out, B, Q, H,
                                    W, nbins, nbc, be_r, be_c, stream);
}

extern "C" int atorch_bilinear_f64(const void* pts, const void* grids,
                                   void* out, int B, int Q, int H, int W,
                                   void* stream) {
  return launch_gather<double, double>(pts, grids, out, B, Q, H, W, stream);
}
