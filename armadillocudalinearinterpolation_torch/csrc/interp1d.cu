// 1-D linear interpolation on Hopper (sm_90a): three kernels.
//
// Replaces, in armadillocudalinearinterpolation_tpu/ops/interp_pallas.py:
//   lerp1d_kernel         _lerp1d_kernel (:246, K3), lerp1d;
//   lerp1d_sorted_kernel  _lerp1d_sorted_kernel (:138, K4), lerp1d_binned;
//   interp1d_kernel       _interp1d_kernel (:344, K5), both call sites of
//                         make_interp1d (:490 sorted, :521 direct).
// Their plain PyTorch versions are lerp1d_plain, lerp1d_sorted_plain and
// interp1d_plain in armadillocudalinearinterpolation_torch/ops/
// interp1d_cuda.py.
//
// What bounds them: bytes and latency, not arithmetic.  A query reads one
// f32 and writes one, with two table reads (K3, K4) or a short chain of
// dependent ones (K5: bucket, seed node, S advance steps, the node), for a
// handful of flops.  A table of at most 65536 nodes (256 KB in f32, 1 MB as
// K5's float4 rows) stays in the 50 MB L2, so DRAM sees the query stream
// and the outputs.  The TPU gathers only within a 128-lane vreg, so its
// kernels swept the table chunk by chunk, kept pre-shifted copies of it and
// sorted the queries for locality; the card gathers directly, so:
// - K3: one thread per query, grid-stride; both nodes through the
//   read-only path.
// - K4: K3's function on value-sorted batches (the sort is a PyTorch sort
//   outside).  One CTA per group of kGroup consecutive sorted queries of
//   one batch.  The group's node span [min i0, max i0 + 1] comes from a
//   block min/max over its queries, so it holds for any order; NaN queries
//   and pads take no part (a NaN's result is NaN at any cell).  A span of
//   at most kWindow nodes is staged in shared memory and read there; a
//   wider one (skewed or out-of-range queries) is read from the table in
//   device memory, so every distribution stays exact.  Each result goes
//   straight to out[id]: no restore sort.
// - K5: one thread per query, grid-stride; the bucket seed, the step-back
//   check and at most S advance steps, each one load, then one float4 load
//   of the node row (xp[lo], xp[lo+1], fp[lo], fp[lo+1]).  With an order
//   array it reads sorted values and writes out[order[i]] (the sorted
//   route); the sorted values come from the sort, so no gather of q.
//
// Semantics follow the plain versions operation by operation: u = (q - x0)
// * inv_dx with the f32 limits the host made, a truncating conversion that
// saturates (cvt.rzi: NaN -> 0), clamps written as two comparisons so that
// a NaN stays NaN (as under torch.clamp), IEEE division in K5, and
// f0 + t*(f1 - f0).  Build with --fmad=false and without --use_fast_math,
// so that no multiply-add is fused where the plain version rounds twice.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = kThreads;  // sorted queries per CTA of K4
constexpr int kWindow = 8192;     // nodes K4 stages in shared memory (32 KB)
constexpr int kBlocksPerSM = 8;   // grid-stride kernels: 2048 threads an SM

__device__ __forceinline__ float clamp01(float t) {
  return t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + t * (b - a);
}

// K3's cell: clamp(trunc(u), 0, n-2), the conversion saturating
__device__ __forceinline__ int cell(float u, int n) {
  return min(max(__float2int_rz(u), 0), n - 2);
}

__global__ void lerp1d_kernel(const float* __restrict__ q,
                              const float* __restrict__ fp,
                              float* __restrict__ out, long long Q, int n,
                              float x0, float inv_dx) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < Q;
       i += stride) {
    const float u = (__ldg(q + i) - x0) * inv_dx;
    const int i0 = cell(u, n);
    const float t = clamp01(u - (float)i0);
    out[i] = lerp(__ldg(fp + i0), __ldg(fp + i0 + 1), t);
  }
}

__global__ void __launch_bounds__(kGroup)
    lerp1d_sorted_kernel(const float* __restrict__ qs,
                         const long long* __restrict__ order,
                         const float* __restrict__ fp, float* __restrict__ out,
                         long long Q, long long Qb, int n, float x0,
                         float inv_dx) {
  __shared__ float win[kWindow];
  __shared__ int s_lo, s_hi;
  const long long k = (long long)blockIdx.x * kGroup + threadIdx.x;
  const long long pos = (long long)blockIdx.y * Qb + k;
  float u = 0.f;
  int i0 = 0;
  long long id = Q;  // a position past the batch writes nothing
  if (k < Qb) {
    u = (__ldg(qs + pos) - x0) * inv_dx;
    i0 = cell(u, n);
    id = __ldg(order + pos);
  }
  const bool valid = id < Q && !isnan(u);
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();
  const int lo_w = __reduce_min_sync(0xffffffffu, valid ? i0 : INT_MAX);
  const int hi_w = __reduce_max_sync(0xffffffffu, valid ? i0 : -1);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_lo, lo_w);
    atomicMax(&s_hi, hi_w);
  }
  __syncthreads();
  // the group reads nodes [lo, s_hi + 1]; the same for the whole CTA
  const int lo = s_lo;
  const int span = s_hi + 2 - lo;
  const bool staged = s_hi >= 0 && span <= kWindow;
  if (staged) {
    for (int e = threadIdx.x; e < span; e += kGroup) win[e] = __ldg(fp + lo + e);
    __syncthreads();
  }
  if (id >= Q) return;
  const float t = clamp01(u - (float)i0);
  float f0, f1;
  if (staged) {
    // a NaN query's cell may lie outside the span: keep it in the window
    const int j = min(max(i0 - lo, 0), span - 2);
    f0 = win[j];
    f1 = win[j + 1];
  } else {
    f0 = __ldg(fp + i0);
    f1 = __ldg(fp + i0 + 1);
  }
  out[id] = lerp(f0, f1, t);
}

__global__ void interp1d_kernel(const float* __restrict__ q,
                                const long long* __restrict__ order,
                                const int* __restrict__ bucket,
                                const float4* __restrict__ nodes,
                                float* __restrict__ out, long long Q,
                                long long total, int n, int m, int S, float e0,
                                float inv_du, float x_lo, float x_hi) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long id = order ? __ldg(order + i) : i;
    if (id >= Q) continue;  // a pad of the sorted route
    const float qv = __ldg(q + i);
    const float qc = qv < x_lo ? x_lo : (qv > x_hi ? x_hi : qv);
    int k = min(max(__float2int_rz((qc - e0) * inv_du), 0), m - 1);
    // f32 rounding of (qc - e0) * inv_du can overshoot the bucket by one
    // near an edge: step back if the seed node lies right of the query
    if (__ldg(&nodes[__ldg(bucket + k)].x) > qc && k > 0) k -= 1;
    int lo = __ldg(bucket + k);
    for (int s = 0; s < S; ++s) {  // once a step fails, every later one does
      if (!(__ldg(&nodes[lo].y) <= qc && lo < n - 2)) break;
      ++lo;
    }
    const float4 nd = __ldg(nodes + lo);
    const float t = clamp01((qc - nd.x) / (nd.y - nd.x));
    out[id] = lerp(nd.z, nd.w, t);
  }
}

// Blocks of a grid-stride launch over `work` items: enough to fill every SM.
int grid_blocks(long long work, int* blocks) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  *blocks = (int)(need < cap ? need : cap);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int atorch_lerp1d(const void* q, const void* fp, void* out,
                             long long Q, int n, double x0, double inv_dx,
                             void* stream) {
  if (Q < 0 || n < 2) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  int blocks = 0;
  const int err = grid_blocks(Q, &blocks);
  if (err != cudaSuccess) return err;
  lerp1d_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(fp),
      static_cast<float*>(out), Q, n, (float)x0, (float)inv_dx);
  return (int)cudaGetLastError();
}

// qs and order: n_batches rows of Qb sorted positions; ids >= Q are pads.
extern "C" int atorch_lerp1d_sorted(const void* qs, const void* order,
                                    const void* fp, void* out, long long Q,
                                    int n_batches, long long Qb, int n,
                                    double x0, double inv_dx, void* stream) {
  if (Q < 0 || n < 2 || n_batches < 1 || n_batches > 65535 || Qb < 0 ||
      (long long)n_batches * Qb < Q)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((Qb + kGroup - 1) / kGroup), (unsigned)n_batches);
  lerp1d_sorted_kernel<<<grid, kGroup, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(qs), static_cast<const long long*>(order),
      static_cast<const float*>(fp), static_cast<float*>(out), Q, Qb, n,
      (float)x0, (float)inv_dx);
  return (int)cudaGetLastError();
}

// order == NULL: q holds the Q == total queries in id order.  Otherwise q
// holds total sorted values and order their ids (ids >= Q are pads).
extern "C" int atorch_interp1d(const void* q, const void* order,
                               const void* bucket, const void* nodes,
                               void* out, long long Q, long long total, int n,
                               int m, int S, double e0, double inv_du,
                               double x_lo, double x_hi, void* stream) {
  if (Q < 0 || total < Q || (order == nullptr && total != Q) || n < 2 ||
      m < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)nodes % sizeof(float4) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (Q == 0) return (int)cudaSuccess;
  int blocks = 0;
  const int err = grid_blocks(total, &blocks);
  if (err != cudaSuccess) return err;
  interp1d_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const long long*>(order),
      static_cast<const int*>(bucket), static_cast<const float4*>(nodes),
      static_cast<float*>(out), Q, total, n, m, S, (float)e0, (float)inv_du,
      (float)x_lo, (float)x_hi);
  return (int)cudaGetLastError();
}
