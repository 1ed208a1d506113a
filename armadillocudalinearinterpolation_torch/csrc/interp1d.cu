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
//   outside, sort_batches: batch b holds the ids [b Qb, (b+1) Qb)).  Both
//   nodes come through the read-only path: sorted neighbours share L1
//   lines where the queries are dense, and where they are sparse (64k
//   nodes, 4096 queries a batch: ~16 nodes apart) a staged node span would
//   read more table than the queries need.  What the sort costs K4 is the
//   scatter of results to their ids, so a batch of at most kBatchStage
//   queries is one CTA: each thread computes kUnroll queries at a time
//   (their loads in flight together), puts each result in shared memory at
//   its id's place in the batch, and the CTA then writes the batch's
//   results in id order, coalesced (a batch holding ids outside its range,
//   which sort_batches never makes, writes each result to its id).  Larger
//   batches take a grid-stride body that writes each result straight to
//   out[id].  Neither needs a restore sort; both take any permutation.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;   // grid-stride kernels: 2048 threads an SM
constexpr int kSortedThreads = 512;  // K4's CTA per batch
constexpr int kBatchStage = 12288;   // largest batch K4 stages (48 KB)
constexpr int kUnroll = 4;           // K4's queries in flight per thread

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

// K3's value of one query
__device__ __forceinline__ float lerp_at(float q, const float* __restrict__ fp,
                                         int n, float x0, float inv_dx) {
  const float u = (q - x0) * inv_dx;
  const int i0 = cell(u, n);
  const float t = clamp01(u - (float)i0);
  return lerp(__ldg(fp + i0), __ldg(fp + i0 + 1), t);
}

__global__ void lerp1d_kernel(const float* __restrict__ q,
                              const float* __restrict__ fp,
                              float* __restrict__ out, long long Q, int n,
                              float x0, float inv_dx) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < Q;
       i += stride)
    out[i] = lerp_at(__ldg(q + i), fp, n, x0, inv_dx);
}

// One CTA per batch of Qb <= kBatchStage sorted queries (blockIdx.x); four
// CTAs an SM, so that the 512 batches of 2M queries run in one wave.
//
// A batch whose ids all lie in its own range (every batch of sort_batches)
// holds exactly that range, since order is a permutation: its results are
// written out in id order, and no other batch writes there.  A batch that
// holds an id outside its range (any other permutation) writes every result
// straight to its id instead, as the grid-stride body does; the one barrier
// tells the CTA which case it is in.
__global__ void __launch_bounds__(kSortedThreads, 4)
    lerp1d_sorted_kernel(const float* __restrict__ qs,
                         const long long* __restrict__ order,
                         const float* __restrict__ fp, float* __restrict__ out,
                         long long Q, int Qb, int n, float x0, float inv_dx) {
  extern __shared__ float res[];  // the batch's results by id - base
  const long long base = (long long)blockIdx.x * Qb;
  int local = 1;
  for (int k0 = threadIdx.x; k0 < Qb; k0 += kUnroll * kSortedThreads) {
    float qv[kUnroll];
    int slot[kUnroll];  // -1: an id outside the batch
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kSortedThreads;
      if (k < Qb) {
        qv[u] = __ldg(qs + base + k);
        const long long d = __ldg(order + base + k) - base;
        slot[u] = d >= 0 && d < Qb ? (int)d : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kSortedThreads;
      if (k >= Qb) continue;
      const float r = lerp_at(qv[u], fp, n, x0, inv_dx);
      if (slot[u] >= 0) {
        res[slot[u]] = r;
      } else {
        local = 0;
        const long long id = __ldg(order + base + k);
        if (id >= 0 && id < Q) out[id] = r;
      }
    }
  }
  if (__syncthreads_and(local)) {
    const int n_out = (int)min((long long)Qb, Q - base);  // pads write nothing
    for (int k = threadIdx.x; k < n_out; k += kSortedThreads)
      out[base + k] = res[k];
    return;
  }
  // this thread's own in-range results, each to its id
  for (int k = threadIdx.x; k < Qb; k += kSortedThreads) {
    const long long slot = __ldg(order + base + k) - base;
    if (slot >= 0 && slot < Qb && base + slot < Q)
      out[base + slot] = res[slot];
  }
}

// Batches above kBatchStage: grid-stride over the sorted positions, each
// result to out[order[i]] (ids >= Q are pads).
__global__ void lerp1d_sorted_direct_kernel(const float* __restrict__ qs,
                                            const long long* __restrict__ order,
                                            const float* __restrict__ fp,
                                            float* __restrict__ out,
                                            long long Q, long long total,
                                            int n, float x0, float inv_dx) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long id = __ldg(order + i);
    if (id < Q) out[id] = lerp_at(__ldg(qs + i), fp, n, x0, inv_dx);
  }
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

// qs and order: n_batches rows of Qb sorted positions, order a permutation
// of [0, n_batches Qb) (sort_batches: row b holds the ids [b Qb, (b+1) Qb),
// the case the staged body writes out coalesced); ids >= Q are pads.
extern "C" int atorch_lerp1d_sorted(const void* qs, const void* order,
                                    const void* fp, void* out, long long Q,
                                    int n_batches, long long Qb, int n,
                                    double x0, double inv_dx, void* stream) {
  if (Q < 0 || n < 2 || n_batches < 1 || Qb < 0 ||
      (long long)n_batches * Qb < Q)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (Qb <= kBatchStage) {
    lerp1d_sorted_kernel<<<(unsigned)n_batches, kSortedThreads,
                           (size_t)Qb * sizeof(float), s>>>(
        static_cast<const float*>(qs), static_cast<const long long*>(order),
        static_cast<const float*>(fp), static_cast<float*>(out), Q, (int)Qb,
        n, (float)x0, (float)inv_dx);
  } else {
    const long long total = (long long)n_batches * Qb;
    int blocks = 0;
    const int err = grid_blocks(total, &blocks);
    if (err != cudaSuccess) return err;
    lerp1d_sorted_direct_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(qs), static_cast<const long long*>(order),
        static_cast<const float*>(fp), static_cast<float*>(out), Q, total, n,
        (float)x0, (float)inv_dx);
  }
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
