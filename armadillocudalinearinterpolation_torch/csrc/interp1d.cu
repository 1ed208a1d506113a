// 1-D linear interpolation on Hopper (sm_90a): three kernels.
//
// Replaces, in armadillocudalinearinterpolation_tpu/ops/interp_pallas.py:
//   lerp1d_kernel         _lerp1d_kernel (:246, K3), lerp1d;
//   lerp1d_sorted_kernel  _lerp1d_sorted_kernel (:138, K4), lerp1d_binned;
//   interp1d_{shared,readonly}_kernel, interp1d_{batch,scatter}_kernel
//                         _interp1d_kernel (:344, K5), both call sites of
//                         make_interp1d (:521 direct, :490 sorted).
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
// - K5: a chain of dependent loads a query (the bucket seed, the seed
//   node for the step-back test, at most S advance steps, the node), so
//   latency, not bytes, held one query a thread at 27% of its bound.  Four
//   bodies, each with several queries a thread whose chains advance
//   together (their loads in flight at once):
//   * direct, "shared" (tables that fit one CTA's shared memory: 4096
//     nodes take 64 KB): one persistent CTA an SM copies a compact form of
//     the tables into shared memory by 16-byte cp.async (the columns xp
//     and fp, 8 B a node, and the bucket map as 16-bit node indices), with
//     its first queries' loads in flight meanwhile, then streams its
//     contiguous range of queries, the next round's loads in flight while
//     one is computed.  Every table load is a shared-memory load, and the
//     chain keeps the x values it loads, so that a query takes five of
//     them (bucket, seed x, x[lo+1], f[lo], f[lo+1]) plus one an advance.
//   * direct, "readonly" (larger tables, up to 65536 nodes: 1 MB of rows):
//     grid-stride over rounds of queries, tables through the read-only
//     path; a packed bucket entry (node index, that node's x) makes the
//     step-back test cost no load of its own.
//   * sorted, "batch": K4's recipe, one CTA a batch of value-sorted
//     queries, results put in shared memory at their id's place and the
//     batch written out in id order, coalesced (the one scatter of the
//     route); pads (ids >= Q) are never written.  Tables through the
//     read-only path, where sorted neighbours share L1 lines.
//   * sorted, "scatter": batches above kBatchStage, grid-stride, each
//     result straight to out[order[i]].
//   ops/interp1d_cuda.py chooses the body (interp1d_body, sorted_body).
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
constexpr int kBatchStage = 12288;   // largest batch K4 and K5 stage (48 KB)
constexpr int kUnroll = 4;           // K4's and K5's queries a thread
constexpr int kSharedThreads = 1024; // K5 shared: one persistent CTA an SM
constexpr int kSharedUnroll = 4;     // its chains a thread, advanced together
constexpr int kReadonlyThreads = 256;   // K5 readonly and scatter
constexpr int kBatchThreads = 256;      // K5 batch
constexpr int kBatchUnroll = 8;         // its queries a thread a round
// K5's body numbers, as ops/interp1d_cuda.py passes them
enum Body { kShared = 0, kReadonly = 1, kBatch = 2, kScatter = 3 };

__device__ __forceinline__ float clamp01(float t) {
  return t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + t * (b - a);
}

// 16 bytes from device to shared memory, in flight until waited for
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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

// ------------------------------------------------------------------ K5

struct Interp1dParams {
  int n, m, S;
  float e0, inv_du, x_lo, x_hi;
};

// The tables in device memory, through the read-only path: nodes[i] =
// (xp[i], xp[i+1], fp[i], fp[i+1]), seeds[k] = (bucket[k], bits of
// xp[bucket[k]]).
struct ReadonlyTables {
  const float4* nodes;
  const int2* seeds;
  __device__ __forceinline__ int seed(int k, float& x) const {
    const int2 e = __ldg(seeds + k);
    x = __int_as_float(e.y);
    return e.x;
  }
  __device__ __forceinline__ int seed_lo(int k) const {
    return __ldg(&seeds[k].x);
  }
  __device__ __forceinline__ float next_x(int lo) const {
    return __ldg(&nodes[lo].y);
  }
  __device__ __forceinline__ float4 row(int lo) const {
    return __ldg(nodes + lo);
  }
};

// U queries' values from their raw values qv on the tables in device
// memory, each chain one step at a time for all U, so that the U loads of
// a step are in flight together.
// The arithmetic of interp1d_plain: clamp to the nodes, the bucket seed,
// one step back if the seed node lies right of the query (the f32 seed can
// overshoot by one near a bucket edge), at most S advance steps (once a
// step fails every later one does), then the blend.
template <int U, typename T>
__device__ __forceinline__ void interp_values(const T& tb,
                                              const Interp1dParams& P,
                                              const float (&qv)[U],
                                              float (&res)[U]) {
  float qc[U], xs[U];
  int k[U], lo[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    qc[u] = qv[u] < P.x_lo ? P.x_lo : (qv[u] > P.x_hi ? P.x_hi : qv[u]);
    k[u] = min(max(__float2int_rz((qc[u] - P.e0) * P.inv_du), 0), P.m - 1);
    lo[u] = tb.seed(k[u], xs[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (xs[u] > qc[u] && k[u] > 0) lo[u] = tb.seed_lo(k[u] - 1);
  bool adv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) adv[u] = true;
  for (int s = 0; s < P.S; ++s) {
    float nx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) nx[u] = adv[u] ? tb.next_x(lo[u]) : 0.f;
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      adv[u] = adv[u] && nx[u] <= qc[u] && lo[u] < P.n - 2;
      lo[u] += adv[u];
      any |= adv[u];
    }
    if (!any) break;
  }
  float4 nd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) nd[u] = tb.row(lo[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float t = clamp01((qc[u] - nd[u].x) / (nd[u].y - nd[u].x));
    res[u] = lerp(nd[u].z, nd[u].w, t);
  }
}

// interp_values on the tables in shared memory, x[i] = xp[i], f[i] =
// fp[i], bk[k] = bucket[k] (separate 4-byte arrays, so that gathers of x
// spread over all 32 banks), with the same arithmetic and fewer loads:
// the seed's x is x0 unless the seed steps back, and the advance keeps
// x[lo] and x[lo+1] as it loads them, so that the blend loads only f.
template <int U>
__device__ __forceinline__ void interp_values_shared(
    const float* __restrict__ x, const float* __restrict__ f,
    const uint16_t* __restrict__ bk, const Interp1dParams& P,
    const float (&qv)[U], float (&res)[U]) {
  float qc[U], x0[U], x1[U];
  int k[U], lo[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    qc[u] = qv[u] < P.x_lo ? P.x_lo : (qv[u] > P.x_hi ? P.x_hi : qv[u]);
    k[u] = min(max(__float2int_rz((qc[u] - P.e0) * P.inv_du), 0), P.m - 1);
    lo[u] = bk[k[u]];
    x0[u] = x[lo[u]];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (x0[u] > qc[u] && k[u] > 0) {
      lo[u] = bk[k[u] - 1];
      x0[u] = x[lo[u]];
    }
    x1[u] = x[lo[u] + 1];
  }
  bool adv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) adv[u] = true;
  for (int s = 0; s < P.S; ++s) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      adv[u] = adv[u] && x1[u] <= qc[u] && lo[u] < P.n - 2;
      if (adv[u]) {
        ++lo[u];
        x0[u] = x1[u];
        x1[u] = x[lo[u] + 1];
      }
      any |= adv[u];
    }
    if (!any) break;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float t = clamp01((qc[u] - x0[u]) / (x1[u] - x0[u]));
    res[u] = lerp(f[lo[u]], f[lo[u] + 1], t);
  }
}

// Direct, "shared": CTA c takes the queries [Q c / G, Q (c+1) / G) in
// rounds of kSharedThreads * kSharedUnroll, query u of a thread at
// threadIdx.x + u * kSharedThreads of the round; the loads of its first
// round are issued before the tables are waited for, and each round
// computed issues the next round's.  Shared memory: x and f (the columns,
// 8n bytes, padded to 16), then bk (2m bytes), copied as they lie in
// device memory.
__global__ void __launch_bounds__(kSharedThreads)
    interp1d_shared_kernel(const float* __restrict__ q,
                           const float* __restrict__ columns,
                           const uint16_t* __restrict__ bucket16,
                           float* __restrict__ out, long long Q,
                           Interp1dParams P) {
  constexpr int U = kSharedUnroll;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t col_bytes = (size_t)P.n * 2 * sizeof(float);
  const size_t col_pad = (col_bytes + 15) / 16 * 16;
  const float* x = reinterpret_cast<const float*>(smem);
  const uint16_t* bk = reinterpret_cast<const uint16_t*>(smem + col_pad);
  // 16-byte copies of both tables; a tail under 16 bytes by plain loads
  const size_t bk_bytes = (size_t)P.m * sizeof(uint16_t);
  const unsigned char* srcs[2] = {
      reinterpret_cast<const unsigned char*>(columns),
      reinterpret_cast<const unsigned char*>(bucket16)};
  const size_t offs[2] = {0, col_pad}, lens[2] = {col_bytes, bk_bytes};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const size_t whole = lens[t] / 16 * 16;
    for (size_t c = threadIdx.x * 16; c < whole; c += kSharedThreads * 16)
      cp_async16(smem + offs[t] + c, srcs[t] + c);
    for (size_t c = whole + threadIdx.x; c < lens[t]; c += kSharedThreads)
      smem[offs[t] + c] = srcs[t][c];
  }
  cp_async_commit();

  const long long lo_q = Q * blockIdx.x / gridDim.x;
  const long long hi_q = Q * (blockIdx.x + 1) / gridDim.x;
  constexpr int round = kSharedThreads * U;
  float qv[U], res[U];
  auto load = [&](long long r0, float (&dst)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = r0 + u * kSharedThreads + threadIdx.x;
      dst[u] = i < hi_q ? __ldg(q + i) : P.x_lo;
    }
  };
  load(lo_q, qv);  // in flight while the tables arrive
  cp_async_wait_all();
  __syncthreads();
  for (long long r0 = lo_q; r0 < hi_q; r0 += round) {
    float qn[U];
    load(r0 + round, qn);  // the next round's loads, in flight meanwhile
    interp_values_shared<U>(x, x + P.n, bk, P, qv, res);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = r0 + u * kSharedThreads + threadIdx.x;
      if (i < hi_q) out[i] = res[u];
      qv[u] = qn[u];
    }
  }
}

// Direct, "readonly": grid-stride over rounds of kReadonlyThreads *
// kUnroll queries.
__global__ void __launch_bounds__(kReadonlyThreads, 4)
    interp1d_readonly_kernel(const float* __restrict__ q,
                             const float4* __restrict__ nodes,
                             const int2* __restrict__ seeds,
                             float* __restrict__ out, long long Q,
                             Interp1dParams P) {
  const ReadonlyTables tb{nodes, seeds};
  constexpr int round = kReadonlyThreads * kUnroll;
  for (long long r0 = (long long)blockIdx.x * round; r0 < Q;
       r0 += (long long)gridDim.x * round) {
    float qv[kUnroll], res[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = r0 + u * kReadonlyThreads + threadIdx.x;
      qv[u] = i < Q ? __ldg(q + i) : P.x_lo;
    }
    interp_values<kUnroll>(tb, P, qv, res);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = r0 + u * kReadonlyThreads + threadIdx.x;
      if (i < Q) out[i] = res[u];
    }
  }
}

// Sorted, "batch": one CTA a batch of Qb <= kBatchStage sorted positions
// (blockIdx.x), as K4: a batch whose ids all lie in its own range (every
// batch of sort_batches) is written out in id order; one holding an id
// outside its range writes each result straight to its id.
__global__ void __launch_bounds__(kBatchThreads, 4)
    interp1d_batch_kernel(const float* __restrict__ qs,
                          const long long* __restrict__ order,
                          const float4* __restrict__ nodes,
                          const int2* __restrict__ seeds,
                          float* __restrict__ out, long long Q, int Qb,
                          Interp1dParams P) {
  extern __shared__ float staged[];  // the batch's results by id - base
  const ReadonlyTables tb{nodes, seeds};
  const long long base = (long long)blockIdx.x * Qb;
  int local = 1;
  for (int k0 = threadIdx.x; k0 < Qb; k0 += kBatchUnroll * kBatchThreads) {
    float qv[kBatchUnroll], res[kBatchUnroll];
    long long id[kBatchUnroll];
#pragma unroll
    for (int u = 0; u < kBatchUnroll; ++u) {
      const int k = k0 + u * kBatchThreads;
      qv[u] = k < Qb ? __ldg(qs + base + k) : P.x_lo;
      id[u] = k < Qb ? __ldg(order + base + k) : -1;
    }
    interp_values<kBatchUnroll>(tb, P, qv, res);
#pragma unroll
    for (int u = 0; u < kBatchUnroll; ++u) {
      if (k0 + u * kBatchThreads >= Qb) continue;
      const long long d = id[u] - base;
      if (d >= 0 && d < Qb) {
        staged[d] = res[u];
      } else {
        local = 0;
        if (id[u] >= 0 && id[u] < Q) out[id[u]] = res[u];
      }
    }
  }
  if (__syncthreads_and(local)) {
    const int n_out = (int)min((long long)Qb, Q - base);  // pads write nothing
    for (int k = threadIdx.x; k < n_out; k += kBatchThreads)
      out[base + k] = staged[k];
    return;
  }
  // this thread's own in-range results, each to its id
  for (int k = threadIdx.x; k < Qb; k += kBatchThreads) {
    const long long d = __ldg(order + base + k) - base;
    if (d >= 0 && d < Qb && base + d < Q) out[base + d] = staged[d];
  }
}

// Sorted, "scatter": grid-stride over the sorted positions, each result to
// out[order[i]] (ids >= Q are pads).
__global__ void __launch_bounds__(kReadonlyThreads, 4)
    interp1d_scatter_kernel(const float* __restrict__ qs,
                            const long long* __restrict__ order,
                            const float4* __restrict__ nodes,
                            const int2* __restrict__ seeds,
                            float* __restrict__ out, long long Q,
                            long long total, Interp1dParams P) {
  const ReadonlyTables tb{nodes, seeds};
  constexpr int round = kReadonlyThreads * kUnroll;
  for (long long r0 = (long long)blockIdx.x * round; r0 < total;
       r0 += (long long)gridDim.x * round) {
    float qv[kUnroll], res[kUnroll];
    long long id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = r0 + u * kReadonlyThreads + threadIdx.x;
      qv[u] = i < total ? __ldg(qs + i) : P.x_lo;
      id[u] = i < total ? __ldg(order + i) : Q;
    }
    interp_values<kUnroll>(tb, P, qv, res);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (id[u] >= 0 && id[u] < Q) out[id[u]] = res[u];
  }
}

// Blocks of a grid-stride launch over `work` items, `per_block` a block:
// enough to fill every SM with `per_sm` blocks, and no more than the work.
int grid_blocks(long long work, int* blocks, int per_block = kThreads,
                int per_sm = kBlocksPerSM) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = (work + per_block - 1) / per_block;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(need < cap ? need : cap);
  return (int)cudaSuccess;
}

// Opt `kernel` in to `shmem` bytes of dynamic shared memory (above 48 KB).
template <typename K>
int opt_in(K kernel, size_t shmem) {
  if (shmem <= 48 * 1024) return (int)cudaSuccess;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (shmem > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
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

// body kShared (tab_a: the columns xp then fp, tab_b: the 16-bit bucket
// map) and kReadonly (tab_a: float4 node rows, tab_b: int2 packed bucket
// entries) take the Q == total queries q in id order and order == NULL;
// kBatch and kScatter (the readonly tables) take total = n_batches * Qb
// sorted values q and their ids order (ids >= Q are pads), kBatch only
// batches of at most kBatchStage.
extern "C" int atorch_interp1d(const void* q, const void* order,
                               const void* tab_a, const void* tab_b,
                               void* out, long long Q, long long total,
                               int n_batches, int n, int m, int S, double e0,
                               double inv_du, double x_lo, double x_hi,
                               int body, void* stream) {
  const bool sorted = body == kBatch || body == kScatter;
  if (Q < 0 || total < Q || n < 2 || m < 1 || S < 0 || body < kShared ||
      body > kScatter || sorted != (order != nullptr) ||
      (!sorted && total != Q) ||
      (sorted && (n_batches < 1 || total % n_batches != 0)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of the shared body's tables; float4 rows and int2
  // entries of the others
  if ((uintptr_t)tab_a % 16 != 0 ||
      (uintptr_t)tab_b % (body == kShared ? 16 : 8) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (Q == 0) return (int)cudaSuccess;
  const Interp1dParams P{n, m, S, (float)e0, (float)inv_du, (float)x_lo,
                         (float)x_hi};
  cudaStream_t s = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const long long* ids = static_cast<const long long*>(order);
  float* o = static_cast<float*>(out);
  int blocks = 0, err = (int)cudaSuccess;
  switch (body) {
    case kShared: {
      const size_t shmem = ((size_t)n * 2 * sizeof(float) + 15) / 16 * 16 +
                           (size_t)m * sizeof(uint16_t);
      int per_sm = 0;
      if ((err = opt_in(interp1d_shared_kernel, shmem)) != cudaSuccess ||
          (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, interp1d_shared_kernel, kSharedThreads, shmem)) !=
              cudaSuccess)
        return err;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      // as many persistent CTAs as fit on the card (each copies the
      // tables once), no more than the rounds of queries
      if ((err = grid_blocks(Q, &blocks, kSharedThreads * kSharedUnroll,
                             per_sm)) != cudaSuccess)
        return err;
      interp1d_shared_kernel<<<blocks, kSharedThreads, shmem, s>>>(
          qf, static_cast<const float*>(tab_a),
          static_cast<const uint16_t*>(tab_b), o, Q, P);
      break;
    }
    case kReadonly:
      if ((err = grid_blocks(Q, &blocks, kReadonlyThreads * kUnroll, 4)) !=
          cudaSuccess)
        return err;
      interp1d_readonly_kernel<<<blocks, kReadonlyThreads, 0, s>>>(
          qf, static_cast<const float4*>(tab_a),
          static_cast<const int2*>(tab_b), o, Q, P);
      break;
    case kBatch: {
      const long long Qb = total / n_batches;
      if (Qb > kBatchStage) return (int)cudaErrorInvalidValue;
      interp1d_batch_kernel<<<(unsigned)n_batches, kBatchThreads,
                              (size_t)Qb * sizeof(float), s>>>(
          qf, ids, static_cast<const float4*>(tab_a),
          static_cast<const int2*>(tab_b), o, Q, (int)Qb, P);
      break;
    }
    default:
      if ((err = grid_blocks(total, &blocks, kReadonlyThreads * kUnroll,
                             4)) != cudaSuccess)
        return err;
      interp1d_scatter_kernel<<<blocks, kReadonlyThreads, 0, s>>>(
          qf, ids, static_cast<const float4*>(tab_a),
          static_cast<const int2*>(tab_b), o, Q, total, P);
  }
  return (int)cudaGetLastError();
}
