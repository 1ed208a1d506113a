// Batched 2-D bilinear interpolation on Hopper (sm_90a).
//
// Replaces, in armadillocudalinearinterpolation_tpu/ops/interp_pallas.py:
//   bilinear_staged_kernel<G>,        _bilinear_kernel2 (:871, K7), the
//   bilinear_gather_kernel<float, G>  method="full" path;
//   bin_{count,scan,scatter}_kernel   the sorts and searchsorted around the
//                                     binned kernel (:779-797);
//   bilinear_binned_kernel<G, async>  _bilinear_binned_kernel (:670, K8), the
//                                     method="binned" path;
//   bilinear_f64_kernel               _gather8_kernel (:556, K6) and the f64
//                                     blend after it (:652-661),
//                                     bilinear_batched_f64.
// Their plain PyTorch versions are gather_plain, bin_queries, binned_plain
// and f64_plain in armadillocudalinearinterpolation_torch/ops/interp_cuda.py.
//
// What bounds them: bytes and latency, not arithmetic.  A query reads its
// (row, col) pair (8 B; 16 B in f64), four grid corners, and writes one
// value, for about twenty flops.  The TPU has no fast gather, so its
// kernels turned the lookup into tent-weight matmuls; the card gathers from
// shared memory and L2 directly:
// - K7 staged: one to a few CTAs per grid.  Each copies a band of the
//   grid's rows plus one halo row into its shared memory (16-byte cp.async
//   copies by every thread) while its threads load the grid's pairs, two
//   per 16-byte load, and computes the queries whose corner row it holds:
//   the grid is read once, coalesced, and every corner comes from local
//   shared memory.  A cluster of CTAs that gathered the corners of every
//   query from the owner's band through distributed shared memory was the
//   first design; it took 33.4 us against 13.4 us for this one at config 2
//   (PERF.md, PR 5), the remote reads being the cost.
// - K7 direct: one thread per query, corners from device memory (L2).  The
//   shapes where staging does not pay take it (ops/interp_cuda.py routes
//   by shape).
// - binning: a counting sort in three kernels.  Per block of 2048 queries a
//   shared-memory histogram of bins; a scan per grid over (block, bin) gives
//   each block its slots; a scatter writes each query's int32 id and its
//   (row, col) pair to its slot.  The order inside a bin is not stable: each
//   result goes to its own id and depends only on its pair and its window.
// - K8: persistent CTAs (as many as fit on the card) walk the (grid, bin)
//   items.  Each CTA holds two window buffers; 16-byte cp.async copies bring
//   the next bin's (be_r+1) x (be_c+1) window (nodes past the grid filled
//   with 0) while the current bin's queries, contiguous in bin order, are
//   computed.  Where a grid row is not a whole multiple of 16 bytes, the
//   threads load the window with plain loads instead.  No capacity: a bin
//   of any size stays exact.  A TMA tiled copy (a 3-D tensor map over
//   (B, H, W)) was the first design; on the card it stopped with an illegal
//   instruction in every form tried (PERF.md, PR 5), so it is not used.
// - f64 (K6): the gather in double throughout (native fp64), several
//   queries a thread: a thread loads its kF64Queries pairs, then all their
//   corners, then blends, so that every load of those queries is in flight
//   together, and an eighth as many CTAs as one thread a query run.  A
//   corner pair (c0, c0 + 1) that starts on a 16-byte boundary comes in
//   one 16-byte load, otherwise in two 8-byte loads.  Its call is cheap on
//   the host too: ops/interp_cuda.py checks the common case in one test
//   and calls this file's entry point, bound once, with nothing but the
//   pointers, the sizes and the stream.
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

#include <algorithm>

namespace {

constexpr int kThreads = 256;         // direct gather and binning
constexpr int kBinChunk = 8;          // queries per thread in the binning
constexpr int kStagedThreads = 1024;  // staged gather
constexpr int kStagedVecs = 4;        // 16-byte pair loads per thread a round
constexpr int kBinnedThreads = 512;   // K8
constexpr int kMaxBands = 8;          // bands of a grid in the staged body
constexpr int kMaxParts = 8;          // query parts of a grid in it
constexpr int kF64Threads = 256;      // K6
constexpr int kF64Queries = 8;        // K6's queries a thread, loads together

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int floor_int(float x) { return (int)floorf(x); }
__device__ __forceinline__ int floor_int(double x) { return (int)::floor(x); }

// a grid value as the blend's type: f32, or the bf16 copy's top 16 bits
__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ float value(uint16_t v) {
  return __uint_as_float((unsigned)v << 16);
}

template <typename G>
__device__ __forceinline__ G load_raw(const G* g, size_t i) {
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

// The blend of a query whose corner g00 sits at e, in rows of `pitch`.
template <typename T, typename G>
__device__ __forceinline__ T blend_at(const G* e, int pitch,
                                      const Corner<T>& k) {
  const T top = lerp(T(value(e[0])), T(value(e[1])), k.tc);
  const T bot = lerp(T(value(e[pitch])), T(value(e[pitch + 1])), k.tc);
  return lerp(top, bot, k.tr);
}

// ---------------------------------------------------- asynchronous copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from device to shared memory, in flight until waited for;
// in == false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// all but the most recent group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// ---------------------------------------------------- K7: direct gather

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
  const T g00 = value(load_raw(g, 0)), g01 = value(load_raw(g, 1));
  const T g10 = value(load_raw(g, W)), g11 = value(load_raw(g, (size_t)W + 1));
  const T top = lerp(g00, g01, k.tc);
  const T bot = lerp(g10, g11, k.tc);
  out[i] = lerp(top, bot, k.tr);
}

// ---------------------------------------------------------- K6: f64

// g[0] and g[1]: one 16-byte load where g sits on a 16-byte boundary
__device__ __forceinline__ void corner_pair(const double* g, double& a,
                                            double& b) {
  if (((uintptr_t)g & 15) == 0) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(g));
    a = v.x;
    b = v.y;
  } else {
    a = __ldg(g);
    b = __ldg(g + 1);
  }
}

// Grid blockIdx.y, queries [blockIdx.x * kF64Threads * kF64Queries, +that):
// query u of a thread is threadIdx.x + u * kF64Threads of the block's
// range, so that each round of pair loads and stores is coalesced.
__global__ void __launch_bounds__(kF64Threads)
    bilinear_f64_kernel(const double2* __restrict__ pts,
                        const double* __restrict__ grids,
                        double* __restrict__ out, int Q, int H, int W) {
  const size_t b = blockIdx.y;
  const long long q0 =
      (long long)blockIdx.x * (kF64Threads * kF64Queries) + threadIdx.x;
  const double* g = grids + b * H * W;
  double2 p[kF64Queries];
#pragma unroll
  for (int u = 0; u < kF64Queries; ++u) {
    const long long q = q0 + u * kF64Threads;
    if (q < Q) p[u] = pts[b * Q + q];
  }
  Corner<double> k[kF64Queries];
  double g00[kF64Queries], g01[kF64Queries], g10[kF64Queries],
      g11[kF64Queries];
#pragma unroll
  for (int u = 0; u < kF64Queries; ++u) {
    if (q0 + u * kF64Threads >= Q) continue;
    k[u] = corner(p[u].x, p[u].y, H, W);
    const double* e = g + (size_t)k[u].r0 * W + k[u].c0;
    corner_pair(e, g00[u], g01[u]);
    corner_pair(e + W, g10[u], g11[u]);
  }
#pragma unroll
  for (int u = 0; u < kF64Queries; ++u) {
    const long long q = q0 + u * kF64Threads;
    if (q >= Q) continue;
    const double top = lerp(g00[u], g01[u], k[u].tc);
    const double bot = lerp(g10[u], g11[u], k[u].tc);
    out[b * Q + q] = lerp(top, bot, k[u].tr);
  }
}

// ---------------------------------------------------- K7: staged gather

// CTAs (bands x parts) per grid (blockIdx.y).  CTA x holds the rows of band
// x % bands, [band * rows, band * rows + rows + 1), in shared memory, reads
// the grid's queries of part x / bands and computes those whose corner row
// r0 its band owns (the last band owns every row from its first on).  The
// band sits `lead` bytes into the buffer, so that its 16-byte boundaries
// fall where the device memory's do.
template <typename G>
__global__ void __launch_bounds__(kStagedThreads)
    bilinear_staged_kernel(const float2* __restrict__ pts,
                           const G* __restrict__ grids,
                           float* __restrict__ out, int Q, int H, int W,
                           int rows, int bands) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int band_id = blockIdx.x % bands, part = blockIdx.x / bands;
  const int parts = gridDim.x / bands;
  const int b = blockIdx.y;
  const int r_lo = band_id * rows;
  const int r_hi = min(H, r_lo + rows + 1);
  // corner rows this band owns: [r_lo, r_own)
  const int r_own = band_id == bands - 1 ? H : r_lo + rows;
  const size_t n = r_hi > r_lo ? (size_t)(r_hi - r_lo) * W : 0;
  const G* src = grids + ((size_t)b * H + r_lo) * W;
  const size_t lead = (uintptr_t)src % 16;
  G* band = reinterpret_cast<G*>(smem + lead);
  // elements [e0, e1) by 16-byte asynchronous copies, the rest by threads
  constexpr size_t per16 = 16 / sizeof(G);
  const size_t e0 = min(n, ((16 - lead) % 16) / sizeof(G));
  const size_t e1 = max(e0, (n - e0) / per16 * per16 + e0);
  for (size_t c = e0 + threadIdx.x * per16; c < e1; c += blockDim.x * per16)
    cp_async16(band + c, src + c, true);
  cp_async_commit();
  for (size_t e = threadIdx.x; e < e0; e += blockDim.x) band[e] = src[e];
  for (size_t e = e1 + threadIdx.x; e < n; e += blockDim.x) band[e] = src[e];

  // the part's queries, as flat pair indices [i_lo, i_hi), loaded two at a
  // time (16 bytes) from vector index v_lo on
  const long long n_all = (long long)gridDim.y * Q;
  const long long i_lo = (long long)b * Q + (long long)Q * part / parts;
  const long long i_hi = (long long)b * Q + (long long)Q * (part + 1) / parts;
  const long long v_lo = i_lo >> 1, v_hi = (i_hi + 1) >> 1;
  const long long step = (long long)kStagedVecs * blockDim.x;
  const float4* pts4 = reinterpret_cast<const float4*>(pts);
  float4 p[kStagedVecs];
  auto load_round = [&](long long v0) {
#pragma unroll
    for (int u = 0; u < kStagedVecs; ++u) {
      const long long v = v0 + (long long)u * blockDim.x + threadIdx.x;
      if (v >= v_hi) continue;
      if (2 * v + 1 < n_all) {
        p[u] = __ldg(pts4 + v);
      } else {
        const float2 h = __ldg(pts + 2 * v);
        p[u] = make_float4(h.x, h.y, 0.f, 0.f);
      }
    }
  };
  long long v0 = v_lo;
  load_round(v0);
  cp_async_wait_all();
  __syncthreads();  // the band is in place

  for (; v0 < v_hi; v0 += step) {
#pragma unroll
    for (int u = 0; u < kStagedVecs; ++u) {
      const long long v = v0 + (long long)u * blockDim.x + threadIdx.x;
      if (v >= v_hi) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long i = 2 * v + h;
        if (i < i_lo || i >= i_hi) continue;
        const Corner<float> k = corner(h ? p[u].z : p[u].x,
                                       h ? p[u].w : p[u].y, H, W);
        if (k.r0 < r_lo || k.r0 >= r_own) continue;
        out[i] = blend_at<float>(band + (size_t)(k.r0 - r_lo) * W + k.c0, W,
                                 k);
      }
    }
    load_round(v0 + step);
  }
}

// ------------------------------------------------------------- binning

struct BinLayout {
  int H, W, nbr, nbc, be_r, be_c, nbins;
};

// bin_queries' formula: clamp, truncation, corner clamp, bin
__device__ __forceinline__ int bin_of(float2 p, const BinLayout& L) {
  const float r = clampv(p.x, 0.f, (float)(L.H - 1));
  const float c = clampv(p.y, 0.f, (float)(L.W - 1));
  const int r0 = min(max((int)r, 0), L.H - 2);
  const int c0 = min(max((int)c, 0), L.W - 2);
  return min(r0 / L.be_r, L.nbr - 1) * L.nbc + min(c0 / L.be_c, L.nbc - 1);
}

constexpr int kBinBlock = kThreads * kBinChunk;
constexpr int kScanThreads = 1024;

// hist[b][k][blk]: the queries of block blk of grid b that fall in bin k
// (bin-major, so that one scan over it orders the slots bin by bin)
__global__ void __launch_bounds__(kThreads)
    bin_count_kernel(const float2* __restrict__ pts, int* __restrict__ hist,
                     int Q, BinLayout L) {
  extern __shared__ int s_hist[];
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  for (int k = threadIdx.x; k < L.nbins; k += blockDim.x) s_hist[k] = 0;
  __syncthreads();
  const float2* p = pts + (size_t)b * Q;
  const long long q0 = (long long)blk * kBinBlock + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kBinChunk; ++j) {
    const long long q = q0 + (long long)j * kThreads;
    if (q < Q) atomicAdd(&s_hist[bin_of(__ldg(p + q), L)], 1);
  }
  __syncthreads();
  int* h = hist + (size_t)b * L.nbins * nblk + blk;
  for (int k = threadIdx.x; k < L.nbins; k += blockDim.x)
    h[(size_t)k * nblk] = s_hist[k];
}

// Inclusive scan of part[0, blockDim.x) in shared memory.
__device__ void block_inclusive_scan(int* part) {
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    const int v = (int)threadIdx.x >= d ? part[threadIdx.x - d] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
}

// Exclusive scan of s[0, n) by the whole block, each thread over one
// contiguous chunk; returns the total.  part: blockDim.x ints of shared
// scratch.
__device__ int block_exclusive_scan(int* s, long long n, int* part) {
  const long long per = (n + blockDim.x - 1) / blockDim.x;
  const long long lo = min(n, (long long)threadIdx.x * per);
  const long long hi = min(n, lo + per);
  int sum = 0;
  for (long long k = lo; k < hi; ++k) sum += s[k];
  part[threadIdx.x] = sum;
  __syncthreads();
  block_inclusive_scan(part);
  int run = part[threadIdx.x] - sum;
  const int total = part[blockDim.x - 1];
  for (long long k = lo; k < hi; ++k) {
    const int c = s[k];
    s[k] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

// One CTA per grid: hist becomes each (bin, block)'s first slot, and
// offsets[b] the bins' starts with Q at the end.
__global__ void __launch_bounds__(kScanThreads)
    bin_scan_kernel(int* __restrict__ hist, int* __restrict__ offsets,
                    int nblk, int nbins) {
  __shared__ int part[kScanThreads];
  const int b = blockIdx.x;
  int* h = hist + (size_t)b * nbins * nblk;
  const int total = block_exclusive_scan(h, (long long)nbins * nblk, part);
  int* o = offsets + (size_t)b * (nbins + 1);
  for (int k = threadIdx.x; k < nbins; k += blockDim.x)
    o[k] = nblk > 0 ? h[(size_t)k * nblk] : 0;
  if (threadIdx.x == 0) o[nbins] = total;
}

// Each query's id and pair to its slot, bin by bin.  The block first
// groups its queries by bin in shared memory, so that neighbouring threads
// write neighbouring slots.
__global__ void __launch_bounds__(kThreads)
    bin_scatter_kernel(const float2* __restrict__ pts,
                       const int* __restrict__ hist, int* __restrict__ order,
                       float2* __restrict__ pairs, int Q, BinLayout L) {
  extern __shared__ __align__(16) unsigned char sbuf[];
  float2* s_pair = reinterpret_cast<float2*>(sbuf);
  int* s_id = reinterpret_cast<int*>(s_pair + kBinBlock);
  int* s_bin = s_id + kBinBlock;
  int* s_cnt = s_bin + kBinBlock;    // per bin: count, then slot shift
  int* s_start = s_cnt + L.nbins;    // per bin: first local position
  int* part = s_start + L.nbins;     // kThreads of scan scratch
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  for (int k = threadIdx.x; k < L.nbins; k += blockDim.x) s_cnt[k] = 0;
  __syncthreads();
  const float2* p = pts + (size_t)b * Q;
  const long long q0 = (long long)blk * kBinBlock;
  float2 v[kBinChunk];
  int bin[kBinChunk], rank[kBinChunk];
#pragma unroll
  for (int j = 0; j < kBinChunk; ++j) {
    const long long q = q0 + (long long)j * kThreads + threadIdx.x;
    if (q >= Q) continue;
    v[j] = __ldg(p + q);
    bin[j] = bin_of(v[j], L);
    rank[j] = atomicAdd(&s_cnt[bin[j]], 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < L.nbins; k += blockDim.x)
    s_start[k] = s_cnt[k];
  __syncthreads();
  block_exclusive_scan(s_start, L.nbins, part);
#pragma unroll
  for (int j = 0; j < kBinChunk; ++j) {
    const long long q = q0 + (long long)j * kThreads + threadIdx.x;
    if (q >= Q) continue;
    const int pos = s_start[bin[j]] + rank[j];
    s_pair[pos] = v[j];
    s_id[pos] = (int)q;
    s_bin[pos] = bin[j];
  }
  // slot of local position pos in bin k: the block's first slot there, plus
  // pos - s_start[k]
  const int* h = hist + (size_t)b * L.nbins * nblk + blk;
  for (int k = threadIdx.x; k < L.nbins; k += blockDim.x)
    s_cnt[k] = h[(size_t)k * nblk] - s_start[k];
  __syncthreads();
  const int n_local = (int)min((long long)kBinBlock, (long long)Q - q0);
  const size_t row = (size_t)b * Q;
  for (int pos = threadIdx.x; pos < n_local; pos += blockDim.x) {
    const size_t slot = row + s_cnt[s_bin[pos]] + pos;
    order[slot] = s_id[pos];
    pairs[slot] = s_pair[pos];
  }
}

// ----------------------------------------------------------------- K8

struct BinnedGeom {
  int Q, H, W, nbins, nbc, be_r, be_c;
  int pitch;     // window row in elements: be_c + 1 from a 16-byte boundary
  int n_items;   // B * nbins
  unsigned buf;  // bytes of one window buffer
};

// The next (grid, bin) item of this CTA at or after `it` that holds queries.
__device__ __forceinline__ int next_item(int it, const int* offsets,
                                         const BinnedGeom& g) {
  for (; it < g.n_items; it += gridDim.x) {
    const int* o = offsets + (size_t)(it / g.nbins) * (g.nbins + 1) +
                   it % g.nbins;
    if (__ldg(o + 1) > __ldg(o)) break;
  }
  return it;
}

// The window of item `it`: its grid and the first row and column.
__device__ __forceinline__ void item_window(int it, const BinnedGeom& g,
                                            int& b, int& rb, int& cb) {
  b = it / g.nbins;
  const int k = it % g.nbins;
  rb = (k / g.nbc) * g.be_r;
  cb = (k % g.nbc) * g.be_c;
}

// Fill `win` with the window from row rb and column cb rounded down to a
// 16-byte boundary; nodes past the grid's last row or column (never read
// by a query) become 0.  kAsync: 16-byte cp.async copies, left in flight
// (rows of the grid whole multiples of 16 bytes); else plain loads.
template <typename G, bool kAsync>
__device__ __forceinline__ void load_window(G* win, const G* grids,
                                            const BinnedGeom& g, int b,
                                            int rb, int cb) {
  constexpr int per16 = 16 / sizeof(G);
  const int ca = cb - cb % per16;
  const int wr = g.be_r + 1;
  const G* src = grids + (size_t)b * g.H * g.W;
  if (kAsync) {
    const int cpr = g.pitch / per16;  // 16-byte chunks per window row
    for (int e = threadIdx.x; e < wr * cpr; e += blockDim.x) {
      const int r = e / cpr, c = ca + (e - r * cpr) * per16;
      const bool in = rb + r < g.H && c < g.W;
      cp_async16(win + r * g.pitch + (c - ca),
                 in ? src + (size_t)(rb + r) * g.W + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < wr * g.pitch; e += blockDim.x) {
      const int r = e / g.pitch, c = ca + (e - r * g.pitch);
      win[e] = (rb + r < g.H && c < g.W)
                   ? load_raw(src, (size_t)(rb + r) * g.W + c)
                   : G(0);
    }
  }
}

template <typename G, bool kAsync>
__global__ void __launch_bounds__(kBinnedThreads)
    bilinear_binned_kernel(const G* __restrict__ grids,
                           const float2* __restrict__ pairs,
                           const int* __restrict__ order,
                           const int* __restrict__ offsets,
                           float* __restrict__ out, BinnedGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int per16 = 16 / sizeof(G);
  int it = next_item(blockIdx.x, offsets, g);
  int b, rb, cb;
  if (kAsync && it < g.n_items) {
    item_window(it, g, b, rb, cb);
    load_window<G, true>(reinterpret_cast<G*>(smem), grids, g, b, rb, cb);
    cp_async_commit();
  }
  for (int s = 0; it < g.n_items; s ^= 1) {
    const int nxt = next_item(it + gridDim.x, offsets, g);
    G* win = reinterpret_cast<G*>(smem + (size_t)s * g.buf);
    if (kAsync) {
      // the next window into the other buffer, freed by the barrier at the
      // end of the previous item; then wait for this item's window only
      if (nxt < g.n_items) {
        item_window(nxt, g, b, rb, cb);
        load_window<G, true>(
            reinterpret_cast<G*>(smem + (size_t)(s ^ 1) * g.buf), grids, g,
            b, rb, cb);
      }
      cp_async_commit();
      cp_async_wait_one();
      item_window(it, g, b, rb, cb);
    } else {
      item_window(it, g, b, rb, cb);
      load_window<G, false>(win, grids, g, b, rb, cb);
    }
    __syncthreads();
    const int* o = offsets + (size_t)b * (g.nbins + 1) + it % g.nbins;
    const int lo = __ldg(o), hi = __ldg(o + 1);
    const size_t row = (size_t)b * g.Q;
    const G* w0 = win + cb % per16;  // node (rb, cb)
    for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      const float2 p = __ldg(pairs + row + j);
      const int qid = __ldg(order + row + j);
      const Corner<float> k = corner(p.x, p.y, g.H, g.W);
      // corner relative to the window; the clamp only keeps a query binned
      // elsewhere (a NaN coordinate) inside shared memory
      const int lr = min(max(k.r0 - rb, 0), g.be_r - 1);
      const int lc = min(max(k.c0 - cb, 0), g.be_c - 1);
      out[row + qid] = blend_at<float>(w0 + lr * g.pitch + lc, g.pitch, k);
    }
    __syncthreads();  // buffer s is free before its next fill
    it = nxt;
  }
}

// ---------------------------------------------------------------- host

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

// Launches that put the grid index on grid.y (at most 65535) run over
// chunks of at most kGridsPerLaunch grids, each with its pointers moved to
// the chunk's first grid.  An even count keeps a chunk's pairs on the
// 16-byte boundaries of the whole array.
constexpr int kGridsPerLaunch = 65534;

template <typename F>
int for_grid_chunks(int B, F launch_chunk) {
  for (int b0 = 0; b0 < B; b0 += kGridsPerLaunch) {
    const int err = launch_chunk(b0, std::min(kGridsPerLaunch, B - b0));
    if (err != cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

// CTAs of `kernel` that fit on the whole card at once.
template <typename K>
int resident_ctas(K kernel, int threads, size_t shmem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, shmem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return (int)cudaSuccess;
}

int check_common(const void* pts, size_t pair_bytes, int B, int Q, int H,
                 int W) {
  if (B < 0 || Q < 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)pts % pair_bytes != 0) return (int)cudaErrorMisalignedAddress;
  return (int)cudaSuccess;
}

template <typename T, typename G>
int launch_gather(const void* pts, const void* grids, void* out, int B, int Q,
                  int H, int W, void* stream) {
  using P = typename Pair<T>::type;
  const int err = check_common(pts, sizeof(P), B, Q, H, W);
  if (err != cudaSuccess || B == 0 || Q == 0) return err;
  const unsigned blocks = (unsigned)(((long long)Q + kThreads - 1) / kThreads);
  return for_grid_chunks(B, [&](int b0, int nb) {
    bilinear_gather_kernel<T, G>
        <<<dim3(blocks, (unsigned)nb), kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const P*>(pts) + (size_t)b0 * Q,
            static_cast<const G*>(grids) + (size_t)b0 * H * W,
            static_cast<T*>(out) + (size_t)b0 * Q, Q, H, W);
    return (int)cudaGetLastError();
  });
}

int launch_f64(const void* pts, const void* grids, void* out, int B, int Q,
               int H, int W, void* stream) {
  const int err = check_common(pts, sizeof(double2), B, Q, H, W);
  if (err != cudaSuccess || B == 0 || Q == 0) return err;
  constexpr int per_block = kF64Threads * kF64Queries;
  const unsigned blocks =
      (unsigned)(((long long)Q + per_block - 1) / per_block);
  return for_grid_chunks(B, [&](int b0, int nb) {
    bilinear_f64_kernel<<<dim3(blocks, (unsigned)nb), kF64Threads, 0,
                          (cudaStream_t)stream>>>(
        static_cast<const double2*>(pts) + (size_t)b0 * Q,
        static_cast<const double*>(grids) + (size_t)b0 * H * W,
        static_cast<double*>(out) + (size_t)b0 * Q, Q, H, W);
    return (int)cudaGetLastError();
  });
}

template <typename G>
int launch_staged(const void* pts, const void* grids, void* out, int B, int Q,
                  int H, int W, int bands, int parts, void* stream) {
  int err = check_common(pts, 16, B, Q, H, W);
  if (err != cudaSuccess) return err;
  if (bands < 1 || bands > kMaxBands || bands > H || parts < 1 ||
      parts > kMaxParts)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return (int)cudaSuccess;
  const int rows = (H + bands - 1) / bands;
  // the band and up to 15 bytes of lead to its first 16-byte boundary
  const size_t shmem = 16 + (size_t)(rows + 1) * W * sizeof(G);
  auto kernel = bilinear_staged_kernel<G>;
  if ((err = opt_in(kernel, shmem)) != cudaSuccess) return err;
  return for_grid_chunks(B, [&](int b0, int nb) {
    kernel<<<dim3((unsigned)(bands * parts), (unsigned)nb), kStagedThreads,
             shmem, (cudaStream_t)stream>>>(
        static_cast<const float2*>(pts) + (size_t)b0 * Q,
        static_cast<const G*>(grids) + (size_t)b0 * H * W,
        static_cast<float*>(out) + (size_t)b0 * Q, Q, H, W, rows, bands);
    return (int)cudaGetLastError();
  });
}

int launch_binning(const void* pts, void* pairs, void* order, void* offsets,
                   void* hist, int B, int Q, int H, int W, int nbr, int nbc,
                   int be_r, int be_c, void* stream) {
  int err = check_common(pts, sizeof(float2), B, Q, H, W);
  if (err != cudaSuccess) return err;
  if (nbr < 1 || nbc < 1 || be_r < 1 || be_c < 1)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)pairs % sizeof(float2) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0) return (int)cudaSuccess;
  const BinLayout L{H, W, nbr, nbc, be_r, be_c, nbr * nbc};
  const int nblk = (int)(((long long)Q + kBinBlock - 1) / kBinBlock);
  const size_t count_smem = (size_t)L.nbins * sizeof(int);
  const size_t scatter_smem = (size_t)kBinBlock * (sizeof(float2) + 2 * sizeof(int)) +
                              ((size_t)2 * L.nbins + kThreads) * sizeof(int);
  if ((err = opt_in(bin_count_kernel, count_smem)) != cudaSuccess ||
      (err = opt_in(bin_scatter_kernel, scatter_smem)) != cudaSuccess)
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t hist_per_grid = (size_t)L.nbins * nblk;
  if (nblk > 0) {
    err = for_grid_chunks(B, [&](int b0, int nb) {
      bin_count_kernel<<<dim3((unsigned)nblk, (unsigned)nb), kThreads,
                         count_smem, s>>>(
          static_cast<const float2*>(pts) + (size_t)b0 * Q,
          static_cast<int*>(hist) + b0 * hist_per_grid, Q, L);
      return (int)cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  bin_scan_kernel<<<B, kScanThreads, 0, s>>>(
      static_cast<int*>(hist), static_cast<int*>(offsets), nblk, L.nbins);
  if ((err = (int)cudaGetLastError()) != cudaSuccess) return err;
  if (nblk > 0) {
    err = for_grid_chunks(B, [&](int b0, int nb) {
      bin_scatter_kernel<<<dim3((unsigned)nblk, (unsigned)nb), kThreads,
                           scatter_smem, s>>>(
          static_cast<const float2*>(pts) + (size_t)b0 * Q,
          static_cast<const int*>(hist) + b0 * hist_per_grid,
          static_cast<int*>(order) + (size_t)b0 * Q,
          static_cast<float2*>(pairs) + (size_t)b0 * Q, Q, L);
      return (int)cudaGetLastError();
    });
  }
  return err;
}

template <typename G, bool kAsync>
int launch_binned_body(const void* grids, const void* pairs,
                       const void* order, const void* offsets, void* out,
                       const BinnedGeom& g, void* stream) {
  auto kernel = bilinear_binned_kernel<G, kAsync>;
  const size_t shmem = 2 * (size_t)g.buf;
  int err = opt_in(kernel, shmem);
  if (err != cudaSuccess) return err;
  int resident = 0;
  if ((err = resident_ctas(kernel, kBinnedThreads, shmem, &resident)) !=
      cudaSuccess)
    return err;
  const int ctas = std::min(resident, g.n_items);
  kernel<<<ctas, kBinnedThreads, shmem, (cudaStream_t)stream>>>(
      static_cast<const G*>(grids), static_cast<const float2*>(pairs),
      static_cast<const int*>(order), static_cast<const int*>(offsets),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_binned(const void* grids, const void* pairs, const void* order,
                  const void* offsets, void* out, int B, int Q, int H, int W,
                  int nbins, int nbc, int be_r, int be_c, int async,
                  void* stream) {
  int err = check_common(pairs, sizeof(float2), B, Q, H, W);
  if (err != cudaSuccess) return err;
  if (nbins < 1 || nbc < 1 || be_r < 1 || be_c < 1 || nbins % nbc != 0 ||
      (long long)B * nbins > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // the 16-byte copies need a 16-byte base and rows of whole 16 bytes
  if (async && ((uintptr_t)grids % 16 != 0 || ((size_t)W * sizeof(G)) % 16))
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || Q == 0) return (int)cudaSuccess;
  constexpr int per16 = 16 / sizeof(G);
  BinnedGeom g;
  g.Q = Q;
  g.H = H;
  g.W = W;
  g.nbins = nbins;
  g.nbc = nbc;
  g.be_r = be_r;
  g.be_c = be_c;
  g.pitch = (be_c + per16 + per16 - 1) / per16 * per16;
  g.n_items = B * nbins;
  g.buf = (unsigned)(((size_t)(be_r + 1) * g.pitch * sizeof(G) + 127) / 128 *
                     128);
  return async ? launch_binned_body<G, true>(grids, pairs, order, offsets,
                                             out, g, stream)
               : launch_binned_body<G, false>(grids, pairs, order, offsets,
                                              out, g, stream);
}

}  // namespace

// grid_bf16 != 0: grids holds the bf16 copy (uint16 bit patterns).
// bands 0: the direct body; 1..8: the staged body with that many bands of
// rows and `parts` parts of the queries per grid.
extern "C" int atorch_bilinear_gather(const void* pts, const void* grids,
                                      void* out, int B, int Q, int H, int W,
                                      int grid_bf16, int bands, int parts,
                                      void* stream) {
  if (bands > 0)
    return grid_bf16 ? launch_staged<uint16_t>(pts, grids, out, B, Q, H, W,
                                               bands, parts, stream)
                     : launch_staged<float>(pts, grids, out, B, Q, H, W,
                                            bands, parts, stream);
  return grid_bf16
             ? launch_gather<float, uint16_t>(pts, grids, out, B, Q, H, W,
                                              stream)
             : launch_gather<float, float>(pts, grids, out, B, Q, H, W,
                                           stream);
}

// hist: B * ceil(Q / 2048) * nbr * nbc ints of scratch.
extern "C" int atorch_bilinear_binning(const void* pts, void* pairs,
                                       void* order, void* offsets, void* hist,
                                       int B, int Q, int H, int W, int nbr,
                                       int nbc, int be_r, int be_c,
                                       void* stream) {
  return launch_binning(pts, pairs, order, offsets, hist, B, Q, H, W, nbr,
                        nbc, be_r, be_c, stream);
}

// async != 0: windows by 16-byte cp.async copies (a 16-byte aligned grid
// whose rows are whole multiples of 16 bytes).
extern "C" int atorch_bilinear_binned(const void* grids, const void* pairs,
                                      const void* order, const void* offsets,
                                      void* out, int B, int Q, int H, int W,
                                      int nbins, int nbc, int be_r, int be_c,
                                      int grid_bf16, int async, void* stream) {
  return grid_bf16
             ? launch_binned<uint16_t>(grids, pairs, order, offsets, out, B,
                                       Q, H, W, nbins, nbc, be_r, be_c, async,
                                       stream)
             : launch_binned<float>(grids, pairs, order, offsets, out, B, Q,
                                    H, W, nbins, nbc, be_r, be_c, async,
                                    stream);
}

extern "C" int atorch_bilinear_f64(const void* pts, const void* grids,
                                   void* out, int B, int Q, int H, int W,
                                   void* stream) {
  return launch_f64(pts, grids, out, B, Q, H, W, stream);
}
