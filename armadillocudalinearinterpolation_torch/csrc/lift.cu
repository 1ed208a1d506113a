// The lift on Hopper (sm_90a): K9, the closed-form travelling-wave initial
// condition (v0, s0) of a stack of points, float and double; and K9T, the
// same lift with D forward tangents, double.
//
// Replaces: armadillocudalinearinterpolation_tpu/model/lift.py::lift (:66),
// a Python loop over the spikes unrolled at trace time, which XLA fuses into
// one device program (the reference's LiftKernel, EventDrivenMap.cu:
// 505-542); K9T replaces jax.jacfwd through it.  The plain PyTorch versions
// are armadillocudalinearinterpolation_torch/model/lift.py::lift_plain and,
// for the tangents, the same loop on dual numbers
// (model/lift_cuda.py::lift_tangent_plain); the card tests also hold K9T
// against torch.func over lift_plain.
//
// What bounds it: each site (p, i) and spike costs ~28 exp and ~100 other
// operations (one branch of each select), and each site writes two values
// (2 + 2D for K9T) from M + 2 values of its point.  At the map's shapes
// (1-4 points x 512-4096 sites, 3 spikes) both bounds are well under a
// microsecond, so what a launch takes is its longest chain of dependent
// operations and the waves its threads need.  A whole site in one thread
// is ~28 exp in a row.
//
// Design: a site's lift is a sum over the spikes m = 1..M of independent
// closed forms: the voltage term of each exponential pair
// (_lift_voltage_term: ahead of the spike or behind it), its synapse term
// (_lift_synapse_term), and the spike's reset exp(-(x - c u)/c).  Most of
// each closed form does not depend on the site: the voltage term ahead of
// the spike is its boundary part (site-free) plus two coefficients times
// an exp of the site less an exp of the spike, each in the plain loop's
// order.  So a CTA, which holds 16 Sub consecutive sites of one point
// (and for K9T one direction), works in three phases with a barrier
// between:
//   1. the site-free factors of each spike and pair (Spike), four warps
//      each taking a group of them, a lane a (spike, pair); a fifth warp
//      the decay exp(-x/c) of each site, once;
//   2. the pieces, two warps a spike: the voltage warp and the synapse warp
//      (which also takes the reset), lanes 0-15 pair 1 and lanes 16-31
//      pair 2 of the same 16 sites, Sub such half-warps of sites in turn,
//      so that a warp runs one closed form and diverges only at the sites
//      on either side of the spike; a piece is one or two exp of the site
//      and a few products;
//   3. thread j < 16 Sub sums site j's pieces in the plain loop's order
//      and with its operations (v += (P1 - P2) decay, then - reset where
//      ahead; s += S1 - S2; the drive and the v < vth clamp last).
// More spikes than kRound run in rounds of kRound, the sums carried over.
// Phase 1 is the same for every CTA of a point (and direction), and its
// chain of divisions and exps is the longest: so a CTA takes more sites
// (Sub = 2, 4) once its grid would need more than one wave of CTAs
// (layout).
//
// Layout: grid.x covers the P points times their ceil(N / (16 Sub)) tiles
// of sites, grid.y (K9T) the D directions; blockDim.x is 32 threads times
// the larger of 2 warps a spike of the round and kGroups + 1 (at M = 3, 6
// warps), at most 170 registers a thread, so that two CTAs fit an SM.  K9T carries one direction a thread
// (a Dual: value and one tangent): direction k's tangent arithmetic reads
// only the primal and direction k, so its bits do not depend on the
// layout; every direction recomputes the primal, and direction 0's CTAs
// write it.
//
// Semantics follow model/lift.py operation by operation: every product, sum
// and quotient in the order PyTorch evaluates the plain loop's expressions,
// a Python-scalar subexpression (-b, 2a/b) in double and then rounded to the
// working type, as PyTorch casts a Python float, each torch.where as the
// branch it keeps.  Build with --fmad=false, so that no product is fused
// into a sum.  K9T runs the same body (lift_tile) on the dual number, whose
// value part is K9's arithmetic, bit for bit; its tangents follow
// torch.func's rules: the kept branch of a select carries the tangent, the
// masks and the v < vth clamp carry none.

#include <stdint.h>

namespace {

constexpr int kHalf = 16;                // sites of a half-warp
constexpr int kRound = 3;                // spikes a round, two warps each
constexpr int kGroups = 4;               // warps of a spike's factors
constexpr int kMaxThreads = 64 * kRound;
constexpr int kWave = 264;               // two CTAs on each of 132 SMs
constexpr int kMaxGridY = 65535;
constexpr long long kMaxGridX = 2147483647;

// A value and one tangent, under forward-mode rules in the order PyTorch's
// derivative formulas take them (mul: b' a + a' b; div: (a' - b' q) / b;
// exp: a' e; reciprocal: -a' r r).  A plain double has no tangent.
struct Dual {
  double v, d;
};

__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ double value(double x) { return x; }
__device__ __forceinline__ double value(const Dual& x) { return x.v; }

__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(double& x) { x = 0.0; }
__device__ __forceinline__ void set_zero(Dual& x) { x = {0.0, 0.0}; }

__device__ __forceinline__ float recip(float x) { return 1.0f / x; }
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return ::exp(x); }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  return {a.v + b.v, a.d + b.d};
}

__device__ __forceinline__ Dual operator+(const Dual& a, double s) {
  return {a.v + s, a.d};
}

__device__ __forceinline__ Dual operator-(const Dual& a) {
  return {-a.v, -a.d};
}

__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  return {a.v - b.v, a.d - b.d};
}

__device__ __forceinline__ Dual operator-(const Dual& a, double s) {
  return {a.v - s, a.d};
}

__device__ __forceinline__ Dual operator-(double s, const Dual& a) {
  return {s - a.v, -a.d};
}

__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  return {a.v * b.v, b.d * a.v + a.d * b.v};
}

__device__ __forceinline__ Dual operator*(const Dual& a, double s) {
  return {a.v * s, a.d * s};
}

__device__ __forceinline__ Dual operator*(double s, const Dual& a) {
  return {s * a.v, a.d * s};
}

__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  const double q = a.v / b.v;
  return {q, (a.d - b.d * q) / b.v};
}

__device__ __forceinline__ Dual operator/(double s, const Dual& b) {
  const double q = s / b.v;
  return {q, -(b.d * q) / b.v};
}

__device__ __forceinline__ Dual recip(const Dual& a) {
  const double r = 1.0 / a.v;
  return {r, -a.d * (r * r)};
}

__device__ __forceinline__ Dual xexp(const Dual& a) {
  const double e = ::exp(a.v);
  return {e, a.d * e};
}

// The model's constants in the working type S, each rounded once from the
// double PyTorch would hold as a Python float.
template <typename S>
struct Consts {
  S a1, a2, b1, b2, nb1, nb2, k1, k2, drive, vth, half_width, dx;
};

template <typename S>
Consts<S> make_consts(double a1, double a2, double b1, double b2,
                      double drive, double vth, double half_width,
                      double dx) {
  return {S(a1), S(a2), S(b1), S(b2), S(-b1), S(-b2), S(2.0 * a1 / b1),
          S(2.0 * a2 / b2), S(drive), S(vth), S(half_width), S(dx)};
}

// The factors of one spike's and one pair's closed forms that do not
// depend on the site, each in the plain loop's order up to the site's
// first factor: _lift_voltage_term's boundary term (the whole of it), the
// coefficients of homog and partic and the exps they subtract, and the
// coefficient of the branch behind the spike; _lift_synapse_term's
// coefficients.  Written by four warps of the CTA, one a group:
// (boundary, bq, enb), (h0, eh), (p0, ep), (sa0, sb0, sb1, sb2).
template <typename T>
struct Spike {
  T boundary, bq, enb, h0, eh, p0, ep, sa0, sb0, sb1, sb2;
};

template <typename T, typename S>
__device__ __forceinline__ void spike_factors(int group, const T& c,
                                              const T& u, const T& beta,
                                              S a, S b, S nb, S k,
                                              Spike<T>& f) {
  const T cb = c * b;
  const T abc = beta * a * c;
  switch (group) {
    case 0:
      f.bq = abc / ((beta + cb) * (cb + S(1)));
      f.enb = xexp(c * nb * u);
      f.boundary = f.bq * xexp(u * (cb + S(1))) * f.enb;
      break;
    case 1:
      f.h0 = abc / (S(1) - beta) * xexp(beta * u) *
             (recip(beta + cb) + recip(cb - beta));
      f.eh = xexp(u * (S(1) - beta));
      break;
    case 2:
      f.p0 = abc / ((cb - beta) * (S(1) - cb)) * xexp(cb * u);
      f.ep = xexp(c * u * (S(1) - cb) / c);
      break;
    default:
      f.sa0 = beta * a * (c / (beta + cb));
      f.sb0 = (beta / (S(1) - beta * beta / (cb * cb))) * k;
      f.sb1 = -(beta / c);
      f.sb2 = beta * a * (c / (cb - beta));
  }
}

// _lift_voltage_term at site x: the branch ahead of the spike (x - c u >
// 0), boundary + homog - partic, or the branch behind it
template <typename T, typename S>
__device__ __forceinline__ T voltage(S x, const T& c, const T& beta, S b,
                                     bool ahead, const Spike<T>& f) {
  const T cb = c * b;
  if (ahead)
    return f.boundary + f.h0 * (xexp(x / c * (S(1) - beta)) - f.eh) -
           f.p0 * (xexp(x * (S(1) - cb) / c) - f.ep);
  return f.bq * xexp(x * (cb + S(1)) / c) * f.enb;
}

// _lift_synapse_term at site x: its ahead value (x - c u) behind the spike
// (c u - x > 0), else its behind value
template <typename T, typename S>
__device__ __forceinline__ T synapse(S x, const T& cu, S b,
                                     bool behind_spike, const Spike<T>& f) {
  if (behind_spike) return f.sa0 * xexp((x - cu) * b);
  return f.sb0 * xexp(f.sb1 * (x - cu)) - f.sb2 * xexp((cu - x) * b);
}

// What a round of up to kRound spikes keeps in shared memory, for a CTA of
// kHalf * Sub sites: each spike's and pair's factors; the pieces, by spike
// of the round, field (0 the voltage, 1 the synapse), pair and site; each
// spike's reset (where the site is ahead of it); each site's decay
// exp(-x/c).
template <typename T, int Sub>
struct Tile {
  Spike<T> spike[kRound][2];
  T piece[kRound][2][2][kHalf * Sub];
  T reset[kRound][kHalf * Sub];
  T decay[kHalf * Sub];
};

// The sites [i0, i0 + kHalf * Sub) of model/lift.py::lift_plain, as the
// header lays them out over the CTA: the lift at the mirrored coordinate
// x = L - dx i of the point (c = U[0], u_m = U[m], beta); load(m) returns
// U[m] in the type T.  Every thread of the CTA calls it; thread j <
// kHalf * Sub returns site i0 + j's (v, s) (the others return nothing of
// use).
template <int Sub, typename T, typename S, typename Load>
__device__ __forceinline__ void lift_tile(int i0, int N, int M,
                                          const T& beta, Load load,
                                          const Consts<S>& k,
                                          Tile<T, Sub>& tile, T& v, T& s) {
  constexpr int sites = kHalf * Sub;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = lane / kHalf, round = M < kRound ? M : kRound;
  const T c = load(0);
  auto coordinate = [&](int j) { return k.half_width - S(i0 + j) * k.dx; };
  T v_acc;
  set_zero(v_acc);
  T s_acc = v_acc;
  for (int m0 = 1; m0 <= M; m0 += round) {
    // phase 1: the factors of each spike and pair (warps 0-3, a lane a
    // spike and pair), and each site's decay (warp 4, first round)
    if (warp < kGroups) {
      const int r = lane / 2, p = lane % 2;
      if (r < round && m0 + r <= M)
        spike_factors(warp, c, load(m0 + r), beta, p ? k.a2 : k.a1,
                      p ? k.b2 : k.b1, p ? k.nb2 : k.nb1, p ? k.k2 : k.k1,
                      tile.spike[r][p]);
    } else if (warp == kGroups && m0 == 1) {
      for (int j = lane; j < sites && i0 + j < N; j += 32)
        tile.decay[j] = xexp(-coordinate(j) / c);
    }
    __syncthreads();
    // phase 2: the pieces, two warps a spike (its voltage, and its synapse
    // with the reset on pair 1's lanes), each lane Sub sites in turn
    const int r = warp / 2, m = m0 + r;
    if (r < round && m <= M) {
      const S b = pair ? k.b2 : k.b1;
      const T cu = c * load(m);
      const Spike<T>& f = tile.spike[r][pair];
#pragma unroll 1
      for (int j = lane % kHalf; j < sites && i0 + j < N; j += kHalf) {
        const S x = coordinate(j);
        if (warp % 2 == 0) {
          tile.piece[r][0][pair][j] =
              voltage(x, c, beta, b, value(x - cu) > S(0), f);
        } else {
          tile.piece[r][1][pair][j] =
              synapse(x, cu, b, value(cu - x) > S(0), f);
          if (pair == 0 && value(x - cu) > S(0))
            tile.reset[r][j] = xexp(-(x - cu) / c);
        }
      }
    }
    __syncthreads();
    // phase 3: site j's sums in the plain loop's order
    const int j = threadIdx.x;
    if (j < sites && i0 + j < N) {
      const S x = coordinate(j);
      for (int q = 0; q < round && m0 + q <= M; ++q) {
        const T cu = c * load(m0 + q);
        v_acc = v_acc + (tile.piece[q][0][0][j] - tile.piece[q][0][1][j]) *
                            tile.decay[j];
        if (value(x - cu) > S(0)) v_acc = v_acc - tile.reset[q][j];
        s_acc = s_acc + (tile.piece[q][1][0][j] - tile.piece[q][1][1][j]);
      }
    }
    if (m0 + round <= M) __syncthreads();
  }
  v = v_acc + k.drive;
  v = v * (value(v) < k.vth ? S(1) : S(0));
  s = s_acc;
}

template <int Sub, typename S>
__global__ void __launch_bounds__(kMaxThreads, 2)
    lift_kernel(const S* __restrict__ U, const S* __restrict__ beta,
                int beta_stride, int N, int M, int tiles, Consts<S> k,
                S* __restrict__ v0, S* __restrict__ s0) {
  __shared__ Tile<S, Sub> tile;
  const int p = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - p * tiles) * kHalf * Sub;
  const S* Up = U + (size_t)p * (M + 1);
  S v, s;
  lift_tile<Sub>(i0, N, M, beta[(size_t)p * beta_stride],
                 [&](int m) { return Up[m]; }, k, tile, v, s);
  const int i = i0 + threadIdx.x;
  if (threadIdx.x < kHalf * Sub && i < N) {
    v0[(size_t)p * N + i] = v;
    s0[(size_t)p * N + i] = s;
  }
}

// dU is (D, P, M + 1), dbeta (D, P); dv0 and ds0 (D, P, N).  Direction
// blockIdx.y.
template <int Sub>
__global__ void __launch_bounds__(kMaxThreads, 2)
    lift_tangent_kernel(const double* __restrict__ U,
                        const double* __restrict__ beta, int beta_stride,
                        const double* __restrict__ dU,
                        const double* __restrict__ dbeta, int P, int N,
                        int M, int tiles, Consts<double> k,
                        double* __restrict__ v0, double* __restrict__ s0,
                        double* __restrict__ dv0, double* __restrict__ ds0) {
  __shared__ Tile<Dual, Sub> tile;
  const int p = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - p * tiles) * kHalf * Sub;
  const int d = blockIdx.y;
  const size_t row = (size_t)p * (M + 1);
  const double* dUd = dU + (size_t)d * P * (M + 1);
  const Dual b = {beta[(size_t)p * beta_stride], dbeta[(size_t)d * P + p]};
  Dual v, s;
  lift_tile<Sub>(
      i0, N, M, b, [&](int m) { return Dual{U[row + m], dUd[row + m]}; }, k,
      tile, v, s);
  const int i = i0 + threadIdx.x;
  if (threadIdx.x < kHalf * Sub && i < N) {
    const size_t site = (size_t)p * N + i;
    if (d == 0) {
      v0[site] = v.v;
      s0[site] = s.v;
    }
    dv0[(size_t)d * P * N + site] = v.d;
    ds0[(size_t)d * P * N + site] = s.d;
  }
}

// The launch of P points of N sites, M spikes and D directions: the
// half-warps of sites a CTA takes (Sub: the fewest of min_sub, 2, 4 whose
// grid fits one wave of kWave CTAs, else 4), its grid and block, or false
// where the grid would exceed its limits.  K9 takes min_sub 2, K9T 1: on the card K9 ran fastest with 32
// sites a CTA or more at every shape of the map's path, K9T with 16 where
// that grid fits one wave (tools/lift_study.py).
struct Layout {
  int sub, tiles;
  dim3 grid, block;
};

bool layout(int P, int N, int M, int beta_stride, int D, int min_sub,
            Layout& out) {
  if (P < 1 || N < 1 || M < 1 || beta_stride < 0 || D < 1 ||
      D > kMaxGridY || P * ((N - 1) / (long long)kHalf + 1) > kMaxGridX)
    return false;
  int sub = min_sub;
  while (sub < 4 &&
         (long long)P * ((N - 1) / (kHalf * sub) + 1) * D > kWave)
    sub *= 2;
  out.sub = sub;
  out.tiles = (N - 1) / (kHalf * out.sub) + 1;
  const int round = M < kRound ? M : kRound;
  out.grid = dim3((unsigned)(P * out.tiles), D);
  out.block = dim3(32 * (2 * round > kGroups ? 2 * round : kGroups + 1));
  return true;
}

template <int Sub, typename S>
void launch_sub(const Layout& l, cudaStream_t stream, const void* U,
                const void* beta, void* v0, void* s0, int N, int M,
                int beta_stride, const Consts<S>& k) {
  lift_kernel<Sub, S><<<l.grid, l.block, 0, stream>>>(
      static_cast<const S*>(U), static_cast<const S*>(beta), beta_stride, N,
      M, l.tiles, k, static_cast<S*>(v0), static_cast<S*>(s0));
}

template <typename S>
int launch(const void* U, const void* beta, void* v0, void* s0, int P,
           int N, int M, int beta_stride, const Consts<S>& k, void* stream) {
  Layout l;
  if (!layout(P, N, M, beta_stride, 1, 2, l))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (l.sub == 1)
    launch_sub<1>(l, st, U, beta, v0, s0, N, M, beta_stride, k);
  else if (l.sub == 2)
    launch_sub<2>(l, st, U, beta, v0, s0, N, M, beta_stride, k);
  else
    launch_sub<4>(l, st, U, beta, v0, s0, N, M, beta_stride, k);
  return (int)cudaGetLastError();
}

template <int Sub>
void launch_tangent(const Layout& l, cudaStream_t stream, const void* U,
                    const void* beta, int beta_stride, const void* dU,
                    const void* dbeta, int P, int N, int M,
                    const Consts<double>& k, void* v0, void* s0, void* dv0,
                    void* ds0) {
  lift_tangent_kernel<Sub><<<l.grid, l.block, 0, stream>>>(
      static_cast<const double*>(U), static_cast<const double*>(beta),
      beta_stride, static_cast<const double*>(dU),
      static_cast<const double*>(dbeta), P, N, M, l.tiles, k,
      static_cast<double*>(v0), static_cast<double*>(s0),
      static_cast<double*>(dv0), static_cast<double*>(ds0));
}

}  // namespace

// U: (P, M + 1) values (c, u_1..u_M) of each point; beta: the mean rate,
// beta[p * beta_stride] (beta_stride 0: one rate for every point); v0, s0:
// (P, N).  The constants are ModelConfig's fields.
#define ATORCH_LIFT(NAME, S)                                                  \
  extern "C" int NAME(const void* U, const void* beta, void* v0, void* s0,    \
                      int P, int N, int M, int beta_stride, double a1,        \
                      double a2, double b1, double b2, double drive,          \
                      double vth, double half_width, double dx,               \
                      void* stream) {                                         \
    return launch<S>(U, beta, v0, s0, P, N, M, beta_stride,                   \
                     make_consts<S>(a1, a2, b1, b2, drive, vth, half_width,   \
                                    dx),                                      \
                     stream);                                                 \
  }

ATORCH_LIFT(atorch_lift_f32, float)
ATORCH_LIFT(atorch_lift_f64, double)

// K9T: the lift of atorch_lift_f64 and its tangents along D directions
// (at most 65535), dU (D, P, M + 1) and dbeta (D, P), into dv0 and ds0
// (D, P, N), in one launch.
extern "C" int atorch_lift_tangent_f64(
    const void* U, const void* beta, const void* dU, const void* dbeta,
    void* v0, void* s0, void* dv0, void* ds0, int P, int N, int M, int D,
    int beta_stride, double a1, double a2, double b1, double b2,
    double drive, double vth, double half_width, double dx, void* stream) {
  Layout l;
  if (!layout(P, N, M, beta_stride, D, 1, l))
    return (int)cudaErrorInvalidValue;
  const Consts<double> k =
      make_consts<double>(a1, a2, b1, b2, drive, vth, half_width, dx);
  const cudaStream_t st = (cudaStream_t)stream;
  if (l.sub == 1)
    launch_tangent<1>(l, st, U, beta, beta_stride, dU, dbeta, P, N, M, k,
                      v0, s0, dv0, ds0);
  else if (l.sub == 2)
    launch_tangent<2>(l, st, U, beta, beta_stride, dU, dbeta, P, N, M, k,
                      v0, s0, dv0, ds0);
  else
    launch_tangent<4>(l, st, U, beta, beta_stride, dU, dbeta, P, N, M, k,
                      v0, s0, dv0, ds0);
  return (int)cudaGetLastError();
}
