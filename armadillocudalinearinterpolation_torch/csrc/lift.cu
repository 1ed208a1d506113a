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
// (4 points x 1024-4096 sites, 3 spikes) both bounds are under a
// microsecond, so one launch is the floor; the plain loop issues ~780
// elementwise launches an evaluation from the host.  The design is one
// thread a site and nothing shared: no stage is worth a barrier.
//
// Layout: grid.x covers a point's N sites, grid.y the P points, grid.z
// (K9T) chunks of K tangent directions.  A thread reads its point's (c,
// u_1..u_M, beta) (and their tangents), the same addresses across the warp,
// and writes its site's outputs, coalesced along i.  A chunk recomputes the
// primal; the first chunk writes it.
//
// Semantics follow model/lift.py operation by operation: every product, sum
// and quotient in the order PyTorch evaluates the plain loop's expressions,
// a Python-scalar subexpression (-b, 2a/b) in double and then rounded to the
// working type, as PyTorch casts a Python float, each torch.where as the
// branch it keeps.  Build with --fmad=false, so that no product is fused
// into a sum.  K9T runs the same body (lift_site) on a forward-mode dual
// number whose value part is K9's arithmetic, bit for bit; its tangents
// follow torch.func's rules: the kept branch of a select carries the
// tangent, the masks and the v < vth clamp carry none.

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridYZ = 65535;

// A value and K tangents, under forward-mode rules in the order PyTorch's
// derivative formulas take them (mul: b' a + a' b; div: (a' - b' q) / b;
// exp: a' e; reciprocal: -a' r r).  A plain double has no tangent.
template <int K>
struct Dual {
  double v;
  double d[K];
};

__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ double value(double x) { return x; }
template <int K>
__device__ __forceinline__ double value(const Dual<K>& x) { return x.v; }

__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(double& x) { x = 0.0; }
template <int K>
__device__ __forceinline__ void set_zero(Dual<K>& x) {
  x.v = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) x.d[k] = 0.0;
}

__device__ __forceinline__ float recip(float x) { return 1.0f / x; }
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return ::exp(x); }

template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a, double s) {
  Dual<K> r = a;
  r.v = a.v + s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator+(double s, const Dual<K>& a) {
  Dual<K> r = a;
  r.v = s + a.v;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a) {
  Dual<K> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a, double s) {
  Dual<K> r = a;
  r.v = a.v - s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(double s, const Dual<K>& a) {
  Dual<K> r;
  r.v = s - a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = b.d[k] * a.v + a.d[k] * b.v;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a, double s) {
  Dual<K> r;
  r.v = a.v * s;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator*(double s, const Dual<K>& a) {
  Dual<K> r;
  r.v = s * a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator/(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (a.d[k] - b.d[k] * r.v) / b.v;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator/(double s, const Dual<K>& b) {
  Dual<K> r;
  r.v = s / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -(b.d[k] * r.v) / b.v;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> recip(const Dual<K>& a) {
  Dual<K> r;
  r.v = 1.0 / a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k] * (r.v * r.v);
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> xexp(const Dual<K>& a) {
  Dual<K> r;
  r.v = ::exp(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * r.v;
  return r;
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

// _lift_voltage_term's branch ahead of the spike (x - c u > 0)
template <typename T, typename S>
__device__ __forceinline__ T voltage_ahead(S x, const T& c, const T& u,
                                           const T& beta, S a, S b, S nb) {
  const T cb = c * b;
  const T abc = beta * a * c;
  const T boundary = abc / ((beta + cb) * (cb + S(1))) *
                     xexp(u * (cb + S(1))) * xexp(c * nb * u);
  const T homog = abc / (S(1) - beta) * xexp(beta * u) *
                  (recip(beta + cb) + recip(cb - beta)) *
                  (xexp(x / c * (S(1) - beta)) - xexp(u * (S(1) - beta)));
  const T partic = abc / ((cb - beta) * (S(1) - cb)) * xexp(cb * u) *
                   (xexp(x * (S(1) - cb) / c) -
                    xexp(c * u * (S(1) - cb) / c));
  return boundary + homog - partic;
}

// _lift_voltage_term's branch behind the spike
template <typename T, typename S>
__device__ __forceinline__ T voltage_behind(S x, const T& c, const T& u,
                                            const T& beta, S a, S b, S nb) {
  const T cb = c * b;
  return beta * a * c / ((beta + cb) * (cb + S(1))) *
         xexp(x * (cb + S(1)) / c) * xexp(c * nb * u);
}

// _lift_synapse_term's ahead (x - c u) and behind (c u - x) values
template <typename T, typename S>
__device__ __forceinline__ T synapse_ahead(S x, const T& c, const T& u,
                                           const T& beta, S a, S b) {
  const T cb = c * b;
  return beta * a * (c / (beta + cb)) * xexp((x - c * u) * b);
}

template <typename T, typename S>
__device__ __forceinline__ T synapse_behind(S x, const T& c, const T& u,
                                            const T& beta, S a, S b,
                                            S k) {
  const T cb = c * b;
  return (beta / (S(1) - beta * beta / (cb * cb))) * k *
             xexp(-(beta / c) * (x - c * u)) -
         beta * a * (c / (cb - beta)) * xexp((c * u - x) * b);
}

// One site of model/lift.py::lift_plain: the lift at the mirrored
// coordinate x = L - dx i of point (c = U[0], u_m = U[m], beta); load(m)
// returns U[m] in the type T.
template <typename T, typename S, typename Load>
__device__ __forceinline__ void lift_site(int i, const T& beta, Load load,
                                          int M, const Consts<S>& k, T& v,
                                          T& s) {
  const S x = k.half_width - S(i) * k.dx;
  const T c = load(0);
  T v_acc;
  set_zero(v_acc);
  T s_acc = v_acc;
  for (int m = 1; m <= M; ++m) {
    const T u = load(m);
    const T cu = c * u;
    const bool ahead = value(x - cu) > S(0);
    const T dummy =
        (ahead ? voltage_ahead(x, c, u, beta, k.a1, k.b1, k.nb1) -
                     voltage_ahead(x, c, u, beta, k.a2, k.b2, k.nb2)
               : voltage_behind(x, c, u, beta, k.a1, k.b1, k.nb1) -
                     voltage_behind(x, c, u, beta, k.a2, k.b2, k.nb2)) *
        xexp(-x / c);
    v_acc = v_acc + dummy;
    if (ahead) v_acc = v_acc - xexp(-(x - cu) / c);
    const bool behind_spike = value(cu - x) > S(0);
    s_acc = s_acc +
            (behind_spike ? synapse_ahead(x, c, u, beta, k.a1, k.b1) -
                                synapse_ahead(x, c, u, beta, k.a2, k.b2)
                          : synapse_behind(x, c, u, beta, k.a1, k.b1, k.k1) -
                                synapse_behind(x, c, u, beta, k.a2, k.b2,
                                               k.k2));
  }
  v = v_acc + k.drive;
  v = v * (value(v) < k.vth ? S(1) : S(0));
  s = s_acc;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    lift_kernel(const S* __restrict__ U, const S* __restrict__ beta,
                int beta_stride, int N, int M, Consts<S> k,
                S* __restrict__ v0, S* __restrict__ s0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int p = blockIdx.y;
  const S* Up = U + (size_t)p * (M + 1);
  S v, s;
  lift_site<S, S>(i, beta[(size_t)p * beta_stride],
                  [&](int m) { return Up[m]; }, M, k, v, s);
  v0[(size_t)p * N + i] = v;
  s0[(size_t)p * N + i] = s;
}

// dU is (D, P, M + 1), dbeta (D, P); dv0 and ds0 (D, P, N).  Chunk
// blockIdx.z carries directions [z K, z K + K) and reads zeros past D.
template <int K>
__global__ void __launch_bounds__(kThreads)
    lift_tangent_kernel(const double* __restrict__ U,
                        const double* __restrict__ beta, int beta_stride,
                        const double* __restrict__ dU,
                        const double* __restrict__ dbeta, int P, int N,
                        int M, int D, Consts<double> k,
                        double* __restrict__ v0, double* __restrict__ s0,
                        double* __restrict__ dv0, double* __restrict__ ds0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int p = blockIdx.y;
  const int d0 = blockIdx.z * K;
  const size_t row = (size_t)p * (M + 1);
  auto load = [&](int m) {
    Dual<K> r;
    r.v = U[row + m];
#pragma unroll
    for (int j = 0; j < K; ++j)
      r.d[j] = d0 + j < D ? dU[(size_t)(d0 + j) * P * (M + 1) + row + m]
                          : 0.0;
    return r;
  };
  Dual<K> b;
  b.v = beta[(size_t)p * beta_stride];
#pragma unroll
  for (int j = 0; j < K; ++j)
    b.d[j] = d0 + j < D ? dbeta[(size_t)(d0 + j) * P + p] : 0.0;
  Dual<K> v, s;
  lift_site<Dual<K>, double>(i, b, load, M, k, v, s);
  const size_t site = (size_t)p * N + i;
  if (blockIdx.z == 0) {
    v0[site] = v.v;
    s0[site] = s.v;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (d0 + j < D) {
      dv0[(size_t)(d0 + j) * P * N + site] = v.d[j];
      ds0[(size_t)(d0 + j) * P * N + site] = s.d[j];
    }
  }
}

bool valid(int P, int N, int M, int beta_stride) {
  return P >= 1 && P <= kMaxGridYZ && N >= 1 && M >= 1 && beta_stride >= 0;
}

template <typename S>
int launch(const void* U, const void* beta, void* v0, void* s0, int P,
           int N, int M, int beta_stride, const Consts<S>& k, void* stream) {
  if (!valid(P, N, M, beta_stride)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, P);
  lift_kernel<S><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const S*>(U), static_cast<const S*>(beta), beta_stride, N,
      M, k, static_cast<S*>(v0), static_cast<S*>(s0));
  return (int)cudaGetLastError();
}

template <int K>
void launch_tangent(const dim3& grid, cudaStream_t stream, const void* U,
                    const void* beta, int beta_stride, const void* dU,
                    const void* dbeta, int P, int N, int M, int D,
                    const Consts<double>& k, void* v0, void* s0, void* dv0,
                    void* ds0) {
  lift_tangent_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const double*>(U), static_cast<const double*>(beta),
      beta_stride, static_cast<const double*>(dU),
      static_cast<const double*>(dbeta), P, N, M, D, k,
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

// K9T: the lift of atorch_lift_f64 and its tangents along D directions,
// dU (D, P, M + 1) and dbeta (D, P), into dv0 and ds0 (D, P, N), in one
// launch: chunks of D (up to 4) directions.
extern "C" int atorch_lift_tangent_f64(
    const void* U, const void* beta, const void* dU, const void* dbeta,
    void* v0, void* s0, void* dv0, void* ds0, int P, int N, int M, int D,
    int beta_stride, double a1, double a2, double b1, double b2,
    double drive, double vth, double half_width, double dx, void* stream) {
  if (!valid(P, N, M, beta_stride) || D < 1) return (int)cudaErrorInvalidValue;
  const int K = D < 4 ? D : 4;
  const int chunks = (D + K - 1) / K;
  if (chunks > kMaxGridYZ) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, P, chunks);
  const Consts<double> k =
      make_consts<double>(a1, a2, b1, b2, drive, vth, half_width, dx);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1:
      launch_tangent<1>(grid, st, U, beta, beta_stride, dU, dbeta, P, N, M,
                        D, k, v0, s0, dv0, ds0);
      break;
    case 2:
      launch_tangent<2>(grid, st, U, beta, beta_stride, dU, dbeta, P, N, M,
                        D, k, v0, s0, dv0, ds0);
      break;
    case 3:
      launch_tangent<3>(grid, st, U, beta, beta_stride, dU, dbeta, P, N, M,
                        D, k, v0, s0, dv0, ds0);
      break;
    default:
      launch_tangent<4>(grid, st, U, beta, beta_stride, dU, dbeta, P, N, M,
                        D, k, v0, s0, dv0, ds0);
  }
  return (int)cudaGetLastError();
}
