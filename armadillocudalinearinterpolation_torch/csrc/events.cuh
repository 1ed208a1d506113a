// Per-lane event arithmetic shared by the evolve kernel (evolve.cu) and the
// schedule replay kernel (replay.cu): the membrane residual and its time
// derivative, and the next-firing-time root-find with its fire/no-fire
// decision.  The plain PyTorch versions are
// armadillocudalinearinterpolation_torch/model/events.py; both follow the
// same formulas in the same operation order.  Build without
// --use_fast_math (it changes exp and pow and flushes denormals) and with
// --fmad=false, so that no multiply-add is fused where the plain version
// rounds twice.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Consts {
  double vth, drive, gap, a1, a2, neg_b1, neg_b2, dx, t_horizon, root_tol;
  int counter_max;
};

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

// Classify event (j, t_new) to the nearest tracked trajectory (lowest id on
// ties) and record it as its last firing before T or its first after T,
// unless that trajectory has crossed already.  One thread, shared memory.
// Returns the trajectory it recorded (the first after T where t_new > T),
// or -1.
template <typename T>
__device__ __forceinline__ int classify_event(int j, T t_new, T t_horizon,
                                               int M, int* last_ind,
                                               T* last_time, int* crossed_ind,
                                               T* crossed_time, int* crossed) {
  int mm = 0, dmin = abs(j - last_ind[0]);
  for (int m = 1; m < M; ++m) {
    const int dm = abs(j - last_ind[m]);
    if (dm < dmin) {
      dmin = dm;
      mm = m;
    }
  }
  if (!crossed[mm]) {
    if (t_new > t_horizon) {
      crossed_time[mm] = t_new;
      crossed_ind[mm] = j;
      crossed[mm] = 1;
    } else {
      last_time[mm] = t_new;
      last_ind[mm] = j;
    }
    return mm;
  }
  return -1;
}

// Opt in to more than 48 KB of dynamic shared memory where a launch needs
// it; refuse what the device cannot give.
template <typename K>
int set_shared_memory(K kernel, size_t bytes) {
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
