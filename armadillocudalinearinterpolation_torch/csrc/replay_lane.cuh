// The per-lane update of the schedule replay (replay.cu): K2's advance()
// of one lane through one event and its kick weight, and K2T's
// advance_directions(), the same advance once and the tangents of D
// directions.  The sweep of either kernel is these functions over a row's
// lanes; tools/kernel_resources.py counts their fp64 operations in a probe
// kernel that includes this header alone.  Build without --use_fast_math
// and with --fmad=false (see events.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// Event (j, dt) on one lane with state (vi, si), rate bi and kick weight
// wd = w(|lane - j|): the closed-form advance (e_t = exp(-dt) and de =
// drive (1 - e_t) are the same for every lane), the reset if the lane
// fires, the ring kick.  The one lane update of the kernel.
__device__ __forceinline__ void advance(double& vi, double& si, double bi,
                                        double wd, bool fires, double dt,
                                        double e_t, double de) {
  const double e_b = ::exp(-bi * dt);
  const double vn = vi * e_t + de + si * (e_b - e_t) / (1.0 - bi);
  vi = fires ? 0.0 : vn;
  si = si * e_b + bi * wd;
}

__device__ __forceinline__ double kick_weight(const double* w, int lane,
                                              int j, int N) {
  const int d = abs(lane - j);
  return w[min(d, N - d)];
}

// One direction's tangent (dvi, dsi) of a lane in state (vi, si), rate bi
// and rate tangent dbi, through the event (dt, e_t = exp(-dt)) whose d(dt)
// is ddt: e_b = exp(-bi dt), q = (e_b - e_t) / (1 - bi) and inv = 1 / (1 -
// bi) are the lane's; de_t = -e_t d(dt), de_b = -e_b (db dt + b d(dt)).
__device__ __forceinline__ void tangent_step(double& dvi, double& dsi,
                                             double vi, double si, double bi,
                                             double dbi, double ddt,
                                             double wd, bool fires,
                                             double dt, double e_t,
                                             double e_b, double q,
                                             double inv, double drive) {
  const double de_t = -e_t * ddt;
  const double de_b = -e_b * (dbi * dt + bi * ddt);
  const double dq = ((de_b - de_t) + q * dbi) * inv;
  const double dvn = dvi * e_t + vi * de_t - drive * de_t + dsi * q + si * dq;
  dvi = fires ? 0.0 : dvn;
  dsi = dsi * e_b + si * de_b + dbi * wd;
}

// advance() on lane i of a K2T CTA and the tangent of each of its D
// directions (db = dp[d] base[i]): the primal lines are advance()'s (bit
// for bit).  The arrays hold the CTA's lanes with a stride of `stride`
// values between one direction's and the next.
__device__ __forceinline__ void advance_directions(
    double* v, double* s, const double* b, const double* bs, double* dv,
    double* ds, int stride, int i, int D, const double* dp,
    const double* ddt, double wd, bool fires, double dt, double e_t,
    double de, double drive) {
  const double vi = v[i], si = s[i], bi = b[i];
  const double e_b = ::exp(-bi * dt);
  const double vn = vi * e_t + de + si * (e_b - e_t) / (1.0 - bi);
  // one division for the tangents: q = (e_b - e_t) / (1 - b) and its
  // derivative ((de_b - de_t) + q db) / (1 - b) by one reciprocal
  const double inv = 1.0 / (1.0 - bi);
  const double q = (e_b - e_t) * inv;
  const double base = bs[i];
  for (int d = 0; d < D; ++d) {
    const size_t o = (size_t)d * stride + i;
    double dvi = dv[o], dsi = ds[o];
    tangent_step(dvi, dsi, vi, si, bi, dp[d] * base, ddt[d], wd, fires, dt,
                 e_t, e_b, q, inv, drive);
    dv[o] = dvi;
    ds[o] = dsi;
  }
  v[i] = fires ? 0.0 : vn;
  s[i] = si * e_b + bi * wd;
}

}  // namespace
