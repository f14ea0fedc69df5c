// Device code shared by the ionogram kernels (ionogram.cu, ionogram_mxu.cu):
// the physical constants, jnp.clip, the warp sum and mup_stable, the
// Appleton-Hartree group index with the analytic near-reflection margin.
// Every expression keeps the order of the plain PyTorch version; the
// sources are built without fast math and with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kCP = 8.97866275;      // plasma-frequency constant
constexpr double kGP = 2.799249247e10;  // gyrofrequency constant [Hz/T]
constexpr double kPI = 3.14159265358979323846;
constexpr double kDH = 1e-6;            // reflection backoff [km]
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T clip01(T x) {  // jnp.clip: NaN propagates
  x = x < T(0) ? T(0) : x;
  return x > T(1) ? T(1) : x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Segment index and fraction of the uniform-grid resample: i0 =
// clamp(floor(pos), 0, N-2), frac = clip(pos - i0, 0, 1).
template <typename T>
__device__ __forceinline__ int uniform_index(T pos, int N, T& frac) {
  T fl = floor(pos);
  fl = fl < T(0) ? T(0) : fl;
  fl = fl > T(N - 2) ? T(N - 2) : fl;
  const int i0 = (int)fl;
  frac = clip01(pos - T(i0));
  return i0;
}

// mu' with the near-reflection small quantity supplied analytically:
// expression for expression pallas_vh._mu_mup_stable_tile. Returns mu'
// (0 where not ok) and sets ok.
template <typename T, int MODE>
__device__ __forceinline__ T mup_stable(T X, T Y, T psi_deg, T eps_crit,
                                        T eps_max, bool& ok_out) {
  const bool use_an = (eps_crit < T(1e-3)) && (eps_crit <= eps_max);
  const T psi = psi_deg * T(kPI / 180.0);
  T sinp, cosp;  // one call, the same values as sin and cos
  if constexpr (sizeof(T) == 4) {
    sincosf(psi, &sinp, &cosp);
  } else {
    sincos(psi, &sinp, &cosp);
  }
  const T YT = Y * sinp;
  const T YL = Y * cosp;

  T Xm1, eps_u = T(0);
  if (MODE > 0) {
    Xm1 = use_an ? eps_crit : T(1) - X;
  } else {
    eps_u = use_an ? eps_crit : T(1) - X - Y;
    Xm1 = use_an ? Y + eps_u : T(1) - X;
  }

  const T YT2 = YT * YT;
  const T YL2 = YL * YL;
  const T beta = sqrt(T(0.25) * (YT2 * YT2) + YL2 * (Xm1 * Xm1));
  const T bsum = beta + T(0.5) * YT2;
  const bool b_ok = bsum > T(0);
  const T bsum_safe = b_ok ? bsum : T(1);
  const T s_term = b_ok ? YL2 * (Xm1 * Xm1) / bsum_safe : T(0);
  const T conj = Xm1 * Xm1 + s_term;

  T D_safe, under;
  bool d_ok;
  if (MODE > 0) {
    const T D = Xm1 + s_term;
    d_ok = D != T(0);
    D_safe = d_ok ? D : T(1);
    under = conj / D_safe;
  } else {
    const T D = Xm1 - T(0.5) * YT2 - beta;
    d_ok = D != T(0);
    D_safe = d_ok ? D : T(1);
    const T conj_safe = conj > T(0) ? conj : T(1);
    const T under_an =
        (Xm1 * Xm1) * eps_u * (Xm1 + Y) / (conj_safe * D_safe);
    under = use_an ? under_an : T(1) - X * Xm1 / D_safe;
    d_ok = d_ok && (!use_an || conj > T(0));
  }

  const bool u_ok = (under >= T(0)) && d_ok;
  const T mu = u_ok ? sqrt(under) : T(1);
  const bool bb_ok = beta > T(0);
  const T beta_safe = bb_ok ? beta : T(1);
  const bool m_ok = u_ok && bb_ok && (mu > T(0)) && (mu <= T(1));
  const T mu_safe = m_ok ? mu : T(1);

  T Xm1_nv = Xm1, D_nv = D_safe, mu_nv = mu_safe;
  if (MODE > 0 && use_an) {
    Xm1_nv = T(1);
    D_nv = T(1);
    mu_nv = T(1);
  }
  const T mm = T(MODE);
  const T dbetadX = -YL2 * Xm1_nv / beta_safe;
  const T dDdX = T(-1) + mm * dbetadX;
  const T dalphadY = YT * YT2 * sinp + T(2) * YL * (Xm1_nv * Xm1_nv) * cosp;
  const T dbetadY = T(0.5) * dalphadY / beta_safe;
  const T dDdY = -YT * sinp + mm * dbetadY;
  T dmudY = (X * Xm1_nv * dDdY) / (T(2) * mu_nv * (D_nv * D_nv));
  T dmudX = (T(1) / (T(2) * mu_nv * D_nv)) *
            (T(2) * X - T(1) + X * Xm1_nv / D_nv * dDdX);
  if (MODE > 0 && use_an) {
    // cancellation-free expansions with X == 1 - Xm1 (see the JAX source)
    const T cfac = b_ok ? YL2 / bsum_safe : T(0);
    const T onepr = T(1) + cfac * Xm1;
    const T T_st = T(-1) + cfac * (T(1) - T(2) * Xm1) -
                   YL2 / beta_safe * (T(1) - Xm1);
    dmudX = T_st / (T(2) * mu_safe * (onepr * onepr));
    const T q_st = cosp - YT * sinp * YL / bsum_safe;
    dmudY = X * YL * Xm1 * q_st /
            (T(2) * mu_safe * beta_safe * (onepr * onepr));
  }
  T mup = mu - (T(2) * X * dmudX + Y * dmudY);
  bool ok = m_ok && isfinite(mup);

  // per-element isotropic fallback for unmagnetised samples
  const bool iso_ok = Xm1 > T(0);
  const T iso_mup = T(1) / sqrt(iso_ok ? Xm1 : T(1));
  const bool unmag = fabs(Y) < T(1e-12);
  mup = unmag ? (iso_ok ? iso_mup : T(0)) : (ok ? mup : T(0));
  ok = (unmag && iso_ok) || (!unmag && ok);
  ok_out = ok && (mup > T(0)) && (mup <= T(1e7));
  return mup;
}

// One grid point's term mu' * dh of the quadrature (0 where mu' is not ok):
// d, bm, bp are the resampled density, |B| and psi at point q of P.
template <typename T, int MODE>
__device__ __forceinline__ T quad_term(T d, T bmv, T bpv, T span, T slope,
                                       T emax, T f, T ff, T mult_dh, T omm,
                                       int q, int P) {
  const T dh = (q == P - 1) ? T(kDH) : span * mult_dh;
  const T X = d * T(kCP * kCP) / ff;
  const T Y = bmv * T(kGP) / f;
  const T eps = slope * (span * omm + T(kDH));
  bool ok;
  const T mup = mup_stable<T, MODE>(X, Y, bpv, eps, emax, ok);
  return ok ? mup * dh : T(0);
}

}  // namespace
