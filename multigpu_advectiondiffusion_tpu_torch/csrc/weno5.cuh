// The WENO5 arithmetic the Burgers kernels share: the flux functions,
// the local Lax-Friedrichs split, the e-form WENO5 reconstruction and
// the face flux, each in the operation order of the plain PyTorch twin
// (ops/kernels/fused_burgers.py::stage_reference, ops/weno.py::
// _weno5_side_nd_e). Included by fused_burgers_stage.cu (K5) and
// slab_run_burgers.cu (K6, K3, K4, K2b), which compute the x and y faces
// in runs (face_run) and the z faces one at a time (face), and by
// whole_run_burgers2d.cu (K7/K7a), fused2d_sharded.cu (K8/K8b) and
// weno_axis.cu (K12); each is built with -fmad=false, so no product and
// sum are contracted into an FMA and every kernel rounds where the twin
// does.

#pragma once

#include <cuda_runtime.h>

namespace {

// constants as the JAX package forms them: a Python double rounded once
constexpr float EPS = (float)1e-6;
constexpr float C13 = (float)(13.0 / 12.0);
constexpr float S1 = (float)(1.0 / 6.0);
constexpr float S2 = (float)(2.0 * (1.0 / 6.0));
constexpr float S4 = (float)(4.0 * (1.0 / 6.0));
constexpr float S5 = (float)(5.0 * (1.0 / 6.0));
constexpr float SM2 = (float)(-2.0 * (1.0 / 6.0));
constexpr float D_LO = (float)0.1;
constexpr float D_MID = (float)0.6;
constexpr float D_HI = (float)0.3;

enum { BURGERS = 0, LINEAR = 1, BUCKLEY = 2 };

template <int FLUX>
__device__ __forceinline__ float flux_f(float w, float c) {
  if constexpr (FLUX == LINEAR) return c * w;
  // BUCKLEY: 4 w w / (4 w w + (1 - w)^2)
  const float q = 4.0f * w * w;
  const float o = 1.0f - w;
  return __fdiv_rn(q, q + o * o);
}

template <int FLUX>
__device__ __forceinline__ float flux_df(float w, float c) {
  if constexpr (FLUX == BURGERS) return w;
  if constexpr (FLUX == LINEAR) return c;
  // BUCKLEY: 8 w (1 - w) / (5 w w - 2 w + 1)^2
  const float q = 5.0f * w * w - 2.0f * w + 1.0f;
  return __fdiv_rn(8.0f * w * (1.0f - w), q * q);
}

// Lax-Friedrichs split of one value into f+ and f-
template <int FLUX>
__device__ __forceinline__ void split(float w, float c, float& fp,
                                      float& fm) {
  if constexpr (FLUX == BURGERS) {
    const float t = 0.5f * w;
    const float a = fabsf(w);
    fp = t * (t + a);
    fm = t * (t - a);
  } else {
    const float a = fabsf(flux_df<FLUX>(w, c));
    const float fu = flux_f<FLUX>(w, c);
    fp = 0.5f * (fu + a * w);
    fm = 0.5f * (fu - a * w);
  }
}

// One WENO5 reconstruction in e-form from its parts: the differences
// e0..e3, their curvature terms cd_i = C13*dd_i*dd_i (dd_i = e_{i+1} -
// e_i), h_i = 0.5*e_i and g_i = 1.5*e_i. Faces next to each other share
// most parts, so a run of faces computes each once (face_run).
template <bool WZ, bool MINUS>
__device__ __forceinline__ void weno5_side_parts(
    float e0, float e1, float e2, float e3, float cd0, float cd1, float cd2,
    float h0, float h1, float h2, float h3, float g1, float g2, float& num,
    float& den) {
  const float l0 = g1 - h0;  // 1.5 e1 - 0.5 e0
  const float l1 = h1 + h2;  // 0.5 e1 + 0.5 e2
  const float l2 = h3 - g2;  // 0.5 e3 - 1.5 e2
  const float b0 = cd0 + l0 * l0;
  const float b1 = cd1 + l1 * l1;
  const float b2 = cd2 + l2 * l2;
  const float s0 = b0 + EPS, s1 = b1 + EPS, s2 = b2 + EPS;
  const float d0 = MINUS ? D_LO : D_HI;
  const float d2 = MINUS ? D_HI : D_LO;
  float a0, a1, a2;
  if constexpr (WZ) {
    const float tau = fabsf(b0 - b2);
    a0 = d0 * (s0 + tau) * (s1 * s2);
    a1 = D_MID * (s1 + tau) * (s0 * s2);
    a2 = d2 * (s2 + tau) * (s0 * s1);
  } else {
    const float p0 = s1 * s2, p1 = s0 * s2, p2 = s0 * s1;
    a0 = d0 * (p0 * p0);
    a1 = D_MID * (p1 * p1);
    a2 = d2 * (p2 * p2);
  }
  float x0, x1, x2;
  if constexpr (MINUS) {
    x0 = S5 * e1 - S2 * e0;
    x1 = S1 * e1 + S2 * e2;
    x2 = S4 * e2 - S1 * e3;
  } else {
    x0 = S1 * e0 - S4 * e1;
    x1 = SM2 * e1 - S1 * e2;
    x2 = S2 * e3 - S5 * e2;
  }
  num = a0 * x0 + a1 * x1 + a2 * x2;
  den = a0 + a1 + a2;
}

// One WENO5 reconstruction in e-form: (numerator, denominator) of the
// deviation from the window's center (ops/weno.py::_weno5_side_nd).
template <bool WZ, bool MINUS>
__device__ __forceinline__ void weno5_side(float e0, float e1, float e2,
                                           float e3, float& num,
                                           float& den) {
  const float dd0 = e1 - e0, dd1 = e2 - e1, dd2 = e3 - e2;
  weno5_side_parts<WZ, MINUS>(e0, e1, e2, e3, C13 * dd0 * dd0,
                              C13 * dd1 * dd1, C13 * dd2 * dd2, 0.5f * e0,
                              0.5f * e1, 0.5f * e2, 0.5f * e3, 1.5f * e1,
                              1.5f * e2, num, den);
}

// Face flux right of the cell whose f+ window is p[0..4] (center p[2])
// and whose right neighbour's f- window is m[0..4] (center m[2]).
template <bool WZ>
__device__ __forceinline__ float face(const float* p, const float* m) {
  float nm, dm, np, dp;
  weno5_side<WZ, true>(p[1] - p[0], p[2] - p[1], p[3] - p[2], p[4] - p[3],
                       nm, dm);
  weno5_side<WZ, false>(m[1] - m[0], m[2] - m[1], m[3] - m[2], m[4] - m[3],
                        np, dp);
  return (p[2] + m[2]) + (nm * __frcp_rn(dm) + np * __frcp_rn(dp));
}

// The fluxes h[0..RUN) of RUN neighbouring faces along a line: face j
// is right of cell c + j, fp[0..RUN+4) are f+ of cells c-2 .. c+RUN+1
// and fm[0..RUN+4) f- of cells c-1 .. c+RUN+2. Each is face()'s
// arithmetic to the bit; the differences, curvatures and l-term
// products that neighbouring faces share are computed once.
template <bool WZ, int RUN>
__device__ __forceinline__ void face_run(const float* fp, const float* fm,
                                         float* h) {
  constexpr int NE = RUN + 3;  // differences a side
  float num[2][RUN], den[2][RUN];
#pragma unroll
  for (int side = 0; side < 2; ++side) {  // f+ (MINUS), then f-
    const float* f = side == 0 ? fp : fm;
    float e[NE], hh[NE], g[NE], cd[NE - 1];
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      e[q] = f[q + 1] - f[q];
      hh[q] = 0.5f * e[q];
      g[q] = 1.5f * e[q];
    }
#pragma unroll
    for (int q = 0; q < NE - 1; ++q) {
      const float dd = e[q + 1] - e[q];
      cd[q] = C13 * dd * dd;
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (side == 0)
        weno5_side_parts<WZ, true>(e[j], e[j + 1], e[j + 2], e[j + 3], cd[j],
                                   cd[j + 1], cd[j + 2], hh[j], hh[j + 1],
                                   hh[j + 2], hh[j + 3], g[j + 1], g[j + 2],
                                   num[0][j], den[0][j]);
      else
        weno5_side_parts<WZ, false>(e[j], e[j + 1], e[j + 2], e[j + 3],
                                    cd[j], cd[j + 1], cd[j + 2], hh[j],
                                    hh[j + 1], hh[j + 2], hh[j + 3], g[j + 1],
                                    g[j + 2], num[1][j], den[1][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j)
    h[j] = (fp[j + 2] + fm[j + 2]) + (num[0][j] * __frcp_rn(den[0][j]) +
                                      num[1][j] * __frcp_rn(den[1][j]));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace
