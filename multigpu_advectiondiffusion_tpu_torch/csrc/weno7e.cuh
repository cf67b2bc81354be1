// The WENO7-JS face flux in the forward-difference e-form that the fused
// Burgers kernels evaluate at order 7 (reach R = 4): K5
// (fused_burgers_stage.cu), K6 (slab_run_burgers.cu) and K7/K7a
// (whole_run_burgers2d.cu). Each operation is the plain PyTorch twin's
// (ops/weno.py::_weno7_side_nd_e, ops/kernels/fused_burgers.py::
// _divergence), in its order; every includer is built with -fmad=false,
// so no product and sum are contracted into an FMA and the kernels round
// where the twin does.
//
// For the face between cells c and c+1 the minus window is f+ at cells
// c-3 .. c+3 and the plus window f- at c-2 .. c+4; the flux is
//   h = (f+[c] + f-[c+1]) + (nm * rcp(dm) + np * rcp(dp))
// with (nm, dm) and (np, dp) the unnormalized (numerator, denominator) of
// each side's deviation from its center cell.
//
// The alphas are the division-free d_k (prod_{j != k} s_j)^2, s_j =
// beta_j + eps, so they scale as beta^6: in float32 they overflow for
// split-flux jumps above about 3.6 (the JAX package's ops/weno.py note);
// bounded solver states stay under it.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "weno5.cuh"

namespace {

// each constant a Python double rounded once to f32, as the twin's
// float * tensor products round it
constexpr float W7_EPS = (float)1e-6;
constexpr float W7_D0 = (float)(1.0 / 35.0);
constexpr float W7_D1 = (float)(12.0 / 35.0);
constexpr float W7_D2 = (float)(18.0 / 35.0);
constexpr float W7_D3 = (float)(4.0 / 35.0);
// the candidates' coefficients ca / 12, formed as ca * (1.0 / 12.0)
#define W7_C(x) ((float)((x) * (1.0 / 12.0)))

// beta_k = (A ea + D eb + F ec) ea + (B eb + E ec) eb + C (ec ec), rows
// (A, B, C, D, E, F) of the JAX package's ops/weno.py::_B7
__device__ __forceinline__ float w7e_beta(float A, float B, float C, float D,
                                          float E, float F, float ea,
                                          float eb, float ec) {
  return (A * ea + D * eb + F * ec) * ea + (B * eb + E * ec) * eb +
         C * (ec * ec);
}

// One WENO7-JS reconstruction from the six differences e[0..6) of its
// window: (num, den) of the deviation from the window's center. MINUS is
// the u^- side (optimal weights d0..d3), else the u^+ side (d3..d0).
template <bool MINUS>
__device__ __forceinline__ void weno7e_side(const float* e, float& num,
                                            float& den) {
  const float s0 = w7e_beta(6649.0f, 45076.0f, 25729.0f, -33916.0f,
                            -63436.0f, 22778.0f, e[0], e[1], e[2]) +
                   W7_EPS;
  const float s1 = w7e_beta(3169.0f, 17236.0f, 6649.0f, -13036.0f,
                            -17116.0f, 5978.0f, e[1], e[2], e[3]) +
                   W7_EPS;
  const float s2 = w7e_beta(6649.0f, 17236.0f, 3169.0f, -17116.0f,
                            -13036.0f, 5978.0f, e[2], e[3], e[4]) +
                   W7_EPS;
  const float s3 = w7e_beta(25729.0f, 45076.0f, 6649.0f, -63436.0f,
                            -33916.0f, 22778.0f, e[3], e[4], e[5]) +
                   W7_EPS;
  const float p01 = s0 * s1;
  const float p23 = s2 * s3;
  const float m0 = s1 * p23, m1 = s0 * p23, m2 = p01 * s3, m3 = p01 * s2;
  const float a0 = (MINUS ? W7_D0 : W7_D3) * (m0 * m0);
  const float a1 = (MINUS ? W7_D1 : W7_D2) * (m1 * m1);
  const float a2 = (MINUS ? W7_D2 : W7_D1) * (m2 * m2);
  const float a3 = (MINUS ? W7_D3 : W7_D0) * (m3 * m3);
  float x0, x1, x2, x3;
  if constexpr (MINUS) {
    x0 = W7_C(3.0) * e[0] + W7_C(-10.0) * e[1] + W7_C(13.0) * e[2];
    x1 = W7_C(-1.0) * e[1] + W7_C(4.0) * e[2] + W7_C(3.0) * e[3];
    x2 = W7_C(1.0) * e[2] + W7_C(6.0) * e[3] + W7_C(-1.0) * e[4];
    x3 = W7_C(9.0) * e[3] + W7_C(-4.0) * e[4] + W7_C(1.0) * e[5];
  } else {
    x0 = W7_C(-1.0) * e[0] + W7_C(4.0) * e[1] + W7_C(-9.0) * e[2];
    x1 = W7_C(1.0) * e[1] + W7_C(-6.0) * e[2] + W7_C(-1.0) * e[3];
    x2 = W7_C(-3.0) * e[2] + W7_C(-4.0) * e[3] + W7_C(1.0) * e[4];
    x3 = W7_C(-13.0) * e[3] + W7_C(10.0) * e[4] + W7_C(-3.0) * e[5];
  }
  num = a0 * x0 + a1 * x1 + a2 * x2 + a3 * x3;
  den = a0 + a1 + a2 + a3;
}

#undef W7_C

// The fluxes h[0..RUN) of RUN neighbouring faces along a line: face j is
// right of cell c + j; fp[0..RUN+6) are f+ of cells c-3 .. c+RUN+2 and
// fm[0..RUN+6) f- of cells c-2 .. c+RUN+3. The first differences that
// neighbouring faces share are computed once; each face is face7e()'s
// arithmetic to the bit.
template <int RUN>
__device__ __forceinline__ void face7e_run(const float* fp, const float* fm,
                                           float* h) {
  constexpr int NE = RUN + 5;  // differences a side
  float ep[NE], em[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    ep[q] = fp[q + 1] - fp[q];
    em[q] = fm[q + 1] - fm[q];
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float nm, dm, np, dp;
    weno7e_side<true>(ep + j, nm, dm);
    weno7e_side<false>(em + j, np, dp);
    h[j] = (fp[j + 3] + fm[j + 3]) + (nm * __frcp_rn(dm) + np * __frcp_rn(dp));
  }
}

// Face flux right of the cell whose f+ window is p[0..7) (center p[3])
// and whose right neighbour's f- window is m[0..7) (center m[3]).
__device__ __forceinline__ float face7e(const float* p, const float* m) {
  float h;
  face7e_run<1>(p, m, &h);
  return h;
}

// The face helpers of the bodies that take the reach R as a template
// parameter: WENO5 (R = 3; weno5.cuh, WZ selecting the Z weights) or
// WENO7-JS (R = 4). fp[0..RUN+2R-2) are f+ of cells c-R+1 .. c+RUN+R-2
// and fm[0..RUN+2R-2) f- of cells c-R+2 .. c+RUN+R-1 for the faces right
// of cells c .. c+RUN-1.
template <int R, bool WZ, int RUN>
__device__ __forceinline__ void face_run_of(const float* fp, const float* fm,
                                            float* h) {
  static_assert(R == 3 || R == 4, "WENO5 or WENO7");
  if constexpr (R == 3)
    face_run<WZ, RUN>(fp, fm, h);
  else
    face7e_run<RUN>(fp, fm, h);
}

template <int R, bool WZ>
__device__ __forceinline__ float face_of(const float* p, const float* m) {
  if constexpr (R == 3)
    return face<WZ>(p, m);
  else
    return face7e(p, m);
}

// The host side of those bodies: f(Int<R>, Int<FLUX>, bool_constant<WZ>)
// for the instance of `flux` (0-2), `order` (7: R = 4, JS only; else R =
// 3) and `weno_z`, each entry's one switch over its instances; the
// caller checks the arguments first.
template <int V>
using Int = std::integral_constant<int, V>;

template <class F>
cudaError_t dispatch(int flux, int order, int weno_z, F&& f) {
  using std::false_type;
  using std::true_type;
  if (order == 7) {
    switch (flux) {
      case 0: return f(Int<4>{}, Int<BURGERS>{}, false_type{});
      case 1: return f(Int<4>{}, Int<LINEAR>{}, false_type{});
      default: return f(Int<4>{}, Int<BUCKLEY>{}, false_type{});
    }
  }
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: return f(Int<3>{}, Int<BURGERS>{}, false_type{});
    case 1: return f(Int<3>{}, Int<BURGERS>{}, true_type{});
    case 2: return f(Int<3>{}, Int<LINEAR>{}, false_type{});
    case 3: return f(Int<3>{}, Int<LINEAR>{}, true_type{});
    case 4: return f(Int<3>{}, Int<BUCKLEY>{}, false_type{});
    default: return f(Int<3>{}, Int<BUCKLEY>{}, true_type{});
  }
}

}  // namespace
