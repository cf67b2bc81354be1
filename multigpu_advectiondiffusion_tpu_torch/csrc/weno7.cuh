// The WENO7-JS face flux in the classical q-form, its betas written on
// forward differences, in the operation order of the plain PyTorch twin
// (ops/weno.py::_weno7_betas, _weno7_weights, _weno7_minus,
// _weno7_plus): every product and sum as Python evaluates the
// expression, left to right, each division a true (IEEE-rounded)
// division. Included by weno_axis.cu (K12), which is built with
// -fmad=false, so no product and sum are contracted into an FMA and the
// kernel rounds where the twin does.
//
// The q-form weights, not the single-division e-form, because this
// per-axis op takes arbitrary data: the e-form raises betas to the 6th
// power and overflows for split-flux jumps above ~3.6 (the JAX
// package's ops/pallas/weno.py::_face_flux note).

#pragma once

#include <cuda_runtime.h>

namespace {

// optimal linear weights of the minus side (WENO7resAdv_X.m:85), each a
// Python double rounded once to f32
constexpr float D7_0 = (float)(1.0 / 35.0);
constexpr float D7_1 = (float)(12.0 / 35.0);
constexpr float D7_2 = (float)(18.0 / 35.0);
constexpr float D7_3 = (float)(4.0 / 35.0);
constexpr float EPS7 = (float)1e-6;

// The betas as quadratic forms on the forward differences e_j = q[j+1] -
// q[j] of each stencil's window: rows (A, B, C, D, E, F) of the JAX
// package's ops/weno.py::_B7, each evaluated as
// (A ea + D eb + F ec) ea + (B eb + E ec) eb + C (ec ec) with
// (ea, eb, ec) = (e_k, e_{k+1}, e_{k+2}). Exactly the classical value
// form's betas (WENO7resAdv_X.m:60-83), but without its 1e5-scale
// products of values that cancel on smooth data.
__device__ __forceinline__ float weno7_beta(float A, float B, float C,
                                            float D, float E, float F,
                                            float ea, float eb, float ec) {
  return (A * ea + D * eb + F * ec) * ea + (B * eb + E * ec) * eb +
         C * (ec * ec);
}

__device__ __forceinline__ void weno7_betas(const float* q, float& b0,
                                            float& b1, float& b2,
                                            float& b3) {
  float e[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) e[j] = q[j + 1] - q[j];
  b0 = weno7_beta(6649.0f, 45076.0f, 25729.0f, -33916.0f, -63436.0f,
                  22778.0f, e[0], e[1], e[2]);
  b1 = weno7_beta(3169.0f, 17236.0f, 6649.0f, -13036.0f, -17116.0f,
                  5978.0f, e[1], e[2], e[3]);
  b2 = weno7_beta(6649.0f, 17236.0f, 3169.0f, -17116.0f, -13036.0f,
                  5978.0f, e[2], e[3], e[4]);
  b3 = weno7_beta(25729.0f, 45076.0f, 6649.0f, -63436.0f, -33916.0f,
                  22778.0f, e[3], e[4], e[5]);
}

// alpha_k = d_k / (eps + b_k)^2, normalized by one reciprocal of the sum
__device__ __forceinline__ float weno7_alpha(float d, float b) {
  const float s = EPS7 + b;
  return __fdiv_rn(d, s * s);
}

template <bool MINUS>
__device__ __forceinline__ float weno7_side(const float* q) {
  const float m3 = q[0], m2 = q[1], m1 = q[2], c = q[3], p1 = q[4],
              p2 = q[5], p3 = q[6];
  float b0, b1, b2, b3;
  weno7_betas(q, b0, b1, b2, b3);
  const float a0 = weno7_alpha(MINUS ? D7_0 : D7_3, b0);
  const float a1 = weno7_alpha(MINUS ? D7_1 : D7_2, b1);
  const float a2 = weno7_alpha(MINUS ? D7_2 : D7_1, b2);
  const float a3 = weno7_alpha(MINUS ? D7_3 : D7_0, b3);
  const float inv = __fdiv_rn(1.0f, a0 + a1 + a2 + a3);
  const float w0 = a0 * inv, w1 = a1 * inv, w2 = a2 * inv, w3 = a3 * inv;
  float num;
  if constexpr (MINUS) {
    num = w0 * (-3.0f * m3 + 13.0f * m2 - 23.0f * m1 + 25.0f * c) +
          w1 * (m2 - 5.0f * m1 + 13.0f * c + 3.0f * p1) +
          w2 * (-m1 + 7.0f * c + 7.0f * p1 - p2) +
          w3 * (3.0f * c + 13.0f * p1 - 5.0f * p2 + p3);
  } else {
    num = w0 * (m3 - 5.0f * m2 + 13.0f * m1 + 3.0f * c) +
          w1 * (-m2 + 7.0f * m1 + 7.0f * c - p1) +
          w2 * (3.0f * m1 + 13.0f * c - 5.0f * p1 + p2) +
          w3 * (25.0f * c - 23.0f * p1 + 13.0f * p2 - 3.0f * p3);
  }
  return __fdiv_rn(num, 12.0f);
}

// Face flux whose minus window is p[0..6] (f+ of the cells left of the
// face and three right of it) and plus window m[0..6] (f- one cell on).
__device__ __forceinline__ float face7(const float* p, const float* m) {
  return weno7_side<true>(p) + weno7_side<false>(m);
}

}  // namespace
