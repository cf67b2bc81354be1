// The WENO flux divergence along one axis of a float32 array padded by
// the stencil radius r on that axis: K12 (3-D, any sweep axis) and K12b
// (2-D) are this one kernel on the array viewed as (outer, n + 2r, inner).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// weno.py::flux_divergence_pallas (:184, pallas_call :248) and
// _flux_divergence_2d (:267, pallas_call :284). It computes the same
// function, not the same blocks:
//
//   out[k] = (h[k+1/2] - h[k-1/2]) * (1/dx)
//   WENO5 (r = 3): h = (f+[i] + f-[i+1]) + (nm * rcp(dm) + np * rcp(dp))
//     in the e-form of weno5.cuh::face, JS or Z weights;
//   WENO7 (r = 4): h = weno7_minus(f+ window) + weno7_plus(f- window)
//     in the q-form of weno7.cuh::face7, JS weights;
//
// with the local Lax-Friedrichs split f+- of u (weno5.cuh::split: Burgers
// t*(t +- |u|), t = u/2; else (f(u) +- |f'(u)| u)/2; fluxes Burgers,
// linear with speed c, Buckley-Leverett). Face f (0..n) has its minus
// window at padded positions f .. f+2r-2 and its plus window at
// f+1 .. f+2r-1.
//
// Rounding: built with -fmad=false (ops/kernels/weno.py), every division
// and reciprocal IEEE-rounded; every operation in the order of the plain
// PyTorch twin (ops/kernels/weno.py::flux_divergence_reference), so the
// two agree to the bit on the card. Each face is computed the same way
// wherever it is computed, so the chunking below changes no bit.
//
// Bound on an H100, per launch at 512^3: bytes move the padded array in
// once and the output out once, 4 (n + 2r + n) bytes a column cell:
// 1,080 MB, 0.322 ms at 3.35 TB/s. Operations, each face computed once
// (an abs, a reciprocal and a division count one each), per output cell:
//   split: Burgers 6, linear 7, Buckley-Leverett 22
//   WENO5-JS: first differences 2, curvatures 6, two reconstructions of
//     43, h 7, divergence 2: 103 (WENO5-Z: 113)
//   WENO7: two sides of 145 (betas 92, weights 20, candidates 25, their
//     weighted sum 7, /12 1), h 1, divergence 2: 293
// WENO5-JS with the Burgers flux: 109 a cell, 14.6 G operations at 512^3,
// 0.218 ms at 67 TFLOP/s, so WENO5 is bound by bytes; WENO7, 299 a cell,
// 0.60 ms, by operations.
//
// Design (simple and right first): one thread marches `chunk` cells of
// one (outer, inner) column along the sweep axis, keeping the split
// fluxes of the 2r padded positions its next face needs in registers, so
// each face within a chunk is computed once (once more where chunks
// meet). Consecutive threads take consecutive inner indices, so loads
// coalesce when the sweep axis is not the last; along the last axis
// (inner == 1) consecutive threads take consecutive chunks and share
// lines through L1. Shared-memory tiles and TMA are left to later work.

#include <cuda_runtime.h>

#include "weno5.cuh"
#include "weno7.cuh"

namespace {

constexpr int THREADS = 256;

template <int FLUX, int ORDER, bool WZ>
__global__ void __launch_bounds__(THREADS)
weno_axis_kernel(const float* __restrict__ up, float* __restrict__ out,
                 long long outer, int n, long long inner, int chunk,
                 int nchunks, float c, float inv_dx) {
  constexpr int R = ORDER == 7 ? 4 : 3;
  constexpr int W = 2 * R;  // padded positions a face needs
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= outer * nchunks * inner) return;
  const long long ii = t % inner;
  const long long rest = t / inner;
  const int ch = (int)(rest % nchunks);
  const long long o = rest / nchunks;
  const int k0 = ch * chunk;
  const int k1 = min(k0 + chunk, n);

  const long long np = n + 2 * R;
  const float* src = up + o * np * inner + ii;  // padded position 0
  float* dst = out + o * (long long)n * inner + ii;

  // split fluxes at padded positions f .. f+W-1 for the next face f
  float P[W], M[W];
#pragma unroll
  for (int q = 0; q < W; ++q)
    split<FLUX>(src[(long long)(k0 + q) * inner], c, P[q], M[q]);
  float h_lo;
  if constexpr (ORDER == 7) {
    h_lo = face7(&P[0], &M[1]);
  } else {
    h_lo = face<WZ>(&P[0], &M[1]);
  }
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int q = 0; q < W - 1; ++q) {
      P[q] = P[q + 1];
      M[q] = M[q + 1];
    }
    split<FLUX>(src[(long long)(k + W) * inner], c, P[W - 1], M[W - 1]);
    float h_hi;
    if constexpr (ORDER == 7) {
      h_hi = face7(&P[0], &M[1]);
    } else {
      h_hi = face<WZ>(&P[0], &M[1]);
    }
    dst[(long long)k * inner] = (h_hi - h_lo) * inv_dx;
    h_lo = h_hi;
  }
}

template <int FLUX, int ORDER, bool WZ>
void launch(const float* up, float* out, long long outer, int n,
            long long inner, int chunk, float c, float inv_dx,
            cudaStream_t s) {
  const int nchunks = (n + chunk - 1) / chunk;
  const long long threads = outer * nchunks * inner;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  weno_axis_kernel<FLUX, ORDER, WZ><<<(unsigned int)blocks, THREADS, 0, s>>>(
      up, out, outer, n, inner, chunk, nchunks, c, inv_dx);
}

template <int FLUX>
int dispatch(const float* up, float* out, long long outer, int n,
             long long inner, int chunk, int order, int wz, float c,
             float inv_dx, cudaStream_t s) {
  if (order == 7) {
    if (wz) return (int)cudaErrorInvalidValue;  // WENO7 is JS only
    launch<FLUX, 7, false>(up, out, outer, n, inner, chunk, c, inv_dx, s);
  } else if (order == 5) {
    if (wz)
      launch<FLUX, 5, true>(up, out, outer, n, inner, chunk, c, inv_dx, s);
    else
      launch<FLUX, 5, false>(up, out, outer, n, inner, chunk, c, inv_dx, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `up` is the contiguous float32 array viewed as (outer, n + 2r, inner),
// `out` as (outer, n, inner), r = 3 for order 5 and 4 for order 7. `flux`
// is 0 Burgers, 1 linear (speed `c`), 2 Buckley-Leverett; `wz` selects
// the WENO5-Z weights. Returns cudaGetLastError() after the launch (0 on
// success); does not synchronise.
extern "C" int weno_axis(const float* up, float* out, long long outer,
                         int n, long long inner, int chunk, int flux,
                         float c, int order, int wz, float inv_dx,
                         void* stream) {
  if (outer < 1 || n < 1 || inner < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const long long nchunks = (n + chunk - 1) / chunk;
  if ((outer * nchunks * inner + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flux) {
    case BURGERS:
      return dispatch<BURGERS>(up, out, outer, n, inner, chunk, order, wz, c,
                               inv_dx, s);
    case LINEAR:
      return dispatch<LINEAR>(up, out, outer, n, inner, chunk, order, wz, c,
                              inv_dx, s);
    case BUCKLEY:
      return dispatch<BUCKLEY>(up, out, outer, n, inner, chunk, order, wz, c,
                               inv_dx, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
