// One SSP-RK3 stage of 3-D Burgers / scalar conservation law with WENO5,
// fused into one kernel (K5).
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// fused_burgers.py::_stage_kernel (:352, built by _make_stage :688) for
// WENO5-JS/Z on one device. It computes the same function, not the same
// blocks:
//
//   rk  = b*(v + dt*rhs)            (stage 1, no u operand)
//   rk  = a*u + b*(v + dt*rhs)      (stages 2 and 3)
//   rhs = -((div_z + div_y) + div_x) [+ lap]
//   div = (h[i+1/2] - h[i-1/2]) * (1/dx)
//   h   = (f+[i] + f-[i+1]) + (nm * rcp(dm) + np * rcp(dp))
//
// with the local Lax-Friedrichs split f+- of v (for Burgers
// t*(t +- |v|), t = v/2; else (f(v) +- |f'(v)| v)/2), the e-form WENO5
// reconstruction (ops/weno.py::_weno5_side_nd_e) of each side as an
// unnormalized (numerator, denominator), lap the O4 Laplacian with taps
// c_j*nu/(12 dx^2) (z, y, x; j ascending), and, on the final stage of an
// adaptive run, max|f'(rk)| over every cell folded into *mx.
//
// Rounding: built with -fmad=false (ops/kernels/fused_burgers.py), so no
// product and sum are contracted into an FMA; the reciprocal is the
// IEEE-rounded __frcp_rn and the Buckley-Leverett quotients __fdiv_rn.
// Every operation is evaluated in the order of the plain PyTorch twin
// (ops/kernels/fused_burgers.py::stage_reference), so the two agree to
// the bit on the card.
//
// Layout: unsharded, the state is unpadded (nz, ny, nx) contiguous
// float32. Edge boundaries replicate the face value, so every neighbour
// index is clamped into the grid: there are no ghost cells to maintain.
// A shard of a z-slab mesh keeps zpad = 3 ghost planes below and above
// its (lz, ny, nx) block, (lz + 6, ny, nx), which the halo refresh
// rewrites from the neighbours after every stage (parallel/halo.py); a
// z neighbour index is clamped at the global z edges only (the TPU
// kernel's edge fill keys on global rows, fused_burgers.py:846-910), y
// and x as before. The split schedule's calls write the planes
// [k_begin, k_end) of the block and may take the ghost planes below or
// above from the exchanged operands lo/hi ((3, ny, nx) each).
//
// Aliasing: the third stage runs in place (u == out). That is safe
// because each thread reads u only at its own cell, before it writes
// that cell, and v is always a different buffer from out.
//
// Wave-speed maximum: |f'| >= 0, so a float's order equals its bits'
// order as an unsigned int, and a NaN (positive after fabsf) lies above
// +inf: an integer max keeps it, as jnp.max does, so a NaN poisons dt.
// Each block reduces its cells (warp __reduce_max_sync, then shared
// memory) and does one atomicMax on *mx, which the host entry point
// zeroes on the stream before the launch.
//
// Bound on an H100: f32 operations. The count below is the twin's
// operation sequence with each face computed once and the first
// differences and curvatures shared between neighbouring faces (as the
// TPU z sweep shares them); an abs, a negation, a reciprocal and a
// division each count as one operation, as on the data sheet. Per cell,
// WENO5-JS, Burgers flux, viscous:
//   split: t = v/2, |v|, t+|v|, t-|v|, two products         6
//   per axis                                               103
//     first differences of f+ and f-                         2
//     curvatures (difference, two products), both sides      6
//     two reconstructions of 43 (l-terms 9, betas 6, +eps 3,
//       alphas 9, candidates 9, numerator 5, denominator 2) 86
//     h: two reciprocals, two products, three sums           7
//     divergence: difference, product                        2
//   three axes                                             309
//   sum and negation of the divergences                      3
//   Laplacian: 15 products, 14 sums, added to rhs           30
//   combine: dt*rhs, v+, b*, a*u, +  (stage 1: 3)            5
//   total, stages 2-3 (stage 1: 351)                       353
// WENO5-Z adds 5 a reconstruction (tau and the Z alphas), 30 a cell;
// an inviscid run saves 30. At 512^3 that is 47.4 G operations a stage:
// 0.707 ms at 67 TFLOP/s. Bytes are 8 / 12 a cell (v read, u read for
// stages 2-3, out written): 0.32 / 0.48 ms at 3.35 TB/s. So the stage is
// bound by operations, and a step by about 2.1 ms.
//
// Design (simple and right first): one thread per (y, x) column marches
// a chunk of z planes (zchunk). The split fluxes of seven z planes live
// in a register window, so each z face is computed once within a chunk
// (once more where chunks meet). Each y and x face is computed twice,
// once for each of its two cells, from seven neighbours loaded through
// L1 and split again, and every face recomputes its differences and
// curvatures: 717 operations a cell, 2.03x the count above. The
// reference's
// Burgers3d_WENO5_SharedMem (kernels.cu:212-272) computes each face once
// from shared-memory tiles; that redesign is left for later work.

#include <cuda_runtime.h>

#include "weno5.cuh"

namespace {

constexpr int BX = 32;  // threads along x: one warp spans 32 columns
constexpr int BY = 8;   // threads along y
constexpr int NWARPS = BX * BY / 32;

struct Params {
  float inv_dx[3];  // z, y, x
  float lap[15];    // viscous taps, z/y/x by j; unused when !viscous
  int viscous;
  float c;          // speed of the linear flux
  float a, b;       // stage combination
};

// Where the z planes of a launch lie: the block's planes start zpad rows
// into the buffer, its plane k is global plane k + oz of gnz, and the
// launch writes the planes [k_begin, k_end).
struct ZGeometry {
  int zpad, gnz, oz, k_begin, k_end;
};

// Buffer plane of the z neighbour of block plane k at global offset d,
// clamped at the global z edges; rows in the ghost region come from
// lo/hi where one is given. Unsharded, the plane clamped into [0, nz).
template <bool SHARDED, bool OPERANDS>
__device__ __forceinline__ const float* zplane(const float* v,
                                               const float* lo,
                                               const float* hi, int k, int d,
                                               int nz, long long P,
                                               const ZGeometry& g) {
  if (!SHARDED) return v + clampi(k + d, 0, nz - 1) * P;
  const int row = clampi(k + d + g.oz, 0, g.gnz - 1) - g.oz + g.zpad;
  if (OPERANDS && lo != nullptr && row < g.zpad) return lo + row * P;
  if (OPERANDS && hi != nullptr && row >= nz + g.zpad)
    return hi + (row - nz - g.zpad) * P;
  return v + row * P;
}

// SHARDED and OPERANDS are compile-time so that the unsharded launch
// (SHARDED false: no ghost planes, every plane, no operands) carries none
// of the sharded geometry's arithmetic or tests.
template <int FLUX, bool WZ, bool SHARDED, bool OPERANDS>
__global__ void __launch_bounds__(BX * BY)
stage_kernel(const float* __restrict__ v, const float* u, float* out,
             const float* __restrict__ lo, const float* __restrict__ hi,
             int nz, int ny, int nx, int zchunk, ZGeometry g, Params p,
             const float* __restrict__ dt_ptr, unsigned int* mx) {
  const int i = blockIdx.x * BX + threadIdx.x;  // x index
  const int j = blockIdx.y * BY + threadIdx.y;  // y index
  const bool valid = i < nx && j < ny;
  const int k0 = (SHARDED ? g.k_begin : 0) + blockIdx.z * zchunk;
  const int k1 = min(k0 + zchunk, SHARDED ? g.k_end : nz);
  unsigned int mbits = 0u;  // max |f'(rk)| of this thread, as bits

  if (valid) {
    const long long P = (long long)ny * nx;  // plane stride
    const long long col = (long long)j * nx + i;
    const float dt = *dt_ptr;
    const float c = p.c;

    // clamped (edge) neighbour offsets, q = 0..6 for offset q-3
    int oy[7], ox[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      oy[q] = (clampi(j + q - 3, 0, ny - 1) - j) * nx;
      ox[q] = clampi(i + q - 3, 0, nx - 1) - i;
    }

    // z window: planes k-3..k+3 of v and its split
    float W[7], Zp[7], Zm[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      W[q] = zplane<SHARDED, OPERANDS>(v, lo, hi, k0, q - 3, nz, P, g)[col];
      split<FLUX>(W[q], c, Zp[q], Zm[q]);
    }
    float hz_lo = face<WZ>(&Zp[0], &Zm[1]);  // face k0-1/2

    for (int k = k0; k < k1; ++k) {
      const long long cell = (long long)(SHARDED ? k + g.zpad : k) * P + col;
      const float hz_hi = face<WZ>(&Zp[1], &Zm[2]);  // face k+1/2
      const float dz = (hz_hi - hz_lo) * p.inv_dx[0];

      float Y[7], Yp[7], Ym[7];
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        Y[q] = q == 3 ? W[3] : v[cell + oy[q]];
        split<FLUX>(Y[q], c, Yp[q], Ym[q]);
      }
      const float dy =
          (face<WZ>(&Yp[1], &Ym[2]) - face<WZ>(&Yp[0], &Ym[1])) * p.inv_dx[1];

      float X[7], Xp[7], Xm[7];
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        X[q] = q == 3 ? W[3] : v[cell + ox[q]];
        split<FLUX>(X[q], c, Xp[q], Xm[q]);
      }
      const float dx =
          (face<WZ>(&Xp[1], &Xm[2]) - face<WZ>(&Xp[0], &Xm[1])) * p.inv_dx[2];

      float rhs = -(dz + dy + dx);
      if (p.viscous) {
        float acc = W[1] * p.lap[0];
#pragma unroll
        for (int q = 1; q < 5; ++q) acc = acc + W[q + 1] * p.lap[q];
#pragma unroll
        for (int q = 0; q < 5; ++q) acc = acc + Y[q + 1] * p.lap[5 + q];
#pragma unroll
        for (int q = 0; q < 5; ++q) acc = acc + X[q + 1] * p.lap[10 + q];
        rhs = rhs + acc;
      }
      float rk = p.b * (W[3] + dt * rhs);
      if (u != nullptr) rk = p.a * u[cell] + rk;
      out[cell] = rk;
      if (mx != nullptr) {
        const unsigned int bits = __float_as_uint(fabsf(flux_df<FLUX>(rk, c)));
        mbits = bits > mbits ? bits : mbits;
      }

      // slide the z window one plane up
      hz_lo = hz_hi;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        W[q] = W[q + 1];
        Zp[q] = Zp[q + 1];
        Zm[q] = Zm[q + 1];
      }
      // a shard's plane k+4 lies in its buffer only if it is needed
      if (!SHARDED || k + 1 < k1) {
        W[6] = zplane<SHARDED, OPERANDS>(v, lo, hi, k, 4, nz, P, g)[col];
        split<FLUX>(W[6], c, Zp[6], Zm[6]);
      }
    }
  }

  if (mx != nullptr) {  // uniform across the launch
    __shared__ unsigned int warp_max[NWARPS];
    const int tid = threadIdx.y * BX + threadIdx.x;
    const unsigned int w = __reduce_max_sync(0xffffffffu, mbits);
    if ((tid & 31) == 0) warp_max[tid >> 5] = w;
    __syncthreads();
    if (tid == 0) {
      unsigned int m = warp_max[0];
#pragma unroll
      for (int q = 1; q < NWARPS; ++q) m = warp_max[q] > m ? warp_max[q] : m;
      atomicMax(mx, m);
    }
  }
}

template <int FLUX, bool WZ, bool SHARDED, bool OPERANDS>
void launch_as(const float* v, const float* u, float* out, const float* lo,
            const float* hi, int nz, int ny, int nx, int zchunk,
            const ZGeometry& g, const Params& p, const float* dt,
            unsigned int* mx, cudaStream_t s) {
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY,
                  (g.k_end - g.k_begin + zchunk - 1) / zchunk);
  stage_kernel<FLUX, WZ, SHARDED, OPERANDS><<<grid, block, 0, s>>>(
      v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, mx);
}

template <int FLUX, bool WZ>
void launch(const float* v, const float* u, float* out, const float* lo,
            const float* hi, int nz, int ny, int nx, int zchunk,
            const ZGeometry& g, const Params& p, const float* dt,
            unsigned int* mx, cudaStream_t s) {
  if (lo != nullptr || hi != nullptr)
    launch_as<FLUX, WZ, true, true>(v, u, out, lo, hi, nz, ny, nx, zchunk, g,
                                    p, dt, mx, s);
  else if (g.zpad != 0 || g.k_begin != 0 || g.k_end != nz)
    launch_as<FLUX, WZ, true, false>(v, u, out, lo, hi, nz, ny, nx, zchunk,
                                     g, p, dt, mx, s);
  else
    launch_as<FLUX, WZ, false, false>(v, u, out, lo, hi, nz, ny, nx, zchunk,
                                      g, p, dt, mx, s);
}

}  // namespace

// Launch one stage on `stream`. `nz` is the block's plane count (the
// buffer holds nz + 2*zpad planes, zpad 0 or 3); `zgeo` points to 4 host
// ints: zpad, the global plane count, the block's global z offset and
// mx_init. `u` is null for stage 1 and may equal `out` (in-place stage
// 3). `dt` points to one float on the device. `flux` is 0 (Burgers), 1
// (linear, speed `c`) or 2 (Buckley-Leverett); `weno_z` selects the
// WENO5-Z weights. `inv_dx` points to 3 host floats (z, y, x) and `lap`
// to 15 host floats, or is null for an inviscid run. Only the block's
// planes [k_begin, k_end) are written; `lo`/`hi`, when not null, hold the
// zpad ghost planes below/above (the split schedule's operands). `mx`,
// when not null, points to one float on the device that receives
// max|f'(out)| over the planes written (zeroed here first, on the
// stream, when mx_init is not 0; else folded into its value). Returns
// the first CUDA error (0 on success); does not synchronise.
extern "C" int fused_burgers_stage(const float* v, const float* u,
                                   float* out, int nz, int ny, int nx,
                                   const float* dt, int flux, float c,
                                   int weno_z, const float* inv_dx,
                                   const float* lap, float a, float b,
                                   float* mx, int zchunk, const int* zgeo,
                                   int k_begin, int k_end, const float* lo,
                                   const float* hi, void* stream) {
  const ZGeometry g{zgeo[0], zgeo[1], zgeo[2], k_begin, k_end};
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 || flux < 0 || flux > 2 ||
      k_begin < 0 || k_end > nz || k_begin >= k_end || g.zpad < 0 ||
      (g.zpad == 0 && (g.gnz != nz || g.oz != 0)) ||
      (g.zpad > 0 && g.zpad < 3) || g.oz < 0 || g.oz + nz > g.gnz)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int q = 0; q < 3; ++q) p.inv_dx[q] = inv_dx[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 15; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.a = a;
  p.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* m = reinterpret_cast<unsigned int*>(mx);
  if (m != nullptr && zgeo[3] != 0) {
    const cudaError_t e = cudaMemsetAsync(m, 0, sizeof(unsigned int), s);
    if (e != cudaSuccess) return (int)e;
  }
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: launch<BURGERS, false>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, m, s); break;
    case 1: launch<BURGERS, true>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, m, s); break;
    case 2: launch<LINEAR, false>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, m, s); break;
    case 3: launch<LINEAR, true>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, m, s); break;
    case 4: launch<BUCKLEY, false>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, m, s); break;
    default: launch<BUCKLEY, true>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, m, s); break;
  }
  return (int)cudaGetLastError();
}
