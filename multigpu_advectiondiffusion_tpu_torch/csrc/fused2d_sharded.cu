// One SSP-RK3 stage of the 2-D O4 heat equation or of 2-D Burgers/WENO5
// or WENO7-JS over a shard of a device mesh (K8), or over a row window of
// it (K8b).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// fused2d_sharded.py::_make_stage (:170, call site :195) and
// ::_make_band_stage (:206, call site :231), with the stage bodies
// _diffusion_stage (:143) and _burgers_stage (:121). There a 2-D shard
// fits VMEM whole, so each stage is one whole-array block; the split
// schedule's band calls take a row slice of the buffer with the exchanged
// ghost rows concatenated onto it. Here one thread computes one cell, and
// a launch writes the interior rows [r_begin, r_end) of the shard only:
// the whole shard (K8) or one of the split schedule's three bands (K8b),
// whose edge bands read the ghost rows from the exchanged operands lo and
// hi in place of the buffer's (no concatenation).
//
// Diffusion (kind 0), the per-cell arithmetic of K7's diffusion stage
// (csrc/whole_run_diffusion2d.cu) with global masks:
//   out = where(interior, rk, where(face, bc_value, v))
//   rk  = b*(v + dt*acc)  (stage 1),  a*u + b*(v + dt*acc)  (stages 2, 3)
//   acc = sum over axes y, x, taps j = 0..4 of taps[axis][j] * v[j-2]
// summed in that order with __fmul_rn/__fadd_rn, "interior" the cells
// >= band away from every GLOBAL face and "face" the cells on one. The
// layout is the shard padded by R = 2, (ly+4, lx+4); the ghost ring holds
// the wall value at a global wall and neighbour data elsewhere (the halo
// refresh, parallel/halo.py).
//
// Burgers (kind 1), the per-cell arithmetic of K7's Burgers stage
// (csrc/whole_run_burgers2d.cu) on the shard padded by the reach R (3 at
// WENO5, 4 at WENO7; (ly+2R, lx+2R)): the local Lax-Friedrichs split, the
// e-form WENO5 or WENO7 face fluxes (weno7e.cuh::face_of<R, WZ>, K7's),
// rhs = -(div_y + div_x) [+ the O4 viscous taps], rk = b*(v + dt*rhs)
// and a*u + rk. A neighbour outside the GLOBAL domain is the nearest
// global edge cell (the TPU body's _edge_fill_global, read as K7 clamps),
// which lies in this shard; a neighbour in another shard is read from
// the ghost rows or columns the refresh (or the exchanged operand) left.
// dt is read from the device; with `mx` the stage folds max|f'(out)| over
// the cells it writes into *mx (the adaptive step's wave speed). Built
// with -fmad=false, as K7 is: every operation rounds where K7's does, so
// a sharded run equals K7's unsharded run to the bit.
//
// Aliasing: the third stage runs in place (u == out). Each thread reads u
// only at its own cell before writing it, and v is never out.
//
// Bound on an H100: K8 on the main shard (200x400 of 400^2 on dy=2) must
// move 8 B a cell (12 with u), 0.64-0.96 MB, 0.19-0.29 us at 3.35 TB/s;
// diffusion's 22-24 f32 operations a cell take 0.03 us at 67 TFLOP/s,
// Burgers' 219-239 (each face once; WENO7 about 460) 0.3-0.6 us: both are
// launch-bound at this size (a launch costs a few us), and the 2-D mesh
// path is bound by the host's exchange between stages (PERF.md). The
// Burgers body computes each face twice, from the 2R + 1 neighbours of a
// line split again a cell.

#include <cuda_runtime.h>

#include "weno5.cuh"
#include "weno7e.cuh"

namespace {

constexpr int BX = 32;  // threads along x: one warp spans 32 columns
constexpr int BY = 8;   // threads along y
constexpr int NWARPS = BX * BY / 32;

// ghost depth of the diffusion layout: the O4 reach (the Burgers layout's
// is the WENO reach R, a template parameter)
constexpr int H_DIFFUSION = 2;

// A launch's place in the global grid.
struct Geometry {
  int ly, lx;          // local interior shape
  int gy, gx;          // global interior shape
  int oy, ox;          // global index of local interior cell (0, 0)
  int r_begin, r_end;  // local interior rows written
};

// Padded row `r` (a local interior row index, -h <= r < ly + h) of the
// stage input: from the exchanged operand lo (r < 0) or hi (r >= ly)
// where one is given, else from the buffer.
template <int H, bool OPERANDS>
__device__ __forceinline__ const float* in_row(const float* v,
                                               const float* lo,
                                               const float* hi, int r,
                                               const Geometry& g,
                                               long long X) {
  if (OPERANDS) {
    if (lo != nullptr && r < 0) return lo + (long long)(r + H) * X;
    if (hi != nullptr && r >= g.ly) return hi + (long long)(r - g.ly) * X;
  }
  return v + (long long)(r + H) * X;
}

struct DiffusionParams {
  float taps[10];  // [axis y, x][tap j]
  float dt, a, b, bc_value;
  int band;
};

template <bool HAS_U, bool OPERANDS>
__global__ void __launch_bounds__(BX * BY)
diffusion_kernel(const float* v, const float* u, float* out,
                 const float* lo, const float* hi, Geometry g,
                 DiffusionParams p) {
  constexpr int H = H_DIFFUSION;
  const int i = blockIdx.x * BX + threadIdx.x;                // local x
  const int j = g.r_begin + blockIdx.y * BY + threadIdx.y;  // local y
  if (i >= g.lx || j >= g.r_end) return;
  const long long X = g.lx + 2 * H;  // row stride
  const long long c = (long long)(j + H) * X + (i + H);
  const int col = i + H;
  const float vc = v[c];
  const float* t = p.taps;

  float acc = __fmul_rn(in_row<H, OPERANDS>(v, lo, hi, j - 2, g, X)[col],
                        t[0]);
  acc = __fadd_rn(
      acc, __fmul_rn(in_row<H, OPERANDS>(v, lo, hi, j - 1, g, X)[col], t[1]));
  acc = __fadd_rn(acc, __fmul_rn(vc, t[2]));
  acc = __fadd_rn(
      acc, __fmul_rn(in_row<H, OPERANDS>(v, lo, hi, j + 1, g, X)[col], t[3]));
  acc = __fadd_rn(
      acc, __fmul_rn(in_row<H, OPERANDS>(v, lo, hi, j + 2, g, X)[col], t[4]));

  acc = __fadd_rn(acc, __fmul_rn(v[c - 2], t[5]));
  acc = __fadd_rn(acc, __fmul_rn(v[c - 1], t[6]));
  acc = __fadd_rn(acc, __fmul_rn(vc, t[7]));
  acc = __fadd_rn(acc, __fmul_rn(v[c + 1], t[8]));
  acc = __fadd_rn(acc, __fmul_rn(v[c + 2], t[9]));

  float rk = __fmul_rn(p.b, __fadd_rn(vc, __fmul_rn(p.dt, acc)));
  if (HAS_U) rk = __fadd_rn(__fmul_rn(p.a, u[c]), rk);

  const int gj = j + g.oy, gi = i + g.ox;  // global y, x
  const bool interior = gj >= p.band && gj < g.gy - p.band &&
                        gi >= p.band && gi < g.gx - p.band;
  const bool face = gj == 0 || gj == g.gy - 1 || gi == 0 || gi == g.gx - 1;
  out[c] = interior ? rk : (face ? p.bc_value : vc);
}

struct BurgersParams {
  float inv_dx[2];  // y, x
  float lap[10];    // viscous taps, y/x by j; unused when !viscous
  int viscous;
  float c;          // speed of the linear flux
  float a, b;
};

template <int R, int FLUX, bool WZ, bool HAS_U, bool OPERANDS>
__global__ void __launch_bounds__(BX * BY)
burgers_kernel(const float* v, const float* u, float* out, const float* lo,
               const float* hi, Geometry g, BurgersParams p,
               const float* dt_ptr, unsigned int* mx) {
  constexpr int H = R;       // the layout's ghost depth is the reach
  constexpr int N = 2 * R + 1;  // a line's cells, j-R .. j+R
  const int i = blockIdx.x * BX + threadIdx.x;                // local x
  const int j = g.r_begin + blockIdx.y * BY + threadIdx.y;  // local y
  // every thread reaches the block's reduction below
  const bool active = i < g.lx && j < g.r_end;
  unsigned int mbits = 0u;
  if (active) {
    const float dt = *dt_ptr;
    const float c = p.c;
    const long long X = g.lx + 2 * H;  // row stride
    const float* vrow = v + (long long)(j + H) * X + H;  // interior col 0
    const float vc = vrow[i];

    float Y[N], Yp[N], Ym[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == R) {
        Y[r] = vc;
      } else {
        // clamped at the global edges only
        const int jj = clampi(j + r - R + g.oy, 0, g.gy - 1) - g.oy;
        Y[r] = in_row<H, OPERANDS>(v, lo, hi, jj, g, X)[i + H];
      }
      split<FLUX>(Y[r], c, Yp[r], Ym[r]);
    }
    const float dy = (face_of<R, WZ>(&Yp[1], &Ym[2]) -
                      face_of<R, WZ>(&Yp[0], &Ym[1])) * p.inv_dx[0];

    float Xv[N], Xp[N], Xm[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      Xv[r] = r == R ? vc
                     : vrow[clampi(i + r - R + g.ox, 0, g.gx - 1) - g.ox];
      split<FLUX>(Xv[r], c, Xp[r], Xm[r]);
    }
    const float dx = (face_of<R, WZ>(&Xp[1], &Xm[2]) -
                      face_of<R, WZ>(&Xp[0], &Xm[1])) * p.inv_dx[1];

    float rhs = -(dy + dx);
    if (p.viscous) {  // the O4 taps on cells j-2 .. j+2, i-2 .. i+2
      float acc = Y[R - 2] * p.lap[0];
#pragma unroll
      for (int r = 1; r < 5; ++r) acc = acc + Y[R - 2 + r] * p.lap[r];
#pragma unroll
      for (int r = 0; r < 5; ++r) acc = acc + Xv[R - 2 + r] * p.lap[5 + r];
      rhs = rhs + acc;
    }
    const long long cell = (long long)(j + H) * X + (i + H);
    float rk = p.b * (vc + dt * rhs);
    if (HAS_U) rk = p.a * u[cell] + rk;
    out[cell] = rk;
    if (mx != nullptr)
      mbits = __float_as_uint(fabsf(flux_df<FLUX>(rk, c)));
  }

  if (mx != nullptr) {  // uniform across the launch
    // |f'| >= 0, so a float's order is its bits' order as an unsigned int
    // (a NaN lies above +inf and is kept, as K7a keeps it)
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

dim3 grid_of(const Geometry& g) {
  return dim3((g.lx + BX - 1) / BX, (g.r_end - g.r_begin + BY - 1) / BY, 1);
}

template <bool OPERANDS>
void launch_diffusion(const float* v, const float* u, float* out,
                      const float* lo, const float* hi, const Geometry& g,
                      const DiffusionParams& p, cudaStream_t s) {
  const dim3 block(BX, BY, 1);
  if (u != nullptr)
    diffusion_kernel<true, OPERANDS><<<grid_of(g), block, 0, s>>>(
        v, u, out, lo, hi, g, p);
  else
    diffusion_kernel<false, OPERANDS><<<grid_of(g), block, 0, s>>>(
        v, u, out, lo, hi, g, p);
}

template <int R, int FLUX, bool WZ, bool OPERANDS>
void launch_burgers_as(const float* v, const float* u, float* out,
                       const float* lo, const float* hi, const Geometry& g,
                       const BurgersParams& p, const float* dt,
                       unsigned int* mx, cudaStream_t s) {
  const dim3 block(BX, BY, 1);
  if (u != nullptr)
    burgers_kernel<R, FLUX, WZ, true, OPERANDS><<<grid_of(g), block, 0, s>>>(
        v, u, out, lo, hi, g, p, dt, mx);
  else
    burgers_kernel<R, FLUX, WZ, false, OPERANDS><<<grid_of(g), block, 0, s>>>(
        v, u, out, lo, hi, g, p, dt, mx);
}

template <int R, int FLUX, bool WZ>
void launch_burgers(const float* v, const float* u, float* out,
                    const float* lo, const float* hi, const Geometry& g,
                    const BurgersParams& p, const float* dt,
                    unsigned int* mx, cudaStream_t s) {
  if (lo != nullptr || hi != nullptr)
    launch_burgers_as<R, FLUX, WZ, true>(v, u, out, lo, hi, g, p, dt, mx, s);
  else
    launch_burgers_as<R, FLUX, WZ, false>(v, u, out, lo, hi, g, p, dt, mx, s);
}

}  // namespace

// Launch one stage on `stream` over the interior rows geo[6]..geo[7] of a
// shard. `geo` points to 8 host ints: the local interior (ly, lx), the
// global interior (gy, gx), the shard's global offsets (oy, ox) and the
// rows [r_begin, r_end) written. `kind` 0 is diffusion (padded by 2;
// `coeffs` points to its 10 taps, with `band`, `bc_value` and `dt` by
// value), 1 Burgers (padded by the reach: 3 at `order` 5, 4 at order 7;
// `coeffs` points to inv_dx (y, x), `lap` to 10 viscous taps or is null,
// `dt_ptr` to one float on the device, `flux` 0 Burgers / 1 linear (speed
// `c`) / 2 Buckley-Leverett, `weno_z` the WENO5-Z weights (order 5 only),
// and `mx`, when not null, to one float on the
// device that receives max|f'(out)| over the rows written: zeroed first
// on the stream when mx_init is not 0, else folded into its value). `u`
// is null for stage 1 and may equal `out`. `lo`/`hi`, when not null, are
// (h, lx + 2h) rows that stand in for the ghost rows below/above the
// shard. Returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int fused2d_sharded_stage(
    const float* v, const float* u, float* out, const int* geo,
    const float* lo, const float* hi, int kind, const float* coeffs,
    const float* lap, int band, float bc_value, float dt,
    const float* dt_ptr, int flux, float c, int weno_z, int order, float a,
    float b, float* mx, int mx_init, void* stream) {
  const Geometry g{geo[0], geo[1], geo[2], geo[3],
                   geo[4], geo[5], geo[6], geo[7]};
  if (g.ly < 1 || g.lx < 1 || g.oy < 0 || g.ox < 0 || g.oy + g.ly > g.gy ||
      g.ox + g.lx > g.gx || g.r_begin < 0 || g.r_end > g.ly ||
      g.r_begin >= g.r_end || kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (mx != nullptr) return (int)cudaErrorInvalidValue;
    DiffusionParams p;
    for (int q = 0; q < 10; ++q) p.taps[q] = coeffs[q];
    p.dt = dt;
    p.a = a;
    p.b = b;
    p.bc_value = bc_value;
    p.band = band;
    if (lo != nullptr || hi != nullptr)
      launch_diffusion<true>(v, u, out, lo, hi, g, p, s);
    else
      launch_diffusion<false>(v, u, out, lo, hi, g, p, s);
    return (int)cudaGetLastError();
  }
  if (dt_ptr == nullptr || flux < 0 || flux > 2 ||
      (order != 5 && order != 7) || (order == 7 && weno_z))
    return (int)cudaErrorInvalidValue;
  BurgersParams p;
  for (int q = 0; q < 2; ++q) p.inv_dx[q] = coeffs[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 10; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.a = a;
  p.b = b;
  unsigned int* m = reinterpret_cast<unsigned int*>(mx);
  if (m != nullptr && mx_init != 0) {
    const cudaError_t e = cudaMemsetAsync(m, 0, sizeof(unsigned int), s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)dispatch(flux, order, weno_z, [&](auto r, auto fl, auto wz) {
    launch_burgers<decltype(r)::value, decltype(fl)::value,
                   decltype(wz)::value>(v, u, out, lo, hi, g, p, dt_ptr, m,
                                        s);
    return cudaGetLastError();
  });
}
