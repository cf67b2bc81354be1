// N SSP-RK3 steps of 2-D Burgers / scalar conservation law with WENO5 in
// ONE cooperative kernel launch (K7, Burgers body; K7a, adaptive dt).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// whole_run.py::_kernel (:28, launched by whole_run :50; fixed dt) and
// ::_kernel_adaptive (:75, launched by whole_run_adaptive :107) with the
// stage body fused_burgers2d.py::_stage (:79), for WENO5-JS/Z on one
// device. There the Pallas grid is the iteration counter and the state
// lives in VMEM for the whole run. Here the counterpart is one persistent
// cooperative grid:
//
//   [adaptive: m = max|f'(S)| over every cell; grid.sync()]
//   for each of n_iters steps:
//     [adaptive: dt = cfl_dx / max(m, 1e-12); tacc += dt]
//     T1 = s(S)      ; grid.sync()
//     T2 = s(T1, S)  ; grid.sync()
//     S  = s(T2, S)  ; grid.sync()     (in place over S; adaptive: the
//                                        next m, max|f'| of the new S)
//   [adaptive: *t_sum = tacc]
//
// with s(v, u) the K5 stage with one axis fewer:
//   rk  = b*(v + dt*rhs)            (stage 1, no u operand)
//   rk  = a*u + b*(v + dt*rhs)      (stages 2 and 3)
//   rhs = -(div_y + div_x) [+ lap]
//   div = (h[i+1/2] - h[i-1/2]) * (1/dx)
//   h   = (f+[i] + f-[i+1]) + (nm * rcp(dm) + np * rcp(dp))
// the local Lax-Friedrichs split f+- of v, the e-form WENO5
// reconstruction (ops/weno.py::_weno5_side_nd_e) of each side, and lap the
// O4 Laplacian with taps c_j*nu/(12 dx^2) (y, x; j ascending).
//
// Rounding: built with -fmad=false (ops/kernels/fused_burgers2d.py), so no
// product and sum are contracted into an FMA; reciprocals are __frcp_rn,
// the Buckley-Leverett quotients and dt __fdiv_rn. Every operation is
// evaluated in the order of the plain twin
// (ops/kernels/fused_burgers.py::stage_reference, looped by
// ops/kernels/whole_run.py::plain_run/plain_run_adaptive), so the two
// agree to the bit.
//
// Layout: the state is unpadded (ny, nx) contiguous float32, at most
// 2^30 cells (32-bit cell indices; the grid-stride walk advances a
// cell's (y, x) by the stride's quotient and remainder). Edge
// boundaries replicate the face value, so every neighbour index is
// clamped into the grid: there are no ghost cells to re-synthesize after
// each stage (the TPU body's _edge_fill_2d).
//
// Adaptive dt (K7a). The maximum must be exact and the same in every
// block. |f'| >= 0, so a float's order equals its bits' order as an
// unsigned int, and a NaN (positive after fabsf) lies above +inf: an
// integer max keeps it, as jnp.max does. Each block reduces its cells
// (warp __reduce_max_sync, then shared memory) and does one atomicMax on
// one of two words, mx[k & 1] holding the maximum that step k reads and
// mx[(k & 1) ^ 1] receiving the next; block 0 zeroes the latter at the
// start of step k, which no thread reads again before step k+1 and no
// block raises before the stage-1 barrier. Every thread reads the word
// (a volatile load, served by L2) and forms dt with the same f32 division
// of f32(cfl min dx) by the maximum floored at 1e-12 (a comparison that
// keeps a NaN, unlike fmaxf), so dt is the same everywhere and a NaN
// poisons it, as jnp.maximum(NaN, 1e-12) does. The time advance tacc is
// summed in f32 from 0 and written once, at the end.
//
// Aliasing and visibility: as in K5, a stage reads its stencil from v
// (never the buffer it writes) and u only at its own cell, so the
// in-place third stage is safe; no pointer is __restrict__/read-only,
// since the buffers a stage reads were written by other blocks within
// this launch, and grid.sync() orders those writes before the reads.
//
// Bound on an H100: f32 operations. Counted as in K5's note (each face
// once, first differences and curvatures shared between neighbouring
// faces), per cell with the Burgers flux: split 6, 103 an axis, the sum
// and negation of the two divergences 2, the viscous Laplacian 20, the
// combine 5 (stage 1: 3) -- 239 a cell (inviscid 219), WENO5-Z 10 more an
// axis; adaptive dt adds |f'| and its max, 2 a cell a step. At 400^2 and
// 200 steps, inviscid (the main path), that is 21.0 G operations, 0.31 ms
// at 67 TFLOP/s; the state moves 0.64 MB in and out of device memory
// once. As written each face is computed twice, from seven neighbours
// split again for every cell and axis, with its differences and
// curvatures (571 operations a cell inviscid, 2.6x the count above), and
// each step waits at three grid-wide barriers, whose cost chip_smoke.py
// measures as the sync floor. Face-once shared-memory tiles are later
// work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "weno5.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
// 32-bit cell indices: a cell index plus the grid stride stays below 2^31
constexpr long long MAX_CELLS = 1LL << 30;
constexpr int NWARPS = THREADS / 32;

constexpr float DT_FLOOR = (float)1e-12;  // timestepping/cfl.py floor

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

struct Args {
  float* S;
  float* T1;
  float* T2;
  int ny, nx;
  float inv_dx[2];  // y, x
  float lap[10];    // viscous taps, y/x by j; unused when !viscous
  int viscous;
  float c;          // speed of the linear flux
  float dt;         // fixed dt (unused when adaptive)
  float cfl_dx;     // f32(cfl * min dx) (adaptive)
  unsigned int* mx; // two words (adaptive)
  float* t_sum;     // the accumulated time advance (adaptive)
  int n_iters;
};

// The largest of every thread's `bits` in the block, folded into *word
// with one atomicMax. Every thread of the block must call it.
__device__ __forceinline__ void block_max(unsigned int bits,
                                          unsigned int* word) {
  __shared__ unsigned int warp_max[NWARPS];
  const unsigned int w = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int m = warp_max[0];
#pragma unroll
    for (int q = 1; q < NWARPS; ++q) m = warp_max[q] > m ? warp_max[q] : m;
    atomicMax(word, m);
  }
  __syncthreads();  // warp_max is reused by the next call
}

// One stage over this thread's cells; with EMIT, returns the largest
// |f'(rk)| of them as bits (else 0).
template <int FLUX, bool WZ, bool HAS_U, bool EMIT>
__device__ __forceinline__ unsigned int stage(const float* v, const float* u,
                                              float* out, float dt, float a,
                                              float b, const Args& p) {
  const int ny = p.ny, nx = p.nx;
  const int ncell = ny * nx;
  const int stride = gridDim.x * blockDim.x;
  const int dj = stride / nx, di = stride - dj * nx;
  const float c = p.c;
  unsigned int mbits = 0u;
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  int j = q / nx, i = q - j * nx;  // (y, x) of cell q, x fastest
  for (; q < ncell; q += stride) {
    const float vc = v[q];

    float Y[7], Yp[7], Ym[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      Y[r] = r == 3 ? vc : v[clampi(j + r - 3, 0, ny - 1) * nx + i];
      split<FLUX>(Y[r], c, Yp[r], Ym[r]);
    }
    const float dy =
        (face<WZ>(&Yp[1], &Ym[2]) - face<WZ>(&Yp[0], &Ym[1])) * p.inv_dx[0];

    float X[7], Xp[7], Xm[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      X[r] = r == 3 ? vc : v[q + (clampi(i + r - 3, 0, nx - 1) - i)];
      split<FLUX>(X[r], c, Xp[r], Xm[r]);
    }
    const float dx =
        (face<WZ>(&Xp[1], &Xm[2]) - face<WZ>(&Xp[0], &Xm[1])) * p.inv_dx[1];

    float rhs = -(dy + dx);
    if (p.viscous) {
      float acc = Y[1] * p.lap[0];
#pragma unroll
      for (int r = 1; r < 5; ++r) acc = acc + Y[r + 1] * p.lap[r];
#pragma unroll
      for (int r = 0; r < 5; ++r) acc = acc + X[r + 1] * p.lap[5 + r];
      rhs = rhs + acc;
    }
    float rk = b * (vc + dt * rhs);
    if (HAS_U) rk = a * u[q] + rk;
    out[q] = rk;
    if (EMIT) {
      const unsigned int bits = __float_as_uint(fabsf(flux_df<FLUX>(rk, c)));
      mbits = bits > mbits ? bits : mbits;
    }
    j += dj;  // the next cell of this thread, without a division
    i += di;
    if (i >= nx) {
      i -= nx;
      ++j;
    }
  }
  return mbits;
}

template <int FLUX, bool WZ, bool ADAPTIVE>
__global__ void __launch_bounds__(THREADS) whole_run_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  float dt = p.dt;
  float tacc = 0.0f;
  if (ADAPTIVE) {  // m of the initial state into mx[0]
    const int ncell = p.ny * p.nx;
    const int stride = gridDim.x * blockDim.x;
    unsigned int mbits = 0u;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < ncell;
         q += stride) {
      const unsigned int bits =
          __float_as_uint(fabsf(flux_df<FLUX>(p.S[q], p.c)));
      mbits = bits > mbits ? bits : mbits;
    }
    block_max(mbits, &p.mx[0]);
    grid.sync();
  }
  for (int k = 0; k < p.n_iters; ++k) {
    const int cur = k & 1;
    if (ADAPTIVE) {
      const float m = __uint_as_float(
          *reinterpret_cast<volatile unsigned int*>(&p.mx[cur]));
      dt = __fdiv_rn(p.cfl_dx, m < DT_FLOOR ? DT_FLOOR : m);
      tacc = tacc + dt;
      if (blockIdx.x == 0 && threadIdx.x == 0) p.mx[cur ^ 1] = 0u;
    }
    stage<FLUX, WZ, false, false>(p.S, nullptr, p.T1, dt, 0.0f, 1.0f, p);
    grid.sync();
    stage<FLUX, WZ, true, false>(p.T1, p.S, p.T2, dt, A2, B2, p);
    grid.sync();
    const unsigned int mbits =
        stage<FLUX, WZ, true, ADAPTIVE>(p.T2, p.S, p.S, dt, A3, B3, p);
    if (ADAPTIVE) block_max(mbits, &p.mx[cur ^ 1]);
    grid.sync();
  }
  if (ADAPTIVE && blockIdx.x == 0 && threadIdx.x == 0) *p.t_sum = tacc;
}

// The sync floor: the same grid and barriers with the stage body off.
__global__ void __launch_bounds__(THREADS) sync_floor_kernel(int n_iters) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < 3 * n_iters; ++k) grid.sync();
}

template <int FLUX, bool WZ, bool ADAPTIVE>
cudaError_t launch(Args& p, int body, int* grid_blocks, cudaStream_t s) {
  auto* kernel = whole_run_kernel<FLUX, WZ, ADAPTIVE>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const long long ncell = (long long)p.ny * p.nx;
  const long long need = (ncell + THREADS - 1) / THREADS;
  const int blocks = (int)(need < (long long)per_sm * sms
                               ? need : (long long)per_sm * sms);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  if (!body) {
    void* args[] = {&p.n_iters};
    return cudaLaunchCooperativeKernel((const void*)sync_floor_kernel,
                                       blocks, THREADS, args, 0, s);
  }
  if (ADAPTIVE) {
    e = cudaMemsetAsync(p.mx, 0, 2 * sizeof(unsigned int), s);
    if (e != cudaSuccess) return e;
  }
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)kernel, blocks, THREADS,
                                     args, 0, s);
}

template <bool ADAPTIVE>
cudaError_t dispatch(Args& p, int flux, int weno_z, int body,
                     int* grid_blocks, cudaStream_t s) {
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: return launch<BURGERS, false, ADAPTIVE>(p, body, grid_blocks, s);
    case 1: return launch<BURGERS, true, ADAPTIVE>(p, body, grid_blocks, s);
    case 2: return launch<LINEAR, false, ADAPTIVE>(p, body, grid_blocks, s);
    case 3: return launch<LINEAR, true, ADAPTIVE>(p, body, grid_blocks, s);
    case 4: return launch<BUCKLEY, false, ADAPTIVE>(p, body, grid_blocks, s);
    default: return launch<BUCKLEY, true, ADAPTIVE>(p, body, grid_blocks, s);
  }
}

}  // namespace

// Run n_iters SSP-RK3 steps on the (ny, nx) state S in place, T1 and T2
// scratch buffers of S's shape, in one cooperative launch on `stream`.
// `flux` is 0 (Burgers), 1 (linear, speed `c`) or 2 (Buckley-Leverett);
// `weno_z` selects the WENO5-Z weights. `inv_dx` points to 2 host floats
// (y, x) and `lap` to 10 host floats, or is null for an inviscid run.
// With `t_sum` null the step is `dt`; else it is adaptive (K7a): dt =
// cfl_dx / max(max|f'(S)|, 1e-12) before every step, `mx` points to two
// words of device scratch (zeroed here, on the stream) and the f32 sum
// of the steps' dt lands in *t_sum on the device. With `body` 0 the same
// grid runs only its 3 barriers a step (the sync floor). `grid_blocks`,
// when not null, receives the grid's block count. Returns the first CUDA
// error (0 on success); does not synchronise.
extern "C" int whole_run_burgers2d(float* S, float* T1, float* T2, int ny,
                                   int nx, int flux, float c, int weno_z,
                                   const float* inv_dx, const float* lap,
                                   float dt, float cfl_dx, float* mx,
                                   float* t_sum, int n_iters, int body,
                                   int* grid_blocks, void* stream) {
  if (ny < 1 || nx < 1 || n_iters < 0 || flux < 0 || flux > 2 ||
      (long long)ny * nx > MAX_CELLS || (t_sum != nullptr && mx == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.S = S;
  p.T1 = T1;
  p.T2 = T2;
  p.ny = ny;
  p.nx = nx;
  for (int q = 0; q < 2; ++q) p.inv_dx[q] = inv_dx[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 10; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.dt = dt;
  p.cfl_dx = cfl_dx;
  p.mx = reinterpret_cast<unsigned int*>(mx);
  p.t_sum = t_sum;
  p.n_iters = n_iters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      t_sum != nullptr ? dispatch<true>(p, flux, weno_z, body, grid_blocks, s)
                       : dispatch<false>(p, flux, weno_z, body, grid_blocks, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
