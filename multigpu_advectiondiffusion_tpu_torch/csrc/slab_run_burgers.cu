// N fixed-dt SSP-RK3 steps of 3-D Burgers / scalar conservation law with
// WENO5 in ONE cooperative kernel launch, all three stages of a step
// fused in one pass over the state (K6), and the same for B independent
// members in one launch (K2b); one entry, slab_run_burgers, serves both.
// A second entry, slab_step_burgers, is K3's Burgers instance: one step
// over an output window of a shard of a z-slab mesh, one launch (the
// TPU kernel fused_slab_run.py::_step_call_kernel, :508, with this
// step_fn). Its buffer holds the shard's lz core planes between depth =
// k*G ghost planes a side (G = 9), (lz + 2 depth, ny, nx); planes are
// read by global z, from the buffer (its exchanged ghost rows included)
// or, for the split schedule's edge calls, from the exchanged operands
// lo/hi, and every read is clamped into the GLOBAL z domain (the TPU
// step_fn's fill keys on global rows, :1540-1578), so a window is K6's
// step over those planes to the bit. Only in-domain planes are written.
//
// A third, slab_run_dma_burgers, is K4's Burgers instance: every shard
// of a z-slab mesh on this card, a whole sharded run in ONE cooperative
// launch, the ghost rows moved inside the kernel (csrc/slab_dma.cuh; the
// TPU kernel fused_slab_run.py::_whole_run_dma_kernel, :327, launched
// :816). Step s is step j = s % k of its block: at j = 0 the block's
// exchange, then every shard's K3 window [oz - w, oz + lz + w), w =
// (k-1-j)G, through the same step_tile, so a K4 run is the collective K3
// run and K6's unsharded run to the bit.
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// fused_slab_run.py::_whole_run_kernel (:188, launched :889, and with
// batched=True at :933 for run_batched) with SlabRunBurgersStepper's
// step_fn (:1540-1645), for WENO5-JS/Z on one device. It computes the
// same function, not the same blocks:
//
//   for each of n_iters steps (grid.sync() after each):
//     t1  = fill(s(fill(S)))
//     t2  = fill(s(t1, S))
//     out = s(t2, S)
//
// with s(v, u) K5's stage (csrc/fused_burgers_stage.cu):
//   rk  = [a*u +] b*(v + dt*rhs)
//   rhs = -((div_z + div_y) + div_x) [+ lap]
// and fill the edge replication of the domain's boundary values into
// every position outside it (fused_slab_run.py:1540-1578), applied to
// each stage's own output. A read clamped into the domain is the same
// thing, which is how K5 treats the boundary, so a step here is three K5
// stages, and its plain twin (ops/kernels/fused_slab_run.py::
// burgers_step_reference) is three K5-twin stages.
//
// Rounding: built with -fmad=false, like K5, with K5's device functions
// (csrc/weno5.cuh) evaluated in K5's order, so the kernel equals its
// twin to the bit.
//
// Design. A block owns a 32x32 (y, x) output tile and a chunk of zchunk z
// planes and marches z; the windows narrow by r = 3 cells a stage:
// S 50x50, t1 44x44, t2 38x38, out 32x32. Shared memory keeps a ring of
// z planes per stage, only planes inside the domain: 10 of S (t1 needs
// planes m-6..m, and the a*u terms of stages 2 and 3 read planes m-6 and
// m-9), 7 each of t1 and t2 -- 194,640 bytes, one block to an SM.
// Iteration m loads S plane m, computes t1 plane m-3, t2 plane m-6 and
// the output plane m-9, with a __syncthreads() after each. Every read is
// clamped into the domain: in z through the ring's plane index, in y and
// x through the position a window cell stands for (a cell outside the
// domain computes the stage at the clamped cell, so it holds the same
// replica as fill). Each cell's stage is K5's per-cell arithmetic: seven
// neighbours an axis from shared memory, split, two faces an axis.
// Recompute factor: per output cell of a full tile, 1.89 + 1.41 + 1 =
// 4.30 stage evaluations for 3 (1.43x); each z chunk adds 18 loaded and
// 18 computed planes at its two ends.
//
// Layout: the state is unpadded (nz, ny, nx) contiguous float32, K5's, at
// most 2^31 - 1 cells (32-bit indices). K2b's buffers are B such states
// back to back; a member's offset is 64-bit, and members share no cell,
// so member m of K2b is K6's run of member m to the bit.
//
// Aliasing and visibility: step k reads S0 or S1 and writes the other
// (other tiles still read the cells a tile writes); later steps read what
// other blocks wrote in this launch, so no pointer is __restrict__, and
// grid.sync() orders every write of a step before the next step's reads.
//
// Bound on an H100: f32 operations. Counted as in K5's note, each face
// once: 351 a cell in stage 1 and 353 in stages 2-3 (WENO5-JS, Burgers
// flux, viscous), 1,057 a cell a step; WENO5-Z adds 30 a stage, an
// inviscid run saves 30. At 400x400x406 that is 68.7 G operations a step,
// 1.025 ms at 67 TFLOP/s; the bytes, 8 a cell a step, take 0.155 ms. As
// written each face is computed twice from seven neighbours split again
// for every cell and axis (K5's 717 operations a cell a stage), times the
// windows' recompute: about 3.0x the count above. Face-once tiles and TMA
// plane loads are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "slab_dma.cuh"
#include "weno5.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 3;             // WENO5 reach
constexpr int T = 32;            // output tile edge, y and x
constexpr int W0 = T + 6 * R;    // S window edge: 50
constexpr int W1 = T + 4 * R;    // t1 window edge: 44
constexpr int W2 = T + 2 * R;    // t2 window edge: 38
constexpr int NV = 3 * R + 1;    // S planes kept: m-9 .. m
constexpr int N1 = 2 * R + 1;    // t1 planes kept
constexpr int N2 = 2 * R + 1;    // t2 planes kept
constexpr int THREADS = 256;
constexpr int SMEM_BYTES =
    (NV * W0 * W0 + N1 * W1 * W1 + N2 * W2 * W2) * (int)sizeof(float);
constexpr long long MAX_CELLS = (1LL << 31) - 1;

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

struct Args {
  int nz, ny, nx;  // global shape (K3: nz over every shard)
  float inv_dx[3];  // z, y, x
  float lap[15];    // viscous taps, z/y/x by j; unused when !viscous
  int viscous;
  float c;          // speed of the linear flux
  float dt;
  int zchunk;
  int tiles_x, chunks, jobs;
  // where the planes lie: the output window [z_lo, z_hi) (global z), the
  // buffer row of global plane 0, the buffer's planes, its ghost rows a
  // side and the exchanged operands that stand in for them (or null)
  int z_lo, z_hi, row_off, pz, depth;
  const float* lo;
  const float* hi;
};

__device__ __forceinline__ int slot(int plane, int n) {
  const int r = plane % n;
  return r < 0 ? r + n : r;
}

// Buffer row `row` of S, from an exchanged operand where one stands in.
__device__ __forceinline__ const float* plane_of(const float* S,
                                                 const Args& p, int row,
                                                 int P) {
  if (p.lo != nullptr && row < p.depth) return p.lo + row * P;
  if (p.hi != nullptr && row >= p.pz - p.depth)
    return p.hi + (row - (p.pz - p.depth)) * P;
  return S + row * P;
}

// K5's stage at one cell from its z column W (planes k-3..k+3) and its y
// and x rows Y and X (W[3] == Y[3] == X[3] is the cell): the same
// operations in the same order as csrc/fused_burgers_stage.cu.
template <int FLUX, bool WZ, bool HAS_U>
__device__ __forceinline__ float stage_cell(const float* W, const float* Y,
                                            const float* X, float u, float a,
                                            float b, const Args& p) {
  const float c = p.c;
  float Zp[7], Zm[7], Yp[7], Ym[7], Xp[7], Xm[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    split<FLUX>(W[q], c, Zp[q], Zm[q]);
    split<FLUX>(Y[q], c, Yp[q], Ym[q]);
    split<FLUX>(X[q], c, Xp[q], Xm[q]);
  }
  const float dz =
      (face<WZ>(&Zp[1], &Zm[2]) - face<WZ>(&Zp[0], &Zm[1])) * p.inv_dx[0];
  const float dy =
      (face<WZ>(&Yp[1], &Ym[2]) - face<WZ>(&Yp[0], &Ym[1])) * p.inv_dx[1];
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
  float rk = b * (W[3] + p.dt * rhs);
  if (HAS_U) rk = a * u + rk;
  return rk;
}

// One stage on plane z of the WOUT x WOUT output window whose corner is
// global (y_org, x_org). `in` is the ring of the stage input (NIN planes
// of (WOUT+2R)^2, the window one r wider on each side), `sv` the ring of
// S's planes (a*u term). Each window cell computes the stage at its
// position clamped into the domain. GLOBAL writes the in-domain cells of
// the tile to `out`; otherwise every cell of the shared plane `out`.
template <int FLUX, bool WZ, int WOUT, int NIN, bool HAS_U, bool GLOBAL>
__device__ __forceinline__ void stage_plane(const float* in, const float* sv,
                                            float* out, int z, int y_org,
                                            int x_org, float a, float b,
                                            const Args& p) {
  constexpr int WIN = WOUT + 2 * R;
  const float* planes[7];
#pragma unroll
  for (int q = 0; q < 7; ++q)
    planes[q] = in + slot(clampi(z - 3 + q, 0, p.nz - 1), NIN) * WIN * WIN;
  const float* u = sv + slot(z, NV) * W0 * W0;
  const int y_u = y_org - (W0 - WOUT) / 2;  // corner of S's window
  const int x_u = x_org - (W0 - WOUT) / 2;
  for (int e = threadIdx.x; e < WOUT * WOUT; e += THREADS) {
    const int oy = e / WOUT, ox = e - oy * WOUT;
    const int y = y_org + oy, x = x_org + ox;
    const int cy = clampi(y, 0, p.ny - 1), cx = clampi(x, 0, p.nx - 1);
    if (GLOBAL && (y != cy || x != cx)) continue;
    const int c = (cy - y_org + R) * WIN + (cx - x_org + R);
    float W[7], Y[7], X[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      W[q] = planes[q][c];
      Y[q] = planes[3][c + (q - 3) * WIN];
      X[q] = planes[3][c + (q - 3)];
    }
    const float uc = HAS_U ? u[(cy - y_u) * W0 + (cx - x_u)] : 0.0f;
    const float val = stage_cell<FLUX, WZ, HAS_U>(W, Y, X, uc, a, b, p);
    if (GLOBAL)
      out[((z + p.row_off) * p.ny + y) * p.nx + x] = val;
    else
      out[e] = val;
  }
}

// One step on job `job`: a 32x32 (y, x) tile and a chunk of z planes,
// S -> out. Ends with a __syncthreads(), so the block may start another
// job on the same shared memory.
template <int FLUX, bool WZ>
__device__ void step_tile(const float* S, float* out, const Args& p, int job,
                          float* sm) {
  float* V = sm;                       // S planes, NV x W0^2
  float* A = V + NV * W0 * W0;         // t1 planes, N1 x W1^2
  float* B = A + N1 * W1 * W1;         // t2 planes, N2 x W2^2
  const int chunk = job % p.chunks;
  const int tile = job / p.chunks;
  const int x0 = (tile % p.tiles_x) * T;
  const int y0 = (tile / p.tiles_x) * T;
  const int k0 = p.z_lo + chunk * p.zchunk;
  const int k1 = min(k0 + p.zchunk, p.z_hi);

  for (int m = k0 - 3 * R; m < k1 + 3 * R; ++m) {
    if (m >= 0 && m < p.nz) {  // S plane m, edge-replicated in y and x
      float* vm = V + slot(m, NV) * W0 * W0;
      const float* src = plane_of(S, p, m + p.row_off, p.ny * p.nx);
      for (int e = threadIdx.x; e < W0 * W0; e += THREADS) {
        const int wy = e / W0, wx = e - wy * W0;
        const int y = clampi(y0 - 3 * R + wy, 0, p.ny - 1);
        const int x = clampi(x0 - 3 * R + wx, 0, p.nx - 1);
        vm[e] = src[y * p.nx + x];
      }
    }
    __syncthreads();
    const int z1 = m - R;  // t1 = s(S): planes k0-6 .. k1+5 in the domain
    if (z1 >= k0 - 2 * R && z1 >= 0 && z1 < p.nz)
      stage_plane<FLUX, WZ, W1, NV, false, false>(
          V, V, A + slot(z1, N1) * W1 * W1, z1, y0 - 2 * R, x0 - 2 * R, 0.0f,
          1.0f, p);
    __syncthreads();
    const int z2 = m - 2 * R;  // t2 = s(t1, S): planes k0-3 .. k1+2
    if (z2 >= k0 - R && z2 >= 0 && z2 < p.nz)
      stage_plane<FLUX, WZ, W2, N1, true, false>(
          A, V, B + slot(z2, N2) * W2 * W2, z2, y0 - R, x0 - R, A2, B2, p);
    __syncthreads();
    const int z3 = m - 3 * R;  // out = s(t2, S): planes k0 .. k1-1
    if (z3 >= k0 && z3 >= 0 && z3 < p.nz)
      stage_plane<FLUX, WZ, T, N2, true, true>(B, V, out, z3, y0, x0, A3, B3,
                                               p);
    __syncthreads();
  }
}

// K3: one step on one job a block, S -> out (the host swaps).
template <int FLUX, bool WZ>
__global__ void __launch_bounds__(THREADS)
step_kernel(const float* S, float* out, Args p) {
  extern __shared__ float sm[];
  step_tile<FLUX, WZ>(S, out, p, blockIdx.x, sm);
}

// K6 (members == 1) and K2b: every member's step k in one pass over the
// flattened (member, tile, z-chunk) work list, then one grid.sync() for
// the whole batch. Member m's state starts m * member_stride floats into
// S0 and S1 (64-bit); inside a member step_tile's 32-bit indices hold.
template <int FLUX, bool WZ>
__global__ void __launch_bounds__(THREADS)
slab_run_kernel(float* S0, float* S1, Args p, int n_iters, int members,
                long long member_stride) {
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  const int jobs = p.jobs * members;
  for (int k = 0; k < n_iters; ++k) {
    const float* src = (k & 1) ? S1 : S0;
    float* dst = (k & 1) ? S0 : S1;
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
      const int m = job / p.jobs;
      const long long off = m * member_stride;
      step_tile<FLUX, WZ>(src + off, dst + off, p, job - m * p.jobs, sm);
    }
    grid.sync();
  }
}

template <int FLUX, bool WZ>
cudaError_t launch(float* S0, float* S1, Args& p, int n_iters, int members,
                   int* grid_blocks, cudaStream_t s) {
  auto* kernel = slab_run_kernel<FLUX, WZ>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const long long jobs = (long long)p.jobs * members;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(jobs < resident ? jobs : resident);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  long long member_stride = (long long)p.nz * p.ny * p.nx;
  void* args[] = {&S0, &S1, &p, &n_iters, &members, &member_stride};
  return cudaLaunchCooperativeKernel((const void*)kernel, blocks, THREADS,
                                     args, SMEM_BYTES, s);
}

// The cooperative launch of K6/K2b: n_iters steps of `members` members
// whose states lie back to back in S0 and S1.
cudaError_t launch_slab_run(float* S0, float* S1, int members, int nz, int ny,
                            int nx, int flux, float c, int weno_z,
                            const float* inv_dx, const float* lap, float dt,
                            int zchunk, int n_iters, int* grid_blocks,
                            cudaStream_t s) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 || n_iters < 0 || flux < 0 ||
      flux > 2 || members < 1 || (long long)nz * ny * nx > MAX_CELLS)
    return cudaErrorInvalidValue;
  Args p;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  for (int q = 0; q < 3; ++q) p.inv_dx[q] = inv_dx[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 15; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.dt = dt;
  p.zchunk = zchunk;
  p.z_lo = 0;
  p.z_hi = nz;
  p.row_off = 0;
  p.pz = nz;
  p.depth = 0;
  p.lo = nullptr;
  p.hi = nullptr;
  p.tiles_x = (nx + T - 1) / T;
  p.chunks = (nz + zchunk - 1) / zchunk;
  p.jobs = ((ny + T - 1) / T) * p.tiles_x * p.chunks;
  if ((long long)p.jobs * members > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e;
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: e = launch<BURGERS, false>(S0, S1, p, n_iters, members, grid_blocks, s); break;
    case 1: e = launch<BURGERS, true>(S0, S1, p, n_iters, members, grid_blocks, s); break;
    case 2: e = launch<LINEAR, false>(S0, S1, p, n_iters, members, grid_blocks, s); break;
    case 3: e = launch<LINEAR, true>(S0, S1, p, n_iters, members, grid_blocks, s); break;
    case 4: e = launch<BUCKLEY, false>(S0, S1, p, n_iters, members, grid_blocks, s); break;
    default: e = launch<BUCKLEY, true>(S0, S1, p, n_iters, members, grid_blocks, s); break;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// K6 (members == 1) and K2b: n_iters fixed-dt steps of `members`
// independent members in ONE cooperative launch on `stream`. S0 and S1
// each hold the members' states back to back, (members, nz, ny, nx); step
// k reads S0 (k even) or S1 (k odd) and writes the other, so every
// member's result is in S0 when n_iters is even and in S1 when it is odd.
// Member m computes exactly K6's run of member m alone: the same
// step_tile on its own state, no shared cell. `flux` is 0 (Burgers), 1
// (linear, speed `c`) or 2 (Buckley-Leverett); `weno_z` selects the
// WENO5-Z weights. `inv_dx` points to 3 host floats (z, y, x) and `lap` to
// 15 host floats, or is null for an inviscid run. `grid_blocks`, when not
// null, receives the grid's block count. Returns the first CUDA error (0
// on success); does not synchronise.
extern "C" int slab_run_burgers(float* S0, float* S1, int members, int nz,
                                int ny, int nx, int flux, float c, int weno_z,
                                const float* inv_dx, const float* lap,
                                float dt, int zchunk, int n_iters,
                                int* grid_blocks, void* stream) {
  return (int)launch_slab_run(S0, S1, members, nz, ny, nx, flux, c, weno_z,
                              inv_dx, lap, dt, zchunk, n_iters, grid_blocks,
                              static_cast<cudaStream_t>(stream));
}

namespace {

template <int FLUX, bool WZ>
cudaError_t launch_step(const float* S, float* out, const Args& p,
                        cudaStream_t s) {
  auto* kernel = step_kernel<FLUX, WZ>;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kernel<<<p.jobs, THREADS, SMEM_BYTES, s>>>(S, out, p);
  return cudaGetLastError();
}

}  // namespace

// K3, Burgers: one fixed-dt step over the output window [z_lo, z_hi)
// (global planes) of a shard's buffer S -> out, on `stream`. The buffers
// are (pz, ny, nx) with `depth` ghost planes a side; global plane g lies
// at buffer row g + row_off; nz is the global plane count. `lo`/`hi`,
// when not null, are (depth, ny, nx) and stand in for the buffer's first
// and last depth rows. Every in-domain plane of the input box (the window
// and 9 planes a side) must lie in the buffer. The flux and physics
// arguments are slab_run_burgers's. Returns the first CUDA error (0 on
// success); does not synchronise.
extern "C" int slab_step_burgers(const float* S, float* out, const float* lo,
                                 const float* hi, int pz, int depth, int nz,
                                 int ny, int nx, int row_off, int z_lo,
                                 int z_hi, int flux, float c, int weno_z,
                                 const float* inv_dx, const float* lap,
                                 float dt, int zchunk, void* stream) {
  // the buffer rows of the box's in-domain planes
  const int first = (z_lo - 3 * R > 0 ? z_lo - 3 * R : 0) + row_off;
  const int last = (z_hi + 3 * R < nz ? z_hi + 3 * R : nz) - 1 + row_off;
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 || flux < 0 || flux > 2 ||
      z_lo >= z_hi || depth < 0 || 2 * depth > pz || first < 0 ||
      last >= pz || (long long)pz * ny * nx > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  for (int q = 0; q < 3; ++q) p.inv_dx[q] = inv_dx[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 15; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.dt = dt;
  p.zchunk = zchunk;
  p.z_lo = z_lo;
  p.z_hi = z_hi;
  p.row_off = row_off;
  p.pz = pz;
  p.depth = depth;
  p.lo = lo;
  p.hi = hi;
  p.tiles_x = (nx + T - 1) / T;
  p.chunks = (z_hi - z_lo + zchunk - 1) / zchunk;
  p.jobs = ((ny + T - 1) / T) * p.tiles_x * p.chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: return (int)launch_step<BURGERS, false>(S, out, p, s);
    case 1: return (int)launch_step<BURGERS, true>(S, out, p, s);
    case 2: return (int)launch_step<LINEAR, false>(S, out, p, s);
    case 3: return (int)launch_step<LINEAR, true>(S, out, p, s);
    case 4: return (int)launch_step<BUCKLEY, false>(S, out, p, s);
    default: return (int)launch_step<BUCKLEY, true>(S, out, p, s);
  }
}

namespace {

// K4, Burgers: n_iters steps of every shard in sh, k steps a block (G =
// 3R = 9). p carries the global shape, the physics and the tiling
// (p.jobs: tiles a plane); each job's window and rows are set here.
template <int FLUX, bool WZ>
__global__ void __launch_bounds__(THREADS)
slab_run_dma_kernel(DmaShards sh, Args p, int lz, int k, int n_iters) {
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 3 * R;
  const int tiles = p.jobs;
  for (int s = 0; s < n_iters; ++s) {
    const int j = s % k;
    const int par = s & 1;
    if (j == 0) dma_exchange(sh, par, s / k, grid);
    const int w = (k - 1 - j) * G;
    Args q = p;
    q.chunks = (lz + 2 * w + p.zchunk - 1) / p.zchunk;
    const int per_shard = tiles * q.chunks;
    for (int job = blockIdx.x; job < sh.n * per_shard; job += gridDim.x) {
      const int i = job / per_shard;
      const int oz = i * lz;
      q.z_lo = oz - w;
      q.z_hi = oz + lz + w;
      q.row_off = sh.depth - oz;
      step_tile<FLUX, WZ>(dma_state(sh, par, i), dma_state(sh, par ^ 1, i),
                          q, job - i * per_shard, sm);
    }
    grid.sync();
  }
}

template <int FLUX, bool WZ>
cudaError_t launch_dma(DmaShards& sh, Args& p, int lz, int k, int n_iters,
                       long long jobs, int* grid_blocks, cudaStream_t s) {
  auto* kernel = slab_run_dma_kernel<FLUX, WZ>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(jobs < resident ? jobs : resident);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  void* args[] = {&sh, &p, &lz, &k, &n_iters};
  e = cudaLaunchCooperativeKernel((const void*)kernel, blocks, THREADS, args,
                                  SMEM_BYTES, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// K4, Burgers: n_iters fixed-dt steps of the `shards` z-slab shards of a
// mesh, all on this card, in ONE cooperative launch on `stream`. s0, s1
// and land are host arrays of `shards` device pointers, in z order:
// shard i's two state buffers (lz + 2 depth, ny, nx), depth = 9k, its lz
// core planes from row depth (global planes i*lz ...), and its landing
// buffer (2, 2, depth, ny, nx). Step s reads s0 (s even) or s1 (s odd)
// and writes the other, so the result is in s0 when n_iters is even and
// in s1 when it is odd; at the start of every block of k steps the
// shards' ghost rows are exchanged through the landing buffers
// (csrc/slab_dma.cuh). The flux and physics arguments are
// slab_run_burgers's. `grid_blocks`, when not null, receives the grid's
// block count. Returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int slab_run_dma_burgers(float* const* s0, float* const* s1,
                                    float* const* land, int shards, int lz,
                                    int k, int ny, int nx, int flux, float c,
                                    int weno_z, const float* inv_dx,
                                    const float* lap, float dt, int zchunk,
                                    int n_iters, int* grid_blocks,
                                    void* stream) {
  const int depth = k * 3 * R;
  const int pz = lz + 2 * depth;
  if (shards < 1 || shards > DMA_MAX_SHARDS || k < 1 || n_iters < 0 ||
      lz < depth || ny < 1 || nx < 1 || zchunk < 1 || flux < 0 || flux > 2 ||
      (long long)pz * ny * nx > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.nz = shards * lz;
  p.ny = ny;
  p.nx = nx;
  for (int q = 0; q < 3; ++q) p.inv_dx[q] = inv_dx[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 15; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.dt = dt;
  p.zchunk = zchunk;
  p.z_lo = 0;
  p.z_hi = lz;
  p.row_off = depth;
  p.pz = pz;
  p.depth = depth;
  p.lo = nullptr;
  p.hi = nullptr;
  p.tiles_x = (nx + T - 1) / T;
  p.chunks = 1;
  p.jobs = ((ny + T - 1) / T) * p.tiles_x;  // tiles a plane
  DmaShards sh;
  for (int i = 0; i < shards; ++i) {
    sh.s0[i] = s0[i];
    sh.s1[i] = s1[i];
    sh.land[i] = land[i];
  }
  sh.n = shards;
  sh.pz = pz;
  sh.depth = depth;
  sh.plane = (long long)ny * nx;
  // the widest step (j = 0) has the most jobs
  const long long jobs = (long long)shards * p.jobs *
                         ((lz + 2 * depth - 6 * R + zchunk - 1) / zchunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: return (int)launch_dma<BURGERS, false>(sh, p, lz, k, n_iters, jobs, grid_blocks, s);
    case 1: return (int)launch_dma<BURGERS, true>(sh, p, lz, k, n_iters, jobs, grid_blocks, s);
    case 2: return (int)launch_dma<LINEAR, false>(sh, p, lz, k, n_iters, jobs, grid_blocks, s);
    case 3: return (int)launch_dma<LINEAR, true>(sh, p, lz, k, n_iters, jobs, grid_blocks, s);
    case 4: return (int)launch_dma<BUCKLEY, false>(sh, p, lz, k, n_iters, jobs, grid_blocks, s);
    default: return (int)launch_dma<BUCKLEY, true>(sh, p, lz, k, n_iters, jobs, grid_blocks, s);
  }
}
