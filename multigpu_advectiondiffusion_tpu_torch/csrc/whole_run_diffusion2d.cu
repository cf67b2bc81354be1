// N SSP-RK3 steps of the 2-D O4 heat equation in ONE cooperative kernel
// launch (K7, diffusion body).
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// whole_run.py::_kernel (:28, launched by whole_run :50) with the stage
// body fused_diffusion2d.py::_stage (:45). There the Pallas grid is the
// iteration counter: the state is copied into VMEM once, every stage of
// every step runs in-core on a sequential grid, and the result is copied
// out once. Here the counterpart is one persistent cooperative grid:
//
//   for each of n_iters steps:
//     T1 = s(S)      ; grid.sync()
//     T2 = s(T1, S)  ; grid.sync()
//     S  = s(T2, S)  ; grid.sync()     (in place over S)
//
// with s(v, u) = where(interior, rk, where(face, bc_value, v)),
//   rk  = b*(v + dt*acc)            (stage 1, no u operand)
//   rk  = a*u + b*(v + dt*acc)      (stages 2 and 3)
//   acc = sum over axes y, x, taps j = 0..4 of taps[axis][j] * v[j-2],
// taps[axis][j] = c_j * K / (12 dx_axis^2) rounded once to f32, the
// (a, b) of SSP-RK3 rounded once from Python doubles, "interior" the
// cells >= band away from every face and "face" the cells on a face.
// Terms are summed in the TPU kernel's order (y, x; j ascending) with
// explicit round-to-nearest multiplies and adds (__fmul_rn/__fadd_rn), so
// no product and sum are contracted into an FMA and the kernel rounds
// exactly where its plain twin does
// (ops/kernels/fused_diffusion.py::stage_reference, run by
// ops/kernels/whole_run.py::plain_run).
//
// Layout: the padded state is (ny+4, nx+4) contiguous float32, the K1
// layout without the TPU's (8, 128) rounding, with at most 2^30 interior
// cells (32-bit cell indices). The 2-deep ghost ring holds bc_value in
// all three buffers and is never written.
//
// Grid: at most the blocks that can be resident at once (the occupancy
// query times the SMs), so every block reaches every grid.sync(). Each
// thread walks the interior cells with a grid-stride loop, x fastest, so
// a warp reads 32 neighbouring cells of a row; a cell's (y, x) advances
// by the stride's quotient and remainder, with no division a cell.
//
// Aliasing and visibility: a stage reads its stencil from v (T1 or T2,
// never the buffer it writes) and u only at its own cell, before writing
// that cell, so the in-place third stage is safe. Buffers written by one
// stage are read by other blocks in the next one, within this launch, so
// no pointer is __restrict__/read-only (the non-coherent load path may
// serve stale data); grid.sync() orders every write before the barrier
// with every read after it.
//
// Bound on an H100: at 1001^2 one buffer is 4.0 MB and the three take
// 12.1 MB, a quarter of the 50 MB L2, so after the first stage the state
// never leaves L2: the run must move 4 MB in and 4 MB out of device
// memory once (2.4 us at 3.35 TB/s). Its f32 operations (22 a cell in
// stage 1, 24 in stages 2-3, the interior cells only) take 10.4 ms at
// 67 TFLOP/s for 10,000 steps, so the run is bound by operations. What
// the design pays on top: each stage streams v, u and out through L2
// (8-12 B a cell, 32 a step), and each step waits at three grid-wide
// barriers, whose cost chip_smoke.py measures as the sync floor (the same
// grid with the stage body off). Shared-memory tiles, fewer barriers
// (two steps per tile with a widened halo) and register-resident state
// are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 2;  // stencil radius of the O4 second derivative
constexpr int THREADS = 256;
// 32-bit cell indices: a cell index plus the grid stride stays below 2^31
constexpr long long MAX_CELLS = 1LL << 30;

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
// (Compute_RK, MultiGPU/Diffusion3d_Baseline/Kernels.cu:266-300)
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

struct Args {
  float* S;
  float* T1;
  float* T2;
  int ny, nx;
  float taps[10];  // [axis y, x][tap j]
  float dt;
  int band;
  float bc_value;
  int n_iters;
};

template <bool HAS_U>
__device__ __forceinline__ void stage(const float* v, const float* u,
                                      float* out, float a, float b,
                                      const Args& p) {
  const long long X = p.nx + 2 * R;  // row stride
  const int ncell = p.ny * p.nx;
  const int stride = gridDim.x * blockDim.x;
  const int dj = stride / p.nx, di = stride - dj * p.nx;
  const float* t = p.taps;
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  int j = q / p.nx, i = q - j * p.nx;  // (y, x) of cell q, x fastest
  for (; q < ncell; q += stride) {
    const long long c = (long long)(j + R) * X + (i + R);
    const float vc = v[c];

    float acc = __fmul_rn(v[c - 2 * X], t[0]);
    acc = __fadd_rn(acc, __fmul_rn(v[c - X], t[1]));
    acc = __fadd_rn(acc, __fmul_rn(vc, t[2]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + X], t[3]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + 2 * X], t[4]));

    acc = __fadd_rn(acc, __fmul_rn(v[c - 2], t[5]));
    acc = __fadd_rn(acc, __fmul_rn(v[c - 1], t[6]));
    acc = __fadd_rn(acc, __fmul_rn(vc, t[7]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + 1], t[8]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + 2], t[9]));

    float rk = __fmul_rn(b, __fadd_rn(vc, __fmul_rn(p.dt, acc)));
    if (HAS_U) rk = __fadd_rn(__fmul_rn(a, u[c]), rk);

    const bool interior = j >= p.band && j < p.ny - p.band &&
                          i >= p.band && i < p.nx - p.band;
    const bool face = j == 0 || j == p.ny - 1 || i == 0 || i == p.nx - 1;
    out[c] = interior ? rk : (face ? p.bc_value : vc);
    j += dj;  // the next cell of this thread, without a division
    i += di;
    if (i >= p.nx) {
      i -= p.nx;
      ++j;
    }
  }
}

__global__ void __launch_bounds__(THREADS) whole_run_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < p.n_iters; ++k) {
    stage<false>(p.S, nullptr, p.T1, 0.0f, 1.0f, p);  // u1 = u + dt L(u)
    grid.sync();
    stage<true>(p.T1, p.S, p.T2, A2, B2, p);  // 3/4 u + 1/4 (...)
    grid.sync();
    stage<true>(p.T2, p.S, p.S, A3, B3, p);  // 1/3 u + 2/3 (...)
    grid.sync();
  }
}

// The sync floor: the same grid and barriers with the stage body off.
__global__ void __launch_bounds__(THREADS) sync_floor_kernel(int n_iters) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < 3 * n_iters; ++k) grid.sync();
}

}  // namespace

// Run n_iters SSP-RK3 steps on the padded state S in place, T1 and T2
// scratch buffers of S's shape whose ghost rings hold bc_value, in one
// cooperative launch on `stream`. `taps` points to 10 host floats. With
// `body` 0 the same grid runs only its 3 barriers a step (the sync
// floor). `grid_blocks`, when not null, receives the grid's block count.
// Returns the first CUDA error (0 on success); does not synchronise.
extern "C" int whole_run_diffusion2d(float* S, float* T1, float* T2, int ny,
                                     int nx, const float* taps, float dt,
                                     int band, float bc_value, int n_iters,
                                     int body, int* grid_blocks,
                                     void* stream) {
  if (ny < 1 || nx < 1 || n_iters < 0 || (long long)ny * nx > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.S = S;
  p.T1 = T1;
  p.T2 = T2;
  p.ny = ny;
  p.nx = nx;
  for (int q = 0; q < 10; ++q) p.taps[q] = taps[q];
  p.dt = dt;
  p.band = band;
  p.bc_value = bc_value;
  p.n_iters = n_iters;

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, whole_run_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const long long ncell = (long long)ny * nx;
  const long long need = (ncell + THREADS - 1) / THREADS;
  const int blocks = (int)(need < (long long)per_sm * sms
                               ? need : (long long)per_sm * sms);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body) {
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel((const void*)whole_run_kernel, blocks,
                                    THREADS, args, 0, s);
  } else {
    void* args[] = {&p.n_iters};
    e = cudaLaunchCooperativeKernel((const void*)sync_floor_kernel, blocks,
                                    THREADS, args, 0, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
