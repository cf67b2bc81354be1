// One fused SSP-RK3 step of the 3-D O4 heat equation: all three stages
// in one pass over the state. Three kernels share the step (step_tile):
//
//   K10  step_kernel      one launch a step, S -> out (the host swaps);
//   K2   slab_run_kernel  one cooperative launch a run, the buffers
//                         ping-ponging and a grid.sync() after each step;
//   K2b  the same kernel with a member axis: B independent members' runs
//        in one cooperative launch, one grid.sync() a step for the batch;
//   K3   step_kernel over an output window of a shard of a z-slab mesh:
//        one launch a step (or a call of the split or k-step schedule);
//   K4   slab_run_dma_kernel: every shard of a z-slab mesh on this card,
//        a whole sharded run in ONE cooperative launch, the ghost rows
//        moved inside the kernel (csrc/slab_dma.cuh).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// fused_diffusion_step.py::_step_kernel (:94, launched :214),
// fused_slab_run.py::_whole_run_kernel (:188, launched :889, and with
// batched=True at :933 for run_batched) and fused_slab_run.py::
// _step_call_kernel (:508, built by _make_call :949-1017, launched
// :1007) and fused_slab_run.py::_whole_run_dma_kernel (:327, launched
// :816) with the diffusion step_fn (:1330) over fused_diffusion_step.
// _stage_rows (:56).
//
// K3. A shard's buffer holds its lz core planes between depth = k*G
// ghost planes a side (G = 3R = 6 rows a step, k the steps a halo
// exchange serves), (lz + 2 depth, ny+4, nx+4). The launch computes the
// step on the output window [z_lo, z_hi) of global planes, which may
// reach into the ghost rows (the k-step schedule's widened windows);
// its input box is the window and 3R planes a side. Planes inside the
// global domain are read from the buffer (its exchanged ghost rows
// included) or, for the split schedule's edge calls, from the exchanged
// operands lo (buffer rows [0, depth)) and hi (the last depth rows);
// planes outside the global domain read as bc_value, so K3's window is
// K2's step over those planes to the bit. Only in-domain planes of the
// window are written.
// It computes the same function, not the same blocks:
//
//   t1  = s(S)        T1 = s(S)
//   t2  = s(t1, S)    T2 = s(T1, S)     (three K1 stages)
//   out = s(t2, S)    out = s(T2, S)
//   s(v, u) = where(interior, rk, where(face, bc_value, v))
//   rk = [a*u +] b*(v + dt*acc), acc the 15 O4 taps, z, y, x; j ascending
//
// with taps, a, b, "interior" and "face" as in K1
// (csrc/fused_diffusion_stage.cu). Every stage's value outside the domain
// is bc_value: the TPU kernel leaves rows outside the global domain
// untouched by every stage (neither interior nor face), so they keep the
// frozen pad, and K1's ghost ring holds bc_value and is never written.
// Terms are summed in K1's order with __fmul_rn/__fadd_rn, so the step
// equals three K1 stages to the bit, and equals its plain PyTorch twin
// (ops/kernels/fused_diffusion_step.py::step_reference) to the bit.
//
// Design. On the TPU a block holds full-width y/x rows of a z-slab plus
// 6-row z ghosts in VMEM. On the H100 one 400x200 plane is 320 KB, more
// than a block's 227 KB of shared memory, so a block owns a 32x32 (y, x)
// output tile and a chunk of zchunk z planes, and marches z. The ghost
// ring is recomputed in y and x as in z: the windows narrow by 2R = 4
// cells a stage, S 44x44, t1 40x40, t2 36x36, out 32x32. Shared memory
// keeps a ring of z planes per stage: 7 of S (stages 2 and 3 also read S
// for their a*u term), 5 each of t1 and t2 -- 112,128 bytes, two blocks
// to an SM. Iteration m loads S plane m, computes t1 plane m-2, t2 plane
// m-4 and the output plane m-6, with a __syncthreads() after each.
// Recompute factor: per output cell of a full tile the block loads 1.89
// cells of S and evaluates 1.5625 + 1.27 + 1 = 3.83 stages for 3 (1.28x);
// each z chunk adds 12 loaded and 12 computed planes at its two ends.
//
// Layout: K1's padded (nz+4, ny+4, nx+4) contiguous float32, at most
// 2^31 - 1 padded cells (32-bit indices). The kernels read and write the
// interior only; positions outside the domain read as bc_value. K2b's
// buffers are B such layouts back to back; a member's offset is 64-bit,
// and members share no cell, so member m of K2b is K2's run of member m
// to the bit (the TPU kernel's member_halo = 0).
//
// Aliasing and visibility: a step reads S and writes out, never the same
// buffer (other tiles still read the cells a tile writes). K2's later
// steps read what other blocks wrote in this launch, so no pointer is
// __restrict__/read-only (the non-coherent load path may serve stale
// data); grid.sync() orders every write of a step before the next step's
// reads.
//
// K4. The TPU kernel runs one program per shard and pushes ghost rows to
// its neighbours over ICI; on one card every shard of the mesh is a
// job range of ONE cooperative launch (the flattened (shard, tile,
// z-chunk) list, as K2b's member axis), and the exchange is a grid-wide
// copy between grid.sync()s (csrc/slab_dma.cuh). Step s of the run is
// step j = s % k of block s / k: at j = 0 the block's exchange, then
// every shard's step over the window [oz - w, oz + lz + w), w = (k-1-j)G,
// with row_off = depth - oz: K3's call of the k-step schedule, through
// the same step_tile, so a K4 run is the collective K3 run (and K2's
// unsharded run) to the bit. A step reads and writes only its own
// shard's buffers; the exchange alone crosses shards.
//
// Bound on an H100: device-memory bytes. A step must read S once and
// write the interior once: 8 B a cell, 0.0394 ms at 400x200x206 and
// 3.35 TB/s, against 32 B a cell for three K1 stages. Its f32 operations
// (32 a cell in stage 1, 34 in stages 2-3) take 0.0246 ms at 67 TFLOP/s.
// What the design pays on top: the windows' recompute, four block
// barriers a plane, 13 shared-memory reads a stencil evaluation and, in
// K2, one grid barrier a step. TMA plane loads, register z-queues and
// larger tiles are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "slab_dma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 2;             // stencil radius of the O4 second derivative
constexpr int T = 32;            // output tile edge, y and x
constexpr int W0 = T + 6 * R;    // S window edge: 44
constexpr int W1 = T + 4 * R;    // t1 window edge: 40
constexpr int W2 = T + 2 * R;    // t2 window edge: 36
constexpr int NV = 3 * R + 1;    // S planes kept: m-6 .. m
constexpr int N1 = 2 * R + 1;    // t1 planes kept
constexpr int N2 = 2 * R + 1;    // t2 planes kept
constexpr int THREADS = 256;
constexpr int SMEM_BYTES =
    (NV * W0 * W0 + N1 * W1 * W1 + N2 * W2 * W2) * (int)sizeof(float);
constexpr long long MAX_CELLS = (1LL << 31) - 1;  // padded cells

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
// (Compute_RK, MultiGPU/Diffusion3d_Baseline/Kernels.cu:266-300)
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

struct Args {
  int nz, ny, nx;  // global interior shape (K3: nz over every shard)
  float taps[15];  // [axis z, y, x][tap j]
  float dt;
  int band;
  float bc_value;
  int zchunk;              // z planes a job marches
  int tiles_x, chunks;     // jobs: tiles_y * tiles_x * chunks
  int jobs;
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

// One stage on a WOUT x WOUT plane z of the output window whose corner
// is global (y_org, x_org). `in` is the ring of the stage input (NIN
// planes of (WOUT+2R)^2, the window one R wider on each side), `sv` the
// ring of S's planes (for the a*u term). GLOBAL writes the in-domain
// cells to the padded buffer `out` (the tile itself); otherwise every
// cell of the shared plane `out` is written, bc_value outside the domain.
template <int WOUT, int NIN, bool HAS_U, bool GLOBAL>
__device__ __forceinline__ void stage_plane(const float* in, const float* sv,
                                            float* out, int z, int y_org,
                                            int x_org, float a, float b,
                                            const Args& p) {
  constexpr int WIN = WOUT + 2 * R;
  constexpr int OFF_U = (W0 - WOUT) / 2;  // this window inside S's
  const float* q0 = in + slot(z - 2, NIN) * WIN * WIN;
  const float* q1 = in + slot(z - 1, NIN) * WIN * WIN;
  const float* q2 = in + slot(z, NIN) * WIN * WIN;
  const float* q3 = in + slot(z + 1, NIN) * WIN * WIN;
  const float* q4 = in + slot(z + 2, NIN) * WIN * WIN;
  const float* u = sv + slot(z, NV) * W0 * W0;
  const bool z_in = z >= 0 && z < p.nz;
  const bool z_interior = z >= p.band && z < p.nz - p.band;
  const bool z_face = z == 0 || z == p.nz - 1;
  const float* t = p.taps;
  const int X = p.nx + 2 * R;
  const int P = (p.ny + 2 * R) * X;
  for (int e = threadIdx.x; e < WOUT * WOUT; e += THREADS) {
    const int oy = e / WOUT, ox = e - oy * WOUT;
    const int y = y_org + oy, x = x_org + ox;
    const bool in_domain = z_in && y >= 0 && y < p.ny && x >= 0 && x < p.nx;
    float val = p.bc_value;
    if (in_domain) {
      const int c = (oy + R) * WIN + (ox + R);
      const float vc = q2[c];

      float acc = __fmul_rn(q0[c], t[0]);
      acc = __fadd_rn(acc, __fmul_rn(q1[c], t[1]));
      acc = __fadd_rn(acc, __fmul_rn(vc, t[2]));
      acc = __fadd_rn(acc, __fmul_rn(q3[c], t[3]));
      acc = __fadd_rn(acc, __fmul_rn(q4[c], t[4]));

      acc = __fadd_rn(acc, __fmul_rn(q2[c - 2 * WIN], t[5]));
      acc = __fadd_rn(acc, __fmul_rn(q2[c - WIN], t[6]));
      acc = __fadd_rn(acc, __fmul_rn(vc, t[7]));
      acc = __fadd_rn(acc, __fmul_rn(q2[c + WIN], t[8]));
      acc = __fadd_rn(acc, __fmul_rn(q2[c + 2 * WIN], t[9]));

      acc = __fadd_rn(acc, __fmul_rn(q2[c - 2], t[10]));
      acc = __fadd_rn(acc, __fmul_rn(q2[c - 1], t[11]));
      acc = __fadd_rn(acc, __fmul_rn(vc, t[12]));
      acc = __fadd_rn(acc, __fmul_rn(q2[c + 1], t[13]));
      acc = __fadd_rn(acc, __fmul_rn(q2[c + 2], t[14]));

      float rk = __fmul_rn(b, __fadd_rn(vc, __fmul_rn(p.dt, acc)));
      if (HAS_U)
        rk = __fadd_rn(__fmul_rn(a, u[(oy + OFF_U) * W0 + (ox + OFF_U)]), rk);

      const bool interior = z_interior && y >= p.band && y < p.ny - p.band &&
                            x >= p.band && x < p.nx - p.band;
      const bool face =
          z_face || y == 0 || y == p.ny - 1 || x == 0 || x == p.nx - 1;
      val = interior ? rk : (face ? p.bc_value : vc);
    }
    if (GLOBAL) {
      if (in_domain) out[(z + p.row_off) * P + (y + R) * X + (x + R)] = val;
    } else {
      out[e] = val;
    }
  }
}

// One step on job `job`: a 32x32 (y, x) tile and a chunk of z planes,
// S -> out. Ends with a __syncthreads(), so the block may start another
// job on the same shared memory.
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
  const int X = p.nx + 2 * R;
  const int P = (p.ny + 2 * R) * X;

  for (int m = k0 - 3 * R; m < k1 + 3 * R; ++m) {
    // S plane m, bc_value outside the domain
    float* vm = V + slot(m, NV) * W0 * W0;
    const bool z_in = m >= 0 && m < p.nz;
    const float* src = z_in ? plane_of(S, p, m + p.row_off, P) : nullptr;
    for (int e = threadIdx.x; e < W0 * W0; e += THREADS) {
      const int wy = e / W0, wx = e - wy * W0;
      const int y = y0 - 3 * R + wy, x = x0 - 3 * R + wx;
      vm[e] = z_in && y >= 0 && y < p.ny && x >= 0 && x < p.nx
                  ? src[(y + R) * X + (x + R)]
                  : p.bc_value;
    }
    __syncthreads();
    const int z1 = m - R;  // t1 = s(S): planes k0-4 .. k1+3
    if (z1 >= k0 - 2 * R)
      stage_plane<W1, NV, false, false>(V, V, A + slot(z1, N1) * W1 * W1, z1,
                                        y0 - 2 * R, x0 - 2 * R, 0.0f, 1.0f,
                                        p);
    __syncthreads();
    const int z2 = m - 2 * R;  // t2 = s(t1, S): planes k0-2 .. k1+1
    if (z2 >= k0 - R)
      stage_plane<W2, N1, true, false>(A, V, B + slot(z2, N2) * W2 * W2, z2,
                                       y0 - R, x0 - R, A2, B2, p);
    __syncthreads();
    const int z3 = m - 3 * R;  // out = s(t2, S): planes k0 .. k1-1
    if (z3 >= k0)
      stage_plane<T, N2, true, true>(B, V, out, z3, y0, x0, A3, B3, p);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
step_kernel(const float* S, float* out, Args p) {
  extern __shared__ float sm[];
  step_tile(S, out, p, blockIdx.x, sm);
}

// K2 (members == 1) and K2b: every member's step k in one pass over the
// flattened (member, tile, z-chunk) work list, then one grid.sync() for
// the whole batch. Member m's buffers start m * member_stride floats into
// S0 and S1 (64-bit); inside a member step_tile's 32-bit indices hold.
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
      step_tile(src + off, dst + off, p, job - m * p.jobs, sm);
    }
    grid.sync();
  }
}

// Fill the arguments for the whole unsharded state (K10, K2): the window
// is every plane, the buffer K1's padded layout; 0 or a CUDA error for
// shapes the kernels refuse.
cudaError_t make_args(Args& p, int nz, int ny, int nx, const float* taps,
                      float dt, int band, float bc_value, int zchunk) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 ||
      (long long)(nz + 2 * R) * (ny + 2 * R) * (nx + 2 * R) > MAX_CELLS)
    return cudaErrorInvalidValue;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  for (int q = 0; q < 15; ++q) p.taps[q] = taps[q];
  p.dt = dt;
  p.band = band;
  p.bc_value = bc_value;
  p.zchunk = zchunk;
  p.z_lo = 0;
  p.z_hi = nz;
  p.row_off = R;
  p.pz = nz + 2 * R;
  p.depth = R;
  p.lo = nullptr;
  p.hi = nullptr;
  p.tiles_x = (nx + T - 1) / T;
  p.chunks = (nz + zchunk - 1) / zchunk;
  p.jobs = ((ny + T - 1) / T) * p.tiles_x * p.chunks;
  return cudaSuccess;
}

}  // namespace

// K10: one fused step, S -> out, on `stream` (the padded layout; `out`'s
// interior is written, S is not touched). `taps` points to 15 host
// floats. Returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int fused_step_diffusion(const float* S, float* out, int nz, int ny,
                                    int nx, const float* taps, float dt,
                                    int band, float bc_value, int zchunk,
                                    void* stream) {
  Args p;
  cudaError_t e = make_args(p, nz, ny, nx, taps, dt, band, bc_value, zchunk);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  step_kernel<<<p.jobs, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(S, out, p);
  return (int)cudaGetLastError();
}

// K3: one fused step over the output window [z_lo, z_hi) (global planes)
// of a shard's buffer S -> out, on `stream`. The buffers are (pz, ny+4,
// nx+4) with `depth` ghost planes a side; global plane g lies at buffer
// row g + row_off; nz is the global plane count. `lo`/`hi`, when not
// null, are (depth, ny+4, nx+4) and stand in for the buffer's first and
// last depth rows. Every in-domain plane of the input box (the window and
// 6 planes a side) must lie in the buffer. `taps` points to 15 host
// floats. Returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int slab_step_diffusion(const float* S, float* out,
                                   const float* lo, const float* hi, int pz,
                                   int depth, int nz, int ny, int nx,
                                   int row_off, int z_lo, int z_hi,
                                   const float* taps, float dt, int band,
                                   float bc_value, int zchunk, void* stream) {
  Args p;
  cudaError_t e = make_args(p, nz, ny, nx, taps, dt, band, bc_value, zchunk);
  // the buffer rows of the box's in-domain planes
  const int first = (z_lo - 3 * R > 0 ? z_lo - 3 * R : 0) + row_off;
  const int last = (z_hi + 3 * R < nz ? z_hi + 3 * R : nz) - 1 + row_off;
  if (e == cudaSuccess &&
      (z_lo >= z_hi || depth < 0 || 2 * depth > pz || first < 0 ||
       last >= pz ||
       (long long)pz * (ny + 2 * R) * (nx + 2 * R) > MAX_CELLS))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  p.z_lo = z_lo;
  p.z_hi = z_hi;
  p.row_off = row_off;
  p.pz = pz;
  p.depth = depth;
  p.lo = lo;
  p.hi = hi;
  p.chunks = (z_hi - z_lo + zchunk - 1) / zchunk;
  p.jobs = ((ny + T - 1) / T) * p.tiles_x * p.chunks;
  step_kernel<<<p.jobs, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(S, out, p);
  return (int)cudaGetLastError();
}

namespace {

// The cooperative launch of K2/K2b: n_iters steps of `members` members
// whose padded buffers lie back to back in S0 and S1.
cudaError_t launch_slab_run(float* S0, float* S1, int members, int nz, int ny,
                            int nx, const float* taps, float dt, int band,
                            float bc_value, int zchunk, int n_iters,
                            int* grid_blocks, cudaStream_t stream) {
  Args p;
  cudaError_t e = make_args(p, nz, ny, nx, taps, dt, band, bc_value, zchunk);
  if (e == cudaSuccess &&
      (n_iters < 0 || members < 1 ||
       (long long)p.jobs * members > 0x7fffffffLL))
    e = cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)slab_run_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slab_run_kernel, THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const long long jobs = (long long)p.jobs * members;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(jobs < resident ? jobs : resident);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  long long member_stride =
      (long long)(nz + 2 * R) * (ny + 2 * R) * (nx + 2 * R);
  void* args[] = {&S0, &S1, &p, &n_iters, &members, &member_stride};
  e = cudaLaunchCooperativeKernel((const void*)slab_run_kernel, blocks,
                                  THREADS, args, SMEM_BYTES, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// K2 (members == 1) and K2b: n_iters fused steps of `members` independent
// members in ONE cooperative launch on `stream`. S0 and S1 each hold the
// members' padded buffers back to back, (members, nz+4, ny+4, nx+4); step
// k reads S0 (k even) or S1 (k odd) and writes the other, so every
// member's result is in S0 when n_iters is even and in S1 when it is odd.
// Member m computes exactly K2's run of member m alone: the same
// step_tile on its own buffers, no shared cell. `grid_blocks`, when not
// null, receives the grid's block count. Returns the first CUDA error (0
// on success); does not synchronise.
extern "C" int slab_run_diffusion(float* S0, float* S1, int members, int nz,
                                  int ny, int nx, const float* taps, float dt,
                                  int band, float bc_value, int zchunk,
                                  int n_iters, int* grid_blocks,
                                  void* stream) {
  return (int)launch_slab_run(S0, S1, members, nz, ny, nx, taps, dt, band,
                              bc_value, zchunk, n_iters, grid_blocks,
                              static_cast<cudaStream_t>(stream));
}

namespace {

// K4: n_iters steps of every shard in sh, k steps a block (G = 3R).
// p carries the global shape, the physics and the tiling (p.jobs: tiles
// a plane); each job's window and rows are set here. A step's jobs are
// numbered chunk-major over (chunk, shard, tile), so every shard's last
// (remnant) chunks come last; each block takes blockIdx.x first, then
// the next number from the step parity's counter (`counters`, 2 ints;
// next_job and reset_counter, csrc/slab_dma.cuh).
__global__ void __launch_bounds__(THREADS)
slab_run_dma_kernel(DmaShards sh, Args p, int lz, int k, int n_iters,
                    int* counters) {
  extern __shared__ float sm[];
  __shared__ int claimed;
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 3 * R;
  const int tiles = p.jobs;
  const int per_chunk = tiles * sh.n;
  for (int s = 0; s < n_iters; ++s) {
    const int j = s % k;
    const int par = s & 1;
    if (j == 0) dma_exchange(sh, par, s / k, grid);
    reset_counter(counters, s);
    const int w = (k - 1 - j) * G;
    Args q = p;
    q.chunks = (lz + 2 * w + p.zchunk - 1) / p.zchunk;
    const int jobs = per_chunk * q.chunks;
    for (int job = blockIdx.x; job < jobs;
         job = next_job(&counters[par], &claimed)) {
      const int chunk = job / per_chunk;
      const int rest = job - chunk * per_chunk;
      const int i = rest / tiles;
      const int oz = i * lz;
      q.z_lo = oz - w;
      q.z_hi = oz + lz + w;
      q.row_off = sh.depth - oz;
      // step_tile numbers a window's jobs tile-major, chunk fastest
      step_tile(dma_state(sh, par, i), dma_state(sh, par ^ 1, i), q,
                (rest - i * tiles) * q.chunks + chunk, sm);
    }
    grid.sync();
  }
}

}  // namespace

// K4: n_iters fused steps of the `shards` z-slab shards of a mesh, all on
// this card, in ONE cooperative launch on `stream`. s0, s1 and land are
// host arrays of `shards` device pointers, in z order: shard i's two
// state buffers (lz + 2 depth, ny+4, nx+4), depth = 6k, its lz core
// planes from row depth (global planes i*lz ...), and its landing
// buffer (2, 2, depth, ny+4, nx+4). Step s reads s0 (s even) or s1 (s
// odd) and writes the other, so the result is in s0 when n_iters is even
// and in s1 when it is odd; at the start of every block of k steps the
// shards' ghost rows are exchanged through the landing buffers
// (csrc/slab_dma.cuh). `taps` points to 15 host floats. `counters`
// points to 2 device ints, both zero at the launch (the steps' job
// counters; the launch leaves them dirty). `grid_blocks`, when not
// null, receives the grid's block count. Returns the first CUDA
// error (0 on success); does not synchronise.
extern "C" int slab_run_dma_diffusion(float* const* s0, float* const* s1,
                                      float* const* land, int shards, int lz,
                                      int k, int ny, int nx,
                                      const float* taps, float dt, int band,
                                      float bc_value, int zchunk, int n_iters,
                                      int* counters, int* grid_blocks,
                                      void* stream) {
  if (shards < 1 || shards > DMA_MAX_SHARDS || k < 1 || n_iters < 0 ||
      lz < k * 3 * R || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args p;
  cudaError_t e = make_args(p, shards * lz, ny, nx, taps, dt, band, bc_value,
                            zchunk);
  const int depth = k * 3 * R;
  const int pz = lz + 2 * depth;
  if (e == cudaSuccess &&
      (long long)pz * (ny + 2 * R) * (nx + 2 * R) > MAX_CELLS)
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  DmaShards sh;
  for (int i = 0; i < shards; ++i) {
    sh.s0[i] = s0[i];
    sh.s1[i] = s1[i];
    sh.land[i] = land[i];
  }
  sh.n = shards;
  sh.pz = pz;
  sh.depth = depth;
  sh.plane = (long long)(ny + 2 * R) * (nx + 2 * R);
  p.pz = pz;
  p.depth = depth;
  const int tiles = ((ny + T - 1) / T) * p.tiles_x;
  p.jobs = tiles;
  // the widest step (j = 0) has the most jobs
  const long long jobs = (long long)shards * tiles *
                         ((lz + 2 * depth - 6 * R + zchunk - 1) / zchunk);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  e = cudaFuncSetAttribute((const void*)slab_run_dma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slab_run_dma_kernel, THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(jobs < resident ? jobs : resident);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  void* args[] = {&sh, &p, &lz, &k, &n_iters, &counters};
  e = cudaLaunchCooperativeKernel((const void*)slab_run_dma_kernel, blocks,
                                  THREADS, args, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
