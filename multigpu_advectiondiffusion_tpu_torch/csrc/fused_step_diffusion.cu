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
// (Stage 1 has b = 1 and no u: its b*x is x, so it is not issued.)
//
// Design. On the TPU a block holds full-width y/x rows of a z-slab plus
// 6-row z ghosts in VMEM. On the H100 one 400x200 plane is 320 KB, more
// than a block's 227 KB of shared memory, so a block owns a 32x32 (y, x)
// output tile and a chunk of z planes, and marches z. The ghost ring is
// recomputed in y and x as in z: the windows narrow by 2R = 4 cells a
// stage, S 44x44, t1 40x40, t2 36x36, out 32x32.
//
// What holds the body back on the card is the issue of instructions, the
// shared-memory traffic a stage evaluation needs and their latency, not
// device memory, so the design keeps each lean:
//
// - Every shared plane, whatever the stage, uses the S window's
//   coordinates and row pitch W0 = 44 (a stage's plane holds only its
//   own rows). A block has 8 x 44 = 352 threads, and thread t owns
//   column t % 44 and rows t / 44 + 8j of every window: its cells sit at
//   t + const + 352j in every plane, so each tap is a shared load at an
//   immediate offset from five plane pointers a stage and plane (no
//   division, no index arithmetic a cell), and a warp's 32 lanes read 32
//   consecutive words (no bank conflict). A stage leaves the columns
//   outside its window idle (t1 4 of 44, t2 8, out 12).
// - The masks are a tile's and a plane's: a stage whose window lies
//   inside the band in y and x on an interior plane stores rk with no
//   test; other tiles and planes evaluate every cell of the window too
//   and select with K1's masks, cell by cell, without a branch (a branch
//   a cell was slower). A plane outside the domain is bc_value, with
//   nothing evaluated.
// - S plane m+1 is loaded into registers (ld.global.cg, through L2:
//   K2's later steps read what other blocks wrote in this launch) while
//   plane m is computed, and stored to shared memory at the top of the
//   next iteration, so no load waits; the stage-3 a*u term is loaded the
//   same way at the top of its iteration. The stage-2 a*u term is read
//   from the S ring.
// - Three block barriers a plane: iteration m stores S plane m, then
//   computes t1 plane m-2 | t2 plane m-4 | out plane m-6. Rings of five
//   planes a stage (S m-4..m; t1, t2 the five z taps of the next stage):
//   105,600 bytes, two blocks (22 warps) an SM, 80 registers a thread.
// - The z taps stay in shared memory, and the x taps are separate loads.
//   Timed on the H100 and slower or no faster (PERF.md): z taps
//   in register queues (three or four rows a thread, one barrier a
//   plane, 484-660 threads and one block an SM, for the registers);
//   column pairs through 8-byte loads with two barriers a plane; 16 or
//   12 rows a pass (more warps, fewer registers: spills); 16-row tiles
//   at three blocks an SM (more recompute); each stage's stores after
//   all its passes; K1's masks precomputed a job as bits.
//
// Jobs. A job is a (z chunk, member or shard, tile) triple, numbered
// chunk-major, so the remnant chunks come last; the cooperative kernels
// (K2, K2b, K4) take blockIdx.x first and then the next number from a
// job counter, one a step parity (csrc/slab_dma.cuh next_job). The
// caller plans the chunk length (ops/kernels/fused_slab_run.py
// diffusion_schedule), weighing the 12 planes each chunk adds at its
// ends against the step's tail.
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
// job range of ONE cooperative launch (the flattened (chunk, shard,
// tile) list, as K2b's member axis), and the exchange is a grid-wide
// copy between grid.sync()s (csrc/slab_dma.cuh). Step s of the run is
// step j = s % k of block s / k: at j = 0 the block's exchange, then
// every shard's step over the window [oz - w, oz + lz + w), w = (k-1-j)G,
// with row_off = depth - oz: K3's call of the k-step schedule, through
// the same step_tile, so a K4 run is the collective K3 run (and K2's
// unsharded run) to the bit. A step reads and writes only its own
// shard's buffers; the exchange alone crosses shards.
//
// Bound on an H100: f32 operations. Three K1 stages are 32 + 34 + 34 of
// them a cell (15 products and 14 sums of taps, dt*acc, v +, b*, and in
// stages 2 and 3 a*u and +); rounded one by one (__fmul_rn/__fadd_rn),
// none fuses into an FMA, so the pipe issues one a lane a cycle: 33.5
// T/s, half the card's 67 TFLOP/s. At 400x200x206 that is 0.0492 ms a
// step, above the 0.0394 ms of its 8 B a cell of device memory. The body
// issues 31 + 34 + 34 an evaluated cell, and the windows' recompute
// evaluates 3.83 stages an output cell for 3, a z chunk of Z planes 8 +
// 4 more planes of t1 and t2 (ops/kernels/fused_diffusion_step.py::
// ops_issued counts them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "slab_dma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 2;            // stencil radius of the O4 second derivative
constexpr int TY = 32, TX = 32; // output tile, y and x
constexpr int H0 = TY + 6 * R;  // S window rows: 44
constexpr int W0 = TX + 6 * R;  // S window columns and every plane's pitch
constexpr int ROWS = 8;         // window rows a pass of the block covers
constexpr int THREADS = ROWS * W0;  // 352: a thread a column, 8 rows
constexpr int MIN_BLOCKS = 2;   // blocks an SM
constexpr int RING = 2 * R + 1; // planes a ring keeps: five z taps
// a stage's plane: its window's rows at pitch W0 (S 44, t1 40, t2 36)
constexpr int PS = H0 * W0;
constexpr int P1 = (H0 - 2 * R) * W0;
constexpr int P2 = (H0 - 4 * R) * W0;
constexpr int SMEM_BYTES = RING * (PS + P1 + P2) * (int)sizeof(float);
constexpr int LOAD_PASSES = (H0 + ROWS - 1) / ROWS;  // 6 (the last half)
constexpr int OUT_PASSES = (TY + ROWS - 1) / ROWS;   // 4
constexpr long long MAX_CELLS = (1LL << 31) - 1;     // padded cells

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
  int tiles_x, tiles;      // tiles a row, tiles a plane
  int chunks;              // z chunks of the window
  // where the planes lie: the output window [z_lo, z_hi) (global z), the
  // buffer row of global plane 0, the buffer's planes, its ghost rows a
  // side and the exchanged operands that stand in for them (or null)
  int z_lo, z_hi, row_off, pz, depth;
  const float* lo;
  const float* hi;
};

// The output window of a step and the buffer row of global plane 0.
struct Window {
  int z_lo, z_hi, row_off;
};

__device__ __forceinline__ Window window_of(const Args& p) {
  return {p.z_lo, p.z_hi, p.row_off};
}

__device__ __forceinline__ int slot(int plane) {
  const int r = plane % RING;
  return r < 0 ? r + RING : r;
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

// One job's geometry as this thread sees it.
struct Job {
  int y0, x0;         // global (y, x) of S window cell (0, 0)
  int rt, c;          // this thread's first window row and its column
  int x;              // global x of its column
  bool x_in, x_int, x_face;
  // [0]: the S window lies inside the domain in y and x; [s]: stage s's
  // window lies inside the band in y and x
  bool inner[4];
};

__device__ __forceinline__ bool in_span(int a, int b, int lo, int hi) {
  return a >= lo && b <= hi;  // [a, b) inside [lo, hi)
}

// rk of the stage whose input planes z-2 .. z+2 are q0 .. q4 at the cell
// (y taps at -2W0 .. 2W0, x taps at -2 .. 2 on q2), the terms in K1's
// order.
template <bool HAS_U>
__device__ __forceinline__ float rk_cell(const float* q0, const float* q1,
                                         const float* q2, const float* q3,
                                         const float* q4, float u, float a,
                                         float b, const Args& p) {
  const float* t = p.taps;
  const float vc = q2[0];
  float acc = __fmul_rn(q0[0], t[0]);
  acc = __fadd_rn(acc, __fmul_rn(q1[0], t[1]));
  acc = __fadd_rn(acc, __fmul_rn(vc, t[2]));
  acc = __fadd_rn(acc, __fmul_rn(q3[0], t[3]));
  acc = __fadd_rn(acc, __fmul_rn(q4[0], t[4]));

  acc = __fadd_rn(acc, __fmul_rn(q2[-2 * W0], t[5]));
  acc = __fadd_rn(acc, __fmul_rn(q2[-W0], t[6]));
  acc = __fadd_rn(acc, __fmul_rn(vc, t[7]));
  acc = __fadd_rn(acc, __fmul_rn(q2[W0], t[8]));
  acc = __fadd_rn(acc, __fmul_rn(q2[2 * W0], t[9]));

  acc = __fadd_rn(acc, __fmul_rn(q2[-2], t[10]));
  acc = __fadd_rn(acc, __fmul_rn(q2[-1], t[11]));
  acc = __fadd_rn(acc, __fmul_rn(vc, t[12]));
  acc = __fadd_rn(acc, __fmul_rn(q2[1], t[13]));
  acc = __fadd_rn(acc, __fmul_rn(q2[2], t[14]));

  const float s = __fadd_rn(vc, __fmul_rn(p.dt, acc));
  if (!HAS_U) return s;  // stage 1: b = 1
  return __fadd_rn(__fmul_rn(a, u), __fmul_rn(b, s));
}

// Stage ST (1, 2, 3) on plane z: rows [2ST, W0 - 2ST) and the same
// columns of the S window, read from the ring `in` (the previous stage's
// planes, first row 2ST - 2); stages 1 and 2 write every cell of their
// plane `dst` (first row 2ST), bc_value outside the domain; stage 3
// writes the in-domain cells to the padded buffer `out` at buffer row
// z + row_off. `us` is the S ring (stage 2's a*u), `u3` stage 3's a*u
// values, loaded a pass each.
template <int ST>
__device__ __forceinline__ void stage_plane(const float* in, float* dst,
                                            const float* us,
                                            const float (&u3)[OUT_PASSES],
                                            float* out, int row_off, int z,
                                            const Job& J, const Args& p) {
  constexpr int F = 2 * ST;               // first row and column
  constexpr int H = H0 - 4 * ST;          // rows
  constexpr int W = W0 - 4 * ST;          // columns
  constexpr int PIN = ST == 1 ? PS : ST == 2 ? P1 : P2;
  constexpr int PASSES = (H + ROWS - 1) / ROWS;
  constexpr float A = ST == 2 ? A2 : A3;
  constexpr float B = ST == 2 ? B2 : B3;
  if (J.c < F || J.c >= F + W) return;
  const bool z_in = z >= 0 && z < p.nz;
  // the cell of pass 0 in the input plane (first row F - 2) and in dst
  const int cell = threadIdx.x + 2 * W0;
  if (!z_in) {
    if (ST < 3) {
#pragma unroll
      for (int j = 0; j < PASSES; ++j)
        if (J.rt + ROWS * j < H) dst[threadIdx.x + THREADS * j] = p.bc_value;
    }
    return;
  }
  const float* q0 = in + slot(z - 2) * PIN + cell;
  const float* q1 = in + slot(z - 1) * PIN + cell;
  const float* q2 = in + slot(z) * PIN + cell;
  const float* q3 = in + slot(z + 1) * PIN + cell;
  const float* q4 = in + slot(z + 2) * PIN + cell;
  // stage 2's u: the S ring's plane z at the cell (S's first row is 0)
  const float* u2 = us + slot(z) * PS + threadIdx.x + F * W0;
  const int X = p.nx + 2 * R;
  const int P = (p.ny + 2 * R) * X;
  // stage 3's destination: the padded cell of pass 0
  float* o = out + (z + row_off) * P + (J.y0 + F + J.rt + R) * X + (J.x + R);
  const bool z_int = z >= p.band && z < p.nz - p.band;
  if (z_int && J.inner[ST]) {  // every cell interior: rk, no test
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      if (H % ROWS != 0 && j == PASSES - 1 && J.rt + ROWS * j >= H) break;
      const int d = THREADS * j;
      const float u = ST == 1 ? 0.0f : ST == 2 ? u2[d] : u3[j];
      const float v = rk_cell<ST != 1>(q0 + d, q1 + d, q2 + d, q3 + d,
                                       q4 + d, u, A, B, p);
      if (ST < 3)
        dst[threadIdx.x + d] = v;
      else
        o[ROWS * j * X] = v;
    }
    return;
  }
  // elsewhere every cell is evaluated too (the planes hold bc_value
  // outside the domain, so the inputs are finite) and K1's masks select,
  // with no branch: the passes' chains overlap as in the fast path
  const bool z_face = z == 0 || z == p.nz - 1;
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    if (H % ROWS != 0 && j == PASSES - 1 && J.rt + ROWS * j >= H) break;
    const int d = THREADS * j;
    const int y = J.y0 + F + J.rt + ROWS * j;
    const bool in_domain = J.x_in && y >= 0 && y < p.ny;
    const float u = ST == 1 ? 0.0f : ST == 2 ? u2[d] : u3[j];
    const float r = rk_cell<ST != 1>(q0 + d, q1 + d, q2 + d, q3 + d, q4 + d,
                                     u, A, B, p);
    const bool interior = z_int && J.x_int && y >= p.band &&
                          y < p.ny - p.band;
    const bool face = z_face || J.x_face || y == 0 || y == p.ny - 1;
    const float v = !in_domain ? p.bc_value
                    : interior ? r
                    : face     ? p.bc_value
                               : q2[d];
    if (ST < 3)
      dst[threadIdx.x + d] = v;
    else if (in_domain)
      o[ROWS * j * X] = v;
  }
}

// S plane m of the job's window into `v` (a pass each; bc_value outside
// the domain), through L2.
__device__ __forceinline__ void load_plane(float (&v)[LOAD_PASSES],
                                           const float* S, int m,
                                           int row_off, const Job& J,
                                           const Args& p) {
#pragma unroll
  for (int j = 0; j < LOAD_PASSES; ++j) v[j] = p.bc_value;
  if (m < 0 || m >= p.nz) return;
  const int X = p.nx + 2 * R;
  const int P = (p.ny + 2 * R) * X;
  const float* src = plane_of(S, p, m + row_off, P);
  const int first = (J.y0 + J.rt + R) * X + (J.x + R);  // pass 0's cell
  if (J.inner[0]) {
#pragma unroll
    for (int j = 0; j < LOAD_PASSES; ++j)
      if (H0 % ROWS == 0 || j < LOAD_PASSES - 1 || J.rt + ROWS * j < H0)
        v[j] = __ldcg(src + first + ROWS * j * X);
    return;
  }
  if (!J.x_in) return;
#pragma unroll
  for (int j = 0; j < LOAD_PASSES; ++j) {
    const int y = J.y0 + J.rt + ROWS * j;
    if (J.rt + ROWS * j < H0 && y >= 0 && y < p.ny)
      v[j] = __ldcg(src + first + ROWS * j * X);
  }
}

// Stage 3's a*u values on plane z (its rows of S at this thread's
// column), through L2; only in-domain cells are read.
__device__ __forceinline__ void load_u3(float (&u)[OUT_PASSES],
                                        const float* S, int z, int row_off,
                                        const Job& J, const Args& p) {
  constexpr int F = 6;
  if (z < 0 || z >= p.nz || !J.x_in || J.c < F || J.c >= F + TX) return;
  const int X = p.nx + 2 * R;
  const int P = (p.ny + 2 * R) * X;
  const float* src = plane_of(S, p, z + row_off, P) +
                     (J.y0 + F + J.rt + R) * X + (J.x + R);
#pragma unroll
  for (int j = 0; j < OUT_PASSES; ++j) {
    const int y = J.y0 + F + J.rt + ROWS * j;
    if (J.inner[3] || (y >= 0 && y < p.ny)) u[j] = __ldcg(src + ROWS * j * X);
  }
}

// One step on one job, S -> out: tile `tile` of the plane, z chunk
// `chunk` of the window w. The next job may start at once: its first
// shared-memory writes (S planes) touch no plane this job still reads
// after its last barrier.
__device__ void step_tile(const float* S, float* out, const Args& p,
                          Window w, int tile, int chunk, float* sm) {
  float* V = sm;              // S planes
  float* A = V + RING * PS;   // t1 planes
  float* B = A + RING * P1;   // t2 planes
  Job J;
  J.x0 = (tile % p.tiles_x) * TX - 3 * R;
  J.y0 = (tile / p.tiles_x) * TY - 3 * R;
  J.rt = threadIdx.x / W0;
  J.c = threadIdx.x - J.rt * W0;
  J.x = J.x0 + J.c;
  J.x_in = J.x >= 0 && J.x < p.nx;
  J.x_int = J.x >= p.band && J.x < p.nx - p.band;
  J.x_face = J.x == 0 || J.x == p.nx - 1;
  J.inner[0] = in_span(J.y0, J.y0 + H0, 0, p.ny) &&
               in_span(J.x0, J.x0 + W0, 0, p.nx);
#pragma unroll
  for (int s = 1; s <= 3; ++s) {
    const int a = 2 * s;
    J.inner[s] =
        in_span(J.y0 + a, J.y0 + H0 - a, p.band, p.ny - p.band) &&
        in_span(J.x0 + a, J.x0 + W0 - a, p.band, p.nx - p.band);
  }
  const int k0 = w.z_lo + chunk * p.zchunk;
  const int k1 = min(k0 + p.zchunk, w.z_hi);

  float next[LOAD_PASSES];
  float u3[OUT_PASSES] = {};
  load_plane(next, S, k0 - 3 * R, w.row_off, J, p);
  for (int m = k0 - 3 * R; m < k1 + 3 * R; ++m) {
    float* vm = V + slot(m) * PS + threadIdx.x;
#pragma unroll
    for (int j = 0; j < LOAD_PASSES; ++j)
      if (H0 % ROWS == 0 || j < LOAD_PASSES - 1 || J.rt + ROWS * j < H0)
        vm[THREADS * j] = next[j];
    if (m + 1 < k1 + 3 * R) load_plane(next, S, m + 1, w.row_off, J, p);
    const int z3 = m - 3 * R;  // out = s(t2, S): planes k0 .. k1-1
    if (z3 >= k0) load_u3(u3, S, z3, w.row_off, J, p);
    __syncthreads();
    const int z1 = m - R;      // t1 = s(S): planes k0-4 .. k1+3
    if (z1 >= k0 - 2 * R)
      stage_plane<1>(V, A + slot(z1) * P1, V, u3, out, w.row_off, z1, J, p);
    __syncthreads();
    const int z2 = m - 2 * R;  // t2 = s(t1, S): planes k0-2 .. k1+1
    if (z2 >= k0 - R)
      stage_plane<2>(A, B + slot(z2) * P2, V, u3, out, w.row_off, z2, J, p);
    __syncthreads();
    if (z3 >= k0)
      stage_plane<3>(B, nullptr, V, u3, out, w.row_off, z3, J, p);
  }
}

// K10 and K3: one step, one job a block: job b is chunk b / tiles of
// tile b % tiles.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
step_kernel(const float* S, float* out, const __grid_constant__ Args p) {
  extern __shared__ float sm[];
  const int chunk = blockIdx.x / p.tiles;
  step_tile(S, out, p, window_of(p), blockIdx.x - chunk * p.tiles, chunk,
            sm);
}

// K2 (members == 1) and K2b: every member's step k over the (chunk,
// member, tile) jobs, then one grid.sync() for the whole batch. Member
// m's buffers start m * member_stride floats into S0 and S1 (64-bit);
// inside a member step_tile's 32-bit indices hold.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
slab_run_kernel(float* S0, float* S1, const __grid_constant__ Args p,
                int n_iters, int members, long long member_stride,
                int* counters) {
  extern __shared__ float sm[];
  __shared__ int claimed;
  cg::grid_group grid = cg::this_grid();
  const int per_chunk = p.tiles * members;
  const int jobs = per_chunk * p.chunks;
  for (int k = 0; k < n_iters; ++k) {
    const float* src = (k & 1) ? S1 : S0;
    float* dst = (k & 1) ? S0 : S1;
    reset_counter(counters, k);
    for (int job = blockIdx.x; job < jobs;
         job = next_job(&counters[k & 1], &claimed)) {
      const int chunk = job / per_chunk;
      const int rest = job - chunk * per_chunk;
      const int mb = rest / p.tiles;
      const long long off = mb * member_stride;
      step_tile(src + off, dst + off, p, window_of(p),
                rest - mb * p.tiles, chunk, sm);
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
  p.tiles_x = (nx + TX - 1) / TX;
  p.tiles = ((ny + TY - 1) / TY) * p.tiles_x;
  p.chunks = (nz + zchunk - 1) / zchunk;
  return cudaSuccess;
}

// The blocks of a cooperative launch of `kernel` for `jobs` jobs: every
// co-resident block, at most one a job.
cudaError_t cooperative_blocks(const void* kernel, long long jobs,
                               int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
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
  *blocks = (int)(jobs < resident ? jobs : resident);
  return *blocks < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

cudaError_t launch_step(const float* S, float* out, const Args& p,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return e;
  step_kernel<<<p.tiles * p.chunks, THREADS, SMEM_BYTES, stream>>>(S, out,
                                                                    p);
  return cudaGetLastError();
}

}  // namespace

// K10: one fused step, S -> out, on `stream` (the padded layout; `out`'s
// interior is written, S is not touched); a job marches `zchunk` z
// planes. `taps` points to 15 host floats. Returns the first CUDA error
// (0 on success); does not synchronise.
extern "C" int fused_step_diffusion(const float* S, float* out, int nz, int ny,
                                    int nx, const float* taps, float dt,
                                    int band, float bc_value, int zchunk,
                                    void* stream) {
  Args p;
  cudaError_t e = make_args(p, nz, ny, nx, taps, dt, band, bc_value, zchunk);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_step(S, out, p, static_cast<cudaStream_t>(stream));
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
  if (e != cudaSuccess) return (int)e;
  p.z_lo = z_lo;
  p.z_hi = z_hi;
  p.row_off = row_off;
  p.pz = pz;
  p.depth = depth;
  p.lo = lo;
  p.hi = hi;
  p.chunks = (z_hi - z_lo + zchunk - 1) / zchunk;
  return (int)launch_step(S, out, p, static_cast<cudaStream_t>(stream));
}

// K2 (members == 1) and K2b: n_iters fused steps of `members` independent
// members in ONE cooperative launch on `stream`. S0 and S1 each hold the
// members' padded buffers back to back, (members, nz+4, ny+4, nx+4); step
// k reads S0 (k even) or S1 (k odd) and writes the other, so every
// member's result is in S0 when n_iters is even and in S1 when it is odd.
// Member m computes exactly K2's run of member m alone: the same
// step_tile on its own buffers, no shared cell. A job marches `zchunk`
// z planes. `counters` points to 2 device ints, both zero at the launch
// (the steps' job counters; the launch leaves them dirty). `grid_blocks`,
// when not null, receives the grid's block count. Returns the first CUDA
// error (0 on success); does not synchronise.
extern "C" int slab_run_diffusion(float* S0, float* S1, int members, int nz,
                                  int ny, int nx, const float* taps, float dt,
                                  int band, float bc_value, int zchunk,
                                  int n_iters, int* counters,
                                  int* grid_blocks, void* stream) {
  Args p;
  cudaError_t e = make_args(p, nz, ny, nx, taps, dt, band, bc_value, zchunk);
  const long long jobs = (long long)p.tiles * p.chunks * members;
  if (e == cudaSuccess &&
      (n_iters < 0 || members < 1 || counters == nullptr ||
       jobs > 0x7fffffffLL))
    e = cudaErrorInvalidValue;
  int blocks = 0;
  if (e == cudaSuccess)
    e = cooperative_blocks((const void*)slab_run_kernel, jobs, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  long long member_stride =
      (long long)(nz + 2 * R) * (ny + 2 * R) * (nx + 2 * R);
  void* args[] = {&S0, &S1, &p, &n_iters, &members, &member_stride,
                  &counters};
  e = cudaLaunchCooperativeKernel((const void*)slab_run_kernel, blocks,
                                  THREADS, args, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

namespace {

// K4: n_iters steps of every shard in sh, k steps a block (G = 3R).
// p carries the global shape, the physics and the tiling; each job's
// window and rows are set here. Step j of a block has the (chunk, shard,
// tile) jobs of the windows [oz - w, oz + lz + w), w = (k-1-j)G.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
slab_run_dma_kernel(DmaShards sh, const __grid_constant__ Args p, int lz,
                    int k, int n_iters, int* counters) {
  extern __shared__ float sm[];
  __shared__ int claimed;
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 3 * R;
  const int per_chunk = p.tiles * sh.n;
  for (int s = 0; s < n_iters; ++s) {
    const int j = s % k;
    const int par = s & 1;
    if (j == 0) dma_exchange(sh, par, s / k, grid);
    reset_counter(counters, s);
    const int w = (k - 1 - j) * G;
    const int jobs = per_chunk * ((lz + 2 * w + p.zchunk - 1) / p.zchunk);
    for (int job = blockIdx.x; job < jobs;
         job = next_job(&counters[par], &claimed)) {
      const int chunk = job / per_chunk;
      const int rest = job - chunk * per_chunk;
      const int i = rest / p.tiles;
      const int oz = i * lz;
      step_tile(dma_state(sh, par, i), dma_state(sh, par ^ 1, i), p,
                {oz - w, oz + lz + w, sh.depth - oz}, rest - i * p.tiles,
                chunk, sm);
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
// (csrc/slab_dma.cuh). A job marches `zchunk` z planes. `taps` points to
// 15 host floats. `counters` points to 2 device ints, both zero at the
// launch (the steps' job counters; the launch leaves them dirty).
// `grid_blocks`, when not null, receives the grid's block count. Returns
// the first CUDA error (0 on success); does not synchronise.
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
  // the widest step (j = 0) has the most jobs
  const long long jobs = (long long)shards * p.tiles *
                         ((lz + 2 * depth - 6 * R + zchunk - 1) / zchunk);
  int blocks = 0;
  e = cooperative_blocks((const void*)slab_run_dma_kernel, jobs, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  void* args[] = {&sh, &p, &lz, &k, &n_iters, &counters};
  e = cudaLaunchCooperativeKernel((const void*)slab_run_dma_kernel, blocks,
                                  THREADS, args, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
