// N SSP-RK3 steps of 2-D Burgers / scalar conservation law with WENO5 in
// ONE cooperative kernel launch (K7, Burgers body; K7a, adaptive dt).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// whole_run.py::_kernel (:28, launched by whole_run :50; fixed dt) and
// ::_kernel_adaptive (:75, launched by whole_run_adaptive :107) with the
// stage body fused_burgers2d.py::_stage (:79), for WENO5-JS/Z and
// WENO7-JS on one device. There the Pallas grid is the iteration counter
// and the state
// lives in VMEM for the whole run. Here the counterpart is one persistent
// cooperative grid whose blocks own tiles of the grid and run every step:
//
//   [adaptive: m = max|f'(S)| over every cell; grid.sync()]
//   for each of n_iters steps k:
//     [adaptive: dt = cfl_dx / max(m, 1e-12); tacc += dt]
//     S_k -> window of S_k in shared memory (the tile and 9 cells a side)
//     t1 = s(S_k), t2 = s(t1, S_k), S_{k+1} = s(t2, S_k)  (shared memory;
//                                   adaptive: m of S_{k+1} on the tile)
//     S_{k+1}'s tile edges -> the other global buffer;  grid.sync()
//   [adaptive: *t_sum = tacc]
//
// with s(v, u) the K5 stage with one axis fewer:
//   rk  = v + dt*rhs                (stage 1, b = 1, no u operand)
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
// ops/kernels/whole_run.py::plain_run/plain_run_adaptive), and a face
// flux is a function of its ten split values only, so the two agree to
// the bit.
//
// Layout: the state is unpadded (ny, nx) contiguous float32, at most
// 2^30 cells (32-bit cell indices). Edge boundaries replicate the edge
// value: the twin clamps every neighbour index of each stage's own v into
// the grid.
//
// Design. What bounded the first port (a cell a thread by grid stride,
// every face computed twice from seven neighbours reloaded through L2 and
// split again, 571 operations a cell a stage, three grid-wide barriers a
// step) was the issue of those operations and the barriers. Here:
//
// - Jobs. The grid is cut into my x mx tiles of near-equal sides
//   (ops/kernels/fused_burgers2d.py::burgers2d_schedule plans them from
//   the card's numbers, whole_run_burgers2d_card). A job is a tile; its
//   window is the tile and 3R = 9 cells a side, clipped to [-R, n + R):
//   cells outside the grid are ghosts holding the replica of the edge
//   cell they clamp to. Stage 1 is evaluated on the tile and 6 cells a
//   side, stage 2 on 3, stage 3 on the tile, each clipped to the grid:
//   the halo is recomputed with the arithmetic of the neighbour's own
//   cells, so it equals them to the bit, and t1 and t2 never leave shared
//   memory. Only S crosses jobs: ONE exchange a step.
// - Edge values. The cell that a stage writes on a grid edge also writes
//   its value and split into the ghosts that clamp to it, so each stage
//   reads the edge replicas of its own v, as the twin does.
// - Ping-pong. Step k reads S_k from buffer k & 1 (0: S, 1: T1) and
//   writes S_{k+1} to the other, so no job overwrites cells a neighbour
//   still reads. T2 is not used.
// - Resident tiles. When every job has its own block (jobs <= the
//   co-resident blocks, the planned case) a block keeps its window in
//   shared memory for the run: stage 3 writes S_{k+1} and its split in
//   place (it reads u only at its own cell), the block publishes only the
//   9 cells of each edge that neighbours read, and reloads only its 9-cell
//   halo each step; the result is written from shared memory at the end.
//   Otherwise (more jobs than blocks) each job reloads its whole window
//   and writes its whole tile every step; an odd run's result is copied
//   from T1 into S at the end.
// - Each split and each face once a stage. Loads split each window cell
//   as it arrives; a stage's cells split their own result for the next
//   stage. The faces of a stage are computed once, in runs of three along
//   a row (x) or a column (y) (weno5.cuh::face_run, as K5's face_item),
//   one run a thread, into two face planes; after a block barrier each
//   cell takes its divergences, the viscous taps (radius 2) from the v
//   plane and the combine, in the twin's order. Two block barriers a
//   stage, one after the loads.
// - Adaptive dt (K7a). The maximum must be exact and the same in every
//   block. |f'| >= 0, so a float's order equals its bits' order as an
//   unsigned int, and a NaN (positive after fabsf) lies above +inf: an
//   integer max keeps it, as jnp.max does. Stage 3 takes max|f'| of
//   S_{k+1} over the tile's cells; each block reduces it (warp
//   __reduce_max_sync, then shared memory) and does one atomicMax before
//   the step's grid.sync(). One barrier a step needs three words: step k
//   reads word k % 3, raises word (k+1) % 3 and block 0 zeroes word
//   (k+2) % 3, which every block read in step k-1 and none raises before
//   step k+1. Every thread forms dt with the same f32 division of
//   f32(cfl min dx) by the maximum floored at 1e-12 (a comparison that
//   keeps a NaN, unlike fmaxf), so dt is the same everywhere and a NaN
//   poisons it, as jnp.maximum(NaN, 1e-12) does; a block forms it after
//   its halo loads are issued, so their round trips through L2 and the
//   word's overlap. tacc is summed in f32 from 0 and written once, at the
//   end.
// - Global traffic goes through L2 (__ldcg/__stcg): the buffers are
//   written in this launch, and the non-coherent and L1 paths may serve
//   stale data.
// - Index arithmetic. A resident block works out its job once: its
//   64-bit divisions are long software sequences on every thread (about
//   0.7 us a step at 400^2, PERF.md); a stage steps its work items'
//   lines and places instead of dividing each item's index.
// - Block: 768 threads, one block an SM (80 registers a thread, no
//   spills). Timed on the H100 at 400^2 and 1478^2 with
//   examples/k7_burgers_tiling_sweep.py (PERF.md), none faster: 512, 640,
//   800, 832, 896 and 1024 threads (800-1024 get 64-72 registers); two
//   blocks an SM of 384 or 512 threads on 256-264 tiles; runs of four or
//   five faces; two cells a thread at a time in (C); three exchanges a
//   step with no recompute (t1 and t2 edges published and reloaded).
//
// Shared memory: seven planes at one pitch in the window's coordinates
// (S, t1, t2, f+, f-, the x faces and the y faces), with SPARE rows and
// columns past the widest window that the last run of a line reads.
//
// Bound on an H100: f32 operations. Counted as in K5's note (each face
// once, first differences and curvatures shared between neighbouring
// faces), per cell with the Burgers flux: split 6, 103 an axis, the sum
// and negation of the two divergences 2, the viscous Laplacian 20, the
// combine 5 (stage 1: 3) -- 239 a cell (inviscid 219), WENO5-Z 10 more an
// axis; adaptive dt adds |f'| and its max, 2 a cell a step. At 400^2 and
// 200 steps, inviscid (the main path), that is 21.0 G operations, 0.31 ms
// at 67 TFLOP/s; the state moves 0.64 MB in and out of device memory
// once. The body issues, a cell a stage, a split (6), a third of each of
// its two lines' runs of three faces (305 / 3 each, WENO5-Z 335 / 3), the
// divergences, their sum and negation 6, the Laplacian 20 and the combine
// 5 (stage 1: 2), on the evaluated cells of each stage (at 400^2 about
// 1.4 stages for each one needed); fused_burgers2d.ops_issued counts a
// run: 314 an output cell a stage on the planned 10x13 tiles at 400^2,
// 1.44x the count. With `body` 0 the same grid runs only its
// grid.sync()s, one a step: chip_smoke.py reports that floor. PERF.md
// has the times (a run(200) at 400^2 about 9x the bound).
//
// Order 7 (WENO7-JS): the same body with the reach R = 4 as a template
// parameter: windows of the tile and 3R = 12 cells a side (clipped to 4
// past the grid), stages on the tile and 8, 4, 0 cells a side, tiles of
// at least 12 cells a side, and each face the e-form of weno7e.cuh in
// runs of three (RUN + 6 split values a side; the last run of a line still
// reads at most SPARE cells past the window). The planner takes the
// order-7 instance's own numbers (11x12 tiles at the physical 400x408
// grid). Counted as in K5's note, a WENO7 axis is 219 operations a cell
// with each face once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "weno5.cuh"
#include "weno7e.cuh"

namespace cg = cooperative_groups;

namespace {

// R, the WENO reach (3: WENO5-JS/Z, 4: WENO7-JS), is a template parameter
// of the body; a job's window reaches HALO = 3R cells past its tile.
constexpr int THREADS = 768;
constexpr int MIN_BLOCKS = 1;  // resident blocks an SM
constexpr int NWARPS = THREADS / 32;
constexpr int RUN = 3;    // faces a work item computes
constexpr int SPARE = 2;  // rows / columns the last run of a line reads
constexpr int PLANES = 7;
// 32-bit cell indices
constexpr long long MAX_CELLS = 1LL << 30;

constexpr float DT_FLOOR = (float)1e-12;  // timestepping/cfl.py floor

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

struct Args {
  float* S;   // buffer 0: S_k of even k, and the result
  float* T1;  // buffer 1: S_k of odd k
  int ny, nx;
  int my, mx, jobs;  // tiles along y and x, my * mx
  int P;             // pitch of a shared plane (floats)
  int plane;         // floats of a shared plane
  float inv_dx[2];   // y, x
  float lap[10];     // viscous taps, y/x by j; unused when !viscous
  int viscous;
  float c;            // speed of the linear flux
  float dt;           // fixed dt (unused when adaptive)
  float cfl_dx;       // f32(cfl * min dx) (adaptive)
  unsigned int* wmax; // three words (adaptive)
  float* t_sum;       // the accumulated time advance (adaptive)
  int n_iters;
  int body;  // 0: the exchanges only (the floor)
};

// A job's tile and window in global cell coordinates.
struct Job {
  int y0, y1, x0, x1;      // the tile
  int wy0, wy1, wx0, wx1;  // the window, clipped to [-R, n + R)
};

template <int R>
__device__ __forceinline__ Job job_of(int j, const Args& p) {
  constexpr int HALO = 3 * R;
  Job J;
  const int jy = j / p.mx, jx = j - jy * p.mx;
  J.y0 = (int)((long long)jy * p.ny / p.my);
  J.y1 = (int)((long long)(jy + 1) * p.ny / p.my);
  J.x0 = (int)((long long)jx * p.nx / p.mx);
  J.x1 = (int)((long long)(jx + 1) * p.nx / p.mx);
  J.wy0 = max(J.y0 - HALO, -R);
  J.wy1 = min(J.y1 + HALO, p.ny + R);
  J.wx0 = max(J.x0 - HALO, -R);
  J.wx1 = min(J.x1 + HALO, p.nx + R);
  return J;
}

// The shared planes of a block, each in its window's coordinates: global
// (y, x) at [(y - wy0) * P + x - wx0].
struct Planes {
  float *s, *t1, *t2;  // S (stage 3 writes S_{k+1} in place), t1, t2
  float *fp, *fm;      // the split of the v a stage reads
  float *hx, *hy;      // faces: left of the cell (x), above it (y)
};

// The largest of every thread's `bits` in the block, folded into *word
// with one atomicMax. Every thread of the block must call it, and the
// block must pass a grid.sync() before it calls it again.
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
  // warp_max is not written again before the block's next grid.sync()
}

// The n-th cell (y, x) of job J's window (`ring` false: row-major) or of
// its halo, the window without the tile (`ring`: the rows above the tile,
// those below it, then the tile's rows left and right of it).
__device__ __forceinline__ void window_cell(int n, const Job& J, bool ring,
                                            int& y, int& x) {
  const int w = J.wx1 - J.wx0;
  const int above = (J.y0 - J.wy0) * w, below = (J.wy1 - J.y1) * w;
  if (!ring || n < above) {
    y = J.wy0 + n / w;
    x = J.wx0 + n % w;
  } else if (n < above + below) {
    n -= above;
    y = J.y1 + n / w;
    x = J.wx0 + n % w;
  } else {
    n -= above + below;
    const int left = J.x0 - J.wx0, side = left + J.wx1 - J.x1;
    y = J.y0 + n / side;
    const int c = n % side;
    x = c < left ? J.wx0 + c : J.x1 + c - left;
  }
}

// S_k's window of job J from `src` into the S plane, each cell split into
// the f+ and f- planes: the whole window (`ring` false) or only its halo
// (`ring`: what a resident job reloads). A cell outside the grid loads
// the edge cell it clamps to. Every thread issues LOADS loads before it
// stores one, so their L2 round trips overlap.
template <int FLUX>
__device__ __forceinline__ void load_window(const float* src,
                                            const Planes& sm, const Job& J,
                                            const Args& p, bool ring) {
  constexpr int LOADS = 4;
  const int w = J.wx1 - J.wx0;
  const int cells = ring ? (J.wy1 - J.wy0) * w - (J.y1 - J.y0) *
                                                     (J.x1 - J.x0)
                         : (J.wy1 - J.wy0) * w;
  for (int n0 = threadIdx.x; n0 < cells; n0 += LOADS * THREADS) {
    float val[LOADS];
    int at[LOADS];
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      at[e] = -1;
      const int n = n0 + e * THREADS;
      if (n >= cells) continue;
      int y, x;
      window_cell(n, J, ring, y, x);
      val[e] = __ldcg(src + clampi(y, 0, p.ny - 1) * p.nx +
                      clampi(x, 0, p.nx - 1));
      at[e] = (y - J.wy0) * p.P + x - J.wx0;
    }
#pragma unroll
    for (int e = 0; e < LOADS; ++e)
      if (at[e] >= 0) {
        sm.s[at[e]] = val[e];
        split<FLUX>(val[e], p.c, sm.fp[at[e]], sm.fm[at[e]]);
      }
  }
}

// The viscous taps' sum of the cell at `at` of the v plane (vc its
// value), y then x, j ascending, in the twin's order.
__device__ __forceinline__ float lap_acc(const float* v, int at, int P,
                                         float vc, const Args& p) {
  float acc = v[at - 2 * P] * p.lap[0];
  acc = acc + v[at - P] * p.lap[1];
  acc = acc + vc * p.lap[2];
  acc = acc + v[at + P] * p.lap[3];
  acc = acc + v[at + 2 * P] * p.lap[4];
  acc = acc + v[at - 2] * p.lap[5];
  acc = acc + v[at - 1] * p.lap[6];
  acc = acc + vc * p.lap[7];
  acc = acc + v[at + 1] * p.lap[8];
  acc = acc + v[at + 2] * p.lap[9];
  return acc;
}

// rk of stage ST from v, rhs and u: v + dt*rhs (stage 1), else
// a*u + b*(v + dt*rhs).
template <int ST>
__device__ __forceinline__ float combine(float vc, float rhs, float u,
                                         float dt) {
  if (ST == 1) return vc + dt * rhs;
  constexpr float A = ST == 2 ? A2 : A3;
  constexpr float B = ST == 2 ? B2 : B3;
  const float rk = B * (vc + dt * rhs);
  return A * u + rk;
}

// A cell's rk (y, x) at `at` into `out`, with its split (stages 1-2, and
// stage 3 when resident) and, stages 1-2 on a grid edge, into the ghosts
// that clamp to it; stage 3 writes it to `dst` too (every cell, or when
// resident those within HALO of the tile's edges). Returns `mbits`
// raised, with EMIT, by |f'(rk)|.
template <int R, int FLUX, int ST, bool EMIT>
__device__ __forceinline__ unsigned int cell_store(
    float rk, int y, int x, int at, float* out, const Planes& sm,
    const Job& J, const Args& p, float* dst, bool resident,
    unsigned int mbits) {
  constexpr int HALO = 3 * R;
  out[at] = rk;
  if (ST < 3 || resident) {
    float fp, fm;
    split<FLUX>(rk, p.c, fp, fm);
    sm.fp[at] = fp;
    sm.fm[at] = fm;
    if (ST < 3 && (y == 0 || y == p.ny - 1 || x == 0 || x == p.nx - 1)) {
      const int gy0 = y == 0 ? J.wy0 : y;
      const int gy1 = y == p.ny - 1 ? J.wy1 - 1 : y;
      const int gx0 = x == 0 ? J.wx0 : x;
      const int gx1 = x == p.nx - 1 ? J.wx1 - 1 : x;
      for (int gy = gy0; gy <= gy1; ++gy)
        for (int gx = gx0; gx <= gx1; ++gx) {
          const int g = at + (gy - y) * p.P + (gx - x);
          out[g] = rk;
          sm.fp[g] = fp;
          sm.fm[g] = fm;
        }
    }
  }
  if (ST == 3) {
    if (!resident || y < J.y0 + HALO || y >= J.y1 - HALO ||
        x < J.x0 + HALO || x >= J.x1 - HALO)
      __stcg(dst + y * p.nx + x, rk);
    if (EMIT) {
      const unsigned int bits = __float_as_uint(fabsf(flux_df<FLUX>(rk, p.c)));
      mbits = bits > mbits ? bits : mbits;
    }
  }
  return mbits;
}

// Stage ST (1, 2, 3) of job J from the v plane `v` (its split in the f+
// and f- planes) on the tile and E = R(3 - ST) cells a side, clipped to
// the grid: (B) every x face of those rows and y face of those columns
// once, in runs of three, one run a thread; a block barrier; (C) each
// cell's rk into `out`, with its split into the f+ and f- planes for the
// next stage and, on a grid edge, into the ghosts that clamp to it.
// Stage 3 writes S_{k+1} into the S plane in place (a cell reads its u
// before it writes it, and no other cell reads it in this stage), splits
// it only when the job stays resident, and writes it to `dst` (every
// cell, or when resident only those within HALO of the tile's edges).
// Returns, with EMIT, the largest |f'(S_{k+1})| of this thread's cells as
// bits (else 0).
template <int R, int FLUX, bool WZ, int ST, bool EMIT>
__device__ __forceinline__ unsigned int stage(const float* v, float* out,
                                              const Planes& sm, const Job& J,
                                              const Args& p, float dt,
                                              float* dst, bool resident) {
  constexpr int E = R * (3 - ST);
  constexpr int NV = RUN + 2 * R - 2;  // split values a run reads a side
  const int ya = max(J.y0 - E, 0), yb = min(J.y1 + E, p.ny);
  const int xa = max(J.x0 - E, 0), xb = min(J.x1 + E, p.nx);
  const int nr = yb - ya, nc = xb - xa;
  const int P = p.P;
  const int base = (ya - J.wy0) * P + xa - J.wx0;  // (ya, xa) in a plane

  // (B) x runs: row r, faces left of cells xa + 3q .. +2 (nc + 1 faces a
  // row); y runs: column c, faces above rows ya + 3q .. +2. The last run
  // of a line may reach SPARE cells past the window; its extra faces land
  // in cells no stage reads. Work item t is x run t (t < nxi) or y run t -
  // nxi_pad (y runs start a warp); a thread takes the items t =
  // threadIdx.x mod THREADS, stepping its run's line and place.
  const int rx = nc / RUN + 1, ry = nr / RUN + 1;
  const int nxi = nr * rx, nyi = nc * ry;
  const int nxi_pad = (nxi + 31) & ~31;
  {
    int r = threadIdx.x / rx, q = threadIdx.x - r * rx;  // x run (r, q)
    constexpr int step = THREADS;
    const int dr = step / rx, dq = step - dr * rx;
    int t = threadIdx.x;
    for (; t < nxi; t += step) {
      float F[NV], M[NV], h[RUN];
      const int at = base + r * P + RUN * q;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        F[k] = sm.fp[at - R + k];
        M[k] = sm.fm[at - R + 1 + k];
      }
      face_run_of<R, WZ, RUN>(F, M, h);
#pragma unroll
      for (int j = 0; j < RUN; ++j) sm.hx[at + j] = h[j];
      r += dr;
      q += dq;
      if (q >= rx) {
        q -= rx;
        ++r;
      }
    }
    while (t < nxi_pad) t += step;
    int e = t - nxi_pad;
    q = e / nc;  // y run (q, col)
    int col = e - q * nc;
    const int dqy = step / nc, dc = step - dqy * nc;
    for (; e < nyi; e += step) {
      float F[NV], M[NV], h[RUN];
      const int at = base + RUN * q * P + col;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        F[k] = sm.fp[at + (k - R) * P];
        M[k] = sm.fm[at + (k - R + 1) * P];
      }
      face_run_of<R, WZ, RUN>(F, M, h);
#pragma unroll
      for (int j = 0; j < RUN; ++j) sm.hy[at + j * P] = h[j];
      q += dqy;
      col += dc;
      if (col >= nc) {
        col -= nc;
        ++q;
      }
    }
  }
  __syncthreads();

  // (C) the cells
  unsigned int mbits = 0u;
  const int cells = nr * nc;
  const int dr = THREADS / nc, dc = THREADS - dr * nc;
  int r = threadIdx.x / nc, cc = threadIdx.x - r * nc;
  for (int t = threadIdx.x; t < cells; t += THREADS) {
    const int at = base + r * P + cc;
    const float vc = v[at];
    const float dy = (sm.hy[at + P] - sm.hy[at]) * p.inv_dx[0];
    const float dx = (sm.hx[at + 1] - sm.hx[at]) * p.inv_dx[1];
    float rhs = -(dy + dx);
    if (p.viscous) rhs = rhs + lap_acc(v, at, P, vc, p);
    const float rk = combine<ST>(vc, rhs, ST == 1 ? 0.0f : sm.s[at], dt);
    mbits = cell_store<R, FLUX, ST, EMIT>(rk, ya + r, xa + cc, at, out, sm,
                                          J, p, dst, resident, mbits);
    r += dr;
    cc += dc;
    if (cc >= nc) {
      cc -= nc;
      ++r;
    }
  }
  return mbits;
}

// The tile of job J from the S plane into `dst`, a warp a row.
__device__ __forceinline__ void store_tile(float* dst, const float* s,
                                           const Job& J, const Args& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = J.y0 + warp; y < J.y1; y += NWARPS) {
    const int srow = (y - J.wy0) * p.P - J.wx0;
    for (int x = J.x0 + lane; x < J.x1; x += 32)
      __stcg(dst + y * p.nx + x, s[srow + x]);
  }
}

// The tile of job J from `src` into `dst` (the result of an odd run).
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          const Job& J, const Args& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = J.y0 + warp; y < J.y1; y += NWARPS)
    for (int x = J.x0 + lane; x < J.x1; x += 32)
      __stcg(dst + y * p.nx + x, __ldcg(src + y * p.nx + x));
}

template <int R, int FLUX, bool WZ, bool ADAPTIVE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
whole_run_kernel(const __grid_constant__ Args p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  if (!p.body) {  // the floor: the same grid, its barriers only
    for (int k = 0; k < p.n_iters; ++k) grid.sync();
    return;
  }
  if (p.n_iters < 1) {
    if (ADAPTIVE && blockIdx.x == 0 && threadIdx.x == 0) *p.t_sum = 0.0f;
    return;
  }
  Planes sm;
  sm.s = smem;
  sm.t1 = sm.s + p.plane;
  sm.t2 = sm.t1 + p.plane;
  sm.fp = sm.t2 + p.plane;
  sm.fm = sm.fp + p.plane;
  sm.hx = sm.fm + p.plane;
  sm.hy = sm.hx + p.plane;
  const bool resident = (int)gridDim.x >= p.jobs;
  // spare rows and columns of the planes hold finite values
  for (int i = threadIdx.x; i < PLANES * p.plane; i += THREADS) smem[i] = 0.0f;
  // a resident block's job, worked out once (its 64-bit divisions)
  __shared__ Job own;
  if (resident && threadIdx.x == 0) own = job_of<R>(blockIdx.x, p);

  float dt = p.dt;
  float tacc = 0.0f;
  if (ADAPTIVE) {  // m of the initial state into word 0
    unsigned int mbits = 0u;
    for (int j = blockIdx.x; j < p.jobs; j += gridDim.x) {
      const Job J = job_of<R>(j, p);
      const int w = J.x1 - J.x0, n = (J.y1 - J.y0) * w;
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int y = J.y0 + i / w, x = J.x0 + i % w;
        const unsigned int bits = __float_as_uint(
            fabsf(flux_df<FLUX>(__ldcg(p.S + y * p.nx + x), p.c)));
        mbits = bits > mbits ? bits : mbits;
      }
    }
    block_max(mbits, &p.wmax[0]);
    grid.sync();
  }
  __syncthreads();  // the planes are zeroed

  int word = 0;  // the word step k reads: k % 3
  for (int k = 0; k < p.n_iters; ++k) {
    const float* src = (k & 1) ? p.T1 : p.S;
    float* dst = (k & 1) ? p.S : p.T1;
    const int next = word == 2 ? 0 : word + 1;
    float m = 0.0f;
    if (ADAPTIVE) {
      m = __uint_as_float(
          *reinterpret_cast<volatile unsigned int*>(&p.wmax[word]));
      if (blockIdx.x == 0 && threadIdx.x == 0)
        p.wmax[next == 2 ? 0 : next + 1] = 0u;
    }
    unsigned int mbits = 0u;
    for (int j = blockIdx.x; j < p.jobs; j += gridDim.x) {
      const Job J = resident ? own : job_of<R>(j, p);
      // a resident job's tile holds S_k: it reloads only its halo
      load_window<FLUX>(src, sm, J, p, resident && k > 0);
      // dt after the loads are issued, so the word's and their round
      // trips through L2 overlap (every block has a job)
      if (ADAPTIVE) dt = __fdiv_rn(p.cfl_dx, m < DT_FLOOR ? DT_FLOOR : m);
      __syncthreads();
      stage<R, FLUX, WZ, 1, false>(sm.s, sm.t1, sm, J, p, dt, dst, resident);
      __syncthreads();
      stage<R, FLUX, WZ, 2, false>(sm.t1, sm.t2, sm, J, p, dt, dst,
                                   resident);
      __syncthreads();
      const unsigned int b = stage<R, FLUX, WZ, 3, ADAPTIVE>(
          sm.t2, sm.s, sm, J, p, dt, dst, resident);
      mbits = b > mbits ? b : mbits;
      // the planes are free for the block's next job (a resident job's
      // block has none: the grid.sync() below orders the next step)
      if (!resident) __syncthreads();
    }
    if (ADAPTIVE) {
      tacc = tacc + dt;
      block_max(mbits, &p.wmax[next]);
    }
    grid.sync();
    word = next;
  }
  if (ADAPTIVE && blockIdx.x == 0 && threadIdx.x == 0) *p.t_sum = tacc;
  // the result into S (every read of the last step is done): a resident
  // job writes its tile; an odd run's reloaded tiles are in T1
  const bool odd = p.n_iters & 1;
  if (!odd && !resident) return;
  for (int j = blockIdx.x; j < p.jobs; j += gridDim.x) {
    const Job J = job_of<R>(j, p);
    if (resident)
      store_tile(p.S, sm.s, J, p);
    else
      copy_tile(p.S, p.T1, J, p);
  }
}

// The kernel instance of `flux`, `weno_z` and ADAPTIVE at order 5, and
// of `flux` and ADAPTIVE at order 7 (WENO7-JS).
template <bool ADAPTIVE>
const void* instance_of(int flux, int weno_z, int order) {
  if (order == 7) {
    switch (flux) {
      case 0: return (const void*)whole_run_kernel<4, BURGERS, false, ADAPTIVE>;
      case 1: return (const void*)whole_run_kernel<4, LINEAR, false, ADAPTIVE>;
      default: return (const void*)whole_run_kernel<4, BUCKLEY, false, ADAPTIVE>;
    }
  }
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: return (const void*)whole_run_kernel<3, BURGERS, false, ADAPTIVE>;
    case 1: return (const void*)whole_run_kernel<3, BURGERS, true, ADAPTIVE>;
    case 2: return (const void*)whole_run_kernel<3, LINEAR, false, ADAPTIVE>;
    case 3: return (const void*)whole_run_kernel<3, LINEAR, true, ADAPTIVE>;
    case 4: return (const void*)whole_run_kernel<3, BUCKLEY, false, ADAPTIVE>;
    default: return (const void*)whole_run_kernel<3, BUCKLEY, true, ADAPTIVE>;
  }
}

const void* instance(int flux, int weno_z, bool adaptive, int order) {
  return adaptive ? instance_of<true>(flux, weno_z, order)
                  : instance_of<false>(flux, weno_z, order);
}

}  // namespace

// Run n_iters SSP-RK3 steps on the (ny, nx) state S in place, T1 the
// other state buffer and T2 scratch of S's shape (not used), in one
// cooperative launch on `stream`. `order` is 5 (WENO5; `weno_z` selects
// the WENO5-Z weights) or 7 (WENO7-JS, weno_z 0), of reach R = 3 or 4.
// The grid is cut into my x mx tiles, a job each; each side of a tile
// spans at least 3R cells where there is more than one tile along it.
// `flux` is 0 (Burgers), 1 (linear, speed `c`) or 2 (Buckley-Leverett).
// `inv_dx` points to 2 host floats (y, x) and `lap` to 10 host floats, or
// is null for an inviscid run. With `t_sum` null the step is `dt`; else
// it is adaptive (K7a): dt = cfl_dx / max(max|f'(S)|, 1e-12) before every
// step, `wmax` points to three words of device scratch (zeroed here, on
// the stream) and the f32 sum of the steps' dt lands in *t_sum on the
// device. With `body` 0 the same grid runs only its grid.sync()s, one a
// step (the floor). `grid_blocks`, when not null, receives the grid's
// block count and `smem_bytes` a block's dynamic shared memory. Returns
// the first CUDA error (0 on success); does not synchronise.
extern "C" int whole_run_burgers2d(float* S, float* T1, float* T2, int ny,
                                   int nx, int flux, float c, int weno_z,
                                   int order, const float* inv_dx,
                                   const float* lap,
                                   float dt, float cfl_dx, float* wmax,
                                   float* t_sum, int n_iters, int my, int mx,
                                   int body, int* grid_blocks,
                                   int* smem_bytes, void* stream) {
  (void)T2;
  const int R = order == 7 ? 4 : 3, HALO = 3 * R;
  if (ny < 1 || nx < 1 || n_iters < 0 || flux < 0 || flux > 2 || my < 1 ||
      mx < 1 || my > ny || mx > nx || (my > 1 && ny / my < HALO) ||
      (mx > 1 && nx / mx < HALO) || (long long)ny * nx > MAX_CELLS ||
      (t_sum != nullptr && wmax == nullptr) ||
      (order != 5 && order != 7) || (order == 7 && weno_z))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.S = S;
  p.T1 = T1;
  p.ny = ny;
  p.nx = nx;
  p.my = my;
  p.mx = mx;
  p.jobs = my * mx;
  // the widest window: the longest tile sides and HALO cells a side
  const int h = min((ny + my - 1) / my + 2 * HALO, ny + 2 * R);
  const int w = min((nx + mx - 1) / mx + 2 * HALO, nx + 2 * R);
  p.P = w + SPARE;
  p.plane = (h + SPARE) * p.P;
  for (int q = 0; q < 2; ++q) p.inv_dx[q] = inv_dx[q];
  p.viscous = lap != nullptr;
  for (int q = 0; q < 10; ++q) p.lap[q] = lap != nullptr ? lap[q] : 0.0f;
  p.c = c;
  p.dt = dt;
  p.cfl_dx = cfl_dx;
  p.wmax = reinterpret_cast<unsigned int*>(wmax);
  p.t_sum = t_sum;
  p.n_iters = n_iters;
  p.body = body;
  const long long bytes = (long long)PLANES * p.plane * (long long)sizeof(float);
  const void* kernel = instance(flux, weno_z, t_sum != nullptr, order);

  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(p.jobs < resident ? p.jobs : resident);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  if (smem_bytes != nullptr) *smem_bytes = (int)bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_sum != nullptr && body) {
    e = cudaMemsetAsync(wmax, 0, 3 * sizeof(unsigned int), s);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, blocks, THREADS, args,
                                  (size_t)bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The card's numbers that K7 Burgers' plan (fused_burgers2d.py::
// burgers2d_schedule) depends on, for the current device and the instance
// of `flux`, `weno_z`, `adaptive` and `order`, into out[0..4]: its SMs; the
// blocks
// an SM the instance's threads and registers allow; the dynamic shared
// memory a block may opt into; an SM's shared memory; and what each
// resident block holds besides its dynamic shared memory (the runtime's
// reserve and the kernel's static shared memory). Returns the first CUDA
// error (0 on success).
extern "C" int whole_run_burgers2d_card(int flux, int weno_z, int adaptive,
                                        int order, int* out) {
  if (flux < 0 || flux > 2 || (order != 5 && order != 7) ||
      (order == 7 && weno_z))
    return (int)cudaErrorInvalidValue;
  const void* kernel = instance(flux, weno_z, adaptive != 0, order);
  int dev = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                      THREADS, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[3], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[4] = reserved + (int)attr.sharedSizeBytes;
  return 0;
}
