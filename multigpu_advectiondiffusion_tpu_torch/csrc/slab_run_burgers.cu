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
// twin to the bit. A face flux is a function of its ten split values
// only, whichever cell asks for it, so computing it once keeps the bits.
//
// Design. A block of 768 threads (24 warps; 512 were slower, 1,024
// spill) owns a 32x32 (y, x) output tile and a chunk of z planes
// and marches z; stage s's output window is 32 + 6(3-s) cells a side
// (t1 44, t2 38, out 32) and its input window 6 wider (S 50, t1 44, t2
// 38). Only in-domain cells are evaluated; every read of a stage input
// is clamped into the domain, which is the replica fill makes. Shared
// memory (224,304 bytes, one block an SM) holds for each stage:
//   a ring of 6 input planes, z-2 .. z+3 (the z face above z reads them),
//     in-domain cells only;
//   the split (f+, f-) of input plane z over the whole input window,
//     computed once a cell (clamped reads, so no later read clamps);
//   the x faces (WO rows of WO+1) and y faces (WO+1 rows of WO) of plane
//     z, each computed once from the split plane, in runs of 3 along
//     the line (weno5.cuh::face_run: the differences, curvatures and
//     l-term products neighbouring faces share computed once).
// The a*u terms of stages 2 and 3 read S at the cell from global memory
// (L2), so S keeps no extra planes. A thread keeps the z face below each
// of its cells in a register (3 + 2 + 2 of them): the face above plane z
// is the face below z+1, so each z face is computed once, from the six
// ring planes of its column split again (6 splits a cell a stage).
// Iteration m loads S plane m and handles stage s on plane z_s = m - 3s
// in five passes with four barriers: (1) the S plane and the split
// planes of the three stages, (2) the x and y face runs of the three
// stages in one loop, (3)-(5) the cells of stages 1, 2, 3, each writing
// the next stage's ring (stage 3: the output). Stage s's first plane's
// lower z face is computed one iteration early. Index arithmetic steps
// (y, x) by constants: no division or modulo a cell.
//
// Measured (chip_smoke.py phase 14, H100 80GB HBM3, 700 W, 400x400x406
// inviscid): 8.45 ms a step, against 15.5 for the body this replaced
// and 6.3 for three K5 launches. Slower on the same card: S read from
// global memory with one pass for every face and one for every cell;
// 20x20 or 17x17 tiles at two blocks an SM (the windows' recompute
// grows faster than the occupancy helps); one face an item. Against K5
// the body evaluates 13.1 face fluxes an output cell a step, K5 18,
// but at about half K5's rate an evaluation: one block of 24 warps an
// SM that meets four barriers a plane, against K5's many blocks and
// none.
//
// Schedule (K6, K2b, K4). A job is a (z chunk, member or shard, tile)
// triple, numbered chunk-major, so the last chunk of every tile, the
// remnant, comes last. Each block takes blockIdx.x first and then the
// next number from an atomic counter, one counter a step parity (the
// other is reset during the step, before the grid barrier that precedes
// its reuse), so no step is rounded up to whole waves of equal slots.
// The chunk length is the caller's (ops/kernels/fused_slab_run.py picks
// it so that a window splits evenly); which block runs a job changes no
// bit.
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
// once with shared differences: 351 a cell in stage 1 and 353 in stages
// 2-3 (WENO5-JS, Burgers flux, viscous), 1,057 a cell a step; WENO5-Z
// adds 30 a stage, an inviscid run saves 30. At 400x400x406 that is 68.7
// G operations a step, 1.025 ms at 67 TFLOP/s; the bytes, 8 a cell a
// step, take 0.155 ms. With -fmad=false no product and sum fuse, so the
// f32 pipe issues one operation a lane a cycle: half of 67 TFLOP/s is
// the most this kernel can reach. As written, a face in a run costs
// about 102 operations, the z faces 119 and their six splits, and the
// windows recompute 4.30 stage evaluations for 3: about 1,650
// operations an output cell a step, 1.6x the count above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "slab_dma.cuh"
#include "weno5.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 3;           // WENO5 reach
constexpr int T = 32;          // output tile edge, y and x
constexpr int NR = 2 * R;      // ring planes of a stage input: z-2 .. z+3
constexpr int THREADS = 768;
constexpr long long MAX_CELLS = (1LL << 31) - 1;

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

// Stage S_ (1, 2, 3) of a step: its windows and its shared memory.
template <int S_>
struct Win {
  static constexpr int WO = T + 2 * R * (3 - S_);  // output window edge
  static constexpr int WI = WO + 2 * R;            // input window edge
  static constexpr int PLANE = WI * WI;
  static constexpr int RING = NR * PLANE;
  static constexpr int SPLIT = 2 * PLANE;            // f+ then f-
  static constexpr int FX = WO * (WO + 1);            // x faces
  static constexpr int FY = (WO + 1) * WO;            // y faces
  static constexpr int SIZE = RING + SPLIT + FX + FY;
  static constexpr int ROUNDS = (WO * WO + THREADS - 1) / THREADS;
};
constexpr int SMEM_BYTES =
    (Win<1>::SIZE + Win<2>::SIZE + Win<3>::SIZE) * (int)sizeof(float);
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB a block");

struct Args {
  int nz, ny, nx;  // global shape (K3: nz over every shard)
  float inv_dx[3];  // z, y, x
  float lap[15];    // viscous taps, z/y/x by j; unused when !viscous
  int viscous;
  float c;          // speed of the linear flux
  float dt;
  int zchunk;       // z planes a job marches
  int tiles_x, tiles;  // tiles along x, tiles a plane
  int chunks;          // z chunks of the output window
  // where the planes lie: the output window [z_lo, z_hi) (global z), the
  // buffer row of global plane 0, the buffer's planes, its ghost rows a
  // side and the exchanged operands that stand in for them (or null)
  int z_lo, z_hi, row_off, pz, depth;
  const float* lo;
  const float* hi;
};

// Buffer row `row` of S, from an exchanged operand where one stands in.
__device__ __forceinline__ const float* plane_of(const float* S,
                                                 const Args& p, int row,
                                                 int P) {
  if (p.lo != nullptr && row < p.depth) return p.lo + row * P;
  if (p.hi != nullptr && row >= p.pz - p.depth)
    return p.hi + (row - (p.pz - p.depth)) * P;
  return S + row * P;
}

// A job's output window [z_lo, z_hi) and the buffer row of global
// plane 0. Apart from Args, which the kernels read from their parameter
// space: K4 sets it a job, and a local copy of Args would sit in local
// memory.
struct Window {
  int z_lo, z_hi, row_off;
};

__device__ __forceinline__ Window window_of(const Args& p) {
  return {p.z_lo, p.z_hi, p.row_off};
}

// A stage's shared memory, carved out of the block's in stage order.
struct Mem {
  float* ring;   // NR planes of the input window
  float* split;  // f+ plane, then f- plane, of the input window
  float* fx;     // x faces: row oy, face i is the face below cell i
  float* fy;     // y faces: row i is the face below cell row i
};

template <int S_>
__device__ __forceinline__ Mem mem_of(float* base) {
  using W = Win<S_>;
  Mem m;
  m.ring = base;
  m.split = m.ring + W::RING;
  m.fx = m.split + W::SPLIT;
  m.fy = m.fx + W::FX;
  return m;
}

// The cells e = threadIdx.x + r*THREADS of a W-wide window, as (row,
// column), stepped without division.
template <int W>
struct Cursor {
  int row, col;
  __device__ __forceinline__ Cursor() {
    row = threadIdx.x / W;
    col = threadIdx.x - row * W;
  }
  __device__ __forceinline__ void next() {
    row += THREADS / W;
    col += THREADS % W;
    if (col >= W) {
      col -= W;
      ++row;
    }
  }
};

// Pass 1 for stage S_: the split of input plane z over the input window
// whose global corner is (iy, ix), every read clamped into the domain.
template <int FLUX, int S_>
__device__ __forceinline__ void split_plane(const Mem& m, int z, int iy,
                                            int ix, const Args& p) {
  using W = Win<S_>;
  const float* v = m.ring + (z % NR) * W::PLANE;
  const bool inside =
      iy >= 0 && ix >= 0 && iy + W::WI <= p.ny && ix + W::WI <= p.nx;
  Cursor<W::WI> cur;
  for (int e = threadIdx.x; e < W::PLANE; e += THREADS, cur.next()) {
    int c = e;
    if (!inside)
      c = (clampi(iy + cur.row, 0, p.ny - 1) - iy) * W::WI +
          (clampi(ix + cur.col, 0, p.nx - 1) - ix);
    split<FLUX>(v[c], p.c, m.split[e], m.split[W::PLANE + e]);
  }
}

// Faces a work item of pass 2 computes: a run along x or y.
constexpr int RUN = 3;
static_assert((T + 1) % RUN == 0, "face lines of every stage split in runs");

// Pass 2, item v of stage S_: a run of RUN x faces (v < WO*K: row r,
// faces RUN*k ..) or y faces (face rows RUN*k .., column col) of the
// output window whose global corner is (oy, ox); skipped on a row
// (column) outside the domain.
template <bool WZ, int S_>
__device__ __forceinline__ void face_item(const Mem& m, int v, int oy,
                                          int ox, const Args& p) {
  using W = Win<S_>;
  constexpr int WO = W::WO, WI = W::WI, K = (WO + 1) / RUN;
  const float* sp = m.split;
  const float* sn = m.split + W::PLANE;
  float P[RUN + 4], M[RUN + 4], h[RUN];
  if (v < WO * K) {
    const int r = v / K, i = (v - r * K) * RUN;
    if (oy + r < 0 || oy + r >= p.ny) return;
    const int c = (r + R) * WI + i;
#pragma unroll
    for (int q = 0; q < RUN + 4; ++q) {
      P[q] = sp[c + q];
      M[q] = sn[c + 1 + q];
    }
    face_run<WZ, RUN>(P, M, h);
#pragma unroll
    for (int j = 0; j < RUN; ++j) m.fx[r * (WO + 1) + i + j] = h[j];
  } else {
    v -= WO * K;
    const int k = v / WO, col = v - k * WO, i = k * RUN;
    if (ox + col < 0 || ox + col >= p.nx) return;
    const int c = i * WI + col + R;
#pragma unroll
    for (int q = 0; q < RUN + 4; ++q) {
      P[q] = sp[c + q * WI];
      M[q] = sn[c + (q + 1) * WI];
    }
    face_run<WZ, RUN>(P, M, h);
#pragma unroll
    for (int j = 0; j < RUN; ++j) m.fy[(i + j) * WO + col] = h[j];
  }
}

// Pass 2: the x and y faces of the active stages' planes, one loop over
// the three stages' runs (2 WO (WO+1) / RUN items a stage).
template <bool WZ>
__device__ __forceinline__ void faces(const Mem& m1, const Mem& m2,
                                      const Mem& m3, bool c1, bool c2,
                                      bool c3, int y0, int x0,
                                      const Args& p) {
  constexpr int N1 = 2 * Win<1>::WO * (Win<1>::WO + 1) / RUN;
  constexpr int N2 = 2 * Win<2>::WO * (Win<2>::WO + 1) / RUN;
  constexpr int N3 = 2 * Win<3>::WO * (Win<3>::WO + 1) / RUN;
  for (int v = threadIdx.x; v < N1 + N2 + N3; v += THREADS) {
    if (v < N1) {
      if (c1) face_item<WZ, 1>(m1, v, y0 - 2 * R, x0 - 2 * R, p);
    } else if (v < N1 + N2) {
      if (c2) face_item<WZ, 2>(m2, v - N1, y0 - R, x0 - R, p);
    } else if (c3) {
      face_item<WZ, 3>(m3, v - N1 - N2, y0, x0, p);
    }
  }
}

// Passes 3-5 for stage S_ on plane z: the z face above each in-domain
// cell of the output window (corner (oy, ox)) and, when `cells`, the
// stage's value there: into the next stage's ring plane `dst` (window
// layout) or, for the last stage, into the output buffer. hz holds the z
// face below each of the thread's cells.
template <int FLUX, bool WZ, int S_>
__device__ __forceinline__ void stage(const Mem& m, float* dst,
                                      const float* S, float* out, int z,
                                      bool cells, int oy, int ox, int row_off,
                                      float (&hz)[Win<S_>::ROUNDS],
                                      const Args& p) {
  using W = Win<S_>;
  constexpr int WO = W::WO, WI = W::WI;
  constexpr bool HAS_U = S_ > 1;
  constexpr bool LAST = S_ == 3;
  const float a = S_ == 1 ? 0.0f : (S_ == 2 ? A2 : A3);
  const float b = S_ == 1 ? 1.0f : (S_ == 2 ? B2 : B3);
  const float* col[NR];  // input planes z-2 .. z+3, clamped
#pragma unroll
  for (int q = 0; q < NR; ++q)
    col[q] = m.ring + (clampi(z - 2 + q, 0, p.nz - 1) % NR) * W::PLANE;
  const int P = p.ny * p.nx;
  const float* u = HAS_U ? plane_of(S, p, z + row_off, P) : nullptr;
  Cursor<WO> cur;
#pragma unroll
  for (int r = 0; r < W::ROUNDS; ++r, cur.next()) {
    const int e = threadIdx.x + r * THREADS;
    const int y = oy + cur.row, x = ox + cur.col;
    if (e >= WO * WO || y < 0 || y >= p.ny || x < 0 || x >= p.nx) continue;
    const int c = (cur.row + R) * WI + cur.col + R;
    float V[NR], Zp[NR], Zm[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      V[q] = col[q][c];
      split<FLUX>(V[q], p.c, Zp[q], Zm[q]);
    }
    const float hz_hi = face<WZ>(&Zp[0], &Zm[1]);  // face z+1/2
    if (cells) {
      const float dz = (hz_hi - hz[r]) * p.inv_dx[0];
      const int f = cur.row * (WO + 1) + cur.col;
      const float dy = (m.fy[e + WO] - m.fy[e]) * p.inv_dx[1];
      const float dx = (m.fx[f + 1] - m.fx[f]) * p.inv_dx[2];
      float rhs = -(dz + dy + dx);
      if (p.viscous) {
        const float* v = col[2];
        float acc = V[0] * p.lap[0];
#pragma unroll
        for (int q = 1; q < 5; ++q) acc = acc + V[q] * p.lap[q];
        const int iy = oy - R, ix = ox - R;  // input window corner
#pragma unroll
        for (int q = 0; q < 5; ++q)
          acc = acc + v[(clampi(y + q - 2, 0, p.ny - 1) - iy) * WI + x - ix] *
                          p.lap[5 + q];
#pragma unroll
        for (int q = 0; q < 5; ++q)
          acc = acc + v[(y - iy) * WI + clampi(x + q - 2, 0, p.nx - 1) - ix] *
                          p.lap[10 + q];
        rhs = rhs + acc;
      }
      float rk = b * (V[2] + p.dt * rhs);
      if (HAS_U) rk = a * u[y * p.nx + x] + rk;
      if (LAST)
        out[(z + row_off) * P + y * p.nx + x] = rk;
      else
        dst[e] = rk;
    }
    hz[r] = hz_hi;
  }
}

// One step on the tile `tile` and z chunk `chunk`, S -> out. Does not end
// with a barrier: the caller's job claim has one before the block's
// shared memory is reused.
template <int FLUX, bool WZ>
__device__ void step_tile(const float* S, float* out, const Args& p,
                          Window w, int tile, int chunk, float* sm) {
  const Mem m1 = mem_of<1>(sm);
  const Mem m2 = mem_of<2>(sm + Win<1>::SIZE);
  const Mem m3 = mem_of<3>(sm + Win<1>::SIZE + Win<2>::SIZE);
  const int ty = tile / p.tiles_x;
  const int x0 = (tile - ty * p.tiles_x) * T, y0 = ty * T;
  const int k0 = w.z_lo + chunk * p.zchunk;
  const int k1 = min(k0 + p.zchunk, w.z_hi);
  // cell planes of stage s: [k0 - R(3-s), k1 + R(3-s)) in the domain
  const int f1 = max(k0 - 2 * R, 0), l1 = min(k1 + 2 * R, p.nz);
  const int f2 = max(k0 - R, 0), l2 = min(k1 + R, p.nz);
  const int f3 = max(k0, 0), l3 = min(k1, p.nz);
  if (f3 >= l3) return;
  const int s_end = min(k1 + 3 * R, p.nz);  // S planes [k0 - 3R, s_end)
  const int P = p.ny * p.nx;
  float hz1[Win<1>::ROUNDS], hz2[Win<2>::ROUNDS], hz3[Win<3>::ROUNDS];

  for (int m = max(k0 - 3 * R, 0); m < l3 + 3 * R; ++m) {
    const int z1 = m - R, z2 = m - 2 * R, z3 = m - 3 * R;
    const bool c1 = z1 >= f1 && z1 < l1;
    const bool c2 = z2 >= f2 && z2 < l2;
    const bool c3 = z3 >= f3 && z3 < l3;
    // (1) S plane m, its in-domain cells; the stages' split planes
    if (m < s_end) {
      using W = Win<1>;
      float* vm = m1.ring + (m % NR) * W::PLANE;
      const float* src = plane_of(S, p, m + w.row_off, P);
      const int iy = y0 - 3 * R, ix = x0 - 3 * R;
      Cursor<W::WI> cur;
      for (int e = threadIdx.x; e < W::PLANE; e += THREADS, cur.next()) {
        const int y = iy + cur.row, x = ix + cur.col;
        if (y >= 0 && y < p.ny && x >= 0 && x < p.nx)
          vm[e] = src[y * p.nx + x];
      }
    }
    if (c1) split_plane<FLUX, 1>(m1, z1, y0 - 3 * R, x0 - 3 * R, p);
    if (c2) split_plane<FLUX, 2>(m2, z2, y0 - 2 * R, x0 - 2 * R, p);
    if (c3) split_plane<FLUX, 3>(m3, z3, y0 - R, x0 - R, p);
    __syncthreads();
    // (2) the x and y faces of the stages' planes
    faces<WZ>(m1, m2, m3, c1, c2, c3, y0, x0, p);
    __syncthreads();
    // (3) t1 = s(S) on plane z1, into stage 2's ring
    if (z1 >= f1 - 1 && z1 < l1)
      stage<FLUX, WZ, 1>(m1, m2.ring + (max(z1, 0) % NR) * Win<2>::PLANE, S,
                         out, z1, c1, y0 - 2 * R, x0 - 2 * R, w.row_off, hz1,
                         p);
    __syncthreads();
    // (4) t2 = s(t1, S) on plane z2, into stage 3's ring
    if (z2 >= f2 - 1 && z2 < l2)
      stage<FLUX, WZ, 2>(m2, m3.ring + (max(z2, 0) % NR) * Win<3>::PLANE, S,
                         out, z2, c2, y0 - R, x0 - R, w.row_off, hz2, p);
    __syncthreads();
    // (5) out = s(t2, S) on plane z3
    if (z3 >= f3 - 1 && z3 < l3)
      stage<FLUX, WZ, 3>(m3, nullptr, S, out, z3, c3, y0, x0, w.row_off, hz3,
                         p);
  }
}

// K3: one step on one job a block, S -> out (the host swaps); job b is
// chunk b / tiles of tile b % tiles.
template <int FLUX, bool WZ>
__global__ void __launch_bounds__(THREADS, 1)
step_kernel(const float* S, float* out, Args p) {
  extern __shared__ float sm[];
  const int chunk = blockIdx.x / p.tiles;
  step_tile<FLUX, WZ>(S, out, p, window_of(p), blockIdx.x - chunk * p.tiles,
                      chunk, sm);
}

// K6 (members == 1) and K2b: every member's step k over the (chunk,
// member, tile) jobs, then one grid.sync() for the whole batch. Member
// m's state starts m * member_stride floats into S0 and S1 (64-bit);
// inside a member step_tile's 32-bit indices hold.
template <int FLUX, bool WZ>
__global__ void __launch_bounds__(THREADS, 1)
slab_run_kernel(float* S0, float* S1, Args p, int n_iters, int members,
                long long member_stride, int* counters) {
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
      step_tile<FLUX, WZ>(src + off, dst + off, p, window_of(p),
                          rest - mb * p.tiles,
                          chunk, sm);
    }
    grid.sync();
  }
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

template <int FLUX, bool WZ>
cudaError_t launch(float* S0, float* S1, Args& p, int n_iters, int members,
                   int* counters, int* grid_blocks, cudaStream_t s) {
  auto* kernel = slab_run_kernel<FLUX, WZ>;
  int blocks = 0;
  cudaError_t e = cooperative_blocks(
      (const void*)kernel, (long long)p.tiles * p.chunks * members, &blocks);
  if (e != cudaSuccess) return e;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  long long member_stride = (long long)p.nz * p.ny * p.nx;
  void* args[] = {&S0, &S1, &p, &n_iters, &members, &member_stride,
                  &counters};
  return cudaLaunchCooperativeKernel((const void*)kernel, blocks, THREADS,
                                     args, SMEM_BYTES, s);
}

// The physics and tiling every entry shares; the window is the caller's.
Args make_args(int nz, int ny, int nx, const float* inv_dx, const float* lap,
               float c, float dt, int zchunk) {
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
  p.tiles_x = (nx + T - 1) / T;
  p.tiles = ((ny + T - 1) / T) * p.tiles_x;
  p.chunks = 1;
  p.z_lo = 0;
  p.z_hi = nz;
  p.row_off = 0;
  p.pz = nz;
  p.depth = 0;
  p.lo = nullptr;
  p.hi = nullptr;
  return p;
}

// The cooperative launch of K6/K2b: n_iters steps of `members` members
// whose states lie back to back in S0 and S1.
cudaError_t launch_slab_run(float* S0, float* S1, int members, int nz, int ny,
                            int nx, int flux, float c, int weno_z,
                            const float* inv_dx, const float* lap, float dt,
                            int zchunk, int n_iters, int* counters,
                            int* grid_blocks, cudaStream_t s) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 || n_iters < 0 || flux < 0 ||
      flux > 2 || members < 1 || counters == nullptr ||
      (long long)nz * ny * nx > MAX_CELLS)
    return cudaErrorInvalidValue;
  Args p = make_args(nz, ny, nx, inv_dx, lap, c, dt, zchunk);
  p.chunks = (nz + zchunk - 1) / zchunk;
  if ((long long)p.tiles * p.chunks * members > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e;
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: e = launch<BURGERS, false>(S0, S1, p, n_iters, members, counters, grid_blocks, s); break;
    case 1: e = launch<BURGERS, true>(S0, S1, p, n_iters, members, counters, grid_blocks, s); break;
    case 2: e = launch<LINEAR, false>(S0, S1, p, n_iters, members, counters, grid_blocks, s); break;
    case 3: e = launch<LINEAR, true>(S0, S1, p, n_iters, members, counters, grid_blocks, s); break;
    case 4: e = launch<BUCKLEY, false>(S0, S1, p, n_iters, members, counters, grid_blocks, s); break;
    default: e = launch<BUCKLEY, true>(S0, S1, p, n_iters, members, counters, grid_blocks, s); break;
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
// 15 host floats, or is null for an inviscid run. `zchunk` is the z
// planes of a job. `counters` points to 2 device ints, both zero at the
// launch (the steps' job counters; the launch leaves them dirty).
// `grid_blocks`, when not null, receives the grid's block count. Returns
// the first CUDA error (0 on success); does not synchronise.
extern "C" int slab_run_burgers(float* S0, float* S1, int members, int nz,
                                int ny, int nx, int flux, float c, int weno_z,
                                const float* inv_dx, const float* lap,
                                float dt, int zchunk, int n_iters,
                                int* counters, int* grid_blocks,
                                void* stream) {
  return (int)launch_slab_run(S0, S1, members, nz, ny, nx, flux, c, weno_z,
                              inv_dx, lap, dt, zchunk, n_iters, counters,
                              grid_blocks, static_cast<cudaStream_t>(stream));
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
  kernel<<<p.tiles * p.chunks, THREADS, SMEM_BYTES, s>>>(S, out, p);
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
  Args p = make_args(nz, ny, nx, inv_dx, lap, c, dt, zchunk);
  p.z_lo = z_lo;
  p.z_hi = z_hi;
  p.row_off = row_off;
  p.pz = pz;
  p.depth = depth;
  p.lo = lo;
  p.hi = hi;
  p.chunks = (z_hi - z_lo + zchunk - 1) / zchunk;
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
// 3R = 9). p carries the global shape, the physics and the tiling; each
// job's window and rows are set here. Step j of a block has the (chunk,
// shard, tile) jobs of the windows [oz - w, oz + lz + w), w = (k-1-j)G.
template <int FLUX, bool WZ>
__global__ void __launch_bounds__(THREADS, 1)
slab_run_dma_kernel(DmaShards sh, Args p, int lz, int k, int n_iters,
                    int* counters) {
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
      step_tile<FLUX, WZ>(dma_state(sh, par, i), dma_state(sh, par ^ 1, i),
                          p, {oz - w, oz + lz + w, sh.depth - oz},
                          rest - i * p.tiles, chunk, sm);
    }
    grid.sync();
  }
}

template <int FLUX, bool WZ>
cudaError_t launch_dma(DmaShards& sh, Args& p, int lz, int k, int n_iters,
                       long long jobs, int* counters, int* grid_blocks,
                       cudaStream_t s) {
  auto* kernel = slab_run_dma_kernel<FLUX, WZ>;
  int blocks = 0;
  cudaError_t e = cooperative_blocks((const void*)kernel, jobs, &blocks);
  if (e != cudaSuccess) return e;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  void* args[] = {&sh, &p, &lz, &k, &n_iters, &counters};
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
// (csrc/slab_dma.cuh). The flux and physics arguments, `counters` and
// `grid_blocks` are slab_run_burgers's. Returns the first CUDA error (0
// on success); does not synchronise.
extern "C" int slab_run_dma_burgers(float* const* s0, float* const* s1,
                                    float* const* land, int shards, int lz,
                                    int k, int ny, int nx, int flux, float c,
                                    int weno_z, const float* inv_dx,
                                    const float* lap, float dt, int zchunk,
                                    int n_iters, int* counters,
                                    int* grid_blocks, void* stream) {
  const int depth = k * 3 * R;
  const int pz = lz + 2 * depth;
  if (shards < 1 || shards > DMA_MAX_SHARDS || k < 1 || n_iters < 0 ||
      lz < depth || ny < 1 || nx < 1 || zchunk < 1 || flux < 0 || flux > 2 ||
      counters == nullptr || (long long)pz * ny * nx > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  Args p = make_args(shards * lz, ny, nx, inv_dx, lap, c, dt, zchunk);
  p.pz = pz;
  p.depth = depth;
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
  const long long jobs = (long long)shards * p.tiles *
                         ((lz + 2 * depth - 6 * R + zchunk - 1) / zchunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flux * 2 + (weno_z ? 1 : 0)) {
    case 0: return (int)launch_dma<BURGERS, false>(sh, p, lz, k, n_iters, jobs, counters, grid_blocks, s);
    case 1: return (int)launch_dma<BURGERS, true>(sh, p, lz, k, n_iters, jobs, counters, grid_blocks, s);
    case 2: return (int)launch_dma<LINEAR, false>(sh, p, lz, k, n_iters, jobs, counters, grid_blocks, s);
    case 3: return (int)launch_dma<LINEAR, true>(sh, p, lz, k, n_iters, jobs, counters, grid_blocks, s);
    case 4: return (int)launch_dma<BUCKLEY, false>(sh, p, lz, k, n_iters, jobs, counters, grid_blocks, s);
    default: return (int)launch_dma<BUCKLEY, true>(sh, p, lz, k, n_iters, jobs, counters, grid_blocks, s);
  }
}
