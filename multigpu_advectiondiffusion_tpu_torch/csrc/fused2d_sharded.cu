// One SSP-RK3 stage of the 2-D O4 heat equation or of 2-D Burgers/WENO5
// or WENO7-JS over a shard of a device mesh (K8), or over the bands of it
// that the split schedule writes (K8b).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// fused2d_sharded.py::_make_stage (:170, call site :195) and
// ::_make_band_stage (:206, call site :231), with the stage bodies
// _diffusion_stage (:143) and _burgers_stage (:121). There a 2-D shard
// fits VMEM whole, so each stage is one whole-array block; the split
// schedule's band calls take a row slice of the buffer with the exchanged
// ghost rows concatenated onto it. Here a launch writes one or two bands
// of interior rows [r0, r1) of the shard: the whole shard (K8), the split
// schedule's interior band, or its bottom band [0, h) and top band
// [ly - h, ly) together (K8b), the edge bands reading the ghost rows from
// the exchanged operands lo and hi in place of the buffer's (nothing is
// concatenated).
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
// e-form WENO5 or WENO7 face fluxes (weno7e.cuh::face_run_of<R, WZ, RUN>,
// K7's), rhs = -(div_y + div_x) [+ the O4 viscous taps], rk = b*(v +
// dt*rhs) and a*u + rk. A neighbour outside the GLOBAL domain is the
// nearest global edge cell (the TPU body's _edge_fill_global, read as K7
// clamps), which lies in this shard; a neighbour in another shard is read
// from the ghost rows or columns the refresh (or the exchanged operand)
// left. dt is read from the device; with `mx` the stage folds
// max|f'(out)| over the cells it writes into *mx (the adaptive step's
// wave speed). Built with -fmad=false, as K7 is: every operation rounds
// where K7's does, so a sharded run equals K7's unsharded run to the bit.
//
// Aliasing: the third stage runs in place (u == out). Each thread reads u
// only at the cell it writes, before it writes it, and v is never out.
//
// Design. The first port ran a cell a thread: each computed both faces of
// its cell on each axis from the 2R + 1 cells of its line, loaded and
// split again a cell (about 450 f32 operations a cell at WENO5, twice the
// face-once count), and the host prepared each launch from scratch. Here:
//
// - Tiles (body TILED, Burgers). A block takes a tile of the rows a
//   launch writes: near-equal parts of each band's rows, tx columns (the
//   last tile ragged), planned on the host (ops/kernels/fused2d_sharded.py::
//   plan_tiles). It loads the tile and R cells a side on both axes into
//   shared memory, each cell once (`vec` floats a load where the row's
//   pitch and the tile's columns allow: 8-byte copies at R = 3, 16-byte at
//   R = 4), and splits it once into f+ and f- planes; then every x face of
//   the tile's rows and y face of its columns once, in runs of three along
//   a line (K7's face_run_of), one run a thread, into two face planes;
//   after a barrier each cell takes its divergences, the viscous taps from
//   the v plane, the combine and the store, in the twin's order. u of a
//   thread's first two cells is loaded before the window. The last run of
//   a line reads SPARE cells past the window, which the load fills with
//   zeros; its extra faces land where no cell reads them.
// - A cell a thread (body CELL): the first port's kernels, unchanged but
//   for the emitted maximum's fold and a second band (the paired edge
//   bands: a block row of band rows each). The planner keeps them where
//   they measured faster (plan_tiles' rule, PERF.md): diffusion, the split
//   schedule's edge bands, WENO5 launches bound by their latency (the
//   200x400 shard).
// - The emitted maximum without a memset: each block folds its cells'
//   |f'| (bits as unsigned ints: |f'| >= 0, so a float's order is its
//   bits', and a NaN lies above +inf and is kept, as K7a keeps it) into a
//   scratch word by atomicMax; the last block to finish (a count that
//   wraps to 0 by itself, taken with one acq_rel atomic) takes the word,
//   zeroing it for the next launch, and writes it to *mx (mx_init) or the
//   larger of it and *mx.
// - The launch plan. The host fills a Plan once a stage kind and band
//   (geometry, parameters, tiles, the scratch words) and each launch
//   passes only the buffers, dt and the plan's address:
//   fused2d_launch.
//
// Bound on an H100: K8 on the main shard (200x400 of 400^2 on dy=2) must
// move 8 B a cell (12 with u), 0.64-0.96 MB, 0.19-0.29 us at 3.35 TB/s;
// diffusion's 22-24 f32 operations a cell take 0.03 us at 67 TFLOP/s,
// Burgers' 219-239 (each face once; WENO7 about 460) 0.3-0.6 us: both are
// launch-bound at this size (a launch costs a few us), and the 2-D mesh
// path is bound by the host's exchange between stages (PERF.md). On a
// 2048x4096 shard the bounds are 30 us by bytes and 27 us (WENO5) or 58
// us (WENO7) by operations. The tiled Burgers body issues, a cell, the
// splits of its window share, a third of each of its two lines' runs of
// three faces and its own 6 + 20 + 5 (fused2d_sharded.ops_issued counts a
// launch).

#include <cuda_runtime.h>

#include <cstdint>

#include "weno5.cuh"
#include "weno7e.cuh"

namespace {

constexpr int BX = 32;  // the CELL body: threads along x (one warp)
constexpr int BY = 8;   // threads along y
constexpr int MAX_THREADS = 512;  // the TILED body's largest block
constexpr int RUN = 3;    // faces a work item computes
constexpr int SPARE = 2;  // rows / columns the last run of a line reads
constexpr int LOADS = 4;  // window loads a thread issues before it stores
constexpr int PLANES = 5;  // TILED: v, f+, f-, x faces, y faces

// ghost depth of the diffusion layout: the O4 reach (the Burgers layout's
// is the WENO reach R, a template parameter)
constexpr int H_DIFFUSION = 2;

// floats a TILED window load moves at most, by reach: the Burgers layout's
// pitch lx + 2R is even at R = 3 for an even lx, a multiple of 4 at R = 4
// for lx a multiple of 4
template <int R>
constexpr int VMAX = R == 4 ? 4 : 2;

enum { CELL = 0, TILED = 1 };

// A launch's plan, filled on the host once a stage kind and band; mirrored
// field for field by ops/kernels/fused2d_sharded.py::_Plan.
struct Plan {
  unsigned int* scratch;  // 2 device words: the blocks' max, blocks done
  int device;
  int ly, lx;            // local interior shape
  int gy, gx;            // global interior shape
  int oy, ox;            // global index of local interior cell (0, 0)
  int nbands;            // 1, or 2 (both edge bands, from lo and hi)
  int r0[2], r1[2];      // interior rows [r0, r1) each band writes
  int my[2];             // tiles along y of each band
  int mx, tx;            // tiles along x, of tx columns (the last ragged)
  int body;              // CELL or TILED
  int threads;           // a block's threads (CELL: BX a tile row)
  int vec;               // TILED: floats a window load, 1 or VMAX<R>
  int pitch, plane;      // TILED: shared planes (floats)
  int smem;              // TILED: dynamic shared memory (bytes)
  int kind;              // 0 diffusion, 1 Burgers
  int flux, weno_z, order;
  float a, b;
  float taps[10];  // diffusion: [axis y, x][tap j]
  int band;
  float bc_value;
  float inv_dx[2];  // Burgers: y, x
  float lap[10];    // viscous taps, y/x by j; unused when !viscous
  int viscous;
  float c;  // speed of the linear flux
};

// What the host passes a launch besides its plan (mirrored by
// ops/kernels/fused2d_sharded.py::_Args).
struct Args {
  const float* v;
  const float* u;
  float* out;
  const float* lo;
  const float* hi;
  const float* dt_ptr;
  float* mx;
  void* stream;
  float dt;
  int mx_init;
};

// The emitted maximum's words: *mx, the plan's scratch, mx_init.
struct Fold {
  unsigned int* mx;  // null: no maximum emitted
  unsigned int* scratch;
  int init;
};

// Folds every thread's `bits` into the launch's maximum: the block's
// largest into scratch[0] by atomicMax; the last block to finish (its
// count wrapping to 0 for the next launch) takes the word, zeroing it,
// and writes it to *mx, or the larger of it and *mx unless init. Every
// thread of the block calls it; the block has a multiple of 32 threads.
__device__ __forceinline__ void fold_max(unsigned int bits, const Fold& f) {
  __shared__ unsigned int warp_max[MAX_THREADS / 32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = blockDim.x * blockDim.y / 32;
  const unsigned int w = __reduce_max_sync(0xffffffffu, bits);
  if ((tid & 31) == 0) warp_max[tid >> 5] = w;
  __syncthreads();
  if (tid != 0) return;
  unsigned int m = warp_max[0];
  for (int q = 1; q < nwarps; ++q) m = warp_max[q] > m ? warp_max[q] : m;
  atomicMax(f.scratch, m);
  // the count, wrapping to 0 after the last block: its release orders this
  // block's atomicMax before it, its acquire every block's before the last
  // block's exchange (one acq_rel atomic, no full fence)
  const unsigned int last = gridDim.x * gridDim.y - 1;
  unsigned int ticket;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(ticket)
               : "l"(f.scratch + 1), "r"(last)
               : "memory");
  if (ticket != last) return;
  const unsigned int all = atomicExch(f.scratch, 0u);
  const unsigned int old = f.init ? 0u : *f.mx;
  *f.mx = all > old ? all : old;
}

// --------------------------------------------------------------------- //
// CELL bodies: a cell a thread, blocks of BX x (at most BY) threads
// --------------------------------------------------------------------- //

// A CELL launch's place in the global grid.
struct Geometry {
  int ly, lx;          // local interior shape
  int gy, gx;          // global interior shape
  int oy, ox;          // global index of local interior cell (0, 0)
  int r_begin, r_end;  // local interior rows written (the first band)
  // with the operands: the second band's rows, written by the block rows
  // from `split` on (split = gridDim.y for one band)
  int r_begin2, r_end2, split;
};

// This thread's local row `j`, false past its band's rows. Without the
// operands a launch writes one band in block rows of BY; with them one or
// two bands, a block row of blockDim.y rows each.
template <bool OPERANDS>
__device__ __forceinline__ bool row_of(const Geometry& g, int& j) {
  if (!OPERANDS) {
    j = g.r_begin + blockIdx.y * BY + threadIdx.y;
    return j < g.r_end;
  }
  const bool second = (int)blockIdx.y >= g.split;
  const int by = (int)blockIdx.y - (second ? g.split : 0);
  j = (second ? g.r_begin2 : g.r_begin) + by * (int)blockDim.y +
      (int)threadIdx.y;
  return j < (second ? g.r_end2 : g.r_end);
}

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
fused2d_diffusion_cell(const float* v, const float* u, float* out,
                       const float* lo, const float* hi, Geometry g,
                       DiffusionParams p) {
  constexpr int H = H_DIFFUSION;
  const int i = blockIdx.x * BX + threadIdx.x;  // local x
  int j;                                        // local y
  if (!row_of<OPERANDS>(g, j) || i >= g.lx) return;
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
fused2d_burgers_cell(const float* v, const float* u, float* out,
                     const float* lo, const float* hi, Geometry g,
                     BurgersParams p, const float* dt_ptr, Fold f) {
  constexpr int H = R;       // the layout's ghost depth is the reach
  constexpr int N = 2 * R + 1;  // a line's cells, j-R .. j+R
  const int i = blockIdx.x * BX + threadIdx.x;  // local x
  int j;                                        // local y
  // every thread reaches the block's reduction below
  const bool active = row_of<OPERANDS>(g, j) && i < g.lx;
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
    if (f.mx != nullptr)
      mbits = __float_as_uint(fabsf(flux_df<FLUX>(rk, c)));
  }
  if (f.mx != nullptr) fold_max(mbits, f);  // uniform across the launch
}

// --------------------------------------------------------------------- //
// The TILED body (Burgers)
// --------------------------------------------------------------------- //

// What a TILED launch passes: the buffers, dt, the fold and the plan.
struct Launch {
  const float* v;
  const float* u;  // null for stage 1; may equal out
  float* out;
  const float* lo;  // (R, lx + 2R) rows standing in below the shard
  const float* hi;  // ... and above it
  const float* dt_ptr;  // one float on the device
  Fold f;
  Plan p;
};

// The tile of this block: tiles of band 0 first, then band 1's; each
// band cut into my[band] near-equal parts of its rows and mx parts of tx
// columns, the last ragged. 32-bit arithmetic: fused2d_prepare takes
// shards of at most 65535 rows and columns.
struct Tile {
  int y0, y1, x0, x1;  // local interior rows and columns
};

__device__ __forceinline__ Tile tile_of(const Plan& p) {
  unsigned int t = blockIdx.y;
  const bool second = t >= (unsigned int)p.my[0];
  if (second) t -= p.my[0];
  const int r0 = second ? p.r0[1] : p.r0[0];
  const unsigned int n = (second ? p.r1[1] : p.r1[0]) - r0;
  const unsigned int m = second ? p.my[1] : p.my[0];
  Tile T;
  T.y0 = r0 + (int)(t * n / m);
  T.y1 = r0 + (int)((t + 1) * n / m);
  T.x0 = (int)blockIdx.x * p.tx;
  T.x1 = min(T.x0 + p.tx, p.lx);
  return T;
}

// Padded row `r` of the stage input (in_row's rule, for a TILED launch).
template <int H>
__device__ __forceinline__ const float* tile_row(const Launch& L, int r,
                                                 long long X) {
  if (L.lo != nullptr && r < 0) return L.lo + (long long)(r + H) * X;
  if (L.hi != nullptr && r >= L.p.ly)
    return L.hi + (long long)(r - L.p.ly) * X;
  return L.v + (long long)(r + H) * X;
}

// V floats from `src` into `val`: one 8- or 16-byte load (V = 2, 4).
template <int V>
__device__ __forceinline__ void load_vec(const float* src, float* val) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src));
    val[0] = q.x;
    val[1] = q.y;
    val[2] = q.z;
    val[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(src));
    val[0] = q.x;
    val[1] = q.y;
  } else {
    val[0] = __ldg(src);
  }
}

// The window of tile T, rows T.y0 - R .. T.y1 + R and columns T.x0 - R
// .. T.x1 + R of the stage input, and SPARE more rows and columns of
// zeros, each cell once: put(at, value) with `at` its place in a plane of
// pitch P. A row or column outside the GLOBAL domain is the nearest global
// edge one; rows below and above the shard come from lo/hi where given.
// A work item is V adjacent cells of a row: one V-float load where the
// window's columns lie in the global domain and the row's address is
// aligned to it, else a load a cell. Every thread issues LOADS items'
// loads before it puts one.
template <int R, int V, class Put>
__device__ __forceinline__ void load_window(const Launch& L, const Tile& T,
                                            int P, Put put) {
  const Plan& p = L.p;
  const long long X = p.lx + 2 * R;
  const int wr = T.y1 - T.y0 + 2 * R, wc = T.x1 - T.x0 + 2 * R;
  const int W = wc + SPARE, nq = (W + V - 1) / V;
  const int items = (wr + SPARE) * nq;
  const bool inside = T.x0 - R + p.ox >= 0 && T.x1 + R + p.ox <= p.gx;
  const int nt = blockDim.x;
  for (int n0 = threadIdx.x; n0 < items; n0 += LOADS * nt) {
    float val[LOADS][V];
    int at[LOADS], cnt[LOADS];
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int n = n0 + e * nt;
      cnt[e] = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) val[e][k] = 0.0f;
      if (n >= items) continue;
      const int y = n / nq, x = (n - y * nq) * V;
      at[e] = y * P + x;
      cnt[e] = min(V, W - x);
      if (y >= wr) continue;  // a spare row: zeros
      const int r = clampi(T.y0 - R + y + p.oy, 0, p.gy - 1) - p.oy;
      // window column x is padded column T.x0 + x of the row
      const float* row = tile_row<R>(L, r, X) + T.x0;
      if (V > 1 && inside && x + V <= wc &&
          (reinterpret_cast<std::uintptr_t>(row + x) % (4 * V)) == 0) {
        load_vec<V>(row + x, val[e]);
        continue;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (x + k >= wc) break;  // spare columns: zeros
        const int col = clampi(T.x0 - R + x + k + p.ox, 0, p.gx - 1) - p.ox;
        val[e][k] = __ldg(row - T.x0 + col + R);
      }
    }
#pragma unroll
    for (int e = 0; e < LOADS; ++e)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k < cnt[e]) put(at[e] + k, val[e][k]);
  }
}

// The viscous taps' sum of the cell at `at` of the v plane (vc its
// value), y then x, j ascending, in the twin's order.
__device__ __forceinline__ float lap_acc(const float* v, int at, int P,
                                         float vc, const float* lap) {
  float acc = v[at - 2 * P] * lap[0];
  acc = acc + v[at - P] * lap[1];
  acc = acc + vc * lap[2];
  acc = acc + v[at + P] * lap[3];
  acc = acc + v[at + 2 * P] * lap[4];
  acc = acc + v[at - 2] * lap[5];
  acc = acc + v[at - 1] * lap[6];
  acc = acc + vc * lap[7];
  acc = acc + v[at + 1] * lap[8];
  acc = acc + v[at + 2] * lap[9];
  return acc;
}

template <int R, int FLUX, bool WZ, int V>
__global__ void __launch_bounds__(MAX_THREADS)
fused2d_burgers_tiled(const __grid_constant__ Launch L) {
  extern __shared__ float smem[];
  const Plan& p = L.p;
  const Tile T = tile_of(p);
  const int nr = T.y1 - T.y0, nc = T.x1 - T.x0;
  const int P = p.pitch;
  float* const sv = smem;
  float* const fp = sv + p.plane;
  float* const fm = fp + p.plane;
  float* const hx = fm + p.plane;  // face left of the cell
  float* const hy = hx + p.plane;  // face above the cell
  const float c = p.c;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long X = p.lx + 2 * R;
  const int cells = nr * nc;

  // u at this thread's first two cells, loaded first: its round trip
  // overlaps the window's
  float u0 = 0.0f, u1 = 0.0f;
  if (L.u != nullptr) {
    for (int k = 0; k < 2; ++k) {
      const int t = tid + k * nt;
      if (t >= cells) break;
      const int r = t / nc;
      const float w =
          L.u[(long long)(T.y0 + r + R) * X + (T.x0 + t - r * nc + R)];
      if (k == 0) u0 = w; else u1 = w;
    }
  }

  // (A) the window, each cell split once
  load_window<R, V>(L, T, P, [&](int at, float w) {
    sv[at] = w;
    split<FLUX>(w, c, fp[at], fm[at]);
  });
  __syncthreads();

  // (B) x runs: tile row r, faces left of cells 3q .. 3q + 2 (nc + 1
  // faces a row); y runs: column col, faces above rows 3q .. 3q + 2. The
  // y runs start a warp.
  constexpr int NV = RUN + 2 * R - 2;  // split values a run reads a side
  const int base = R * P + R;          // tile cell (0, 0) in a plane
  const int rx = nc / RUN + 1, ry = nr / RUN + 1;
  const int nxi = nr * rx, nyi = nc * ry;
  const int nxi_pad = (nxi + 31) & ~31;
  for (int t = tid; t < nxi_pad + nyi; t += nt) {
    float F[NV], M[NV], h[RUN];
    if (t < nxi) {
      const int r = t / rx, q = t - r * rx;
      const int at = base + r * P + RUN * q;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        F[k] = fp[at - R + k];
        M[k] = fm[at - R + 1 + k];
      }
      face_run_of<R, WZ, RUN>(F, M, h);
#pragma unroll
      for (int j = 0; j < RUN; ++j) hx[at + j] = h[j];
    } else if (t >= nxi_pad) {
      const int e = t - nxi_pad;
      const int q = e / nc, col = e - q * nc;
      const int at = base + RUN * q * P + col;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        F[k] = fp[at + (k - R) * P];
        M[k] = fm[at + (k - R + 1) * P];
      }
      face_run_of<R, WZ, RUN>(F, M, h);
#pragma unroll
      for (int j = 0; j < RUN; ++j) hy[at + j * P] = h[j];
    }
  }
  __syncthreads();

  // (C) the cells
  const float dt = *L.dt_ptr;
  unsigned int mbits = 0u;
  const int dr = nt / nc, dc = nt - dr * nc;
  int r = tid / nc, cc = tid - r * nc;
  for (int t = tid, k = 0; t < cells; t += nt, ++k) {
    const int at = base + r * P + cc;
    const float vc = sv[at];
    const float dy = (hy[at + P] - hy[at]) * p.inv_dx[0];
    const float dx = (hx[at + 1] - hx[at]) * p.inv_dx[1];
    float rhs = -(dy + dx);
    if (p.viscous) rhs = rhs + lap_acc(sv, at, P, vc, p.lap);
    const long long cell = (long long)(T.y0 + r + R) * X + (T.x0 + cc + R);
    float rk = p.b * (vc + dt * rhs);
    if (L.u != nullptr)
      rk = p.a * (k == 0 ? u0 : (k == 1 ? u1 : L.u[cell])) + rk;
    L.out[cell] = rk;
    if (L.f.mx != nullptr) {
      const unsigned int bits = __float_as_uint(fabsf(flux_df<FLUX>(rk, c)));
      mbits = bits > mbits ? bits : mbits;
    }
    r += dr;
    cc += dc;
    if (cc >= nc) {
      cc -= nc;
      ++r;
    }
  }
  if (L.f.mx != nullptr) fold_max(mbits, L.f);  // uniform across the launch
}

// --------------------------------------------------------------------- //
// Host side
// --------------------------------------------------------------------- //

// The CELL kernel of a plan, with `has_u` and `operands` (lo or hi given).
template <bool HAS_U, bool OPERANDS>
const void* cell_kernel(const Plan& p) {
  if (p.kind == 0)
    return (const void*)fused2d_diffusion_cell<HAS_U, OPERANDS>;
  const void* k = nullptr;
  dispatch(p.flux, p.order, p.weno_z, [&](auto r, auto fl, auto wz) {
    k = (const void*)fused2d_burgers_cell<decltype(r)::value,
                                          decltype(fl)::value,
                                          decltype(wz)::value, HAS_U,
                                          OPERANDS>;
    return cudaSuccess;
  });
  return k;
}

const void* kernel_of(const Plan& p, bool has_u, bool operands) {
  if (p.body == CELL) {
    if (has_u)
      return operands ? cell_kernel<true, true>(p)
                      : cell_kernel<true, false>(p);
    return operands ? cell_kernel<false, true>(p)
                    : cell_kernel<false, false>(p);
  }
  const void* k = nullptr;
  dispatch(p.flux, p.order, p.weno_z, [&](auto r, auto fl, auto wz) {
    constexpr int R = decltype(r)::value;
    if (p.vec == VMAX<R>)
      k = (const void*)fused2d_burgers_tiled<R, decltype(fl)::value,
                                             decltype(wz)::value, VMAX<R>>;
    else
      k = (const void*)fused2d_burgers_tiled<R, decltype(fl)::value,
                                             decltype(wz)::value, 1>;
    return cudaSuccess;
  });
  return k;
}

bool plan_ok(const Plan& p) {
  const int h = p.kind == 0 ? H_DIFFUSION : (p.order == 7 ? 4 : 3);
  if (p.ly < 1 || p.lx < 1 || p.ly > 65535 || p.lx > 65535 || p.oy < 0 ||
      p.ox < 0 || p.oy + p.ly > p.gy || p.ox + p.lx > p.gx ||
      p.nbands < 1 || p.nbands > 2 || p.tx < 1 ||
      p.mx != (p.lx + p.tx - 1) / p.tx || p.kind < 0 || p.kind > 1 ||
      (p.body != CELL && p.body != TILED))
    return false;
  for (int b = 0; b < p.nbands; ++b)
    if (p.r0[b] < 0 || p.r1[b] > p.ly || p.r0[b] >= p.r1[b] || p.my[b] < 1 ||
        p.my[b] > p.r1[b] - p.r0[b])
      return false;
  if (p.nbands == 1 && p.my[1] != 0) return false;
  if (p.body == CELL) {  // tiles of threads / BX x BX cells, ragged last
    const int rows = p.threads / BX;
    if (p.threads % BX != 0 || rows < 1 || rows > BY || p.tx != BX)
      return false;
    for (int b = 0; b < p.nbands; ++b)
      if (p.my[b] != (p.r1[b] - p.r0[b] + rows - 1) / rows) return false;
    // one band in block rows of BY (or one block row), or a block row a
    // band (the paired edge bands)
    if (p.nbands == 1 && rows != BY && p.my[0] != 1) return false;
    if (p.nbands == 2 && (p.my[0] != 1 || p.my[1] != 1)) return false;
  } else {  // Burgers: every tile's window (and SPARE) fits the planes
    if (p.kind != 1 || p.threads < 32 || p.threads > MAX_THREADS ||
        p.threads % 32 != 0)
      return false;
    const int vmax = h == 4 ? VMAX<4> : VMAX<3>;
    if (p.vec != 1 && (p.vec != vmax || (p.lx + 2 * h) % p.vec != 0 ||
                       p.tx % p.vec != 0))
      return false;
    int ty = 0;
    for (int b = 0; b < p.nbands; ++b) {
      const int side = (p.r1[b] - p.r0[b] + p.my[b] - 1) / p.my[b];
      ty = side > ty ? side : ty;
    }
    if (p.pitch < p.tx + 2 * h + SPARE ||
        p.plane < (ty + 2 * h + SPARE) * p.pitch ||
        p.smem != PLANES * p.plane * (int)sizeof(float))
      return false;
  }
  if (p.kind == 1 && (p.flux < 0 || p.flux > 2 ||
                      (p.order != 5 && p.order != 7) ||
                      (p.order == 7 && p.weno_z) || p.scratch == nullptr))
    return false;
  return true;
}

}  // namespace

// The card's numbers the planner takes, for `device`, into out[0..1]: its
// SMs and the dynamic shared memory a block may opt into. Returns the
// first CUDA error (0 on success).
extern "C" int fused2d_card(int device, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  return (int)e;
}

// Check a plan (a Plan) and let its kernel take its shared memory: the
// TILED kernel's limit (one for every plan of its instance) is raised to
// the plan's, never lowered, so every plan prepared before stays
// launchable. Called once a plan; returns cudaErrorInvalidValue for a plan
// the kernels do not take, else the first CUDA error (0 on success).
extern "C" int fused2d_prepare(const void* plan) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  if (p.body != TILED || p.smem <= 48 * 1024) return 0;
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != p.device) e = cudaSetDevice(p.device);
  const void* kernel = kernel_of(p, true, false);  // u is a run-time choice
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < p.smem)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (cur != p.device) cudaSetDevice(cur);
  return (int)e;
}

// Launch one stage as `plan` (a Plan checked by fused2d_prepare) says,
// with `args` (an Args): `v` the stage input, `u` null for stage 1 (may
// equal `out`), `lo`/`hi`, when not null, (h, lx + 2h) rows standing in
// for the ghost rows below/above the shard (both for a plan of two
// bands); diffusion takes `dt` by value, Burgers at `dt_ptr` (one float
// on the device) and, when `mx` is not null, folds max|f'(out)| over the
// rows written into it (its value replaced when mx_init is not 0); on
// `stream`. Returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int fused2d_launch(const void* plan, const void* args) {
  const Plan& p = *static_cast<const Plan*>(plan);
  const Args& a = *static_cast<const Args*>(args);
  const bool operands = a.lo != nullptr || a.hi != nullptr;
  if ((p.kind == 0 && a.mx != nullptr) ||
      (p.kind == 1 && a.dt_ptr == nullptr) ||
      (p.nbands == 2 && (a.lo == nullptr || a.hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Fold f{reinterpret_cast<unsigned int*>(a.mx), p.scratch, a.mx_init};
  const dim3 grid(p.mx, p.my[0] + (p.nbands > 1 ? p.my[1] : 0), 1);
  const void* kernel = kernel_of(p, a.u != nullptr, operands);
  // the kernels' arguments, by body and kind
  Geometry g{p.ly, p.lx, p.gy, p.gx, p.oy, p.ox, p.r0[0], p.r1[0],
             p.r0[1], p.r1[1], p.my[0]};
  DiffusionParams dp;
  BurgersParams bp;
  Launch L{a.v, a.u, a.out, a.lo, a.hi, a.dt_ptr, f, p};
  void* diffusion_args[] = {(void*)&a.v, (void*)&a.u, (void*)&a.out,
                            (void*)&a.lo, (void*)&a.hi, &g, &dp};
  void* burgers_args[] = {(void*)&a.v, (void*)&a.u, (void*)&a.out,
                          (void*)&a.lo, (void*)&a.hi, &g, &bp,
                          (void*)&a.dt_ptr, (void*)&f};
  void* tiled_args[] = {&L};
  void** kargs = tiled_args;
  dim3 block(p.threads, 1, 1);
  size_t smem = (size_t)p.smem;
  if (p.body == CELL) {
    block = dim3(BX, p.threads / BX, 1);
    smem = 0;
    if (p.kind == 0) {
      for (int q = 0; q < 10; ++q) dp.taps[q] = p.taps[q];
      dp.dt = a.dt;
      dp.a = p.a;
      dp.b = p.b;
      dp.bc_value = p.bc_value;
      dp.band = p.band;
      kargs = diffusion_args;
    } else {
      for (int q = 0; q < 2; ++q) bp.inv_dx[q] = p.inv_dx[q];
      for (int q = 0; q < 10; ++q) bp.lap[q] = p.lap[q];
      bp.viscous = p.viscous;
      bp.c = p.c;
      bp.a = p.a;
      bp.b = p.b;
      kargs = burgers_args;
    }
  }
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != p.device) e = cudaSetDevice(p.device);
  if (e == cudaSuccess)
    e = cudaLaunchKernel(kernel, grid, block, kargs, smem,
                         static_cast<cudaStream_t>(a.stream));
  if (cur != p.device) cudaSetDevice(cur);
  return (int)e;
}
