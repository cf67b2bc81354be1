// One SSP-RK3 stage of 3-D Burgers / scalar conservation law with WENO5
// or WENO7, fused into one kernel (K5).
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// fused_burgers.py::_stage_kernel (:352, built by _make_stage :688) for
// WENO5-JS/Z and WENO7-JS (below), on one device and on the shards of
// every mesh layout (z slabs, y or x slabs, pencils and blocks: the TPU
// stepper's y_sharded/x_sharded layouts, fused_burgers.py:847-849). It
// computes the same function, not the same blocks:
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
// A shard of a z-slab mesh keeps zpad = R ghost planes (the reach: 3 at
// WENO5, 4 at WENO7) below and above its (lz, ny, nx) block, (lz + 2R,
// ny, nx), which the halo refresh rewrites from the neighbours after
// every stage (parallel/halo.py); a z neighbour index is clamped at the
// global z edges only (the TPU kernel's edge fill keys on global rows,
// fused_burgers.py:846-910), y and x as before. The split schedule's
// calls write the planes [k_begin, k_end) of the block and may take the
// ghost planes below or above from the exchanged operands lo/hi ((zpad,
// ny, nx) each).
// A shard of a mesh that cuts y and/or x (the YX instance) stores R ghost
// rows and/or columns on each cut axis as well, its plane (ly + 2R) x (lx
// + 2R) on both cut axes or on one, and clamps a y or x neighbour index
// at the global edges only, as z above: inside the domain the tile's
// halo reads the stored ghosts the refresh wrote, at a global wall the
// edge cell, and so does a thread whose column lies past the core (the
// last core row's or column's faces read its tile cell). Its z axis is cut or whole (zpad R or 0), with the split
// roles and operands when cut (their planes at the stored pitch). What
// the TPU layout adds for its (8, 128) tiles (the y margin, the x ghost
// lanes rounded to 128, the x working tail) has no purpose here; the
// pitch is whatever nx + 2R is, and every load is a scalar 4-byte load,
// so no alignment is assumed. Only the geometry's integer arithmetic
// differs: a cell's operations and their order are the unsharded
// kernel's, so a sharded run equals the unsharded one to the bit.
//
// Aliasing: the third stage runs in place (u == out). That is safe
// because each thread reads u only at its own cells, each before it
// writes it, and v (the only array read through shared memory) is
// always a different buffer from out.
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
// Design: a block of TX x TY threads (one warp a tile row) owns a
// TY x TX (y, x) output tile and marches a chunk of z planes (zchunk);
// each thread owns one (y, x) column of the tile. For each plane k:
//   (A) the block writes plane k's (TY + 6) x (TX + 6) tile of v and its
//       split f+ and f- into shared memory: a thread's own cell from its
//       z window (below), the 3-cell halo from global memory at clamped
//       indices (the edge replicas; loaded while plane k-1 was
//       computed), each split once;
//   (B) after a barrier, the TX + 1 x faces of every tile row and the
//       TY + 1 y faces of every tile column, each computed once, in runs
//       of three (weno5.cuh::face_run: what neighbouring faces share is
//       computed once), one run a thread, into shared memory; and each
//       thread's z face k+1/2 from its register window;
//   (C) after a barrier, each cell takes (h[+1/2] - h[-1/2]) * (1/dx) on
//       each axis, the Laplacian's y/x taps from the tile and its z taps
//       from the window, and writes rk.
// The tile is double-buffered ((A) of plane k+1 may overwrite one buffer
// while (C) of plane k still reads the other), so a plane costs two
// barriers. The z window keeps v and its split on planes k-3 .. k+3 of
// the thread's column in registers and the z face below plane k, so each
// z face is computed once within a chunk (once more where chunks meet);
// the plane entering the window, the next plane's halo and u at the
// next cell are loaded one plane ahead. Threads whose column lies
// outside the grid march the clamped column, which is what the tile's
// edge replicas hold, and write nothing. A face flux is a function of
// its ten split values only, so the bits are the twin's.
//
// Tile: 14 x 32, 448 threads, 2 blocks an SM (70 registers a thread, no
// spills), 22,064 bytes of static shared memory a block (2 x 3 planes of
// 20 x 38 floats, 14 x 33 x faces, 15 x 32 y faces, a word a warp), z
// chunks of 64 planes, fewer where a grid has too few tiles to fill the
// card (ops/kernels/fused_burgers.py stage_zchunk). Timed alone at
// 512^3 and 400x400x406 on an H100 against 5x32 (5 blocks an SM), 8x32
// (2, 3 and 4 blocks; 4 spill), 11x32 (2, 3), 17x32, 20x32, 26x32 and
// 32x32 (1 block), z chunks of 16-128, the z face in (B) or in (C), and a
// software-pipelined body with one barrier a plane (three tile buffers,
// the faces of plane k beside the cells of plane k-1): this one was the
// fastest, most variants with two or more blocks an SM within 5 % of
// it, the pipelined ones near 20 % slower and the one-block 14x32 ones
// near 45 %. What a taller tile saves in halo splits and extra faces,
// fewer resident blocks give back.
//
// Issued operations a cell (f32 operations counted as above; Burgers
// flux): the split of the cell entering the z window 6 (and 7 more
// splits of the window a chunk); the halo's splits, 6 (PLANE -
// THREADS) / THREADS; the x faces (TX+1)/TX and the y faces (TY+1)/TY
// of a face in a run of three, 305 / 3 a face (WENO5-Z 335 / 3); one z
// face of 119 (WENO5-Z 129; a chunk's first plane one more); the three
// divergences 6, their sum and negation 3, the Laplacian 30 and the
// combine 5 (stage 1: 3). At 512^3, WENO5-JS, viscous, stages 2-3: 394
// a cell against the face-once count's 353 (the z face alone recomputes
// what neighbouring z faces share); ops_issued() in
// ops/kernels/fused_burgers.py counts a launch. The IEEE reciprocals
// (two a face) take a few instructions each beyond the one operation
// counted.
//
// Order 7 (WENO7-JS, reach R = 4): the same body with R a template
// parameter, unsharded and on every shard (pads of 4). The tile plane
// is (TY + 8) x (TX + 8), the halo 4 cells, the z window planes k-4 ..
// k+4, and each face is the e-form of
// weno7e.cuh (face7e_run in runs of three, which share only the first
// differences: the betas of neighbouring faces use other rows of _B7).
// Static shared memory 24,944 bytes. Counted as above, a WENO7 side is
// 104 operations (betas 60, +eps 4, products 6, alphas 8, candidates 20,
// numerator 7, denominator 3), a face 227 alone and 661 in a run of
// three, an axis 219 a cell with each face once: 701 a cell in stages 2-3
// (stage 1: 699; inviscid 30 fewer).

#include <cuda_runtime.h>

#include "weno5.cuh"
#include "weno7e.cuh"

namespace {

constexpr int TX = 32;                  // tile columns: a warp a row
constexpr int TY = 14;                  // tile rows
constexpr int MIN_BLOCKS = 2;           // resident blocks an SM
constexpr int THREADS = TX * TY;
constexpr int NWARPS = THREADS / 32;
constexpr int RUN = 3;                  // faces a work item computes
static_assert((TX + 1) % RUN == 0 && (TY + 1) % RUN == 0,
              "face lines split in runs");
constexpr int NXI = TY * ((TX + 1) / RUN);  // x face runs a plane
constexpr int NYI = TX * ((TY + 1) / RUN);  // y face runs a plane
constexpr int NXI_PAD = (NXI + 31) / 32 * 32;  // y runs start a warp
static_assert(NXI_PAD + NYI <= THREADS, "one face run a thread at most");

// The tile geometry of reach R (3: WENO5, 4: WENO7).
template <int R>
struct Geo {
  static constexpr int WT = TX + 2 * R;         // a tile row with its halo
  static constexpr int PLANE = (TY + 2 * R) * WT;
  static constexpr int HALO = PLANE - THREADS;  // halo cells of a plane
  static constexpr int HROUNDS = (HALO + THREADS - 1) / THREADS;
  static constexpr int NV = RUN + 2 * R - 2;    // split values a run reads
  static constexpr int NZ = 2 * R + 1;          // planes of the z window
};

template <int R>
struct Smem {
  float v[2][Geo<R>::PLANE];   // v on the tile plane, double-buffered
  float fp[2][Geo<R>::PLANE];  // its f+
  float fm[2][Geo<R>::PLANE];  // its f-
  float fx[TY * (TX + 1)];  // x faces: row r, face i below cell i
  float fy[(TY + 1) * TX];  // y faces: row i below cell row i
  unsigned int warp_max[NWARPS];
};
static_assert(sizeof(Smem<4>) <= 48 * 1024, "static shared memory");

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

// A shard of a mesh that cuts y and/or x as well (the YX instance): the
// z fields as above (zpad 0 when z is whole), and for y and x the same
// three numbers: the block's core of ny x nx cells sits ypad rows and
// xpad columns into planes of (ny + 2 ypad) x (nx + 2 xpad) floats, and
// its row j is global row j + oy of gny (x likewise). A pad of 0 means
// the axis is whole (oy 0, gny ny).
struct ZYXGeometry {
  int zpad, gnz, oz, k_begin, k_end;
  int ypad, gny, oy, xpad, gnx, ox;
};

template <bool YX>
using GeometryOf = std::conditional_t<YX, ZYXGeometry, ZGeometry>;

// Stored index of local index l on an axis of n core cells, a pad of
// `pad` cells a side, global offset o of gn: clamped at the global edges
// (the edge boundary's replicas), then into the stored range [-pad, n +
// pad) (only a tile cell outside the core reads past it, and it writes
// nothing), then shifted by the pad.
__device__ __forceinline__ int stored(int l, int n, int pad, int o, int gn) {
  return clampi(clampi(l + o, 0, gn - 1) - o, -pad, n - 1 + pad) + pad;
}

// Offset in a plane of the cell at local (y, x), clamped as the
// instance's layout says: into the grid (no stored y/x ghosts), or at
// the global edges only (the YX instance's stored ghosts).
template <bool YX, class G>
__device__ __forceinline__ int plane_offset(const G& g, int y, int x, int ny,
                                            int nx) {
  if constexpr (YX)
    return stored(y, ny, g.ypad, g.oy, g.gny) * (nx + 2 * g.xpad) +
           stored(x, nx, g.xpad, g.ox, g.gnx);
  else
    return clampi(y, 0, ny - 1) * nx + clampi(x, 0, nx - 1);
}

// Buffer plane of the z neighbour of block plane k at global offset d,
// clamped at the global z edges; rows in the ghost region come from
// lo/hi where one is given. Unsharded, the plane clamped into [0, nz).
template <bool SHARDED, bool OPERANDS, class G>
__device__ __forceinline__ const float* zplane(const float* v,
                                               const float* lo,
                                               const float* hi, int k, int d,
                                               int nz, long long P,
                                               const G& g) {
  if (!SHARDED) return v + clampi(k + d, 0, nz - 1) * P;
  const int row = clampi(k + d + g.oz, 0, g.gnz - 1) - g.oz + g.zpad;
  if (OPERANDS && lo != nullptr && row < g.zpad) return lo + row * P;
  if (OPERANDS && hi != nullptr && row >= nz + g.zpad)
    return hi + (row - nz - g.zpad) * P;
  return v + row * P;
}

// (B) for the thread's run of faces, if it has one: x faces (tid <
// NXI: row r, faces i .. i+2) or y faces (NXI_PAD <= tid < NXI_PAD +
// NYI: column col, face rows i .. i+2) of the tile plane in buffer b.
template <int R, bool WZ>
__device__ __forceinline__ void face_item(Smem<R>& sm, int b, int tid) {
  constexpr int WT = Geo<R>::WT, NV = Geo<R>::NV;
  const float* sp = sm.fp[b];
  const float* sn = sm.fm[b];
  float P[NV], M[NV], h[RUN];
  if (tid < NXI) {
    constexpr int K = (TX + 1) / RUN;
    const int r = tid / K, i = (tid - r * K) * RUN;
    const int c = (r + R) * WT + i;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      P[q] = sp[c + q];
      M[q] = sn[c + 1 + q];
    }
    face_run_of<R, WZ, RUN>(P, M, h);
#pragma unroll
    for (int j = 0; j < RUN; ++j) sm.fx[r * (TX + 1) + i + j] = h[j];
  } else if (tid >= NXI_PAD && tid < NXI_PAD + NYI) {
    const int e = tid - NXI_PAD;
    const int i = e / TX * RUN, col = e % TX;
    const int c = i * WT + col + R;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      P[q] = sp[c + q * WT];
      M[q] = sn[c + (q + 1) * WT];
    }
    face_run_of<R, WZ, RUN>(P, M, h);
#pragma unroll
    for (int j = 0; j < RUN; ++j) sm.fy[(i + j) * TX + col] = h[j];
  }
}

// SHARDED, OPERANDS and YX are compile-time so that the unsharded launch
// (SHARDED false: no ghost planes, every plane, no operands) carries none
// of the sharded geometry's arithmetic or tests, and the z-slab launches
// (YX false) none of the y/x geometry's. The YX instance (a mesh that
// cuts y and/or x) is SHARDED and OPERANDS as well, its zpad 0 when z is
// whole. R is the WENO reach: 3 (WENO5-JS/Z) or 4 (WENO7-JS).
template <int R, int FLUX, bool WZ, bool SHARDED, bool OPERANDS, bool YX>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stage_kernel(const float* __restrict__ v, const float* u, float* out,
             const float* __restrict__ lo, const float* __restrict__ hi,
             int nz, int ny, int nx, int zchunk, GeometryOf<YX> g, Params p,
             const float* __restrict__ dt_ptr, unsigned int* mx) {
  constexpr int WT = Geo<R>::WT, HALO = Geo<R>::HALO;
  constexpr int HROUNDS = Geo<R>::HROUNDS, NZ = Geo<R>::NZ;
  __shared__ Smem<R> sm;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int i = x0 + tx, j = y0 + ty;  // the thread's column
  const bool valid = i < nx && j < ny;
  const int k0 = (SHARDED ? g.k_begin : 0) + blockIdx.z * zchunk;
  const int k1 = min(k0 + zchunk, SHARDED ? g.k_end : nz);
  // plane stride, and the thread's column: an outside thread marches
  // the column its tile cell holds, the edge replica (clamped into the
  // grid) or, on the YX instance, the stored ghost where the domain goes
  // on (the faces of the last core row or column read those cells)
  long long P;
  int col;
  if constexpr (YX) {
    const int pitch = nx + 2 * g.xpad;
    P = (long long)(ny + 2 * g.ypad) * pitch;
    col = stored(j, ny, g.ypad, g.oy, g.gny) * pitch +
          stored(i, nx, g.xpad, g.ox, g.gnx);
  } else {
    P = (long long)ny * nx;
    col = min(j, ny - 1) * nx + min(i, nx - 1);
  }
  const int own = (ty + R) * WT + tx + R;  // its cell in the tile
  const float dt = *dt_ptr;
  const float c = p.c;
  unsigned int mbits = 0u;  // max |f'(rk)| of this thread, as bits

  // the halo cells this thread loads: tile index and clamped offset in
  // a plane (-1: none)
  int hidx[HROUNDS], hoff[HROUNDS];
#pragma unroll
  for (int h = 0; h < HROUNDS; ++h) {
    const int e = tid + h * THREADS;
    int r = -1, q = 0;
    if (e < 2 * R * WT) {  // the R rows above the tile, then below it
      const int top = e < R * WT;
      const int f = top ? e : e - R * WT;
      r = f / WT + (top ? 0 : TY + R);
      q = f % WT;
    } else if (e < HALO) {  // the R columns left and right of each row
      const int f = e - 2 * R * WT;
      r = f / (2 * R) + R;
      q = f % (2 * R);
      if (q >= R) q += TX;
    }
    hidx[h] = r < 0 ? -1 : r * WT + q;
    hoff[h] = r < 0 ? 0 : plane_offset<YX>(g, y0 - R + r, x0 - R + q, ny, nx);
  }
  // plane k of the block in the buffer (the tile's plane; never a ghost)
  auto row_of = [&](int k) {
    return v + (long long)(SHARDED ? k + g.zpad : k) * P;
  };
  float hv[HROUNDS];
#pragma unroll
  for (int h = 0; h < HROUNDS; ++h)
    if (hidx[h] >= 0) hv[h] = row_of(k0)[hoff[h]];
  // u at the thread's cell, loaded one plane ahead like the halo (u is
  // written only at the cell, after it is read)
  auto cell_of = [&](int k) {
    return (long long)(SHARDED ? k + g.zpad : k) * P + col;
  };
  float u_c = u != nullptr && valid ? u[cell_of(k0)] : 0.0f;

  // z window: planes k-R..k+R of v and its split
  float W[NZ], Zp[NZ], Zm[NZ];
#pragma unroll
  for (int q = 0; q < NZ; ++q) {
    W[q] = zplane<SHARDED, OPERANDS>(v, lo, hi, k0, q - R, nz, P, g)[col];
    split<FLUX>(W[q], c, Zp[q], Zm[q]);
  }
  float hz_lo = face_of<R, WZ>(&Zp[0], &Zm[1]);  // face k0-1/2

  for (int k = k0; k < k1; ++k) {
    const int b = (k - k0) & 1;
    // (A) the tile plane k: the own cell from the window, the halo split
    sm.v[b][own] = W[R];
    sm.fp[b][own] = Zp[R];
    sm.fm[b][own] = Zm[R];
#pragma unroll
    for (int h = 0; h < HROUNDS; ++h)
      if (hidx[h] >= 0) {
        sm.v[b][hidx[h]] = hv[h];
        split<FLUX>(hv[h], c, sm.fp[b][hidx[h]], sm.fm[b][hidx[h]]);
      }
    // loads for plane k+1: its halo and the window's new plane k+R+1 (a
    // shard's plane k+R+1 lies in its buffer only if it is needed)
    const bool more = k + 1 < k1;
    float u_next = 0.0f;
    if (more) {
#pragma unroll
      for (int h = 0; h < HROUNDS; ++h)
        if (hidx[h] >= 0) hv[h] = row_of(k + 1)[hoff[h]];
      if (u != nullptr && valid) u_next = u[cell_of(k + 1)];
    }
    float w_in = 0.0f;
    if (!SHARDED || more)
      w_in = zplane<SHARDED, OPERANDS>(v, lo, hi, k, R + 1, nz, P, g)[col];
    __syncthreads();

    // (B) the x and y faces of the plane, and the z face above the cell
    face_item<R, WZ>(sm, b, tid);
    const float hz_hi = face_of<R, WZ>(&Zp[1], &Zm[2]);  // face k+1/2
    __syncthreads();

    // (C) the cell
    const float dz = (hz_hi - hz_lo) * p.inv_dx[0];
    const float dy =
        (sm.fy[(ty + 1) * TX + tx] - sm.fy[ty * TX + tx]) * p.inv_dx[1];
    const float dx = (sm.fx[ty * (TX + 1) + tx + 1] -
                      sm.fx[ty * (TX + 1) + tx]) * p.inv_dx[2];
    float rhs = -(dz + dy + dx);
    if (p.viscous) {
      const float* t = sm.v[b] + own;
      float acc = W[R - 2] * p.lap[0];
#pragma unroll
      for (int q = 1; q < 5; ++q) acc = acc + W[R - 2 + q] * p.lap[q];
#pragma unroll
      for (int q = 0; q < 5; ++q) acc = acc + t[(q - 2) * WT] * p.lap[5 + q];
#pragma unroll
      for (int q = 0; q < 5; ++q) acc = acc + t[q - 2] * p.lap[10 + q];
      rhs = rhs + acc;
    }
    if (valid) {
      float rk = p.b * (W[R] + dt * rhs);
      if (u != nullptr) rk = p.a * u_c + rk;
      out[cell_of(k)] = rk;
      if (mx != nullptr) {
        const unsigned int bits =
            __float_as_uint(fabsf(flux_df<FLUX>(rk, c)));
        mbits = bits > mbits ? bits : mbits;
      }
    }

    // slide the z window one plane up
    u_c = u_next;
    hz_lo = hz_hi;
#pragma unroll
    for (int q = 0; q < NZ - 1; ++q) {
      W[q] = W[q + 1];
      Zp[q] = Zp[q + 1];
      Zm[q] = Zm[q + 1];
    }
    if (!SHARDED || more) {
      W[NZ - 1] = w_in;
      split<FLUX>(W[NZ - 1], c, Zp[NZ - 1], Zm[NZ - 1]);
    }
  }

  if (mx != nullptr) {  // uniform across the launch
    const unsigned int w = __reduce_max_sync(0xffffffffu, mbits);
    if ((tid & 31) == 0) sm.warp_max[tid >> 5] = w;
    __syncthreads();
    if (tid == 0) {
      unsigned int m = sm.warp_max[0];
#pragma unroll
      for (int q = 1; q < NWARPS; ++q)
        m = sm.warp_max[q] > m ? sm.warp_max[q] : m;
      atomicMax(mx, m);
    }
  }
}

template <int R, int FLUX, bool WZ, bool SHARDED, bool OPERANDS, bool YX>
void launch_as(const float* v, const float* u, float* out, const float* lo,
               const float* hi, int nz, int ny, int nx, int zchunk,
               const GeometryOf<YX>& g, const Params& p, const float* dt,
               unsigned int* mx, cudaStream_t s) {
  const dim3 block(TX, TY, 1);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY,
                  (g.k_end - g.k_begin + zchunk - 1) / zchunk);
  stage_kernel<R, FLUX, WZ, SHARDED, OPERANDS, YX><<<grid, block, 0, s>>>(
      v, u, out, lo, hi, nz, ny, nx, zchunk, g, p, dt, mx);
}

// The instances of reach R: on a y- and/or x-cut shard (yx not null),
// with operands, sharded, or unsharded (every plane, no ghost planes).
template <int R, int FLUX, bool WZ>
void launch(const float* v, const float* u, float* out, const float* lo,
            const float* hi, int nz, int ny, int nx, int zchunk,
            const ZGeometry& g, const ZYXGeometry* yx, const Params& p,
            const float* dt, unsigned int* mx, cudaStream_t s) {
  if (yx != nullptr)
    launch_as<R, FLUX, WZ, true, true, true>(v, u, out, lo, hi, nz, ny, nx,
                                             zchunk, *yx, p, dt, mx, s);
  else if (lo != nullptr || hi != nullptr)
    launch_as<R, FLUX, WZ, true, true, false>(v, u, out, lo, hi, nz, ny, nx,
                                              zchunk, g, p, dt, mx, s);
  else if (g.zpad != 0 || g.k_begin != 0 || g.k_end != nz)
    launch_as<R, FLUX, WZ, true, false, false>(v, u, out, lo, hi, nz, ny, nx,
                                               zchunk, g, p, dt, mx, s);
  else
    launch_as<R, FLUX, WZ, false, false, false>(v, u, out, lo, hi, nz, ny,
                                                nx, zchunk, g, p, dt, mx, s);
}

// The y or x numbers of a YX launch are sound: a pad of 0 (the axis
// whole) or at least the reach, and the core inside the global extent.
bool axis_ok(int n, int pad, int o, int gn, int reach) {
  if (pad == 0) return gn == n && o == 0;
  return pad >= reach && o >= 0 && o + n <= gn;
}

}  // namespace

// Launch one stage on `stream`. `nz` is the block's plane count (the
// buffer holds nz + 2*zpad planes, zpad 0 or at least the reach: 3 at
// order 5, 4 at order 7); `zgeo` points to 4 host
// ints: zpad, the global plane count, the block's global z offset and
// mx_init. `u` is null for stage 1 and may equal `out` (in-place stage
// 3). `dt` points to one float on the device. `flux` is 0 (Burgers), 1
// (linear, speed `c`) or 2 (Buckley-Leverett); `order` is 5 (WENO5, and
// `weno_z` selects the WENO5-Z weights) or 7 (WENO7-JS: weno_z 0).
// `inv_dx` points to 3 host
// floats (z, y, x) and `lap` to 15 host floats, or is null for an inviscid
// run. Only the block's
// planes [k_begin, k_end) are written; `lo`/`hi`, when not null, hold the
// zpad ghost planes below/above (the split schedule's operands). `mx`,
// when not null, points to one float on the device that receives
// max|f'(out)| over the planes written (zeroed here first, on the
// stream, when mx_init is not 0; else folded into its value). `yxgeo`,
// when not null, points to 6 host ints of a shard that stores y and/or x
// ghosts (the YX instance): ypad, the global row count, the block's
// global y offset, then xpad, gnx and ox; `ny`/`nx` are then its core
// extents, and its planes (ny + 2 ypad) x (nx + 2 xpad). Returns the
// first CUDA error (0 on success); does not synchronise.
extern "C" int fused_burgers_stage(const float* v, const float* u,
                                   float* out, int nz, int ny, int nx,
                                   const float* dt, int flux, float c,
                                   int weno_z, int order, const float* inv_dx,
                                   const float* lap, float a, float b,
                                   float* mx, int zchunk, const int* zgeo,
                                   int k_begin, int k_end, const float* lo,
                                   const float* hi, const int* yxgeo,
                                   void* stream) {
  const ZGeometry g{zgeo[0], zgeo[1], zgeo[2], k_begin, k_end};
  const int reach = order == 7 ? 4 : 3;
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 || flux < 0 || flux > 2 ||
      k_begin < 0 || k_end > nz || k_begin >= k_end || g.zpad < 0 ||
      (g.zpad == 0 && (g.gnz != nz || g.oz != 0)) ||
      (g.zpad > 0 && g.zpad < reach) || g.oz < 0 || g.oz + nz > g.gnz ||
      (long long)ny * nx > 2147483647LL ||  // a plane's offsets are int
      (order != 5 && order != 7) || (order == 7 && weno_z))
    return (int)cudaErrorInvalidValue;
  ZYXGeometry yx{};
  if (yxgeo != nullptr) {
    yx = ZYXGeometry{g.zpad,   g.gnz,    g.oz,     k_begin,  k_end,   yxgeo[0],
                     yxgeo[1], yxgeo[2], yxgeo[3], yxgeo[4], yxgeo[5]};
    if ((yx.ypad == 0 && yx.xpad == 0) ||
        !axis_ok(ny, yx.ypad, yx.oy, yx.gny, reach) ||
        !axis_ok(nx, yx.xpad, yx.ox, yx.gnx, reach) ||
        (long long)(ny + 2 * yx.ypad) * (nx + 2 * yx.xpad) > 2147483647LL)
      return (int)cudaErrorInvalidValue;
  }
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
  return (int)dispatch(flux, order, weno_z, [&](auto r, auto fl, auto wz) {
    launch<decltype(r)::value, decltype(fl)::value, decltype(wz)::value>(
        v, u, out, lo, hi, nz, ny, nx, zchunk, g,
        yxgeo != nullptr ? &yx : nullptr, p, dt, m, s);
    return cudaGetLastError();
  });
}

// The tiling of the WENO`order`-JS Burgers instance (order 5 or 7), the
// unsharded one (yx 0) or the YX one (yx 1), into 7 ints: tile rows, tile
// columns, threads a block, static shared memory bytes, blocks an SM can
// hold, registers a thread and local (spilled) bytes a thread. Returns
// the first CUDA error (0 on success).
extern "C" int fused_burgers_stage_geometry(int order, int yx, int* out) {
  if (order != 5 && order != 7) return (int)cudaErrorInvalidValue;
  const void* kernel =
      yx ? (order == 5
                ? (const void*)stage_kernel<3, BURGERS, false, true, true, true>
                : (const void*)stage_kernel<4, BURGERS, false, true, true, true>)
         : (order == 5 ? (const void*)
                             stage_kernel<3, BURGERS, false, false, false, false>
                       : (const void*)
                             stage_kernel<4, BURGERS, false, false, false, false>);
  out[0] = TY;
  out[1] = TX;
  out[2] = THREADS;
  out[3] = (int)(order == 5 ? sizeof(Smem<3>) : sizeof(Smem<4>));
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel,
                                                            THREADS, 0);
}
