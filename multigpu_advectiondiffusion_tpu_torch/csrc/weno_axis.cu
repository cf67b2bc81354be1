// The WENO flux divergence along one axis of a contiguous float32 array
// viewed as (outer, n, inner): K12 (3-D, any sweep axis) and K12b (2-D)
// are this one source. The array comes unpadded: the r ghost cells a side
// of the sweep axis (r = 3 WENO5, 4 WENO7) are formed in the kernel, and
// the store carries the sum over the axes and its sign.
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// weno.py::flux_divergence_pallas (:184, pallas_call :248) and
// _flux_divergence_2d (:267, pallas_call :284). It computes the same
// function, not the same blocks:
//
//   div[k] = (h[k+1/2] - h[k-1/2]) * (1/dx)
//   WENO5 (r = 3): h = (f+[i] + f-[i+1]) + (nm * rcp(dm) + np * rcp(dp))
//     in the e-form of weno5.cuh (weno5_side_parts), JS or Z weights;
//   WENO7 (r = 4): h = weno7_minus(f+ window) + weno7_plus(f- window)
//     in the q-form of weno7.cuh::face7, JS weights;
//   out[k] = div[k], acc[k] + div[k] or -(acc[k] + div[k])
//
// with the local Lax-Friedrichs split f+- of u (weno5.cuh::split; fluxes
// Burgers, linear with speed c, Buckley-Leverett). Padded position p (0 ..
// n+2r-1) is cell p - r; face f (0..n) has its minus window at positions
// f .. f+2r-2 and its plus window at f+1 .. f+2r-1. A ghost (cell k < 0 or
// k >= n) comes from one of (Ghosts::kind):
//   edge       the face cell, u[0] or u[n-1];
//   periodic   u[k + n] or u[k - n] (n >= r);
//   dirichlet  the value, float32 of the boundary's;
//   slabs      lo[o, k + r, i] or hi[o, k - n, i]: the (outer, r, inner)
//              ghost slabs of a halo exchange (a sharded axis);
// the values core/bc.py::pad_axis and parallel/halo.py::exchange_axis
// concatenate, so a padded copy is never made. `acc` may be `out`: each
// thread reads acc only at the cells it writes, before it writes them.
//
// Rounding: built with -fmad=false (ops/kernels/weno.py), every division
// and reciprocal IEEE-rounded; every operation in the order of the plain
// PyTorch twin (ops/kernels/weno.py::flux_divergence_reference, then
// `acc + div` and the negation), so the two agree to the bit on the card.
// div is rounded before the sum is added. Each face is computed the same
// way wherever it is computed, so the tiling below changes no bit.
//
// Bound on an H100, per launch at 512^3: bytes move u in once and the
// output out once, 8 B a cell, 1,074 MB, 0.322 ms at 3.35 TB/s; with the
// running sum acc is read too, 12 B a cell, 0.483 ms (the ghosts are a
// few planes of u or of the slabs). Operations, each split and face once
// (an abs, a reciprocal and a division count one each), per output cell:
//   split: Burgers 6, linear 7, Buckley-Leverett 22
//   WENO5-JS: first differences 2, curvatures 6, two reconstructions of
//     43, h 7, divergence 2: 103 (WENO5-Z: 113)
//   WENO7: two sides of 145 (betas 92, weights 20, candidates 25, their
//     weighted sum 7, /12 1), h 1, divergence 2: 293
//   the sum 1, its sign 1
// WENO5-JS with the Burgers flux: 109 a cell, 0.218 ms at 67 TFLOP/s, so
// WENO5 is bound by bytes; WENO7, 299 a cell, 0.60 ms, by operations.
// Unfused (no FMA), one product or sum issues a lane a cycle: 33.5 T/s.
//
// Design (one march for both sweeps): a thread marches a piece of one
// line, G cells a step (4 WENO5, 2 WENO7): the step's G loads issue
// together, their splits join a window of G + 2r - 1 split positions in
// registers, the step's G faces come from one face_run (WENO5: the
// differences and curvatures of neighbouring faces shared), and the
// window moves on by G.
// - The sweep along a column axis (inner > 1: z and y in 3-D, y in 2-D):
//   consecutive threads take consecutive columns, so every load and
//   store of a warp is 128 contiguous bytes. A thread marches a chunk of
//   its column, planned from the SM count and the kernel's occupancy so
//   the grid fills the card COL_WAVES times, and stores each cell as it
//   goes; the store's kind (div, sum, negated sum) is a template
//   parameter. A chunk whose every read is a cell of u takes a path with
//   no ghost test. Registers are capped for 6 blocks an SM (80 used; a
//   load's latency hides behind other warps): at 512^3 the sum sweep
//   took 0.74 ms against 0.86 uncapped (127 registers). Four columns a
//   thread with 16-byte loads (255 registers, spills) and a ring of 12
//   positions unrolled so no value moves (a 3,000-instruction loop) were
//   measured slower (PERF.md).
// - The sweep along the last axis (inner == 1): a block takes 128 rows,
//   a thread a row, of a segment of T = 32 cells. It stages the rows'
//   T + 2r positions, ghosts by the rule above, in shared memory by
//   cp.async (a warp on 32 consecutive values of a row: coalesced), then
//   each thread marches its row as a column thread marches its column,
//   reading shared memory, and the divergences go back over their own
//   positions; a last pass adds the sum, read from device memory 8 rows
//   of loads at a time, and stores, a warp on 32 consecutive cells. The
//   positions are stored transposed (a pitch of 129 values a position),
//   so both the march (a warp on 32 rows) and the passes (a warp along
//   one row) are free of bank conflicts; that layout takes 4-byte copies,
//   not 16-byte ones. The sweep is bound by the warps an SM holds, so a
//   block keeps nothing else in shared memory: staging the sum there too,
//   or double-buffering the segments, measured slower. Each split and
//   face once a segment (face s0 and the first 2r splits once more): 1/32
//   of the faces and 6/32 of the splits twice.

#include <cuda_runtime.h>

#include <atomic>

#include "weno5.cuh"
#include "weno7.cuh"

namespace {

enum { GHOST_EDGE = 0, GHOST_PERIODIC = 1, GHOST_DIRICHLET = 2,
       GHOST_SLABS = 3 };

struct Ghosts {
  int kind;
  float value;      // GHOST_DIRICHLET
  const float* lo;  // GHOST_SLABS: (outer, R, inner), cells -R .. -1
  const float* hi;  // (outer, R, inner), cells n .. n+R-1
};

constexpr int COL_THREADS = 128;
constexpr int COL_MIN_BLOCKS = 6;  // resident blocks an SM: 85 registers
constexpr int COL_WAVES = 16;  // resident grids a column sweep plans for
constexpr int MIN_CHUNK = 8;   // cells a thread marches at least
constexpr int ROW_THREADS = 128;  // rows a block of the last-axis sweep
constexpr int ROW_SEGMENT = 32;   // cells a row segment (planned)
constexpr int ROW_BATCH = 8;      // rows a warp's store pass loads at once
// cells a step of the march (its loads and faces together)
template <int ORDER>
constexpr int MARCH_STEP = ORDER == 7 ? 2 : 4;

// the value of u's column (o, i) at cell k, k a ghost
template <int R>
__device__ __forceinline__ float ghost(const float* __restrict__ u,
                                       long long o, long long i, int k,
                                       int n, long long inner,
                                       const Ghosts& g) {
  if (g.kind == GHOST_DIRICHLET) return g.value;
  if (g.kind == GHOST_SLABS)
    return k < 0 ? g.lo[(o * R + (k + R)) * inner + i]
                 : g.hi[(o * R + (k - n)) * inner + i];
  const int kk = g.kind == GHOST_PERIODIC ? (k < 0 ? k + n : k - n)
                                          : (k < 0 ? 0 : n - 1);
  return u[(o * n + kk) * inner + i];
}

// ------------------------------------------------------------------ //
// The march: one thread, cells k0 .. k1-1 of one line
// ------------------------------------------------------------------ //

// The faces f0 .. f0+G-1 from the split values fp/fm of their positions:
// WENO5 fp = f+ at f0 .. f0+G+3, fm = f- at f0+1 .. f0+G+4
// (weno5.cuh::face_run shares the differences, curvatures and their
// halves between neighbouring faces); WENO7 fp = f+ at f0 .. f0+G+5, fm =
// f- at f0+1 .. f0+G+6, face7 a face.
template <int ORDER, bool WZ, int G>
__device__ __forceinline__ void faces(const float* fp, const float* fm,
                                      float* h) {
  if constexpr (ORDER == 7) {
#pragma unroll
    for (int j = 0; j < G; ++j) h[j] = face7(fp + j, fm + j);
  } else {
    face_run<WZ, G>(fp, fm, h);
  }
}

// What the store writes (a template parameter of the column sweep, the
// last-axis sweep's store pass takes it at run time)
enum { STORE_DIV = 0, STORE_SUM = 1, STORE_NEG_SUM = 2 };

template <int MODE>
__device__ __forceinline__ float stored(float a, float d) {
  if constexpr (MODE == STORE_DIV) return d;
  if constexpr (MODE == STORE_SUM) return a + d;
  return -(a + d);
}

// March cells k0 .. k1-1 of a line: `line.at(p)` is u at padded position
// p (cell p - R), `line.sum(k)` the running sum at cell k (MODE != DIV),
// `line.put(k, v)` stores cell k. A step of G cells splits positions k+W
// .. k+W+G-1 into the window (index q: position k+1+q), computes faces
// k+1 .. k+G in one run and stores its G cells; the window then moves on
// by G (W-1 values a side). The next step's loads (u and the sum) issue
// before this step's arithmetic, so a load has a step to arrive. Each
// split and face once (face k0 and the first W splits once more a line
// piece). `line` reads nothing past the positions and cells it is asked
// for below: a piece's last step reads up to G-1 positions and cells past
// k1 + W - 1 and k1 - 1 (at() and sum() see them; they feed no store).
template <int FLUX, int ORDER, bool WZ, int MODE, typename Line>
__device__ __forceinline__ void march(const Line& line, int k0, int k1,
                                      float c, float inv_dx) {
  constexpr int R = ORDER == 7 ? 4 : 3;
  constexpr int W = 2 * R;                      // positions a face reads
  constexpr int G = MARCH_STEP<ORDER>;          // cells a step
  constexpr int NW = G + W - 1;                 // the window
  float P[NW], M[NW];
  float h_lo;
  {
    float p0[W], m0[W];
#pragma unroll
    for (int q = 0; q < W; ++q)
      split<FLUX>(line.at(k0 + q), c, p0[q], m0[q]);
    if constexpr (ORDER == 7)
      h_lo = face7(&p0[0], &m0[1]);
    else
      h_lo = face<WZ>(&p0[0], &m0[1]);
#pragma unroll
    for (int q = 0; q < W - 1; ++q) P[q] = p0[q + 1], M[q] = m0[q + 1];
  }
  float wn[G], an[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    wn[j] = line.at(k0 + W + j);
    an[j] = MODE == STORE_DIV ? 0.0f : line.sum(k0 + j);
  }
#pragma unroll 1
  for (int k = k0; k < k1; k += G) {
    float a[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      split<FLUX>(wn[j], c, P[W - 1 + j], M[W - 1 + j]);
      a[j] = an[j];
    }
    if (k + G < k1) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        wn[j] = line.at(k + G + W + j);
        if constexpr (MODE != STORE_DIV) an[j] = line.sum(k + G + j);
      }
    }
    float h[G];
    faces<ORDER, WZ, G>(&P[0], &M[1], h);
    if (k + G <= k1) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        line.put(k + j, stored<MODE>(a[j], (h[j] - h_lo) * inv_dx));
        h_lo = h[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (k + j < k1)
          line.put(k + j, stored<MODE>(a[j], (h[j] - h_lo) * inv_dx));
        h_lo = h[j];
      }
    }
#pragma unroll
    for (int q = 0; q < W - 1; ++q) P[q] = P[q + G], M[q] = M[q + G];
  }
}

// ------------------------------------------------------------------ //
// The column sweep (inner > 1)
// ------------------------------------------------------------------ //

// A column of u (cell 0 at `col[R * inner]`), the sum and the output;
// INSIDE: every position read is a cell of u, else the ghost rule and
// nothing past `last` (the last position face k1 reads).
template <int R, bool INSIDE>
struct ColLine {
  const float* __restrict__ u;
  const float* col;  // padded position 0 of the column
  const float* acc;  // cell 0
  float* out;        // cell 0
  long long inner, o, i;
  int n, last, k1;
  Ghosts g;

  __device__ __forceinline__ float at(int p) const {
    if constexpr (INSIDE) {
      return col[p * inner];
    } else {
      const int k = p - R;
      if (k >= 0 && k < n) return col[p * inner];
      return p <= last ? ghost<R>(u, o, i, k, n, inner, g) : 0.0f;
    }
  }
  __device__ __forceinline__ float sum(int k) const {
    if constexpr (INSIDE) return acc[k * inner];
    return k < k1 ? acc[k * inner] : 0.0f;
  }
  __device__ __forceinline__ void put(int k, float v) const {
    out[k * inner] = v;
  }
};

template <int FLUX, int ORDER, bool WZ, int MODE>
__global__ void __launch_bounds__(COL_THREADS, COL_MIN_BLOCKS)
weno_axis_kernel_col(const float* __restrict__ u, const float* acc,
                     float* out, long long outer, int n, long long inner,
                     int chunk, int nchunks, float c, float inv_dx,
                     Ghosts g) {
  constexpr int R = ORDER == 7 ? 4 : 3;
  constexpr int W = 2 * R;
  const long long t = (long long)blockIdx.x * COL_THREADS + threadIdx.x;
  if (t >= outer * nchunks * inner) return;
  const long long i = t % inner;
  const long long rest = t / inner;
  const int ch = (int)(rest % nchunks);
  const long long o = rest / nchunks;
  const int k0 = ch * chunk;
  const int k1 = min(k0 + chunk, n);
  const long long base = o * n * inner + i;  // cell 0 of the column
  const float* col = u + base - R * inner;
  const float* a = acc == nullptr ? nullptr : acc + base;
  if (k0 >= R && k1 + R + MARCH_STEP<ORDER> - 1 <= n) {
    // every position the chunk reads (its last step's whole) is a cell
    const ColLine<R, true> line{u, col, a, out + base, inner, o, i,
                                n, k1 + W - 1, k1, g};
    march<FLUX, ORDER, WZ, MODE>(line, k0, k1, c, inv_dx);
  } else {
    const ColLine<R, false> line{u, col, a, out + base, inner, o, i,
                                 n, k1 + W - 1, k1, g};
    march<FLUX, ORDER, WZ, MODE>(line, k0, k1, c, inv_dx);
  }
}

// ------------------------------------------------------------------ //
// The last-axis sweep (inner == 1)
// ------------------------------------------------------------------ //

// one 4-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

// A row held in shared memory at pitch PITCH (position p at col[p *
// PITCH]); the march's divergences go back over their own positions.
template <int R, int PITCH>
struct SharedLine {
  float* col;
  __device__ __forceinline__ float at(int p) const { return col[p * PITCH]; }
  __device__ __forceinline__ float sum(int) const { return 0.0f; }
  __device__ __forceinline__ void put(int k, float v) const {
    col[(k + R) * PITCH] = v;
  }
};

// A block: ROW_THREADS rows (a thread a row) of a segment of T cells.
// The segment's T + 2R positions of each row are staged in shared
// memory transposed, position-major with a pitch of ROW_THREADS + 1, so
// the march's reads (a warp on 32 rows at one position) and the staging
// and store passes (a warp on 32 positions of one row) hit 32 banks;
// MARCH_STEP more positions a row are room for the last step's reads
// past the segment (never stored from). The kernel is bound by how many
// warps an SM holds, so the block keeps nothing else in shared memory:
// the store pass reads the sum from device memory, ROW_BATCH rows of
// loads in flight at once.
template <int FLUX, int ORDER, bool WZ>
__global__ void __launch_bounds__(ROW_THREADS)
weno_axis_kernel_row(const float* __restrict__ u, const float* acc,
                     float* out, long long outer, int n, int T, int nseg,
                     float c, float inv_dx, Ghosts g, int mode) {
  constexpr int R = ORDER == 7 ? 4 : 3;
  constexpr int PITCH = ROW_THREADS + 1;
  constexpr int WARPS = ROW_THREADS / 32;
  extern __shared__ float sh[];  // [T + 2R + MARCH_STEP][PITCH]
  const int seg = blockIdx.x % nseg;
  const long long o0 = (long long)(blockIdx.x / nseg) * ROW_THREADS;
  const int s0 = seg * T;  // the segment's first cell
  const int rows = (int)min((long long)ROW_THREADS, outer - o0);
  const int len = min(T, n - s0);  // cells of the segment
  const int np = len + 2 * R;      // its positions
  const float* ub = u + o0 * n;    // the block's first row
  const int tid = threadIdx.x, lane = tid & 31;

  // 1. stage: a warp on 32 positions of one row, a copy a value;
  // positions p_lo .. p_hi-1 hold cells of the row, the rest ghosts by
  // their rule
  const int p_lo = max(0, R - s0), p_hi = min(np, n - s0 + R);
  for (int r = tid >> 5; r < rows; r += WARPS) {
    const float* src = ub + (long long)r * n + (s0 - R) + p_lo + lane;
    float* dst = sh + (p_lo + lane) * PITCH + r;
    for (int p = p_lo + lane; p < p_hi; p += 32) {
      cp_async4(dst, src);
      src += 32;
      dst += 32 * PITCH;
    }
    if (p_lo > 0 || p_hi < np) {
      for (int p = lane; p < np; p += 32)
        if (p < p_lo || p >= p_hi)
          sh[p * PITCH + r] = ghost<R>(u, o0 + r, 0, s0 + p - R, n, 1, g);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // 2. the march of this thread's row
  if (tid < rows)
    march<FLUX, ORDER, WZ, STORE_DIV>(SharedLine<R, PITCH>{sh + tid}, 0, len,
                                      c, inv_dx);
  __syncthreads();

  // 3. the sum, the sign and the store: a warp on 32 cells of one row,
  // the sums of ROW_BATCH rows loaded before any is stored (out may be
  // acc: each cell is read before it is written)
  const long long first = o0 * n + s0;
  for (int r0 = tid >> 5; r0 < rows; r0 += WARPS * ROW_BATCH) {
    for (int k = lane; k < len; k += 32) {
      float a[ROW_BATCH];
      if (mode != STORE_DIV) {
#pragma unroll
        for (int j = 0; j < ROW_BATCH; ++j) {
          const int r = r0 + j * WARPS;
          a[j] = r < rows ? acc[first + (long long)r * n + k] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < ROW_BATCH; ++j) {
        const int r = r0 + j * WARPS;
        if (r >= rows) break;
        const float d = sh[(k + R) * PITCH + r];
        out[first + (long long)r * n + k] =
            mode == STORE_DIV ? d
            : mode == STORE_SUM ? stored<STORE_SUM>(a[j], d)
                                : stored<STORE_NEG_SUM>(a[j], d);
      }
    }
  }
}

// ------------------------------------------------------------------ //
// Plans and launches
// ------------------------------------------------------------------ //

int sm_count() {
  static std::atomic<int> sms{0};
  int v = sms.load();
  if (v == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    sms.store(v);
  }
  return v;
}

// resident blocks an SM of `kernel`, cached in `cached` (one a kernel)
template <typename K>
int per_sm(std::atomic<int>& cached, K kernel, int threads, int smem) {
  int v = cached.load();
  if (v == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, threads,
                                                      smem) != cudaSuccess)
      return 0;
    cached.store(v);
  }
  return v;
}

template <int FLUX, int ORDER, bool WZ, int MODE>
cudaError_t launch_col(const float* u, const float* acc, float* out,
                       long long outer, int n, long long inner, int chunk,
                       float c, float inv_dx, const Ghosts& g,
                       cudaStream_t s, int* plan) {
  auto* kernel = weno_axis_kernel_col<FLUX, ORDER, WZ, MODE>;
  static std::atomic<int> occupancy{0};
  const long long per_row = outer * inner;  // threads a chunk row
  if (chunk <= 0) {
    // chunks that fill the card COL_WAVES times, whole steps
    const long long resident = (long long)sm_count() *
                               per_sm(occupancy, kernel, COL_THREADS, 0) *
                               COL_THREADS;
    if (resident <= 0) return cudaErrorInvalidDevice;
    long long nch = (COL_WAVES * resident + per_row - 1) / per_row;
    const long long most = n / MIN_CHUNK > 1 ? n / MIN_CHUNK : 1;
    nch = nch < 1 ? 1 : (nch > most ? most : nch);
    constexpr int G = MARCH_STEP<ORDER>;
    chunk = (int)((n + nch - 1) / nch);
    chunk = (chunk + G - 1) / G * G;
  }
  const int nchunks = (n + chunk - 1) / chunk;
  const long long blocks =
      (per_row * nchunks + COL_THREADS - 1) / COL_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (plan != nullptr) plan[0] = chunk, plan[1] = nchunks;
  kernel<<<(unsigned int)blocks, COL_THREADS, 0, s>>>(
      u, acc, out, outer, n, inner, chunk, nchunks, c, inv_dx, g);
  return cudaGetLastError();
}

template <int FLUX, int ORDER, bool WZ>
cudaError_t launch_row(const float* u, const float* acc, float* out,
                       long long outer, int n, int T, float c,
                       float inv_dx, const Ghosts& g, int mode,
                       cudaStream_t s, int* plan) {
  constexpr int R = ORDER == 7 ? 4 : 3;
  auto* kernel = weno_axis_kernel_row<FLUX, ORDER, WZ>;
  static std::atomic<int> smem_set{48 * 1024};
  if (T <= 0) T = n < ROW_SEGMENT ? n : ROW_SEGMENT;
  const int smem = (T + 2 * R + MARCH_STEP<ORDER>) * (ROW_THREADS + 1) *
                   (int)sizeof(float);
  if (smem > smem_set.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set.store(smem);
  }
  const int nseg = (n + T - 1) / T;
  const long long blocks = (outer + ROW_THREADS - 1) / ROW_THREADS * nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (plan != nullptr) plan[0] = T, plan[1] = nseg;
  kernel<<<(unsigned int)blocks, ROW_THREADS, smem, s>>>(
      u, acc, out, outer, n, T, nseg, c, inv_dx, g, mode);
  return cudaGetLastError();
}

template <int FLUX, int ORDER, bool WZ>
cudaError_t dispatch_order(const float* u, const float* acc, float* out,
                           long long outer, int n, long long inner,
                           int chunk, float c, float inv_dx, const Ghosts& g,
                           int mode, cudaStream_t s, int* plan) {
  if (inner == 1)
    return launch_row<FLUX, ORDER, WZ>(u, acc, out, outer, n, chunk, c,
                                       inv_dx, g, mode, s, plan);
  if (mode == STORE_DIV)
    return launch_col<FLUX, ORDER, WZ, STORE_DIV>(
        u, acc, out, outer, n, inner, chunk, c, inv_dx, g, s, plan);
  if (mode == STORE_SUM)
    return launch_col<FLUX, ORDER, WZ, STORE_SUM>(
        u, acc, out, outer, n, inner, chunk, c, inv_dx, g, s, plan);
  return launch_col<FLUX, ORDER, WZ, STORE_NEG_SUM>(
      u, acc, out, outer, n, inner, chunk, c, inv_dx, g, s, plan);
}

template <int FLUX>
cudaError_t dispatch(const float* u, const float* acc, float* out,
                     long long outer, int n, long long inner, int chunk,
                     int order, int wz, float c, float inv_dx,
                     const Ghosts& g, int mode, cudaStream_t s, int* plan) {
  if (order == 7 && !wz)
    return dispatch_order<FLUX, 7, false>(u, acc, out, outer, n, inner,
                                          chunk, c, inv_dx, g, mode, s, plan);
  if (order == 5 && wz)
    return dispatch_order<FLUX, 5, true>(u, acc, out, outer, n, inner, chunk,
                                         c, inv_dx, g, mode, s, plan);
  if (order == 5)
    return dispatch_order<FLUX, 5, false>(u, acc, out, outer, n, inner,
                                          chunk, c, inv_dx, g, mode, s, plan);
  return cudaErrorInvalidValue;  // WENO7 is JS only
}

}  // namespace

// `u` is the contiguous float32 array viewed as (outer, n, inner), `out`
// (and `acc`, the running sum, or null) the same shape; `out` may be
// `acc`. Ghosts: `ghost_kind` 0 edge, 1 periodic (n >= r), 2 Dirichlet
// (`value`), 3 the slabs `lo`/`hi`, each (outer, r, inner), r = 3 for
// order 5 and 4 for order 7. `negate` (with `acc`) stores -(acc + div).
// `flux` is 0
// Burgers, 1 linear (speed `c`), 2 Buckley-Leverett; `wz` selects the
// WENO5-Z weights. `chunk`: cells a thread marches along a column axis,
// the segment along the last one (a multiple of 4); 0 plans it. `plan`,
// if not null, receives (chunk, chunks a column) of a column sweep or
// (segment, rows a block) of a last-axis one. Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
extern "C" int weno_axis(const float* u, const float* acc, float* out,
                         long long outer, int n, long long inner,
                         int ghost_kind, float value, const float* lo,
                         const float* hi, int negate, int chunk, int flux,
                         float c, int order, int wz, float inv_dx,
                         void* stream, int* plan) {
  const int r = order == 7 ? 4 : 3;
  if (outer < 1 || n < 1 || inner < 1 || chunk < 0 || ghost_kind < 0 ||
      ghost_kind > GHOST_SLABS)
    return (int)cudaErrorInvalidValue;
  if (ghost_kind == GHOST_PERIODIC && n < r) return (int)cudaErrorInvalidValue;
  if (ghost_kind == GHOST_SLABS && (lo == nullptr || hi == nullptr))
    return (int)cudaErrorInvalidValue;
  const Ghosts g{ghost_kind, value, lo, hi};
  const int mode = acc == nullptr ? STORE_DIV
                                  : (negate ? STORE_NEG_SUM : STORE_SUM);
  if (acc == nullptr && negate) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flux) {
    case BURGERS:
      return (int)dispatch<BURGERS>(u, acc, out, outer, n, inner, chunk,
                                    order, wz, c, inv_dx, g, mode, s, plan);
    case LINEAR:
      return (int)dispatch<LINEAR>(u, acc, out, outer, n, inner, chunk, order,
                                   wz, c, inv_dx, g, mode, s, plan);
    case BUCKLEY:
      return (int)dispatch<BUCKLEY>(u, acc, out, outer, n, inner, chunk,
                                    order, wz, c, inv_dx, g, mode, s, plan);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
