// N SSP-RK3 steps of the 2-D O4 heat equation in ONE cooperative kernel
// launch (K7, diffusion body).
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// whole_run.py::_kernel (:28, launched by whole_run :50) with the stage
// body fused_diffusion2d.py::_stage (:45). There the Pallas grid is the
// iteration counter: the state is copied into VMEM once, every stage of
// every step runs in-core on a sequential grid, and the result is copied
// out once. Here the counterpart is one persistent cooperative grid whose
// blocks own tiles of the grid and run every step of the run:
//
//   for each of n_iters steps k:
//     S_k -> window of S_k in shared memory (the tile and 6 cells a side)
//     t1 = s(S_k), t2 = s(t1, S_k), S_{k+1} = s(t2, S_k)   (shared memory)
//     S_{k+1} on the tile -> the other global buffer;  exchange
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
// ops/kernels/whole_run.py::plain_run). Stage 1 has b = 1: its b*x is x,
// so it is not issued.
//
// Layout: the padded state is (ny+4, nx+4) contiguous float32, the K1
// layout without the TPU's (8, 128) rounding, with at most 2^31 - 1 cells
// (32-bit indices). The 2-deep ghost ring of each buffer is never
// written; stage 1 reads S's, stage 2 T1's and stage 3 T2's, as the twin
// does.
//
// Design. What bounded the first port (one thread a cell, three grid-wide
// barriers a step, every stage streaming v, u and out through L2) was the
// barriers and the L2 latency of each stage, not the operations. Here:
//
// - Jobs. The interior is cut into my x mx tiles of near-equal sides
//   (ops/kernels/fused_diffusion2d.py::diffusion2d_schedule plans them).
//   A job is a tile; its window is the tile and 3R = 6 cells a side,
//   clipped to the padded array. Stage 1 is evaluated on the tile and 4
//   cells a side, stage 2 on 2 a side, stage 3 on the tile: the halo is
//   recomputed with the same arithmetic as the neighbour's own cells, so
//   it equals them to the bit, and t1 and t2 never leave shared memory.
//   Only S crosses jobs: ONE exchange a step.
// - Ping-pong. Step k reads S_k from buffer k & 1 (0: S, 1: T1) and
//   writes S_{k+1} to the other, so no job overwrites cells a neighbour
//   still reads. With an odd n_iters the result lands in T1 and is copied
//   to S after a last exchange.
// - Resident tiles. When every job has its own block (jobs <= the
//   co-resident blocks, the planned case) a block keeps its window in
//   shared memory for the whole run: stage 3 writes S_{k+1} into it in
//   place (it reads u only at its own cell), the block publishes only the
//   6 cells of each edge that neighbours read, and reloads only its 6-cell
//   halo each step. Otherwise (more jobs than blocks) each job reloads its
//   whole window and writes its whole tile every step.
// - Exchange: one grid.sync() a step, after every job's writes. Timed on
//   the H100 at 1001^2 and not kept (PERF.md): flags a job in global
//   memory that only the neighbours wait on (as fast, within the spread);
//   two or more blocks an SM (slower); patches of 6 or 8 rows (slower);
//   computing the cells that need no halo before the exchange (slower:
//   the frame left after it costs a round of its own); two steps an
//   exchange would need 754 patches for 640 threads in its first step.
// - Register tiles. A thread evaluates a patch of V = 4 rows by 4
//   columns: its column quad's values of rows -2 .. V+1 and the quads
//   left and right of each row come from shared memory as 16-byte loads
//   (one 16-byte load an evaluated cell), every shared plane at one pitch
//   in the window's coordinates, so the quads stay aligned at every
//   stage. The masks are a patch's: a patch inside the band stores rk
//   with no test; others select cell by cell, as K1's masks.
// - Global traffic goes through L2 with __ldcg (the buffers are written
//   in this launch; the non-coherent and L1 paths may serve stale data),
//   each warp on one row, so every load and store is coalesced.
//
// Bound on an H100: at 1001^2 one buffer is 4.0 MB, so the state stays in
// the 50 MB L2 for the run: the run must move 4 MB in and 4 MB out of
// device memory once (2.4 us at 3.35 TB/s). Its f32 operations (22 a cell
// in stage 1, 24 in stages 2-3, the interior cells only, as counted by
// chip_smoke.py) take 10.4 ms at 67 TFLOP/s for 10,000 steps, so the run
// is bound by operations; rounded one by one they issue at half that
// rate. The body issues 21 + 24 + 24 an evaluated cell, and an 84x91 tile
// evaluates 1.09 stages a cell for each one it needs. With `body` 0 the
// same grid runs only its grid.sync()s: chip_smoke.py reports that
// floor (2.1 us a step on the H100, a fifth of the step).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 2;         // stencil radius of the O4 second derivative
constexpr int HALO = 3 * R;  // a job's window reaches 6 cells past its tile
constexpr int THREADS = 640;
constexpr int MIN_BLOCKS = 1;  // resident blocks an SM
constexpr int WARPS = THREADS / 32;
constexpr int V = 4;     // rows of a thread's patch (its columns: a quad)
constexpr int LEFT = 4;  // shared column of the window's first column
constexpr long long MAX_CELLS = (1LL << 31) - 1;  // padded cells

// SSP-RK3 stage combinations u_next = a*u + b*(v + dt*L(v))
// (Compute_RK, MultiGPU/Diffusion3d_Baseline/Kernels.cu:266-300)
constexpr float A2 = (float)0.75, B2 = (float)0.25;
constexpr float A3 = (float)(1.0 / 3.0), B3 = (float)(2.0 / 3.0);

struct Args {
  float* S;         // buffer 0: S_k of even k, and the result
  float* T1;        // buffer 1: S_k of odd k
  const float* T2;  // read for its ghost ring only
  int ny, nx;
  int my, mx, jobs;  // tiles along y and x, my * mx
  int P;             // pitch of a shared plane (floats)
  int plane;         // floats of a shared plane: (max window rows + V) * P
  float taps[10];    // [axis y, x][tap j]
  float dt;
  int band;
  float bc_value;
  int n_iters;
  int body;  // 0: the exchanges only (the floor)
};

// A job's tile and window in global interior coordinates.
struct Job {
  int j, jy, jx;
  int y0, y1, x0, x1;      // the tile
  int wy0, wy1, wx0, wx1;  // the window, clipped to [-R, n + R)
};

__device__ __forceinline__ Job job_of(int j, const Args& p) {
  Job J;
  J.j = j;
  J.jy = j / p.mx;
  J.jx = j - J.jy * p.mx;
  J.y0 = (int)((long long)J.jy * p.ny / p.my);
  J.y1 = (int)((long long)(J.jy + 1) * p.ny / p.my);
  J.x0 = (int)((long long)J.jx * p.nx / p.mx);
  J.x1 = (int)((long long)(J.jx + 1) * p.nx / p.mx);
  J.wy0 = max(J.y0 - HALO, -R);
  J.wy1 = min(J.y1 + HALO, p.ny + R);
  J.wx0 = max(J.x0 - HALO, -R);
  J.wx1 = min(J.x1 + HALO, p.nx + R);
  return J;
}

// rk of one cell from its y taps y0..y4 (y2 the cell) and x taps x0..x4,
// the terms in the twin's order.
template <int ST>
__device__ __forceinline__ float rk_cell(float y0, float y1, float y2,
                                         float y3, float y4, float x0,
                                         float x1, float x3, float x4,
                                         float u, const Args& p) {
  const float* t = p.taps;
  float acc = __fmul_rn(y0, t[0]);
  acc = __fadd_rn(acc, __fmul_rn(y1, t[1]));
  acc = __fadd_rn(acc, __fmul_rn(y2, t[2]));
  acc = __fadd_rn(acc, __fmul_rn(y3, t[3]));
  acc = __fadd_rn(acc, __fmul_rn(y4, t[4]));
  acc = __fadd_rn(acc, __fmul_rn(x0, t[5]));
  acc = __fadd_rn(acc, __fmul_rn(x1, t[6]));
  acc = __fadd_rn(acc, __fmul_rn(y2, t[7]));
  acc = __fadd_rn(acc, __fmul_rn(x3, t[8]));
  acc = __fadd_rn(acc, __fmul_rn(x4, t[9]));
  const float s = __fadd_rn(y2, __fmul_rn(p.dt, acc));
  if (ST == 1) return s;  // b = 1, no u
  constexpr float A = ST == 2 ? A2 : A3;
  constexpr float B = ST == 2 ? B2 : B3;
  return __fadd_rn(__fmul_rn(A, u), __fmul_rn(B, s));
}

__device__ __forceinline__ float lane_of(const float4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// A rectangle of global interior cells, rows [ya, yb) x columns [xa, xb).
struct Rect {
  int ya, yb, xa, xb;
};

__device__ __forceinline__ void store4(float* dst, const float4& v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "f"(v.x),
                  "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Stage ST (1, 2, 3) of job J: `out` <- s(`in`, `us`) on the tile and
// E = 2(3 - ST) cells a side, inside the domain, in patches of V rows by
// a quad. Every shared plane has the window's coordinates: global (y, x)
// at [(y - wy0) * P + x - wx0 + LEFT]. Stage 3 writes into `us` (S) in
// place: a patch reads its u before it writes, and no other thread reads
// those cells in this stage.
template <int ST>
__device__ __forceinline__ void stage(const float* in, const float* us,
                                      float* out, const Job& J,
                                      const Args& p) {
  constexpr int E = 2 * (3 - ST);
  const Rect rc{max(J.y0 - E, 0), min(J.y1 + E, p.ny), max(J.x0 - E, 0),
                min(J.x1 + E, p.nx)};
  const int off = LEFT - J.wx0;  // shared column of global x: x + off
  const int qa = (rc.xa + off) >> 2;
  const int nq = ((rc.xb - 1 + off) >> 2) - qa + 1;
  const int total = (rc.yb - rc.ya + V - 1) / V * nq;
  const int P = p.P;
  for (int t = threadIdx.x; t < total; t += THREADS) {
    const int g = t / nq;
    const int q = qa + (t - g * nq);
    const int r0 = rc.ya + g * V;  // global row of the patch's first row
    const int x0 = 4 * q - off;    // global x of the quad's first cell
    const int base = (r0 - J.wy0) * P + 4 * q;
    float4 c[V + 4];  // the quad's rows r0-2 .. r0+V+1
#pragma unroll
    for (int i = 0; i < V + 4; ++i)
      c[i] = *reinterpret_cast<const float4*>(in + base + (i - 2) * P);
    float4 res[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float4 l = *reinterpret_cast<const float4*>(in + base + i * P - 4);
      const float4 r = *reinterpret_cast<const float4*>(in + base + i * P + 4);
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ST != 1) u = *reinterpret_cast<const float4*>(us + base + i * P);
      const float4 m = c[i + 2];
      res[i].x = rk_cell<ST>(c[i].x, c[i + 1].x, m.x, c[i + 3].x, c[i + 4].x,
                             l.z, l.w, m.y, m.z, u.x, p);
      res[i].y = rk_cell<ST>(c[i].y, c[i + 1].y, m.y, c[i + 3].y, c[i + 4].y,
                             l.w, m.x, m.z, m.w, u.y, p);
      res[i].z = rk_cell<ST>(c[i].z, c[i + 1].z, m.z, c[i + 3].z, c[i + 4].z,
                             m.x, m.y, m.w, r.x, u.z, p);
      res[i].w = rk_cell<ST>(c[i].w, c[i + 1].w, m.w, c[i + 3].w, c[i + 4].w,
                             m.y, m.z, r.x, r.y, u.w, p);
    }
    const bool whole = r0 + V <= rc.yb && x0 >= rc.xa && x0 + 4 <= rc.xb;
    if (whole && r0 >= p.band && r0 + V <= p.ny - p.band &&
        x0 >= p.band && x0 + 4 <= p.nx - p.band) {  // every cell interior
#pragma unroll
      for (int i = 0; i < V; ++i) store4(out + base + i * P, res[i]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int y = r0 + i;
      if (y >= rc.yb) break;
      const bool y_int = y >= p.band && y < p.ny - p.band;
      const bool y_face = y == 0 || y == p.ny - 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = x0 + e;
        if (x < rc.xa || x >= rc.xb) continue;
        const bool interior = y_int && x >= p.band && x < p.nx - p.band;
        const bool face = y_face || x == 0 || x == p.nx - 1;
        out[base + i * P + e] = interior ? lane_of(res[i], e)
                                : face   ? p.bc_value
                                         : lane_of(c[i + 2], e);
      }
    }
  }
}

// The three stages of job J, a block barrier after each.
__device__ __forceinline__ void stages(float* sS, float* s1, float* s2,
                                       const Job& J, const Args& p) {
  stage<1>(sS, sS, s1, J, p);
  __syncthreads();
  stage<2>(s1, sS, s2, J, p);
  __syncthreads();
  stage<3>(s2, sS, sS, J, p);
  __syncthreads();
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

// S_k's window of job J from `src` into the S plane: the whole window
// (`ring` false; with `ghosts` also the cells outside the domain, from
// the ghost rings of S, T1 and T2 into the S, t1 and t2 planes) or only
// its halo (`ring`: what a resident job reloads; its ghost cells never
// change). Every thread issues LOADS loads before it stores one, so
// their L2 round trips overlap.
__device__ __forceinline__ void load_window(const float* src, float* sS,
                                            float* s1, float* s2,
                                            const Job& J, const Args& p,
                                            bool ghosts, bool ring) {
  constexpr int LOADS = 4;
  const long long X = p.nx + 2 * R;
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
      const long long g = (y + R) * X + x + R;
      const int s = (y - J.wy0) * p.P + x - J.wx0 + LEFT;
      if (y >= 0 && y < p.ny && x >= 0 && x < p.nx) {
        val[e] = __ldcg(src + g);
        at[e] = s;
      } else if (ghosts) {
        sS[s] = __ldcg(p.S + g);
        s1[s] = __ldcg(p.T1 + g);
        s2[s] = __ldcg(p.T2 + g);
      }
    }
#pragma unroll
    for (int e = 0; e < LOADS; ++e)
      if (at[e] >= 0) sS[at[e]] = val[e];
  }
}

// The tile of the S plane (S_{k+1}) into `dst`, a warp a row; with
// `edges` only its cells within HALO of an edge (what neighbours read).
__device__ __forceinline__ void store_tile(float* dst, const float* sS,
                                           const Job& J, const Args& p,
                                           bool edges) {
  const long long X = p.nx + 2 * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = LEFT - J.wx0;
  for (int y = J.y0 + warp; y < J.y1; y += WARPS) {
    const bool mid = edges && y >= J.y0 + HALO && y < J.y1 - HALO;
    const long long row = (y + R) * X + R;
    const int srow = (y - J.wy0) * p.P + off;
    for (int x = J.x0 + lane; x < J.x1; x += 32) {
      if (mid && x >= J.x0 + HALO && x < J.x1 - HALO) continue;
      __stcg(dst + row + x, sS[srow + x]);
    }
  }
}

// The tile of `src` into `dst` (the result of an odd run into S).
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          const Job& J, const Args& p) {
  const long long X = p.nx + 2 * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = J.y0 + warp; y < J.y1; y += WARPS) {
    const long long row = (y + R) * X + R;
    for (int x = J.x0 + lane; x < J.x1; x += 32)
      __stcg(dst + row + x, __ldcg(src + row + x));
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
whole_run_kernel(const __grid_constant__ Args p) {
  extern __shared__ float4 smem[];
  float* sS = reinterpret_cast<float*>(smem);
  float* s1 = sS + p.plane;
  float* s2 = s1 + p.plane;
  cg::grid_group grid = cg::this_grid();
  const bool resident = (int)gridDim.x >= p.jobs;
  if (p.n_iters < 1) return;
  // spare rows and columns of the planes hold finite values
  for (int i = threadIdx.x; i < 3 * p.plane; i += THREADS) sS[i] = 0.0f;
  __syncthreads();

  for (int k = 0; k < p.n_iters; ++k) {
    const float* src = (k & 1) ? p.T1 : p.S;
    float* dst = (k & 1) ? p.S : p.T1;
    for (int j = blockIdx.x; j < p.jobs; j += gridDim.x) {
      const Job J = job_of(j, p);
      if (p.body) {
        // a resident job's tile holds S_k: it reloads only its halo
        const bool ring = resident && k > 0;
        load_window(src, sS, s1, s2, J, p, !ring, ring);
        __syncthreads();
        stages(sS, s1, s2, J, p);
        store_tile(dst, sS, J, p, resident);
      }
      // the planes are free for the block's next job (a resident job's
      // block has none: the grid.sync() below orders the next step)
      if (!resident) __syncthreads();
    }
    grid.sync();
  }
  if (!p.body) return;
  // the result into S (every read of the last step is done): a resident
  // job writes its tile (the edges of an even run are there already); an
  // odd run's tiles are in T1
  const bool odd = p.n_iters & 1;
  if (!odd && !resident) return;
  for (int j = blockIdx.x; j < p.jobs; j += gridDim.x) {
    const Job J = job_of(j, p);
    if (resident)
      store_tile(p.S, sS, J, p, false);
    else
      copy_tile(p.S, p.T1, J, p);
  }
}

}  // namespace

// Run n_iters SSP-RK3 steps on the padded state S (ny+4, nx+4) in place,
// T1 and T2 buffers of S's shape (T1 the other state buffer, T2 read for
// its ghost ring), in one cooperative launch on `stream`. The interior is
// cut into my x mx tiles, a job each; each side of a tile spans at least
// 6 cells where there is more than one tile along it. `taps` points to 10
// host floats. With `body` 0 the same grid runs only its grid.sync()s
// (the floor). `grid_blocks`, when not null,
// receives the grid's block count and `smem_bytes` a block's dynamic
// shared memory. Returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int whole_run_diffusion2d(float* S, float* T1, const float* T2,
                                     int ny, int nx, const float* taps,
                                     float dt, int band, float bc_value,
                                     int n_iters, int my, int mx, int body,
                                     int* grid_blocks, int* smem_bytes,
                                     void* stream) {
  if (ny < 1 || nx < 1 || n_iters < 0 || my < 1 || mx < 1 || my > ny ||
      mx > nx || (my > 1 && ny / my < HALO) || (mx > 1 && nx / mx < HALO) ||
      (long long)(ny + 2 * R) * (nx + 2 * R) > MAX_CELLS ||
      (long long)my * mx > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.S = S;
  p.T1 = T1;
  p.T2 = T2;
  p.ny = ny;
  p.nx = nx;
  p.my = my;
  p.mx = mx;
  p.jobs = my * mx;
  // the widest window: the longest tile sides and 6 cells a side
  const int h = min((ny + my - 1) / my + 2 * HALO, ny + 2 * R);
  const int w = min((nx + mx - 1) / mx + 2 * HALO, nx + 2 * R);
  p.P = 4 * ((w + 3) / 4 + 3);  // LEFT spare columns, a quad or more right
  p.plane = (h + V) * p.P;
  for (int q = 0; q < 10; ++q) p.taps[q] = taps[q];
  p.dt = dt;
  p.band = band;
  p.bc_value = bc_value;
  p.n_iters = n_iters;
  p.body = body;
  const long long bytes = 3LL * p.plane * (long long)sizeof(float);

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
  e = cudaFuncSetAttribute((const void*)whole_run_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)whole_run_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, whole_run_kernel, THREADS, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(p.jobs < resident ? p.jobs : resident);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (grid_blocks != nullptr) *grid_blocks = blocks;
  if (smem_bytes != nullptr) *smem_bytes = (int)bytes;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)whole_run_kernel, blocks,
                                  THREADS, args, (size_t)bytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The card's numbers that K7's plan (fused_diffusion2d.py::
// diffusion2d_schedule) depends on, for the current device, into
// out[0..4]: its SMs; the blocks an SM the kernel's threads and registers
// allow; the dynamic shared memory a block may opt into; an SM's shared
// memory; and what each resident block holds besides its dynamic shared
// memory (the runtime's reserve and the kernel's static shared memory).
// Returns the first CUDA error (0 on success).
extern "C" int whole_run_diffusion2d_card(int* out) {
  int dev = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], whole_run_kernel, THREADS, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[3], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, whole_run_kernel);
  if (e != cudaSuccess) return (int)e;
  out[4] = reserved + (int)attr.sharedSizeBytes;
  return 0;
}
