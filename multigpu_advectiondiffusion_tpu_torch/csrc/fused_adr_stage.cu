// One SSP-RK3 stage of the 3-D advection–diffusion–reaction equation
// u_t + a . grad u = K(x) lap(u) - lambda u, fused into one kernel (K9).
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// fused_adr.py::_stage_kernel (built by _make_stage). It computes the
// same function, not the same blocks, in the TPU kernel's term order:
//
//   lap = sum over axes z, y, x, taps j = 0..4 of v[j-2] * taps[axis][j]
//         (taps = c_j / (12 dx_axis^2) rounded to f32: the UNSCALED sum)
//   adv = sum over the axes with cp or cm != 0, z then y then x, of
//         cp*(v - v[-1]) + cm*(v[+1] - v)     (first-order upwind)
//   rhs = k0 * (1 + ((eps*cz[k])*cy[j])*cx[i]) * lap   (eps != 0)
//       = k0 * lap                                     (eps == 0)
//   rhs = rhs - adv;  rhs = rhs - lambda*v   (lambda != 0)
//   rk  = b*(v + dt*rhs)  (stage 1),  a*u + b*(v + dt*rhs)  (stages 2, 3)
//   out = where(interior, rk, where(face, bc_value, v))
//
// with cp = f32(max(a_axis, 0)/dx), cm = f32(min(a_axis, 0)/dx),
// "interior" the cells >= band away from every global face and "face"
// the cells on a global face. K(x)'s factors cz/cy/cx are the 1-D
// vectors cos(pi*(g/(n-1) - 0.5)) of the global index g, computed once
// by the wrapper in float32 (a GPU's cosf and the CPU's need not round
// alike) and cut to the block's cells; the kernel forms their product per
// cell, so no 3-D coefficient field lives in device memory. A shard of a
// device mesh passes the global interior shape and its offsets, so both
// masks are global (the TPU kernel's offsets operand,
// fused_adr.py:244-305); it runs its own instance of the kernel, as K1's
// shards do, and the unsharded launch carries none of its arithmetic. The
// file is built with -fmad=false: no product and sum are contracted into
// an FMA, and the kernel rounds exactly where the plain PyTorch twin
// (ops/kernels/fused_adr.py::adr_stage_reference) does.
//
// Layout and aliasing: K1's (csrc/fused_diffusion_stage.cu). The padded
// state is (nz+4, ny+4, nx+4) contiguous float32 whose 2-deep ghost ring
// holds bc_value and is never written (a shard's: neighbour data on a
// sharded axis, refreshed between stages); the upwind +-1 neighbours lie
// inside it. The third stage runs in place (u == out): a block reads u
// only at its own tile's cells, each before it writes it, and v is never
// out.
//
// Bound on an H100: device-memory bytes, as K1's. Each stage must read
// v's interior once and write the interior once, 8 B/cell, and stages 2
// and 3 read u too, 12 B/cell (cz/cy/cx are a few KB): 0.040 / 0.060 ms
// at 508x204x160. About 60 f32 operations a cell (15 taps, 5 upwind
// terms an advecting axis, the coefficient, reaction and RK combine; not
// contracted, so they issue one a lane a cycle) are more than half of
// what the card issues in that time, so the loads must stay in flight
// while they issue. Design:
//
// - Plane tiles. A block owns a TY x TX = 16x64 (y, x) tile (32x32 and
//   8x128 were no faster on the H100, PERF.md) and marches a chunk of z planes (6 by
//   default: ops/kernels/fused_adr.py::adr_schedule plans it). Each
//   plane's tile of v with its 2-cell y/x halo comes into a ring of NV
//   shared planes, and u's tile (stages 2, 3) into a ring of NU, by
//   asynchronous copies (cp.async) issued LEAD planes ahead of the
//   compute, so three planes of loads are in flight while a plane's
//   operations issue, with one block barrier a plane. Both tiles start
//   at a padded column that is a multiple of 4 (u's carries 2 columns a
//   side it does not read), so where the row pitch is a multiple of 4
//   floats, as (508+4) is, every copy is 16 bytes (W = 4; else 4-byte
//   copies, W = 1). Each thread works out its copies' offsets once; a
//   plane is one or two copies a thread. TMA would take a tensor map a
//   buffer, built on the host, to save issue that is no longer the limit.
//   Deeper rings (LEAD 8, 9, 11 at 3 or 2 blocks an SM) and longer chunks
//   were slower on the H100 (PERF.md).
// - Registers. A thread owns a column and RPT = 4 rows of the tile: the
//   five z taps of each stay in a register queue (the z upwind
//   neighbours too), fed from the ring's plane two ahead; the y taps of
//   its own rows are the queue's centres, the other y and the x taps
//   shared loads at immediate offsets, a warp on 32 neighbouring columns.
//   A plane whose physics has every term (the main path) takes a path
//   with no test a cell, and a thread whose cells all lie inside the band
//   stores with no mask.
// - Stores go straight from registers, a warp on one row.
//
// bf16 storage (fused_adr_stage_bf16, unsharded and sharded; the TPU
// kernel's bf16 rung, fused_adr.py:140-148, :342-354): the same kernel,
// SHARDED as for float, with the storage type T a
// template parameter (storage.cuh). The rings hold bf16 planes, each value
// upcast where it is read; the arithmetic is the float32 instance's, and
// each written cell rounds to bf16 once, after the stage. A copy moves W
// bf16 values: 16 bytes (W = 8) where the row pitch is a multiple of 8
// values, else 8 bytes (W = 4) or 4 (W = 2) as the pitch allows, else
// one value by a plain load and store (cp.async moves no 2-byte copy).
// The shared pitch is 72 values (a multiple of 8) in place of 68. Half the
// bytes: 4 B/cell at stage 1, 6 at stages 2 and 3.

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "storage.cuh"

namespace {

constexpr int R = 2;  // stencil radius of the O4 second derivative
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // resident blocks an SM (64 registers)
constexpr int NV = 6;          // v planes in the ring
constexpr int NU = 4;          // u planes in the ring
constexpr int LEAD = 7;        // copy group of plane m + LEAD issued at m
constexpr int RPT = 4;         // rows a thread owns
constexpr int TY = 16, TX = 64;  // the (y, x) tile a block owns
static_assert(TY * TX == RPT * THREADS, "a thread owns RPT rows");

// The shared planes of storage type T: every plane's pitch (TX + 2R for
// float; rounded up to a multiple of 8 values for bf16, the 16-byte
// copies' width), a v and a u plane's values, the block's bytes.
template <typename T>
struct Layout {
  static constexpr int PV = sizeof(T) == 2 ? 72 : TX + 2 * R;
  static constexpr int PLANE_V = (TY + 2 * R) * PV;
  static constexpr int PLANE_U = TY * PV;
  static constexpr int SMEM_BYTES =
      (NV * PLANE_V + NU * PLANE_U) * (int)sizeof(T);
};

struct Params {
  float taps[15];  // [axis z, y, x][tap j], unscaled by K
  float cp[3];     // upwind coefficients per axis (z, y, x)
  float cm[3];
  int adv_axes;    // bit a set: axis a has cp or cm != 0
  float k0, eps, lam, dt, a, b, bc_value;
  int band;
};

// The global picture of a sharded launch: the global interior shape and
// the block's offsets.
struct Geometry {
  int gz, gy, gx;  // global interior shape
  int oz, oy, ox;  // global index of local interior cell (0, 0, 0)
};

// The launch's plan: tiles a row, z planes a block.
struct Plan {
  int tiles_x, zchunk;
};

// One asynchronous copy of W values of T: 16 bytes through L2 only, or 8
// or 4 bytes through L1 (cp.async takes no smaller copy that bypasses
// it); a 2-byte value by a plain load and store, complete before the
// barrier that precedes its readers.
template <int W, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  constexpr int BYTES = W * (int)sizeof(T);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(src) : "memory");
  else if (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(d), "l"(src) : "memory");
  else if (BYTES == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(d), "l"(src) : "memory");
  else
    *dst = *src;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// A thread's share of the copies of a ROWS x COLS tile of a plane, in
// copies of W values of T, THREADS at a time: each copy's offset in the shared
// tile (pitch COLS; -1: the copy would reach past the array's `rows_in`
// rows or `cols_in` columns and is skipped) and in the plane (row pitch
// X), worked out once a block.
template <int W, int ROWS, int COLS, typename T>
struct TileCopy {
  static_assert(COLS % W == 0, "a shared row takes whole copies");
  static constexpr int PER_ROW = COLS / W, N = ROWS * PER_ROW;
  static constexpr int K = (N + THREADS - 1) / THREADS;
  int so[K], go[K];

  __device__ __forceinline__ TileCopy(long long X, int rows_in,
                                      int cols_in) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int t = threadIdx.x + i * THREADS;
      const int r = t / PER_ROW, c = (t - r * PER_ROW) * W;
      so[i] = t < N && r < rows_in && c < cols_in ? r * COLS + c : -1;
      go[i] = (int)(r * X + c);
    }
  }

  __device__ __forceinline__ void issue(T* dst, const T* src) const {
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (so[i] >= 0) cp_async<W>(dst + so[i], src + go[i]);
  }
};

template <int W, bool HAS_U, bool SHARDED, typename T = float>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
adr_stage_kernel(const T* __restrict__ v, const T* u, T* out,
                 const float* __restrict__ cz, const float* __restrict__ cy,
                 const float* __restrict__ cx, int nz, int ny, int nx,
                 Plan pl, Params p, Geometry g) {
  using L = Layout<T>;
  constexpr int PV = L::PV, PLANE_V = L::PLANE_V, PLANE_U = L::PLANE_U;
  extern __shared__ float4 smem[];
  T* sv = reinterpret_cast<T*>(smem);
  T* su = sv + NV * PLANE_V;

  const int ty = blockIdx.x / pl.tiles_x;
  const int y0 = ty * TY, x0 = (blockIdx.x - ty * pl.tiles_x) * TX;
  const int k0 = blockIdx.y * pl.zchunk;
  const int zc = min(k0 + pl.zchunk, nz) - k0;
  const long long X = nx + 2 * R;
  const long long P = (long long)(ny + 2 * R) * X;

  // copy group q: v's padded plane k0 + q (the z taps of interior plane
  // k0 + q - 2 are centred on it) and u's interior plane k0 + q - 4, both
  // first needed in iteration q - 4. Both tiles start at the padded
  // column x0 (u's with 2 columns a side it does not read), so every row
  // of them starts 16-byte aligned where the row pitch is.
  const T* vtile = v + (long long)y0 * X + x0;  // padded (y0, x0)
  const T* utile = HAS_U ? u + (long long)(y0 + R) * X + x0 : nullptr;
  const TileCopy<W, TY + 2 * R, PV, T> vcopy(X, ny + 2 * R - y0,
                                             (int)X - x0);
  const TileCopy<W, TY, PV, T> ucopy(X, ny - y0, (int)X - x0);
  auto issue = [&](int q) {
    if (q < zc + 2 * R)
      vcopy.issue(sv + (q % NV) * PLANE_V, vtile + (k0 + q) * P);
    if (HAS_U && q >= 2 * R && q < zc + 2 * R)
      ucopy.issue(su + ((q - 2 * R) % NU) * PLANE_U,
                  utile + (k0 + q - R) * P);
    cp_commit();
  };

  // this thread's column and rows, and their masks
  const int c = threadIdx.x % TX;
  const int r0 = (threadIdx.x / TX) * RPT;
  const int i = x0 + c;  // interior x
  const int gi = SHARDED ? i + g.ox : i;
  const int gz = SHARDED ? g.gz : nz, gy = SHARDED ? g.gy : ny,
            gx = SHARDED ? g.gx : nx;
  const bool x_in = i < nx;
  const bool in_x = gi >= p.band && gi < gx - p.band;
  const bool face_x = gi == 0 || gi == gx - 1;
  const float cxi = x_in ? cx[i] : 0.0f;
  bool in_yx[RPT], face_yx[RPT], cell_in[RPT];
  bool inner = true;  // every cell of the thread in the domain, >= band
  float cyj[RPT];     // from the walls in y and x
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int j = y0 + r0 + e;
    const int gj = SHARDED ? j + g.oy : j;
    cell_in[e] = x_in && j < ny;
    in_yx[e] = in_x && gj >= p.band && gj < gy - p.band;
    face_yx[e] = face_x || gj == 0 || gj == gy - 1;
    cyj[e] = j < ny ? cy[j] : 0.0f;
    inner = inner && cell_in[e] && in_yx[e];
  }
  // this thread's cell of row e in a v plane and in a u plane
  const int vcell = (r0 + R) * PV + c + R;
  const int ucell = r0 * PV + c + R;

#pragma unroll 1
  for (int q = 0; q < LEAD - 1; ++q) issue(q);
  cp_wait<LEAD - 1 - 2 * R>();  // the first four planes
  __syncthreads();
  float q0[RPT], q1[RPT], q2[RPT], q3[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    q0[e] = to_f32(sv[0 * PLANE_V + vcell + e * PV]);
    q1[e] = to_f32(sv[1 * PLANE_V + vcell + e * PV]);
    q2[e] = to_f32(sv[2 * PLANE_V + vcell + e * PV]);
    q3[e] = to_f32(sv[3 * PLANE_V + vcell + e * PV]);
  }
  __syncthreads();  // group LEAD - 1 reuses plane 0's slot
  issue(LEAD - 1);

#pragma unroll 1
  for (int m = 0; m < zc; ++m) {
    cp_wait<LEAD - 2 * R - 1>();  // group m + 4: v plane m + 4, u plane m
    __syncthreads();  // every copy landed; plane m - 1's readers are done
    issue(m + LEAD);
    const int k = k0 + m;  // interior z of this plane
    const T* pc = sv + ((m + R) % NV) * PLANE_V + vcell;  // centre
    const T* p4 = sv + ((m + 2 * R) % NV) * PLANE_V + vcell;
    const T* pu = su + (m % NU) * PLANE_U + ucell;
    const int gk = SHARDED ? k + g.oz : k;
    const bool in_z = gk >= p.band && gk < gz - p.band;
    const bool face_z = gk == 0 || gk == gz - 1;
    const bool fast = inner && in_z;  // every cell interior: no mask
    const float ez = p.eps != 0.0f ? p.eps * cz[k] : 0.0f;
    // the centre plane's column: rows r0-2 .. r0+RPT+1, own rows from q2
    float col[RPT + 4];
    col[0] = to_f32(pc[-2 * PV]);
    col[1] = to_f32(pc[-PV]);
#pragma unroll
    for (int e = 0; e < RPT; ++e) col[e + 2] = q2[e];
    col[RPT + 2] = to_f32(pc[RPT * PV]);
    col[RPT + 3] = to_f32(pc[(RPT + 1) * PV]);
    T* o = out + (long long)(k + R) * P + (long long)(y0 + r0 + R) * X +
               (i + R);
    // the cells of this plane; FULL: every axis advects, eps and lambda
    // are not 0 (the main path), so no term is tested a cell
    auto cells = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const float q4 = to_f32(p4[e * PV]);
        const T* row = pc + e * PV;
        const float xm2 = to_f32(row[-2]), xm1 = to_f32(row[-1]),
                    xp1 = to_f32(row[1]), xp2 = to_f32(row[2]);
        const float ym1 = col[e + 1], yp1 = col[e + 3];
        const float vc = q2[e];

        float lap = q0[e] * p.taps[0];
        lap = lap + q1[e] * p.taps[1];
        lap = lap + vc * p.taps[2];
        lap = lap + q3[e] * p.taps[3];
        lap = lap + q4 * p.taps[4];
        lap = lap + col[e] * p.taps[5];
        lap = lap + ym1 * p.taps[6];
        lap = lap + vc * p.taps[7];
        lap = lap + yp1 * p.taps[8];
        lap = lap + col[e + 4] * p.taps[9];
        lap = lap + xm2 * p.taps[10];
        lap = lap + xm1 * p.taps[11];
        lap = lap + vc * p.taps[12];
        lap = lap + xp1 * p.taps[13];
        lap = lap + xp2 * p.taps[14];

        // upwind advective divergence, the axes in z, y, x order
        const float lo[3] = {q1[e], ym1, xm1};
        const float hi[3] = {q3[e], yp1, xp1};
        float adv = 0.0f;
        bool any = FULL;
        if (FULL) {
          adv = p.cp[0] * (vc - lo[0]) + p.cm[0] * (hi[0] - vc);
          adv = adv + (p.cp[1] * (vc - lo[1]) + p.cm[1] * (hi[1] - vc));
          adv = adv + (p.cp[2] * (vc - lo[2]) + p.cm[2] * (hi[2] - vc));
        } else {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            if (p.adv_axes & (1 << ax)) {
              const float term =
                  p.cp[ax] * (vc - lo[ax]) + p.cm[ax] * (hi[ax] - vc);
              adv = any ? adv + term : term;
              any = true;
            }
          }
        }

        float rhs;
        if (FULL || p.eps != 0.0f) {
          const float kf = p.k0 * (1.0f + (ez * cyj[e]) * cxi);
          rhs = kf * lap;
        } else {
          rhs = p.k0 * lap;
        }
        if (any) rhs = rhs - adv;
        if (FULL || p.lam != 0.0f) rhs = rhs - p.lam * vc;

        float rk = p.b * (vc + p.dt * rhs);
        if (HAS_U) rk = p.a * to_f32(pu[e * PV]) + rk;

        if (fast) {
          o[e * X] = from_f32<T>(rk);
        } else if (cell_in[e]) {
          const bool interior = in_yx[e] && in_z;
          const bool face = face_yx[e] || face_z;
          o[e * X] = from_f32<T>(interior ? rk : (face ? p.bc_value : vc));
        }

        q0[e] = q1[e];
        q1[e] = vc;
        q2[e] = q3[e];
        q3[e] = q4;
      }
    };
    if (p.adv_axes == 7 && p.eps != 0.0f && p.lam != 0.0f)
      cells(std::true_type{});
    else
      cells(std::false_type{});
  }
  cp_wait<0>();  // no copy outlives the block
}

// The pointers and sizes of one stage (T: the state's storage type).
template <typename T>
struct Buffers {
  const T* v;
  const T* u;
  T* out;
  const float *cz, *cy, *cx;
  int nz, ny, nx;
};

// Launch one instance of the kernel. The first launch of an instance on
// a device opts it into its dynamic shared memory and the largest
// carveout (MIN_BLOCKS blocks an SM need 4 x 49 KB); `blocks_per_sm`,
// when not null, receives its resident blocks an SM.
template <int W, bool HAS_U, bool SHARDED, typename T>
cudaError_t launch(const Buffers<T>& d, Plan pl, const Params& p,
                   const Geometry& g, int* blocks_per_sm, cudaStream_t s) {
  constexpr int bytes = Layout<T>::SMEM_BYTES;
  const auto kernel = adr_stage_kernel<W, HAS_U, SHARDED, T>;
  // bit k: the attributes are set on device k (devices past 63 set them
  // at every launch)
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit == 0 || !(set_on.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    set_on.fetch_or(bit, std::memory_order_release);
  }
  if (blocks_per_sm != nullptr) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      THREADS, bytes);
    if (e != cudaSuccess) return e;
  }
  pl.tiles_x = (d.nx + TX - 1) / TX;
  const dim3 grid(pl.tiles_x * ((d.ny + TY - 1) / TY),
                  (d.nz + pl.zchunk - 1) / pl.zchunk, 1);
  kernel<<<grid, THREADS, bytes, s>>>(d.v, d.u, d.out, d.cz, d.cy, d.cx,
                                      d.nz, d.ny, d.nx, pl, p, g);
  return cudaGetLastError();
}

template <int W, bool SHARDED, typename T>
cudaError_t launch_u(const Buffers<T>& d, Plan pl, const Params& p,
                     const Geometry& g, int* blocks_per_sm, cudaStream_t s) {
  return d.u != nullptr
             ? launch<W, true, SHARDED>(d, pl, p, g, blocks_per_sm, s)
             : launch<W, false, SHARDED>(d, pl, p, g, blocks_per_sm, s);
}

template <bool SHARDED>
cudaError_t launch_width(int w, const Buffers<float>& d, Plan pl,
                         const Params& p, const Geometry& g,
                         int* blocks_per_sm, cudaStream_t s) {
  return w == 4 ? launch_u<4, SHARDED>(d, pl, p, g, blocks_per_sm, s)
                : launch_u<1, SHARDED>(d, pl, p, g, blocks_per_sm, s);
}

// The bf16 instances' widths: 8, 4, 2 or 1 values a copy.
template <bool SHARDED>
cudaError_t launch_width_bf16(int w, const Buffers<__nv_bfloat16>& d,
                              Plan pl, const Params& p, const Geometry& g,
                              int* blocks_per_sm, cudaStream_t s) {
  switch (w) {
    case 8: return launch_u<8, SHARDED>(d, pl, p, g, blocks_per_sm, s);
    case 4: return launch_u<4, SHARDED>(d, pl, p, g, blocks_per_sm, s);
    case 2: return launch_u<2, SHARDED>(d, pl, p, g, blocks_per_sm, s);
    default: return launch_u<1, SHARDED>(d, pl, p, g, blocks_per_sm, s);
  }
}

// The width (values of `size` bytes) of the launch's copies: the widest
// of 16, 8 and 4 bytes whose width divides the row pitch X (so every
// tile row of v and u starts aligned: tiles start at multiples of 8
// columns) and whose alignment the buffers have; else 1 value (float: a
// 4-byte copy; bf16: a plain load and store).
int copy_width(const void* v, const void* u, long long X, int size) {
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int w = bytes / size;
    if (w >= 1 && X % w == 0 && (unsigned long long)v % bytes == 0 &&
        (unsigned long long)u % bytes == 0)
      return w;
    if (size == 4 && bytes == 16) break;  // float: 16-byte or 4-byte copies
  }
  return 1;
}

}  // namespace

// Launch one stage on `stream`. `u` is null for stage 1 and may equal
// `out` (in-place stage 3). `taps` points to 15 host floats, `adv` to 6
// (cp for z, y, x, then cm); cz/cy/cx are device vectors of nz/ny/nx
// floats, K(x)'s factors at the block's cells. `zchunk` is the z planes
// a block marches. `global3` (gz, gy, gx) and `offset3` (oz, oy, ox),
// when not null, point to 3 host ints each: the global interior shape and
// the block's offsets (a shard of a mesh; null: the unsharded instance).
// `plan_out`, when not null, receives the width of the copies (floats)
// and the kernel's resident blocks an SM. Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
extern "C" int fused_adr_stage(const float* v, const float* u, float* out,
                               int nz, int ny, int nx, const float* taps,
                               const float* cz, const float* cy,
                               const float* cx, float k0, float eps,
                               const float* adv, float lam, float dt,
                               float a, float b, int band, float bc_value,
                               int zchunk, const int* global3,
                               const int* offset3, int* plan_out,
                               void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 ||
      (global3 == nullptr) != (offset3 == nullptr) ||
      (long long)(nz + 2 * R) * (ny + 2 * R) * (nx + 2 * R) >
          (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int q = 0; q < 15; ++q) p.taps[q] = taps[q];
  p.adv_axes = 0;
  for (int ax = 0; ax < 3; ++ax) {
    p.cp[ax] = adv[ax];
    p.cm[ax] = adv[3 + ax];
    if (p.cp[ax] != 0.0f || p.cm[ax] != 0.0f) p.adv_axes |= 1 << ax;
  }
  p.k0 = k0;
  p.eps = eps;
  p.lam = lam;
  p.dt = dt;
  p.a = a;
  p.b = b;
  p.bc_value = bc_value;
  p.band = band;
  const long long X = nx + 2 * R;
  Plan pl;
  pl.zchunk = zchunk;
  pl.tiles_x = 0;  // set by the launch
  const int w = copy_width(v, u, X, 4);
  int* blocks_per_sm = nullptr;
  if (plan_out != nullptr) {
    plan_out[0] = w;
    blocks_per_sm = plan_out + 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buffers<float> d{v, u, out, cz, cy, cx, nz, ny, nx};
  if (global3 == nullptr)
    return (int)launch_width<false>(w, d, pl, p,
                                    Geometry{nz, ny, nx, 0, 0, 0},
                                    blocks_per_sm, s);
  const Geometry g{global3[0], global3[1], global3[2],
                   offset3[0], offset3[1], offset3[2]};
  if (g.oz < 0 || g.oy < 0 || g.ox < 0 || g.oz + nz > g.gz ||
      g.oy + ny > g.gy || g.ox + nx > g.gx)
    return (int)cudaErrorInvalidValue;
  return (int)launch_width<true>(w, d, pl, p, g, blocks_per_sm, s);
}

// K9's bf16 instances: one stage on bf16 buffers (the padded layout and
// arguments of fused_adr_stage, the sharded geometry too: null global3
// and offset3 launch the unsharded instance, else the sharded one, the
// TPU kernel's bf16 rung on a shard, fused_adr.py:342-354). Loads
// upcast, the arithmetic is the float32 instance's, and each written
// cell is rounded to bf16 once. `plan_out`, when not null, receives the
// copies' width (bf16 values) and the resident blocks an SM. Returns
// cudaGetLastError() after the launch (0 on success); does not
// synchronise.
extern "C" int fused_adr_stage_bf16(const void* v, const void* u, void* out,
                                    int nz, int ny, int nx,
                                    const float* taps, const float* cz,
                                    const float* cy, const float* cx,
                                    float k0, float eps, const float* adv,
                                    float lam, float dt, float a, float b,
                                    int band, float bc_value, int zchunk,
                                    const int* global3, const int* offset3,
                                    int* plan_out, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 ||
      (global3 == nullptr) != (offset3 == nullptr) ||
      (long long)(nz + 2 * R) * (ny + 2 * R) * (nx + 2 * R) > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int q = 0; q < 15; ++q) p.taps[q] = taps[q];
  p.adv_axes = 0;
  for (int ax = 0; ax < 3; ++ax) {
    p.cp[ax] = adv[ax];
    p.cm[ax] = adv[3 + ax];
    if (p.cp[ax] != 0.0f || p.cm[ax] != 0.0f) p.adv_axes |= 1 << ax;
  }
  p.k0 = k0;
  p.eps = eps;
  p.lam = lam;
  p.dt = dt;
  p.a = a;
  p.b = b;
  p.bc_value = bc_value;
  p.band = band;
  Plan pl;
  pl.zchunk = zchunk;
  pl.tiles_x = 0;  // set by the launch
  const int w = copy_width(v, u, nx + 2 * R, 2);
  int* blocks_per_sm = nullptr;
  if (plan_out != nullptr) {
    plan_out[0] = w;
    blocks_per_sm = plan_out + 1;
  }
  using bf16 = __nv_bfloat16;
  const Buffers<bf16> d{static_cast<const bf16*>(v),
                        static_cast<const bf16*>(u), static_cast<bf16*>(out),
                        cz, cy, cx, nz, ny, nx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (global3 == nullptr)
    return (int)launch_width_bf16<false>(w, d, pl, p,
                                         Geometry{nz, ny, nx, 0, 0, 0},
                                         blocks_per_sm, s);
  const Geometry g{global3[0], global3[1], global3[2],
                   offset3[0], offset3[1], offset3[2]};
  if (g.oz < 0 || g.oy < 0 || g.ox < 0 || g.oz + nz > g.gz ||
      g.oy + ny > g.gy || g.ox + nx > g.gx)
    return (int)cudaErrorInvalidValue;
  return (int)launch_width_bf16<true>(w, d, pl, p, g, blocks_per_sm, s);
}
