// One SSP-RK3 stage of the 3-D O4 heat equation, fused into one kernel.
//
// Replaces the TPU kernel multigpu_advectiondiffusion_tpu/ops/pallas/
// fused_diffusion.py::_stage_kernel (built by _make_stage). It computes
// the same function, not the same blocks:
//
//   out = where(interior, rk, where(face, bc_value, v))
//   rk  = b*(v + dt*acc)            (stage 1, no u operand)
//   rk  = a*u + b*(v + dt*acc)      (stages 2 and 3)
//   acc = sum over axes z, y, x, taps j = 0..4 of taps[axis][j] * v[j-2]
//
// with taps[axis][j] = c_j * K_axis / (12 dx_axis^2) rounded to f32,
// "interior" the cells >= band away from every global face and "face"
// the cells on a global face. A shard of a device mesh passes the global
// interior shape and its offsets, so both masks are global (the TPU
// kernel's offsets operand, fused_diffusion.py:243-262); it runs its own
// instance of the kernel. Terms are summed in the TPU kernel's
// order (z, y, x; j ascending) with explicit round-to-nearest
// multiplies and adds (__fmul_rn/__fadd_rn), so the compiler cannot
// contract them into FMAs: the kernel rounds exactly where the plain
// PyTorch twin (ops/kernels/fused_diffusion.py::stage_reference) does.
//
// Layout: the padded state is (nz+4, ny+4, nx+4) contiguous float32 (a
// shard's local block). The kernel writes interior cells only. Unsharded,
// the 2-deep ghost ring holds bc_value and is never written. Sharded,
// the ghost rows of a sharded axis hold neighbour data, which the halo
// refresh rewrites after every stage (parallel/halo.py), and bc_value
// on a global face.
//
// Roles of the split schedule (fused_diffusion.py:279-331, :482-545): a
// launch writes the z planes [k_begin, k_end) of the interior only. The
// "interior" call's planes read no ghost row; the "bottom" and "top"
// calls take the R z-ghost planes from the exchanged operands lo and hi
// ((R, ny+4, nx+4) each) instead of the buffer, whose z ghosts are stale
// in that schedule.
//
// Aliasing: the third stage runs in place (u == out). That is safe
// because each thread reads u only at its own cell, before it writes
// that cell, and no launch reads the neighbours of the buffer it
// writes (v is always a different buffer from out).
//
// Bound on an H100: device-memory bytes. Each stage must read v's
// interior once and write the interior once: 8 B/cell; stages 2 and 3
// also read u: 12 B/cell. No cell that computes rk reaches the ghost
// ring (band >= 2 on the main path) and face cells take bc_value, so the
// ghosts need no read. The arithmetic is ~34 f32 operations a cell, far
// below the card's f32 rate at that traffic. The bf16 instance moves half
// the bytes (4 B/cell at stage 1, 6 at stages 2 and 3) with the same
// arithmetic. Design: one thread per
// (y, x) column marches a chunk of z planes (zchunk, 8 by default) and
// keeps the five z taps in a register queue (the reference's
// LaplaceO4_async, MultiGPU/Diffusion3d_Baseline/Kernels.cu:207-261),
// so the z stream is read once; the y and x neighbours are shared
// between the threads of a block through L1. Shared-memory tiling and
// TMA are left to later work.

#include <cuda_runtime.h>

#include "storage.cuh"

namespace {

constexpr int R = 2;    // stencil radius of the O4 second derivative
constexpr int BX = 32;  // threads along x: one warp spans 32 columns
constexpr int BY = 8;   // threads along y

struct Taps {
  float c[15];  // [axis z, y, x][tap j]
};

// The global picture of a launch: the global interior shape and this
// block's offsets (0 and the local shape when unsharded), and the planes
// written.
struct Geometry {
  int gz, gy, gx;  // global interior shape
  int oz, oy, ox;  // global index of local interior cell (0, 0, 0)
  int k_begin, k_end;
};

// Padded plane `row` of the stage input: from the exchanged operand lo
// (rows 0..R-1) or hi (rows nz+R..nz+2R-1) where one is given.
template <typename T>
__device__ __forceinline__ const T* plane(const T* v, const T* lo,
                                          const T* hi, int row, int nz,
                                          long long P) {
  if (lo != nullptr && row < R) return lo + row * P;
  if (hi != nullptr && row >= nz + R) return hi + (row - nz - R) * P;
  return v + row * P;
}

// SHARDED and OPERANDS are compile-time so that the unsharded launch
// (SHARDED false: local masks, every plane, no operands) carries none of
// the sharded geometry's arithmetic or tests. T is the buffers' storage
// type (storage.cuh): float, or __nv_bfloat16 for the bf16 instances
// (unsharded, sharded and with operands, as the float ones), whose loads
// upcast and whose one store a cell rounds, the TPU kernel's bf16 rung
// (fused_diffusion.py:205-212, :269, its sharded roles :281, :417-432).
template <bool HAS_U, bool SHARDED, bool OPERANDS, typename T = float>
__global__ void __launch_bounds__(BX * BY)
stage_kernel(const T* __restrict__ v, const T* u, T* out,
             const T* __restrict__ lo, const T* __restrict__ hi,
             int nz, int ny, int nx, int zchunk, Geometry g, Taps taps,
             float dt, float a, float b, int band, float bc_value) {
  const int i = blockIdx.x * BX + threadIdx.x;  // interior x index
  const int j = blockIdx.y * BY + threadIdx.y;  // interior y index
  if (i >= nx || j >= ny) return;
  const int k0 = (SHARDED ? g.k_begin : 0) + blockIdx.z * zchunk;
  const int k1 = min(k0 + zchunk, SHARDED ? g.k_end : nz);

  const long long X = nx + 2 * R;                   // row stride
  const long long P = (long long)(ny + 2 * R) * X;  // plane stride
  const long long col = (long long)(j + R) * X + (i + R);

  // global y, x and the global interior shape
  const int gj = SHARDED ? j + g.oy : j, gi = SHARDED ? i + g.ox : i;
  const int gz = SHARDED ? g.gz : nz, gy = SHARDED ? g.gy : ny,
            gx = SHARDED ? g.gx : nx;
  const bool in_yx = gj >= band && gj < gy - band && gi >= band &&
                     gi < gx - band;
  const bool face_yx = gj == 0 || gj == gy - 1 || gi == 0 || gi == gx - 1;

  // z taps of interior plane k live at padded planes k .. k+4
  float q0, q1, q2, q3;
  if (OPERANDS) {
    q0 = to_f32(plane(v, lo, hi, k0 + 0, nz, P)[col]);
    q1 = to_f32(plane(v, lo, hi, k0 + 1, nz, P)[col]);
    q2 = to_f32(plane(v, lo, hi, k0 + 2, nz, P)[col]);
    q3 = to_f32(plane(v, lo, hi, k0 + 3, nz, P)[col]);
  } else {
    q0 = to_f32(v[(long long)(k0 + 0) * P + col]);
    q1 = to_f32(v[(long long)(k0 + 1) * P + col]);
    q2 = to_f32(v[(long long)(k0 + 2) * P + col]);
    q3 = to_f32(v[(long long)(k0 + 3) * P + col]);
  }

  for (int k = k0; k < k1; ++k) {
    const long long c = (long long)(k + R) * P + col;  // this cell
    const float q4 = to_f32(OPERANDS ? plane(v, lo, hi, k + 4, nz, P)[col]
                                     : v[c + 2 * P]);

    float acc = __fmul_rn(q0, taps.c[0]);
    acc = __fadd_rn(acc, __fmul_rn(q1, taps.c[1]));
    acc = __fadd_rn(acc, __fmul_rn(q2, taps.c[2]));
    acc = __fadd_rn(acc, __fmul_rn(q3, taps.c[3]));
    acc = __fadd_rn(acc, __fmul_rn(q4, taps.c[4]));

    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c - 2 * X]), taps.c[5]));
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c - X]), taps.c[6]));
    acc = __fadd_rn(acc, __fmul_rn(q2, taps.c[7]));
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c + X]), taps.c[8]));
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c + 2 * X]), taps.c[9]));

    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c - 2]), taps.c[10]));
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c - 1]), taps.c[11]));
    acc = __fadd_rn(acc, __fmul_rn(q2, taps.c[12]));
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c + 1]), taps.c[13]));
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v[c + 2]), taps.c[14]));

    float rk = __fmul_rn(b, __fadd_rn(q2, __fmul_rn(dt, acc)));
    if (HAS_U) rk = __fadd_rn(__fmul_rn(a, to_f32(u[c])), rk);

    const int gk = SHARDED ? k + g.oz : k;  // global z
    const bool interior = in_yx && gk >= band && gk < gz - band;
    const bool face = face_yx || gk == 0 || gk == gz - 1;
    out[c] = from_f32<T>(interior ? rk : (face ? bc_value : q2));

    q0 = q1;
    q1 = q2;
    q2 = q3;
    q3 = q4;
  }
}

template <bool SHARDED, bool OPERANDS, typename T = float>
void launch(const T* v, const T* u, T* out, const T* lo, const T* hi, int nz,
            int ny, int nx, int zchunk, const Geometry& g, const Taps& t,
            float dt, float a, float b, int band, float bc_value,
            cudaStream_t s) {
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY,
                  (g.k_end - g.k_begin + zchunk - 1) / zchunk);
  if (u != nullptr) {
    stage_kernel<true, SHARDED, OPERANDS, T><<<grid, block, 0, s>>>(
        v, u, out, lo, hi, nz, ny, nx, zchunk, g, t, dt, a, b, band,
        bc_value);
  } else {
    stage_kernel<false, SHARDED, OPERANDS, T><<<grid, block, 0, s>>>(
        v, u, out, lo, hi, nz, ny, nx, zchunk, g, t, dt, a, b, band,
        bc_value);
  }
}

// Launch the instance a launch needs: the operands' (split roles), the
// sharded one, or the unsharded one for the whole unsharded state.
template <typename T>
int dispatch(const T* v, const T* u, T* out, int nz, int ny, int nx,
             const float* taps, float dt, float a, float b, int band,
             float bc_value, int zchunk, const int* global3,
             const int* offset3, int k_begin, int k_end, const T* lo,
             const T* hi, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 || k_begin < 0 ||
      k_end > nz || k_begin >= k_end)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int q = 0; q < 15; ++q) t.c[q] = taps[q];
  const Geometry g{global3[0], global3[1], global3[2], offset3[0],
                   offset3[1], offset3[2], k_begin, k_end};
  const bool operands = lo != nullptr || hi != nullptr;
  const bool sharded = operands || g.gz != nz || g.gy != ny || g.gx != nx ||
                       g.oz != 0 || g.oy != 0 || g.ox != 0 || k_begin != 0 ||
                       k_end != nz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (operands)
    launch<true, true>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, t, dt, a, b,
                       band, bc_value, s);
  else if (sharded)
    launch<true, false>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, t, dt, a,
                        b, band, bc_value, s);
  else
    launch<false, false>(v, u, out, lo, hi, nz, ny, nx, zchunk, g, t, dt, a,
                         b, band, bc_value, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one stage on `stream`. `u` is null for stage 1 and may equal
// `out` (in-place stage 3). `taps` points to 15 host floats. `global3`
// (gz, gy, gx) and `offset3` (oz, oy, ox) point to 3 host ints each: the
// global interior shape and this block's offsets. Only the interior z
// planes [k_begin, k_end) are written; `lo`/`hi`, when not null, hold the
// R z-ghost planes below/above the block (the split schedule's exchanged
// operands). A launch whose geometry is the whole unsharded state runs
// the unsharded instance. Returns cudaGetLastError() after the launch (0
// on success); does not synchronise.
extern "C" int fused_diffusion_stage(const float* v, const float* u,
                                     float* out, int nz, int ny, int nx,
                                     const float* taps, float dt, float a,
                                     float b, int band, float bc_value,
                                     int zchunk, const int* global3,
                                     const int* offset3, int k_begin,
                                     int k_end, const float* lo,
                                     const float* hi, void* stream) {
  return dispatch(v, u, out, nz, ny, nx, taps, dt, a, b, band, bc_value,
                  zchunk, global3, offset3, k_begin, k_end, lo, hi, stream);
}

// K1's bf16 instances: one stage on bf16 buffers, with the layout and
// arguments of fused_diffusion_stage (the sharded geometry, the window and
// the split roles' bf16 operands lo/hi too), each geometry its own
// instance as there. Loads upcast, the arithmetic is the float32
// instance's, and each written cell is rounded to bf16 once. Returns
// cudaGetLastError() after the launch (0 on success); does not
// synchronise.
extern "C" int fused_diffusion_stage_bf16(const void* v, const void* u,
                                          void* out, int nz, int ny, int nx,
                                          const float* taps, float dt,
                                          float a, float b, int band,
                                          float bc_value, int zchunk,
                                          const int* global3,
                                          const int* offset3, int k_begin,
                                          int k_end, const void* lo,
                                          const void* hi, void* stream) {
  using bf16 = __nv_bfloat16;
  return dispatch(static_cast<const bf16*>(v), static_cast<const bf16*>(u),
                  static_cast<bf16*>(out), nz, ny, nx, taps, dt, a, b, band,
                  bc_value, zchunk, global3, offset3, k_begin, k_end,
                  static_cast<const bf16*>(lo), static_cast<const bf16*>(hi),
                  stream);
}
