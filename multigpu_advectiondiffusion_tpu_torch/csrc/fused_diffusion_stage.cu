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
// the cells on a global face. Terms are summed in the TPU kernel's
// order (z, y, x; j ascending) with explicit round-to-nearest
// multiplies and adds (__fmul_rn/__fadd_rn), so the compiler cannot
// contract them into FMAs: the kernel rounds exactly where the plain
// PyTorch twin (ops/kernels/fused_diffusion.py::stage_reference) does.
//
// Layout: the padded state is (nz+4, ny+4, nx+4) contiguous float32.
// The 2-deep ghost ring holds bc_value and is never written; only the
// nz*ny*nx interior cells are.
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
// below the card's f32 rate at that traffic. Design: one thread per
// (y, x) column marches a chunk of z planes (zchunk, 8 by default) and
// keeps the five z taps in a register queue (the reference's
// LaplaceO4_async, MultiGPU/Diffusion3d_Baseline/Kernels.cu:207-261),
// so the z stream is read once; the y and x neighbours are shared
// between the threads of a block through L1. Shared-memory tiling and
// TMA are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int R = 2;    // stencil radius of the O4 second derivative
constexpr int BX = 32;  // threads along x: one warp spans 32 columns
constexpr int BY = 8;   // threads along y

struct Taps {
  float c[15];  // [axis z, y, x][tap j]
};

template <bool HAS_U>
__global__ void __launch_bounds__(BX * BY)
stage_kernel(const float* __restrict__ v, const float* u, float* out,
             int nz, int ny, int nx, int zchunk, Taps taps, float dt,
             float a, float b, int band, float bc_value) {
  const int i = blockIdx.x * BX + threadIdx.x;  // interior x index
  const int j = blockIdx.y * BY + threadIdx.y;  // interior y index
  if (i >= nx || j >= ny) return;
  const int k0 = blockIdx.z * zchunk;
  const int k1 = min(k0 + zchunk, nz);

  const long long X = nx + 2 * R;                   // row stride
  const long long P = (long long)(ny + 2 * R) * X;  // plane stride
  const long long col = (long long)(j + R) * X + (i + R);

  const bool in_yx = j >= band && j < ny - band && i >= band && i < nx - band;
  const bool face_yx = j == 0 || j == ny - 1 || i == 0 || i == nx - 1;

  // z taps of interior plane k live at padded planes k .. k+4
  float q0 = v[(long long)(k0 + 0) * P + col];
  float q1 = v[(long long)(k0 + 1) * P + col];
  float q2 = v[(long long)(k0 + 2) * P + col];
  float q3 = v[(long long)(k0 + 3) * P + col];

  for (int k = k0; k < k1; ++k) {
    const long long c = (long long)(k + R) * P + col;  // this cell
    const float q4 = v[c + 2 * P];

    float acc = __fmul_rn(q0, taps.c[0]);
    acc = __fadd_rn(acc, __fmul_rn(q1, taps.c[1]));
    acc = __fadd_rn(acc, __fmul_rn(q2, taps.c[2]));
    acc = __fadd_rn(acc, __fmul_rn(q3, taps.c[3]));
    acc = __fadd_rn(acc, __fmul_rn(q4, taps.c[4]));

    acc = __fadd_rn(acc, __fmul_rn(v[c - 2 * X], taps.c[5]));
    acc = __fadd_rn(acc, __fmul_rn(v[c - X], taps.c[6]));
    acc = __fadd_rn(acc, __fmul_rn(q2, taps.c[7]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + X], taps.c[8]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + 2 * X], taps.c[9]));

    acc = __fadd_rn(acc, __fmul_rn(v[c - 2], taps.c[10]));
    acc = __fadd_rn(acc, __fmul_rn(v[c - 1], taps.c[11]));
    acc = __fadd_rn(acc, __fmul_rn(q2, taps.c[12]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + 1], taps.c[13]));
    acc = __fadd_rn(acc, __fmul_rn(v[c + 2], taps.c[14]));

    float rk = __fmul_rn(b, __fadd_rn(q2, __fmul_rn(dt, acc)));
    if (HAS_U) rk = __fadd_rn(__fmul_rn(a, u[c]), rk);

    const bool interior = in_yx && k >= band && k < nz - band;
    const bool face = face_yx || k == 0 || k == nz - 1;
    out[c] = interior ? rk : (face ? bc_value : q2);

    q0 = q1;
    q1 = q2;
    q2 = q3;
    q3 = q4;
  }
}

}  // namespace

// Launch one stage on `stream`. `u` is null for stage 1 and may equal
// `out` (in-place stage 3). `taps` points to 15 host floats. Returns
// cudaGetLastError() after the launch (0 on success); does not
// synchronise.
extern "C" int fused_diffusion_stage(const float* v, const float* u,
                                     float* out, int nz, int ny, int nx,
                                     const float* taps, float dt, float a,
                                     float b, int band, float bc_value,
                                     int zchunk, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1) return (int)cudaErrorInvalidValue;
  Taps t;
  for (int q = 0; q < 15; ++q) t.c[q] = taps[q];
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY,
                  (nz + zchunk - 1) / zchunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u != nullptr) {
    stage_kernel<true><<<grid, block, 0, s>>>(v, u, out, nz, ny, nx, zchunk,
                                              t, dt, a, b, band, bc_value);
  } else {
    stage_kernel<false><<<grid, block, 0, s>>>(v, u, out, nz, ny, nx, zchunk,
                                               t, dt, a, b, band, bc_value);
  }
  return (int)cudaGetLastError();
}
