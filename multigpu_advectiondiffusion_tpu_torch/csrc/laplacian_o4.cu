// The O4 Laplacian of a padded float32 array, in 3-D (K11) and 2-D (K11b).
//
// Replaces the TPU kernels multigpu_advectiondiffusion_tpu/ops/pallas/
// laplacian.py::laplacian_o4_3d (:140, pallas_call :177) and
// laplacian_o4_2d (:194, pallas_call :217). It computes the same
// function, not the same blocks:
//
//   out = sum over axes a (z, y, x in 3-D; y, x in 2-D) of K_a * term_a
//   term_a = sum over taps j = 0..4 of u[j - 2 along a] * t_a[j]
//
// on an input padded by 2 on every axis ((nz+4, ny+4, nx+4) -> (nz, ny,
// nx)), with t_a[j] = c_j / (12 dx_a^2) formed in double and rounded once
// to f32 and K_a rounded to f32 (both by the wrapper). Terms are summed in
// the TPU kernel's order (per axis j ascending, then K_a * term, axes
// z, y, x) with explicit round-to-nearest multiplies and adds
// (__fmul_rn/__fadd_rn), so the compiler cannot contract them into FMAs:
// the kernel rounds exactly where the plain PyTorch twin
// (ops/kernels/laplacian.py::laplacian_reference) does. The ghost corners
// are never read (13-point cross stencil; 9-point in 2-D).
//
// Bound on an H100: device-memory bytes. The padded array is read once
// and the interior written once: 400x200x206 moves 135.2 MB, 0.0403 ms at
// 3.35 TB/s. The arithmetic is 15 products, 12 sums and 3 K-products and
// 2 sums a cell in 3-D (32 operations), far below the f32 rate at that
// traffic. Design (simple and right first): in 3-D one thread per (y, x)
// column marches a chunk of z planes and keeps the five z taps in a
// register queue (the reference's LaplaceO4_async, MultiGPU/
// Diffusion3d_Baseline/Kernels.cu:207-261), so the z stream is read once;
// the y and x neighbours are shared between the threads of a block
// through L1. In 2-D one thread per cell. Shared-memory tiles and TMA are
// left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int R = 2;    // stencil radius of the O4 second derivative
constexpr int BX = 32;  // threads along x: one warp spans 32 columns
constexpr int BY = 8;   // threads along y

struct Coeffs {
  float t[15];  // [axis][tap j], array axis order
  float k[3];   // K per axis
};

__device__ __forceinline__ float tap5(float q0, float q1, float q2,
                                      float q3, float q4, const float* t) {
  float acc = __fmul_rn(q0, t[0]);
  acc = __fadd_rn(acc, __fmul_rn(q1, t[1]));
  acc = __fadd_rn(acc, __fmul_rn(q2, t[2]));
  acc = __fadd_rn(acc, __fmul_rn(q3, t[3]));
  return __fadd_rn(acc, __fmul_rn(q4, t[4]));
}

__global__ void __launch_bounds__(BX * BY)
laplacian3d_kernel(const float* __restrict__ up, float* __restrict__ out,
                   int nz, int ny, int nx, int zchunk, Coeffs c) {
  const int i = blockIdx.x * BX + threadIdx.x;  // interior x index
  const int j = blockIdx.y * BY + threadIdx.y;  // interior y index
  if (i >= nx || j >= ny) return;
  const int k0 = blockIdx.z * zchunk;
  const int k1 = min(k0 + zchunk, nz);

  const long long X = nx + 2 * R;                   // padded row stride
  const long long P = (long long)(ny + 2 * R) * X;  // padded plane stride
  const long long col = (long long)(j + R) * X + (i + R);
  const long long ocol = (long long)j * nx + i;
  const long long oplane = (long long)ny * nx;

  // z taps of interior plane k live at padded planes k .. k+4
  float q0 = up[(long long)(k0 + 0) * P + col];
  float q1 = up[(long long)(k0 + 1) * P + col];
  float q2 = up[(long long)(k0 + 2) * P + col];
  float q3 = up[(long long)(k0 + 3) * P + col];

  for (int k = k0; k < k1; ++k) {
    const long long cc = (long long)(k + R) * P + col;  // this cell
    const float q4 = up[cc + 2 * P];
    const float tz = tap5(q0, q1, q2, q3, q4, &c.t[0]);
    const float ty = tap5(up[cc - 2 * X], up[cc - X], q2, up[cc + X],
                          up[cc + 2 * X], &c.t[5]);
    const float tx = tap5(up[cc - 2], up[cc - 1], q2, up[cc + 1],
                          up[cc + 2], &c.t[10]);
    float acc = __fmul_rn(c.k[0], tz);
    acc = __fadd_rn(acc, __fmul_rn(c.k[1], ty));
    acc = __fadd_rn(acc, __fmul_rn(c.k[2], tx));
    out[(long long)k * oplane + ocol] = acc;
    q0 = q1;
    q1 = q2;
    q2 = q3;
    q3 = q4;
  }
}

__global__ void __launch_bounds__(BX * BY)
laplacian2d_kernel(const float* __restrict__ up, float* __restrict__ out,
                   int ny, int nx, Coeffs c) {
  const int i = blockIdx.x * BX + threadIdx.x;  // interior x index
  const int j = blockIdx.y * BY + threadIdx.y;  // interior y index
  if (i >= nx || j >= ny) return;
  const long long X = nx + 2 * R;
  const long long cc = (long long)(j + R) * X + (i + R);
  const float q = up[cc];
  const float ty = tap5(up[cc - 2 * X], up[cc - X], q, up[cc + X],
                        up[cc + 2 * X], &c.t[0]);
  const float tx = tap5(up[cc - 2], up[cc - 1], q, up[cc + 1], up[cc + 2],
                        &c.t[5]);
  out[(long long)j * nx + i] =
      __fadd_rn(__fmul_rn(c.k[0], ty), __fmul_rn(c.k[1], tx));
}

}  // namespace

// K11: `up` is (nz+4, ny+4, nx+4), `out` (nz, ny, nx), both contiguous
// float32 on the device. `taps` points to 15 host floats (z, y, x by tap),
// `k` to 3 (K per axis). Returns cudaGetLastError() after the launch (0 on
// success); does not synchronise.
extern "C" int laplacian_o4_3d(const float* up, float* out, int nz, int ny,
                               int nx, const float* taps, const float* k,
                               int zchunk, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1)
    return (int)cudaErrorInvalidValue;
  Coeffs c;
  for (int q = 0; q < 15; ++q) c.t[q] = taps[q];
  for (int q = 0; q < 3; ++q) c.k[q] = k[q];
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY,
                  (nz + zchunk - 1) / zchunk);
  laplacian3d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      up, out, nz, ny, nx, zchunk, c);
  return (int)cudaGetLastError();
}

// K11b: `up` is (ny+4, nx+4), `out` (ny, nx); `taps` 10 host floats (y, x
// by tap), `k` 2.
extern "C" int laplacian_o4_2d(const float* up, float* out, int ny, int nx,
                               const float* taps, const float* k,
                               void* stream) {
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  Coeffs c;
  for (int q = 0; q < 10; ++q) c.t[q] = taps[q];
  for (int q = 0; q < 2; ++q) c.k[q] = k[q];
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, 1);
  laplacian2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      up, out, ny, nx, c);
  return (int)cudaGetLastError();
}
