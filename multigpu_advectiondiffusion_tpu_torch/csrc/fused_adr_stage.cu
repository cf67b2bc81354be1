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
// shards do, and the unsharded launch carries none of its arithmetic. The file is built with
// -fmad=false: no product and sum are contracted into an FMA, and the
// kernel rounds exactly where the plain PyTorch twin
// (ops/kernels/fused_adr.py::adr_stage_reference) does.
//
// Layout and aliasing: K1's (csrc/fused_diffusion_stage.cu). The padded
// state is (nz+4, ny+4, nx+4) contiguous float32 whose 2-deep ghost ring
// holds bc_value and is never written (a shard's: neighbour data on a
// sharded axis, refreshed between stages); the upwind +-1 neighbours lie
// inside it. The third stage runs in place (u == out): each thread reads
// u only at its own cell, before writing it, and v is never out.
//
// Bound on an H100: device-memory bytes, as K1's. Each stage must read
// v's interior once and write the interior once, 8 B/cell, and stages 2
// and 3 read u too, 12 B/cell (cz/cy/cx are a few KB). About 60 f32
// operations a cell (15 taps, 6 upwind terms a axis at most, the
// coefficient, reaction and RK combine) stay far under the card's f32
// rate at that traffic. Design: one thread per (y, x) column marches a
// chunk of z planes with the five z taps, which also give the z upwind
// neighbours, in a register queue, so the z stream is read once; the y
// and x neighbours come through L1, shared by the threads of a block.
// Shared-memory tiling and TMA are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int R = 2;    // stencil radius of the O4 second derivative
constexpr int BX = 32;  // threads along x: one warp spans 32 columns
constexpr int BY = 8;   // threads along y

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

template <bool HAS_U, bool SHARDED>
__global__ void __launch_bounds__(BX * BY)
adr_stage_kernel(const float* __restrict__ v, const float* u, float* out,
                 const float* __restrict__ cz, const float* __restrict__ cy,
                 const float* __restrict__ cx, int nz, int ny, int nx,
                 int zchunk, Params p, Geometry g) {
  const int i = blockIdx.x * BX + threadIdx.x;  // interior x index
  const int j = blockIdx.y * BY + threadIdx.y;  // interior y index
  if (i >= nx || j >= ny) return;
  const int k0 = blockIdx.z * zchunk;
  const int k1 = min(k0 + zchunk, nz);

  const long long X = nx + 2 * R;                   // row stride
  const long long P = (long long)(ny + 2 * R) * X;  // plane stride
  const long long col = (long long)(j + R) * X + (i + R);

  // global y, x and the global interior shape
  const int gj = SHARDED ? j + g.oy : j, gi = SHARDED ? i + g.ox : i;
  const int gz = SHARDED ? g.gz : nz, gy = SHARDED ? g.gy : ny,
            gx = SHARDED ? g.gx : nx;
  const bool in_yx = gj >= p.band && gj < gy - p.band && gi >= p.band &&
                     gi < gx - p.band;
  const bool face_yx = gj == 0 || gj == gy - 1 || gi == 0 || gi == gx - 1;
  const float cyj = cy[j], cxi = cx[i];

  // z taps of interior plane k live at padded planes k .. k+4
  float q0 = v[(long long)(k0 + 0) * P + col];
  float q1 = v[(long long)(k0 + 1) * P + col];
  float q2 = v[(long long)(k0 + 2) * P + col];
  float q3 = v[(long long)(k0 + 3) * P + col];

  for (int k = k0; k < k1; ++k) {
    const long long c = (long long)(k + R) * P + col;  // this cell
    const float q4 = v[c + 2 * P];
    const float ym1 = v[c - X], yp1 = v[c + X];
    const float xm1 = v[c - 1], xp1 = v[c + 1];

    float lap = q0 * p.taps[0];
    lap = lap + q1 * p.taps[1];
    lap = lap + q2 * p.taps[2];
    lap = lap + q3 * p.taps[3];
    lap = lap + q4 * p.taps[4];
    lap = lap + v[c - 2 * X] * p.taps[5];
    lap = lap + ym1 * p.taps[6];
    lap = lap + q2 * p.taps[7];
    lap = lap + yp1 * p.taps[8];
    lap = lap + v[c + 2 * X] * p.taps[9];
    lap = lap + v[c - 2] * p.taps[10];
    lap = lap + xm1 * p.taps[11];
    lap = lap + q2 * p.taps[12];
    lap = lap + xp1 * p.taps[13];
    lap = lap + v[c + 2] * p.taps[14];

    // upwind advective divergence, the axes in z, y, x order
    const float lo[3] = {q1, ym1, xm1};
    const float hi[3] = {q3, yp1, xp1};
    float adv = 0.0f;
    bool any = false;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      if (p.adv_axes & (1 << ax)) {
        const float term = p.cp[ax] * (q2 - lo[ax]) + p.cm[ax] * (hi[ax] - q2);
        adv = any ? adv + term : term;
        any = true;
      }
    }

    float rhs;
    if (p.eps != 0.0f) {
      const float kf = p.k0 * (1.0f + ((p.eps * cz[k]) * cyj) * cxi);
      rhs = kf * lap;
    } else {
      rhs = p.k0 * lap;
    }
    if (any) rhs = rhs - adv;
    if (p.lam != 0.0f) rhs = rhs - p.lam * q2;

    float rk = p.b * (q2 + p.dt * rhs);
    if (HAS_U) rk = p.a * u[c] + rk;

    const int gk = SHARDED ? k + g.oz : k;  // global z
    const bool interior = in_yx && gk >= p.band && gk < gz - p.band;
    const bool face = face_yx || gk == 0 || gk == gz - 1;
    out[c] = interior ? rk : (face ? p.bc_value : q2);

    q0 = q1;
    q1 = q2;
    q2 = q3;
    q3 = q4;
  }
}

template <bool SHARDED>
void launch(const float* v, const float* u, float* out, const float* cz,
            const float* cy, const float* cx, int nz, int ny, int nx,
            int zchunk, const Params& p, const Geometry& g,
            cudaStream_t s) {
  const dim3 block(BX, BY, 1);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY,
                  (nz + zchunk - 1) / zchunk);
  if (u != nullptr) {
    adr_stage_kernel<true, SHARDED><<<grid, block, 0, s>>>(
        v, u, out, cz, cy, cx, nz, ny, nx, zchunk, p, g);
  } else {
    adr_stage_kernel<false, SHARDED><<<grid, block, 0, s>>>(
        v, u, out, cz, cy, cx, nz, ny, nx, zchunk, p, g);
  }
}

}  // namespace

// Launch one stage on `stream`. `u` is null for stage 1 and may equal
// `out` (in-place stage 3). `taps` points to 15 host floats, `adv` to 6
// (cp for z, y, x, then cm); cz/cy/cx are device vectors of nz/ny/nx
// floats, K(x)'s factors at the block's cells. `global3` (gz, gy, gx)
// and `offset3` (oz, oy, ox), when not null, point to 3 host ints each:
// the global interior shape and the block's offsets (a shard of a mesh;
// null: the unsharded instance). Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise.
extern "C" int fused_adr_stage(const float* v, const float* u, float* out,
                               int nz, int ny, int nx, const float* taps,
                               const float* cz, const float* cy,
                               const float* cx, float k0, float eps,
                               const float* adv, float lam, float dt,
                               float a, float b, int band, float bc_value,
                               int zchunk, const int* global3,
                               const int* offset3, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || zchunk < 1 ||
      (global3 == nullptr) != (offset3 == nullptr))
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (global3 != nullptr) {
    const Geometry g{global3[0], global3[1], global3[2],
                     offset3[0], offset3[1], offset3[2]};
    if (g.oz < 0 || g.oy < 0 || g.ox < 0 || g.oz + nz > g.gz ||
        g.oy + ny > g.gy || g.ox + nx > g.gx)
      return (int)cudaErrorInvalidValue;
    launch<true>(v, u, out, cz, cy, cx, nz, ny, nx, zchunk, p, g, s);
  } else {
    launch<false>(v, u, out, cz, cy, cx, nz, ny, nx, zchunk, p,
                  Geometry{nz, ny, nx, 0, 0, 0}, s);
  }
  return (int)cudaGetLastError();
}
