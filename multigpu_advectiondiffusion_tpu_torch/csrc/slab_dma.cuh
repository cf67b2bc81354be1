// K4's ghost-row exchange inside the kernel, shared by its diffusion
// (csrc/fused_step_diffusion.cu) and Burgers (csrc/slab_run_burgers.cu)
// instances.
//
// Replaces the remote copies and the landing splice of the TPU kernel
// multigpu_advectiondiffusion_tpu/ops/pallas/fused_slab_run.py::
// _whole_run_dma_kernel (:327-505). On the TPU each shard is its own
// program, pushes its core edge windows to its z neighbours' landing
// buffers with make_async_remote_copy and waits on paired semaphores. On
// one Hopper card every shard of the mesh runs in ONE cooperative launch,
// so a push is a copy by the whole grid and a grid.sync() stands in for
// every semaphore: nothing can be read before it has landed, and no
// landing slot is written while it is read.
//
// The data contract is the TPU kernel's. Shard i of n holds its lz core
// planes between depth = k*G ghost planes a side, two state buffers
// (pz = lz + 2 depth planes of `plane` floats each) and a landing buffer
// (2 slots, 2 sides, depth planes). At the start of block b (k steps a
// block), with the read parity's buffers:
//
//   push:   rows [pz - 2 depth, pz - depth) (my top core window) ->
//           land[(i + 1) % n][b % 2][0];
//           rows [depth, 2 depth) (my bottom core window) ->
//           land[(i - 1) % n][b % 2][1]
//           (a ring: the wall shards' wrapped windows land in slots
//           nobody reads, as the TPU's cyclic pushes do);
//   grid.sync();
//   splice: land[i][b % 2][0] -> rows [0, depth) where i > 0, and
//           land[i][b % 2][1] -> rows [pz - depth, pz) where i < n - 1;
//           the wall sides keep their ghost rows, which the step reads
//           as the wall value (diffusion) or never reads (Burgers clamps);
//   grid.sync().
//
// Each phase moves 2 n depth plane floats, a grid-stride loop with
// neighbouring threads on neighbouring addresses. No pointer is
// __restrict__: the state was written by other blocks in this launch.

#pragma once

#include <cooperative_groups.h>

// shards a launch takes: the table below is a kernel argument
constexpr int DMA_MAX_SHARDS = 64;

// The shards of a z-slab mesh on this card, in z order.
struct DmaShards {
  float* s0[DMA_MAX_SHARDS];    // state buffer of even steps' reads
  float* s1[DMA_MAX_SHARDS];    // ... and of odd steps'
  float* land[DMA_MAX_SHARDS];  // (2 slots, 2 sides, depth, plane)
  int n;                        // shards
  int pz, depth;                // buffer planes, ghost planes a side
  long long plane;              // floats a plane
};

__device__ __forceinline__ float* dma_state(const DmaShards& sh, int par,
                                            int i) {
  return par ? sh.s1[i] : sh.s0[i];
}

// The push and the splice of block b, reading parity `par`.
__device__ void dma_exchange(const DmaShards& sh, int par, int b,
                             cooperative_groups::grid_group& grid) {
  const long long win = (long long)sh.depth * sh.plane;
  const long long total = 2LL * sh.n * win;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int slot = b & 1;
  for (long long q = first; q < total; q += stride) {
    const int i = (int)(q / (2 * win));
    const long long r = q - 2 * win * i;
    const int side = (int)(r / win);
    const long long e = r - win * side;
    const int to = side == 0 ? (i + 1) % sh.n : (i + sh.n - 1) % sh.n;
    const long long row = side == 0 ? sh.pz - 2 * sh.depth : sh.depth;
    sh.land[to][(2 * slot + side) * win + e] =
        dma_state(sh, par, i)[row * sh.plane + e];
  }
  grid.sync();
  for (long long q = first; q < total; q += stride) {
    const int i = (int)(q / (2 * win));
    const long long r = q - 2 * win * i;
    const int side = (int)(r / win);
    const long long e = r - win * side;
    if (side == 0 ? i == 0 : i == sh.n - 1) continue;  // a wall side
    const long long row = side == 0 ? 0 : sh.pz - sh.depth;
    dma_state(sh, par, i)[row * sh.plane + e] =
        sh.land[i][(2 * slot + side) * win + e];
  }
  grid.sync();
}
