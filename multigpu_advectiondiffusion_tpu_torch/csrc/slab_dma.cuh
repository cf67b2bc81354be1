// K4's ghost-row exchange inside the kernel, shared by its diffusion
// (csrc/fused_step_diffusion.cu) and Burgers (csrc/slab_run_burgers.cu)
// instances, and the job counters of the cooperative slab launches (K4
// both instances, K6/K2b Burgers).
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
// (pz = lz + 2 depth planes of `plane` values each) and a landing buffer
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
// Each phase moves 2 n depth planes, window by window, a grid-stride
// loop with neighbouring threads on neighbouring addresses (no division
// an element). No pointer is __restrict__: the state was written by other
// blocks in this launch.
//
// T is the buffers' storage type (storage.cuh): float, or __nv_bfloat16
// for the bf16 instances of K4, whose state and landing buffers are both
// bf16 (the TPU kernel's landing buffer has the state's dtype), so the
// exchange moves half the bytes. A copy moves the values' bits.

#pragma once

#include <cooperative_groups.h>

// shards a launch takes: the table below is a kernel argument
constexpr int DMA_MAX_SHARDS = 64;

// The shards of a z-slab mesh on this card, in z order.
template <typename T>
struct DmaShards {
  T* s0[DMA_MAX_SHARDS];    // state buffer of even steps' reads
  T* s1[DMA_MAX_SHARDS];    // ... and of odd steps'
  T* land[DMA_MAX_SHARDS];  // (2 slots, 2 sides, depth, plane)
  int n;                    // shards
  int pz, depth;            // buffer planes, ghost planes a side
  long long plane;          // values a plane
};

template <typename T>
__device__ __forceinline__ T* dma_state(const DmaShards<T>& sh, int par,
                                        int i) {
  return par ? sh.s1[i] : sh.s0[i];
}

// The push and the splice of block b, reading parity `par`: one window
// (shard, side) after another, each a grid-stride copy, 16 bytes a
// thread at a time (four floats, eight bf16 values) where a plane is a
// multiple of 16 bytes (so every window starts 16-byte aligned in
// buffers that are).
template <typename T>
__device__ void dma_exchange(const DmaShards<T>& sh, int par, int b,
                             cooperative_groups::grid_group& grid) {
  constexpr int PER16 = 16 / sizeof(T);  // values in 16 bytes
  const long long win = (long long)sh.depth * sh.plane;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int slot = b & 1;
  const bool vec = sh.plane % PER16 == 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int w = 0; w < 2 * sh.n; ++w) {
      const int i = w >> 1, side = w & 1;
      T* dst;
      const T* src;
      if (pass == 0) {  // push my core edge window to the neighbour
        const int to = side == 0 ? (i + 1) % sh.n : (i + sh.n - 1) % sh.n;
        const long long row = side == 0 ? sh.pz - 2 * sh.depth : sh.depth;
        dst = sh.land[to] + (2 * slot + side) * win;
        src = dma_state(sh, par, i) + row * sh.plane;
      } else {  // splice the landed window into my ghost rows
        if (side == 0 ? i == 0 : i == sh.n - 1) continue;  // a wall side
        const long long row = side == 0 ? 0 : sh.pz - sh.depth;
        dst = dma_state(sh, par, i) + row * sh.plane;
        src = sh.land[i] + (2 * slot + side) * win;
      }
      if (vec) {
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        for (long long q = first; q < win / PER16; q += stride)
          d4[q] = s4[q];
      } else {
        for (long long q = first; q < win; q += stride) dst[q] = src[q];
      }
    }
    grid.sync();
  }
}

// The job counters: two device ints, one a step parity, both zero at the
// launch. A block takes blockIdx.x first, then claims the next number
// from its step's counter (the claims start past gridDim.x).

// The next job of the block: a barrier (the block is done with the last
// one's shared memory), one claim on the step's counter, a barrier.
__device__ __forceinline__ int next_job(int* counter, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1) + gridDim.x;
  __syncthreads();
  return *slot;
}

// At the start of step k: reset the other parity's counter, last used by
// step k-1 and next by step k+1 (after this step's grid barrier).
__device__ __forceinline__ void reset_counter(int* counters, int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicExch(&counters[(k + 1) & 1], 0);
}
