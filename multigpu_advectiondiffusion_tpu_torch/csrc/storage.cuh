// The storage type of a kernel's global buffers, apart from the type it
// computes in (float32). The bf16 instances of K1, K2, K3, K4, K6 and K9
// (the TPU kernels' bf16-storage rung, compute_dtype = float32; K1 and
// K9 sharded too) load bf16,
// compute every tap and RK stage in float32 and round each stored value
// once, to nearest even; at T = float both functions are the identity,
// so the float32 instances compile to what they were.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
