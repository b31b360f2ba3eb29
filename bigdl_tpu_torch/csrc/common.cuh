// Shared helpers for the hand-written Hopper kernels: dtype codes that the
// Python wrappers pass through ctypes, f32 <-> storage conversions, and
// 2^x on the special-function unit.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bigdl {

// dtype codes, kept in step with bigdl_tpu_torch/ops/_build.py DTYPE_CODES
// (activations) and WEIGHT_CODES (packed weights: int8, e4m3)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF8E4M3 = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// Two floats rounded to bf16 in one 32-bit register (lo in the lower half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// 2^x on the special-function unit (what __expf uses after its scaling)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace bigdl
