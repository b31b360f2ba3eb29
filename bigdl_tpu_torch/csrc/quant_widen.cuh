// Widening packed weights without conversion instructions (they run at a
// fraction of the integer and f32 rate), shared by the bf16 K13/K15
// (quant_bf16.cuh) and the f32 ones (quant_matmul.cu): a small integer u
// goes exact into f32 as the bits 0x4B000000 | u, 2^23 + u, less a
// constant; an e4m3 byte's sign and exponent-mantissa bits placed in f32's,
// times 2^120 (which rebiases the exponent, subnormals included); bf16 is
// then f32's high half, exactly, since these values have at most 8
// significant bits.
#pragma once

#include <cstdint>

namespace bigdl {
namespace quant {

// byte i of u as 2^23 + byte, in f32
__device__ __forceinline__ float magic(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i));
}

// two f32 as bf16x2 (the low half from a), by their high halves
__device__ __forceinline__ uint32_t hi_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 4 biased bytes (b + bias each) of u to f32, exactly
__device__ __forceinline__ void biased4_f32(uint32_t u, float bias,
                                            float (&f)[4]) {
  const float k = 8388608.0f + bias;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = magic(u, i) - k;
}

// 4 biased bytes (b + bias each) of u to bf16, two words
__device__ __forceinline__ uint2 biased4(uint32_t u, float bias) {
  const float k = 8388608.0f + bias;
  return make_uint2(hi_halves(magic(u, 0) - k, magic(u, 1) - k),
                    hi_halves(magic(u, 2) - k, magic(u, 3) - k));
}

// e4m3 byte i of w to f32: 0x7F and 0xFF are NaN
__device__ __forceinline__ float e4m3(uint32_t w, int i) {
  const uint32_t t = __byte_perm(w, 0u, 0x0444 + (i << 12));  // byte << 24
  const float v = __uint_as_float((t & 0x80000000u) |
                                  ((t >> 4) & 0x07F00000u)) * 0x1p120f;
  return (t & 0x7F000000u) == 0x7F000000u ? __uint_as_float(0x7FC00000u)
                                          : v;
}

// 4 int8 bytes of u to f32 (b ^ 0x80 is b + 128)
__device__ __forceinline__ void int8x4_f32(uint32_t u, float (&f)[4]) {
  biased4_f32(u ^ 0x80808080u, 128.0f, f);
}

// 4 split-half nibble bytes of u to f32: the low nibbles into lo, the high
// ones into hi; a nibble n is two's complement, (n ^ 8) - 8
__device__ __forceinline__ void nibbles_f32(uint32_t u, float (&lo)[4],
                                            float (&hi)[4]) {
  biased4_f32((u & 0x0F0F0F0Fu) ^ 0x08080808u, 8.0f, lo);
  biased4_f32(((u >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.0f, hi);
}

}  // namespace quant
}  // namespace bigdl
