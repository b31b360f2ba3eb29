// Register-tiled f32 products on FFMA, fed by a cp.async ring, shared by
// the f32 attention forward (attention.cu, K8/K9) and the f32 flash
// backward (flash_attention_bwd.cu, K10/K11).
//
// What bounds them on Hopper: an SM's shared memory hands out 128 bytes a
// clock, one 4-byte register a lane, against 128 FFMA lanes, so a product
// loop keeps FFMA fed only with 4 FFMA or more per register it loads.  So
// each thread owns a micro-tile of the product: `dots` sums an (outer x
// inner) tile over D from two row sets read as float2 (kAo + kAi loads for
// 2 kAo kAi FFMA: 8 x 8 gives 4 FFMA a loaded register), `outer` adds
// x^T y over N rows into a (kCo x kCc) accumulator from float4 reads.
// Rows are padded to D + 4 floats: 16-byte cp.async destinations stay
// aligned, and eight consecutive rows start on eight distinct 8-byte bank
// pairs, so a warp's loads that read 4 or 8 consecutive rows are free of
// bank conflicts.  `copy_rows` fills such rows with 16-byte cp.async.cg
// copies of every thread of the block (rows past the end zero-filled by a
// source size of 0); `copy_row` brings n floats (an lse, a delta, a bias)
// by 4-byte copies.  The tile structs of the kernels (C below) name the
// micro-tile's shape: kD, kLd (D + 4), kAo, kAi, kAog, kAig (a thread's
// outer rows lie kAog apart, its inner rows kAig apart) for `dots`; kCo,
// kCc, kVec, kCcg, kLdx (the x rows' pitch) for `outer`, `col_at` and
// `store_row` (a thread's columns come in groups of kVec, a kCcg kVec
// apart).
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace bigdl {
namespace ffma {

// a named barrier of n threads (id 0 is __syncthreads'): bar_arrive
// counts the thread in without waiting, bar_sync waits until all n have
// come; either orders the thread's earlier shared-memory writes before
// the barrier completes
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// n rows of D floats from row r0 of x into dst (rows of D + 4 floats) by
// 16-byte cp.async copies of every one of a block's kThreads threads; rows
// at or past `end` zero-filled
template <int D, int N, int kThreads>
__device__ __forceinline__ void copy_rows(float* dst, const float* x, int r0,
                                          int end) {
  constexpr int kChunks = D / 4;
  static_assert(N * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int n = 0; n < N * kChunks / kThreads; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r0 + r < end;
    wg::cp16(wg::smem_addr(dst + r * (D + 4) + 4 * c),
             x + (ok ? static_cast<long long>(r0 + r) * D + 4 * c : 0), ok);
  }
}

// n floats of x from r0 into dst by 4-byte cp.async copies of threads
// [t0, t0 + n); zeros at or past `end`
__device__ __forceinline__ void copy_row(float* dst, const float* x, int r0,
                                         int end, int t0, int n) {
  const int r = static_cast<int>(threadIdx.x) - t0;
  if (r >= 0 && r < n) {
    const bool ok = r0 + r < end;
    wg::cp4(wg::smem_addr(dst + r), x + (ok ? r0 + r : 0), ok);
  }
}

// x[i][j] = sum over d of a[i][d] b[j][d], the thread's outer rows at a +
// kAog i (D + 4) and inner rows at b + kAig j (D + 4), both read as float2
// along D: kAo + kAi loads for 2 kAo kAi FFMA, d in order
template <typename C>
__device__ __forceinline__ void dots(float (&x)[C::kAo][C::kAi],
                                     const float* a, const float* b) {
  constexpr int kLd = C::kLd;
#pragma unroll
  for (int i = 0; i < C::kAo; ++i)
#pragma unroll
    for (int j = 0; j < C::kAi; ++j) x[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < C::kD; d += 2) {
    float2 av[C::kAo], bv[C::kAi];
#pragma unroll
    for (int i = 0; i < C::kAo; ++i)
      av[i] = *reinterpret_cast<const float2*>(a + C::kAog * i * kLd + d);
#pragma unroll
    for (int j = 0; j < C::kAi; ++j)
      bv[j] = *reinterpret_cast<const float2*>(b + C::kAig * j * kLd + d);
#pragma unroll
    for (int i = 0; i < C::kAo; ++i)
#pragma unroll
      for (int j = 0; j < C::kAi; ++j) {
        x[i][j] = fmaf(av[i].x, bv[j].x, x[i][j]);
        x[i][j] = fmaf(av[i].y, bv[j].y, x[i][j]);
      }
  }
}

// acc[i][c] += sum over r < N of x[r][i] y[r][column c]: x rows at x + r
// kLdx, the thread's kCo outer indices read as float4 (float2 where kCo is
// 2); y rows at y + r (D + 4) from the thread's first column, its columns
// in groups of kVec a kCcg kVec apart.  kCo / 4 + kCc / kVec loads for kCo
// kCc FFMA, r in order
template <typename C, int N>
__device__ __forceinline__ void outer(float (&acc)[C::kCo][C::kCc],
                                      const float* x, const float* y) {
  constexpr int kCo = C::kCo, kCc = C::kCc, kV = C::kVec;
#pragma unroll 4
  for (int r = 0; r < N; ++r) {
    float xs[kCo], yv[kCc];
    if constexpr (kCo == 2) {
      const float2 t = *reinterpret_cast<const float2*>(x + r * C::kLdx);
      xs[0] = t.x, xs[1] = t.y;
    } else {
#pragma unroll
      for (int g = 0; g < kCo / 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(x + r * C::kLdx +
                                                          4 * g);
        xs[4 * g] = t.x, xs[4 * g + 1] = t.y, xs[4 * g + 2] = t.z,
        xs[4 * g + 3] = t.w;
      }
    }
#pragma unroll
    for (int g = 0; g < kCc / kV; ++g) {
      const float* at = y + r * C::kLd + g * C::kCcg * kV;
      if constexpr (kV == 4) {
        const float4 t = *reinterpret_cast<const float4*>(at);
        yv[4 * g] = t.x, yv[4 * g + 1] = t.y, yv[4 * g + 2] = t.z,
        yv[4 * g + 3] = t.w;
      } else if constexpr (kV == 2) {
        const float2 t = *reinterpret_cast<const float2*>(at);
        yv[2 * g] = t.x, yv[2 * g + 1] = t.y;
      } else {
        yv[g] = *at;
      }
    }
#pragma unroll
    for (int i = 0; i < kCo; ++i)
#pragma unroll
      for (int c = 0; c < kCc; ++c) acc[i][c] = fmaf(xs[i], yv[c], acc[i][c]);
  }
}

// the address of the thread's column group g in a row of D floats
template <typename C>
__device__ __forceinline__ int col_at(int cc, int g) {
  return g * C::kCcg * C::kVec + cc * C::kVec;
}

// one output row (D floats at out) from the thread's acc at its columns
template <typename C>
__device__ __forceinline__ void store_row(float* out,
                                          const float (&acc)[C::kCc],
                                          int cc) {
  constexpr int kV = C::kVec;
#pragma unroll
  for (int g = 0; g < C::kCc / kV; ++g) {
    float* at = out + col_at<C>(cc, g);
    if constexpr (kV == 4)
      *reinterpret_cast<float4*>(at) =
          make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2],
                      acc[4 * g + 3]);
    else if constexpr (kV == 2)
      *reinterpret_cast<float2*>(at) = make_float2(acc[2 * g], acc[2 * g + 1]);
    else
      *at = acc[g];
  }
}

}  // namespace ffma
}  // namespace bigdl
