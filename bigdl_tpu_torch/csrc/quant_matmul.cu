// The fused dequant-matmul family of quantized inference,
//     y[m, n] = (sum_k x[m, k] * widen(q[n, k])) * scale[n],
// with x (M, K) and the packed weight (N, K) both K-contiguous.
//
// K13 replaces bigdl_tpu/ops/quant.py `_w8_kernel` (reached through
// `_fused_call`, and for e4m3 weights through `_f8_pallas`): int8 or e4m3
// weights, float32 or bfloat16 x, f32 accumulation, the per-channel scale
// applied once on the output before the single rounding to x's dtype.
// K14 replaces `_a8_kernel`: int8 x int8 -> int32 (`__dp4a`), then
// float(acc) * s[n] with s = scale * sx from the wrapper; integer sums are
// exact, so it is bit-equal to its plain version.  K15 replaces
// `_w4_kernel`: split-half int4 nibbles (column k < h = ceil(K/2) is the low
// nibble of byte k, column k >= h the high nibble of byte k - h) decoded in
// place with ((b & 15) ^ 8) - 8, so x is never re-laid out; the TPU wrapper
// concatenated [x[:, :h] | x[:, h:]] padded to 128 lanes for Mosaic.
//
// The TPU kernels padded M/N/K to 128/128/512 tiles in memory and carried
// the K sum across sequential grid steps in VMEM.  Here each block owns one
// output tile, loops over K inside itself, and masks the ragged edges;
// nothing is padded in memory.  The weight is widened on its way into
// shared memory (int8 and e4m3 are exact in bf16 and f32), so no widened
// copy of it ever exists in device memory.
//
// Bound on the H100, from the path's shapes (Inception-v1 at batch 32: the
// convs' patch matrices, e.g. conv2/3x3's 100,352 x 576, dominate the bytes;
// the weights are small): bytes at 3.35 TB/s for bf16 x (the arithmetic at
// 989 TFLOP/s would take about a third of that), FFMA throughput at 67 TFLOP/s
// for f32 x.  The designs:
// * f32 x (K13/K15): 64x64 output tile per 256-thread block, 4x4 outputs a
//   thread, K in steps of 16 through shared memory, fmaf in full f32 (no
//   TF32), so it matches the reference's full-f32 product;
// * bf16 x (K13/K15): 128x64 tile, 8 warps of 32x32, mma.sync m16n8k16 bf16
//   with f32 accumulators on the exactly widened operands, K in steps of
//   32; x tiles come in 16-byte loads when K % 8 == 0;
// * K14: 64x64 tile, 4x4 int32 accumulators a thread, 4 bytes of K per
//   __dp4a, K in steps of 32 bytes.
// All tiles are single-buffered: a simple right kernel first; cp.async or
// TMA pipelining and wgmma are later work.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t exp = (b >> 3) & 15u;
  const uint32_t man = b & 7u;
  if (exp == 15u && man == 7u) return __int_as_float(0x7fc00000);  // NaN
  if (exp == 0u) {  // subnormal: man * 2^-9
    const float v = static_cast<float>(man) * 0.001953125f;
    return sign ? -v : v;
  }
  return __int_as_float(static_cast<int>(sign | ((exp + 120u) << 23) |
                                         (man << 20)));
}

// Weight decoders: element (n, k) of the widened (N, K) weight as float, and
// for int8/e4m3 eight K-consecutive elements at once (k % 8 == 0).
struct W8 {
  static constexpr bool kVec = true;
  const int8_t* q;
  int k;
  __device__ __forceinline__ float at(int n, int kk) const {
    return static_cast<float>(q[static_cast<long long>(n) * k + kk]);
  }
  __device__ __forceinline__ void load8(int n, int kk, float* f) const {
    const uint2 v =
        *reinterpret_cast<const uint2*>(q + static_cast<long long>(n) * k + kk);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = static_cast<float>(b[j]);
  }
};

struct WF8 {
  static constexpr bool kVec = true;
  const uint8_t* q;
  int k;
  __device__ __forceinline__ float at(int n, int kk) const {
    return e4m3_to_f32(q[static_cast<long long>(n) * k + kk]);
  }
  __device__ __forceinline__ void load8(int n, int kk, float* f) const {
    const uint2 v =
        *reinterpret_cast<const uint2*>(q + static_cast<long long>(n) * k + kk);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = e4m3_to_f32(b[j]);
  }
};

struct W4 {
  static constexpr bool kVec = false;
  const int8_t* q;
  int k;
  int h;  // bytes per row, ceil(k / 2)
  __device__ __forceinline__ float at(int n, int kk) const {
    const bool low = kk < h;
    const int b = q[static_cast<long long>(n) * h + (low ? kk : kk - h)];
    const int v = low ? ((b & 15) ^ 8) - 8 : (((b >> 4) & 15) ^ 8) - 8;
    return static_cast<float>(v);
  }
  __device__ __forceinline__ void load8(int, int, float*) const {}
};

// ---- float32 x: FFMA ---------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16, kFThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kFThreads)
    dequant_mm_f32(const float* __restrict__ x, W w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int m, int n, int k) {
  __shared__ float xs[kFBK][kFBM + 4];
  __shared__ float ws[kFBK][kFBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kFBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kFThreads;  // 64 rows x 16 k
      const int r = e >> 4, c = e & 15;
      const int gk = k0 + c, gm = m0 + r, gn = n0 + r;
      xs[c][r] = (gm < m && gk < k) ? x[static_cast<long long>(gm) * k + gk]
                                    : 0.0f;
      ws[c][r] = (gn < n && gk < k) ? w.at(gn, gk) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) y[static_cast<long long>(gm) * n + gn] = acc[i][j] * scale[gn];
    }
  }
}

// ---- bfloat16 x: mma.sync m16n8k16 -------------------------------------------

constexpr int kMBM = 128, kMBN = 64, kMBK = 32, kMThreads = 256;
constexpr int kMStride = kMBK + 8;  // bf16 per smem row: 80 bytes, no conflicts

using bigdl::ld32;
using bigdl::mma_bf16;
using bigdl::pack_bf16x2;

template <typename W>
__global__ void __launch_bounds__(kMThreads)
    dequant_mm_bf16(const __nv_bfloat16* __restrict__ x, W w,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ y, int m, int n, int k,
                    bool vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[kMBM * kMStride];
  __shared__ __align__(16) __nv_bfloat16 ws[kMBN * kMStride];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kMBM, n0 = blockIdx.x * kMBN;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kMBK) {
    if (vec) {  // 128 rows x 4 chunks of 8 bf16
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * kMThreads;
        const int r = e >> 2, c = (e & 3) * 8;
        const int gm = m0 + r, gk = k0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < m && gk < k)
          v = *reinterpret_cast<const uint4*>(
              x + static_cast<long long>(gm) * k + gk);
        *reinterpret_cast<uint4*>(xs + r * kMStride + c) = v;
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int e = tid + i * kMThreads;
        const int r = e >> 5, c = e & 31;
        const int gm = m0 + r, gk = k0 + c;
        xs[r * kMStride + c] =
            (gm < m && gk < k) ? x[static_cast<long long>(gm) * k + gk] : zero;
      }
    }
    if (W::kVec && vec) {  // 64 rows x 4 chunks of 8 weights
      const int r = tid >> 2, c = (tid & 3) * 8;
      const int gn = n0 + r, gk = k0 + c;
      float f[8];
      if (gn < n && gk < k) {
        w.load8(gn, gk, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.0f;
      }
      *reinterpret_cast<uint4*>(ws + r * kMStride + c) =
          make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                     pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
    } else {
#pragma unroll 4
      for (int i = 0; i < 8; ++i) {
        const int e = tid + i * kMThreads;
        const int r = e >> 5, c = e & 31;
        const int gn = n0 + r, gk = k0 + c;
        ws[r * kMStride + c] =
            __float2bfloat16((gn < n && gk < k) ? w.at(gn, gk) : 0.0f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMBK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p =
            xs + (wm * 32 + mi * 16 + g) * kMStride + ks + 2 * t;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kMStride);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * kMStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p =
            ws + (wn * 32 + ni * 8 + g) * kMStride + ks + 2 * t;
        b[ni][0] = ld32(p);
        b[ni][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }
  // accumulator (mi, ni, j): row g (+8 for j >= 2), column 2t + (j & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gm = m0 + wm * 32 + mi * 16 + g + (j >> 1) * 8;
        const int gn = n0 + wn * 32 + ni * 8 + 2 * t + (j & 1);
        if (gm < m && gn < n)
          y[static_cast<long long>(gm) * n + gn] =
              __float2bfloat16(acc[mi][ni][j] * scale[gn]);
      }
    }
  }
}

// ---- K14: int8 x int8 -> int32 -----------------------------------------------

constexpr int kABM = 64, kABN = 64, kAWords = 8, kAThreads = 256;  // 32 B of K

__device__ __forceinline__ int load_word(const int8_t* __restrict__ p, int row,
                                         int rows, int gk, int k, bool vec) {
  if (row >= rows || gk >= k) return 0;
  const long long at = static_cast<long long>(row) * k + gk;
  if (vec) return *reinterpret_cast<const int*>(p + at);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (gk + j < k) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[at + j]))
                         << (8 * j);
  return static_cast<int>(v);
}

template <typename TY>
__global__ void __launch_bounds__(kAThreads)
    a8_mm(const int8_t* __restrict__ xq, const int8_t* __restrict__ q,
          const float* __restrict__ s, TY* __restrict__ y, int m, int n, int k,
          bool vec) {
  __shared__ int xs[kABM][kAWords + 1];
  __shared__ int ws[kABN][kAWords + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kABM, n0 = blockIdx.x * kABN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < k; k0 += 4 * kAWords) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kAThreads;  // 64 rows x 8 words
      const int r = e >> 3, wd = e & 7;
      const int gk = k0 + 4 * wd;
      xs[r][wd] = load_word(xq, m0 + r, m, gk, k, vec);
      ws[r][wd] = load_word(q, n0 + r, n, gk, k, vec);
    }
    __syncthreads();
#pragma unroll
    for (int wd = 0; wd < kAWords; ++wd) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][wd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][wd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n)
        y[static_cast<long long>(gm) * n + gn] = bigdl::from_f32<TY>(
            static_cast<float>(acc[i][j]) * s[gn]);
    }
  }
}

inline bool aligned(const void* p, unsigned int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline unsigned int tiles(int total, int tile) {
  return static_cast<unsigned int>((total + tile - 1) / tile);
}

template <typename W>
int launch_dequant(const void* x, W w, const void* scale, void* y, int xdtype,
                   int m, int n, int k, bool vec, cudaStream_t s) {
  const float* sc = static_cast<const float*>(scale);
  if (xdtype == bigdl::kF32) {
    dequant_mm_f32<W><<<dim3(tiles(n, kFBN), tiles(m, kFBM)), kFThreads, 0,
                        s>>>(static_cast<const float*>(x), w, sc,
                             static_cast<float*>(y), m, n, k);
  } else if (xdtype == bigdl::kBF16) {
    dequant_mm_bf16<W><<<dim3(tiles(n, kMBN), tiles(m, kMBM)), kMThreads, 0,
                         s>>>(static_cast<const __nv_bfloat16*>(x), w, sc,
                              static_cast<__nv_bfloat16*>(y), m, n, k, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K13: x (m, k) f32/bf16, q (n, k) int8 or e4m3, scale (n,) f32 -> y (m, n)
extern "C" int bigdl_w8_matmul(const void* x, const void* q, const void* scale,
                               void* y, int xdtype, int wdtype, int m, int n,
                               int k, void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 8 == 0 && aligned(x, 16) && aligned(q, 8);
  if (wdtype == bigdl::kI8)
    return launch_dequant(x, W8{static_cast<const int8_t*>(q), k}, scale, y,
                          xdtype, m, n, k, vec, s);
  if (wdtype == bigdl::kF8E4M3)
    return launch_dequant(x, WF8{static_cast<const uint8_t*>(q), k}, scale, y,
                          xdtype, m, n, k, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K15: x (m, k) f32/bf16, q4 (n, ceil(k/2)) split-half nibbles -> y (m, n)
extern "C" int bigdl_w4_matmul(const void* x, const void* q4,
                               const void* scale, void* y, int xdtype, int m,
                               int n, int k, void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const bool vec = k % 8 == 0 && aligned(x, 16);
  return launch_dequant(x, W4{static_cast<const int8_t*>(q4), k, (k + 1) / 2},
                        scale, y, xdtype, m, n, k, vec,
                        static_cast<cudaStream_t>(stream));
}

// K14: xq (m, k) int8, q (n, k) int8, s = scale * sx (n,) f32 -> y (m, n)
extern "C" int bigdl_a8_matmul(const void* xq, const void* q, const void* s,
                               void* y, int ydtype, int m, int n, int k,
                               void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && aligned(xq, 4) && aligned(q, 4);
  const dim3 grid(tiles(n, kABN), tiles(m, kABM));
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(s);
  if (ydtype == bigdl::kF32) {
    a8_mm<float><<<grid, kAThreads, 0, st>>>(a, b, sc, static_cast<float*>(y),
                                             m, n, k, vec);
  } else if (ydtype == bigdl::kBF16) {
    a8_mm<__nv_bfloat16><<<grid, kAThreads, 0, st>>>(
        a, b, sc, static_cast<__nv_bfloat16*>(y), m, n, k, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
