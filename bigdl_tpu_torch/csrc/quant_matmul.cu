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
// the K sum across sequential grid steps in VMEM.  Here nothing is padded
// in memory: blocks mask (or TMA zero-fills) the ragged edges.  The weight
// is widened inside the block (int8, e4m3 and int4 are exact in bf16 and
// f32), so no widened copy of it ever exists in device memory.
//
// What bounds them on the H100, at the path's shapes (Inception-v1's 55
// stride-1 convs as patch matrices and its classifier, batch 8 and 32):
// * bf16 x (K13, K15; the serving path): the convs' bytes.  A product
//   does 2 M N K operations on about 2 M (K + N) bytes, N K / (N + K) =
//   15-315 operations a byte, below the card's 295 for every conv but
//   inception_5b/3x3; conv2/3x3's x alone is 100,352 x 576 (116 MB).  The
//   classifier (M 8 or 32, K 1024, N 1000) moves 1 MB and is bound by
//   latency: a launch and one chain of K steps.  So the kernel
//   (quant_bf16.cuh) keeps x's bytes moving and the card full: TMA copies
//   x's tiles and the packed weight's into a 4-stage ring, wgmma runs on
//   them as they land, a block's N tile covers all of N up to 256 so x is
//   read once (two or four N tiles above, neighbours in the grid, the
//   second reading x from L2), and where M tiles x N tiles give fewer
//   blocks than the card's 132 SMs (the late stages, the classifier) the K
//   steps are split across blocks, whose f32 partial sums a second pass
//   (splitk_finish) adds in split order, scales and rounds once: no
//   atomics, so two launches are bit-equal.  The plan per shape (bm, bn,
//   splits) is ops/quant.py `bf16_plan`'s.  Measured, it runs at about
//   half of the bytes rate on the large convs: a block's step (widening,
//   products, a barrier) and its copies overlap only in part at one block
//   a streaming multiprocessor (PERF.md §6).
// * f32 x (K13/K15): FFMA throughput at 67 TFLOP/s; a 64x64 output tile
//   per 256-thread block, 4x4 outputs a thread, K in steps of 16 through
//   shared memory, fmaf in full f32 (no TF32), so it matches the
//   reference's full-f32 product;
// * K14: 64x64 tile, 4x4 int32 accumulators a thread, 4 bytes of K per
//   __dp4a, K in steps of 32 bytes.
// The f32 kernel and K14 are single-buffered: a simple right kernel first.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "quant_bf16.cuh"

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

// Weight decoders of the f32 kernel: element (n, k) of the widened (N, K)
// weight as float.
struct W8 {
  const int8_t* q;
  int k;
  __device__ __forceinline__ float at(int n, int kk) const {
    return static_cast<float>(q[static_cast<long long>(n) * k + kk]);
  }
};

struct WF8 {
  const uint8_t* q;
  int k;
  __device__ __forceinline__ float at(int n, int kk) const {
    return e4m3_to_f32(q[static_cast<long long>(n) * k + kk]);
  }
};

struct W4 {
  const int8_t* q;
  int k;
  int h;  // bytes per row, ceil(k / 2)
  __device__ __forceinline__ float at(int n, int kk) const {
    const bool low = kk < h;
    const int b = q[static_cast<long long>(n) * h + (low ? kk : kk - h)];
    const int v = low ? ((b & 15) ^ 8) - 8 : (((b >> 4) & 15) ^ 8) - 8;
    return static_cast<float>(v);
  }
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

// ---- bfloat16 x: the second pass of a split K -----------------------------

// y = (ws[0] + ws[1] + ... + ws[splits - 1]) * scale, rounded once to
// bf16, for the f32 partial sums ws (splits, total = m n) of
// quant_bf16.cuh's kernel; the splits are added in order, so the sum has a
// fixed order.  V outputs a thread: 4 where n % 4 == 0 and the pointers
// allow 16-byte loads (8-byte stores), else 1.
template <int V>
__global__ void splitk_finish(const float* __restrict__ ws,
                              const float* __restrict__ scale,
                              __nv_bfloat16* __restrict__ y, int total, int n,
                              int splits) {
  for (int i = V * (blockIdx.x * blockDim.x + threadIdx.x); i < total;
       i += V * gridDim.x * blockDim.x) {
    float v[V], w[V];
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(ws + i);
    } else {
      v[0] = ws[i];
    }
    for (int j = 1; j < splits; ++j) {
      const float* p = ws + static_cast<long long>(j) * total + i;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(w) = *reinterpret_cast<const float4*>(p);
      } else {
        w[0] = p[0];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] += w[e];
    }
    const int col = i % n;
    if constexpr (V == 4) {
      const float4 sc = *reinterpret_cast<const float4*>(scale + col);
      *reinterpret_cast<uint2*>(y + i) =
          make_uint2(bigdl::pack_bf16x2(v[0] * sc.x, v[1] * sc.y),
                     bigdl::pack_bf16x2(v[2] * sc.z, v[3] * sc.w));
    } else {
      y[i] = __float2bfloat16(v[0] * scale[col]);
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

inline unsigned int tiles(int total, int tile) {
  return static_cast<unsigned int>((total + tile - 1) / tile);
}

template <typename W>
int launch_f32(const void* x, W w, const void* scale, void* y, int m, int n,
               int k, cudaStream_t s) {
  dequant_mm_f32<W><<<dim3(tiles(n, kFBN), tiles(m, kFBM)), kFThreads, 0,
                      s>>>(static_cast<const float*>(x), w,
                           static_cast<const float*>(scale),
                           static_cast<float*>(y), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel of weight kind W with the plan (bm, bn, splits), then
// the second pass when the plan splits K.
template <typename W>
int run_bf16(const void* x, const void* q, const void* scale, void* y, int m,
             int n, int k, int bm, int bn, int splits, void* ws,
             cudaStream_t s) {
  using bigdl::quant::Bf16Args;
  if (k == 0)  // an empty sum
    return static_cast<int>(cudaMemsetAsync(
        y, 0, static_cast<size_t>(m) * n * sizeof(__nv_bfloat16), s));
  Bf16Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.q = static_cast<const uint8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.ws = static_cast<float*>(ws);
  a.m = m;
  a.n = n;
  a.k = k;
  a.bm = bm;
  a.bn = bn;
  a.splits = splits;
  const long long total = static_cast<long long>(m) * n;
  if (splits > 1 && total > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = bigdl::quant::launch_bf16<W>(a, s);
  if (rc != 0 || splits == 1) return rc;
  const bool vec = n % 4 == 0 && bigdl::quant::aligned_to(ws, 16) &&
                   bigdl::quant::aligned_to(scale, 16) &&
                   bigdl::quant::aligned_to(y, 8);
  const unsigned int blocks = bigdl::blocks_for(vec ? total / 4 : total);
  if (vec)
    splitk_finish<4><<<blocks, bigdl::kThreads, 0, s>>>(
        a.ws, a.scale, a.y, static_cast<int>(total), n, splits);
  else
    splitk_finish<1><<<blocks, bigdl::kThreads, 0, s>>>(
        a.ws, a.scale, a.y, static_cast<int>(total), n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K13: x (m, k) f32/bf16, q (n, k) int8 or e4m3, scale (n,) f32 -> y (m, n);
// bf16 with the plan (bm, bn, splits) and, when splits > 1, an f32
// workspace ws (splits, m, n) (f32 x takes neither)
extern "C" int bigdl_w8_matmul(const void* x, const void* q, const void* scale,
                               void* y, int xdtype, int wdtype, int m, int n,
                               int k, int bm, int bn, int splits, void* ws,
                               void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8 = wdtype == bigdl::kI8;
  if (!int8 && wdtype != bigdl::kF8E4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (xdtype == bigdl::kF32)
    return int8 ? launch_f32(x, W8{static_cast<const int8_t*>(q), k}, scale,
                             y, m, n, k, s)
                : launch_f32(x, WF8{static_cast<const uint8_t*>(q), k},
                             scale, y, m, n, k, s);
  if (xdtype != bigdl::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return int8 ? run_bf16<bigdl::quant::Int8>(x, q, scale, y, m, n, k, bm, bn,
                                             splits, ws, s)
              : run_bf16<bigdl::quant::E4m3>(x, q, scale, y, m, n, k, bm, bn,
                                             splits, ws, s);
}

// K15: x (m, k) f32/bf16, q4 (n, ceil(k/2)) split-half nibbles -> y (m, n);
// the plan and workspace as for K13
extern "C" int bigdl_w4_matmul(const void* x, const void* q4,
                               const void* scale, void* y, int xdtype, int m,
                               int n, int k, int bm, int bn, int splits,
                               void* ws, void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdtype == bigdl::kF32)
    return launch_f32(x, W4{static_cast<const int8_t*>(q4), k, (k + 1) / 2},
                      scale, y, m, n, k, s);
  if (xdtype != bigdl::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return run_bf16<bigdl::quant::Int4>(x, q4, scale, y, m, n, k, bm, bn,
                                      splits, ws, s);
}

// K14: xq (m, k) int8, q (n, k) int8, s = scale * sx (n,) f32 -> y (m, n)
extern "C" int bigdl_a8_matmul(const void* xq, const void* q, const void* s,
                               void* y, int ydtype, int m, int n, int k,
                               void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && bigdl::quant::aligned_to(xq, 4) &&
                   bigdl::quant::aligned_to(q, 4);
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
