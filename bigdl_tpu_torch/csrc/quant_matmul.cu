// The fused dequant-matmul family of quantized inference,
//     y[m, n] = (sum_k x[m, k] * widen(q[n, k])) * scale[n],
// with x (M, K) and the packed weight (N, K) both K-contiguous.
//
// K13 replaces bigdl_tpu/ops/quant.py `_w8_kernel` (reached through
// `_fused_call`, and for e4m3 weights through `_f8_pallas`): int8 or e4m3
// weights, float32 or bfloat16 x, f32 accumulation, the per-channel scale
// applied once on the output before the single rounding to x's dtype.
// K14 replaces `_a8_kernel`: int8 x int8 -> int32 on the int8 tensor cores,
// then float(acc) * s[n] with s = scale * sx from the wrapper; integer sums
// are exact, so it is bit-equal to its plain version.  K15 replaces
// `_w4_kernel`: split-half int4 nibbles (column k < h = ceil(K/2) is the low
// nibble of byte k, column k >= h the high nibble of byte k - h) decoded in
// place with ((b & 15) ^ 8) - 8, so x is never re-laid out; the TPU wrapper
// concatenated [x[:, :h] | x[:, h:]] padded to 128 lanes for Mosaic.
//
// The TPU kernels padded M/N/K to 128/128/512 tiles in memory and carried
// the K sum across sequential grid steps in VMEM.  Here nothing is padded
// in memory: blocks mask (or zero-fill) the ragged edges.  The weight is
// widened inside the block (int8, e4m3 and int4 are exact in bf16 and f32)
// with the integer and f32-add tricks of quant_widen.cuh, never by a
// conversion instruction per product, so no widened copy of it ever exists
// in device memory.  Where the tiles give fewer blocks than the card has
// SMs, K is split across blocks; the plans per shape are ops/quant.py's
// `bf16_plan`, `f32_plan` and `a8_plan`.
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
//   atomics, so two launches are bit-equal.  Measured, it runs at about
//   half of the bytes rate on the large convs: a block's step (widening,
//   products, a barrier) and its copies overlap only in part at one block
//   a streaming multiprocessor (PERF.md §6).
// * f32 x (K13 with int8 or e4m3 weights, K15; the default quantized
//   classifier's path): FFMA's rate, 67 TFLOP/s in full f32 (no TF32: the
//   reference's product is f32), for every conv but the narrow 1x1s (N
//   16-48, bound by x's bytes), and as much what shared memory hands the
//   FFMA units: 128 bytes a clock an SM, one 4-byte register a lane,
//   against 128 FFMA lanes, so a product loop keeps pace only at 4 FFMA or
//   more per register it loads.  One kernel, f32_mm, for the three weight
//   kinds: 128 threads, up to three blocks an SM (168 registers), each
//   thread an 8 x 8 micro-tile (8 x 4 in the 32-column tile), read as
//   float4 along K from rows padded to 20 floats: 16 loads for 256 FFMA, 4
//   FFMA a loaded register, with no bank conflicts.  Block tiles of 64 x
//   128, 128 x 64 or 128 x 32 (the plan takes the one with the least
//   padding, so the 1x1 convs with N 16-48 compute little of it), K steps
//   of 16 weight columns (int4: 8 packed bytes, the low nibbles against
//   x's columns [j, j + 8), the high ones against [h + j, h + j + 8)).  x's
//   tile and the packed weight's bytes come through a 3-stage ring of
//   cp.async copies (16-byte where K % 4 == 0 and x is 16-byte aligned,
//   else 4-byte; the weight in 16-, 8- or 4-byte pieces as its rows allow,
//   or byte by byte), two steps ahead of the products; once a step has
//   landed, the block widens its packed bytes once into an f32 tile, then
//   runs the step's products.  The output tile goes out through shared
//   memory in float4 rows.  Split K (the plan fills two blocks an SM)
//   writes f32 partial sums that splitk_finish adds in split order, as
//   for bf16.  Measured (PERF.md §6), the product loops alone run at about
//   60 % of FFMA's rate and the copies cost a further fifth: both feed on
//   the SM's shared memory; larger micro-tiles (8 x 12, 8 x 16, with fewer
//   blocks an SM), x by TMA and one barrier a step were no faster.
// * K14: latency (the classifier moves 1 MB; its int8 operations take
//   0.03 us at the tensor cores' 1,979 TOPS).  So it runs on the int8
//   tensor cores (wgmma m64nNk32 s32.s8.s8, both operands K-major in
//   shared memory, as x (M, K) and q (N, K) already are), one warpgroup a
//   64-row block, an N tile of 64, 128 or 256, 128-byte K steps through a
//   4-stage ring of 16-byte cp.async copies into the 128-byte swizzled
//   layout (4- or 1-byte pieces where K % 16 != 0 or a row is not 16-byte
//   aligned), and splits K so that the classifier's blocks reach the card's
//   SMs.  A split's int32 partial sums go to a workspace; the last block of
//   an output tile, found by an atomic ticket, adds them in split order,
//   scales and stores, in the same launch (a second launch would add a
//   launch's latency to a kernel bound by latency).
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "quant_bf16.cuh"
#include "quant_widen.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = bigdl::wg;
using bigdl::quant::aligned_to;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 8 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read, but must still be a mapped address)
__device__ __forceinline__ void cp8(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// ---- float32 x: register-tiled FFMA fed by a cp.async ring -----------------

constexpr int kFThreads = 128, kFStages = 3;
constexpr int kFK = 16;        // weight columns a K step
constexpr int kFLd = kFK + 4;  // floats a staged row of x or of the widened
                               // weight (16-byte aligned; 5 bank groups on)
constexpr int kFTM = 8;        // rows of a thread's micro-tile

// f32 weight kinds: x's column halves a K step (int4's low and high
// nibbles) and the widening of 4 packed bytes into 4 floats a half
struct FInt8 {
  static constexpr int kHalves = 1;
  __device__ static __forceinline__ void widen(uint32_t u, float (&f)[1][4]) {
    bigdl::quant::int8x4_f32(u, f[0]);
  }
};

struct FE4m3 {
  static constexpr int kHalves = 1;
  __device__ static __forceinline__ void widen(uint32_t u, float (&f)[1][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[0][i] = bigdl::quant::e4m3(u, i);
  }
};

struct FInt4 {
  static constexpr int kHalves = 2;
  __device__ static __forceinline__ void widen(uint32_t u, float (&f)[2][4]) {
    bigdl::quant::nibbles_f32(u, f[0], f[1]);
  }
};

struct F32Args {
  const float* x;      // (m, k)
  const uint8_t* q;    // (n, row_bytes) packed
  const float* scale;  // (n,)
  float* y;            // (m, n)
  float* ws;           // (splits, m, n) partial sums when splits > 1
  int m, n, k, splits;
  // ---- derived by run_f32
  int row_bytes;  // packed bytes a row: k, or h = ceil(k / 2) for int4
  int steps;      // K steps in all
  int per;        // K steps a split
  int wvec;       // bytes a piece of the weight's copies: 16, 8, 4 or 1
  bool xvec;      // x by 16-byte copies (else 4-byte)
};

// A block of 128 threads owns rows [m0, m0 + kBM) and columns [n0, n0 +
// kBN) over K steps [first, first + per).  Its threads are kLM x LN lanes,
// a warp 4 x 8 of them; thread (ao, ai) holds rows ao + kLM i (i < 8) and
// columns ai + LN j (j < TN), each read as float4 along K: a quarter-warp's
// loads of x read one row (a broadcast), of the weight 8 consecutive rows
// 20 floats apart (distinct bank groups).  Shared memory: x's ring
// [stage][kBM][kFLd], the widened weight [kBN][kFLd], the packed weight's
// ring [stage][kBN][kCols]; at the end, the output tile [kBM][kBN + 8]
// over all of it, stored by rows in float4 pieces.
template <typename W, int TN, int LN>
__global__ void __launch_bounds__(kFThreads, 3) f32_mm(const F32Args a) {
  constexpr int kLM = kFThreads / LN;
  constexpr int kBM = kFTM * kLM, kBN = TN * LN;
  constexpr int kCols = kFK / W::kHalves;  // x columns a half, packed bytes
                                           // of a row a step
  constexpr int kXChunks = kBM * kFK / 4;  // 16-byte units of a step's x
  constexpr int kWords = kBN * kCols / 4;  // 4-byte words of its weight
  constexpr int kLdy = kBN + 8;            // floats a staged output row
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;
  float* wt = xs + kFStages * kBM * kFLd;
  unsigned char* raw = reinterpret_cast<unsigned char*>(wt + kBN * kFLd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ao = warp / (LN / 8) * 4 + lane / 8;
  const int ai = warp % (LN / 8) * 8 + lane % 8;
  const int n_tiles = (a.n + kBN - 1) / kBN;
  const int m0 = blockIdx.x / n_tiles * kBM, n0 = blockIdx.x % n_tiles * kBN;
  const int first = blockIdx.y * a.per;
  const int n_iter = min(a.steps - first, a.per);

  // step it's x tile and packed weight into ring stage it % kFStages: x
  // columns [half ? h : 0) + step kCols, + kCols) a half, zeros past m and
  // past the half's end (int4's low half ends at h); the weight's bytes
  // [step kCols, + kCols) of rows n0.., zeros past n and row_bytes
  auto load = [&](int it) {
    const int s = it % kFStages, step = first + it;
    float* xd = xs + s * kBM * kFLd;
#pragma unroll 1  // unrolled, its addresses take registers the products need
    for (int j = 0; j < kXChunks / kFThreads; ++j) {
      const int e = tid + j * kFThreads;
      const int r = e / (kFK / 4), c = e % (kFK / 4);
      const int hf = c / (kCols / 4);
      const int col = (hf ? a.row_bytes : 0) + step * kCols +
                      4 * (c % (kCols / 4));
      const int end = W::kHalves == 2 && !hf ? a.row_bytes : a.k;
      const int gm = m0 + r;
      const float* src = a.x + static_cast<long long>(gm) * a.k + col;
      const uint32_t dst = wg::smem_addr(xd + r * kFLd + 4 * c);
      if (a.xvec) {
        const bool ok = gm < a.m && col < end;
        wg::cp16(dst, ok ? src : a.x, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = gm < a.m && col + i < end;
          wg::cp4(dst + 4 * i, ok ? src + i : a.x, ok);
        }
      }
    }
    unsigned char* rd = raw + s * kBN * kCols;
    const int cb = step * kCols;
    if (a.wvec == 1) {  // rows not 4-byte aligned: byte by byte
      for (int u = tid; u < kWords; u += kFThreads) {
        const int r = u / (kCols / 4), c = 4 * (u % (kCols / 4));
        const int gn = n0 + r;
        const uint8_t* row = a.q + static_cast<long long>(gn) * a.row_bytes;
        uint32_t v = 0;
        for (int i = 0; i < 4; ++i)
          if (gn < a.n && cb + c + i < a.row_bytes)
            v |= static_cast<uint32_t>(row[cb + c + i]) << (8 * i);
        *reinterpret_cast<uint32_t*>(rd + r * kCols + c) = v;
      }
      return;
    }
    const int pieces = kCols / a.wvec;  // a row's pieces a step
    for (int u = tid; u < kBN * pieces; u += kFThreads) {
      const int r = u / pieces, c = a.wvec * (u % pieces);
      const int gn = n0 + r, gc = cb + c;
      const bool ok = gn < a.n && gc < a.row_bytes;  // whole or absent
      const uint8_t* src =
          ok ? a.q + static_cast<long long>(gn) * a.row_bytes + gc : a.q;
      const uint32_t dst = wg::smem_addr(rd + r * kCols + c);
      if (a.wvec == 16)
        wg::cp16(dst, src, ok);
      else if (a.wvec == 8)
        cp8(dst, src, ok);
      else
        wg::cp4(dst, src, ok);
    }
  };

#pragma unroll 1
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < n_iter) load(s);
    wg::cp_commit();
  }
  float acc[kFTM][TN];
#pragma unroll
  for (int i = 0; i < kFTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kFStages;
    wg::cp_wait<kFStages - 2>();  // this thread's copies of step it
    __syncthreads();  // everyone's; and step it - 1's products are done
    if (it + kFStages - 1 < n_iter) load(it + kFStages - 1);
    wg::cp_commit();
    // widen the step's packed bytes once into the f32 tile
    const unsigned char* rs = raw + s * kBN * kCols;
    for (int u = tid; u < kWords; u += kFThreads) {
      const int r = u / (kCols / 4), c = 4 * (u % (kCols / 4));
      float f[W::kHalves][4];
      W::widen(*reinterpret_cast<const uint32_t*>(rs + r * kCols + c), f);
#pragma unroll
      for (int hf = 0; hf < W::kHalves; ++hf)
        *reinterpret_cast<float4*>(wt + r * kFLd + hf * kCols + c) =
            make_float4(f[hf][0], f[hf][1], f[hf][2], f[hf][3]);
    }
    __syncthreads();
    const float* xr = xs + s * kBM * kFLd + ao * kFLd;
    const float* wr = wt + ai * kFLd;
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 4) {
      float4 av[kFTM], bv[TN];
#pragma unroll
      for (int i = 0; i < kFTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(xr + i * kLM * kFLd + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(wr + j * LN * kFLd + kk);
#pragma unroll
      for (int i = 0; i < kFTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
  }

  // one split: y = acc * scale; several: this split's partial sums.  The
  // tile goes through shared memory (rows of kBN + 8 floats: a warp's
  // writes hit distinct banks), then out by rows, 4 floats a store where
  // n % 4 == 0
  float* out = a.splits > 1
                   ? a.ws + static_cast<long long>(blockIdx.y) * a.m * a.n
                   : a.y;
  wg::cp_wait<0>();
  __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = n0 + ai + LN * j;
    const float sc = a.splits == 1 && gc < a.n ? a.scale[gc] : 1.0f;
#pragma unroll
    for (int i = 0; i < kFTM; ++i)
      fsm[(ao + i * kLM) * kLdy + ai + LN * j] = acc[i][j] * sc;
  }
  __syncthreads();
  const bool vec = (a.n & 3) == 0;
  for (int e = tid; e < kBM * (kBN / 4); e += kFThreads) {
    const int r = e / (kBN / 4), c = 4 * (e % (kBN / 4));
    const int gm = m0 + r, gc = n0 + c;
    if (gm >= a.m || gc >= a.n) continue;
    const float4 v = *reinterpret_cast<const float4*>(fsm + r * kLdy + c);
    float* dst = out + static_cast<long long>(gm) * a.n + gc;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float* v4 = reinterpret_cast<const float*>(&v);
      for (int i = 0; i < 4 && gc + i < a.n; ++i) dst[i] = v4[i];
    }
  }
}

// ---- the second pass of a split K (f32 and bf16 x) --------------------------

__device__ __forceinline__ void store4(float* y, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(y) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(y) =
      make_uint2(bigdl::pack_bf16x2(a, b), bigdl::pack_bf16x2(c, d));
}

// y = (ws[0] + ws[1] + ... + ws[splits - 1]) * scale, rounded once to TY,
// for the f32 partial sums ws (splits, total = m n) of the f32 kernel or
// quant_bf16.cuh's; the splits are added in order, so the sum has a fixed
// order.  V outputs a thread: 4 where n % 4 == 0 and the pointers allow
// 16-byte loads (and 4-output stores), else 1.
template <int V, typename TY>
__global__ void splitk_finish(const float* __restrict__ ws,
                              const float* __restrict__ scale,
                              TY* __restrict__ y, int total, int n,
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
      store4(y + i, v[0] * sc.x, v[1] * sc.y, v[2] * sc.z, v[3] * sc.w);
    } else {
      y[i] = bigdl::from_f32<TY>(v[0] * scale[col]);
    }
  }
}

template <typename TY>
int finish_splits(const float* ws, const float* scale, TY* y, int total,
                  int n, int splits, cudaStream_t s) {
  const bool vec = n % 4 == 0 && aligned_to(ws, 16) && aligned_to(scale, 16) &&
                   aligned_to(y, 4 * sizeof(TY));
  const unsigned int blocks = bigdl::blocks_for(vec ? total / 4 : total);
  if (vec)
    splitk_finish<4, TY><<<blocks, bigdl::kThreads, 0, s>>>(ws, scale, y,
                                                            total, n, splits);
  else
    splitk_finish<1, TY><<<blocks, bigdl::kThreads, 0, s>>>(ws, scale, y,
                                                            total, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// the empty sum (k == 0)
int zeros(void* y, int m, int n, size_t elem, cudaStream_t s) {
  return static_cast<int>(
      cudaMemsetAsync(y, 0, static_cast<size_t>(m) * n * elem, s));
}

// checks a plan's splits against its steps and derives the steps a split
int split_steps(int steps, int splits, const void* ws) {
  if (splits < 1 || steps == 0 || (splits > 1 && !ws)) return -1;
  const int per = cdiv(steps, splits);
  return (splits - 1) * per >= steps ? -1 : per;  // no empty split
}

// the f32 kernel at block tile (bm, TN LN), if bm is its height
template <typename W, int TN, int LN>
cudaError_t launch_f32_tile(const F32Args& a, int bm, cudaStream_t s) {
  constexpr int kBM = kFTM * (kFThreads / LN), kBN = TN * LN;
  constexpr int kRing = 4 * (kFStages * kBM * kFLd + kBN * kFLd) +
                        kFStages * kBN * (kFK / W::kHalves);
  constexpr int kOut = 4 * kBM * (kBN + 8);  // the staged output tile
  constexpr int kBytes = kRing > kOut ? kRing : kOut;
  if (bm != kBM) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      f32_mm<W, TN, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  f32_mm<W, TN, LN><<<dim3(cdiv(a.m, kBM) * cdiv(a.n, kBN), a.splits),
                      kFThreads, kBytes, s>>>(a);
  return cudaGetLastError();
}

// The f32 kernel of weight kind W with the plan (bm, bn, splits), then the
// second pass when the plan splits K.
template <typename W>
int run_f32(const void* x, const void* q, const void* scale, void* y, int m,
            int n, int k, int bm, int bn, int splits, void* ws,
            cudaStream_t s) {
  if (k == 0) return zeros(y, m, n, sizeof(float), s);
  F32Args a{};
  a.x = static_cast<const float*>(x);
  a.q = static_cast<const uint8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.ws = static_cast<float*>(ws);
  a.m = m;
  a.n = n;
  a.k = k;
  a.splits = splits;
  constexpr int kCols = kFK / W::kHalves;
  a.row_bytes = W::kHalves == 2 ? (k + 1) / 2 : k;
  a.steps = cdiv(a.row_bytes, kCols);
  a.per = split_steps(a.steps, splits, ws);
  const long long total = static_cast<long long>(m) * n;
  if (a.per < 0 || (splits > 1 && total > INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  a.wvec = 1;
  for (int v = kCols < 16 ? kCols : 16; v >= 4; v /= 2)
    if (a.row_bytes % v == 0 && aligned_to(q, v)) {
      a.wvec = v;
      break;
    }
  // a 16-byte unit of a half is whole or absent: int4's halves end at h
  a.xvec = k % 4 == 0 && a.row_bytes % 4 == 0 && aligned_to(x, 16);
  cudaError_t e = cudaErrorInvalidValue;
  if (bn == 128)
    e = launch_f32_tile<W, 8, 16>(a, bm, s);
  else if (bn == 64)
    e = launch_f32_tile<W, 8, 8>(a, bm, s);
  else if (bn == 32)
    e = launch_f32_tile<W, 4, 8>(a, bm, s);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return finish_splits(a.ws, a.scale, a.y, static_cast<int>(total), n,
                       splits, s);
}

// The bf16 kernel of weight kind W with the plan (bm, bn, splits), then
// the second pass when the plan splits K.
template <typename W>
int run_bf16(const void* x, const void* q, const void* scale, void* y, int m,
             int n, int k, int bm, int bn, int splits, void* ws,
             cudaStream_t s) {
  using bigdl::quant::Bf16Args;
  if (k == 0) return zeros(y, m, n, sizeof(__nv_bfloat16), s);
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
  return finish_splits(a.ws, a.scale, a.y, static_cast<int>(total), n,
                       splits, s);
}

// ---- K14: int8 x int8 -> int32 on the tensor cores --------------------------

constexpr int kAStep = 128;     // bytes of K a step: a 128-byte tile row
constexpr int kAStages = 4;
constexpr int kAThreads = 128;  // one warpgroup: 64 rows a block

struct A8Args {
  const int8_t* x;  // (m, k)
  const int8_t* q;  // (n, k)
  const float* s;   // (n,) scale * sx
  void* y;          // (m, n) f32 or bf16
  int* ws;          // (splits, m, n) int32 partial sums when splits > 1
  int* tickets;     // one counter an output tile, 0 between launches
  int m, n, k, splits;
  // ---- derived by bigdl_a8_matmul
  int steps, per;
  int copy;         // bytes a piece of the copies: 16, 4 or 1
  bool pairs;       // y 16-byte aligned (f32; bf16 8), n even: 2-output
                    // stores (4-output in the split sum where n % 4 == 0)
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bigdl::pack_bf16x2(a, b);
}

// A block owns rows [m0, m0 + 64) and columns [n0, n0 + BN) over K steps
// [first, first + per).  A ring stage holds the step's 64 x rows, then its
// BN weight rows, 128 bytes each in the 128-byte swizzle (wgmma.cuh's
// Tile<64>, which TMA's SWIZZLE_128B would write); each k32 product reads
// 32 bytes of every row.
template <typename TY, int BN>
__global__ void __launch_bounds__(kAThreads) a8_wgmma(const A8Args a) {
  using T = wg::Tile<64>;
  constexpr int kX = 64 * kAStep, kStage = (64 + BN) * kAStep;
  constexpr int kUnits = (64 + BN) * (kAStep / 16);  // 16-byte units a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t raw0 = wg::smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const int tid = threadIdx.x;
  const int n_tiles = (a.n + BN - 1) / BN;
  const int m0 = blockIdx.x / n_tiles * 64, n0 = blockIdx.x % n_tiles * BN;
  const int first = blockIdx.y * a.per;
  const int n_iter = min(a.steps - first, a.per);

  // step it's rows into ring stage it % kAStages (zeros past m, n and k):
  // unit e is row e / 8 of the stage (x rows, then weight rows), bytes
  // [16 (e % 8), + 16) of the step, at its swizzled place
  auto load = [&](int it) {
    const int kb = (first + it) * kAStep;
    const int st = (it % kAStages) * kStage;
#pragma unroll
    for (int j = 0; j < kUnits / kAThreads; ++j) {
      const int e = tid + j * kAThreads;
      const int r = e / (kAStep / 16), c = 16 * (e % (kAStep / 16));
      const bool isx = r < 64;
      const int8_t* src0 = isx ? a.x : a.q;
      const int g = isx ? m0 + r : n0 + r - 64;
      const int rows = isx ? a.m : a.n;
      const int gc = kb + c;
      const int8_t* src = src0 + static_cast<long long>(g) * a.k + gc;
      const int o = r * kAStep + c;
      const int off = st + (o ^ (((o >> 7) & 7) << 4));
      if (a.copy == 16) {
        const bool ok = g < rows && gc < a.k;
        wg::cp16(base + off, ok ? src : src0, ok);
      } else if (a.copy == 4) {
#pragma unroll
        for (int i = 0; i < 16; i += 4) {
          const bool ok = g < rows && gc + i < a.k;
          wg::cp4(base + off + i, ok ? src + i : src0, ok);
        }
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (g < rows)
          for (int i = 0; i < 16 && gc + i < a.k; ++i)
            v[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                        << (8 * (i % 4));
        *reinterpret_cast<uint4*>(smem + off) = make_uint4(v[0], v[1], v[2],
                                                           v[3]);
      }
    }
  };

#pragma unroll 1
  for (int s = 0; s < kAStages - 1; ++s) {
    if (s < n_iter) load(s);
    wg::cp_commit();
  }
  int acc[BN / 2];
  auto step = [&](int it, auto first_step) {
    const uint32_t xs = base + (it % kAStages) * kStage, qs = xs + kX;
    wg::cp_wait<kAStages - 2>();  // this thread's copies of step it
    wg::fence_async_shared();     // visible to wgmma's reads, after
    __syncthreads();              // everyone's; step it - 1 is read
    if (it + kAStages - 1 < n_iter) load(it + kAStages - 1);
    wg::cp_commit();
    wg::mma_fence();
    wg::Ss8<BN>::template mma<decltype(first_step)::value>(
        acc, T::template kmajor<64>(xs, 0), T::template kmajor<BN>(qs, 0));
#pragma unroll
    for (int ks = 1; ks < kAStep / 32; ++ks)
      wg::Ss8<BN>::template mma<false>(acc, T::template kmajor<64>(xs, ks),
                                       T::template kmajor<BN>(qs, ks));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(acc);
  };
  step(0, std::true_type{});
  for (int it = 1; it < n_iter; ++it) step(it, std::false_type{});

  // f(column in the tile, row in the 64, acc there, acc at the next column)
  // for every register pair of this thread (wgmma.cuh's layout)
  const int lane = tid & 31;
  const int row0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
  auto each = [&](auto&& f) {
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      f(8 * (i >> 2) + 2 * (lane & 3), row0 + 8 * ((i >> 1) & 1), acc[i],
        acc[i + 1]);
  };
  TY* y = static_cast<TY*>(a.y);
  if (a.splits == 1) {
    each([&](int col, int row, int v0, int v1) {
      const int gm = m0 + row, gc = n0 + col;
      if (gm >= a.m || gc >= a.n) return;
      TY* p = y + static_cast<long long>(gm) * a.n + gc;
      const float f0 = static_cast<float>(v0) * a.s[gc];
      if (gc + 1 >= a.n) {
        p[0] = bigdl::from_f32<TY>(f0);
        return;
      }
      const float f1 = static_cast<float>(v1) * a.s[gc + 1];
      if (a.pairs) {
        store2(p, f0, f1);
      } else {
        p[0] = bigdl::from_f32<TY>(f0);
        p[1] = bigdl::from_f32<TY>(f1);
      }
    });
    return;
  }
  // this split's partial sums, then a ticket: the tile's last block adds
  // every split's in split order (the others' from L2), scales, stores
  const long long mn = static_cast<long long>(a.m) * a.n;
  int* part = a.ws + blockIdx.y * mn;
  each([&](int col, int row, int v0, int v1) {
    const int gm = m0 + row, gc = n0 + col;
    if (gm >= a.m || gc >= a.n) return;
    int* p = part + static_cast<long long>(gm) * a.n + gc;
    if (gc + 1 < a.n && (a.n & 1) == 0) {
      *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
      p[0] = v0;
      if (gc + 1 < a.n) p[1] = v1;
    }
  });
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + blockIdx.x, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // V outputs a thread at a time (4 where n % 4 == 0: 16-byte loads), the
  // splits' loads unrolled so that they are in flight together
  const int rows = min(64, a.m - m0), cols = min(BN, a.n - n0);
  auto reduce = [&](auto width) {
    constexpr int V = decltype(width)::value;
    for (int e = tid; e < rows * cols / V; e += kAThreads) {
      const int r = e / (cols / V), c = V * (e % (cols / V));
      const long long at = static_cast<long long>(m0 + r) * a.n + n0 + c;
      int sum[V] = {};
#pragma unroll 8
      for (int j = 0; j < a.splits; ++j) {
        const int* p = a.ws + j * mn + at;
        if constexpr (V == 4) {
          const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
          sum[0] += v.x, sum[1] += v.y, sum[2] += v.z, sum[3] += v.w;
        } else {
          sum[0] += __ldcg(p);
        }
      }
      if constexpr (V == 4)
        store4(y + at, static_cast<float>(sum[0]) * a.s[n0 + c],
               static_cast<float>(sum[1]) * a.s[n0 + c + 1],
               static_cast<float>(sum[2]) * a.s[n0 + c + 2],
               static_cast<float>(sum[3]) * a.s[n0 + c + 3]);
      else
        y[at] = bigdl::from_f32<TY>(static_cast<float>(sum[0]) * a.s[n0 + c]);
    }
  };
  if ((a.n & 3) == 0 && a.pairs)
    reduce(std::integral_constant<int, 4>{});
  else
    reduce(std::integral_constant<int, 1>{});
  if (tid == 0) a.tickets[blockIdx.x] = 0;  // for the next launch
}

template <typename TY, int BN>
cudaError_t launch_a8_bn(const A8Args& a, cudaStream_t s) {
  constexpr int kBytes = kAStages * (64 + BN) * kAStep + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      a8_wgmma<TY, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  a8_wgmma<TY, BN><<<dim3(cdiv(a.m, 64) * cdiv(a.n, BN), a.splits),
                     kAThreads, kBytes, s>>>(a);
  return cudaGetLastError();
}

template <typename TY>
cudaError_t launch_a8(const A8Args& a, int bn, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_a8_bn<TY, 64>(a, s);
    case 128: return launch_a8_bn<TY, 128>(a, s);
    case 256: return launch_a8_bn<TY, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K13: x (m, k) f32/bf16, q (n, k) int8 or e4m3, scale (n,) f32 -> y (m, n)
// with the plan (bm, bn, splits) of x's dtype and, when splits > 1, an f32
// workspace ws (splits, m, n)
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
    return int8 ? run_f32<FInt8>(x, q, scale, y, m, n, k, bm, bn, splits, ws,
                                 s)
                : run_f32<FE4m3>(x, q, scale, y, m, n, k, bm, bn, splits, ws,
                                 s);
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
    return run_f32<FInt4>(x, q4, scale, y, m, n, k, bm, bn, splits, ws, s);
  if (xdtype != bigdl::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return run_bf16<bigdl::quant::Int4>(x, q4, scale, y, m, n, k, bm, bn,
                                      splits, ws, s);
}

// K14: xq (m, k) int8, q (n, k) int8, s = scale * sx (n,) f32 -> y (m, n)
// with the plan (bn, splits) and, when splits > 1, an int32 workspace ws
// (splits, m, n) and a ticket counter an output tile, all 0
extern "C" int bigdl_a8_matmul(const void* xq, const void* q, const void* s,
                               void* y, int ydtype, int m, int n, int k,
                               int bn, int splits, void* ws, void* tickets,
                               void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = ydtype == bigdl::kF32;
  if (!f32 && ydtype != bigdl::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return zeros(y, m, n, f32 ? 4 : 2, st);
  A8Args a{};
  a.x = static_cast<const int8_t*>(xq);
  a.q = static_cast<const int8_t*>(q);
  a.s = static_cast<const float*>(s);
  a.y = y;
  a.ws = static_cast<int*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.m = m;
  a.n = n;
  a.k = k;
  a.splits = splits;
  a.steps = cdiv(k, kAStep);
  a.per = split_steps(a.steps, splits, ws);
  if (a.per < 0 || (splits > 1 && !tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  a.copy = k % 16 == 0 && aligned_to(xq, 16) && aligned_to(q, 16) ? 16
           : k % 4 == 0 && aligned_to(xq, 4) && aligned_to(q, 4)  ? 4
                                                                  : 1;
  a.pairs = n % 2 == 0 && aligned_to(y, f32 ? 16 : 8);
  const cudaError_t e =
      f32 ? launch_a8<float>(a, bn, st) : launch_a8<__nv_bfloat16>(a, bn, st);
  return static_cast<int>(e);
}
