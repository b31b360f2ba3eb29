// The bf16 dequant-matmul of K13 (int8 and e4m3 weights) and K15 (int4
// nibbles) on Hopper: y (m, n) = (x (m, k) . widen(q) (n, k)^T) * scale,
// f32 sums, one rounding to bf16.  quant_matmul.cu's header note says what
// bounds it and why it is laid out so; the grid's plan (bm, bn, splits)
// comes from the wrapper (ops/quant.py bf16_plan).  Each weight kind is
// instantiated in its own quant_bf16_<kind>.cu, so the three compile in
// parallel.
//
// A block owns rows [m0, m0 + bm) (bm 64, 128, or 192 where BN <= 192)
// and columns [n0, n0 + BN) (BN = N rounded up to 8, at most 256) over K
// steps [first, first + per) of its split.  Warpgroup 0 produces (TMA and
// the weight's widening), the bm / 64 after it consume (wgmma):
// * x tiles come by TMA into a 3- or 4-stage ring, swizzled as wgmma reads
//   them (64 columns a step, or for int4 two tiles of 32: the low nibbles'
//   columns [j, j + 32) and the high nibbles' [h + j, h + j + 32), h =
//   ceil(k / 2)), one mbarrier a stage; the map's bounds zero the ragged
//   M and K edges (and, for int4, the low tile past h).  A shape TMA
//   cannot take (k % 8 != 0, x not 16-byte aligned, or for int4 h % 8 !=
//   0: a box starts on 16 bytes) loads the same tiles element by element.
// * the packed weight's step (64 bytes of a row, int4 32) comes into the
//   same ring stage by TMA, on the same mbarrier, where its rows are
//   16-byte aligned; else (k 600: 8-byte rows) the producer's threads copy
//   their own 8-byte units by cp.async in 8- or 4-byte pieces, or byte by
//   byte;
// * the producer's 128 threads widen the step's units (8 packed bytes
//   each) into one of two bf16 buffers (a tile, two for int4), 16 bytes a
//   store in the swizzled layout, with integer and f32-add tricks rather
//   than conversion instructions: exact for int8, e4m3 (NaN stays NaN) and
//   the nibbles, whose two's complement is (n ^ 8) - 8.  They widen step
//   it while the consumers multiply step it - 1; mbarriers hand the
//   buffers and the ring's stages back and forth, with no block barrier;
// * each consumer runs wgmma m64nNk16 on its 64 rows, N composed of
//   power-of-two widths (208 = 128 + 64 + 16), f32 accumulators in
//   registers;
// * one split: scale, round to bf16, stage the tile in shared memory and
//   store whole rows in 16-byte pieces; several: the consumers write their
//   f32 partial sums to the caller's workspace, and quant_matmul.cu's
//   second pass adds them in split order.
// What bounds it, measured (PERF.md §6): at the large convs the
// producer's widening of BN x 64 weights a step, which 192 rows a block
// spreads over more of x.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"
#include "quant_widen.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace bigdl {
namespace quant {

using bf16 = __nv_bfloat16;
namespace wg = bigdl::wg;

constexpr int kStepCols = 64;  // x columns a K step

// One product and its plan; the fields below the line are derived by
// launch_bf16.
struct Bf16Args {
  const bf16* x;       // (m, k)
  const uint8_t* q;    // (n, row_bytes) packed
  const float* scale;  // (n,)
  bf16* y;             // (m, n)
  float* ws;           // (splits, m, n) partial sums when splits > 1
  int m, n, k;
  int bm, bn, splits;
  // ----
  int stages;     // depth of the x and weight rings: 3 at bm 64 up to bn
                  // 192 (two blocks then fit an SM), else 4
  int row_bytes;  // packed bytes a row: k, or h = ceil(k / 2) for int4
  int steps;      // K steps in all
  int per;        // K steps a split
  int wvec;       // without wtma: bytes a thread's weight copy, 8, 4 or 1
  bool tma;       // x by TMA
  bool wtma;      // the packed weight by TMA (its rows 16-byte aligned)
  bool yvec;      // y rows in 16-byte stores
};

// Weight kinds: x tiles a K step, packed bytes of a row a step, and the
// widening of 8 packed bytes into 16-byte chunks of bf16, one a tile.
struct Int8 {
  static constexpr int kHalves = 1, kStepBytes = 64;
  __device__ static __forceinline__ void widen(uint2 v, uint4 (&c)[1]) {
    const uint2 a = biased4(v.x ^ 0x80808080u, 128.0f);  // b + 128
    const uint2 b = biased4(v.y ^ 0x80808080u, 128.0f);
    c[0] = make_uint4(a.x, a.y, b.x, b.y);
  }
};

struct E4m3 {
  static constexpr int kHalves = 1, kStepBytes = 64;
  __device__ static __forceinline__ void widen(uint2 v, uint4 (&c)[1]) {
    c[0] = make_uint4(hi_halves(e4m3(v.x, 0), e4m3(v.x, 1)),
                      hi_halves(e4m3(v.x, 2), e4m3(v.x, 3)),
                      hi_halves(e4m3(v.y, 0), e4m3(v.y, 1)),
                      hi_halves(e4m3(v.y, 2), e4m3(v.y, 3)));
  }
};

// split-half nibbles: byte j of a row holds weight column j (low) and
// h + j (high), so 8 bytes give 8 columns of each half; a nibble n is
// two's complement, (n ^ 8) - 8
struct Int4 {
  static constexpr int kHalves = 2, kStepBytes = 32;
  __device__ static __forceinline__ void widen(uint2 v, uint4 (&c)[2]) {
    uint2 lo[2], hi[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t w = j ? v.y : v.x;
      lo[j] = biased4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 8.0f);
      hi[j] = biased4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.0f);
    }
    c[0] = make_uint4(lo[0].x, lo[0].y, lo[1].x, lo[1].y);
    c[1] = make_uint4(hi[0].x, hi[0].y, hi[1].x, hi[1].y);
  }
};

// byte offsets from the 1024-aligned base of a block's shared memory
template <typename W, int BN>
struct Layout {
  static constexpr int kB = BN * 128 / W::kHalves;  // one widened tile
  static constexpr int kBHalf = (kB + 1023) / 1024 * 1024;
  static constexpr int kBBuf = W::kHalves * kBHalf;  // a step's tiles
  int x_stage;  // the x tiles of a step: bm rows x 64 columns
  int b;        // the widened tiles, two buffers of kBBuf
  int raw;      // the packed weight's ring
  int bars;     // mbarriers: a stage's copies landed and its x tile and
                // packed weight are free; a widened buffer full and free
  int bytes;    // dynamic shared memory, with 1024 for the alignment
  __host__ __device__ Layout(int bm, int stages)
      : x_stage(bm * 2 * kStepCols),
        b(stages * bm * 2 * kStepCols),
        raw(b + 2 * kBBuf),
        bars(raw + stages * BN * W::kStepBytes),
        bytes(bars + (2 * stages + 4) * 8 + 1024) {}
};

// Byte offset o of a row-major tile with rows of kW bytes (128, 64 or 32)
// moved to where the swizzle puts it (wgmma.cuh's header).
template <int kW>
__device__ __forceinline__ int swizzle(int o) {
  return o ^ (((o >> 7) & (kW / 16 - 1)) << 4);
}

// The accumulator of a 64 x N product, N a multiple of 8: one wgmma of
// the largest power-of-two width kC at column kN0, then the rest.
template <int N, int kN0 = 0>
struct Acc {
  static constexpr int kC = N >= 256 ? 256 : N >= 128 ? 128 : N >= 64 ? 64
                            : N >= 32 ? 32 : N >= 16 ? 16 : 8;
  float d[kC / 2];
  Acc<N - kC, kN0 + kC> rest;

  // d (+)= A B over k16 step ks: a the A descriptor, b the widened tile
  template <typename T, bool kFirst>
  __device__ __forceinline__ void mma(uint64_t a, uint32_t b, int ks) {
    wg::Ss<kC>::template mma<kFirst>(
        d, a, T::template kmajor<64>(b + kN0 * T::kW, ks));
    rest.template mma<T, kFirst>(a, b, ks);
  }

  __device__ __forceinline__ void fence() {
    wg::fence_regs(d);
    rest.fence();
  }

  // f(column in the tile, row in the warpgroup's 64, d there, d at the
  // next column) for every register pair of this thread
  template <typename F>
  __device__ __forceinline__ void each(F& f) {
    const int lane = threadIdx.x & 31;
    const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < kC / 2; i += 2)
      f(kN0 + 8 * (i >> 2) + 2 * (lane & 3), row + 8 * ((i >> 1) & 1), d[i],
        d[i + 1]);
    rest.each(f);
  }
};

template <int kN0>
struct Acc<0, kN0> {
  template <typename T, bool kFirst>
  __device__ __forceinline__ void mma(uint64_t, uint32_t, int) {}
  __device__ __forceinline__ void fence() {}
  template <typename F>
  __device__ __forceinline__ void each(F&) {}
};

constexpr int kWg = 128;  // threads a warpgroup: the producer, then
                          // bm / 64 consumers

// A step's packed weight in units of 8 bytes: unit u is row u / kPerRow,
// bytes [8 (u % kPerRow), + 8) of its step; producer thread t owns units
// t, t + kWg, ... (kUnits a thread, the last maybe past the tile).
template <typename W, int BN>
struct Units {
  static constexpr int kPerRow = W::kStepBytes / 8;
  static constexpr int kAll = BN * kPerRow;
  static constexpr int kUnits = (kAll + kWg - 1) / kWg;
};

// this producer thread's units of the packed bytes [cb, cb + kStepBytes)
// of rows [n0, n0 + BN) into the ring stage at dst (zeros past n and
// row_bytes): by cp.async of a.wvec bytes (row_bytes % wvec == 0, so a
// piece is whole or absent), or byte by byte; the weights TMA cannot copy
template <typename W, int BN>
__device__ __forceinline__ void copy_weight(const Bf16Args& a, uint32_t dst,
                                            unsigned char* dst_p, int n0,
                                            int cb) {
  using U = Units<W, BN>;
#pragma unroll
  for (int j = 0; j < U::kUnits; ++j) {
    const int u = threadIdx.x + j * kWg;
    if (u >= U::kAll) break;
    const int r = u / U::kPerRow, c = 8 * (u % U::kPerRow);
    const int gn = n0 + r, gc = cb + c;
    const uint8_t* row = a.q + static_cast<long long>(gn) * a.row_bytes;
    const uint32_t at = dst + r * W::kStepBytes + c;
    if (a.wvec == 8) {
      const bool ok = gn < a.n && gc < a.row_bytes;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(at), "l"(ok ? row + gc : a.q), "r"(ok ? 8 : 0)
                   : "memory");
    } else if (a.wvec == 4) {
#pragma unroll
      for (int i = 0; i < 8; i += 4) {
        const bool ok = gn < a.n && gc + i < a.row_bytes;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(at + i), "l"(ok ? row + gc + i : a.q),
                        "r"(ok ? 4 : 0) : "memory");
      }
    } else {
      uint2 v = make_uint2(0u, 0u);
      for (int i = 0; i < 8; ++i)
        if (gn < a.n && gc + i < a.row_bytes)
          (i < 4 ? v.x : v.y) |= static_cast<uint32_t>(row[gc + i])
                                 << (8 * (i & 3));
      *reinterpret_cast<uint2*>(dst_p + r * W::kStepBytes + c) = v;
    }
  }
}

// widen this producer thread's units of the ring stage at packed into the
// tile(s) at tiles (T the tile layout)
template <typename W, int BN, typename T>
__device__ __forceinline__ void widen_units(const unsigned char* packed,
                                            unsigned char* tiles) {
  using U = Units<W, BN>;
#pragma unroll
  for (int j = 0; j < U::kUnits; ++j) {
    const int u = threadIdx.x + j * kWg;
    if (u >= U::kAll) break;
    const int r = u / U::kPerRow, c = 8 * (u % U::kPerRow);
    uint4 out[W::kHalves];
    W::widen(*reinterpret_cast<const uint2*>(packed + r * W::kStepBytes + c),
             out);
#pragma unroll
    for (int hf = 0; hf < W::kHalves; ++hf)
      *reinterpret_cast<uint4*>(tiles + hf * Layout<W, BN>::kBHalf +
                                swizzle<T::kW>(r * T::kW + 2 * c)) = out[hf];
  }
}

// Warpgroup 0 produces: its thread 0 starts the TMA copies of a stage, all
// its threads copy the weights TMA cannot and x where TMA cannot, and widen
// step it into buffer it % 2 while the consumers multiply step it - 1.
// Warpgroups 1.. consume: wgmma on their 64 rows of step it's x tile and
// widened buffer.  The barriers: full[s], a stage's TMA bytes landed;
// x_free[s], its x tile and packed weight read (by every thread);
// b_full[j], buffer j widened (by the producer's threads); b_free[j],
// buffer j read (by the consumers' threads).
template <typename W, int BN>
__global__ void __launch_bounds__((BN <= 192 ? 4 : 3) * kWg)
    dequant_mm_wgmma(const Bf16Args a, const __grid_constant__ CUtensorMap m_lo,
    const __grid_constant__ CUtensorMap m_hi,
    const __grid_constant__ CUtensorMap m_w) {
  using T = wg::Tile<kStepCols / W::kHalves>;  // one x or weight tile
  constexpr int kCols = kStepCols / W::kHalves;
  const Layout<W, BN> L(a.bm, a.stages);
  const int S = a.stages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw0 = wg::smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw0);
  const int tid = threadIdx.x;
  const int consumers = a.bm / 64;  // warpgroups
  const int n_tiles = (a.n + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * a.bm;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int first = blockIdx.y * a.per;
  const int n_iter = min(a.steps - first, a.per);
  const uint32_t full = base + L.bars, x_free = full + 8 * S;
  const uint32_t b_full = x_free + 8 * S, b_free = b_full + 16;
  // the bytes TMA brings a stage: x's tiles and the packed weight's
  const uint32_t tx = (a.tma ? L.x_stage : 0) +
                      (a.wtma ? BN * W::kStepBytes : 0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(x_free + 8 * s, (consumers + 1) * kWg);
    }
    for (int j = 0; j < 2; ++j) {
      wg::mbar_init(b_full + 8 * j, kWg);
      wg::mbar_init(b_free + 8 * j, consumers * kWg);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  Acc<BN> acc;
  if (tid < kWg) {  // the producer
    auto load = [&](int it) {  // the x tiles and packed weight of step it
      const int s = it % S, step = first + it;
      const uint32_t xs = base + s * L.x_stage;
      const int raw = L.raw + s * BN * W::kStepBytes;
      // the stage was last read in step it - S
      if (it >= S && (!a.tma || (tx && tid == 0)))
        wg::mbar_wait(x_free + 8 * s, (it / S - 1) & 1);
      if (tx && tid == 0) {
        wg::mbar_expect(full + 8 * s, tx);
        if (a.tma) {
          wg::tma_load_2d(xs, &m_lo, full + 8 * s, step * kCols, m0);
          if (W::kHalves == 2)
            wg::tma_load_2d(xs + a.bm * T::kW, &m_hi, full + 8 * s,
                            a.row_bytes + step * kCols, m0);
        }
        if (a.wtma)
          wg::tma_load_2d(base + raw, &m_w, full + 8 * s,
                          step * W::kStepBytes, n0);
      }
      if (!a.tma) {  // element by element: low tile (int8: the tile)
                     // columns below row_bytes or k, the high tile's below k
        const bf16 zero = __float2bfloat16(0.0f);
        for (int e = tid; e < a.bm * kStepCols; e += kWg) {
          const int half = e / (a.bm * kCols), r = (e / kCols) % a.bm;
          const int c = e % kCols;
          const int col = (half ? a.row_bytes : 0) + step * kCols + c;
          const int end = W::kHalves == 2 && !half ? a.row_bytes : a.k;
          const int gm = m0 + r;
          *reinterpret_cast<bf16*>(
              smem + s * L.x_stage + half * a.bm * T::kW +
              swizzle<T::kW>(r * T::kW + 2 * c)) =
              gm < a.m && col < end
                  ? a.x[static_cast<long long>(gm) * a.k + col] : zero;
        }
      }
      if (!a.wtma)
        copy_weight<W, BN>(a, base + raw, smem + raw, n0,
                           step * W::kStepBytes);
    };
#pragma unroll 1
    for (int s = 0; s < S - 1; ++s) {
      if (s < n_iter) load(s);
      wg::cp_commit();
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % S, j = it & 1;
      if (tx) wg::mbar_wait(full + 8 * s, (it / S) & 1);
      if (!a.wtma) {  // this thread's copies of step it
        if (S == 4)
          wg::cp_wait<2>();
        else
          wg::cp_wait<1>();
      }
      if (it >= 2) wg::mbar_wait(b_free + 8 * j, (it / 2 - 1) & 1);
      widen_units<W, BN, T>(smem + L.raw + s * BN * W::kStepBytes,
                            smem + L.b + j * L.kBBuf);
      wg::fence_async_shared();  // the widened tile (and x by loads)
      wg::mbar_arrive(b_full + 8 * j);
      wg::mbar_arrive(x_free + 8 * s);
      // into the stage of step it - 1, once the consumers are done with it
      if (it + S - 1 < n_iter) load(it + S - 1);
      wg::cp_commit();
    }
  } else {  // a consumer: rows [64 c, 64 c + 64) of the tile
    const int x_rows = (tid / kWg - 1) * 64 * T::kW;
    auto step = [&](int it, auto first_step) {
      const int s = it % S, j = it & 1;
      if (a.tma) wg::mbar_wait(full + 8 * s, (it / S) & 1);
      wg::mbar_wait(b_full + 8 * j, (it / 2) & 1);
      const uint32_t xs = base + s * L.x_stage + x_rows;
      const uint32_t bt = base + L.b + j * L.kBBuf;
      wg::mma_fence();
      acc.template mma<T, decltype(first_step)::value>(
          T::template kmajor<64>(xs, 0), bt, 0);
#pragma unroll
      for (int k = 1; k < kStepCols / 16; ++k) {
        const int hf = k / (kCols / 16), ks = k % (kCols / 16);
        acc.template mma<T, false>(
            T::template kmajor<64>(xs + hf * a.bm * T::kW, ks),
            bt + hf * L.kBHalf, ks);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      acc.fence();
      wg::mbar_arrive(b_free + 8 * j);
      wg::mbar_arrive(x_free + 8 * s);
    };
    step(0, std::true_type{});
    for (int it = 1; it < n_iter; ++it) step(it, std::false_type{});
  }

  const int row0 = (tid / kWg - 1) * 64;  // a consumer's rows in the tile
  if (a.splits > 1) {  // f32 partial sums of this split
    if (tid < kWg) return;
    float* ws = a.ws + static_cast<long long>(blockIdx.y) * a.m * a.n;
    auto put = [&](int col, int row, float v0, float v1) {
      const int gm = m0 + row0 + row, gc = n0 + col;
      if (gm >= a.m || gc >= a.n) return;
      float* p = ws + static_cast<long long>(gm) * a.n + gc;
      if (gc + 1 < a.n && (a.n & 1) == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (gc + 1 < a.n) p[1] = v1;
      }
    };
    acc.each(put);
    return;
  }
  // scale, round once, stage rows in shared memory (the rings are free once
  // every consumer is done), then store them in 16-byte pieces
  constexpr int kRow = BN * 2 + 16;  // bytes a staged row
  __syncthreads();
  auto stage = [&](int col, int row, float v0, float v1) {
    const int gc = n0 + col;
    const float s0 = gc < a.n ? a.scale[gc] : 0.0f;
    const float s1 = gc + 1 < a.n ? a.scale[gc + 1] : 0.0f;
    *reinterpret_cast<uint32_t*>(smem + (row0 + row) * kRow + 2 * col) =
        pack_bf16x2(v0 * s0, v1 * s1);
  };
  if (tid >= kWg) acc.each(stage);
  __syncthreads();
  for (int e = tid; e < a.bm * (BN / 8); e += blockDim.x) {
    const int r = e / (BN / 8), c = 8 * (e % (BN / 8));
    const int gm = m0 + r, gc = n0 + c;
    if (gm >= a.m || gc >= a.n) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(smem + r * kRow + 2 * c);
    bf16* dst = a.y + static_cast<long long>(gm) * a.n + gc;
    if (a.yvec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e8 = reinterpret_cast<const bf16*>(&v);
      for (int j = 0; j < 8 && gc + j < a.n; ++j) dst[j] = e8[j];
    }
  }
}

template <typename W, int BN>
cudaError_t launch_bn(const Bf16Args& a, const CUtensorMap& lo,
                      const CUtensorMap& hi, const CUtensorMap& w,
                      cudaStream_t s) {
  const Layout<W, BN> L(a.bm, a.stages);
  const cudaError_t e = cudaFuncSetAttribute(
      dequant_mm_wgmma<W, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.bytes);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.m + a.bm - 1) / a.bm) * ((a.n + BN - 1) / BN);
  dequant_mm_wgmma<W, BN><<<dim3(tiles, a.splits), (1 + a.bm / 64) * kWg,
                            L.bytes, s>>>(a, lo, hi, w);
  return cudaGetLastError();
}

inline bool aligned_to(const void* p, unsigned int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Derive a's lower fields, build the maps of x and the packed weight and
// launch the BN = a.bn kernel; the caller runs the second pass when
// a.splits > 1.
template <typename W>
int launch_bf16(Bf16Args a, cudaStream_t s) {
  a.row_bytes = W::kHalves == 2 ? (a.k + 1) / 2 : a.k;
  a.steps = (a.row_bytes + W::kStepBytes - 1) / W::kStepBytes;
  if ((a.bm != 64 && a.bm != 128 && (a.bm != 192 || a.bn > 192)) ||
      a.bn % 8 || a.bn < 8 || a.bn > 256 || a.splits < 1 || a.steps == 0 ||
      (a.splits > 1 && !a.ws))
    return static_cast<int>(cudaErrorInvalidValue);
  a.stages = a.bm == 64 && a.bn <= 192 ? 3 : 4;
  a.per = (a.steps + a.splits - 1) / a.splits;
  if ((a.splits - 1) * a.per >= a.steps)  // the last split would be empty
    return static_cast<int>(cudaErrorInvalidValue);
  a.wvec = a.row_bytes % 8 == 0 && aligned_to(a.q, 8) ? 8
           : a.row_bytes % 4 == 0 && aligned_to(a.q, 4) ? 4 : 1;
  // a TMA box starts on 16 bytes: int4's high tile at column h too
  a.tma = a.k % 8 == 0 && a.row_bytes % 8 == 0 && aligned_to(a.x, 16);
  a.wtma = a.row_bytes % 16 == 0 && aligned_to(a.q, 16);
  a.yvec = a.n % 8 == 0 && aligned_to(a.y, 16);
  CUtensorMap lo{}, hi{}, w{};
  const cuuint64_t rows = static_cast<cuuint64_t>(a.m);
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(a.k) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(64 / W::kHalves),
                             static_cast<cuuint32_t>(a.bm)};
  // the low tile ends at h for int4 (the high nibbles' columns follow)
  if (a.tma && (!tma::bf16_map<2>(&lo, a.x,
                                  {static_cast<cuuint64_t>(a.row_bytes),
                                   rows}, stride, box) ||
                (W::kHalves == 2 &&
                 !tma::bf16_map<2>(&hi, a.x,
                                   {static_cast<cuuint64_t>(a.k), rows},
                                   stride, box))))
    return static_cast<int>(cudaErrorNotSupported);
  // the packed weight's rows, W::kStepBytes by bn a box, as they are
  if (a.wtma &&
      !tma::tile_map<2>(&w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q,
                        {static_cast<cuuint64_t>(a.row_bytes),
                         static_cast<cuuint64_t>(a.n)},
                        {static_cast<cuuint64_t>(a.row_bytes)},
                        {static_cast<cuuint32_t>(W::kStepBytes),
                         static_cast<cuuint32_t>(a.bn)},
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t e = cudaErrorInvalidValue;
  switch (a.bn) {
#define BIGDL_BN(B) \
    case B: e = launch_bn<W, B>(a, lo, hi, w, s); break;
    BIGDL_BN(8) BIGDL_BN(16) BIGDL_BN(24) BIGDL_BN(32) BIGDL_BN(40)
    BIGDL_BN(48) BIGDL_BN(56) BIGDL_BN(64) BIGDL_BN(72) BIGDL_BN(80)
    BIGDL_BN(88) BIGDL_BN(96) BIGDL_BN(104) BIGDL_BN(112) BIGDL_BN(120)
    BIGDL_BN(128) BIGDL_BN(136) BIGDL_BN(144) BIGDL_BN(152) BIGDL_BN(160)
    BIGDL_BN(168) BIGDL_BN(176) BIGDL_BN(184) BIGDL_BN(192) BIGDL_BN(200)
    BIGDL_BN(208) BIGDL_BN(216) BIGDL_BN(224) BIGDL_BN(232) BIGDL_BN(240)
    BIGDL_BN(248) BIGDL_BN(256)
#undef BIGDL_BN
    default: break;
  }
  return static_cast<int>(e);
}

extern template int launch_bf16<Int8>(Bf16Args, cudaStream_t);
extern template int launch_bf16<E4m3>(Bf16Args, cudaStream_t);
extern template int launch_bf16<Int4>(Bf16Args, cudaStream_t);

}  // namespace quant
}  // namespace bigdl
