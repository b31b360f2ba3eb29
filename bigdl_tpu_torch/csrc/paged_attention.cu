// K12: masked attention over a block-paged KV pool, the serving read path.
// q (B, H, S, D); k/v pools (P+1, Hkv, ps, D) whose last page (id P) is the
// trash page; pages (B, Lp) int32, logical page l of row b in pool page
// pages[b, l]; positions (B, S) int32, key slot l visible to token s of row
// b iff l <= positions[b, s]; query head h reads KV head h / (H / Hkv).
// Output (B, H, S, D) in the cache dtype.  All tensors contiguous.
//
// Replaces bigdl_tpu/ops/attention.py `_paged_kernel` (wrapper
// `paged_attention`, :813).  The TPU kernel ran a grid of (B, H, Lp), its
// index map gathering one physical page per grid step into VMEM through
// the scalar-prefetched page table and the last step computing over the
// whole row.  On Hopper the grid runs in no order, so nothing carries from
// one page to the next: a block owns (row b, KV head, up to 16 query rows
// of that KV head's GQA group: (head in group, position) pairs) and walks
// the row's logical pages itself, with its own copy of pages[b, :] in
// shared memory (in place of the scalar prefetch), up to the last key any
// of its queries can see, 64 keys a tile.  Each K/V head is read once per
// (b, KV head, row tile).
//
// Arithmetic, as the reference's gather path computes it
// (bigdl_tpu/nn/attention.py:341-369), in three phases:
// 1. scores: q·k in f32 (FFMA) per visible key, rounded to bf16 and scaled
//    and rounded again when q and the cache are both bf16 (jnp.einsum keeps
//    bf16 x bf16 in bf16), scaled in f32 otherwise; l > positions -> -inf.
//    The block keeps its rows' scores in shared memory.
// 2. exact softmax in f32: the row max, the sum of exp(s - m), then
//    p = exp(s - m) / sum rounded to the cache dtype (the reference
//    normalises before it casts the weights, so one pass with a running
//    rescale would round differently).
// 3. o = p·v with f32 accumulation, rounded once to the cache dtype.
// The trash page reads as zeros: it is never skipped (a visible trash slot
// has score 0 and adds nothing through v = 0) and never read, so a row
// whose table is all trash gives the plain version's output and a NaN
// dumped on the trash page reaches no row.  A page id outside [0, P] reads
// as trash too.  A bf16 q over an f32 cache is widened to f32 by the
// wrapper, exactly.
//
// Bound on the H100: bytes.  Each visible K/V token is read once per
// (b, KV head) and row tile, plus q and the output, over 3.35 TB/s; the
// work is 4·D FLOPs per visible (query, key) pair and head.  At the decode
// shape (8 rows, 8 heads, S 1, D 64, ~560 visible tokens, bf16) that is
// about 9 MB, ~3 us, so launch latency and the single-buffered staging
// dominate.  FFMA with f32 accumulation throughout; tensor cores, cp.async
// and a split over pages are later work.
#include <cstdint>

#include "common.cuh"

namespace {

using bigdl::from_f32;
using bigdl::to_f32;

constexpr int kPagedThreads = 128;
constexpr int kKT = 64;       // keys per K/V tile
constexpr int kMaxRows = 16;  // query rows per block
constexpr int kMaxOut = 8;    // output elements per thread: rows * D <= 1024
constexpr int kBatch = 8;     // loads a thread has in flight when staging

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pages;
  const int* pos;
  void* o;
  int h, hkv, s, d, ps, lp, trash, ts;
  float scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return round_bf16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// QT: q's type, CT: the cache's; kRound: both bf16, scores rounded to bf16
template <typename QT, typename CT, bool kRound>
__global__ void __launch_bounds__(kPagedThreads) paged_attn(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int D = p.d, L = p.lp * p.ps, g = p.h / p.hkv;
  const int rows = g * p.s;
  const int r0 = blockIdx.x * p.ts;
  const int nr = min(p.ts, rows - r0);
  const int kvh = blockIdx.y, b = blockIdx.z;
  long long* addr = reinterpret_cast<long long*>(sm);       // [kKT]
  int* pos = reinterpret_cast<int*>(sm + 2 * kKT);          // [kMaxRows]
  float* qs = sm + 2 * kKT + kMaxRows;                      // [ts][D]
  float* ss = qs + p.ts * D;                                // [ts][L]
  float* tile = ss + static_cast<long long>(p.ts) * L;      // [kKT][D + 1]
  int* row_pages = reinterpret_cast<int*>(tile + kKT * (D + 1));  // [lp]

  // row i of the block: head kvh * g + (r0 + i) / S, position (r0 + i) % S
  auto q_off = [&](int i) -> long long {
    const int r = r0 + i, hh = kvh * g + r / p.s, si = r % p.s;
    return ((static_cast<long long>(b) * p.h + hh) * p.s + si) * D;
  };
  if (tid < nr) pos[tid] = p.pos[static_cast<long long>(b) * p.s +
                                 (r0 + tid) % p.s];
  for (int i = tid; i < p.lp; i += kPagedThreads)
    row_pages[i] = p.pages[static_cast<long long>(b) * p.lp + i];
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < nr * D; e += kPagedThreads)
    qs[e] = to_f32(q[q_off(e / D) + e % D]);
  __syncthreads();
  int maxpos = -1;
  for (int i = 0; i < nr; ++i) maxpos = max(maxpos, pos[i]);
  const int lvis = min(L, maxpos + 1);  // the keys any row of the block sees

  // one tile of K or V (keys [k0, k0 + kKT)) into shared memory as f32,
  // zeros for the trash page and beyond lvis.  Each thread issues all its
  // loads of a batch before it stores any, 16-byte vectors where the rows
  // allow, so a tile costs about one memory latency, not one per element.
  const bool vec = (D * sizeof(CT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  auto stage = [&](int k0, const CT* pool) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < kKT) {
      const int l = k0 + tid;
      long long a = -1;
      if (l < lvis) {
        const int phys = row_pages[l / p.ps];
        if (phys >= 0 && phys < p.trash)
          a = ((static_cast<long long>(phys) * p.hkv + kvh) * p.ps +
               l % p.ps) * D;
      }
      addr[tid] = a;
    }
    __syncthreads();
    if (vec) {
      constexpr int kV = 16 / sizeof(CT);  // elements per vector
      const int nv = D / kV, total = kKT * nv;
      for (int e0 = tid; e0 < total; e0 += kPagedThreads * kBatch) {
        uint4 buf[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kPagedThreads;
          buf[u] = make_uint4(0u, 0u, 0u, 0u);
          if (e < total) {
            const long long a = addr[e / nv];
            if (a >= 0)
              buf[u] = *reinterpret_cast<const uint4*>(pool + a +
                                                       (e % nv) * kV);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kPagedThreads;
          if (e >= total) continue;
          const CT* x = reinterpret_cast<const CT*>(&buf[u]);
          float* t = tile + (e / nv) * (D + 1) + (e % nv) * kV;
#pragma unroll
          for (int j = 0; j < kV; ++j) t[j] = to_f32(x[j]);
        }
      }
    } else {
      for (int e0 = tid; e0 < kKT * D; e0 += kPagedThreads * kBatch) {
        float buf[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kPagedThreads;
          buf[u] = 0.0f;
          if (e < kKT * D) {
            const long long a = addr[e / D];
            if (a >= 0) buf[u] = to_f32(pool[a + e % D]);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kPagedThreads;
          if (e < kKT * D) tile[(e / D) * (D + 1) + e % D] = buf[u];
        }
      }
    }
    __syncthreads();
  };

  // 1. scores: thread (half, key) takes rows half, half + 2, ...
  const CT* kp = static_cast<const CT*>(p.k);
  const int half = tid / kKT, kk = tid % kKT;
  for (int k0 = 0; k0 < lvis; k0 += kKT) {
    stage(k0, kp);
    const int l = k0 + kk;
    if (l >= lvis) continue;
    float acc[kMaxRows / 2];
#pragma unroll
    for (int j = 0; j < kMaxRows / 2; ++j) acc[j] = 0.0f;
    const float* kr = tile + kk * (D + 1);
    for (int c = 0; c < D; ++c) {
      const float kv = kr[c];
#pragma unroll
      for (int j = 0; j < kMaxRows / 2; ++j) {
        const int i = half + 2 * j;
        if (i < nr) acc[j] = fmaf(qs[i * D + c], kv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxRows / 2; ++j) {
      const int i = half + 2 * j;
      if (i >= nr) continue;
      const float x = kRound ? round_bf16(round_bf16(acc[j]) * p.scale)
                             : acc[j] * p.scale;
      ss[static_cast<long long>(i) * L + l] = l <= pos[i] ? x : -INFINITY;
    }
  }
  __syncthreads();

  // 2. softmax in f32, one warp per row; the weights rounded to the cache
  // dtype in place
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < nr; i += kPagedThreads / 32) {
    float* row = ss + static_cast<long long>(i) * L;
    float m = -INFINITY;
    for (int l = lane; l < lvis; l += 32) m = fmaxf(m, row[l]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int l = lane; l < lvis; l += 32) sum += expf(row[l] - m);
    sum = warp_sum(sum);
    for (int l = lane; l < lvis; l += 32)
      row[l] = round_to<CT>(expf(row[l] - m) / sum);
  }

  // 3. o = p·v: thread element e = tid + 128 j is (row e / D, column e % D)
  const CT* vp = static_cast<const CT*>(p.v);
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < lvis; k0 += kKT) {
    stage(k0, vp);
    const int kn = min(kKT, lvis - k0);
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int e = tid + j * kPagedThreads;
      if (e >= nr * D) continue;
      const int i = e / D, c = e % D;
      const float* pr = ss + static_cast<long long>(i) * L + k0;
      float a = acc[j];
      for (int t = 0; t < kn; ++t) a = fmaf(pr[t], tile[t * (D + 1) + c], a);
      acc[j] = a;
    }
  }
  CT* o = static_cast<CT*>(p.o);
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int e = tid + j * kPagedThreads;
    if (e < nr * D) o[q_off(e / D) + e % D] = from_f32<CT>(acc[j]);
  }
}

template <typename QT, typename CT, bool kRound>
cudaError_t launch_t(const Params& p, int b, cudaStream_t s) {
  const long long length = static_cast<long long>(p.lp) * p.ps;
  const size_t smem =
      sizeof(float) * (2 * kKT + kMaxRows + static_cast<size_t>(p.ts) * p.d +
                       static_cast<size_t>(p.ts) * length +
                       static_cast<size_t>(kKT) * (p.d + 1) + p.lp);
  const cudaError_t e = cudaFuncSetAttribute(
      paged_attn<QT, CT, kRound>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = (p.h / p.hkv) * p.s;
  const dim3 grid((rows + p.ts - 1) / p.ts, p.hkv, b);
  paged_attn<QT, CT, kRound><<<grid, kPagedThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K12: q (b, h, s, d) f32/bf16; pools (trash + 1, hkv, ps, d) f32/bf16;
// pages (b, lp) and positions (b, s) int32 -> o (b, h, s, d) in the cache
// dtype; ts query rows per block (ops/attention.py paged_rows_per_block)
extern "C" int bigdl_paged_attention(const void* q, const void* k,
                                     const void* v, const void* pages,
                                     const void* positions, void* o,
                                     int q_dtype, int c_dtype, int b, int h,
                                     int hkv, int s, int d, int ps, int lp,
                                     int trash, float scale, int ts,
                                     void* stream) {
  if (b == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  if (ts < 1 || ts > kMaxRows || ts * d > kMaxOut * kPagedThreads ||
      hkv < 1 || h % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, static_cast<const int*>(pages),
                 static_cast<const int*>(positions), o, h, hkv, s, d, ps, lp,
                 trash, ts, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (q_dtype == bigdl::kF32 && c_dtype == bigdl::kF32)
    e = launch_t<float, float, false>(p, b, st);
  else if (q_dtype == bigdl::kBF16 && c_dtype == bigdl::kBF16)
    e = launch_t<__nv_bfloat16, __nv_bfloat16, true>(p, b, st);
  else if (q_dtype == bigdl::kF32 && c_dtype == bigdl::kBF16)
    e = launch_t<float, __nv_bfloat16, false>(p, b, st);
  return static_cast<int>(e);
}
