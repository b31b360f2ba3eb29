// The attention-forward kernels, o = softmax(q k^T * scale, masked) v, for
// q (B*H, Tq, D) and k, v (B*Hk, Tk, D), all D-contiguous; query head i of
// batch row b reads KV row b*Hk + (i % H) / (H / Hk) (GQA, no repeated K/V
// in memory).  Masked scores are NEG_INF = -1e30 (not -inf); the causal
// mask is top-left aligned (q_pos >= k_pos, no shift when Tq != Tk).
//
// K8 replaces bigdl_tpu/ops/attention.py `_fwd_kernel` (via
// `_fused_forward`): one max per row over all keys, p = exp(s - m) in f32,
// one division at the end.  The TPU kernel held a whole (block_q, Tk) f32
// score tile in VMEM; at Tk = 2048 that is 512 KB for 64 rows, more than a
// block's 227 KB of shared memory.  So K8 makes two passes over K/V tiles:
// the row max first, then p, l = sum p and acc = p v.  It is not an online
// rescale.
// K9 replaces `_stream_kernel` (via `_streaming_forward`): the online
// softmax with a running max m, sum l and accumulator in f32; causal tiles
// in the future and tiles whose keys are all padded (the optional (B, Tk)
// additive bias) are skipped; p = 0 where s <= NEG_INF / 2; o = acc /
// max(l, 1e-20), so a row with every key padded gives 0.  The TPU kernel
// padded its m/l scratch to 128 lanes; here they live in registers.  On the
// training path (kLse) K9 also writes the row logsumexp m + log(l) in f32,
// one float per row (the reference's `with_lse`, stored over LSE_W = 8
// lanes there), from the f32 l that sums p before p is rounded; a row with
// every key padded gets about NEG_INF, for which the flash backward
// (flash_attention_bwd.cu) gives nothing.  The forward-only launch writes
// no LSE.
//
// Design (bf16, the LM paths): a block owns (one B*H row, 64 kWG query
// rows): kWG consumer warpgroups of 64 rows each (two at head dims up to
// 128, one at 256, where the accumulator takes 128 registers a thread)
// and one producer warp.  The producer's lane 0 copies each warpgroup's q
// tile once by TMA, then K and V tiles of 64 keys through a ring of
// kStages stages (3, or 2 at D 256), each stage completing on its own
// full mbarrier and released by the consumer warps on its empty one; K8's
// first pass asks the ring for K alone.  TMA writes the tiles in wgmma's
// swizzled layout (wgmma.cuh), zero-filling rows past T, so T need not be
// a multiple of 64.  s = q k^T is an SS wgmma with both operands K-major;
// p = 2^(s scale log2 e - m log2 e) is one FMA and one ex2; p is rounded
// to bf16 in registers (the reference keeps p in f32: the tolerance of
// the kernel against its plain version states this; l sums the f32 p) and
// is the register A operand of acc += p v, whose B operand is the V tile
// read MN-major through the descriptor: no transposed copy of V is made.
// The masks are applied only on tiles that cross the causal diagonal of a
// warpgroup's rows or the Tk tail; with the key bias every tile adds it,
// and a tile whose keys are all padded is skipped by the producer and the
// consumers alike (both read the bias and vote per warp).  A warpgroup
// waits for and releases every tile of its block but computes only those
// up to its own causal frontier.  Head dims 16, 32, 64, 128 and 256 (the
// wrapper zero-pads others up to 256): D 16 rows take the 32-byte swizzle,
// D 32 the 64-byte one, D >= 64 panels of 64 columns with the 128-byte
// one.  At D 256 the q tile (32 KB) and two stages of K and V (64 KB each)
// take 160 KB of shared memory.
// * f32: FFMA, one block of 4 warps a (B*H row, 64 query rows), 16 rows a
//   warp; K/V tiles of 64 keys staged through shared memory by the
//   threads; one lane per key of the tile for the scores, one lane per
//   output column for p v, in full f32.  At D 256 its dynamic shared
//   memory is 213 248 bytes and each lane holds 16 rows x 8 columns of
//   acc.
// Bound on the H100 at the path's shapes (T 2048 and 8192, D 64): the
// tensor cores' rate over the causal half of the FLOPs in bf16 (K/V are
// read once per block of 64 kWG query rows, from L2 mostly), FFMA in
// f32.  K8 computes the scores twice (6 D FLOPs a query-key pair against
// K9's 4 D).  Within a warpgroup a tile's products and its softmax run in
// series; the other warpgroup and the other blocks on the SM fill the gaps.
#include <cstdint>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bigdl::ex2;
using bigdl::pack_bf16x2;
using bf16 = __nv_bfloat16;
namespace wg = bigdl::wg;
using wg::frag_col;
using wg::frag_row;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;             // query rows of an f32 block and of a
                                    // bf16 consumer warpgroup
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kAttnThreads = 128;   // f32: 4 warps, 16 rows each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Tk) or null
  void* o;
  float* lse;         // (B*H, Tq) row logsumexp, written when kLse
  int h, hk, tq, tk;
  float scale;
  bool causal;
};

struct Rows {  // an f32 block's place in the problem
  long long q_row, kv_row;  // first element of q/o and of k/v
  const float* bias;
  int q0, k_end;
};

__device__ __forceinline__ Rows block_rows(const Params& p, int d) {
  const int bh = blockIdx.y;
  const int qblk = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  Rows r;
  r.q0 = qblk * kBQ;
  const int b = bh / p.h;
  const long long kv = static_cast<long long>(b) * p.hk +
                       (bh % p.h) / (p.h / p.hk);
  r.q_row = static_cast<long long>(bh) * p.tq * d;
  r.kv_row = kv * p.tk * d;
  r.bias = p.bias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;
  r.k_end = p.causal ? min(p.tk, r.q0 + kBQ) : p.tk;
  return r;
}

// the masked, scaled score of (q_pos, k_pos); bs is the tile's bias
// (indexed by col) or the bias row (indexed by k_pos, col = k_pos)
__device__ __forceinline__ float mask_score(float dot, const Params& p,
                                            int q_pos, int k_pos,
                                            const float* bs, int col) {
  if (k_pos >= p.tk) return -INFINITY;  // ragged tail: no key at all
  float x = dot * p.scale;
  if (p.causal && q_pos < k_pos) x = kNegInf;
  if (bs) x += bs[col];
  return x;
}

// Stage the tile's bias in shared memory and report whether any of its
// keys is real (a barrier for the whole block).
__device__ __forceinline__ int stage_bias(const Rows& r, const Params& p,
                                          int k0, float* bs) {
  const int tid = threadIdx.x;
  bool real = false;
  if (tid < kBK) {
    const float b = k0 + tid < p.tk ? r.bias[k0 + tid] : kNegInf;
    bs[tid] = b;
    real = b > kNegInf / 2;
  }
  return __syncthreads_or(real);
}

// ---- bfloat16: wgmma on TMA tiles, one producer warp -----------------------

template <int D>
struct Bf16 {  // the block's shape and its shared memory, from a 1024-byte
               // aligned base
  static constexpr int kWG = D <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr int kRows = kWG * kBQ;       // query rows a block
  static constexpr int kThreads = kWG * 128 + 32;
  static constexpr int kTile = kBQ * D * 2;     // a q, K or V tile
  static constexpr int kQ = 0;                  // + warpgroup * kTile
  static constexpr int kK = kWG * kTile;        // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// whether any key of the tile at k0 is real, by the bias; the whole warp
// calls it and gets one answer (the producer and every consumer warp read
// the same bias, so they skip the same tiles)
__device__ __forceinline__ bool keys_live(const float* bias, int k0,
                                          int tk) {
  const int a = k0 + (threadIdx.x & 31), b = a + 32;
  const bool live = (a < tk && bias[a] > kNegInf / 2) ||
                    (b < tk && bias[b] > kNegInf / 2);
  return __any_sync(0xffffffffu, live);
}

// s = the 64 rows of tile a times the 64 rows of tile b, transposed, over
// D; the first k16 step only writes s
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a,
                                       uint32_t b) {
  using T = wg::Tile<D>;
  wg::Ss<64>::mma<true>(s, T::template kmajor<kBQ>(a, 0),
                        T::template kmajor<kBK>(b, 0));
#pragma unroll
  for (int ks = 1; ks < D / 16; ++ks)
    wg::Ss<64>::mma<false>(s, T::template kmajor<kBQ>(a, ks),
                           T::template kmajor<kBK>(b, ks));
}

// s (raw dots) into the masked, scaled scores: the whole mask on an edge
// tile (it crosses the causal diagonal of these rows or the Tk tail), else
// the bias alone
template <bool kBias>
__device__ __forceinline__ void mask(float (&s)[32], const Params& p,
                                     const int (&row)[2], int k0,
                                     const float* bias, bool edge) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int k = k0 + frag_col(i);
    if (edge)
      s[i] = mask_score(s[i], p, row[(i >> 1) & 1], k,
                        kBias ? bias : nullptr, k);
    else if (kBias)
      s[i] = s[i] * p.scale + bias[k];
  }
}

// each row's max over the tile, of s times scale (kRaw: s holds the raw
// dots of a tile that needs no mask) or of s
template <bool kRaw>
__device__ __forceinline__ void row_max(const float (&s)[32],
                                        float (&mt)[2], float scale) {
  mt[0] = mt[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    mt[ri] = fmaxf(mt[ri], __shfl_xor_sync(0xffffffffu, mt[ri], 1));
    mt[ri] = fmaxf(mt[ri], __shfl_xor_sync(0xffffffffu, mt[ri], 2));
    if (kRaw) mt[ri] *= scale;
  }
}

// p from s (the raw dots when kRaw, else the masked, scaled scores x) and
// the rows' max m, into s; l += p; K9 (kGuard) gives p = 0 where
// x <= NEG_INF / 2
template <bool kRaw, bool kGuard>
__device__ __forceinline__ void probs(float (&s)[32], float (&l)[2],
                                      const float (&m)[2], float scale) {
  const float c = scale * kLog2e;
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ri = (i >> 1) & 1;
    float pj;
    if (kRaw)
      pj = ex2(fmaf(s[i], c, -ml[ri]));
    else if (kGuard)
      pj = s[i] > kNegInf / 2 ? ex2(fmaf(s[i], kLog2e, -ml[ri])) : 0.0f;
    else
      pj = ex2(fmaf(s[i], kLog2e, -ml[ri]));
    s[i] = pj;
    l[ri] += pj;
  }
}

// acc += p v over the tile: p rounded to bf16 as the register A operand, V
// read MN-major
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const float (&pr)[32],
                                           uint32_t vs) {
  uint32_t a[4][4];
  wg::to_a(pr, a);
  wg::mma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wg::mma_rs(acc, a[c], wg::Tile<D>::template mnmajor<kBK>(vs, c));
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::fence_regs(acc);
}

template <int D, bool kStream, bool kBias, bool kLse>
__global__ void __launch_bounds__(Bf16<D>::kThreads) attn_bf16(
    Params p, const __grid_constant__ CUtensorMap m_q,
    const __grid_constant__ CUtensorMap m_k,
    const __grid_constant__ CUtensorMap m_v) {
  using C = Bf16<D>;
  using T = wg::Tile<D>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kRows;  // longest first
  const int kvz = b * p.hk + (bh % p.h) / (p.h / p.hk);     // the KV row
  const int k_end = p.causal ? min(p.tk, q0 + C::kRows) : p.tk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const float* bias =
      kBias ? p.bias + static_cast<long long>(b) * p.tk : nullptr;
  const uint32_t full = base + C::kBars, empty = full + 8 * S,
                 qbar = empty + 8 * S;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4 * C::kWG);  // each consumer warp
    }
    wg::mbar_init(qbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * C::kWG) {  // the producer warp
    if (lane == 0) {
      wg::mbar_expect(qbar, C::kWG * C::kTile);
      for (int w = 0; w < C::kWG; ++w)
        T::template tma<kBQ>(base + C::kQ + w * C::kTile, &m_q, qbar,
                             q0 + w * kBQ, bh);
    }
    int it = 0;
    auto load = [&](int k0, bool with_v) {  // the next stage of the ring
      const int s = it % S;
      if (lane == 0) {
        if (it >= S) wg::mbar_wait(empty + 8 * s, (it / S - 1) & 1);
        wg::mbar_expect(full + 8 * s, (with_v ? 2 : 1) * C::kTile);
        T::template tma<kBK>(base + C::kK + s * C::kTile, &m_k, full + 8 * s,
                             k0, kvz);
        if (with_v)
          T::template tma<kBK>(base + C::kV + s * C::kTile, &m_v,
                               full + 8 * s, k0, kvz);
      }
      ++it;
    };
    if (!kStream)  // K8's first pass: K alone
      for (int t = 0; t < n_tiles; ++t) load(t * kBK, false);
    for (int t = 0; t < n_tiles; ++t) {
      if (kBias && !keys_live(bias, t * kBK, p.tk)) continue;
      load(t * kBK, true);
    }
    // leave only once the consumers have released the last stages
    if (lane == 0)
      for (int j = max(0, it - S); j < it; ++j)
        wg::mbar_wait(empty + 8 * (j % S), (j / S) & 1);
    return;
  }

  const int wgi = warp >> 2;               // this consumer warpgroup
  const int r0 = q0 + wgi * kBQ;           // its first row
  // its keys end: tiles past it lie in the future of all its rows
  const int r_end = r0 >= p.tq ? 0
                  : p.causal ? min(k_end, r0 + kBQ) : k_end;
  const uint32_t qs = base + C::kQ + wgi * C::kTile;
  int row[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) row[ri] = r0 + frag_row(2 * ri);
  float m[2], l[2] = {0.0f, 0.0f};
  m[0] = m[1] = kStream ? kNegInf : -INFINITY;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  wg::mbar_wait(qbar, 0);

  int it = 0;
  auto acquire = [&]() {  // the stage of the next tile, once it is full
    const int s = it % S;
    wg::mbar_wait(full + 8 * s, (it / S) & 1);
    return s;
  };
  auto release = [&](int s) {  // every product on the stage is done
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * s);
    ++it;
  };
  // mask this tile: it crosses the causal diagonal of these rows, or the
  // Tk tail
  auto edge_of = [&](int k0) {
    return (p.causal && k0 + kBK - 1 > r0) || k0 + kBK > p.tk;
  };

  if (!kStream) {  // K8 pass 1: the row max over every key
    for (int t = 0; t < n_tiles; ++t) {
      const int s = acquire(), k0 = t * kBK;
      if (k0 < r_end) {
        float sc[32], mt[2];
        wg::mma_fence();
        scores<D>(sc, qs, base + C::kK + s * C::kTile);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_regs(sc);
        if (edge_of(k0)) {
          mask<false>(sc, p, row, k0, nullptr, true);
          row_max<false>(sc, mt, p.scale);
        } else {
          row_max<true>(sc, mt, p.scale);
        }
        m[0] = fmaxf(m[0], mt[0]);
        m[1] = fmaxf(m[1], mt[1]);
      }
      release(s);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (kBias && !keys_live(bias, k0, p.tk)) continue;  // every key padded
    const int s = acquire();
    if (k0 < r_end) {
      float sc[32];
      wg::mma_fence();
      scores<D>(sc, qs, base + C::kK + s * C::kTile);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::fence_regs(sc);
      const bool edge = edge_of(k0);
      const bool raw = !kBias && !edge;  // no mask, no bias: the raw dots
      if (!raw) mask<kBias>(sc, p, row, k0, bias, edge);
      if (kStream) {  // the online rescale
        float mt[2];
        if (raw)
          row_max<true>(sc, mt, p.scale);
        else
          row_max<false>(sc, mt, p.scale);
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const float m_new = fmaxf(m[ri], mt[ri]);
          const float alpha = ex2((m[ri] - m_new) * kLog2e);
          m[ri] = m_new;
          l[ri] *= alpha;
#pragma unroll
          for (int i = 0; i < D / 2; ++i)
            if (((i >> 1) & 1) == ri) acc[i] *= alpha;
        }
        if (raw)
          probs<true, true>(sc, l, m, p.scale);
        else
          probs<false, true>(sc, l, m, p.scale);
      } else if (raw) {  // K8 pass 2
        probs<true, false>(sc, l, m, p.scale);
      } else {
        probs<false, false>(sc, l, m, p.scale);
      }
      accumulate<D>(acc, sc, base + C::kV + s * C::kTile);
    }
    release(s);
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
    if (kStream) l[ri] = fmaxf(l[ri], 1e-20f);
  }
  const long long q_row = static_cast<long long>(bh) * p.tq;
  bf16* o = static_cast<bf16*>(p.o) + q_row * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int ri = (i >> 1) & 1;
    if (row[ri] < p.tq)
      *reinterpret_cast<uint32_t*>(o + static_cast<long long>(row[ri]) * D +
                                   frag_col(i)) =
          pack_bf16x2(acc[i] / l[ri], acc[i + 1] / l[ri]);
  }
  if (kLse && (lane & 3) == 0)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      if (row[ri] < p.tq) p.lse[q_row + row[ri]] = m[ri] + logf(l[ri]);
}

// ---- float32: FFMA ----------------------------------------------------------

constexpr int f32_smem_floats(int d) {
  // q block, K tile (padded rows), V tile, p of each warp's 16 rows
  return kBQ * d + kBK * (d + 1) + kBK * d + 4 * 16 * kBK;
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

template <int D, bool kStream, bool kBias, bool kLse>
__global__ void __launch_bounds__(kAttnThreads) attn_f32(Params p) {
  constexpr int kCols = (D + 31) / 32;  // output columns of a lane
  extern __shared__ float sm[];
  float* qs = sm;                   // [kBQ][D]
  float* ks = qs + kBQ * D;         // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);   // [kBK][D]
  __shared__ float bs[kBK];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ps = vs + kBK * D + warp * 16 * kBK;  // [16][kBK] of this warp
  const Rows r = block_rows(p, D);
  const float* q = static_cast<const float*>(p.q) + r.q_row;
  const float* k = static_cast<const float*>(p.k) + r.kv_row;
  const float* v = static_cast<const float*>(p.v) + r.kv_row;
  const int row0 = r.q0 + warp * 16;

  for (int e = tid; e < kBQ * D; e += kAttnThreads) {
    const int rr = r.q0 + e / D;
    qs[e] = rr < p.tq ? q[static_cast<long long>(rr) * D + e % D] : 0.0f;
  }

  float m[16], l[16], acc[16][kCols];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = kStream ? kNegInf : -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  auto stage = [&](int k0, bool with_v) -> bool {
    __syncthreads();
    for (int e = tid; e < kBK * D; e += kAttnThreads) {
      const int key = e / D, c = e % D;
      const bool in = k0 + key < p.tk;
      const long long at = static_cast<long long>(k0 + key) * D + c;
      ks[key * (D + 1) + c] = in ? k[at] : 0.0f;
      if (with_v) vs[e] = in ? v[at] : 0.0f;
    }
    if (kBias) return stage_bias(r, p, k0, bs) != 0;
    __syncthreads();
    return true;
  };

  // s[j][i]: score of row row0 + i, key k0 + lane + 32 j
  auto scores = [&](int k0, float (&s)[2][16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[0][i] = s[1][i] = 0.0f;
    const float* k0p = ks + lane * (D + 1);
    const float* k1p = ks + (lane + 32) * (D + 1);
    const float* qp = qs + warp * 16 * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = k0p[d], b = k1p[d];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float qv = qp[i * D + d];
        s[0][i] = fmaf(qv, a, s[0][i]);
        s[1][i] = fmaf(qv, b, s[1][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s[j][i] = mask_score(s[j][i], p, row0 + i, k0 + lane + 32 * j,
                             kBias ? bs : nullptr, lane + 32 * j);
  };

  float s[2][16];
  if (!kStream) {  // K8 pass 1
    for (int k0 = 0; k0 < r.k_end; k0 += kBK) {
      stage(k0, false);
      scores(k0, s);
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = fmaxf(m[i], fmaxf(s[0][i], s[1][i]));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = warp_max(m[i]);
  }

  for (int k0 = 0; k0 < r.k_end; k0 += kBK) {
    if (!stage(k0, true)) continue;
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (kStream) {
        const float m_new = fmaxf(m[i], warp_max(fmaxf(s[0][i], s[1][i])));
        const float alpha = __expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = s[j][i];
        const float pj = kStream ? (x > kNegInf / 2 ? __expf(x - m[i]) : 0.0f)
                                 : __expf(x - m[i]);
        l[i] += pj;
        ps[i * kBK + lane + 32 * j] = pj;
      }
    }
    __syncwarp();
    for (int key = 0; key < kBK; ++key) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < D ? vs[key * D + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float pv = ps[i * kBK + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

  float* o = static_cast<float*>(p.o) + r.q_row;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float li = warp_sum(l[i]);
    if (kStream) li = fmaxf(li, 1e-20f);
    if (row0 + i >= p.tq) continue;
    if (kLse && lane == 0)
      p.lse[static_cast<long long>(blockIdx.y) * p.tq + row0 + i] =
          m[i] + logf(li);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D)
        o[static_cast<long long>(row0 + i) * D + col] = acc[i][c] / li;
    }
  }
}

// ---- launch -----------------------------------------------------------------

// the TMA map of a (z, n, D) bf16 tensor whose boxes are the panels of a
// 64-row tile (wgmma.cuh), swizzled as the tile is, rows past n zeros (a
// map of at least one row: with Tk = 0 no tile is copied)
template <int D>
bool tile_map(CUtensorMap* map, const void* ptr, int n, int z) {
  using T = bigdl::wg::Tile<D>;
  const cuuint64_t rows = n > 0 ? n : 1;
  return bigdl::tma::bf16_map<3>(
      map, ptr, {static_cast<cuuint64_t>(D), rows, static_cast<cuuint64_t>(z)},
      {static_cast<cuuint64_t>(D) * 2, rows * D * 2},
      {static_cast<cuuint32_t>(T::kW / 2), static_cast<cuuint32_t>(kBQ), 1u});
}

template <typename K, typename... A>
cudaError_t run(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                const A&... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <bool kStream, bool kBias, bool kLse, int D>
cudaError_t launch_d(const Params& p, int dtype, int bh, cudaStream_t s) {
  if (dtype == bigdl::kBF16) {
    using C = Bf16<D>;
    CUtensorMap mq, mk, mv;
    const int bk = bh / p.h * p.hk;
    if (!tile_map<D>(&mq, p.q, p.tq, bh) || !tile_map<D>(&mk, p.k, p.tk, bk) ||
        !tile_map<D>(&mv, p.v, p.tk, bk))
      return cudaErrorNotSupported;
    return run(attn_bf16<D, kStream, kBias, kLse>,
               dim3((p.tq + C::kRows - 1) / C::kRows, bh), C::kThreads,
               C::kBytes, s, p, mq, mk, mv);
  }
  if (dtype == bigdl::kF32)
    return run(attn_f32<D, kStream, kBias, kLse>,
               dim3((p.tq + kBQ - 1) / kBQ, bh), kAttnThreads,
               f32_smem_floats(D) * static_cast<int>(sizeof(float)), s, p);
  return cudaErrorInvalidValue;
}

template <bool kStream, bool kBias, bool kLse>
int launch(const Params& p, int dtype, int bh, int d, void* stream) {
  if (p.tq == 0 || bh == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (d) {
    case 16: e = launch_d<kStream, kBias, kLse, 16>(p, dtype, bh, s); break;
    case 32: e = launch_d<kStream, kBias, kLse, 32>(p, dtype, bh, s); break;
    case 64: e = launch_d<kStream, kBias, kLse, 64>(p, dtype, bh, s); break;
    case 128: e = launch_d<kStream, kBias, kLse, 128>(p, dtype, bh, s); break;
    case 256: e = launch_d<kStream, kBias, kLse, 256>(p, dtype, bh, s); break;
    default: break;
  }
  return static_cast<int>(e);
}

}  // namespace

// K8: q (bh, tq, d), k/v (bh / h * hk, tk, d) f32 or bf16 -> o like q
extern "C" int bigdl_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int bh, int h, int hk,
                                   int tq, int tk, int d, float scale,
                                   int causal, void* stream) {
  const Params p{q, k, v, nullptr, o, nullptr, h, hk, tq, tk, scale,
                 causal != 0};
  return launch<false, false, false>(p, dtype, bh, d, stream);
}

// K9: as K8, with an optional (bh / h, tk) f32 additive key-padding bias
// and, when lse is not null, the (bh, tq) f32 row logsumexp
extern "C" int bigdl_attention_stream_fwd(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* o, void* lse, int dtype,
                                          int bh, int h, int hk, int tq,
                                          int tk, int d, float scale,
                                          int causal, void* stream) {
  const Params p{q, k, v, static_cast<const float*>(bias), o,
                 static_cast<float*>(lse), h, hk, tq, tk, scale, causal != 0};
  if (bias) {
    if (lse) return launch<true, true, true>(p, dtype, bh, d, stream);
    return launch<true, true, false>(p, dtype, bh, d, stream);
  }
  if (lse) return launch<true, false, true>(p, dtype, bh, d, stream);
  return launch<true, false, false>(p, dtype, bh, d, stream);
}
