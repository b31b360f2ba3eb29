// The flash backward of the streaming attention (K9, attention.cu): dQ, dK
// and dV from q (B*H, Tq, D), k, v (B*Hk, Tk, D), K9's row logsumexp lse
// (B*H, Tq) f32, the upstream gradient do (like q), the optional (B, Tk)
// f32 additive key-padding bias and delta = rowsum(dO * O) (B*H, Tq) f32.
// Per (query, key) pair, p = exp(s - lse) (0 where s <= NEG_INF / 2, the
// guard applied before the exp: a row with every key padded has lse ~
// NEG_INF and would otherwise get exp(0) = 1), dp = dO v^T,
// ds = p (dp - delta) scale; dq = ds k, dk = ds^T q, dv = p^T dO.  Query
// head i of batch row b reads KV row b*Hk + i / (H / Hk) (GQA); the causal
// mask is top-left aligned (q_pos >= k_pos), masked scores NEG_INF.
//
// The delta pass (bigdl_flash_bwd_delta) computes delta once per backward,
// 8 lanes a row with 16-byte loads of O and dO, for K10 and K11 to share:
// the TPU kernels recomputed it per block (bigdl_tpu/ops/attention.py
// `_bwd_dq_kernel`, `_bwd_dkv_kernel`), where the VPU had cycles to spare;
// per (KV tile, query tile) that is Tk / 64 strided passes over O and dO
// for every row.  It reads 2 Tq D elements and is bound by bytes.
//
// K10 replaces `_bwd_dq_kernel` (via `_flash_streaming_bwd`).  The TPU
// kernel carried dq in VMEM scratch over a sequential K grid axis.  Here a
// block owns (one B*H row, 64 query rows), keeps dq in f32 registers, and
// walks the 64-key K/V tiles up to the causal frontier, last rows first
// (they have the most tiles), skipping tiles whose keys are all padded, as
// K9 does.  K11 replaces `_bwd_dkv_kernel`.  The TPU kernel ran an inner
// grid of group * n_q_blocks steps per KV block (every query block of every
// query head sharing the KV head) into VMEM scratch.  Here a block owns
// (one B*Hk row, 64 keys), first keys first, keeps dk and dv in f32
// registers, and loops over the same group * n_q query tiles of 64 rows
// itself, from its causal frontier on.  So neither needs an atomicAdd:
// their sums have a fixed order and two launches are bit-equal.  A K11
// tile whose keys are all padded writes zeros and loops over nothing.
//
// * bf16 (the long-context path): bound by the tensor cores' rate over the
//   causal half of 6 D (K10) and 8 D (K11) FLOPs per pair and head.  A
//   block is one warpgroup (128 threads) and every product a Hopper wgmma
//   (wgmma.cuh) with f32 accumulators.  The tiles that stay (q and dO for
//   K10, k and v for K11) are copied once into shared memory by TMA; the
//   streamed tiles (k and v for K10; q and dO for K11) come through a
//   3-stage ring, each stage filled by TMA two tiles ahead and completing
//   on its own mbarrier, so one thread's two copy instructions replace the
//   threads' loads and the copies overlap the products (the bias for K10,
//   lse and delta for K11 ride along as 4-byte cp.async copies, since a row
//   of them need not be 16-byte aligned).  TMA writes the tiles in wgmma's
//   swizzled layout, zero-filling rows past T, and wgmma reads them
//   K-major for s = q k^T and dp = dO v^T (K11: s^T = k q^T,
//   dp^T = v dO^T), and MN-major, through the descriptor alone, for ds k
//   (K10), p^T dO and ds^T q (K11): no transposed copy is made.  p and ds
//   are rounded to bf16 in registers (p to dO's dtype, ds to q's, where the
//   reference rounds) and are the register A operand of the second
//   products.  The mask is applied only on tiles that cross the causal
//   diagonal or a ragged tail; inside, p = 2^(s c - lse log2 e) is one FMA
//   and one ex2.  What bounds them now: within a warpgroup a tile's first
//   products, its elementwise step and its second products run in series
//   (no producer warp, no ping-pong between warpgroups), so the tensor
//   cores idle during the elementwise step; the other blocks on the SM
//   hide part of it.
// * f32 (train_main's path): FFMA, one lane per key (K10) or per query
//   (K11) for the scores, one lane per output column for the products,
//   every tile staged single-buffered by the threads; bound by FFMA's rate
//   over the same FLOPs.  No TF32: the reference computes in f32.
// Head dims 16, 32, 64, 128 and 256 (the wrapper zero-pads others up to
// 256); rows past Tq or keys past Tk are zero-filled and masked, so T need
// not be a multiple of 64.  At D 256 (a tile of 64 rows is 32 KB in bf16):
// the bf16 ring has two stages, not three (K10: q and dO, then K and V a
// stage, 192 KB in all; K11: K and V, then q and dO a stage); the bf16 K11
// would need 256 registers a thread for dk and dv, so a block holds one
// half of their columns (a third grid axis) and recomputes s and dp over
// all of D, 1.5x the FLOPs; the f32 K10 takes 32 query rows a block (8 a
// warp) and the f32 K11 32 keys (4 a warp), 205 568 and 214 144 bytes of
// shared memory.
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
using wg::to_a;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;           // query rows (K10) or keys (K11) a
                                    // block, rows of a streamed tile
constexpr int kThreads = 128;       // f32 K10: 4 warps
constexpr int kF32DkvThreads = 256; // f32 K11: 8 warps
constexpr int kWgThreads = 128;     // bf16: one warpgroup a block

// bf16: the depth of the TMA ring; three stages of 64-row tiles at D 256
// would not fit a block's shared memory beside the tiles that stay
template <int D>
__host__ __device__ constexpr int stages() {
  return D <= 128 ? 3 : 2;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* delta;  // (B*H, Tq)
  const float* lse;
  const void* dout;
  const float* bias;  // (B, Tk) or null
  void* dq;
  void* dk;
  void* dv;
  int h, hk, tq, tk;
  float scale;
  bool causal;
};

// the masked, scaled score of (q_pos, k_pos); bias is the tile's in shared
// memory (null without one), indexed by the key's place in the tile
__device__ __forceinline__ float mask_score(float dot, const Params& p,
                                            int q_pos, int k_pos,
                                            const float* bs, int kcol) {
  if (k_pos >= p.tk || q_pos >= p.tq) return -INFINITY;  // ragged tails
  float x = dot * p.scale;
  if (p.causal && q_pos < k_pos) x = kNegInf;
  if (bs) x += bs[kcol];
  return x;
}

__device__ __forceinline__ float prob(float s, float lse) {
  return s > kNegInf / 2 ? __expf(s - lse) : 0.0f;
}

constexpr float kLog2e = 1.4426950408889634f;

// Stage n keys' bias from k0 into bs and report whether any of them is
// real (a barrier for the whole block).
__device__ __forceinline__ int stage_bias(const Params& p, int b, int k0,
                                          int n, float* bs) {
  bool real = false;
  if (threadIdx.x < n) {
    const int key = k0 + threadIdx.x;
    const float x = key < p.tk
        ? p.bias[static_cast<long long>(b) * p.tk + key] : kNegInf;
    bs[threadIdx.x] = x;
    real = x > kNegInf / 2;
  }
  return __syncthreads_or(real);
}

// the dynamic shared memory rounded up to the 1024 bytes the swizzle needs
// (kernels ask for 1024 more than their layout)
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw,
                                                 unsigned char** at) {
  const uint32_t a = wg::smem_addr(raw);
  const uint32_t base = (a + 1023u) & ~1023u;
  *at = raw + (base - a);
  return base;
}


// ---- K10, bfloat16 ---------------------------------------------------------

template <int D>
struct DqLayout {  // byte offsets from the 1024-aligned base
  static constexpr int kStages = stages<D>();
  static constexpr int kKv = kTile * D * 2;  // one q, dO, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kKv;
  static constexpr int kK = 2 * kKv;         // + stage * kKv
  static constexpr int kV = kK + kStages * kKv;
  static constexpr int kBias = kV + kStages * kKv;
  static constexpr int kBars = kBias + kStages * kTile * 4;  // kStages + 1
  static constexpr int kBytes = kBars + (kStages + 1) * 8 + 1024;
};

// p, then ds = p (dp - delta) scale into s, for one 64 x 64 tile: rows of
// this thread r[2] with their lse and delta, keys k0 + column; kEdge masks
// (causal diagonal, ragged tails), else only the bias applies
template <bool kEdge, bool kBias>
__device__ __forceinline__ void dq_scores(float (&s)[32],
                                          const float (&dp)[32],
                                          const Params& p, const int (&r)[2],
                                          const float (&lse)[2],
                                          const float (&delta)[2], int k0,
                                          const float* bs) {
  const float c = p.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ri = (i >> 1) & 1, col = frag_col(i);
    float pj;
    if (!kEdge && !kBias) {  // no mask, and every row has a finite lse
      pj = ex2(fmaf(s[i], c, -lse[ri] * kLog2e));
    } else if (kEdge) {
      pj = prob(mask_score(s[i], p, r[ri], k0 + col, kBias ? bs : nullptr,
                           col), lse[ri]);
    } else {
      pj = prob(s[i] * p.scale + bs[col], lse[ri]);
    }
    s[i] = pj * (dp[i] - delta[ri]) * p.scale;
  }
}

// x = the 64 rows of tile a times the 64 rows of tile b, transposed, over D
template <int D>
__device__ __forceinline__ void product(float (&x)[32], uint32_t a,
                                        uint32_t b) {
  using T = wg::Tile<D>;
  wg::Ss<64>::mma<true>(x, T::template kmajor<kTile>(a, 0),
                        T::template kmajor<kTile>(b, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wg::Ss<64>::mma<false>(x, T::template kmajor<kTile>(a, kk),
                           T::template kmajor<kTile>(b, kk));
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kWgThreads) dq_bf16(
    Params p, const __grid_constant__ CUtensorMap m_q,
    const __grid_constant__ CUtensorMap m_do,
    const __grid_constant__ CUtensorMap m_k,
    const __grid_constant__ CUtensorMap m_v) {
  using T = wg::Tile<D>;
  using L = DqLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem_raw, &smem);
  const float* bias_s = reinterpret_cast<const float*>(smem + L::kBias);
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const long long q_row = static_cast<long long>(bh) * p.tq;
  const int kvz = b * p.hk + (bh % p.h) / (p.h / p.hk);  // the KV row
  const int k_end = p.causal ? min(p.tk, q0 + kTile) : p.tk;
  const int n_iter = (k_end + kTile - 1) / kTile;
  const uint32_t bars = base + L::kBars;  // a barrier a stage, then q's
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(bars + 8 * i, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  auto load_stage = [&](int it) {  // K, V (and the bias) of key tile it
    const int s = it % kStages, k0 = it * kTile;
    if (tid == 0) {
      wg::mbar_expect(bars + 8 * s, 2 * L::kKv);
      T::template tma<kTile>(base + L::kK + s * L::kKv, &m_k, bars + 8 * s,
                             k0, kvz);
      T::template tma<kTile>(base + L::kV + s * L::kKv, &m_v, bars + 8 * s,
                             k0, kvz);
    }
    if (kBias && tid < kTile) {
      const bool ok = k0 + tid < p.tk;
      wg::cp4(base + L::kBias + (s * kTile + tid) * 4,
              p.bias + static_cast<long long>(b) * p.tk + (ok ? k0 + tid : 0),
              ok);
    }
  };

  if (tid == 0) {  // q and dO, once
    wg::mbar_expect(bars + 8 * kStages, 2 * L::kKv);
    T::template tma<kTile>(base + L::kQ, &m_q, bars + 8 * kStages, q0, bh);
    T::template tma<kTile>(base + L::kDo, &m_do, bars + 8 * kStages, q0, bh);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_stage(s);
    wg::cp_commit();
  }

  int r[2];
  float lse[2], delta[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    r[ri] = q0 + frag_row(2 * ri);
    const bool in = r[ri] < p.tq;
    lse[ri] = in ? p.lse[q_row + r[ri]] : 0.0f;
    delta[ri] = in ? p.delta[q_row + r[ri]] : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  wg::mbar_wait(bars + 8 * kStages, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages, k0 = it * kTile;
    const float* bs = bias_s + s * kTile;
    wg::cp_wait<kStages - 2>();  // this thread's bias copies of tile it
    wg::mbar_wait(bars + 8 * s, (it / kStages) & 1);  // its K and V
    bool live = true;
    if (kBias) {                 // every thread's copies, and any key real
      live = __syncthreads_or(tid < kTile && k0 + tid < p.tk &&
                              bs[tid] > kNegInf / 2);
    } else {
      __syncthreads();
    }
    // into the stage of tile it - 1, whose products are done
    if (it + kStages - 1 < n_iter) load_stage(it + kStages - 1);
    wg::cp_commit();
    if (!live) continue;  // every key of the tile padded

    const uint32_t ks = base + L::kK + s * L::kKv;
    float sc[32], dp[32];
    wg::mma_fence();
    product<D>(sc, base + L::kQ, ks);                          // q k^T
    product<D>(dp, base + L::kDo, base + L::kV + s * L::kKv);  // dO v^T
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(sc);
    wg::fence_regs(dp);
    if ((p.causal && k0 + kTile - 1 > q0) || k0 + kTile > p.tk)
      dq_scores<true, kBias>(sc, dp, p, r, lse, delta, k0, bs);
    else
      dq_scores<false, kBias>(sc, dp, p, r, lse, delta, k0, bs);
    uint32_t a[4][4];
    to_a(sc, a);  // ds rounded to bf16, as the reference
    wg::mma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)  // dq += ds k, K read MN-major
      wg::mma_rs(acc, a[c], T::template mnmajor<kTile>(ks, c));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(acc);
  }

  bf16* dq = static_cast<bf16*>(p.dq) + q_row * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = q0 + frag_row(i);
    if (row < p.tq)
      *reinterpret_cast<uint32_t*>(dq + static_cast<long long>(row) * D +
                                   frag_col(i)) =
          pack_bf16x2(acc[i], acc[i + 1]);
  }
}

// ---- K11, bfloat16 ---------------------------------------------------------

template <int D>
struct DkvLayout {  // byte offsets from the 1024-aligned base
  static constexpr int kStages = stages<D>();
  // columns of dk and dv a block holds: all of D up to 128; at D 256 a
  // block holds one half (their f32 sums would take 256 registers a
  // thread) and recomputes s and dp, which span all of D
  static constexpr int kN = D <= 128 ? D : 128;
  static constexpr int kQd = kTile * D * 2;  // one K, V, q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kQd;
  static constexpr int kQ = 2 * kQd;         // + stage * kQd
  static constexpr int kDo = kQ + kStages * kQd;
  static constexpr int kLse = kDo + kStages * kQd;
  static constexpr int kDelta = kLse + kStages * kTile * 4;
  static constexpr int kBias = kDelta + kStages * kTile * 4;
  static constexpr int kBars = kBias + kTile * 4;  // kStages + 1 barriers
  static constexpr int kBytes = kBars + (kStages + 1) * 8 + 1024;
};

// p into st and ds = p (dp - delta) scale into dpt for one 64 x 64 tile of
// s^T: this thread's keys key[2] (their bias kb), queries q0 + column with
// their lse and delta in shared memory
template <bool kEdge, bool kBias>
__device__ __forceinline__ void dkv_scores(float (&st)[32], float (&dpt)[32],
                                           const Params& p,
                                           const int (&key)[2],
                                           const float (&kb)[2], int q0,
                                           const float* ls, const float* dl) {
  const float c = p.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = frag_col(4 * j);
    const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, ri = e >> 1;
      const float lse = (e & 1) ? l2.y : l2.x;
      const float delta = (e & 1) ? d2.y : d2.x;
      float pj;
      if (!kEdge && !kBias) {  // no mask, and every row has a finite lse
        pj = ex2(fmaf(st[i], c, -lse * kLog2e));
      } else {
        float x;
        if (kEdge) {
          x = mask_score(st[i], p, q0 + col + (e & 1), key[ri], nullptr, 0);
          if (kBias && x != -INFINITY) x += kb[ri];
        } else {
          x = st[i] * p.scale + kb[ri];
        }
        pj = prob(x, lse);
      }
      st[i] = pj;
      dpt[i] = pj * (dpt[i] - delta) * p.scale;
    }
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kWgThreads) dkv_bf16(
    Params p, const __grid_constant__ CUtensorMap m_q,
    const __grid_constant__ CUtensorMap m_do,
    const __grid_constant__ CUtensorMap m_k,
    const __grid_constant__ CUtensorMap m_v) {
  using T = wg::Tile<D>;
  using L = DkvLayout<D>;
  constexpr int kStages = L::kStages, kN = L::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem_raw, &smem);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
  const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
  float* bias_s = reinterpret_cast<float*>(smem + L::kBias);
  const int tid = threadIdx.x;
  const int kvr = blockIdx.y, b = kvr / p.hk, kvh = kvr % p.hk;
  const int group = p.h / p.hk;
  const int k0 = blockIdx.x * kTile;  // the most query tiles first
  const int c0 = blockIdx.z * kN;     // the block's first column of dk, dv
  // its panels of an MN-major q or dO tile start here
  const uint32_t cols = c0 / (T::kW / 2) * kTile * T::kW;
  const long long kv_row = static_cast<long long>(kvr) * p.tk;
  const uint32_t bars = base + L::kBars;  // a barrier a stage, then k's
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(bars + 8 * i, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  int key[2];
  float kb[2] = {0.0f, 0.0f};
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) key[ri] = k0 + frag_row(2 * ri);
  bool live = true;
  if (kBias) {  // a tile whose keys are all padded computes nothing
    const int kk = k0 + tid;
    const float x = kk < p.tk
        ? p.bias[static_cast<long long>(b) * p.tk + kk] : kNegInf;
    if (tid < kTile) bias_s[tid] = x;
    live = __syncthreads_or(tid < kTile && x > kNegInf / 2);
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) kb[ri] = bias_s[key[ri] - k0];
  }
  const int nq = (p.tq + kTile - 1) / kTile;
  const int first = p.causal ? min(k0 / kTile, nq) : 0;  // causal frontier
  const int per = nq - first;  // query tiles a head
  const int n_iter = live ? group * per : 0;

  auto load_stage = [&](int it) {  // q, dO, lse, delta of query tile it
    const int s = it % kStages;
    const int q0 = (first + it % per) * kTile;
    const int bh = b * p.h + kvh * group + it / per;
    const long long q_row = static_cast<long long>(bh) * p.tq;
    if (tid == 0) {
      wg::mbar_expect(bars + 8 * s, 2 * L::kQd);
      T::template tma<kTile>(base + L::kQ + s * L::kQd, &m_q, bars + 8 * s,
                             q0, bh);
      T::template tma<kTile>(base + L::kDo + s * L::kQd, &m_do, bars + 8 * s,
                             q0, bh);
    }
    // lse by the first 64 threads, delta by the next
    const int rr = tid % kTile;
    const bool ok = q0 + rr < p.tq;
    wg::cp4(base + (tid < kTile ? L::kLse : L::kDelta) + (s * kTile + rr) * 4,
            (tid < kTile ? p.lse : p.delta) + q_row + (ok ? q0 + rr : 0), ok);
  };

  float dka[kN / 2], dva[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dka[i] = dva[i] = 0.0f;

  if (n_iter > 0) {
    if (tid == 0) {  // k and v, once
      wg::mbar_expect(bars + 8 * kStages, 2 * L::kQd);
      T::template tma<kTile>(base + L::kK, &m_k, bars + 8 * kStages, k0,
                             kvr);
      T::template tma<kTile>(base + L::kV, &m_v, bars + 8 * kStages, k0,
                             kvr);
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_iter) load_stage(s);
      wg::cp_commit();
    }
    wg::mbar_wait(bars + 8 * kStages, 0);
  }
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = (first + it % per) * kTile;
    wg::cp_wait<kStages - 2>();  // this thread's lse and delta copies
    wg::mbar_wait(bars + 8 * s, (it / kStages) & 1);  // q and dO of tile it
    __syncthreads();             // every thread's copies
    // into the stage of tile it - 1, whose products are done
    if (it + kStages - 1 < n_iter) load_stage(it + kStages - 1);
    wg::cp_commit();

    const uint32_t qs = base + L::kQ + s * L::kQd;
    const uint32_t ds = base + L::kDo + s * L::kQd;
    float st[32], dpt[32];
    wg::mma_fence();
    product<D>(st, base + L::kK, qs);   // s^T = k q^T
    product<D>(dpt, base + L::kV, ds);  // dp^T = v dO^T
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(st);
    wg::fence_regs(dpt);
    const float* ls = lse_s + s * kTile;
    const float* dl = delta_s + s * kTile;
    if ((p.causal && q0 < k0 + kTile - 1) || q0 + kTile > p.tq ||
        k0 + kTile > p.tk)
      dkv_scores<true, kBias>(st, dpt, p, key, kb, q0, ls, dl);
    else
      dkv_scores<false, kBias>(st, dpt, p, key, kb, q0, ls, dl);
    uint32_t pa[4][4], da[4][4];
    to_a(st, pa);   // p rounded to dO's dtype
    to_a(dpt, da);  // ds to q's
    wg::mma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)  // dv += p^T dO, dO read MN-major
      wg::mma_rs(dva, pa[c], T::template mnmajor<kTile>(ds + cols, c));
#pragma unroll
    for (int c = 0; c < 4; ++c)  // dk += ds^T q, q read MN-major
      wg::mma_rs(dka, da[c], T::template mnmajor<kTile>(qs + cols, c));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(dva);
    wg::fence_regs(dka);
  }

  bf16* dk = static_cast<bf16*>(p.dk) + kv_row * D;
  bf16* dv = static_cast<bf16*>(p.dv) + kv_row * D;
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int kk = k0 + frag_row(i);
    if (kk >= p.tk) continue;
    const long long at = static_cast<long long>(kk) * D + c0 + frag_col(i);
    *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16x2(dka[i], dka[i + 1]);
    *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16x2(dva[i], dva[i + 1]);
  }
}

// ---- K10, float32 ----------------------------------------------------------

// query rows of an f32 K10 block: 64 (16 a warp), or 32 (8 a warp) at D
// 256, where 64 rows of q and dO beside the K and V tiles would not fit
template <int D>
__host__ __device__ constexpr int dq_f32_rows() {
  return D <= 128 ? kTile : kTile / 2;
}

template <int D>
constexpr int dq_f32_smem() {  // q, dO, K and V (padded rows), ds, bias
  return (2 * dq_f32_rows<D>() * D + 2 * kTile * (D + 1) +
          dq_f32_rows<D>() * kTile + kTile) * 4;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) dq_f32(Params p) {
  constexpr int kCols = (D + 31) / 32;  // output columns of a lane
  constexpr int kRows = dq_f32_rows<D>(), kWR = kRows / 4;  // rows a warp
  extern __shared__ float sm[];
  float* qs = sm;                      // [kRows][D]
  float* dos = qs + kRows * D;         // [kRows][D]
  float* ks = dos + kRows * D;         // [64][D + 1]
  float* vs = ks + kTile * (D + 1);    // [64][D + 1]
  float* bs = vs + kTile * (D + 1) + kRows * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = vs + kTile * (D + 1) + warp * kWR * kTile;  // this warp's ds
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const long long q_row = static_cast<long long>(bh) * p.tq * D;
  const long long kv_row = (static_cast<long long>(b) * p.hk +
                            (bh % p.h) / (p.h / p.hk)) * p.tk * D;
  const float* q = static_cast<const float*>(p.q) + q_row;
  const float* dout = static_cast<const float*>(p.dout) + q_row;
  const float* k = static_cast<const float*>(p.k) + kv_row;
  const float* v = static_cast<const float*>(p.v) + kv_row;
  const int row0 = q0 + warp * kWR;

  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int rr = q0 + e / D;
    const long long at = static_cast<long long>(rr) * D + e % D;
    qs[e] = rr < p.tq ? q[at] : 0.0f;
    dos[e] = rr < p.tq ? dout[at] : 0.0f;
  }
  __syncthreads();
  float lse[kWR], delta[kWR], acc[kWR][kCols];
#pragma unroll
  for (int i = 0; i < kWR; ++i) {
    const int rr = row0 + i;
    const long long at = static_cast<long long>(bh) * p.tq + rr;
    delta[i] = rr < p.tq ? p.delta[at] : 0.0f;
    lse[i] = rr < p.tq ? p.lse[at] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = p.causal ? min(p.tk, q0 + kRows) : p.tk;
  const float* qp = qs + warp * kWR * D;
  const float* dp_ = dos + warp * kWR * D;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int key = e / D, c = e % D;
      const bool in = k0 + key < p.tk;
      const long long at = static_cast<long long>(k0 + key) * D + c;
      ks[key * (D + 1) + c] = in ? k[at] : 0.0f;
      vs[key * (D + 1) + c] = in ? v[at] : 0.0f;
    }
    if (kBias) {
      if (!stage_bias(p, b, k0, kTile, bs)) continue;
    } else {
      __syncthreads();
    }
    // s[j][i], dp[j][i]: row row0 + i, key k0 + lane + 32 j
    float s[2][kWR], dp[2][kWR];
#pragma unroll
    for (int i = 0; i < kWR; ++i)
      s[0][i] = s[1][i] = dp[0][i] = dp[1][i] = 0.0f;
    const float* k0p = ks + lane * (D + 1);
    const float* k1p = ks + (lane + 32) * (D + 1);
    const float* v0p = vs + lane * (D + 1);
    const float* v1p = vs + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float ka = k0p[d], kb = k1p[d], va = v0p[d], vb = v1p[d];
#pragma unroll
      for (int i = 0; i < kWR; ++i) {
        const float qv = qp[i * D + d], dv = dp_[i * D + d];
        s[0][i] = fmaf(qv, ka, s[0][i]);
        s[1][i] = fmaf(qv, kb, s[1][i]);
        dp[0][i] = fmaf(dv, va, dp[0][i]);
        dp[1][i] = fmaf(dv, vb, dp[1][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lane + 32 * j;
#pragma unroll
      for (int i = 0; i < kWR; ++i) {
        const float x = mask_score(s[j][i], p, row0 + i, k0 + col,
                                   kBias ? bs : nullptr, col);
        ps[i * kTile + col] = prob(x, lse[i]) * (dp[j][i] - delta[i]) *
                              p.scale;
      }
    }
    __syncwarp();
    for (int key = 0; key < kTile; ++key) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        kv[c] = col < D ? ks[key * (D + 1) + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kWR; ++i) {
        const float x = ps[i * kTile + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(x, kv[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

  float* dq = static_cast<float*>(p.dq) + q_row;
#pragma unroll
  for (int i = 0; i < kWR; ++i) {
    if (row0 + i >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dq[static_cast<long long>(row0 + i) * D + col] = acc[i][c];
    }
  }
}

// ---- K11, float32 ----------------------------------------------------------

// keys of an f32 K11 block: 64 (8 a warp), or 32 (4 a warp) at D 256,
// where 64 keys of K and V beside the q and dO tiles would not fit
template <int D>
__host__ __device__ constexpr int dkv_f32_keys() {
  return D <= 128 ? kTile : kTile / 2;
}

template <int D>
constexpr int dkv_f32_smem() {  // K, V; q, dO (padded rows); p, ds; rows
  return (2 * dkv_f32_keys<D>() * D + 2 * kTile * (D + 1) +
          2 * dkv_f32_keys<D>() * kTile + 2 * kTile + dkv_f32_keys<D>()) *
         4;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kF32DkvThreads) dkv_f32(Params p) {
  constexpr int kCols = (D + 31) / 32;
  constexpr int kWarps = kF32DkvThreads / 32;
  constexpr int kKeys = dkv_f32_keys<D>(), kF32Keys = kKeys / kWarps;
  extern __shared__ float sm[];
  float* ks = sm;                          // [kKeys][D]
  float* vs = ks + kKeys * D;              // [kKeys][D]
  float* qs = vs + kKeys * D;              // [64][D + 1]
  float* dos = qs + kTile * (D + 1);       // [64][D + 1]
  float* pb = dos + kTile * (D + 1);       // [warps][keys a warp][64]
  float* db = pb + kKeys * kTile;
  float* lse_s = db + kKeys * kTile;
  float* delta_s = lse_s + kTile;
  float* bs = delta_s + kTile;             // [kKeys]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = pb + warp * kF32Keys * kTile;
  float* dw = db + warp * kF32Keys * kTile;
  const int kvr = blockIdx.y, b = kvr / p.hk, kvh = kvr % p.hk;
  const int group = p.h / p.hk;
  const int k0 = blockIdx.x * kKeys;
  const long long kv_row = static_cast<long long>(kvr) * p.tk * D;
  const int key0 = k0 + warp * kF32Keys;  // this warp's first key
  float* dk = static_cast<float*>(p.dk) + kv_row;
  float* dv = static_cast<float*>(p.dv) + kv_row;

  float dka[kF32Keys][kCols], dva[kF32Keys][kCols];
#pragma unroll
  for (int i = 0; i < kF32Keys; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.0f;

  const bool live = kBias ? stage_bias(p, b, k0, kKeys, bs) != 0 : true;
  if (live) {
    const float* k = static_cast<const float*>(p.k) + kv_row;
    const float* v = static_cast<const float*>(p.v) + kv_row;
    for (int e = threadIdx.x; e < kKeys * D; e += kF32DkvThreads) {
      const int kk = k0 + e / D;
      const long long at = static_cast<long long>(kk) * D + e % D;
      ks[e] = kk < p.tk ? k[at] : 0.0f;
      vs[e] = kk < p.tk ? v[at] : 0.0f;
    }
    const int nq = (p.tq + kTile - 1) / kTile;
    const int first = p.causal ? k0 / kTile : 0;
    const float* kp = ks + warp * kF32Keys * D;
    const float* vp = vs + warp * kF32Keys * D;
    for (int hh = 0; hh < group; ++hh) {
      const int bh = b * p.h + kvh * group + hh;
      const long long q_row = static_cast<long long>(bh) * p.tq * D;
      const float* q = static_cast<const float*>(p.q) + q_row;
      const float* dout = static_cast<const float*>(p.dout) + q_row;
      for (int qb = first; qb < nq; ++qb) {
        const int q0 = qb * kTile;
        __syncthreads();
        for (int e = threadIdx.x; e < kTile * D; e += kF32DkvThreads) {
          const int r = e / D, c = e % D;
          const bool in = q0 + r < p.tq;
          const long long at = static_cast<long long>(q0 + r) * D + c;
          qs[r * (D + 1) + c] = in ? q[at] : 0.0f;
          dos[r * (D + 1) + c] = in ? dout[at] : 0.0f;
        }
        if (threadIdx.x < kTile) {
          const int qr = q0 + threadIdx.x;
          const long long at = static_cast<long long>(bh) * p.tq + qr;
          delta_s[threadIdx.x] = qr < p.tq ? p.delta[at] : 0.0f;
          lse_s[threadIdx.x] = qr < p.tq ? p.lse[at] : 0.0f;
        }
        __syncthreads();
        // s[j][i], dp[j][i]: key key0 + i, query q0 + lane + 32 j
        float s[2][kF32Keys], dp[2][kF32Keys];
#pragma unroll
        for (int i = 0; i < kF32Keys; ++i)
          s[0][i] = s[1][i] = dp[0][i] = dp[1][i] = 0.0f;
        const float* q0p = qs + lane * (D + 1);
        const float* q1p = qs + (lane + 32) * (D + 1);
        const float* d0p = dos + lane * (D + 1);
        const float* d1p = dos + (lane + 32) * (D + 1);
#pragma unroll 2
        for (int d = 0; d < D; ++d) {
          const float qa = q0p[d], qb2 = q1p[d], da = d0p[d], db2 = d1p[d];
#pragma unroll
          for (int i = 0; i < kF32Keys; ++i) {
            const float kv = kp[i * D + d], vv = vp[i * D + d];
            s[0][i] = fmaf(kv, qa, s[0][i]);
            s[1][i] = fmaf(kv, qb2, s[1][i]);
            dp[0][i] = fmaf(vv, da, dp[0][i]);
            dp[1][i] = fmaf(vv, db2, dp[1][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = lane + 32 * j;
#pragma unroll
          for (int i = 0; i < kF32Keys; ++i) {
            const float x = mask_score(s[j][i], p, q0 + col, key0 + i,
                                       kBias ? bs : nullptr,
                                       warp * kF32Keys + i);
            const float pj = prob(x, lse_s[col]);
            pw[i * kTile + col] = pj;
            dw[i * kTile + col] = pj * (dp[j][i] - delta_s[col]) * p.scale;
          }
        }
        __syncwarp();
        for (int r = 0; r < kTile; ++r) {
          float qv[kCols], dov[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int col = lane + 32 * c;
            qv[c] = col < D ? qs[r * (D + 1) + col] : 0.0f;
            dov[c] = col < D ? dos[r * (D + 1) + col] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kF32Keys; ++i) {
            const float pv = pw[i * kTile + r], dsv = dw[i * kTile + r];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              dva[i][c] = fmaf(pv, dov[c], dva[i][c]);
              dka[i][c] = fmaf(dsv, qv[c], dka[i][c]);
            }
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kF32Keys; ++i) {
    if (key0 + i >= p.tk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        const long long at = static_cast<long long>(key0 + i) * D + col;
        dk[at] = dka[i][c];
        dv[at] = dva[i][c];
      }
    }
  }
}

// ---- the delta pass --------------------------------------------------------

constexpr int kDeltaLanes = 8;  // lanes a row

// delta[row] = sum over d of dO[row][d] * O[row][d] in f32 (both already in
// q's dtype), kDeltaLanes lanes a row with 16-byte loads where the row
// allows them
template <typename T>
__global__ void __launch_bounds__(bigdl::kThreads) delta_kernel(
    const T* o, const T* dout, float* delta, long long rows, int d) {
  constexpr int kV = 16 / sizeof(T);
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kDeltaLanes;
  const int lane = threadIdx.x % kDeltaLanes;
  float x = 0.0f;
  if (row < rows) {
    const T* a = o + row * d;
    const T* b = dout + row * d;
    if (d % kV == 0) {
      for (int c = lane * kV; c < d; c += kDeltaLanes * kV) {
        const uint4 ua = *reinterpret_cast<const uint4*>(a + c);
        const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
        const T* va = reinterpret_cast<const T*>(&ua);
        const T* vb = reinterpret_cast<const T*>(&ub);
#pragma unroll
        for (int i = 0; i < kV; ++i)
          x += bigdl::to_f32(va[i]) * bigdl::to_f32(vb[i]);
      }
    } else {
      for (int c = lane; c < d; c += kDeltaLanes)
        x += bigdl::to_f32(a[c]) * bigdl::to_f32(b[c]);
    }
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (row < rows && lane == 0) delta[row] = x;
}

// ---- launch ----------------------------------------------------------------

template <typename K, typename... A>
cudaError_t run(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                const A&... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// the TMA map of a (z, n, D) bf16 tensor whose boxes are the panels of a
// 64-row tile (wgmma.cuh), swizzled as the tile is, rows past n zeros
template <int D>
bool tile_map(CUtensorMap* map, const void* ptr, int n, int z) {
  using T = bigdl::wg::Tile<D>;
  return bigdl::tma::bf16_map<3>(
      map, ptr,
      {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
       static_cast<cuuint64_t>(z)},
      {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(n) * D * 2},
      {static_cast<cuuint32_t>(T::kW / 2), static_cast<cuuint32_t>(kTile),
       1u});
}

template <bool kDq, bool kBias, int D>
cudaError_t launch_d(const Params& p, int dtype, int b, cudaStream_t s) {
  if (dtype == bigdl::kBF16) {
    const dim3 grid_q((p.tq + kTile - 1) / kTile, b * p.h);
    const dim3 grid_k((p.tk + kTile - 1) / kTile, b * p.hk,
                      D / DkvLayout<D>::kN);
    CUtensorMap mq, mdo, mk, mv;
    if (!tile_map<D>(&mq, p.q, p.tq, b * p.h) ||
        !tile_map<D>(&mdo, p.dout, p.tq, b * p.h) ||
        !tile_map<D>(&mk, p.k, p.tk, b * p.hk) ||
        !tile_map<D>(&mv, p.v, p.tk, b * p.hk))
      return cudaErrorNotSupported;
    if (kDq)
      return run(dq_bf16<D, kBias>, grid_q, kWgThreads, DqLayout<D>::kBytes,
                 s, p, mq, mdo, mk, mv);
    return run(dkv_bf16<D, kBias>, grid_k, kWgThreads, DkvLayout<D>::kBytes,
               s, p, mq, mdo, mk, mv);
  }
  if (dtype == bigdl::kF32) {
    constexpr int rows = dq_f32_rows<D>(), keys = dkv_f32_keys<D>();
    if (kDq)
      return run(dq_f32<D, kBias>, dim3((p.tq + rows - 1) / rows, b * p.h),
                 kThreads, dq_f32_smem<D>(), s, p);
    return run(dkv_f32<D, kBias>, dim3((p.tk + keys - 1) / keys, b * p.hk),
               kF32DkvThreads, dkv_f32_smem<D>(), s, p);
  }
  return cudaErrorInvalidValue;
}

template <bool kDq>
int launch(const Params& p, int dtype, int b, int d, void* stream) {
  if (p.tq == 0 || p.tk == 0 || b == 0) return static_cast<int>(cudaSuccess);
  if (p.h % p.hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bias = p.bias != nullptr;
  cudaError_t e = cudaErrorInvalidValue;
  switch (d) {
#define BIGDL_CASE(DD)                                                   \
    case DD:                                                             \
      e = bias ? launch_d<kDq, true, DD>(p, dtype, b, s)                 \
               : launch_d<kDq, false, DD>(p, dtype, b, s);               \
      break;
    BIGDL_CASE(16)
    BIGDL_CASE(32)
    BIGDL_CASE(64)
    BIGDL_CASE(128)
    BIGDL_CASE(256)
#undef BIGDL_CASE
    default: break;
  }
  return static_cast<int>(e);
}

}  // namespace

// delta (rows) f32 = rowsum(dO * O) over d, for o and do (rows, d) in one
// dtype
extern "C" int bigdl_flash_bwd_delta(const void* o, const void* dout,
                                     void* delta, int dtype, long long rows,
                                     int d, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = bigdl::blocks_for(rows * kDeltaLanes);
  float* out = static_cast<float*>(delta);
  if (dtype == bigdl::kBF16)
    delta_kernel<<<blocks, bigdl::kThreads, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), out,
        rows, d);
  else if (dtype == bigdl::kF32)
    delta_kernel<<<blocks, bigdl::kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), out,
        rows, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K10: dq (b*h, tq, d) like q from q, k, v, delta (b*h, tq) f32, lse
// (b*h, tq) f32, do and an optional (b, tk) f32 bias
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* delta, const void* lse,
                                  const void* dout, const void* bias,
                                  void* dq, int dtype, int b, int h, int hk,
                                  int tq, int tk, int d, float scale,
                                  int causal, void* stream) {
  const Params p{q, k, v, static_cast<const float*>(delta),
                 static_cast<const float*>(lse), dout,
                 static_cast<const float*>(bias), dq, nullptr, nullptr, h,
                 hk, tq, tk, scale, causal != 0};
  return launch<true>(p, dtype, b, d, stream);
}

// K11: dk, dv (b*hk, tk, d) like k, each summed over the query heads that
// share its KV head
extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* delta, const void* lse,
                                   const void* dout, const void* bias,
                                   void* dk, void* dv, int dtype, int b,
                                   int h, int hk, int tq, int tk, int d,
                                   float scale, int causal, void* stream) {
  const Params p{q, k, v, static_cast<const float*>(delta),
                 static_cast<const float*>(lse), dout,
                 static_cast<const float*>(bias), nullptr, dk, dv, h, hk,
                 tq, tk, scale, causal != 0};
  return launch<false>(p, dtype, b, d, stream);
}
