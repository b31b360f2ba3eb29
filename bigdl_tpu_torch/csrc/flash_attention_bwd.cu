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
// block owns (one B*H row, 64 query rows; f32 as below), keeps dq in f32
// registers, and walks the K/V tiles up to the causal frontier, last rows
// first
// (they have the most tiles), skipping tiles whose keys are all padded, as
// K9 does.  K11 replaces `_bwd_dkv_kernel`.  The TPU kernel ran an inner
// grid of group * n_q_blocks steps per KV block (every query block of every
// query head sharing the KV head) into VMEM scratch.  Here a block owns
// (one B*Hk row, 64 keys; f32 as below), first keys first, keeps dk and
// dv in f32 registers, and loops over the same group * n_q query tiles
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
// * f32 (train_main's path): bound by FFMA's rate over the same FLOPs (no
//   TF32: the reference computes in f32), and as much by what shared
//   memory hands the FFMA units: 128 bytes a clock an SM, one 4-byte
//   register a lane, against 128 FFMA lanes, so a product loop keeps pace
//   only with 4 FFMA or more per register it loads.  A block is 256
//   threads, one an SM (up to 254 registers a thread, no spills).  The tiles
//   that stay (q, dO, lse and delta for K10; K and V for K11) are copied
//   once; the streamed tiles (K, V and the bias for K10; q, dO, lse and
//   delta for K11) come through a 2-stage ring of 16-byte cp.async.cg
//   copies (4-byte ones for lse, delta and the bias), each tile's issued
//   while the tile before it is computed; rows past T are zero-filled by a
//   source size of 0.  The block's two halves split the products: the
//   first sums s, the second dp, each thread an 8 x 8 micro-tile read as
//   float2 along D (16 loads for 128 FFMA: 8 a load instruction, 4 a
//   register).  K10's halves then hand each other s or dp through ds^T in
//   shared memory and each finishes ds for one half of the tile's keys, and
//   sums dq = ds k over them (adding the two halves' dq at the end); K11's
//   first half writes p and sums dv = p^T dO while the second turns p into
//   ds and sums dk = ds^T q (named barriers let each half go on as soon as
//   its operand is whole).  In those second products a thread owns 8
//   output rows x 8 columns and reads p or ds (stored transposed: a row a
//   key for K10, a row a query for K11) and the streamed tile's row as
//   float4: 4 loads for 64 FFMA, 16 a load instruction, 4 a register.
//   Rows are padded to D + 4 floats, so a warp's loads are free of bank
//   conflicts.  Tiles (a block's own x streamed), and micro-tiles (scores;
//   outputs): up to D 64 K10 128 query rows x 64 keys and K11 128 keys x 64
//   query rows (8 x 8; 8 x 8, but 8 x 4 at D 32 and 4 x 4 at D 16, 10.7 and
//   8 FFMA a load instruction); at D 128 K10 64 x 64 (8 x 4, 5.3 a load
//   instruction; 8 x 8) and K11 64 x 32, since 64 rows of q and dO would
//   not fit beside K and V (4 x 4, 4; 8 x 8); at D 256 both 32 x 32 (4 x 2,
//   2.7; 8 x 8).  The mask only on tiles across the causal diagonal or a
//   ragged tail; elsewhere, without a bias, p = 2^(s c - lse log2 e).
//   The copies, `dots`, `outer` and the named barriers are ffma.cuh's,
//   shared with the f32 forward (attention.cu).
// Head dims 16, 32, 64, 128 and 256 (the wrapper zero-pads others up to
// 256); rows past Tq or keys past Tk are zero-filled and masked, so T need
// not be a multiple of a tile.  At D 256 (a tile of 64 rows is 32 KB in
// bf16): the bf16 ring has two stages, not three (K10: q and dO, then K and
// V a stage, 192 KB in all; K11: K and V, then q and dO a stage); the bf16
// K11 would need 256 registers a thread for dk and dv, so a block holds one
// half of their columns (a third grid axis) and recomputes s and dp over
// all of D, 1.5x the FLOPs.
#include <cstdint>

#include "common.cuh"
#include "ffma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bigdl::ex2;
using bigdl::pack_bf16x2;
using bigdl::rounded;
using bf16 = __nv_bfloat16;
namespace wg = bigdl::wg;
using bigdl::ffma::bar_arrive;
using bigdl::ffma::bar_sync;
using bigdl::ffma::col_at;
using bigdl::ffma::copy_row;
using bigdl::ffma::copy_rows;
using bigdl::ffma::dots;
using bigdl::ffma::outer;
using bigdl::ffma::store_row;
using wg::frag_col;
using wg::frag_row;
using wg::to_a;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;           // query rows (K10) or keys (K11) a
                                    // block, rows of a streamed tile
constexpr int kF32Threads = 256;    // f32 K10 and K11: 8 warps
constexpr int kThreads = 128;       // dq_wide: 4 warps
constexpr int kWideDkvThreads = 256;  // dkv_wide: 8 warps
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

// ---- K10 and K11, float32 --------------------------------------------------

// The tiles of the f32 K10 and K11.  The outer side is a block's own (K10:
// its query rows, whose q and dO stay; K11: its keys, whose K and V stay),
// the inner side comes through the ring (K10: the keys of a K/V tile; K11:
// the query rows of a q/dO tile).  A block's two halves of 128 threads
// split every product: the first half sums s, the second dp (each thread
// a kAo x kAi micro-tile of outer x inner); then K10's halves each sum dq
// over one half of the tile's keys (added at the end), K11's first half dv
// and its second dk (each thread kCo outer indices x kCc columns).  Rows
// of q, K, V and dO are padded to D + 4 floats and rows of p and ds to
// kOuter + 4: 16-byte aligned, and eight consecutive rows start on eight
// distinct 8-byte bank pairs.
template <int D, bool kDq>
struct F32Tiles {
  static constexpr int kD = D;
  static constexpr int kOuter = D <= 64 ? 128 : D == 128 ? 64 : 32;
  // K11 at D 128 streams 32 query rows: 64 would not fit beside its K/V
  static constexpr int kInner = D <= 64 || (kDq && D == 128) ? 64 : 32;
  static constexpr int kAo = D <= 64 || (kDq && D == 128) ? 8 : 4;
  static constexpr int kAi = kOuter * kInner / 128 / kAo;
  static constexpr int kAog = kOuter / kAo, kAig = kInner / kAi;
  static constexpr int kCo = D == 16 ? 4 : 8;
  static constexpr int kCc = kOuter * D / 128 / kCo;
  static constexpr int kCcg = D / kCc;
  static constexpr int kVec = kCc < 4 ? kCc : 4;
  static constexpr int kLd = D + 4, kLdx = kOuter + 4;
  static constexpr int kTileF = kInner * kLd;  // floats of a streamed tile
  // floats: K10 q, dO; K and V a stage; the bias a stage; lse, delta; ds^T.
  // K11 K, V; q and dO a stage; lse and delta a stage; p, ds
  static constexpr int kFloats =
      kDq ? 2 * kOuter * kLd + 2 * 2 * kTileF + 2 * kInner + 2 * kOuter +
                kInner * kLdx
          : 2 * kOuter * kLd + 2 * 2 * kTileF + 2 * 2 * kInner +
                2 * kInner * kLdx;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kAog * kAig == 128 && kAog >= 4 && kAig >= 8, "s lanes");
  static_assert(kOuter / kCo * kCcg == 128, "output lanes");
};

// A thread's half and indices.  In s or dp its outer indices are ao +
// kAog i and its inner ones ai + kAig j, a warp 4 x 8 of them, so that a
// warp's loads of either side read 4 or 8 consecutive rows.  In the
// outputs its outer indices are co + i (i < kCo) and its columns cc kVec +
// g kCcg kVec + e (e < kVec), a warp 4 x 8 of them (8 x 4 at D 16): its
// loads of p or ds read 128 consecutive bytes, its loads of the streamed
// tile 32 consecutive floats or fewer.
template <typename C>
struct F32Lanes {
  int half, ao, ai, co, cc;
  __device__ __forceinline__ F32Lanes() {
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    half = threadIdx.x / 128;
    constexpr int kAw = C::kAig / 8;  // warps across the inner side
    ao = w / kAw * 4 + l / 8;
    ai = w % kAw * 8 + l % 8;
    constexpr int kLw = C::kCcg < 8 ? C::kCcg : 8;  // lanes across columns
    constexpr int kCw = C::kCcg / kLw;              // warps across columns
    co = (w / kCw * (32 / kLw) + l / kLw) * C::kCo;
    cc = w % kCw * kLw + l % kLw;
  }
};

// p of one score: the masked path (kEdge: causal diagonal, ragged tails;
// bias b added unless masked), the bias alone, or neither (one FMA and one
// ex2 on log2e-scaled operands: every row has a finite lse there)
template <bool kEdge, bool kBias>
__device__ __forceinline__ float tile_p(float s, const Params& p, int q_pos,
                                        int k_pos, float b, float lse) {
  if (!kEdge && !kBias) return ex2(fmaf(s, p.scale * kLog2e, -lse * kLog2e));
  float x;
  if (kEdge) {
    x = mask_score(s, p, q_pos, k_pos, nullptr, 0);
    if (kBias && x != -INFINITY) x += b;
  } else {
    x = s * p.scale + b;
  }
  return prob(x, lse);
}

// K10's ds of one tile for the keys half H finishes (its j in [H kAi / 2,
// (H + 1) kAi / 2)): the thread's rows q0 + ao + kAog i (their lse and
// delta in ls, dl) and keys k0 + ai + kAig j (their bias in bs); it holds
// s (H 0) or dp (H 1) in sd, and the other half left the other operand at
// the element's place in ds^T (xs, a row of kOuter + 4 a key), where ds
// goes
template <typename C, int H, bool kEdge, bool kBias>
__device__ __forceinline__ void dq_ds(const float (&sd)[C::kAo][C::kAi],
                                      const Params& p, int q0, int k0,
                                      const F32Lanes<C>& ln, const float* ls,
                                      const float* dl, const float* bs,
                                      float* xs) {
  constexpr int kJh = C::kAi / 2;
#pragma unroll
  for (int i = 0; i < C::kAo; ++i) {
    const int row = ln.ao + C::kAog * i;
    const float lse = ls[row], delta = dl[row];
#pragma unroll
    for (int j = H * kJh; j < (H + 1) * kJh; ++j) {
      const int key = ln.ai + C::kAig * j;
      float* at = xs + key * C::kLdx + row;
      const float s = H == 0 ? sd[i][j] : *at;
      const float dp = H == 0 ? *at : sd[i][j];
      *at = tile_p<kEdge, kBias>(s, p, q0 + row, k0 + key,
                                 kBias ? bs[key] : 0.0f, lse) *
            (dp - delta) * p.scale;
    }
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kF32Threads, 1) dq_f32_ring(Params p) {
  using C = F32Tiles<D, true>;
  constexpr int kOuter = C::kOuter, kInner = C::kInner, kLd = C::kLd;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [kOuter][kLd]
  float* dos = qs + kOuter * kLd;        // [kOuter][kLd]
  float* ks = dos + kOuter * kLd;        // [stage][kInner][kLd]
  float* vs = ks + 2 * C::kTileF;        // [stage][kInner][kLd]
  float* bias_s = vs + 2 * C::kTileF;    // [stage][kInner]
  float* ls = bias_s + 2 * kInner;       // [kOuter]
  float* dl = ls + kOuter;               // [kOuter]
  float* xs = dl + kOuter;               // [kInner][kLdx]: s or dp, ds
  const int tid = threadIdx.x;
  const F32Lanes<C> ln;
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOuter;  // longest rows first
  const long long q_row = static_cast<long long>(bh) * p.tq;
  const long long kv_row = (static_cast<long long>(b) * p.hk +
                            (bh % p.h) / (p.h / p.hk)) * p.tk;
  const float* k = static_cast<const float*>(p.k) + kv_row * D;
  const float* v = static_cast<const float*>(p.v) + kv_row * D;
  const int k_end = p.causal ? min(p.tk, q0 + kOuter) : p.tk;
  const int n_iter = (k_end + kInner - 1) / kInner;

  // q, dO, lse and delta once, then K, V (and the bias) of key tile 0
  copy_rows<D, kOuter, kF32Threads>(
      qs, static_cast<const float*>(p.q) + q_row * D, q0, p.tq);
  copy_rows<D, kOuter, kF32Threads>(
      dos, static_cast<const float*>(p.dout) + q_row * D, q0, p.tq);
  copy_row(ls, p.lse + q_row, q0, p.tq, 0, kOuter);
  copy_row(dl, p.delta + q_row, q0, p.tq, kOuter, kOuter);
  auto load_stage = [&](int it) {
    const int s = it % 2, k0 = it * kInner;
    copy_rows<D, kInner, kF32Threads>(ks + s * C::kTileF, k, k0, p.tk);
    copy_rows<D, kInner, kF32Threads>(vs + s * C::kTileF, v, k0, p.tk);
    if (kBias)
      copy_row(bias_s + s * kInner, p.bias + static_cast<long long>(b) * p.tk,
               k0, p.tk, 0, kInner);
  };
  if (n_iter > 0) load_stage(0);
  wg::cp_commit();

  // the thread's dq over its half's keys of every tile
  float acc[C::kCo][C::kCc];
#pragma unroll
  for (int i = 0; i < C::kCo; ++i)
#pragma unroll
    for (int c = 0; c < C::kCc; ++c) acc[i][c] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % 2, k0 = it * kInner;
    const float* kt = ks + s * C::kTileF;
    const float* vt = vs + s * C::kTileF;
    const float* bs = bias_s + s * kInner;
    wg::cp_wait<0>();  // this thread's copies of tile it
    bool live = true;
    if (kBias) {       // every thread's copies, and any key real
      live = __syncthreads_or(tid < kInner && k0 + tid < p.tk &&
                              bs[tid] > kNegInf / 2);
    } else {
      __syncthreads();
    }
    // into the other stage, whose tile it - 1 is done
    if (it + 1 < n_iter) load_stage(it + 1);
    wg::cp_commit();
    if (!live) continue;  // every key of the tile padded

    // the first half s = q k^T, the second dp = dO v^T
    float sd[C::kAo][C::kAi];
    dots<C>(sd, (ln.half ? dos : qs) + ln.ao * kLd,
            (ln.half ? vt : kt) + ln.ai * kLd);
    // each half finishes ds for one half of the keys (the first the lower
    // keys, j < kAi / 2): it leaves its s or dp of the other keys in ds^T
    // for the other half, then reads the other's at its own
    constexpr int kJh = C::kAi / 2;
#pragma unroll
    for (int i = 0; i < C::kAo; ++i)
#pragma unroll
      for (int j = 0; j < C::kAi; ++j)
        if ((j < kJh) == (ln.half == 1))
          xs[(ln.ai + C::kAig * j) * C::kLdx + ln.ao + C::kAog * i] =
              sd[i][j];
    __syncthreads();
    const bool edge =
        (p.causal && k0 + kInner - 1 > q0) || k0 + kInner > p.tk;
    if (ln.half == 0) {
      if (edge)
        dq_ds<C, 0, true, kBias>(sd, p, q0, k0, ln, ls, dl, bs, xs);
      else
        dq_ds<C, 0, false, kBias>(sd, p, q0, k0, ln, ls, dl, bs, xs);
    } else {
      if (edge)
        dq_ds<C, 1, true, kBias>(sd, p, q0, k0, ln, ls, dl, bs, xs);
      else
        dq_ds<C, 1, false, kBias>(sd, p, q0, k0, ln, ls, dl, bs, xs);
    }
    // dq += ds k over the half's keys, once the half's ds is whole
    if (ln.half == 0)
      bar_sync(2, kF32Threads / 2);
    else
      bar_sync(3, kF32Threads / 2);
    constexpr int kHalf = kInner / 2;
    outer<C, kHalf>(acc, xs + ln.half * kHalf * C::kLdx + ln.co,
                    kt + ln.half * kHalf * kLd + ln.cc * C::kVec);
  }

  // dq = the first half's sum + the second's, through q's rows
  if (ln.half == 1) {
#pragma unroll
    for (int i = 0; i < C::kCo; ++i)
      store_row<C>(qs + (ln.co + i) * kLd, acc[i], ln.cc);
  }
  __syncthreads();
  if (ln.half == 0) {
    float* dq = static_cast<float*>(p.dq) + q_row * D;
#pragma unroll
    for (int i = 0; i < C::kCo; ++i) {
#pragma unroll
      for (int g = 0; g < C::kCc / C::kVec; ++g)
#pragma unroll
        for (int e = 0; e < C::kVec; ++e)
          acc[i][g * C::kVec + e] +=
              qs[(ln.co + i) * kLd + col_at<C>(ln.cc, g) + e];
      if (q0 + ln.co + i < p.tq)
        store_row<C>(dq + static_cast<long long>(q0 + ln.co + i) * D, acc[i],
                     ln.cc);
    }
  }
}

// K11's p of one tile into p (ps, a row of kOuter + 4 a query): s^T of the
// thread's keys k0 + ao + kAog i (their bias kb) and rows q0 + ai + kAig j,
// their lse in ls
template <typename C, bool kEdge, bool kBias>
__device__ __forceinline__ void dkv_p(const float (&s)[C::kAo][C::kAi],
                                      const Params& p, int q0, int k0,
                                      const F32Lanes<C>& ln,
                                      const float (&kb)[C::kAo],
                                      const float* ls, float* ps) {
#pragma unroll
  for (int j = 0; j < C::kAi; ++j) {
    const int row = ln.ai + C::kAig * j;
    const float lse = ls[row];
#pragma unroll
    for (int i = 0; i < C::kAo; ++i) {
      const int key = ln.ao + C::kAog * i;
      ps[row * C::kLdx + key] = tile_p<kEdge, kBias>(
          s[i][j], p, q0 + row, k0 + key, kb[i], lse);
    }
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kF32Threads, 1) dkv_f32_ring(Params p) {
  using C = F32Tiles<D, false>;
  constexpr int kOuter = C::kOuter, kInner = C::kInner, kLd = C::kLd;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                        // [kOuter][kLd]
  float* vs = ks + kOuter * kLd;         // [kOuter][kLd]
  float* qs = vs + kOuter * kLd;         // [stage][kInner][kLd]
  float* dos = qs + 2 * C::kTileF;       // [stage][kInner][kLd]
  float* lse_s = dos + 2 * C::kTileF;    // [stage][kInner]
  float* delta_s = lse_s + 2 * kInner;   // [stage][kInner]
  float* ps = delta_s + 2 * kInner;      // [kInner][kLdx]
  float* dss = ps + kInner * C::kLdx;    // [kInner][kLdx]
  const int tid = threadIdx.x;
  const F32Lanes<C> ln;
  const int kvr = blockIdx.y, b = kvr / p.hk, kvh = kvr % p.hk;
  const int group = p.h / p.hk;
  const int k0 = blockIdx.x * kOuter;  // the most query tiles first
  const long long kv_row = static_cast<long long>(kvr) * p.tk;

  float kb[C::kAo];  // the bias of the thread's keys in s
#pragma unroll
  for (int i = 0; i < C::kAo; ++i) kb[i] = 0.0f;
  bool live = true;
  if (kBias) {  // a block whose keys are all padded computes nothing
    const float* bb = p.bias + static_cast<long long>(b) * p.tk;
    live = __syncthreads_or(tid < kOuter && k0 + tid < p.tk &&
                            bb[k0 + tid] > kNegInf / 2);
#pragma unroll
    for (int i = 0; i < C::kAo; ++i) {
      const int key = k0 + ln.ao + C::kAog * i;
      if (key < p.tk) kb[i] = bb[key];
    }
  }
  const int nq = (p.tq + kInner - 1) / kInner;
  const int first = p.causal ? min(k0 / kInner, nq) : 0;  // causal frontier
  const int per = nq - first;  // query tiles a head
  const int n_iter = live ? group * per : 0;

  auto load_stage = [&](int it) {  // q, dO, lse, delta of query tile it
    const int s = it % 2, q0 = (first + it % per) * kInner;
    const long long q_row =
        static_cast<long long>(b * p.h + kvh * group + it / per) * p.tq;
    copy_rows<D, kInner, kF32Threads>(
        qs + s * C::kTileF, static_cast<const float*>(p.q) + q_row * D, q0,
        p.tq);
    copy_rows<D, kInner, kF32Threads>(
        dos + s * C::kTileF, static_cast<const float*>(p.dout) + q_row * D,
        q0, p.tq);
    copy_row(lse_s + s * kInner, p.lse + q_row, q0, p.tq, 0, kInner);
    copy_row(delta_s + s * kInner, p.delta + q_row, q0, p.tq, kInner,
             kInner);
  };
  if (n_iter > 0) {  // K and V once, then query tile 0
    copy_rows<D, kOuter, kF32Threads>(
        ks, static_cast<const float*>(p.k) + kv_row * D, k0, p.tk);
    copy_rows<D, kOuter, kF32Threads>(
        vs, static_cast<const float*>(p.v) + kv_row * D, k0, p.tk);
    load_stage(0);
  }
  wg::cp_commit();

  // the first half's dv, the second half's dk
  float acc[C::kCo][C::kCc];
#pragma unroll
  for (int i = 0; i < C::kCo; ++i)
#pragma unroll
    for (int c = 0; c < C::kCc; ++c) acc[i][c] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % 2, q0 = (first + it % per) * kInner;
    const float* qt = qs + s * C::kTileF;
    const float* dot = dos + s * C::kTileF;
    wg::cp_wait<0>();  // this thread's copies of tile it
    __syncthreads();   // every thread's; tile it - 1's products are done
    if (it + 1 < n_iter) load_stage(it + 1);
    wg::cp_commit();

    // the first half s^T = k q^T, the second dp^T = v dO^T
    float sd[C::kAo][C::kAi];
    dots<C>(sd, (ln.half ? vs : ks) + ln.ao * kLd,
            (ln.half ? dot : qt) + ln.ai * kLd);
    const float* ls = lse_s + s * kInner;
    const float* dl = delta_s + s * kInner;
    // the first half writes p and sums dv += p^T dO as soon as its p is
    // whole (barrier 2), while the second waits for that p (barrier 1),
    // writes ds and sums dk += ds^T q once its ds is whole (barrier 3)
    if (ln.half == 0) {
      if ((p.causal && q0 < k0 + kOuter - 1) || q0 + kInner > p.tq ||
          k0 + kOuter > p.tk)
        dkv_p<C, true, kBias>(sd, p, q0, k0, ln, kb, ls, ps);
      else
        dkv_p<C, false, kBias>(sd, p, q0, k0, ln, kb, ls, ps);
      bar_arrive(1, kF32Threads);
      bar_sync(2, kF32Threads / 2);
      outer<C, kInner>(acc, ps + ln.co, dot + ln.cc * C::kVec);
    } else {
      bar_sync(1, kF32Threads);
#pragma unroll
      for (int j = 0; j < C::kAi; ++j) {
        const int row = ln.ai + C::kAig * j;
        const float delta = dl[row];
#pragma unroll
        for (int i = 0; i < C::kAo; ++i) {
          const int at = row * C::kLdx + ln.ao + C::kAog * i;
          dss[at] = ps[at] * (sd[i][j] - delta) * p.scale;
        }
      }
      bar_sync(3, kF32Threads / 2);
      outer<C, kInner>(acc, dss + ln.co, qt + ln.cc * C::kVec);
    }
  }

  float* out = static_cast<float*>(ln.half ? p.dk : p.dv) + kv_row * D;
#pragma unroll
  for (int i = 0; i < C::kCo; ++i) {
    const int key = k0 + ln.co + i;
    if (key < p.tk)
      store_row<C>(out + static_cast<long long>(key) * D, acc[i], ln.cc);
  }
}

// ---- head dims above 256: FFMA over 64-column panels ----------------------

// Above D 256 neither dtype's tiles of whole rows fit a block.  As the
// forward's attn_wide: the products over D (s = q k^T and dp = dO v^T) are
// summed in panels of kPanel columns staged through shared memory as f32,
// and the outputs (dq; dk and dv) are split into column blocks of
// kWideCols over the grid's third axis, each block recomputing s and dp.
// T is the operand type: bf16 operands are widened as they are staged, ds
// is rounded to q's dtype and p to dO's where the reference rounds them,
// and the outputs are rounded once to T.
constexpr int kPanel = 64;      // columns of a staged panel
constexpr int kWideCols = 128;  // output columns a block
constexpr int kWideRows = 32;   // K10: query rows a block (8 a warp)

// a panel of n rows of x (row stride d) from row r0 and column c into dst
// (row stride ld) as f32, zeros for rows at or past `end`
template <typename T>
__device__ __forceinline__ void stage_panel(float* dst, int ld, const T* x,
                                            int d, int r0, int end, int c,
                                            int n, int cols) {
  for (int e = threadIdx.x; e < n * cols; e += blockDim.x) {
    const int r = e / cols, cc = e % cols;
    dst[r * ld + cc] = r0 + r < end && c + cc < d
        ? bigdl::to_f32(x[static_cast<long long>(r0 + r) * d + c + cc])
        : 0.0f;
  }
}

constexpr int dq_wide_smem() {  // q, dO; K, V (padded rows); K's columns;
                                // ds; bias
  return (2 * kWideRows * kPanel + 2 * kTile * (kPanel + 1) +
          kTile * kWideCols + kWideRows * kTile + kTile) * 4;
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads) dq_wide(Params p, int d) {
  constexpr int kWR = kWideRows / 4, kCols = kWideCols / 32;
  extern __shared__ float sm[];
  float* qs = sm;                          // [kWideRows][kPanel]
  float* dos = qs + kWideRows * kPanel;    // [kWideRows][kPanel]
  float* ks = dos + kWideRows * kPanel;    // [64][kPanel + 1]
  float* vs = ks + kTile * (kPanel + 1);   // [64][kPanel + 1]
  float* kc = vs + kTile * (kPanel + 1);   // [64][kWideCols]
  float* bs = kc + kTile * kWideCols + kWideRows * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = kc + kTile * kWideCols + warp * kWR * kTile;  // this warp's ds
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWideRows;
  const int c0 = blockIdx.z * kWideCols;
  const long long q_row = static_cast<long long>(bh) * p.tq * d;
  const long long kv_row = (static_cast<long long>(b) * p.hk +
                            (bh % p.h) / (p.h / p.hk)) * p.tk * d;
  const T* q = static_cast<const T*>(p.q) + q_row;
  const T* dout = static_cast<const T*>(p.dout) + q_row;
  const T* k = static_cast<const T*>(p.k) + kv_row;
  const T* v = static_cast<const T*>(p.v) + kv_row;
  const int row0 = q0 + warp * kWR;

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

  const int k_end = p.causal ? min(p.tk, q0 + kWideRows) : p.tk;
  const float* qp = qs + warp * kWR * kPanel;
  const float* dp_ = dos + warp * kWR * kPanel;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    if (kBias) {
      if (!stage_bias(p, b, k0, kTile, bs)) continue;
    }
    // s[j][i], dp[j][i]: row row0 + i, key k0 + lane + 32 j, over all of D
    float s[2][kWR], dp[2][kWR];
#pragma unroll
    for (int i = 0; i < kWR; ++i)
      s[0][i] = s[1][i] = dp[0][i] = dp[1][i] = 0.0f;
    for (int c = 0; c < d; c += kPanel) {
      __syncthreads();  // the previous panel's (or tile's) readers are done
      stage_panel(qs, kPanel, q, d, q0, p.tq, c, kWideRows, kPanel);
      stage_panel(dos, kPanel, dout, d, q0, p.tq, c, kWideRows, kPanel);
      stage_panel(ks, kPanel + 1, k, d, k0, p.tk, c, kTile, kPanel);
      stage_panel(vs, kPanel + 1, v, d, k0, p.tk, c, kTile, kPanel);
      __syncthreads();
      const float* k0p = ks + lane * (kPanel + 1);
      const float* k1p = ks + (lane + 32) * (kPanel + 1);
      const float* v0p = vs + lane * (kPanel + 1);
      const float* v1p = vs + (lane + 32) * (kPanel + 1);
#pragma unroll 2
      for (int cc = 0; cc < kPanel; ++cc) {
        const float ka = k0p[cc], kb = k1p[cc], va = v0p[cc], vb = v1p[cc];
#pragma unroll
        for (int i = 0; i < kWR; ++i) {
          const float qv = qp[i * kPanel + cc], dv = dp_[i * kPanel + cc];
          s[0][i] = fmaf(qv, ka, s[0][i]);
          s[1][i] = fmaf(qv, kb, s[1][i]);
          dp[0][i] = fmaf(dv, va, dp[0][i]);
          dp[1][i] = fmaf(dv, vb, dp[1][i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lane + 32 * j;
#pragma unroll
      for (int i = 0; i < kWR; ++i) {
        const float x = mask_score(s[j][i], p, row0 + i, k0 + col,
                                   kBias ? bs : nullptr, col);
        ps[i * kTile + col] = rounded<T>(prob(x, lse[i]) *
                                         (dp[j][i] - delta[i]) * p.scale);
      }
    }
    __syncthreads();  // every panel read; the ds of every warp written
    stage_panel(kc, kWideCols, k, d, k0, p.tk, c0, kTile, kWideCols);
    __syncthreads();
    for (int key = 0; key < kTile; ++key) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv[c] = kc[key * kWideCols + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kWR; ++i) {
        const float x = ps[i * kTile + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(x, kv[c], acc[i][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + q_row;
#pragma unroll
  for (int i = 0; i < kWR; ++i) {
    if (row0 + i >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < d)
        dq[static_cast<long long>(row0 + i) * d + col] =
            bigdl::from_f32<T>(acc[i][c]);
    }
  }
}

// K11 above D 256: 8 warps of 8 keys each over 64 keys a block, lanes over
// the 64 query rows of a tile; the panels and the column blocks share one
// region of shared memory (they are used one after the other)
constexpr int kWideKeys = kWideDkvThreads / 32 * 8;  // 64
constexpr int kPanels = 2 * kWideKeys * kPanel + 2 * kTile * (kPanel + 1);
constexpr int kColBlocks = 2 * kTile * kWideCols;

constexpr int dkv_wide_smem() {  // panels or column blocks; p, ds; rows
  return ((kPanels > kColBlocks ? kPanels : kColBlocks) +
          2 * kWideKeys * kTile + 2 * kTile + kWideKeys) * 4;
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kWideDkvThreads) dkv_wide(Params p, int d) {
  constexpr int kCols = kWideCols / 32, kWK = 8;  // keys a warp
  extern __shared__ float sm[];
  float* ks = sm;                          // [64][kPanel]
  float* vs = ks + kWideKeys * kPanel;     // [64][kPanel]
  float* qs = vs + kWideKeys * kPanel;     // [64][kPanel + 1]
  float* dos = qs + kTile * (kPanel + 1);  // [64][kPanel + 1]
  float* qc = sm;                          // [64][kWideCols], over the panels
  float* dc = qc + kTile * kWideCols;      // [64][kWideCols]
  float* pb = sm + (kPanels > kColBlocks ? kPanels : kColBlocks);
  float* db = pb + kWideKeys * kTile;      // [keys][64]
  float* lse_s = db + kWideKeys * kTile;
  float* delta_s = lse_s + kTile;
  float* bs = delta_s + kTile;             // [kWideKeys]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = pb + warp * kWK * kTile;
  float* dw = db + warp * kWK * kTile;
  const int kvr = blockIdx.y, b = kvr / p.hk, kvh = kvr % p.hk;
  const int group = p.h / p.hk;
  const int k0 = blockIdx.x * kWideKeys;
  const int c0 = blockIdx.z * kWideCols;
  const long long kv_row = static_cast<long long>(kvr) * p.tk * d;
  const int key0 = k0 + warp * kWK;  // this warp's first key
  const T* k = static_cast<const T*>(p.k) + kv_row;
  const T* v = static_cast<const T*>(p.v) + kv_row;

  float dka[kWK][kCols], dva[kWK][kCols];
#pragma unroll
  for (int i = 0; i < kWK; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.0f;

  const bool live = kBias ? stage_bias(p, b, k0, kWideKeys, bs) != 0 : true;
  if (live) {
    const int nq = (p.tq + kTile - 1) / kTile;
    const int first = p.causal ? k0 / kTile : 0;
    const float* kp = ks + warp * kWK * kPanel;
    const float* vp = vs + warp * kWK * kPanel;
    for (int hh = 0; hh < group; ++hh) {
      const int bh = b * p.h + kvh * group + hh;
      const long long q_row = static_cast<long long>(bh) * p.tq * d;
      const T* q = static_cast<const T*>(p.q) + q_row;
      const T* dout = static_cast<const T*>(p.dout) + q_row;
      for (int qb = first; qb < nq; ++qb) {
        const int q0 = qb * kTile;
        __syncthreads();  // the previous tile's readers are done
        if (threadIdx.x < kTile) {
          const int qr = q0 + threadIdx.x;
          const long long at = static_cast<long long>(bh) * p.tq + qr;
          delta_s[threadIdx.x] = qr < p.tq ? p.delta[at] : 0.0f;
          lse_s[threadIdx.x] = qr < p.tq ? p.lse[at] : 0.0f;
        }
        // s[j][i], dp[j][i]: key key0 + i, query q0 + lane + 32 j
        float s[2][kWK], dp[2][kWK];
#pragma unroll
        for (int i = 0; i < kWK; ++i)
          s[0][i] = s[1][i] = dp[0][i] = dp[1][i] = 0.0f;
        for (int c = 0; c < d; c += kPanel) {
          __syncthreads();
          stage_panel(ks, kPanel, k, d, k0, p.tk, c, kWideKeys, kPanel);
          stage_panel(vs, kPanel, v, d, k0, p.tk, c, kWideKeys, kPanel);
          stage_panel(qs, kPanel + 1, q, d, q0, p.tq, c, kTile, kPanel);
          stage_panel(dos, kPanel + 1, dout, d, q0, p.tq, c, kTile, kPanel);
          __syncthreads();
          const float* q0p = qs + lane * (kPanel + 1);
          const float* q1p = qs + (lane + 32) * (kPanel + 1);
          const float* d0p = dos + lane * (kPanel + 1);
          const float* d1p = dos + (lane + 32) * (kPanel + 1);
#pragma unroll 2
          for (int cc = 0; cc < kPanel; ++cc) {
            const float qa = q0p[cc], qb2 = q1p[cc], da = d0p[cc],
                        db2 = d1p[cc];
#pragma unroll
            for (int i = 0; i < kWK; ++i) {
              const float kv = kp[i * kPanel + cc], vv = vp[i * kPanel + cc];
              s[0][i] = fmaf(kv, qa, s[0][i]);
              s[1][i] = fmaf(kv, qb2, s[1][i]);
              dp[0][i] = fmaf(vv, da, dp[0][i]);
              dp[1][i] = fmaf(vv, db2, dp[1][i]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = lane + 32 * j;
#pragma unroll
          for (int i = 0; i < kWK; ++i) {
            const float x = mask_score(s[j][i], p, q0 + col, key0 + i,
                                       kBias ? bs : nullptr, warp * kWK + i);
            const float pj = prob(x, lse_s[col]);
            pw[i * kTile + col] = rounded<T>(pj);
            dw[i * kTile + col] =
                rounded<T>(pj * (dp[j][i] - delta_s[col]) * p.scale);
          }
        }
        __syncthreads();  // every panel read: the column blocks replace them
        stage_panel(qc, kWideCols, q, d, q0, p.tq, c0, kTile, kWideCols);
        stage_panel(dc, kWideCols, dout, d, q0, p.tq, c0, kTile, kWideCols);
        __syncthreads();
        for (int r = 0; r < kTile; ++r) {
          float qv[kCols], dov[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            qv[c] = qc[r * kWideCols + lane + 32 * c];
            dov[c] = dc[r * kWideCols + lane + 32 * c];
          }
#pragma unroll
          for (int i = 0; i < kWK; ++i) {
            const float pv = pw[i * kTile + r], dsv = dw[i * kTile + r];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              dva[i][c] = fmaf(pv, dov[c], dva[i][c]);
              dka[i][c] = fmaf(dsv, qv[c], dka[i][c]);
            }
          }
        }
      }
    }
  }

  T* dk = static_cast<T*>(p.dk) + kv_row;
  T* dv = static_cast<T*>(p.dv) + kv_row;
#pragma unroll
  for (int i = 0; i < kWK; ++i) {
    if (key0 + i >= p.tk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < d) {
        const long long at = static_cast<long long>(key0 + i) * d + col;
        dk[at] = bigdl::from_f32<T>(dka[i][c]);
        dv[at] = bigdl::from_f32<T>(dva[i][c]);
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
    using Q = F32Tiles<D, true>;
    using K = F32Tiles<D, false>;
    if (kDq)
      return run(dq_f32_ring<D, kBias>,
                 dim3((p.tq + Q::kOuter - 1) / Q::kOuter, b * p.h),
                 kF32Threads, Q::kBytes, s, p);
    return run(dkv_f32_ring<D, kBias>,
               dim3((p.tk + K::kOuter - 1) / K::kOuter, b * p.hk),
               kF32Threads, K::kBytes, s, p);
  }
  return cudaErrorInvalidValue;
}

// a head dim above 256 (a multiple of kPanel): the D-chunked kernels
template <bool kDq, bool kBias, typename T>
cudaError_t launch_wide_t(const Params& p, int b, int d, cudaStream_t s) {
  const int cols = (d + kWideCols - 1) / kWideCols;
  if (kDq)
    return run(dq_wide<T, kBias>,
               dim3((p.tq + kWideRows - 1) / kWideRows, b * p.h, cols),
               kThreads, dq_wide_smem(), s, p, d);
  return run(dkv_wide<T, kBias>,
             dim3((p.tk + kWideKeys - 1) / kWideKeys, b * p.hk, cols),
             kWideDkvThreads, dkv_wide_smem(), s, p, d);
}

template <bool kDq, bool kBias>
cudaError_t launch_wide(const Params& p, int dtype, int b, int d,
                        cudaStream_t s) {
  if (dtype == bigdl::kBF16)
    return launch_wide_t<kDq, kBias, bf16>(p, b, d, s);
  if (dtype == bigdl::kF32)
    return launch_wide_t<kDq, kBias, float>(p, b, d, s);
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
    default:
      if (d > 256 && d % kPanel == 0)
        e = bias ? launch_wide<kDq, true>(p, dtype, b, d, s)
                 : launch_wide<kDq, false>(p, dtype, b, d, s);
      break;
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
