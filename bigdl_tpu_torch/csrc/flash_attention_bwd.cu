// The flash backward of the streaming attention (K9, attention.cu): dQ, dK
// and dV from q (B*H, Tq, D), k, v (B*Hk, Tk, D), K9's output o and its row
// logsumexp lse (B*H, Tq) f32, the upstream gradient do (like q) and the
// optional (B, Tk) f32 additive key-padding bias.  Per (query, key) pair,
// p = exp(s - lse) (0 where s <= NEG_INF / 2, the guard applied before the
// exp: a row with every key padded has lse ~ NEG_INF and would otherwise
// get exp(0) = 1), delta = rowsum(dO * O), dp = dO v^T,
// ds = p (dp - delta) scale; dq = ds k, dk = ds^T q, dv = p^T dO.  Query
// head i of batch row b reads KV row b*Hk + i / (H / Hk) (GQA); the causal
// mask is top-left aligned (q_pos >= k_pos), masked scores NEG_INF.
//
// K10 replaces bigdl_tpu/ops/attention.py `_bwd_dq_kernel` (via
// `_flash_streaming_bwd`).  The TPU kernel carried dq in VMEM scratch over
// a sequential K grid axis and recomputed delta per block.  Here one block
// of 4 warps owns (one B*H row, 64 query rows, 16 a warp), computes delta
// once per row in its prologue, keeps dq in f32 registers, and walks the
// 64-key K/V tiles up to the causal frontier, skipping tiles whose keys
// are all padded, as K9 does.
// K11 replaces `_bwd_dkv_kernel`.  The TPU kernel ran an inner grid of
// group * n_q_blocks steps per KV block (every query block of every query
// head sharing the KV head) into VMEM scratch.  Here one block owns (one
// B*Hk row, 64 keys), keeps dk and dv in f32 registers, and loops over the
// same group * n_q query tiles itself, from the KV tile's causal frontier
// on (the first query tile that reaches its first key).  So K11 needs no
// atomicAdd: its sums have a fixed order and two launches are bit-equal.
// A KV tile whose keys are all padded writes zeros and loops over nothing.
//
// * bf16: every product on mma.sync m16n8k16 with f32 accumulators.  The
//   row-major K (V) tile gives the B operand of q k^T (dO v^T); the
//   transposed copies give the B operand of ds k (K10) and of p^T dO and
//   ds^T q (K11), whose A operand is the score fragment itself, rounded to
//   bf16 where the reference rounds (ds to q's dtype, p to dO's).
// * f32: FFMA, one lane per key (K10) or per query (K11) for the scores,
//   one lane per output column for the products.
// Head dims 16/32/64/128 (the wrapper zero-pads others); rows past Tq or
// keys past Tk are masked, so T need not be a multiple of 64.  Bound on the
// H100 at the path's shapes (T 4096-8192, D 64, causal): the tensor cores'
// (bf16) or FFMA's (f32) rate over the causal half of 6 D (K10) and 8 D
// (K11) FLOPs per pair and head; each K/V (K10) or q/dO (K11) tile is read
// once per block, mostly from L2.  Every tile is staged through shared
// memory single-buffered; cp.async, wgmma and TMA are later work.
#include <cstdint>

#include "common.cuh"

namespace {

using bigdl::ld32;
using bigdl::mma_bf16;
using bigdl::pack_bf16x2;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;           // query rows (K10) or keys (K11) a block
constexpr int kThreads = 128;       // 4 warps, 16 rows (keys) each
constexpr int kF32DkvThreads = 256; // K11 f32: 8 warps, 8 keys each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
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

// Stage 64 keys' bias from k0 into bs and report whether any of them is
// real (a barrier for the whole block).
__device__ __forceinline__ int stage_bias(const Params& p, int b, int k0,
                                          float* bs) {
  bool real = false;
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    const float x = key < p.tk
        ? p.bias[static_cast<long long>(b) * p.tk + key] : kNegInf;
    bs[threadIdx.x] = x;
    real = x > kNegInf / 2;
  }
  return __syncthreads_or(real);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a row-major tile of
// stride rs and, when t is not null, a transposed one (t[c][row], stride
// ts); rows past n are zeros
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* src, int r0,
                                           int n, __nv_bfloat16* rm, int rs,
                                           __nv_bfloat16* tr, int ts) {
  for (int e = threadIdx.x; e < kTile * D / 8; e += blockDim.x) {
    const int row = e / (D / 8), c = (e % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n)
      x = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + row) * D + c);
    *reinterpret_cast<uint4*>(rm + row * rs + c) = x;
    if (tr) {
      const __nv_bfloat16* h8 = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c + i) * ts + row] = h8[i];
    }
  }
}

// A fragments (16 rows from r, all of D) of a (rows, D) bf16 matrix
template <int D>
__device__ __forceinline__ void load_a(const __nv_bfloat16* src, int r, int n,
                                       uint32_t (&a)[D / 16][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = r + g + 8 * (j & 1);
      a[kd][j] = rr < n
          ? ld32(src + static_cast<long long>(rr) * D + kd * 16 + 2 * t +
                 (j >> 1) * 8)
          : 0u;
    }
  }
}

// c[n] = A B^T over D for 8 column groups of 8: A in fragments, B row-major
// in shared memory (64 rows of stride bs): c[n][j] is (row g + 8 (j / 2),
// column 8 n + 2 t + j % 2)
template <int D>
__device__ __forceinline__ void mma_abt(const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* b, int bs,
                                        float (&c)[8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[n][j] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const __nv_bfloat16* bp = b + (8 * n + g) * bs + kd * 16 + 2 * t;
      const uint32_t bb[2] = {ld32(bp), ld32(bp + 8)};
      mma_bf16(c[n], a[kd], bb);
    }
  }
}

// acc += S X over the 64-wide inner dim: S in the C layout of mma_abt,
// rounded to bf16 as the A operand; X transposed in shared memory (xt[c][i],
// stride xs), acc[n] in the C layout over D / 8 column groups
template <int D>
__device__ __forceinline__ void mma_sx(const float (&s)[8][4],
                                       const __nv_bfloat16* xt, int xs,
                                       float (&acc)[D / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                           pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                           pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* bp = xt + (8 * n + g) * xs + 16 * kc + 2 * t;
      const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
      mma_bf16(acc[n], a, b);
    }
  }
}

// ---- K10, bfloat16 ---------------------------------------------------------

template <int D>
constexpr int dq_bf16_smem() {  // K and V row-major, K transposed, bias
  return 2 * kTile * (D + 8) * 2 + D * (kTile + 8) * 2 + kTile * 4;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) dq_bf16(Params p) {
  constexpr int kRS = D + 8, kTS = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * kRS;
  __nv_bfloat16* kt = vs + kTile * kRS;
  float* bs = reinterpret_cast<float*>(kt + D * kTS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const long long q_row = static_cast<long long>(bh) * p.tq * D;
  const long long kv_row = (static_cast<long long>(b) * p.hk +
                            (bh % p.h) / (p.h / p.hk)) * p.tk * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + q_row;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + q_row;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(p.dout) + q_row;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_row;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_row;
  const int r0 = q0 + warp * 16;
  const int row[2] = {r0 + g, r0 + g + 8};

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(q, r0, p.tq, qa);
  load_a<D>(dout, r0, p.tq, da);
  // delta = rowsum(dO * O) over this lane's columns, then its quad's
  float lse[2], delta[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = row[i] < p.tq ? p.lse[static_cast<long long>(bh) * p.tq +
                                   row[i]] : 0.0f;
    if (row[i] >= p.tq) continue;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = kd * 16 + 2 * t + 8 * hi;
        const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(
            dout + static_cast<long long>(row[i]) * D + c);
        const __nv_bfloat162 o2 = *reinterpret_cast<const __nv_bfloat162*>(
            o + static_cast<long long>(row[i]) * D + c);
        delta[i] += __bfloat162float(d2.x) * __bfloat162float(o2.x) +
                    __bfloat162float(d2.y) * __bfloat162float(o2.y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;

  const int k_end = p.causal ? min(p.tk, q0 + kTile) : p.tk;
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D>(k, k0, p.tk, ks, kRS, kt, kTS);
    stage_bf16<D>(v, k0, p.tk, vs, kRS, nullptr, 0);
    if (kBias) {
      if (!stage_bias(p, b, k0, bs)) continue;  // every key padded
    } else {
      __syncthreads();
    }
    mma_abt<D>(qa, ks, kRS, s);
    mma_abt<D>(da, vs, kRS, dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1, col = 8 * n + 2 * t + (j & 1);
        const float x = mask_score(s[n][j], p, row[i], k0 + col,
                                   kBias ? bs : nullptr, col);
        s[n][j] = prob(x, lse[i]) * (dp[n][j] - delta[i]) * p.scale;
      }
    }
    mma_sx<D>(s, kt, kTS, acc);  // ds rounded to bf16, as the reference
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + q_row;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.tq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(
          dq + static_cast<long long>(row[i]) * D + 8 * n + 2 * t) =
          pack_bf16x2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---- K11, bfloat16 ---------------------------------------------------------

template <int D>
constexpr int dkv_bf16_smem() {  // q and dO row-major and transposed, rows
  return 2 * kTile * (D + 8) * 2 + 2 * D * (kTile + 8) * 2 + 3 * kTile * 4;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) dkv_bf16(Params p) {
  constexpr int kRS = D + 8, kTS = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = qs + kTile * kRS;
  __nv_bfloat16* qt = ds + kTile * kRS;
  __nv_bfloat16* dt = qt + D * kTS;
  float* lse_s = reinterpret_cast<float*>(dt + D * kTS);
  float* delta_s = lse_s + kTile;
  float* bs = delta_s + kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvr = blockIdx.y, b = kvr / p.hk, kvh = kvr % p.hk;
  const int group = p.h / p.hk;
  const int k0 = blockIdx.x * kTile;
  const long long kv_row = static_cast<long long>(kvr) * p.tk * D;
  const int kr0 = k0 + warp * 16;
  const int key[2] = {kr0 + g, kr0 + g + 8};
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(p.dk) + kv_row;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(p.dv) + kv_row;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.0f;

  const bool live = kBias ? stage_bias(p, b, k0, bs) != 0 : true;
  if (live) {
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a<D>(static_cast<const __nv_bfloat16*>(p.k) + kv_row, kr0, p.tk,
              ka);
    load_a<D>(static_cast<const __nv_bfloat16*>(p.v) + kv_row, kr0, p.tk,
              va);
    const int nq = (p.tq + kTile - 1) / kTile;
    const int first = p.causal ? k0 / kTile : 0;
    float st[8][4], dpt[8][4];
    for (int hh = 0; hh < group; ++hh) {
      const int bh = b * p.h + kvh * group + hh;
      const long long q_row = static_cast<long long>(bh) * p.tq * D;
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + q_row;
      const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + q_row;
      const __nv_bfloat16* dout =
          static_cast<const __nv_bfloat16*>(p.dout) + q_row;
      for (int qb = first; qb < nq; ++qb) {
        const int q0 = qb * kTile;
        __syncthreads();  // the previous tile's readers are done
        stage_bf16<D>(q, q0, p.tq, qs, kRS, qt, kTS);
        stage_bf16<D>(dout, q0, p.tq, ds, kRS, dt, kTS);
        // delta and lse of the tile's 64 rows, 16 a warp
        for (int r = warp * 16; r < warp * 16 + 16; ++r) {
          const int qr = q0 + r;
          float x = 0.0f;
          if (qr < p.tq)
            for (int c = lane; c < D; c += 32)
              x += __bfloat162float(dout[static_cast<long long>(qr) * D + c]) *
                   __bfloat162float(o[static_cast<long long>(qr) * D + c]);
          x = warp_sum(x);
          if (lane == 0) {
            delta_s[r] = x;
            lse_s[r] = qr < p.tq
                ? p.lse[static_cast<long long>(bh) * p.tq + qr] : 0.0f;
          }
        }
        __syncthreads();
        mma_abt<D>(ka, qs, kRS, st);    // s^T: (key, query)
        mma_abt<D>(va, ds, kRS, dpt);   // dp^T = v dO^T
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = j >> 1, col = 8 * n + 2 * t + (j & 1);
            const float x = mask_score(st[n][j], p, q0 + col, key[i],
                                       kBias ? bs : nullptr,
                                       warp * 16 + g + 8 * i);
            const float pj = prob(x, lse_s[col]);
            st[n][j] = pj;
            dpt[n][j] = pj * (dpt[n][j] - delta_s[col]) * p.scale;
          }
        }
        mma_sx<D>(st, dt, kTS, dva);   // dv += p^T dO, p rounded to bf16
        mma_sx<D>(dpt, qt, kTS, dka);  // dk += ds^T q, ds rounded to bf16
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.tk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long long at = static_cast<long long>(key[i]) * D + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16x2(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16x2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---- K10, float32 ----------------------------------------------------------

template <int D>
constexpr int dq_f32_smem() {  // q, dO, K and V (padded rows), ds, bias
  return (2 * kTile * D + 2 * kTile * (D + 1) + 4 * 16 * kTile + kTile) * 4;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads) dq_f32(Params p) {
  constexpr int kCols = (D + 31) / 32;  // output columns of a lane
  extern __shared__ float sm[];
  float* qs = sm;                      // [64][D]
  float* dos = qs + kTile * D;         // [64][D]
  float* ks = dos + kTile * D;         // [64][D + 1]
  float* vs = ks + kTile * (D + 1);    // [64][D + 1]
  float* bs = vs + kTile * (D + 1) + 4 * 16 * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = vs + kTile * (D + 1) + warp * 16 * kTile;  // this warp's ds
  const int bh = blockIdx.y, b = bh / p.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const long long q_row = static_cast<long long>(bh) * p.tq * D;
  const long long kv_row = (static_cast<long long>(b) * p.hk +
                            (bh % p.h) / (p.h / p.hk)) * p.tk * D;
  const float* q = static_cast<const float*>(p.q) + q_row;
  const float* o = static_cast<const float*>(p.o) + q_row;
  const float* dout = static_cast<const float*>(p.dout) + q_row;
  const float* k = static_cast<const float*>(p.k) + kv_row;
  const float* v = static_cast<const float*>(p.v) + kv_row;
  const int row0 = q0 + warp * 16;

  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int rr = q0 + e / D;
    const long long at = static_cast<long long>(rr) * D + e % D;
    qs[e] = rr < p.tq ? q[at] : 0.0f;
    dos[e] = rr < p.tq ? dout[at] : 0.0f;
  }
  __syncthreads();
  float lse[16], delta[16], acc[16][kCols];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rr = row0 + i;
    float x = 0.0f;
    if (rr < p.tq)
      for (int c = lane; c < D; c += 32)
        x += dos[(warp * 16 + i) * D + c] *
             o[static_cast<long long>(rr) * D + c];
    delta[i] = warp_sum(x);
    lse[i] = rr < p.tq ? p.lse[static_cast<long long>(bh) * p.tq + rr] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = p.causal ? min(p.tk, q0 + kTile) : p.tk;
  const float* qp = qs + warp * 16 * D;
  const float* dp_ = dos + warp * 16 * D;
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
      if (!stage_bias(p, b, k0, bs)) continue;
    } else {
      __syncthreads();
    }
    // s[j][i], dp[j][i]: row row0 + i, key k0 + lane + 32 j
    float s[2][16], dp[2][16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s[0][i] = s[1][i] = dp[0][i] = dp[1][i] = 0.0f;
    const float* k0p = ks + lane * (D + 1);
    const float* k1p = ks + (lane + 32) * (D + 1);
    const float* v0p = vs + lane * (D + 1);
    const float* v1p = vs + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float ka = k0p[d], kb = k1p[d], va = v0p[d], vb = v1p[d];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
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
      for (int i = 0; i < 16; ++i) {
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
      for (int i = 0; i < 16; ++i) {
        const float x = ps[i * kTile + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(x, kv[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

  float* dq = static_cast<float*>(p.dq) + q_row;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (row0 + i >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dq[static_cast<long long>(row0 + i) * D + col] = acc[i][c];
    }
  }
}

// ---- K11, float32 ----------------------------------------------------------

constexpr int kF32Keys = 8;  // keys of a warp in K11 f32

template <int D>
constexpr int dkv_f32_smem() {  // K, V; q, dO (padded rows); p, ds; rows
  return (2 * kTile * D + 2 * kTile * (D + 1) +
          2 * (kF32DkvThreads / 32) * kF32Keys * kTile + 3 * kTile) * 4;
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kF32DkvThreads) dkv_f32(Params p) {
  constexpr int kCols = (D + 31) / 32;
  constexpr int kWarps = kF32DkvThreads / 32;
  extern __shared__ float sm[];
  float* ks = sm;                          // [64][D]
  float* vs = ks + kTile * D;              // [64][D]
  float* qs = vs + kTile * D;              // [64][D + 1]
  float* dos = qs + kTile * (D + 1);       // [64][D + 1]
  float* pb = dos + kTile * (D + 1);       // [warps][8][64]
  float* db = pb + kWarps * kF32Keys * kTile;
  float* lse_s = db + kWarps * kF32Keys * kTile;
  float* delta_s = lse_s + kTile;
  float* bs = delta_s + kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = pb + warp * kF32Keys * kTile;
  float* dw = db + warp * kF32Keys * kTile;
  const int kvr = blockIdx.y, b = kvr / p.hk, kvh = kvr % p.hk;
  const int group = p.h / p.hk;
  const int k0 = blockIdx.x * kTile;
  const long long kv_row = static_cast<long long>(kvr) * p.tk * D;
  const int key0 = k0 + warp * kF32Keys;  // this warp's first key
  float* dk = static_cast<float*>(p.dk) + kv_row;
  float* dv = static_cast<float*>(p.dv) + kv_row;

  float dka[kF32Keys][kCols], dva[kF32Keys][kCols];
#pragma unroll
  for (int i = 0; i < kF32Keys; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.0f;

  const bool live = kBias ? stage_bias(p, b, k0, bs) != 0 : true;
  if (live) {
    const float* k = static_cast<const float*>(p.k) + kv_row;
    const float* v = static_cast<const float*>(p.v) + kv_row;
    for (int e = threadIdx.x; e < kTile * D; e += kF32DkvThreads) {
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
      const float* o = static_cast<const float*>(p.o) + q_row;
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
        __syncthreads();
        for (int r = warp * kF32Keys; r < warp * kF32Keys + kF32Keys; ++r) {
          const int qr = q0 + r;
          float x = 0.0f;
          if (qr < p.tq)
            for (int c = lane; c < D; c += 32)
              x += dos[r * (D + 1) + c] *
                   o[static_cast<long long>(qr) * D + c];
          x = warp_sum(x);
          if (lane == 0) {
            delta_s[r] = x;
            lse_s[r] = qr < p.tq
                ? p.lse[static_cast<long long>(bh) * p.tq + qr] : 0.0f;
          }
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

// ---- launch ----------------------------------------------------------------

template <typename K>
cudaError_t run(K kernel, dim3 grid, int threads, int smem, const Params& p,
                cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool kDq, bool kBias, int D>
cudaError_t launch_d(const Params& p, int dtype, int b, cudaStream_t s) {
  const dim3 grid_q((p.tq + kTile - 1) / kTile, b * p.h);
  const dim3 grid_k((p.tk + kTile - 1) / kTile, b * p.hk);
  if (dtype == bigdl::kBF16) {
    if (kDq)
      return run(dq_bf16<D, kBias>, grid_q, kThreads, dq_bf16_smem<D>(), p,
                 s);
    return run(dkv_bf16<D, kBias>, grid_k, kThreads, dkv_bf16_smem<D>(), p,
               s);
  }
  if (dtype == bigdl::kF32) {
    if (kDq)
      return run(dq_f32<D, kBias>, grid_q, kThreads, dq_f32_smem<D>(), p, s);
    return run(dkv_f32<D, kBias>, grid_k, kF32DkvThreads, dkv_f32_smem<D>(),
               p, s);
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
#undef BIGDL_CASE
    default: break;
  }
  return static_cast<int>(e);
}

}  // namespace

// K10: dq (b*h, tq, d) like q from q, k, v, o, lse (b*h, tq) f32, do and an
// optional (b, tk) f32 bias
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse,
                                  const void* dout, const void* bias,
                                  void* dq, int dtype, int b, int h, int hk,
                                  int tq, int tk, int d, float scale,
                                  int causal, void* stream) {
  const Params p{q, k, v, o, static_cast<const float*>(lse), dout,
                 static_cast<const float*>(bias), dq, nullptr, nullptr, h,
                 hk, tq, tk, scale, causal != 0};
  return launch<true>(p, dtype, b, d, stream);
}

// K11: dk, dv (b*hk, tk, d) like k, each summed over the query heads that
// share its KV head
extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, const void* bias,
                                   void* dk, void* dv, int dtype, int b,
                                   int h, int hk, int tq, int tk, int d,
                                   float scale, int causal, void* stream) {
  const Params p{q, k, v, o, static_cast<const float*>(lse), dout,
                 static_cast<const float*>(bias), nullptr, dk, dv, h, hk,
                 tq, tk, scale, causal != 0};
  return launch<false>(p, dtype, b, d, stream);
}
