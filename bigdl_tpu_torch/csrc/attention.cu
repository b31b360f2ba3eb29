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
// Design: one block of 4 warps owns (one B*H row, 64 query rows), 16 rows
// a warp; K/V tiles of 64 keys are staged through shared memory.  Both
// kernels stop at the causal frontier of their 64 rows: a tile in the
// future adds p = 0 with alpha = 1, so skipping it is exact.
// * bf16: q k^T and p v on mma.sync m16n8k16 with f32 accumulators; q is
//   held in registers as A fragments, V is stored transposed so that its B
//   fragments are 32-bit loads; p is rounded to bf16 for the p v product
//   (the reference keeps p in f32: the tolerance of the kernel against its
//   plain version states this), l sums the f32 p.
// * f32: FFMA, one lane per key of the tile for the scores, one lane per
//   output column for p v, in full f32.
// Bound on the H100 at the path's shapes (T 2048 and 8192, D 64): the
// tensor cores' rate over the causal half of the FLOPs in bf16 (K/V are
// read once per 64 query rows, from L2 mostly), FFMA in f32.  K8's second
// pass over the scores costs it a third more FLOPs than K9.  wgmma, TMA and
// warp specialisation are later work.
#include <cstdint>

#include "common.cuh"

namespace {

using bigdl::ld32;
using bigdl::mma_bf16;
using bigdl::pack_bf16x2;

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;             // query rows per block, 16 a warp
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kAttnThreads = 128;

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

struct Rows {  // the block's place in the problem
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

// ---- bfloat16: mma.sync -----------------------------------------------------

template <int D, bool kStream, bool kBias, bool kLse>
__global__ void __launch_bounds__(kAttnThreads) attn_bf16(Params p) {
  constexpr int kKS = D + 8;    // K tile row stride (bf16): no bank conflicts
  constexpr int kVS = kBK + 8;  // transposed V tile row stride
  constexpr int kKD = D / 16;   // k-steps of q k^T
  constexpr int kND = D / 8;    // n-tiles of p v
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kKS];
  __shared__ __align__(16) __nv_bfloat16 vt[D * kVS];
  __shared__ float bs[kBK];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Rows r = block_rows(p, D);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + r.q_row;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + r.kv_row;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + r.kv_row;
  const int row[2] = {r.q0 + warp * 16 + g, r.q0 + warp * 16 + g + 8};

  uint32_t qa[kKD][4];
#pragma unroll
  for (int kd = 0; kd < kKD; ++kd) {
    const int c = kd * 16 + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = row[j & 1];
      qa[kd][j] = rr < p.tq
          ? ld32(q + static_cast<long long>(rr) * D + c + (j >> 1) * 8)
          : 0u;
    }
  }

  float m[2], l[2] = {0.0f, 0.0f};
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;

  // one K (and V) tile into shared memory; returns whether to use it
  auto stage = [&](int k0, bool with_v) -> bool {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D / 8; e += kAttnThreads) {
      const int key = e / (D / 8), c = (e % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k0 + key < p.tk) {
        const long long at = static_cast<long long>(k0 + key) * D + c;
        kv4 = *reinterpret_cast<const uint4*>(k + at);
        if (with_v) vv4 = *reinterpret_cast<const uint4*>(v + at);
      }
      *reinterpret_cast<uint4*>(ks + key * kKS + c) = kv4;
      if (with_v) {
        const __nv_bfloat16* h8 = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt[(c + i) * kVS + key] = h8[i];
      }
    }
    if (kBias) return stage_bias(r, p, k0, bs) != 0;
    __syncthreads();
    return true;
  };

  // s[n][j]: score of row row[j / 2], key k0 + 8n + 2t + j % 2
  auto scores = [&](int k0, float (&s)[8][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < kKD; ++kd) {
        const __nv_bfloat16* bp = ks + (8 * n + g) * kKS + kd * 16 + 2 * t;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16(s[n], qa[kd], b);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * n + 2 * t + (j & 1);
        s[n][j] = mask_score(s[n][j], p, row[j >> 1], k0 + col,
                             kBias ? bs : nullptr, col);
      }
    }
  };

  // acc += p v over the tile, p rounded to bf16 as the A operand
  auto accumulate = [&](const float (&s)[8][4]) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        const __nv_bfloat16* bp = vt + (8 * n + g) * kVS + 16 * kc + 2 * t;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16(acc[n], a, b);
      }
    }
  };

  float s[8][4];
  if (!kStream) {  // K8 pass 1: the row max over every key
    m[0] = m[1] = -INFINITY;
    for (int k0 = 0; k0 < r.k_end; k0 += kBK) {
      stage(k0, false);
      scores(k0, s);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j >> 1] = fmaxf(m[j >> 1], s[n][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
  } else {
    m[0] = m[1] = kNegInf;
  }

  for (int k0 = 0; k0 < r.k_end; k0 += kBK) {
    if (!stage(k0, true)) continue;  // K9: every key of the tile padded
    scores(k0, s);
    if (kStream) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mt = fmaxf(mt, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[i], mt);
        const float alpha = __expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[n][j];
        const float pj = kStream
            ? (x > kNegInf / 2 ? __expf(x - m[j >> 1]) : 0.0f)
            : __expf(x - m[j >> 1]);
        s[n][j] = pj;
        l[j >> 1] += pj;
      }
    }
    accumulate(s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (kStream) l[i] = fmaxf(l[i], 1e-20f);
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + r.q_row;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.tq) continue;
    if (kLse && t == 0)
      p.lse[static_cast<long long>(blockIdx.y) * p.tq + row[i]] =
          m[i] + logf(l[i]);
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      *reinterpret_cast<uint32_t*>(
          o + static_cast<long long>(row[i]) * D + 8 * n + 2 * t) =
          pack_bf16x2(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    }
  }
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

template <bool kStream, bool kBias, bool kLse, int D>
cudaError_t launch_d(const Params& p, int dtype, int bh, cudaStream_t s) {
  const dim3 grid((p.tq + kBQ - 1) / kBQ, bh);
  if (dtype == bigdl::kBF16) {
    attn_bf16<D, kStream, kBias, kLse><<<grid, kAttnThreads, 0, s>>>(p);
  } else if (dtype == bigdl::kF32) {
    const int smem = f32_smem_floats(D) * static_cast<int>(sizeof(float));
    const cudaError_t e = cudaFuncSetAttribute(
        attn_f32<D, kStream, kBias, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attn_f32<D, kStream, kBias, kLse><<<grid, kAttnThreads, smem, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
