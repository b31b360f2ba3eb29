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
// one page to the next.  The query rows of one (row b, KV head) are packed
// (GQA group head, position) pairs, rows = (H / Hkv) S of them, and a
// block reads its keys' page ids from pages[b, :] itself (in place of the
// scalar prefetch; through L1, so the table's length sets no limit).  The
// trash page reads as zeros, never from memory: a visible trash slot has
// score 0 and adds nothing through v = 0, so a row whose table is all
// trash gives zeros and a NaN dumped on the trash page reaches no row; a
// page id outside [0, P] reads as trash too.  A bf16 q over an f32 cache
// is widened to f32 by the wrapper, exactly.
//
// Scores as the reference's gather path computes them
// (bigdl_tpu/nn/attention.py:341-369): q.k in f32, rounded to bf16, scaled
// and rounded again when q and the cache are both bf16 (jnp.einsum keeps
// bf16 x bf16 in bf16; scores kept in f32 fail phase 2e's large-score
// case), scaled in f32 otherwise; l > positions[b, s] masked with -inf.
// The softmax is in f32.  The wrapper plans one of two paths by shape
// alone (ops/attention.py paged_plan), never reading the positions or the
// table on the host:
//
// (a) tensor cores: bf16 q over a bf16 cache, at least 64 packed rows, D
//     16-256 (prefill).  A block is one consumer warpgroup that owns 64
//     packed rows and one producer warp.  The consumers copy the q tile
//     once into the swizzled layout wgmma reads (wgmma.cuh); the producer
//     gathers each 64-key K and V tile from the pool into the same layout
//     with 16-byte cp.async copies, through a ring of stages (3, or 2 at D
//     256) on mbarriers.  cp.async and not TMA: a copy whose source size is
//     0 zero-fills a trash slot, a page id outside [0, P] or a key past the
//     block's last visible key without reading it, at any page size (TMA
//     would need one box a page, the page size a multiple of 8 dividing
//     64, and the producer zeroing trash slots itself).  The producer hands
//     a stage over only after its copies have landed (cp.async.wait_group)
//     and a proxy fence has made them visible to wgmma, and it hands over
//     the oldest landed tile before it waits for a free stage, so the
//     consumers never wait for the next tile's copies to be issued.
//     s = q k^T is an SS wgmma; after the masks, the online softmax of
//     attention.cu's K9 (a running max and sum per row), p rounded to bf16
//     as the register A operand of acc += p v, with V read MN-major
//     through the descriptor.
//     Where the reference normalises p by the row sum before it casts p to
//     bf16, this path rounds the unnormalised p of each tile and divides
//     once at the end: the two land within one bf16 step of sum |p v|
//     apart.  A block walks the key tiles up to the last key any of its
//     rows sees, read from the positions on the device.
// (b) page split: every other call (decode at S 1, fewer than 64 packed
//     rows, an f32 cache, f32 q over a bf16 cache, other head dims up to
//     1024).  A block of 4 warps owns up to 16 packed rows (rows x D <=
//     1024 output elements, 8 a thread) of one (row, KV head) and one
//     split of the row's pages; the splits are planned so that the decode
//     shape's grid fills the card for two waves or more where only a part
//     of each table is visible.  A split whose pages start past its rows'
//     last visible key writes an empty partial (max -inf, sum 0) and
//     exits.  K and V come through a double-buffered ring of cp.async
//     copies (16 bytes where the rows allow, 4 or 8, or 2-byte loads for
//     a bf16 row of odd length) with trash zero-filled, into rows padded
//     by 16 bytes so that the threads of a key tile read them without
//     bank conflicts.  FFMA scores (thread (key, part of the rows)), the
//     online softmax in f32 (a warp a row) and f32 p v (thread a (row,
//     column) element).  One split writes o directly; with more, each
//     writes its rows' max, sum and f32 p v, and a second kernel adds
//     them in split order and rounds o once to the cache dtype, so two
//     launches are bit-equal (no atomics).
//
// Bound on the H100: bytes.  Each visible K/V token is read once per (row,
// KV head) and row tile, plus q and the output, over 3.35 TB/s; the work
// is 4 D FLOPs per visible (query, key) pair and head.  At the decode shape
// (8 rows, 8 heads, S 1, D 64, ~560 visible tokens, bf16) that is ~9 MB,
// ~3 us, and the kernel is latency-bound: a split's two tiles of loads,
// then the combine's launch.  Neither path keeps a row of L scores in
// shared memory, so the table's length sets no limit.
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bigdl::ex2;
using bigdl::from_f32;
using bigdl::pack_bf16x2;
using bigdl::to_f32;
using bigdl::warp_max;
using bigdl::warp_sum;
using bf16 = __nv_bfloat16;
namespace wg = bigdl::wg;
using wg::frag_col;
using wg::frag_row;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcRows = 64;       // (a): packed rows a block, keys a tile
constexpr int kSplitThreads = 128;
constexpr int kMaxRows = 16;      // (b): packed rows a block
constexpr int kMaxOut = 8;        // (b): output elements a thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pages;
  const int* pos;
  void* o;
  float* part;    // (b) with splits: m, l (N, splits, 2), then acc (N,
                  // splits, D), N = B Hkv rows
  int h, hkv, s, d, ps, lp, trash;
  int rows;       // packed rows of a (row, KV head): (H / Hkv) S
  int rpb;        // (b): packed rows a block
  int splits, sp; // (b): splits of the row's pages, pages a split
  int kt;         // (b): keys a staged tile
  int unit;       // (b): bytes a copy
  float scale;
};

// the element offset of packed row r of (row b, KV head kvh) in q and o:
// head kvh * (H / Hkv) + r / S, position r % S
__device__ __forceinline__ long long row_off(const Params& p, int b, int kvh,
                                             int r) {
  const int hh = kvh * (p.h / p.hkv) + r / p.s;
  return ((static_cast<long long>(b) * p.h + hh) * p.s + r % p.s) * p.d;
}

// the pool element offset of key l of KV head kvh through the row's pages,
// or -1 where its page is the trash page or an id outside [0, P]
__device__ __forceinline__ long long key_off(const Params& p,
                                             const int* row_pages, int kvh,
                                             int l) {
  const int phys = row_pages[l / p.ps];
  if (phys < 0 || phys >= p.trash) return -1;
  return ((static_cast<long long>(phys) * p.hkv + kvh) * p.ps + l % p.ps) *
         p.d;
}

// ---- (a) tensor cores ------------------------------------------------------

template <int D>
struct Tc {  // the block's shape and its shared memory, from a 1024-byte
             // aligned base
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr int kLag = kStages - 1;  // tiles in flight while the
                                            // producer waits for a stage
  static constexpr int kThreads = 128 + 32;
  static constexpr int kTile = kTcRows * D * 2;  // a q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;               // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // full, empty
  static constexpr int kPos = kBars + 2 * kStages * 8;
  static constexpr int kBytes = kPos + kTcRows * 4 + 1024;
};

// the byte offset of 16-byte chunk c of row `row` in a 64-row tile of D
// columns, as TMA's swizzle would write it (wgmma.cuh): panels of W bytes,
// each row's chunks XOR-ed with address bits 7..
template <int D>
__device__ __forceinline__ uint32_t tile_chunk(int row, int c) {
  constexpr int kW = wg::Tile<D>::kW, kPer = kW / 16;  // chunks a panel row
  const uint32_t off = (c / kPer) * kTcRows * kW + row * kW + (c % kPer) * 16;
  return off ^ (((off >> 7) & (kPer - 1)) << 4);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::kThreads) paged_tc(Params p) {
  using C = Tc<D>;
  constexpr int S = C::kStages, kCpr = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  int* pos_s = reinterpret_cast<int*>(smem + C::kPos);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kTcRows, kvh = blockIdx.y, b = blockIdx.z;
  const int length = p.lp * p.ps;
  const uint32_t full = base + C::kBars, empty = full + 8 * S;
  if (tid < kTcRows) {
    const int r = r0 + tid;
    pos_s[tid] = r < p.rows
        ? p.pos[static_cast<long long>(b) * p.s + r % p.s] : -1;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + 8 * s, 32);  // each producer lane
      wg::mbar_init(empty + 8 * s, 4);  // each consumer warp
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  int maxpos = -1;
  for (int i = 0; i < kTcRows; ++i) maxpos = max(maxpos, pos_s[i]);
  const int kend = min(length, maxpos + 1);  // keys any row of the block sees
  const int n_tiles = (kend + kTcRows - 1) / kTcRows;

  if (warp == 4) {  // the producer warp
    const int* row_pages = p.pages + static_cast<long long>(b) * p.lp;
    const bf16* kpool = static_cast<const bf16*>(p.k);
    const bf16* vpool = static_cast<const bf16*>(p.v);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S, k0 = t * kTcRows;
      if (t >= C::kLag) {  // hand the oldest tile in flight over once it
                           // has landed, before waiting for a free stage
        wg::cp_wait<C::kLag - 1>();
        wg::fence_async_shared();
        wg::mbar_arrive(full + 8 * ((t - C::kLag) % S));
      }
      // this lane's keys k0 + lane and k0 + lane + 32
      long long off[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int l = k0 + lane + 32 * hf;
        off[hf] = l < kend ? key_off(p, row_pages, kvh, l) : -1;
      }
      if (t >= S) wg::mbar_wait(empty + 8 * s, (t / S - 1) & 1);
      const uint32_t ks = base + C::kK + s * C::kTile;
      const uint32_t vs = base + C::kV + s * C::kTile;
#pragma unroll 4
      for (int e = lane; e < kTcRows * kCpr; e += 32) {
        const int row = e / kCpr, c = e % kCpr;
        const long long a0 = __shfl_sync(0xffffffffu, off[0], row & 31);
        const long long a1 = __shfl_sync(0xffffffffu, off[1], row & 31);
        const long long a = row < 32 ? a0 : a1;
        const long long src = a >= 0 ? a + c * 8 : 0;
        const uint32_t at = tile_chunk<D>(row, c);
        wg::cp16(ks + at, kpool + src, a >= 0);
        wg::cp16(vs + at, vpool + src, a >= 0);
      }
      wg::cp_commit();
    }
    wg::cp_wait<0>();
    wg::fence_async_shared();
    for (int t = max(0, n_tiles - C::kLag); t < n_tiles; ++t)
      wg::mbar_arrive(full + 8 * (t % S));
    return;
  }

  // the q tile: the block's packed rows, zeros past p.rows
  const bf16* q = static_cast<const bf16*>(p.q);
  for (int e = tid; e < kTcRows * kCpr; e += 128) {
    const int row = e / kCpr, c = e % kCpr, r = r0 + row;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.rows)
      x = *reinterpret_cast<const uint4*>(q + row_off(p, b, kvh, r) + c * 8);
    *reinterpret_cast<uint4*>(smem + C::kQ + tile_chunk<D>(row, c)) = x;
  }
  wg::fence_async_shared();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumers only

  int pos[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) pos[ri] = pos_s[frag_row(2 * ri)];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S, k0 = t * kTcRows;
    wg::mbar_wait(full + 8 * s, (t / S) & 1);
    wg::fence_async_shared();
    float sc[32];
    wg::mma_fence();
    wg::scores<D>(sc, base + C::kQ, base + C::kK + s * C::kTile);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(sc);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1, key = k0 + frag_col(i);
      const float x =
          bigdl::rounded<bf16>(bigdl::rounded<bf16>(sc[i]) * p.scale);
      sc[i] = key < length && key <= pos[ri] ? x : -INFINITY;
      mt[ri] = fmaxf(mt[ri], sc[i]);
    }
    float mu[2];  // the running max, 0 while a row has seen no key
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mt[ri] = fmaxf(mt[ri], __shfl_xor_sync(0xffffffffu, mt[ri], 1));
      mt[ri] = fmaxf(mt[ri], __shfl_xor_sync(0xffffffffu, mt[ri], 2));
      const float m_new = fmaxf(m[ri], mt[ri]);
      mu[ri] = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = ex2((m[ri] - mu[ri]) * kLog2e);
      m[ri] = m_new;
      l[ri] *= alpha;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (((i >> 1) & 1) == ri) acc[i] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      const float pj = ex2(fmaf(sc[i], kLog2e, -mu[ri] * kLog2e));
      sc[i] = pj;
      l[ri] += pj;
    }
    wg::accumulate<D>(acc, sc, base + C::kV + s * C::kTile);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * s);
  }

  bf16* o = static_cast<bf16*>(p.o);
  long long at[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
    const int r = r0 + frag_row(2 * ri);
    at[ri] = r < p.rows ? row_off(p, b, kvh, r) : -1;
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int ri = (i >> 1) & 1;
    if (at[ri] < 0) continue;
    const float li = l[ri] > 0.0f ? l[ri] : 1.0f;  // no visible key: 0
    *reinterpret_cast<uint32_t*>(o + at[ri] + frag_col(i)) =
        pack_bf16x2(acc[i] / li, acc[i + 1] / li);
  }
}

// ---- (b) page split --------------------------------------------------------

struct SplitLayout {  // byte offsets of a split block's shared memory
  int stride;         // a staged key row: D elements padded to 16, + 16
  int stage;          // one tile of K (or V)
  int q, s, rows, bytes;
};

__host__ __device__ inline SplitLayout split_layout(int d, int esize, int rpb,
                                                    int kt) {
  SplitLayout L;
  L.stride = (d * esize + 15) / 16 * 16 + 16;
  L.stage = kt * L.stride;
  L.q = 4 * L.stage;               // 2 buffers of K and V
  L.s = L.q + rpb * d * 4;         // q rows as f32
  L.rows = L.s + rpb * kt * 4;     // the tile's scores, then p
  L.bytes = L.rows + 4 * kMaxRows * 4;  // positions, m, l, alpha
  return L;
}

// `unit` bytes global -> shared: cp.async of 16, 8 or 4 bytes (zeros when
// !valid, src then not read), or an ordinary 2-byte copy
__device__ __forceinline__ void copy_unit(uint32_t dst, const char* src,
                                          bool valid, int unit) {
  switch (unit) {
    case 16:
      wg::cp16(dst, src, valid);
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
      break;
    default: {
      const unsigned short x =
          valid ? *reinterpret_cast<const unsigned short*>(src) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst), "h"(x)
                   : "memory");
    }
  }
}

// a 16-byte read of 4 floats or 8 bf16 widened to f32 (bf16's bits are
// f32's top half), in registers
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// QT: q's type, CT: the cache's; kRound: both bf16, scores rounded to bf16
template <typename QT, typename CT, bool kRound>
__global__ void __launch_bounds__(kSplitThreads) paged_split(Params p) {
  constexpr int kE = sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.d, kt = p.kt, j = blockIdx.x;
  const int kvh = blockIdx.y % p.hkv, b = blockIdx.z;
  const int r0 = blockIdx.y / p.hkv * p.rpb, nr = min(p.rpb, p.rows - r0);
  const SplitLayout L = split_layout(D, kE, p.rpb, kt);
  float* qs = reinterpret_cast<float*>(smem + L.q);    // [rpb][D]
  float* ss = reinterpret_cast<float*>(smem + L.s);    // [rpb][kt]
  int* pos_s = reinterpret_cast<int*>(smem + L.rows);  // [kMaxRows]
  float* ms = reinterpret_cast<float*>(pos_s + kMaxRows);
  float* ls = ms + kMaxRows;
  float* als = ls + kMaxRows;
  const uint32_t stages = wg::smem_addr(smem);
  const int length = p.lp * p.ps;

  if (tid < kMaxRows) {
    pos_s[tid] = tid < nr ? p.pos[static_cast<long long>(b) * p.s +
                                  (r0 + tid) % p.s] : -1;
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  __syncthreads();
  int maxpos = -1;
  for (int i = 0; i < nr; ++i) maxpos = max(maxpos, pos_s[i]);
  const int kend = min(length, maxpos + 1);  // keys any row of the block sees
  const int ks = j * p.sp * p.ps;
  const int ke = min(kend, (j + 1) * p.sp * p.ps);
  const long long N = static_cast<long long>(gridDim.z) * p.hkv * p.rows;
  const long long prow = (static_cast<long long>(b) * p.hkv + kvh) * p.rows +
                         r0;  // the block's first packed row of all N
  float* acc_out = p.part + 2 * N * p.splits;
  CT* o = static_cast<CT*>(p.o);

  if (ks >= ke) {  // no visible key in this split: an empty partial
    if (p.splits > 1) {
      for (int e = tid; e < nr * D; e += kSplitThreads)
        acc_out[((prow + e / D) * p.splits + j) * D + e % D] = 0.0f;
      if (tid < nr) {
        float* ml = p.part + ((prow + tid) * p.splits + j) * 2;
        ml[0] = -INFINITY;
        ml[1] = 0.0f;
      }
    } else {
      for (int e = tid; e < nr * D; e += kSplitThreads)
        o[row_off(p, b, kvh, r0 + e / D) + e % D] = from_f32<CT>(0.0f);
    }
    return;
  }

  // one tile of K and V (keys [k0, k0 + kt)) into buffer t & 1, zeros for
  // the trash page and for keys at or past ke; a thread loads the page ids
  // of kBatch copies before it issues them, so their loads overlap
  const int* row_pages = p.pages + static_cast<long long>(b) * p.lp;
  const char* kpool = static_cast<const char*>(p.k);
  const char* vpool = static_cast<const char*>(p.v);
  const int upr = D * kE / p.unit;  // copies a key row
  auto stage = [&](int t) {
    constexpr int kBatch = 8;
    const int k0 = ks + t * kt, total = kt * upr;
    const uint32_t kb = stages + (t & 1) * 2 * L.stage, vb = kb + L.stage;
    for (int e0 = tid; e0 < total; e0 += kSplitThreads * kBatch) {
      long long a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kSplitThreads, l = k0 + e / upr;
        a[u] = e < total && l < ke ? key_off(p, row_pages, kvh, l) : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kSplitThreads;
        if (e >= total) break;
        const int row = e / upr, c = e - row * upr;
        const long long src = a[u] >= 0 ? a[u] * kE + c * p.unit : 0;
        const uint32_t dst = row * L.stride + c * p.unit;
        copy_unit(kb + dst, kpool + src, a[u] >= 0, p.unit);
        copy_unit(vb + dst, vpool + src, a[u] >= 0, p.unit);
      }
    }
  };

  // the first two tiles' copies fly while q is read
  const int n_tiles = (ke - ks + kt - 1) / kt;
  stage(0);
  wg::cp_commit();
  if (n_tiles > 1) {
    stage(1);
    wg::cp_commit();
  }
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < nr * D; e += kSplitThreads)
    qs[e] = to_f32(q[row_off(p, b, kvh, r0 + e / D) + e % D]);
  const int parts = kSplitThreads / kt, kk = tid % kt, part = tid / kt;
  const bool vec = (D * kE) % 16 == 0;
  float acc[kMaxOut];
#pragma unroll
  for (int jj = 0; jj < kMaxOut; ++jj) acc[jj] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)  // tile t + 1's copies may still fly
      wg::cp_wait<1>();
    else
      wg::cp_wait<0>();
    __syncthreads();
    const int k0 = ks + t * kt, kn = min(kt, ke - k0);
    const unsigned char* kb = smem + (t & 1) * 2 * L.stage;
    const unsigned char* vb = kb + L.stage;

    // scores: thread (key kk, part) takes rows part, part + parts, ...
    if (kk < kn) {
      float dot[kMaxRows / 2];
#pragma unroll
      for (int jj = 0; jj < kMaxRows / 2; ++jj) dot[jj] = 0.0f;
      const unsigned char* kr = kb + kk * L.stride;
      if (vec) {
        constexpr int kV = 16 / kE;  // elements a 16-byte read
        for (int c = 0; c < D; c += kV) {
          float x[kV];
          unpack(*reinterpret_cast<const uint4*>(kr + c * kE), x);
#pragma unroll
          for (int jj = 0; jj < kMaxRows / 2; ++jj) {
            const int i = part + parts * jj;
            if (i >= nr) break;
#pragma unroll
            for (int u = 0; u < kV; ++u)
              dot[jj] = fmaf(qs[i * D + c + u], x[u], dot[jj]);
          }
        }
      } else {
        const CT* x = reinterpret_cast<const CT*>(kr);
        for (int c = 0; c < D; ++c) {
          const float kv = to_f32(x[c]);
#pragma unroll
          for (int jj = 0; jj < kMaxRows / 2; ++jj) {
            const int i = part + parts * jj;
            if (i >= nr) break;
            dot[jj] = fmaf(qs[i * D + c], kv, dot[jj]);
          }
        }
      }
      const int key = k0 + kk;
#pragma unroll
      for (int jj = 0; jj < kMaxRows / 2; ++jj) {
        const int i = part + parts * jj;
        if (i >= nr) break;
        const float x =
            kRound ? bigdl::rounded<bf16>(bigdl::rounded<bf16>(dot[jj]) *
                                          p.scale)
                   : dot[jj] * p.scale;
        ss[i * kt + kk] = key <= pos_s[i] ? x : -INFINITY;
      }
    }
    __syncthreads();

    // the online softmax in f32, a warp a row: p = exp(s - m) in place
    for (int i = warp; i < nr; i += kSplitThreads / 32) {
      float* row = ss + i * kt;
      const float m_old = ms[i];
      float mt = -INFINITY;
      for (int c = lane; c < kn; c += 32) mt = fmaxf(mt, row[c]);
      const float m_new = fmaxf(m_old, warp_max(mt));
      const float mu = m_new == -INFINITY ? 0.0f : m_new;
      float sum = 0.0f;
      for (int c = lane; c < kn; c += 32) {
        const float e = expf(row[c] - mu);
        row[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - mu);
        als[i] = alpha;
        ls[i] = ls[i] * alpha + sum;
        ms[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc alpha + p v: thread element e = tid + 128 jj is (row e / D,
    // column e % D)
#pragma unroll
    for (int jj = 0; jj < kMaxOut; ++jj) {
      const int e = tid + jj * kSplitThreads;
      if (e >= nr * D) break;
      const int i = e / D, c = e % D;
      const float* pr = ss + i * kt;
      float a = acc[jj] * als[i];
      for (int u = 0; u < kn; ++u)
        a = fmaf(pr[u],
                 to_f32(*reinterpret_cast<const CT*>(vb + u * L.stride +
                                                     c * kE)),
                 a);
      acc[jj] = a;
    }
    __syncthreads();  // every read of this buffer is done: tile t + 2's
    if (t + 2 < n_tiles) {
      stage(t + 2);
      wg::cp_commit();
    }
  }

  if (p.splits == 1) {
#pragma unroll
    for (int jj = 0; jj < kMaxOut; ++jj) {
      const int e = tid + jj * kSplitThreads;
      if (e >= nr * D) break;
      const int i = e / D;
      o[row_off(p, b, kvh, r0 + i) + e % D] =
          from_f32<CT>(ls[i] > 0.0f ? acc[jj] / ls[i] : 0.0f);
    }
    return;
  }
#pragma unroll
  for (int jj = 0; jj < kMaxOut; ++jj) {
    const int e = tid + jj * kSplitThreads;
    if (e >= nr * D) break;
    acc_out[((prow + e / D) * p.splits + j) * D + e % D] = acc[jj];
  }
  if (tid < nr) {
    float* ml = p.part + ((prow + tid) * p.splits + j) * 2;
    ml[0] = ms[tid];
    ml[1] = ls[tid];
  }
}

// the splits' partials of packed row blockIdx.x (of all N) added in split
// order and o rounded once to the cache dtype: each split's weight
// exp(m_j - m) (0 for an empty one, whose partial p v is zeros) staged
// once in shared memory
template <typename CT>
__global__ void __launch_bounds__(kSplitThreads) paged_combine(Params p) {
  extern __shared__ float sh[];  // m, l, weight: [splits] each
  float* ms = sh;
  float* ls = ms + p.splits;
  float* ws = ls + p.splits;
  const long long n = blockIdx.x, N = gridDim.x;
  const int r = static_cast<int>(n % p.rows);
  const int kvh = static_cast<int>(n / p.rows % p.hkv);
  const int b = static_cast<int>(n / p.rows / p.hkv);
  const float* ml = p.part + n * p.splits * 2;
  const float* acc = p.part + 2 * N * p.splits + n * p.splits * p.d;
  for (int j = threadIdx.x; j < p.splits; j += kSplitThreads) {
    ms[j] = ml[2 * j];
    ls[j] = ml[2 * j + 1];
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = 0; j < p.splits; ++j)
    if (ls[j] > 0.0f) m = fmaxf(m, ms[j]);
  for (int j = threadIdx.x; j < p.splits; j += kSplitThreads)
    ws[j] = ls[j] > 0.0f ? expf(ms[j] - m) : 0.0f;
  __syncthreads();
  float sum = 0.0f;
  for (int j = 0; j < p.splits; ++j) sum = fmaf(ws[j], ls[j], sum);
  CT* o = static_cast<CT*>(p.o) + row_off(p, b, kvh, r);
  for (int c = threadIdx.x; c < p.d; c += kSplitThreads) {
    float a = 0.0f;
    for (int j = 0; j < p.splits; ++j) a = fmaf(ws[j], acc[j * p.d + c], a);
    o[c] = from_f32<CT>(sum > 0.0f ? a / sum : 0.0f);
  }
}

// ---- launch -----------------------------------------------------------------

template <typename K>
cudaError_t run(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                const Params& p) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Params& p, int b, cudaStream_t s) {
  return run(paged_tc<D>, dim3((p.rows + kTcRows - 1) / kTcRows, p.hkv, b),
             Tc<D>::kThreads, Tc<D>::kBytes, s, p);
}

template <typename QT, typename CT, bool kRound>
cudaError_t launch_split(const Params& p, int b, cudaStream_t s) {
  const int tiles = (p.rows + p.rpb - 1) / p.rpb;
  const SplitLayout L = split_layout(p.d, sizeof(CT), p.rpb, p.kt);
  cudaError_t e = run(paged_split<QT, CT, kRound>,
                      dim3(p.splits, tiles * p.hkv, b), kSplitThreads,
                      L.bytes, s, p);
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long n = static_cast<long long>(b) * p.hkv * p.rows;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  return run(paged_combine<CT>, dim3(static_cast<unsigned int>(n)),
             kSplitThreads, 3 * p.splits * static_cast<int>(sizeof(float)),
             s, p);
}

}  // namespace

// K12: q (b, h, s, d) f32/bf16; pools (trash + 1, hkv, ps, d) f32/bf16;
// pages (b, lp) and positions (b, s) int32 -> o (b, h, s, d) in the cache
// dtype.  The plan (ops/attention.py paged_plan): tc, the tensor-core path
// (bf16 q and cache, d 16-256), else the page split with rpb packed rows a
// block, `splits` splits of sp pages and kt keys a staged tile; scratch is
// (b hkv rows splits (d + 2)) f32 when splits > 1, else null.
extern "C" int bigdl_paged_attention(const void* q, const void* k,
                                     const void* v, const void* pages,
                                     const void* positions, void* o,
                                     void* scratch, int q_dtype, int c_dtype,
                                     int b, int h, int hkv, int s, int d,
                                     int ps, int lp, int trash, float scale,
                                     int tc, int rpb, int splits, int sp,
                                     int kt, void* stream) {
  if (b == 0 || h == 0 || s == 0) return static_cast<int>(cudaSuccess);
  if (hkv < 1 || h % hkv || ps < 1 || lp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, static_cast<const int*>(pages),
           static_cast<const int*>(positions), o,
           static_cast<float*>(scratch), h, hkv, s, d, ps, lp, trash,
           (h / hkv) * s, rpb, splits, sp, kt, 16, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (tc) {
    if (q_dtype != bigdl::kBF16 || c_dtype != bigdl::kBF16 ||
        reinterpret_cast<uintptr_t>(k) % 16 ||
        reinterpret_cast<uintptr_t>(v) % 16 ||
        reinterpret_cast<uintptr_t>(q) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16: e = launch_tc<16>(p, b, st); break;
      case 32: e = launch_tc<32>(p, b, st); break;
      case 64: e = launch_tc<64>(p, b, st); break;
      case 128: e = launch_tc<128>(p, b, st); break;
      case 256: e = launch_tc<256>(p, b, st); break;
      default: break;
    }
    return static_cast<int>(e);
  }
  if (rpb < 1 || rpb > kMaxRows || rpb * d > kMaxOut * kSplitThreads ||
      (kt != 8 && kt != 16 && kt != 32 && kt != 64) || splits < 1 ||
      (splits > 1 && (!scratch || sp < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest copy that the rows and both pools' alignment allow
  const int esize = c_dtype == bigdl::kF32 ? 4 : 2;
  const uintptr_t at = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v) |
                       static_cast<uintptr_t>(d * esize);
  p.unit = at % 16 == 0 ? 16 : at % 8 == 0 ? 8 : at % 4 == 0 ? 4 : 2;
  if (q_dtype == bigdl::kF32 && c_dtype == bigdl::kF32)
    e = launch_split<float, float, false>(p, b, st);
  else if (q_dtype == bigdl::kBF16 && c_dtype == bigdl::kBF16)
    e = launch_split<bf16, bf16, true>(p, b, st);
  else if (q_dtype == bigdl::kF32 && c_dtype == bigdl::kBF16)
    e = launch_split<float, bf16, false>(p, b, st);
  return static_cast<int>(e);
}
