// K1: NCHW max pool forward with an optional stored argmax code, and
// K3: its backward, routing dy through that code.
//
// K1 replaces bigdl_tpu/ops/pooling.py:99 `_fwd_kernel` (reached through
// `_max_pool_fwd_impl`), K3 bigdl_tpu/ops/pooling.py:130 `_bwd_kernel`
// (reached through `_max_pool_pallas_bwd`).  The TPU kernels emulated
// strided window reads and the backward scatter with one-hot MXU matmuls
// and dilations in VMEM, and padded with a finite bf16 minimum: Mosaic
// workarounds with no counterpart here.
//
// Bound on the H100: bytes.  K1 reads x once and writes y (and idx) once,
// (|x| + |y| + |idx|) / 3.35 TB/s; K3 reads dy and idx once and writes dx
// once, (|dy| + |idx| + |dx|) / 3.35 TB/s.  Per element there are at most
// kh * kw compares (K1) or code tests (K3), far below the card's rate.
//
// Design.  A block owns a contiguous span of its planes: `planes` whole
// planes (ops/pooling.py `pool_plan` picks them so that the 13 Inception
// pools put several blocks on every SM), or, for a plane over the plan's
// shared-memory budget or too few planes to fill the card, a band of
// `rows` rows of one plane, with its halo: the input rows its windows
// reach (K1: kh - sh rows past the band at stride sh), or the dy and code
// rows of every window that reaches the band's dx rows (K3).  A row too
// wide for the budget is cut as well, into tiles of `cols` columns (y
// columns in K1; dx columns in K3, a multiple of the stride) with the same
// halo across columns.  The grid is one-dimensional: a block finds its
// planes, band and tile from blockIdx.x.
// 1. The block copies its input span into shared memory: 16-byte cp.async
//    copies over the 16-byte aligned body, scalar loads for a misaligned
//    head and tail, into a buffer placed at the source's address mod 16 so
//    that both ends of every 16-byte copy are aligned.  Window overlap
//    (each x cell read by up to 9 windows at stride 1) then costs no device
//    traffic.  A tile's rows are not contiguous: it copies them row by row
//    into rows of a fixed pitch.
// 2. Each thread walks the block's work items a block's thread count
//    apart: y elements (K1); stride cells of sh x sw dx elements (K3, fixed
//    windows) or dx elements (K3, generic).  Its (plane, row, item) is
//    carried forward by adds and compares: two 32-bit divisions per thread,
//    at its start, and none per element or in 64 bits.  Results go to
//    shared memory, placed like the output's address mod 16.
// 3. The block stores its output span with 16-byte stores over the aligned
//    body and scalar stores at a misaligned head and tail (a tile row by
//    row).
// Both kernels are templated on whether a row is cut into tiles (so whole
// rows pay nothing for them) and on the window (kh, kw, sh, sw) of the
// path's geometries, 3x3/2, 3x3/1 and 2x2/2, whose window loops unroll with
// no branch: K1 starts its scan at the window's first cell in the plane and
// reads -inf outside it; a K3 thread loads each window that reaches its
// stride cell once, and knows at compile time at which offset (p, q) each
// of them reaches each of its cells, so a code test is one compare and the
// stride tests are gone.  Every other geometry takes the generic
// instantiation (<0, 0, 0, 0>), whose sizes are read at run time; its K3
// takes each padded dx row's and column's quotient and remainder by the
// stride from tables built once per block, so it too divides per row and
// per column, not per element.  `variant` is the one table of which window
// takes which instantiation; `bigdl_max_pool2d_variant` gives its code.  The
// entry points size a block's shared memory from the plan themselves
// (fwd_smem, bwd_smem: the largest block's layout) and refuse a plan over
// the card's limit.
//
// Tie rule: the window is scanned in row-major order and compared in f32
// with a strict `>`, so the FIRST maximal offset wins (Torch / XLA /
// `ops/pooling.py:123`).  A window with no cell in the plane (ceil mode
// with the stride past the window) gives -inf and code 0.  The index is the
// window-offset code p*kw+q as uint8 (kh*kw <= 255, checked by the
// wrapper).  K3 is a gather: each dx element visits the windows that cover
// its cell and adds dy where the stored code names its own offset (p, q).
// No atomics, so the result is deterministic; the sum is taken in f32 over
// q within each window row p, then over p in ascending order, and rounded
// once to dy's dtype, which is the order of ops/pooling.py
// `max_pool2d_bwd_plain`, so the two are bit-equal.  Padding cells and the
// ceil-mode tail are never written.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSmemLimit = 232448;  // the most one block can have

// The geometry of a launch and its plan.  A block holds G whole planes, or
// (G 1) a band of B rows, y rows in K1 and dx rows in K3, and of those a
// tile of C columns, y columns in K1 and dx columns in K3 (the plane's all
// in whole-plane blocks); nb bands a plane, nt tiles a row.  A block's
// threads walk its work items (y elements in K1; dx elements in the
// generic K3, stride cells of sh x sw dx elements in the fixed ones) in
// rows of wl items, wb rows a plane (kBandRows in a band, which is of one
// plane); (dg, dr, dc) is the block's thread count as planes, rows and
// items of that walk.
struct PoolArgs {
  int planes;
  int h, w, oh, ow;
  int kh, kw, sh, sw, ph, pw;
  int G, B, C, nb, nt;
  int wl, wb, dg, dr, dc;
  int ni, nj;  // K3: ceil(kh / sh), ceil(kw / sw)
};

constexpr int kBandRows = 1 << 30;

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// A block's planes [g0, g0 + gn), band and tile, from blockIdx.x.
struct Block {
  int g0, gn, band, tile;
  __device__ __forceinline__ explicit Block(const PoolArgs& a) {
    const int per = a.nb * a.nt;
    const int x = blockIdx.x / per;
    const int rest = blockIdx.x - x * per;
    band = rest / a.nt;
    tile = rest - band * a.nt;
    g0 = x * a.G;
    gn = min(a.G, a.planes - g0);
  }
};

// A thread's place in its block's walk: plane g, row r, item c.
struct Walk {
  int g, r, c;
  __device__ __forceinline__ Walk(int j, const PoolArgs& a) {
    const int row = j / a.wl;
    c = j - row * a.wl;
    g = row / a.wb;
    r = row - g * a.wb;
  }
  __device__ __forceinline__ void step(const PoolArgs& a) {
    c += a.dc;
    r += a.dr;
    g += a.dg;
    if (c >= a.wl) {
      c -= a.wl;
      ++r;
    }
    if (r >= a.wb) {
      r -= a.wb;
      ++g;
    }
  }
};

// Copy n elements of src into the shared region at `region` (16 + n *
// sizeof(T) bytes, 16-byte aligned) and return where they start there: at
// src's address mod 16, so the 16-byte aligned body goes by 16-byte
// cp.async copies; the head before it and the tail after it by scalar
// loads.  The caller waits for the copies (wait_copies) before it reads.
template <typename T>
__device__ __forceinline__ T* stage_in(unsigned char* region, const T* src,
                                       int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  T* dst = reinterpret_cast<T*>(region + mis);
  const int head = min(n, ((16 - mis) & 15) / static_cast<int>(sizeof(T)));
  const int body = (n - head) / kVec;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int v = threadIdx.x; v < body; v += blockDim.x)
    bigdl::wg::cp16(bigdl::wg::smem_addr(dst + head + v * kVec),
                    src + head + v * kVec, true);
  for (int i = head + body * kVec + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
  return dst;
}

__device__ __forceinline__ void wait_copies() {
  bigdl::wg::cp_commit();
  bigdl::wg::cp_wait<0>();
  __syncthreads();
}

// Where in a shared region an output span bound for `p` is built: at p's
// address mod 16, as stage_in places an input.
template <typename T>
__device__ __forceinline__ T* placed(unsigned char* region, const T* p) {
  return reinterpret_cast<T*>(region + (reinterpret_cast<uintptr_t>(p) & 15));
}

// Store n elements built at src (placed for dst) to dst: 16-byte stores
// over the aligned body, scalar stores at the head and tail.
template <typename T>
__device__ __forceinline__ void store_out(const T* src, T* dst, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(n, ((16 - mis) & 15) / static_cast<int>(sizeof(T)));
  const int body = (n - head) / kVec;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int v = threadIdx.x; v < body; v += blockDim.x) d[v] = s[v];
  for (int i = head + body * kVec + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// A tile's rows: `rows` rows of n elements, src's `sp` apart, to dst's
// `dp` apart, by scalar loads and stores along each row.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dp, const T* src,
                                          int sp, int rows, int n) {
  for (int r = 0; r < rows; ++r)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[r * dp + i] = src[r * sp + i];
}

// K1.  A block: planes [g0, g0 + gn) whole, or y rows [oy0, oy0 + R) by y
// columns [oc0, oc0 + Cn) of one plane (kTiled: a row is cut into tiles).
template <typename T, int KH, int KW, int SH, int SW, bool kTiled>
__global__ void __launch_bounds__(kMaxThreads)
    pool_fwd(const T* __restrict__ x, T* __restrict__ y,
             uint8_t* __restrict__ idx, PoolArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFixed = KH > 0;
  const int kh = KH ? KH : a.kh, kw = KW ? KW : a.kw;
  const int sh = SH ? SH : a.sh, sw = SW ? SW : a.sw;
  const Block b(a);
  constexpr bool tiled = kTiled;
  // the input rows [ir0, ir1) the block's y rows read
  int oy0 = 0, R = a.oh, ir0 = 0, ir1 = a.h;
  if (a.nb > 1 || tiled) {
    oy0 = b.band * a.B;
    R = min(a.B, a.oh - oy0);
    ir0 = min(a.h, max(0, oy0 * sh - a.ph));
    ir1 = max(ir0, min(a.h, (oy0 + R - 1) * sh - a.ph + kh));
  }
  // the input columns [ic0, ic1) a tile's y columns read, staged in rows
  // of P
  int oc0 = 0, Cn = a.ow, ic0 = 0, ic1 = a.w, P = a.w;
  if constexpr (tiled) {
    oc0 = b.tile * a.C;
    Cn = min(a.C, a.ow - oc0);
    ic0 = min(a.w, max(0, oc0 * sw - a.pw));
    ic1 = max(ic0, min(a.w, (oc0 + Cn - 1) * sw - a.pw + kw));
    P = (a.C - 1) * sw + kw;
  }
  const int in_plane = (ir1 - ir0) * P, out_plane = R * a.C;
  const int n_in = b.gn * in_plane, n_out = b.gn * out_plane;
  const long long in_off = static_cast<long long>(b.g0) * a.h * a.w +
                           static_cast<long long>(ir0) * a.w + ic0;
  const long long out_off = static_cast<long long>(b.g0) * a.oh * a.ow +
                            static_cast<long long>(oy0) * a.ow + oc0;

  unsigned char* region = smem;
  const T* xs = reinterpret_cast<const T*>(region);
  if constexpr (tiled)
    copy_rows(reinterpret_cast<T*>(region), P, x + in_off, a.w, ir1 - ir0,
              ic1 - ic0);
  else
    xs = stage_in(region, x + in_off, n_in);
  region += round16(16 + n_in * static_cast<int>(sizeof(T)));
  T* ys = tiled ? reinterpret_cast<T*>(region) : placed(region, y + out_off);
  region += round16(16 + n_out * static_cast<int>(sizeof(T)));
  uint8_t* is = idx == nullptr ? nullptr
                : tiled        ? region
                               : placed(region, idx + out_off);
  wait_copies();

  Walk at(threadIdx.x, a);
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    const T* xp = xs + at.g * in_plane;
    const int y0 = (oy0 + at.r) * sh - a.ph;  // the window's first input row
    const int x0 = (oc0 + at.c) * sw - a.pw;  // and column
    const int o = (y0 - ir0) * P + x0 - ic0;  // and its origin in xp
    // the window's cells in the plane are rows [p_lo, ..) by columns
    // [q_lo, ..): its first one in row-major order starts the scan, and a
    // cell outside reads -inf, which no strict > takes.  A window wholly
    // past the plane's end has no cell: -inf and code 0.  Only a stride
    // past the window leaves one (ceil mode, pad 0), so not a fixed one.
    const int p_lo = max(0, -y0), q_lo = max(0, -x0);
    const bool none = !kFixed && (y0 >= a.h || x0 >= a.w);
    const float first = bigdl::to_f32(xp[none ? 0 : o + p_lo * P + q_lo]);
    float best = none ? -INFINITY : first;
    int code = none ? 0 : p_lo * kw + q_lo;
#pragma unroll
    for (int p = 0; p < kh; ++p) {
      const bool row_in = y0 + p >= 0 && y0 + p < a.h;
#pragma unroll
      for (int q = 0; q < kw; ++q) {
        const bool in = row_in && x0 + q >= 0 && x0 + q < a.w;
        const float v = in ? bigdl::to_f32(xp[o + p * P + q]) : -INFINITY;
        if (v > best) {
          best = v;
          code = p * kw + q;
        }
      }
    }
    ys[j] = bigdl::from_f32<T>(best);
    if (is != nullptr) is[j] = static_cast<uint8_t>(code);
    at.step(a);
  }
  __syncthreads();
  if constexpr (tiled) {
    copy_rows(y + out_off, a.ow, ys, a.C, R, Cn);
    if (is != nullptr) copy_rows(idx + out_off, a.ow, is, a.C, R, Cn);
  } else {
    store_out(ys, y + out_off, n_out);
    if (is != nullptr) store_out(is, idx + out_off, n_out);
  }
}

// K3.  A block: planes [g0, g0 + gn) whole, or dx rows [iy0, iy0 + R) by
// dx columns [ic0, ic0 + Cn) of one plane; and the windows, rows [oy_lo,
// oy_hi] by columns [ox_lo, ox_hi], that reach them (kTiled: a row is cut
// into tiles).
template <typename T, int KH, int KW, int SH, int SW, bool kTiled>
__global__ void __launch_bounds__(kMaxThreads)
    pool_bwd(const T* __restrict__ dy, const uint8_t* __restrict__ idx,
             T* __restrict__ dx, PoolArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFixed = KH > 0;
  const int kh = KH ? KH : a.kh, kw = KW ? KW : a.kw;
  const int sh = SH ? SH : a.sh, sw = SW ? SW : a.sw;
  const Block b(a);
  constexpr bool tiled = kTiled;
  int iy0 = 0, R = a.h, oy_lo = 0, oy_hi = a.oh - 1;
  if (a.nb > 1 || tiled) {
    iy0 = b.band * a.B;
    R = min(a.B, a.h - iy0);
    const int top = iy0 + a.ph - kh + 1;  // padded row of window oy_lo's end
    oy_lo = top > 0 ? (top + sh - 1) / sh : 0;
    oy_hi = min(a.oh - 1, (iy0 + R - 1 + a.ph) / sh);
  }
  // a tile's windows are staged in rows of P
  int ic0 = 0, Cn = a.w, ox_lo = 0, ox_hi = a.ow - 1, P = a.ow;
  if constexpr (tiled) {
    ic0 = b.tile * a.C;
    Cn = min(a.C, a.w - ic0);
    const int left = ic0 + a.pw - kw + 1;  // padded column of ox_lo's end
    ox_lo = left > 0 ? (left + sw - 1) / sw : 0;
    ox_hi = min(a.ow - 1, (ic0 + Cn - 1 + a.pw) / sw);
    P = (a.C + kw - 2) / sw + 1;
  }
  const int win_rows = max(0, oy_hi - oy_lo + 1);
  const int win_plane = win_rows * P, out_plane = R * a.C;
  const int n_in = b.gn * win_plane, n_out = b.gn * out_plane;
  const long long in_off = static_cast<long long>(b.g0) * a.oh * a.ow +
                           static_cast<long long>(oy_lo) * a.ow + ox_lo;
  const long long out_off = static_cast<long long>(b.g0) * a.h * a.w +
                            static_cast<long long>(iy0) * a.w + ic0;

  unsigned char* region = smem;
  const T* dys = reinterpret_cast<const T*>(region);
  if constexpr (tiled)
    copy_rows(reinterpret_cast<T*>(region), P, dy + in_off, a.ow, win_rows,
              max(0, ox_hi - ox_lo + 1));
  else
    dys = stage_in(region, dy + in_off, n_in);
  region += round16(16 + n_in * static_cast<int>(sizeof(T)));
  const uint8_t* codes = region;
  if constexpr (tiled)
    copy_rows(region, P, idx + in_off, a.ow, win_rows,
              max(0, ox_hi - ox_lo + 1));
  else
    codes = stage_in(region, idx + in_off, n_in);
  region += round16(16 + n_in);
  T* dxs = tiled ? reinterpret_cast<T*>(region) : placed(region, dx + out_off);
  region += round16(16 + n_out * static_cast<int>(sizeof(T)));
  // generic windows: each padded row's and column's (quotient, remainder)
  // by the stride, rows [0, R) then columns [0, C)
  int2* tab = reinterpret_cast<int2*>(region);
  if (!kFixed) {
    for (int i = threadIdx.x; i < R + a.C; i += blockDim.x) {
      const int v = i < R ? iy0 + i + a.ph : ic0 + i - R + a.pw;
      const int s = i < R ? sh : sw;
      const int qt = v / s;
      tab[i] = make_int2(qt, v - qt * s);
    }
  }
  wait_copies();

  // window (oy, ox) of plane g at g win_plane + base + oy P + ox
  const int base = -oy_lo * P - ox_lo;
  Walk at(threadIdx.x, a);
  if constexpr (kFixed) {
    // a thread's item is the stride cell (ga, gb): padded rows [SH ga, SH
    // ga + SH) by columns [SW gb, SW gb + SW), reached by windows (ga - i,
    // gb - m), i < NI, m < NJ, window (ga - i, gb - m) at row p = SH i + u
    // and column q = SW m + v of cell (u, v): all known at compile time
    constexpr int NI = (KH + SH - 1) / SH, NJ = (KW + SW - 1) / SW;
    const int a_lo = (iy0 + a.ph) / SH, b_lo = (ic0 + a.pw) / SW;
    const int na = (iy0 + R - 1 + a.ph) / SH - a_lo + 1;
    const int n_cells = b.gn * na * a.wl;
    for (int j = threadIdx.x; j < n_cells; j += blockDim.x) {
      const int ga = a_lo + at.r, gb = b_lo + at.c;
      const int wbase = at.g * win_plane + base;
      int cw[NI][NJ];
      float dw[NI][NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
#pragma unroll
        for (int m = 0; m < NJ; ++m) {
          const int oy = ga - i, ox = gb - m;
          const bool in =
              oy >= oy_lo && oy <= oy_hi && ox >= ox_lo && ox <= ox_hi;
          const int o = wbase + oy * P + ox;
          cw[i][m] = in ? codes[o] : 255;  // no window's code is 255
          dw[i][m] = in ? bigdl::to_f32(dys[o]) : 0.0f;
        }
      }
      T* dxp = dxs + at.g * out_plane;
#pragma unroll
      for (int u = 0; u < SH; ++u) {
        const int row = SH * ga + u - a.ph;
        if (row < iy0 || row >= iy0 + R) continue;
#pragma unroll
        for (int v = 0; v < SW; ++v) {
          const int col = SW * gb + v - a.pw;
          if (col < ic0 || col >= ic0 + Cn) continue;
          // a window that does not name the cell adds +0.0, which changes
          // no sum here (a sum that starts at +0.0 never becomes -0.0)
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < NI; ++i) {  // window rows in ascending order
            if (SH * i + u >= KH) continue;
            float rsum = 0.0f;
#pragma unroll
            for (int m = 0; m < NJ; ++m) {
              if (SW * m + v >= KW) continue;
              const int code = (SH * i + u) * KW + SW * m + v;
              rsum += cw[i][m] == code ? dw[i][m] : 0.0f;
            }
            acc += rsum;
          }
          dxp[(row - iy0) * a.C + col - ic0] = bigdl::from_f32<T>(acc);
        }
      }
      at.step(a);
    }
  } else {
    // a thread's item is one dx cell; the windows that reach it from its
    // row's and column's (quotient, remainder) by the stride
    for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
      const int wbase = at.g * win_plane + base;
      const int2 rt = tab[at.r], ct = tab[R + at.c];
      const int oy0 = rt.x, p0 = rt.y, ox0 = ct.x, q0 = ct.y;
      float acc = 0.0f;
      for (int i = 0; i < a.ni; ++i) {
        const int p = p0 + i * sh, oy = oy0 - i;
        const bool row_in = p < kh && oy >= oy_lo && oy <= oy_hi;
        const int o = wbase + oy * P + ox0;
        float rsum = 0.0f;
        for (int m = 0; m < a.nj; ++m) {
          const int q = q0 + m * sw, ox = ox0 - m;
          if (row_in && q < kw && ox >= ox_lo && ox <= ox_hi &&
              codes[o - m] == p * kw + q)
            rsum += bigdl::to_f32(dys[o - m]);
        }
        acc += rsum;
      }
      dxs[j] = bigdl::from_f32<T>(acc);
      at.step(a);
    }
  }
  __syncthreads();
  if constexpr (tiled)
    copy_rows(dx + out_off, a.w, dxs, a.C, R, Cn);
  else
    store_out(dxs, dx + out_off, n_out);
}

// 0: generic; 1: 3x3 stride 2; 2: 3x3 stride 1; 3: 2x2 stride 2
int variant(int kh, int kw, int sh, int sw) {
  if (kh == 3 && kw == 3 && sh == 2 && sw == 2) return 1;
  if (kh == 3 && kw == 3 && sh == 1 && sw == 1) return 2;
  if (kh == 2 && kw == 2 && sh == 2 && sw == 2) return 3;
  return 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int KH, int KW, int SH, int SW>
cudaError_t launch_fwd(const void* x, void* y, void* idx, const PoolArgs& a,
                       dim3 grid, int threads, int smem, cudaStream_t s) {
  auto k = a.nt > 1 ? pool_fwd<T, KH, KW, SH, SW, true>
                    : pool_fwd<T, KH, KW, SH, SW, false>;
  const cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  k<<<grid, threads, smem, s>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                static_cast<uint8_t*>(idx), a);
  return cudaGetLastError();
}

template <typename T, int KH, int KW, int SH, int SW>
cudaError_t launch_bwd(const void* dy, const void* idx, void* dx,
                       const PoolArgs& a, dim3 grid, int threads, int smem,
                       cudaStream_t s) {
  auto k = a.nt > 1 ? pool_bwd<T, KH, KW, SH, SW, true>
                    : pool_bwd<T, KH, KW, SH, SW, false>;
  const cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  k<<<grid, threads, smem, s>>>(static_cast<const T*>(dy),
                                static_cast<const uint8_t*>(idx),
                                static_cast<T*>(dx), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_for(const void* x, void* y, void* idx, const PoolArgs& a,
                    dim3 grid, int threads, int smem, cudaStream_t s) {
  switch (variant(a.kh, a.kw, a.sh, a.sw)) {
    case 1: return launch_fwd<T, 3, 3, 2, 2>(x, y, idx, a, grid, threads, smem, s);
    case 2: return launch_fwd<T, 3, 3, 1, 1>(x, y, idx, a, grid, threads, smem, s);
    case 3: return launch_fwd<T, 2, 2, 2, 2>(x, y, idx, a, grid, threads, smem, s);
    default: return launch_fwd<T, 0, 0, 0, 0>(x, y, idx, a, grid, threads, smem, s);
  }
}

template <typename T>
cudaError_t bwd_for(const void* dy, const void* idx, void* dx,
                    const PoolArgs& a, dim3 grid, int threads, int smem,
                    cudaStream_t s) {
  switch (variant(a.kh, a.kw, a.sh, a.sw)) {
    case 1: return launch_bwd<T, 3, 3, 2, 2>(dy, idx, dx, a, grid, threads, smem, s);
    case 2: return launch_bwd<T, 3, 3, 1, 1>(dy, idx, dx, a, grid, threads, smem, s);
    case 3: return launch_bwd<T, 2, 2, 2, 2>(dy, idx, dx, a, grid, threads, smem, s);
    default: return launch_bwd<T, 0, 0, 0, 0>(dy, idx, dx, a, grid, threads, smem, s);
  }
}

long long r16(long long bytes) { return (bytes + 15) & ~15LL; }

// The dynamic shared memory of a plan's largest K1 block as pool_fwd lays
// it out: x (a band's input rows, a tile's input columns), y and idx, each
// in a region 16 bytes over what it holds.
long long fwd_smem(const PoolArgs& a, int size) {
  const bool whole = a.nb == 1 && a.nt == 1;
  const long long rows_in =
      whole ? a.h : std::min(a.h, (a.B - 1) * a.sh + a.kh);
  const long long pitch = a.nt > 1 ? (a.C - 1) * a.sw + a.kw : a.w;
  const long long n_in = a.G * rows_in * pitch;
  const long long n_out = static_cast<long long>(a.G) * a.B * a.C;
  return r16(16 + n_in * size) + r16(16 + n_out * size) + r16(16 + n_out);
}

// The same for K3 (pool_bwd): dy and the codes of the windows that reach
// the block's dx rows and columns, dx, and the generic window's tables.
long long bwd_smem(const PoolArgs& a, int size) {
  const bool whole = a.nb == 1 && a.nt == 1;
  const long long win_rows =
      whole ? a.oh : std::min(a.oh, (a.B + a.kh - 2) / a.sh + 1);
  const long long pitch = a.nt > 1 ? (a.C + a.kw - 2) / a.sw + 1 : a.ow;
  const long long n_in = a.G * win_rows * pitch;
  const long long n_out = static_cast<long long>(a.G) * a.B * a.C;
  return r16(16 + n_in * size) + r16(16 + n_in) + r16(16 + n_out * size) +
         8LL * (a.B + a.C);
}

// Fill in a plan of `planes` planes a block, or of one plane's `full` rows
// in bands of `rows` and its `width` columns in tiles of `cols` (a multiple
// of `step` where there is more than one tile), with a walk of wl(C) items
// a row and wb rows a plane, and its block count; false when the kernels
// do not take the plan.
template <typename WalkLength>
bool plan_grid(PoolArgs& a, int full, int width, int step, int planes,
               int rows, int cols, int threads, WalkLength wl, int wb,
               long long& blocks) {
  if (planes < 1 || rows < 1 || rows > full || cols < 1 || cols > width ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return false;
  a.G = planes;
  a.B = rows;
  a.C = cols;
  a.nb = (full + rows - 1) / rows;
  a.nt = (width + cols - 1) / cols;
  if ((a.nb > 1 || a.nt > 1) && planes != 1) return false;
  if (a.nt > 1 && cols % step != 0) return false;
  blocks = static_cast<long long>((a.planes + planes - 1) / planes) * a.nb *
           a.nt;
  if (blocks > INT_MAX) return false;
  a.wl = wl(cols);
  a.wb = a.nb > 1 || a.nt > 1 ? kBandRows : wb;
  const int row_step = threads / a.wl;
  a.dc = threads - row_step * a.wl;
  a.dg = row_step / a.wb;
  a.dr = row_step - a.dg * a.wb;
  a.ni = (a.kh + a.sh - 1) / a.sh;
  a.nj = (a.kw + a.sw - 1) / a.sw;
  return true;
}

}  // namespace

extern "C" int bigdl_max_pool2d_variant(int kh, int kw, int sh, int sw) {
  return variant(kh, kw, sh, sw);
}

extern "C" int bigdl_max_pool2d_fwd(const void* x, void* y, void* idx,
                                    int dtype, int n, int c, int h, int w,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, int oh, int ow, int planes,
                                    int rows, int cols, int threads,
                                    void* stream) {
  if (static_cast<long long>(n) * c * oh * ow == 0)
    return static_cast<int>(cudaSuccess);
  if (dtype != bigdl::kF32 && dtype != bigdl::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  PoolArgs a{n * c, h, w, oh, ow, kh, kw, sh, sw, ph, pw};
  long long blocks = 0;
  if (!plan_grid(a, oh, ow, 1, planes, rows, cols, threads,
                 [](int cols) { return cols; }, oh, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = fwd_smem(a, dtype == bigdl::kF32 ? 4 : 2);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return static_cast<int>(
        fwd_for<float>(x, y, idx, a, grid, threads, smem, s));
  return static_cast<int>(
      fwd_for<__nv_bfloat16>(x, y, idx, a, grid, threads, smem, s));
}

extern "C" int bigdl_max_pool2d_bwd(const void* dy, const void* idx, void* dx,
                                    int dtype, int n, int c, int h, int w,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, int oh, int ow, int planes,
                                    int rows, int cols, int threads,
                                    void* stream) {
  if (static_cast<long long>(n) * c * h * w == 0)
    return static_cast<int>(cudaSuccess);
  if (dtype != bigdl::kF32 && dtype != bigdl::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  PoolArgs a{n * c, h, w, oh, ow, kh, kw, sh, sw, ph, pw};
  // the fixed windows walk stride cells (a tile starts on one), the
  // generic one dx elements
  const bool fixed = variant(kh, kw, sh, sw) != 0;
  const int wb = fixed ? (h - 1 + ph) / sh - ph / sh + 1 : h;
  long long blocks = 0;
  if (!plan_grid(a, h, w, sw, planes, rows, cols, threads,
                 [&](int cols) {
                   return fixed ? (pw % sw + cols - 1) / sw + 1 : cols;
                 },
                 wb, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = bwd_smem(a, dtype == bigdl::kF32 ? 4 : 2);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return static_cast<int>(
        bwd_for<float>(dy, idx, dx, a, grid, threads, smem, s));
  return static_cast<int>(
      bwd_for<__nv_bfloat16>(dy, idx, dx, a, grid, threads, smem, s));
}
