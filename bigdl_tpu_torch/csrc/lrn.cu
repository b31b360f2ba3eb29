// K2: cross-map LRN forward, y = x * scale^-beta with
//     scale = k + alpha/size * sum_{j=c-lo}^{c+hi} x_j^2,
// and K4: its backward,
//     q_j  = dy_j * x_j * scale_j^-beta / scale_j,
//     dx_c = dy_c * scale_c^-beta - 2 alpha/size beta x_c sum_{j=c-hi}^{c+lo} q_j.
//
// K2 replaces bigdl_tpu/ops/lrn.py:123 `_fwd_kernel` (reached through
// `_lrn_pallas_fwd` -> `_grid_call`), K4 bigdl_tpu/ops/lrn.py:133
// `_bwd_kernel` (reached through `_lrn_pallas_bwd`).  The TPU kernels held a
// (C, tile) block in VMEM and summed shifted copies of it, so each element
// was read once and q formed once per element.
//
// Bound on the H100: bytes.  K2 reads x once and writes y (and scale) once,
// (|x| + |y| [+ |scale|]) / 3.35 TB/s; K4 reads x, scale and dy once and
// writes dx once, (|x| + |scale| + |dy| + |dx|) / 3.35 TB/s.  The work per
// element (size FMAs, a window's adds, one rsqrt, one sqrt, one division)
// is far below the card's rates.
//
// What the first design lacked.  One thread owned one (image, pixel) and
// walked all C channels in series, one scalar load a channel behind a
// window loop of run-time length: 100 352 threads at batch 32 (37 % of the
// card's thread slots), each with one 2- or 4-byte load in flight, some
// 300 KB in flight where 3.35 TB/s needs a few MB.  K2 reloaded and
// re-squared the whole window for every channel, and K4 recomputed q for
// every channel of every window (five rsqrt, sqrt and divisions an element).
//
// Design.  A thread owns V adjacent pixels of one image and a chunk of
// `chunk` channels, so the grid is (image, channel chunk, pixel vector),
// pixel vectors fastest: neighbouring threads load neighbouring bytes of
// one channel plane, and the chunks of one image run side by side, so the
// size - 1 halo channels a chunk re-reads from its neighbours come from L2.
// ops/lrn.py `lrn_plan` picks V (16 bytes in K2 and 8 in K4, fewer or one
// pixel where a plane's length or a tensor's alignment does not allow
// them) and the chunk, so that the grid fills the card (at batch 8 too).
// A thread walks its chunk's input planes in channel order, kGroup planes
// a step, each step's loads (in K4 three a plane) sent a step ahead so
// that they are in flight while it computes, and keeps the window in
// registers:
// - K2 keeps the last size - 1 input vectors; each output sums its window's
//   squares from registers, so each element is read once per chunk.
// - K4 forms q once, as its channel enters the window, and keeps it with
//   the scale^-beta, x and dy of the channels it has yet to write, so an
//   element costs one rsqrt, one sqrt and one division.
// A channel outside [0, C) enters as zeros (K4: x = dy = 0, scale 1, so
// q = 0).  The window size is a compile-time parameter for size 5 (every
// LRN in the repo: Inception-v1, AlexNet), so the window's registers are
// named at compile time; any other size takes the generic instantiation,
// which reloads each output's window from L1 and recomputes its q.
//
// What bounds them now (bench_lrn.py ablate, Inception-v1's two LRNs at
// batch 32, H100): K2 runs at about 0.7 of its bytes bound and K4 at about
// 0.6.  K4's registers set its occupancy: its three windows in 16-byte
// bf16 vectors, or four planes a step, cost it a third; the halo below a
// chunk, its division and its square roots cost under a tenth each.
//
// Each window sum is taken in f32 in the first design's order (j ascending
// from c - lo in K2, from c - hi in K4, starting from 0), with the out-of-
// range channels' zeros added where it skipped them (x + 0 = x), so both
// kernels give the first design's bits.
//
// scale^-beta uses the `_neg_pow` forms of ops/lrn.py: beta = 0.75 as
// rsqrt(s) * sqrt(rsqrt(s)), beta = 0.5 as rsqrt(s), powf otherwise.
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

enum PowMode : int { kBeta075 = 0, kBeta05 = 1, kPowf = 2 };

// input planes a thread loads together, and outputs it writes, per step
// (ops/lrn.py LRN_GROUP)
constexpr int kGroup = 2;
// the window size with its own instantiation (ops/lrn.py LRN_FIXED_SIZES)
constexpr int kFixedSize = 5;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float neg_pow(float s, float beta, int mode) {
  if (mode == kBeta075) {
    const float r = rsqrtf(s);
    return r * sqrtf(r);
  }
  if (mode == kBeta05) return rsqrtf(s);
  return powf(s, -beta);
}

// The grid as lrn_plan describes it: `total` threads, one per (image,
// chunk, pixel vector), pixel vectors fastest.
struct Grid {
  long long total, hw, vecs;
  int c, chunks, chunk;
};

// A thread's work: its pixels' offset in plane 0 of its image (`base`) and
// its channels [c0, c0 + nout); false for a thread past the grid's end.
template <int V>
__device__ __forceinline__ bool place(const Grid& g, long long& base,
                                      int& c0, int& nout) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= g.total) return false;
  long long v, k, b;
  if (g.total <= INT_MAX) {
    const unsigned tt = static_cast<unsigned>(t);
    const unsigned r = tt / static_cast<unsigned>(g.vecs);
    v = tt - r * static_cast<unsigned>(g.vecs);
    k = r % static_cast<unsigned>(g.chunks);
    b = r / static_cast<unsigned>(g.chunks);
  } else {
    const long long r = t / g.vecs;
    v = t - r * g.vecs;
    k = r % g.chunks;
    b = r / g.chunks;
  }
  c0 = static_cast<int>(k) * g.chunk;
  nout = min(g.chunk, g.c - c0);
  base = b * g.c * g.hw + v * V;
  return true;
}

// V values of T as they lie in memory (4, 8 or 16 bytes, or one scalar),
// read as f32 lane by lane: a bf16 lane is the upper half of an f32.  x and
// dy stay in this form until their last use, which halves the registers a
// bf16 thread carries.
template <typename T, int V>
struct Raw {
  static constexpr int kWords = V * static_cast<int>(sizeof(T)) / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords == 4,
                "a vector is 4, 8 or 16 bytes");
  uint32_t w[kWords];
  __device__ __forceinline__ float operator[](int p) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[p]);
    return __uint_as_float(p % 2 ? w[p / 2] & 0xffff0000u : w[p / 2] << 16);
  }
};

template <typename T>
struct Raw<T, 1> {
  T v;
  __device__ __forceinline__ float operator[](int) const {
    return bigdl::to_f32(v);
  }
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* __restrict__ p) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.v = *p;
  } else if constexpr (Raw<T, V>::kWords == 1) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (Raw<T, V>::kWords == 2) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
  }
  return r;
}

// `fill` (0 or 1, exact in bf16) in every lane
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> filled(float fill) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.v = bigdl::from_f32<T>(fill);
  } else {
    uint32_t b = __float_as_uint(fill);
    if constexpr (sizeof(T) == 2) b = (b >> 16) | (b & 0xffff0000u);
#pragma unroll
    for (int i = 0; i < Raw<T, V>::kWords; ++i) r.w[i] = b;
  }
  return r;
}

// plane j of a thread's pixels, or `fill` where j is outside [0, c) or the
// load is not wanted
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> fetch(const T* __restrict__ a,
                                           long long base, int j, bool want,
                                           const Grid& g, float fill) {
  if (want && j >= 0 && j < g.c) return load<T, V>(a + base + j * g.hw);
  return filled<T, V>(fill);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = bigdl::from_f32<T>(f[0]);
  } else {
    constexpr int kWords = Raw<T, V>::kWords;
    uint32_t w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = sizeof(T) == 4 ? __float_as_uint(f[i])
                            : bigdl::pack_bf16x2(f[2 * i], f[2 * i + 1]);
    if constexpr (kWords == 1)
      *reinterpret_cast<unsigned int*>(p) = w[0];
    else if constexpr (kWords == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// K2 at a window size fixed at compile time.  w[i] holds input plane
// c0 - lo + o0 + i in f32.  A step takes the kGroup planes after w[S - 2]
// (loaded a step ahead), starts the loads of the next step's, then writes
// outputs o0 .. o0 + kGroup - 1 of the chunk, output o0 + u from w[u .. u +
// S - 1], and keeps w[kGroup ..] for the next step.  The first step's
// loads go out with those of the window below the chunk.
template <typename T, int V, int S>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_fwd_fixed(const T* __restrict__ x, T* __restrict__ y,
                  T* __restrict__ scale, Grid g, float alpha_over_size,
                  float beta, float k, int mode) {
  constexpr int lo = (S - 1) / 2;
  long long base;
  int c0, nout;
  if (!place<V>(g, base, c0, nout)) return;
  float w[S - 1 + kGroup][V];
  Raw<T, V> below[S - 1], next[kGroup];
#pragma unroll
  for (int i = 0; i < S - 1; ++i)
    below[i] = fetch<T, V>(x, base, c0 - lo + i, true, g, 0.0f);
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    next[u] = fetch<T, V>(x, base, c0 - lo + S - 1 + u, u < nout, g, 0.0f);
#pragma unroll
  for (int i = 0; i < S - 1; ++i)
#pragma unroll
    for (int p = 0; p < V; ++p) w[i][p] = below[i][p];
  for (int o0 = 0; o0 < nout; o0 += kGroup) {
    Raw<T, V> in[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      in[u] = next[u];
      next[u] = fetch<T, V>(x, base, c0 - lo + o0 + kGroup + S - 1 + u,
                            o0 + kGroup + u < nout, g, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
#pragma unroll
      for (int p = 0; p < V; ++p) w[S - 1 + u][p] = in[u][p];
      if (o0 + u < nout) {
        float yv[V], sv[V];
#pragma unroll
        for (int p = 0; p < V; ++p) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < S; ++i) s += w[u + i][p] * w[u + i][p];
          const float sc = k + alpha_over_size * s;
          yv[p] = w[u + lo][p] * neg_pow(sc, beta, mode);
          sv[p] = sc;
        }
        const long long at =
            base + static_cast<long long>(c0 + o0 + u) * g.hw;
        store<T, V>(y + at, yv);
        if (scale != nullptr) store<T, V>(scale + at, sv);
      }
    }
#pragma unroll
    for (int i = 0; i < S - 1; ++i)
#pragma unroll
      for (int p = 0; p < V; ++p) w[i][p] = w[kGroup + i][p];
  }
}

// K2 at any window size: each output reloads its window (from L1).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_fwd_generic(const T* __restrict__ x, T* __restrict__ y,
                    T* __restrict__ scale, Grid g, int size,
                    float alpha_over_size, float beta, float k, int mode) {
  const int lo = (size - 1) / 2, hi = size - 1 - lo;
  long long base;
  int c0, nout;
  if (!place<V>(g, base, c0, nout)) return;
  for (int ch = c0; ch < c0 + nout; ++ch) {
    const int j0 = max(0, ch - lo), j1 = min(g.c - 1, ch + hi);
    float s[V];
#pragma unroll
    for (int p = 0; p < V; ++p) s[p] = 0.0f;
    for (int j = j0; j <= j1; ++j) {
      const Raw<T, V> v = load<T, V>(x + base + j * g.hw);
#pragma unroll
      for (int p = 0; p < V; ++p) s[p] += v[p] * v[p];
    }
    const long long at = base + static_cast<long long>(ch) * g.hw;
    const Raw<T, V> v = load<T, V>(x + at);
    float yv[V];
#pragma unroll
    for (int p = 0; p < V; ++p) {
      s[p] = k + alpha_over_size * s[p];
      yv[p] = v[p] * neg_pow(s[p], beta, mode);
    }
    store<T, V>(y + at, yv);
    if (scale != nullptr) store<T, V>(scale + at, s);
  }
}

// K4 at a window size fixed at compile time.  Slot i holds input plane
// c0 - hi + o0 + i: its q and scale^-beta in f32, its x and dy as loaded.
// A step takes the kGroup planes after slot S - 2 (loaded a step ahead),
// starts the loads of the next step's, then, plane by plane, forms its q
// and writes output o0 + u, which sums q over slots u .. u + S - 1
// (channels c0 + o0 + u - hi .. + lo) and is centred on slot u + hi.
template <typename T, int V, int S>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_bwd_fixed(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx, Grid g,
                  float coef, float beta, int mode) {
  constexpr int hi = S - 1 - (S - 1) / 2;
  constexpr int kSlots = S - 1 + kGroup;
  long long base;
  int c0, nout;
  if (!place<V>(g, base, c0, nout)) return;
  Raw<T, V> xs[kSlots], ds[kSlots];
  float q[kSlots][V], pb[kSlots][V];
  // q = dy x scale^-beta / scale of slot i, once
  auto enter = [&](int i, const Raw<T, V>& sv) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const float s = sv[p];
      pb[i][p] = neg_pow(s, beta, mode);
      q[i][p] = ds[i][p] * xs[i][p] * pb[i][p] / s;
    }
  };
  Raw<T, V> below[S - 1], nx[kGroup], ns[kGroup], nd[kGroup];
  auto ahead = [&](int u, int j, bool want) {
    nx[u] = fetch<T, V>(x, base, j, want, g, 0.0f);
    ns[u] = fetch<T, V>(scale, base, j, want, g, 1.0f);
    nd[u] = fetch<T, V>(dy, base, j, want, g, 0.0f);
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    xs[i] = fetch<T, V>(x, base, c0 - hi + i, true, g, 0.0f);
    below[i] = fetch<T, V>(scale, base, c0 - hi + i, true, g, 1.0f);
    ds[i] = fetch<T, V>(dy, base, c0 - hi + i, true, g, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) ahead(u, c0 - hi + S - 1 + u, u < nout);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) enter(i, below[i]);
  for (int o0 = 0; o0 < nout; o0 += kGroup) {
    Raw<T, V> sv[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      xs[S - 1 + u] = nx[u];
      sv[u] = ns[u];
      ds[S - 1 + u] = nd[u];
      ahead(u, c0 - hi + o0 + kGroup + S - 1 + u, o0 + kGroup + u < nout);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      enter(S - 1 + u, sv[u]);
      if (o0 + u < nout) {
        float dv[V];
#pragma unroll
        for (int p = 0; p < V; ++p) {
          float rsum = 0.0f;
#pragma unroll
          for (int i = 0; i < S; ++i) rsum += q[u + i][p];
          dv[p] = ds[u + hi][p] * pb[u + hi][p] -
                  coef * xs[u + hi][p] * rsum;
        }
        store<T, V>(dx + base + static_cast<long long>(c0 + o0 + u) * g.hw,
                    dv);
      }
    }
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      xs[i] = xs[kGroup + i];
      ds[i] = ds[kGroup + i];
#pragma unroll
      for (int p = 0; p < V; ++p) {
        q[i][p] = q[kGroup + i][p];
        pb[i][p] = pb[kGroup + i][p];
      }
    }
  }
}

// K4 at any window size: each output recomputes its window's q (from L1).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    lrn_bwd_generic(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ dy, T* __restrict__ dx, Grid g,
                    int size, float coef, float beta, int mode) {
  const int lo = (size - 1) / 2, hi = size - 1 - lo;
  long long base;
  int c0, nout;
  if (!place<V>(g, base, c0, nout)) return;
  for (int ch = c0; ch < c0 + nout; ++ch) {
    const int j0 = max(0, ch - hi), j1 = min(g.c - 1, ch + lo);
    float rsum[V];
#pragma unroll
    for (int p = 0; p < V; ++p) rsum[p] = 0.0f;
    for (int j = j0; j <= j1; ++j) {
      const long long at = base + static_cast<long long>(j) * g.hw;
      const Raw<T, V> xv = load<T, V>(x + at), sv = load<T, V>(scale + at),
                      dv = load<T, V>(dy + at);
#pragma unroll
      for (int p = 0; p < V; ++p)
        rsum[p] += dv[p] * xv[p] * neg_pow(sv[p], beta, mode) / sv[p];
    }
    const long long at = base + static_cast<long long>(ch) * g.hw;
    const Raw<T, V> xv = load<T, V>(x + at), sv = load<T, V>(scale + at),
                    dv = load<T, V>(dy + at);
    float out[V];
#pragma unroll
    for (int p = 0; p < V; ++p)
      out[p] = dv[p] * neg_pow(sv[p], beta, mode) - coef * xv[p] * rsum[p];
    store<T, V>(dx + at, out);
  }
}

// The grid of a plan, or false where the library does not take it: a
// vector other than one element or 4, 8 or 16 bytes, a vector plan over a
// plane whose length is not a multiple of it or a tensor not aligned to
// it, an instantiation it does not have, a chunk or block size out of
// range.
bool plan_grid(int n, int c, long long hw, int size, int fixed, int vec,
               int chunk, int threads, int itemsize,
               std::initializer_list<const void*> tensors, Grid& g,
               long long& blocks) {
  if (size < 1 || (fixed != 0 && (fixed != kFixedSize || size != fixed)))
    return false;
  const int bytes = vec * itemsize;
  if (vec != 1 && bytes != 4 && bytes != 8 && bytes != 16) return false;
  if (vec != 1) {
    if (hw % vec != 0) return false;
    for (const void* p : tensors)
      if (p != nullptr && reinterpret_cast<uintptr_t>(p) % bytes != 0)
        return false;
  }
  if (chunk < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return false;
  const long long vecs = (hw + vec - 1) / vec;
  const long long chunks = (c + chunk - 1) / chunk;
  g = Grid{n * chunks * vecs, hw, vecs, c, static_cast<int>(chunks), chunk};
  blocks = (g.total + threads - 1) / threads;
  return blocks <= INT_MAX;
}

// launch(std::integral_constant<int, V>) for the pixels a thread of the
// plan, `vec`: one element, or 4, 8 or 16 bytes of them
template <typename T, typename F>
void with_vec(int vec, F&& launch) {
  constexpr int kSize = sizeof(T);
  if (vec == 1)
    launch(std::integral_constant<int, 1>{});
  else if (vec * kSize == 4)
    launch(std::integral_constant<int, 4 / kSize>{});
  else if (vec * kSize == 8)
    launch(std::integral_constant<int, 8 / kSize>{});
  else
    launch(std::integral_constant<int, 16 / kSize>{});
}

template <typename T>
cudaError_t fwd_for(const void* x, void* y, void* scale, const Grid& g,
                    long long blocks, int threads, int size, int fixed,
                    int vec, float aos, float beta, float k, int mode,
                    cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(blocks));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  T* st = static_cast<T*>(scale);
  with_vec<T>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if (fixed != 0)
      lrn_fwd_fixed<T, V, kFixedSize>
          <<<grid, threads, 0, s>>>(xt, yt, st, g, aos, beta, k, mode);
    else
      lrn_fwd_generic<T, V>
          <<<grid, threads, 0, s>>>(xt, yt, st, g, size, aos, beta, k, mode);
  });
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_for(const void* x, const void* scale, const void* dy,
                    void* dx, const Grid& g, long long blocks, int threads,
                    int size, int fixed, int vec, float coef, float beta,
                    int mode, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(blocks));
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* dt = static_cast<const T*>(dy);
  T* out = static_cast<T*>(dx);
  with_vec<T>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    if (fixed != 0)
      lrn_bwd_fixed<T, V, kFixedSize>
          <<<grid, threads, 0, s>>>(xt, st, dt, out, g, coef, beta, mode);
    else
      lrn_bwd_generic<T, V><<<grid, threads, 0, s>>>(xt, st, dt, out, g, size,
                                                     coef, beta, mode);
  });
  return cudaGetLastError();
}

}  // namespace

// x, y, scale (or null), dtype, n, c, hw, size, alpha/size, beta, k, the
// pow mode, then the plan: fixed (the window size of the instantiation, or
// 0 for the generic one), pixels a thread (1, or 4, 8 or 16 bytes' worth),
// channels a thread, threads a block
extern "C" int bigdl_lrn_fwd(const void* x, void* y, void* scale, int dtype,
                             int n, int c, long long hw, int size,
                             float alpha_over_size, float beta, float k,
                             int mode, int fixed, int vec, int chunk,
                             int threads, void* stream) {
  if (static_cast<long long>(n) * c * hw == 0)
    return static_cast<int>(cudaSuccess);
  if (dtype != bigdl::kF32 && dtype != bigdl::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g;
  long long blocks;
  if (!plan_grid(n, c, hw, size, fixed, vec, chunk, threads,
                 dtype == bigdl::kF32 ? 4 : 2, {x, y, scale}, g, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return static_cast<int>(fwd_for<float>(x, y, scale, g, blocks, threads,
                                           size, fixed, vec, alpha_over_size,
                                           beta, k, mode, s));
  return static_cast<int>(fwd_for<__nv_bfloat16>(
      x, y, scale, g, blocks, threads, size, fixed, vec, alpha_over_size,
      beta, k, mode, s));
}

// x, scale, dy, dx, dtype, n, c, hw, size, alpha/size, beta, the pow mode,
// then the plan as for the forward
extern "C" int bigdl_lrn_bwd(const void* x, const void* scale, const void* dy,
                             void* dx, int dtype, int n, int c, long long hw,
                             int size, float alpha_over_size, float beta,
                             int mode, int fixed, int vec, int chunk,
                             int threads, void* stream) {
  if (static_cast<long long>(n) * c * hw == 0)
    return static_cast<int>(cudaSuccess);
  if (dtype != bigdl::kF32 && dtype != bigdl::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g;
  long long blocks;
  if (!plan_grid(n, c, hw, size, fixed, vec, chunk, threads,
                 dtype == bigdl::kF32 ? 4 : 2, {x, scale, dy, dx}, g, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const float coef = 2.0f * alpha_over_size * beta;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32)
    return static_cast<int>(bwd_for<float>(x, scale, dy, dx, g, blocks,
                                           threads, size, fixed, vec, coef,
                                           beta, mode, s));
  return static_cast<int>(bwd_for<__nv_bfloat16>(x, scale, dy, dx, g, blocks,
                                                 threads, size, fixed, vec,
                                                 coef, beta, mode, s));
}
