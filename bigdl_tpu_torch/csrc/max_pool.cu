// K1: NCHW max pool forward with an optional stored argmax code, and
// K3: its backward, routing dy through that code.
//
// K1 replaces bigdl_tpu/ops/pooling.py `_fwd_kernel` (reached through
// `_max_pool_fwd_impl`).  One thread per output element; neighbouring
// threads own neighbouring `ow`, so each window row is read with strided but
// coalesced loads and y/idx are stored coalesced.  The TPU kernel's one-hot
// selection matmuls and finite bf16-min padding existed only because Mosaic
// had no strided loads; here padding cells are simply skipped.
//
// Bound on the H100: bytes.  The pool reads x once and writes y (and idx)
// once; the window re-reads hit L1/L2, so the floor is
// (|x| + |y| + |idx|) / 3.35 TB/s.
//
// Tie rule: the window is scanned in row-major order and compared in f32
// with a strict `>`, so the FIRST maximal offset wins (Torch / XLA /
// `ops/pooling.py:123`).  The index is the window-offset code p*kw+q as
// uint8 (kh*kw <= 255, checked by the wrapper).
//
// K3 replaces bigdl_tpu/ops/pooling.py `_bwd_kernel` (reached through
// `_max_pool_pallas_bwd`), which scattered dy with one-hot MXU matmuls and
// dilations in VMEM.  Here it is a GATHER: one thread per element of dx
// visits the output windows that cover its cell and adds dy where the
// stored code names its own offset (p, q).  No atomics, so the result is
// deterministic; the sum is taken in f32 over q within each window row p,
// then over p in ascending order, and rounded once to dy's dtype, which is
// the order of ops/pooling.py `max_pool2d_bwd_plain`, so the two are
// bit-equal.  Padding cells and the ceil-mode tail are never written.
//
// Bound on the H100: bytes, (|dy| + |idx| + |dx|) / 3.35 TB/s; each thread
// reads at most kh*kw codes, re-reads of neighbouring windows hit L1/L2.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T>
__global__ void max_pool2d_fwd_kernel(const T* __restrict__ x,
                                      T* __restrict__ y,
                                      uint8_t* __restrict__ idx,
                                      long long total, int h, int w, int kh,
                                      int kw, int sh, int sw, int ph, int pw,
                                      int oh, int ow) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int ox = static_cast<int>(i % ow);
    const long long t = i / ow;
    const int oy = static_cast<int>(t % oh);
    const long long plane = t / oh;
    const T* xp = x + plane * h * w;
    const int y0 = oy * sh - ph;
    const int x0 = ox * sw - pw;
    float best = -INFINITY;
    int best_code = 0;
    bool have = false;
    for (int p = 0; p < kh; ++p) {
      const int iy = y0 + p;
      if (iy < 0 || iy >= h) continue;
      for (int q = 0; q < kw; ++q) {
        const int ix = x0 + q;
        if (ix < 0 || ix >= w) continue;
        const float v = bigdl::to_f32(xp[iy * w + ix]);
        if (!have || v > best) {
          best = v;
          best_code = p * kw + q;
          have = true;
        }
      }
    }
    y[i] = bigdl::from_f32<T>(best);
    if (idx != nullptr) idx[i] = static_cast<uint8_t>(best_code);
  }
}

template <typename T>
void launch(const void* x, void* y, void* idx, long long total, int h, int w,
            int kh, int kw, int sh, int sw, int ph, int pw, int oh, int ow,
            cudaStream_t stream) {
  max_pool2d_fwd_kernel<T><<<bigdl::blocks_for(total), bigdl::kThreads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<uint8_t*>(idx), total, h, w, kh, kw, sh, sw, ph, pw, oh,
      ow);
}

template <typename T>
__global__ void max_pool2d_bwd_kernel(const T* __restrict__ dy,
                                      const uint8_t* __restrict__ idx,
                                      T* __restrict__ dx, long long total,
                                      int h, int w, int kh, int kw, int sh,
                                      int sw, int ph, int pw, int oh,
                                      int ow) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int ix = static_cast<int>(i % w);
    const long long t = i / w;
    const int iy = static_cast<int>(t % h);
    const long long plane = t / h;
    const T* dyp = dy + plane * oh * ow;
    const uint8_t* ip = idx + plane * oh * ow;
    // position in the padded plane; window (oy, ox) covers it at offset
    // (p, q) when oy*sh + p == r and ox*sw + q == col
    const int r = iy + ph;
    const int col = ix + pw;
    float acc = 0.0f;
    for (int p = 0; p < kh && p <= r; ++p) {
      const int rr = r - p;
      if (rr % sh != 0 || rr / sh >= oh) continue;
      const int oy = rr / sh;
      float row = 0.0f;
      for (int q = 0; q < kw && q <= col; ++q) {
        const int cc = col - q;
        if (cc % sw != 0 || cc / sw >= ow) continue;
        const long long o = static_cast<long long>(oy) * ow + cc / sw;
        if (ip[o] == p * kw + q) row += bigdl::to_f32(dyp[o]);
      }
      acc += row;
    }
    dx[i] = bigdl::from_f32<T>(acc);
  }
}

template <typename T>
void launch_bwd(const void* dy, const void* idx, void* dx, long long total,
                int h, int w, int kh, int kw, int sh, int sw, int ph, int pw,
                int oh, int ow, cudaStream_t stream) {
  max_pool2d_bwd_kernel<T><<<bigdl::blocks_for(total), bigdl::kThreads, 0,
                             stream>>>(
      static_cast<const T*>(dy), static_cast<const uint8_t*>(idx),
      static_cast<T*>(dx), total, h, w, kh, kw, sh, sw, ph, pw, oh, ow);
}

}  // namespace

extern "C" int bigdl_max_pool2d_fwd(const void* x, void* y, void* idx,
                                    int dtype, int n, int c, int h, int w,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, int oh, int ow, void* stream) {
  const long long total = static_cast<long long>(n) * c * oh * ow;
  if (total == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) {
    launch<float>(x, y, idx, total, h, w, kh, kw, sh, sw, ph, pw, oh, ow, s);
  } else if (dtype == bigdl::kBF16) {
    launch<__nv_bfloat16>(x, y, idx, total, h, w, kh, kw, sh, sw, ph, pw, oh,
                          ow, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bigdl_max_pool2d_bwd(const void* dy, const void* idx, void* dx,
                                    int dtype, int n, int c, int h, int w,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, int oh, int ow, void* stream) {
  const long long total = static_cast<long long>(n) * c * h * w;
  if (total == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) {
    launch_bwd<float>(dy, idx, dx, total, h, w, kh, kw, sh, sw, ph, pw, oh,
                      ow, s);
  } else if (dtype == bigdl::kBF16) {
    launch_bwd<__nv_bfloat16>(dy, idx, dx, total, h, w, kh, kw, sh, sw, ph,
                              pw, oh, ow, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
