// K2: cross-map LRN forward, y = x * scale^-beta with
//     scale = k + alpha/size * sum_{j=c-lo}^{c+hi} x_j^2,
// and K4: its backward,
//     q_j  = dy_j * x_j * scale_j^-beta / scale_j,
//     dx_c = dy_c * scale_c^-beta - 2 alpha/size beta x_c sum_{j=c-hi}^{c+lo} q_j.
//
// Replaces bigdl_tpu/ops/lrn.py `_fwd_kernel` (reached through
// `_lrn_pallas_fwd` -> `_grid_call`).  One thread per (image, pixel) walks
// the channels; neighbouring threads own neighbouring pixels, so every load
// of a channel plane and every store of y/scale is coalesced.  The window
// sum is recomputed per channel in f32 (`size` loads, all but one served by
// L1/L2), which keeps it order-stable and free of running-sum drift.
//
// Bound on the H100: bytes.  x is read once and y (and scale) written once:
// (|x| + |y| [+ |scale|]) / 3.35 TB/s; the 2*size+3 flops per element are
// far below the f32 rate.
//
// K4 replaces bigdl_tpu/ops/lrn.py `_bwd_kernel` (reached through
// `_lrn_pallas_bwd` -> `_grid_call`), which summed shifted copies of q over
// the reversed window [-hi, lo] in VMEM.  Here, as in K2, one thread per
// (image, pixel) walks the channels; for each channel it recomputes the
// window's q_j in f32 from x, scale and dy (all but one load of each served
// by L1/L2), so there is no running sum and no scratch buffer.
// Bound on the H100: bytes, (|x| + |scale| + |dy| + |dx|) / 3.35 TB/s.
//
// scale^-beta uses the `_neg_pow` forms of ops/lrn.py: beta = 0.75 as
// rsqrt(s) * sqrt(rsqrt(s)), beta = 0.5 as rsqrt(s), powf otherwise.
#include "common.cuh"

namespace {

enum PowMode : int { kBeta075 = 0, kBeta05 = 1, kPowf = 2 };

__device__ __forceinline__ float neg_pow(float s, float beta, int mode) {
  if (mode == kBeta075) {
    const float r = rsqrtf(s);
    return r * sqrtf(r);
  }
  if (mode == kBeta05) return rsqrtf(s);
  return powf(s, -beta);
}

template <typename T>
__global__ void lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               T* __restrict__ scale, long long total, int c,
                               long long hw, int lo, int hi,
                               float alpha_over_size, float beta, float k,
                               int mode) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long b = i / hw;
    const long long pix = i - b * hw;
    const long long base = b * c * hw + pix;
    for (int ch = 0; ch < c; ++ch) {
      const int j0 = ch - lo < 0 ? 0 : ch - lo;
      const int j1 = ch + hi > c - 1 ? c - 1 : ch + hi;
      float s = 0.0f;
      for (int j = j0; j <= j1; ++j) {
        const float v = bigdl::to_f32(x[base + j * hw]);
        s += v * v;
      }
      const float sc = k + alpha_over_size * s;
      const long long at = base + ch * hw;
      const float xv = bigdl::to_f32(x[at]);
      y[at] = bigdl::from_f32<T>(xv * neg_pow(sc, beta, mode));
      if (scale != nullptr) scale[at] = bigdl::from_f32<T>(sc);
    }
  }
}

template <typename T>
void launch(const void* x, void* y, void* scale, long long total, int c,
            long long hw, int lo, int hi, float aos, float beta, float k,
            int mode, cudaStream_t stream) {
  lrn_fwd_kernel<T><<<bigdl::blocks_for(total), bigdl::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scale),
      total, c, hw, lo, hi, aos, beta, k, mode);
}

template <typename T>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ scale,
                               const T* __restrict__ dy, T* __restrict__ dx,
                               long long total, int c, long long hw, int lo,
                               int hi, float coef, float beta, int mode) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long b = i / hw;
    const long long pix = i - b * hw;
    const long long base = b * c * hw + pix;
    for (int ch = 0; ch < c; ++ch) {
      const int j0 = ch - hi < 0 ? 0 : ch - hi;
      const int j1 = ch + lo > c - 1 ? c - 1 : ch + lo;
      float rsum = 0.0f;
      for (int j = j0; j <= j1; ++j) {
        const long long at = base + j * hw;
        const float s = bigdl::to_f32(scale[at]);
        rsum += bigdl::to_f32(dy[at]) * bigdl::to_f32(x[at]) *
                neg_pow(s, beta, mode) / s;
      }
      const long long at = base + ch * hw;
      const float pb = neg_pow(bigdl::to_f32(scale[at]), beta, mode);
      dx[at] = bigdl::from_f32<T>(bigdl::to_f32(dy[at]) * pb -
                                  coef * bigdl::to_f32(x[at]) * rsum);
    }
  }
}

template <typename T>
void launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
                long long total, int c, long long hw, int lo, int hi,
                float coef, float beta, int mode, cudaStream_t stream) {
  lrn_bwd_kernel<T><<<bigdl::blocks_for(total), bigdl::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx), total, c, hw, lo, hi,
      coef, beta, mode);
}

}  // namespace

extern "C" int bigdl_lrn_fwd(const void* x, void* y, void* scale, int dtype,
                             int n, int c, long long hw, int size,
                             float alpha_over_size, float beta, float k,
                             int mode, void* stream) {
  const long long total = static_cast<long long>(n) * hw;
  if (total == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const int lo = (size - 1) / 2;
  const int hi = size - 1 - lo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) {
    launch<float>(x, y, scale, total, c, hw, lo, hi, alpha_over_size, beta,
                  k, mode, s);
  } else if (dtype == bigdl::kBF16) {
    launch<__nv_bfloat16>(x, y, scale, total, c, hw, lo, hi, alpha_over_size,
                          beta, k, mode, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bigdl_lrn_bwd(const void* x, const void* scale, const void* dy,
                             void* dx, int dtype, int n, int c, long long hw,
                             int size, float alpha_over_size, float beta,
                             int mode, void* stream) {
  const long long total = static_cast<long long>(n) * hw;
  if (total == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const int lo = (size - 1) / 2;
  const int hi = size - 1 - lo;
  const float coef = 2.0f * alpha_over_size * beta;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) {
    launch_bwd<float>(x, scale, dy, dx, total, c, hw, lo, hi, coef, beta,
                      mode, s);
  } else if (dtype == bigdl::kBF16) {
    launch_bwd<__nv_bfloat16>(x, scale, dy, dx, total, c, hw, lo, hi, coef,
                              beta, mode, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
