// K5, K6 and K7: the fp16 wire codec, which keeps the top two bytes of each
// IEEE-754 float32 (truncation, not rounding: bfloat16's bits).
//
//   K5 compress:   u16 = bits(f32) >> 16
//   K6 decompress: f32 = bits(u32(u16) << 16)
//   K7 add:        decompress both, add in f32 with subnormal inputs and
//                  results flushed to signed zero, truncate again
//
// Replace bigdl_tpu/ops/fp16.py `_compress_kernel`, `_decompress_kernel` and
// `_add_kernel` (reached through `_elementwise_call`), which padded the flat
// vector to (rows, 128) blocks of 256 rows in VMEM.  Here a grid-stride loop
// over the flat vector with 64-bit indices: when every pointer lies on a
// 16-byte boundary, each step moves 8 elements as 16-byte vector loads and
// stores and a scalar tail takes the last n % 8; otherwise (a view at an
// odd offset) the scalar loop takes the whole vector.
//
// K7 adds with `add.rn.ftz.f32`: the TPU, and XLA on the CPU, flush
// subnormals in f32 arithmetic, so a subnormal input counts as signed zero
// and a subnormal sum becomes signed zero.  The flush is in the
// instruction, not in the shared build flags, which stay without -ftz for
// the other kernels.  A NaN sum is the card's canonical NaN (0x7FFF after
// truncation), where the CPU keeps the first NaN's payload.
//
// Bound on the H100: bytes.  Each kernel reads its inputs once and writes
// its output once: 6 bytes per element (K5: 4 in, 2 out; K6: 2 in, 4 out;
// K7: 2 + 2 in, 2 out) at 3.35 TB/s; the one add per element is nothing.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kVec = 8;                        // elements per vector step
constexpr unsigned int kMaxBlocks = 132 * 16;  // 16 blocks of 256 per SM

__device__ __forceinline__ float widen(uint32_t u16) {
  return __uint_as_float(u16 << 16);
}

__device__ __forceinline__ uint32_t add_ftz(uint32_t a16, uint32_t b16) {
  float s;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(s) : "f"(widen(a16)),
      "f"(widen(b16)));
  return __float_as_uint(s) >> 16;
}

// Two elements in one 32-bit word of u16 (the lower address in the lower
// half) from two f32.
__device__ __forceinline__ uint32_t compress2(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return add_ftz(a & 0xFFFFu, b & 0xFFFFu) |
         (add_ftz(a >> 16, b >> 16) << 16);
}

__global__ void compress_kernel(const float* __restrict__ x,
                                uint16_t* __restrict__ out, long long n,
                                long long vecs) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = tid; v < vecs; v += stride) {
    const float4 p = xv[2 * v];
    const float4 q = xv[2 * v + 1];
    ov[v] = make_uint4(compress2(p.x, p.y), compress2(p.z, p.w),
                       compress2(q.x, q.y), compress2(q.z, q.w));
  }
  for (long long i = kVec * vecs + tid; i < n; i += stride) {
    out[i] = static_cast<uint16_t>(__float_as_uint(x[i]) >> 16);
  }
}

__global__ void decompress_kernel(const uint16_t* __restrict__ u,
                                  float* __restrict__ out, long long n,
                                  long long vecs) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* uv = reinterpret_cast<const uint4*>(u);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long v = tid; v < vecs; v += stride) {
    const uint4 w = uv[v];
    ov[2 * v] = make_float4(widen(w.x & 0xFFFFu), __uint_as_float(
        w.x & 0xFFFF0000u), widen(w.y & 0xFFFFu),
        __uint_as_float(w.y & 0xFFFF0000u));
    ov[2 * v + 1] = make_float4(widen(w.z & 0xFFFFu), __uint_as_float(
        w.z & 0xFFFF0000u), widen(w.w & 0xFFFFu),
        __uint_as_float(w.w & 0xFFFF0000u));
  }
  for (long long i = kVec * vecs + tid; i < n; i += stride) {
    out[i] = widen(u[i]);
  }
}

__global__ void add_kernel(const uint16_t* __restrict__ a,
                           const uint16_t* __restrict__ b,
                           uint16_t* __restrict__ out, long long n,
                           long long vecs) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = tid; v < vecs; v += stride) {
    const uint4 p = av[v];
    const uint4 q = bv[v];
    ov[v] = make_uint4(add2(p.x, q.x), add2(p.y, q.y), add2(p.z, q.z),
                       add2(p.w, q.w));
  }
  for (long long i = kVec * vecs + tid; i < n; i += stride) {
    out[i] = static_cast<uint16_t>(add_ftz(a[i], b[i]));
  }
}

// Whole 8-element vector steps: n / kVec when every pointer lies on a
// 16-byte boundary, else 0 (the scalar loop takes the whole vector).
long long vector_steps(long long n, std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  }
  return n / kVec;
}

unsigned int blocks(long long vecs, long long n) {
  const long long scalars = n - kVec * vecs;
  const long long units = vecs > scalars ? vecs : scalars;
  const long long b = (units + bigdl::kThreads - 1) / bigdl::kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? (b < 1 ? 1 : b)
                                                  : kMaxBlocks);
}

}  // namespace

extern "C" int bigdl_fp16_compress(const void* x, void* out, long long n,
                                   void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long vecs = vector_steps(n, {x, out});
  compress_kernel<<<blocks(vecs, n), bigdl::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(out), n, vecs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bigdl_fp16_decompress(const void* u, void* out, long long n,
                                     void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long vecs = vector_steps(n, {u, out});
  decompress_kernel<<<blocks(vecs, n), bigdl::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(u), static_cast<float*>(out), n, vecs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bigdl_fp16_add(const void* a, const void* b, void* out,
                              long long n, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long vecs = vector_steps(n, {a, b, out});
  add_kernel<<<blocks(vecs, n), bigdl::kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<uint16_t*>(out), n, vecs);
  return static_cast<int>(cudaGetLastError());
}
