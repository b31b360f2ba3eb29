// Hopper building blocks shared by the attention forward and flash backward
// kernels, the paged attention and the bf16 quantized matmuls: TMA tile
// copies into shared memory that complete on an mbarrier, 4- and 16-byte
// cp.async copies, the 128/64/32-byte swizzled tile layout that TMA writes and
// wgmma reads, its shared-memory matrix descriptors, and the bf16 wgmma
// products (f32 accumulators): both operands from shared memory at N
// 8-256, or A from registers at N 16-256; and the int8 products of K14
// (int32 accumulators, both operands from shared memory, N 64-256).
// Compiled for sm_90a only (wgmma does not exist on plain sm_90).
//
// Layouts.  A warpgroup is 4 consecutive warps (128 threads); warp w of it
// owns rows [16 w, 16 w + 16) of a 64-row product.  For lane (g = lane / 4,
// t = lane % 4), accumulator register i of an m64nN product holds
// D[16 w + g + 8 ((i / 2) % 2)][8 (i / 4) + 2 t + i % 2], N / 2 registers
// in all: the mma.sync m16n8 C fragment repeated over N / 8 column groups.
// A register A operand (m64 k16) is the mma.sync m16n8k16 A fragment, so an
// accumulator rounded to bf16 is the A operand of the next product over its
// columns: for columns [16 c, 16 c + 16) it is pack(d[8c], d[8c+1]),
// pack(d[8c+2], d[8c+3]), pack(d[8c+4], d[8c+5]), pack(d[8c+6], d[8c+7]).
//
// A tile of R rows by D bf16 columns sits in shared memory as D * 2 / W
// panels of R rows of W = min(128, 2 D) bytes, panel p holding columns
// [p W / 2, (p + 1) W / 2); each row's 16-byte chunks are XOR-swizzled
// with address bits 7.. (Swizzle<log2(W / 16), 4, 3>, what TMA's
// SWIZZLE_{W}B writes), so a tile must start on a 1024-byte boundary.  The
// same tile is read K-major (its rows are M or N, its columns the reduction)
// or MN-major (its rows are the reduction, its columns N) by the
// descriptor alone: no transposed copy is ever made.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace bigdl {
namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read, but must still be a mapped address)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 16 bytes global -> shared, asynchronously, bypassing L1; zeros when
// !valid (src is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}


__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// mbarriers and TMA: one thread arms a barrier with the bytes it expects and
// starts the tile copies; every thread waits for the barrier's phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one arrival on the barrier (its count set at init)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the barrier has completed the phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// the box at (c0, c1, c2) of a 3-D tensor map into shared memory at dst,
// counted against the barrier's expected bytes; the map is a
// __grid_constant__ kernel parameter
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

// the box at (c0, c1) of a 2-D tensor map, as tma_load_3d
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1) : "memory");
}

// make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma's operand reads, TMA) after the next barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from touching accumulators across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// accumulator register i of this thread in its warpgroup's m64 product: its
// row of the 64 and its column (see the header)
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// a 64 x 64 accumulator rounded to bf16 as the register A operand of a
// product over its 64 columns, 16 at a time (a[c] for columns 16c..)
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[c][j] = pack_bf16x2(x[8 * c + 2 * j], x[8 * c + 2 * j + 1]);
}

// The tile layout of D columns (see the header).
template <int D>
struct Tile {
  static constexpr int kW = 2 * D < 128 ? 2 * D : 128;  // bytes of a row
  static constexpr int kPanels = 2 * D / kW;
  // the descriptor's layout code: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kW == 128 ? 1 : kW == 64 ? 2 : 3;

  // rows [r0, r0 + R) of matrix z of a (z, n, D) tensor map into the tile
  // at dst, one TMA box of W / 2 columns by R rows a panel; rows past n
  // arrive as zeros.  Started by one thread; R D 2 bytes land on bar.
  template <int R>
  __device__ static __forceinline__ void tma(uint32_t dst, const void* map,
                                             uint32_t bar, int r0, int z) {
#pragma unroll
    for (int panel = 0; panel < kPanels; ++panel)
      tma_load_3d(dst + panel * R * kW, map, bar, panel * kW / 2, r0, z);
  }

  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
           (kLayout << 62);
  }

  // K-major operand: the R rows of a tile (M for A, N for B), reduction
  // columns [16 ks, 16 ks + 16): a 32-byte step inside the swizzled row,
  // panels R W apart past W bytes; 8-row groups 8 W apart (SBO)
  template <int R>
  __device__ static __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
    const int byte = ks * 32;
    return desc(tile + (byte / kW) * R * kW + byte % kW, 16, 8 * kW);
  }

  // MN-major B operand: reduction rows [16 ks, 16 ks + 16) of a tile of R
  // rows, all D columns as N: 8-row groups 8 W apart (SBO), W / 2-column
  // panels R W apart (LBO)
  template <int R>
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t tile, int ks) {
    return desc(tile + 16 * ks * kW, R * kW, 8 * kW);
  }
};

// d (64 x N) = A B (kFirst: d is only written, so no other instruction
// defines it inside the product's pipeline stage) or d += A B, over k16:
// A (64 x 16) and B (N x 16) from shared memory, both K-major.  N is 8,
// 16, 32, 64, 128 or 256; the accumulator is N / 2 registers a thread.
template <int N>
struct Ss;

// the accumulator's operands: BIGDL_ACCn(c) is c(d[0]), ..., c(d[n - 1])
#define BIGDL_G4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define BIGDL_ACC4(c) BIGDL_G4(c, 0)
#define BIGDL_ACC8(c) BIGDL_G4(c, 0), BIGDL_G4(c, 4)
#define BIGDL_ACC16(c) BIGDL_G4(c, 0), BIGDL_G4(c, 4), BIGDL_G4(c, 8), \
    BIGDL_G4(c, 12)
#define BIGDL_ACC32(c) BIGDL_G4(c, 0), BIGDL_G4(c, 4), BIGDL_G4(c, 8), \
    BIGDL_G4(c, 12), BIGDL_G4(c, 16), BIGDL_G4(c, 20), \
    BIGDL_G4(c, 24), BIGDL_G4(c, 28)
#define BIGDL_ACC64(c) BIGDL_G4(c, 0), BIGDL_G4(c, 4), BIGDL_G4(c, 8), \
    BIGDL_G4(c, 12), BIGDL_G4(c, 16), BIGDL_G4(c, 20), \
    BIGDL_G4(c, 24), BIGDL_G4(c, 28), BIGDL_G4(c, 32), \
    BIGDL_G4(c, 36), BIGDL_G4(c, 40), BIGDL_G4(c, 44), \
    BIGDL_G4(c, 48), BIGDL_G4(c, 52), BIGDL_G4(c, 56), \
    BIGDL_G4(c, 60)
#define BIGDL_ACC128(c) BIGDL_G4(c, 0), BIGDL_G4(c, 4), \
    BIGDL_G4(c, 8), BIGDL_G4(c, 12), BIGDL_G4(c, 16), \
    BIGDL_G4(c, 20), BIGDL_G4(c, 24), BIGDL_G4(c, 28), \
    BIGDL_G4(c, 32), BIGDL_G4(c, 36), BIGDL_G4(c, 40), \
    BIGDL_G4(c, 44), BIGDL_G4(c, 48), BIGDL_G4(c, 52), \
    BIGDL_G4(c, 56), BIGDL_G4(c, 60), BIGDL_G4(c, 64), \
    BIGDL_G4(c, 68), BIGDL_G4(c, 72), BIGDL_G4(c, 76), \
    BIGDL_G4(c, 80), BIGDL_G4(c, 84), BIGDL_G4(c, 88), \
    BIGDL_G4(c, 92), BIGDL_G4(c, 96), BIGDL_G4(c, 100), \
    BIGDL_G4(c, 104), BIGDL_G4(c, 108), BIGDL_G4(c, 112), \
    BIGDL_G4(c, 116), BIGDL_G4(c, 120), BIGDL_G4(c, 124)

#define BIGDL_SS(N, REGS, ACC, A, B, SCALE)                                 \
  template <>                                                               \
  struct Ss<N> {                                                            \
    template <bool kFirst>                                                  \
    __device__ static __forceinline__ void mma(float (&d)[N / 2],          \
                                               uint64_t a, uint64_t b) {   \
      if constexpr (kFirst)                                                 \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"     \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16"  \
                     ".bf16 {" REGS "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"   \
                     : ACC("=f") : "l"(a), "l"(b), "r"(0));                 \
      else                                                                  \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"     \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16"  \
                     ".bf16 {" REGS "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"   \
                     : ACC("+f") : "l"(a), "l"(b), "r"(1));                 \
    }                                                                       \
  };

BIGDL_SS(8, "%0, %1, %2, %3", BIGDL_ACC4, "%4", "%5", "%6")
BIGDL_SS(16, "%0, %1, %2, %3, %4, %5, %6, %7", BIGDL_ACC8, "%8", "%9", "%10")
BIGDL_SS(32,
         "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
         "%14, %15",
         BIGDL_ACC16, "%16", "%17", "%18")
BIGDL_SS(64,
         "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
         "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
         "%26, %27, %28, %29, %30, %31",
         BIGDL_ACC32, "%32", "%33", "%34")
BIGDL_SS(128,
         "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
         "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
         "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
         "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
         "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
         "%62, %63",
         BIGDL_ACC64, "%64", "%65", "%66")
#define BIGDL_REGS128                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "     \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "     \
  "%122, %123, %124, %125, %126, %127"
BIGDL_SS(256, BIGDL_REGS128, BIGDL_ACC128, "%128", "%129", "%130")
#undef BIGDL_SS

// d (64 x N, int32) = A B (kFirst: written only, as Ss) or d += A B over
// k32: A (64 x 32) and B (N x 32) int8 from shared memory, both K-major
// (8-bit wgmma takes no other layout).  A k32 step of int8 is 32 bytes of a
// row, as a k16 step of bf16, so Tile's descriptors serve both; the
// accumulator's layout is the f32 one (the header's).  N is 64, 128 or 256.
template <int N>
struct Ss8;

#define BIGDL_SS8(N, REGS, ACC, A, B, SCALE)                                \
  template <>                                                               \
  struct Ss8<N> {                                                           \
    template <bool kFirst>                                                  \
    __device__ static __forceinline__ void mma(int (&d)[N / 2], uint64_t a,\
                                               uint64_t b) {               \
      if constexpr (kFirst)                                                 \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"     \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8"    \
                     ".s8 {" REGS "}, " A ", " B ", p;\n}\n"                \
                     : ACC("=r") : "l"(a), "l"(b), "r"(0));                 \
      else                                                                  \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"     \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8"    \
                     ".s8 {" REGS "}, " A ", " B ", p;\n}\n"                \
                     : ACC("+r") : "l"(a), "l"(b), "r"(1));                 \
    }                                                                       \
  };

BIGDL_SS8(64,
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
          "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
          "%26, %27, %28, %29, %30, %31",
          BIGDL_ACC32, "%32", "%33", "%34")
BIGDL_SS8(128,
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
          "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
          "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
          "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
          "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
          "%62, %63",
          BIGDL_ACC64, "%64", "%65", "%66")
BIGDL_SS8(256, BIGDL_REGS128, BIGDL_ACC128, "%128", "%129", "%130")
#undef BIGDL_SS8

// d += A B over k16: A (64 x 16) in registers, B (16 x 256) from shared
// memory, MN-major
__device__ __forceinline__ void mma_rs(float (&d)[128],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" BIGDL_REGS128 "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : BIGDL_ACC128("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef BIGDL_REGS128
#undef BIGDL_ACC128
#undef BIGDL_ACC64
#undef BIGDL_ACC32
#undef BIGDL_ACC16
#undef BIGDL_ACC8
#undef BIGDL_ACC4
#undef BIGDL_G4

// d += A B over k16: A (64 x 16) in registers, B (16 x 16) from shared
// memory, MN-major
__device__ __forceinline__ void mma_rs(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B over k16: A (64 x 16) in registers, B (16 x 32) from shared
// memory, MN-major
__device__ __forceinline__ void mma_rs(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B over k16: A (64 x 16) in registers, B (16 x 64) from shared
// memory, MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B over k16: A (64 x 16) in registers, B (16 x 128) from shared
// memory, MN-major
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// s = the 64 rows of tile a times the 64 rows of tile b, transposed, over
// D (both K-major, tiles of D columns); the first k16 step only writes s
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a,
                                       uint32_t b) {
  using T = Tile<D>;
  Ss<64>::mma<true>(s, T::template kmajor<64>(a, 0),
                    T::template kmajor<64>(b, 0));
#pragma unroll
  for (int ks = 1; ks < D / 16; ++ks)
    Ss<64>::mma<false>(s, T::template kmajor<64>(a, ks),
                       T::template kmajor<64>(b, ks));
}

// acc += p v over a 64-key tile: p (a 64 x 64 accumulator) rounded to
// bf16 as the register A operand, the V tile read MN-major
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const float (&pr)[32],
                                           uint32_t vs) {
  uint32_t a[4][4];
  to_a(pr, a);
  mma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c)
    mma_rs(acc, a[c], Tile<D>::template mnmajor<64>(vs, c));
  mma_commit();
  mma_wait<0>();
  fence_regs(acc);
}

}  // namespace wg
}  // namespace bigdl
