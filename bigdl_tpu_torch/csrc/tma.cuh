// Host side of the TMA copies (wgmma.cuh has the device side): the tensor
// maps that the flash backward and the bf16 quantized matmuls build per
// launch.  cuTensorMapEncodeTiled comes from
// libcuda.so.1, which the process has loaded already (no link against it).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

namespace bigdl {
namespace tma {

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, or null if libcuda.so.1 is not there
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The map of a rank-R tensor of elements of `type` (dims[0] contiguous;
// strides[i] the bytes between steps of dim i + 1) whose boxes of box[0] x
// ... elements land in shared memory as laid out by `swizzle`; elements
// past dims arrive as zeros.  False if the encoder refuses it.
template <int R>
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
              const cuuint32_t (&box)[R], CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  cuuint32_t unit[R];
  for (int i = 0; i < R; ++i) unit[i] = 1;
  return encode(map, type, R, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 tensor's map, its boxes swizzled by their row bytes (box[0] * 2:
// 128, 64 or 32, as wgmma.cuh's Tile lays them out)
template <int R>
bool bf16_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[R],
              const cuuint64_t (&strides)[R - 1],
              const cuuint32_t (&box)[R]) {
  return tile_map<R>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims,
                     strides, box,
                     box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : box[0] * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace tma
}  // namespace bigdl
