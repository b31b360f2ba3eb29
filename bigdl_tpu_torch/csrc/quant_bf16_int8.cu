// The bf16 K13 kernel for int8 weights at every N tile width
// (quant_bf16.cuh), in a file of its own so that the three weight kinds
// compile in parallel.
#include "quant_bf16.cuh"

namespace bigdl {
namespace quant {

template int launch_bf16<Int8>(Bf16Args, cudaStream_t);

}  // namespace quant
}  // namespace bigdl
