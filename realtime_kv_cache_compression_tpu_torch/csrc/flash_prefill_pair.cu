// K1 mode (c), kFull: every query row of a pair sees every key of the block
// (`flash_pair_attention(causal=False)`). The kernel is the template in
// flash_prefill.cuh; this source instantiates this mode only, so that nvcc
// builds it beside the others.

#include "flash_prefill.cuh"

namespace rkv {
namespace flash {

cudaError_t launch_full(const FlashParams& p, cudaStream_t stream) {
  if (p.dtype == kFloat32) return launch_mode<float, kFull>(p, stream);
  if (p.dtype == kBFloat16) return launch_mode<__nv_bfloat16, kFull>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace rkv
