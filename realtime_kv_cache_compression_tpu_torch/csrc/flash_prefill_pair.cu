// K1 mode (c), kFull: every query row of a pair sees every key of the block
// (`flash_pair_attention(causal=False)`). The kernel is the template in
// flash_prefill.cuh (both dtype routes); this source instantiates this
// mode only, so that nvcc builds it beside the others.

#include "flash_prefill.cuh"

namespace rkv {
namespace flash {

cudaError_t launch_full(const FlashParams& p, cudaStream_t stream) {
  return launch_mode<kFull>(p, stream);
}

cudaError_t instance_info_full(int index, FlashInstanceInfo* out) {
  return instance_info<kFull>(index, out);
}

}  // namespace flash
}  // namespace rkv
