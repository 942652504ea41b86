// K1 mode (d), kPositioned: chunk queries over pool slots at arbitrary
// global positions (`flash_positioned_attention`). The kernel is the
// template in flash_prefill.cuh (both dtype routes); this source
// instantiates this mode only, so that nvcc builds it beside the others.

#include "flash_prefill.cuh"

namespace rkv {
namespace flash {

cudaError_t launch_positioned(const FlashParams& p, cudaStream_t stream) {
  return launch_mode<kPositioned>(p, stream);
}

cudaError_t instance_info_positioned(int index, FlashInstanceInfo* out) {
  return instance_info<kPositioned>(index, out);
}

}  // namespace flash
}  // namespace rkv
