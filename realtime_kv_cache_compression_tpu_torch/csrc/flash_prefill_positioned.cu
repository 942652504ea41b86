// K1 mode (d), kPositioned: chunk queries over pool slots at arbitrary
// global positions (`flash_positioned_attention`). The kernel is the
// template in flash_prefill.cuh; this source instantiates this mode only,
// so that nvcc builds it beside the others.

#include "flash_prefill.cuh"

namespace rkv {
namespace flash {

cudaError_t launch_positioned(const FlashParams& p, cudaStream_t stream) {
  if (p.dtype == kFloat32) return launch_mode<float, kPositioned>(p, stream);
  if (p.dtype == kBFloat16) return launch_mode<__nv_bfloat16, kPositioned>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace rkv
