// K1 mode (a)'s variants (flash_prefill_with_prompt_mass's fold_gqa,
// exp_bf16 and stats_via_mxu; the bit mask tc::Variant) at the default
// tile of every head_dim. The kernel is the template in
// flash_prefill_tc.cuh; ops/cuda/_build.py compiles this source once per
// combination with -DRKV_FLASH_VARIANT set to 1-7, so that nvcc builds
// the seven in parallel beside the default instances. The float32 route
// takes exp_bf16 alone (the scalar kernel's EXP instance, in the object of
// that combination); the wrappers send it no other.

#include "flash_prefill.cuh"

#if RKV_FLASH_VARIANT == 2  // exp_bf16 alone: its float32 kernel too
namespace rkv {
namespace flash {
#define RKV_FLASH_SCALAR_KERNEL flash_prefill_exp_kernel
#define RKV_FLASH_SCALAR_EXP 1
#include "flash_prefill_scalar.cuh"
#undef RKV_FLASH_SCALAR_KERNEL
#undef RKV_FLASH_SCALAR_EXP
}  // namespace flash
}  // namespace rkv
#endif

#ifndef RKV_FLASH_VARIANT
#error "build with -DRKV_FLASH_VARIANT=<1-7>"
#endif

namespace rkv {
namespace flash {
namespace {

template <int VAR, int D>
cudaError_t launch_d(const FlashParams& p, cudaStream_t stream) {
  using Def = tc::DefaultTile<D, kCausal>;
  if (p.dtype == kBFloat16)
    return tc::launch<D, kCausal, Def::kRows, Def::kBN, VAR>(p, stream);
  if constexpr (VAR == tc::kExpBf16) {
    if (p.dtype == kFloat32) return launch_scalar<D, kCausal, true>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <int VAR, int D>
cudaError_t info_d(bool bf16, FlashInstanceInfo* out) {
  using Def = tc::DefaultTile<D, kCausal>;
  return fill_info<D, kCausal, Def::kRows, Def::kBN, VAR>(bf16, out);
}

}  // namespace

template <int VAR>
cudaError_t launch_variant(const FlashParams& p, cudaStream_t stream) {
  static_assert(VAR >= 1 && VAR <= 7, "a combination of the three flags");
  if (p.mode != kCausal) return cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return launch_d<VAR, 16>(p, stream);
    case 32: return launch_d<VAR, 32>(p, stream);
    case 64: return launch_d<VAR, 64>(p, stream);
    case 128: return launch_d<VAR, 128>(p, stream);
    case 256: return launch_d<VAR, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int VAR>
cudaError_t variant_info(int d, bool bf16, FlashInstanceInfo* out) {
  switch (d) {
    case 16: return info_d<VAR, 16>(bf16, out);
    case 32: return info_d<VAR, 32>(bf16, out);
    case 64: return info_d<VAR, 64>(bf16, out);
    case 128: return info_d<VAR, 128>(bf16, out);
    case 256: return info_d<VAR, 256>(bf16, out);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t launch_variant<RKV_FLASH_VARIANT>(const FlashParams&,
                                                       cudaStream_t);
template cudaError_t variant_info<RKV_FLASH_VARIANT>(int, bool,
                                                     FlashInstanceInfo*);

}  // namespace flash
}  // namespace rkv
