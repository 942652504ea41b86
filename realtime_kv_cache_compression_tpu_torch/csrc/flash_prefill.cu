// K1: flash-attention prefill with the prompt-mass side channel: the C
// entries, and the causal modes (a), (b) and the diagonal pair. The kernel,
// its modes, its two dtype routes and its design are described in
// flash_prefill.cuh and flash_prefill_tc.cuh; modes (c) and (d) are
// instantiated in flash_prefill_pair.cu and flash_prefill_positioned.cu,
// so that nvcc builds the three in parallel; the non-default tiles and mode
// (a)'s variants in flash_prefill_tiles.cu and flash_prefill_variants.cu
// (one object per mode and per variant).

#include "flash_prefill.cuh"

using rkv::flash::FlashInstanceInfo;
using rkv::flash::kCausal;
using rkv::flash::kFull;
using rkv::flash::kPositioned;

namespace {

// Mode (a)'s variant `variant` (1-7), each in its own object.
cudaError_t launch_variant(const FlashParams& p, int variant,
                           cudaStream_t s) {
  switch (variant) {
    case 1: return rkv::flash::launch_variant<1>(p, s);
    case 2: return rkv::flash::launch_variant<2>(p, s);
    case 3: return rkv::flash::launch_variant<3>(p, s);
    case 4: return rkv::flash::launch_variant<4>(p, s);
    case 5: return rkv::flash::launch_variant<5>(p, s);
    case 6: return rkv::flash::launch_variant<6>(p, s);
    case 7: return rkv::flash::launch_variant<7>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches K1: the mode's default kernel, or with l->rows / l->keys set a
// non-default tile, or with l->variant set (mode (a) only, default tile)
// a variant.
extern "C" int flash_prefill_launch(const FlashLaunch* l, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FlashParams* p = &l->p;
  if (p->q_offset < 0) return cudaErrorInvalidValue;
  const bool tile = l->rows != 0 || l->keys != 0;
  if (l->variant != 0 && (tile || p->mode != kCausal))
    return cudaErrorInvalidValue;
  switch (p->mode) {
    case kCausal:
      // Only the causal modes index keys by position: there the chunk's
      // rows must lie inside the buffer.
      if (p->q_offset + p->S_q > p->S_k) return cudaErrorInvalidValue;
      if (l->variant != 0) return launch_variant(*p, l->variant, s);
      if (tile)
        return rkv::flash::launch_tile<kCausal>(*p, l->rows, l->keys, s);
      return rkv::flash::launch_mode<kCausal>(*p, s);
    case kFull:
      if (tile) return rkv::flash::launch_tile<kFull>(*p, l->rows, l->keys, s);
      return rkv::flash::launch_full(*p, s);
    case kPositioned:
      if (p->kpos == nullptr) return cudaErrorInvalidValue;
      if (tile)
        return rkv::flash::launch_tile<kPositioned>(*p, l->rows, l->keys, s);
      return rkv::flash::launch_positioned(*p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Registers, local memory and shared memory of instance `index` (0-9, see
// rkv::flash::instance_info) of `mode`.
extern "C" int flash_prefill_instance_info(int mode, int index,
                                           FlashInstanceInfo* out) {
  switch (mode) {
    case kCausal: return rkv::flash::instance_info<kCausal>(index, out);
    case kFull: return rkv::flash::instance_info_full(index, out);
    case kPositioned:
      return rkv::flash::instance_info_positioned(index, out);
    default: return cudaErrorInvalidValue;
  }
}

// The same for the non-default tile rows x keys of `mode` at head_dim d,
// and for mode (a)'s variant `variant` (1-7) at head_dim d in bf16 or
// (exp_bf16 alone) float32; cudaErrorInvalidValue for one not built.
extern "C" int flash_prefill_tile_info(int mode, int d, int rows, int keys,
                                       FlashInstanceInfo* out) {
  switch (mode) {
    case kCausal: return rkv::flash::tile_info<kCausal>(d, rows, keys, out);
    case kFull: return rkv::flash::tile_info<kFull>(d, rows, keys, out);
    case kPositioned:
      return rkv::flash::tile_info<kPositioned>(d, rows, keys, out);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_prefill_variant_info(int variant, int d, int bf16,
                                          FlashInstanceInfo* out) {
  switch (variant) {
    case 1: return rkv::flash::variant_info<1>(d, bf16, out);
    case 2: return rkv::flash::variant_info<2>(d, bf16, out);
    case 3: return rkv::flash::variant_info<3>(d, bf16, out);
    case 4: return rkv::flash::variant_info<4>(d, bf16, out);
    case 5: return rkv::flash::variant_info<5>(d, bf16, out);
    case 6: return rkv::flash::variant_info<6>(d, bf16, out);
    case 7: return rkv::flash::variant_info<7>(d, bf16, out);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
