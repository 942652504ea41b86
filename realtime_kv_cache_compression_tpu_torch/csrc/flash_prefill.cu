// K1: flash-attention prefill with the prompt-mass side channel: the C
// entries, and the causal modes (a), (b) and the diagonal pair. The kernel,
// its modes, its two dtype routes and its design are described in
// flash_prefill.cuh and flash_prefill_tc.cuh; modes (c) and (d) are
// instantiated in flash_prefill_pair.cu and flash_prefill_positioned.cu,
// so that nvcc builds the three in parallel.

#include "flash_prefill.cuh"

using rkv::flash::FlashInstanceInfo;
using rkv::flash::kCausal;
using rkv::flash::kFull;
using rkv::flash::kPositioned;

extern "C" int flash_prefill_launch(const FlashParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->q_offset < 0) return cudaErrorInvalidValue;
  switch (p->mode) {
    case kCausal:
      // Only the causal modes index keys by position: there the chunk's
      // rows must lie inside the buffer.
      if (p->q_offset + p->S_q > p->S_k) return cudaErrorInvalidValue;
      return rkv::flash::launch_mode<kCausal>(*p, s);
    case kFull:
      return rkv::flash::launch_full(*p, s);
    case kPositioned:
      if (p->kpos == nullptr) return cudaErrorInvalidValue;
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

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
