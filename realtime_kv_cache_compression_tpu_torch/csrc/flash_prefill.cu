// K1: flash-attention prefill with the prompt-mass side channel: the C
// entry, and the causal modes (a), (b) and the diagonal pair. The kernel,
// its modes and its design are described in flash_prefill.cuh; modes (c)
// and (d) are instantiated in flash_prefill_pair.cu and
// flash_prefill_positioned.cu, so that nvcc builds the three in parallel.

#include "flash_prefill.cuh"

using rkv::flash::kCausal;
using rkv::flash::kFull;
using rkv::flash::kPositioned;
using rkv::flash::launch_mode;

extern "C" int flash_prefill_launch(const FlashParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->q_offset < 0) return cudaErrorInvalidValue;
  if (p->dtype != rkv::kFloat32 && p->dtype != rkv::kBFloat16)
    return cudaErrorInvalidValue;
  switch (p->mode) {
    case kCausal:
      // Only the causal modes index keys by position: there the chunk's
      // rows must lie inside the buffer.
      if (p->q_offset + p->S_q > p->S_k) return cudaErrorInvalidValue;
      return p->dtype == rkv::kFloat32
                 ? launch_mode<float, kCausal>(*p, s)
                 : launch_mode<__nv_bfloat16, kCausal>(*p, s);
    case kFull:
      return rkv::flash::launch_full(*p, s);
    case kPositioned:
      if (p->kpos == nullptr) return cudaErrorInvalidValue;
      return rkv::flash::launch_positioned(*p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
