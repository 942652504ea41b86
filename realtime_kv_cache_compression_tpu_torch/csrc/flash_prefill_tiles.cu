// K1's non-default tensor-core tiles (the wrappers' block_q / block_k): at
// head_dim 64 and 128, every tile of 64 or 128 rows by 64 or 128 keys
// other than the mode's default, but mode (d)'s 128 x 128, which spills
// (tc::tile_built, tc::DefaultTile). The
// kernel is the template in flash_prefill_tc.cuh; ops/cuda/_build.py
// compiles this source once per mode with -DRKV_FLASH_TILE_MODE set to
// kCausal, kFull or kPositioned, so that nvcc builds the three in
// parallel beside the default instances. bf16 only: the float32 route has
// one layout.

#include "flash_prefill.cuh"

#ifndef RKV_FLASH_TILE_MODE
#error "build with -DRKV_FLASH_TILE_MODE=<mode>"
#endif

namespace rkv {
namespace flash {
namespace {

// Whether ROWS x BN at head_dim D of mode MODE is built here: built, and
// not the default, which flash_prefill*.cu build.
template <int MODE, int D, int ROWS, int BN>
constexpr bool here() {
  using Def = tc::DefaultTile<D, MODE>;
  return tc::tile_built(MODE, D, ROWS, BN) &&
         !(ROWS == Def::kRows && BN == Def::kBN);
}

template <int MODE, int D, int ROWS, int BN>
cudaError_t launch_if_here(const FlashParams& p, cudaStream_t stream) {
  if constexpr (here<MODE, D, ROWS, BN>())
    return tc::launch<D, MODE, ROWS, BN>(p, stream);
  return cudaErrorInvalidValue;
}

template <int MODE, int D, int ROWS, int BN>
cudaError_t info_if_here(FlashInstanceInfo* out) {
  if constexpr (here<MODE, D, ROWS, BN>())
    return fill_info<D, MODE, ROWS, BN>(true, out);
  return cudaErrorInvalidValue;
}

template <int MODE, int D>
cudaError_t launch_d(const FlashParams& p, int rows, int keys,
                     cudaStream_t stream) {
  if (rows == 64 && keys == 64)
    return launch_if_here<MODE, D, 64, 64>(p, stream);
  if (rows == 64 && keys == 128)
    return launch_if_here<MODE, D, 64, 128>(p, stream);
  if (rows == 128 && keys == 64)
    return launch_if_here<MODE, D, 128, 64>(p, stream);
  if (rows == 128 && keys == 128)
    return launch_if_here<MODE, D, 128, 128>(p, stream);
  return cudaErrorInvalidValue;
}

template <int MODE, int D>
cudaError_t info_d(int rows, int keys, FlashInstanceInfo* out) {
  if (rows == 64 && keys == 64) return info_if_here<MODE, D, 64, 64>(out);
  if (rows == 64 && keys == 128) return info_if_here<MODE, D, 64, 128>(out);
  if (rows == 128 && keys == 64) return info_if_here<MODE, D, 128, 64>(out);
  if (rows == 128 && keys == 128)
    return info_if_here<MODE, D, 128, 128>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

template <int MODE>
cudaError_t launch_tile(const FlashParams& p, int rows, int keys,
                        cudaStream_t stream) {
  if (p.dtype != kBFloat16) return cudaErrorInvalidValue;
  switch (p.D) {
    case 64: return launch_d<MODE, 64>(p, rows, keys, stream);
    case 128: return launch_d<MODE, 128>(p, rows, keys, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t tile_info(int d, int rows, int keys, FlashInstanceInfo* out) {
  switch (d) {
    case 64: return info_d<MODE, 64>(rows, keys, out);
    case 128: return info_d<MODE, 128>(rows, keys, out);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t launch_tile<RKV_FLASH_TILE_MODE>(const FlashParams&,
                                                      int, int,
                                                      cudaStream_t);
template cudaError_t tile_info<RKV_FLASH_TILE_MODE>(int, int, int,
                                                    FlashInstanceInfo*);

}  // namespace flash
}  // namespace rkv
