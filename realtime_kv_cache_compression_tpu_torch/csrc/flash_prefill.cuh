// K1: flash-attention prefill with the prompt-mass side channel (the kernel
// template; flash_prefill*.cu instantiate it, one source per mode).
//
// Replaces the TPU kernel `_flash_kernel` in
// realtime_kv_cache_compression_tpu/ops/pallas/flash_prefill.py in all four
// of its modes, chosen by a template parameter:
//   (a)/(b) kCausal: S_q query rows of a prefill chunk at global positions
//       q_offset .. q_offset + S_q - 1 over an S_k-row position-ordered key
//       buffer (`flash_prefill_with_prompt_mass`: q_offset = 0, S_q = S_k;
//       `flash_chunk_attention_with_prompt_mass`; and the diagonal pair of
//       `flash_pair_attention(causal=True)`);
//   (c) kFull: every query row sees every key (`flash_pair_attention(
//       causal=False)`, the ring-attention off-diagonal pair);
//   (d) kPositioned: keys are pool slots at arbitrary global positions
//       `kpos` (invalid slots hold POS_SENTINEL = 2^30); key j is visible to
//       row i iff kpos[j] <= q_offset + i, and it is a prompt column iff
//       kpos[j] < plen (`flash_positioned_attention`).
//
// For every query row i of every query head it computes
//   o_i   = softmax(q_i K^T / sqrt(d)) V          over the visible keys
//   pm_i  = sum over visible prompt columns of softmax(.)_ij
//   lse_i = log sum_j exp(q_i k_j / sqrt(d))      (when `lse` is given)
// with the online softmax: a running max m, denominator l, accumulator acc,
// and one more running sum, the prompt mass, rescaled by the same
// exp(m_old - m_new) as l and divided by l at the end. The S x S score
// matrix never exists. A row that sees no key gets o = 0, pm = 0 and
// lse = -inf, so it vanishes in `merge_attention_partials`.
//
// Layout: q [B, S_q, Hq, D], k/v [B, S_k, Hkv, D], read through strides
// (unit stride on D), GQA by kv head = q head / (Hq / Hkv); kpos [B, S_k]
// int32 contiguous. Outputs: o with q's layout and dtype, pm and lse
// [B, Hq, S_q] float32 per head. In kCausal mode buffer keys past the
// chunk's rows hold later positions and causality hides them; the ragged
// S_q and S_k edges are masked here, not padded by the caller.
//
// Two routes, chosen by dtype in launch_mode (both hand-written kernels;
// a CUDA tensor launches the one its dtype names, or the call fails):
// - bf16 (every path users run): the tensor-core kernel of
//   flash_prefill_tc.cuh, wgmma tiles over TMA-staged Q/K/V, float32
//   accumulators and softmax statistics, P rounded to bf16 for the value
//   product as the TPU kernel rounds it. Bound: operations (bf16 at 989
//   TFLOP/s).
// - float32 (the parity phases that hold greedy tokens and 1e-4 logits
//   against the plain path): the scalar-FMA kernel below. Tensor cores
//   would run float32 as TF32 (10-bit significands), which cannot hold
//   those limits. One thread per query row, 128 rows per block (head_dim
//   256: four threads per row, 32 rows per block), grid (row tiles, Hq,
//   B); each thread keeps its scaled query row and output accumulator (its
//   share of them) in registers; blocks stage K/V tiles in shared memory,
//   which every thread reads by broadcast. Arithmetic is float32 scalar
//   FMA in base 2: sm_scale * log2(e) is folded into q so the exponentials
//   are exp2. Bound there: FMA issue and shared-memory reads.
// Mode (d) in both routes: the slots are unordered, so every tile is
// visited, except that a tile none of whose keys the block's last row can
// see (all POS_SENTINEL, say) is skipped before its K/V are staged;
// visibility is then tested per key. The scalar kernel skips a 16-key
// sub-tile with no visible key per row, so exp2(-inf - -inf) never arises.
//
// Per call (FlashLaunch rows / keys / variant, 0 for the defaults): a
// bf16 launch may name another tensor-core tile (flash_prefill_tiles.cu)
// or, in mode (a), a variant (flash_prefill_variants.cu); both are
// described in flash_prefill_tc.cuh. The float32 route has one layout:
// the wrappers validate a tile request and send none, and of the variants
// it takes only exp_bf16 (EXP below: s - m and p rounded to bf16 as the
// tensor-core variant rounds them), since fold_gqa and stats_via_mxu
// choose a layout that computes the same function.

#pragma once

#include <cstdint>

#include "common.cuh"

// Kernel arguments, passed by value; mirrored field for field by a ctypes
// Structure in ops/cuda/flash_prefill.py. Strides are in elements. lse may
// be null (not written); kpos is read in kPositioned mode only.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* pm;
  float* lse;
  const int* plen;
  const int* kpos;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, S_q, S_k, q_offset, Hq, Hkv, D, dtype, mode;
  float sm_scale;
};

// A launch: the kernel's arguments and what the host dispatch reads
// besides them, a tile (rows x keys) or a variant of mode (a) (0: the
// defaults). The kernels take FlashParams alone: a larger argument struct
// gives some default instances other registers. Mirrored by ctypes
// Structures in ops/cuda/flash_prefill.py.
struct FlashLaunch {
  FlashParams p;
  int rows, keys, variant;
};

namespace rkv {
namespace flash {

constexpr int kRows = 128;  // threads per block of the float32 route
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPosSentinel = 1 << 30;  // POS_SENTINEL of the wrappers

enum Mode : int { kCausal = 0, kFull = 1, kPositioned = 2 };

// The float32 route: kLanes threads per query row (one up to head_dim 128;
// four at 256, each holding 64 channels of q and of the accumulator, with
// the dot products summed over the four by shuffles, so that a thread's
// registers hold its share), kRows threads per block.
template <int D>
struct ScalarShape {
  static constexpr int kLanes = D > 128 ? 4 : 1;
  static constexpr int kRowsPerBlock = kRows / kLanes;
  static constexpr int kDL = D / kLanes;  // channels per thread
  // Keys per shared-memory tile: static K and V tiles stay below 48 KB.
  static constexpr int kBN = D <= 64 ? 64 : D <= 128 ? 32 : 16;
};

#define RKV_FLASH_SCALAR_KERNEL flash_prefill_kernel
#define RKV_FLASH_SCALAR_EXP 0
#include "flash_prefill_scalar.cuh"
#undef RKV_FLASH_SCALAR_KERNEL
#undef RKV_FLASH_SCALAR_EXP

// exp_bf16's float32 kernel, defined where flash_prefill_variants.cu
// includes flash_prefill_scalar.cuh again.
template <int D, int MODE>
__global__ void __launch_bounds__(kRows)
flash_prefill_exp_kernel(const FlashParams p);

// The float32 kernel of exp_bf16 (EXP) or of the default.
template <int D, int MODE, bool EXP>
constexpr auto scalar_kernel_of() {
  if constexpr (EXP)
    return &flash_prefill_exp_kernel<D, MODE>;
  else
    return &flash_prefill_kernel<D, MODE>;
}

}  // namespace flash
}  // namespace rkv

#include "flash_prefill_tc.cuh"

namespace rkv {
namespace flash {

// Launches mode MODE at the route of p.dtype and its head_dim; one source
// per mode instantiates it (flash_prefill*.cu), so nvcc builds the modes
// in parallel.
template <int D, int MODE, bool EXP = false>
cudaError_t launch_scalar(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.S_q + ScalarShape<D>::kRowsPerBlock - 1) /
                      ScalarShape<D>::kRowsPerBlock,
                  p.Hq, p.B);
  scalar_kernel_of<D, MODE, EXP>()<<<grid, kRows, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const FlashParams& p, cudaStream_t stream) {
  if (p.dtype == kBFloat16) {
    switch (p.D) {
      case 16: return tc::launch<16, MODE>(p, stream);
      case 32: return tc::launch<32, MODE>(p, stream);
      case 64: return tc::launch<64, MODE>(p, stream);
      case 128: return tc::launch<128, MODE>(p, stream);
      case 256: return tc::launch<256, MODE>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (p.dtype != kFloat32) return cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return launch_scalar<16, MODE>(p, stream);
    case 32: return launch_scalar<32, MODE>(p, stream);
    case 64: return launch_scalar<64, MODE>(p, stream);
    case 128: return launch_scalar<128, MODE>(p, stream);
    case 256: return launch_scalar<256, MODE>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// What the build made of one instance: its route, head_dim, tile (rows
// and keys per block; the float32 route's rows per block and keys per
// shared tile) and variant, registers, local memory and shared memory.
// Index 0-4 of mode MODE's defaults are the float32 route at head_dim 16,
// 32, 64, 128, 256, index 5-9 the bf16 tensor-core route. Mirrored by a
// ctypes Structure in ops/cuda/flash_prefill.py.
struct FlashInstanceInfo {
  int bf16, head_dim, regs, local_bytes, static_smem, dynamic_smem, threads,
      rows, keys, variant;
};

constexpr int kInstanceDims = 5;

template <int D, int MODE, int ROWS = tc::DefaultTile<D, MODE>::kRows,
          int BN = tc::DefaultTile<D, MODE>::kBN, int VAR = 0>
cudaError_t fill_info(bool bf16, FlashInstanceInfo* out) {
  using L = tc::Layout<D, MODE, ROWS, BN, VAR>;
  using Def = tc::DefaultTile<D, MODE>;
  // A float32 instance exists for the default tile, plain or exp_bf16.
  constexpr bool kScalar = ROWS == Def::kRows && BN == Def::kBN &&
                           (VAR == 0 || VAR == tc::kExpBf16);
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (bf16)
    err = cudaFuncGetAttributes(&a, tc::kernel_of<D, MODE, ROWS, BN, VAR>());
  else if constexpr (kScalar)
    err = cudaFuncGetAttributes(
        &a, scalar_kernel_of<D, MODE, VAR == tc::kExpBf16>());
  if (err != cudaSuccess) return err;
  out->bf16 = bf16;
  out->head_dim = D;
  out->regs = a.numRegs;
  out->local_bytes = static_cast<int>(a.localSizeBytes);
  out->static_smem = static_cast<int>(a.sharedSizeBytes);
  out->dynamic_smem = bf16 ? L::kAlloc : 0;
  out->threads = bf16 ? L::kThreads : kRows;
  out->rows = bf16 ? ROWS : ScalarShape<D>::kRowsPerBlock;
  out->keys = bf16 ? BN : ScalarShape<D>::kBN;
  out->variant = bf16 ? VAR : VAR & tc::kExpBf16;
  return cudaSuccess;
}

template <int MODE>
cudaError_t instance_info(int index, FlashInstanceInfo* out) {
  if (index < 0 || index >= 2 * kInstanceDims) return cudaErrorInvalidValue;
  const bool bf16 = index >= kInstanceDims;
  switch (index % kInstanceDims) {
    case 0: return fill_info<16, MODE>(bf16, out);
    case 1: return fill_info<32, MODE>(bf16, out);
    case 2: return fill_info<64, MODE>(bf16, out);
    case 3: return fill_info<128, MODE>(bf16, out);
    case 4: return fill_info<256, MODE>(bf16, out);
    default: return cudaErrorInvalidValue;
  }
}

// Defined in flash_prefill_pair.cu and flash_prefill_positioned.cu.
cudaError_t launch_full(const FlashParams& p, cudaStream_t stream);
cudaError_t launch_positioned(const FlashParams& p, cudaStream_t stream);
cudaError_t instance_info_full(int index, FlashInstanceInfo* out);
cudaError_t instance_info_positioned(int index, FlashInstanceInfo* out);

// The non-default tiles of mode MODE (bf16 only; rows x keys), in the
// object that flash_prefill_tiles.cu builds for MODE; and mode (a)'s
// variant VAR (1-7) at the default tile, in the object that
// flash_prefill_variants.cu builds for VAR. Each returns
// cudaErrorInvalidValue for an instance the build lacks.
template <int MODE>
cudaError_t launch_tile(const FlashParams& p, int rows, int keys,
                        cudaStream_t stream);
template <int MODE>
cudaError_t tile_info(int d, int rows, int keys, FlashInstanceInfo* out);
template <int VAR>
cudaError_t launch_variant(const FlashParams& p, cudaStream_t stream);
template <int VAR>
cudaError_t variant_info(int d, bool bf16, FlashInstanceInfo* out);

}  // namespace flash
}  // namespace rkv
