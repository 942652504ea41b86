// K1's tensor-core route: bf16 q/k/v on Hopper's wgmma, with Q, K and V
// staged by TMA. flash_prefill.cuh includes it and dispatches every bf16
// launch here (its header says which dtype takes which route, and why).
//
// Block: 288 threads, 128 query rows of one query head (head_dim 256: 160
// threads, 64 rows; see Layout). Warps 0-7 are two consumer warpgroups of
// 64 rows each; the last warp is the producer. The
// producer issues one TMA copy of the block's Q tile (bf16, once) and then
// walks the key tiles (kBN keys) through a ring of kStages = 2 K/V
// stages guarded by mbarriers ("full": the copy landed; "empty": all the
// consumer threads are done with the stage), so the next tile's copy
// overlaps this tile's products. It writes each stage's first key index
// beside the tiles, and -1 after the last tile, so the consumers need no
// tile count: in mode (d) the producer reads a tile's key positions first
// and skips a tile the block's last row cannot see before its copy is
// issued (block-uniform), and stages the positions for the consumers.
//
// Per tile a consumer warpgroup computes S = Q K^T with m64n{kBN}k16 wgmma
// (A and B from shared memory, K-major), scales the float32 scores by
// sm_scale * log2(e) after the product (q is never pre-scaled or rounded,
// so the prompt mass and lse keep float32 accuracy), applies the mask,
// runs the online softmax in registers (each thread holds two rows of the
// accumulator layout: rows g and g + 8 of its warp's 16, where g = lane / 4;
// row reductions are two __shfl_xor over the quad), and computes
// O += P V with m64nDk16 wgmma, P from registers (the accumulator layout
// converted pairwise to bf16x2: the RS form) and V from shared memory read
// transposed. l and the prompt mass sum the float32 p; only the P.V
// operand is rounded to bf16, as the TPU kernel rounds p to v's dtype.
// The prompt mass is summed per key only in a tile that straddles the
// row's prompt length: a tile wholly before it adds l's own increment, a
// tile after it nothing (mode (d) tests kpos < plen per key).
//
// Masks: the causal modes mask only a tile that crosses the diagonal of
// the warpgroup's rows (at q_offset) and stop at the block's last visible
// key; a warpgroup skips a tile that lies wholly in its future. Mode (c)
// masks the ragged S_k edge; mode (d) tests kpos <= q_offset + row per
// key. A row that has seen no key keeps m = -inf and exponentiates against
// 0, so exp2(-inf - -inf) never forms; a row that sees no key writes o = 0,
// pm = 0 and lse = -inf.
//
// Shared memory: each TMA box is one swizzle span wide (head_dim 16: 32 B,
// 32: 64 B, 64 and up: 128 B, as D / 64 boxes), and each wgmma descriptor
// names the same swizzle (csrc/wgmma.cuh): 8-row atoms of 256, 512 or
// 1024 B, 1024-byte aligned. d=128: Q 32 KB + 2 stages x (K + V) 128 KB;
// d=256: 32 KB + 128 KB.
// Grid (Hq, row tiles, B): the n_rep query heads of one kv head are
// neighbours, so their K/V tiles meet in L2, and the row tiles run in
// reverse, so the longest causal rows start first.
// Bound: operations (4 B Hq d S_q S_visible at 989 TFLOP/s bf16).
//
// Tiles per call (the wrappers' block_q / block_k): the rows (64: one
// consumer warpgroup; 128: two) and the keys per tile (64 or 128) are
// template parameters, and the shared-memory layout, the TMA boxes and the
// grid follow from them. Each mode's default tile (DefaultTile) is built
// at every head_dim; at head_dim 64 and 128 the other tiles of
// {64, 128} x {64, 128} are built too but mode (d)'s 128 x 128
// (`tile_built`), in sources of their own (flash_prefill_tiles.cu, one
// object per mode).
//
// Variants of mode (a) (JAX's fold_gqa, exp_bf16 and stats_via_mxu, a bit
// mask VAR, at the default tile; flash_prefill_variants.cu, one object
// per combination):
// - kFold: the block takes the n_rep query heads of one kv head, packed
//   into the rows: tile row r is position row0 + r / n_rep of query head
//   hk n_rep + r % n_rep, kRows / n_rep positions a block (rows past
//   n_rep (kRows / n_rep) hold no query and are never stored), so each
//   K/V tile is staged once for the group. The Q box spans (D, n_rep
//   heads, kRows / n_rep positions); grid (Hkv, position tiles, B).
// - kExpBf16: s - m is rounded to bf16 and exponentiated on bf16 pairs
//   (ex2.approx.ftz.bf16x2), so P is the value product's bf16 operand as
//   it is; l and the prompt mass sum those bf16 probabilities in float32.
// - kStatsMxu: l and the prompt mass come from one m64n8k16 wgmma per
//   k-step of P with a [kBN x 8] shared operand [ones | prompt indicator |
//   zeros] (row 1 written by the producer per tile), not from the quad's
//   row sums. A float32 P is split into a bf16 high and low part (two
//   products; the part left, p - hi - lo, is within 2^-16 |p|); with
//   kExpBf16 P is bf16 already and one product is exact.

#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace rkv {
namespace flash {
namespace tc {

constexpr int kStages = 2;  // K/V ring depth

// Mode (a)'s variants, a bit mask (see above); 0 is the default kernel.
enum Variant : int { kFold = 1, kExpBf16 = 2, kStatsMxu = 4 };

// Each mode's tile at head_dim D when the call names none.
template <int D, int MODE>
struct DefaultTile {
  static constexpr int kRows = D > 128 ? 64 : 128;
  static constexpr int kBN = MODE == kPositioned || D > 128 ? 64 : 128;
};

// Whether the build holds the bf16 tile of `rows` x `keys` of `mode` at
// head_dim `d`: the default tile everywhere, and every tile of 64 or 128
// rows by 64 or 128 keys at head_dim 64 and 128 but mode (d)'s 128 x 128,
// whose per-key position tests spill past the 168 registers a thread of a
// 288-thread block has (16 and 56 bytes at head_dim 64 and 128; the reason
// mode (d) takes 64-key tiles by default). Mirrored by `built_tiles` in
// ops/cuda/flash_prefill.py.
constexpr bool tile_built(int mode, int d, int rows, int keys) {
  return (d == 64 || d == 128)
             ? (rows == 64 || rows == 128) && (keys == 64 || keys == 128) &&
                   !(mode == kPositioned && rows == 128 && keys == 128)
             : rows == (d > 128 ? 64 : 128) &&
                   keys == (mode == kPositioned || d > 128 ? 64 : 128);
}

// Tile sizes and shared-memory layout of one instance (byte offsets from a
// 1024-aligned base): Q [kSubs][kRows][kBoxD], K and V
// [kStages][kSubs][kBN][kBoxD] (bf16, swizzled), key positions
// [kStages][kBN], each stage's first key, and the mbarriers (Q,
// full[kStages], empty[kStages]).
// - head_dim <= 128: kRows = 128 query rows, two consumer warpgroups and
//   the producer warp (288 threads, which ptxas caps at 168 registers);
//   kBN = 128 keys per tile, except 64 in mode (d), whose per-key position
//   tests would otherwise push the scores and positions past those
//   registers and spill.
// - head_dim 256: O alone is 128 float32 registers a thread, and Q plus
//   two stages of 128-key K and V tiles would pass the 227 KB of shared
//   memory. So one consumer warpgroup of kRows = 64 rows and the producer
//   warp (160 threads: up to 255 registers), 64-key tiles in every mode,
//   four 128-byte boxes per row: Q 32 KB + 2 x (K + V) 128 KB. S = Q K^T is
//   m64n64 over 16 k-steps, O += P V m64n256 (V MN-major as before).
// Those are the defaults (DefaultTile); a call may name another tile of
// ROWS x BN at head_dim 64 and 128. kStatsMxu adds per stage the [8 x kBN]
// bf16 stats operand, K-major in kBN / 64 boxes of 8 swizzled 128-byte
// rows (1 KB each), between V and the key positions.
template <int D, int MODE, int ROWS = DefaultTile<D, MODE>::kRows,
          int BN = DefaultTile<D, MODE>::kBN, int VAR = 0>
struct Layout {
  static constexpr int kRows = ROWS;  // query rows per block
  static constexpr int kConsumers = 2 * kRows;  // one warpgroup per 64 rows
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kBN = BN;
  static constexpr int kSwBytes = D >= 64 ? 128 : 2 * D;  // one box row
  static constexpr int kBoxD = kSwBytes / 2;
  static constexpr int kSubs = D / kBoxD;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // K or V, one stage
  static constexpr int kStatsBytes = VAR & kStatsMxu ? kBN / 64 * 1024 : 0;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kStatsOff = kVOff + kStages * kKVBytes;
  static constexpr int kPosOff = kStatsOff + kStages * kStatsBytes;
  static constexpr int kTileOff = kPosOff + kStages * kBN * 4;
  static constexpr int kBarOff = kTileOff + 16;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static_assert(kBoxD % 16 == 0 && D % kBoxD == 0 && D <= 256,
                "head_dim 16..256");
  static_assert(kKVBytes % 1024 == 0 && kQBytes % 1024 == 0, "alignment");
  static_assert(kAlloc <= 232448, "shared memory of one block");
  static_assert((ROWS == 64 || (ROWS == 128 && D <= 128)) &&
                    (BN == 64 || BN == 128),
                "tiles of 64 or 128 rows (64 at head_dim 256) by 64 or 128 "
                "keys");
  static_assert(VAR == 0 || MODE == kCausal, "the variants are mode (a)'s");
};

using namespace rkv::hopper;  // csrc/wgmma.cuh

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exp2 of two bf16 on the bf16 lanes (kExpBf16), and the two halves of a
// bf16 pair as float32.
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// threadIdx.x and blockIdx.x read anew (the compiler may not keep an
// earlier read live in a register for them).
__device__ __forceinline__ int tid_x() {
  int x;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(x));
  return x;
}

__device__ __forceinline__ int ctaid_x() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

// ---------------------------------------------------------------------------
// The kernel (flash_prefill_tc_kernel.cuh): flash_tc_kernel<D, MODE>, each
// mode's default tile and kernel, and flash_tc_tuned_kernel<D, MODE, ROWS,
// BN, VAR>, the other tiles and the variants
// ---------------------------------------------------------------------------

#define RKV_FLASH_TC_TUNED 0
#include "flash_prefill_tc_kernel.cuh"
#undef RKV_FLASH_TC_TUNED
#define RKV_FLASH_TC_TUNED 1
#include "flash_prefill_tc_kernel.cuh"
#undef RKV_FLASH_TC_TUNED

// The kernel of an instance: flash_tc_kernel for the default tile and
// kernel, flash_tc_tuned_kernel otherwise.
template <int D, int MODE, int ROWS, int BN, int VAR>
constexpr auto kernel_of() {
  if constexpr (ROWS == DefaultTile<D, MODE>::kRows &&
                BN == DefaultTile<D, MODE>::kBN && VAR == 0)
    return &flash_tc_kernel<D, MODE>;
  else
    return &flash_tc_tuned_kernel<D, MODE, ROWS, BN, VAR>;
}

// ---------------------------------------------------------------------------
// Host: tensor maps and the launch
// ---------------------------------------------------------------------------

// A bf16 [B][S][H][D] view with element strides (sb, ss, sh, 1) as a 4-d
// tensor map whose box is `rows` rows of `heads` heads (position-major in
// shared memory: row r is head r % heads), box_d elements wide. Rows past
// S read as zeros. The wrapper has checked TMA's rules (16-byte base and
// strides); the CUDA driver refuses anything else.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int D,
                              int H, int S, int B, long long sh, long long ss,
                              long long sb, int box_d, int rows,
                              CUtensorMapSwizzle swizzle, int heads = 1) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d),
                             static_cast<cuuint32_t>(heads),
                             static_cast<cuuint32_t>(rows), 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                           dims, strides, box, swizzle);
}

template <int D, int MODE, int ROWS = DefaultTile<D, MODE>::kRows,
          int BN = DefaultTile<D, MODE>::kBN, int VAR = 0>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  using L = Layout<D, MODE, ROWS, BN, VAR>;
  const CUtensorMapSwizzle swizzle =
      L::kSwBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kSwBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  // Folded, a block's Q box is kRows / n_rep positions of n_rep heads.
  constexpr bool kFoldQ = VAR & kFold;
  const int n_rep = p.Hq / p.Hkv;
  const int span = kFoldQ ? L::kRows / n_rep : L::kRows;
  if (span == 0) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_map(&tm_q, p.q, D, p.Hq, p.S_q, p.B, p.q_sh,
                               p.q_ss, p.q_sb, L::kBoxD, span, swizzle,
                               kFoldQ ? n_rep : 1);
  if (err == cudaSuccess)
    err = encode_map(&tm_k, p.k, D, p.Hkv, p.S_k, p.B, p.k_sh, p.k_ss,
                     p.k_sb, L::kBoxD, L::kBN, swizzle);
  if (err == cudaSuccess)
    err = encode_map(&tm_v, p.v, D, p.Hkv, p.S_k, p.B, p.v_sh, p.v_ss,
                     p.v_sb, L::kBoxD, L::kBN, swizzle);
  if (err != cudaSuccess) return err;
  // Above 48 KB of shared memory only after opting in, once per instance.
  constexpr auto kernel = kernel_of<D, MODE, ROWS, BN, VAR>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(kFoldQ ? p.Hkv : p.Hq, (p.S_q + span - 1) / span, p.B);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(p, tm_q, tm_k, tm_v);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace flash
}  // namespace rkv
