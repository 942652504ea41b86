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

#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace rkv {
namespace flash {
namespace tc {

constexpr int kStages = 2;  // K/V ring depth

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
template <int D, int MODE>
struct Layout {
  static constexpr int kRows = D > 128 ? 64 : 128;  // query rows per block
  static constexpr int kConsumers = 2 * kRows;  // one warpgroup per 64 rows
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kBN = MODE == kPositioned || D > 128 ? 64 : 128;
  static constexpr int kSwBytes = D >= 64 ? 128 : 2 * D;  // one box row
  static constexpr int kBoxD = kSwBytes / 2;
  static constexpr int kSubs = D / kBoxD;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // K or V, one stage
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kPosOff = kVOff + kStages * kKVBytes;
  static constexpr int kTileOff = kPosOff + kStages * kBN * 4;
  static constexpr int kBarOff = kTileOff + 16;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static_assert(kBoxD % 16 == 0 && D % kBoxD == 0 && D <= 256,
                "head_dim 16..256");
  static_assert(kKVBytes % 1024 == 0 && kQBytes % 1024 == 0, "alignment");
  static_assert(kAlloc <= 232448, "shared memory of one block");
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

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D, int MODE>
__global__ void __launch_bounds__(Layout<D, MODE>::kThreads, 1)
flash_tc_kernel(const FlashParams p, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  using L = Layout<D, MODE>;
  constexpr int kBN = L::kBN, kRows = L::kRows;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle repeats every 1024 bytes and TMA and wgmma both read it
  // from the address bits, so every tile starts on a 1024-byte boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  int* s_pos = reinterpret_cast<int*>(smem + L::kPosOff);
  int* s_tile = reinterpret_cast<int*>(smem + L::kTileOff);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, hq = blockIdx.x;
  const int hk = hq / (p.Hq / p.Hkv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == L::kConsumers / 32) {
    // ---- producer warp ---------------------------------------------------
    const int rows_live = min(row0 + kRows, p.S_q);  // local rows < S_q
    const int q_last = p.q_offset + rows_live - 1;   // last live position
    const int kv_end =
        MODE == kCausal ? min(p.S_k, p.q_offset + rows_live) : p.S_k;
    const int n_tiles = (kv_end + kBN - 1) / kBN;
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kSubs; ++c)
        tma_load_4d(smem + c * kRows * L::kSwBytes, &tm_q, bar_q,
                    c * L::kBoxD, hq, row0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBN;
      int pos[MODE == kPositioned ? kBN / 32 : 1];
      if constexpr (MODE == kPositioned) {
        bool seen = false;
#pragma unroll
        for (int i = 0; i < kBN / 32; ++i) {
          const int key = k0 + lane + 32 * i;
          pos[i] = key < p.S_k
                       ? p.kpos[static_cast<long long>(b) * p.S_k + key]
                       : kPosSentinel;
          seen |= pos[i] <= q_last;
        }
        if (!__any_sync(0xffffffffu, seen)) continue;  // no copy issued
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if constexpr (MODE == kPositioned) {
#pragma unroll
        for (int i = 0; i < kBN / 32; ++i)
          s_pos[stage * kBN + lane + 32 * i] = pos[i];
        __syncwarp();
      }
      if (lane == 0) {
        s_tile[stage] = k0;
        mbar_expect_tx(&full[stage], 2 * L::kKVBytes);
        uint8_t* k_dst = smem + L::kKOff + stage * L::kKVBytes;
        uint8_t* v_dst = smem + L::kVOff + stage * L::kKVBytes;
#pragma unroll
        for (int c = 0; c < L::kSubs; ++c) {
          tma_load_4d(k_dst + c * kBN * L::kSwBytes, &tm_k, &full[stage],
                      c * L::kBoxD, hk, k0, b);
          tma_load_4d(v_dst + c * kBN * L::kSwBytes, &tm_v, &full[stage],
                      c * L::kBoxD, hk, k0, b);
        }
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // End of the key stream: the consumers stop at the stage marked -1.
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      s_tile[stage] = -1;
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // ---- consumer warpgroups ------------------------------------------------
  const int wg = warp / 4;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = row0 + wg * 64 + (warp % 4) * 16 + g;  // local rows r0, r1
  const int r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  const int wg_first = p.q_offset + row0 + wg * 64;  // its first position
  const int plen = p.plen[b];
  const float scale = p.sm_scale * kLog2e;
  const uint32_t q_base = s_base + wg * 64 * L::kSwBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f, pm0 = 0.f, pm1 = 0.f;  // partial over the quad

  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int k0 = s_tile[stage];
    if (k0 < 0) break;
    // Causal: a tile wholly in this warpgroup's future adds nothing.
    if (MODE != kCausal || k0 <= wg_first + 63) {
      const uint32_t k_base = s_base + L::kKOff + stage * L::kKVBytes;
      const uint32_t v_base = s_base + L::kVOff + stage * L::kKVBytes;
      const int* pos = s_pos + stage * kBN;

      float s[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBN, 0>(s, kmajor_desc<L::kSwBytes>(q_base, kRows, kk),
                         kmajor_desc<L::kSwBytes>(k_base, kBN, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Element i of s: row r0 (i % 4 < 2) or r1, key column
      // 8 (i / 4) + 2 t4 + i % 2 of the tile.
      uint32_t prompt_bits = 0;  // mode (d): bit 2 (i / 4) + i % 2
      if constexpr (MODE == kPositioned) {
        // Each thread reads its 32 key positions once, as pairs, and keeps
        // only their prompt bits: the positions need no registers later.
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int2 kp = *reinterpret_cast<const int2*>(pos + 8 * j + 2 * t4);
          if (kp.x > qp0) s[4 * j] = -INFINITY;
          if (kp.y > qp0) s[4 * j + 1] = -INFINITY;
          if (kp.x > qp1) s[4 * j + 2] = -INFINITY;
          if (kp.y > qp1) s[4 * j + 3] = -INFINITY;
          prompt_bits |= static_cast<uint32_t>(kp.x < plen) << (2 * j);
          prompt_bits |= static_cast<uint32_t>(kp.y < plen) << (2 * j + 1);
        }
      } else if (MODE == kCausal ? k0 + kBN - 1 > wg_first
                                 : k0 + kBN > p.S_k) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * t4 + (i % 2);
          const bool visible = MODE == kCausal
                                   ? key <= (i % 4 < 2 ? qp0 : qp1)
                                   : key < p.S_k;
          if (!visible) s[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        if (i % 4 < 2) mx0 = fmaxf(mx0, s[i]);
        else mx1 = fmaxf(mx1, s[i]);
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale);
      // A row that has seen no key yet keeps m = -inf: its p and alpha are
      // taken against 0, never as exp2(-inf - -inf).
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const float pv = exp2f(fmaf(s[i], scale, i % 4 < 2 ? -mu0 : -mu1));
        s[i] = pv;
        if (i % 4 < 2) ls0 += pv;
        else ls1 += pv;
      }
      // Prompt mass: l's own increment where the tile lies wholly before
      // the prompt length, a masked sum only where it straddles it.
      float ps0 = 0.f, ps1 = 0.f;
      if (MODE != kPositioned && k0 + kBN <= plen) {
        ps0 = ls0;
        ps1 = ls1;
      } else if (MODE == kPositioned || k0 < plen) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const bool prompt =
              MODE == kPositioned
                  ? (prompt_bits >> (2 * (i / 4) + i % 2)) & 1u
                  : k0 + 8 * (i / 4) + 2 * t4 + (i % 2) < plen;
          if (prompt) {
            if (i % 4 < 2) ps0 += s[i];
            else ps1 += s[i];
          }
        }
      }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
      pm0 = pm0 * a0 + ps0;
      pm1 = pm1 * a1 + ps1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= i % 4 < 2 ? a0 : a1;

      // P as the A operand: k-step kk takes s[8 kk .. 8 kk + 7] pairwise.
      uint32_t pr[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pr[kk][j] = pack_bf16x2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      fence_regs(pr);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs_tb<D>(o, pr[kk], mnmajor_desc<L::kSwBytes>(v_base, kBN, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pr);
    }
    mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  pm0 = quad_sum(pm0);
  pm1 = quad_sum(pm1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                       static_cast<long long>(b) * p.o_sb +
                       static_cast<long long>(hq) * p.o_sh + 2 * t4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < p.S_q)
      *reinterpret_cast<uint32_t*>(out + r0 * p.o_ss + 8 * j) =
          pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < p.S_q)
      *reinterpret_cast<uint32_t*>(out + r1 * p.o_ss + 8 * j) =
          pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (t4 == 0) {
    const long long stat = (static_cast<long long>(b) * p.Hq + hq) * p.S_q;
    // m is base 2; the lse is natural, -inf for a row that saw no key.
    if (r0 < p.S_q) {
      p.pm[stat + r0] = pm0 * inv0;
      if (p.lse != nullptr)
        p.lse[stat + r0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    }
    if (r1 < p.S_q) {
      p.pm[stat + r1] = pm1 * inv1;
      if (p.lse != nullptr)
        p.lse[stat + r1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and the launch
// ---------------------------------------------------------------------------

// A bf16 [B][S][H][D] view with element strides (sb, ss, sh, 1) as a 4-d
// tensor map whose box is `rows` rows of one head, box_d elements wide.
// Rows past S read as zeros. The wrapper has checked TMA's rules (16-byte
// base and strides); the driver refuses anything else.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int D,
                              int H, int S, int B, long long sh, long long ss,
                              long long sb, int box_d, int rows,
                              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), 1,
                             static_cast<cuuint32_t>(rows), 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                           dims, strides, box, swizzle);
}

template <int D, int MODE>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  using L = Layout<D, MODE>;
  const CUtensorMapSwizzle swizzle =
      L::kSwBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kSwBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_map(&tm_q, p.q, D, p.Hq, p.S_q, p.B, p.q_sh,
                               p.q_ss, p.q_sb, L::kBoxD, L::kRows, swizzle);
  if (err == cudaSuccess)
    err = encode_map(&tm_k, p.k, D, p.Hkv, p.S_k, p.B, p.k_sh, p.k_ss,
                     p.k_sb, L::kBoxD, L::kBN, swizzle);
  if (err == cudaSuccess)
    err = encode_map(&tm_v, p.v, D, p.Hkv, p.S_k, p.B, p.v_sh, p.v_ss,
                     p.v_sb, L::kBoxD, L::kBN, swizzle);
  if (err != cudaSuccess) return err;
  // Above 48 KB of shared memory only after opting in, once per instance.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_tc_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kAlloc);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(p.Hq, (p.S_q + L::kRows - 1) / L::kRows, p.B);
  flash_tc_kernel<D, MODE><<<grid, L::kThreads, L::kAlloc, stream>>>(
      p, tm_q, tm_k, tm_v);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace flash
}  // namespace rkv
