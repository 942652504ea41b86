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

template <int D, int MODE>
__global__ void __launch_bounds__(kRows)
flash_prefill_kernel(const FlashParams p) {
  using SS = ScalarShape<D>;
  constexpr int BN = SS::kBN, kLanes = SS::kLanes, kDL = SS::kDL;
  constexpr int SUB = 16;                // keys per register sub-tile
  __shared__ __align__(16) float sK[BN][D];
  __shared__ __align__(16) float sV[BN][D];
  __shared__ int sPos[MODE == kPositioned ? BN : 1];

  const int b = blockIdx.z, hq = blockIdx.y;
  const int hk = hq / (p.Hq / p.Hkv);
  const int row0 = blockIdx.x * SS::kRowsPerBlock;
  // The local row indexes q, o, pm and lse; causality takes the global row
  // row + q_offset, with q_offset read where it is used (at d=128, where
  // the kernel spills, this keeps one register fewer live).
  const int row = row0 + threadIdx.x / kLanes;
  const int lane_c = threadIdx.x % kLanes;  // this thread's channel share
  // The kLanes threads of a row are neighbours in one warp: they take the
  // same branches, and shuffle among themselves only.
  const unsigned row_mask =
      kLanes == 1 ? 0u
                  : ((1u << kLanes) - 1u) << ((threadIdx.x % 32) & ~(kLanes - 1));
  const bool live = row < p.S_q;

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  // Channel d = 4 (kLanes i + lane_c) + e of this thread's i-th float4, so
  // the kLanes threads of a row read neighbouring 16-byte words.
  float qr[kDL];
  float acc[kDL];
  const float qscale = p.sm_scale * kLog2e;
#pragma unroll
  for (int i = 0; i < kDL; ++i) {
    const int d = 4 * (kLanes * (i / 4) + lane_c) + i % 4;
    qr[i] = live ? q[b * p.q_sb + row * p.q_ss + hq * p.q_sh + d] * qscale
                 : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f, pmass = 0.f;
  const int plen = p.plen[b];
  // Causal: keys past the block's last global row are unseen.
  const int kv_end = MODE == kCausal
                         ? min(p.S_k, p.q_offset + row0 + SS::kRowsPerBlock)
                         : p.S_k;

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();
    if constexpr (MODE == kPositioned) {
      // Stage the tile's key positions; skip the tile (block-uniform)
      // when the block's last live row sees none of its keys.
      int seen = 0;
      if (threadIdx.x < BN) {
        const int key = k0 + threadIdx.x;
        const int pos = key < p.S_k ? p.kpos[b * p.S_k + key] : kPosSentinel;
        sPos[threadIdx.x] = pos;
        seen = pos <= p.q_offset + min(row0 + SS::kRowsPerBlock, p.S_q) - 1;
      }
      if (!__syncthreads_or(seen)) continue;
    }
    for (int i = threadIdx.x; i < BN * D; i += kRows) {
      const int j = i / D, d = i % D, key = k0 + j;
      float kf = 0.f, vf = 0.f;
      if (key < p.S_k) {
        kf = k[b * p.k_sb + key * p.k_ss + hk * p.k_sh + d];
        vf = v[b * p.v_sb + key * p.v_ss + hk * p.v_sh + d];
      }
      sK[j][d] = kf;
      sV[j][d] = vf;
    }
    __syncthreads();
    if (!live) continue;
    int jmax = BN;  // keys of the tile this row may see
    if constexpr (MODE == kCausal) {
      if (k0 > row + p.q_offset) continue;
      jmax = min(BN, row + p.q_offset - k0 + 1);
    } else if constexpr (MODE == kFull) {
      jmax = min(BN, p.S_k - k0);
    }
    for (int j0 = 0; j0 < jmax; j0 += SUB) {
      float s[SUB];
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        bool visible;
        if constexpr (MODE == kPositioned) {
          visible = sPos[j] <= row + p.q_offset;
        } else {
          visible = j < jmax;
        }
        float dot = -INFINITY;
        if (visible) {
          dot = 0.f;
          const float4* kr = reinterpret_cast<const float4*>(sK[j]) + lane_c;
#pragma unroll
          for (int d4 = 0; d4 < kDL / 4; ++d4) {
            const float4 kk = kr[kLanes * d4];
            dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
#pragma unroll
          for (int o = 1; o < kLanes; o <<= 1)
            dot += __shfl_xor_sync(row_mask, dot, o);
        }
        s[jj] = dot;
        mt = fmaxf(mt, dot);
      }
      if constexpr (MODE == kPositioned) {
        // No key of the sub-tile is visible: nothing to add, and m may
        // still be -inf, where exp2(m - m_new) would be NaN.
        if (mt == -INFINITY) continue;
      }
      // Causal and full modes: j0 < jmax, so mt is finite and so is m_new.
      const float m_new = fmaxf(m, mt);
      const float alpha = exp2f(m - m_new);  // m = -inf on the first tile: 0
      l *= alpha;
      pmass *= alpha;
#pragma unroll
      for (int d = 0; d < kDL; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float pj = exp2f(s[jj] - m_new);  // masked: exp2(-inf) = 0
        l += pj;
        bool prompt;
        if constexpr (MODE == kPositioned) {
          prompt = sPos[j0 + jj] < plen;
        } else {
          prompt = k0 + j0 + jj < plen;
        }
        if (prompt) pmass += pj;
        const float4* vr =
            reinterpret_cast<const float4*>(sV[j0 + jj]) + lane_c;
#pragma unroll
        for (int d4 = 0; d4 < kDL / 4; ++d4) {
          const float4 vv = vr[kLanes * d4];
          acc[4 * d4 + 0] = fmaf(pj, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pj, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pj, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pj, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float inv = l > 0.f ? 1.f / l : 1.f;
    float* o = static_cast<float*>(p.o);
#pragma unroll
    for (int i = 0; i < kDL; ++i) {
      const int d = 4 * (kLanes * (i / 4) + lane_c) + i % 4;
      o[b * p.o_sb + row * p.o_ss + hq * p.o_sh + d] = acc[i] * inv;
    }
    if (lane_c == 0) {
      const long long stat =
          (static_cast<long long>(b) * p.Hq + hq) * p.S_q + row;
      p.pm[stat] = pmass * inv;
      // m is base 2; the lse is natural, -inf for a row that saw no key.
      if (p.lse != nullptr) p.lse[stat] = m * kLn2 + logf(fmaxf(l, 1e-30f));
    }
  }
}

}  // namespace flash
}  // namespace rkv

#include "flash_prefill_tc.cuh"

namespace rkv {
namespace flash {

// Launches mode MODE at the route of p.dtype and its head_dim; one source
// per mode instantiates it (flash_prefill*.cu), so nvcc builds the modes
// in parallel.
template <int D, int MODE>
cudaError_t launch_scalar(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.S_q + ScalarShape<D>::kRowsPerBlock - 1) /
                      ScalarShape<D>::kRowsPerBlock,
                  p.Hq, p.B);
  flash_prefill_kernel<D, MODE><<<grid, kRows, 0, stream>>>(p);
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

// What the build made of one instance of mode MODE: index 0-4 the float32
// route at head_dim 16, 32, 64, 128, 256, index 5-9 the bf16 tensor-core
// route. Mirrored by a ctypes Structure in ops/cuda/flash_prefill.py.
struct FlashInstanceInfo {
  int bf16, head_dim, regs, local_bytes, static_smem, dynamic_smem, threads;
};

constexpr int kInstanceDims = 5;

template <int D, int MODE>
cudaError_t fill_info(bool bf16, FlashInstanceInfo* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      bf16 ? cudaFuncGetAttributes(&a, tc::flash_tc_kernel<D, MODE>)
           : cudaFuncGetAttributes(&a, flash_prefill_kernel<D, MODE>);
  if (err != cudaSuccess) return err;
  out->bf16 = bf16;
  out->head_dim = D;
  out->regs = a.numRegs;
  out->local_bytes = static_cast<int>(a.localSizeBytes);
  out->static_smem = static_cast<int>(a.sharedSizeBytes);
  out->dynamic_smem = bf16 ? tc::Layout<D, MODE>::kAlloc : 0;
  out->threads = bf16 ? tc::Layout<D, MODE>::kThreads : kRows;
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

}  // namespace flash
}  // namespace rkv
