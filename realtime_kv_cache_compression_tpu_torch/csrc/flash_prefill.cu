// K1: causal flash-attention prefill with the prompt-mass side channel.
//
// Replaces the TPU kernel `_flash_kernel` in
// realtime_kv_cache_compression_tpu/ops/pallas/flash_prefill.py in its
// square causal mode (a), as called by `flash_prefill_with_prompt_mass`,
// and its rectangular causal mode (b), as called by
// `flash_chunk_attention_with_prompt_mass`: S_q query rows of a prefill
// chunk at global positions q_offset .. q_offset + S_q - 1 over an S_k-row
// position-ordered key buffer. Mode (a) is q_offset = 0, S_q = S_k.
//
// For every query row i (global row g = q_offset + i) of every query head
// it computes
//   o_i  = softmax(q_i K^T / sqrt(d)) V          over keys j <= g
//   pm_i = sum_{j < plen[b], j <= g} softmax(.)_ij
// with the online softmax: a running max m, denominator l, accumulator acc,
// and one more running sum, the prompt mass, rescaled by the same
// exp(m_old - m_new) as l and divided by l at the end. The S x S score
// matrix never exists.
//
// Layout: q [B, S_q, Hq, D], k/v [B, S_k, Hkv, D], read through strides
// (unit stride on D), GQA by kv head = q head / (Hq / Hkv). Outputs: o with
// q's layout and dtype, pm [B, Hq, S_q] float32 per head (the wrapper
// averages heads). Buffer keys past the chunk's rows hold later positions
// and causality hides them; the ragged S_q and S_k edges are masked here,
// not padded by the caller. In mode (b) the rows of a later chunk see more
// keys: a block's work grows with q_offset + its rows.
//
// Design (first version, right before fast): one thread per query row,
// 128 rows per block, grid (row tiles, Hq, B). Each thread keeps its scaled
// query row and output accumulator in registers; blocks stage K/V tiles in
// shared memory as float32, which every thread of the block reads by
// broadcast. Arithmetic is float32 scalar FMA (inputs f32 or bf16), in base
// 2: sm_scale * log2(e) is folded into q so the exponentials are exp2.
// Bound: at d=64 the kernel is bound by FMA issue and shared-memory reads
// (two float4 broadcast reads per 8 FMAs), far below the tensor cores'
// rate; tensor-core tiles (mma/wgmma) and TMA are later work.

#include <cstdint>

#include "common.cuh"

using rkv::from_f;
using rkv::to_f;

// Kernel arguments, passed by value; mirrored field for field by a ctypes
// Structure in ops/cuda/flash_prefill.py. Strides are in elements.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* pm;
  const int* plen;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, S_q, S_k, q_offset, Hq, Hkv, D, dtype;
  float sm_scale;
};

namespace {

constexpr int kRows = 128;  // query rows per block == threads per block
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_prefill_kernel(const FlashParams p) {
  constexpr int BN = D <= 64 ? 64 : 32;  // keys per shared-memory tile
  constexpr int SUB = 16;                // keys per register sub-tile
  __shared__ __align__(16) float sK[BN][D];
  __shared__ __align__(16) float sV[BN][D];

  const int b = blockIdx.z, hq = blockIdx.y;
  const int hk = hq / (p.Hq / p.Hkv);
  const int row0 = blockIdx.x * kRows;
  // The local row indexes q, o and pm; causality takes the global row
  // row + q_offset, with q_offset read where it is used (at d=128, where
  // the kernel spills, this keeps one register fewer live).
  const int row = row0 + threadIdx.x;
  const bool live = row < p.S_q;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  float qr[D];
  float acc[D];
  const float qscale = p.sm_scale * kLog2e;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f(q[b * p.q_sb + row * p.q_ss + hq * p.q_sh + d]) * qscale
                 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f, pmass = 0.f;
  const int plen = p.plen[b];
  // Causal: keys past the block's last global row are unseen.
  const int kv_end = min(p.S_k, p.q_offset + row0 + kRows);

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < BN * D; i += kRows) {
      const int j = i / D, d = i % D, key = k0 + j;
      float kf = 0.f, vf = 0.f;
      if (key < p.S_k) {
        kf = to_f(k[b * p.k_sb + key * p.k_ss + hk * p.k_sh + d]);
        vf = to_f(v[b * p.v_sb + key * p.v_ss + hk * p.v_sh + d]);
      }
      sK[j][d] = kf;
      sV[j][d] = vf;
    }
    __syncthreads();
    if (!live || k0 > row + p.q_offset) continue;
    const int jmax = min(BN, row + p.q_offset - k0 + 1);  // visible keys
    for (int j0 = 0; j0 < jmax; j0 += SUB) {
      float s[SUB];
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        float dot = -INFINITY;
        if (j < jmax) {
          dot = 0.f;
          const float4* kr = reinterpret_cast<const float4*>(sK[j]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = kr[d4];
            dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
        }
        s[jj] = dot;
        mt = fmaxf(mt, dot);
      }
      // j0 < jmax, so mt is finite and so is m_new.
      const float m_new = fmaxf(m, mt);
      const float alpha = exp2f(m - m_new);  // m = -inf on the first tile: 0
      l *= alpha;
      pmass *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float pj = exp2f(s[jj] - m_new);  // masked: exp2(-inf) = 0
        l += pj;
        if (k0 + j0 + jj < plen) pmass += pj;
        const float4* vr = reinterpret_cast<const float4*>(sV[j0 + jj]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
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
    T* o = static_cast<T*>(p.o);
#pragma unroll
    for (int d = 0; d < D; ++d)
      o[b * p.o_sb + row * p.o_ss + hq * p.o_sh + d] = from_f<T>(acc[d] * inv);
    p.pm[(static_cast<long long>(b) * p.Hq + hq) * p.S_q + row] = pmass * inv;
  }
}

template <typename T>
cudaError_t launch_typed(const FlashParams& p, cudaStream_t stream) {
  const dim3 grid((p.S_q + kRows - 1) / kRows, p.Hq, p.B);
  switch (p.D) {
    case 16: flash_prefill_kernel<T, 16><<<grid, kRows, 0, stream>>>(p); break;
    case 32: flash_prefill_kernel<T, 32><<<grid, kRows, 0, stream>>>(p); break;
    case 64: flash_prefill_kernel<T, 64><<<grid, kRows, 0, stream>>>(p); break;
    case 128: flash_prefill_kernel<T, 128><<<grid, kRows, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_launch(const FlashParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->q_offset < 0 || p->q_offset + p->S_q > p->S_k)
    return cudaErrorInvalidValue;
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
