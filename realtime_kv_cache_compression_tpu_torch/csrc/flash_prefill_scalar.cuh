// K1's float32 route: the scalar-FMA kernel (described in
// flash_prefill.cuh). No include guard: each inclusion defines one kernel
// template, named RKV_FLASH_SCALAR_KERNEL. flash_prefill.cuh includes it
// as flash_prefill_kernel, and flash_prefill_variants.cu, for exp_bf16,
// as flash_prefill_exp_kernel with RKV_FLASH_SCALAR_EXP set, whose
// probabilities take exp_bf16's roundings. The default's text must not
// change: ptxas gives the other kernels of its object (the tensor-core
// defaults) other registers when it does, though their own PTX is the
// same.

#ifndef RKV_FLASH_SCALAR_KERNEL
#error "define RKV_FLASH_SCALAR_KERNEL (and RKV_FLASH_SCALAR_EXP) first"
#endif

template <int D, int MODE>
__global__ void __launch_bounds__(kRows)
RKV_FLASH_SCALAR_KERNEL(const FlashParams p) {
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
#if RKV_FLASH_SCALAR_EXP
        // exp_bf16: s - m rounded to bf16 and exponentiated as the
        // tensor-core variant's ex2.approx.ftz.bf16x2 does it: exp2
        // truncated to bf16, 1 where |x| < 2^-23, 0 below -126 (flushed);
        // masked: -inf, so 0.
        const float x = __bfloat162float(__float2bfloat16(s[jj] - m_new));
        const float pj =
            fabsf(x) < 0x1p-23f ? 1.f
            : x < -126.f        ? 0.f
                : __uint_as_float(__float_as_uint(exp2f(x)) & 0xffff0000u);
#else
        const float pj = exp2f(s[jj] - m_new);  // masked: exp2(-inf) = 0
#endif
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
