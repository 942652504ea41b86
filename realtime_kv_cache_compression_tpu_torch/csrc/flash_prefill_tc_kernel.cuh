// K1's tensor-core kernel (described in flash_prefill_tc.cuh). No include
// guard: each inclusion defines one kernel template. flash_prefill_tc.cuh
// includes it as flash_tc_kernel<D, MODE>, each mode's default tile and
// kernel, and with RKV_FLASH_TC_TUNED set as flash_tc_tuned_kernel<D,
// MODE, ROWS, BN, VAR>, the other tiles and mode (a)'s variants: the lines
// that differ sit in `#if RKV_FLASH_TC_TUNED`. The default's text (the
// lines outside those blocks and in their #else) must not change: for any
// other text of the same function, even a semantically equal one, ptxas
// gave some default instances other registers (the callers' bits held).

#if RKV_FLASH_TC_TUNED
template <int D, int MODE, int ROWS, int BN, int VAR>
__global__ void __launch_bounds__(Layout<D, MODE, ROWS, BN, VAR>::kThreads, 1)
flash_tc_tuned_kernel(const FlashParams p,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  using L = Layout<D, MODE, ROWS, BN, VAR>;
  constexpr int kBN = L::kBN, kRows = L::kRows;
  constexpr bool kFoldQ = VAR & kFold;
#else
template <int D, int MODE>
__global__ void __launch_bounds__(Layout<D, MODE>::kThreads, 1)
flash_tc_kernel(const FlashParams p, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  using L = Layout<D, MODE>;
  constexpr int kBN = L::kBN, kRows = L::kRows;
#endif
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
#if RKV_FLASH_TC_TUNED
  // Folded, block x is kv head hk and a block takes `span` positions of
  // its n_rep query heads (`used` rows: row r is position row0 + r / n_rep
  // of head hk n_rep + r % n_rep); else query head hq, row r position
  // row0 + r.
  const int n_rep = p.Hq / p.Hkv;
  const int hk = kFoldQ ? hq : hq / n_rep;
  const int span = kFoldQ ? kRows / n_rep : kRows;
  const int used = kFoldQ ? span * n_rep : kRows;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * span;  // longest first
#else
  const int hk = hq / (p.Hq / p.Hkv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
#endif
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
#if RKV_FLASH_TC_TUNED
  if constexpr (VAR & kStatsMxu) {
    // The stats operands' rows: 0 all ones (l), 1 the prompt indicator
    // (zeros until the producer writes it per tile), 2-7 zeros.
    for (int i = threadIdx.x; i < kStages * kBN; i += L::kThreads) {
      const int row = i / 8 % 8;
      const uint32_t w = row == 0 ? 0x3F803F80u : 0u;
      *reinterpret_cast<uint4*>(smem + L::kStatsOff + i / 64 * 1024 +
                                swizzle128(row, i % 8)) =
          make_uint4(w, w, w, w);
    }
    fence_proxy_async();
  }
#endif
  __syncthreads();

  if (warp == L::kConsumers / 32) {
    // ---- producer warp ---------------------------------------------------
#if RKV_FLASH_TC_TUNED
    const int rows_live = min(row0 + span, p.S_q);  // local rows < S_q
#else
    const int rows_live = min(row0 + kRows, p.S_q);  // local rows < S_q
#endif
    const int q_last = p.q_offset + rows_live - 1;   // last live position
    const int kv_end =
        MODE == kCausal ? min(p.S_k, p.q_offset + rows_live) : p.S_k;
    const int n_tiles = (kv_end + kBN - 1) / kBN;
    if (lane == 0) {
#if RKV_FLASH_TC_TUNED
      mbar_expect_tx(bar_q, kFoldQ ? used * D * 2 : L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kSubs; ++c)
        tma_load_4d(smem + c * kRows * L::kSwBytes, &tm_q, bar_q,
                    c * L::kBoxD, kFoldQ ? hk * n_rep : hq, row0, b);
#else
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kSubs; ++c)
        tma_load_4d(smem + c * kRows * L::kSwBytes, &tm_q, bar_q,
                    c * L::kBoxD, hq, row0, b);
#endif
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
#if RKV_FLASH_TC_TUNED
      if constexpr (VAR & kStatsMxu) {
        // Row 1 of the stage's stats operand: 1 for keys before the
        // prompt length, 8 keys (one 16-byte unit) a lane.
        if (lane < kBN / 8) {
          const int key = k0 + 8 * lane, plen = p.plen[b];
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = (key + 2 * e < plen ? 0x3F80u : 0u) |
                   (key + 2 * e + 1 < plen ? 0x3F800000u : 0u);
          *reinterpret_cast<uint4*>(smem + L::kStatsOff +
                                    stage * L::kStatsBytes + lane / 8 * 1024 +
                                    swizzle128(1, lane % 8)) =
              make_uint4(w[0], w[1], w[2], w[3]);
          fence_proxy_async();
        }
        __syncwarp();
      }
#endif
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
#if RKV_FLASH_TC_TUNED
  // Local rows r0, r1 (positions; folded, of tile rows lr0 and lr0 + 8,
  // whose heads the store takes anew, so the loop holds no register for
  // them). The warpgroup's positions run wg_first .. wg_last.
  int r0, r1, wg_first, wg_last;
  if constexpr (kFoldQ) {
    const int lr0 = wg * 64 + (warp % 4) * 16 + g;
    r0 = row0 + lr0 / n_rep;
    r1 = row0 + (lr0 + 8) / n_rep;
    wg_first = p.q_offset + row0 + wg * 64 / n_rep;
    wg_last = p.q_offset + row0 + min(wg * 64 + 63, used - 1) / n_rep;
  } else {
    r0 = row0 + wg * 64 + (warp % 4) * 16 + g;
    r1 = r0 + 8;
    wg_first = p.q_offset + row0 + wg * 64;
    wg_last = wg_first + 63;
  }
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
#else
  const int r0 = row0 + wg * 64 + (warp % 4) * 16 + g;  // local rows r0, r1
  const int r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  const int wg_first = p.q_offset + row0 + wg * 64;  // its first position
#endif
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
#if RKV_FLASH_TC_TUNED
    if (MODE != kCausal || k0 <= wg_last) {
#else
    if (MODE != kCausal || k0 <= wg_first + 63) {
#endif
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
#if RKV_FLASH_TC_TUNED
      if constexpr (VAR == 0) {
#endif
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
#if RKV_FLASH_TC_TUNED
      } else {
        constexpr bool kExp = VAR & kExpBf16, kStats = VAR & kStatsMxu;
        float ls0 = 0.f, ls1 = 0.f;
        float pe0 = 0.f, pe1 = 0.f;  // exp_bf16: the prompt part, straddling
        // P as the A operand: k-step kk takes s[8 kk .. 8 kk + 7] pairwise.
        uint32_t pr[kBN / 16][4];
        if constexpr (kExp) {
          // exp_bf16: P in bf16 from the exponent on, the float scores dead;
          // l's and, where the tile straddles the prompt length, the prompt
          // mass's increments in the same pass (element i = 8 kk + 2 j and
          // i + 1: keys k0 + 16 kk + 8 (j / 2) + 2 t4 and the next, row r0
          // for even j).
          const bool straddle = k0 < plen && k0 + kBN > plen;
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j;
              const float mu = i % 4 < 2 ? mu0 : mu1;
              pr[kk][j] = ex2_bf16x2(pack_bf16x2(fmaf(s[i], scale, -mu),
                                                 fmaf(s[i + 1], scale, -mu)));
              const float p0 = bf16_lo(pr[kk][j]), p1 = bf16_hi(pr[kk][j]);
              const int key = k0 + 16 * kk + 8 * (j / 2) + 2 * t4;
              const float pp = straddle ? (key < plen ? p0 : 0.f) +
                                              (key + 1 < plen ? p1 : 0.f)
                                        : 0.f;
              if (i % 4 < 2) {
                ls0 += p0 + p1;
                pe0 += pp;
              } else {
                ls1 += p0 + p1;
                pe1 += pp;
              }
            }
        } else {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const float pv = exp2f(fmaf(s[i], scale, i % 4 < 2 ? -mu0 : -mu1));
            s[i] = pv;
            if (i % 4 < 2) ls0 += pv;
            else ls1 += pv;
          }
        }
        if constexpr (!kStats) {
          // Prompt mass: l's own increment where the tile lies wholly before
          // the prompt length, a masked sum only where it straddles it.
          float ps0 = 0.f, ps1 = 0.f;
          if (MODE != kPositioned && k0 + kBN <= plen) {
            ps0 = ls0;
            ps1 = ls1;
          } else if (kExp) {
            ps0 = pe0;
            ps1 = pe1;
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
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= i % 4 < 2 ? a0 : a1;

        // stats_via_mxu: the product accumulates into [l0, pm0, l1, pm1],
        // rescaled first (its columns 0 and 1 sit in the quad's first
        // thread, t4 = 0; the others add the operand's zero columns, so the
        // quad sums stay right). On float32 P, the low part p - hi rounded
        // to bf16 is packed beside the high part, so each pair of s dies at
        // once.
        uint32_t plo[kStats && !kExp ? kBN / 16 : 1][4];
        float st[4] = {l0, pm0, l1, pm1};
        if constexpr (kStats) {
          st[0] *= a0;
          st[1] *= a0;
          st[2] *= a1;
          st[3] *= a1;
        }
        if constexpr (kStats && !kExp) {
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float p0 = s[8 * kk + 2 * j], p1 = s[8 * kk + 2 * j + 1];
              pr[kk][j] = pack_bf16x2(p0, p1);
              plo[kk][j] = pack_bf16x2(p0 - bf16_lo(pr[kk][j]),
                                       p1 - bf16_hi(pr[kk][j]));
            }
        } else if constexpr (!kExp) {
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pr[kk][j] =
                  pack_bf16x2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        }
        fence_regs(pr);
        fence_regs(o);
        if constexpr (kStats) {
          fence_regs(st);
          if constexpr (!kExp) fence_regs(plo);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs_tb<D>(o, pr[kk],
                         mnmajor_desc<L::kSwBytes>(v_base, kBN, kk));
        if constexpr (kStats) {
          const uint32_t st_base =
              s_base + L::kStatsOff + stage * L::kStatsBytes;
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk) {
            wgmma_rs_n8(st, pr[kk], kmajor_desc<128>(st_base, 8, kk));
            if constexpr (!kExp)
              wgmma_rs_n8(st, plo[kk], kmajor_desc<128>(st_base, 8, kk));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pr);
        if constexpr (kStats) {
          fence_regs(st);
          if constexpr (!kExp) fence_regs(plo);
          l0 = st[0];
          pm0 = st[1];
          l1 = st[2];
          pm1 = st[3];
        }
      }
#endif
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
#if RKV_FLASH_TC_TUNED
  if constexpr (kFoldQ) {
    // Folded rows: each its own query head; pad rows are never stored.
    const int tid = tid_x(), nr = p.Hq / p.Hkv;
    const int lr0 = tid / 128 * 64 + tid / 32 % 4 * 16 + tid % 32 / 4;
    const int h0 = ctaid_x() * nr + lr0 % nr;
    const int h1 = ctaid_x() * nr + (lr0 + 8) % nr;
    const bool live0 = lr0 < kRows / nr * nr && r0 < p.S_q;
    const bool live1 = lr0 + 8 < kRows / nr * nr && r1 < p.S_q;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                         static_cast<long long>(b) * p.o_sb + 2 * t4;
    __nv_bfloat16* out0 = out + static_cast<long long>(h0) * p.o_sh +
                          r0 * p.o_ss;
    __nv_bfloat16* out1 = out + static_cast<long long>(h1) * p.o_sh +
                          r1 * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (live0)
        *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
            pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (live1)
        *reinterpret_cast<uint32_t*>(out1 + 8 * j) =
            pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (t4 == 0) {
      const long long stat0 = (static_cast<long long>(b) * p.Hq + h0) * p.S_q;
      const long long stat1 = (static_cast<long long>(b) * p.Hq + h1) * p.S_q;
      if (live0) {
        p.pm[stat0 + r0] = pm0 * inv0;
        if (p.lse != nullptr)
          p.lse[stat0 + r0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
      }
      if (live1) {
        p.pm[stat1 + r1] = pm1 * inv1;
        if (p.lse != nullptr)
          p.lse[stat1 + r1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
      }
    }
    return;
  }
#endif
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
