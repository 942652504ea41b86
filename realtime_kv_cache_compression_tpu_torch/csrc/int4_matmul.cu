// K3: fused int4 dequant-matmul over half-split, offset-binary packed codes.
//
// Replaces the TPU kernel `_kernel` in
// realtime_kv_cache_compression_tpu/ops/pallas/int4_matmul.py (launched by
// `int4_matmul`, wrapped by `int4_matmul_tensor`).
//
//   y = x[:, :K/2] @ W_lo + x[:, K/2:] @ W_hi
//
// where byte q_packed[p, n] holds u = q + 8 of row p (low nibble) and of
// row p + K/2 (high nibble), and W[k, n] = (u - 8) * scale[k / G, n]. The
// low half's groups are scale rows 0 .. K/(2G) - 1, the high half's the
// rest (hi_off rows further); with one group (n_g == 1) both halves read
// row 0 (gs = K/2, hi_off = 0).
//
// Layout: x [M, K] float32 or bf16, row-major and contiguous; q_packed
// [K/2, N] uint8 and scale [n_g, N] float32, contiguous; y [M, N] in x's
// type. Accumulation is float32; each group's dot partial is scaled by its
// float32 scale row and added in float32, as the TPU kernel does, so the
// weights are never rounded. The weights never exist in device memory at
// more than their packed 0.5 bytes per element. The wrapper picks one of
// three routes by shape and type (`route`, ops/cuda/int4_matmul.py):
//
//  - kGemv, M <= 8 (decode), any type: bound by the packed weight bytes.
//    A block covers 32 x kCols columns (kCols = 16 at M <= 2: one 16-byte
//    load per packed row and thread, 512 B of a row per warp) and a range
//    of at most kMaxRange packed rows, which its eight warps split into
//    eight runs, loaded four rows at a time, each batch's loads issued
//    before the previous batch's products (the first while x is staged).
//    x of the block's rows of both halves is staged in shared memory
//    once. Codes convert exactly to u - 8 as float by a byte permute and
//    one float add (no int-to-float conversion: at a quarter of the FMA
//    rate, two of those per byte would cap the route near half the memory
//    rate), each group's partial is a float32 FMA chain, scales come as
//    float4. The wrapper keeps the grid to one wave (two blocks per SM).
//    The warps' sums meet in shared memory; with split > 1
//    blocks over K, each block writes its float32 partial to scratch, and
//    the last block of a column tile to arrive (a per-tile ticket, counted
//    with atomicAdd after a fence) sums the splits in split order, rounds
//    once, writes y and resets the ticket: deterministic, one launch, no
//    epilogue kernel. The scratch (partials and tickets, zero between
//    calls) is the wrapper's, cached per device and stream.
//    Expert-indexed form (`expert_ids` set; route "gemv_expert" in the
//    wrapper): the same GEMV over one expert of an [E, K/2, N] code stack
//    and its [E, n_g, N] scales, the expert id read by each block from
//    device memory (expert_ids[slot]), so routed MoE decode needs no host
//    read and no copy of the expert. It replaces the Pallas `_kernel`
//    launched per routed expert and projection by `_moe_dynslice`
//    (realtime_kv_cache_compression_tpu/ops/moe.py:156-162, through
//    `int4_matmul_tensor(..., wt.expert(e))`). Bound: one expert's codes
//    and scales once; at Mixtral-8x7B's 4096 x 14336 (and 14336 x 4096)
//    with groups of 128, 29.36 MB of codes + 1.84 MB of scales, about
//    9.3 us at 3.35 TB/s.
//  - kTensorCore, M > 8, bf16 (prefill), where TMA can read the operands
//    (N % 16 == 0, K % 16 == 0, 16-byte aligned) and every 64-row step of
//    packed rows holds whole groups or lies in one (n_g == 1, gs % 64 ==
//    0, or gs in {16, 32}): bound by operations. wgmma on 128 x 128 output
//    tiles; see namespace tc below.
//  - kTile, every other M > 8 (float32 prefill, the parity phases' exact
//    route, and shapes the tensor-core route cannot take): a float32
//    shared-memory tile, 64 x 128 outputs, 256 threads of 4 x 8 outputs;
//    per step 16 packed rows are staged with the matching x columns of both
//    halves and dequantized there ((u - 8) * s_g, once per element for all
//    64 rows of the tile), so the inner loop is a plain float32 FMA tile
//    for any group size. Bound there: FMA issue.

#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

using rkv::from_f;
using rkv::to_f;

// Kernel arguments; mirrored by a ctypes Structure in ops/cuda/int4_matmul.py.
struct Int4MatmulParams {
  const void* x;
  const uint8_t* q;
  const float* scale;
  void* out;
  float* partial;  // [split, M, N] float32 scratch (kGemv with split > 1)
  int* ticket;     // [column tiles] int32 scratch, zero between calls
  int M, N, KH;    // KH = K / 2 packed rows
  int gs;          // packed rows per scale group (KH when n_g == 1)
  int hi_off;      // scale-row offset of the high half's groups
  int split;       // kGemv: blocks over K
  int route;       // Route
  int dtype;
  // kGemv over one expert of a stack (null on every other call): q and
  // scale point at expert 0, and the block offsets them by expert
  // expert_ids[slot], read from device memory, times the strides.
  const int* expert_ids;
  long long q_estride, s_estride;  // bytes of codes / floats of scales
  int slot;
  int n_experts;
};

enum Route : int { kGemv = 0, kTile = 1, kTensorCore = 2 };

namespace {

constexpr int kSmallM = 8;
constexpr int kGemvThreads = 256;  // eight warps
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kMaxRange = 512;     // packed rows per kGemv block (GEMV_MAX_ROWS)
constexpr int kBM = 64, kBN = 128, kBKP = 16, kThreads = 256;

// Bytes n..n+3 of packed row `row` (zeros past the end of the row).
__device__ __forceinline__ uint32_t load_packed(const uint8_t* row, int n,
                                                int n_cols, bool vec) {
  if (vec && n + 3 < n_cols) return *reinterpret_cast<const uint32_t*>(row + n);
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < n_cols) word |= static_cast<uint32_t>(row[n + i]) << (8 * i);
  return word;
}

// Signed code of nibble `shift` of a packed word, as float: u - 8, exact.
__device__ __forceinline__ float code(uint32_t word, int shift) {
  return static_cast<float>((word >> shift) & 0xFu) - 8.f;
}

// kGemv's columns per thread: 16 (one uint4 of a packed row) at M <= 2;
// fewer at larger M, so the partials of both halves stay in registers
// (mirrored by gemv_block_cols in ops/cuda/int4_matmul.py).
template <int MT>
struct GemvShape {
  static constexpr int kCols = MT <= 2 ? 16 : 32 / MT;
  static constexpr int kBlockCols = 32 * kCols;
  // Shared memory: x [MT][2][kMaxRange], then the warps' sums
  // [kGemvWarps][MT][kBlockCols] in the same floats.
  static constexpr int kSmemFloats =
      MT * 2 * kMaxRange > kGemvWarps * MT * kBlockCols
          ? MT * 2 * kMaxRange
          : kGemvWarps * MT * kBlockCols;
};

// The signed code u - 8 of byte e of `nib` (four nibbles, one in the low
// bits of each byte) as an exact float, without an int-to-float
// conversion (a quarter-rate instruction): the byte becomes the float
// 2^23 + u (bits 0x4B0000uu), and 2^23 + 8 is subtracted.
__device__ __forceinline__ float nibble_code(uint32_t nib, int e) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 | e)) -
         8388616.f;
}

// C bytes (columns n .. n + C - 1) of a packed row as C / 4 words, zeros
// past the row's end; one 16-, 8- or 4-byte load where `vec` allows it.
template <int C>
__device__ __forceinline__ void load_codes(const uint8_t* row, int n,
                                           int n_cols, bool vec,
                                           uint32_t (&w)[C / 4]) {
  if (vec && n + C <= n_cols) {
    if constexpr (C == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + n);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (C == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + n);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(row + n);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < C / 4; ++i) w[i] = load_packed(row, n + 4 * i, n_cols, false);
}

// C float32 scales of scale row `g` at columns n .. n + C - 1 (zeros past
// N), as float4 loads where `vec4` allows it.
template <int C>
__device__ __forceinline__ void load_scales(const float* scale, int g, int n,
                                            int n_cols, bool vec4,
                                            float (&s)[C]) {
  const float* row = scale + static_cast<long long>(g) * n_cols;
  if (vec4 && n + C <= n_cols) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(row + n + 4 * i);
      s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z; s[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) s[j] = n + j < n_cols ? row[n + j] : 0.f;
}

// kGemv: see the header. Grid (column tiles, split).
template <typename T, int MT>
__global__ void __launch_bounds__(kGemvThreads)
int4_gemv_kernel(const Int4MatmulParams p) {
  constexpr int C = GemvShape<MT>::kCols, BC = GemvShape<MT>::kBlockCols;
  constexpr int kUnroll = 4;  // packed rows per batch; two batches in flight
  __shared__ __align__(16) float smem[GemvShape<MT>::kSmemFloats];
  __shared__ int s_last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * BC + lane * C;
  const int range = (p.KH + p.split - 1) / p.split;
  const int p0 = blockIdx.y * range;
  const int p1 = min(p.KH, p0 + range);
  const int K = 2 * p.KH;
  const T* x = static_cast<const T*>(p.x);
  const uint8_t* q = p.q;
  const float* scale = p.scale;
  if (p.expert_ids != nullptr) {
    const int e = p.expert_ids[p.slot];
    if (e < 0 || e >= p.n_experts) __trap();  // a router fault, never data
    q += e * p.q_estride;
    scale += e * p.s_estride;
  }

  const int wrange = (p1 - p0 + kGemvWarps - 1) / kGemvWarps;
  const int w0 = p0 + warp * wrange;
  const int w1 = min(p1, w0 + wrange);
  const bool vec = p.N % C == 0, vec4 = p.N % 4 == 0;
  // kUnroll rows' codes, rows at or past `end` as zeros.
  auto load_batch = [&](uint32_t (&w)[kUnroll][C / 4], int r0, int end) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + u < end) {
        load_codes<C>(q + static_cast<long long>(r0 + u) * p.N, n, p.N,
                      vec, w[u]);
      } else {
#pragma unroll
        for (int i = 0; i < C / 4; ++i) w[u][i] = 0u;
      }
    }
  };
  // The first batch's codes are in flight while x is staged.
  int r = w0;
  uint32_t w[kUnroll][C / 4];
  if (n < p.N) load_batch(w, r, min((r / p.gs + 1) * p.gs, w1));

  // x of the block's rows, both halves, as float: sx[(m * 2 + half) *
  // kMaxRange + r - p0].
  float* sx = smem;
  for (int i = threadIdx.x; i < MT * 2 * range; i += kGemvThreads) {
    const int m = i / (2 * range), rem = i % (2 * range);
    const int h = rem / range, rr = rem % range;
    sx[(m * 2 + h) * kMaxRange + rr] =
        m < p.M && p0 + rr < p1
            ? to_f(x[static_cast<long long>(m) * K + h * p.KH + p0 + rr])
            : 0.f;
  }
  __syncthreads();

  float acc[MT][C];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[m][j] = 0.f;

  if (n < p.N) {
    while (r < w1) {
      const int g = r / p.gs;
      const int g_end = min((g + 1) * p.gs, w1);
      float plo[MT][C], phi[MT][C];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < C; ++j) plo[m][j] = phi[m][j] = 0.f;
      for (; r < g_end; r += kUnroll) {
        // The next batch (the rest of this group, or the next group's
        // first rows) is loaded before this one's products.
        const int rn = min(r + kUnroll, g_end);
        const int rn_end = rn < g_end ? g_end : min(g_end + p.gs, w1);
        uint32_t next[kUnroll][C / 4];
        if (rn < w1) load_batch(next, rn, rn_end);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // Rows past the group's end hold zeros and take x = 0: they add
          // exactly 0.
          const bool live = r + u < g_end;
          // Both nibbles of each byte, into both halves.
#pragma unroll
          for (int i = 0; i < C / 4; ++i) {
            const uint32_t lo = w[u][i] & 0x0F0F0F0Fu;
            const uint32_t hi = (w[u][i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xl = live ? sx[(m * 2) * kMaxRange + r + u - p0] : 0.f;
              const float xh =
                  live ? sx[(m * 2 + 1) * kMaxRange + r + u - p0] : 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                plo[m][4 * i + e] = fmaf(xl, nibble_code(lo, e), plo[m][4 * i + e]);
                phi[m][4 * i + e] = fmaf(xh, nibble_code(hi, e), phi[m][4 * i + e]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int i = 0; i < C / 4; ++i) w[u][i] = next[u][i];
      }
      r = g_end;
      float slo[C], shi[C];
      load_scales<C>(scale, g, n, p.N, vec4, slo);
      load_scales<C>(scale, g + p.hi_off, n, p.N, vec4, shi);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < C; ++j)
          acc[m][j] += plo[m][j] * slo[j] + phi[m][j] * shi[j];
    }
  }

  // The warps' sums, in warp order, into one partial per block.
  __syncthreads();  // every read of sx is done: its floats are reused
  float* red = smem;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j)
      red[(warp * MT + m) * BC + lane * C + j] = acc[m][j];
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < MT * BC; i += kGemvThreads) {
    const int m = i / BC, c = i % BC, col = blockIdx.x * BC + c;
    if (m >= p.M || col >= p.N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[(w * MT + m) * BC + c];
    const long long mn = static_cast<long long>(m) * p.N + col;
    if (p.split == 1) out[mn] = from_f<T>(s);
    else p.partial[static_cast<long long>(blockIdx.y) * p.M * p.N + mn] = s;
  }
  if (p.split == 1) return;

  // Split-K in the same launch: the last block of this column tile sums
  // the splits in split order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&p.ticket[blockIdx.x], 1) == p.split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < MT * BC; i += kGemvThreads) {
    const int m = i / BC, c = i % BC, col = blockIdx.x * BC + c;
    if (m >= p.M || col >= p.N) continue;
    const long long mn = static_cast<long long>(m) * p.N + col;
    float s = 0.f;
    for (int sp = 0; sp < p.split; ++sp)
      s += __ldcg(&p.partial[static_cast<long long>(sp) * p.M * p.N + mn]);
    out[mn] = from_f<T>(s);
  }
  if (threadIdx.x == 0) p.ticket[blockIdx.x] = 0;  // ready for the next call
}

// Large M: one 64 x 128 output tile per block, 4 x 8 outputs per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_tiled_kernel(const Int4MatmulParams p) {
  __shared__ __align__(16) float sXl[kBKP][kBM + 4];  // [packed row][m]
  __shared__ __align__(16) float sXh[kBKP][kBM + 4];
  __shared__ __align__(16) float sWl[kBKP][kBN];      // dequantized codes
  __shared__ __align__(16) float sWh[kBKP][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int K = 2 * p.KH;
  const bool vec = (p.N % 4) == 0;
  const T* x = static_cast<const T*>(p.x);
  float acc[4][8] = {};

  for (int r0 = 0; r0 < p.KH; r0 += kBKP) {
    __syncthreads();
    // x: 64 rows x 16 packed rows, both halves; four of each per thread.
#pragma unroll
    for (int i = 0; i < (kBM * kBKP) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int mm = e / kBKP, rr = e % kBKP;
      const int m = m0 + mm, r = r0 + rr;
      const bool in = m < p.M && r < p.KH;
      const long long base = static_cast<long long>(m) * K + r;
      sXl[rr][mm] = in ? to_f(x[base]) : 0.f;
      sXh[rr][mm] = in ? to_f(x[base + p.KH]) : 0.f;
    }
    // codes: 16 packed rows x 32 column quads; two words per thread.
#pragma unroll
    for (int i = 0; i < (kBKP * kBN / 4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int rr = e / (kBN / 4), cq = e % (kBN / 4);
      const int r = r0 + rr, n = n0 + 4 * cq;
      const uint32_t word =
          r < p.KH ? load_packed(p.q + static_cast<long long>(r) * p.N, n, p.N, vec)
                   : 0u;
      const int g = r / p.gs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float lo = 0.f, hi = 0.f;
        if (r < p.KH && n + j < p.N) {
          lo = code(word, 8 * j) * p.scale[static_cast<long long>(g) * p.N + n + j];
          hi = code(word, 8 * j + 4) *
               p.scale[static_cast<long long>(g + p.hi_off) * p.N + n + j];
        }
        sWl[rr][4 * cq + j] = lo;
        sWh[rr][4 * cq + j] = hi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kBKP; ++rr) {
      const float4 al = *reinterpret_cast<const float4*>(&sXl[rr][ty * 4]);
      const float4 ah = *reinterpret_cast<const float4*>(&sXh[rr][ty * 4]);
      const float4 bl0 = *reinterpret_cast<const float4*>(&sWl[rr][tx * 8]);
      const float4 bl1 = *reinterpret_cast<const float4*>(&sWl[rr][tx * 8 + 4]);
      const float4 bh0 = *reinterpret_cast<const float4*>(&sWh[rr][tx * 8]);
      const float4 bh1 = *reinterpret_cast<const float4*>(&sWh[rr][tx * 8 + 4]);
      const float a_l[4] = {al.x, al.y, al.z, al.w};
      const float a_h[4] = {ah.x, ah.y, ah.z, ah.w};
      const float b_l[8] = {bl0.x, bl0.y, bl0.z, bl0.w, bl1.x, bl1.y, bl1.z, bl1.w};
      const float b_h[8] = {bh0.x, bh0.y, bh0.z, bh0.w, bh1.x, bh1.y, bh1.z, bh1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a_h[i], b_h[j], fmaf(a_l[i], b_l[j], acc[i][j]));
    }
  }
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (m < p.M && n < p.N)
        out[static_cast<long long>(m) * p.N + n] = from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// kTensorCore: bf16 prefill on wgmma
// ---------------------------------------------------------------------------
//
// Block: 256 threads, two warpgroups, a 128 x 128 output tile (each
// warpgroup 64 rows x 128 columns). The reduction walks steps of 64 packed
// rows, each step one half: (rows r0 .. r0 + 63, low nibbles, x columns
// r0 ..), then (the same rows, high nibbles, x columns K/2 + r0 ..).
// Thread 0 feeds a ring of kStages stages by TMA, each the step's x tile
// [128 rows][64 columns] (128 B swizzle, K-major: the A operand; columns
// past K and rows past M read as zeros, and the low half's columns past
// K/2 meet zeroed codes) and its packed codes [64 rows][128 columns]
// (uint8, plain). Every thread unpacks 32 codes of the step into a bf16
// tile W [64 k-rows][128 columns] holding the raw signed codes u - 8
// (exact in bf16), n-contiguous in two 64-column chunks with the 128 B
// swizzle computed here (the B operand, MN-major with the transpose bit),
// rows past K/2 written as zeros; then fence.proxy.async, so that the
// async proxy (wgmma) sees the generic stores, and a block barrier. W is
// double-buffered: step t + 1's codes are unpacked while step t's wgmma
// runs.
//
// Scales the TPU kernel's way: each warpgroup runs m64n128k16 wgmma into a
// float32 group partial (the first k-step of a group overwrites it) and,
// at every group boundary and step end, adds partial * s_g[n] into its
// float32 accumulator (s of the low or the high half's scale row). So no
// weight is ever rounded: the only bf16 roundings are x's own (it is bf16)
// and y's one. Groups: one 64-row step lies in one group (gs % 64 == 0,
// or one group) or holds 64 / gs whole groups of 16 or 32 rows.
//
// Shared memory: kStages x (x 16 KB + codes 8 KB) + 2 x W 16 KB + the
// mbarriers, about 129 KB: one block per SM, 255 registers a thread (the
// accumulator and the partial are 64 float32 each).
// Bound: operations (2 M K N at 989 TFLOP/s bf16); the x and code tiles
// stream from L2 at 40 KB per 64-row pair of steps.
namespace tc {

using namespace rkv::hopper;

constexpr int kTM = 128, kTN = 128, kTK = 64;  // tile rows, columns; rows per step
constexpr int kTcThreads = 256;
constexpr int kStages = 4;
constexpr int kXBytes = kTM * kTK * 2;       // 16 KB
constexpr int kCodeBytes = kTK * kTN;        // 8 KB
constexpr int kStageBytes = kXBytes + kCodeBytes;
constexpr int kWBytes = kTK * kTN * 2;       // 16 KB
constexpr int kWOff = kStages * kStageBytes;
constexpr int kBarOff = kWOff + 2 * kWBytes;
constexpr int kAlloc = kBarOff + 8 * kStages + 1024;  // + room to align
static_assert(kStageBytes % 1024 == 0 && kWBytes % 1024 == 0, "alignment");

// Four bf16 of the signed codes u - 8 of the packed word `nib` (four
// nibbles already in the low 4 bits of each byte), as two bf16x2: byte b
// becomes the bf16 bit pattern 0x4300 | b, which is 128 + b, and 136 is
// subtracted in bf16, exactly (every result is an integer in [-8, 7]).
__device__ __forceinline__ uint2 codes_bf16x4(uint32_t nib) {
  const uint32_t lo = __byte_perm(nib, 0x43434343u, 0x4140);
  const uint32_t hi = __byte_perm(nib, 0x43434343u, 0x4342);
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 a = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), bias);
  const __nv_bfloat162 b = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi), bias);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}

// Step t: packed rows 64 (t / 2) .., half t % 2.
struct Step {
  int r0, half;
  __device__ __forceinline__ explicit Step(int t) : r0(kTK * (t / 2)), half(t % 2) {}
};

// Thread 0: the TMA copies of step t into its stage.
__device__ __forceinline__ void issue_step(uint8_t* smem, uint64_t* full,
                                           const CUtensorMap* tm_x,
                                           const CUtensorMap* tm_q, int t,
                                           int KH, int m0, int n0) {
  const Step st(t);
  const int stage = t % kStages;
  uint8_t* dst = smem + stage * kStageBytes;
  mbar_expect_tx(&full[stage], kStageBytes);
  tma_load_2d(dst, tm_x, &full[stage], st.half * KH + st.r0, m0);
  tma_load_2d(dst + kXBytes, tm_q, &full[stage], n0, st.r0);
}

// Every thread: 32 codes of step t (row tid / 4, columns 32 (tid % 4) ..)
// into W buffer `wbuf` as bf16, swizzled; rows past K/2 as zeros.
__device__ __forceinline__ void unpack_step(uint8_t* smem, uint64_t* full,
                                            int t, int KH) {
  const Step st(t);
  const int stage = t % kStages;
  mbar_wait(&full[stage], (t / kStages) & 1);
  const int row = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const uint8_t* codes = smem + stage * kStageBytes + kXBytes + row * kTN +
                         32 * quarter;
  const uint4 c0 = *reinterpret_cast<const uint4*>(codes);
  const uint4 c1 = *reinterpret_cast<const uint4*>(codes + 16);
  const uint32_t words[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const bool live = st.r0 + row < KH;
  const int shift = 4 * st.half;
  uint8_t* w = smem + kWOff + (t % 2) * kWBytes + (quarter / 2) * (kTK * 128);
#pragma unroll
  for (int u = 0; u < 4; ++u) {  // 16-byte units of 8 columns
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (live) {
      const uint2 a = codes_bf16x4((words[2 * u] >> shift) & 0x0F0F0F0Fu);
      const uint2 b = codes_bf16x4((words[2 * u + 1] >> shift) & 0x0F0F0F0Fu);
      v = make_uint4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<uint4*>(w + swizzle128(row, (quarter % 2) * 4 + u)) = v;
  }
  fence_proxy_async();
}

// kSeg: k-steps of 16 rows per group partial: 4 (a 64-row step lies in
// one group), or 64 / gs groups per step (gs = 16 or 32). A template
// parameter, so that the wgmma loops unroll.
template <int kSeg>
__global__ void __launch_bounds__(kTcThreads, 1)
int4_tc_kernel(const Int4MatmulParams p,
               const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_q) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle repeats every 1024 bytes and TMA and wgmma both read it
  // from the address bits, so every tile starts on a 1024-byte boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int n_steps = 2 * ((p.KH + kTK - 1) / kTK);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kStages && t < n_steps; ++t)
      issue_step(smem, full, &tm_x, &tm_q, t, p.KH, m0, n0);
  unpack_step(smem, full, 0, p.KH);
  __syncthreads();

  float acc[kTN / 2], part[kTN / 2];
#pragma unroll
  for (int i = 0; i < kTN / 2; ++i) acc[i] = part[i] = 0.f;
  const uint32_t s_base = smem_u32(smem);
  for (int t = 0; t < n_steps; ++t) {
    const Step st(t);
    const uint32_t a_base =
        s_base + (t % kStages) * kStageBytes + wg * 64 * 128;
    const uint32_t b_base = s_base + kWOff + (t % 2) * kWBytes;
#pragma unroll
    for (int k0 = 0; k0 < kTK / 16; k0 += kSeg) {
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = k0; kk < k0 + kSeg; ++kk)
        wgmma_ss<kTN, 1>(part, kmajor_desc<128>(a_base, 64, kk),
                         mnmajor_desc<128>(b_base, kTK, kk), kk > k0);
      wgmma_commit();
      if (k0 + kSeg == kTK / 16 && t + 1 < n_steps)
        unpack_step(smem, full, t + 1, p.KH);  // overlaps the products
      wgmma_wait_all();
      fence_regs(part);
      // The group's partial, scaled by its row of this half, into acc
      // (rows past K/2 hold zeros and belong to no group).
      if (st.r0 + 16 * k0 >= p.KH) continue;
      const int grp = (st.r0 + 16 * k0) / p.gs;
      const float* srow = p.scale +
          static_cast<long long>(grp + st.half * p.hi_off) * p.N;
#pragma unroll
      for (int j = 0; j < kTN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        const float2 s = col < p.N ? *reinterpret_cast<const float2*>(srow + col)
                                   : make_float2(0.f, 0.f);
        acc[4 * j] = fmaf(part[4 * j], s.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(part[4 * j + 1], s.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(part[4 * j + 2], s.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(part[4 * j + 3], s.y, acc[4 * j + 3]);
      }
    }
    // Both warpgroups are done with this step's stage and W buffer.
    __syncthreads();
    if (threadIdx.x == 0 && t + kStages < n_steps)
      issue_step(smem, full, &tm_x, &tm_q, t + kStages, p.KH, m0, n0);
  }

  // Element i: row 16 warp + g (+ 8 for i % 4 >= 2) of the warpgroup's 64,
  // column 8 (i / 4) + 2 t4 + i % 2.
  const int r0 = m0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if (col >= p.N) continue;
    if (r0 < p.M)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r0) * p.N + col) =
          pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    if (r1 < p.M)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r1) * p.N + col) =
          pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int kSeg>
cudaError_t launch_seg(const Int4MatmulParams& p, dim3 grid,
                       const CUtensorMap& tm_x, const CUtensorMap& tm_q,
                       cudaStream_t stream) {
  // Above 48 KB of shared memory only after opting in, once per instance.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int4_tc_kernel<kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kAlloc);
  if (opt_in != cudaSuccess) return opt_in;
  int4_tc_kernel<kSeg><<<grid, kTcThreads, kAlloc, stream>>>(p, tm_x, tm_q);
  return cudaGetLastError();
}

cudaError_t launch(const Int4MatmulParams& p, cudaStream_t stream) {
  const int K = 2 * p.KH;
  CUtensorMap tm_x, tm_q;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(p.M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {kTK, kTM};
  cudaError_t err = encode_tensor_map(
      &tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.x, x_dims, x_strides,
      x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t q_dims[2] = {static_cast<cuuint64_t>(p.N),
                                static_cast<cuuint64_t>(p.KH)};
  const cuuint64_t q_strides[1] = {static_cast<cuuint64_t>(p.N)};
  const cuuint32_t q_box[2] = {kTN, kTK};
  if (err == cudaSuccess)
    err = encode_tensor_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.q,
                            q_dims, q_strides, q_box,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kTN - 1) / kTN, (p.M + kTM - 1) / kTM);
  const int seg = p.gs % kTK == 0 || p.gs == p.KH ? 4 : p.gs / 16;
  return seg == 4   ? launch_seg<4>(p, grid, tm_x, tm_q, stream)
         : seg == 2 ? launch_seg<2>(p, grid, tm_x, tm_q, stream)
                    : launch_seg<1>(p, grid, tm_x, tm_q, stream);
}

}  // namespace tc

namespace {

template <typename T>
cudaError_t launch_gemv(const Int4MatmulParams& p, cudaStream_t stream) {
  auto go = [&](auto kernel, int block_cols) {
    const dim3 grid((p.N + block_cols - 1) / block_cols, p.split);
    kernel<<<grid, kGemvThreads, 0, stream>>>(p);
    return cudaGetLastError();
  };
  if (p.M == 1) return go(int4_gemv_kernel<T, 1>, GemvShape<1>::kBlockCols);
  if (p.M == 2) return go(int4_gemv_kernel<T, 2>, GemvShape<2>::kBlockCols);
  if (p.M <= 4) return go(int4_gemv_kernel<T, 4>, GemvShape<4>::kBlockCols);
  return go(int4_gemv_kernel<T, 8>, GemvShape<8>::kBlockCols);
}

template <typename T>
cudaError_t launch_typed(const Int4MatmulParams& p, cudaStream_t stream) {
  if (p.route == kGemv) return launch_gemv<T>(p, stream);
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  int4_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int4_matmul_launch(const Int4MatmulParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->M <= 0 || p->N <= 0 || p->KH <= 0 || p->gs <= 0 || p->KH % p->gs)
    return cudaErrorInvalidValue;
  switch (p->route) {
    case kGemv:
      if (p->M > kSmallM || p->split <= 0 ||
          (p->KH + p->split - 1) / p->split > kMaxRange ||
          (p->split > 1 && (p->partial == nullptr || p->ticket == nullptr)) ||
          (p->expert_ids != nullptr &&
           (p->n_experts <= 0 || p->q_estride % 16 || p->s_estride % 4)))
        return cudaErrorInvalidValue;
      break;
    case kTile:
      if (p->M <= kSmallM || p->expert_ids != nullptr)
        return cudaErrorInvalidValue;
      break;
    case kTensorCore:
      if (p->M <= kSmallM || p->expert_ids != nullptr ||
          p->dtype != rkv::kBFloat16 || p->N % 16 ||
          p->KH % 8 ||
          !(p->gs == p->KH || p->gs % tc::kTK == 0 || p->gs == 16 ||
            p->gs == 32))
        return cudaErrorInvalidValue;
      return tc::launch(*p, s);
    default:
      return cudaErrorInvalidValue;
  }
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
