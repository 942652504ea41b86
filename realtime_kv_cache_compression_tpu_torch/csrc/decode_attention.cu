// K2: fused dequant + attention decode over the packed tier pools, the
// quantized decode pool and the recent ring, flash-decoding style.
//
// Replaces the TPU kernel `_decode_kernel` in
// realtime_kv_cache_compression_tpu/ops/pallas/decode_attention.py, all of
// it: tiers, decode pool, ring, and G >= 1 scale groups per head.
//
// One query token per batch row attends over every stored token of a
// layer: the HIGH/MID/LOW tier pools (2/4/8-bit codes packed chunk-strided
// along the token axis, or raw 16-bit values), the decode pool (ring-sized
// blocks, each packed as one chunk, or raw 16-bit) and the uncompressed
// recent ring. Within a chunk of C tokens with R = ceil(C * bits / 8) byte
// rows, byte row r of chunk c holds the 8 / bits tokens c C + r + j R (j =
// 0, 1, ...; those below C), token j at bit offset j * bits. With one
// scale per (token, kv head), G = 1, the affine folds into rank-1
// corrections in bf16, as the reference folds it (decode_attention.py:
// 32-33, :193-194):
//   s = (q.c - sum(q) * zp_k) * sc_k * sm_scale
//   o = sum_t p_t sc_v,t c_t - sum_t p_t sc_v,t zp_v,t
// With G > 1 groups of gs = D / G channels (a power of two, at least 8),
// and in float32 at any G (see launch_rep), each code is dequantized in
// registers, (c - zp_g) * sc_g, before its products: the same function as
// the reference's per-channel expansion (decode_attention.py:195-200,
// :230-234), summed in another order.
// The only mask is stored position <= query position; invalid tier and
// pool slots and ring slots at or past the ring length are skipped.
//
// Bound: bytes. Per kv head and stored token the kernel reads D * bits / 8
// code bytes of K and of V plus 16 bytes of float32 scale and zero point
// per group; a layer's state at the main path's sizes is 0.3-13 MB, so a
// call lasts a few microseconds at the memory rate and the launch and the
// chain of dependent loads inside a block set its time. The design:
//
//  - Work by byte rows. The grid is (splits, kv heads, batch); a split is
//    a range of byte rows of one segment (tier, pool or ring). A block
//    walks its rows in tiles of at most kTileTokens tokens and kTileBytes
//    bytes of K (and of V) inside one chunk, and the wrapper gives every
//    split about the same number of whole tiles, as few as keep a layer
//    within two blocks per SM (at most 32 splits per (row, kv head);
//    one tile a block at the main path's batch-1 widths but Llama-2-7B's
//    32 kv heads). Each tile's code
//    rows (or raw values) and scales are staged into shared memory by
//    cp.async, double-buffered: tile i + 1's copies are in flight while
//    tile i is scored, so every byte row is fetched from device memory
//    once, with 16-byte copies.
//  - Scores: D / 16 lanes share a byte row, each unpacking the 16 codes
//    it holds for every token of the row (8 / bits tokens: one shift and
//    mask per word for all of them) into floats by a byte permute (2^23 +
//    u) and one subtraction, then a dot with each query head's 16
//    channels; the lanes' partial dots meet by shuffles. n_rep is a
//    template parameter (instances 1, 2, 4, 8, 16; a head count between
//    two instances takes the larger, the extra heads' q zero and unread).
//  - Softmax online across tiles, one warp per query head; then the values:
//    D / 4 threads share a byte row, each unpacking four channels of every
//    token of the row; row slots keep their own sums in registers (4 x
//    n_rep floats) and meet once per block in shared memory.
//  - One launch: each block writes its partial (m, l, acc) to scratch, and
//    the last block of each (batch row, kv head) to arrive (a ticket,
//    counted with atomicAdd after a fence) merges the splits by
//    log-sum-exp in split order, writes the output and resets the ticket.
//    The scratch is the wrapper's, cached per device and stream; every
//    call gives the same bits.
//  - With an lse pointer (a decode over one rank's slot shard of a
//    sequence-sharded state) the merging block also writes each row's
//    log-sum-exp M + log L in float32 (-inf where no key was seen) and
//    writes O / L in float32, not in q's dtype, so that the ranks'
//    partials merge exactly and round once. Without it nothing changes.
//  - The parameter struct is __grid_constant__, so the runtime segment
//    index reads it where it lies instead of copying it to local memory.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

using rkv::from_f;
using rkv::to_f;

// One pool of the walk (a tier, the decode pool or the ring). Mirrored by
// a ctypes Structure in ops/cuda/decode_attention.py.
struct DecodeSegment {
  const void* k;          // [B, rows, H, D] uint8 codes, or raw q-dtype values
  const void* v;
  const float* k_scale;   // [B, n, H, G] float32 (unused for raw segments)
  const float* k_zp;
  const float* v_scale;
  const float* v_zp;
  const int* pos;         // [B, n] stored positions
  const uint8_t* valid;   // [B, n] slot validity (tiers, pool), or null
  const int* length;      // [B] live ring length (ring), or null
  long long rows;         // stored rows per batch row
  int n;                  // tokens (slots)
  int bits;               // 2 / 4 / 8 codes, 16 raw
  int chunk;              // packing chunk C (raw: any; one token per row)
  int rows_per_chunk;     // R (raw: C)
  int split_start;        // first split of this segment
  int n_splits;
  int rows_per_split;     // byte rows per split (the last may hold fewer)
  int tile_rows;          // byte rows per tile, at most
};

constexpr int kMaxSegments = 5;  // HIGH, MID, LOW, decode pool, ring

struct DecodeParams {
  DecodeSegment seg[kMaxSegments];
  const void* q;          // [B, Hq, D]
  const int* q_pos;       // [B]
  float* part_acc;        // [B, Hkv, splits, REP, D] (REP: the instance's)
  float* part_m;          // [B, Hkv, splits, REP]
  float* part_l;
  int* ticket;            // [B, Hkv], zero between calls
  void* out;              // [B, Hq, D], q dtype (float32 with lse)
  float* lse;             // [B, Hq] log-sum-exp, or null
  int n_seg, total_splits, B, Hkv, rep, D, dtype;
  int G, gshift;          // scale groups per head; log2(D / G)
  float sm_scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 256;   // tokens per tile, at most
constexpr int kTileBytes = 16384;  // bytes of K (and of V) rows per tile
constexpr int kGroupedScales = 1024;  // G x tokens per scale array (G > 1)
constexpr int kMaxSplits = 64;     // splits per (batch row, kv head)
constexpr int kMaxRep = 16;
constexpr float kNegInf = -INFINITY;

// Shared memory (dynamic): [2 buffers][K | V] tile bytes; [2][4][scale
// floats] (k scale, k zero, v scale, v zero per tile token and group);
// q [REP][D]; scores [REP][kTileTokens]; the tile tokens' masks [2][256].
template <bool kGrouped>
__host__ __device__ constexpr int scale_floats() {
  return kGrouped ? kGroupedScales : kTileTokens;
}

constexpr int kStageBytes = 2 * 2 * kTileBytes;

template <int REP, bool kGrouped>
__host__ __device__ constexpr int smem_bytes_fixed() {
  return kStageBytes + 2 * 4 * scale_floats<kGrouped>() * 4 +
         REP * kTileTokens * 4 + 2 * kTileTokens * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Code e (0..3) of a word whose bytes each hold one code in their low bits,
// as an exact float: the byte becomes the float 2^23 + u (bits 0x4B0000uu)
// and 2^23 is subtracted; no int-to-float conversion.
__device__ __forceinline__ float code_f(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | e)) -
         8388608.f;
}

template <int BITS>
__device__ __forceinline__ uint32_t code_mask() {
  return BITS == 8 ? 0xFFFFFFFFu : BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
}

// Four consecutive raw values of type T at `src` as floats.
__device__ __forceinline__ void load4_raw(const float* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4_raw(const __nv_bfloat16* src,
                                          float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(src);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}

// Everything a block's passes share.
struct Ctx {
  const DecodeSegment* sg;
  int b, h, H, D, G, gshift;
  int row_bytes;       // K (or V) bytes per stored row
  uint8_t* stage;      // [2][K | V][kTileBytes]
  float* scales;       // [2][4][scale floats]
  int scale_floats;
  float* sq;           // [REP][D], interleaved: see sq_index
  float* sp;           // [REP][kTileTokens]
  int* sok;            // [2][kTileTokens]
  int qpos, ring_len;
};

// Where q[r][d] lies in sq: lane li of a row reads channels 16 li + 4 i ..
// + 3 as one float4 for each i, so the float4s of one (r, i) lie side by
// side in lane order ([REP][4][D / 16][4]) and a row's lanes read
// consecutive 16-byte words (no bank conflict).
__device__ __forceinline__ int sq_index(int r, int d, int D) {
  return (r * 4 + (d % 16) / 4) * (D / 4) + (d / 16) * 4 + d % 4;
}

// One tile: byte rows r0 .. r0 + nrows - 1 of chunk c of the segment. Tile
// token tt = j * nrows + (r - r0) is token j of row r.
struct Tile {
  int r0, nrows, c;
};

__device__ __forceinline__ int tile_per(const DecodeSegment& sg) {
  return sg.bits == 16 ? 1 : 8 / sg.bits;
}

// Token index of tile token tt, or -1 past the chunk's end.
__device__ __forceinline__ int tile_token(const DecodeSegment& sg,
                                          const Tile& t, int tt) {
  const int j = tt / t.nrows, rr = tt - j * t.nrows;
  const int local = t.r0 + rr - t.c * sg.rows_per_chunk +
                    j * sg.rows_per_chunk;
  return local < sg.chunk ? t.c * sg.chunk + local : -1;
}

// All threads: the tile's rows of K and V and, for a packed segment, its
// tokens' scales into buffer `buf`, by cp.async (one commit group).
__device__ __forceinline__ void issue_tile(const Ctx& x, const Tile& t,
                                           int buf) {
  const DecodeSegment& sg = *x.sg;
  uint8_t* sk = x.stage + buf * 2 * kTileBytes;
  uint8_t* sv = sk + kTileBytes;
  const int upr = x.row_bytes / 16;  // a power of two
  const int ushift = __ffs(upr) - 1;
  const char* kb = static_cast<const char*>(sg.k);
  const char* vb = static_cast<const char*>(sg.v);
  for (int u = threadIdx.x; u < t.nrows * upr; u += kThreads) {
    const int r = u >> ushift, uu = u & (upr - 1);
    const long long off =
        ((x.b * sg.rows + t.r0 + r) * x.H + x.h) *
            static_cast<long long>(x.row_bytes) + uu * 16;
    cp_async16(sk + r * x.row_bytes + uu * 16, kb + off);
    cp_async16(sv + r * x.row_bytes + uu * 16, vb + off);
  }
  if (sg.bits != 16) {
    float* sc = x.scales + buf * 4 * x.scale_floats;
    const int ntok = tile_per(sg) * t.nrows;
    const int gshift = __ffs(x.G) - 1;  // G is a power of two
    for (int i = threadIdx.x; i < ntok * x.G; i += kThreads) {
      const int tt = i >> gshift, g = i & (x.G - 1);
      const int tok = tile_token(sg, t, tt);
      if (tok < 0) {  // never attended: finite placeholders
#pragma unroll
        for (int a = 0; a < 4; ++a) sc[a * x.scale_floats + i] = 0.f;
        continue;
      }
      const long long src =
          ((static_cast<long long>(x.b) * sg.n + tok) * x.H + x.h) * x.G + g;
      cp_async4(sc + i, sg.k_scale + src);
      cp_async4(sc + x.scale_floats + i, sg.k_zp + src);
      cp_async4(sc + 2 * x.scale_floats + i, sg.v_scale + src);
      cp_async4(sc + 3 * x.scale_floats + i, sg.v_zp + src);
    }
  }
  cp_async_commit();
}

// What thread tt needs for tile token tt's mask, loaded ahead of use.
struct Meta {
  int tok, pos, valid;
};

__device__ __forceinline__ Meta load_meta(const Ctx& x, const Tile& t) {
  const DecodeSegment& sg = *x.sg;
  Meta m{-1, 0, 0};
  if (threadIdx.x < tile_per(sg) * t.nrows) {
    m.tok = tile_token(sg, t, threadIdx.x);
    if (m.tok >= 0) {
      const long long bt = static_cast<long long>(x.b) * sg.n + m.tok;
      m.pos = sg.pos[bt];
      m.valid = sg.valid ? sg.valid[bt] : 1;
    }
  }
  return m;
}

__device__ __forceinline__ void store_meta(const Ctx& x, const Meta& m,
                                           int buf) {
  if (threadIdx.x >= kTileTokens) return;
  const bool live = m.tok >= 0 && m.valid != 0 &&
                    (x.sg->valid != nullptr || m.tok < x.ring_len);
  x.sok[buf * kTileTokens + threadIdx.x] = live && m.pos <= x.qpos;
}

// Pass 1: the tile's scores into sp[rep][tt] (-inf where masked).
template <typename T, int REP, bool kGrouped, int BITS>
__device__ __forceinline__ void score_tile(const Ctx& x, const Tile& t,
                                           int buf, const float* sqsum,
                                           float sm_scale) {
  constexpr int PER = BITS == 16 ? 1 : 8 / BITS;
  const int L = x.D / 16;  // lanes per row: 16 channels each
  const int li = threadIdx.x & (L - 1), slot = threadIdx.x / L;
  const int RS = kThreads / L;
  const uint8_t* sk = x.stage + buf * 2 * kTileBytes;
  float* sc = x.scales + buf * 4 * x.scale_floats;
  float* svsc = sc + 2 * x.scale_floats;
  float* svzp = sc + 3 * x.scale_floats;
  const int* ok = x.sok + buf * kTileTokens;
  const int d0 = li * 16;
  for (int base = 0; base < t.nrows; base += RS) {
    const int r = base + slot;
    const bool live = r < t.nrows;
    float dot[PER][REP];
#pragma unroll
    for (int j = 0; j < PER; ++j)
#pragma unroll
      for (int q = 0; q < REP; ++q) dot[j][q] = 0.f;
    if (live) {
      if constexpr (BITS == 16) {
        const T* kr = reinterpret_cast<const T*>(sk + r * x.row_bytes) + d0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float kv[4];
          load4_raw(kr + 4 * i, kv);
#pragma unroll
          for (int q = 0; q < REP; ++q) {
            const float4 q4 = *reinterpret_cast<const float4*>(
                x.sq + sq_index(q, d0 + 4 * i, x.D));
            dot[0][q] = fmaf(q4.x, kv[0], dot[0][q]);
            dot[0][q] = fmaf(q4.y, kv[1], dot[0][q]);
            dot[0][q] = fmaf(q4.z, kv[2], dot[0][q]);
            dot[0][q] = fmaf(q4.w, kv[3], dot[0][q]);
          }
        }
      } else {
        const uint4 w4 = *reinterpret_cast<const uint4*>(sk + r * x.D + d0);
        const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float cv[PER][4];
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const uint32_t cw = (words[i] >> (j * BITS)) & code_mask<BITS>();
#pragma unroll
            for (int e = 0; e < 4; ++e) cv[j][e] = code_f(cw, e);
            if constexpr (kGrouped) {
              const int g = (d0 + 4 * i) >> x.gshift;
              const int si = (j * t.nrows + r) * x.G + g;
              const float s = sc[si], z = sc[x.scale_floats + si];
#pragma unroll
              for (int e = 0; e < 4; ++e) cv[j][e] = (cv[j][e] - z) * s;
            }
          }
#pragma unroll
          for (int q = 0; q < REP; ++q) {
            const float4 q4 = *reinterpret_cast<const float4*>(
                x.sq + sq_index(q, d0 + 4 * i, x.D));
#pragma unroll
            for (int j = 0; j < PER; ++j) {
              dot[j][q] = fmaf(q4.x, cv[j][0], dot[j][q]);
              dot[j][q] = fmaf(q4.y, cv[j][1], dot[j][q]);
              dot[j][q] = fmaf(q4.z, cv[j][2], dot[j][q]);
              dot[j][q] = fmaf(q4.w, cv[j][3], dot[j][q]);
            }
          }
        }
      }
    }
    // The row's L lanes (aligned, inside one warp) sum their dots.
    for (int o = 1; o < L; o <<= 1)
#pragma unroll
      for (int j = 0; j < PER; ++j)
#pragma unroll
        for (int q = 0; q < REP; ++q)
          dot[j][q] += __shfl_xor_sync(0xffffffffu, dot[j][q], o);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int tt = j * t.nrows + r;
      const bool tok_ok = ok[tt] != 0;
      float ksc = 1.f, kzp = 0.f;
      if constexpr (BITS != 16 && !kGrouped) {
        ksc = sc[tt];
        kzp = sc[x.scale_floats + tt];
      }
#pragma unroll
      for (int q = 0; q < REP; ++q) {
        // The writes spread over the lanes (L is a power of two).
        if (((j * REP + q) & (L - 1)) != li) continue;
        float s = dot[j][q];
        if constexpr (BITS != 16 && !kGrouped) s = (s - sqsum[q] * kzp) * ksc;
        x.sp[q * kTileTokens + tt] = tok_ok ? s * sm_scale : kNegInf;
      }
      if constexpr (BITS != 16 && kGrouped) {
        // A masked token's V scales may be anything: make them (1, 0), so
        // that its zero weight meets finite values in pass 3.
        if (!tok_ok) {
          for (int g = d0 >> x.gshift; g <= (d0 + 15) >> x.gshift; ++g) {
            svsc[tt * x.G + g] = 1.f;
            svzp[tt * x.G + g] = 0.f;
          }
        }
      }
    }
  }
}

// Pass 2: online softmax over the tile, one warp per query head. sp
// becomes the weights (times the V scale for G = 1 packed segments);
// sm / sl / scorr carry the running max, sum and rank-1 correction, and
// salpha the factor that rescales the value sums.
template <int REP, bool kGrouped>
__device__ __forceinline__ void softmax_tile(const Ctx& x, int ntok,
                                             int buf, bool packed,
                                             float* sm, float* sl,
                                             float* scorr, float* salpha) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* sc = x.scales + buf * 4 * x.scale_floats;
  const float* svsc = sc + 2 * x.scale_floats;
  const float* svzp = sc + 3 * x.scale_floats;
  const bool rank1 = packed && !kGrouped;
  for (int q = warp; q < REP; q += kWarps) {
    float* s = x.sp + q * kTileTokens;
    float mx = kNegInf;
    for (int tt = lane; tt < ntok; tt += 32) mx = fmaxf(mx, s[tt]);
    mx = rkv::warp_max(mx);
    const float m_old = sm[q];
    const float m_new = fmaxf(m_old, mx);
    const float alpha = m_new == kNegInf ? 1.f : expf(m_old - m_new);
    float l = 0.f, corr = 0.f;
    for (int tt = lane; tt < ntok; tt += 32) {
      const bool live = s[tt] != kNegInf;
      float e = live ? expf(s[tt] - m_new) : 0.f;
      l += e;
      if (rank1 && live) {
        e *= svsc[tt];
        corr = fmaf(e, svzp[tt], corr);
      }
      s[tt] = e;
    }
    l = rkv::warp_sum(l);
    corr = rkv::warp_sum(corr);
    if (lane == 0) {
      sm[q] = m_new;
      sl[q] = fmaf(sl[q], alpha, l);
      scorr[q] = fmaf(scorr[q], alpha, corr);
      salpha[q] = alpha;
    }
  }
}

// Pass 3: the tile's weighted values into this thread's sums (four
// channels, every query head).
template <typename T, int REP, bool kGrouped, int BITS>
__device__ __forceinline__ void value_tile(const Ctx& x, const Tile& t,
                                           int buf, float (&acc)[REP][4]) {
  constexpr int PER = BITS == 16 ? 1 : 8 / BITS;
  const int Q = x.D / 4;
  const int cq = threadIdx.x % Q, slot = threadIdx.x / Q;
  const int RS = kThreads / Q;
  const uint8_t* sv = x.stage + buf * 2 * kTileBytes + kTileBytes;
  const float* sc = x.scales + buf * 4 * x.scale_floats;
  const float* svsc = sc + 2 * x.scale_floats;
  const float* svzp = sc + 3 * x.scale_floats;
  const int g = (4 * cq) >> x.gshift;
  for (int r = slot; r < t.nrows; r += RS) {
    if constexpr (BITS == 16) {
      float v[4];
      load4_raw(reinterpret_cast<const T*>(sv + r * x.row_bytes) + 4 * cq, v);
#pragma unroll
      for (int q = 0; q < REP; ++q) {
        const float p = x.sp[q * kTileTokens + r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(p, v[e], acc[q][e]);
      }
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(sv + r * x.D +
                                                            4 * cq);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int tt = j * t.nrows + r;
        const uint32_t cw = (w >> (j * BITS)) & code_mask<BITS>();
        float cv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) cv[e] = code_f(cw, e);
        if constexpr (kGrouped) {
          const float s = svsc[tt * x.G + g], z = svzp[tt * x.G + g];
#pragma unroll
          for (int e = 0; e < 4; ++e) cv[e] = (cv[e] - z) * s;
        }
#pragma unroll
        for (int q = 0; q < REP; ++q) {
          const float p = x.sp[q * kTileTokens + tt];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(p, cv[e], acc[q][e]);
        }
      }
    }
  }
}

template <typename T, int REP, bool kGrouped>
__device__ __forceinline__ void run_tile(const Ctx& x, const Tile& t,
                                         int buf, float (&acc)[REP][4],
                                         const float* sqsum, float sm_scale,
                                         float* sm, float* sl, float* scorr,
                                         float* salpha) {
  const int bits = x.sg->bits;
  switch (bits) {
    case 2: score_tile<T, REP, kGrouped, 2>(x, t, buf, sqsum, sm_scale); break;
    case 4: score_tile<T, REP, kGrouped, 4>(x, t, buf, sqsum, sm_scale); break;
    case 8: score_tile<T, REP, kGrouped, 8>(x, t, buf, sqsum, sm_scale); break;
    default: score_tile<T, REP, kGrouped, 16>(x, t, buf, sqsum, sm_scale);
  }
  __syncthreads();
  softmax_tile<REP, kGrouped>(x, (bits == 16 ? 1 : 8 / bits) * t.nrows, buf,
                              bits != 16, sm, sl, scorr, salpha);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < REP; ++q) {
    const float a = salpha[q];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] *= a;
  }
  switch (bits) {
    case 2: value_tile<T, REP, kGrouped, 2>(x, t, buf, acc); break;
    case 4: value_tile<T, REP, kGrouped, 4>(x, t, buf, acc); break;
    case 8: value_tile<T, REP, kGrouped, 8>(x, t, buf, acc); break;
    default: value_tile<T, REP, kGrouped, 16>(x, t, buf, acc);
  }
  __syncthreads();
}

// kGrouped: per-element dequantization with [G][tokens] scale rows (G > 1
// scale groups per head, or float32 at any G); the other instance keeps
// the rank-1 arithmetic.
// Two blocks per SM (128 registers) where the sums fit; the 16-head
// instances and the grouped 8-head ones take up to 255 registers.
template <typename T, int REP, bool kGrouped>
__global__ void __launch_bounds__(kThreads,
                                  REP >= 16 || (kGrouped && REP >= 8) ? 1 : 2)
decode_attention_kernel(const __grid_constant__ DecodeParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sqsum[REP], sm[REP], sl[REP], scorr[REP], salpha[REP];
  __shared__ int s_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, H = p.Hkv, D = p.D;
  int si = 0;
  for (int i = 1; i < p.n_seg; ++i)
    if (split >= p.seg[i].split_start) si = i;
  const DecodeSegment& sg = p.seg[si];

  Ctx x;
  x.sg = &sg;
  x.b = b;
  x.h = h;
  x.H = H;
  x.D = D;
  x.G = p.G;
  x.gshift = p.gshift;
  x.row_bytes = sg.bits == 16 ? D * static_cast<int>(sizeof(T)) : D;
  x.stage = smem;
  x.scale_floats = scale_floats<kGrouped>();
  x.scales = reinterpret_cast<float*>(smem + kStageBytes);
  x.sp = x.scales + 2 * 4 * x.scale_floats;
  x.sok = reinterpret_cast<int*>(x.sp + REP * kTileTokens);
  x.sq = reinterpret_cast<float*>(x.sok + 2 * kTileTokens);

  // This split's byte rows, walked in tiles that never cross a chunk.
  const int R = sg.rows_per_chunk;
  const int row_begin = (split - sg.split_start) * sg.rows_per_split;
  const int row_end = static_cast<int>(
      min(sg.rows, static_cast<long long>(row_begin) + sg.rows_per_split));
  auto tile_at = [&](int r0) {
    const int c = r0 / R;
    return Tile{r0, min(min(r0 + sg.tile_rows, (c + 1) * R), row_end) - r0, c};
  };

  // Tile 0's copies and masks are in flight while q is staged.
  Meta meta{-1, 0, 0};
  if (row_begin < row_end) {
    const Tile t0 = tile_at(row_begin);
    issue_tile(x, t0, 0);
    meta = load_meta(x, t0);
  }
  x.qpos = p.q_pos[b];
  x.ring_len = sg.length ? sg.length[b] : 0;
  const T* q = static_cast<const T*>(p.q);
  const int rep = p.rep;
  for (int i = tid; i < REP * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    x.sq[sq_index(r, d, D)] =
        r < rep ? to_f(q[(static_cast<long long>(b) * H * rep + h * rep + r) *
                             D + d])
                : 0.f;
  }
  if (tid < REP) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
    scorr[tid] = 0.f;
  }
  __syncthreads();
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < REP; r += kWarps) {
      float s = 0.f;
      // Row r's D values fill sq[r D .. (r + 1) D) in some order.
      for (int d = lane; d < D; d += 32) s += x.sq[r * D + d];
      s = rkv::warp_sum(s);
      if (lane == 0) sqsum[r] = s;
    }
  }

  float acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  int buf = 0;
  for (int r0 = row_begin; r0 < row_end;) {
    const Tile t = tile_at(r0);
    store_meta(x, meta, buf);
    const bool more = t.r0 + t.nrows < row_end;
    if (more) {
      const Tile tn = tile_at(t.r0 + t.nrows);
      issue_tile(x, tn, buf ^ 1);
      meta = load_meta(x, tn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    run_tile<T, REP, kGrouped>(x, t, buf, acc, sqsum, p.sm_scale, sm, sl,
                               scorr, salpha);
    r0 = t.r0 + t.nrows;
    buf ^= 1;
  }

  // The row slots' sums meet in the (now idle) staging buffers, in slot
  // order; then this split's partial.
  __syncthreads();
  const int Q = D / 4, RS = kThreads / Q, cq = tid % Q, slot = tid / Q;
  float* red = reinterpret_cast<float*>(smem);  // [RS][REP][D]
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(slot * REP + r) * D + 4 * cq + e] = acc[r][e];
  __syncthreads();
  const long long bh = static_cast<long long>(b) * H + h;
  const long long part = bh * p.total_splits + split;
  for (int i = tid; i < REP * D; i += kThreads) {
    const int r = i / D;
    float s = 0.f;
    for (int k = 0; k < RS; ++k) s += red[k * REP * D + i];
    p.part_acc[part * REP * D + i] = s - scorr[r];
  }
  if (tid < REP) {
    p.part_m[part * REP + tid] = sm[tid];
    p.part_l[part * REP + tid] = sl[tid];
  }

  // The last block of this (batch row, kv head) merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&p.ticket[bh], 1) == p.total_splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int S = p.total_splits;
  float* sw = reinterpret_cast<float*>(smem);  // [S][REP] weights
  float* sL = sw + kMaxSplits * REP;           // [REP]
  float* sM = sL + REP;                        // [REP]
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < REP; r += kWarps) {
      float M = kNegInf;
      for (int s = lane; s < S; s += 32)
        M = fmaxf(M, __ldcg(&p.part_m[(bh * S + s) * REP + r]));
      M = rkv::warp_max(M);
      float L = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float ms = __ldcg(&p.part_m[(bh * S + s) * REP + r]);
        const float w = ms == kNegInf ? 0.f : expf(ms - M);
        sw[s * REP + r] = w;
        L = fmaf(w, __ldcg(&p.part_l[(bh * S + s) * REP + r]), L);
      }
      L = rkv::warp_sum(L);
      if (lane == 0) {
        sL[r] = L;
        sM[r] = M;
      }
    }
  }
  __syncthreads();
  // Four channels a thread, eight splits' partials loaded before their
  // products (the sum stays in split order).
  T* out = static_cast<T*>(p.out);
  const int D4 = D / 4;
  for (int i = tid; i < rep * D4; i += kThreads) {
    const int r = i / D4, d4 = i - r * D4;
    const float4* src = reinterpret_cast<const float4*>(p.part_acc) +
                        (bh * S * REP + r) * D4 + d4;
    const long long stride = static_cast<long long>(REP) * D4;
    float O[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < S; s0 += 8) {
      float4 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = s0 + u < S ? __ldcg(src + (s0 + u) * stride)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u >= S) break;
        const float w = sw[(s0 + u) * REP + r];
        O[0] = fmaf(w, a[u].x, O[0]);
        O[1] = fmaf(w, a[u].y, O[1]);
        O[2] = fmaf(w, a[u].z, O[2]);
        O[3] = fmaf(w, a[u].w, O[3]);
      }
    }
    const float L = sL[r];
    const long long o = (bh * rep + r) * D + 4 * d4;
    if (p.lse) {
      // The partial of a slot shard: O / L kept in float32, rounded once
      // after the ranks' partials merge.
#pragma unroll
      for (int e = 0; e < 4; ++e)
        static_cast<float*>(p.out)[o + e] = L > 0.f ? O[e] / L : 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[o + e] = from_f<T>(L > 0.f ? O[e] / L : 0.f);
    }
  }
  if (p.lse && tid < rep)
    p.lse[bh * rep + tid] = sL[tid] > 0.f ? sM[tid] + logf(sL[tid]) : kNegInf;
  if (tid == 0) p.ticket[bh] = 0;  // ready for the next call
}

template <typename T, int REP, bool kGrouped>
cudaError_t launch_instance(const DecodeParams& p, cudaStream_t stream) {
  const int bytes = smem_bytes_fixed<REP, kGrouped>() + REP * p.D * 4;
  // Above 48 KB only after opting in to the largest size, once per
  // instance (the q rows at D = 256).
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      decode_attention_kernel<T, REP, kGrouped>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes_fixed<REP, kGrouped>() + REP * 256 * 4);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(p.total_splits, p.Hkv, p.B);
  decode_attention_kernel<T, REP, kGrouped>
      <<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// float32 dequantizes every code before its products, at any G: the
// rank-1 fold subtracts sum(q) zp_k and sum_t p_t sc_v,t zp_v,t from sums
// of codes of up to 255 scale steps, and at a trained model's logits that
// cancellation costs float32 the digits its parity with the plain version
// (dequantize, then attend) needs. bf16 outputs round far above it.
template <typename T, int REP>
cudaError_t launch_rep(const DecodeParams& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_instance<T, REP, true>(p, stream);
  } else {
    return p.G > 1 ? launch_instance<T, REP, true>(p, stream)
                   : launch_instance<T, REP, false>(p, stream);
  }
}

template <typename T>
cudaError_t launch_typed(const DecodeParams& p, cudaStream_t stream) {
  if (p.rep == 1) return launch_rep<T, 1>(p, stream);
  if (p.rep == 2) return launch_rep<T, 2>(p, stream);
  if (p.rep <= 4) return launch_rep<T, 4>(p, stream);
  if (p.rep <= 8) return launch_rep<T, 8>(p, stream);
  return launch_rep<T, 16>(p, stream);
}

bool segment_ok(const DecodeSegment& sg, const DecodeParams& p, int elem) {
  const int per = sg.bits == 16 ? 1 : 8 / sg.bits;
  const int row_bytes = sg.bits == 16 ? p.D * elem : p.D;
  const int tokens = per * sg.tile_rows;
  return (sg.bits == 2 || sg.bits == 4 || sg.bits == 8 || sg.bits == 16) &&
         sg.tile_rows > 0 && sg.rows_per_split > 0 &&
         sg.rows_per_chunk > 0 && tokens <= kTileTokens &&
         sg.tile_rows * row_bytes <= kTileBytes &&
         (p.G == 1 || sg.bits == 16 || tokens * p.G <= kGroupedScales);
}

}  // namespace

// The tile and split limits above, which the wrapper plans by
// (ops/cuda/decode_attention.py reads them here; the launch checks them).
struct DecodeLimits {
  int tile_tokens, tile_bytes, grouped_scales, max_splits;
};

extern "C" int decode_attention_limits(DecodeLimits* out) {
  *out = {kTileTokens, kTileBytes, kGroupedScales, kMaxSplits};
  return 0;
}

extern "C" int decode_attention_launch(const DecodeParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->rep < 1 || p->rep > kMaxRep || p->n_seg < 1 ||
      p->n_seg > kMaxSegments || p->total_splits < 1 ||
      p->total_splits > kMaxSplits || p->G < 1 ||
      !(p->D == 16 || p->D == 32 || p->D == 64 || p->D == 128 ||
        p->D == 256) ||
      (p->D >> p->gshift) != p->G || (p->D >> p->gshift) << p->gshift != p->D ||
      (p->G > 1 && p->gshift < 3) || p->ticket == nullptr ||
      p->q == nullptr || p->q_pos == nullptr || p->out == nullptr ||
      reinterpret_cast<uintptr_t>(p->lse) % alignof(float) != 0)
    return cudaErrorInvalidValue;
  const int elem = p->dtype == rkv::kFloat32 ? 4 : 2;
  for (int i = 0; i < p->n_seg; ++i)
    if (!segment_ok(p->seg[i], *p, elem)) return cudaErrorInvalidValue;
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
