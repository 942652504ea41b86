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
// rows, token t sits in byte row floor(t / C) * R + (t mod C) mod R at bit
// offset floor((t mod C) / R) * bits. Codes are unpacked here. With one
// scale per (token, kv head), G = 1, the affine folds into rank-1
// corrections:
//   s = (q.c - sum(q) * zp_k) * sc_k * sm_scale
//   o = sum_t p_t sc_v,t c_t - sum_t p_t sc_v,t zp_v,t
// With G > 1 groups of gs = D / G channels (a power of two, at least 8)
// each code is dequantized in registers, (c - zp_g) * sc_g, before its
// products: the same function as the reference's per-channel expansion
// (decode_attention.py:195-200, :230-234), summed in another order.
// The only mask is stored position <= query position; invalid tier and
// pool slots and ring slots at or past the ring length are skipped.
//
// Grid: the TPU walks segments in order in one program per batch row, which
// on this card would leave 131 of 132 SMs idle at batch 1. Here the token
// axis of every pool is cut into splits of 128 tokens and the grid is
// (splits, kv heads, batch): each block scores its tokens for all n_rep
// query heads of its kv head, keeps a partial (m, l, acc) per head, and a
// second small kernel merges the partials by log-sum-exp. head_dim 16 to
// 256: up to 128 each thread of the value pass owns one channel, at 256
// two (PvShape), so 128 threads cover every channel at every width.
// Bound: bytes. Per kv head and token it reads D * bits / 8 code bytes of K
// and of V plus 16 bytes of float32 scale and zero point, so at 2 bits and
// D = 64 the scales weigh as much as the codes. Each token's code row is
// read once per block with 16-byte loads; the scales once per token.

#include <cstdint>

#include "common.cuh"

using rkv::from_f;
using rkv::to_f;

// One pool of the walk (a tier or the ring). Mirrored by a ctypes
// Structure in ops/cuda/decode_attention.py.
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
  int chunk;              // packing chunk C
  int rows_per_chunk;     // R
  int split_start;        // first split of this segment
  int n_splits;
};

constexpr int kMaxSegments = 5;  // HIGH, MID, LOW, decode pool, ring

struct DecodeParams {
  DecodeSegment seg[kMaxSegments];
  const void* q;          // [B, Hq, D]
  const int* q_pos;       // [B]
  float* part_acc;        // [B, Hkv, splits, rep, D]
  float* part_m;          // [B, Hkv, splits, rep]
  float* part_l;
  void* out;              // [B, Hq, D], q dtype
  int n_seg, total_splits, B, Hkv, rep, D, dtype;
  int G, gshift;          // scale groups per head; log2(D / G)
  float sm_scale;
};

namespace {

constexpr int kTile = 128;     // tokens per split == threads per block
constexpr int kThreads = 128;
constexpr int kMaxRep = 16;    // query heads per kv head

// Byte offset of token `tok`'s packed code row (kv head h) in a segment's
// [B, rows, H, D] code array, and the token's bit offset in those bytes.
__device__ __forceinline__ long long code_offset(const DecodeSegment& sg,
                                                 int b, int h, int H, int D,
                                                 int tok, int* shift) {
  const int c = tok / sg.chunk, tc = tok - c * sg.chunk;
  const int row = c * sg.rows_per_chunk + tc % sg.rows_per_chunk;
  *shift = (tc / sg.rows_per_chunk) * sg.bits;
  return ((b * sg.rows + row) * H + h) * static_cast<long long>(D);
}

// Channels per thread and token groups of the PV pass (pass 3): up to
// D = 128 one channel per thread and kThreads / D token groups summed in
// shared memory; at D = 256 two channels per thread and one group.
template <int D>
struct PvShape {
  static constexpr int kChan = D > kThreads ? D / kThreads : 1;
  static constexpr int kDT = D / kChan;         // threads over one token
  static constexpr int kGroups = kThreads / kDT;
};

// V scales and zero points per scale group and token, [kMaxG][kTile] each,
// in dynamic shared memory (16 KB at D = 128 with G > 1, 32 KB at 256).
template <int D, bool kGrouped>
constexpr int scale_rows_bytes() {
  return 2 * (kGrouped ? D / 8 : 1) * kTile * 4;
}

// kGrouped: G > 1 scale groups per head. The G = 1 instance keeps one V
// scale row per block and the rank-1 arithmetic; only the grouped instance
// holds [G][kTile] rows, so G = 1 occupancy is unchanged.
template <typename T, int D, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const DecodeParams p) {
  constexpr int kChan = PvShape<D>::kChan, kDT = PvShape<D>::kDT;
  constexpr int kGroups = PvShape<D>::kGroups;  // token groups in the PV pass
  constexpr int kMaxG = kGrouped ? D / 8 : 1;  // groups of >= 8 channels
  __shared__ __align__(16) float sq[kMaxRep][D];
  __shared__ float sqsum[kMaxRep];
  __shared__ float sp[kMaxRep][kTile];   // scores, then p (* v_scale if G=1)
  extern __shared__ float s_scales[];    // V zero points / scales per group
  float (*svzp)[kTile] = reinterpret_cast<float (*)[kTile]>(s_scales);
  float (*svsc)[kTile] =
      reinterpret_cast<float (*)[kTile]>(s_scales + kMaxG * kTile);
  __shared__ float sred[kGroups > 1 ? kMaxRep : 1][kThreads];
  __shared__ float sm[kMaxRep], sl[kMaxRep], scorr[kMaxRep];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, H = p.Hkv, rep = p.rep;
  int si = 0;
  for (int i = 1; i < p.n_seg; ++i)
    if (split >= p.seg[i].split_start) si = i;
  const DecodeSegment& sg = p.seg[si];
  const int t0 = (split - sg.split_start) * kTile;
  const int nt = min(kTile, sg.n - t0);
  const int qpos = p.q_pos[b];
  const bool raw = sg.bits == 16;
  constexpr bool grouped = kGrouped;
  const int hq0 = h * rep;

  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sq[r][d] = to_f(q[(static_cast<long long>(b) * H * rep + hq0 + r) * D + d]);
  }
  __syncthreads();
  if (tid < rep) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += sq[tid][d];
    sqsum[tid] = s;
  }
  __syncthreads();

  // Pass 1: one thread per token scores it for every query head.
  {
    const int t = tid;
    bool ok = false;
    float dots[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) dots[r] = 0.f;
    float vsc = 0.f, vzp = 0.f;  // G = 1: this token's V scale and zero
    if (t < nt) {
      const int tok = t0 + t;
      const long long bt = static_cast<long long>(b) * sg.n + tok;
      const bool live = sg.valid ? sg.valid[bt] != 0 : tok < sg.length[b];
      ok = live && sg.pos[bt] <= qpos;
    }
    if (ok) {
      const int tok = t0 + t;
      const long long bth = (static_cast<long long>(b) * sg.n + tok) * H + h;
      if (raw) {
        const T* kr = static_cast<const T*>(sg.k) +
                      ((b * sg.rows + tok) * H + h) * static_cast<long long>(D);
        for (int d = 0; d < D; ++d) {
          const float kv = to_f(kr[d]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r)
            if (r < rep) dots[r] = fmaf(sq[r][d], kv, dots[r]);
        }
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) dots[r] *= p.sm_scale;
        vsc = 1.f;
      } else if (grouped) {
        int shift;
        const uint8_t* kr = static_cast<const uint8_t*>(sg.k) +
                            code_offset(sg, b, h, H, D, tok, &shift);
        const unsigned mask = (1u << sg.bits) - 1u;
        const float* ksc = sg.k_scale + bth * p.G;
        const float* kzp = sg.k_zp + bth * p.G;
        for (int d8 = 0; d8 < D; d8 += 8) {  // 8 channels lie in one group
          const uint2 w = *reinterpret_cast<const uint2*>(kr + d8);
          const uint32_t words[2] = {w.x, w.y};
          const int g = d8 >> p.gshift;
          const float sc = ksc[g], zp = kzp[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float c = static_cast<float>(
                ((words[e >> 2] >> (8 * (e & 3))) >> shift) & mask);
            const float kv = (c - zp) * sc;
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r)
              if (r < rep) dots[r] = fmaf(sq[r][d8 + e], kv, dots[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) dots[r] *= p.sm_scale;
        for (int g = 0; g < p.G; ++g) {
          svsc[g][t] = sg.v_scale[bth * p.G + g];
          svzp[g][t] = sg.v_zp[bth * p.G + g];
        }
      } else {
        int shift;
        const uint8_t* kr = static_cast<const uint8_t*>(sg.k) +
                            code_offset(sg, b, h, H, D, tok, &shift);
        const unsigned mask = (1u << sg.bits) - 1u;
        for (int d16 = 0; d16 < D; d16 += 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(kr + d16);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float c = static_cast<float>(
                ((words[e >> 2] >> (8 * (e & 3))) >> shift) & mask);
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r)
              if (r < rep) dots[r] = fmaf(sq[r][d16 + e], c, dots[r]);
          }
        }
        const float ksc = sg.k_scale[bth], kzp = sg.k_zp[bth];
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) dots[r] = (dots[r] - sqsum[r] * kzp) * ksc * p.sm_scale;
        vsc = sg.v_scale[bth];
        vzp = sg.v_zp[bth];
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) sp[r][t] = ok ? dots[r] : -INFINITY;
    if (!grouped) {
      svsc[0][t] = vsc;
      svzp[0][t] = vzp;
    } else if (!ok || raw) {  // raw values pass (c - 0) * 1 unchanged
      for (int g = 0; g < p.G; ++g) {
        svsc[g][t] = 1.f;
        svzp[g][t] = 0.f;
      }
    }
  }
  __syncthreads();

  // Pass 2: per query head, max / exp / sum over the split (one warp each).
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rep; r += kThreads / 32) {
    float mx = -INFINITY;
    for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, sp[r][t]);
    mx = rkv::warp_max(mx);
    float l = 0.f, corr = 0.f;
    for (int t = lane; t < kTile; t += 32) {
      const float e = mx == -INFINITY ? 0.f : expf(sp[r][t] - mx);
      l += e;
      if (grouped) {  // V dequantizes per channel in pass 3
        sp[r][t] = e;
      } else {
        const float w = e * svsc[0][t];
        sp[r][t] = w;
        corr = fmaf(w, svzp[0][t], corr);
      }
    }
    l = rkv::warp_sum(l);
    corr = rkv::warp_sum(corr);
    if (lane == 0) {
      sm[r] = mx;
      sl[r] = l;
      scorr[r] = corr;
    }
  }
  __syncthreads();

  // Pass 3: weighted sum of values; thread (token group g, channels
  // d0 + c kDT).
  const long long part = (static_cast<long long>(b) * H + h) * p.total_splits + split;
  {
    const int d0 = tid % kDT, g = tid / kDT;
    float acc[kChan][kMaxRep];
#pragma unroll
    for (int c = 0; c < kChan; ++c)
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) acc[c][r] = 0.f;
    for (int t = g; t < nt; t += kGroups) {
      const int tok = t0 + t;
#pragma unroll
      for (int c = 0; c < kChan; ++c) {
        const int d = d0 + c * kDT, cg = d >> p.gshift;
        float cv;
        if (raw) {
          const T* vr = static_cast<const T*>(sg.v) +
                        ((b * sg.rows + tok) * H + h) * static_cast<long long>(D);
          cv = to_f(vr[d]);
        } else {
          int shift;
          const uint8_t byte = static_cast<const uint8_t*>(sg.v)[
              code_offset(sg, b, h, H, D, tok, &shift) + d];
          cv = static_cast<float>((byte >> shift) & ((1u << sg.bits) - 1u));
        }
        if (grouped) cv = (cv - svzp[cg][t]) * svsc[cg][t];
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) acc[c][r] = fmaf(sp[r][t], cv, acc[c][r]);
      }
    }
    if constexpr (kGroups == 1) {  // each channel has one thread: no sum
#pragma unroll
      for (int c = 0; c < kChan; ++c)
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep)
            p.part_acc[(part * rep + r) * D + d0 + c * kDT] =
                acc[c][r] - scorr[r];
    } else {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) sred[r][tid] = acc[0][r];
    }
  }
  if constexpr (kGroups > 1) {
    __syncthreads();
    for (int i = tid; i < rep * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) s += sred[r][g * D + d];
      p.part_acc[(part * rep + r) * D + d] = s - scorr[r];
    }
  }
  if (tid < rep) {
    p.part_m[part * rep + tid] = sm[tid];
    p.part_l[part * rep + tid] = sl[tid];
  }
}

// Merges the splits of one (batch row, query head) by log-sum-exp.
template <typename T>
__global__ void decode_merge_kernel(const DecodeParams p) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const int Hq = p.Hkv * p.rep;
  const int b = bh / Hq, hq = bh % Hq, h = hq / p.rep, r = hq % p.rep;
  const long long base = (static_cast<long long>(b) * p.Hkv + h) * p.total_splits;
  float M = -INFINITY;
  for (int s = 0; s < p.total_splits; ++s)
    M = fmaxf(M, p.part_m[(base + s) * p.rep + r]);
  float L = 0.f, O = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < p.total_splits; ++s) {
      const long long ps = (base + s) * p.rep + r;
      const float ms = p.part_m[ps];
      if (ms == -INFINITY) continue;
      const float w = expf(ms - M);
      L = fmaf(w, p.part_l[ps], L);
      O = fmaf(w, p.part_acc[ps * p.D + d], O);
    }
  }
  static_cast<T*>(p.out)[static_cast<long long>(bh) * p.D + d] =
      from_f<T>(L > 0.f ? O / L : 0.f);
}

template <typename T, int D, bool kGrouped>
cudaError_t launch_instance(const DecodeParams& p, dim3 grid,
                            cudaStream_t stream) {
  constexpr int kBytes = scale_rows_bytes<D, kGrouped>();
  // The static arrays and the scale rows pass 48 KB at D = 256 with
  // G > 1: opt in to the dynamic size, once per instance.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      decode_split_kernel<T, D, kGrouped>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  decode_split_kernel<T, D, kGrouped><<<grid, kThreads, kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const DecodeParams& p, dim3 grid,
                         cudaStream_t stream) {
  return p.G > 1 ? launch_instance<T, D, true>(p, grid, stream)
                 : launch_instance<T, D, false>(p, grid, stream);
}

template <typename T>
cudaError_t launch_typed(const DecodeParams& p, cudaStream_t stream) {
  const dim3 grid(p.total_splits, p.Hkv, p.B);
  cudaError_t err;
  switch (p.D) {
    case 16: err = launch_split<T, 16>(p, grid, stream); break;
    case 32: err = launch_split<T, 32>(p, grid, stream); break;
    case 64: err = launch_split<T, 64>(p, grid, stream); break;
    case 128: err = launch_split<T, 128>(p, grid, stream); break;
    case 256: err = launch_split<T, 256>(p, grid, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<p.B * p.Hkv * p.rep, p.D, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_launch(const DecodeParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->rep < 1 || p->rep > kMaxRep || p->n_seg < 1 ||
      p->n_seg > kMaxSegments || p->G < 1 || (p->D >> p->gshift) != p->G ||
      (p->D >> p->gshift) << p->gshift != p->D || (p->G > 1 && p->gshift < 3))
    return cudaErrorInvalidValue;
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
