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
// type. Accumulation is float32. Ragged M, N and K/2 edges are masked here.
//
// Design (first version, right before fast); the weights never exist in
// device memory at more than their packed 0.5 bytes per element:
//  - Small M (decode, M <= 8) is bound by the packed weight bytes. Each
//    thread owns four columns (one 32-bit word of a packed row), walks its
//    block's range of packed rows, unpacks lo = p & 0xF and hi = p >> 4 of
//    the same byte, and keeps each group's partial dot of both halves in
//    float32; at each group boundary it adds part * s_g into the
//    accumulator. The -8 offset is subtracted from the code as it is
//    converted to float (exact), instead of the TPU kernel's rank-1
//    8 * sum(x_g) correction: it costs nothing here and avoids cancelling
//    two large sums. The grid splits the packed rows so that enough blocks
//    stream weights; float32 partials [split, M, N] are summed in order by
//    a second kernel, so results do not depend on scheduling.
//  - Large M (prefill) is bound by arithmetic. 64 x 128 output tiles, 256
//    threads of 4 x 8 outputs each; per step, 16 packed rows are staged in
//    shared memory with the matching x columns of both halves, and the
//    codes are unpacked and dequantized there ((u - 8) * s_g, once per
//    element for all 64 rows of the tile), so the inner loop is a plain
//    float32 FMA tile and works for any group size. Tensor cores
//    (mma.sync / wgmma), TMA and pipelining are later work.

#include <cstdint>

#include "common.cuh"

using rkv::from_f;
using rkv::to_f;

// Kernel arguments; mirrored by a ctypes Structure in ops/cuda/int4_matmul.py.
struct Int4MatmulParams {
  const void* x;
  const uint8_t* q;
  const float* scale;
  void* out;
  float* partial;  // [split, M, N] float32 scratch, small-M route only
  int M, N, KH;    // KH = K / 2 packed rows
  int gs;          // packed rows per scale group (KH when n_g == 1)
  int hi_off;      // scale-row offset of the high half's groups
  int split, dtype;
};

namespace {

constexpr int kSmallM = 8;
constexpr int kGemvThreads = 256;  // four columns each
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

// Small M: float32 partial sums of one packed-row range, four columns per
// thread.
template <typename T, int MT>
__global__ void __launch_bounds__(kGemvThreads)
int4_gemv_kernel(const Int4MatmulParams p) {
  const int n = (blockIdx.x * kGemvThreads + threadIdx.x) * 4;
  const int range = (p.KH + p.split - 1) / p.split;
  const int p0 = blockIdx.y * range;
  const int p1 = min(p.KH, p0 + range);
  const int K = 2 * p.KH;
  const bool vec = (p.N % 4) == 0;
  const T* x = static_cast<const T*>(p.x);
  float acc[MT][4] = {};
  if (n < p.N && p0 < p1) {
    float plo[MT][4] = {}, phi[MT][4] = {};
    int g = p0 / p.gs;
    int g_end = (g + 1) * p.gs;
    auto flush = [&](int grp) {
      float slo[4], shi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = n + j < p.N;
        slo[j] = in ? p.scale[static_cast<long long>(grp) * p.N + n + j] : 0.f;
        shi[j] = in ? p.scale[static_cast<long long>(grp + p.hi_off) * p.N + n + j]
                    : 0.f;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[m][j] += plo[m][j] * slo[j] + phi[m][j] * shi[j];
          plo[m][j] = 0.f;
          phi[m][j] = 0.f;
        }
    };
#pragma unroll 2
    for (int r = p0; r < p1; ++r) {
      if (r == g_end) {
        flush(g);
        ++g;
        g_end += p.gs;
      }
      const uint32_t word =
          load_packed(p.q + static_cast<long long>(r) * p.N, n, p.N, vec);
      float clo[4], chi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        clo[j] = code(word, 8 * j);
        chi[j] = code(word, 8 * j + 4);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < p.M) {
          const float xl = to_f(x[static_cast<long long>(m) * K + r]);
          const float xh = to_f(x[static_cast<long long>(m) * K + p.KH + r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            plo[m][j] = fmaf(xl, clo[j], plo[m][j]);
            phi[m][j] = fmaf(xh, chi[j], phi[m][j]);
          }
        }
      }
    }
    flush(g);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m < p.M && n + j < p.N)
        p.partial[(static_cast<long long>(blockIdx.y) * p.M + m) * p.N + n + j] =
            acc[m][j];
}

// Sum of the splits in order, rounded once to the output type.
template <typename T>
__global__ void int4_gemv_epilogue(const Int4MatmulParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long mn = static_cast<long long>(p.M) * p.N;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = 0; s < p.split; ++s) acc += p.partial[s * mn + i];
  static_cast<T*>(p.out)[i] = from_f<T>(acc);
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

template <typename T>
cudaError_t launch_typed(const Int4MatmulParams& p, cudaStream_t stream) {
  if (p.M <= kSmallM) {
    const dim3 grid((p.N + 4 * kGemvThreads - 1) / (4 * kGemvThreads), p.split);
    if (p.M == 1) int4_gemv_kernel<T, 1><<<grid, kGemvThreads, 0, stream>>>(p);
    else if (p.M == 2) int4_gemv_kernel<T, 2><<<grid, kGemvThreads, 0, stream>>>(p);
    else if (p.M <= 4) int4_gemv_kernel<T, 4><<<grid, kGemvThreads, 0, stream>>>(p);
    else int4_gemv_kernel<T, 8><<<grid, kGemvThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long mn = static_cast<long long>(p.M) * p.N;
    int4_gemv_epilogue<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                            stream>>>(p);
  } else {
    const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
    int4_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int int4_matmul_launch(const Int4MatmulParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->M <= 0 || p->N <= 0 || p->KH <= 0 || p->gs <= 0 || p->KH % p->gs)
    return cudaErrorInvalidValue;
  if (p->M <= kSmallM && (p->split <= 0 || p->partial == nullptr))
    return cudaErrorInvalidValue;
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
