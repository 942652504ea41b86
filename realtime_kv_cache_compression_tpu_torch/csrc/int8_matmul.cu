// K4: W8A8 matmul, int8 x int8 -> int32, scaled per row and per column.
//
// Replaces the TPU kernel `_mm_kernel` in
// realtime_kv_cache_compression_tpu/ops/pallas/int8_matmul.py (launched by
// `int8_matmul`, reached through `dynamic_int8_matmul`).
//
//   y[m, n] = float(sum_k x_q[m, k] * w_q[k, n]) * x_scale[m] * w_scale[n]
//
// Layout: x_q [M, K] int8 and w_q [K, N] int8, both row-major and
// contiguous; x_scale [M], w_scale [N] float32; y [M, N] float32 or bf16.
// The integer sum is exact; it converts to float32 with round-to-nearest
// (|acc| can pass 2^24 at K = 11008), then the two multiplies follow in
// that order, then one rounding to the output type: the reference's order,
// so the plain version agrees bit for bit.
//
// Design (first version, right before fast). Products run on __dp4a: four
// int8 pairs per instruction into an int32. dp4a wants four consecutive k
// of one column in one register, and w_q is row-major in k, so every
// thread reads a 4 x 4 byte square (four k rows, four columns, one 32-bit
// word per row) and transposes it in registers with __byte_perm.
//  - Small M (decode, M <= 8): bound by the weight bytes. Each thread owns
//    four columns; a block of 256 threads covers 1024 columns and one
//    k-range, and the grid splits K so that enough blocks stream weights.
//    Each block writes int32 partials [split, M, N]; a second kernel sums
//    the splits in order and applies the epilogue.
//  - Large M (prefill): bound by dp4a throughput. 128 x 128 output tiles, 256
//    threads of 8 x 8 outputs each, k-slabs of 32 staged in shared memory
//    as packed words (x row-major in k already; w transposed as above).
//    Tensor cores (mma.sync / wgmma with int8) and TMA are later work.
// Ragged M, N and K edges are masked here; the wrapper pads nothing.

#include <cstdint>

#include "common.cuh"

using rkv::from_f;

// Kernel arguments; mirrored by a ctypes Structure in ops/cuda/int8_matmul.py.
struct Int8MatmulParams {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  int* partial;  // [split, M, N] int32 scratch, small-M route only
  int M, N, K, split, dtype;
};

namespace {

constexpr int kSmallM = 8;
constexpr int kGemvThreads = 256;  // four columns each
constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;

// Bytes k..k+3 of a row of `n_cols` bytes at `row` (zeros past the end).
// `vec`: the row stride and base allow an aligned 32-bit load.
__device__ __forceinline__ int load4(const int8_t* row, int k, int n_cols,
                                     bool vec) {
  if (vec && k + 3 < n_cols) return *reinterpret_cast<const int*>(row + k);
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < n_cols)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + i])) << (8 * i);
  return static_cast<int>(word);
}

// Rows r0..r3 hold bytes of columns 0..3; returns one word per column
// holding that column's bytes of rows 0..3.
__device__ __forceinline__ void transpose4(int r0, int r1, int r2, int r3,
                                           int c[4]) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);
  const unsigned t2 = __byte_perm(r2, r3, 0x5140);
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = static_cast<int>(__byte_perm(t0, t2, 0x5410));
  c[1] = static_cast<int>(__byte_perm(t0, t2, 0x7632));
  c[2] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
  c[3] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
}

// Four consecutive columns n..n+3 of w rows k..k+3, one word per column.
__device__ __forceinline__ void load_w_square(const Int8MatmulParams& p,
                                              int k, int n, bool vec,
                                              int c[4]) {
  int r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = k + i < p.K
               ? load4(p.w + static_cast<long long>(k + i) * p.N, n, p.N, vec)
               : 0;
  transpose4(r[0], r[1], r[2], r[3], c);
}

template <typename T>
__device__ __forceinline__ void store_out(const Int8MatmulParams& p, int m,
                                          int n, int acc) {
  const float y = static_cast<float>(acc) * p.xs[m] * p.ws[n];
  static_cast<T*>(p.out)[static_cast<long long>(m) * p.N + n] = from_f<T>(y);
}

// Small M: int32 partial sums of one k-range for four columns per thread.
template <int MT>
__global__ void __launch_bounds__(kGemvThreads)
int8_gemv_kernel(const Int8MatmulParams p) {
  const int n = (blockIdx.x * kGemvThreads + threadIdx.x) * 4;
  const int range = (((p.K + p.split - 1) / p.split) + 3) / 4 * 4;
  const int k0 = blockIdx.y * range;
  const int k1 = min(p.K, k0 + range);
  const bool wvec = (p.N % 4) == 0;
  const bool xvec = (p.K % 4) == 0;
  int acc[MT][4] = {};
  if (n < p.N) {
#pragma unroll 4
    for (int k = k0; k < k1; k += 4) {
      int c[4];
      load_w_square(p, k, n, wvec, c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < p.M) {
          const int xw = load4(p.x + static_cast<long long>(m) * p.K, k, p.K,
                               xvec);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(xw, c[j], acc[m][j]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m < p.M && n + j < p.N)
        p.partial[(static_cast<long long>(blockIdx.y) * p.M + m) * p.N + n + j] =
            acc[m][j];
}

// Sum of the splits in order, then the epilogue.
template <typename T>
__global__ void int8_gemv_epilogue(const Int8MatmulParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long mn = static_cast<long long>(p.M) * p.N;
  if (i >= mn) return;
  int acc = 0;
  for (int s = 0; s < p.split; ++s) acc += p.partial[s * mn + i];
  store_out<T>(p, static_cast<int>(i / p.N), static_cast<int>(i % p.N), acc);
}

// Large M: one 128 x 128 output tile per block, 8 x 8 outputs per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_tiled_kernel(const Int8MatmulParams p) {
  __shared__ __align__(16) int sA[kBK / 4][kBM];  // x words, [k-word][m]
  __shared__ __align__(16) int sB[kBK / 4][kBN];  // w words, [k-word][n]
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool wvec = (p.N % 4) == 0;
  const bool xvec = (p.K % 4) == 0;
  int acc[8][8] = {};

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    __syncthreads();
    // x: 128 rows x 8 words, four words per thread.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int mm = e / (kBK / 4), kw = e % (kBK / 4);
      const int m = m0 + mm;
      sA[kw][mm] = m < p.M ? load4(p.x + static_cast<long long>(m) * p.K,
                                   k0 + 4 * kw, p.K, xvec)
                           : 0;
    }
    // w: 8 k-words x 32 column quads, one 4 x 4 square per thread.
    {
      const int kw = tid / (kBN / 4), cq = tid % (kBN / 4);
      int c[4];
      load_w_square(p, k0 + 4 * kw, n0 + 4 * cq, wvec, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) sB[kw][4 * cq + j] = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBK / 4; ++kw) {
      int a[8], b[8];
      const int4* ap = reinterpret_cast<const int4*>(&sA[kw][ty * 8]);
      const int4* bp = reinterpret_cast<const int4*>(&sB[kw][tx * 8]);
      const int4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (m < p.M && n < p.N) store_out<T>(p, m, n, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const Int8MatmulParams& p, cudaStream_t stream) {
  if (p.M <= kSmallM) {
    const dim3 grid((p.N + 4 * kGemvThreads - 1) / (4 * kGemvThreads), p.split);
    if (p.M == 1) int8_gemv_kernel<1><<<grid, kGemvThreads, 0, stream>>>(p);
    else if (p.M == 2) int8_gemv_kernel<2><<<grid, kGemvThreads, 0, stream>>>(p);
    else if (p.M <= 4) int8_gemv_kernel<4><<<grid, kGemvThreads, 0, stream>>>(p);
    else int8_gemv_kernel<8><<<grid, kGemvThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long mn = static_cast<long long>(p.M) * p.N;
    int8_gemv_epilogue<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                            stream>>>(p);
  } else {
    const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
    int8_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_matmul_launch(const Int8MatmulParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->M <= 0 || p->N <= 0 || p->K <= 0) return cudaErrorInvalidValue;
  if (p->M <= kSmallM && (p->split <= 0 || p->partial == nullptr))
    return cudaErrorInvalidValue;
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
