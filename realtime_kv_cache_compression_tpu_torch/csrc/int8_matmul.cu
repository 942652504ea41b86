// K4: W8A8 matmul, int8 x int8 -> int32, scaled per row and per column.
//
// Replaces the TPU kernel `_mm_kernel` in
// realtime_kv_cache_compression_tpu/ops/pallas/int8_matmul.py (launched by
// `int8_matmul`, reached through `dynamic_int8_matmul`).
//
//   y[m, n] = float(sum_k x_q[m, k] * w_q[k, n]) * x_scale[m] * w_scale[n]
//
// Layout: x_q [M, K] int8 and w_q [K, N] int8, both row-major and
// contiguous (w_q keeps the JAX package's layout: N-contiguous); x_scale
// [M], w_scale [N] float32; y [M, N] float32 or bf16. The integer sum is
// exact on every route, in any order; it converts to float32 with
// round-to-nearest (|acc| can pass 2^24 at K = 11008), then the two
// multiplies follow in that order, then one rounding to the output type:
// the reference's order, so every route equals the plain version bit for
// bit, in both output types. The wrapper picks one of three routes by
// shape (`_route`, ops/cuda/int8_matmul.py):
//
//  - kGemv, M <= 8 (decode): bound by the weight bytes. A block covers
//    32 x kCols columns (kCols = 16 at M <= 2: one 16-byte load per row
//    and thread) and a range of at most kMaxRange rows of k, which its
//    eight warps split into eight runs, four rows at a time, each batch's
//    loads issued before the previous batch's products. A thread
//    transposes each 4 x 4 byte square (four k rows, four columns) with
//    __byte_perm so that __dp4a takes four k of one column per
//    instruction; x of the block's range is staged as packed words. The
//    warps' int32 sums meet in shared memory; with split > 1 blocks over
//    K each block writes its int32 partial to scratch and the last block
//    of a column tile to arrive (a per-tile ticket, counted with
//    atomicAdd after a fence) sums the splits, applies the epilogue and
//    resets the ticket: one launch, no epilogue kernel. The scratch is the
//    wrapper's, cached per device and stream.
//  - kTensorCore, M > 8 where TMA can read x (K % 16 == 0, 16-byte
//    aligned bases) and W's rows take 16-byte loads (N % 16 == 0): int8
//    wgmma, bound by operations; see namespace tc below.
//  - kTile, every other M > 8: 128 x 128 output tiles of __dp4a, 256
//    threads of 8 x 8 outputs, k-slabs of 32 staged as packed words.
// Ragged M, N and K edges are masked here; the wrapper pads nothing.

#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

using rkv::from_f;

// Kernel arguments; mirrored by a ctypes Structure in ops/cuda/int8_matmul.py.
struct Int8MatmulParams {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  int* partial;  // [split, M, N] int32 scratch (kGemv with split > 1)
  int* ticket;   // [column tiles] int32 scratch, zero between calls
  int M, N, K;
  int split;     // kGemv: blocks over K
  int route;     // Route
  int dtype;
};

enum Route : int { kGemv = 0, kTile = 1, kTensorCore = 2 };

namespace {

constexpr int kSmallM = 8;
constexpr int kGemvThreads = 256;  // eight warps
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kMaxRange = 1024;    // k rows per kGemv block (GEMV_MAX_ROWS)
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

// The epilogue: float32(acc) * x_scale[m] * w_scale[n], one rounding.
template <typename T>
__device__ __forceinline__ void store_out(const Int8MatmulParams& p, int m,
                                          int n, int acc) {
  const float y = static_cast<float>(acc) * p.xs[m] * p.ws[n];
  static_cast<T*>(p.out)[static_cast<long long>(m) * p.N + n] = from_f<T>(y);
}

// kGemv's columns per thread: 16 (one uint4 of a row) at M <= 2; fewer at
// larger M, so that the int32 sums stay in registers (mirrored by
// gemv_block_cols in ops/cuda/int8_matmul.py).
template <int MT>
struct GemvShape {
  static constexpr int kCols = MT <= 2 ? 16 : 32 / MT;
  static constexpr int kBlockCols = 32 * kCols;
  // Shared memory: x [MT][kMaxRange / 4] words, then the warps' sums
  // [kGemvWarps][MT][kBlockCols] in the same ints.
  static constexpr int kXWords = MT * (kMaxRange / 4);
  static constexpr int kRedInts = kGemvWarps * MT * kBlockCols;
  static constexpr int kSmemInts = kXWords > kRedInts ? kXWords : kRedInts;
};

// C bytes (columns n .. n + C - 1) of a row as C / 4 words, zeros past the
// row's end; one 16-, 8- or 4-byte load where `vec` allows it.
template <int C>
__device__ __forceinline__ void load_row(const int8_t* row, int n, int n_cols,
                                         bool vec, int (&w)[C / 4]) {
  if (vec && n + C <= n_cols) {
    if constexpr (C == 16) {
      const int4 v = *reinterpret_cast<const int4*>(row + n);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (C == 8) {
      const int2 v = *reinterpret_cast<const int2*>(row + n);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const int*>(row + n);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < C / 4; ++i) w[i] = load4(row, n + 4 * i, n_cols, false);
}

// kGemv: see the header. Grid (column tiles, split).
template <typename T, int MT>
__global__ void __launch_bounds__(kGemvThreads)
int8_gemv_kernel(const Int8MatmulParams p) {
  constexpr int C = GemvShape<MT>::kCols, BC = GemvShape<MT>::kBlockCols;
  constexpr int kXStride = kMaxRange / 4;
  __shared__ __align__(16) int smem[GemvShape<MT>::kSmemInts];
  __shared__ int s_last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * BC + lane * C;
  // Ranges are whole quads of k rows (only the last may pass K).
  const int range = ((p.K + p.split - 1) / p.split + 3) / 4 * 4;
  const int k0 = min(p.K, static_cast<int>(blockIdx.y) * range);
  const int k1 = min(p.K, k0 + range);
  const int wrange = ((k1 - k0 + kGemvWarps - 1) / kGemvWarps + 3) / 4 * 4;
  const int w0 = min(k1, k0 + warp * wrange);
  const int w1 = min(k1, w0 + wrange);
  const bool vec = p.N % C == 0, xvec = p.K % 4 == 0;
  // Rows r .. r + 3 at this thread's columns, rows past K as zeros.
  auto load_quad = [&](int (&q)[4][C / 4], int r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r + i < p.K) {
        load_row<C>(p.w + static_cast<long long>(r + i) * p.N, n, p.N, vec,
                    q[i]);
      } else {
#pragma unroll
        for (int j = 0; j < C / 4; ++j) q[i][j] = 0;
      }
    }
  };
  // The first quad's weights are in flight while x is staged.
  int cur[4][C / 4] = {};
  if (n < p.N && w0 < w1) load_quad(cur, w0);

  // x of the block's rows as words of four k: sx[m * kXStride + (k - k0) / 4].
  int* sx = smem;
  const int nq = (k1 - k0 + 3) / 4;
  for (int i = threadIdx.x; i < MT * nq; i += kGemvThreads) {
    const int m = i / nq, q = i % nq;
    sx[m * kXStride + q] =
        m < p.M ? load4(p.x + static_cast<long long>(m) * p.K, k0 + 4 * q,
                        p.K, xvec)
                : 0;
  }
  __syncthreads();

  int acc[MT][C];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[m][j] = 0;
  if (n < p.N) {
    for (int r = w0; r < w1; r += 4) {
      // The next quad is loaded before this one's products.
      int next[4][C / 4] = {};
      if (r + 4 < w1) load_quad(next, r + 4);
#pragma unroll
      for (int cq = 0; cq < C / 4; ++cq) {
        int c[4];
        transpose4(cur[0][cq], cur[1][cq], cur[2][cq], cur[3][cq], c);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xw = sx[m * kXStride + (r - k0) / 4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m][4 * cq + j] = __dp4a(xw, c[j], acc[m][4 * cq + j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C / 4; ++j) cur[i][j] = next[i][j];
    }
  }

  // The warps' sums into one partial per block (integers: any order).
  __syncthreads();  // every read of sx is done: its ints are reused
  int* red = smem;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j)
      red[(warp * MT + m) * BC + lane * C + j] = acc[m][j];
  __syncthreads();
  const long long MN = static_cast<long long>(p.M) * p.N;
  for (int i = threadIdx.x; i < MT * BC; i += kGemvThreads) {
    const int m = i / BC, c = i % BC, col = blockIdx.x * BC + c;
    if (m >= p.M || col >= p.N) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[(w * MT + m) * BC + c];
    if (p.split == 1) store_out<T>(p, m, col, s);
    else p.partial[blockIdx.y * MN + static_cast<long long>(m) * p.N + col] = s;
  }
  if (p.split == 1) return;

  // Split-K in the same launch: the last block of this column tile sums
  // the splits and applies the epilogue.
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
    int s = 0;
    for (int sp = 0; sp < p.split; ++sp) s += __ldcg(&p.partial[sp * MN + mn]);
    store_out<T>(p, m, col, s);
  }
  if (threadIdx.x == 0) p.ticket[blockIdx.x] = 0;  // ready for the next call
}

// kTile: one 128 x 128 output tile per block, 8 x 8 outputs per thread.
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

}  // namespace

// ---------------------------------------------------------------------------
// kTensorCore: the prefill on int8 wgmma
// ---------------------------------------------------------------------------
//
// Block: 256 threads, two warpgroups, a 128 x 256 output tile (each
// warpgroup 64 rows x 256 columns: wgmma m64n256k32 s8.s8 -> s32, 128
// int32 accumulators a thread). 128 x 256 rather than 128 x 128: per
// 128-byte k-slab the block then stages 48 KB of operands for 8.4 M
// products (32 KB for 4.2 M at 128 x 128), so the tile streams a third
// fewer operand bytes from L2 per product; 128 accumulators, the 32
// registers of one slab of W in flight and the addresses fit the 255
// registers of one block per SM. The reduction walks k-slabs of 128
// bytes (4 wgmma k-steps of 32).
//
// A (x_q, K-major): thread 0 feeds a ring of kStages slabs [128 rows][128
// bytes] by TMA with the 128 B swizzle, which is wgmma's K-major layout
// as it lands; rows past M and columns past K read as zeros.
//
// B (w_q): wgmma reads 8-bit operands only K-major, and w_q is [K, N],
// N-contiguous; the weights keep that layout (the same bytes as the JAX
// package's tree, and no second copy), and the block transposes each slab
// as it stages it. Thread (cg = lane % 16, kg = 2 warp + lane / 16) loads
// k rows 8 kg .. 8 kg + 7 of columns 16 cg .. 16 cg + 15 as eight 16-byte
// loads (a warp's load reads two whole 256-byte rows), transposes each
// 4 x 4 byte square with __byte_perm, and writes each column's eight k as
// one 8-byte store into the K-major tile [256 rows][128 bytes] with the
// 128 B swizzle computed here. The tile's rows hold W's columns in the
// order `tile_col` gives (an XOR inside each 16-column group), so that
// these stores meet no bank conflict; the epilogue puts them back. Then
// fence.proxy.async, so that wgmma (the async proxy) sees the generic
// stores, and the block barrier. W has three buffers: slab t + 1 is
// loaded before slab t's wgmma issue and stored while it runs, and slab
// t's products are still in flight when slab t + 1's are issued (wgmma
// waits for all but the newest group), so the tensor cores do not idle at
// the barrier. Both warpgroups read the whole W tile, and wgmma's wait
// covers only the warpgroup's own groups: at step t the other warpgroup
// may still be reading slab t - 1's buffer, so slab t + 1 goes into slab
// t - 2's, which both finished before step t - 1's block barrier. (Two
// buffers would need a second block barrier a step.)
//
// Shared memory: kStages x 16 KB of x + 3 x 32 KB of W + the mbarriers,
// about 161 KB: one block per SM. The grid runs row tiles fastest, so the
// blocks in flight share a few column panels of W in L2 and x (at most
// M x K bytes) stays there too.
// Bound: operations (2 M K N at 1,979 TOP/s int8).
namespace tc {

using namespace rkv::hopper;

// Tile rows and columns; k bytes per slab.
constexpr int kTM = 128, kTN = 256, kTK = 128;
constexpr int kTcThreads = 256;
constexpr int kStages = 4;
constexpr int kABytes = kTM * kTK;   // 16 KB
constexpr int kBBytes = kTN * kTK;   // 32 KB
constexpr int kWBufs = 3;
constexpr int kBOff = kStages * kABytes;
constexpr int kBarOff = kBOff + kWBufs * kBBytes;
constexpr int kAlloc = kBarOff + 8 * kStages + 1024;  // + room to align
static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "alignment");

// Word q (columns 4 q .. 4 q + 3) of a 16-byte row piece.
__device__ __forceinline__ int word(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Thread (cg = lane % 16, kg = 2 warp + lane / 16)'s piece of W slab t: k
// rows 128 t + 8 kg .. + 7 of columns n0 + 16 cg .. + 15; rows past K and
// columns past N as zeros (N % 16 == 0: a 16-column group lies wholly
// inside N or wholly past it). One load instruction of a warp reads two
// whole 256-byte rows.
__device__ __forceinline__ void load_w(const Int8MatmulParams& p, int t,
                                       int n0, int4 (&v)[8]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int k = t * kTK + (2 * warp + lane / 16) * 8;
  const int n = n0 + (lane % 16) * 16;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    v[r] = n < p.N && k + r < p.K
               ? __ldg(reinterpret_cast<const int4*>(
                     p.w + static_cast<long long>(k + r) * p.N + n))
               : make_int4(0, 0, 0, 0);
}

// Tile row (wgmma column) of W's column 16 cg + c: c's low three bits
// XOR cg's, so that the 16 threads storing column c of their groups write
// 8 distinct swizzled units (no bank conflict beyond the two wavefronts
// 256 bytes need). An involution inside each 16-column group that keeps
// the pairs {2 m, 2 m + 1} together; the epilogue undoes it.
__device__ __forceinline__ int tile_col(int cg, int c) {
  return 16 * cg + (c ^ (cg & 7));
}

// The piece, transposed, into the K-major W tile `buf` (128 B swizzle).
__device__ __forceinline__ void store_w(uint8_t* buf, const int4 (&v)[8]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = lane % 16, kg = 2 * warp + lane / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int lo[4], hi[4];
    transpose4(word(v[0], q), word(v[1], q), word(v[2], q), word(v[3], q), lo);
    transpose4(word(v[4], q), word(v[5], q), word(v[6], q), word(v[7], q), hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = tile_col(cg, 4 * q + j);
      *reinterpret_cast<int2*>(buf + swizzle128(row, kg / 2) + (kg % 2) * 8) =
          make_int2(lo[j], hi[j]);
    }
  }
}

// Thread 0: the TMA copy of x's slab t into its stage.
__device__ __forceinline__ void issue_x(uint8_t* smem, uint64_t* full,
                                        const CUtensorMap* tm_x, int t,
                                        int m0) {
  const int stage = t % kStages;
  mbar_expect_tx(&full[stage], kABytes);
  tma_load_2d(smem + stage * kABytes, tm_x, &full[stage], t * kTK, m0);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b);

template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst,
                                                          float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
int8_tc_kernel(const Int8MatmulParams p,
               const __grid_constant__ CUtensorMap tm_x) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle repeats every 1024 bytes and TMA and wgmma both read it
  // from the address bits, so every tile starts on a 1024-byte boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int n_steps = (p.K + kTK - 1) / kTK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  int4 v[8];
  load_w(p, 0, n0, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kStages && t < n_steps; ++t)
      issue_x(smem, full, &tm_x, t, m0);
  store_w(smem + kBOff, v);
  fence_proxy_async();
  __syncthreads();

  int32_t acc[kTN / 2];
#pragma unroll
  for (int i = 0; i < kTN / 2; ++i) acc[i] = 0;
  const uint32_t s_base = smem_u32(smem);
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) load_w(p, t + 1, n0, v);
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    const uint32_t a_base = s_base + (t % kStages) * kABytes + wg * 64 * kTK;
    const uint32_t b_base = s_base + kBOff + (t % kWBufs) * kBBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 32; ++kk)
      wgmma_s8<kTN>(acc, kmajor_desc<128>(a_base, 64, kk),
                    kmajor_desc<128>(b_base, kTN, kk));
    wgmma_commit();
    // Slab t's products stay in flight; this warpgroup's of slab t - 1 are
    // done. Slab t + 1 goes into slab t - 2's W buffer, which both
    // warpgroups finished before the last step's barrier (the other
    // warpgroup may still read slab t - 1's).
    wgmma_wait_one();
    fence_regs(acc);
    if (t + 1 < n_steps) {  // slab t + 1 is transposed under the products
      store_w(smem + kBOff + ((t + 1) % kWBufs) * kBBytes, v);
      fence_proxy_async();
    }
    __syncthreads();
    if (threadIdx.x == 0 && t >= 1 && t - 1 + kStages < n_steps)
      issue_x(smem, full, &tm_x, t - 1 + kStages, m0);
  }
  wgmma_wait_all();
  fence_regs(acc);

  // Element i: row 16 warp + g (+ 8 for i % 4 >= 2) of the warpgroup's 64,
  // tile column 8 (i / 4) + 2 t4 + i % 2, which holds W's column
  // tile_col(cg, c) with cg = j / 2 for j = i / 4: a pair of tile columns
  // is the pair of W's columns {2 m, 2 m + 1}, in swapped order where
  // cg is odd. N % 16 == 0: both columns of a pair lie inside N or both
  // past it.
  const int r0 = m0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  const float xs0 = r0 < p.M ? p.xs[r0] : 0.f;
  const float xs1 = r1 < p.M ? p.xs[r1] : 0.f;
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j) {
    const int cg = j / 2, c = 8 * (j % 2) + 2 * t4;
    const int col = n0 + tile_col(cg, c) - ((cg & 1) ? 1 : 0);
    if (col >= p.N) continue;
    const int a = (cg & 1) ? 1 : 0;  // the pair's first element in W order
    const float2 s = *reinterpret_cast<const float2*>(p.ws + col);
    if (r0 < p.M)
      store_pair<T>(out + static_cast<long long>(r0) * p.N + col,
                    static_cast<float>(acc[4 * j + a]) * xs0 * s.x,
                    static_cast<float>(acc[4 * j + 1 - a]) * xs0 * s.y);
    if (r1 < p.M)
      store_pair<T>(out + static_cast<long long>(r1) * p.N + col,
                    static_cast<float>(acc[4 * j + 2 + a]) * xs1 * s.x,
                    static_cast<float>(acc[4 * j + 3 - a]) * xs1 * s.y);
  }
}

template <typename T>
cudaError_t launch(const Int8MatmulParams& p, cudaStream_t stream) {
  CUtensorMap tm_x;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.K),
                              static_cast<cuuint64_t>(p.M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.K)};
  const cuuint32_t box[2] = {kTK, kTM};
  const cudaError_t err = encode_tensor_map(
      &tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.x, dims, strides, box,
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // Above 48 KB of shared memory only after opting in, once per instance.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      int8_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kAlloc);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((p.M + kTM - 1) / kTM, (p.N + kTN - 1) / kTN);
  int8_tc_kernel<T><<<grid, kTcThreads, kAlloc, stream>>>(p, tm_x);
  return cudaGetLastError();
}

}  // namespace tc

namespace {

template <typename T>
cudaError_t launch_gemv(const Int8MatmulParams& p, cudaStream_t stream) {
  auto go = [&](auto kernel, int block_cols) {
    const dim3 grid((p.N + block_cols - 1) / block_cols, p.split);
    kernel<<<grid, kGemvThreads, 0, stream>>>(p);
    return cudaGetLastError();
  };
  if (p.M == 1) return go(int8_gemv_kernel<T, 1>, GemvShape<1>::kBlockCols);
  if (p.M == 2) return go(int8_gemv_kernel<T, 2>, GemvShape<2>::kBlockCols);
  if (p.M <= 4) return go(int8_gemv_kernel<T, 4>, GemvShape<4>::kBlockCols);
  return go(int8_gemv_kernel<T, 8>, GemvShape<8>::kBlockCols);
}

template <typename T>
cudaError_t launch_typed(const Int8MatmulParams& p, cudaStream_t stream) {
  switch (p.route) {
    case kGemv:
      return launch_gemv<T>(p, stream);
    case kTensorCore:
      return tc::launch<T>(p, stream);
    default: {
      const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
      int8_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(p);
      return cudaGetLastError();
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const Int8MatmulParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->M <= 0 || p->N <= 0 || p->K <= 0) return cudaErrorInvalidValue;
  switch (p->route) {
    case kGemv:
      if (p->M > kSmallM || p->split <= 0 ||
          (p->K + p->split - 1) / p->split > kMaxRange ||
          (p->split > 1 && (p->partial == nullptr || p->ticket == nullptr)))
        return cudaErrorInvalidValue;
      break;
    case kTile:
      if (p->M <= kSmallM) return cudaErrorInvalidValue;
      break;
    case kTensorCore:
      if (p->M <= kSmallM || p->K % 16 || p->N % 16)
        return cudaErrorInvalidValue;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (p->dtype == rkv::kFloat32) return launch_typed<float>(*p, s);
  if (p->dtype == rkv::kBFloat16) return launch_typed<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
