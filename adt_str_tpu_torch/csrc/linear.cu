// Inference product y = x W^T + b with a K order fixed for every row count, for Hopper (sm_90a).
//
// No TPU kernel: a repair of the port. The plain version
// (ops/linear.py:linear_plain, `x @ W^T + b` as the JAX package's
// models/transformer.py:linear rounds it) goes to cuBLAS, which picks its
// algorithm (tiles, split-K, a GEMV) by the shape: on the card one row's
// product differed between 40 and 80 rows of the beam's decode step, so a
// row's logits, and its tokens, moved with the rows decoded beside it. Here
// every output element is summed over K in one order, whatever M is:
//     T = bf16 or fp16: acc = 0; for each k step of 16 in ascending order:
//           acc = mma.m16n8k16(x[r, k:k+16], W[c, k:k+16], acc)
//           y = T(T(acc) + b)        (the plain version's two roundings: the product, then the bias)
//     fp32: acc = 0; for k ascending: acc = fma(x[r, k], W[c, k], acc);  y = acc + b
// with no split of K and no choice by M: an element's sum does not depend on
// the tile it falls in or on the rows beside it (a tensor-core product adds
// each element's 16 terms the same way wherever it sits in the tile). The
// tiles follow M, the order does not: the bits are those of the first
// design's 64 x 64 tiles.
//
// Bound on an H100: at the decode step's few rows (16 a greedy bucket, 80 a
// beam bucket), the bytes of W, read once; at the encoder's 246 rows a
// chunk, the bf16 operations. A k step waits on the one before it (one
// accumulator), so each output tile's chain of K / 16 products runs at the
// mma's latency; the design puts as many chains on the card at once as the
// rows allow and keeps W's bytes in flight ahead of them:
//   - M <= 320 (decode): a warp owns one 8-column tile and every 16-row tile
//     of the block (up to 5: the beam's 80 rows in one block, W read once a
//     column), so a W column strip is read by one warp; at 16 rows, blocks
//     of 2 warps where that still gives the 132 SMs a wave, else of 1 (16 x
//     768 -> 768: 96 blocks of 8 columns); at more rows, blocks of 4 warps,
//     so the x rows a block reads again stay within 2.5 times its W rows;
//   - M > 320: 64 x 128 tiles, four warps of 64 x 32.
// x and W stream through a cp.async ring of 128-deep k stages (rows padded
// to 136 elements: conflict-free ldmatrix), 8 stages at one row tile (K =
// 768 is then in flight at once), 4 at 2-5, 3 for the large tiles; mma.sync
// m16n8k16 (no wgmma: at 16 rows its 64-row tiles would multiply padding,
// and W's bytes bound the step).
//
// fp32 (the `compute_dtype: float32` configs' decode) keeps its order above:
// one chain of K dependent FMAs an output, so an output takes at least K FMA
// latencies (measured on the H100, 4.5 cycles at 1.98 GHz: 2.6 us a launch
// at K = 768, 7.9 at 3,072, the launch included), whatever the tile. The
// design puts every chain of the call on the card at once and feeds them:
//   - a block owns a strip of columns and every row of its row tile (all the
//     rows up to 80: the beam's 80 rows in one tile, W read once; tiles of
//     80 past that); a thread owns RT rows x CT columns, RT CT chains side by
//     side, and reads 4 k of each a step (16-byte shared-memory loads of rows
//     padded by 4 floats, conflict-free);
//   - the strips follow the columns an SM would get (N / 132): 8 columns a
//     block and one chain a thread up to 8 an SM (16 x 768 -> 768: 96 blocks
//     of 128 threads), 16 columns and 2 chains up to 16 (the generator), and
//     past that 132 strips split as evenly as N falls (widths differ by one),
//     2 x 2 chains a thread (FFN 1, the in-projection) or, at 80 rows, 5 x 3;
//   - x's and W's rows stream through a cp.async ring of 8 stages of 64 k (6
//     of 32 at 80 rows): 7 of K = 768's 12 stages are in flight at the start;
//     16-byte copies where K % 4 == 0 and x and w are 16-byte aligned, else
//     4-byte copies (any K, any alignment), the k past K zero-filled: fma(0,
//     0, acc) is acc, so padding leaves the bits alone, and the outputs are
//     the first design's bit for bit at every M.
// What holds it (PERF.md): every block stages all of x, so x crosses from L2
// once a strip (as many bytes as W at 16 rows, 5 times W at 80), and the
// shared-memory reads of the operands; the TMA (1-D bulk or 2-D tile, with
// or without cluster multicast of x) fed these chains more slowly.

#include <algorithm>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4z;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldmatrix_x2;
using hopper::ldmatrix_x4;
using hopper::mma_16816;

constexpr int BK = 128, LDS = BK + 8;  // k depth of a stage; bf16 row stride of a staged tile (272 bytes)

// x (M, K), w (N, K), bias (N) or null, y (M, N), all of T (bf16 or fp16); K % 8 == 0, 16-byte aligned rows.
// A block of WARPS warps: rows [m0, m0 + 16 MT), columns [n0, n0 + 8 NT WARPS); warp w owns columns
// n0 + 8 NT w .. + 8 NT and every row of the block.
template <typename T, int MT, int NT, int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS) linear_bf16_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                                 const T* __restrict__ bias, T* __restrict__ y, int M,
                                                                 int N, int K) {
  constexpr int THREADS = 32 * WARPS, BM = 16 * MT, BN = 8 * NT * WARPS;
  constexpr int ROWS = BM + BN;                      // staged rows a stage: x's, then W's
  constexpr int COPIES = ROWS * (BK / 8) / THREADS;  // 16-byte copies a thread a stage
  static_assert(ROWS * (BK / 8) % THREADS == 0, "every thread copies as many chunks");
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  T* stages = reinterpret_cast<T*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;

  // A thread copies column `col` of the staged rows tid / 16 + i THREADS / 16: their sources are set
  // once, so a stage's copies cost an add each (one warp a block must also keep its product chain fed).
  const int col = (tid % (BK / 8)) * 8;
  const T* src[COPIES];
  bool row_ok[COPIES];
#pragma unroll
  for (int i = 0; i < COPIES; ++i) {
    const int row = tid / (BK / 8) + i * (THREADS / (BK / 8));
    const bool is_x = row < BM;
    const int r = is_x ? m0 + row : n0 + row - BM;
    row_ok[i] = r < (is_x ? M : N);
    src[i] = (is_x ? x : w) + static_cast<size_t>(row_ok[i] ? r : 0) * K + col;
  }
  auto load = [&](int stage, int kt) {
    T* dst = stages + (stage * ROWS + tid / (BK / 8)) * LDS + col;
    const int k0 = kt * BK;
    const bool k_ok = k0 + col < K;
#pragma unroll
    for (int i = 0; i < COPIES; ++i)
      cp_async_16(dst + i * (THREADS / (BK / 8)) * LDS, src[i] + (k_ok ? k0 : 0), k_ok && row_ok[i]);
  };

  float acc[MT][NT][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // and every warp is done with stage kt - 1, whose buffer is refilled next
    if (kt + STAGES - 1 < k_tiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const T* xs = stages + (kt % STAGES) * ROWS * LDS;
    const T* ws = xs + (BM + warp * NT * 8) * LDS;
    const int steps = min(BK, K - kt * BK + 15) / 16;  // k steps of 16 that reach K: no step of padding alone
#pragma unroll 8
    for (int kk = 0; kk < steps; ++kk) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(a[mi], xs + (mi * 16 + lane % 16) * LDS + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) ldmatrix_x2(b[ni], ws + (ni * 8 + lane % 8) * LDS + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_16816<T>(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + mi * 16 + lane / 4 + 8 * (e / 2);
        const int c = n0 + (warp * NT + ni) * 8 + 2 * (lane % 4) + e % 2;
        if (r >= M || c >= N) continue;
        T v = hopper::from_float<T>(acc[mi][ni][e]);
        if (bias != nullptr) v = hopper::from_float<T>(__fadd_rn(hopper::to_float(v), hopper::to_float(bias[c])));
        y[static_cast<size_t>(r) * N + c] = v;
      }
}

// fp32: x (M, K), w (N, K), bias (N) or null, y (M, N). The grid's blocks split the N columns as evenly
// as they fall (widths differ by one at most, none above TC CT); a block of TR x TC threads owns rows
// [m0, m0 + TR RT) and its strip [n0, n_end); thread (tr, tc) owns rows m0 + tr + i TR (i < RT) and
// columns n0 + tc + j TC (j < CT): RT CT sums, each its own chain of FMAs over k ascending, so the chains
// of a thread run side by side. x's and W's k stages stream through a ring of STAGES stages of BK k; a
// thread reads 4 k of each of its rows and columns a step (16-byte shared-memory loads, rows padded by 4
// floats: the lanes' rows fall in distinct banks). VEC: 16-byte copies (K % 4 == 0 and 16-byte aligned x
// and w), else 4-byte copies; the k past K is zero-filled, and fma(0, 0, acc) is acc (a sum that starts
// at +0 is never -0), so the padding leaves every bit as it is.
template <int TR, int RT, int TC, int CT, int BK, int STAGES, bool VEC>
__global__ void __launch_bounds__(TR * TC) linear_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                                             const float* __restrict__ bias, float* __restrict__ y,
                                                             int M, int N, int K) {
  constexpr int THREADS = TR * TC, BM = TR * RT, BN = TC * CT, LD = BK + 4, ROWS = BM + BN;
  constexpr int CHUNKS = BK / 4;              // 16-byte chunks a staged row
  constexpr int ROW_STEP = THREADS / CHUNKS;  // a thread copies one chunk column of every ROW_STEP-th row
  constexpr int COPIES = (ROWS + ROW_STEP - 1) / ROW_STEP;
  static_assert(THREADS % CHUNKS == 0, "a thread's copies share one chunk column");
  extern __shared__ __align__(16) uint8_t smem[];
  float* stages = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, tr = tid / TC, tc = tid % TC;
  const int m0 = blockIdx.y * BM;
  const int n0 = static_cast<int>(static_cast<long long>(blockIdx.x) * N / gridDim.x);
  const int n_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * N / gridDim.x);
  const int k_tiles = (K + BK - 1) / BK;

  // staged rows: x's BM, then W's BN; a thread's sources are set once
  const int col = (tid % CHUNKS) * 4, row0 = tid / CHUNKS;
  const float* src[COPIES];
  bool row_ok[COPIES];
#pragma unroll
  for (int i = 0; i < COPIES; ++i) {
    const int row = row0 + i * ROW_STEP;
    const bool is_x = row < BM;
    const int r = is_x ? m0 + row : n0 + row - BM;
    row_ok[i] = row < ROWS && r < (is_x ? M : n_end);
    src[i] = (is_x ? x : w) + static_cast<size_t>(row_ok[i] ? r : 0) * K + col;
  }
  auto load = [&](int stage, int kt) {
    float* dst = stages + (stage * ROWS + row0) * LD + col;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      if (ROWS % ROW_STEP != 0 && row0 + i * ROW_STEP >= ROWS) continue;
      float* d = dst + i * ROW_STEP * LD;
      if constexpr (VEC) {
        const bool ok = row_ok[i] && k0 + col < K;
        cp_async_16(d, src[i] + (ok ? k0 : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok[i] && k0 + col + e < K;
          cp_async_4z(d + e, src[i] + (ok ? k0 + e : 0), ok);
        }
      }
    }
  };

  float acc[RT][CT] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // and every thread is done with stage kt - 1, whose buffer is refilled next
    if (kt + STAGES - 1 < k_tiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* xs = stages + ((kt % STAGES) * ROWS + tr) * LD;
    const float* ws = stages + ((kt % STAGES) * ROWS + BM + tc) * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[RT], b[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = *reinterpret_cast<const float4*>(xs + i * TR * LD + kk);
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = *reinterpret_cast<const float4*>(ws + j * TC * LD + kk);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float v = acc[i][j];
          v = __fmaf_rn(a[i].x, b[j].x, v);
          v = __fmaf_rn(a[i].y, b[j].y, v);
          v = __fmaf_rn(a[i].z, b[j].z, v);
          acc[i][j] = __fmaf_rn(a[i].w, b[j].w, v);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int r = m0 + tr + i * TR, c = n0 + tc + j * TC;
      if (r < M && c < n_end) y[static_cast<size_t>(r) * N + c] = bias != nullptr ? __fadd_rn(acc[i][j], bias[c]) : acc[i][j];
    }
}

constexpr int SM_COUNT = 132;  // H100 SXM; sets only the tile choice, never the order of a sum

template <typename T, int MT, int NT, int WARPS, int STAGES>
int launch_bf16(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, cudaStream_t s) {
  constexpr int BM = 16 * MT, BN = 8 * NT * WARPS, BYTES = STAGES * (BM + BN) * LDS * 2;
  static hopper::SmemLimit limit;
  if (const int e = limit.ensure(linear_bf16_kernel<T, MT, NT, WARPS, STAGES>, BYTES)) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  linear_bf16_kernel<T, MT, NT, WARPS, STAGES><<<grid, 32 * WARPS, BYTES, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_16(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  if (M > 320) return launch_bf16<T, 4, 4, 4, 3>(x, w, bias, y, M, N, K, st);
  // One row tile: blocks of 2 warps if that still fills a wave, else of 1. More rows: 4 warps, so that
  // the x rows each block reads again stay within 2.5 times the W rows it reads once.
  switch ((M + 15) / 16) {
    case 1:
      return (N + 15) / 16 >= SM_COUNT ? launch_bf16<T, 1, 1, 2, 8>(x, w, bias, y, M, N, K, st)
                                       : launch_bf16<T, 1, 1, 1, 8>(x, w, bias, y, M, N, K, st);
    case 2: return launch_bf16<T, 2, 1, 4, 4>(x, w, bias, y, M, N, K, st);
    case 3: return launch_bf16<T, 3, 1, 4, 4>(x, w, bias, y, M, N, K, st);
    case 4: return launch_bf16<T, 4, 1, 4, 4>(x, w, bias, y, M, N, K, st);
    default: return launch_bf16<T, 5, 1, 4, 4>(x, w, bias, y, M, N, K, st);
  }
}

// `blocks` strips of the N columns (at least N / BN of them) a row tile.
template <int TR, int RT, int TC, int CT, int BK, int STAGES, bool VEC>
int launch_f32_as(const float* x, const float* w, const float* bias, float* y, int M, int N, int K, int blocks,
                  cudaStream_t s) {
  constexpr int BM = TR * RT, BN = TC * CT, BYTES = STAGES * (BM + BN) * (BK + 4) * 4;
  static hopper::SmemLimit limit;
  if (const int e = limit.ensure(linear_f32_kernel<TR, RT, TC, CT, BK, STAGES, VEC>, BYTES)) return e;
  const dim3 grid(std::max(blocks, (N + BN - 1) / BN), (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  linear_f32_kernel<TR, RT, TC, CT, BK, STAGES, VEC><<<grid, TR * TC, BYTES, s>>>(x, w, bias, y, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int TR, int RT, int TC, int CT, int BK, int STAGES>
int launch_f32_tile(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, int blocks,
                    cudaStream_t s) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_f32_as<TR, RT, TC, CT, BK, STAGES, true>(xf, wf, bf, yf, M, N, K, blocks, s)
             : launch_f32_as<TR, RT, TC, CT, BK, STAGES, false>(xf, wf, bf, yf, M, N, K, blocks, s);
}

// The tile follows the rows (one row tile up to 80 rows, tiles of 80 past them) and the columns a
// streaming multiprocessor would get (N / SM_COUNT); none of it touches the order of a sum.
int launch_f32(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  const int per_sm = (N + SM_COUNT - 1) / SM_COUNT;
  switch (std::min((M + 15) / 16, 5)) {
    case 1:  // a strip of 8 columns a block, one sum a thread; 16; 24 in 132 strips, 2 x 2 sums a thread
      if (per_sm <= 8) return launch_f32_tile<16, 1, 8, 1, 64, 8>(x, w, bias, y, M, N, K, 0, st);
      if (per_sm <= 16) return launch_f32_tile<8, 2, 16, 1, 64, 8>(x, w, bias, y, M, N, K, 0, st);
      return launch_f32_tile<8, 2, 12, 2, 64, 8>(x, w, bias, y, M, N, K, SM_COUNT, st);
    case 2: return launch_f32_tile<16, 2, 8, 1, 64, 8>(x, w, bias, y, M, N, K, 0, st);
    case 3: return launch_f32_tile<16, 3, 8, 1, 64, 6>(x, w, bias, y, M, N, K, 0, st);
    case 4: return launch_f32_tile<16, 4, 8, 1, 32, 8>(x, w, bias, y, M, N, K, 0, st);
    default:  // 80 rows: 8 columns a block, 5 sums a thread; past 8 columns an SM, 132 strips of up to 18, 5 x 3
      if (per_sm <= 8) return launch_f32_tile<16, 5, 8, 1, 32, 6>(x, w, bias, y, M, N, K, 0, st);
      return launch_f32_tile<16, 5, 6, 3, 32, 6>(x, w, bias, y, M, N, K, SM_COUNT, st);
  }
}

}  // namespace

// Launch on `stream`; returns 0 or a cudaError_t. Contiguous x (M, K), w
// (N, K), y (M, N) and bias (N) or null, all of `dtype` (0: fp32, 1: bf16,
// 2: fp16); bf16 and fp16 need K % 8 == 0 and 16-byte aligned x and w.
extern "C" int launch_linear(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, int dtype,
                             void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && (K % 8 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, w, bias, y, M, N, K, st);
  return dtype == 1 ? launch_16<__nv_bfloat16>(x, w, bias, y, M, N, K, st) : launch_16<__half>(x, w, bias, y, M, N, K, st);
}
