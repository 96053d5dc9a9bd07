// Inference product y = x W^T + b with a K order fixed for every row count, for Hopper (sm_90a).
//
// No TPU kernel: a repair of the port. The plain version
// (ops/linear.py:linear_plain, `x @ W^T + b` as the JAX package's
// models/transformer.py:linear rounds it) goes to cuBLAS, which picks its
// algorithm (tiles, split-K, a GEMV) by the shape: on the card one row's
// product differed between 40 and 80 rows of the beam's decode step, so a
// row's logits, and its tokens, moved with the rows decoded beside it. Here
// every output element is summed over K in one order, whatever M is:
//     bf16: acc = 0; for each k step of 16 in ascending order: acc = mma.m16n8k16(x[r, k:k+16], W[c, k:k+16], acc)
//           y = bf16(bf16(acc) + b)        (the plain version's two roundings: the product, then the bias)
//     fp32: acc = 0; for k ascending: acc = fma(x[r, k], W[c, k], acc);  y = acc + b
// with no split of K and no choice by M: an element's sum does not depend on
// the tile it falls in or on the rows beside it (a tensor-core product adds
// each element's 16 terms the same way wherever it sits in the tile).
//
// Bound on an H100: at the decode step's few rows, the bytes of W (read
// once); at the encoder's 246 rows a chunk, the bf16 operations. The design
// is the simple one: 64 x 64 output tiles, four warps of 32 x 32, mma.sync
// m16n8k16 fed by ldmatrix from a 3-stage cp.async ring of 64 x 32 tiles of
// x and W (rows padded to 40 elements: conflict-free ldmatrix). fp32 runs
// on the CUDA cores, 4 x 4 outputs a thread (no shipped config computes in
// fp32; it is kept exact rather than fast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, STAGES = 3, THREADS = 128;
constexpr int LDS = BK + 8;  // bf16 row stride of a shared tile (80 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x (M, K) bf16, w (N, K) bf16, bias (N) bf16 or null, y (M, N) bf16; K % 8 == 0, 16-byte aligned rows
__global__ void __launch_bounds__(THREADS) linear_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                              const __nv_bfloat16* __restrict__ w,
                                                              const __nv_bfloat16* __restrict__ bias,
                                                              __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BN][LDS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 quarter of the tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 64 rows x 4 chunks of 8 elements, for x and for W
      const int c = tid + i * THREADS, row = c / 4, col = (c % 4) * 8;
      const bool kin = k0 + col < K;
      const bool va = kin && m0 + row < M, vb = kin && n0 + row < N;
      cp_async_16(&As[stage][row][col], va ? x + static_cast<size_t>(m0 + row) * K + k0 + col : x, va);
      cp_async_16(&Bs[stage][row][col], vb ? w + static_cast<size_t>(n0 + row) * K + k0 + col : w, vb);
    }
  };

  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // and every warp is done with tile kt - 1, whose stage is refilled next
    if (kt + STAGES - 1 < k_tiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &As[s][wm * 32 + mi * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ldmatrix_x2(b[ni], &Bs[s][wn * 32 + ni * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 32 + mi * 16 + lane / 4 + 8 * (e / 2);
        const int c = n0 + wn * 32 + ni * 8 + 2 * (lane % 4) + e % 2;
        if (r >= M || c >= N) continue;
        __nv_bfloat16 v = __float2bfloat16_rn(acc[mi][ni][e]);
        if (bias != nullptr) v = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), __bfloat162float(bias[c])));
        y[static_cast<size_t>(r) * N + c] = v;
      }
}

constexpr int FT = 16;  // fp32: k depth of a shared tile

// x (M, K) fp32, w (N, K) fp32, bias (N) fp32 or null, y (M, N) fp32; 256 threads, 4 x 4 outputs each
__global__ void __launch_bounds__(256) linear_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                                         const float* __restrict__ bias, float* __restrict__ y, int M,
                                                         int N, int K) {
  __shared__ float As[FT][BM + 4];
  __shared__ float Bs[FT][BN + 4];
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 64 rows x 16 k of x and of W, transposed into shared memory
      const int e = tid + i * 256, row = e / FT, kk = e % FT;
      const bool kin = k0 + kk < K;
      As[kk][row] = kin && m0 + row < M ? x[static_cast<size_t>(m0 + row) * K + k0 + kk] : 0.f;
      Bs[kk][row] = kin && n0 + row < N ? w[static_cast<size_t>(n0 + row) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    const int kn = min(FT, K - k0);
    for (int kk = 0; kk < kn; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(As[kk][tm * 4 + i], Bs[kk][tn * 4 + j], acc[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + tm * 4 + i, c = n0 + tn * 4 + j;
      if (r < M && c < N) y[static_cast<size_t>(r) * N + c] = bias != nullptr ? __fadd_rn(acc[i][j], bias[c]) : acc[i][j];
    }
}

}  // namespace

// Launch on `stream`; returns 0 or a cudaError_t. Contiguous x (M, K), w
// (N, K), y (M, N) and bias (N) or null, all of `dtype` (0: fp32, 1: bf16);
// bf16 needs K % 8 == 0 and 16-byte aligned x and w.
extern "C" int launch_linear(const void* x, const void* w, const void* bias, void* y, int M, int N, int K, int dtype,
                             void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && (K % 8 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    linear_bf16_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), M, N, K);
  else
    linear_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                            static_cast<const float*>(bias), static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
