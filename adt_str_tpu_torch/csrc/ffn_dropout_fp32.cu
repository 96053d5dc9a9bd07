// K4 on the CUDA cores: fused FFN + dropout forward in fp32, for
// `model.compute_dtype: float32` (ffn_dropout.cu takes bf16 only).
//
// Replaces adt_str_tpu/ops/pallas_ffn.py:fused_ffn_dropout (_fwd_call,
// _fwd_kernel), which runs in the compute dtype (`cdt = x2.dtype`), for fp32
// operands. For x (N, d), W1 (d_ff, d) (linear1.weight), W2 (d, d_ff)
// (linear2.weight), b1, b2, all fp32, and four seed words:
//     pre = x W1^T + b1                                 (an output)
//     hd  = keep_h(r, c) ? gelu(pre) * (1 / keep_h) : 0  (gelu with the
//                                                        Abramowitz-Stegun erf)
//     out = keep_o(r, c) ? (hd W2^T + b2) * (1 / keep_o) : 0
// with the counter-hash masks of ops/dropout_hash.py, bit-identical to the
// bf16 kernel's and the JAX package's. Tensor parallelism as in
// ffn_dropout.cu: the hidden mask at the whole-width index
// r * d_ff_total + col0 + c, and the partial mode (b2 null) writes
// hd W2_shard^T alone. gelu uses the accurate expf and division: the fp32
// path is held to the plain path's fp32 results.
//
// Bound on an H100: at the decoder's training shapes (N = 64 * 511, d 768,
// d_ff 3072) the two products are 4 N d d_ff flops, 309 GFLOP: 4.6 ms at the
// 67 TFLOP/s of fp32 FMA (no TF32), against 0.3 GB of fp32 operands (0.1 ms
// at 3.35 TB/s). So it is bound by fp32 operations, and the design is the
// classic register-blocked SGEMM, twice, split at the hidden as the bf16
// kernel is: 128 x 128 output tiles, 256 threads each owning an 8 x 8 block
// (rows 4 ty.. and 64 + 4 ty.., columns 4 tx.. and 64 + 4 tx..), depth
// stages of 8 staged transposed in shared memory so a thread reads its 8 A
// and 8 B values as four float4; GEMM 1's epilogue adds b1, writes pre and
// the dropped gelu hd, GEMM 2's adds b2 and applies the output mask.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int THREADS = 256;

constexpr uint32_t HASH_GOLDEN = 0x9E3779B9u;
constexpr uint32_t HASH_M1 = 0x85EBCA6Bu;

enum Mode { kHiddenMode = 0, kOutMode = 1, kPartialMode = 2 };

__device__ __forceinline__ bool keep(uint32_t idx, uint32_t s0, uint32_t s1, uint32_t thresh) {
  uint32_t h = idx * HASH_GOLDEN + s0;
  h ^= h >> 16;
  h *= HASH_M1;
  h ^= s1;
  h ^= h >> 15;
  return h < thresh;
}

// gelu with the Abramowitz-Stegun 7.1.26 erf, as ops/ffn.py:gelu_as computes it in fp32
__device__ __forceinline__ float gelu_as(float p) {
  const float x = __fdiv_rn(p, 1.41421356237309515f);
  const float s = static_cast<float>((x > 0.f) - (x < 0.f));
  const float a = fabsf(x);
  const float t = __fdiv_rn(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = s * (1.0f - poly * expf(-a * a));
  return p * 0.5f * (1.0f + erf);
}

// C = A B^T for A (rows, K) and B (cols, K), both K-major fp32; rows past
// `rows` read as zeros; cols and K are multiples of 128 and 8. The epilogue
// of kMode: kHiddenMode writes out = pre (A B^T + bias) and hd; kOutMode
// writes out = the masked (A B^T + bias); kPartialMode writes A B^T.
template <int kMode>
__global__ void __launch_bounds__(THREADS) ffn_gemm_fp32(const float* __restrict__ A, const float* __restrict__ Bw,
                                                         const float* __restrict__ bias, float* __restrict__ out,
                                                         float* __restrict__ hd, int rows, int K, int cols,
                                                         int mask_cols, int col0, uint32_t s0, uint32_t s1,
                                                         uint32_t thresh, float inv_keep) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bs[BK][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // loads: thread t copies 4 consecutive k of row t / 2 of each tile
  const int lr = threadIdx.x / 2, lk = (threadIdx.x % 2) * 4;
  const bool a_ok = m0 + lr < rows;
  const float* a_src = A + static_cast<size_t>(a_ok ? m0 + lr : 0) * K + lk;
  const float* b_src = Bw + static_cast<size_t>(n0 + lr) * K + lk;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const float4 a4 = a_ok ? __ldg(reinterpret_cast<const float4*>(a_src + k0)) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(b_src + k0));
    __syncthreads();  // the previous stage is read
    as[lk][lr] = a4.x;
    as[lk + 1][lr] = a4.y;
    as[lk + 2][lr] = a4.z;
    as[lk + 3][lr] = a4.w;
    bs[lk][lr] = b4.x;
    bs[lk + 1][lr] = b4.y;
    bs[lk + 2][lr] = b4.z;
    bs[lk + 3][lr] = b4.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 x1 = *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
      const float4 y0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 y1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  // thread element (i, j): row m0 + (i < 4 ? 4 ty + i : 64 + 4 ty + i - 4), column n0 + the same of tx, j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = n0 + 64 * half + 4 * tx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * half + e];
      const size_t at = static_cast<size_t>(r) * cols + c;
      if constexpr (kMode == kPartialMode) {
        *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c));
      v[0] = __fadd_rn(v[0], b4.x);
      v[1] = __fadd_rn(v[1], b4.y);
      v[2] = __fadd_rn(v[2], b4.z);
      v[3] = __fadd_rn(v[3], b4.w);
      if constexpr (kMode == kHiddenMode) {
        *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);  // pre
        const uint32_t idx = static_cast<uint32_t>(r) * static_cast<uint32_t>(mask_cols) + static_cast<uint32_t>(col0 + c);
        float g[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) g[e] = keep(idx + e, s0, s1, thresh) ? __fmul_rn(gelu_as(v[e]), inv_keep) : 0.f;
        *reinterpret_cast<float4*>(hd + at) = make_float4(g[0], g[1], g[2], g[3]);
      } else {
        const uint32_t idx = static_cast<uint32_t>(r) * static_cast<uint32_t>(cols) + static_cast<uint32_t>(c);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = keep(idx + e, s0, s1, thresh) ? __fmul_rn(v[e], inv_keep) : 0.f;
        *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

}  // namespace

extern "C" int ffn_dropout_fp32_tile() { return BN; }

// Launch both GEMMs on `stream`; returns 0 or a cudaError_t. The caller
// checks: fp32 contiguous x (N, d), w1 (d_ff, d), w2 (d, d_ff), b1 (d_ff,),
// b2 (d,) or null (the partial mode), d and d_ff multiples of 128, outputs
// out (N, d), pre and the scratch hd (N, d_ff), 16-byte aligned; seeds as
// in ffn_dropout.cu.
extern "C" int launch_ffn_dropout_fp32(const void* x, const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* out, void* pre, void* hd, int N, int d, int d_ff,
                                       int d_ff_total, int col0, unsigned int s_h0, unsigned int s_h1,
                                       unsigned int s_o0, unsigned int s_o1, unsigned int thresh_h,
                                       unsigned int thresh_o, float inv_keep_h, float inv_keep_o, void* stream) {
  if (N < 1 || d % BN || d_ff % BN || col0 < 0 || col0 >= d_ff_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned mt = static_cast<unsigned>((N + BM - 1) / BM);
  ffn_gemm_fp32<kHiddenMode><<<dim3(d_ff / BN, mt), THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<float*>(pre), static_cast<float*>(hd), N, d, d_ff, d_ff_total, col0, s_h0, s_h1, thresh_h,
      inv_keep_h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (b2 == nullptr)
    ffn_gemm_fp32<kPartialMode><<<dim3(d / BN, mt), THREADS, 0, st>>>(
        static_cast<const float*>(hd), static_cast<const float*>(w2), nullptr, static_cast<float*>(out), nullptr, N,
        d_ff, d, d, 0, s_o0, s_o1, thresh_o, inv_keep_o);
  else
    ffn_gemm_fp32<kOutMode><<<dim3(d / BN, mt), THREADS, 0, st>>>(
        static_cast<const float*>(hd), static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<float*>(out), nullptr, N, d_ff, d, d, 0, s_o0, s_o1, thresh_o, inv_keep_o);
  return static_cast<int>(cudaGetLastError());
}
