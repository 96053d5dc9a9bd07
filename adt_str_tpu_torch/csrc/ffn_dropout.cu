// K4: fused FFN + dropout forward for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_ffn.py:fused_ffn_dropout (_fwd_kernel). For
// x (N, d) bf16, W1 (d, d_ff), W2 (d_ff, d), b1, b2 (bf16) and four seed
// words:
//     pre = bf16(x W1 + b1)                            (fp32 accumulation; an output)
//     hd  = bf16(keep_h(r, c) ? gelu(pre) / keep_h : 0) (gelu with the
//                                                       Abramowitz-Stegun erf)
//     out = bf16(keep_o(r, c) ? (hd W2 + b2) / keep_o : 0)
// keep_*(r, c) is the counter hash of ops/dropout_hash.py on the flat
// index r * cols + c of the unpadded (N, cols) array, in uint32 arithmetic,
// compared with the threshold min(int(keep * 2^32), 2^32 - 1). The masks
// are bit-identical to the JAX package's.
//
// Bound on an H100: at the decoder's training shapes (N = 64 * 511, d = 768,
// d_ff = 3072) the two products are 4 * N * d * d_ff flops, 309 GFLOP
// (312 us at 989 TFLOP/s), while x, the weights, pre and out are about
// 260 MB (78 us at 3.35 TB/s): it is bound by operations, and the gain over
// two library GEMMs is the (N, d_ff) hidden that never goes to device memory.
// The design (one launch):
//   - one block per 32 rows, 8 warps; the x row tile (32 x d bf16) stays in
//     shared memory;
//   - d_ff is walked in chunks of 128: the 32 x 128 pre chunk is a wmma
//     product over W1 streamed in 128 x 64 slabs; the epilogue adds b1,
//     rounds, writes pre, applies gelu, the hidden mask and 1/keep_h, and
//     leaves the bf16 hidden chunk in shared memory;
//   - the chunk is multiplied into W2 (streamed in 32-row slabs) and added
//     to the 32 x d fp32 output tile, which stays in registers across all
//     chunks (12 wmma fragments a warp at d = 768);
//   - the output epilogue adds b2 and applies the output mask.
// Each block reads all of W1 and W2 (from L2), so the kernel moves far more
// bytes through L2 than the bound counts. No TMA, wgmma or pipelining yet:
// this is the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int D = 768;        // d_model: the one width the model runs
constexpr int BM = 32;        // rows per block
constexpr int FC = 128;       // d_ff chunk
constexpr int KS1 = 64;       // depth of a W1 slab (over d)
constexpr int KS2 = 32;       // depth of a W2 slab (over the chunk)
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDW1 = KS1 + 8;  // bf16 row stride of the W1 slab ([f][k])
constexpr int LDPRE = FC + 4;  // fp32 row stride of the pre chunk
constexpr int LDH = FC + 8;    // bf16 row stride of the hidden chunk

constexpr uint32_t HASH_GOLDEN = 0x9E3779B9u;
constexpr uint32_t HASH_M1 = 0x85EBCA6Bu;

__host__ __device__ constexpr int ldx(int d) { return d + 8; }  // bf16 stride of x and the W2 slab
__host__ __device__ constexpr int slab_bytes(int d) {
  return FC * LDW1 * 2 > KS2 * ldx(d) * 2 ? FC * LDW1 * 2 : KS2 * ldx(d) * 2;
}
__host__ __device__ constexpr int smem_bytes(int d) {
  return BM * ldx(d) * 2 + slab_bytes(d) + BM * LDPRE * 4 + BM * LDH * 2;
}

__device__ inline bool keep(uint32_t idx, uint32_t s0, uint32_t s1, uint32_t thresh) {
  uint32_t h = idx * HASH_GOLDEN + s0;
  h ^= h >> 16;
  h *= HASH_M1;
  h ^= s1;
  h ^= h >> 15;
  return h < thresh;
}

// gelu with the Abramowitz-Stegun 7.1.26 erf of pallas_ffn._erf, in fp32
__device__ inline float gelu_as(float p) {
  const float x = p / 1.41421356237309515f;
  const float s = static_cast<float>((x > 0.f) - (x < 0.f));
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = s * (1.0f - poly * expf(-a * a));
  return p * 0.5f * (1.0f + erf);
}

__global__ void __launch_bounds__(THREADS, 1) ffn_dropout_kernel(
    const __nv_bfloat16* __restrict__ x,    // (N, D)
    const __nv_bfloat16* __restrict__ w1,   // (d_ff, D): W1 transposed, linear1.weight's layout
    const __nv_bfloat16* __restrict__ b1,   // (d_ff,)
    const __nv_bfloat16* __restrict__ w2,   // (d_ff, D): W2
    const __nv_bfloat16* __restrict__ b2,   // (D,)
    __nv_bfloat16* __restrict__ out,        // (N, D)
    __nv_bfloat16* __restrict__ pre,        // (N, d_ff)
    int N, int d_ff, uint32_t s0, uint32_t s1, uint32_t s2, uint32_t s3,
    uint32_t thresh_h, uint32_t thresh_o, float inv_keep_h, float inv_keep_o) {
  constexpr int LDX = ldx(D);
  constexpr int NCT = D / 16 / WARPS;  // output column tiles a warp owns, in both row tiles
  constexpr int LDOUT = D + 4;
  static_assert(D % (16 * WARPS) == 0, "d must be a multiple of 128");
  static_assert(BM * LDOUT * 4 <= BM * LDX * 2 + slab_bytes(D), "the output tile reuses x and the slab");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + BM * LDX * 2);
  float* pre_s = reinterpret_cast<float*>(smem + BM * LDX * 2 + slab_bytes(D));
  __nv_bfloat16* hd_s = reinterpret_cast<__nv_bfloat16*>(smem + BM * LDX * 2 + slab_bytes(D) + BM * LDPRE * 4);
  float* out_s = reinterpret_cast<float*>(smem);  // the output tile, at the end

  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int i = tid; i < BM * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(xs + r * LDX + c) = v;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_out[2][NCT];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NCT; ++j) wmma::fill_fragment(acc_out[rt][j], 0.f);

  // pre chunk 32 x 128: warp owns row tile (warp & 1) and column tiles 2 * (warp >> 1) + {0, 1}
  const int prt = warp & 1, pct = 2 * (warp >> 1);
  for (int f0 = 0; f0 < d_ff; f0 += FC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_pre[2];
    wmma::fill_fragment(acc_pre[0], 0.f);
    wmma::fill_fragment(acc_pre[1], 0.f);
    for (int k0 = 0; k0 < D; k0 += KS1) {
      __syncthreads();  // x is loaded; the slab is no longer read
      for (int i = tid; i < FC * (KS1 / 8); i += THREADS) {
        const int f = i / (KS1 / 8), c = (i % (KS1 / 8)) * 8;
        *reinterpret_cast<uint4*>(slab + f * LDW1 + c) =
            *reinterpret_cast<const uint4*>(w1 + static_cast<size_t>(f0 + f) * D + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS1; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, xs + prt * 16 * LDX + k0 + kk, LDX);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;  // W1 from [f][k]
          wmma::load_matrix_sync(fb, slab + (pct + j) * 16 * LDW1 + kk, LDW1);
          wmma::mma_sync(acc_pre[j], fa, fb, acc_pre[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(pre_s + prt * 16 * LDPRE + (pct + j) * 16, acc_pre[j], LDPRE, wmma::mem_row_major);
    __syncthreads();

    // epilogue of the first product: bias, bf16 pre, gelu, hidden mask
    for (int i = tid; i < BM * FC; i += THREADS) {
      const int r = i / FC, c = i % FC;
      const int row = r0 + r, col = f0 + c;
      const __nv_bfloat16 pb = __float2bfloat16_rn(pre_s[r * LDPRE + c] + __bfloat162float(b1[col]));
      float hv = 0.f;
      if (row < N) {
        pre[static_cast<size_t>(row) * d_ff + col] = pb;
        const uint32_t idx = static_cast<uint32_t>(row) * static_cast<uint32_t>(d_ff) + static_cast<uint32_t>(col);
        if (keep(idx, s0, s1, thresh_h)) hv = gelu_as(__bfloat162float(pb)) * inv_keep_h;
      }
      hd_s[r * LDH + c] = __float2bfloat16_rn(hv);
    }

    // second product: out += hd_chunk W2[f0:f0+128], W2 streamed in 32-row slabs
    for (int kb = 0; kb < FC; kb += KS2) {
      __syncthreads();  // the hidden chunk is written; the slab is no longer read
      for (int i = tid; i < KS2 * (D / 8); i += THREADS) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(slab + r * LDX + c) =
            *reinterpret_cast<const uint4*>(w2 + static_cast<size_t>(f0 + kb + r) * D + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS2; kk += 16) {
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, hd_s + rt * 16 * LDH + kb + kk, LDH);
#pragma unroll
          for (int j = 0; j < NCT; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, slab + kk * LDX + (warp * NCT + j) * 16, LDX);
            wmma::mma_sync(acc_out[rt][j], fa, fb, acc_out[rt][j]);
          }
        }
      }
    }
  }
  __syncthreads();  // x and the slab become the output tile

#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NCT; ++j)
      wmma::store_matrix_sync(out_s + rt * 16 * LDOUT + (warp * NCT + j) * 16, acc_out[rt][j], LDOUT,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue of the second product: bias and output mask
  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    if (row >= N) continue;
    const float v = out_s[r * LDOUT + c] + __bfloat162float(b2[c]);
    const uint32_t idx = static_cast<uint32_t>(row) * static_cast<uint32_t>(D) + static_cast<uint32_t>(c);
    out[static_cast<size_t>(row) * D + c] = __float2bfloat16_rn(keep(idx, s2, s3, thresh_o) ? v * inv_keep_o : 0.f);
  }
}

}  // namespace

extern "C" int ffn_dropout_chunk() { return FC; }
extern "C" int ffn_dropout_width() { return D; }

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a width other than D. The caller checks: bf16
// contiguous x (N, D), w1 and w2 (d_ff, D), b1 (d_ff,), b2 (D,), d_ff a
// multiple of 128, outputs of the right shapes; seeds are the four scrambled
// words [h0, h1, o0, o1].
extern "C" int launch_ffn_dropout(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, void* pre, int N, int d, int d_ff,
                                  unsigned int s_h0, unsigned int s_h1, unsigned int s_o0,
                                  unsigned int s_o1, unsigned int thresh_h, unsigned int thresh_o,
                                  float inv_keep_h, float inv_keep_o, void* stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(ffn_dropout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_dropout_kernel<<<(N + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(pre), N, d_ff, s_h0, s_h1, s_o0, s_o1, thresh_h, thresh_o, inv_keep_h, inv_keep_o);
  return static_cast<int>(cudaGetLastError());
}

