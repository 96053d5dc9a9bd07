// K5 forward: fused short-sequence attention for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel). For each
// (batch b, head h) and query row i:
//     s_ij = (q_i . k_j) * scale + mask[b, i, j]       (fp32; mask optional, shared over heads)
//     lse_i = m_i + log(sum_j exp(s_ij - m_i)),  m_i = max_j s_ij
//     p_ij = bf16(exp(s_ij - m_i) / sum_j exp(s_ij - m_i))
//     out_i = bf16(sum_j p_ij v_j)                        (fp32 accumulation)
// q, k, v are bf16 (B, H, T, 128); Tk <= 256.
//
// Bound on an H100: at the encoder's shapes (T = 246, head dim 128) the
// flops are 4*T*T*128 per head, about 12 GFLOP per layer for a batch of 64
// (12 us at 989 TFLOP/s), while q, k, v and out are about 97 MB of bf16
// (29 us at 3.35 TB/s): it is bound by memory. The design reads each of q,
// k, v once per 64-row query tile and writes out once, and keeps the scores
// and probabilities on the SM:
//   - one block per (64 query rows, head, batch item), 8 warps;
//   - a 64 x Tk fp32 score tile fits in shared memory for Tk <= 256, so the
//     exact two-pass softmax of the TPU kernel applies (max, exp, sum,
//     divide), with p cast to bf16 before P.V exactly where the TPU kernel
//     casts it; an online softmax would round elsewhere;
//   - Q.K^T and P.V run on bf16 tensor cores (nvcuda::wmma) with fp32
//     accumulators; p is written as bf16 over its own fp32 score row;
//   - ragged Tq and Tk are handled here: rows past T are zero-filled in
//     shared memory and masked out of the softmax, so no caller pads to 8.
// No TMA, wgmma or pipelining yet: this is the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int D = 128;        // head dim
constexpr int MAX_TK = 256;   // keys held in shared memory
constexpr int THREADS = 256;  // 8 warps
constexpr int LDQ = D + 8;    // bf16 row stride of the Q and K/V tiles
constexpr int LDO = D + 4;    // fp32 row stride of the output tile

__host__ __device__ inline int kv_bytes(int tk_pad) {
  const int kv = tk_pad * LDQ * 2, o = BQ * LDO * 4;  // the K/V tile, later the output tile
  return kv > o ? kv : o;
}

__host__ __device__ inline int smem_bytes(int tk_pad) {
  return BQ * LDQ * 2 + kv_bytes(tk_pad) + BQ * (tk_pad + 8) * 4;
}

// rows row0.. of a (rows, D) bf16 matrix into a (pad_rows, LDQ) tile, zero from row `valid` on
__device__ inline void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                 int pad_rows, int valid) {
  for (int i = threadIdx.x; i < pad_rows * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = v;
  }
}

__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, H, Tq, D)
    const __nv_bfloat16* __restrict__ k,   // (B, H, Tk, D)
    const __nv_bfloat16* __restrict__ v,   // (B, H, Tk, D)
    const float* __restrict__ mask,        // (B, Tq, Tk) or null
    __nv_bfloat16* __restrict__ out,       // (B, H, Tq, D)
    float* __restrict__ lse,               // (B, H, Tq)
    int H, int Tq, int Tk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tk_pad = (Tk + 15) / 16 * 16;
  const int lds = tk_pad + 8;  // fp32 row stride of the score tile
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kv = qs + BQ * LDQ;
  float* sc = reinterpret_cast<float*>(smem + BQ * LDQ * 2 + kv_bytes(tk_pad));
  float* os = reinterpret_cast<float*>(kv);  // output tile, after P.V

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int bh = b * H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_kt = tk_pad / 16;

  load_rows(qs, q + static_cast<size_t>(bh) * Tq * D, q0, BQ, Tq);
  load_rows(kv, k + static_cast<size_t>(bh) * Tk * D, 0, tk_pad, Tk);
  __syncthreads();

  // scores: 4 row tiles x n_kt key tiles of 16 x 16
  for (int t = warp; t < 4 * n_kt; t += THREADS / 32) {
    const int rt = t & 3, ct = t >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;  // K^T
      wmma::load_matrix_sync(fa, qs + rt * 16 * LDQ + d0, LDQ);
      wmma::load_matrix_sync(fb, kv + ct * 16 * LDQ + d0, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sc + rt * 16 * lds + ct * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // exact softmax, one warp per row; each lane holds up to 8 of the row's scores
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int qi = q0 + r;
    float* srow = sc + r * lds;
    const float* mrow = (mask != nullptr && qi < Tq) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
    float vals[MAX_TK / 32];
    float m = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < MAX_TK / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < Tk) {
        float s = srow[j] * scale;
        if (mrow != nullptr) s += mrow[j];
        vals[i] = s;
        m = fmaxf(m, s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_TK / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < Tk) {
        vals[i] = expf(vals[i] - m);
        sum += vals[i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();  // the whole row is read before p overwrites it
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(srow);
#pragma unroll
    for (int i = 0; i < MAX_TK / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < tk_pad) prow[j] = __float2bfloat16_rn(j < Tk ? vals[i] / sum : 0.f);
    }
    if (lane == 0 && qi < Tq) lse[static_cast<size_t>(bh) * Tq + qi] = m + logf(sum);
  }
  __syncthreads();

  load_rows(kv, v + static_cast<size_t>(bh) * Tk * D, 0, tk_pad, Tk);
  __syncthreads();

  // out tile: warp owns row tile (warp & 3) and 64 columns from (warp >> 2) * 64
  const int rt = warp & 3, c0 = (warp >> 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(sc);
  for (int kt = 0; kt < n_kt; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, ps + rt * 16 * (2 * lds) + kt * 16, 2 * lds);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, kv + kt * 16 * LDQ + c0 + j * 16, LDQ);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
  __syncthreads();  // every warp is done with V before the output tile overwrites it
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(os + rt * 16 * LDO + c0 + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncthreads();

  __nv_bfloat16* og = out + static_cast<size_t>(bh) * Tq * D;
  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (q0 + r >= Tq) continue;
    const float* src = os + r * LDO + c;
    __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16_rn(src[e]);
    *reinterpret_cast<uint4*>(og + static_cast<size_t>(q0 + r) * D + c) = *reinterpret_cast<const uint4*>(o8);
  }
}

}  // namespace

extern "C" int attention_max_keys() { return MAX_TK; }
extern "C" int attention_head_dim() { return D; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks: bf16 contiguous q, k, v with head dim 128, 1 <= Tk <= 256, a
// contiguous fp32 (B, Tq, Tk) mask or null, outputs of the right shapes.
extern "C" int launch_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                    void* out, void* lse, int B, int H, int Tq, int Tk,
                                    float scale, void* stream) {
  const int smem = smem_bytes((Tk + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}
