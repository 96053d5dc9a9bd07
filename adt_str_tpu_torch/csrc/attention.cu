// K5 forward: fused short-sequence attention for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel). For each
// (batch b, head h) and query row i:
//     s_ij = (q_i . k_j) * scale + mask[b, i, j]       (fp32; mask optional, shared over heads)
//     m_i = max(max_j s_ij, -1e4 if n_virtual > 0)
//     l_i = sum_j exp(s_ij - m_i) + n_virtual * exp(-1e4 - m_i)
//     lse_i = m_i + log(l_i)
//     p_ij = bf16(exp(s_ij - m_i) / l_i)
//     out_i = bf16(sum_j p_ij v_j)                        (fp32 accumulation)
// q, k, v are bf16 (B, H, T, 128); 1 <= Tk <= 512. The n_virtual keys are
// those the JAX caller pads on (score exactly -1e4, v = 0): they are counted
// in l and lse without being stored.
//
// Bound on an H100: at the decoder's training shapes (Tq = Tk = 511, head
// dim 128, B = 64, 6 heads) the flops are 4*Tq*Tk*128 per head, 51 GFLOP
// (52 us at 989 TFLOP/s), while q, k, v, out and the fp32 mask are about
// 270 MB (81 us at 3.35 TB/s): it is bound by memory. The design reads q
// once, K and V once per 32-row query tile, and keeps scores and
// probabilities on the SM:
//   - one block per (32 query rows, head, batch item), 8 warps;
//   - the block's 32 fp32 score rows for all keys stay in shared memory
//     (32 x 520 x 4 B = 66.5 KB at Tk = 512) while K is streamed through in
//     64-key tiles, so the exact two-pass softmax of the TPU kernel applies
//     (max, exp, sum, divide) with p cast to bf16 before P.V exactly where
//     the TPU kernel casts it; an online softmax would round elsewhere;
//   - V is then streamed through the same 64-key tile buffer for P.V;
//   - Q.K^T and P.V run on bf16 tensor cores (nvcuda::wmma) with fp32
//     accumulators; p is written as bf16 over its own fp32 score row;
//   - ragged Tq and Tk are handled here: rows past T are zero-filled in
//     shared memory and masked out of the softmax, so no caller pads to 8.
// About 91 KB of shared memory a block, two blocks an SM. No TMA, wgmma or
// pipelining yet: this is the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>

using namespace nvcuda;

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per streamed K/V tile
constexpr int D = 128;        // head dim
constexpr int MAX_TK = 512;   // keys whose fp32 scores a block holds
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDQ = D + 8;    // bf16 row stride of the Q and K/V tiles
constexpr int LDO = D + 4;    // fp32 row stride of the output tile
constexpr float NEG_MASK = -1e4f;

static_assert(BK * LDQ * 2 >= BQ * LDO * 4, "the output tile reuses the K/V tile buffer");

__host__ __device__ inline int pad_keys(int tk) { return (tk + BK - 1) / BK * BK; }

__host__ __device__ inline int smem_bytes(int tk_pad) {
  return BQ * LDQ * 2 + BK * LDQ * 2 + BQ * (tk_pad + 8) * 4;
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
    int H, int Tq, int Tk, int n_virtual, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tk_pad = pad_keys(Tk);
  const int lds = tk_pad + 8;  // fp32 row stride of the score rows
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kv = qs + BQ * LDQ;
  float* sc = reinterpret_cast<float*>(smem + BQ * LDQ * 2 + BK * LDQ * 2);
  float* os = reinterpret_cast<float*>(kv);  // output tile, after P.V

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int bh = b * H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * Tk * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * Tk * D;

  load_rows(qs, q + static_cast<size_t>(bh) * Tq * D, q0, BQ, Tq);

  // scores, one 64-key tile at a time: warp -> row tile (warp & 1), key sub-tile (warp >> 1)
  {
    const int rt = warp & 1, ct = warp >> 1;
    for (int k0 = 0; k0 < tk_pad; k0 += BK) {
      __syncthreads();  // Q is loaded; the previous K tile is no longer read
      load_rows(kv, kg, k0, BK, Tk);
      __syncthreads();
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
      wmma::store_matrix_sync(sc + rt * 16 * lds + k0 + ct * 16, acc, lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // exact softmax, one warp per row; each lane holds up to 16 of the row's scores
  for (int r = warp; r < BQ; r += WARPS) {
    const int qi = q0 + r;
    float* srow = sc + r * lds;
    const float* mrow = (mask != nullptr && qi < Tq) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
    float vals[MAX_TK / 32];
    float m = n_virtual > 0 ? NEG_MASK : -FLT_MAX;
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
    if (n_virtual > 0) sum += static_cast<float>(n_virtual) * expf(NEG_MASK - m);
    __syncwarp();  // the whole row is read before p overwrites it
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(srow);
#pragma unroll
    for (int i = 0; i < MAX_TK / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < tk_pad) prow[j] = __float2bfloat16_rn(j < Tk ? vals[i] / sum : 0.f);
    }
    if (lane == 0 && qi < Tq) lse[static_cast<size_t>(bh) * Tq + qi] = m + logf(sum);
  }

  // out tile 32 x 128: warp owns row tile (warp & 1) and 32 columns from (warp >> 1) * 32
  const int rt = warp & 1, c0 = (warp >> 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
  const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(sc);
  for (int k0 = 0; k0 < tk_pad; k0 += BK) {
    __syncthreads();  // p is written; the previous V tile is no longer read
    load_rows(kv, vg, k0, BK, Tk);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, ps + rt * 16 * (2 * lds) + k0 + kk, 2 * lds);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, kv + kk * LDQ + c0 + j * 16, LDQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();  // every warp is done with V before the output tile overwrites it
#pragma unroll
  for (int j = 0; j < 2; ++j)
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
// checks: bf16 contiguous q, k, v with head dim 128, 1 <= Tk <= 512,
// n_virtual >= 0, a contiguous fp32 (B, Tq, Tk) mask or null, outputs of
// the right shapes.
extern "C" int launch_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                    void* out, void* lse, int B, int H, int Tq, int Tk,
                                    int n_virtual, float scale, void* stream) {
  const int smem = smem_bytes(pad_keys(Tk));
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Tq, Tk, n_virtual, scale);
  return static_cast<int>(cudaGetLastError());
}
