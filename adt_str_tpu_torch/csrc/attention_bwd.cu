// K5 backward: fused short-sequence attention gradients for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_vjp_bwd (_bwd_kernel). For
// each (batch b, head h), with s = (q k^T) * scale + mask as in the forward
// and the forward's lse (which counts the caller's virtual keys):
//     p = exp(s - lse);  delta_i = sum_d do_id * out_id
//     dv = p^T do;  dp = do v^T;  ds = p * (dp - delta) * scale
//     dq = ds k;  dk = ds^T q
// q, k, v, out, do are bf16 (B, H, T, 128); dq, dk, dv are written bf16.
//
// Bound on an H100: at the decoder's training shapes (Tq = Tk = 511, B = 64,
// 6 heads) the five products are 10*Tq*Tk*128 flops per head, 128 GFLOP
// (130 us at 989 TFLOP/s); the bytes (q, k, v, out, do, dq, dk, dv in bf16,
// the fp32 mask and lse) are about 470 MB (140 us at 3.35 TB/s). The two are
// close; the design keeps every (Tq, Tk) intermediate on the SM:
//   - a small kernel takes delta = rowsum(do * out) in fp32;
//   - dk/dv kernel: one block per (64-key tile, head, batch item) loops over
//     64-query tiles, recomputes s and dp with tensor cores, forms p and ds
//     in fp32, and accumulates dv += p^T do and dk += ds^T q in fp32
//     fragments that stay in registers for the whole loop;
//   - dq kernel: one block per (64-query tile, head, batch item) loops over
//     64-key tiles the same way and accumulates dq += ds k.
// No atomics, so the result is deterministic. s and dp are recomputed in
// both kernels. All products run on bf16 tensor cores (nvcuda::wmma) with
// fp32 accumulation; q, k, v and do are bf16 already, so q k^T and do v^T
// are exact products, but p and ds are rounded to bf16 to enter the
// p^T do, ds^T q and ds k products (the TPU kernel keeps them in fp32): a
// relative error of at most 2^-9 per term, below the bf16 rounding of the
// outputs. No TMA, wgmma or pipelining yet: this is the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BT = 64;        // query rows and key rows per tile
constexpr int D = 128;        // head dim
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDQ = D + 8;    // bf16 row stride of the q, k, v, do tiles
constexpr int LDS = BT + 4;   // fp32 row stride of the s and dp tiles
constexpr int LDP = BT + 8;   // bf16 row stride of the p and ds tiles
constexpr int LDO = D + 4;    // fp32 row stride of the output staging tile

constexpr int TILE_IN = BT * LDQ * 2;   // one bf16 input tile
constexpr int TILE_S = BT * LDS * 4;    // one fp32 score tile
constexpr int TILE_P = BT * LDP * 2;    // one bf16 p / ds tile
static_assert(2 * TILE_S >= BT * LDO * 4, "the output staging tile reuses the s and dp tiles");

// the dk/dv kernel holds q, do, k, v, s, dp, p, ds, lse, delta; the dq kernel the same but p
constexpr int SMEM_KV = 4 * TILE_IN + 2 * TILE_S + 2 * TILE_P + 2 * BT * 4;
constexpr int SMEM_Q = 4 * TILE_IN + 2 * TILE_S + TILE_P + 2 * BT * 4;

__device__ inline void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int valid) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = v;
  }
}

__device__ inline void load_row_stats(float* lse_s, float* delta_s, const float* lse, const float* delta,
                                      int q0, int Tq) {
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    const bool ok = q0 + i < Tq;
    lse_s[i] = ok ? lse[q0 + i] : 0.f;
    delta_s[i] = ok ? delta[q0 + i] : 0.f;
  }
}

// s = q k^T and dp = do v^T for one (64 query, 64 key) tile pair, unscaled, fp32
__device__ inline void tile_products(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                     const __nv_bfloat16* dos, const __nv_bfloat16* vs,
                                     float* s, float* dp, int warp) {
  for (int t = warp; t < (BT / 16) * (BT / 16); t += WARPS) {
    const int rt = t % (BT / 16), ct = t / (BT / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
    wmma::fill_fragment(acc_s, 0.f);
    wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, qs + rt * 16 * LDQ + d0, LDQ);
      wmma::load_matrix_sync(fb, ks + ct * 16 * LDQ + d0, LDQ);
      wmma::mma_sync(acc_s, fa, fb, acc_s);
      wmma::load_matrix_sync(fa, dos + rt * 16 * LDQ + d0, LDQ);
      wmma::load_matrix_sync(fb, vs + ct * 16 * LDQ + d0, LDQ);
      wmma::mma_sync(acc_p, fa, fb, acc_p);
    }
    wmma::store_matrix_sync(s + rt * 16 * LDS + ct * 16, acc_s, LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(dp + rt * 16 * LDS + ct * 16, acc_p, LDS, wmma::mem_row_major);
  }
}

// p = exp(s * scale + mask - lse) and ds = p (dp - delta) scale as bf16 tiles
// [query][key]; zero outside (Tq, Tk). `p_out` may be null.
__device__ inline void tile_softmax_grad(const float* s, const float* dp, __nv_bfloat16* p_out,
                                         __nv_bfloat16* ds_out, const float* lse_s, const float* delta_s,
                                         const float* mask_b, int Tq, int Tk, int q0, int k0, float scale) {
  for (int i = threadIdx.x; i < BT * BT; i += THREADS) {
    const int r = i / BT, c = i % BT;
    const int qi = q0 + r, kj = k0 + c;
    float p = 0.f, ds = 0.f;
    if (qi < Tq && kj < Tk) {
      float x = s[r * LDS + c] * scale;
      if (mask_b != nullptr) x += mask_b[static_cast<size_t>(qi) * Tk + kj];
      p = expf(x - lse_s[r]);
      ds = p * (dp[r * LDS + c] - delta_s[r]) * scale;
    }
    if (p_out != nullptr) p_out[r * LDP + c] = __float2bfloat16_rn(p);
    ds_out[r * LDP + c] = __float2bfloat16_rn(ds);
  }
}

// an fp32 (64, 128) accumulator tile (warp: row tile warp & 3, columns from (warp >> 2) * 64)
// -> bf16 rows row0.. of a (valid, D) matrix, through the staging tile
__device__ inline void store_tile(wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[4],
                                  float* stage, __nv_bfloat16* dst, int row0, int valid, int warp) {
  const int rt = warp & 3, c0 = (warp >> 2) * 64;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(stage + rt * 16 * LDO + c0 + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BT * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (row0 + r >= valid) continue;
    const float* src = stage + r * LDO + c;
    __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16_rn(src[e]);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * D + c) = *reinterpret_cast<const uint4*>(o8);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) attention_delta_kernel(
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* o = out + static_cast<size_t>(row) * D;
  const __nv_bfloat16* g = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int c = lane + 32 * i;
    sum += __bfloat162float(o[c]) * __bfloat162float(g[c]);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

struct Smem {
  __nv_bfloat16 *qs, *dos, *ks, *vs, *ps, *dss;
  float *s, *dp, *lse, *delta;
};

__device__ inline Smem carve(unsigned char* smem, bool with_p) {
  Smem m;
  m.qs = reinterpret_cast<__nv_bfloat16*>(smem);
  m.dos = m.qs + BT * LDQ;
  m.ks = m.dos + BT * LDQ;
  m.vs = m.ks + BT * LDQ;
  m.s = reinterpret_cast<float*>(smem + 4 * TILE_IN);
  m.dp = m.s + BT * LDS;
  m.dss = reinterpret_cast<__nv_bfloat16*>(smem + 4 * TILE_IN + 2 * TILE_S);
  m.ps = with_p ? m.dss + BT * LDP : nullptr;
  m.lse = reinterpret_cast<float*>(smem + 4 * TILE_IN + 2 * TILE_S + (with_p ? 2 : 1) * TILE_P);
  m.delta = m.lse + BT;
  return m;
}

__global__ void __launch_bounds__(THREADS) attention_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int Tq, int Tk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem, true);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  const int bh = b * H + h, warp = threadIdx.x >> 5;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  load_rows(m.ks, k + koff, k0, Tk);
  load_rows(m.vs, v + koff, k0, Tk);
  // warp owns key row tile (warp & 3) and 64 columns from (warp >> 2) * 64 of dk and dv
  const int rt = warp & 3, c0 = (warp >> 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[4], acc_dv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }
  for (int q0 = 0; q0 < Tq; q0 += BT) {
    __syncthreads();  // the previous query tile is no longer read
    load_rows(m.qs, q + qoff, q0, Tq);
    load_rows(m.dos, dout + qoff, q0, Tq);
    load_row_stats(m.lse, m.delta, lse + static_cast<size_t>(bh) * Tq, delta + static_cast<size_t>(bh) * Tq, q0, Tq);
    __syncthreads();
    tile_products(m.qs, m.ks, m.dos, m.vs, m.s, m.dp, warp);
    __syncthreads();
    tile_softmax_grad(m.s, m.dp, m.ps, m.dss, m.lse, m.delta, mask_b, Tq, Tk, q0, k0, scale);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      // p^T and ds^T: (key, query) element at [query][key], a column-major load
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fp, fds;
      wmma::load_matrix_sync(fp, m.ps + kk * LDP + rt * 16, LDP);
      wmma::load_matrix_sync(fds, m.dss + kk * LDP + rt * 16, LDP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, m.dos + kk * LDQ + c0 + j * 16, LDQ);
        wmma::mma_sync(acc_dv[j], fp, fb, acc_dv[j]);
        wmma::load_matrix_sync(fb, m.qs + kk * LDQ + c0 + j * 16, LDQ);
        wmma::mma_sync(acc_dk[j], fds, fb, acc_dk[j]);
      }
    }
  }
  __syncthreads();  // the s and dp tiles become the staging tile
  store_tile(acc_dv, m.s, dv + koff, k0, Tk, warp);
  store_tile(acc_dk, m.s, dk + koff, k0, Tk, warp);
}

__global__ void __launch_bounds__(THREADS) attention_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int H, int Tq, int Tk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem, false);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int bh = b * H + h, warp = threadIdx.x >> 5;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  load_rows(m.qs, q + qoff, q0, Tq);
  load_rows(m.dos, dout + qoff, q0, Tq);
  load_row_stats(m.lse, m.delta, lse + static_cast<size_t>(bh) * Tq, delta + static_cast<size_t>(bh) * Tq, q0, Tq);
  // warp owns query row tile (warp & 3) and 64 columns from (warp >> 2) * 64 of dq
  const int rt = warp & 3, c0 = (warp >> 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < Tk; k0 += BT) {
    __syncthreads();  // the previous key tile is no longer read
    load_rows(m.ks, k + koff, k0, Tk);
    load_rows(m.vs, v + koff, k0, Tk);
    __syncthreads();
    tile_products(m.qs, m.ks, m.dos, m.vs, m.s, m.dp, warp);
    __syncthreads();
    tile_softmax_grad(m.s, m.dp, nullptr, m.dss, m.lse, m.delta, mask_b, Tq, Tk, q0, k0, scale);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fds;
      wmma::load_matrix_sync(fds, m.dss + rt * 16 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, m.ks + kk * LDQ + c0 + j * 16, LDQ);
        wmma::mma_sync(acc[j], fds, fb, acc[j]);
      }
    }
  }
  __syncthreads();
  store_tile(acc, m.s, dq + qoff, q0, Tq, warp);
}

}  // namespace

extern "C" int attention_bwd_head_dim() { return D; }

// Launch the three kernels on `stream`; returns cudaGetLastError() (0 on
// success). The caller checks: bf16 contiguous q, k, v, out, do with head
// dim 128, a contiguous fp32 (B, Tq, Tk) mask or null, fp32 (B, H, Tq) lse,
// an fp32 (B, H, Tq) scratch `delta`, and bf16 outputs of q's and k's shapes.
extern "C" int launch_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                    const void* out, const void* lse, const void* dout, void* delta,
                                    void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_KV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_Q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(out);
  const auto* gb = static_cast<const __nv_bfloat16*>(dout);
  const auto* mf = static_cast<const float*>(mask);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  const int rows = B * H * Tq;
  attention_delta_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0, st>>>(ob, gb, df, rows);
  attention_bwd_dkdv_kernel<<<dim3((Tk + BT - 1) / BT, H, B), THREADS, SMEM_KV, st>>>(
      qb, kb, vb, mf, lf, gb, df, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H, Tq, Tk, scale);
  attention_bwd_dq_kernel<<<dim3((Tq + BT - 1) / BT, H, B), THREADS, SMEM_Q, st>>>(
      qb, kb, vb, mf, lf, gb, df, static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}
