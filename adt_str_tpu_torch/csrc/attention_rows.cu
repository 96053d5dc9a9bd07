// Inference attention, one query row a block, for Hopper (sm_90a).
//
// No TPU kernel: a repair of the port. The plain version
// (ops/attention_rows.py:attention_plain, the JAX package's
// models/transformer.py:attention_core) is two batched cuBLAS products
// around ATen's softmax; on the card cuBLAS picks its algorithm by the batch
// count, so the decode step's attention (greedy self and cross, the beam's
// gathered self rows and its per-item cross rows) gave a row other bits
// beside other rows. Here a block computes one query row of one head, and
// every sum runs in an order fixed by the head dim and the key count:
//     s_t = (sum_j q_j k_tj) / sqrt(hd) + mask_t     fp32; lane sums in j order, then a xor butterfly
//     p_t = T(exp(s_t - max s) / sum_t exp(s_t - max s))     the sum: thread sums in t order, then a fixed tree
//     out_j = T(sum_t p_t v_tj)                     fp32, t ascending
// with q, k, v of type T (bf16 or fp32), as the plain version rounds them:
// scores in fp32 from the upcast q and k, probabilities cast to T before
// the product with v, fp32 accumulation, the output in T.
//
// Bound on an H100: bytes. The decode step reads each head's k and v rows
// once a query row (the cache up to max_length keys for self-attention,
// the encoder memory for cross-attention); a few flops a byte. The design is
// the simple one: 128 threads; the scores (one fp32 a key) and the query in
// shared memory; a warp a key for the scores, a thread an output dim for
// p . v. The beam's K query rows of one item read its cross rows K times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int MAX_KEYS = 4096;  // fp32 scores in shared memory
constexpr int MAX_HD = 256;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f32(float x);
template <> __device__ inline float from_f32<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Strides {  // elements; the last dim of q, k, v is contiguous
  long long q[3], k[3], v[3], m[4];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ mask, T* __restrict__ out, Strides st, int H, int Tq, int Tk, int hd,
                      float scale) {
  __shared__ float qs[MAX_HD];
  __shared__ float p[MAX_KEYS];
  __shared__ float red[WARPS];
  const int i = blockIdx.x, h = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long n = blockIdx.z;
  const T* qr = q + n * st.q[0] + h * st.q[1] + i * st.q[2];
  for (int j = tid; j < hd; j += THREADS) qs[j] = to_f32(qr[j]);
  __syncthreads();

  const T* kb = k + n * st.k[0] + h * st.k[1];
  const float* mr = mask == nullptr ? nullptr : mask + n * st.m[0] + h * st.m[1] + i * st.m[2];
  for (int t = warp; t < Tk; t += WARPS) {
    const T* kr = kb + t * st.k[2];
    float s = 0.f;
    for (int j = lane; j < hd; j += 32) s = __fmaf_rn(qs[j], to_f32(kr[j]), s);
    s = __fdiv_rn(warp_sum(s), scale);
    if (lane == 0) p[t] = mr == nullptr ? s : __fadd_rn(s, mr[t * st.m[3]]);
  }
  __syncthreads();

  float m = -INFINITY;
  for (int t = tid; t < Tk; t += THREADS) m = fmaxf(m, p[t]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused below

  float sum = 0.f;
  for (int t = tid; t < Tk; t += THREADS) {
    const float e = expf(__fsub_rn(p[t], m));
    p[t] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, red[w]);
  for (int t = tid; t < Tk; t += THREADS) p[t] = to_f32(from_f32<T>(__fdiv_rn(p[t], sum)));
  __syncthreads();

  const T* vb = v + n * st.v[0] + h * st.v[1];
  T* o = out + ((n * H + h) * Tq + i) * static_cast<long long>(hd);
  for (int j = tid; j < hd; j += THREADS) {
    float a = 0.f;
    for (int t = 0; t < Tk; ++t) a = __fmaf_rn(p[t], to_f32(vb[t * st.v[2] + j]), a);
    o[j] = from_f32<T>(a);
  }
}

}  // namespace

extern "C" int attention_rows_max_keys() { return MAX_KEYS; }
extern "C" int attention_rows_max_head_dim() { return MAX_HD; }

// Launch on `stream`; returns 0 or a cudaError_t. q (N, H, Tq, hd), k and v
// (N, H, Tk, hd) of `dtype` (0: fp32, 1: bf16) with the strides (elements)
// of their first three dims in `strides[0:3]`, `[3:6]`, `[6:9]` and a
// contiguous last dim; `mask` null or fp32 with the strides of its
// (N, H, Tq, Tk) broadcast in `strides[9:13]`; `out` a contiguous
// (N, H, Tq, hd) of `dtype`. 1 <= Tk <= 4096, 1 <= hd <= 256.
extern "C" int launch_attention_rows(const void* q, const void* k, const void* v, const void* mask, void* out,
                                     const long long* strides, int N, int H, int Tq, int Tk, int hd, float scale,
                                     int dtype, void* stream) {
  if (N < 0 || H <= 0 || Tq <= 0 || Tk <= 0 || Tk > MAX_KEYS || hd <= 0 || hd > MAX_HD || N > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  Strides st;
  for (int d = 0; d < 3; ++d) {
    st.q[d] = strides[d];
    st.k[d] = strides[3 + d];
    st.v[d] = strides[6 + d];
  }
  for (int d = 0; d < 4; ++d) st.m[d] = strides[9 + d];
  const dim3 grid(Tq, H, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 1)
    attention_rows_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), m, static_cast<__nv_bfloat16*>(out), st, H, Tq, Tk, hd, scale);
  else
    attention_rows_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                          static_cast<const float*>(v), m, static_cast<float*>(out), st,
                                                          H, Tq, Tk, hd, scale);
  return static_cast<int>(cudaGetLastError());
}
