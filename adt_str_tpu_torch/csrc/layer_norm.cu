// LayerNorm over the last dimension with fp32 statistics, for Hopper (sm_90a).
//
// No TPU kernel: a repair of the port. The plain version
// (ops/layer_norm.py:layer_norm_plain, the formula of the JAX package's
// models/transformer.py:layer_norm) takes its mean and variance with ATen's
// reductions, whose launch shape (and so the order of the fp32 sums) follows
// the number of rows: on the card a row's statistics, and from them the
// decode's tokens, moved with the rows decoded beside it. Here one warp owns
// one row, and the order of every sum is fixed by d alone:
//     mean = (sum_lanes (sum_j x[32 j + lane])) / d        lane sums in j order, then a xor butterfly
//     var  = (sum_lanes (sum_j (x - mean)^2)) / d          the plain formula's two passes
//     y    = T(((x - mean) * (1 / sqrt(var + eps))) * w + b)
// each product and sum rounded on its own (the _rn intrinsics are never
// contracted into an FMA), as the plain version's separate tensor ops are;
// the rows beside it do not enter any of it.
//
// Bound on an H100: bytes (each input read once, the output written once;
// a few flops an element). A row of d <= 1024 stays in registers (32 values
// a lane) between the passes, so x is read from device memory once. Eight
// rows (warps) a block of 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int MAXV = 32;  // values a lane: d <= 32 * 32

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
                  T* __restrict__ y, long long rows, int d, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[MAXV];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = 32 * j + lane;
    v[j] = i < d ? to_f32(xr[i]) : 0.f;
    s = __fadd_rn(s, v[j]);
  }
  const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(d));
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    if (32 * j + lane < d) {
      v[j] = __fsub_rn(v[j], mean);
      q = __fadd_rn(q, __fmul_rn(v[j], v[j]));
    }
  }
  const float var = __fdiv_rn(warp_sum(q), static_cast<float>(d));
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = 32 * j + lane;
    if (i < d) yr[i] = from_f32<T>(__fadd_rn(__fmul_rn(__fmul_rn(v[j], r), w[i]), b[i]));
  }
}

}  // namespace

extern "C" int layer_norm_max_d() { return 32 * MAXV; }

// Launch on `stream`; returns 0 or a cudaError_t. `x` and `y` are contiguous
// (rows, d) of `dtype` (0: fp32, 1: bf16), `w` and `b` fp32 (d,); 0 < d <= 1024.
extern "C" int launch_layer_norm(const void* x, const void* w, const void* b, void* y, long long rows, int d,
                                 float eps, int dtype, void* stream) {
  if (d <= 0 || d > 32 * MAXV || rows < 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0)
    layer_norm_kernel<float><<<blocks, WARPS * 32, 0, st>>>(static_cast<const float*>(x), wf, bf,
                                                              static_cast<float*>(y), rows, d, eps);
  else
    layer_norm_kernel<__nv_bfloat16><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf, static_cast<__nv_bfloat16*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}
