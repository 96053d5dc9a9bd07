// LayerNorm over the last dimension with fp32 statistics, alone or with the
// residual add fused in front of it, for Hopper (sm_90a).
//
// No TPU kernel: a repair of the port. The plain version
// (ops/layer_norm.py:layer_norm_plain, the formula of the JAX package's
// models/transformer.py:layer_norm) takes its mean and variance with ATen's
// reductions, whose launch shape (and so the order of the fp32 sums) follows
// the number of rows: on the card a row's statistics, and from them the
// decode's tokens, moved with the rows decoded beside it. Here one warp owns
// one row, and the order of every sum is fixed by d alone:
//     v    = x                       (layer_norm)
//     v    = T(x + r)                (add_layer_norm: the sum rounded to T, as ATen's add rounds it)
//     mean = (sum_lanes (sum_j v[32 j + lane])) / d        lane sums in j order, then a xor butterfly
//     var  = (sum_lanes (sum_j (v - mean)^2)) / d          the plain formula's two passes
//     y    = T(((v - mean) * (1 / sqrt(var + eps))) * w + b)
// each product and sum rounded on its own (the _rn intrinsics are never
// contracted into an FMA), as the plain version's separate tensor ops are;
// the rows beside it do not enter any of it. add_layer_norm(x, r) is
// therefore bit-equal to layer_norm(x + r).
//
// Bound on an H100: bytes (each input read once, the output written once;
// a few flops an element), and at the decode step's 16 rows the latency of
// one row's loads. So:
//   - a warp copies its row of x (and of r) into shared memory with 16-byte
//     cp.async, every copy of the row in flight at once (3 a lane for a
//     768-wide bf16 row), instead of 24 dependent 2-byte loads a lane; the
//     block copies w and b (fp32) into shared memory once, instead of every
//     warp loading them an element at a time from global memory;
//   - each lane then reads its strided elements l, l + 32, ... from shared
//     memory (bf16 and fp32 at stride 32 are free of bank conflicts), keeps
//     them in registers (32 a lane, d <= 1024) between the passes, writes
//     y's row back into its staging buffer and out with 16-byte stores;
//   - past d 1,024 a row no longer fits a lane's registers:
//     `layer_norm_wide_kernel` reads each lane's elements from device
//     memory (L2 after the first pass) on each of the three passes instead,
//     with the same sums in the same order (at any d: no shared memory);
//   - rows a block (warps) by row count, which touches no sum: 8 while the
//     grid keeps at least two blocks an SM (the encoder's 16 x 246 = 3,936
//     rows: 492 blocks), else halved down to 1, so the decode's 16 rows run
//     as 16 blocks on 16 SMs instead of 2 blocks on 2.
// Rows whose bytes are not a multiple of 16, or pointers not 16-byte
// aligned, are copied an element at a time (the same values, so the same bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_WARPS = 8;
constexpr int MAXV = 32;  // values a lane: d <= 32 * 32

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// `elems` elements of `T` from global `src` to shared `dst` by the `n` threads
// `t` of a group: 16-byte cp.async chunks when `vec`, else one element at a time.
template <typename T>
__device__ inline void stage(void* dst, const void* src, int elems, bool vec, int t, int n) {
  if (vec) {
    const int chunks = elems * static_cast<int>(sizeof(T)) / 16;
    for (int c = t; c < chunks; c += n)
      cp_async_16(static_cast<uint8_t*>(dst) + 16 * c, static_cast<const uint8_t*>(src) + 16 * c, true);
  } else {
    for (int i = t; i < elems; i += n) static_cast<T*>(dst)[i] = static_cast<const T*>(src)[i];
  }
}

// Shared memory: w and b (fp32, `dp` each), then a warp's x row and, with
// kResidual, its r row (`dp` elements of T each); dp = d rounded up to 8, so
// every buffer starts 16-byte aligned.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(MAX_WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, long long rows, int d, float eps, bool vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int dp = (d + 7) & ~7;
  float* ws = reinterpret_cast<float*>(smem);
  float* bs = ws + dp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* xs = reinterpret_cast<T*>(bs + dp) + warp * (kResidual ? 2 : 1) * dp;
  T* rs = xs + dp;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  const bool live = row < rows;

  stage<float>(ws, w, d, vec, threadIdx.x, blockDim.x);
  stage<float>(bs, b, d, vec, threadIdx.x, blockDim.x);
  if (live) {
    stage<T>(xs, x + row * d, d, vec, lane, 32);
    if constexpr (kResidual) stage<T>(rs, res + row * d, d, vec, lane, 32);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;

  float v[MAXV];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = 32 * j + lane;
    if constexpr (kResidual)
      v[j] = i < d ? to_float(from_float<T>(__fadd_rn(to_float(xs[i]), to_float(rs[i])))) : 0.f;
    else
      v[j] = i < d ? to_float(xs[i]) : 0.f;
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
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  T* yr = y + row * d;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int i = 32 * j + lane;
    if (i < d) {
      const T out = from_float<T>(__fadd_rn(__fmul_rn(__fmul_rn(v[j], rstd), ws[i]), bs[i]));
      if (vec)
        xs[i] = out;  // each lane rewrites only the elements it read
      else
        yr[i] = out;
    }
  }
  if (vec) {
    __syncwarp();
    const int chunks = d * static_cast<int>(sizeof(T)) / 16;
    for (int c = lane; c < chunks; c += 32)
      reinterpret_cast<uint4*>(yr)[c] = reinterpret_cast<const uint4*>(xs)[c];
  }
}

// Past 32 * MAXV values a row: the same arithmetic in the same order, each
// pass reading the lane's elements l, l + 32, ... from device memory.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(MAX_WARPS * 32)
layer_norm_wide_kernel(const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y, long long rows, int d, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (row >= rows) return;
  const T* xr = x + row * d;
  const T* rr = kResidual ? res + row * d : nullptr;
  auto value = [&](int i) {
    if constexpr (kResidual)
      return to_float(from_float<T>(__fadd_rn(to_float(xr[i]), to_float(rr[i]))));
    else
      return to_float(xr[i]);
  };
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s = __fadd_rn(s, value(i));
  const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(d));
  float q = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = __fsub_rn(value(i), mean);
    q = __fadd_rn(q, __fmul_rn(v, v));
  }
  const float var = __fdiv_rn(warp_sum(q), static_cast<float>(d));
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  T* yr = y + row * d;
  for (int i = lane; i < d; i += 32)
    yr[i] = from_float<T>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(value(i), mean), rstd), w[i]), b[i]));
}

int smem_bytes(int d, int warps, int elem, bool residual) {
  const int dp = (d + 7) & ~7;
  return 2 * dp * 4 + warps * (residual ? 2 : 1) * dp * elem;
}

template <typename T, bool kResidual>
int launch(const void* x, const void* r, const float* w, const float* b, void* y, long long rows, int d, float eps,
           cudaStream_t st) {
  static SmemLimit limit;
  static int sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    if (dev < 64) sms[dev] = n_sm;
  }
  int warps = MAX_WARPS;
  while (warps > 1 && (rows + warps - 1) / warps < 2LL * n_sm) warps /= 2;
  if (d > 32 * MAXV) {
    const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
    layer_norm_wide_kernel<T, kResidual><<<blocks, warps * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), w, b, static_cast<T*>(y), rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (int err = limit.ensure(layer_norm_kernel<T, kResidual>,
                             smem_bytes(32 * MAXV, MAX_WARPS, sizeof(T), kResidual)))
    return err;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool vec = (d * static_cast<int>(sizeof(T))) % 16 == 0 && d % 4 == 0 && aligned(x) && aligned(y) &&
                   aligned(w) && aligned(b) && (!kResidual || aligned(r));
  const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
  layer_norm_kernel<T, kResidual><<<blocks, warps * 32, smem_bytes(d, warps, sizeof(T), kResidual), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), w, b, static_cast<T*>(y), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The widest row whose values a lane keeps in registers; wider rows take `layer_norm_wide_kernel`.
extern "C" int layer_norm_register_d() { return 32 * MAXV; }

// Launch on `stream`; returns 0 or a cudaError_t. `x`, `r` (nullptr:
// layer_norm, else add_layer_norm) and `y` are contiguous (rows, d) of
// `dtype` (0: fp32, 1: bf16, 2: fp16), `w` and `b` fp32 (d,); d > 0.
extern "C" int launch_layer_norm(const void* x, const void* r, const void* w, const void* b, void* y, long long rows,
                                 int d, float eps, int dtype, void* stream) {
  if (d <= 0 || rows < 0 || dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0)
    return r == nullptr ? launch<float, false>(x, r, wf, bf, y, rows, d, eps, st)
                        : launch<float, true>(x, r, wf, bf, y, rows, d, eps, st);
  if (dtype == 1)
    return r == nullptr ? launch<__nv_bfloat16, false>(x, r, wf, bf, y, rows, d, eps, st)
                        : launch<__nv_bfloat16, true>(x, r, wf, bf, y, rows, d, eps, st);
  return r == nullptr ? launch<__half, false>(x, r, wf, bf, y, rows, d, eps, st)
                      : launch<__half, true>(x, r, wf, bf, y, rows, d, eps, st);
}
