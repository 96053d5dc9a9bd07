// K2: one-shot bank gather + mixup blend for Hopper (sm_90a).
//
// Replaces adt_str_tpu/synth/pallas_place.py:gather_blend (_gather_blend_kernel).
// For a (n_rows, L) bank `table` (f32 or bf16), N requests of row ids
// (main, sub) and f32 weights lam:
//     out[i, :] = T((1 - lam_i) * f32(table[main_i, :]) + lam_i * f32(table[sub_i, :]))
// each product and sum rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn:
// nvcc never contracts the intrinsics into an FMA), then rounded to the
// table's type (__float2bfloat16_rn for bf16). A row id outside [0, n_rows)
// is clamped into it, as JAX's gathers clamp. ops/place.py:gather_blend_plain
// computes the same operations, so the two are bit-equal.
//
// Bound on an H100: a pure stream. At the training shape (N = 64 * 27 = 1728
// requests of L = 30720 bf16) it reads 2 * 1728 rows and writes 1728, about
// 318.5 MB, 0.095 ms at 3.35 TB/s; the three f32 operations per element are
// nothing beside that. The risk is the gather itself: the rows lie anywhere
// in a bank of several GiB, so each row's first touch can miss the TLB (the
// TPU kernel measured per-DMA address translation as its limit).
// The design: one block of 256 threads per (request, 256 * V elements of
// the row); each thread moves one 16-byte vector (V = 8 bf16 or 4 f32) of
// the main row and of the sub row and writes one vector of the blend. Row
// offsets are 64-bit: a production bank has more than 2^31 elements.
// V = 1 when a row is not a whole number of 16-byte vectors.
// No TMA or pipelining yet: this is the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f32(float x);
template <> __device__ inline float from_f32<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gather_blend_kernel(const T* __restrict__ table, const int* __restrict__ idx_main, const int* __restrict__ idx_sub,
                    const float* __restrict__ lam, T* __restrict__ out, int n_rows, int L) {
  const int req = blockIdx.x;
  const long long v = static_cast<long long>(blockIdx.y) * THREADS + threadIdx.x;  // vector within the row
  if (v * V >= L) return;
  const float l = lam[req];
  const float w = __fsub_rn(1.f, l);
  const T* m = table + static_cast<long long>(min(max(idx_main[req], 0), n_rows - 1)) * L + v * V;
  const T* s = table + static_cast<long long>(min(max(idx_sub[req], 0), n_rows - 1)) * L + v * V;
  T* o = out + static_cast<long long>(req) * L + v * V;
  alignas(16) T mv[V];
  alignas(16) T sv[V];
  alignas(16) T ov[V];
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(mv) = *reinterpret_cast<const uint4*>(m);
    *reinterpret_cast<uint4*>(sv) = *reinterpret_cast<const uint4*>(s);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mv[k] = m[k];
      sv[k] = s[k];
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ov[k] = from_f32<T>(__fadd_rn(__fmul_rn(w, to_f32(mv[k])), __fmul_rn(l, to_f32(sv[k]))));
  }
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(ov);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = ov[k];
  }
}

template <typename T, int V>
cudaError_t launch(const void* table, const int* im, const int* is, const float* lam, void* out, int n,
                   int n_rows, int L, cudaStream_t stream) {
  const long long vecs = (static_cast<long long>(L) + V - 1) / V;
  const dim3 grid(n, static_cast<unsigned>((vecs + THREADS - 1) / THREADS));
  gather_blend_kernel<T, V><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(table), im, is, lam,
                                                          static_cast<T*>(out), n_rows, L);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16; + 2 for 16-byte vectors (L * sizeof(T) % 16 == 0 and
// 16-byte aligned table and out). n_rows >= 1: the bank's row count.
extern "C" int launch_gather_blend(const void* table, const void* idx_main, const void* idx_sub, const void* lam,
                                   void* out, int n, int n_rows, int L, int dtype, void* stream) {
  const int* im = static_cast<const int*>(idx_main);
  const int* is = static_cast<const int*>(idx_sub);
  const float* lm = static_cast<const float*>(lam);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, 1>(table, im, is, lm, out, n, n_rows, L, st);
    case 1: return launch<__nv_bfloat16, 1>(table, im, is, lm, out, n, n_rows, L, st);
    case 2: return launch<float, 4>(table, im, is, lm, out, n, n_rows, L, st);
    case 3: return launch<__nv_bfloat16, 8>(table, im, is, lm, out, n, n_rows, L, st);
    default: return cudaErrorInvalidValue;
  }
}
