// K3: one-shot note placement for Hopper (sm_90a).
//
// Replaces adt_str_tpu/synth/pallas_place.py:place_notes (_kernel). For
// blend rows (B, S, L) (f32 or bf16: the stream type), and per row b and
// note n a slot, an onset sample and an f32 gain:
//     out[b, t] = sum_n g[b, n] * f32(blend[b, slot[b, n], t - onset[b, n]])
// over 0 <= t - onset < L and 0 <= t < chunk (what runs past the chunk is
// clipped), notes with g == 0 skipped, the notes added one after another in
// note order into an f32 sum that starts at 0, each product and sum rounded
// on its own (__fmul_rn, __fadd_rn: nvcc never contracts them into an FMA).
// A slot outside [0, S) or an onset outside [0, chunk) is clamped into it.
// ops/place.py:place_notes_plain adds the same products in the same order,
// so the two are bit-equal.
//
// Bound on an H100: at the training shape (B = 64, S = 27, L = 30720 bf16,
// 128 notes, chunk 61440) reading the blend rows once and writing the f32
// output is 121.9 MB, 0.036 ms at 3.35 TB/s; the multiply-adds (at most
// 64 * 128 * 30720) are far below that at the fp32 rate. It is bound by bytes
// if every blend row is read from device memory once: a row is read once for
// every note that uses it, but the 27 rows of a segment (1.6 MB) stay in L2
// while the blocks of that segment run.
// The design: grid (time tiles of 1024 samples, B). A block owns one output
// tile and keeps it in registers (4 samples a thread, 256 apart so a warp's
// loads are contiguous); it stages the segment's note metadata in shared
// memory 256 notes at a time and walks the notes in order, skipping those
// with g == 0 or no overlap with its tile, and reads blend[t - onset] at
// each of its samples directly. No atomics: each output sample has one
// owner, so the result is deterministic. The TPU kernel's lane and row
// rotation (pltpu.roll) was a TPU layout device and is not carried over.
// No TMA, shared-memory staging of the rows or pipelining yet: this is the
// simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;  // output samples a block owns
constexpr int NOTE_BATCH = 256;             // notes staged in shared memory at once

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
place_notes_kernel(const T* __restrict__ blend, const int* __restrict__ slot, const int* __restrict__ onset,
                   const float* __restrict__ gain, float* __restrict__ out, int n_slots, int L, int n_notes,
                   int chunk) {
  __shared__ int s_slot[NOTE_BATCH];
  __shared__ int s_onset[NOTE_BATCH];
  __shared__ float s_gain[NOTE_BATCH];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int t_end = min(t0 + TILE, chunk);
  const T* rows = blend + static_cast<long long>(b) * n_slots * L;
  float acc[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) acc[k] = 0.f;

  for (int base = 0; base < n_notes; base += NOTE_BATCH) {
    const int cnt = min(NOTE_BATCH, n_notes - base);
    __syncthreads();  // the previous batch is consumed
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      const long long at = static_cast<long long>(b) * n_notes + base + i;
      s_slot[i] = min(max(slot[at], 0), n_slots - 1);
      s_onset[i] = min(max(onset[at], 0), chunk - 1);
      s_gain[i] = gain[at];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const float g = s_gain[i];
      const int o = s_onset[i];
      // uniform across the block: skip silent notes and notes off this tile
      if (g == 0.f || o >= t_end || static_cast<long long>(o) + L <= t0) continue;
      const T* x = rows + static_cast<long long>(s_slot[i]) * L;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int t = t0 + k * THREADS + threadIdx.x;
        const int j = t - o;
        if (t < chunk && j >= 0 && j < L) acc[k] = __fadd_rn(acc[k], __fmul_rn(g, to_f32(x[j])));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int t = t0 + k * THREADS + threadIdx.x;
    if (t < chunk) out[static_cast<long long>(b) * chunk + t] = acc[k];
  }
}

template <typename T>
cudaError_t launch(const void* blend, const int* slot, const int* onset, const float* gain, float* out, int B,
                   int n_slots, int L, int n_notes, int chunk, cudaStream_t stream) {
  const dim3 grid((chunk + TILE - 1) / TILE, B);
  place_notes_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(blend), slot, onset, gain, out, n_slots,
                                                      L, n_notes, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (the blend rows' type). n_slots >= 1, chunk >= 1.
extern "C" int launch_place_notes(const void* blend, const void* slot, const void* onset, const void* gain,
                                  void* out, int B, int n_slots, int L, int n_notes, int chunk, int dtype,
                                  void* stream) {
  const int* sl = static_cast<const int*>(slot);
  const int* on = static_cast<const int*>(onset);
  const float* g = static_cast<const float*>(gain);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(blend, sl, on, g, o, B, n_slots, L, n_notes, chunk, st);
    case 1: return launch<__nv_bfloat16>(blend, sl, on, g, o, B, n_slots, L, n_notes, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}
