// K3: one-shot note placement for Hopper (sm_90a).
//
// Replaces adt_str_tpu/synth/pallas_place.py:place_notes (_kernel). For
// bf16 blend rows (B, S, L) (the stream type) and per row b and note n a
// slot, an onset sample and an f32 gain:
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
// up to 128 notes, chunk 61440) the blend samples the notes use (each row
// read once) and the f32 output come to about 95 MB, 0.028 ms at 3.35 TB/s.
// The rows of a segment (1.6 MB) stay in L2 while its tiles run, so device
// memory is read about once; but every note reads its own window of its row
// from L2 (about 200 MB at that shape: `mean_multiply_adds` x 2 B in
// chip_smoke.py), which sets a second floor at the L2 rate.
//
// The design: grid (time tiles of TILE = 2048 samples, B), tile fastest, so
// the tiles of a segment run together. A block owns one output tile and
// keeps its f32 sums in registers (128 consumer threads x 16 samples: thread
// i owns positions i, i + 128, ..., so a warp's shared-memory reads and
// global stores are contiguous).
// One producer warp reads the segment's note list 32 notes at a time,
// ballots the notes that sound and overlap the tile, and for each of them,
// in note order, issues one 1-D bulk asynchronous copy of the part of the
// note's row that the tile needs (its start rounded down to 128 bytes, its
// end up to 16, inside [0, L)) into the next slot of a RING-slot
// shared-memory ring, with the note's gain, shift and overlap beside it. Each slot has a full mbarrier (the
// copy's bytes) and an empty one (one arrival per consumer warp). The
// consumers take the slots in order, read their samples at the note's
// shift, add them (masked to the overlap only when the note starts or ends
// inside the tile) and release the slot. So RING notes' windows are in
// flight per block instead of one 2-byte load per thread, and the note list
// is walked by one warp instead of every thread. Each output sample has one
// owner and no atomics are used: the result is deterministic. Rows are not
// summed per slot in shared memory first: that would change the order of
// the sum. The TPU kernel's lane and row rotation (pltpu.roll) was a TPU
// layout device and is not carried over.
//
// Measured on an H100 (chip_smoke.py and ops/place_notes_probe.py, PERF.md):
// the copies alone run at about the L2 rate of a `copy_`, and the adds alone
// take nearly as long, so the two overlap at about 1.2x the L2 floor.
// Starting a copy on a 128-byte boundary instead of 16 took 10% off (a
// misaligned start presumably costs the copy engine extra requests);
// 2048-sample tiles with 8 slots (6 blocks an SM) ran a little faster than
// 4096 (3 blocks an SM), and a deeper ring, reversed tile order, streaming
// stores and an L2 evict-last hint did not help.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CONSUMER_WARPS = 4;
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int PER_THREAD = 16;
constexpr int TILE = CONSUMERS * PER_THREAD;  // output samples a block owns
constexpr int RING = 8;                       // note windows in flight per block
constexpr int SLOT_ELEMS = TILE + 64;         // a window of <= TILE samples, start rounded down to 128 bytes
constexpr int SLOT_BYTES = SLOT_ELEMS * 2;

// A slot's note: its gain, the shift `off` (the note's sample for tile
// position u sits at slot element u + off) and its overlap [lo, hi) with
// the tile; hi < 0 ends the list.
struct NoteWindow {
  float gain;
  int off, lo, hi;
};

constexpr int SMEM_BYTES = RING * SLOT_BYTES + 2 * RING * 8 + RING * static_cast<int>(sizeof(NoteWindow));

__global__ void __launch_bounds__(THREADS, 6)
place_notes_kernel(const __nv_bfloat16* __restrict__ blend, const int* __restrict__ slot,
                   const int* __restrict__ onset, const float* __restrict__ gain, float* __restrict__ out,
                   int n_slots, int L, int n_notes, int chunk) {
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * SLOT_BYTES);
  uint64_t* empty = full + RING;
  NoteWindow* win = reinterpret_cast<NoteWindow*>(empty + RING);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int len = min(TILE, chunk - t0);  // tile positions inside the chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer: the sounding notes of this tile, in note order
    const __nv_bfloat16* rows = blend + static_cast<long long>(b) * n_slots * L;
    const long long at = static_cast<long long>(b) * n_notes;
    int k = 0;  // windows issued
    for (int base = 0; base < n_notes; base += 32) {
      const int n = base + lane;
      float g = 0.f;
      int o = 0, sl = 0;
      if (n < n_notes) {
        g = gain[at + n];
        o = min(max(onset[at + n], 0), chunk - 1);
        sl = min(max(slot[at + n], 0), n_slots - 1);
      }
      // the note's row positions [jlo, jhi) that land in this tile
      const int jlo = max(t0 - o, 0), jhi = min(t0 + len - o, L);
      unsigned sounding = __ballot_sync(0xffffffffu, n < n_notes && g != 0.f && jhi > jlo);
      while (sounding) {
        const int src = __ffs(sounding) - 1;
        sounding &= sounding - 1;
        if (lane == src) {
          // from a 128-byte boundary of the row (the copy engine splits a misaligned start) to a
          // 16-byte one; jb <= L as L % 8 == 0
          const int ja = jlo & ~63, jb = (jhi + 7) & ~7;
          const int s = k % RING;
          mbar_wait(&empty[s], ((k / RING) & 1) ^ 1);
          win[s] = NoteWindow{g, t0 - o - ja, max(o - t0, 0), jhi + o - t0};
          mbar_arrive_expect_tx(&full[s], (jb - ja) * 2);
          bulk_load_1d(ring + s * SLOT_ELEMS, rows + static_cast<long long>(sl) * L + ja, (jb - ja) * 2, &full[s]);
        }
        ++k;
        __syncwarp();
      }
    }
    if (lane == 0) {
      const int s = k % RING;
      mbar_wait(&empty[s], ((k / RING) & 1) ^ 1);
      win[s] = NoteWindow{0.f, 0, 0, -1};
      mbar_arrive(&full[s]);
    }
  } else {  // consumers: tile positions threadIdx.x + i * CONSUMERS
    float acc[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;
    for (int k = 0;; ++k) {
      const int s = k % RING;
      mbar_wait(&full[s], (k / RING) & 1);
      const NoteWindow w = win[s];
      if (w.hi < 0) break;
      const __nv_bfloat16* x = ring + s * SLOT_ELEMS + w.off;  // x[u]: the note's sample at tile position u
      if (w.lo == 0 && w.hi == len) {  // the note covers the tile (positions past len land past the chunk)
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(w.gain, __bfloat162float(x[threadIdx.x + i * CONSUMERS])));
      } else {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
          const int u = threadIdx.x + i * CONSUMERS;
          if (u >= w.lo && u < w.hi) acc[i] = __fadd_rn(acc[i], __fmul_rn(w.gain, __bfloat162float(x[u])));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    float* dst = out + static_cast<long long>(b) * chunk + t0;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int u = threadIdx.x + i * CONSUMERS;
      if (u < len) dst[u] = acc[i];
    }
  }
}

// The kernel's shared-memory limit set on the current device, once.
int prepare_device() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(dev < 64 && done[dev]))
    e = cudaFuncSetAttribute(place_notes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = true;
  return 0;
}

}  // namespace

// The launch geometry, for reports: output samples a block owns, ring
// slots, threads a block, dynamic shared memory a block.
extern "C" void place_notes_layout(int* tile, int* ring, int* threads, int* smem_bytes) {
  *tile = TILE;
  *ring = RING;
  *threads = THREADS;
  *smem_bytes = SMEM_BYTES;
}

// Launch on `stream`; returns 0 or a cudaError_t. The caller checks: a
// contiguous bf16 blend whose rows start on 16-byte boundaries (L % 8 == 0,
// blend 16-byte aligned), contiguous int32 slot and onset and f32 gain of
// (B, n_notes), an f32 (B, chunk) output; B <= 65535.
extern "C" int launch_place_notes(const void* blend, const void* slot, const void* onset, const void* gain,
                                  void* out, int B, int n_slots, int L, int n_notes, int chunk, void* stream) {
  if (B < 1 || n_slots < 1 || chunk < 1 || n_notes < 0 || L < 0 || L % 8 != 0 ||
      reinterpret_cast<uintptr_t>(blend) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = prepare_device()) return err;
  const dim3 grid((chunk + TILE - 1) / TILE, B);
  place_notes_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(blend), static_cast<const int*>(slot), static_cast<const int*>(onset),
      static_cast<const float*>(gain), static_cast<float*>(out), n_slots, L, n_notes, chunk);
  return static_cast<int>(cudaGetLastError());
}
