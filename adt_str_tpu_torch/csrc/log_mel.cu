// K1: fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_mel.py:pallas_log_mel (_kernel). Computes,
// for each kept frame of a batch of waves,
//     a = frame_bf16 . C,  b = frame_bf16 . S        (C, S: Hann-windowed cos/-sin DFT bases, bf16)
//     mel = (a^2 + b^2) . M                          (M: HTK mel filterbank, fp32)
//     out = (clamp(log(mel + floor), lo, hi) - lo) / (hi - lo)      "norm" mode
//         = 10 * log(max(mel, floor)) / ln(10)                         "db" mode
// with fp32 accumulation everywhere.
//
// Bound on an H100: the two DFT products dominate (4 * frames * n_fft * bins
// bf16 flops, 0.13 ms at 989 TFLOP/s for a batch of 64 chunks) while the
// bytes are small (the wave, the bases and the output: about 20 MB, 0.006
// ms at 3.35 TB/s). So it is bound by operations, and the design keeps the
// tensor cores fed and everything between the wave and the output on the SM:
//   - one block per 128 kept frames of one wave: two consumer warpgroups of
//     64 frames and one producer thread. The frames' overlapping window of
//     the wave, 127 * hop + n_fft samples, is kept in shared memory as bf16
//     (reflect padding on the index, bf16 rounding on load: the values of
//     the rounded framed copy); no framed copy is materialized;
//   - the frames are wgmma's register A operand, loaded with ldmatrix from
//     row addresses f * hop apart (a wgmma descriptor cannot describe
//     overlapping rows; hop * 2 bytes must be a multiple of 16);
//   - any other hop and n_fft (JAX's kernel frames the wave in HBM and takes
//     them all: 44.1 kHz at time_res 0.01 gives hop 441, 22.05 kHz hop 220)
//     take two more routes of the same kernel (`Frames`). A hop that is not
//     a multiple of 8 keeps the window in shared memory and builds each
//     fragment register from two 2-byte loads (ldmatrix needs 16-byte rows).
//     A window too large for shared memory (hop 960 at 48 kHz and time_res
//     0.02: 127 * 960 + n_fft samples) is not staged: each fragment element
//     is read from the wave in device memory (through L1 and L2, which hold
//     the block's span), reflected and rounded to bf16 as the window fill
//     does. An n_fft that is not a multiple of 64 runs its last stage past
//     the frame: the bases' rows past n_fft come from TMA as zeros, so those
//     samples add exact zeros;
//   - the cos and sin bases stream through a 3-stage TMA ring in tiles of
//     64 samples x 64 bins (read MN-major, as stored), each tile feeding
//     both warpgroups (wgmma m64n64k16): every base tile is read once per
//     128 frames, and the loads overlap the products. (Tiles of 128 bins,
//     m64n128k16 with 128 accumulators a thread, made ptxas serialise the
//     products, C7512, and ran 3% slower);
//   - the power a^2 + b^2 is formed on the accumulators and staged in shared
//     memory by each warpgroup for its own frames. An HTK triangular
//     filterbank puts each bin in at most two adjacent bands (m0, m0 + 1), so
//     the mel projection reads a per-bin table (w0, w1, m0) instead of the
//     dense bins x mels matrix: the thread of (frame, band parity h) adds
//     each bin's power times the weight of its band of parity h, in bin
//     order, into one running sum, and a band is complete when the next bin
//     moves to the next band of that parity. The dense product's other terms
//     are exact zeros, so this is the same fp32 sum in bin order. Bins past
//     the last nonzero weight are not computed;
//   - the log tail runs on the registers and writes each output once;
//   - a band's sum is taken per frequency tile of 128 bins (the running sum
//     restarts at each tile) and the sums of the tiles its bins lie in are
//     added in tile order: ((s_a + s_a+1) + s_a+2) + .... That order does
//     not depend on how the tiles are shared among blocks, so a row's output
//     is the same bits at every split and every batch size;
//   - a launch of few frame tiles would leave SMs idle (two blocks for a
//     2.56 s chunk), so the wrapper splits the frequency tiles over `split`
//     blocks of the same frames (ops/cuda_mel.py:freq_split, one wave of
//     the SMs). With split 1 a block adds its tiles' sums in registers; with
//     more, each block writes each of its tiles' band sums to that tile's
//     part of a scratch (only the bands the tile reaches), and a second
//     small kernel adds each band's parts over its range of tiles
//     (ops/cuda_mel.py:band_tiles) in tile order and runs the tail.

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE_F = 128;   // frames per block (two warpgroups of 64)
constexpr int FT = 128;       // frequency bins per tile of the mel table (the unit of the split)
constexpr int BN = 64;        // frequency bins per product tile
constexpr int KC = 64;        // samples per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int LDP = BN + 1;   // fp32 row stride of the power tile (conflict-free column reads)

constexpr int BOX_BYTES = KC * BN * 2;           // 64 samples x 64 bins (8 KB)
constexpr int STAGE_BYTES = 2 * BOX_BYTES;       // cos, then sin
constexpr int PW_BYTES = TILE_F * LDP * 4;

// Where a block's frames come from: the window in shared memory through
// ldmatrix (hop % 8 == 0), the window through 2-byte loads (any hop), or the
// wave in device memory (a window too large for shared memory).
enum Frames { kLdmatrix = 0, kScalar = 1, kGlobal = 2 };

__host__ __device__ inline int n_stages_of(int n_fft) { return (n_fft + KC - 1) / KC; }
// the samples of a block's 128 frames, each read to its last stage's end
__host__ __device__ inline int window_len(int hop, int n_fft) { return (TILE_F - 1) * hop + n_stages_of(n_fft) * KC; }

inline int smem_bytes(int hop, int n_fft, bool window) {
  return 1024 + STAGES * STAGE_BYTES + PW_BYTES + (window ? (window_len(hop, n_fft) * 2 + 15) / 16 * 16 : 0) +
         2 * STAGES * 8;
}

__device__ __forceinline__ float log_tail(float x, float log_floor, float lo, float hi, int db_mode) {
  if (db_mode) return 10.f * logf(fmaxf(x, log_floor)) / 2.302585092994046f;
  const float l = fminf(fmaxf(logf(x + log_floor), lo), hi);
  return (l - lo) / (hi - lo);
}

template <int kFrames>
__global__ void __launch_bounds__(THREADS, 1) log_mel_kernel(
    const __grid_constant__ CUtensorMap cos_map,  // (n_fft, k_pad) bf16, boxes of 64 samples x 64 bins
    const __grid_constant__ CUtensorMap sin_map,
    const float* __restrict__ wave,               // (B, T) fp32
    const float4* __restrict__ table,             // (n_tiles * FT): w0, w1, m0 (int bits), 0
    float* __restrict__ out,                      // split 1: (B, n_out, n_mels); else (n_tiles, B, n_out, n_mels)
    int B, int T, int n_fft, int hop, int n_tiles, int n_mels, int frame_start, int n_out, int split,
    float log_floor, float clamp_lo, float clamp_hi, int db_mode) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem;                                              // [STAGES][cos, sin][64 samples][64 bins]
  float* pw = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);  // [128 frames][LDP]
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(pw + TILE_F * LDP);
  const int seg_len = kFrames == kGlobal ? 0 : window_len(hop, n_fft);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(win) + (seg_len * 2 + 15) / 16 * 16);
  uint64_t* empty = full + STAGES;

  const int n_ft = (n_out + TILE_F - 1) / TILE_F;
  const int s_idx = blockIdx.x % split, ft = (blockIdx.x / split) % n_ft, b = blockIdx.x / (split * n_ft);
  const int tile_lo = s_idx * n_tiles / split, tile_hi = (s_idx + 1) * n_tiles / split;
  const int n_stages = n_stages_of(n_fft);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: the base tiles of this block's frequency range, in order
    setmaxnreg_dec<40>();
    if (t == 0) {
      int g = 0;
      for (int bin0 = tile_lo * FT; bin0 < tile_hi * FT; bin0 += BN) {
        for (int st = 0; st < n_stages; ++st, ++g) {
          const int s = g % STAGES;
          uint8_t* slot = ring + s * STAGE_BYTES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(slot, &cos_map, &full[s], bin0, st * KC);
          tma_load_2d(slot + BOX_BYTES, &sin_map, &full[s], bin0, st * KC);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // the window of the wave that holds the block's 128 frames (the wrapper
  // guarantees T > n_fft / 2); samples past the padded wave belong to frames
  // beyond n_out, which are never stored
  const float* wave_b = wave + static_cast<size_t>(b) * T;
  const long base = static_cast<long>(frame_start + ft * TILE_F) * hop - n_fft / 2;
  // sample i of the block's window, reflected at both ends and rounded to bf16
  auto sample = [&](long i) {
    long x = base + i;
    if (x < 0) x = -x;
    else if (x >= T) x = 2L * (T - 1) - x;
    return __float2bfloat16_rn((x >= 0 && x < T) ? wave_b[x] : 0.f);
  };
  if constexpr (kFrames != kGlobal) {
    for (int i = threadIdx.x; i < seg_len; i += 256) win[i] = sample(i);
  }
  named_barrier(1, 256);

  const int w = t / 32, l = t % 32;
  // ldmatrix row of this lane: frame 64 wg + 16 w + 8 ((l / 8) & 1) + l % 8, samples + 8 (l / 16)
  const uint8_t* a_row =
      reinterpret_cast<const uint8_t*>(win) + ((wg * 64 + 16 * w + 8 * ((l / 8) & 1) + l % 8) * hop + 8 * (l / 16)) * 2;
  float acc_a[BN / 2] = {}, acc_b[BN / 2] = {};  // frames . C and frames . S (64 x 64 each)
  uint32_t fa[4][4];  // a stage's frames: wgmma's A operand for its 4 steps of 16 samples

  // mel state of thread (frame f, band parity h): the running band, its sum
  // in this frequency tile and the sum of its earlier tiles (split 1), the
  // next band of parity h not yet written (split 1) and the part (split > 1)
  const int f = t / 2, h = t % 2;
  const int frame = ft * TILE_F + wg * 64 + f;
  int cur = -1, next = h, part = tile_lo;
  float sum = 0.f, before = 0.f;
  auto write = [&](int m, float v) {
    if (frame >= n_out) return;
    const size_t row = static_cast<size_t>(b) * n_out + frame;
    if (split == 1)
      out[row * n_mels + m] = log_tail(v, log_floor, clamp_lo, clamp_hi, db_mode);
    else
      out[(static_cast<size_t>(part) * B * n_out + row) * n_mels + m] = v;
  };
  auto finish_band = [&]() {  // writes `cur` (split 1: and the untouched bands of parity h below it)
    if (split == 1)
      for (; next < cur; next += 2) write(next, 0.f);
    write(cur, before + sum);
    next = cur + 2;
  };

  int g = 0;
  for (int bin0 = tile_lo * FT; bin0 < tile_hi * FT; bin0 += BN) {
    if (bin0 % FT == 0 && bin0 > tile_lo * FT) {  // a new frequency tile: the open band's sum restarts
      if (split == 1) {
        before += sum;
      } else {  // the band's sum in the tile just ended; the next tile's part starts afresh
        if (cur >= 0) finish_band();
        ++part;
        cur = -1;
      }
      sum = 0.f;
    }
    for (int st = 0; st < n_stages; ++st, ++g) {
      if constexpr (kFrames == kLdmatrix) {
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) ldmatrix_x4(fa[kk], a_row + (st * KC + 16 * kk) * 2);
      } else {
        // ldmatrix's fragment: register mi holds frame 16 w + 8 (mi & 1) + l / 4 of the
        // warpgroup's 64, samples 16 kk + 8 (mi >> 1) + 2 (l % 4), +1 of the stage (low half first)
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const long i = static_cast<long>(wg * 64 + 16 * w + 8 * (mi & 1) + l / 4) * hop + st * KC + 16 * kk +
                           8 * (mi >> 1) + 2 * (l % 4);
            __nv_bfloat16 lo, hi;
            if constexpr (kFrames == kScalar) {
              lo = win[i];
              hi = win[i + 1];
            } else {
              lo = sample(i);
              hi = sample(i + 1);
            }
            fa[kk][mi] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
                         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
          }
      }
      const int s = g % STAGES;
      mbar_wait(&full[s], (g / STAGES) & 1);
      const uint8_t* slot = ring + s * STAGE_BYTES;
      fence_regs(acc_a);
      fence_regs(acc_b);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        // 16 sample rows of the box (8-row groups 1,024 B apart); the first step overwrites
        mma_64x64_rs_tb(acc_a, fa[kk], desc_sw128(slot + kk * 16 * 128, 0, 1024), st > 0 || kk > 0);
        mma_64x64_rs_tb(acc_b, fa[kk], desc_sw128(slot + BOX_BYTES + kk * 16 * 128, 0, 1024), st > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_a);
      fence_regs(acc_b);
      mbar_arrive(&empty[s]);
    }

    // power of this warpgroup's frames -> shared memory
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = wg * 64 + 16 * w + l / 4 + 8 * ((i / 2) & 1), c = 8 * (i / 4) + 2 * (l % 4) + (i & 1);
      pw[r * LDP + c] = acc_a[i] * acc_a[i] + acc_b[i] * acc_b[i];
    }
    named_barrier(2 + wg, 128);
    const float* prow = pw + (wg * 64 + f) * LDP;
    const float4* tb = table + bin0;
    for (int jj = 0; jj < BN; ++jj) {
      const float4 e = __ldg(tb + jj);
      const int m0 = __float_as_int(e.z);
      const int band = m0 + ((m0 ^ h) & 1);
      if (band != cur) {
        if (cur >= 0) finish_band();
        cur = band;
        sum = before = 0.f;
      }
      sum = __fmaf_rn((m0 & 1) == h ? e.x : e.y, prow[jj], sum);
    }
    named_barrier(2 + wg, 128);  // the power tile is read before the next tile's overwrites it
  }
  if (cur >= 0) finish_band();
  if (split == 1)
    for (; next < n_mels; next += 2) write(next, 0.f);
}

// out = tail(a band's parts over its tiles first..last, in tile order; 0 for no tile)
__global__ void log_mel_reduce_kernel(const float* __restrict__ parts, const int2* __restrict__ band_tiles,
                                      float* __restrict__ out, size_t n, int n_mels, float log_floor, float clamp_lo,
                                      float clamp_hi, int db_mode) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int2 r = __ldg(band_tiles + i % n_mels);
  float v = 0.f;
  if (r.x <= r.y) {
    v = parts[r.x * n + i];
    for (int s = r.x + 1; s <= r.y; ++s) v += parts[s * n + i];
  }
  out[i] = log_tail(v, log_floor, clamp_lo, clamp_hi, db_mode);
}

}  // namespace

extern "C" int log_mel_freq_tile() { return FT; }
extern "C" int log_mel_frame_tile() { return TILE_F; }
extern "C" int log_mel_smem_bytes(int hop, int n_fft, int window) { return smem_bytes(hop, n_fft, window != 0); }

// Launch on `stream` by route `frames` (`Frames`); returns 0 or a
// cudaError_t. The caller checks: T > n_fft / 2, contiguous tensors; `cosb`
// and `sinb` are (n_fft, k_pad) bf16 with k_pad % 8 == 0, `table` holds
// n_tiles * 128 entries (w0, w1, m0 bits, 0) with m0 + 1 < n_mels and m0
// nondecreasing; `band_tiles` holds each band's first and last tile (int32
// pairs, ops/cuda_mel.py:band_tiles); with split > 1, `parts` is an fp32
// (n_tiles, B, n_out, n_mels) scratch. Route kLdmatrix needs hop % 8 == 0;
// kLdmatrix and kScalar need the window (127 * hop + n_fft samples, n_fft
// rounded up to 64) in shared memory; else cudaErrorInvalidValue.
extern "C" int launch_log_mel(const void* wave, const void* cosb, const void* sinb, const void* table,
                              const void* band_tiles, void* out, void* parts, int B, int T, int n_fft, int hop,
                              int k_pad, int n_tiles, int n_mels, int frame_start, int n_out, int split,
                              float log_floor, float clamp_lo, float clamp_hi, int db_mode, int frames,
                              void* stream) {
  const int smem = smem_bytes(hop, n_fft, frames != kGlobal);
  if (smem > 232448 || frames < kLdmatrix || frames > kGlobal || (frames == kLdmatrix && hop % 8) || split < 1 ||
      split > n_tiles || (split > 1 && (parts == nullptr || band_tiles == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&log_mel_kernel<kLdmatrix>) kernel = &log_mel_kernel<kGlobal>;
  if (frames == kLdmatrix) kernel = &log_mel_kernel<kLdmatrix>;
  else if (frames == kScalar) kernel = &log_mel_kernel<kScalar>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap cos_map, sin_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad), static_cast<cuuint64_t>(n_fft)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad) * 2};
  const cuuint32_t box[2] = {64, KC};
  int e = 0;
  if ((e = encode_tensor_map(&cos_map, cosb, 2, dims, strides, box)) ||
      (e = encode_tensor_map(&sin_map, sinb, 2, dims, strides, box)))
    return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * ((n_out + TILE_F - 1) / TILE_F) * split;
  kernel<<<blocks, THREADS, smem, st>>>(
      cos_map, sin_map, static_cast<const float*>(wave), static_cast<const float4*>(table),
      static_cast<float*>(split == 1 ? out : parts), B, T, n_fft, hop, n_tiles, n_mels, frame_start, n_out, split,
      log_floor, clamp_lo, clamp_hi, db_mode);
  if (split > 1) {
    const size_t n = static_cast<size_t>(B) * n_out * n_mels;
    log_mel_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(parts), static_cast<const int2*>(band_tiles), static_cast<float*>(out), n, n_mels,
        log_floor, clamp_lo, clamp_hi, db_mode);
  }
  return static_cast<int>(cudaGetLastError());
}
