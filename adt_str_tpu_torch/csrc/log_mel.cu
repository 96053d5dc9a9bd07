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
// Bound on an H100: the two DFT products dominate (2*2*rows*n_fft*n_freqs
// bf16 flops, about 0.13 ms at 989 TFLOP/s for a batch of 64 serving
// chunks) while the bytes are small (the wave, the bases and the output:
// about 0.01 ms at 3.35 TB/s). So it is bound by operations, and the design
// keeps everything on the chip between the wave and the output:
//   - one block per 64 output frames of one wave; the frames are read
//     straight from the wave with reflect padding done on the index and bf16
//     rounding on load (the same values as rounding the framed fp32 copy),
//     and the 64 overlapping frames are one window of the wave kept in
//     shared memory: (63*hop + n_fft) bf16 values, with frame f at offset
//     f*hop, so a 16x16 tensor-core tile of frames is loaded with a leading
//     dimension of hop. No framed copy is materialized (hop 240 forced one on
//     the TPU);
//   - only the kept (trimmed) frames are computed;
//   - the block loops over 64-bin frequency tiles; for each it accumulates
//     frames.C and frames.S with bf16 tensor-core MMA (nvcuda::wmma, fp32
//     accumulators) over n_fft in 64-deep chunks staged in shared memory,
//     forms the power on the accumulator fragments, and adds power.M into a
//     64 x n_mels fp32 tile that each thread keeps in registers (4 frames x
//     8 mels); the power spectrum never leaves the SM;
//   - the log/clamp/scale epilogue runs on the registers and writes the
//     output once.
// No TMA, wgmma or pipelining yet: this is the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TILE_F = 64;     // output frames per block
constexpr int FT = 64;         // frequency bins per tile (bases are padded to a multiple)
constexpr int KC = 64;         // n_fft depth per staged chunk of the bases
constexpr int THREADS = 256;   // 8 warps
constexpr int LDB = FT + 8;    // bf16 row stride of a staged basis chunk
constexpr int LDP = FT + 4;    // fp32 row stride of the power tile

__host__ __device__ inline int seg_padded(int hop, int n_fft) {
  const int seg_len = (TILE_F - 1) * hop + n_fft;
  return (seg_len + 63) / 64 * 64;  // keeps the next region 128-byte aligned
}

__global__ void __launch_bounds__(THREADS) log_mel_kernel(
    const float* __restrict__ wave,          // (B, T) fp32
    const __nv_bfloat16* __restrict__ cosb,  // (n_fft, k_pad) bf16
    const __nv_bfloat16* __restrict__ sinb,  // (n_fft, k_pad) bf16
    const float* __restrict__ melfb,         // (k_pad, n_mels) fp32
    float* __restrict__ out,                 // (B, n_out, n_mels) fp32
    int T, int n_fft, int hop, int k_pad, int n_mels, int frame_start, int n_out,
    float log_floor, float clamp_lo, float clamp_hi, int db_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int seg_len = (TILE_F - 1) * hop + n_fft;
  __nv_bfloat16* seg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cs = seg + seg_padded(hop, n_fft);  // KC x LDB
  __nv_bfloat16* ss = cs + KC * LDB;                 // KC x LDB
  float* pw = reinterpret_cast<float*>(cs);          // TILE_F x LDP, reuses cs/ss after each DFT tile
  float* ms = reinterpret_cast<float*>(ss + KC * LDB);  // FT x n_mels

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TILE_F;  // first output frame of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const float* w = wave + static_cast<size_t>(b) * T;

  // Window of the wave that holds the block's 64 frames, reflect-padded on
  // the index (the wrapper guarantees T > n_fft / 2). Samples past the
  // padded wave belong to frames beyond n_out, which are never stored.
  const long base = static_cast<long>(frame_start + f0) * hop - n_fft / 2;
  for (int i = tid; i < seg_len; i += THREADS) {
    long x = base + i;
    if (x < 0) x = -x;
    else if (x >= T) x = 2L * (T - 1) - x;
    const float v = (x >= 0 && x < T) ? w[x] : 0.f;
    seg[i] = __float2bfloat16_rn(v);
  }

  // mel accumulator: thread owns frames fg*4..+4 and mels mg*8..+8
  const int fg = tid >> 4, mg = tid & 15;
  const bool mel_active = mg * 8 < n_mels;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // DFT warp tile: 16 frames x 32 bins of both a and b
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;

  for (int k0 = 0; k0 < k_pad; k0 += FT) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fa[2], fb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(fa[j], 0.f);
      wmma::fill_fragment(fb[j], 0.f);
    }
    for (int n0 = 0; n0 < n_fft; n0 += KC) {
      __syncthreads();  // earlier readers of cs/ss (or of pw/ms, which alias them) are done
      for (int i = tid; i < KC * FT / 8; i += THREADS) {
        const int r = i / (FT / 8), c = (i % (FT / 8)) * 8;
        const size_t g = static_cast<size_t>(n0 + r) * k_pad + k0 + c;
        *reinterpret_cast<uint4*>(cs + r * LDB + c) = *reinterpret_cast<const uint4*>(cosb + g);
        *reinterpret_cast<uint4*>(ss + r * LDB + c) = *reinterpret_cast<const uint4*>(sinb + g);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fr;
        // rows of this 16x16 tile are frames wr.., each `hop` apart in seg
        wmma::load_matrix_sync(fr, seg + wr * hop + n0 + kk, hop);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bc, bs;
          wmma::load_matrix_sync(bc, cs + kk * LDB + wc + j * 16, LDB);
          wmma::load_matrix_sync(bs, ss + kk * LDB + wc + j * 16, LDB);
          wmma::mma_sync(fa[j], fr, bc, fa[j]);
          wmma::mma_sync(fb[j], fr, bs, fb[j]);
        }
      }
    }
    __syncthreads();  // every warp has finished reading cs/ss before pw overwrites them
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // a and b fragments share one element layout, so the power is elementwise
#pragma unroll
      for (int e = 0; e < fa[j].num_elements; ++e)
        fa[j].x[e] = fa[j].x[e] * fa[j].x[e] + fb[j].x[e] * fb[j].x[e];
      wmma::store_matrix_sync(pw + wr * LDP + wc + j * 16, fa[j], LDP, wmma::mem_row_major);
    }
    for (int i = tid; i < FT * n_mels; i += THREADS)
      ms[i] = melfb[static_cast<size_t>(k0) * n_mels + i];
    __syncthreads();
    if (mel_active) {
      for (int k = 0; k < FT; ++k) {
        float p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) p[r] = pw[(fg * 4 + r) * LDP + k];
        const float4 m0 = *reinterpret_cast<const float4*>(ms + k * n_mels + mg * 8);
        const float4 m1 = *reinterpret_cast<const float4*>(ms + k * n_mels + mg * 8 + 4);
        const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(p[r], m[c], acc[r][c]);
      }
    }
  }

  if (!mel_active) return;
  const float ln10 = 2.302585092994046f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = f0 + fg * 4 + r;
    if (f >= n_out) continue;
    float o[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float x = acc[r][c];
      if (db_mode) {
        o[c] = 10.f * logf(fmaxf(x, log_floor)) / ln10;
      } else {
        const float l = fminf(fmaxf(logf(x + log_floor), clamp_lo), clamp_hi);
        o[c] = (l - clamp_lo) / (clamp_hi - clamp_lo);
      }
    }
    float* dst = out + (static_cast<size_t>(b) * n_out + f) * n_mels + mg * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

}  // namespace

// Frequency tile the bases must be zero-padded to.
extern "C" int log_mel_freq_tile() { return FT; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks: hop % 8 == 0, n_fft % 64 == 0, n_mels % 8 == 0 and <= 128,
// k_pad % 64 == 0, T > n_fft / 2, contiguous tensors.
extern "C" int launch_log_mel(const void* wave, const void* cosb, const void* sinb,
                              const void* melfb, void* out, int B, int T, int n_fft, int hop,
                              int k_pad, int n_mels, int frame_start, int n_out,
                              float log_floor, float clamp_lo, float clamp_hi, int db_mode,
                              void* stream) {
  // a hop too large for shared memory fails here and returns the error
  const int smem = seg_padded(hop, n_fft) * 2 + 2 * KC * LDB * 2 + FT * n_mels * 4;
  cudaError_t err =
      cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_out + TILE_F - 1) / TILE_F, B);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const __nv_bfloat16*>(cosb),
      static_cast<const __nv_bfloat16*>(sinb), static_cast<const float*>(melfb),
      static_cast<float*>(out), T, n_fft, hop, k_pad, n_mels, frame_start, n_out, log_floor,
      clamp_lo, clamp_hi, db_mode);
  return static_cast<int>(cudaGetLastError());
}
