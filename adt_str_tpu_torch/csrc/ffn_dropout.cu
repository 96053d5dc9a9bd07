// K4: fused FFN + dropout forward for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_ffn.py:fused_ffn_dropout (_fwd_call,
// _fwd_kernel). For x (N, d), W1 (d_ff, d) (linear1.weight), W2
// (d, d_ff) (linear2.weight), b1, b2, all of one type T (bf16 or fp16: the
// kernel is a template on it, wgmma's .bf16 or .f16 form, the same rounding
// points) and four seed words:
//     pre = T(x W1^T + b1)                          (fp32 accumulation; an output)
//     hd  = T(keep_h(r, c) ? gelu(pre) / keep_h : 0) (gelu with the
//                                                    Abramowitz-Stegun erf)
//     out = T(keep_o(r, c) ? (hd W2^T + b2) / keep_o : 0)
// fp16's range: pre past 65,504 would round to inf where bf16 keeps it (no
// trained layer comes near; the plain path's fp16 rounds the same way).
// d_ff that is not a multiple of 128: the wrapper (ops/cuda_ffn.py) pads W1's
// rows, b1 and W2's columns with zeros to the next multiple, so the padded
// columns give pre = 0, gelu(0) = 0 and hd = 0 and add nothing to GEMM 2;
// the hidden mask stays keyed on the real width (d_ff_total, col0).
// keep_*(r, c) is the counter hash of ops/dropout_hash.py on the flat
// index r * cols + c of the unpadded (N, cols) array, in uint32 arithmetic,
// compared with the threshold min(int(keep * 2^32), 2^32 - 1). The masks
// are bit-identical to the JAX package's.
//
// Tensor parallelism (a rank's d_ff columns of a whole width d_ff_total):
// the hidden mask is taken at the whole-width index r * d_ff_total + col0 + c,
// and the partial mode stops GEMM 2 at the fp32 product hd W2_shard^T,
// written as it is (no b2, no output mask, no rounding): b2 and the output
// dropout follow the sum over the ranks. col0 = 0 and d_ff_total = d_ff
// are the one-process kernel, bit for bit.
//
// Bound on an H100: at the decoder's training shapes (N = 64 * 511, d = 768,
// d_ff = 3072) the two products are 4 * N * d * d_ff flops, 309 GFLOP
// (312 us at 989 TFLOP/s), against about 0.1 ms of memory traffic: it is
// bound by the tensor cores. The TPU kernel keeps W1 and W2 whole in VMEM
// beside a 128-row tile and never writes the hidden; on Hopper a fused
// tile's fp32 output accumulator (128 x 768 x 4 B = 384 KB) exceeds the
// SM's 256 KB register file, so a fused kernel is stuck at 32-row tiles
// that stream all 9.4 MB of weights per tile. The design therefore splits
// at the hidden, which goes to device memory anyway as `pre`:
//   - two GEMMs of 128 x 128 output tiles, each a persistent kernel of one
//     block an SM: one producer thread keeps a ring of 128 x 64 A and B
//     stage tiles full by TMA (a full and an empty mbarrier a stage); two
//     consumer warpgroups take the block's tiles in turn, each a whole tile
//     (wgmma m64n128k16, both operands K-major in shared memory, 128 fp32
//     accumulators a thread). The ring hands out the stages in tile order,
//     so one warpgroup's products run while the other's epilogue does its
//     fp32 work (ping-pong): GEMM 1's epilogue costs about as much as its
//     products;
//   - GEMM 1 (x W1^T, K = d): the epilogue adds b1 and stages the rounded
//     pre tile in shared memory; the warpgroup then reads it back 16 bytes
//     at a time, applies gelu, the hidden mask and 1/keep_h to give hd (a
//     bf16 scratch tensor), and both tiles go out by TMA store;
//   - GEMM 2 (hd W2^T, K = d_ff): the epilogue adds b2, applies the output
//     mask and 1/keep_o, and stores out.
// Rows past N are zero-filled on load and clipped on store by TMA. The hd
// round trip (2 * N * d_ff * 2 B, 0.12 ms of HBM at the decoder's shape) is
// the price of the split.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;             // output tile rows (two m64 halves)
constexpr int BN = 128;             // output tile columns
constexpr int BK = 64;              // depth of a stage: 128-byte rows, the swizzle atom
constexpr int THREADS = 384;        // warpgroups 0, 1: consumers; 2: producer
constexpr int TILE_BYTES = BM * BK * 2;         // one A or B stage tile (BN == BM)
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int OUT_TILE_BYTES = BM * BN * 2;     // a bf16 output tile, two 64-column halves
constexpr int HALF_BYTES = OUT_TILE_BYTES / 2;

constexpr uint32_t HASH_GOLDEN = 0x9E3779B9u;
constexpr uint32_t HASH_M1 = 0x85EBCA6Bu;

static_assert(BN == BM, "A and B stage tiles share one size");

// The epilogue of a GEMM: GEMM 1 (pre and hd), GEMM 2 (out), GEMM 2's
// partial mode (fp32 out, stored from the registers).
enum Mode { kHiddenMode = 0, kOutMode = 1, kPartialMode = 2 };

// GEMM 1 stages two output tiles (pre, hd) a warpgroup, GEMM 2 one (out);
// the ring takes what shared memory is left.
template <bool kHidden>
struct Shape {
  static constexpr int OUT_TILES = kHidden ? 2 : 1;
  static constexpr int STAGES = kHidden ? 3 : 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * OUT_TILES * OUT_TILE_BYTES + (2 * STAGES + 2) * 8;
};
static_assert(Shape<true>::SMEM <= 232448 && Shape<false>::SMEM <= 232448, "shared memory of one block");

__device__ __forceinline__ bool keep(uint32_t idx, uint32_t s0, uint32_t s1, uint32_t thresh) {
  uint32_t h = idx * HASH_GOLDEN + s0;
  h ^= h >> 16;
  h *= HASH_M1;
  h ^= s1;
  h ^= h >> 15;
  return h < thresh;
}

// gelu with the Abramowitz-Stegun 7.1.26 erf of pallas_ffn._erf, in fp32
// with the fast reciprocal and exp (a few ulps from the plain version's,
// far inside the bf16 rounding of hd that follows)
__device__ __forceinline__ float gelu_as(float p) {
  const float x = p * 0.70710678118654752f;
  const float s = static_cast<float>((x > 0.f) - (x < 0.f));
  const float a = fabsf(x);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = s * (1.0f - poly * __expf(-a * a));
  return p * 0.5f * (1.0f + erf);
}

template <typename T>
__device__ __forceinline__ void put_pair(uint8_t* tile, int r, int c, float lo, float hi) {
  // (r, c) of a 128 x 128 output tile: column half c / 64, then the swizzled row
  *reinterpret_cast<uint32_t*>(tile + (c >> 6) * HALF_BYTES + sw128_offset(r, c & 63)) = pack2<T>(lo, hi);
}

// The block's tiles of A (rows, K) B^T (B: (cols, K)), both T K-major:
// tiles blockIdx.x, + gridDim.x, ..., the j-th to consumer warpgroup j % 2.
// kMode: kHiddenMode, GEMM 1 (stores pre and hd; the hidden mask's row
// stride is mask_cols and its first column col0); kOutMode, GEMM 2 (stores
// out); kPartialMode, GEMM 2's fp32 product into out32.
template <typename T, int kMode>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                           const CUtensorMap* o_map, const CUtensorMap* h_map,
                                           const T* __restrict__ bias, float* __restrict__ out32,
                                           int rows, int K, int cols, int mask_cols, int col0, uint32_t s0,
                                           uint32_t s1, uint32_t thresh, float inv_keep) {
  constexpr bool kHidden = kMode == kHiddenMode;
  constexpr int STAGES = Shape<kHidden>::STAGES, OUT_TILES = Shape<kHidden>::OUT_TILES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + 2 * OUT_TILES * OUT_TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;  // turn[w]: warpgroup w has waited for every stage of its tile

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int ktiles = K / BK, ntiles = cols / BN;
  const int tiles = (rows + BM - 1) / BM * ntiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // the consuming warpgroup's threads release the stage
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: every stage of every tile of the block, in order
    setmaxnreg_dec<40>();
    if (t == 0) {
      int g = 0;  // stage sequence number
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntiles * BM, n0 = tile % ntiles * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++g) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          uint8_t* st = smem + s * STAGE_BYTES;
          tma_load_2d(st, a_map, &full[s], kt * BK, m0);
          tma_load_2d(st + TILE_BYTES, b_map, &full[s], kt * BK, n0);
        }
      }
    }
  } else {  // consumer warpgroup wg: the block's tiles j = wg, wg + 2, ...
    setmaxnreg_inc<232>();
    uint8_t* outs = smem + STAGES * STAGE_BYTES + wg * OUT_TILES * OUT_TILE_BYTES;
    const int w = t / 32, l = t % 32;
    for (int j = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles; j += 2, tile += 2 * gridDim.x) {
      const int m0 = tile / ntiles * BM, n0 = tile % ntiles * BN;
      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
      // A parity wait tells phases apart only one ahead: wait for the stages
      // of tile j once the other warpgroup has waited for those of tile j - 1.
      if (j > 0) mbar_wait(&turn[wg ^ 1], ((j - 1) / 2) & 1);
      int g = j * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++g) {
        const int s = g % STAGES;
        mbar_wait(&full[s], (g / STAGES) & 1);
        const uint8_t* st = smem + s * STAGE_BYTES;
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          const uint64_t b = desc_sw128(st + TILE_BYTES + k * 32, 16, 1024);
          mma_64x128_ss<T>(acc[0], desc_sw128(st + k * 32, 16, 1024), b, 1);
          mma_64x128_ss<T>(acc[1], desc_sw128(st + TILE_BYTES / 2 + k * 32, 16, 1024), b, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0) mbar_arrive(&empty[(g - 1) % STAGES]);
      }
      if (t == 0) mbar_arrive(&turn[wg]);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[(g - 1) % STAGES]);

      // epilogue. The previous tile's stores must have read the staging tiles.
      if (t == 0) store_wait_read();
      named_barrier(1 + wg, 128);
      // accumulator element i of half hr, thread (warp w, lane l): row 64 hr +
      // 16 w + l / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2
#pragma unroll
      for (int jc = 0; jc < BN / 8; ++jc) {
        const int cl = 8 * jc + 2 * (l % 4);
        if constexpr (kMode == kPartialMode) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 64 * hr + 16 * w + l / 4 + 8 * h;
              if (m0 + r < rows)
                *reinterpret_cast<float2*>(out32 + static_cast<size_t>(m0 + r) * cols + n0 + cl) =
                    make_float2(acc[hr][4 * jc + 2 * h], acc[hr][4 * jc + 2 * h + 1]);
            }
          }
          continue;
        }
        const float2 bb = unpack2<T>(*reinterpret_cast<const uint32_t*>(bias + n0 + cl));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * hr + 16 * w + l / 4 + 8 * h;
            const float v0 = acc[hr][4 * jc + 2 * h] + bb.x, v1 = acc[hr][4 * jc + 2 * h + 1] + bb.y;
            if constexpr (kHidden) {
              put_pair<T>(outs, r, cl, v0, v1);  // pre, rounded to T
            } else {
              const uint32_t idx =
                  static_cast<uint32_t>(m0 + r) * static_cast<uint32_t>(cols) + static_cast<uint32_t>(n0 + cl);
              put_pair<T>(outs, r, cl, keep(idx, s0, s1, thresh) ? v0 * inv_keep : 0.f,
                          keep(idx + 1, s0, s1, thresh) ? v1 * inv_keep : 0.f);
            }
          }
        }
      }
      if constexpr (kHidden) {
        // hd from the staged pre, 8 elements (16 bytes) a step: a short loop
        // whose 8 independent gelu chains keep the warp busy (the unrolled
        // per-register form ran 6k instructions of code a thread and spilled)
        named_barrier(1 + wg, 128);
        for (int c = t; c < BM * BN / 8; c += 128) {
          const int r = c / (BN / 8), cc = c % (BN / 8);
          const uint32_t off = (cc >> 3) * HALF_BYTES + sw128_offset(r, (cc & 7) * 8);
          const uint4 raw = *reinterpret_cast<const uint4*>(outs + off);
          const uint32_t* pre2 = reinterpret_cast<const uint32_t*>(&raw);
          const uint32_t idx = static_cast<uint32_t>(m0 + r) * static_cast<uint32_t>(mask_cols) +
                               static_cast<uint32_t>(col0 + n0 + 8 * cc);
          uint4 out;
          uint32_t* hd2 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 p = unpack2<T>(pre2[e]);
            const float g0 = gelu_as(p.x) * inv_keep, g1 = gelu_as(p.y) * inv_keep;
            hd2[e] = pack2<T>(keep(idx + 2 * e, s0, s1, thresh) ? g0 : 0.f,
                              keep(idx + 2 * e + 1, s0, s1, thresh) ? g1 : 0.f);
          }
          *reinterpret_cast<uint4*>(outs + OUT_TILE_BYTES + off) = out;
        }
      }
      if constexpr (kMode == kPartialMode) continue;  // stored from the registers: nothing staged
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tma_store_2d(o_map, outs + h * HALF_BYTES, n0 + 64 * h, m0);
          if constexpr (kHidden) tma_store_2d(h_map, outs + OUT_TILE_BYTES + h * HALF_BYTES, n0 + 64 * h, m0);
        }
        store_commit();
      }
    }
    if (t == 0) store_wait_read();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_dropout_kernel_gemm1(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w1_map,
                             const __grid_constant__ CUtensorMap pre_map, const __grid_constant__ CUtensorMap hd_map,
                             const T* __restrict__ b1, int N, int d, int d_ff, int d_ff_total, int col0,
                             uint32_t s0, uint32_t s1, uint32_t thresh, float inv_keep) {
  gemm_tiles<T, kHiddenMode>(&x_map, &w1_map, &pre_map, &hd_map, b1, nullptr, N, d, d_ff, d_ff_total, col0, s0, s1,
                          thresh, inv_keep);
}

// GEMM 2; kPartial: the fp32 product into out32 (out_map and b2 unused).
template <typename T, bool kPartial>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_dropout_kernel_gemm2(const __grid_constant__ CUtensorMap hd_map, const __grid_constant__ CUtensorMap w2_map,
                             const __grid_constant__ CUtensorMap out_map, const T* __restrict__ b2,
                             float* __restrict__ out32, int N, int d, int d_ff, uint32_t s0, uint32_t s1,
                             uint32_t thresh, float inv_keep) {
  gemm_tiles<T, kPartial ? kPartialMode : kOutMode>(&hd_map, &w2_map, &out_map, nullptr, b2, out32, N, d_ff, d, d, 0,
                                                  s0, s1, thresh, inv_keep);
}

// A row-major (rows, cols) bf16 or fp16 matrix read or written in boxes of
// (64 columns, 128 rows).
int matrix_map(CUtensorMap* map, const void* p, int rows, int cols, bool half) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 128};
  return encode_tensor_map(map, p, 2, dims, strides, box, half);
}

// The device's SM count, and the T kernels' shared-memory limits set, once.
template <typename T>
int prepare_device(int* sms) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && known[dev] > 0) {
    *sms = known[dev];
    return 0;
  }
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(ffn_dropout_kernel_gemm1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Shape<true>::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(ffn_dropout_kernel_gemm2<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Shape<false>::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(ffn_dropout_kernel_gemm2<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Shape<false>::SMEM)) != cudaSuccess)
    return static_cast<int>(e);
  if (dev < 64) known[dev] = *sms;
  return 0;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out, void* pre,
           void* hd, int N, int d, int d_ff, int d_ff_total, int col0, unsigned int s_h0, unsigned int s_h1,
           unsigned int s_o0, unsigned int s_o1, unsigned int thresh_h, unsigned int thresh_o, float inv_keep_h,
           float inv_keep_o, cudaStream_t st) {
  constexpr bool half = is_half<T>;
  const bool partial = b2 == nullptr;
  CUtensorMap x_map, w1_map, pre_map, hd_map, w2_map, out_map;
  int sms = 0, err = 0;
  if ((err = prepare_device<T>(&sms)) || (err = matrix_map(&x_map, x, N, d, half)) ||
      (err = matrix_map(&w1_map, w1, d_ff, d, half)) || (err = matrix_map(&pre_map, pre, N, d_ff, half)) ||
      (err = matrix_map(&hd_map, hd, N, d_ff, half)) || (err = matrix_map(&w2_map, w2, d, d_ff, half)) ||
      (err = matrix_map(&out_map, partial ? hd : out, N, d, half)))  // partial: a map never stored through
    return err;
  const int mt = (N + BM - 1) / BM;
  ffn_dropout_kernel_gemm1<T><<<std::min(sms, mt * (d_ff / BN)), THREADS, Shape<true>::SMEM, st>>>(
      x_map, w1_map, pre_map, hd_map, static_cast<const T*>(b1), N, d, d_ff, d_ff_total, col0, s_h0, s_h1, thresh_h,
      inv_keep_h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::min(sms, mt * (d / BN));
  if (partial)
    ffn_dropout_kernel_gemm2<T, true><<<blocks, THREADS, Shape<false>::SMEM, st>>>(
        hd_map, w2_map, out_map, nullptr, static_cast<float*>(out), N, d, d_ff, s_o0, s_o1, thresh_o, inv_keep_o);
  else
    ffn_dropout_kernel_gemm2<T, false><<<blocks, THREADS, Shape<false>::SMEM, st>>>(
        hd_map, w2_map, out_map, static_cast<const T*>(b2), nullptr, N, d, d_ff, s_o0, s_o1, thresh_o, inv_keep_o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ffn_dropout_tile() { return BN; }

// Launch both GEMMs on `stream`; returns 0 or a cudaError_t. The caller
// checks: contiguous x (N, d), w1 (d_ff, d), w2 (d, d_ff), b1 (d_ff,), b2
// (d,) of `dtype` (1: bf16, 2: fp16), d and d_ff multiples of 128 (d_ff
// padded with zeros past the real columns, see the header), outputs out
// (N, d), pre and the scratch hd (N, d_ff); seeds are the four scrambled
// words [h0, h1, o0, o1]. The hidden mask is that of columns col0.. of a
// d_ff_total-wide hidden (the wrapper checks that the real columns lie in
// it); b2 == nullptr is the partial mode: out is fp32 (N, d), hd W2^T alone.
extern "C" int launch_ffn_dropout(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, void* pre, void* hd, int N, int d, int d_ff,
                                  int d_ff_total, int col0, unsigned int s_h0, unsigned int s_h1,
                                  unsigned int s_o0, unsigned int s_o1, unsigned int thresh_h,
                                  unsigned int thresh_o, float inv_keep_h, float inv_keep_o, int dtype,
                                  void* stream) {
  if (N < 1 || d % BN || d_ff % BN || col0 < 0 || col0 >= d_ff_total || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, pre, hd, N, d, d_ff, d_ff_total, col0, s_h0, s_h1,
                                           s_o0, s_o1, thresh_h, thresh_o, inv_keep_h, inv_keep_o, st)
                    : launch<__half>(x, w1, b1, w2, b2, out, pre, hd, N, d, d_ff, d_ff_total, col0, s_h0, s_h1, s_o0,
                                     s_o1, thresh_h, thresh_o, inv_keep_h, inv_keep_o, st);
}
