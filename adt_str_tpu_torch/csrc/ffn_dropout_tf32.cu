// K4 in fp32 on the tensor cores: fused FFN + dropout forward in 3xTF32, for
// `model.compute_dtype: float32` (ffn_dropout.cu takes bf16 and fp16).
//
// Replaces adt_str_tpu/ops/pallas_ffn.py:fused_ffn_dropout (_fwd_call,
// _fwd_kernel), which runs in the compute dtype (`cdt = x2.dtype`), for fp32
// operands. For x (N, d), W1 (d_ff, d) (linear1.weight), W2 (d, d_ff)
// (linear2.weight), b1, b2, all fp32, and four seed words:
//     pre = x W1^T + b1                                 (an output)
//     hd  = keep_h(r, c) ? gelu(pre) * (1 / keep_h) : 0  (gelu with the
//                                                        Abramowitz-Stegun erf)
//     out = keep_o(r, c) ? (hd W2^T + b2) * (1 / keep_o) : 0
// with the counter-hash masks of ops/dropout_hash.py, bit-identical to the
// bf16 kernel's and the JAX package's. Tensor parallelism as in
// ffn_dropout.cu: the hidden mask at the whole-width index
// r * d_ff_total + col0 + c, and the partial mode (b2 null) writes
// hd W2_shard^T alone. gelu uses the accurate expf and division: the fp32
// path is held to the plain path's fp32 results (cuBLAS, TF32 off).
//
// Bound on an H100: at the decoder's training shapes (N = 64 * 511, d 768,
// d_ff 3072) the two products are 4 N d d_ff flops, 309 GFLOP. An
// fp32-accurate product on the tensor cores is three TF32 products
// (3xTF32): each operand x splits into big = tf32(x) and small =
// tf32(x - big) (hopper.cuh's tf32_split, cvt.rna's bits), and
// a b ~ a_small b_big + a_big b_small + a_big b_big (a_small b_small, below
// 2^-22 of the product, is dropped): 3 x 309 GFLOP at 495 TFLOP/s, 1.87 ms,
// against 4.6 ms of fp32 FMA at 67 TFLOP/s and 0.3 GB of fp32 operands (0.1
// ms at 3.35 TB/s). So it is bound by the tensor cores, and the design is
// ffn_dropout.cu's TMA + wgmma pipeline at TF32 (wgmma m64n128k8):
//   - two GEMMs of 128 x 128 output tiles, each a persistent kernel of one
//     block an SM; one producer thread keeps a 3-deep ring of 128 x 32 fp32
//     A and B stage tiles (128-byte rows, the swizzle atom) full by TMA;
//     both consumer warpgroups take every tile together, warpgroup w its
//     rows 64 w .. 64 w + 63 (wgmma m64n128k8, K-major operands);
//   - the split happens in shared memory once a stage lands: each of the
//     256 consumer threads splits its share of the A and B tiles, big in
//     place and small into the stage's two small tiles (the split is
//     elementwise, so the swizzled layout carries over), then a fence and a
//     barrier over both warpgroups hand the four tiles to wgmma. The next
//     stage is split while the current stage's products run;
//   - the tensor cores truncate as they accumulate (a chain of 288 TF32
//     products moved an output by 1.6e-5 in attention_tf32.cu), so each
//     stage's 12 products (4 K steps x 3) run as one chain from zero into
//     a stage accumulator, which joins the tile's fp32 sum in a rounded add,
//     stage by stage in K order (64 + 64 fp32 registers a consumer thread;
//     a second stage accumulator, so the next stage's products run while
//     one is added, spilled at 168 registers and made ptxas serialise the
//     products);
//   - the epilogues run from the registers: GEMM 1 adds b1, stores pre and
//     the dropped gelu hd (an fp32 scratch tensor); GEMM 2 adds b2, applies
//     the output mask and stores out; the partial mode stores the product.
// Rows past N are zero-filled on load by TMA and never stored. The weights
// and x are read as they are (no split copies in device memory).

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;             // output tile rows (two m64 halves, one a consumer warpgroup)
constexpr int BN = 128;             // output tile columns
constexpr int BK = 32;              // depth of a stage: 128-byte fp32 rows, the swizzle atom
constexpr int KSTEP = 8;            // wgmma's K for TF32: 32 bytes
constexpr int THREADS = 384;        // warpgroups 0, 1: consumers; 2: producer
constexpr int CONSUMERS = 256;
constexpr int TILE_BYTES = BM * BK * 4;         // one A or B stage tile (BN == BM)
constexpr int STAGE_BYTES = 4 * TILE_BYTES;     // A, B (raw, then big), A small, B small
constexpr int STAGES = 3;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

constexpr uint32_t HASH_GOLDEN = 0x9E3779B9u;
constexpr uint32_t HASH_M1 = 0x85EBCA6Bu;

static_assert(BN == BM, "A and B stage tiles share one size");
static_assert(SMEM <= 232448, "shared memory of one block");

enum Mode { kHiddenMode = 0, kOutMode = 1, kPartialMode = 2 };

__device__ __forceinline__ bool keep(uint32_t idx, uint32_t s0, uint32_t s1, uint32_t thresh) {
  uint32_t h = idx * HASH_GOLDEN + s0;
  h ^= h >> 16;
  h *= HASH_M1;
  h ^= s1;
  h ^= h >> 15;
  return h < thresh;
}

// gelu with the Abramowitz-Stegun 7.1.26 erf, as ops/ffn.py:gelu_as computes it in fp32
__device__ __forceinline__ float gelu_as(float p) {
  const float x = __fdiv_rn(p, 1.41421356237309515f);
  const float s = static_cast<float>((x > 0.f) - (x < 0.f));
  const float a = fabsf(x);
  const float t = __fdiv_rn(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = s * (1.0f - poly * expf(-a * a));
  return p * 0.5f * (1.0f + erf);
}

// Wait for stage sequence number `gs` to land, then split it (A and B
// tiles, raw fp32, contiguous): big in place, small into the small tiles
// behind them; consumer thread threadIdx.x takes float4s ct, ct + 256, ...
// of the two tiles. Then hand them to the async proxy and wait for the
// other warpgroup's share.
__device__ __forceinline__ void split_stage(uint8_t* st, int gs) {
  uint64_t* full = reinterpret_cast<uint64_t*>(st - (gs % STAGES) * STAGE_BYTES + STAGES * STAGE_BYTES);
  mbar_wait(&full[gs % STAGES], (gs / STAGES) & 1);
  const int ct = threadIdx.x;
  float4* raw = reinterpret_cast<float4*>(st);
  float4* small = reinterpret_cast<float4*>(st + 2 * TILE_BYTES);
#pragma unroll
  for (int i = 0; i < 2 * TILE_BYTES / 16 / CONSUMERS; ++i) {
    const int e = ct + i * CONSUMERS;
    const float4 x = raw[e];
    uint32_t b0, s0, b1, s1, b2, s2, b3, s3;
    tf32_split(x.x, b0, s0);
    tf32_split(x.y, b1, s1);
    tf32_split(x.z, b2, s2);
    tf32_split(x.w, b3, s3);
    raw[e] = make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(b2), __uint_as_float(b3));
    small[e] = make_float4(__uint_as_float(s0), __uint_as_float(s1), __uint_as_float(s2), __uint_as_float(s3));
  }
  fence_proxy_async();
  named_barrier(1, CONSUMERS);
}

// A stage's 12 products for warpgroup `wg` into `d`, one chain from zero:
// the a_small b_big pass over the stage's 4 K steps, then a_big b_small,
// then a_big b_big (the small terms first).
__device__ __forceinline__ void stage_products(float (&d)[64], const uint8_t* st, int wg) {
  const uint8_t* a_big = st + wg * (TILE_BYTES / 2);
  const uint8_t* b_big = st + TILE_BYTES;
  const uint8_t* a_small = a_big + 2 * TILE_BYTES;
  const uint8_t* b_small = b_big + 2 * TILE_BYTES;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < BK / KSTEP; ++k)
    mma_64x128_tf32(d, desc_sw128(a_small + k * 32, 16, 1024), desc_sw128(b_big + k * 32, 16, 1024), k > 0);
#pragma unroll
  for (int k = 0; k < BK / KSTEP; ++k)
    mma_64x128_tf32(d, desc_sw128(a_big + k * 32, 16, 1024), desc_sw128(b_small + k * 32, 16, 1024), 1);
#pragma unroll
  for (int k = 0; k < BK / KSTEP; ++k)
    mma_64x128_tf32(d, desc_sw128(a_big + k * 32, 16, 1024), desc_sw128(b_big + k * 32, 16, 1024), 1);
  wgmma_commit();
}

// The block's tiles of A (rows, K) B^T (B: (cols, K)), both fp32 K-major:
// tiles blockIdx.x, + gridDim.x, ..., each taken by both consumer
// warpgroups. kMode: kHiddenMode, GEMM 1 (stores pre into out and hd; the
// hidden mask's row stride is mask_cols and its first column col0);
// kOutMode, GEMM 2 (stores out); kPartialMode, GEMM 2's product into out.
template <int kMode>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_tf32_gemm(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                  const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ hd, int rows, int K,
                  int cols, int mask_cols, int col0, uint32_t s0, uint32_t s1, uint32_t thresh, float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int ktiles = K / BK, ntiles = cols / BN;
  const int tiles = (rows + BM - 1) / BM * ntiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);  // both warpgroups release a stage
    }
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
          mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
          uint8_t* st = smem + s * STAGE_BYTES;
          tma_load_2d(st, &a_map, &full[s], kt * BK, m0);
          tma_load_2d(st + TILE_BYTES, &b_map, &full[s], kt * BK, n0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int w = t / 32, l = t % 32;
  int g = 0;  // stage sequence number, as the producer counts it
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntiles * BM, n0 = tile % ntiles * BN;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    split_stage(smem + (g % STAGES) * STAGE_BYTES, g);  // the tile's first stage
    for (int kt = 0; kt < ktiles; ++kt, ++g) {
      uint8_t* st = smem + (g % STAGES) * STAGE_BYTES;
      stage_products(part, st, wg);
      if (kt + 1 < ktiles) split_stage(smem + ((g + 1) % STAGES) * STAGE_BYTES, g + 1);  // while they run
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      mbar_arrive(&empty[g % STAGES]);
    }

    // epilogue: accumulator element i of thread (warp w, lane l) of warpgroup
    // wg: row 64 wg + 16 w + l / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2
#pragma unroll
    for (int jc = 0; jc < BN / 8; ++jc) {
      const int c = n0 + 8 * jc + 2 * (l % 4);
      float2 bb = make_float2(0.f, 0.f);
      if constexpr (kMode != kPartialMode) bb = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 64 * wg + 16 * w + l / 4 + 8 * h;
        if (r >= rows) continue;
        const size_t at = static_cast<size_t>(r) * cols + c;
        float v0 = acc[4 * jc + 2 * h], v1 = acc[4 * jc + 2 * h + 1];
        if constexpr (kMode == kPartialMode) {
          *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
          continue;
        }
        v0 = __fadd_rn(v0, bb.x);
        v1 = __fadd_rn(v1, bb.y);
        if constexpr (kMode == kHiddenMode) {
          *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);  // pre
          const uint32_t idx =
              static_cast<uint32_t>(r) * static_cast<uint32_t>(mask_cols) + static_cast<uint32_t>(col0 + c);
          *reinterpret_cast<float2*>(hd + at) =
              make_float2(keep(idx, s0, s1, thresh) ? __fmul_rn(gelu_as(v0), inv_keep) : 0.f,
                          keep(idx + 1, s0, s1, thresh) ? __fmul_rn(gelu_as(v1), inv_keep) : 0.f);
        } else {
          const uint32_t idx = static_cast<uint32_t>(r) * static_cast<uint32_t>(cols) + static_cast<uint32_t>(c);
          *reinterpret_cast<float2*>(out + at) =
              make_float2(keep(idx, s0, s1, thresh) ? __fmul_rn(v0, inv_keep) : 0.f,
                          keep(idx + 1, s0, s1, thresh) ? __fmul_rn(v1, inv_keep) : 0.f);
        }
      }
    }
  }
}

// A row-major (rows, cols) fp32 matrix read in boxes of (32 columns, 128 rows).
int matrix_map(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {BK, BM};
  return encode_tensor_map(map, p, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The device's SM count, and the kernels' shared-memory limits set, once a device.
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
      (e = cudaFuncSetAttribute(ffn_tf32_gemm<kHiddenMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
          cudaSuccess ||
      (e = cudaFuncSetAttribute(ffn_tf32_gemm<kOutMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
          cudaSuccess ||
      (e = cudaFuncSetAttribute(ffn_tf32_gemm<kPartialMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
          cudaSuccess)
    return static_cast<int>(e);
  if (dev < 64) known[dev] = *sms;
  return 0;
}

}  // namespace

extern "C" int ffn_dropout_tf32_tile() { return BN; }

// Launch both GEMMs on `stream`; returns 0 or a cudaError_t. The caller
// checks: fp32 contiguous x (N, d), w1 (d_ff, d), w2 (d, d_ff), b1 (d_ff,),
// b2 (d,) or null (the partial mode), d and d_ff multiples of 128, outputs
// out (N, d), pre and the scratch hd (N, d_ff), 16-byte aligned; seeds as
// in ffn_dropout.cu.
extern "C" int launch_ffn_dropout_tf32(const void* x, const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* out, void* pre, void* hd, int N, int d, int d_ff,
                                       int d_ff_total, int col0, unsigned int s_h0, unsigned int s_h1,
                                       unsigned int s_o0, unsigned int s_o1, unsigned int thresh_h,
                                       unsigned int thresh_o, float inv_keep_h, float inv_keep_o, void* stream) {
  if (N < 1 || d % BN || d_ff % BN || col0 < 0 || col0 >= d_ff_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap x_map, w1_map, hd_map, w2_map;
  int sms = 0, err = 0;
  if ((err = prepare_device(&sms)) || (err = matrix_map(&x_map, x, N, d)) || (err = matrix_map(&w1_map, w1, d_ff, d)) ||
      (err = matrix_map(&hd_map, hd, N, d_ff)) || (err = matrix_map(&w2_map, w2, d, d_ff)))
    return err;
  const int mt = (N + BM - 1) / BM;
  ffn_tf32_gemm<kHiddenMode><<<std::min(sms, mt * (d_ff / BN)), THREADS, SMEM, st>>>(
      x_map, w1_map, static_cast<const float*>(b1), static_cast<float*>(pre), static_cast<float*>(hd), N, d, d_ff,
      d_ff_total, col0, s_h0, s_h1, thresh_h, inv_keep_h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::min(sms, mt * (d / BN));
  if (b2 == nullptr)
    ffn_tf32_gemm<kPartialMode><<<blocks, THREADS, SMEM, st>>>(hd_map, w2_map, nullptr, static_cast<float*>(out),
                                                               nullptr, N, d_ff, d, d, 0, s_o0, s_o1, thresh_o,
                                                               inv_keep_o);
  else
    ffn_tf32_gemm<kOutMode><<<blocks, THREADS, SMEM, st>>>(hd_map, w2_map, static_cast<const float*>(b2),
                                                           static_cast<float*>(out), nullptr, N, d_ff, d, d, 0, s_o0,
                                                           s_o1, thresh_o, inv_keep_o);
  return static_cast<int>(cudaGetLastError());
}
