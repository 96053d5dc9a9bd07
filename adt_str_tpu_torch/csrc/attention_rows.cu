// Inference attention, the query rows of one (item, head) a block, for Hopper (sm_90a).
//
// No TPU kernel: a repair of the port. The plain version
// (ops/attention_rows.py:attention_plain, the JAX package's
// models/transformer.py:attention_core) is two batched cuBLAS products
// around ATen's softmax; on the card cuBLAS picks its algorithm by the batch
// count, so the decode step's attention (greedy self and cross, the beam's
// gathered self rows and its per-item cross rows) gave a row other bits
// beside other rows. Here every sum of a query row runs in an order fixed by
// the head dim and the keys it reads, whatever rows share its block:
//     s_t = (sum_j q_j k_tj) / sqrt(hd) + mask_t        fp32; mma k-steps of 16 dims, ascending
//     p_t = T(exp(s_t - max s) / sum_t exp(s_t - max s)) the sum: thread sums over t = tid + 256 i
//                                                        ascending, a xor butterfly, then the 8
//                                                        warps' sums in warp order
//     out_j = T(sum_c P_cj)   P_cj = sum_{t in chunk c} p_t v_tj (one mma k-step: 16 keys),
//                             added in ascending chunk order c = 0, 1, ...
// with q, k, v of type T, as the plain version rounds them: scores in fp32
// from the upcast q and k (bf16 products are exact in fp32), probabilities
// rounded to T with the global max and sum before the product with v, fp32
// accumulation, the output in T. `n_keys` (the decode step's valid keys,
// step + 1 of the cache's rows) stops the read there: a key past it would
// add exp(s - 1e4 - max) = 0 to every sum (fp32 underflow), and a chunk of
// zeros adds +0, so the output is bit-equal to the masked read of all keys.
//
// Bound on an H100: bytes. A query row reads its head's k and v rows once
// (the cache up to the valid keys for self-attention, the encoder memory for
// cross-attention); a few flops a byte. The bf16 design: a block of 8 warps
// holds the (up to 16) query rows of one item and head, so the beam's 5
// queries read their item's cross rows once; K then V stream through one
// 4-deep ring of 64-key tiles, 16-byte cp.async copies (V's first tiles
// land during the softmax); q . k^T and p . v run on mma.sync m16n8k16 (q
// and the rounded p as A, k and v from the ring through ldmatrix); the
// scores (fp32, one a key and row) stay in shared memory between the two
// phases. In phase 1 each warp takes 8 keys of a tile; in phase 2 each
// tile's 4 chunks of 16 keys go to 4 warp pairs (a pair splits the head
// dims), whose fp32 partials the block adds in chunk order into one
// accumulator an output. A decode block holds one query row (16 at most):
// the mma's 16 rows are mostly padding, which costs nothing against the
// bytes, and at 16 x 6 blocks a bucket of 16 fills 96 of the 132 SMs.
// The 16-bit design is a template on T (bf16 or fp16: mma.sync's .bf16 or
// .f16 form, the same rounding points) at head dims up to 256. fp32 q, k, v
// (no shipped config), and bf16 or fp16 at head dims past 256 (2 heads or 1
// at d 768: the mma design's ring and partials outgrow shared memory and its
// registers there), take the simple CUDA-core kernel, a template on T: a
// block a query row, a warp a key, a thread an output dim, t ascending, p
// rounded to T before p . v as the plain version rounds it. Its query row
// and scores sit in static shared arrays up to head dim 1,024 and 4,096
// keys; past either, `attention_rows_f32_wide` runs the same body on dynamic
// shared memory (the one-kernel form on dynamic memory ran the 2-head-of-384
// decode row 31% slower on an H100, so the old shapes keep the static
// arrays). It takes any head dim and key count whose sum fits one block's
// 232,448 B (55,808 keys at head dim 2,048); the 16-bit mma design sends
// the keys it cannot hold at one query row a block to it as well.

#include "hopper.cuh"

#include <cmath>

namespace {

using hopper::cp_async_16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldmatrix_x2;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_16816;

constexpr int MMA_MAX_HD = 256;  // the mma design's head dims
constexpr int SMEM_MAX = 232448;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int KT = 64;                   // keys a ring tile (of K, then of V)
constexpr int CHUNK = 16;                // keys of one p . v partial: one mma k-step
constexpr int CHUNKS = KT / CHUNK;       // 4 a tile, each to a pair of warps
constexpr int QROWS = 16;                // query rows a block at most: the mma's M
constexpr int STAGES = 4;

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

// Shared memory of the 16-bit kernel at padded head dim HDP (a power of two,
// 32..256), `qb` query rows a block and `tiles` key tiles: the ring, the
// query tile, the scores, the chunk partials, the warps' row sums and the
// rows' max and sum.
__host__ __device__ constexpr int ldk(int hdp) { return hdp + 8; }  // bf16 row stride: conflict-free ldmatrix
__host__ __device__ constexpr int lds(int tiles) { return tiles * KT + 8; }
inline int smem_bytes(int hdp, int qb, int tiles) {
  return 2 * (STAGES * KT + QROWS) * ldk(hdp) + 4 * (qb * lds(tiles) + CHUNKS * qb * ldk(hdp) + WARPS * qb + 2 * qb);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
attention_rows_bf16(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ mask, T* __restrict__ out, Strides st, int H, int Tq, int n_keys, int hd,
                    int qb, float scale) {
  constexpr int LDK = ldk(HDP), LDP = ldk(HDP), KSTEPS = HDP / 16;
  constexpr int HALF_TILES = HDP / 16;           // n-tiles of 8 dims in half the head dims
  constexpr int ACC = QROWS * HDP / THREADS;     // outputs a thread accumulates
  extern __shared__ __align__(16) uint8_t smem[];
  const int tiles = (n_keys + KT - 1) / KT, LDS = lds(tiles);
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = ring + STAGES * KT * LDK;
  float* sc = reinterpret_cast<float*>(qs + QROWS * LDK);
  float* part = sc + qb * LDS;
  float* red = part + CHUNKS * qb * LDP;  // [row][warp]
  float* row_max = red + WARPS * qb;
  float* row_sum = row_max + qb;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t2 = (lane & 3) * 2;
  const long long n = blockIdx.x / H;
  const int h = blockIdx.x % H, q0 = blockIdx.y * qb, rows = min(qb, Tq - q0);
  const T* kb = k + n * st.k[0] + h * st.k[1];
  const T* vb = v + n * st.v[0] + h * st.v[1];
  const float* mb = mask == nullptr ? nullptr : mask + n * st.m[0] + h * st.m[1] + q0 * st.m[2];

  // The query rows (rows past `rows` and dims past hd as zeros), in the first copy group.
  for (int c = tid; c < QROWS * HDP / 8; c += THREADS) {
    const int r = c / (HDP / 8), col = (c % (HDP / 8)) * 8;
    const bool ok = r < rows && col < hd;
    cp_async_16(qs + r * LDK + col, ok ? q + n * st.q[0] + h * st.q[1] + (q0 + r) * st.q[2] + col : q, ok);
  }
  // Ring tile `it`: K's tile it, then V's tile it - tiles; keys past n_keys as zeros.
  auto load = [&](int stage, int it) {
    const bool is_v = it >= tiles;
    const T* base = is_v ? vb : kb;
    const long long stride = is_v ? st.v[2] : st.k[2];
    const int t0 = (is_v ? it - tiles : it) * KT;
    T* dst = ring + stage * KT * LDK;
    for (int c = tid; c < KT * HDP / 8; c += THREADS) {
      const int r = c / (HDP / 8), col = (c % (HDP / 8)) * 8;
      const bool ok = t0 + r < n_keys && col < hd;
      cp_async_16(dst + r * LDK + col, ok ? base + (t0 + r) * stride + col : base, ok);
    }
  };

  const int total = 2 * tiles;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's part)
    __syncthreads();              // everyone's part, and every warp is done with tile it - 1
    if (it + STAGES - 1 < total) load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();
    const T* tile = ring + (it % STAGES) * KT * LDK;

    if (it < tiles) {  // phase 1: this warp's 8 keys of the tile, every query row
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, qs + (lane & 15) * LDK + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x2(b, tile + (warp * 8 + (lane & 7)) * LDK + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_16816<T>(c, a, b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), t = it * KT + warp * 8 + t2 + (e & 1);
        if (r < rows && t < n_keys) {
          float s = __fdiv_rn(c[e], scale);
          if (mb != nullptr) s = __fadd_rn(s, mb[r * st.m[2] + t * st.m[3]]);
          sc[r * LDS + t] = s;
        }
      }
      if (it == tiles - 1) {  // the softmax of every row, while V's first tiles land
        __syncthreads();
        for (int r = 0; r < rows; ++r) {
          float m = -INFINITY;
          for (int t = tid; t < n_keys; t += THREADS) m = fmaxf(m, sc[r * LDS + t]);
          m = warp_max(m);
          if (lane == 0) red[r * WARPS + warp] = m;
        }
        __syncthreads();
        if (tid < rows) {
          float m = red[tid * WARPS];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[tid * WARPS + w]);
          row_max[tid] = m;
        }
        __syncthreads();
        for (int r = 0; r < rows; ++r) {
          const float m = row_max[r];
          float s = 0.f;
          for (int t = tid; t < n_keys; t += THREADS) {
            const float e = expf(__fsub_rn(sc[r * LDS + t], m));
            sc[r * LDS + t] = e;
            s = __fadd_rn(s, e);
          }
          s = warp_sum(s);
          if (lane == 0) red[r * WARPS + warp] = s;
        }
        __syncthreads();
        if (tid < rows) {
          float s = red[tid * WARPS];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, red[tid * WARPS + w]);
          row_sum[tid] = s;
        }
        __syncthreads();
        for (int r = 0; r < rows; ++r)
          for (int t = tid; t < n_keys; t += THREADS) sc[r * LDS + t] = __fdiv_rn(sc[r * LDS + t], row_sum[r]);
        // the next iteration's barrier publishes the probabilities
      }
    } else {  // phase 2: chunk j of the tile, half `half` of the head dims
      const int j = warp % CHUNKS, half = warp / CHUNKS, key0 = (it - tiles) * KT + j * CHUNK;
      auto p = [&](int r, int t) { return r < rows && t < n_keys ? sc[r * LDS + t] : 0.f; };
      uint32_t a[4];  // the probabilities rounded to T: rows g, g + 8; keys key0 + t2, +1, +8, +9
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x & 1), t = key0 + t2 + 8 * (x >> 1);
        a[x] = hopper::pack2<T>(p(r, t), p(r, t + 1));
      }
      float c[HALF_TILES][4];
#pragma unroll
      for (int nt = 0; nt < HALF_TILES; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
      for (int nt = 0; nt < HALF_TILES; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tile + (j * CHUNK + (lane & 15)) * LDK + half * (HDP / 2) + nt * 8 + (lane >> 4) * 8);
        mma_16816<T>(c[nt], a, b[0], b[1]);
        mma_16816<T>(c[nt + 1], a, b[2], b[3]);
      }
      float* pj = part + j * qb * LDP;
#pragma unroll
      for (int nt = 0; nt < HALF_TILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1);
          if (r < rows) pj[r * LDP + half * (HDP / 2) + nt * 8 + t2 + (e & 1)] = c[nt][e];
        }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ACC; ++i) {  // the tile's chunks into each output, in chunk order
        const int e = tid + i * THREADS, r = e / HDP, d = e % HDP;
        if (r < rows)
#pragma unroll
          for (int jj = 0; jj < CHUNKS; ++jj) acc[i] = __fadd_rn(acc[i], part[(jj * qb + r) * LDP + d]);
      }
    }
  }
  cp_async_wait<0>();

  T* o = out + ((n * H + h) * Tq + q0) * static_cast<long long>(hd);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * THREADS, r = e / HDP, d = e % HDP;
    if (r < rows && d < hd) o[r * hd + d] = hopper::from_float<T>(acc[i]);
  }
}

// The CUDA-core kernel (fp32; bf16 and fp16 past head dim 256): a block a
// query row, a warp a key for the scores, a thread an output dim for p . v
// (t ascending); the scores in shared memory; p rounded to T (a no-op in
// fp32), the output to T.
constexpr int F32_THREADS = 128, F32_WARPS = F32_THREADS / 32;
constexpr int F32_HD = 1024, F32_KEYS = 4096;  // the static arrays' sizes
constexpr int F32_MAX_FLOATS = (SMEM_MAX - 1024) / 4;  // hd + keys in dynamic shared memory

// the body of both: `qs` holds the query row (hd), `p` the scores (n_keys)
template <typename T>
__device__ __forceinline__ void rows_f32(float* qs, float* p, float* red, const T* __restrict__ q,
                                         const T* __restrict__ k, const T* __restrict__ v,
                                         const float* __restrict__ mask, T* __restrict__ out, Strides st,
                                         int H, int Tq, int n_keys, int hd, float scale) {
  const int i = blockIdx.y, h = blockIdx.x % H, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long n = blockIdx.x / H;
  const T* qr = q + n * st.q[0] + h * st.q[1] + i * st.q[2];
  for (int j = tid; j < hd; j += F32_THREADS) qs[j] = hopper::to_float(qr[j]);
  __syncthreads();

  const T* kb = k + n * st.k[0] + h * st.k[1];
  const float* mr = mask == nullptr ? nullptr : mask + n * st.m[0] + h * st.m[1] + i * st.m[2];
  for (int t = warp; t < n_keys; t += F32_WARPS) {
    const T* kr = kb + t * st.k[2];
    float s = 0.f;
    for (int j = lane; j < hd; j += 32) s = __fmaf_rn(qs[j], hopper::to_float(kr[j]), s);
    s = __fdiv_rn(warp_sum(s), scale);
    if (lane == 0) p[t] = mr == nullptr ? s : __fadd_rn(s, mr[t * st.m[3]]);
  }
  __syncthreads();

  float m = -INFINITY;
  for (int t = tid; t < n_keys; t += F32_THREADS) m = fmaxf(m, p[t]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < F32_WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused below

  float sum = 0.f;
  for (int t = tid; t < n_keys; t += F32_THREADS) {
    const float e = expf(__fsub_rn(p[t], m));
    p[t] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < F32_WARPS; ++w) sum = __fadd_rn(sum, red[w]);
  for (int t = tid; t < n_keys; t += F32_THREADS) p[t] = hopper::to_float(hopper::from_float<T>(__fdiv_rn(p[t], sum)));
  __syncthreads();

  const T* vb = v + n * st.v[0] + h * st.v[1];
  T* o = out + ((n * H + h) * Tq + i) * static_cast<long long>(hd);
  for (int j = tid; j < hd; j += F32_THREADS) {
    float a = 0.f;
    for (int t = 0; t < n_keys; ++t) a = __fmaf_rn(p[t], hopper::to_float(vb[t * st.v[2] + j]), a);
    o[j] = hopper::from_float<T>(a);
  }
}

template <typename T>
__global__ void __launch_bounds__(F32_THREADS)
attention_rows_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ mask, T* __restrict__ out, Strides st, int H, int Tq, int n_keys,
                   int hd, float scale) {
  __shared__ float qs[F32_HD];
  __shared__ float p[F32_KEYS];
  __shared__ float red[F32_WARPS];
  rows_f32<T>(qs, p, red, q, k, v, mask, out, st, H, Tq, n_keys, hd, scale);
}

template <typename T>
__global__ void __launch_bounds__(F32_THREADS)
attention_rows_f32_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ out, Strides st, int H, int Tq, int n_keys,
                        int hd, float scale) {
  extern __shared__ float dyn[];
  __shared__ float red[F32_WARPS];
  rows_f32<T>(dyn, dyn + hd, red, q, k, v, mask, out, st, H, Tq, n_keys, hd, scale);
}

template <typename T, int HDP>
int launch_bf16(const void* q, const void* k, const void* v, const float* m, void* out, const Strides& st, int N,
                int H, int Tq, int n_keys, int hd, float scale, cudaStream_t s) {
  static hopper::SmemLimit limit;
  if (const int e = limit.ensure(attention_rows_bf16<T, HDP>, SMEM_MAX)) return e;
  const int tiles = (n_keys + KT - 1) / KT;
  int qb = Tq < QROWS ? Tq : QROWS;  // a row's sums do not depend on the rows beside it in the block
  while (qb > 1 && smem_bytes(HDP, qb, tiles) > SMEM_MAX) qb = (qb + 1) / 2;
  const int bytes = smem_bytes(HDP, qb, tiles);
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N * H, (Tq + qb - 1) / qb);
  attention_rows_bf16<T, HDP><<<grid, THREADS, bytes, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                           static_cast<const T*>(v), m, static_cast<T*>(out), st, H,
                                                           Tq, n_keys, hd, qb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, const float* m, void* out, const Strides& st, int N,
                int H, int Tq, int n_keys, int hd, float scale, cudaStream_t s) {
  if (static_cast<long long>(hd) + n_keys > F32_MAX_FLOATS) return static_cast<int>(cudaErrorInvalidValue);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k), *vp = static_cast<const T*>(v);
  const dim3 grid(N * H, Tq);
  if (hd <= F32_HD && n_keys <= F32_KEYS) {
    attention_rows_f32<T><<<grid, F32_THREADS, 0, s>>>(qp, kp, vp, m, static_cast<T*>(out), st, H, Tq, n_keys, hd,
                                                       scale);
  } else {
    static hopper::SmemLimit limit;
    if (const int e = limit.ensure(attention_rows_f32_wide<T>, 4 * F32_MAX_FLOATS)) return e;
    attention_rows_f32_wide<T><<<grid, F32_THREADS, 4 * (hd + n_keys), s>>>(qp, kp, vp, m, static_cast<T*>(out), st,
                                                                            H, Tq, n_keys, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_16(const void* q, const void* k, const void* v, const float* m, void* out, const Strides& st, int N, int H,
              int Tq, int n_keys, int hd, float scale, cudaStream_t s) {
  // head dims past the mma design's, and keys past what it holds at one query row a block
  const int hdp = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  if (hd > MMA_MAX_HD || smem_bytes(hdp, 1, (n_keys + KT - 1) / KT) > SMEM_MAX)
    return launch_simt<T>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
  const auto aligned = [](const void* p, long long stride) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 8 == 0;
  };
  if (hd % 8 || !aligned(q, st.q[0] | st.q[1] | st.q[2]) || !aligned(k, st.k[0] | st.k[1] | st.k[2]) ||
      !aligned(v, st.v[0] | st.v[1] | st.v[2]))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32) return launch_bf16<T, 32>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
  if (hd <= 64) return launch_bf16<T, 64>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
  if (hd <= 128) return launch_bf16<T, 128>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
  return launch_bf16<T, 256>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
}

}  // namespace

// The most of hd + keys the CUDA-core kernel holds in shared memory (the
// mma design sends it the keys it cannot hold).
extern "C" int attention_rows_max_floats() { return F32_MAX_FLOATS; }

// Launch on `stream`; returns 0 or a cudaError_t. q (N, H, Tq, hd), k and v
// (N, H, Tk, hd) of `dtype` (0: fp32, 1: bf16, 2: fp16) with the strides
// (elements) of their first three dims in `strides[0:3]`, `[3:6]`, `[6:9]`
// and a contiguous last dim; `mask` null or fp32 with the strides of its
// (N, H, Tq, Tk) broadcast in `strides[9:13]`; `out` a contiguous
// (N, H, Tq, hd) of `dtype`. Only keys 0..n_keys-1 are read
// (1 <= n_keys <= Tk); hd + n_keys <= attention_rows_max_floats(); bf16 and
// fp16 at hd <= 256 (the mma design): hd % 8 == 0 and 16-byte aligned
// pointers and row strides; N * H < 2^31.
extern "C" int launch_attention_rows(const void* q, const void* k, const void* v, const void* mask, void* out,
                                     const long long* strides, int N, int H, int Tq, int Tk, int n_keys, int hd,
                                     float scale, int dtype, void* stream) {
  if (N < 0 || H <= 0 || Tq <= 0 || Tk <= 0 || n_keys <= 0 || n_keys > Tk || hd <= 0 ||
      static_cast<long long>(hd) + n_keys > F32_MAX_FLOATS || static_cast<long long>(N) * H > 0x7fffffffLL ||
      Tq > 65535 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  Strides st;
  for (int d = 0; d < 3; ++d) {
    st.q[d] = strides[d];
    st.k[d] = strides[3 + d];
    st.v[d] = strides[6 + d];
  }
  for (int d = 0; d < 4; ++d) st.m[d] = strides[9 + d];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) return launch_simt<float>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
  if (dtype == 1) return launch_16<__nv_bfloat16>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
  return launch_16<__half>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, s);
}
