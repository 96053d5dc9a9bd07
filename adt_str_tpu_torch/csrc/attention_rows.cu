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
// at every head dim, bf16 and fp16 past head dim 256 (2 heads or 1 at d
// 768, 1 at d 2,048: the mma design's ring and partials outgrow shared
// memory and its registers there), and the keys the mma design cannot hold
// at one query row a block (past ~21,000 at head dim 256) take the
// split-key design below (`attention_rows_scores`, `_pv`, `_sum`): the keys
// of a row cut into splits of a size set by the head dim, so a decode
// bucket's few rows still fill the card, every k and v row read once with
// 16-byte loads by a block that holds all the query rows of its item (the
// beam's 5 queries read their item's cross rows once), the probabilities
// rounded after the row's global max and sum as before. It takes any head
// dim and key count with hd + keys <= 57,856 (one query row and a split's
// scores in a block's shared memory).

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

// The split-key design (fp32 at every head dim; bf16 and fp16 past head
// dim 256, and at the keys the mma design cannot hold). A row's keys are cut
// into splits of `ks` keys, ks a function of the head dim alone
// (ops/attention_rows.py:keys_per_split), and three launches follow the
// plain version's rounding points:
//   1. scores: a block an (item, head), a group of its query rows and a
//      split; the query rows in fp32 shared memory, a warp a key (lanes
//      over the head dim in 16-byte loads, each lane's products in dim
//      order, a xor butterfly), s = (q . k) / sqrt(hd) + mask in fp32; s
//      and the split's max m_i to a workspace;
//   2. p . v: the row's max M = max_i m_i and sum L = sum_t exp(s_t - M)
//      over all its keys (a warp a row, lane t % 32's keys in order, a
//      butterfly: every block of the row forms the same L, the plain
//      version's sum in another order, not a rescaled sum of split sums);
//      p = T(exp(s - M) / L), the probabilities
//      rounded as the plain version rounds them, after the global max and
//      sum; then the split's sum p v (groups of threads over keys g, g + G,
//      ..., a thread a 16-byte strip of the head dim, the groups' partials
//      added in group order) into a partial, or into out when one split
//      covers the row;
//   3. out = T(the partials added in split order).
// Every order depends on the head dim and the split alone, never on the
// rows beside a row, so a row keeps its bits alone or in a batch. A key past
// n_keys (the decode step's valid keys) is read by no pass: in the masked
// read of all keys it adds exp(s - 1e4 - m) = 0 to every sum, a product
// with a zero probability, and whole splits of such keys add +0 to the
// partials, so the two reads are bit-equal.
constexpr int SPLIT_THREADS = 256, SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int SPLIT_MAX_KEYS = 256;  // keys a split at most (ks <= 256)
constexpr int MAX_FLOATS = (SMEM_MAX - 1024) / 4;  // hd + keys: the published domain

struct SplitArgs {
  int H, Tq, n_keys, hd, qb, ks, splits;
  float scale;
};

// Query rows a block: up to `most` (the accumulators a thread keeps in pass
// 2), as many as pass 1's fp32 query rows and scores and pass 2's
// probabilities and group partials leave room for.
__host__ __device__ constexpr int split_groups(int nvec) { return nvec >= SPLIT_THREADS ? 1 : SPLIT_THREADS / nvec; }
inline int scores_smem(int qb, int hd, int ks) { return 4 * qb * (hd + ks); }
inline int pv_smem(int qb, int hd, int ks, int nvec) {
  const int g = split_groups(nvec);
  return 4 * (qb * ks + 2 * qb + (g > 1 ? g * qb * hd : 0));
}

// VEC elements of T at p (16-byte aligned when VEC > 1) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = hopper::to_float(p[0]);
  } else if constexpr (VEC == 4) {
    static_assert(sizeof(T) == 4, "4 floats a 16-byte load");
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
    static_assert(VEC == 8 && sizeof(T) == 2, "8 16-bit values a 16-byte load");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = hopper::unpack2<T>(w[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  }
}

// Pass 1. Block (item, head, row group) x split; workspace: sc [rows][splits][ks] (a row's keys in order),
// mx [rows][splits].
template <typename T, int VEC, int MAXR>
__global__ void __launch_bounds__(SPLIT_THREADS)
attention_rows_scores(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ mask,
                      float* __restrict__ sc_out, float* __restrict__ mx_out, Strides st, SplitArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [qb][hd]
  float* sc = qs + a.qb * a.hd;    // [qb][ks]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (a.Tq + a.qb - 1) / a.qb;
  const long long nh = blockIdx.x / groups;
  const long long n = nh / a.H;
  const int h = static_cast<int>(nh % a.H), q0 = static_cast<int>(blockIdx.x % groups) * a.qb;
  const int rows = min(a.qb, a.Tq - q0), split = blockIdx.y, t0 = split * a.ks, keys = min(a.ks, a.n_keys - t0);
  const int nvec = a.hd / VEC;

  for (int i = tid; i < rows * a.hd; i += SPLIT_THREADS) {
    const int r = i / a.hd, j = i % a.hd;
    qs[i] = hopper::to_float(q[n * st.q[0] + h * st.q[1] + (q0 + r) * st.q[2] + j]);
  }
  __syncthreads();

  const T* kb = k + n * st.k[0] + h * st.k[1];
  const float* mb = mask == nullptr ? nullptr : mask + n * st.m[0] + h * st.m[1] + q0 * st.m[2];
  for (int t = warp; t < keys; t += SPLIT_WARPS) {
    const T* kr = kb + (t0 + t) * st.k[2];
    float s[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) s[r] = 0.f;
#pragma unroll 2
    for (int c = lane; c < nvec; c += 32) {
      float kv[VEC];
      load_vec<T, VEC>(kr + c * VEC, kv);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const float* qr = qs + r * a.hd + c * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[r] = __fmaf_rn(qr[e], kv[e], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < rows) {
        float v = __fdiv_rn(warp_sum(s[r]), a.scale);
        if (mb != nullptr) v = __fadd_rn(v, mb[r * st.m[2] + (t0 + t) * st.m[3]]);
        if (lane == 0) sc[r * a.ks + t] = v;
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < rows; r += SPLIT_WARPS) {
    const float* sr = sc + r * a.ks;
    float m = -INFINITY;
    for (int t = lane; t < keys; t += 32) m = fmaxf(m, sr[t]);
    m = warp_max(m);
    const long long row = (nh * a.Tq + q0 + r) * a.splits + split;
    float* so = sc_out + row * a.ks;
    for (int t = lane; t < keys; t += 32) so[t] = sr[t];
    if (lane == 0) mx_out[row] = m;
  }
}

// Pass 2: the split's p . v into part [rows][splits][hd], or into out when splits == 1.
template <typename T, int VEC, int MAXR>
__global__ void __launch_bounds__(SPLIT_THREADS)
attention_rows_pv(const T* __restrict__ v, const float* __restrict__ sc_in, const float* __restrict__ mx_in,
                  float* __restrict__ part, T* __restrict__ out, Strides st, SplitArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* p = sm;                    // [qb][ks]
  float* row_max = p + a.qb * a.ks;
  float* row_sum = row_max + a.qb;
  float* gpart = row_sum + a.qb;    // [G][qb][hd] when G > 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (a.Tq + a.qb - 1) / a.qb;
  const long long nh = blockIdx.x / groups;
  const long long n = nh / a.H;
  const int h = static_cast<int>(nh % a.H), q0 = static_cast<int>(blockIdx.x % groups) * a.qb;
  const int rows = min(a.qb, a.Tq - q0), split = blockIdx.y, t0 = split * a.ks, keys = min(a.ks, a.n_keys - t0);
  const int nvec = a.hd / VEC, G = split_groups(nvec), W = G == 1 ? SPLIT_THREADS : nvec;

  for (int r = warp; r < rows; r += SPLIT_WARPS) {  // the row's max and sum over all its keys
    const long long row = nh * a.Tq + q0 + r;
    const float* mx = mx_in + row * a.splits;
    float m = -INFINITY;
    for (int i = lane; i < a.splits; i += 32) m = fmaxf(m, mx[i]);
    m = warp_max(m);
    const float* sr = sc_in + row * a.splits * a.ks;  // key t at t: splits hold ks keys each
    float l = 0.f;
    for (int t = lane; t < a.n_keys; t += 32) l = __fadd_rn(l, expf(__fsub_rn(sr[t], m)));
    l = warp_sum(l);
    if (lane == 0) {
      row_max[r] = m;
      row_sum[r] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * a.ks; i += SPLIT_THREADS) {
    const int r = i / a.ks, t = i % a.ks;
    const float s = t < keys ? sc_in[((nh * a.Tq + q0 + r) * a.splits + split) * a.ks + t] : 0.f;
    p[i] = t < keys ? hopper::to_float(hopper::from_float<T>(__fdiv_rn(expf(__fsub_rn(s, row_max[r])), row_sum[r])))
                    : 0.f;
  }
  __syncthreads();

  const T* vb = v + n * st.v[0] + h * st.v[1];
  const int g = tid / W;
  if (g < G) {
    for (int c = tid % W; c < nvec; c += W) {
      float acc[MAXR][VEC];
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
#pragma unroll 4
      for (int t = g; t < keys; t += G) {
        float vv[VEC];
        load_vec<T, VEC>(vb + (t0 + t) * st.v[2] + c * VEC, vv);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < rows) {
            const float pr = p[r * a.ks + t];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = __fmaf_rn(pr, vv[e], acc[r][e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const long long row = nh * a.Tq + q0 + r;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int j = c * VEC + e;
            if (G > 1)
              gpart[(g * a.qb + r) * a.hd + j] = acc[r][e];
            else if (a.splits == 1)
              out[row * a.hd + j] = hopper::from_float<T>(acc[r][e]);
            else
              part[(row * a.splits + split) * a.hd + j] = acc[r][e];
          }
        }
      }
    }
  }
  if (G > 1) {  // the groups' partials, in group order
    __syncthreads();
    for (int i = tid; i < rows * a.hd; i += SPLIT_THREADS) {
      const int r = i / a.hd, j = i % a.hd;
      float s = gpart[r * a.hd + j];
      for (int gg = 1; gg < G; ++gg) s = __fadd_rn(s, gpart[(gg * a.qb + r) * a.hd + j]);
      const long long row = nh * a.Tq + q0 + r;
      if (a.splits == 1)
        out[row * a.hd + j] = hopper::from_float<T>(s);
      else
        part[(row * a.splits + split) * a.hd + j] = s;
    }
  }
}

// Pass 3: out = T(the partials in split order), a thread an output.
template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
attention_rows_sum(const float* __restrict__ part, T* __restrict__ out, long long outputs, int hd, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (i >= outputs) return;
  const long long row = i / hd;
  const int j = static_cast<int>(i % hd);
  const float* pp = part + row * splits * hd + j;
  float s = pp[0];
  for (int x = 1; x < splits; ++x) s = __fadd_rn(s, pp[static_cast<long long>(x) * hd]);
  out[i] = hopper::from_float<T>(s);
}

template <typename T, int VEC>
int launch_split_vec(const void* q, const void* k, const void* v, const float* m, void* out, const Strides& st,
                     int N, int H, int Tq, int n_keys, int hd, int ks, float scale, float* work, cudaStream_t s) {
  constexpr int MAXR = VEC == 8 ? 8 : 16;  // pass 2's accumulators: MAXR x VEC a thread
  static hopper::SmemLimit limit1, limit2;
  if (const int e = limit1.ensure(attention_rows_scores<T, VEC, MAXR>, SMEM_MAX)) return e;
  if (const int e = limit2.ensure(attention_rows_pv<T, VEC, MAXR>, SMEM_MAX)) return e;
  const int nvec = hd / VEC, splits = (n_keys + ks - 1) / ks;
  int qb = Tq < MAXR ? Tq : MAXR;  // a row's sums do not depend on the rows beside it in the block
  while (qb > 1 && (scores_smem(qb, hd, ks) > SMEM_MAX || pv_smem(qb, hd, ks, nvec) > SMEM_MAX)) --qb;
  if (scores_smem(qb, hd, ks) > SMEM_MAX || pv_smem(qb, hd, ks, nvec) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(N) * H * Tq;
  if (static_cast<long long>(N) * H * ((Tq + qb - 1) / qb) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  float* sc = work;
  float* mx = sc + rows * splits * ks;
  float* part = mx + rows * splits;
  const SplitArgs a{H, Tq, n_keys, hd, qb, ks, splits, scale};
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * H * ((Tq + qb - 1) / qb)), splits);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k), *vp = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  attention_rows_scores<T, VEC, MAXR><<<grid, SPLIT_THREADS, scores_smem(qb, hd, ks), s>>>(qp, kp, m, sc, mx, st, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_rows_pv<T, VEC, MAXR><<<grid, SPLIT_THREADS, pv_smem(qb, hd, ks, nvec), s>>>(vp, sc, mx, part, o, st, a);
  if (splits > 1 && (e = cudaGetLastError()) == cudaSuccess) {
    const long long outputs = rows * hd;
    attention_rows_sum<T><<<static_cast<unsigned>((outputs + SPLIT_THREADS - 1) / SPLIT_THREADS), SPLIT_THREADS, 0,
                            s>>>(part, o, outputs, hd, splits);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The split-key design: 16-byte loads where the head dim is a multiple of
// their elements (the wrapper then hands 16-byte aligned rows), else one
// element a load; the load width, like ks, follows the head dim alone.
template <typename T>
int launch_split(const void* q, const void* k, const void* v, const float* m, void* out, const Strides& st, int N,
                 int H, int Tq, int n_keys, int hd, int ks, float scale, float* work, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (ks < 1 || ks > SPLIT_MAX_KEYS || static_cast<long long>(hd) + ks > MAX_FLOATS || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd % VEC) return launch_split_vec<T, 1>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, ks, scale, work, s);
  const auto aligned = [](const void* p, const long long* stride) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (stride[0] | stride[1] | stride[2]) % VEC == 0;
  };
  if (!aligned(q, st.q) || !aligned(k, st.k) || !aligned(v, st.v)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_split_vec<T, VEC>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, ks, scale, work, s);
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

// The mma design at 16-bit head dims up to 256 where one query row's scores
// fit a block (ks == 0: the wrapper's route); else the split-key design.
template <typename T>
int launch_16(const void* q, const void* k, const void* v, const float* m, void* out, const Strides& st, int N, int H,
              int Tq, int n_keys, int hd, float scale, int ks, float* work, cudaStream_t s) {
  if (ks > 0) return launch_split<T>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, ks, scale, work, s);
  const int hdp = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  if (hd > MMA_MAX_HD || smem_bytes(hdp, 1, (n_keys + KT - 1) / KT) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
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

// The most of hd + keys the kernel takes (the split-key design's pass 1
// holds a query row and a split's scores in shared memory).
extern "C" int attention_rows_max_floats() { return MAX_FLOATS; }

// Launch on `stream`; returns 0 or a cudaError_t. q (N, H, Tq, hd), k and v
// (N, H, Tk, hd) of `dtype` (0: fp32, 1: bf16, 2: fp16) with the strides
// (elements) of their first three dims in `strides[0:3]`, `[3:6]`, `[6:9]`
// and a contiguous last dim; `mask` null or fp32 with the strides of its
// (N, H, Tq, Tk) broadcast in `strides[9:13]`; `out` a contiguous
// (N, H, Tq, hd) of `dtype`. Only keys 0..n_keys-1 are read
// (1 <= n_keys <= Tk); hd + n_keys <= attention_rows_max_floats(); N * H <
// 2^31. `keys_per_split` 0 asks for the mma design (bf16 and fp16 at hd <=
// 256, hd % 8 == 0, 16-byte aligned pointers and row strides); ks > 0 for
// the split-key design with splits of ks keys, `work` then holds
// N H Tq splits (ks + 1 + (splits > 1 ? hd : 0)) floats, and where hd is a
// multiple of 16 bytes' elements the pointers and row strides are 16-byte
// aligned.
extern "C" int launch_attention_rows(const void* q, const void* k, const void* v, const void* mask, void* out,
                                     const long long* strides, int N, int H, int Tq, int Tk, int n_keys, int hd,
                                     float scale, int dtype, int keys_per_split, void* work, void* stream) {
  if (N < 0 || H <= 0 || Tq <= 0 || Tk <= 0 || n_keys <= 0 || n_keys > Tk || hd <= 0 ||
      static_cast<long long>(hd) + n_keys > MAX_FLOATS || static_cast<long long>(N) * H > 0x7fffffffLL ||
      Tq > 65535 || dtype < 0 || dtype > 2 || keys_per_split < 0 || (dtype == 0 && keys_per_split == 0))
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
  float* w = static_cast<float*>(work);
  const int ks = keys_per_split;
  if (dtype == 0) return launch_split<float>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, ks, scale, w, s);
  if (dtype == 1) return launch_16<__nv_bfloat16>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, ks, w, s);
  return launch_16<__half>(q, k, v, m, out, st, N, H, Tq, n_keys, hd, scale, ks, w, s);
}
