// K5 forward and backward past head dim 256 on the tensor cores, for Hopper
// (sm_90a): bf16 or fp16 q, k, v at every head dim D >= 384 that is a
// multiple of 128 (2 heads of 384, 1 of 768 at d 768; 1 of 2,048 at d
// 2,048), any Tq, Tk >= 1, with no upper limit on D.
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel) and
// :_vjp_bwd (_bwd_kernel) for those inputs, with the arithmetic and the
// rounding points of attention.cu and attention_bwd.cu (see their headers):
//     s = (q . k) * scale + mask;  m = max(max_j s, -1e4 if n_virtual > 0)
//     l = sum_j exp(s - m) + n_virtual * exp(-1e4 - m);  lse = m + log(l)
//     out = T(sum_j T(exp(s - m) / l) v_j)                 (T: q's type)
//     p = exp(s - lse);  dv = p^T do;  dp = do v^T;  delta = rowsum(do * out)
//     ds = p (dp - delta) * scale;  dq = ds k;  dk = ds^T q
// with p and ds rounded to T before their products, the outputs to T, fp32
// accumulation, __expf, and fp16's per-(batch, head) ds scale of
// attention_bwd.cu (ds times a power of two that takes its bound to 2^14).
//
// What holds the head-dim-128 design back past 256: a 128-row Q tile is
// 96 KB at D 384 and a 64-key K or V tile 48 KB (its 4-slot ring no longer
// fits 232,448 B), and a warpgroup's O accumulator of 64 rows is D / 2 fp32
// registers a thread (192 at 384, 384 at 768); the backward's dK and dV twice
// that. So here the head dim never sizes a tile or an accumulator:
//   - the depth is streamed: S = Q K^T and dP = dO V^T are summed over the
//     head dim 64 columns (one TMA box, one 128-byte swizzle atom) a ring
//     stage, on wgmma m64n64k16 with both operands in shared memory;
//   - the outputs are cut in 128-column chunks, each formed as the D-128
//     kernels form theirs.
// Forward: a block of 64 query rows of one (batch, head) and two consumer
// warpgroups that split each 128-key tile (64 keys each) for the scores and
// each 128-column output chunk (64 columns each) for P V. Pass 1 streams
// (Q, K) atoms for the row max and sum (online, fp32; the two warpgroups'
// partials are joined through shared memory). Pass 2 forms the key
// segment's rounded p, T(exp(s - m) / l), once into shared memory (64 rows x
// 512 keys, 64 KB, in the swizzled K-major layout wgmma reads), then runs
// P V for every output chunk from it, V streaming 128 keys x 128 columns a
// stage: S is formed twice in all, as in attention.cu, not once a chunk.
// Past 512 keys p is formed again for each chunk (its segments do not fit).
// Backward: a block of one (batch, head) and one 128-column chunk c of dq,
// dk and dv, walking the 128-key tiles and, in each, the 64-query tiles as
// attention_bwd.cu does (the same grid of (batch, head) blocks at 3 chunks
// a head as at 3 heads of 128). Each (key tile, query tile) step streams the
// head dim's (K, V, Q, dO) atoms through a 3-slot ring, chunk c's two atoms
// last: S^T and dP^T over the full depth (each warpgroup 64 keys), then P^T
// and dS^T in registers, dV_c += P^T dO_c and dK_c += dS^T Q_c from the two
// held slots, and dQ_c += dS K_c through a dS^T tile in shared memory, dq's
// partial sums over key tiles meeting in an fp32 scratch in key-tile order
// (one thread an element, in program order: deterministic, no atomics
// between blocks). S and dP are formed once a chunk: D / 128 times in all.
// The mask tile (fp32, 64 queries x 128 keys) is copied into shared memory
// by the producer's other three warps with 4-byte cp.async (its row stride
// is not 16-byte aligned, which TMA refuses), as in attention_bwd.cu.
//
// Bound on an H100 at the 2-head training shape (B 64, 2 heads of 384,
// 511 x 511 + mask): the work of D 128 at 6 heads, 51 GFLOP forward and 128
// backward (0.05 / 0.13 ms at 989 TFLOP/s), 0.08 / 0.14 ms of bytes. The
// streamed depth re-reads Q (forward) and K, V (backward) from L2 once a
// tile, and the backward forms S and dP once a chunk (3 times at 384), so
// both are bound by L2 and the tensor cores well above the minimum.

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 384;             // warpgroups 0, 1: consumers; 2: producer
constexpr int BQ = 64;                   // query rows of a block (forward) or a query tile (backward)
constexpr int BK = 128;                  // keys of a key tile, 64 a consumer warpgroup
constexpr float NEG_MASK = -1e4f;
constexpr int ATOM64 = 64 * 128;         // 64 rows of 64 columns, 128-byte swizzle (8 KB)
constexpr int ATOM128 = 128 * 128;       // 128 rows of 64 columns (16 KB)
constexpr int DELTA_WARPS = 8, DELTA_ROWS = 8;

// forward
constexpr int F_SLOTS = 4;
constexpr int F_SLOT = 2 * ATOM128;      // a V stage (128 keys x 128 columns); a score stage takes 24 KB
constexpr int F_SEG_TILES = 4;           // key tiles of a p segment: 512 keys
constexpr int F_P_BYTES = F_SEG_TILES * 2 * ATOM64;  // p of 64 rows x 512 keys (64 KB)
constexpr int F_STATS = 2 * 128 * 4 * 4;             // [warpgroup][thread][m, l of two rows]
constexpr int F_SMEM = 1024 + F_SLOTS * F_SLOT + F_P_BYTES + F_STATS + 2 * F_SLOTS * 8;
static_assert(F_SMEM <= 232448, "shared memory of one block");

// backward
constexpr int B_SLOTS = 3;
constexpr int B_SLOT = 2 * ATOM128 + 2 * ATOM64;  // K, V atoms (128 keys), Q, dO atoms (64 queries): 48 KB
constexpr int B_DS = BK * BQ * 2;                 // dS^T tile: 128 key rows of 64 queries (16 KB)
constexpr int B_MASK = BQ * BK * 4;               // the fp32 mask tile (32 KB)
constexpr int B_STATS = 2 * BQ * 4;               // lse and delta of the query tile
constexpr int B_SMEM = 1024 + B_SLOTS * B_SLOT + 2 * B_DS + B_MASK + B_STATS + (2 * B_SLOTS + 2) * 8;
static_assert(B_SMEM <= 232448, "shared memory of one block");

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wide_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,  // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap k_map,  // (B*H, Tk, D), boxes of 128 rows
    const __grid_constant__ CUtensorMap v_map,  // (B*H, Tk, D), boxes of 128 rows
    const float* __restrict__ mask,             // (B, Tq, Tk) or null
    T* __restrict__ out,                        // (B, H, Tq, D)
    float* __restrict__ lse,                    // (B, H, Tq)
    int H, int D, int Tq, int Tk, int n_virtual, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem;                               // [F_SLOTS][F_SLOT]
  uint8_t* pbuf = ring + F_SLOTS * F_SLOT;            // [8 atoms of 64 keys][64 rows][64]
  float* stats = reinterpret_cast<float*>(pbuf + F_P_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + F_P_BYTES + F_STATS);
  uint64_t* empty = full + F_SLOTS;

  const int nq = (Tq + BQ - 1) / BQ;
  const int h = blockIdx.x % H, qt = (blockIdx.x / H) % nq, b = blockIdx.x / (H * nq);
  const int bh = b * H + h, q0 = qt * BQ;
  const int NA = D / 64, NCP = D / 128;
  const int nk = (Tk + BK - 1) / BK, nseg = (nk + F_SEG_TILES - 1) / F_SEG_TILES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the slot
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: the stages in the consumers' order (see the header)
    setmaxnreg_dec<40>();
    if (t != 0) return;
    int pos = 0;
    auto next = [&](uint32_t bytes, uint64_t*& bar) {
      const int s = pos % F_SLOTS;
      mbar_wait(&empty[s], ((pos / F_SLOTS) & 1) ^ 1);
      bar = &full[s];
      mbar_arrive_expect_tx(bar, bytes);
      ++pos;
      return ring + s * F_SLOT;
    };
    auto load_scores = [&](int kt0, int kt1) {  // (Q, K) atoms of each key tile
      for (int kt = kt0; kt < kt1; ++kt)
        for (int a = 0; a < NA; ++a) {
          uint64_t* bar;
          uint8_t* slot = next(ATOM64 + ATOM128, bar);
          tma_load_3d(slot, &q_map, bar, 64 * a, q0, bh);
          tma_load_3d(slot + ATOM64, &k_map, bar, 64 * a, kt * BK, bh);
        }
    };
    load_scores(0, nk);
    for (int cp = 0; cp < NCP; ++cp)
      for (int g = 0; g < nseg; ++g) {
        const int kt0 = g * F_SEG_TILES, kt1 = min(nk, kt0 + F_SEG_TILES);
        if (cp == 0 || nseg > 1) load_scores(kt0, kt1);
        for (int kt = kt0; kt < kt1; ++kt) {  // V: 128 keys x the chunk's 128 columns
          uint64_t* bar;
          uint8_t* slot = next(2 * ATOM128, bar);
          tma_load_3d(slot, &v_map, bar, 128 * cp, kt * BK, bh);
          tma_load_3d(slot + ATOM128, &v_map, bar, 128 * cp + 64, kt * BK, bh);
        }
      }
    return;
  }

  // consumers. Accumulator element i of thread (warp w, lane l) of a 64-row
  // product: row 16 w + l / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
  setmaxnreg_inc<232>();
  const int w = t / 32, l = t % 32;
  const int rl = 16 * w + l / 4;  // the thread's rows of the block: rl, rl + 8
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rl + 8 * r;
    mrow[r] = (mask != nullptr && qi < Tq) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
  }
  int pos = 0;
  auto wait_full = [&](int p) { mbar_wait(&full[p % F_SLOTS], (p / F_SLOTS) & 1); };
  auto release = [&](int p) { mbar_arrive(&empty[p % F_SLOTS]); };

  float S[32] = {};  // each key tile's first product overwrites it (scale_d = 0)
  float mv[32];
  // S = (q . k) * scale + mask over this warpgroup's 64 keys of key tile kt,
  // summed over the head dim one atom a stage; -inf past Tk
  auto scores = [&](int kt) {
    const int key0 = kt * BK + 64 * wg;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * (i / 4) + 2 * (l % 4) + (i & 1);
      const float* mr = mrow[(i / 2) & 1];
      mv[i] = (mr != nullptr && key < Tk) ? __ldg(mr + key) : 0.f;
    }
    fence_regs(S);
    for (int a = 0; a < NA; ++a) {
      const int p = pos + a;
      wait_full(p);
      const uint8_t* slot = ring + (p % F_SLOTS) * F_SLOT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_64x64_ss<T>(S, desc_sw128(slot + kk * 32, 16, 1024),
                        desc_sw128(slot + ATOM64 + wg * ATOM64 + kk * 32, 16, 1024), a > 0 || kk > 0);
      wgmma_commit();
      if (a > 0) {
        wgmma_wait<1>();
        release(p - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(S);
    release(pos + NA - 1);
    pos += NA;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * (i / 4) + 2 * (l % 4) + (i & 1);
      S[i] = key < Tk ? __fadd_rn(__fmul_rn(S[i], scale), mv[i]) : -INFINITY;
    }
  };

  // pass 1: the row max and sum over this warpgroup's keys, online
  float m[2], lsum[2] = {0.f, 0.f};
  m[0] = m[1] = n_virtual > 0 ? NEG_MASK : -INFINITY;
  for (int kt = 0; kt < nk; ++kt) {
    scores(kt);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i / 2) & 1) == r) mx = fmaxf(mx, S[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = m[r] == -INFINITY ? 0.f : lsum[r] * __expf(m[r] - mx);
      if (mx != -INFINITY) {  // a warpgroup whose keys all lie past Tk has none yet
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i / 2) & 1) == r) sum += __expf(S[i] - mx);
      }
      lsum[r] = sum;
      m[r] = mx;
    }
  }
  // the two warpgroups' partials (the same rows, other keys), joined in warpgroup order
  float* mine = stats + (wg * 128 + t) * 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = lsum[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    mine[2 * r] = m[r];
    mine[2 * r + 1] = sum;
  }
  named_barrier(1, 256);
  float mrow_max[2], inv_l[2], row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m0 = stats[t * 4 + 2 * r], m1 = stats[(128 + t) * 4 + 2 * r], mx = fmaxf(m0, m1);
    float sum = (m0 == -INFINITY ? 0.f : stats[t * 4 + 2 * r + 1] * __expf(m0 - mx)) +
                (m1 == -INFINITY ? 0.f : stats[(128 + t) * 4 + 2 * r + 1] * __expf(m1 - mx));
    if (n_virtual > 0) sum += static_cast<float>(n_virtual) * expf(NEG_MASK - mx);
    mrow_max[r] = mx;
    inv_l[r] = 1.f / sum;
    row_lse[r] = mx + logf(sum);
  }
  if (wg == 0 && l % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + rl + 8 * r;
      if (qi < Tq) lse[static_cast<size_t>(bh) * Tq + qi] = row_lse[r];
    }
  }

  // pass 2: p = T(exp(s - m) / l) of a key segment into shared memory, then
  // out's chunk cp (this warpgroup: its columns 64 wg .. + 63) += p V
  for (int cp = 0; cp < NCP; ++cp) {
    float O[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) O[i] = 0.f;
    for (int g = 0; g < nseg; ++g) {
      const int kt0 = g * F_SEG_TILES, kt1 = min(nk, kt0 + F_SEG_TILES);
      if (cp == 0 || nseg > 1) {
        named_barrier(1, 256);  // both warpgroups' products are done with the previous p
        for (int kt = kt0; kt < kt1; ++kt) {
          scores(kt);
          uint8_t* pa = pbuf + ((kt - kt0) * 2 + wg) * ATOM64;  // this warpgroup's 64 keys
#pragma unroll
          for (int j = 0; j < 16; ++j) {  // elements 2j, 2j + 1: row rl + 8 (j & 1)
            const int r = j & 1, c = 8 * (j / 2) + 2 * (l % 4);
            *reinterpret_cast<uint32_t*>(pa + sw128_offset(rl + 8 * r, c)) =
                pack2<T>(__fmul_rn(__expf(S[2 * j] - mrow_max[r]), inv_l[r]),
                         __fmul_rn(__expf(S[2 * j + 1] - mrow_max[r]), inv_l[r]));
          }
        }
        fence_proxy_async();
        named_barrier(1, 256);
      }
      for (int kt = kt0; kt < kt1; ++kt) {
        const int p = pos++;
        wait_full(p);
        const uint8_t* vt = ring + (p % F_SLOTS) * F_SLOT + wg * ATOM128;  // keys x this warpgroup's 64 columns
        fence_regs(O);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_64x64_ss_tb<T>(O, desc_sw128(pbuf + ((kt - kt0) * 2 + kk / 4) * ATOM64 + (kk % 4) * 32, 16, 1024),
                             desc_sw128(vt + kk * 16 * 128, 0, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(O);
        release(p);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int qi = q0 + rl + 8 * (j & 1);
      if (qi < Tq)
        *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(bh) * Tq + qi) * D + 128 * cp + 64 * wg + 8 * (j / 2) +
                                     2 * (l % 4)) = pack2<T>(O[2 * j], O[2 * j + 1]);
    }
  }
}

// The power of two that ds is multiplied by before it is rounded (fp16; see
// attention_bwd.cu): it takes the bound scale |do|max (|v|max + |out|max) of
// (batch, head) bh to [2^13, 2^14); 1 without a bound or where it is 0.
__device__ __forceinline__ float ds_scale(const float* bound, int bh, float scale) {
  if (bound == nullptr) return 1.f;
  const float m = scale * sqrtf(bound[3 * bh]) * (sqrtf(bound[3 * bh + 2]) + sqrtf(bound[3 * bh + 1]));
  if (!(m > 0.f) || !isfinite(m)) return 1.f;
  int e = 0;
  frexpf(16384.f / m, &e);  // 2^(e - 1) <= 16384 / m < 2^e
  return ldexpf(1.f, max(-60, min(60, e - 1)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wide_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map,   // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap do_map,  // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap k_map,   // (B*H, Tk, D), boxes of 128 rows
    const __grid_constant__ CUtensorMap v_map,   // (B*H, Tk, D), boxes of 128 rows
    const float* __restrict__ mask,              // (B, Tq, Tk) or null
    const float* __restrict__ lse,               // (B, H, Tq)
    const float* __restrict__ delta,             // (B, H, Tq)
    float* __restrict__ dq_acc,                  // (B, H, Tq, D) scratch (unused with one key tile)
    const float* __restrict__ bound,             // (B*H, 3) fp16's ds bound or null
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H, int D, int Tq, int Tk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem;                                   // [B_SLOTS][K, V, Q, dO atoms]
  uint8_t* dss = ring + B_SLOTS * B_SLOT;                 // [2][128 keys][64 queries]
  float* mt = reinterpret_cast<float*>(dss + 2 * B_DS);  // [64 queries][128 keys], permuted (see mask_at)
  float* st = mt + BQ * BK;                               // lse[64], delta[64] of the query tile
  uint64_t* full = reinterpret_cast<uint64_t*>(st + 2 * BQ);
  uint64_t* empty = full + B_SLOTS;
  uint64_t* mask_full = empty + B_SLOTS;
  uint64_t* mask_empty = mask_full + 1;

  const int NA = D / 64, NC = D / 128;
  const int c = blockIdx.x % NC, bh = blockIdx.x / NC, b = bh / H;
  const int nkt = (Tk + BK - 1) / BK, nqt = (Tq + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(mask_full, mask == nullptr ? 32 : 32 + 96);  // warp 1's lanes (lse, delta); warps 1-3's mask copies
    mbar_init(mask_empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    const int pw = t / 32, lane = t % 32;
    if (pw == 0) {  // lane 0: the (K, V, Q, dO) atoms of each step, chunk c's two last
      if (lane != 0) return;
      for (int kt = 0; kt < nkt; ++kt)
        for (int qt = 0; qt < nqt; ++qt) {
          const int it = kt * nqt + qt;
          for (int j = 0; j < NA; ++j) {
            const int a = (2 * c + 2 + j) % NA, p = it * NA + j, s = p % B_SLOTS;
            mbar_wait(&empty[s], ((p / B_SLOTS) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], B_SLOT);
            uint8_t* slot = ring + s * B_SLOT;
            tma_load_3d(slot, &k_map, &full[s], 64 * a, kt * BK, bh);
            tma_load_3d(slot + ATOM128, &v_map, &full[s], 64 * a, kt * BK, bh);
            tma_load_3d(slot + 2 * ATOM128, &q_map, &full[s], 64 * a, qt * BQ, bh);
            tma_load_3d(slot + 2 * ATOM128 + ATOM64, &do_map, &full[s], 64 * a, qt * BQ, bh);
          }
        }
      return;
    }
    if (pw >= 2 && mask == nullptr) return;
    // warps 1-3: each step's mask tile; warp 1 also its lse and delta
    const float* lse_bh = lse + static_cast<size_t>(bh) * Tq;
    const float* delta_bh = delta + static_cast<size_t>(bh) * Tq;
    for (int kt = 0; kt < nkt; ++kt)
      for (int qt = 0; qt < nqt; ++qt) {
        const int it = kt * nqt + qt, q0 = qt * BQ;
        mbar_wait(mask_empty, (it & 1) ^ 1);
        if (mask_b != nullptr) {
          // a tile row's 8-key groups are permuted by the query (see `mask_at`)
          for (int r = pw - 1; r < BQ && q0 + r < Tq; r += 3) {
            const float* src = mask_b + static_cast<size_t>(q0 + r) * Tk + kt * BK;
#pragma unroll
            for (int cc = 0; cc < BK / 32; ++cc) {
              const int key = lane + 32 * cc;
              if (kt * BK + key < Tk) cp_async_4(mt + r * BK + (key ^ (8 * ((r >> 1) & 3))), src + key);
            }
          }
          cp_async_arrive(mask_full);
        }
        if (pw == 1) {
          for (int r = lane; r < BQ; r += 32) {
            const bool ok = q0 + r < Tq;
            st[r] = ok ? lse_bh[q0 + r] : INFINITY;  // p = 0 on rows past Tq
            st[BQ + r] = ok ? delta_bh[q0 + r] : 0.f;
          }
          mbar_arrive(mask_full);
        }
      }
    return;
  }

  // consumers: warpgroup wg owns keys 64 wg .. + 63 of each key tile, and
  // columns 64 wg .. + 63 of dq's chunk c
  setmaxnreg_inc<232>();
  const int w = t / 32, l = t % 32;
  const float ds_mult = ds_scale(bound, bh, scale), inv_mult = 1.f / ds_mult;
  const int rk = 64 * wg + 16 * w + l / 4;  // key row of the key tile (and + 8)
  const size_t row0 = static_cast<size_t>(bh) * Tq;
  float S[32] = {}, dP[32] = {}, dQ[32] = {};  // each product's first step overwrites them (scale_d = 0)

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    float dK[2][32], dV[2][32];  // chunk c's two 64-column halves
#pragma unroll
    for (int i = 0; i < 32; ++i) dK[0][i] = dK[1][i] = dV[0][i] = dV[1][i] = 0.f;

    for (int qt = 0; qt < nqt; ++qt) {
      const int it = kt * nqt + qt, q0 = qt * BQ, p0 = it * NA;
      uint8_t* ds = dss + (it & 1) * B_DS;

      // S^T = K Q^T and dP^T = V dO^T over the head dim, an atom a stage;
      // every stage but chunk c's two is released once its products are done
      fence_regs(S);
      fence_regs(dP);
      for (int j = 0; j < NA; ++j) {
        const int p = p0 + j;
        mbar_wait(&full[p % B_SLOTS], (p / B_SLOTS) & 1);
        const uint8_t* slot = ring + (p % B_SLOTS) * B_SLOT;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_64x64_ss<T>(S, desc_sw128(slot + wg * ATOM64 + kk * 32, 16, 1024),
                          desc_sw128(slot + 2 * ATOM128 + kk * 32, 16, 1024), j > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_64x64_ss<T>(dP, desc_sw128(slot + ATOM128 + wg * ATOM64 + kk * 32, 16, 1024),
                          desc_sw128(slot + 2 * ATOM128 + ATOM64 + kk * 32, 16, 1024), j > 0 || kk > 0);
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();
          if (j - 1 < NA - 2) mbar_arrive(&empty[(p - 1) % B_SLOTS]);
        }
      }
      wgmma_wait<0>();
      fence_regs(S);
      fence_regs(dP);

      // p and ds (keys past Tk give 0), from the mask tile and the tile's lse and delta
      mbar_wait(mask_full, it & 1);
      auto mask_at = [&](int cq, int kr) {  // conflict-free for the S^T fragment
        return (mask_b != nullptr && q0 + cq < Tq) ? mt[cq * BK + (kr ^ (8 * ((cq >> 1) & 3)))] : 0.f;
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + rk + 8 * ((i / 2) & 1), cq = 8 * (i / 4) + 2 * (l % 4) + (i & 1);
        S[i] = key < Tk ? __expf(__fadd_rn(__fmul_rn(S[i], scale), mask_at(cq, key - k0)) - st[cq]) : 0.f;
      }
      uint32_t P[16], DS[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cq = 8 * (j / 2) + 2 * (l % 4);  // P[j] packs elements 2j, 2j + 1: row (j & 1)
        const float d0 = S[2 * j] * (dP[2 * j] - st[BQ + cq]) * scale;
        const float d1 = S[2 * j + 1] * (dP[2 * j + 1] - st[BQ + cq + 1]) * scale;
        P[j] = pack2<T>(S[2 * j], S[2 * j + 1]);
        DS[j] = pack2<T>(d0 * ds_mult, d1 * ds_mult);
      }
      mbar_arrive(mask_empty);

      // dV_c += P^T dO_c, dK_c += dS^T Q_c: chunk c's atoms 2c, 2c + 1 lie in the held slots
      const uint8_t* half_slot[2] = {ring + ((p0 + NA - 2) % B_SLOTS) * B_SLOT,
                                     ring + ((p0 + NA - 1) % B_SLOTS) * B_SLOT};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        fence_regs(dV[hh]);
        fence_regs(dK[hh]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2], P[4 * kk + 3]};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mma_64x64_rs_tb<T>(dV[hh], a, desc_sw128(half_slot[hh] + 2 * ATOM128 + ATOM64 + kk * 16 * 128, 0, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {DS[4 * kk], DS[4 * kk + 1], DS[4 * kk + 2], DS[4 * kk + 3]};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mma_64x64_rs_tb<T>(dK[hh], a, desc_sw128(half_slot[hh] + 2 * ATOM128 + kk * 16 * 128, 0, 1024), 1);
      }
      wgmma_commit();

      // dS^T -> shared memory: each warpgroup its own 64 key rows
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cq = 8 * (j / 2) + 2 * (l % 4);
        *reinterpret_cast<uint32_t*>(ds + sw128_offset(rk + 8 * (j & 1), cq)) = DS[j];
      }
      fence_proxy_async();
      named_barrier(1, 256);

      // dQ_part (64 queries x this warpgroup's 64 columns of chunk c) = dS K_c
      const bool last = kt == nkt - 1;
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        fence_regs(dV[hh]);
        fence_regs(dK[hh]);
      }
      fence_regs(dQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_64x64_ss_tt<T>(dQ, desc_sw128(ds + kk * 16 * 128, 0, 1024),
                           desc_sw128((wg == 0 ? half_slot[0] : half_slot[1]) + kk * 16 * 128, 0, 1024), kk > 0);
      wgmma_commit();
      // dq rows q0 + 16 w + l / 4 (+ 8), columns 128 c + 64 wg + 8 j + 2 (l % 4), +1:
      // the last key tile loads the earlier tiles' sum while its product runs
      const size_t col = 128 * static_cast<size_t>(c) + 64 * wg + 2 * (l % 4);
      float2 prev[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 16 * w + l / 4 + 8 * r;
        const size_t base = (row0 + q) * D + col;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          prev[r][j] = (kt > 0 && last && q < Tq) ? __ldcg(reinterpret_cast<const float2*>(dq_acc + base + 8 * j))
                                                  : make_float2(0.f, 0.f);
      }
      wgmma_wait<0>();
      fence_regs(dQ);
      mbar_arrive(&empty[(p0 + NA - 2) % B_SLOTS]);  // chunk c's atoms are read
      mbar_arrive(&empty[(p0 + NA - 1) % B_SLOTS]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 16 * w + l / 4 + 8 * r;
        if (q >= Tq) continue;
        const size_t base = (row0 + q) * D + col;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 v = make_float2(prev[r][j].x + dQ[4 * j + 2 * r] * inv_mult,
                                       prev[r][j].y + dQ[4 * j + 2 * r + 1] * inv_mult);
          float* acc = dq_acc + base + 8 * j;
          if (last) {
            *reinterpret_cast<uint32_t*>(dq + base + 8 * j) = pack2<T>(v.x, v.y);
          } else if (kt == 0) {
            __stcg(reinterpret_cast<float2*>(acc), v);
          } else {  // the middle key tiles add in place, this thread's element in program order
            atomicAdd(acc, v.x);
            atomicAdd(acc + 1, v.y);
          }
        }
      }
    }

    // dk, dv rows of this warpgroup's keys, chunk c's columns (rows past Tk not written)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + rk + 8 * r;
      if (key >= Tk) continue;
      const size_t base = (static_cast<size_t>(bh) * Tk + key) * D + 128 * static_cast<size_t>(c) + 2 * (l % 4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + base + 64 * hh + 8 * j) =
              pack2<T>(dK[hh][4 * j + 2 * r] * inv_mult, dK[hh][4 * j + 2 * r + 1] * inv_mult);
          *reinterpret_cast<uint32_t*>(dv + base + 64 * hh + 8 * j) = pack2<T>(dV[hh][4 * j + 2 * r], dV[hh][4 * j + 2 * r + 1]);
        }
    }
  }
}

// delta = rowsum(do * out) in fp32, a warp a row (D / 32 consecutive
// elements a lane), DELTA_ROWS rows a warp, the rows of one (batch, head)
// (blockIdx.x) a block; with `bound` (fp16; blockIdx.z 1: the rows of v),
// also the largest squared row norms of do, out and v of the (batch, head),
// one atomic max of non-negative floats a block each (order-free).
template <typename T>
__global__ void __launch_bounds__(DELTA_WARPS * 32) wide_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, const T* __restrict__ v, float* __restrict__ delta,
    float* __restrict__ bound, int Tq, int Tk, int D) {
  __shared__ float red[3][DELTA_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, bh = blockIdx.x, words = D / 64;
  const bool v_rows = blockIdx.z == 1;
  const int T_ = v_rows ? Tk : Tq, r0 = (blockIdx.y * DELTA_WARPS + warp) * DELTA_ROWS;
  auto warp_sum = [](float x) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    return x;
  };
  float mx[3] = {0.f, 0.f, 0.f};  // do, out, v
  for (int r = r0; r < r0 + DELTA_ROWS && r < T_; ++r) {
    const size_t row = static_cast<size_t>(bh) * T_ + r;
    if (v_rows) {
      const uint32_t* wv = reinterpret_cast<const uint32_t*>(v + row * D) + lane * words;
      float n = 0.f;
      for (int j = 0; j < words; ++j) {
        const float2 a = unpack2<T>(wv[j]);
        n = fmaf(a.x, a.x, fmaf(a.y, a.y, n));
      }
      mx[2] = fmaxf(mx[2], warp_sum(n));
      continue;
    }
    const uint32_t* o = reinterpret_cast<const uint32_t*>(out + row * D) + lane * words;
    const uint32_t* g = reinterpret_cast<const uint32_t*>(dout + row * D) + lane * words;
    float sum = 0.f, no = 0.f, ng = 0.f;
    for (int j = 0; j < words; ++j) {
      const float2 a = unpack2<T>(o[j]), cc = unpack2<T>(g[j]);
      sum = fmaf(a.x, cc.x, sum);
      sum = fmaf(a.y, cc.y, sum);
      no = fmaf(a.x, a.x, fmaf(a.y, a.y, no));
      ng = fmaf(cc.x, cc.x, fmaf(cc.y, cc.y, ng));
    }
    sum = warp_sum(sum);
    if (lane == 0) delta[row] = sum;
    if (bound != nullptr) {
      mx[0] = fmaxf(mx[0], warp_sum(ng));
      mx[1] = fmaxf(mx[1], warp_sum(no));
    }
  }
  if (bound == nullptr) return;
  if (lane == 0)
    for (int i = 0; i < 3; ++i) red[i][warp] = mx[i];
  __syncthreads();
  if (threadIdx.x < 3) {
    float m = 0.f;
    for (int w = 0; w < DELTA_WARPS; ++w) m = fmaxf(m, red[threadIdx.x][w]);
    // squared norms are non-negative: their float order is their bits' integer order
    if (m > 0.f) atomicMax(reinterpret_cast<int*>(bound) + 3 * bh + threadIdx.x, __float_as_int(m));
  }
}

// (B*H, T, D) bf16 or fp16 read in boxes of (64, rows, 1)
int heads_map(CUtensorMap* map, const void* p, int bh, int T, int D, int rows, bool half) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode_tensor_map(map, p, 3, dims, strides, box, half);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int D, int B,
               int H, int Tq, int Tk, int n_virtual, float scale, cudaStream_t st) {
  constexpr bool half = is_half<T>;
  CUtensorMap q_map, k_map, v_map;
  int err = 0;
  if ((err = heads_map(&q_map, q, B * H, Tq, D, BQ, half)) || (err = heads_map(&k_map, k, B * H, Tk, D, BK, half)) ||
      (err = heads_map(&v_map, v, B * H, Tk, D, BK, half)))
    return err;
  static SmemLimit limit;
  if ((err = limit.ensure(wide_fwd_kernel<T>, F_SMEM))) return err;
  const long long blocks = static_cast<long long>(B) * H * ((Tq + BQ - 1) / BQ);  // head fastest
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wide_fwd_kernel<T><<<static_cast<unsigned>(blocks), THREADS, F_SMEM, st>>>(
      q_map, k_map, v_map, static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse), H, D, Tq,
      Tk, n_virtual, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask, const void* out, const void* lse,
               const void* dout, void* delta, void* dq_acc, void* bound, void* dq, void* dk, void* dv, int D, int B,
               int H, int Tq, int Tk, float scale, cudaStream_t st) {
  constexpr bool half = is_half<T>;
  if (Tk > BK && dq_acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, do_map, k_map, v_map;
  int err = 0;
  if ((err = heads_map(&q_map, q, B * H, Tq, D, BQ, half)) || (err = heads_map(&do_map, dout, B * H, Tq, D, BQ, half)) ||
      (err = heads_map(&k_map, k, B * H, Tk, D, BK, half)) || (err = heads_map(&v_map, v, B * H, Tk, D, BK, half)))
    return err;
  static SmemLimit limit;
  if ((err = limit.ensure(wide_bwd_kernel<T>, B_SMEM))) return err;
  const long long blocks = static_cast<long long>(B) * H * (D / 128);  // chunk fastest
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BLOCK_ROWS = DELTA_WARPS * DELTA_ROWS;
  float* bnd = static_cast<float*>(bound);
  const dim3 grid(B * H, ((Tq > Tk ? Tq : Tk) + BLOCK_ROWS - 1) / BLOCK_ROWS, bnd == nullptr ? 1 : 2);
  wide_delta_kernel<T><<<grid, DELTA_WARPS * 32, 0, st>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                                                          static_cast<const T*>(v), static_cast<float*>(delta), bnd,
                                                          Tq, Tk, D);
  wide_bwd_kernel<T><<<static_cast<unsigned>(blocks), THREADS, B_SMEM, st>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), bnd, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), H, D, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 1 bf16, 2 fp16. The (dtype, head dim) pairs these kernels take.
extern "C" int attention_wide_takes(int dtype, int D) { return (dtype == 1 || dtype == 2) && D >= 384 && D % 128 == 0; }
// Keys of the backward's key tile: past one tile dq is summed in the fp32 scratch.
extern "C" int attention_wide_key_tile() { return BK; }

// Launch the forward on `stream`; returns 0 or a cudaError_t. The caller
// checks: contiguous q (B, H, Tq, D), k and v (B, H, Tk, D) of `dtype` at a
// head dim `attention_wide_takes`, Tq, Tk >= 1, n_virtual >= 0, a contiguous
// fp32 (B, Tq, Tk) mask or null; out like q, lse fp32 (B, H, Tq).
extern "C" int launch_attention_wide_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                                         void* lse, int dtype, int D, int B, int H, int Tq, int Tk, int n_virtual,
                                         float scale, void* stream) {
  if (Tq < 1 || Tk < 1 || n_virtual < 0 || !attention_wide_takes(dtype, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(q, k, v, mask, out, lse, D, B, H, Tq, Tk, n_virtual, scale, st);
  return launch_fwd<__half>(q, k, v, mask, out, lse, D, B, H, Tq, Tk, n_virtual, scale, st);
}

// Launch the delta pass and the backward on `stream`; returns 0 or a
// cudaError_t. As the forward, plus: out and dout like q, lse fp32 (B, H, Tq)
// from the forward, `delta` an fp32 (B, H, Tq) scratch, `dq_acc` an fp32
// (B, H, Tq, D) scratch (null when Tk fits one key tile), `bound` a zeroed
// fp32 (B*H, 3) scratch for fp16 (null for bf16), dq like q, dk and dv like k.
extern "C" int launch_attention_wide_bwd(const void* q, const void* k, const void* v, const void* mask,
                                         const void* out, const void* lse, const void* dout, void* delta,
                                         void* dq_acc, void* bound, void* dq, void* dk, void* dv, int dtype, int D,
                                         int B, int H, int Tq, int Tk, float scale, void* stream) {
  if (Tq < 1 || Tk < 1 || !attention_wide_takes(dtype, D) || ((dtype == 2) != (bound != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WIDE_BWD_ARGS q, k, v, mask, out, lse, dout, delta, dq_acc, bound, dq, dk, dv, D, B, H, Tq, Tk, scale, st
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(WIDE_BWD_ARGS);
  return launch_bwd<__half>(WIDE_BWD_ARGS);
#undef WIDE_BWD_ARGS
}
