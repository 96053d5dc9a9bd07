// K5 backward: fused short-sequence attention gradients for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_vjp_bwd (_bwd_kernel). For
// each (batch b, head h), with s = (q k^T) * scale + mask as in the forward
// and the forward's lse (which counts the caller's virtual keys):
//     p = exp(s - lse);  delta_i = sum_d do_id * out_id
//     dv = p^T do;  dp = do v^T;  ds = p * (dp - delta) * scale
//     dq = ds k;  dk = ds^T q
// q, k, v, out, do are bf16 or fp16 (B, H, T, D) at head dim D = 128 or
// 256, any Tq, Tk >= 1; the mask is fp32 (B, Tq, Tk), shared over heads;
// dq, dk, dv are in q's type. The kernel is a template on both (wgmma's
// .bf16 or .f16 form; p and ds round to q's type where bf16 rounds them).
//
// Bound on an H100: at the decoder's training shapes (Tq = Tk = 511, B = 64,
// 6 heads) the five products are 10*Tq*Tk*128 flops per head, 128 GFLOP
// (130 us at 989 TFLOP/s); the bytes (q, k, v, out, do, dq, dk, dv in bf16,
// the fp32 mask and lse) are about 470 MB (140 us at 3.35 TB/s). The two are
// close, so the design keeps every (Tq, Tk) intermediate on the SM and feeds
// the tensor cores from a TMA ring:
//   - a small kernel takes delta = rowsum(do * out) in fp32;
//   - the main kernel runs one block per (batch, head), head fastest (the
//     TPU kernel's own grid; the six heads of a batch item read their mask
//     rows from L2), and walks the keys in tiles of 128. Per key tile the K
//     and V tiles are loaded once; 64-query tiles of q and do (with their
//     lse and delta rows and the mask tile) stream through a 2-slot ring
//     fed by the producer warpgroup; two consumer warpgroups own 64 keys
//     each;
//   - per (key tile, query tile) a consumer forms S^T = K Q^T and
//     dP^T = V dO^T (wgmma m64n64k16, both operands K-major in shared
//     memory), P^T = exp(S^T * scale + mask^T - lse) and
//     dS^T = P^T (dP^T - delta) * scale in registers, and accumulates
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T as wgmma's register A
//     operand (do and q read MN-major): dK and dV stay in registers for the
//     whole query loop, five products where the first version did seven;
//   - dS^T goes to shared memory as bf16; then each warpgroup takes 64 of
//     dq's 128 columns, dQ_part = dS K with both operands read MN-major, and
//     sums it into an fp32 scratch (B, H, Tq, 128): key tile 0 stores its
//     part, the middle tiles add theirs in L2 (a reduction with no load:
//     half the traffic of a read-modify-write), the last loads the sum,
//     adds its part and stores dq in bf16 (a single key tile never touches
//     the scratch). One block owns the whole (batch, head) and each scratch
//     element belongs to one thread, whose accesses to it take effect in
//     program order: the partial sums reach each dq row in a fixed order
//     (key tile 0, 1, ...), so the result is deterministic; no two blocks
//     or threads touch one element;
//   - the mask's row stride (Tk * 4 B) is not 16-byte aligned, which TMA
//     refuses: the producer's four warps copy each (64 query x 128 key)
//     mask tile into the ring slot with 4-byte cp.async (a warp-wide 128 B
//     row piece a copy) that arrive on the slot's barrier, so the consumers
//     read it from shared memory (their own scattered 4-byte global loads,
//     32 a thread a tile, took a fifth of the kernel's time at 511 x 511);
//   - rows past Tq come from TMA as zeros with lse = +inf (p = 0); keys past
//     Tk are masked to p = 0.
// Head dim 256 (3 heads at d 768). dK and dV of 64 keys over 256 columns
// would be 256 registers a thread in one warpgroup. So at D 256 the key
// tile is 64 keys and the two consumer warpgroups split the head dim: each
// forms S^T and dP^T for all 64 keys (64 x 64 over the full depth, formed
// twice, which costs less than trading them through shared memory and a
// barrier) and keeps dK and dV of its 128 columns (128 registers, as at D
// 128); each takes 128 of dq's 256 columns, 64 at a time. The slot's mask
// tile is then 64 x 64 and the ring 2 x 80 KB: with K and V (64 KB) that
// leaves no room for a dS^T buffer, so dS^T (8 KB) is written into the
// slot's mask tile once both warpgroups have read it (one more barrier a
// step). A second design (a dk/dv kernel of one block a (batch, head, key
// tile), 1,536 blocks at 3 heads, B 64, and a dq kernel of one block a
// 64-row query tile recomputing S and dP, no atomics) took 1.92 ms against
// this one's 1.70 at 511 x 511 (H100 80GB HBM3, 700 W): a step cost about
// 13 us either way, so the atomics and the 1.45 waves of 192 blocks are not
// what holds it.
// Rounding: the products take bf16 (fp16) operands with fp32 accumulation; p and
// ds are rounded to bf16 (fp16) to enter the p^T do, ds^T q and ds k products (the
// TPU kernel keeps them in fp32): a relative error of at most 2^-9 per
// term (2^-12 in fp16), below the rounding of the outputs. fp16's range:
// p is at most 1, but a training step's ds is far below fp16's smallest
// normal (about 2e-9 at the TMIDT configs: do ~ 1e-6 after the loss's mean
// over 32k tokens), so rounded as it is it would flush to 0 and with it
// every dq and dk. In fp16 the delta pass therefore also takes, per
// (batch, head), the largest |do|, |out| and |v| row norms (an atomic max
// of non-negative floats: order-free, so deterministic), which bound
// |ds| <= scale |do| (|v| + |out|); ds is multiplied by the power of two
// that takes that bound to 2^14 before it is rounded, and dk and dq are
// multiplied back by its inverse in fp32 (both exact: no extra rounding). exp is the hardware exp
// (__expf, a few fp32 ulps).

#include <algorithm>
#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;         // query rows per ring slot
constexpr int SLOTS = 2;       // q / do / mask ring
constexpr int THREADS = 384;   // warpgroups 0, 1: consumers; warp 0 of 2: producer
constexpr int DELTA_WARPS = 8;
constexpr int Q_ATOM = BQ * 64 * 2;  // 64 head-dim columns of a q or do tile (8 KB)

// The power of two that ds is multiplied by before it is rounded (fp16; see
// the header): it takes the bound scale |do|max (|v|max + |out|max) of
// (batch, head) bh to [2^13, 2^14); 1 without a bound or where it is 0.
__device__ __forceinline__ float ds_scale(const float* bound, int bh, float scale) {
  if (bound == nullptr) return 1.f;
  const float m = scale * sqrtf(bound[3 * bh]) * (sqrtf(bound[3 * bh + 2]) + sqrtf(bound[3 * bh + 1]));
  if (!(m > 0.f) || !isfinite(m)) return 1.f;
  int e = 0;
  frexpf(16384.f / m, &e);  // 2^(e - 1) <= 16384 / m < 2^e
  return ldexpf(1.f, max(-60, min(60, e - 1)));
}

template <int D>
struct Shape {
  static constexpr bool SPLIT = D == 256;        // the warpgroups split the head dim, not the keys
  static constexpr int BK = SPLIT ? 64 : 128;    // keys per key tile
  static constexpr int ATOMS = D / 64;
  static constexpr int KV_ATOM = BK * 64 * 2;    // 64 head-dim columns of a K or V tile
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int QDO_BYTES = 2 * ATOMS * Q_ATOM;  // q, then do (TMA)
  static constexpr int MASK_BYTES = BQ * BK * 4;        // the fp32 mask tile (cp.async); at D 256 also dS^T
  static constexpr int SLOT_BYTES = QDO_BYTES + MASK_BYTES;
  static constexpr int DS_BYTES = BK * BQ * 2;          // dS^T tile: BK key rows of 64 queries
  static constexpr int DS_BUFS = SPLIT ? 0 : 2;         // own buffers (D 128) or the slot's mask tile (D 256)
  static constexpr int STATS_BYTES = SLOTS * 2 * BQ * 4;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + SLOTS * SLOT_BYTES + DS_BUFS * DS_BYTES + STATS_BYTES +
                              (2 + 2 * SLOTS) * 8;
  static constexpr int DQ_PARTS = D / 128;              // dq products of 64 columns a warpgroup
};
static_assert(Shape<128>::SMEM <= 232448 && Shape<256>::SMEM <= 232448, "shared memory of one block");

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) attention_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map,   // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap do_map,  // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap k_map,   // (B*H, Tk, D), boxes of BK rows
    const __grid_constant__ CUtensorMap v_map,   // (B*H, Tk, D), boxes of BK rows
    const float* __restrict__ mask,              // (B, Tq, Tk) or null
    const float* __restrict__ lse,               // (B, H, Tq)
    const float* __restrict__ delta,             // (B, H, Tq)
    float* __restrict__ dq_acc,                  // (B, H, Tq, D) scratch (unused with one key tile)
    const float* __restrict__ bound,             // (B*H, 3) fp16's ds bound (see the header) or null
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, float scale) {
  using S_ = Shape<D>;
  constexpr bool SPLIT = S_::SPLIT;
  constexpr int BK = S_::BK, ATOMS = S_::ATOMS, KV_ATOM = S_::KV_ATOM, KV_BYTES = S_::KV_BYTES;
  constexpr int QDO_BYTES = S_::QDO_BYTES, SLOT_BYTES = S_::SLOT_BYTES, DS_BYTES = S_::DS_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ks = smem;                              // [ATOMS][BK keys][64]
  uint8_t* vs = ks + KV_BYTES;                     // [ATOMS][BK keys][64]
  uint8_t* ring = vs + KV_BYTES;                   // [SLOTS][q: ATOMS, do: ATOMS][64 rows][64], mask
  uint8_t* dss = ring + SLOTS * SLOT_BYTES;        // [DS_BUFS][BK keys][64 queries]
  float* stats = reinterpret_cast<float*>(dss + S_::DS_BUFS * DS_BYTES);  // [SLOTS][lse, delta][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + SLOTS * 2 * BQ);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + SLOTS;

  const int bh = blockIdx.x, b = bh / H;
  const int nkt = (Tk + BK - 1) / BK, nqt = (Tq + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 256);
    for (int s = 0; s < SLOTS; ++s) {
      // warp 0's lanes of the producer (lane 0 with the bytes), and the mask
      // copies of the producer's 128 threads
      mbar_init(&full[s], mask == nullptr ? 32 : 32 + 128);
      mbar_init(&empty[s], 256);  // every consumer thread releases the slot
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: per key tile, its first query tiles, then K and V, then the rest
    setmaxnreg_dec<40>();
    // warp 0 loads lse, delta, q, do, K and V; all four warps copy the mask
    if (t >= 32 && mask == nullptr) return;
    const int lane = t % 32, pw = t / 32;
    const float* lse_bh = lse + static_cast<size_t>(bh) * Tq;
    const float* delta_bh = delta + static_cast<size_t>(bh) * Tq;
    const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;
    const int early = nqt < SLOTS ? nqt : SLOTS;
    for (int kt = 0; kt < nkt; ++kt) {
      for (int qt = 0; qt < nqt; ++qt) {
        const int it = kt * nqt + qt, s = it % SLOTS, q0 = qt * BQ;
        mbar_wait(&empty[s], ((it / SLOTS) & 1) ^ 1);
        uint8_t* slot = ring + s * SLOT_BYTES;
        if (mask_b != nullptr) {
          // rows of BK keys, 16 rows a warp, a warp-wide 128 B a copy; a
          // tile row's 8-key groups are permuted by the query (see `mask_at`)
          float* mt = reinterpret_cast<float*>(slot + QDO_BYTES);
          for (int r = 16 * pw; r < 16 * pw + 16 && q0 + r < Tq; ++r) {
            const float* src = mask_b + static_cast<size_t>(q0 + r) * Tk + kt * BK;
#pragma unroll
            for (int c = 0; c < BK / 32; ++c) {
              const int key = lane + 32 * c;
              if (kt * BK + key < Tk) cp_async_4(mt + r * BK + (key ^ (8 * ((r >> 1) & 3))), src + key);
            }
          }
          cp_async_arrive(&full[s]);
        }
        if (pw > 0) continue;
        float* st = stats + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < Tq;
          st[r] = ok ? lse_bh[q0 + r] : INFINITY;  // p = 0 on rows past Tq
          st[BQ + r] = ok ? delta_bh[q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], QDO_BYTES);
          for (int a = 0; a < ATOMS; ++a) {
            tma_load_3d(slot + a * Q_ATOM, &q_map, &full[s], 64 * a, q0, bh);
            tma_load_3d(slot + (ATOMS + a) * Q_ATOM, &do_map, &full[s], 64 * a, q0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        if (qt == early - 1) {
          if (kt > 0) mbar_wait(kv_empty, (kt - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
            for (int a = 0; a < ATOMS; ++a) {
              tma_load_3d(ks + a * KV_ATOM, &k_map, kv_full, 64 * a, kt * BK, bh);
              tma_load_3d(vs + a * KV_ATOM, &v_map, kv_full, 64 * a, kt * BK, bh);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: at D 128 warpgroup wg owns keys wg * 64 .. + 63 of each key
  // tile and every column; at D 256 both own the tile's 64 keys and wg
  // columns 128 wg .. + 127 of dk and dv.
  // Accumulator element i of thread (warp w, lane l) of a 64-row product:
  // row 16 w + l / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
  setmaxnreg_inc<232>();
  const int w = t / 32, l = t % 32;
  const float ds_mult = ds_scale(bound, bh, scale), inv_mult = 1.f / ds_mult;
  const int krow = SPLIT ? 0 : 64 * wg;   // the warpgroup's first key row of the tile
  const int ccol = SPLIT ? 128 * wg : 0;  // its first dk / dv column
  const int rk = krow + w * 16 + l / 4;   // key row within the key tile (and + 8)
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;
  const size_t row0 = static_cast<size_t>(bh) * Tq;
  float S[32] = {}, dP[32] = {}, dQ[32] = {};  // each product's first step overwrites them (scale_d = 0)

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    float dK[64], dV[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dK[i] = dV[i] = 0.f;
    mbar_wait(kv_full, kt & 1);

    for (int qt = 0; qt < nqt; ++qt) {
      const int it = kt * nqt + qt, s = it % SLOTS, q0 = qt * BQ;
      const uint8_t* qtile = ring + s * SLOT_BYTES;
      const uint8_t* dotile = qtile + ATOMS * Q_ATOM;
      const float* st = stats + s * 2 * BQ;
      uint8_t* ds = SPLIT ? const_cast<uint8_t*>(qtile) + QDO_BYTES : dss + (it & 1) * DS_BYTES;

      // mask (query c, key row kr) of this slot's tile: conflict-free for the
      // S^T fragment, whose lanes read 8 keys of 4 queries two apart
      const float* mt = reinterpret_cast<const float*>(qtile + QDO_BYTES);
      auto mask_at = [&](int c, int kr) {
        return (mask_b != nullptr && q0 + c < Tq) ? mt[c * BK + (kr ^ (8 * ((c >> 1) & 3)))] : 0.f;
      };
      mbar_wait(&full[s], (it / SLOTS) & 1);

      fence_regs(S);
      fence_regs(dP);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_64x64_ss<T>(S, desc_sw128(ks + (kk / 4) * KV_ATOM + krow * 128 + (kk % 4) * 32, 16, 1024),
                        desc_sw128(qtile + (kk / 4) * Q_ATOM + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_64x64_ss<T>(dP, desc_sw128(vs + (kk / 4) * KV_ATOM + krow * 128 + (kk % 4) * 32, 16, 1024),
                        desc_sw128(dotile + (kk / 4) * Q_ATOM + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(S);
      // p, while dP^T is in flight; keys past Tk give 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + rk + 8 * ((i / 2) & 1), c = 8 * (i / 4) + 2 * (l % 4) + (i & 1);
        S[i] = key < Tk ? __expf(__fmaf_rn(S[i], scale, mask_at(c, key - k0)) - st[c]) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dP);
      uint32_t P[16], DS[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * (j / 2) + 2 * (l % 4);  // P[j] packs elements 2j, 2j + 1: row (j & 1)
        const float d0 = S[2 * j] * (dP[2 * j] - st[BQ + c]) * scale;
        const float d1 = S[2 * j + 1] * (dP[2 * j + 1] - st[BQ + c + 1]) * scale;
        P[j] = pack2<T>(S[2 * j], S[2 * j + 1]);
        DS[j] = pack2<T>(d0 * ds_mult, d1 * ds_mult);
      }
      // dV += P^T dO, dK += dS^T Q over this warpgroup's 128 columns (dO, Q:
      // 16 query rows a step, two 64-column blocks)
      fence_regs(dV);
      fence_regs(dK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2], P[4 * kk + 3]};
        mma_64x128_rs_tb<T>(dV, a, desc_sw128(dotile + (ccol / 64) * Q_ATOM + kk * 16 * 128, Q_ATOM, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {DS[4 * kk], DS[4 * kk + 1], DS[4 * kk + 2], DS[4 * kk + 3]};
        mma_64x128_rs_tb<T>(dK, a, desc_sw128(qtile + (ccol / 64) * Q_ATOM + kk * 16 * 128, Q_ATOM, 1024), 1);
      }
      wgmma_commit();

      // dS^T -> shared memory (T). D 128: each warpgroup its own 64 key
      // rows into a buffer of its own. D 256: both hold all 64 rows, and
      // each writes half of the query columns into the slot's mask tile
      // once both are done reading the mask.
      if constexpr (SPLIT) named_barrier(1, 256);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * (j / 2) + 2 * (l % 4);
        if (!SPLIT || ((j / 2) & 1) == wg) *reinterpret_cast<uint32_t*>(ds + sw128_offset(rk + 8 * (j & 1), c)) = DS[j];
      }
      fence_proxy_async();
      named_barrier(1, 256);

      // dQ_part (64 queries x 64 columns, D / 128 of them a warpgroup) = dS K,
      // once dV and dK are done with P and dS (their registers then hold
      // the scratch's earlier sums, loaded while the product runs)
      const bool last = kt == nkt - 1;
      wgmma_wait<0>();
      fence_regs(dK);
      fence_regs(dV);
#pragma unroll
      for (int part = 0; part < S_::DQ_PARTS; ++part) {
        const int cblk = (D / 128) * wg + part;  // the 64-column block of dq
        fence_regs(dQ);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_64x64_ss_tt<T>(dQ, desc_sw128(ds + kk * 16 * 128, 0, 1024),
                             desc_sw128(ks + cblk * KV_ATOM + kk * 16 * 128, 0, 1024), kk > 0);
        wgmma_commit();
        // dq rows q0 + 16 w + l / 4 (+ 8), columns 64 cblk + 8 j + 2 (l % 4), +1:
        // the last key tile loads the earlier tiles' sum while its product runs
        float2 prev[2][8];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + 16 * w + l / 4 + 8 * r;
          const size_t base = (row0 + q) * D + 64 * cblk + 2 * (l % 4);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            prev[r][j] = (kt > 0 && last && q < Tq) ? __ldcg(reinterpret_cast<const float2*>(dq_acc + base + 8 * j))
                                                    : make_float2(0.f, 0.f);
        }
        wgmma_wait<0>();
        fence_regs(dQ);
        if (part == S_::DQ_PARTS - 1) mbar_arrive(&empty[s]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + 16 * w + l / 4 + 8 * r;
          if (q >= Tq) continue;
          const size_t base = (row0 + q) * D + 64 * cblk + 2 * (l % 4);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 v = make_float2(prev[r][j].x + dQ[4 * j + 2 * r] * inv_mult,
                                         prev[r][j].y + dQ[4 * j + 2 * r + 1] * inv_mult);
            float* acc = dq_acc + base + 8 * j;
            if (last) {
              *reinterpret_cast<uint32_t*>(dq + base + 8 * j) = pack2<T>(v.x, v.y);
            } else if (kt == 0) {
              __stcg(reinterpret_cast<float2*>(acc), v);
            } else {  // the middle key tiles add in place (in L2, no load); see the header on the order
              atomicAdd(acc, v.x);
              atomicAdd(acc + 1, v.y);
            }
          }
        }
      }
    }
    mbar_arrive(kv_empty);  // this thread no longer reads K or V of this tile

    // dk, dv rows of this warpgroup's keys and columns (rows past Tk not written)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + rk + 8 * r;
      if (key >= Tk) continue;
      const size_t base = (static_cast<size_t>(bh) * Tk + key) * D + ccol + 2 * (l % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(dk + base + 8 * j) =
            pack2<T>(dK[4 * j + 2 * r] * inv_mult, dK[4 * j + 2 * r + 1] * inv_mult);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * j) = pack2<T>(dV[4 * j + 2 * r], dV[4 * j + 2 * r + 1]);
      }
    }
  }
}

// delta = rowsum(do * out) in fp32, a warp a row (D / 32 consecutive
// elements a lane), DELTA_ROWS rows a warp, the rows of one (batch, head)
// (blockIdx.x) a block. With `bound` (fp16; blockIdx.z 1: the rows of v),
// also the largest squared row norms of do, out and v of the (batch, head):
// bound[3 bh + 0, 1, 2], one atomic max a block each.
constexpr int DELTA_ROWS = 8;

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_WARPS * 32) attention_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, const T* __restrict__ v, float* __restrict__ delta,
    float* __restrict__ bound, int Tq, int Tk) {
  __shared__ float red[3][DELTA_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, bh = blockIdx.x;
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
      const uint32_t* w = reinterpret_cast<const uint32_t*>(v + row * D) + lane * (D / 64);
      float n = 0.f;
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {
        const float2 a = unpack2<T>(w[j]);
        n = fmaf(a.x, a.x, fmaf(a.y, a.y, n));
      }
      mx[2] = fmaxf(mx[2], warp_sum(n));
      continue;
    }
    const uint32_t* o = reinterpret_cast<const uint32_t*>(out + row * D) + lane * (D / 64);
    const uint32_t* g = reinterpret_cast<const uint32_t*>(dout + row * D) + lane * (D / 64);
    float sum = 0.f, no = 0.f, ng = 0.f;
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const float2 a = unpack2<T>(o[j]), c = unpack2<T>(g[j]);
      sum = fmaf(a.x, c.x, sum);
      sum = fmaf(a.y, c.y, sum);
      no = fmaf(a.x, a.x, fmaf(a.y, a.y, no));
      ng = fmaf(c.x, c.x, fmaf(c.y, c.y, ng));
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* out, const void* lse,
           const void* dout, void* delta, void* dq_acc, void* bound, void* dq, void* dk, void* dv, int B, int H,
           int Tq, int Tk, float scale, cudaStream_t st) {
  constexpr int BK = Shape<D>::BK;
  constexpr bool half = is_half<T>;
  if (Tk > BK && dq_acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, do_map, k_map, v_map;
  int err = 0;
  if ((err = heads_map(&q_map, q, B * H, Tq, D, BQ, half)) || (err = heads_map(&do_map, dout, B * H, Tq, D, BQ, half)) ||
      (err = heads_map(&k_map, k, B * H, Tk, D, BK, half)) || (err = heads_map(&v_map, v, B * H, Tk, D, BK, half)))
    return err;
  static hopper::SmemLimit limit;
  if ((err = limit.ensure(attention_bwd_kernel<T, D>, Shape<D>::SMEM))) return err;
  constexpr int BLOCK_ROWS = DELTA_WARPS * DELTA_ROWS;
  float* bnd = static_cast<float*>(bound);
  const dim3 grid(B * H, (std::max(Tq, Tk) + BLOCK_ROWS - 1) / BLOCK_ROWS, bnd == nullptr ? 1 : 2);
  attention_delta_kernel<T, D><<<grid, DELTA_WARPS * 32, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const T*>(v), static_cast<float*>(delta),
      bnd, Tq, Tk);
  attention_bwd_kernel<T, D><<<B * H, THREADS, Shape<D>::SMEM, st>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), bnd, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 1 bf16, 2 fp16. The (dtype, head dim) pairs this kernel takes,
// and the keys of a key tile at a head dim (past one tile dq is summed in the
// fp32 scratch).
extern "C" int attention_bwd_takes(int dtype, int D) { return (dtype == 1 || dtype == 2) && (D == 128 || D == 256); }
extern "C" int attention_bwd_key_tile(int D) { return D == 256 ? Shape<256>::BK : Shape<128>::BK; }

// Launch the delta pass and the main kernel on `stream`; returns 0 or a
// cudaError_t. The caller checks: contiguous q, k, v, out, do of `dtype` at
// a head dim `attention_bwd_takes`, Tq, Tk >= 1, a contiguous fp32
// (B, Tq, Tk) mask or null, fp32 (B, H, Tq) lse; `delta` is an fp32
// (B, H, Tq) scratch and `dq_acc` an fp32 (B, H, Tq, D) scratch (null when
// Tk fits one key tile), `bound` a zeroed fp32 (B*H, 3) scratch
// for fp16 (null for bf16), the outputs of q's and k's shapes in q's type.
extern "C" int launch_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                    const void* out, const void* lse, const void* dout, void* delta,
                                    void* dq_acc, void* bound, void* dq, void* dk, void* dv, int dtype, int D, int B,
                                    int H, int Tq, int Tk, float scale, void* stream) {
  if (Tk < 1 || Tq < 1 || !attention_bwd_takes(dtype, D) || ((dtype == 2) != (bound != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_BWD_ARGS q, k, v, mask, out, lse, dout, delta, dq_acc, bound, dq, dk, dv, B, H, Tq, Tk, scale, st
  if (dtype == 1)
    return D == 128 ? launch<__nv_bfloat16, 128>(ATTN_BWD_ARGS) : launch<__nv_bfloat16, 256>(ATTN_BWD_ARGS);
  return D == 128 ? launch<__half, 128>(ATTN_BWD_ARGS) : launch<__half, 256>(ATTN_BWD_ARGS);
#undef ATTN_BWD_ARGS
}
