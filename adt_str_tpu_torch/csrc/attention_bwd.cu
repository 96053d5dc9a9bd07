// K5 backward: fused short-sequence attention gradients for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_vjp_bwd (_bwd_kernel). For
// each (batch b, head h), with s = (q k^T) * scale + mask as in the forward
// and the forward's lse (which counts the caller's virtual keys):
//     p = exp(s - lse);  delta_i = sum_d do_id * out_id
//     dv = p^T do;  dp = do v^T;  ds = p * (dp - delta) * scale
//     dq = ds k;  dk = ds^T q
// q, k, v, out, do are bf16 (B, H, T, 128), 1 <= Tk <= 512, any Tq >= 1;
// the mask is fp32 (B, Tq, Tk), shared over heads; dq, dk, dv are bf16.
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
// Rounding: the products take bf16 operands with fp32 accumulation; p and
// ds are rounded to bf16 to enter the p^T do, ds^T q and ds k products (the
// TPU kernel keeps them in fp32): a relative error of at most 2^-9 per
// term, below the bf16 rounding of the outputs. exp is the hardware exp
// (__expf, a few fp32 ulps).

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 128;         // head dim
constexpr int BK = 128;        // keys per key tile (two warpgroups of 64)
constexpr int BQ = 64;         // query rows per ring slot
constexpr int SLOTS = 2;       // q / do / mask ring
constexpr int MAX_TK = 512;
constexpr int THREADS = 384;   // warpgroups 0, 1: consumers; warp 0 of 2: producer
constexpr int DELTA_WARPS = 8;

constexpr int KV_HALF = BK * 64 * 2;         // 64 head-dim columns of a K or V tile (16 KB)
constexpr int KV_BYTES = 2 * KV_HALF;
constexpr int Q_HALF = BQ * 64 * 2;          // 64 head-dim columns of a q or do tile (8 KB)
constexpr int QDO_BYTES = 4 * Q_HALF;        // q, then do (TMA)
constexpr int MASK_BYTES = BQ * BK * 4;      // the fp32 mask tile, 64 queries x 128 keys (cp.async)
constexpr int SLOT_BYTES = QDO_BYTES + MASK_BYTES;
constexpr int DS_BYTES = BK * BQ * 2;        // dS^T tile: 128 key rows of 64 queries (16 KB)
constexpr int STATS_BYTES = SLOTS * 2 * BQ * 4;
constexpr int SMEM_BYTES = 1024 + 2 * KV_BYTES + SLOTS * SLOT_BYTES + 2 * DS_BYTES + STATS_BYTES +
                           (2 + 2 * SLOTS) * 8;

__global__ void __launch_bounds__(THREADS, 1) attention_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map,   // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap do_map,  // (B*H, Tq, D), boxes of 64 rows
    const __grid_constant__ CUtensorMap k_map,   // (B*H, Tk, D), boxes of 128 rows
    const __grid_constant__ CUtensorMap v_map,   // (B*H, Tk, D), boxes of 128 rows
    const float* __restrict__ mask,              // (B, Tq, Tk) or null
    const float* __restrict__ lse,               // (B, H, Tq)
    const float* __restrict__ delta,             // (B, H, Tq)
    float* __restrict__ dq_acc,                  // (B, H, Tq, D) scratch (unused with one key tile)
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int Tq, int Tk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ks = smem;                              // [2 halves][128 keys][64]
  uint8_t* vs = ks + KV_BYTES;                     // [2 halves][128 keys][64]
  uint8_t* ring = vs + KV_BYTES;                   // [SLOTS][q: 2 halves, do: 2 halves][64 rows][64], mask
  uint8_t* dss = ring + SLOTS * SLOT_BYTES;        // [2][128 keys][64 queries]
  float* stats = reinterpret_cast<float*>(dss + 2 * DS_BYTES);  // [SLOTS][lse, delta][64]
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
          // rows of 128 keys, 16 rows a warp, a warp-wide 128 B a copy; a
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
          tma_load_3d(slot, &q_map, &full[s], 0, q0, bh);
          tma_load_3d(slot + Q_HALF, &q_map, &full[s], 64, q0, bh);
          tma_load_3d(slot + 2 * Q_HALF, &do_map, &full[s], 0, q0, bh);
          tma_load_3d(slot + 3 * Q_HALF, &do_map, &full[s], 64, q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
        if (qt == early - 1) {
          if (kt > 0) mbar_wait(kv_empty, (kt - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
            tma_load_3d(ks, &k_map, kv_full, 0, kt * BK, bh);
            tma_load_3d(ks + KV_HALF, &k_map, kv_full, 64, kt * BK, bh);
            tma_load_3d(vs, &v_map, kv_full, 0, kt * BK, bh);
            tma_load_3d(vs + KV_HALF, &v_map, kv_full, 64, kt * BK, bh);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys wg * 64 .. + 63 of each key tile.
  // Accumulator element i of thread (warp w, lane l) of a 64-row product:
  // row 16 w + l / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
  setmaxnreg_inc<232>();
  const int w = t / 32, l = t % 32;
  const int rk = wg * 64 + w * 16 + l / 4;  // key row within the key tile (and + 8)
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
      const uint8_t* dotile = qtile + 2 * Q_HALF;
      const float* st = stats + s * 2 * BQ;
      uint8_t* ds = dss + (it & 1) * DS_BYTES;

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
        mma_64x64_ss(S, desc_sw128(ks + (kk / 4) * KV_HALF + wg * (KV_HALF / 2) + (kk % 4) * 32, 16, 1024),
                     desc_sw128(qtile + (kk / 4) * Q_HALF + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_64x64_ss(dP, desc_sw128(vs + (kk / 4) * KV_HALF + wg * (KV_HALF / 2) + (kk % 4) * 32, 16, 1024),
                     desc_sw128(dotile + (kk / 4) * Q_HALF + (kk % 4) * 32, 16, 1024), kk > 0);
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
        __nv_bfloat162 pb = __floats2bfloat162_rn(S[2 * j], S[2 * j + 1]);
        __nv_bfloat162 db = __floats2bfloat162_rn(d0, d1);
        P[j] = *reinterpret_cast<uint32_t*>(&pb);
        DS[j] = *reinterpret_cast<uint32_t*>(&db);
      }
      // dV += P^T dO, dK += dS^T Q (dO, Q: 16 query rows a step, both 64-column halves)
      fence_regs(dV);
      fence_regs(dK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2], P[4 * kk + 3]};
        mma_64x128_rs_tb(dV, a, desc_sw128(dotile + kk * 16 * 128, Q_HALF, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {DS[4 * kk], DS[4 * kk + 1], DS[4 * kk + 2], DS[4 * kk + 3]};
        mma_64x128_rs_tb(dK, a, desc_sw128(qtile + kk * 16 * 128, Q_HALF, 1024), 1);
      }
      wgmma_commit();

      // dS^T rows of this warpgroup's keys -> shared memory (bf16); both
      // warpgroups then read all 128 key rows
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * (j / 2) + 2 * (l % 4);
        *reinterpret_cast<uint32_t*>(ds + sw128_offset(rk + 8 * (j & 1), c)) = DS[j];
      }
      fence_proxy_async();
      named_barrier(1, 256);

      // dQ_part (64 queries x this warpgroup's 64 columns) = dS K, once
      // dV and dK are done with P and dS (their registers then hold the
      // scratch's earlier sums, loaded while the product runs)
      wgmma_wait<0>();
      fence_regs(dK);
      fence_regs(dV);
      fence_regs(dQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_64x64_ss_tt(dQ, desc_sw128(ds + kk * 16 * 128, 0, 1024),
                        desc_sw128(ks + wg * KV_HALF + kk * 16 * 128, 0, 1024), kk > 0);
      wgmma_commit();
      // dq rows q0 + 16 w + l / 4 (+ 8), columns 64 wg + 8 j + 2 (l % 4), +1:
      // the last key tile loads the earlier tiles' sum while its product runs
      const bool last = kt == nkt - 1;
      float2 prev[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 16 * w + l / 4 + 8 * r;
        const size_t base = (row0 + q) * D + 64 * wg + 2 * (l % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          prev[r][j] = (kt > 0 && last && q < Tq) ? __ldcg(reinterpret_cast<const float2*>(dq_acc + base + 8 * j))
                                                  : make_float2(0.f, 0.f);
      }
      wgmma_wait<0>();
      fence_regs(dQ);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 16 * w + l / 4 + 8 * r;
        if (q >= Tq) continue;
        const size_t base = (row0 + q) * D + 64 * wg + 2 * (l % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 v = make_float2(prev[r][j].x + dQ[4 * j + 2 * r], prev[r][j].y + dQ[4 * j + 2 * r + 1]);
          float* acc = dq_acc + base + 8 * j;
          if (last) {
            *reinterpret_cast<__nv_bfloat162*>(dq + base + 8 * j) = __floats2bfloat162_rn(v.x, v.y);
          } else if (kt == 0) {
            __stcg(reinterpret_cast<float2*>(acc), v);
          } else {  // the middle key tiles add in place (in L2, no load); see the header on the order
            atomicAdd(acc, v.x);
            atomicAdd(acc + 1, v.y);
          }
        }
      }
    }
    mbar_arrive(kv_empty);  // this thread no longer reads K or V of this tile

    // dk, dv rows of this warpgroup's keys (bf16, rows past Tk not written)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + rk + 8 * r;
      if (key >= Tk) continue;
      const size_t base = (static_cast<size_t>(bh) * Tk + key) * D + 2 * (l % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
            __floats2bfloat162_rn(dK[4 * j + 2 * r], dK[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
            __floats2bfloat162_rn(dV[4 * j + 2 * r], dV[4 * j + 2 * r + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(DELTA_WARPS * 32) attention_delta_kernel(
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  // 4 consecutive bf16 a lane (8 bytes)
  const uint2 o = *reinterpret_cast<const uint2*>(out + static_cast<size_t>(row) * D + 4 * lane);
  const uint2 g = *reinterpret_cast<const uint2*>(dout + static_cast<size_t>(row) * D + 4 * lane);
  const float2 o0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o.x));
  const float2 o1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o.y));
  const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g.x));
  const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g.y));
  float sum = o0.x * g0.x + o0.y * g0.y + o1.x * g1.x + o1.y * g1.y;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

// (B*H, T, D) bf16 read in boxes of (64, rows, 1)
int heads_map(CUtensorMap* map, const void* p, int bh, int T, int rows) {
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode_tensor_map(map, p, 3, dims, strides, box);
}

// The kernel's shared-memory limit set on the current device, once.
int prepare_device() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(dev < 64 && done[dev]))
    e = cudaFuncSetAttribute(attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = true;
  return 0;
}

}  // namespace

extern "C" int attention_bwd_head_dim() { return D; }
extern "C" int attention_bwd_key_tile() { return BK; }

// Launch the delta pass and the main kernel on `stream`; returns 0 or a
// cudaError_t. The caller checks: bf16 contiguous q, k, v, out, do with head
// dim 128, 1 <= Tk <= 512, Tq >= 1, a contiguous fp32 (B, Tq, Tk) mask or
// null, fp32 (B, H, Tq) lse; `delta` is an fp32 (B, H, Tq) scratch and
// `dq_acc` an fp32 (B, H, Tq, 128) scratch (null when Tk <= 128), the
// outputs bf16 of q's and k's shapes.
extern "C" int launch_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                    const void* out, const void* lse, const void* dout, void* delta,
                                    void* dq_acc, void* dq, void* dk, void* dv, int B, int H, int Tq,
                                    int Tk, float scale, void* stream) {
  if (Tk < 1 || Tk > MAX_TK || Tq < 1 || (Tk > BK && dq_acc == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, do_map, k_map, v_map;
  int err = 0;
  if ((err = heads_map(&q_map, q, B * H, Tq, BQ)) || (err = heads_map(&do_map, dout, B * H, Tq, BQ)) ||
      (err = heads_map(&k_map, k, B * H, Tk, BK)) || (err = heads_map(&v_map, v, B * H, Tk, BK)))
    return err;
  if ((err = prepare_device())) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * H * Tq;
  attention_delta_kernel<<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta),
      rows);
  attention_bwd_kernel<<<B * H, THREADS, SMEM_BYTES, st>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}
