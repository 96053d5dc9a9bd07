// K5 forward: fused short-sequence attention for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel). For each
// (batch b, head h) and query row i:
//     s_ij = (q_i . k_j) * scale + mask[b, i, j]       (fp32; mask optional, shared over heads)
//     m_i = max(max_j s_ij, -1e4 if n_virtual > 0)
//     l_i = sum_j exp(s_ij - m_i) + n_virtual * exp(-1e4 - m_i)
//     lse_i = m_i + log(l_i)
//     p_ij = bf16(exp(s_ij - m_i) / l_i)
//     out_i = bf16(sum_j p_ij v_j)                        (fp32 accumulation)
// q, k, v are bf16 (B, H, T, 128); 1 <= Tk <= 512. The n_virtual keys are
// those the JAX caller pads on (score exactly -1e4, v = 0): they are counted
// in l and lse without being stored.
//
// Bound on an H100: at the decoder's training shapes (Tq = Tk = 511, head
// dim 128, B = 64, 6 heads) the products are 4*Tq*Tk*128 flops per head,
// 51 GFLOP (52 us at 989 TFLOP/s), while q, k, v, out and the fp32 mask are
// about 270 MB (81 us at 3.35 TB/s): it is bound by memory, the mask (67 MB,
// shared by the heads) being its largest input. The design:
//   - one block per 128 query rows of one (batch, head); blocks are ordered
//     head fastest, so the six blocks of one (batch, query tile) run
//     together and read their mask tile from HBM once;
//   - two consumer warpgroups of 64 rows each and one producer thread: Q is
//     loaded once, then 64-key K and V tiles stream through a 4-slot
//     shared-memory ring, all by TMA with 3-D tensor maps (128, T, B*H) so
//     a tile past Tq or Tk lands as zeros instead of the next head's rows;
//   - exact two-pass softmax, keeping the TPU kernel's (and the plain
//     version's) rounding points: pass 1 walks the K tiles for the row max
//     and sum (online, fp32); pass 2 recomputes S = Q K^T for each tile, forms
//     p = bf16(exp(s - m) / l) in registers and feeds it to P.V as wgmma's
//     register A operand. An online one-pass form would round
//     exp(s - m_running) before dividing by l; the second Q K^T costs half
//     again the tensor work of a kernel bound by bytes. exp is the fast
//     hardware exp2 (__expf, a few fp32 ulps) and 1/l a multiply: with the
//     IEEE exp and division the softmax's instructions, not the products,
//     set the time (2.1x at 511 x 511 on an H100);
//   - a warpgroup waits for its own Q K^T before its softmax; the two
//     warpgroups of a block fill each other's gaps. Overlapping the next
//     tile's Q K^T inside one warpgroup made ptxas serialize the products
//     (and spill), and was slower;
//   - S = Q K^T is wgmma m64n64k16 (both K-major in shared memory); P.V is
//     m64n128k16 with V's (keys, 128) tile read MN-major (transpose-B);
//   - the mask's row stride (Tk * 4 B) is not a multiple of 16 B, which
//     TMA refuses: each thread loads its accumulator fragment's mask values
//     with ordinary loads, issued before it waits for the K tile;
//   - out leaves through shared memory (the block's own Q rows) by TMA
//     store, which clips rows past Tq; lse is stored by one thread a row.

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 128;        // head dim
constexpr int BQ = 128;       // query rows per block (two warpgroups of 64)
constexpr int BKV = 64;       // keys per K or V tile
constexpr int SLOTS = 4;      // K/V ring
constexpr int MAX_TK = 512;   // the shared limit of the forward and backward kernels
constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr float NEG_MASK = -1e4f;

constexpr int Q_HALF = BQ * 64 * 2;        // 64 head-dim columns of the Q tile (16 KB)
constexpr int KV_HALF = BKV * 64 * 2;      // 64 head-dim columns of a K or V tile (8 KB)
constexpr int SLOT_BYTES = 2 * KV_HALF;
constexpr int SMEM_BYTES = 1024 + 2 * Q_HALF + SLOTS * SLOT_BYTES + (1 + 2 * SLOTS) * 8;

__global__ void __launch_bounds__(THREADS, 1) attention_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,   // (B*H, Tq, D)
    const __grid_constant__ CUtensorMap k_map,   // (B*H, Tk, D)
    const __grid_constant__ CUtensorMap v_map,   // (B*H, Tk, D)
    const __grid_constant__ CUtensorMap o_map,   // (B*H, Tq, D), stored
    const float* __restrict__ mask,              // (B, Tq, Tk) or null
    float* __restrict__ lse,                     // (B, H, Tq)
    int H, int Tq, int Tk, int n_virtual, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                    // [2 halves][128 rows][64]
  uint8_t* ring = smem + 2 * Q_HALF;     // [SLOTS][2 halves][64 keys][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + SLOTS * SLOT_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + SLOTS;

  const int nq = (Tq + BQ - 1) / BQ;
  const int h = blockIdx.x % H, qt = (blockIdx.x / H) % nq, b = blockIdx.x / (H * nq);
  const int bh = b * H + h, q0 = qt * BQ;
  const int nk = (Tk + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the slot
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: Q, then K_0..K_{nk-1} (pass 1), then K_0, V_0, K_1, V_1, ... (pass 2)
    setmaxnreg_dec<40>();
    if (t == 0) {
      mbar_arrive_expect_tx(q_full, 2 * Q_HALF);
      tma_load_3d(qs, &q_map, q_full, 0, q0, bh);
      tma_load_3d(qs + Q_HALF, &q_map, q_full, 64, q0, bh);
      for (int i = 0; i < 3 * nk; ++i) {
        const bool is_v = i >= nk && (i - nk) % 2 == 1;
        const int key0 = (i < nk ? i : (i - nk) / 2) * BKV;
        const CUtensorMap* map = is_v ? &v_map : &k_map;
        const int s = i % SLOTS;
        uint8_t* slot = ring + s * SLOT_BYTES;
        mbar_wait(&empty[s], ((i / SLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], SLOT_BYTES);
        tma_load_3d(slot, map, &full[s], 0, key0, bh);
        tma_load_3d(slot + KV_HALF, map, &full[s], 64, key0, bh);
      }
    }
  } else {  // consumers: query rows wg * 64 .. + 63 of the tile
    setmaxnreg_inc<232>();
    // accumulator element i of thread (warp w, lane l): row 16 w + l / 4
    // (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2
    const int w = t / 32, l = t % 32;
    const int rl = wg * 64 + w * 16 + l / 4;  // row within the tile (and + 8)
    const float* mrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + rl + 8 * r;
      mrow[r] = (mask != nullptr && qi < Tq) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
    }
    float m[2], lsum[2] = {0.f, 0.f};
    m[0] = m[1] = n_virtual > 0 ? NEG_MASK : -INFINITY;

    // Ring positions: pass 1 reads K_t at t; pass 2 reads K_t at nk + 2t and
    // V_t at nk + 2t + 1 (the producer's order).
    auto wait_full = [&](int pos) { mbar_wait(&full[pos % SLOTS], (pos / SLOTS) & 1); };
    auto release = [&](int pos) { mbar_arrive(&empty[pos % SLOTS]); };

    float S[32] = {};  // each tile's first product overwrites it (scale_d = 0)
    float mv[32];  // the mask at this thread's score elements of a tile
    auto load_mask = [&](int key0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + 8 * (i / 4) + 2 * (l % 4) + (i & 1);
        const float* mr = mrow[(i / 2) & 1];
        mv[i] = (mr != nullptr && key < Tk) ? __ldg(mr + key) : 0.f;
      }
    };
    // S = (q . k) * scale + mask for the K tile at ring position pos, rounded
    // as the plain version rounds it; -inf past Tk. The mask loads, issued
    // first, land while the products run.
    auto scores = [&](int pos, int key0) {
      load_mask(key0);
      wait_full(pos);
      const uint8_t* kt = ring + (pos % SLOTS) * SLOT_BYTES;
      fence_regs(S);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_64x64_ss(S, desc_sw128(qs + (kk / 4) * Q_HALF + wg * (Q_HALF / 2) + (kk % 4) * 32, 16, 1024),
                     desc_sw128(kt + (kk / 4) * KV_HALF + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
      release(pos);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + 8 * (i / 4) + 2 * (l % 4) + (i & 1);
        S[i] = key < Tk ? __fadd_rn(__fmul_rn(S[i], scale), mv[i]) : -INFINITY;
      }
    };

    mbar_wait(q_full, 0);

    // pass 1: row max and sum, online over the K tiles
    for (int kt = 0; kt < nk; ++kt) {
      scores(kt, kt * BKV);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i / 2) & 1) == r) mx = fmaxf(mx, S[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // mx is finite: key 0 < Tk scores a finite value in tile 0
        float sum = m[r] == -INFINITY ? 0.f : lsum[r] * __expf(m[r] - mx);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i / 2) & 1) == r) sum += __expf(S[i] - mx);
        lsum[r] = sum;
        m[r] = mx;
      }
    }
    float inv_l[2], row_lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = lsum[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (n_virtual > 0) sum += static_cast<float>(n_virtual) * expf(NEG_MASK - m[r]);
      inv_l[r] = 1.f / sum;
      row_lse[r] = m[r] + logf(sum);
    }

    // pass 2: p = bf16(exp(s - m) / l), out += p V
    float O[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) O[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      scores(nk + 2 * kt, kt * BKV);
      uint32_t P[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = i & 1;  // P[i] packs S[2i], S[2i + 1]: row (i & 1)
        __nv_bfloat162 pb = __floats2bfloat162_rn(__fmul_rn(__expf(S[2 * i] - m[r]), inv_l[r]),
                                                  __fmul_rn(__expf(S[2 * i + 1] - m[r]), inv_l[r]));
        P[i] = *reinterpret_cast<uint32_t*>(&pb);
      }
      const int pos_v = nk + 2 * kt + 1;
      wait_full(pos_v);
      const uint8_t* vt = ring + (pos_v % SLOTS) * SLOT_BYTES;
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2], P[4 * kk + 3]};
        // V tile rows 16 kk.. of both 64-column halves: MN blocks KV_HALF apart, 8-key groups 1,024 B apart
        mma_64x128_rs_tb(O, a, desc_sw128(vt + kk * 16 * 128, KV_HALF, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      release(pos_v);
    }

    // out through this warpgroup's own rows of the Q tile (their products are done)
    fence_proxy_async();
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (l % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(qs + (c >> 6) * Q_HALF + sw128_offset(rl + 8 * r, c & 63)) =
            __floats2bfloat162_rn(O[4 * j + 2 * r], O[4 * j + 2 * r + 1]);
    }
    if (l % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + rl + 8 * r;
        if (qi < Tq) lse[static_cast<size_t>(bh) * Tq + qi] = row_lse[r];
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (t == 0 && q0 + 64 * wg < Tq) {
      tma_store_3d(&o_map, qs + wg * (Q_HALF / 2), 0, q0 + 64 * wg, bh);
      tma_store_3d(&o_map, qs + Q_HALF + wg * (Q_HALF / 2), 64, q0 + 64 * wg, bh);
      store_commit();
      store_wait_read();
    }
  }
}

// (B*H, T, D) bf16 read or written in boxes of (64, rows, 1)
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
    e = cudaFuncSetAttribute(attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = true;
  return 0;
}

}  // namespace

extern "C" int attention_max_keys() { return MAX_TK; }
extern "C" int attention_head_dim() { return D; }

// Launch on `stream`; returns 0 or a cudaError_t. The caller checks: bf16
// contiguous q, k, v with head dim 128, 1 <= Tk <= 512, n_virtual >= 0, a
// contiguous fp32 (B, Tq, Tk) mask or null, outputs of the right shapes.
extern "C" int launch_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                    void* out, void* lse, int B, int H, int Tq, int Tk,
                                    int n_virtual, float scale, void* stream) {
  if (Tk < 1 || Tk > MAX_TK || Tq < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map, o_map;
  int err = 0;
  if ((err = heads_map(&q_map, q, B * H, Tq, BQ)) || (err = heads_map(&k_map, k, B * H, Tk, BKV)) ||
      (err = heads_map(&v_map, v, B * H, Tk, BKV)) || (err = heads_map(&o_map, out, B * H, Tq, 64)))
    return err;
  if ((err = prepare_device())) return err;
  const int blocks = B * H * ((Tq + BQ - 1) / BQ);  // head fastest
  attention_fwd_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, o_map, static_cast<const float*>(mask), static_cast<float*>(lse), H, Tq, Tk,
      n_virtual, scale);
  return static_cast<int>(cudaGetLastError());
}
