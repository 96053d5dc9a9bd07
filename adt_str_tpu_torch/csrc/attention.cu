// K5 forward: fused short-sequence attention for Hopper (sm_90a).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel). For each
// (batch b, head h) and query row i:
//     s_ij = (q_i . k_j) * scale + mask[b, i, j]       (fp32; mask optional, shared over heads)
//     m_i = max(max_j s_ij, -1e4 if n_virtual > 0)
//     l_i = sum_j exp(s_ij - m_i) + n_virtual * exp(-1e4 - m_i)
//     lse_i = m_i + log(l_i)
//     p_ij = T(exp(s_ij - m_i) / l_i)                    (T: q's type, bf16 or fp16)
//     out_i = T(sum_j p_ij v_j)                           (fp32 accumulation)
// q, k, v are bf16 or fp16 (B, H, T, D) at head dim D = 128 or 256, any
// Tq, Tk >= 1 (the keys stream through the ring a tile at a time); p and out
// are rounded to q's type. The n_virtual keys are
// those the JAX caller pads on (score exactly -1e4, v = 0): they are counted
// in l and lse without being stored.
//
// Bound on an H100: at the decoder's training shapes (Tq = Tk = 511, head
// dim 128, B = 64, 6 heads) the products are 4*Tq*Tk*128 flops per head,
// 51 GFLOP (52 us at 989 TFLOP/s), while q, k, v, out and the fp32 mask are
// about 270 MB (81 us at 3.35 TB/s): it is bound by memory, the mask (67 MB,
// shared by the heads) being its largest input. The design:
//   - the kernel is a template on the element type (bf16, fp16: the same
//     rounding points, wgmma's .bf16 or .f16 form) and on D. A tile of 64
//     head-dim columns (128-byte rows, the swizzle atom) is one TMA box, so
//     a D-wide tile is D / 64 of them. At D 256 the Q tile is 64 KB and the
//     4-slot K/V ring 4 x 32 KB (193 KB of shared memory in all), and a
//     consumer's O accumulator (64 x 256 fp32) is 128 registers a thread,
//     two m64n128 products a k-step: setmaxnreg gives the consumers 232
//     registers and the producer 40. At D 256, 3 heads (d 768), the same
//     shapes take the same flops and bytes as D 128 at 6 heads;
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

constexpr int BQ = 128;       // query rows per block (two warpgroups of 64)
constexpr int BKV = 64;       // keys per K or V tile
constexpr int SLOTS = 4;      // K/V ring
constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr float NEG_MASK = -1e4f;

constexpr int Q_ATOM = BQ * 64 * 2;    // 64 head-dim columns of the Q tile (16 KB)
constexpr int KV_ATOM = BKV * 64 * 2;  // 64 head-dim columns of a K or V tile (8 KB)

template <int D>
struct Shape {
  static constexpr int ATOMS = D / 64;
  static constexpr int SLOT_BYTES = ATOMS * KV_ATOM;
  static constexpr int SMEM = 1024 + ATOMS * Q_ATOM + SLOTS * SLOT_BYTES + (1 + 2 * SLOTS) * 8;
};
static_assert(Shape<128>::SMEM <= 232448 && Shape<256>::SMEM <= 232448, "shared memory of one block");

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) attention_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,   // (B*H, Tq, D)
    const __grid_constant__ CUtensorMap k_map,   // (B*H, Tk, D)
    const __grid_constant__ CUtensorMap v_map,   // (B*H, Tk, D)
    const __grid_constant__ CUtensorMap o_map,   // (B*H, Tq, D), stored
    const float* __restrict__ mask,              // (B, Tq, Tk) or null
    float* __restrict__ lse,                     // (B, H, Tq)
    int H, int Tq, int Tk, int n_virtual, float scale) {
  constexpr int ATOMS = Shape<D>::ATOMS, SLOT_BYTES = Shape<D>::SLOT_BYTES, NH = D / 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                        // [ATOMS][128 rows][64]
  uint8_t* ring = smem + ATOMS * Q_ATOM;     // [SLOTS][ATOMS][64 keys][64]
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
      mbar_arrive_expect_tx(q_full, ATOMS * Q_ATOM);
      for (int a = 0; a < ATOMS; ++a) tma_load_3d(qs + a * Q_ATOM, &q_map, q_full, 64 * a, q0, bh);
      for (int i = 0; i < 3 * nk; ++i) {
        const bool is_v = i >= nk && (i - nk) % 2 == 1;
        const int key0 = (i < nk ? i : (i - nk) / 2) * BKV;
        const CUtensorMap* map = is_v ? &v_map : &k_map;
        const int s = i % SLOTS;
        uint8_t* slot = ring + s * SLOT_BYTES;
        mbar_wait(&empty[s], ((i / SLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], SLOT_BYTES);
        for (int a = 0; a < ATOMS; ++a) tma_load_3d(slot + a * KV_ATOM, map, &full[s], 64 * a, key0, bh);
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
    // as the plain version rounds it; -inf past Tk. At D 128 the mask loads,
    // issued first, land while the products run; at D 256 they follow the
    // products (held across them, they made ptxas serialize the products
    // and spill).
    auto scores = [&](int pos, int key0) {
      if constexpr (D == 128) load_mask(key0);
      wait_full(pos);
      const uint8_t* kt = ring + (pos % SLOTS) * SLOT_BYTES;
      fence_regs(S);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_64x64_ss<T>(S, desc_sw128(qs + (kk / 4) * Q_ATOM + wg * (Q_ATOM / 2) + (kk % 4) * 32, 16, 1024),
                        desc_sw128(kt + (kk / 4) * KV_ATOM + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
      release(pos);
      if constexpr (D == 256) load_mask(key0);  // after the products: O's 128 registers leave no room for both
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

    // pass 2: p = T(exp(s - m) / l), out += p V (NH products of 128 columns a k-step)
    float O[NH][64];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) O[hh][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      scores(nk + 2 * kt, kt * BKV);
      uint32_t P[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = i & 1;  // P[i] packs S[2i], S[2i + 1]: row (i & 1)
        P[i] = pack2<T>(__fmul_rn(__expf(S[2 * i] - m[r]), inv_l[r]), __fmul_rn(__expf(S[2 * i + 1] - m[r]), inv_l[r]));
      }
      const int pos_v = nk + 2 * kt + 1;
      wait_full(pos_v);
      const uint8_t* vt = ring + (pos_v % SLOTS) * SLOT_BYTES;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) fence_regs(O[hh]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2], P[4 * kk + 3]};
        // V tile rows 16 kk.. of the 128 columns of half hh: MN blocks KV_ATOM apart, 8-key groups 1,024 B apart
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          mma_64x128_rs_tb<T>(O[hh], a, desc_sw128(vt + 2 * hh * KV_ATOM + kk * 16 * 128, KV_ATOM, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) fence_regs(O[hh]);
      release(pos_v);
    }

    // out through this warpgroup's own rows of the Q tile (their products are done)
    fence_proxy_async();
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (l % 4), hh = j / 16, jj = j % 16;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(qs + (c >> 6) * Q_ATOM + sw128_offset(rl + 8 * r, c & 63)) =
            pack2<T>(O[hh][4 * jj + 2 * r], O[hh][4 * jj + 2 * r + 1]);
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
      for (int a = 0; a < ATOMS; ++a) tma_store_3d(&o_map, qs + a * Q_ATOM + wg * (Q_ATOM / 2), 64 * a, q0 + 64 * wg, bh);
      store_commit();
      store_wait_read();
    }
  }
}

// (B*H, T, D) bf16 or fp16 read or written in boxes of (64, rows, 1)
int heads_map(CUtensorMap* map, const void* p, int bh, int T, int D, int rows, bool half) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode_tensor_map(map, p, 3, dims, strides, box, half);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B, int H, int Tq,
           int Tk, int n_virtual, float scale, cudaStream_t st) {
  constexpr bool half = is_half<T>;
  CUtensorMap q_map, k_map, v_map, o_map;
  int err = 0;
  if ((err = heads_map(&q_map, q, B * H, Tq, D, BQ, half)) || (err = heads_map(&k_map, k, B * H, Tk, D, BKV, half)) ||
      (err = heads_map(&v_map, v, B * H, Tk, D, BKV, half)) || (err = heads_map(&o_map, out, B * H, Tq, D, 64, half)))
    return err;
  static hopper::SmemLimit limit;
  if ((err = limit.ensure(attention_fwd_kernel<T, D>, Shape<D>::SMEM))) return err;
  const int blocks = B * H * ((Tq + BQ - 1) / BQ);  // head fastest
  attention_fwd_kernel<T, D><<<blocks, THREADS, Shape<D>::SMEM, st>>>(
      q_map, k_map, v_map, o_map, static_cast<const float*>(mask), static_cast<float*>(lse), H, Tq, Tk, n_virtual,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 1 bf16, 2 fp16. The (dtype, head dim) pairs this kernel takes.
extern "C" int attention_takes(int dtype, int D) { return (dtype == 1 || dtype == 2) && (D == 128 || D == 256); }

// Launch on `stream`; returns 0 or a cudaError_t. The caller checks:
// contiguous q, k, v of `dtype` at a head dim `attention_takes`, Tq, Tk >= 1,
// n_virtual >= 0, a contiguous fp32 (B, Tq, Tk) mask or null, outputs of the
// right shapes.
extern "C" int launch_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                    void* out, void* lse, int dtype, int D, int B, int H, int Tq, int Tk,
                                    int n_virtual, float scale, void* stream) {
  if (Tk < 1 || Tq < 1 || !attention_takes(dtype, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 128 ? launch<__nv_bfloat16, 128>(q, k, v, mask, out, lse, B, H, Tq, Tk, n_virtual, scale, st)
                    : launch<__nv_bfloat16, 256>(q, k, v, mask, out, lse, B, H, Tq, Tk, n_virtual, scale, st);
  return D == 128 ? launch<__half, 128>(q, k, v, mask, out, lse, B, H, Tq, Tk, n_virtual, scale, st)
                  : launch<__half, 256>(q, k, v, mask, out, lse, B, H, Tq, Tk, n_virtual, scale, st);
}
