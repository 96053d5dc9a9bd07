// K5 in fp32 on the tensor cores: fused attention, forward and backward, for
// fp32 q, k, v at every head dim that is a multiple of 128 (the 16-bit
// inputs take attention.cu, attention_bwd.cu and attention_wide.cu).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel) and
// :_vjp_bwd (_bwd_kernel) for fp32 inputs. JAX's kernel runs in any dtype
// and at any head dim that is a multiple of 128 (transformer.py's gate);
// fp32 comes from `model.compute_dtype: float32`. The arithmetic is that of
// ops/cuda_attention.py's plain versions:
//     s = (q . k) * scale + mask;  m = max(max_j s, -1e4 if n_virtual > 0)
//     l = sum_j exp(s - m) + n_virtual * exp(-1e4 - m);  lse = m + log(l)
//     out = (sum_j exp(s - m) v_j) / l      (the max and sum online, flash style)
//     p = exp(s - lse);  dv = p^T do;  dp = do v^T;  delta = rowsum(do * out)
//     ds = p (dp - delta) * scale;  dq = ds k;  dk = ds^T q
// Every product runs on the tensor cores in 3xTF32 (hopper.cuh's
// tf32_split and mma_1688_3xtf32: each fp32 operand split into a TF32 big
// part and a TF32 small part, a . b formed from three TF32 products into
// fp32 accumulators), which keeps fp32's accuracy to about 2^-21 a product:
// q k^T and p v in the forward; the recomputed scores, do v^T, p^T do,
// ds^T q and ds k in the backward, p and ds split like any operand. The
// scale, mask, max, exp (expf), sums and division (IEEE) stay on the CUDA
// cores in fp32, so the fp32 path is held to the plain path's fp32 results
// (1e-5), not to a bf16 tolerance.
//
// Bound on an H100: at the decoder's training shapes (B 64, 6 heads,
// 511 x 511, head dim 128) the forward's products are 4 Tq Tk D flops a
// head, 51 GFLOP, or 154 GFLOP of TF32 products: 0.31 ms at the 495 TFLOP/s
// of dense TF32; the backward's five products 128 GFLOP, 0.78 ms. fp32 FMA
// on the CUDA cores (67 TFLOP/s) cannot go below 0.77 and 1.9 ms. The
// operands (q, k, v, out, the mask) are 0.27 GB, 0.08 ms at 3.35 TB/s: the
// kernels are bound by the products. The design is mma.sync m16n8k8 (wgmma
// takes TF32 operands K-major only, and p v, p^T do, ds^T q and ds k would
// need transposed copies) fed from shared memory by a cp.async ring, and
// each warp splits the fragments it loads (tf32_split, on the integer
// pipes):
//   - scores accumulate over the head dim in 32-column stages (rows 36
//     words apart, so a warp's fragment loads fall in 32 distinct banks);
//     the outputs are formed a column chunk at a time (a block a chunk, the
//     scores recomputed for each: no head dim sizes a block);
//   - the forward: a block 64 query rows (4 warps of 16), out formed 256
//     columns at a time where the head dim is a multiple of 256 (key tiles
//     of 32), else 128 (key tiles of 64); the online max and sum (flash
//     style), out divided by l at the end;
//   - p and ds go from the score accumulators straight into the A operand
//     of the next product: the accumulator's columns 2t, 2t + 1 are taken as
//     that product's k indices t, t + 4 (the chunk tile's rows read in the
//     same order), so no shuffle and no shared memory is needed;
//   - the backward runs three kernels and no atomics (deterministic): the
//     delta pass; a block a (64-key tile, 128-column chunk) that walks
//     64-query tiles (warps 0-3 form s^T, p^T and dv, warps 4-7 dp^T, ds^T
//     and dk, p^T handed over in shared memory); a block a (64-query tile,
//     128-column chunk) that walks 32-key tiles (warps 0-3 form s and p,
//     warps 4-7 dp and ds, and each half adds 64 of the chunk's dq columns);
//   - a tile's output-product operand chunk, its mask tile (and, in dk/dv,
//     its lse and delta) ride with its second stage into shared memory: the
//     mask's rows (Tk words apart) are not 16-byte aligned, so 4 bytes a
//     copy; the softmax then reads no device memory;
//   - a block's tiling and summation order depend on (Tq, Tk, D) only, never
//     on B or H, so a row's results do not depend on the rows beside it.
// `attention_tf32_takes` names the (dtype, head dim) pairs; the wrapper
// raises on any other.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4z;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::mma_1688_3xtf32;
using hopper::tf32_split;
using hopper::tf32_split2;

constexpr float NEG_MASK = -1e4f;
constexpr int DS = 32;           // head-dim columns of a stage
constexpr int LDS = DS + 4;      // padded raw stage row (words)
constexpr int KSTEPS = DS / 8;   // mma k-steps of a stage
constexpr int DC = 128;          // columns of the backward's output chunk
constexpr int LDC = DC + 4;      // padded raw chunk row (words)
constexpr int CT = DC / 8;       // n-tiles of a chunk
constexpr int DELTA_WARPS = 8;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the blocks of a (batch x head, tile of `tile` rows, `oc`-column chunk) grid, or -1 past a grid's x limit
long long grid_blocks(int B, int H, int rows, int tile, int D, int oc) {
  const long long blocks = static_cast<long long>(B) * H * cdiv(rows, tile) * (D / oc);
  return blocks > INT_MAX ? -1 : blocks;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Copies (cp.async, 16 bytes a thread a step) rows r0.. of a row-major fp32
// matrix with `ld` words a row, columns col0.. of `W` words, into a tile of
// ROWS rows `LD` words apart; rows past `rows` are zeros.
template <int W, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void cp_tile(float* dst, const float* __restrict__ src, int r0, int rows, int col0,
                                        int ld) {
  constexpr int PER_ROW = W / 4, STEP = NTHREADS / PER_ROW;
  static_assert(NTHREADS % PER_ROW == 0 && ROWS % STEP == 0, "whole rows a pass");
  const int c = (threadIdx.x % PER_ROW) * 4, r1 = threadIdx.x / PER_ROW;
#pragma unroll 1  // few registers held across the main loop
  for (int k = 0; k < ROWS / STEP; ++k) {
    const int r = r1 + k * STEP;
    const bool ok = r0 + r < rows;
    cp_async_16(dst + r * LD + c, src + (ok ? static_cast<size_t>(r0 + r) * ld + col0 + c : 0), ok);
  }
}

// ROWS x COLS words from (r0, c0) of a matrix `ld` words a row whose rows
// are not 16-byte aligned (the mask's, Tk words apart): 4 bytes a copy;
// zeros past (rows, cols).
template <int ROWS, int COLS, int LD, int NTHREADS>
__device__ __forceinline__ void cp_words(float* dst, const float* __restrict__ src, int r0, int rows, int c0,
                                         int cols, size_t ld) {
  static_assert(ROWS * COLS % NTHREADS == 0, "whole passes");
#pragma unroll 1
  for (int k = 0; k < ROWS * COLS / NTHREADS; ++k) {
    const int e = threadIdx.x + k * NTHREADS, r = e / COLS, cc = e % COLS;
    const bool ok = r0 + r < rows && c0 + cc < cols;
    cp_async_4z(dst + r * LD + cc, src + (ok ? (r0 + r) * ld + c0 + cc : 0), ok);
  }
}

// The tensor cores add a product into its accumulator with truncation, so a
// long chain of mma.sync on one accumulator drifts toward zero (at head dim
// 768, 288 chained products moved out by 1.6e-5 on an H100). Each chain below starts
// from zero and runs over one stage (12 products) or one 8-column tile's
// keys or queries (24 or 12), and the partial sum joins the running sum in
// an fp32 add (round to nearest).

// acc (16 x 8 N) += a b^T over one stage, both raw (a the warp's 16 rows,
// LDA words apart; b N * 8 rows, LDS apart), split here: ascending k-steps,
// each k-step's three passes over the N n-tiles in turn.
template <int LDA, int N>
__device__ __forceinline__ void stage_scores(float (&acc)[N][4], const float* a, const float* b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[N][4];
  zero(part);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t ab[4], as[4];
    float4 bf[N];
    tf32_split(a[g * LDA + ks * 8 + t], ab[0], as[0]);
    tf32_split(a[(g + 8) * LDA + ks * 8 + t], ab[1], as[1]);
    tf32_split(a[g * LDA + ks * 8 + t + 4], ab[2], as[2]);
    tf32_split(a[(g + 8) * LDA + ks * 8 + t + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float* r = b + (n * 8 + g) * LDS + ks * 8 + t;
      bf[n] = tf32_split2(r[0], r[4]);
    }
    mma_1688_3xtf32(part, ab, as, bf);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// acc (16 x 8 N) += x (16 x 8 J, a score accumulator's layout) y (a raw
// tile of J * 8 rows, LD words apart, N * 8 columns), G n-tiles at a time.
// The accumulator's columns 8 j + 2 t and 8 j + 2 t + 1 (lane t % 4) are
// k-step j's k indices t and t + 4, and rows 8 j + 2 t, 8 j + 2 t + 1 of y
// its B operand's: p and ds go from the score accumulator to the A operand
// with no shuffle.
template <int G, int LD, int J, int N>
__device__ __forceinline__ void tile_product(float (&acc)[N][4], const float (&x)[J][4], const float* y, int lane) {
  static_assert(N % G == 0, "G n-tiles at a time");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < N; h += G) {
    float part[G][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t ab[4], as[4];
      float4 bf[G];
      tf32_split(x[j][0], ab[0], as[0]);
      tf32_split(x[j][2], ab[1], as[1]);
      tf32_split(x[j][1], ab[2], as[2]);
      tf32_split(x[j][3], ab[3], as[3]);
      const float* row = y + (j * 8 + 2 * t) * LD + h * 8 + g;
#pragma unroll
      for (int c = 0; c < G; ++c) bf[c] = tf32_split2(row[c * 8], row[LD + c * 8]);
      mma_1688_3xtf32(part, ab, as, bf);
    }
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h + c][e] += part[c][e];
  }
}

// the (scaled, masked) score as the plain version rounds it: (q . k) * scale, then + mask
__device__ __forceinline__ float score(float dot, float scale, float mask) { return __fadd_rn(__fmul_rn(dot, scale), mask); }

// rows `r` (0: the lane's row g, 1: g + 8) of a 16-row accumulator, as a float2 at columns 8 c + 2 t
template <int N>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[N][4], int r, float div) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    *reinterpret_cast<float2*>(dst + c * 8) = make_float2(__fdiv_rn(acc[c][2 * r], div), __fdiv_rn(acc[c][2 * r + 1], div));
}

// The forward's shapes: out formed OC columns at a time (256 where the head
// dim is a multiple of 256, else 128) over key tiles of KEYS (64, or 32 at
// 256 columns, so that out's 128 accumulators a thread leave room); at head
// dim 128 (QRES) the block's q rows stay in shared memory and the ring
// carries k alone.
template <int OC, bool QRES>
struct Fwd {
  static constexpr int ROWS = 64, NTHREADS = 128, STAGES = 2;
  static constexpr int KEYS = OC == 128 ? 64 : 32, NT = KEYS / 8, OT = OC / 8;
  static constexpr int LDV = OC + 4, LDM = KEYS + 8;
  static constexpr int QWORDS = QRES ? ROWS * LDC : 0;          // the resident q tile (head dim 128)
  static constexpr int RAW = ((QRES ? 0 : ROWS) + KEYS) * LDS;  // words of a raw slot: [q stage | k stage]
  static constexpr int SMEM = (QWORDS + STAGES * RAW + KEYS * LDV + ROWS * LDM) * 4;
};

// One block a (batch x head, 64-query tile, OC-column chunk of out), the
// chunk fastest. Walks the key tiles once: the scores over the whole head
// dim (the ring of q and k stages), the online max and sum, then out's chunk
// += p v. A key tile's v chunk and mask tile ride with its stage STAGES - 1,
// issued once the previous tile's p v has read them.
template <int OC, bool QRES>
__global__ void __launch_bounds__(Fwd<OC, QRES>::NTHREADS, 2) attention_tf32_fwd(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int H, int D, int Tq, int Tk,
    int n_virtual, float scale) {
  using F = Fwd<OC, QRES>;
  constexpr int ROWS = F::ROWS, KEYS = F::KEYS, NT = F::NT, STAGES = F::STAGES, NTH = F::NTHREADS;
  constexpr int QOFF = QRES ? 0 : ROWS * LDS;      // the k stage's offset in a slot
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);    // the resident q tile (QRES: ROWS x LDC)
  float* ring = qs + F::QWORDS;                   // STAGES raw slots
  float* vs = ring + STAGES * F::RAW;             // the key tile's v chunk (KEYS x LDV)
  float* ms = vs + KEYS * F::LDV;                 // and its mask tile (ROWS x LDM)
  const int nch = D / OC, nq = cdiv(Tq, ROWS), nk = cdiv(Tk, KEYS), nst = D / DS;
  const int c = blockIdx.x % nch, qt = (blockIdx.x / nch) % nq;
  const size_t bh = blockIdx.x / (nch * nq);
  const int b = static_cast<int>(bh / H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int q0 = qt * ROWS, total = nk * nst;
  const float* qb = q + bh * Tq * D;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  auto slot = [&](int i) { return ring + (i % STAGES) * F::RAW; };
  auto issue = [&](int i) {
    if (i < total) {
      const int kt = i / nst, st = i % nst;
      if (!QRES)
        cp_tile<DS, LDS, ROWS, NTH>(slot(i), qb, q0, Tq, st * DS, D);
      else if (i == 0)
        cp_tile<DC, LDC, ROWS, NTH>(qs, qb, q0, Tq, 0, D);
      cp_tile<DS, LDS, KEYS, NTH>(slot(i) + QOFF, kb, kt * KEYS, Tk, st * DS, D);
      if (st == STAGES - 1) {
        cp_tile<OC, F::LDV, KEYS, NTH>(vs, vb, kt * KEYS, Tk, c * OC, D);
        if (mask_b != nullptr) cp_words<ROWS, KEYS, F::LDM, NTH>(ms, mask_b, q0, Tq, kt * KEYS, Tk, Tk);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  int rows[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    m[r] = n_virtual > 0 ? NEG_MASK : -INFINITY;
    l[r] = 0.f;
  }
  const float* mw = ms + (warp * 16 + (lane >> 2)) * F::LDM + 2 * t;  // the lane's mask row g, columns 2 t..
  float o[F::OT][4], s[NT][4];
  zero(o);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i has landed; every warp is done with the slot issue() refills
    issue(i + STAGES - 1);
    const int kt = i / nst, st = i % nst;
    if (st == 0) zero(s);
    if (QRES)
      stage_scores<LDC>(s, qs + warp * 16 * LDC + st * DS, slot(i), lane);
    else
      stage_scores<LDS>(s, slot(i) + warp * 16 * LDS, slot(i) + QOFF, lane);
    if (st != nst - 1) continue;

    const int k0 = kt * KEYS;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 mk = mask_b != nullptr ? *reinterpret_cast<const float2*>(mw + r * 8 * F::LDM + n * 8)
                                            : make_float2(0.f, 0.f);
        const int key = k0 + n * 8 + 2 * t;
        s[n][2 * r] = key < Tk ? score(s[n][2 * r], scale, mk.x) : -INFINITY;
        s[n][2 * r + 1] = key + 1 < Tk ? score(s[n][2 * r + 1], scale, mk.y) : -INFINITY;
      }
    // the online max and sum; a row's 4 lanes are lanes 4 g.. (xor 1, 2)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // mx is finite: key 0 < Tk scores a finite value in tile 0
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = expf(s[n][e] - mx);
          sum += s[n][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
#pragma unroll
      for (int ct = 0; ct < F::OT; ++ct) {
        o[ct][2 * r] *= alpha;
        o[ct][2 * r + 1] *= alpha;
      }
    }
    tile_product<8, F::LDV>(o, s, vs, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (n_virtual > 0) l[r] += static_cast<float>(n_virtual) * expf(NEG_MASK - m[r]);
    if (rows[r] >= Tq) continue;
    store_rows(out + (bh * Tq + rows[r]) * D + c * OC + 2 * t, o, r, l[r]);
    if (c == 0 && t == 0) lse[bh * Tq + rows[r]] = m[r] + logf(l[r]);
  }
}

template <int OC, bool QRES>
int launch_fwd(const float* q, const float* k, const float* v, const float* mask, float* out, float* lse, int B,
               int H, int D, int Tq, int Tk, int n_virtual, float scale, cudaStream_t st) {
  using F = Fwd<OC, QRES>;
  const long long blocks = grid_blocks(B, H, Tq, F::ROWS, D, OC);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  static hopper::SmemLimit limit;
  if (const int err = limit.ensure(attention_tf32_fwd<OC, QRES>, F::SMEM)) return err;
  attention_tf32_fwd<OC, QRES><<<static_cast<unsigned>(blocks), F::NTHREADS, F::SMEM, st>>>(
      q, k, v, mask, out, lse, H, D, Tq, Tk, n_virtual, scale);
  return static_cast<int>(cudaGetLastError());
}

// delta = rowsum(do * out) in fp32, a warp a row
__global__ void __launch_bounds__(DELTA_WARPS * 32) attention_tf32_delta(const float* __restrict__ out,
                                                                           const float* __restrict__ dout,
                                                                           float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + static_cast<size_t>(row) * D;
  const float* gr = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(o[d], gr[d], sum);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

// ---- the backward: the delta pass, then the dk/dv and dq kernels. Each
// has 8 warps in two roles of 4 (16 rows a warp: 64 keys, or 64 queries)
// and walks tiles of 32 queries (or keys): a stage holds the roles' A
// operands' rows (k and v, or q and do) and the tile's B operands' rows (q
// and do, or k and v); the tile's chunk of the output products' B operands
// (q and do, or k), its mask and (dk/dv) lse and delta ride with its stage
// STAGES - 1.
template <int TILE_>
struct BwdT {
  static constexpr int ROWS = 64, TILE = TILE_, NT = TILE / 8, NTHREADS = 256, STAGES = 2;
  static constexpr int RAW = (2 * ROWS + 2 * TILE) * LDS;  // words of a raw slot: [a0 | a1 | b0 | b1]
  static constexpr int XCHG = 4 * NT * 4 * 32;             // words: p (or ds) of 4 warps, [warp][register][lane]
  static constexpr int LDM_KV = ROWS + 4;                  // dk/dv's mask tile: TILE queries x ROWS keys
  static constexpr int LDM_Q = TILE + 8;                   // dq's: ROWS queries x TILE keys
  static constexpr int DKDV_SMEM = (STAGES * RAW + 2 * TILE * LDC + TILE * LDM_KV + 2 * TILE + XCHG) * 4;
  static constexpr int DQ_SMEM = (STAGES * RAW + TILE * LDC + ROWS * LDM_Q + 2 * XCHG) * 4;
};
using BwdKV = BwdT<64>;  // dk/dv: 64 queries a tile (one block an SM: 255 registers a thread)
using BwdQ = BwdT<32>;   // dq: 32 keys a tile (two blocks an SM: 125 registers)

// dk, dv: one block a (batch x head, 64-key tile, 128-column chunk), the
// chunk fastest, walking the query tiles. Warp w of role 0 holds keys 16 w..
// and forms s^T = k q^T over the head dim, then p^T (handed to role 1) and
// dv's chunk += p^T do; role 1 forms dp^T = v do^T, then ds^T and dk's chunk
// += ds^T q.
__global__ void __launch_bounds__(BwdKV::NTHREADS, 1) attention_tf32_dkdv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H, int D, int Tq, int Tk,
    float scale) {
  constexpr int ROWS = BwdKV::ROWS, TILE = BwdKV::TILE, NT = BwdKV::NT, STAGES = BwdKV::STAGES, NTH = BwdKV::NTHREADS;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES raw slots: [k | v | q | do stages]
  float* qc = ring + STAGES * BwdKV::RAW;           // the query tile's q chunk (TILE x LDC)
  float* dc = qc + TILE * LDC;                    // and its do chunk
  float* ms = dc + TILE * LDC;                    // its mask (TILE queries x LDM_KV keys)
  float* ls = ms + TILE * BwdKV::LDM_KV;            // its lse
  float* dl = ls + TILE;                          // its delta
  float* xchg = dl + TILE;                        // p^T of role 0
  const int nch = D / DC, nk = cdiv(Tk, ROWS), nq = cdiv(Tq, TILE), nst = D / DS;
  const int c = blockIdx.x % nch, kt = (blockIdx.x / nch) % nk;
  const size_t bh = blockIdx.x / (nch * nk);
  const int b = static_cast<int>(bh / H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int role = warp >> 2, wr = warp & 3;
  const int k0 = kt * ROWS, total = nq * nst;
  const float *qb = q + bh * Tq * D, *kb = k + bh * Tk * D, *vb = v + bh * Tk * D, *db = dout + bh * Tq * D;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  auto slot = [&](int i) { return ring + (i % STAGES) * BwdKV::RAW; };
  auto issue = [&](int i) {
    if (i < total) {
      const int q0 = (i / nst) * TILE, st = i % nst;
      float* s = slot(i);
      cp_tile<DS, LDS, ROWS, NTH>(s, kb, k0, Tk, st * DS, D);
      cp_tile<DS, LDS, ROWS, NTH>(s + ROWS * LDS, vb, k0, Tk, st * DS, D);
      cp_tile<DS, LDS, TILE, NTH>(s + 2 * ROWS * LDS, qb, q0, Tq, st * DS, D);
      cp_tile<DS, LDS, TILE, NTH>(s + (2 * ROWS + TILE) * LDS, db, q0, Tq, st * DS, D);
      if (st == STAGES - 1) {
        cp_tile<DC, LDC, TILE, NTH>(qc, qb, q0, Tq, c * DC, D);
        cp_tile<DC, LDC, TILE, NTH>(dc, db, q0, Tq, c * DC, D);
        if (mask_b != nullptr) cp_words<TILE, ROWS, BwdKV::LDM_KV, NTH>(ms, mask_b, q0, Tq, k0, Tk, Tk);
        if (threadIdx.x < 2 * TILE) {
          const int j = threadIdx.x % TILE;
          cp_async_4z(threadIdx.x < TILE ? ls + j : dl + j, (threadIdx.x < TILE ? lse : delta) + bh * Tq + min(q0 + j, Tq - 1),
                      q0 + j < Tq);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  const int keys[2] = {k0 + wr * 16 + (lane >> 2), k0 + wr * 16 + (lane >> 2) + 8};
  const float* mw = ms + wr * 16 + (lane >> 2);  // the lane's key g of the mask tile's rows (queries)
  float* xw = xchg + wr * (NT * 4 * 32);
  float acc[NT][4], grad[CT][4];  // s^T or dp^T; dv or dk
  zero(grad);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i has landed; every warp is done with the slot, chunks and exchange issue() refills
    issue(i + STAGES - 1);
    const int qt = i / nst, st = i % nst;
    if (st == 0) zero(acc);
    // role 0: k rows against q; role 1: v rows against do
    stage_scores<LDS>(acc, slot(i) + (role * ROWS + wr * 16) * LDS, slot(i) + (2 * ROWS + role * TILE) * LDS, lane);
    if (st != nst - 1) continue;

    const int q0 = qt * TILE;
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qj = n * 8 + 2 * t + (e & 1);
          const float mk = mask_b != nullptr ? mw[qj * BwdKV::LDM_KV + (e >> 1) * 8] : 0.f;
          const bool ok = keys[e >> 1] < Tk && q0 + qj < Tq;
          acc[n][e] = ok ? expf(score(acc[n][e], scale, mk) - ls[qj]) : 0.f;
          xw[(n * 4 + e) * 32 + lane] = acc[n][e];
        }
    }
    __syncthreads();  // p^T is in shared memory
    if (role == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = xw[(n * 4 + e) * 32 + lane];
          acc[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(acc[n][e], dl[n * 8 + 2 * t + (e & 1)])), scale);
        }
    }
    // role 0: dv += p^T do; role 1: dk += ds^T q
    tile_product<4, LDC>(grad, acc, role == 0 ? dc : qc, lane);
  }
  cp_async_wait<0>();

  float* dst = role == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (keys[r] < Tk) store_rows(dst + (bh * Tk + keys[r]) * D + c * DC + 2 * t, grad, r, 1.f);
}

// dq: one block a (batch x head, 64-query tile, 128-column chunk), the chunk
// fastest, walking the key tiles. Warp w of role 0 holds queries 16 w.. and
// forms s = q k^T over the head dim and p (handed to role 1); role 1 forms
// dp = do v^T and ds (handed back); then role 0 adds dq's chunk columns 0-63
// (ds k) and role 1 columns 64-127.
__global__ void __launch_bounds__(BwdQ::NTHREADS, 2) attention_tf32_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int D, int Tq, int Tk, float scale) {
  constexpr int ROWS = BwdQ::ROWS, TILE = BwdQ::TILE, NT = BwdQ::NT, STAGES = BwdQ::STAGES, NTH = BwdQ::NTHREADS;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES raw slots: [q | do | k | v stages]
  float* kc = ring + STAGES * BwdQ::RAW;           // the key tile's k chunk (TILE x LDC)
  float* ms = kc + TILE * LDC;                    // its mask (ROWS queries x LDM_Q keys)
  float* xp = ms + ROWS * BwdQ::LDM_Q;             // p of role 0
  float* xs = xp + BwdQ::XCHG;                     // ds of role 1
  const int nch = D / DC, nq = cdiv(Tq, ROWS), nk = cdiv(Tk, TILE), nst = D / DS;
  const int c = blockIdx.x % nch, qt = (blockIdx.x / nch) % nq;
  const size_t bh = blockIdx.x / (nch * nq);
  const int b = static_cast<int>(bh / H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int role = warp >> 2, wr = warp & 3;
  const int q0 = qt * ROWS, total = nk * nst;
  const float *qb = q + bh * Tq * D, *kb = k + bh * Tk * D, *vb = v + bh * Tk * D, *db = dout + bh * Tq * D;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  auto slot = [&](int i) { return ring + (i % STAGES) * BwdQ::RAW; };
  auto issue = [&](int i) {
    if (i < total) {
      const int k0 = (i / nst) * TILE, st = i % nst;
      float* s = slot(i);
      cp_tile<DS, LDS, ROWS, NTH>(s, qb, q0, Tq, st * DS, D);
      cp_tile<DS, LDS, ROWS, NTH>(s + ROWS * LDS, db, q0, Tq, st * DS, D);
      cp_tile<DS, LDS, TILE, NTH>(s + 2 * ROWS * LDS, kb, k0, Tk, st * DS, D);
      cp_tile<DS, LDS, TILE, NTH>(s + (2 * ROWS + TILE) * LDS, vb, k0, Tk, st * DS, D);
      if (st == STAGES - 1) {
        cp_tile<DC, LDC, TILE, NTH>(kc, kb, k0, Tk, c * DC, D);
        if (mask_b != nullptr) cp_words<ROWS, TILE, BwdQ::LDM_Q, NTH>(ms, mask_b, q0, Tq, k0, Tk, Tk);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  int rows[2];
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + wr * 16 + (lane >> 2) + 8 * r;
    const int row = min(rows[r], Tq - 1);
    ls[r] = lse[bh * Tq + row];
    dl[r] = delta[bh * Tq + row];
  }
  const float* mw = ms + (wr * 16 + (lane >> 2)) * BwdQ::LDM_Q + 2 * t;  // the lane's query row g, keys 2 t..
  float* xpw = xp + wr * (NT * 4 * 32);
  float* xsw = xs + wr * (NT * 4 * 32);
  float acc[NT][4], grad[CT / 2][4];  // s or dp; dq's 64 columns of this role
  zero(grad);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    const int kt = i / nst, st = i % nst;
    if (st == 0) zero(acc);
    // role 0: q rows against k; role 1: do rows against v
    stage_scores<LDS>(acc, slot(i) + (role * ROWS + wr * 16) * LDS, slot(i) + (2 * ROWS + role * TILE) * LDS, lane);
    if (st != nst - 1) continue;

    const int k0 = kt * TILE;
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 mk = mask_b != nullptr ? *reinterpret_cast<const float2*>(mw + r * 8 * BwdQ::LDM_Q + n * 8)
                                              : make_float2(0.f, 0.f);
          const int key = k0 + n * 8 + 2 * t;
          const bool row_ok = rows[r] < Tq;
          xpw[(n * 4 + 2 * r) * 32 + lane] =
              key < Tk && row_ok ? expf(score(acc[n][2 * r], scale, mk.x) - ls[r]) : 0.f;
          xpw[(n * 4 + 2 * r + 1) * 32 + lane] =
              key + 1 < Tk && row_ok ? expf(score(acc[n][2 * r + 1], scale, mk.y) - ls[r]) : 0.f;
        }
    }
    __syncthreads();  // p is in shared memory
    if (role == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = xpw[(n * 4 + e) * 32 + lane];
          acc[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(acc[n][e], dl[e >> 1])), scale);
          xsw[(n * 4 + e) * 32 + lane] = acc[n][e];
        }
    }
    __syncthreads();  // ds is in shared memory
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = xsw[(n * 4 + e) * 32 + lane];
    }
    tile_product<8, LDC>(grad, acc, kc + role * (DC / 2), lane);  // dq's columns of this role += ds k
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (rows[r] < Tq) store_rows(dq + (bh * Tq + rows[r]) * D + c * DC + role * (DC / 2) + 2 * t, grad, r, 1.f);
}

static_assert(Fwd<128, true>::SMEM <= 232448 && Fwd<128, false>::SMEM <= 232448 && Fwd<256, false>::SMEM <= 232448 &&
                  BwdKV::DKDV_SMEM <= 232448 &&
                  BwdQ::DQ_SMEM <= 232448,
              "shared memory of one block");
static_assert(DC % DS == 0 && DS == 32, "a stage is 4 k-steps; a chunk is whole stages");

}  // namespace

// fp32 (code 0) at every head dim that is a multiple of 128. dtype codes: 0
// fp32, 1 bf16, 2 fp16.
extern "C" int attention_tf32_takes(int dtype, int D) { return dtype == 0 && D >= 128 && D % 128 == 0; }

// Launch the forward on `stream`; returns 0 or a cudaError_t. The caller
// checks: contiguous fp32 q (B, H, Tq, D), k and v (B, H, Tk, D) at a head
// dim `attention_tf32_takes`, Tq, Tk >= 1, n_virtual >= 0, a contiguous fp32
// (B, Tq, Tk) mask or null; out like q, lse fp32 (B, H, Tq).
extern "C" int launch_attention_tf32_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                                         void* lse, int dtype, int D, int B, int H, int Tq, int Tk, int n_virtual,
                                         float scale, void* stream) {
  if (!attention_tf32_takes(dtype, D) || Tq < 1 || Tk < 1 || n_virtual < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k), *vp = static_cast<const float*>(v);
  const float* mp = static_cast<const float*>(mask);
  float *op = static_cast<float*>(out), *lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_fwd<128, true>(qp, kp, vp, mp, op, lp, B, H, D, Tq, Tk, n_virtual, scale, st);
  return D % 256 == 0 ? launch_fwd<256, false>(qp, kp, vp, mp, op, lp, B, H, D, Tq, Tk, n_virtual, scale, st)
                      : launch_fwd<128, false>(qp, kp, vp, mp, op, lp, B, H, D, Tq, Tk, n_virtual, scale, st);
}

// Launch the delta pass and the dk/dv and dq kernels on `stream`; returns 0
// or a cudaError_t. As the forward, plus: out and dout like q, lse fp32
// (B, H, Tq) from the forward, `delta` an fp32 (B, H, Tq) scratch, dq like
// q, dk and dv like k.
extern "C" int launch_attention_tf32_bwd(const void* q, const void* k, const void* v, const void* mask,
                                         const void* out, const void* lse, const void* dout, void* delta, void* dq,
                                         void* dk, void* dv, int dtype, int D, int B, int H, int Tq, int Tk,
                                         float scale, void* stream) {
  const long long dkdv_blocks = grid_blocks(B, H, Tk, BwdKV::ROWS, D, DC), dq_blocks = grid_blocks(B, H, Tq, BwdQ::ROWS, D, DC);
  const long long rows = static_cast<long long>(B) * H * Tq;
  if (!attention_tf32_takes(dtype, D) || Tq < 1 || Tk < 1 || dkdv_blocks < 1 || dq_blocks < 1 ||
      rows > static_cast<long long>(INT_MAX) - DELTA_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  static hopper::SmemLimit dkdv_limit, dq_limit;
  int err = 0;
  if ((err = dkdv_limit.ensure(attention_tf32_dkdv, BwdKV::DKDV_SMEM)) ||
      (err = dq_limit.ensure(attention_tf32_dq, BwdQ::DQ_SMEM)))
    return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k), *vp = static_cast<const float*>(v);
  const float *dop = static_cast<const float*>(dout), *mp = static_cast<const float*>(mask);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  attention_tf32_delta<<<cdiv(static_cast<int>(rows), DELTA_WARPS), DELTA_WARPS * 32, 0, st>>>(
      static_cast<const float*>(out), dop, dp, static_cast<int>(rows), D);
  attention_tf32_dkdv<<<static_cast<unsigned>(dkdv_blocks), BwdKV::NTHREADS, BwdKV::DKDV_SMEM, st>>>(
      qp, kp, vp, dop, mp, lp, dp, static_cast<float*>(dk), static_cast<float*>(dv), H, D, Tq, Tk, scale);
  attention_tf32_dq<<<static_cast<unsigned>(dq_blocks), BwdQ::NTHREADS, BwdQ::DQ_SMEM, st>>>(
      qp, kp, vp, dop, mp, lp, dp, static_cast<float*>(dq), H, D, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}
