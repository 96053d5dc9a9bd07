// K5 on the CUDA cores: fused attention, forward and backward, for the
// inputs the tensor-core kernels (attention.cu, attention_bwd.cu: bf16 and
// fp16 at head dim 128 or 256; attention_wide.cu: bf16 and fp16 past 256) do
// not take: fp32 q, k, v at every head dim that is a multiple of 128.
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel) and
// :_vjp_bwd (_bwd_kernel) for those inputs. JAX's kernel runs in any dtype
// and at any head dim that is a multiple of 128 (transformer.py's gate);
// fp32 comes from `model.compute_dtype: float32`. The arithmetic is that of
// ops/cuda_attention.py's plain versions, with every product in fp32 FMA
// (no TF32):
//     s = (q . k) * scale + mask;  m = max(max_j s, -1e4 if n_virtual > 0)
//     l = sum_j exp(s - m) + n_virtual * exp(-1e4 - m);  lse = m + log(l)
//     out = sum_j (exp(s - m) / l) v_j
//     p = exp(s - lse);  dv = p^T do;  dp = do v^T;  delta = rowsum(do * out)
//     ds = p (dp - delta) * scale;  dq = ds k;  dk = ds^T q     (all fp32)
// exp and the division are the accurate ones (expf, IEEE division): the fp32
// path is held to the plain path's fp32 results, not to a bf16 tolerance.
//
// Bound on an H100: at the decoder's training shapes (B 64, 6 heads,
// 511 x 511, head dim 128) the forward's products are 4 Tq Tk D flops a
// head, 51 GFLOP, 0.77 ms at the 67 TFLOP/s of fp32 FMA; the backward's
// five products 128 GFLOP, 1.9 ms. The fp32 operands are 4 bytes: q, k, v,
// out and the mask are 0.27 GB (0.08 ms at 3.35 TB/s). So it is bound by
// fp32 operations, and the design is the plain tiled one:
//   - head dims 128..768: a tile of B rows by B keys (B = 64 at head dim
//     128, 32 at 256, 16 at 384..768: a multiple of 16, and the backward's
//     six fp32 tiles fit one block's 232,448 B up to D 768), 256 threads in
//     a 16 x 16 grid, each thread an R x R block of the score tile (rows
//     ty + 16 i, keys tx + 16 j, R = B / 16) and an R x D/16 block of its
//     output;
//   - operands staged in shared memory as fp32, each row padded by one word
//     so that a warp's 16 rows or keys fall in 16 banks;
//   - the forward walks the key tiles twice, exactly as the plain version
//     rounds: pass 1 takes the row max and sum (online, fp32), pass 2 forms
//     p with the final m and l and adds p V;
//   - the backward runs three kernels and no atomics (deterministic): the
//     delta pass; one block a key tile that walks the query tiles and keeps
//     dk and dv in registers; one block a query tile that walks the key
//     tiles and keeps dq in registers (s and dp are formed in both);
//   - past head dim 768 the head dim stops sizing a block: the `_chunked`
//     kernels stage q, k, v and do in shared memory 128 columns at a time
//     (16-row tiles) while a score accumulates over the whole depth (in
//     the same d order as the kernels above), and each block forms one
//     128-column chunk of out, dk and dv, or dq: blocks a (batch, head,
//     row or key tile, column chunk), so s and dp are formed once a chunk.
// `attention_simt_takes` names the (dtype, head dim) pairs; the wrapper
// raises on any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid
constexpr float NEG_MASK = -1e4f;
constexpr int DELTA_WARPS = 8;

using hopper::from_float;
using hopper::to_float;

template <int D>
struct Tiles {
  static constexpr int B = D <= 128 ? 64 : D <= 256 ? 32 : 16;  // rows and keys a tile
  static constexpr int R = B / 16;    // a thread's rows (and keys) of a score tile
  static constexpr int C = D / 16;    // a thread's head-dim columns of an output row
  static constexpr int LD = D + 1;    // padded fp32 row of a (B, D) tile
  static constexpr int LB = B + 1;    // padded fp32 row of a (B, B) tile
  static_assert(B % 16 == 0 && D % 16 == 0, "R = B / 16 rows and keys, C = D / 16 columns a thread");
};

// rows row0.. of a (rows, D) matrix -> a (B, D) fp32 tile with padded rows;
// rows past `rows` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int rows) {
  using S = Tiles<D>;
  for (int e = threadIdx.x; e < S::B * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r * S::LD + d] = row0 + r < rows ? to_float(src[static_cast<size_t>(row0 + r) * D + d]) : 0.f;
  }
}

// s[i][j] = sum_d a[(ty + 16 i), d] b[(tx + 16 j), d] over two (B, D) tiles
template <int D>
__device__ __forceinline__ void tile_products(const float* a, const float* b, float (&s)[Tiles<D>::R][Tiles<D>::R],
                                              int tx, int ty) {
  using S = Tiles<D>;
#pragma unroll
  for (int i = 0; i < S::R; ++i)
#pragma unroll
    for (int j = 0; j < S::R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[S::R], y[S::R];
#pragma unroll
    for (int i = 0; i < S::R; ++i) x[i] = a[(ty + 16 * i) * S::LD + d];
#pragma unroll
    for (int j = 0; j < S::R; ++j) y[j] = b[(tx + 16 * j) * S::LD + d];
#pragma unroll
    for (int i = 0; i < S::R; ++i)
#pragma unroll
      for (int j = 0; j < S::R; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// the (scaled, masked) score as the plain version rounds it: (q . k) * scale, then + mask
__device__ __forceinline__ float score(float dot, float scale, float mask) { return __fadd_rn(__fmul_rn(dot, scale), mask); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attention_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                                                               const T* __restrict__ v, const float* __restrict__ mask,
                                                               T* __restrict__ out, float* __restrict__ lse, int H,
                                                               int Tq, int Tk, int n_virtual, float scale) {
  using S = Tiles<D>;
  constexpr int B = S::B, R = S::R, C = S::C, LD = S::LD, LB = S::LB;
  extern __shared__ float smem[];
  float* qs = smem;          // [B][LD]
  float* kvs = qs + B * LD;  // [B][LD]: a K tile, then a V tile
  float* ps = kvs + B * LD;  // [B][LB]: p of the key tile

  const int nq = (Tq + B - 1) / B, nk = (Tk + B - 1) / B;
  const int h = blockIdx.x % H, qt = (blockIdx.x / H) % nq, b = blockIdx.x / (H * nq);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int q0 = qt * B, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  load_tile<T, D>(qs, q + bh * Tq * D, q0, Tq);
  const float* mrow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    mrow[i] = (mask != nullptr && qi < Tq) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
  }
  float s[R][R];
  // the scores of the K tile in kvs at key k0; -inf past Tk
  auto scores = [&](int k0) {
    tile_products<D>(qs, kvs, s, tx, ty);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = key < Tk ? score(s[i][j], scale, mrow[i] != nullptr ? __ldg(mrow[i] + key) : 0.f) : -INFINITY;
      }
  };

  // pass 1: row max and sum, online over the key tiles; a row's 16 threads
  // are lanes of one half-warp (xor 1..8 stays inside it)
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = n_virtual > 0 ? NEG_MASK : -INFINITY;
    l[i] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, D>(kvs, kb, kt * B, Tk);
    __syncthreads();
    scores(kt * B);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < R; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // mx is finite: key 0 < Tk scores a finite value in tile 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) sum += expf(s[i][j] - mx);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = (m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mx)) + sum;
      m[i] = mx;
    }
  }
  float row_lse[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (n_virtual > 0) l[i] += static_cast<float>(n_virtual) * expf(NEG_MASK - m[i]);
    row_lse[i] = m[i] + logf(l[i]);
  }

  // pass 2: p = T(exp(s - m) / l), out += p V
  float o[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) o[i][c] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, D>(kvs, kb, kt * B, Tk);
    __syncthreads();
    scores(kt * B);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        ps[(ty + 16 * i) * LB + tx + 16 * j] = to_float(from_float<T>(__fdiv_rn(expf(s[i][j] - m[i]), l[i])));
    __syncthreads();  // the K tile is read and p written: V takes the K tile's place
    load_tile<T, D>(kvs, vb, kt * B, Tk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < B; ++j) {
      float x[R], y[C];
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = ps[(ty + 16 * i) * LB + j];
#pragma unroll
      for (int c = 0; c < C; ++c) y[c] = kvs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) o[i][c] = fmaf(x[i], y[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    T* orow = out + (bh * Tq + qi) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[tx + 16 * c] = from_float<T>(o[i][c]);
    if (tx == 0) lse[bh * Tq + qi] = row_lse[i];
  }
}

// delta = rowsum(do * out) in fp32, a warp a row
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_WARPS * 32) attention_delta_simt(const T* __restrict__ out,
                                                                           const T* __restrict__ dout,
                                                                           float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + static_cast<size_t>(row) * D;
  const T* g = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) sum = fmaf(to_float(o[d]), to_float(g[d]), sum);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

// dk, dv: one block a (batch, head, key tile), head fastest, walking the
// query tiles; a thread's keys are rows ty + 16 i, its queries tx + 16 j
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attention_dkdv_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, float scale) {
  using S = Tiles<D>;
  constexpr int B = S::B, R = S::R, C = S::C, LD = S::LD, LB = S::LB;
  extern __shared__ float smem[];
  float* ks = smem;            // [B][LD]
  float* vs = ks + B * LD;     // [B][LD]
  float* qs = vs + B * LD;     // [B][LD]
  float* dos = qs + B * LD;    // [B][LD]
  float* pt = dos + B * LD;    // [B keys][LB]: p^T
  float* dst = pt + B * LB;    // [B keys][LB]: ds^T
  float* ms = dst + B * LB;    // [B queries][LB]: the mask tile
  float* ls = ms + B * LB;     // [B]: lse of the query tile (+inf past Tq: p = 0)
  float* dl = ls + B;          // [B]: delta

  const int nk = (Tk + B - 1) / B, nq = (Tq + B - 1) / B;
  const int h = blockIdx.x % H, kt = (blockIdx.x / H) % nk, b = blockIdx.x / (H * nk);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int k0 = kt * B, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;

  load_tile<T, D>(ks, k + bh * Tk * D, k0, Tk);
  load_tile<T, D>(vs, v + bh * Tk * D, k0, Tk);
  float gk[R][C], gv[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * B;
    __syncthreads();  // the previous query tile's readers are done
    load_tile<T, D>(qs, q + bh * Tq * D, q0, Tq);
    load_tile<T, D>(dos, dout + bh * Tq * D, q0, Tq);
    for (int e = threadIdx.x; e < B; e += THREADS) {
      const bool ok = q0 + e < Tq;
      ls[e] = ok ? lse[bh * Tq + q0 + e] : INFINITY;
      dl[e] = ok ? delta[bh * Tq + q0 + e] : 0.f;
    }
    if (mask_b != nullptr)
      for (int e = threadIdx.x; e < B * B; e += THREADS) {
        const int r = e / B, c = e % B;
        ms[r * LB + c] = (q0 + r < Tq && k0 + c < Tk) ? __ldg(mask_b + static_cast<size_t>(q0 + r) * Tk + k0 + c) : 0.f;
      }
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_products<D>(ks, qs, s, tx, ty);   // s^T: keys x queries
    tile_products<D>(vs, dos, dp, tx, ty);  // dp^T
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        const float sc = score(s[i][j], scale, mask_b != nullptr ? ms[qc * LB + kr] : 0.f);
        const float p = k0 + kr < Tk ? expf(sc - ls[qc]) : 0.f;
        pt[kr * LB + qc] = p;
        dst[kr * LB + qc] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dl[qc])), scale);
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < B; ++j) {
      float xp[R], xs[R], yo[C], yq[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        xp[i] = pt[(ty + 16 * i) * LB + j];
        xs[i] = dst[(ty + 16 * i) * LB + j];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        yo[c] = dos[j * LD + tx + 16 * c];
        yq[c] = qs[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          gv[i][c] = fmaf(xp[i], yo[c], gv[i][c]);
          gk[i][c] = fmaf(xs[i], yq[c], gk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
    const size_t row = (bh * Tk + key) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[row + tx + 16 * c] = from_float<T>(gk[i][c]);
      dv[row + tx + 16 * c] = from_float<T>(gv[i][c]);
    }
  }
}

// dq: one block a (batch, head, query tile), head fastest, walking the key
// tiles; a thread's queries are rows ty + 16 i, its keys tx + 16 j
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attention_dq_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Tq, int Tk, float scale) {
  using S = Tiles<D>;
  constexpr int B = S::B, R = S::R, C = S::C, LD = S::LD, LB = S::LB;
  extern __shared__ float smem[];
  float* qs = smem;          // [B][LD]
  float* dos = qs + B * LD;  // [B][LD]
  float* ks = dos + B * LD;  // [B][LD]
  float* vs = ks + B * LD;   // [B][LD]
  float* dss = vs + B * LD;  // [B queries][LB]: ds

  const int nq = (Tq + B - 1) / B, nk = (Tk + B - 1) / B;
  const int h = blockIdx.x % H, qt = (blockIdx.x / H) % nq, b = blockIdx.x / (H * nq);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int q0 = qt * B, tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(qs, q + bh * Tq * D, q0, Tq);
  load_tile<T, D>(dos, dout + bh * Tq * D, q0, Tq);
  const float* mrow[R];
  float ls[R], dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool ok = qi < Tq;
    mrow[i] = (mask != nullptr && ok) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
    ls[i] = ok ? lse[bh * Tq + qi] : INFINITY;
    dl[i] = ok ? delta[bh * Tq + qi] : 0.f;
  }
  float gq[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) gq[i][c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_tile<T, D>(ks, k + bh * Tk * D, k0, Tk);
    load_tile<T, D>(vs, v + bh * Tk * D, k0, Tk);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_products<D>(qs, ks, s, tx, ty);
    tile_products<D>(dos, vs, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;
        if (key < Tk) {
          const float p = expf(score(s[i][j], scale, mrow[i] != nullptr ? __ldg(mrow[i] + key) : 0.f) - ls[i]);
          ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dl[i])), scale);
        }
        dss[(ty + 16 * i) * LB + tx + 16 * j] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < B; ++j) {
      float x[R], y[C];
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = dss[(ty + 16 * i) * LB + j];
#pragma unroll
      for (int c = 0; c < C; ++c) y[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) gq[i][c] = fmaf(x[i], y[c], gq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    const size_t row = (bh * Tq + qi) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[row + tx + 16 * c] = from_float<T>(gq[i][c]);
  }
}

template <int D>
constexpr int fwd_smem() { return (2 * Tiles<D>::B * Tiles<D>::LD + Tiles<D>::B * Tiles<D>::LB) * 4; }
template <int D>
constexpr int dkdv_smem() {
  return (4 * Tiles<D>::B * Tiles<D>::LD + 3 * Tiles<D>::B * Tiles<D>::LB + 2 * Tiles<D>::B) * 4;
}
template <int D>
constexpr int dq_smem() { return (4 * Tiles<D>::B * Tiles<D>::LD + Tiles<D>::B * Tiles<D>::LB) * 4; }

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B, int H, int Tq,
        int Tk, int n_virtual, float scale, cudaStream_t st) {
  static_assert(fwd_smem<D>() <= 232448, "shared memory of one block");
  static hopper::SmemLimit limit;
  int err = limit.ensure(attention_fwd_simt<T, D>, fwd_smem<D>());
  if (err) return err;
  const int blocks = B * H * ((Tq + Tiles<D>::B - 1) / Tiles<D>::B);  // head fastest
  attention_fwd_simt<T, D><<<blocks, THREADS, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk, n_virtual, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* mask, const void* out, const void* lse,
        const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
        cudaStream_t st) {
  static_assert(dkdv_smem<D>() <= 232448 && dq_smem<D>() <= 232448, "shared memory of one block");
  static hopper::SmemLimit dkdv_limit, dq_limit;
  int err = 0;
  if ((err = dkdv_limit.ensure(attention_dkdv_simt<T, D>, dkdv_smem<D>())) ||
      (err = dq_limit.ensure(attention_dq_simt<T, D>, dq_smem<D>())))
    return err;
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k), *vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float *mp = static_cast<const float*>(mask), *lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const int rows = B * H * Tq, tile = Tiles<D>::B;
  attention_delta_simt<T, D><<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(
      static_cast<const T*>(out), dop, dp, rows);
  attention_dkdv_simt<T, D><<<B * H * ((Tk + tile - 1) / tile), THREADS, dkdv_smem<D>(), st>>>(
      qp, kp, vp, dop, mp, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, scale);
  attention_dq_simt<T, D><<<B * H * ((Tq + tile - 1) / tile), THREADS, dq_smem<D>(), st>>>(
      qp, kp, vp, dop, mp, lp, dp, static_cast<T*>(dq), H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 past head dim 768: the head dim staged 128 columns at a time

constexpr int DC = 128;         // columns of a staged chunk and of an output chunk
constexpr int CB = 16;          // rows and keys of a tile: one a thread of the 16 x 16 grid
constexpr int CLD = DC + 1;     // padded row of a (CB, DC) tile
constexpr int CLB = CB + 1;     // padded row of a (CB, CB) tile
constexpr int CC = DC / 16;     // a thread's columns of an output chunk

// columns col0.. of rows row0.. of a (rows, D) fp32 matrix -> a (CB, DC)
// tile with padded rows; rows past `rows` are zeros
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ src, int row0, int rows, int col0,
                                           int D) {
  for (int e = threadIdx.x; e < CB * DC; e += THREADS) {
    const int r = e / DC, d = e % DC;
    dst[r * CLD + d] = row0 + r < rows ? src[static_cast<size_t>(row0 + r) * D + col0 + d] : 0.f;
  }
}

// acc += sum_d a[ty, d] b[tx, d] over one staged chunk, d ascending: the
// chunks in order add the head dim in the order of tile_products
__device__ __forceinline__ void chunk_products(const float* a, const float* b, float& acc, int tx, int ty) {
#pragma unroll 8
  for (int d = 0; d < DC; ++d) acc = fmaf(a[ty * CLD + d], b[tx * CLD + d], acc);
}

// a thread's score over the whole head dim: a[row0 + ty] . b[key0 + tx]
// through two staging tiles (the block's threads all take part)
__device__ __forceinline__ float depth_product(float* as, float* bs, const float* a, int row0, int rows,
                                               const float* b, int key0, int keys, int D, int tx, int ty) {
  float acc = 0.f;
  for (int col0 = 0; col0 < D; col0 += DC) {
    __syncthreads();  // the tiles' earlier readers are done
    load_chunk(as, a, row0, rows, col0, D);
    load_chunk(bs, b, key0, keys, col0, D);
    __syncthreads();
    chunk_products(as, bs, acc, tx, ty);
  }
  return acc;
}

// out's column chunk blockIdx.x % (D / DC) of one (batch, head, 16-row tile)
__global__ void __launch_bounds__(THREADS) attention_fwd_chunked(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int H, int D, int Tq, int Tk,
    int n_virtual, float scale) {
  __shared__ float tiles[2 * CB * CLD + CB * CLB];
  float* qs = tiles;             // [CB][CLD]
  float* ks = qs + CB * CLD;     // [CB][CLD]: a K chunk, then a V chunk
  float* ps = ks + CB * CLD;     // [CB][CLB]: p of the key tile
  const int NCH = D / DC, nq = (Tq + CB - 1) / CB, nk = (Tk + CB - 1) / CB;
  const int oc = blockIdx.x % NCH, rest = blockIdx.x / NCH;
  const int h = rest % H, qt = (rest / H) % nq, b = rest / (H * nq);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int q0 = qt * CB, tx = threadIdx.x % 16, ty = threadIdx.x / 16, qi = q0 + ty;
  const float* qb = q + bh * Tq * D;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const float* mrow = (mask != nullptr && qi < Tq) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
  auto scores = [&](int k0) {
    const float dot = depth_product(qs, ks, qb, q0, Tq, kb, k0, Tk, D, tx, ty);
    const int key = k0 + tx;
    return key < Tk ? score(dot, scale, mrow != nullptr ? __ldg(mrow + key) : 0.f) : -INFINITY;
  };

  // pass 1: the row max and sum, online; a row's 16 threads are lanes of one half-warp
  float m = n_virtual > 0 ? NEG_MASK : -INFINITY, l = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const float s = scores(kt * CB);
    float mx = fmaxf(m, s);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = expf(s - mx);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = (m == -INFINITY ? 0.f : l * expf(m - mx)) + sum;
    m = mx;
  }
  if (n_virtual > 0) l += static_cast<float>(n_virtual) * expf(NEG_MASK - m);

  // pass 2: p = exp(s - m) / l, out's chunk += p V
  float o[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) o[c] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const float s = scores(kt * CB);
    ps[ty * CLB + tx] = __fdiv_rn(expf(s - m), l);
    __syncthreads();  // the K chunk is read and p written: V's chunk takes the K tile's place
    load_chunk(ks, vb, kt * CB, Tk, oc * DC, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < CB; ++j) {
      const float x = ps[ty * CLB + j];
#pragma unroll
      for (int c = 0; c < CC; ++c) o[c] = fmaf(x, ks[j * CLD + tx + 16 * c], o[c]);
    }
  }
  if (qi >= Tq) return;
  float* orow = out + (bh * Tq + qi) * D + oc * DC;
#pragma unroll
  for (int c = 0; c < CC; ++c) orow[tx + 16 * c] = o[c];
  if (oc == 0 && tx == 0) lse[bh * Tq + qi] = m + logf(l);
}

// delta = rowsum(do * out), a warp a row, at any head dim
__global__ void __launch_bounds__(DELTA_WARPS * 32) attention_delta_chunked(const float* __restrict__ out,
                                                                             const float* __restrict__ dout,
                                                                             float* __restrict__ delta, int rows,
                                                                             int D) {
  const int row = blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + static_cast<size_t>(row) * D;
  const float* g = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(o[d], g[d], sum);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

// dk, dv: column chunk blockIdx.x % (D / DC) of one (batch, head, 16-key
// tile), walking the query tiles; a thread's key is row ty, its query tx
__global__ void __launch_bounds__(THREADS) attention_dkdv_chunked(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H, int D, int Tq, int Tk,
    float scale) {
  __shared__ float as[CB * CLD], bs[CB * CLD], pt[CB * CLB], dst[CB * CLB], ms[CB * CLB], ls[CB], dl[CB];
  const int NCH = D / DC, nk = (Tk + CB - 1) / CB, nq = (Tq + CB - 1) / CB;
  const int oc = blockIdx.x % NCH, rest = blockIdx.x / NCH;
  const int h = rest % H, kt = (rest / H) % nk, b = rest / (H * nk);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int k0 = kt * CB, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* mask_b = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * Tk;
  const float *qb = q + bh * Tq * D, *kb = k + bh * Tk * D, *vb = v + bh * Tk * D, *db = dout + bh * Tq * D;
  float gk[CC], gv[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) gk[c] = gv[c] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * CB;
    const float s = depth_product(as, bs, kb, k0, Tk, qb, q0, Tq, D, tx, ty);   // s^T: keys x queries
    const float dp = depth_product(as, bs, vb, k0, Tk, db, q0, Tq, D, tx, ty);  // dp^T
    if (threadIdx.x < CB) {
      const bool ok = q0 + threadIdx.x < Tq;
      ls[threadIdx.x] = ok ? lse[bh * Tq + q0 + threadIdx.x] : INFINITY;  // p = 0 past Tq
      dl[threadIdx.x] = ok ? delta[bh * Tq + q0 + threadIdx.x] : 0.f;
    }
    if (mask_b != nullptr) {
      const int r = threadIdx.x / CB, c = threadIdx.x % CB;  // query r, key c
      ms[r * CLB + c] = (q0 + r < Tq && k0 + c < Tk) ? __ldg(mask_b + static_cast<size_t>(q0 + r) * Tk + k0 + c) : 0.f;
    }
    __syncthreads();
    const float p = k0 + ty < Tk ? expf(score(s, scale, mask_b != nullptr ? ms[tx * CLB + ty] : 0.f) - ls[tx]) : 0.f;
    pt[ty * CLB + tx] = p;
    dst[ty * CLB + tx] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dl[tx])), scale);
    // this chunk's columns of the query tile's q and do
    load_chunk(as, qb, q0, Tq, oc * DC, D);
    load_chunk(bs, db, q0, Tq, oc * DC, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < CB; ++j) {
      const float xp = pt[ty * CLB + j], xs = dst[ty * CLB + j];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        gv[c] = fmaf(xp, bs[j * CLD + tx + 16 * c], gv[c]);
        gk[c] = fmaf(xs, as[j * CLD + tx + 16 * c], gk[c]);
      }
    }
  }
  const int key = k0 + ty;
  if (key >= Tk) return;
  const size_t row = (bh * Tk + key) * D + oc * DC;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    dk[row + tx + 16 * c] = gk[c];
    dv[row + tx + 16 * c] = gv[c];
  }
}

// dq: column chunk blockIdx.x % (D / DC) of one (batch, head, 16-query
// tile), walking the key tiles; a thread's query is row ty, its key tx
__global__ void __launch_bounds__(THREADS) attention_dq_chunked(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int D, int Tq, int Tk, float scale) {
  __shared__ float as[CB * CLD], bs[CB * CLD], dss[CB * CLB];
  const int NCH = D / DC, nq = (Tq + CB - 1) / CB, nk = (Tk + CB - 1) / CB;
  const int oc = blockIdx.x % NCH, rest = blockIdx.x / NCH;
  const int h = rest % H, qt = (rest / H) % nq, b = rest / (H * nq);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int q0 = qt * CB, tx = threadIdx.x % 16, ty = threadIdx.x / 16, qi = q0 + ty;
  const bool ok = qi < Tq;
  const float* mrow = (mask != nullptr && ok) ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk : nullptr;
  const float ls = ok ? lse[bh * Tq + qi] : INFINITY, dl = ok ? delta[bh * Tq + qi] : 0.f;
  const float *qb = q + bh * Tq * D, *kb = k + bh * Tk * D, *vb = v + bh * Tk * D, *db = dout + bh * Tq * D;
  float gq[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) gq[c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * CB, key = k0 + tx;
    const float s = depth_product(as, bs, qb, q0, Tq, kb, k0, Tk, D, tx, ty);
    const float dp = depth_product(as, bs, db, q0, Tq, vb, k0, Tk, D, tx, ty);
    float ds = 0.f;
    if (key < Tk) {
      const float p = expf(score(s, scale, mrow != nullptr ? __ldg(mrow + key) : 0.f) - ls);
      ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dl)), scale);
    }
    __syncthreads();  // the staging tiles' readers are done
    dss[ty * CLB + tx] = ds;
    load_chunk(bs, kb, k0, Tk, oc * DC, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < CB; ++j) {
      const float x = dss[ty * CLB + j];
#pragma unroll
      for (int c = 0; c < CC; ++c) gq[c] = fmaf(x, bs[j * CLD + tx + 16 * c], gq[c]);
    }
  }
  if (!ok) return;
  const size_t row = (bh * Tq + qi) * D + oc * DC;
#pragma unroll
  for (int c = 0; c < CC; ++c) dq[row + tx + 16 * c] = gq[c];
}

int fwd_chunked(const float* q, const float* k, const float* v, const float* mask, float* out, float* lse, int D,
                int B, int H, int Tq, int Tk, int n_virtual, float scale, cudaStream_t st) {
  const long long blocks = static_cast<long long>(B) * H * ((Tq + CB - 1) / CB) * (D / DC);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attention_fwd_chunked<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(q, k, v, mask, out, lse, H, D, Tq, Tk,
                                                                           n_virtual, scale);
  return static_cast<int>(cudaGetLastError());
}

int bwd_chunked(const float* q, const float* k, const float* v, const float* mask, const float* out,
                const float* lse, const float* dout, float* delta, float* dq, float* dk, float* dv, int D, int B,
                int H, int Tq, int Tk, float scale, cudaStream_t st) {
  const long long dkdv_blocks = static_cast<long long>(B) * H * ((Tk + CB - 1) / CB) * (D / DC);
  const long long dq_blocks = static_cast<long long>(B) * H * ((Tq + CB - 1) / CB) * (D / DC);
  if (dkdv_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * H * Tq;
  attention_delta_chunked<<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0, st>>>(out, dout, delta, rows,
                                                                                               D);
  attention_dkdv_chunked<<<static_cast<unsigned>(dkdv_blocks), THREADS, 0, st>>>(q, k, v, dout, mask, lse, delta, dk,
                                                                                 dv, H, D, Tq, Tk, scale);
  attention_dq_chunked<<<static_cast<unsigned>(dq_blocks), THREADS, 0, st>>>(q, k, v, dout, mask, lse, delta, dq, H,
                                                                             D, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (dtype, head dim) pairs instantiated here, each as one case:
// X(code, element type, D). dtype codes: 0 fp32, 1 bf16, 2 fp16.
#define SIMT_PAIRS(X) \
  X(0, float, 128) X(0, float, 256) X(0, float, 384) X(0, float, 512) X(0, float, 640) X(0, float, 768)

// fp32 (code 0) at every head dim that is a multiple of 128: the kernels
// above at 128..768 (`SIMT_PAIRS`), the chunked ones past 768.
extern "C" int attention_simt_takes(int dtype, int D) { return dtype == 0 && D >= 128 && D % 128 == 0; }

// Launch the forward on `stream`; returns 0 or a cudaError_t. The caller
// checks: contiguous q (B, H, Tq, D), k and v (B, H, Tk, D) of one dtype that
// `attention_simt_takes`, Tq, Tk >= 1, n_virtual >= 0, a contiguous fp32
// (B, Tq, Tk) mask or null; out like q, lse fp32 (B, H, Tq).
extern "C" int launch_attention_simt_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                                         void* lse, int dtype, int D, int B, int H, int Tq, int Tk, int n_virtual,
                                         float scale, void* stream) {
  if (Tq < 1 || Tk < 1 || n_virtual < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SIMT_FWD(code, T, d) \
  if (dtype == code && D == d) return fwd<T, d>(q, k, v, mask, out, lse, B, H, Tq, Tk, n_virtual, scale, st);
  SIMT_PAIRS(SIMT_FWD)
#undef SIMT_FWD
  if (attention_simt_takes(dtype, D))
    return fwd_chunked(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                       static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(lse), D, B, H,
                       Tq, Tk, n_virtual, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch the delta pass and the dk/dv and dq kernels on `stream`; returns 0
// or a cudaError_t. As the forward, plus: out and dout like q, lse fp32
// (B, H, Tq) from the forward, `delta` an fp32 (B, H, Tq) scratch, dq like
// q, dk and dv like k.
extern "C" int launch_attention_simt_bwd(const void* q, const void* k, const void* v, const void* mask,
                                         const void* out, const void* lse, const void* dout, void* delta, void* dq,
                                         void* dk, void* dv, int dtype, int D, int B, int H, int Tq, int Tk,
                                         float scale, void* stream) {
  if (Tq < 1 || Tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SIMT_BWD(code, T, d) \
  if (dtype == code && D == d) \
    return bwd<T, d>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, H, Tq, Tk, scale, st);
  SIMT_PAIRS(SIMT_BWD)
#undef SIMT_BWD
  if (attention_simt_takes(dtype, D))
    return bwd_chunked(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                       static_cast<const float*>(mask), static_cast<const float*>(out), static_cast<const float*>(lse),
                       static_cast<const float*>(dout), static_cast<float*>(delta), static_cast<float*>(dq),
                       static_cast<float*>(dk), static_cast<float*>(dv), D, B, H, Tq, Tk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
