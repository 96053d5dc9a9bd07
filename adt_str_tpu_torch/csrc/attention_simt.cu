// K5 on the CUDA cores: fused attention, forward and backward, for the
// inputs the tensor-core kernels (attention.cu, attention_bwd.cu: bf16 and
// fp16 at head dim 128 or 256) do not take: fp32 q, k, v at head dims
// 128..768, and bf16 and fp16 at head dims 384..768 (multiples of 128).
//
// Replaces adt_str_tpu/ops/pallas_attention.py:_fwd (_fwd_kernel) and
// :_vjp_bwd (_bwd_kernel) for those inputs. JAX's kernel runs in any dtype
// and at any head dim that is a multiple of 128 (transformer.py's gate);
// fp32 comes from `model.compute_dtype: float32`, head dims 384 and 768
// from 2 heads and 1 head at d 768. The arithmetic is that of ops/cuda_attention.py's plain
// versions, with every product in fp32 FMA (no TF32):
//     s = (q . k) * scale + mask;  m = max(max_j s, -1e4 if n_virtual > 0)
//     l = sum_j exp(s - m) + n_virtual * exp(-1e4 - m);  lse = m + log(l)
//     out = sum_j T(exp(s - m) / l) v_j      (T: v's dtype, fp32 accumulation)
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
//   - a tile of B rows by B keys (B = 64 at head dim 128, 32 at 256, 16 at
//     384..768: a multiple of 16, and the backward's six fp32 tiles fit one
//     block's 232,448 B up to D 768 and no further), 256 threads in
//     a 16 x 16 grid, each thread an R x R block of the score tile (rows
//     ty + 16 i, keys tx + 16 j, R = B / 16) and an R x D/16 block of its
//     output;
//   - operands staged in shared memory as fp32, each row padded by one word
//     so that a warp's 16 rows or keys fall in 16 banks;
//   - the forward walks the key tiles twice, exactly as the plain version
//     rounds: pass 1 takes the row max and sum (online, fp32), pass 2 forms
//     p with the final m and l, rounds it to v's dtype, and adds p V;
//   - the backward runs three kernels and no atomics (deterministic): the
//     delta pass; one block a key tile that walks the query tiles and keeps
//     dk and dv in registers; one block a query tile that walks the key
//     tiles and keeps dq in registers (s and dp are formed in both).
// The instantiated (dtype, head dim) pairs are those of
// `attention_simt_takes`; the wrapper raises on any other (head dims past
// 768: the limit of one block's shared memory).

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

}  // namespace

// The (dtype, head dim) pairs instantiated here, each as one case:
// X(code, element type, D). dtype codes: 0 fp32, 1 bf16, 2 fp16.
#define SIMT_PAIRS(X)                                                                                           \
  X(0, float, 128) X(0, float, 256) X(0, float, 384) X(0, float, 512) X(0, float, 640) X(0, float, 768)         \
  X(1, __nv_bfloat16, 384) X(1, __nv_bfloat16, 512) X(1, __nv_bfloat16, 640) X(1, __nv_bfloat16, 768)            \
  X(2, __half, 384) X(2, __half, 512) X(2, __half, 640) X(2, __half, 768)

extern "C" int attention_simt_takes(int dtype, int D) {
#define SIMT_TAKES(code, T, d) if (dtype == code && D == d) return 1;
  SIMT_PAIRS(SIMT_TAKES)
#undef SIMT_TAKES
  return 0;
}

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
  return static_cast<int>(cudaErrorInvalidValue);
}
