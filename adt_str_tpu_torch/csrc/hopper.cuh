// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (ffn_dropout.cu, ffn_dropout_tf32.cu, attention.cu, attention_bwd.cu,
// log_mel.cu), the
// bulk-copy ring of place_notes.cu and the cp.async + mma.sync rings of
// linear.cu, attention_rows.cu and attention_tf32.cu: mbarriers, TMA tile
// copies, 1-D bulk copies, cp.async, wgmma shared-memory descriptors and
// products, ldmatrix, mma.sync (16-bit, and TF32 with the 3xTF32 split),
// wgmma in TF32, setmaxnreg, the 16-bit element types' conversions, and on the
// host the tensor-map encoder and each kernel's shared-memory limit on every
// device. Raw PTX and
// the CUDA runtime only, no library: a kernel that includes it still builds
// in seconds.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, which the
// runtime hands out through cudaGetDriverEntryPoint(ByVersion): nothing is
// linked against libcuda. A kernel takes each map as a
// `const __grid_constant__ CUtensorMap` parameter.
//
// Shared-memory tiles use the 128-byte swizzle throughout: a tile of rows of
// 64 bf16 (128 B), 8-row groups 1,024 B apart, each 16-byte chunk c of row r
// stored at chunk c ^ (r % 8). TMA writes and reads that layout
// (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads it through a descriptor of
// layout type 1. Every tile starts on a 1,024-byte boundary.
//
// The 16-bit element type T of a tensor-core product is bf16
// (__nv_bfloat16) or fp16 (__half): the products, ldmatrix and the tensor
// maps take either (template parameter T, bf16 by default), with fp32
// accumulation; a 128-byte row is 64 elements of either.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace hopper {

// ---- element types

template <typename T>
constexpr bool is_half = std::is_same<T, __half>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// Two floats rounded to T, packed in one register (lo in the low half), and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_half<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (is_half<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&r));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1,024-byte boundary at or after p (a dynamic shared buffer is
// declared 1,024 bytes larger than its tiles need).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// After the inits, before any other thread or the TMA unit uses the barriers.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic still to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (the barrier must
// not be more than one phase behind the one awaited: parity tells only two
// apart). A wait past 2 s of the global timer (a real wait is microseconds)
// traps, so a broken pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t start = 0;
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 1024 == 0) {
      const uint64_t now = global_ns();
      if (polls == 0) start = now;
      else if (now - start > 2000000000ull) __trap();
    }
  }
}

// ---- TMA

// Box at coordinates (c0 innermost, c1[, c2]) into shared memory; completion
// is counted in bytes on `bar`. Parts of the box outside the tensor land as 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at `src` into
// shared memory at `dst` (both 16-byte aligned): a 1-D bulk copy, no tensor
// map; completion is counted in bytes on `bar` as for a TMA load.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Shared memory to the tensor; the parts of the box outside the tensor are
// not written. Issue after fence_proxy_async() and a barrier over the
// writers; then store_commit() and store_wait_read() before the buffer is
// reused or the block exits.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void store_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

__device__ __forceinline__ void store_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); }

// 4 bytes from global to shared memory, asynchronously (for rows whose
// stride TMA refuses); cp_async_arrive then counts one arrival on `bar` once
// all of this thread's earlier cp.async copies have landed (the arrival is
// not added to the barrier's expected count: its init count includes it).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// 16 bytes global -> shared (both 16-byte aligned), or 16 zero bytes (no
// read of `src`) when !valid; counted in the thread's cp.async groups:
// cp_async_commit closes a group, cp_async_wait<n> waits until at most n of
// the thread's groups are still in flight (a barrier then publishes them).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, or a zero (no read of `src`) when !valid; in the
// thread's cp.async groups like cp_async_16 (for rows whose stride is not a
// multiple of 16 bytes).
__device__ __forceinline__ void cp_async_4z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Orders this thread's ordinary shared-memory accesses before later accesses
// by the async proxy (TMA, wgmma) and after earlier ones.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// bar.sync over `count` threads (a multiple of 32) on named barrier `id` (1..15).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Row offset (bytes) of element (r, c) in a 128-byte-swizzled tile of rows
// of 64 bf16: where a thread writes what TMA then stores.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

// ---- wgmma

// Descriptor of a 128-byte-swizzled bf16 tile at `p`. `lbo` and `sbo` are in
// bytes: for a K-major operand (K contiguous) sbo is the stride of 8-row
// groups (1,024) and lbo is unused; for an MN-major operand lbo is the
// stride between 64-column blocks of MN and sbo that of 8-row groups of K.
// A K step of 16 inside the 64-wide swizzle atom adds 32 bytes to `p`.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (call after wgmma_wait and before a batch).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC8(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// d (64 x 64 fp32, warpgroup fragment) += A (64 x 16, K-major, shared) B^T
// (B 64 x 16, K-major, shared); scale_d = 0 overwrites d.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_64x64_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_half<T>)
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, K-major, shared) B (16 x 64, MN-major in
// shared memory: the transpose-B bit).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_64x64_ss_tb(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_half<T>)
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) += A (64 x 16, K-major, shared) B^T (B 128 x 16, K-major, shared).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_64x128_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_half<T>)
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),
        HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),
        HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) += A (64 x 16 bf16 in registers: the accumulator-row layout,
// two bf16 a register) B (16 x 128, MN-major in shared memory: the
// transpose-B bit is set).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_64x128_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (is_half<T>)
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),
        HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  else
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),
        HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16 bf16 in registers, as for mma_64x128_rs_tb)
// B (16 x 64, MN-major in shared memory: the transpose-B bit).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_64x64_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (is_half<T>)
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  else
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, MN-major in shared memory: M contiguous, the
// transpose-A bit) B (16 x 64, MN-major in shared memory: the transpose-B bit).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_64x64_ss_tt(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (is_half<T>)
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 fp32) += A (64 x 8 TF32, K-major, shared) B^T (B 128 x 8 TF32,
// K-major, shared): fp32 bit patterns whose low 13 mantissa bits the tensor
// cores drop (a K step of 8 is 32 bytes of a 128-byte swizzled row, as a
// 16-bit K step of 16); scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_64x128_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
    "{\n"
    ".reg .pred p;\n"
    "setp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
    "%64, %65, p, 1, 1;\n"
    "}\n"
    : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),
      HOPPER_ACC8(48), HOPPER_ACC8(56)
    : "l"(a), "l"(b), "r"(scale_d));
}

#undef HOPPER_ACC8

// ---- ldmatrix

// Four 8 x 8 bf16 matrices from shared memory, one 16-byte row address a
// lane (lanes 8j..8j+7 give the rows of matrix j); register j of lane l
// holds row l / 4, columns 2 (l % 4), +1 of matrix j. With matrices (rows
// 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
// of a warp's 16 rows, the four registers are that warp's part of a wgmma
// register A operand (64 x 16).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// Two 8 x 8 bf16 matrices (lanes 0-7 and 8-15 give the rows): the B operand
// (16 x 8, k x n) of mma_16816 from a tile stored n-major (row n holds k
// contiguous), with rows n0..n0+7 at columns k0 and k0 + 8.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row))
               : "memory");
}

// Four 8 x 8 bf16 matrices, each transposed: register j of lane l holds
// rows 2 (l % 4), +1 at column l / 4 of matrix j. From a tile stored k-major
// (row k holds n contiguous), matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
// (k 0-7, n 8-15), (k 8-15, n 8-15) give the B operands of mma_16816 for
// columns n0..n0+7 (registers 0, 1) and n0+8..n0+15 (registers 2, 3).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// ---- warp-level tensor-core product

// c (16 x 8 fp32) += a (16 x 16 T, row-major) b (16 x 8 T, col-major):
// lane l holds c at rows l / 4 (c[0], c[1]) and l / 4 + 8 (c[2], c[3]),
// columns 2 (l % 4), +1; a as ldmatrix_x4 gives it, b as ldmatrix_x2 does.
// Each element's 16 products are added the same way wherever the element
// sits in the tile.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (is_half<T>)
    asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- fp32 products on the tensor cores in 3xTF32

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; bit for bit for finite x), on the integer pipes: add half of the
// 13 dropped bits' range to the magnitude, then clear them. cvt runs on the
// conversion unit, a quarter of the integer pipes' rate, and the 3xTF32
// split converts two values an operand element.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x -> big + small, two TF32 values (fp32 bit patterns whose low 13 mantissa
// bits are 0): big = tf32_rna(x), small = tf32_rna(x - big). x - big is
// exact, so big + small is x to within 2^-24 |x|.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c (16 x 8 fp32) += a (16 x 8 TF32, row-major) b (8 x 8 TF32, col-major):
// lane l holds a[0] at row l / 4, column l % 4, a[1] at row l / 4 + 8, the
// same column, and a[2], a[3] the same rows at column l % 4 + 4; b0 at k
// l % 4, b1 at k l % 4 + 4, both at n l / 4; c as mma_16816 holds it.
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
    "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
    "{%0, %1, %2, %3};"
    : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B operand's two values of a lane (b0, b1 of mma_1688_tf32), split as
// one float4: {big x0, big x1, small x0, small x1}.
__device__ __forceinline__ float4 tf32_split2(float x0, float x1) {
  uint32_t b0, s0, b1, s1;
  tf32_split(x0, b0, s0);
  tf32_split(x1, b1, s1);
  return make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(s0), __uint_as_float(s1));
}

// c[n] += a b[n] to about fp32's accuracy (3xTF32), for N n-tiles: a = ab +
// as as tf32_split gives them, b[n] as tf32_split2 does; the as bb pass over
// every n-tile, then ab bs, then ab bb (the two small terms first; as bs,
// below 2^-22 of the product, is dropped).
template <int N>
__device__ __forceinline__ void mma_1688_3xtf32(float (&c)[N][4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                                const float4 (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(c[n], as, __float_as_uint(b[n].x), __float_as_uint(b[n].y));
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(c[n], ab, __float_as_uint(b[n].z), __float_as_uint(b[n].w));
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(c[n], ab, __float_as_uint(b[n].x), __float_as_uint(b[n].y));
}

// ---- register rebalancing between the producer and consumer warpgroups
// (all four warps of a warpgroup execute it; the kernel's branches by role
// never reconverge)

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- host: a kernel's dynamic shared-memory limit, on every device

// cudaFuncSetAttribute sets the limit on the current device only, and one
// process may launch on several cards (the data-parallel decode runs a host
// thread a card). So the limit is set once a device: a `static SmemLimit`
// a kernel, whose flags are atomic (two threads that race set it twice,
// which is harmless). Returns 0, or a cudaError_t.
struct SmemLimit {
  std::atomic<bool> done[64];  // zero at static storage

  template <typename Kernel>
  int ensure(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64 && done[dev].load(std::memory_order_acquire)) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) done[dev].store(true, std::memory_order_release);
    return 0;
  }
};

// ---- host: tensor maps

// A tensor map of elements of `type` of `rank` dims (innermost first, sizes
// in elements, strides of dims 1.. in bytes) read or written in boxes of
// `box`, with the 128-byte swizzle. Returns 0, or a cudaError_t.
inline int encode_tensor_map(CUtensorMap* map, const void* base, uint32_t rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapDataType type) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The same for 16-bit elements: bf16, or fp16 with `half`.
inline int encode_tensor_map(CUtensorMap* map, const void* base, uint32_t rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box, bool half = false) {
  return encode_tensor_map(map, base, rank, dims, strides, box,
                           half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

}  // namespace hopper
