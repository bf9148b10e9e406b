// Register-resident attention tiles on Hopper's mma.sync: the primitives the
// flash forward (kernel D, flash_forward.cu) and the flash backward (kernels
// E and F, flash_backward.cu) are built from.
//   * cp.async copies of 16 bytes (rows of bf16) and 4 bytes (fp32 row
//     statistics) into shared memory; a copy with src-size 0 writes zeros
//     and reads nothing, so rows past a valid range arrive as zeros (stale
//     shared memory can hold NaN bits, and NaN x 0 is NaN);
//   * ldmatrix (x4, and x4.trans) to take mma fragments from bf16 rows kept
//     with a 16-byte skew (HD + 8 elements a row), so every ldmatrix phase
//     hits 8 distinct bank quads;
//   * mma.sync m16n8k16, bf16 in, fp32 accumulate, and the packing of fp32
//     accumulators into bf16 A fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dst {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (through L1: .cg takes 16 bytes only)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, fp32 accumulate. Lane = 4 g + t: a holds rows
// g, g + 8 at k 2t, 2t + 1 (+8); b holds column g at k 2t, 2t + 1 (+8); c holds
// rows g (c0, c1) and g + 8 (c2, c3) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f(0) .. f(N - 1), fully unrolled, or U calls an iteration where U < N:
// the d = 256 loops whose fragments come from shared memory, where ptxas
// would otherwise hoist every step's loads ahead of the products and spill.
template <int N, int U, class F>
__device__ __forceinline__ void unrolled(F&& f) {
  if constexpr (U >= N) {
#pragma unroll
    for (int i = 0; i < N; ++i) f(i);
  } else {
#pragma unroll(U)
    for (int i = 0; i < N; ++i) f(i);
  }
}

// ROWS rows of HD bf16 from src (row pitch ld elements), rows row0 .. into
// dst (pitch HD + 8) by cp.async, NT threads; rows >= n are zero-filled.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, size_t ld, int row0, int n) {
  constexpr int CH = HD / 8;
  static_assert(ROWS * CH % NT == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = r < n;
    const bf16* p = src + (ok ? size_t(row0 + r) * ld : 0) + c * 8;
    cp_async16(smem_u32(dst + r * (HD + 8) + c * 8), p, ok ? 16 : 0);
  }
}

}  // namespace dst
