// Signed int8 / int4 values to bf16, shared by the quantized kernels
// (quant_matmul.cu: weights; paged_attention.cu and paged_decode.cu: the
// int8 / int4 KV pool). Every int4 or int8 value is exact in bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dst {

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 signed bytes -> 16 bf16 at dst (two 16-byte stores). NIB 0: the bytes
// themselves (int8); 1: their low nibbles; 2: their high nibbles (int4).
// Nibbles sign-extend by shifts on a signed int.
template <int NIB>
__device__ __forceinline__ void unpack16(const uint4& raw, __nv_bfloat16* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int s = b[e];  // sign-extended
    const int q = NIB == 0 ? s : NIB == 1 ? int(unsigned(s) << 28) >> 28 : s >> 4;
    v[e] = float(q);
  }
  uint4 lo, hi;
  lo.x = pack_bf16x2(v[0], v[1]);
  lo.y = pack_bf16x2(v[2], v[3]);
  lo.z = pack_bf16x2(v[4], v[5]);
  lo.w = pack_bf16x2(v[6], v[7]);
  hi.x = pack_bf16x2(v[8], v[9]);
  hi.y = pack_bf16x2(v[10], v[11]);
  hi.z = pack_bf16x2(v[12], v[13]);
  hi.w = pack_bf16x2(v[14], v[15]);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// Packed bytes straight into bf16 mma fragments, no shared-memory round trip
// (quant_matmul.cu's multi-row kernel, paged_decode.cu).
// A 32-bit word r of four bytes b0 .. b3 -- what ldmatrix hands a thread:
// non-trans, bytes 4t .. 4t + 3 of row g; .trans, bytes 2g, 2g + 1 of rows
// 2t (b0, b1) and 2t + 1 (b2, b3) -- becomes bf16x2 words of the byte pairs
// (b0, b2) in .x and (b1, b3) in .y.

// (a & b) | c in one instruction
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&h);
}

// int8: a byte q is its low seven bits minus 128 times its sign bit; the low
// seven bits or-ed into the mantissa of bf16 128, the sign bit into the
// exponent's lowest bit (128 or 256), the second subtracted from the first
// in bf16x2 -- exact.
__device__ __forceinline__ uint2 frag_int8(uint32_t r) {
  const uint32_t lo7 = 0x007F007Fu, sign = 0x00800080u, bf128 = 0x43004300u;
  const uint32_t r8 = r >> 8;
  return make_uint2(bf16x2_sub(and_or(r, lo7, bf128), and_or(r, sign, bf128)),
                    bf16x2_sub(and_or(r8, lo7, bf128), and_or(r8, sign, bf128)));
}

// int4: lo from the low nibbles, hi from the high ones. A nibble q biased to
// 8 + q is or-ed into the mantissa of bf16 128 and 136 comes off -- exact.
__device__ __forceinline__ void frag_int4(uint32_t r, uint2& lo, uint2& hi) {
  const uint32_t u = r ^ 0x88888888u, nib = 0x000F000Fu, bf128 = 0x43004300u;
  const uint32_t bias = 0x43084308u;  // bf16x2 136
  lo = make_uint2(bf16x2_sub(and_or(u, nib, bf128), bias),
                  bf16x2_sub(and_or(u >> 8, nib, bf128), bias));
  hi = make_uint2(bf16x2_sub(and_or(u >> 4, nib, bf128), bias),
                  bf16x2_sub(and_or(u >> 12, nib, bf128), bias));
}

}  // namespace dst
