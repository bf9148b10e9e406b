// Signed int8 / int4 values to bf16, shared by the quantized kernels
// (quant_matmul.cu: weights; paged_attention.cu: the int8 / int4 KV pool).
// Every int4 or int8 value is exact in bf16.
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

}  // namespace dst
