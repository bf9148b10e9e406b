// One flash-attention tile engine shared by kernel B, the paged chunk-past
// partials and their int modes (paged_attention.cu), and kernel C, the seeded
// chunk-self flash (flash_attention.cu). Kernels A (paged_decode.cu), D
// (flash_forward.cu) and I (paged_tile.cu) have register-resident kernels of
// their own.
//
// A CTA owns BM = 64 query rows of ONE kv head group and walks a column range
// in BN = 64-wide tiles with an fp32 online softmax:
//   S = Q K^T          wmma bf16 16x16x16, fp32 accumulate, into shared memory
//   m, l, P            one warp per 16 rows, masked p = 0 (never exp(0) garbage)
//   O = O * corr + P V wmma, O kept in shared memory as fp32
// Every K/V row is addressed individually through the Mode (paged block-table
// lookup or a dense stride), so tiles need no alignment to pool blocks and any
// block size works. Rows and columns past the valid range load as zeros.
//
// A Mode supplies:
//   setup()               per-CTA scalars from blockIdx
//   rows()                query rows this CTA owns (<= BM; <= 0: nothing to do)
//   q_row(r)              pointer to query row r (head_dim bf16 values)
//   col_lo(), col_hi()    column range to walk, [lo, hi)
//   k_row(c), v_row(c)    pointers to key/value column c
//   keep(r, c)            mask
//   seed_m/l(r), seed_acc(r, j)   initial online-softmax state
//   finish(r, O_row, m, l)        epilogue for row r
// and, for a quantized KV pool (paged_attention.cu), the optional traits
//   kKvBits = 8 | 4       load_kv<HD, RAW_K>(Ks, Vs, ksc, vsc, c0, nc) fills the
//                         K/V tiles (int -> bf16) and the columns' k/v scales;
//                         a score is scaled by its column's k scale, p by its
//                         v scale before P V (l sums the unscaled p)
//   kIntScore = true      the int8 q-hat and int8 K stay int8 (load_q8): S is
//                         an integer product (mma.sync s8 -> s32), dequantized
//                         as s_int * (q_scale[row] * scale) * k_scale[col]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace dst {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int NTHREADS = 128;  // 4 warps, 16 query rows each
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Smem {
  // padded leading dimensions: wmma needs ldm % 8 == 0 (16-bit) / % 4 (fp32)
  // and 32-byte aligned tile pointers; every region is a multiple of 128 B
  static constexpr int QLD = HD + 8;
  static constexpr int KLD = HD + 8;
  static constexpr int SLD = BN + 4;
  static constexpr int PLD = BN + 8;
  static constexpr int OLD = HD + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BM) * QLD * 2;
  static constexpr size_t v_off = k_off + size_t(BN) * KLD * 2;
  static constexpr size_t s_off = v_off + size_t(BN) * KLD * 2;
  static constexpr size_t p_off = s_off + size_t(BM) * SLD * 4;
  static constexpr size_t o_off = p_off + size_t(BM) * PLD * 2;
  static constexpr size_t st_off = o_off + size_t(BM) * OLD * 4;
  static constexpr size_t bytes = st_off + 3 * BM * 4;
  // quantized pools only: k / v column scales and q row scales
  static constexpr size_t quant_bytes = bytes + (2 * BN + BM) * 4;
  static constexpr int Q8LD = HD + 16;  // int8 rows: 16-byte aligned chunks
};

template <class M, class = void>
struct KvBits {
  static constexpr int value = 16;
};
template <class M>
struct KvBits<M, std::void_t<decltype(M::kKvBits)>> {
  static constexpr int value = M::kKvBits;
};
template <class M, class = void>
struct IntScore {
  static constexpr bool value = false;
};
template <class M>
struct IntScore<M, std::void_t<decltype(M::kIntScore)>> {
  static constexpr bool value = M::kIntScore;
};

// mma.sync m16n8k32, s8 x s8 -> s32, accumulating into c
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// S = Q8 K8^T for one warp's 16 rows (row0 ..) and BN columns, int8 tiles with
// leading dim LD (bytes), written to S (fp32, exact: |S| < 2^24) with ld SLD.
// Fragment layout of m16n8k32 (.s8): lane = 4 g + t; A regs hold rows g and
// g + 8, bytes 4t .. 4t + 3 (+16); B regs column g, bytes 4t .. (+16); C rows
// g, g + 8, columns 2t, 2t + 1.
template <int HD, int LD, int SLD>
__device__ __forceinline__ void int8_scores(const int8_t* Q8, const int8_t* K8, float* S,
                                            int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  int c[BN / 8][4];
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0;
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 32) {
    const int8_t* qa = Q8 + (row0 + g) * LD + k0 + 4 * t;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 16);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 16);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int8_t* kb = K8 + (n * 8 + g) * LD + k0 + 4 * t;
      mma_s8(c[n], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(kb),
             *reinterpret_cast<const uint32_t*>(kb + 16));
    }
  }
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    float* s0 = S + (row0 + g) * SLD + n * 8 + 2 * t;
    s0[0] = float(c[n][0]);
    s0[1] = float(c[n][1]);
    s0[8 * SLD] = float(c[n][2]);
    s0[8 * SLD + 1] = float(c[n][3]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 64 rows x HD bf16 into shared memory with 16-byte vector loads; rows >= n
// and null row pointers are zero-filled (a zero V row times p = 0 stays 0,
// where stale shared memory could hold NaN bits).
template <int HD, class RowPtr>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, int n, RowPtr row_ptr) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
      const bf16* p = row_ptr(r);
      if (p != nullptr) val = reinterpret_cast<const uint4*>(p)[c];
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

template <int HD, class Mode>
__global__ void __launch_bounds__(NTHREADS) flash_tile_kernel(const Mode mode_in, float scale) {
  using namespace nvcuda;
  using SM = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v_off);
  float* Ss = reinterpret_cast<float*>(smem + SM::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::p_off);
  float* Os = reinterpret_cast<float*>(smem + SM::o_off);
  float* m_s = reinterpret_cast<float*>(smem + SM::st_off);
  float* l_s = m_s + BM;
  float* c_s = l_s + BM;

  constexpr int KVB = KvBits<Mode>::value;  // 16: bf16 pool
  constexpr bool INTS = IntScore<Mode>::value;
  float* ksc = reinterpret_cast<float*>(smem + SM::bytes);  // KVB != 16 only
  float* vsc = ksc + BN;
  float* qsc = vsc + BN;

  Mode md = mode_in;
  md.setup();
  const int nrows = md.rows();
  if (nrows <= 0) return;  // uniform across the CTA
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if constexpr (INTS) {
    md.template load_q8<HD>(reinterpret_cast<int8_t*>(Qs), qsc, nrows);
  } else {
    load_rows<HD>(Qs, SM::QLD, nrows, [&](int r) { return md.q_row(r); });
  }
  for (int i = threadIdx.x; i < BM * HD; i += NTHREADS) {
    const int r = i / HD, j = i % HD;
    Os[r * SM::OLD + j] = r < nrows ? md.seed_acc(r, j) : 0.f;
  }
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    m_s[r] = r < nrows ? md.seed_m(r) : NEG_INF;
    l_s[r] = r < nrows ? md.seed_l(r) : 0.f;
  }
  __syncthreads();

  const int c_lo = md.col_lo(), c_hi = md.col_hi();
  for (int c0 = c_lo; c0 < c_hi; c0 += BN) {
    const int nc = min(BN, c_hi - c0);
    if constexpr (KVB == 16) {
      load_rows<HD>(Ks, SM::KLD, nc, [&](int r) { return md.k_row(c0 + r); });
      load_rows<HD>(Vs, SM::KLD, nc, [&](int r) { return md.v_row(c0 + r); });
    } else {
      md.template load_kv<HD, INTS>(Ks, Vs, ksc, vsc, c0, nc);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    if constexpr (INTS) {
      int8_scores<HD, SM::Q8LD, SM::SLD>(reinterpret_cast<const int8_t*>(Qs),
                                         reinterpret_cast<const int8_t*>(Ks), Ss, warp * 16,
                                         lane);
    } else {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int k0 = 0; k0 < HD; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * SM::QLD + k0, SM::QLD);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Ks + j * 16 * SM::KLD + k0, SM::KLD);
          wmma::mma_sync(sacc[j], a, b, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * SM::SLD + j * 16, sacc[j], SM::SLD,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int ca = lane, cb = lane + 32;
      const bool live = r < nrows;
      const bool ka = live && ca < nc && md.keep(r, c0 + ca);
      const bool kb = live && cb < nc && md.keep(r, c0 + cb);
      auto score = [&](int c) {
        if constexpr (INTS) {
          return (Ss[r * SM::SLD + c] * (qsc[r] * scale)) * ksc[c];
        } else if constexpr (KVB != 16) {
          return (Ss[r * SM::SLD + c] * scale) * ksc[c];
        } else {
          return Ss[r * SM::SLD + c] * scale;
        }
      };
      const float va = ka ? score(ca) : NEG_INF;
      const float vb = kb ? score(cb) : NEG_INF;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(va, vb)));
      const float pa = ka ? expf(va - m_new) : 0.f;
      const float pb = kb ? expf(vb - m_new) : 0.f;
      const float psum = warp_sum(pa + pb);
      if constexpr (KVB != 16) {
        Ps[r * SM::PLD + ca] = __float2bfloat16(pa * vsc[ca]);
        Ps[r * SM::PLD + cb] = __float2bfloat16(pb * vsc[cb]);
      } else {
        Ps[r * SM::PLD + ca] = __float2bfloat16(pa);
        Ps[r * SM::PLD + cb] = __float2bfloat16(pb);
      }
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
        c_s[r] = corr;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = warp * 16 + i / HD, j = i % HD;
      Os[r * SM::OLD + j] *= c_s[r];
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* optr = Os + warp * 16 * SM::OLD + j * 16;
      wmma::load_matrix_sync(o, optr, SM::OLD, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < BN; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + warp * 16 * SM::PLD + k0, SM::PLD);
        wmma::load_matrix_sync(b, Vs + k0 * SM::KLD + j * 16, SM::KLD);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(optr, o, SM::OLD, wmma::mem_row_major);
    }
    __syncthreads();  // K/V/S buffers are rewritten by the next tile
  }

  for (int r = warp; r < nrows; r += NTHREADS / 32) {
    md.finish(r, Os + r * SM::OLD, m_s[r], l_s[r], lane);
  }
}

// Launch with the dynamic shared memory the tile needs; returns the launch's
// cudaError_t (0 on success). The kernel never synchronises.
template <int HD, class Mode>
int launch_tiles(const Mode& md, dim3 grid, float scale, cudaStream_t stream) {
  auto kern = flash_tile_kernel<HD, Mode>;
  const size_t bytes = KvBits<Mode>::value == 16 ? Smem<HD>::bytes : Smem<HD>::quant_bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, NTHREADS, bytes, stream>>>(md, scale);
  return static_cast<int>(cudaGetLastError());
}

// head_dim dispatch: the tile engine is instantiated for 64, 96, 128 and 256
// (the wrappers refuse any other head dim before a launch). Its loops take a
// row as HD / 8 sixteen-byte chunks (12 at d = 96) with no power-of-two
// assumption; at d = 256 the tile takes 195328 bytes (196096 for an int
// pool), one CTA an SM.
template <class Mode>
int launch_any_hd(const Mode& md, int hd, dim3 grid, float scale, cudaStream_t stream) {
  if (hd == 128) return launch_tiles<128>(md, grid, scale, stream);
  if (hd == 64) return launch_tiles<64>(md, grid, scale, stream);
  if (hd == 96) return launch_tiles<96>(md, grid, scale, stream);
  if (hd == 256) return launch_tiles<256>(md, grid, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dst
