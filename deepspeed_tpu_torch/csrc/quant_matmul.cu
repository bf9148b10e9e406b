// Fused dequantize-matmul (W8A16 / W4A16) on Hopper: kernels G and H of the
// quantized serving path.
//
// Replaces (deepspeed_tpu/ops/quant_matmul.py):
//   G  _qmm_kernel (:93) via quantized_matmul (:108): x [B, D] bf16 times the
//      dequantized int8 [D, F] or int4 [D/2, F] weight, per-group scales
//      [D/group, F] -> [B, F] bf16;
//   H  _qmm_stacked_kernel (:99) via _quantized_matmul_stacked (:161): the
//      same with the weight and its scales picked out of [L, ...] stacks by a
//      layer index -- the launcher offsets the pointers, nothing is copied.
//
// Arithmetic (the reference's _qmm_body :59): per group, one product of x
// with the EXACT integer weights (int -> bf16 is exact for |v| <= 128) into
// fp32, scaled by the group's column scales upcast to fp32, summed over
// groups. The weights are never scaled before the product.
//
// What bounds it on the card: at decode (B <= 16) the packed weight bytes --
// 2 B FLOPs per weight byte (int8) or 4 (int4), far below the ~295 FLOP/byte
// ridge -- so the floor is weight bytes / 3.35 TB/s. The design:
//   * a CTA owns a 64-column tile and a 16-row (B <= 16) or 64-row tile of x
//     and walks its groups in 128-row chunks: the chunk's packed weight tile
//     comes in with 16-byte loads, is unpacked to bf16 in shared memory, and
//     the four warps each take one wmma 16x16x16 product per 16 columns; the
//     next chunk's weight loads are issued before this chunk's products, so
//     they are in flight while the tensor cores work;
//   * after each group the fp32 product is scaled by the group's column
//     scales in registers and added to the running sum;
//   * a product too narrow to give every SM two CTAs (wo, w_down, wqkv at
//     decode) splits its groups over grid.z; each split writes fp32 partials
//     and a second kernel adds them in split order (deterministic);
//   * int4: byte row r of a group holds rows r (low nibble) and r + group/2
//     (high nibble), the in-group de-interleave of quantize_matmul_weight:
//     a 64-byte-row chunk unpacks into 128 weight rows, low nibbles to tile
//     rows [0, 64), high to [64, 128), and the x tile reads the matching two
//     column runs. Nibbles sign-extend by shifts on a signed int.
// What it does not do yet: TMA / cp.async staging, wgmma, or reuse of one
// unpacked weight tile across row tiles at B > 16 (each row tile re-reads the
// weights, from L2). Those are tuning work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "int_unpack.cuh"

namespace dq {

using bf16 = __nv_bfloat16;
using dst::pack_bf16x2;
using dst::unpack16;
constexpr int BN = 64;          // output columns per CTA
constexpr int KC = 128;         // weight rows per chunk
constexpr int NTHREADS = 128;   // 4 warps; warp w owns columns [16 w, 16 w + 16)
constexpr int XLD = KC + 8;     // padded bf16 leading dims: wmma needs ldm % 8 == 0
constexpr int WLD = BN + 8;     // and 32-byte aligned tile pointers

template <int MT>
struct Smem {
  static constexpr size_t x_off = 0;
  static constexpr size_t w_off = x_off + size_t(16 * MT) * XLD * 2;
  static constexpr size_t c_off = w_off + size_t(KC) * WLD * 2;
  static constexpr size_t bytes = c_off + size_t(4 * MT) * 256 * 4;
};

template <int BITS, int MT>
__global__ void __launch_bounds__(NTHREADS)
    qmm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               const bf16* __restrict__ scales, bf16* __restrict__ out,
               float* __restrict__ work, int B, int D, int F, int G, int per) {
  using namespace nvcuda;
  using SM = Smem<MT>;
  constexpr int BM = 16 * MT;
  // packed weight bytes of one chunk, and 16-byte loads per thread
  constexpr int WROWS = BITS == 8 ? KC : KC / 2;
  constexpr int WV = WROWS * BN / 16 / NTHREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + SM::x_off);
  bf16* Ws = reinterpret_cast<bf16*>(smem + SM::w_off);
  float* Cs = reinterpret_cast<float*>(smem + SM::c_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int g_lo = blockIdx.z * per, g_hi = min(G, g_lo + per);
  const int group = D / G, chunks = group / KC;
  // this lane's 8 fragment elements of each 16x16 tile: row er, columns
  // ec .. ec + 7 (read back through Cs, whose layout is row-major)
  const int er = lane / 2, ec = (lane % 2) * 8;
  const int col = n0 + warp * 16 + ec;
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;

  // first packed row (in W's row units) of chunk c of group g
  auto w_row0 = [&](int g, int c) { return g * (group * WROWS / KC) + c * WROWS; };
  uint4 wreg[WV];
  auto load_w = [&](int g, int c) {
    const int r0 = w_row0(g, c);
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int r = i / (BN / 16), cv = i % (BN / 16);
      wreg[j] = *reinterpret_cast<const uint4*>(w + size_t(r0 + r) * F + n0 + cv * 16);
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int r = i / (BN / 16), cv = i % (BN / 16);
      if (BITS == 8) {
        unpack16<0>(wreg[j], Ws + r * WLD + cv * 16);
      } else {
        unpack16<1>(wreg[j], Ws + r * WLD + cv * 16);
        unpack16<2>(wreg[j], Ws + (r + KC / 2) * WLD + cv * 16);
      }
    }
  };
  // x columns of tile row kk in chunk c of group g (see the int4 note above)
  auto load_x = [&](int g, int c) {
    for (int i = threadIdx.x; i < BM * (KC / 8); i += NTHREADS) {
      const int r = i / (KC / 8), kk = (i % (KC / 8)) * 8;
      int xc;
      if (BITS == 8) {
        xc = g * group + c * KC + kk;
      } else {
        xc = g * group + c * (KC / 2) + (kk < KC / 2 ? kk : group / 2 + kk - KC / 2);
      }
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < B) v = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * D + xc);
      *reinterpret_cast<uint4*>(Xs + r * XLD + kk) = v;
    }
  };

  if (g_lo < g_hi) load_w(g_lo, 0);
  for (int g = g_lo; g < g_hi; ++g) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) wmma::fill_fragment(cf[m], 0.f);
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();  // the previous chunk's products are done with Xs / Ws
      store_w();
      load_x(g, c);
      if (c + 1 < chunks) {
        load_w(g, c + 1);
      } else if (g + 1 < g_hi) {
        load_w(g + 1, 0);
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < KC; k0 += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Ws + k0 * WLD + warp * 16, WLD);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::load_matrix_sync(afr, Xs + m * 16 * XLD + k0, XLD);
          wmma::mma_sync(cf[m], afr, bfr, cf[m]);
        }
      }
    }
    // scale this group's products by its column scales, in fp32
    const uint4 sraw = *reinterpret_cast<const uint4*>(scales + size_t(g) * F + col);
    const bf16* sv = reinterpret_cast<const bf16*>(&sraw);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float* cs = Cs + (warp * MT + m) * 256;
      wmma::store_matrix_sync(cs, cf[m], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[m][e] += cs[er * 16 + ec + e] * __bfloat162float(sv[e]);
      __syncwarp();
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m * 16 + er;
    if (row >= B) continue;
    if (work == nullptr) {
      uint4 o;
      o.x = pack_bf16x2(acc[m][0], acc[m][1]); o.y = pack_bf16x2(acc[m][2], acc[m][3]);
      o.z = pack_bf16x2(acc[m][4], acc[m][5]); o.w = pack_bf16x2(acc[m][6], acc[m][7]);
      *reinterpret_cast<uint4*>(out + size_t(row) * F + col) = o;
    } else {
      float4* p = reinterpret_cast<float4*>(work + (size_t(blockIdx.z) * B + row) * F + col);
      p[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      p[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
}

// out = sum of the splits' fp32 partials, in split order, as bf16
__global__ void split_sum_kernel(const float* __restrict__ work, bf16* __restrict__ out,
                                 size_t n, int splits) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[z * n + i];
    out[i] = __float2bfloat16(s);
  }
}

template <int BITS, int MT>
int launch_mt(const bf16* x, const int8_t* w, const bf16* s, bf16* out, float* work, int B,
              int D, int F, int G, int splits, cudaStream_t stream) {
  auto kern = qmm_kernel<BITS, MT>;
  const size_t bytes = Smem<MT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per = (G + splits - 1) / splits;
  const dim3 grid(F / BN, (B + 16 * MT - 1) / (16 * MT), splits);
  kern<<<grid, NTHREADS, bytes, stream>>>(x, w, s, out, splits > 1 ? work : nullptr, B, D, F,
                                          G, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = size_t(B) * F;
  const int blocks = static_cast<int>(n / 256 < 1024 ? (n + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(work, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* w, const void* s, void* out, float* work, int B, int D,
           int F, int G, int bits, int splits, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > 256 || D % KC || F % 128 || G <= 0 || D % G || (D / G) % KC || splits < 1 ||
      (splits > 1 && work == nullptr) || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const bf16* sb = static_cast<const bf16*>(s);
  bf16* ob = static_cast<bf16*>(out);
  if (bits == 8)
    return B <= 16 ? launch_mt<8, 1>(xb, wb, sb, ob, work, B, D, F, G, splits, stream)
                   : launch_mt<8, 4>(xb, wb, sb, ob, work, B, D, F, G, splits, stream);
  return B <= 16 ? launch_mt<4, 1>(xb, wb, sb, ob, work, B, D, F, G, splits, stream)
                 : launch_mt<4, 4>(xb, wb, sb, ob, work, B, D, F, G, splits, stream);
}

}  // namespace dq

extern "C" {

// Kernel G. Returns the launch's cudaError_t (0 = launched).
int dst_qmm(const void* x, const void* w, const void* scales, void* out, float* work, int B,
            int D, int F, int G, int bits, int splits, void* stream) {
  return dq::launch(x, w, scales, out, work, B, D, F, G, bits, splits,
                    static_cast<cudaStream_t>(stream));
}

// Kernel H: w [L, D or D/2, F] and scales [L, G, F], layer `layer`.
int dst_qmm_stacked(const void* x, const void* w, const void* scales, void* out, float* work,
                    int B, int D, int F, int G, int bits, int splits, int layer, void* stream) {
  if (layer < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t wrows = bits == 4 ? size_t(D) / 2 : size_t(D);
  const int8_t* wl = static_cast<const int8_t*>(w) + size_t(layer) * wrows * F;
  const dq::bf16* sl = static_cast<const dq::bf16*>(scales) + size_t(layer) * G * F;
  return dq::launch(x, wl, sl, out, work, B, D, F, G, bits, splits,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
