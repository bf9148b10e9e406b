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
// groups in ascending order. The weights are never scaled before the product.
// int4: byte row r of a group holds rows r (low nibble) and r + group/2 (high
// nibble), the in-group de-interleave of quantize_matmul_weight; each kernel
// unpacks a run of byte rows into two runs of weight rows and reads the
// matching two column runs of x.
//
// Two kernels, by the row count B:
//
// qmm_rows_kernel, B <= 16 (decode). Bound: the packed weight bytes -- 2 B
// FLOPs per weight byte (int8) or 4 (int4), far below the ~295 FLOP/byte
// ridge -- so weight bytes / 3.35 TB/s. Reaching it takes ~25 KB of weight
// bytes in flight an SM (3.35 TB/s x ~1 us / 132) and few instructions a
// byte, so:
//   * the product is transposed, out^T = W^T x^T, on mma.sync m16n8k16:
//     sixteen weight columns are the A operand's rows and the B <= 8 (or
//     16) rows of x one (or two) n8 operands, so at B = 6 six of eight
//     product columns work, not six of sixteen. An A fragment of W^T holds,
//     for each column, two k-adjacent weights: the pairs an ldmatrix.trans
//     of the packed bytes hands each thread, which frag_int8 / frag_int4
//     turn into bf16 exactly (A row g of a 16-column window is column 2g,
//     row g + 8 column 2g + 1). No bf16 tile is written to shared memory;
//   * a CTA owns RN = 128 columns (128-byte segments of each packed row)
//     and splits its share of the contraction over its RWARPS warps, each
//     a contiguous run of whole groups: every warp streams its own rows
//     through its own RSTAGES-deep ring of cp.async.cg copies (RB packed
//     rows, their x columns, and at a group's last stage its scales), run
//     by one FULL mbarrier a slot. A warp refills only a slot it has read
//     itself, so no EMPTY barrier and no CTA-wide barrier stop it; x rows
//     past B arrive as zeros (the copy's src-size);
//   * per group, a fresh fp32 sum (mma_bf16_zero), then acc += sum x
//     scale[g, col] in registers, groups in ascending order; at the end the
//     warps' sums are added in shared memory, in warp order;
//   * a product too narrow to fill the card splits its groups over grid.z
//     (ops/quant_matmul.py::qmm_splits). Each split writes its fp32 partial;
//     the last CTA of a column tile to arrive (an atomic ticket, reset by
//     that CTA for the next launch) adds them in split order and writes
//     the bf16 output: one launch a call, the same bits every launch.
//
// qmm_tile_kernel, 16 < B <= 256 (chunk steps of prefill and mixed batches).
// Bound at B = 256 on w_gateup (D = 4096, F = 28672): operations, 60.1 GFLOP
// -> 0.0608 ms at 989 TFLOP/s; its weights are 117 / 58.7 MB (int8 / int4)
// -> 0.035 / 0.018 ms at 3.35 TB/s. That peak needs wgmma (this kernel runs
// mma.sync), and every column tile re-reads its x rows from L2, so the
// design keeps as little as possible between the tensor cores and the data:
//   * a CTA owns TM x TN = 128 x 128 outputs with 8 warps, each a 64 x 32
//     sub-tile of fp32 accumulators in registers; products by mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate), x fragments by ldmatrix. At B =
//     256 each weight tile is read by the two CTAs of its column tile,
//     launched side by side (grid.x), so the second read comes from L2;
//   * x, the packed weight bytes and the group's scales travel through a
//     STAGES-deep ring of 16-byte cp.async.cg copies, TK weight rows a
//     stage, rows of x past B zero-filled by the copy's src-size. The bytes
//     stay bytes in shared memory, 1/2 (int8) or 1/4 (int4) of a bf16 tile;
//   * the bytes become bf16 straight in B fragments, in registers: an
//     ldmatrix.trans of bytes hands each thread two k-adjacent bytes of two
//     adjacent columns, which a few bit operations turn into the bf16x2
//     words of an even-column and an odd-column n8 tile, exactly (see
//     frag_int8). No bf16 tile is written to shared memory and read back:
//     the two warps sharing a column range each convert it, which costs
//     less than that round trip did;
//   * mbarriers run the ring: copies land on a stage's FULL barrier, warps
//     arrive on its EMPTY barrier when their products are done, and no
//     CTA-wide barrier stops every warp each stage;
//   * per-group scaling in registers: each thread keeps its fragments' sum
//     for the current group and, at the group's end, adds sum * scale[g, col]
//     (its columns from the mma layout; the scales came in with the ring) to
//     its running accumulators. No shared-memory round trip;
//   * a product too narrow to fill one wave of CTAs (one CTA an SM at B = 256:
//     wo and w_down) splits its groups over grid.z, as many splits as keep
//     the grid within one wave (ops/quant_matmul.py::qmm_splits).
// Its splits write fp32 partials and split_sum_kernel adds them in split
// order: no atomics, so two launches on the same inputs give the same bits.
// Not yet: wgmma and TMA (one multicast x tile for a cluster of column
// tiles would halve the x reads), and a persistent grid (w_gateup at B = 256
// is 3.4 waves of CTAs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int_unpack.cuh"

namespace dq {

using bf16 = __nv_bfloat16;
using dst::pack_bf16x2;

// qmm_rows_kernel (B <= 16)
constexpr int RN = 128;        // output columns per CTA: 128-byte segments of each packed row
constexpr int RWARPS = 4;      // warps per CTA, each a contiguous run of the split's groups
constexpr int RB = 32;         // packed rows a stage
constexpr int RSTAGES = 4;     // depth of each warp's cp.async ring

// qmm_tile_kernel (16 < B <= 256)
constexpr int TM = 128;         // rows of x per CTA
constexpr int TN = 128;         // output columns per CTA
constexpr int TK = 128;         // weight rows per stage
constexpr int STAGES = 3;       // depth of the cp.async ring
constexpr int TWARPS = 8;       // 2 x 4 warps of 64 rows x 32 columns

// ---- primitives -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// mbarriers in shared memory (addresses from smem_u32)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival once every cp.async this thread issued before has landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
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

// c = a b (a zero accumulator in)
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, unrolled at compile time
template <typename Fn, int... I>
__device__ __forceinline__ void unroll_seq(Fn&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename Fn>
__device__ __forceinline__ void unroll(Fn&& f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

// Fragments straight from the packed bytes (frag_int8 / frag_int4 of
// int_unpack.cuh): qmm_tile_kernel's B fragments, qmm_rows_kernel's A
// fragments. ldmatrix.trans on bytes (an 8 x 8 matrix of b16 = 8 byte
// rows k of 16 columns) gives thread (g, t) one 32-bit word: bytes 0, 1 =
// row 2t at columns 2g, 2g + 1, and bytes 2, 3 = row 2t + 1 at the same
// columns. Bytes 0 and 2 make the B fragment word of column 2g, bytes 1 and
// 3 that of column 2g + 1: one matrix feeds two n8 tiles, the even and the
// odd columns of 16. An int4 byte holds two rows (low nibble: row kb, high:
// kb + group/2): frag_int4's lo and hi.
using dst::frag_int4;
using dst::frag_int8;

// x's B fragments of rows [0, 8) (one n8 tile) from a bf16 tile: lanes 0-15
// address the two 8 x 8 matrices, k xk .. +7 and xk + 8 .. +15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c = a b (ZERO) or c += a b
template <bool ZERO>
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  if constexpr (ZERO)
    mma_bf16_zero(c, a, b[0], b[1]);
  else
    mma_bf16(c, a, b[0], b[1]);
}

// ---- qmm_rows_kernel ------------------------------------------------------

// One warp's ring: RSTAGES slots of [RB packed rows of RN bytes | the x
// columns they multiply, NT x 8 rows | the group's RN scales]. Row pitches
// carry 16 bytes of skew so every ldmatrix phase hits 8 distinct bank quads.
// After its last stage a warp writes its sums over its own ring.
template <int BITS, int NT>
struct RowSmem {
  static constexpr int WP = RN + 16;                   // byte pitch of the packed rows
  static constexpr int XK = BITS == 8 ? RB : 2 * RB;   // x columns a stage
  static constexpr int XP = XK + 8;                    // bf16 pitch of the x tile
  static constexpr size_t X_OFF = size_t(RB) * WP;
  static constexpr size_t S_OFF = X_OFF + size_t(NT) * 8 * XP * 2;
  static constexpr size_t STAGE = S_OFF + size_t(RN) * 2;
  static constexpr size_t WARP = RSTAGES * STAGE;
  static constexpr size_t SUMS = size_t(RN / 16) * NT * 4 * 32 * 4;  // a warp's fp32 sums
  static_assert(SUMS <= WARP, "a warp's sums fit over its ring");
  static constexpr size_t BYTES = RWARPS * WARP;
};

// The split tickets, one a column tile: zero between launches (the last CTA
// of a tile resets its own). Launches must be ordered (one stream).
constexpr int MAX_TILES = 4096;
__device__ int row_tickets[MAX_TILES];

// out[B, F] (or split blockIdx.z's fp32 partial) for B <= 8 NT rows; see the
// file's note. Thread (g, t) = lane (4 g + t) holds, of m tile j (columns
// 16 j .. +15 of the CTA's) and n tile n, c[0], c[1] = column 16 j + 2 g at
// rows 8 n + 2 t, + 1 and c[2], c[3] = column 16 j + 2 g + 1 at the same rows.
template <int BITS, int NT>
__global__ void __launch_bounds__(RWARPS * 32, 2)
    qmm_rows_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const bf16* __restrict__ scales, bf16* __restrict__ out,
                    float* __restrict__ work, int B, int D, int F, int G, int per) {
  using SM = RowSmem<BITS, NT>;
  constexpr int WP = SM::WP, XK = SM::XK, XP = SM::XP, MT = RN / 16;
  // 16-byte pieces a lane copies a stage: packed piece column lane % 8 of
  // rows lane / 8 + 4 i (i < RB / 4); x pieces lane + 32 i (i < XN) of the
  // NT x 8 rows of XC pieces
  constexpr int XC = XK / 8, XN = NT * 8 * XC / 32;
  static_assert(RN == 128 && RB % 16 == 0 && NT * 8 * XC % 32 == 0, "whole pieces a lane");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[RWARPS * RSTAGES];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * RN;
  const int g_lo = blockIdx.z * per, ng = max(0, min(G, g_lo + per) - g_lo);
  const int group = D / G, rows = BITS == 8 ? group : group / 2;  // packed rows a group
  const int spg = rows / RB;                                       // stages a group
  // this warp's groups [wg, wg_end): a contiguous share of the split's
  const int wg = g_lo + warp * ng / RWARPS, wg_end = g_lo + (warp + 1) * ng / RWARPS;
  const int nstages = (wg_end - wg) * spg;
  unsigned char* wsm = smem + warp * SM::WARP;
  const uint32_t ring = smem_u32(wsm), full0 = smem_u32(bars + warp * RSTAGES);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < RSTAGES; ++k) mbar_init(full0 + k * 8, 32);
  }
  __syncthreads();

  // The copies of stage t (part j of group gg): packed rows [j RB, +RB) of
  // the group; their x columns -- int8: [j RB, +RB) of the group; int4:
  // [j RB, +RB) (low nibbles) then [group/2 + j RB, +RB) (high nibbles).
  const int8_t* w_src = w + size_t(lane >> 3) * F + n0 + (lane & 7) * 16;
  const uint32_t w_dst = (lane >> 3) * WP + (lane & 7) * 16;
  size_t x_off[XN];
  uint32_t x_dst[XN];
  bool x_ok[XN];
#pragma unroll
  for (int i = 0; i < XN; ++i) {
    const int p = lane + 32 * i, r = p / XC, kk = (p % XC) * 8;
    x_ok[i] = r < B;
    x_off[i] = size_t(r) * D + (BITS == 8 || kk < RB ? kk : group / 2 + kk - RB);
    x_dst[i] = SM::X_OFF + (r * XP + kk) * 2;
  }
  int ig = wg, ij = 0;  // the next stage to issue: group and part
  auto issue = [&](int t) {
    if (t >= nstages) return;
    const int k = t % RSTAGES;
    const uint32_t st = ring + k * SM::STAGE;
    const int8_t* src = w_src + (size_t(ig) * rows + ij * RB) * F;
#pragma unroll
    for (int i = 0; i < RB / 4; ++i)
      cp_async16(st + w_dst + i * 4 * WP, src + size_t(4 * i) * F, 16);
    const size_t xcol = size_t(ig) * group + ij * RB;
#pragma unroll
    for (int i = 0; i < XN; ++i)
      cp_async16(st + x_dst[i], x_ok[i] ? x + x_off[i] + xcol : x, x_ok[i] ? 16 : 0);
    if (ij == spg - 1 && lane < RN / 8)
      cp_async16(st + SM::S_OFF + lane * 16, scales + size_t(ig) * F + n0 + lane * 8, 16);
    mbar_arrive_on_copies(full0 + k * 8);
    if (++ij == spg) ij = 0, ++ig;
  };

  float acc[MT][NT][4], gsum[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  // x's B fragments of the k step at x tile column xk
  auto load_x = [&](uint32_t xs, int xk, uint32_t(&b)[NT][2]) {
    if constexpr (NT == 1) {
      ldsm_x2(b[0], xs + ((lane & 7) * XP + xk + ((lane >> 3) & 1) * 8) * 2);
    } else {
      uint32_t r[4];
      ldsm_x4(r, xs + (((lane & 7) + ((lane >> 4) & 1) * 8) * XP + xk + ((lane >> 3) & 1) * 8) * 2);
      b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
    }
  };
  // One stage's products; FIRST: the group's first stage, whose first k
  // step starts each sum from zero (a template argument: no branch in the
  // unrolled body). Byte rows [16 kb, +16) of columns [32 h, +32) come in as
  // one ldmatrix.trans x4: matrices (rows +0, cols +0), (+8, +0), (+0, +16),
  // (+8, +16), whose words r[0] .. r[3] become the A fragments of m tiles
  // 2 h (from r[0], r[1]) and 2 h + 1 (r[2], r[3]).
  auto products = [&](uint32_t ws, auto first_c) {
    constexpr bool FIRST = decltype(first_c)::value;
    const uint32_t xs = ws + SM::X_OFF;
    unroll<RB / 16>([&](auto kb_c) {
      constexpr int kb = decltype(kb_c)::value;
      constexpr bool ZERO = FIRST && kb == 0;
      // int8: the k step's x columns [16 kb, +16); int4: the low nibbles'
      // [16 kb, +16), the high nibbles' [RB + 16 kb, +16)
      uint32_t bx[BITS == 8 ? 1 : 2][NT][2];
      load_x(xs, 16 * kb, bx[0]);
      if constexpr (BITS == 4) load_x(xs, RB + 16 * kb, bx[1]);
      unroll<RN / 32>([&](auto h_c) {
        constexpr int h = decltype(h_c)::value;
        uint32_t r[4];
        ldsm_x4_trans(r, ws + (16 * kb + ((lane >> 3) & 1) * 8 + (lane & 7)) * WP + h * 32 +
                             (lane >> 4) * 16);
        if constexpr (BITS == 8) {
          const uint2 f0 = frag_int8(r[0]), f1 = frag_int8(r[1]);
          const uint2 f2 = frag_int8(r[2]), f3 = frag_int8(r[3]);
          const uint32_t a0[4] = {f0.x, f0.y, f1.x, f1.y}, a1[4] = {f2.x, f2.y, f3.x, f3.y};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma_acc<ZERO>(gsum[2 * h][n], a0, bx[0][n]);
            mma_acc<ZERO>(gsum[2 * h + 1][n], a1, bx[0][n]);
          }
        } else {
          uint2 l0, h0, l1, h1, l2, h2, l3, h3;
          frag_int4(r[0], l0, h0);
          frag_int4(r[1], l1, h1);
          frag_int4(r[2], l2, h2);
          frag_int4(r[3], l3, h3);
          const uint32_t a0[4] = {l0.x, l0.y, l1.x, l1.y}, a1[4] = {l2.x, l2.y, l3.x, l3.y};
          const uint32_t b0[4] = {h0.x, h0.y, h1.x, h1.y}, b1[4] = {h2.x, h2.y, h3.x, h3.y};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma_acc<ZERO>(gsum[2 * h][n], a0, bx[0][n]);
            mma_acc<ZERO>(gsum[2 * h + 1][n], a1, bx[0][n]);
            mma_acc<false>(gsum[2 * h][n], b0, bx[1][n]);
            mma_acc<false>(gsum[2 * h + 1][n], b1, bx[1][n]);
          }
        }
      });
    });
  };

#pragma unroll
  for (int t = 0; t < RSTAGES - 1; ++t) issue(t);
  int cj = 0;  // part of the group the products are in
  for (int s = 0; s < nstages; ++s) {
    issue(s + RSTAGES - 1);  // into the slot read last iteration
    const int k = s % RSTAGES;
    mbar_wait(full0 + k * 8, (s / RSTAGES) & 1);  // stage s landed
    const uint32_t ws = ring + k * SM::STAGE;
    const bool first = cj == 0, last = ++cj == spg;
    if (last) cj = 0;
    if (first)
      products(ws, std::true_type{});
    else
      products(ws, std::false_type{});
    if (last) {  // the group ends: acc += its sum x its column scales
      const unsigned char* sc = wsm + k * SM::STAGE + SM::S_OFF + (lane >> 2) * 4;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(sc + j * 32);
        const float s0 = __low2float(s2), s1 = __high2float(s2);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[j][n][0] = fmaf(gsum[j][n][0], s0, acc[j][n][0]);
          acc[j][n][1] = fmaf(gsum[j][n][1], s0, acc[j][n][1]);
          acc[j][n][2] = fmaf(gsum[j][n][2], s1, acc[j][n][2]);
          acc[j][n][3] = fmaf(gsum[j][n][3], s1, acc[j][n][3]);
        }
      }
    }
    __syncwarp();  // every lane is done with slot k before it is refilled
  }

  // the warps' sums, added in warp order: warp w adds m tiles [w MT/RWARPS, +MT/RWARPS)
  float* sums = reinterpret_cast<float*>(wsm);
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[((j * NT + n) * 4 + e) * 32 + lane] = acc[j][n][e];
  __syncthreads();
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int jj = 0; jj < MT / RWARPS; ++jj) {
    const int j = warp * (MT / RWARPS) + jj;
    const int col = n0 + 16 * j + 2 * (lane >> 2);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0.f;
#pragma unroll
        for (int u = 0; u < RWARPS; ++u)
          v[e] += reinterpret_cast<const float*>(smem + u * SM::WARP)[((j * NT + n) * 4 + e) * 32 +
                                                                      lane];
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = 8 * n + 2 * (lane & 3) + rh;
        if (row >= B) continue;
        if (split)
          *reinterpret_cast<float2*>(work + (size_t(blockIdx.z) * B + row) * F + col) =
              make_float2(v[rh], v[2 + rh]);
        else
          *reinterpret_cast<uint32_t*>(out + size_t(row) * F + col) = pack_bf16x2(v[rh], v[2 + rh]);
      }
    }
  }
  if (!split) return;

  // the ticket: the last split of this column tile to finish adds them all
  __threadfence();  // this thread's partial, before the ticket
  __syncthreads();
  if (tid == 0) {
    int* ticket = row_tickets + blockIdx.x;
    const bool last = atomicAdd(ticket, 1) == int(gridDim.z) - 1;
    if (last) *ticket = 0;  // every split has taken its ticket: ready for the next launch
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t stride = size_t(B) * F;
  for (int i = tid; i < B * RN; i += RWARPS * 32) {
    const size_t o = size_t(i / RN) * F + n0 + i % RN;
    float s = 0.f;
    for (int z = 0; z < int(gridDim.z); ++z) s += __ldcg(work + z * stride + o);
    out[o] = __float2bfloat16(s);
  }
}

// ---- qmm_tile_kernel ------------------------------------------------------

// Shared memory: a STAGES-deep ring of slots [x tile | packed weight bytes |
// the group's scales]. Row pitches carry 16 bytes of skew so every ldmatrix
// phase hits 8 distinct bank quads.
template <int BITS>
struct TileSmem {
  static constexpr int XP = TK + 8;                        // bf16 pitch of the x tile
  static constexpr int WP = TN + 16;                       // byte pitch of the packed bytes
  static constexpr int WROWS = BITS == 8 ? TK : TK / 2;    // packed byte rows a stage
  static constexpr size_t W_OFF = size_t(TM) * XP * 2;
  static constexpr size_t S_OFF = W_OFF + size_t(WROWS) * WP;
  static constexpr size_t STAGE = S_OFF + size_t(TN) * 2;
  static constexpr size_t BYTES = STAGES * STAGE;
};

template <int BITS>
__global__ void __launch_bounds__(TWARPS * 32, 1)
    qmm_tile_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const bf16* __restrict__ scales, bf16* __restrict__ out,
                    float* __restrict__ work, int B, int D, int F, int G, int per) {
  using SM = TileSmem<BITS>;
  constexpr int NT = TWARPS * 32, XP = SM::XP, WP = SM::WP, WROWS = SM::WROWS;
  // 16-byte pieces a thread copies each stage: thread t takes piece column
  // t % XC of x rows t / XC + (NT / XC) i (i < XN), and piece column t % WC
  // of byte rows t / WC + (NT / WC) i (i < WN)
  constexpr int XC = TK / 8, WC = TN / 16, XR = NT / XC, WR = NT / WC;
  constexpr int XN = TM / XR, WN = WROWS / WR;
  static_assert(NT % XC == 0 && NT % WC == 0 && TM % XR == 0 && WROWS % WR == 0,
                "whole rows of 16-byte pieces a pass");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;  // rows 64 wm .. +64, columns 32 wn .. +32
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int g_lo = blockIdx.z * per, g_hi = min(G, g_lo + per);
  const int group = D / G, spg = group / TK;  // stages a group
  const int nstages = max(0, g_hi - g_lo) * spg;

  // Stage t is part j of group g (t = (g - g_lo) spg + j): weight rows
  // [j TK, +TK) of the group (int8), or the byte rows [j TK/2, +TK/2) whose
  // nibbles are weight rows [j TK/2, +TK/2) and [group/2 + j TK/2, +TK/2);
  // x tile columns [0, TK/2) pair with the low nibbles, [TK/2, TK) with the
  // high. Byte rows (and int8's x columns) advance with the absolute stage.
  const int xr = tid / XC, xc = tid % XC, wr = tid / WC, wc = tid % WC;
  const bf16* x_src =
      x + size_t(m0 + xr) * D +
      (BITS == 8 ? xc * 8 : (xc < XC / 2 ? xc * 8 : group / 2 + (xc - XC / 2) * 8));
  const int8_t* w_src = w + size_t(wr) * F + n0 + wc * 16;
  const uint32_t x_dst = (xr * XP + xc * 8) * 2, w_dst = SM::W_OFF + wr * WP + wc * 16;
  const int x_rows = B - m0 - xr;  // piece i's row is valid when XR i < x_rows
  int ig = g_lo, ij = 0;           // the next stage to issue: group and part
  // The ring's mbarriers: FULL(k) completes when every thread's copies of
  // the stage in slot k have landed, EMPTY(k) when every warp is done with
  // its products from slot k. Copies run STAGES - 2 stages ahead of the
  // products, into the slot of the stage two back: a warp waits for the
  // data it reads and for every warp's products of two stages back, so
  // warps may drift a stage apart (a CTA-wide barrier each stage would make
  // every warp wait for the slowest).
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + STAGES * 8;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(full0 + k * 8, NT);
      mbar_init(empty0 + k * 8, TWARPS);
    }
  }
  __syncthreads();
  // stage t into slot t % STAGES, once the products of stage t - STAGES are done
  auto issue = [&](int t) {
    if (t < nstages) {
      const int k = t % STAGES;
      if (t >= STAGES) mbar_wait(empty0 + k * 8, (t / STAGES - 1) & 1);
      const uint32_t st = ring + k * SM::STAGE;
      const size_t a = size_t(ig) * spg + ij;  // absolute stage
      const size_t col = BITS == 8 ? a * TK : (a + size_t(ig) * spg) * (TK / 2);
#pragma unroll
      for (int i = 0; i < XN; ++i) {
        const bool ok = XR * i < x_rows;
        cp_async16(st + x_dst + i * XR * XP * 2, ok ? x_src + i * XR * size_t(D) + col : x,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < WN; ++i)
        cp_async16(st + w_dst + i * WR * WP, w_src + (a * WROWS + i * WR) * F, 16);
      if (tid < TN / 8)
        cp_async16(st + SM::S_OFF + tid * 16, scales + size_t(ig) * F + n0 + tid * 8, 16);
      mbar_arrive_on_copies(full0 + k * 8);
      if (++ij == spg) ij = 0, ++ig;
    }
  };

  // [m tile][n tile][fragment]: the running sum, and the current group's
  // product. n tile 2 h + o holds columns 32 wn + 16 h + 2 n + o (n < 8): its
  // fragment column 2t + e is column 16 h + 4t + 2e + o.
  float acc[4][4][4], gsum[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  static_assert(STAGES >= 3, "a slot being filled, one being read, one for drift");
#pragma unroll
  for (int t = 0; t < STAGES - 2; ++t) issue(t);
  int cj = 0;  // part of the group the products are in
  for (int s = 0; s < nstages; ++s) {
    issue(s + STAGES - 2);
    const int k = s % STAGES;
    mbar_wait(full0 + k * 8, (s / STAGES) & 1);  // stage s landed
    const uint32_t xs = ring + k * SM::STAGE, ws = xs + SM::W_OFF;
    const bool first = cj == 0, last = ++cj == spg;
    if (last) cj = 0;
    // the warp's 32 columns x 16 byte rows from kb: matrices (rows +0, cols
    // +0), (rows +8, cols +0), (rows +0, cols +16), (rows +8, cols +16)
    auto load_bytes = [&](int kb, uint32_t(&r)[4]) {
      ldsm_x4_trans(r, ws + (kb + ((lane >> 3) & 1) * 8 + (lane & 7)) * WP + wn * 32 +
                           (lane >> 4) * 16);
    };
    // The stage's products; FIRST: the group's first stage, whose first k
    // step starts from zero (a template argument, so the unrolled body has
    // no branch). Each k step's bytes are loaded one step ahead.
    auto products = [&](auto first_stage) {
      constexpr bool FIRST = decltype(first_stage)::value;
      // k step kk: 16 weight rows as B fragments of the warp's four n tiles
      auto mma_step = [&](auto kk_c, const uint32_t(&b)[4][2]) {
        constexpr int kk = decltype(kk_c)::value;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldsm_x4(a,
                  xs + ((wm * 64 + mt * 16 + (lane & 15)) * XP + kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (FIRST && kk == 0)
              mma_bf16_zero(gsum[mt][nt], a, b[nt][0], b[nt][1]);
            else
              mma_bf16(gsum[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
      };
      uint32_t r[2][4];
      load_bytes(0, r[0]);
      if constexpr (BITS == 8) {
        auto step = [&](auto kk_c) {
          constexpr int kk = decltype(kk_c)::value;
          if constexpr (kk + 1 < TK / 16) load_bytes((kk + 1) * 16, r[(kk + 1) & 1]);
          uint32_t b[4][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 k0 = frag_int8(r[kk & 1][2 * h]), k8 = frag_int8(r[kk & 1][2 * h + 1]);
            b[2 * h][0] = k0.x, b[2 * h][1] = k8.x;          // even columns
            b[2 * h + 1][0] = k0.y, b[2 * h + 1][1] = k8.y;  // odd columns
          }
          mma_step(kk_c, b);
        };
        unroll<TK / 16>(step);
      } else {
        // byte rows [16 kb, +16) hold the weight rows of k steps kb (low
        // nibbles) and kb + TK/32 (high nibbles)
        auto step = [&](auto kb_c) {
          constexpr int kb = decltype(kb_c)::value;
          if constexpr (kb + 1 < TK / 32) load_bytes((kb + 1) * 16, r[(kb + 1) & 1]);
          uint32_t lo[4][2], hi[4][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint2 l0, h0, l8, h8;
            frag_int4(r[kb & 1][2 * h], l0, h0);
            frag_int4(r[kb & 1][2 * h + 1], l8, h8);
            lo[2 * h][0] = l0.x, lo[2 * h][1] = l8.x, lo[2 * h + 1][0] = l0.y,
                      lo[2 * h + 1][1] = l8.y;
            hi[2 * h][0] = h0.x, hi[2 * h][1] = h8.x, hi[2 * h + 1][0] = h0.y,
                      hi[2 * h + 1][1] = h8.y;
          }
          mma_step(kb_c, lo);
          mma_step(std::integral_constant<int, kb + TK / 32>{}, hi);
        };
        unroll<TK / 32>(step);
      }
    };
    if (first)
      products(std::true_type{});
    else
      products(std::false_type{});
    if (last) {  // the group ends: acc += its product x its column scales
      const unsigned char* sc = smem + (s % STAGES) * SM::STAGE + SM::S_OFF;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // columns 32 wn + 16 h + 4t .. +3: scale of n tile 2h + o, fragment
        // column e is sv[2e + o]
        const uint2 raw = *reinterpret_cast<const uint2*>(
            sc + (wn * 32 + h * 16 + 4 * (lane & 3)) * 2);
        const __nv_bfloat162 s01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 s23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        const float sv[4] = {__low2float(s01), __high2float(s01), __low2float(s23),
                             __high2float(s23)};
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][2 * h + o][e] =
                  fmaf(gsum[mt][2 * h + o][e], sv[2 * (e & 1) + o], acc[mt][2 * h + o][e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + k * 8);  // EMPTY(k): this warp is done with it
  }

  // each thread's outputs: rows g and g + 8 of each m16 tile, columns
  // 16 h + 4t .. +3 of the warp's 32 (n tiles 2h, 2h + 1, fragment columns 0, 1)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = m0 + wm * 64 + mt * 16 + (lane >> 2) + rh * 8;
      if (row >= B) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + wn * 32 + h * 16 + 4 * (lane & 3);
        const float v0 = acc[mt][2 * h][2 * rh], v1 = acc[mt][2 * h + 1][2 * rh];
        const float v2 = acc[mt][2 * h][2 * rh + 1], v3 = acc[mt][2 * h + 1][2 * rh + 1];
        if (work == nullptr)
          *reinterpret_cast<uint2*>(out + size_t(row) * F + col) =
              make_uint2(pack_bf16x2(v0, v1), pack_bf16x2(v2, v3));
        else
          *reinterpret_cast<float4*>(work + (size_t(blockIdx.z) * B + row) * F + col) =
              make_float4(v0, v1, v2, v3);
      }
    }
  }
}

// ---- launch ----------------------------------------------------------------

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

// qmm_tile_kernel on grid, then the split sum when there are splits
template <typename Kern>
int launch_split(Kern kern, size_t smem_bytes, dim3 grid, int threads, const bf16* x,
                 const int8_t* w, const bf16* s, bf16* out, float* work, int B, int D, int F,
                 int G, int splits, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per = (G + splits - 1) / splits;
  kern<<<grid, threads, smem_bytes, stream>>>(x, w, s, out, splits > 1 ? work : nullptr, B, D,
                                              F, G, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n = size_t(B) * F;
  const int blocks = static_cast<int>(n / 256 < 1024 ? (n + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(work, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// qmm_rows_kernel: one launch, its splits added by the kernel's last CTA of
// each column tile
template <int BITS, int NT>
int launch_rows(const bf16* x, const int8_t* w, const bf16* s, bf16* out, float* work, int B,
                int D, int F, int G, int splits, cudaStream_t stream) {
  using SM = RowSmem<BITS, NT>;
  if (splits > 1 && F / RN > MAX_TILES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(qmm_rows_kernel<BITS, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SM::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per = (G + splits - 1) / splits;
  qmm_rows_kernel<BITS, NT><<<dim3(F / RN, 1, splits), RWARPS * 32, SM::BYTES, stream>>>(
      x, w, s, out, splits > 1 ? work : nullptr, B, D, F, G, per);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_bits(const bf16* x, const int8_t* w, const bf16* s, bf16* out, float* work, int B,
                int D, int F, int G, int splits, cudaStream_t stream) {
  if (B <= 8) return launch_rows<BITS, 1>(x, w, s, out, work, B, D, F, G, splits, stream);
  if (B <= 16) return launch_rows<BITS, 2>(x, w, s, out, work, B, D, F, G, splits, stream);
  return launch_split(qmm_tile_kernel<BITS>, TileSmem<BITS>::BYTES,
                      dim3((B + TM - 1) / TM, F / TN, splits), TWARPS * 32, x, w, s, out, work,
                      B, D, F, G, splits, stream);
}

int launch(const void* x, const void* w, const void* s, void* out, float* work, int B, int D,
           int F, int G, int bits, int splits, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B > 256 || D % TK || F % TN || F % RN || G <= 0 || D % G || (D / G) % TK || splits < 1 ||
      (splits > 1 && work == nullptr) || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const bf16* sb = static_cast<const bf16*>(s);
  bf16* ob = static_cast<bf16*>(out);
  if (bits == 8) return launch_bits<8>(xb, wb, sb, ob, work, B, D, F, G, splits, stream);
  return launch_bits<4>(xb, wb, sb, ob, work, B, D, F, G, splits, stream);
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

// qmm_tile_kernel's dynamic shared memory in bytes, int4 and int8 (extern: a
// const has internal linkage otherwise).
extern const int dst_qmm_tile_smem_bytes[2] = {static_cast<int>(dq::TileSmem<4>::BYTES),
                                               static_cast<int>(dq::TileSmem<8>::BYTES)};

// qmm_rows_kernel's dynamic shared memory in bytes: int4 at B <= 8 and at
// B <= 16, then int8 at the same
extern const int dst_qmm_rows_smem_bytes[4] = {
    static_cast<int>(dq::RowSmem<4, 1>::BYTES), static_cast<int>(dq::RowSmem<4, 2>::BYTES),
    static_cast<int>(dq::RowSmem<8, 1>::BYTES), static_cast<int>(dq::RowSmem<8, 2>::BYTES)};

}  // extern "C"
