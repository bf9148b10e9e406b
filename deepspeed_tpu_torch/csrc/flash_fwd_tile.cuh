// The register-resident flash tile of kernel D (flash_forward.cu), shared
// with kernel I's prefill regime (paged_tile.cu), kernel B's chunk-past
// partials (paged_attention.cu) and kernel C's seeded chunk-self flash
// (flash_attention.cu): the tile shape, the softmax arithmetic spelled out,
// S = Q K^T of one warp's 16 rows over a 64-column tile, and the online
// softmax with O += P V. A kernel built on these walks its 64-column tiles in
// order from its first live column and gives the same bits as kernel D on
// the same rows and columns.
#pragma once

#include "flash_mma.cuh"

namespace dst {

constexpr int BN = 64;  // columns a tile
// WARPS warps of 16 query rows a CTA, MINB CTAs per SM for
// __launch_bounds__: the fastest shape without spills at d = 64 and d = 128
// (chip_smoke prints ptxas's registers and spill bytes)
constexpr int WARPS = 4, MINB = 2;
constexpr float FWD_NEG_INF = -1e30f;  // masked score, empty running max

// Shared memory: the K/V ring of STAGES tiles. Where Q's fragments stay in
// registers (Q_REGS, d <= 128), Q's tile lies in the ring's last stage,
// whose first tile is issued after every warp has taken its Q fragments;
// at d = 256 Q's tile follows the ring. The epilogue stages O in Q's tile
// once the ring is idle.
template <int HD>
struct FwdTiles {
  static constexpr bool Q_REGS = HD <= 128;
  static constexpr int STAGES = Q_REGS ? 3 : 2;  // K/V tiles in the ring
  // O's columns a CTA: at d = 256 two CTAs each compute the whole score and
  // take half of O (64 fp32 a thread, not 128)
  static constexpr int OSPLIT = Q_REGS ? 1 : 2;
  static constexpr int OC = HD / OSPLIT;
  static constexpr int BM = 16 * WARPS;  // query rows a CTA
  static constexpr int LD = HD + 8;      // bf16 row pitch: 16 bytes of skew
  static constexpr int Q_ELEMS = BM * LD;
  static constexpr int KV_ELEMS = BN * LD;  // one K or V tile
  static constexpr size_t BYTES =
      size_t(2 * STAGES * KV_ELEMS + (Q_REGS ? 0 : Q_ELEMS)) * sizeof(bf16);
  static_assert(Q_ELEMS <= 2 * KV_ELEMS, "Q fits one stage");
};

// The softmax arithmetic every kernel on this tile shares, spelled out so
// that the compiler cannot contract it differently in one of them: score =
// s * scale, p = expf(score - m), l = fma(l, corr, the tile's row sum).
__device__ __forceinline__ float score_of(float s, float scale) { return __fmul_rn(s, scale); }

__device__ __forceinline__ float p_of(float score, float m) { return expf(__fsub_rn(score, m)); }

// A row's sum over a 64-column tile in one fixed order (a butterfly over
// lanes holding columns c and c + 32): column bits b5, b4 and b3 (this
// thread's n8 tiles j), then b2 and b1 (across the quad), then b0.
// s[j][e0 + b0] holds column 8 j + 2 t + b0 of the row.
__device__ __forceinline__ float tile_row_sum(const float (&s)[BN / 8][4], int e0) {
  float z[2];
#pragma unroll
  for (int b0 = 0; b0 < 2; ++b0) {
    const int e = e0 + b0;
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = s[j][e] + s[j + 4][e];  // b5
    z[b0] = (x[0] + x[2]) + (x[1] + x[3]);                      // b4, b3
    z[b0] += __shfl_xor_sync(0xffffffffu, z[b0], 2);            // b2
    z[b0] += __shfl_xor_sync(0xffffffffu, z[b0], 1);            // b1
  }
  return z[0] + z[1];  // b0
}

// S = Q K^T for a warp's 16 rows and one 64-column tile (raw scores). Q's A
// fragment of k16 step kd: qf[kd] (QREG), else by ldmatrix from the warp's
// 16 rows of Q's shared tile, qs.
template <int HD, bool QREG>
__device__ __forceinline__ void tile_scores(const bf16* ks,
                                            const uint32_t (&qf)[QREG ? HD / 16 : 1][4],
                                            const bf16* qs, float (&s)[BN / 8][4], int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // Q from shared memory (d = 256): two k steps an iteration
  unrolled<HD / 16, QREG ? HD / 16 : 2>([&](int kd) {
    uint32_t qa[4];
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[e] = qf[kd][e];
    } else {
      ldsm_x4(qa, smem_u32(qs + (lane & 15) * LD + kd * 16 + (lane >> 4) * 8));
    }
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      // matrices: (cols np*16 .. +7, d kd*16 .. +7), (.., d +8), (cols +8, d), (cols +8, d +8)
      uint32_t kb[4];
      ldsm_x4(kb, smem_u32(ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kd * 16 +
                           ((lane >> 3) & 1) * 8));
      mma_bf16(s[2 * np], qa, kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  });
}

// The online softmax update of m / l / O from a tile's raw scores s, then
// O += P V for O's OC columns from col0. EDGE: the tile crosses the causal
// diagonal, the window's edge or c_hi for some of the warp's rows, and
// masked entries get score NEG_INF and p = 0.
template <int HD, int OC, bool EDGE>
__device__ __forceinline__ void tile_softmax_pv(const bf16* vs, float (&s)[BN / 8][4],
                                                float (&o)[OC / 8][4], float (&m)[2],
                                                float (&l)[2], int c0, int c_hi, int qp0,
                                                int causal, int window, float scale,
                                                int col0, int lane) {
  constexpr int LD = HD + 8;
  const int tq = lane & 3;
  auto keep = [&](int j, int e) {
    const int c = c0 + j * 8 + 2 * tq + (e & 1);
    const int qp = qp0 + (e >> 1) * 8;
    return c < c_hi && (!causal || qp >= c) && (window <= 0 || qp - c < window);
  };
  float mx[2] = {m[0], m[1]};  // any order of the max gives the same bits
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = !EDGE || keep(j, e) ? score_of(s[j][e], scale) : FWD_NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = !EDGE || keep(j, e) ? p_of(s[j][e], mx[e >> 1]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float psum = tile_row_sum(s, 2 * r);
    const float corr = expf(m[r] - mx[r]);  // 0 when m was empty, 1 when nothing new
    m[r] = mx[r];
    l[r] = __fmaf_rn(l[r], corr, psum);
#pragma unroll
    for (int n = 0; n < OC / 8; ++n) {
      o[n][2 * r] *= corr;
      o[n][2 * r + 1] *= corr;
    }
  }

#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < OC / 16; ++dn) {
      // matrices: (cols kk*16 .. +7, d dn*16 .. +7), (cols +8, d), (cols, d +8), (cols +8, d +8)
      uint32_t vb[4];
      ldsm_x4_trans(vb, smem_u32(vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                 col0 + dn * 16 + (lane >> 4) * 8));
      mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
}

}  // namespace dst
