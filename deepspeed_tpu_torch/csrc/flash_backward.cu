// Flash-attention backward on Hopper: kernels E (dq) and F (dk, dv) of the
// training path, register-resident.
//
// Replaces:
//   E  deepspeed_tpu/ops/flash_attention.py _bwd_dq_kernel (:173) via
//      _bwd_pallas (:249): dq of the causal/window GQA flash attention from
//      the forward's saved lse and delta = rowsum(dO * O) - dlse;
//   F  deepspeed_tpu/ops/flash_attention.py _bwd_dkv_kernel (:208) via
//      _bwd_pallas (:249), with the GQA group sum of :311-313 folded in: the
//      TPU writes per-query-head dk_h / dv_h [B, H, S, d] and sums each kv
//      head's group afterwards; here one CTA owns 64 kv rows of one kv head,
//      walks every query head of its group and writes [B, S, K, d] once --
//      no atomics and no intermediate buffer.
//
// Both recompute the scores from q, k and lse (FA2): with s = q k^T * scale
//   p  = exp(s - lse)         masked entries p = 0 (never exp(0) garbage)
//   dp = dO v^T,  ds = p * (dp - delta)
//   E: dq = scale * ds k      F: dv = p^T dO,  dk = scale * ds^T q
// p and ds are rounded to bf16 before their products, as the TPU kernels do;
// p is taken as exp2(s * scale * log2 e - lse * log2 e). Masking is
// start-aligned like the forward (kernel D): query row t sits at position
// t + rel against key column c; causal keeps t + rel >= c, a window keeps
// t + rel - c <= window - 1.
//
// What bounds it on the card: the products, 2 d FLOPs each per live (row,
// col) pair and query head -- three in E (s, dp, dq), four in F (s, dp, dv,
// dk) -- against 989 TFLOP/s bf16; at training widths (T = 2048, d = 64) the
// bytes of q, k, v, dO and the outputs are a few percent of that time. On
// mma.sync each warp also reads its B operands from shared memory by
// ldmatrix, one 16-byte row a lane for every two mma's, so shared memory
// bandwidth is the nearer limit. The design (FlashAttention-2's backward on
// mma.sync, the tiles of kernel D):
//   * a CTA is 4 warps of 16 rows: F owns 64 kv rows (the TRANSPOSED
//     products S^T = K Q^T, dP^T = V dO^T, so every product of a warp has the
//     warp's own kv rows as its M dimension), E 64 query rows;
//   * the rows a CTA owns are copied once and held as mma A fragments in
//     registers for the whole walk (E: Q and dO; F: K and V at d = 64, which
//     re-reads them from shared memory at d = 96 and 128, where they do not
//     fit), with their fp32 accumulators (F: dK and dV; E: dQ) and row
//     statistics (E: lse and delta of the thread's two rows); they are scaled
//     and written once, staged through the CTA's own rows for 16-byte stores;
//   * d = 256 keeps the same tiles with less in registers: each kernel
//     splits its accumulators' columns over two CTAs (grid x = 2 H for E,
//     2 K for F), each recomputing the whole S and dP (their sums run over
//     all of d) and accumulating 128 columns of dQ, or of dK and dV -- 5/3x
//     E's and 3/2x F's products, no atomics; E re-reads Q's and dO's
//     fragments from a shared tile of their own; S and dP are taken 16
//     columns at a time; both rings have two stages (E 202752, F 203776
//     bytes of shared memory: one CTA an SM);
//   * S and dP live in registers only: p and ds are computed from the
//     accumulators and packed into bf16 A fragments for dV += P^T dO, dK +=
//     dS^T Q (F) and dQ += dS K (E), whose B operands come by ldmatrix.trans;
//     at d = 96 and 128 a tile's columns are taken 32 at a time (16 at
//     d = 256), so that S and dP fit beside the accumulators;
//   * the streamed operands arrive through a cp.async ring, one barrier a
//     tile: E streams K/V tiles over its live column range (Q and dO lie in
//     the ring's last stage, as Q does in kernel D); F streams (Q, dO, lse,
//     delta) tiles over its live query rows of every query head of the group
//     as ONE flattened sequence, so the ring does not drain between heads;
//   * only tiles that cross the causal diagonal, the window's edge or a
//     ragged end take the masked body (a second instantiation of the tile
//     body); rows past the valid range load as zeros and only ever reach
//     their own unwritten output rows;
//   * grids launch the heaviest CTAs first: E reverses its query tiles, as
//     D; F's kv tile 0 sees every query row under a causal mask.
// No atomics: the sums run in a fixed order, and two launches on the same
// inputs give the same bits.
// Not yet: wgmma/TMA, and one fused kernel that shares s and dp between dq and
// dk/dv (it needs an fp32 dq buffer with atomics, and dq stops being
// deterministic).
#include "flash_mma.cuh"

namespace dst {

constexpr int BT = 64;  // rows of a tile: a CTA's own, and a streamed one's
// WARPS warps of 16 rows a CTA, MINB CTAs per SM for __launch_bounds__ (F
// at d = 128 and both kernels at d = 256 run one: their shared memory)
constexpr int WARPS = 4, NT = WARPS * 32, MINB = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdTiles {
  static constexpr int LD = HD + 8;       // bf16 row pitch: 16 bytes of skew
  static constexpr int TILE = BT * LD;    // elements of one [64, HD] tile
  static constexpr bool WIDE = HD > 128;  // d = 256
  static constexpr int STAGES = WIDE ? 2 : 3;      // tiles in a ring
  // columns of S and dP held at once (d = 256: 16, beside 128 accumulators)
  static constexpr int SUB = HD == 64 ? 64 : WIDE ? 16 : 32;
  // F holds K's and V's fragments in registers at d = 64; from d = 96 on it
  // re-reads them from shared memory each tile (its registers are full)
  static constexpr bool KV_REGS = HD == 64;
  // E holds Q's and dO's fragments in registers up to d = 128
  static constexpr bool QD_REGS = !WIDE;
  // accumulator columns a CTA (DSPLIT CTAs a row tile): E's dQ, F's dK, dV
  static constexpr int DCOLS = WIDE ? HD / 2 : HD;
  static constexpr int DSPLIT = HD / DCOLS;
  // E: a ring of (K, V) tile pairs; Q and dO lie in the last stage (QD_REGS)
  // or after the ring
  static constexpr size_t E_BYTES =
      size_t(QD_REGS ? STAGES : STAGES + 1) * 2 * TILE * sizeof(bf16);
  // F: its K and V tiles, then a ring of (Q, dO, lse, delta) stages
  static constexpr size_t F_STAGE = 2 * TILE * sizeof(bf16) + 2 * BT * sizeof(float);
  static constexpr size_t F_BYTES = 2 * TILE * sizeof(bf16) + STAGES * F_STAGE;
  static_assert(STAGES >= 2, "a ring");
  static_assert(F_STAGE % 128 == 0, "stages stay 128-byte aligned");
};

// F's K or V fragments (a placeholder where it re-reads them)
template <int HD>
using KvFrags = uint32_t[BwdTiles<HD>::KV_REGS ? HD / 16 : 1][4];

struct BwdArgs {
  const bf16* q;     // [B, T, H, hd]
  const bf16* k;     // [B, S, K, hd]
  const bf16* v;
  const bf16* dout;  // [B, T, H, hd]
  const float* lse;  // [B, H, T]
  const float* delta;
  bf16* dq;          // [B, T, H, hd]
  bf16* dk;          // [B, S, K, hd]
  bf16* dv;
  int B, T, S, H, K, causal, window, rel;
  float scale;

  __device__ bool keep(int t, int c) const {
    const int qp = t + rel;
    return (!causal || qp >= c) && (window <= 0 || qp - c <= window - 1);
  }
};

// s += A B^T for one k16 step kd: A the warp's 16 rows (fragment af), B the
// NC rows of a [*, HD] bf16 tile in shared memory (the col-major B operand).
template <int HD, int NC>
__device__ __forceinline__ void scores_step(float (&s)[NC / 8][4], const uint32_t (&af)[4],
                                            const bf16* rows, int kd, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int np = 0; np < NC / 16; ++np) {
    // matrices: (rows np*16 .. +7, d kd*16 .. +7), (.., d +8), (rows +8, d), (rows +8, d +8)
    uint32_t b[4];
    ldsm_x4(b, smem_u32(rows + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kd * 16 +
                        ((lane >> 3) & 1) * 8));
    mma_bf16(s[2 * np], af, b[0], b[1]);
    mma_bf16(s[2 * np + 1], af, b[2], b[3]);
  }
}

template <int HD, int NC>
__device__ __forceinline__ void scores(float (&s)[NC / 8][4], const uint32_t (&af)[HD / 16][4],
                                       const bf16* rows, int lane) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) scores_step<HD, NC>(s, af[kd], rows, kd, lane);
}

// The A fragment of k16 step kd of the warp's 16 rows of a [64, HD] tile.
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const bf16* tile, int warp, int kd,
                                       int lane) {
  ldsm_x4(f, smem_u32(tile + (warp * 16 + (lane & 15)) * (HD + 8) + kd * 16 + (lane >> 4) * 8));
}

// scores() with A the warp's rows of the [64, HD] tile `own`: its fragments
// af when HELD, else taken from shared memory a k16 step at a time.
template <int HD, int NC, bool HELD>
__device__ __forceinline__ void scores_of(float (&s)[NC / 8][4],
                                          const uint32_t (&af)[HELD ? HD / 16 : 1][4],
                                          const bf16* own, const bf16* rows, int warp, int lane) {
  if constexpr (HELD) {
    scores<HD, NC>(s, af, rows, lane);
  } else {
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // d = 256: two k steps an iteration
    unrolled<HD / 16, (HD > 128 ? 2 : HD / 16)>([&](int kd) {
      uint32_t f[4];
      a_frag<HD>(f, own, warp, kd, lane);
      scores_step<HD, NC>(s, f, rows, kd, lane);
    });
  }
}

// acc[16, NCOL] += A[16, 16] B[16, col0 .. col0 + NCOL): A packed from the k16
// step's two n8 accumulator tiles x[0], x[1] (columns 2t, 2t + 1 of rows g,
// g + 8 each), B rows k0 .. k0 + 15 of a [*, HD] bf16 tile (row-major [k, n]:
// ldmatrix.trans).
template <int HD, int NCOL>
__device__ __forceinline__ void acc_product(float (&acc)[NCOL / 8][4], const float (&x0)[4],
                                            const float (&x1)[4], const bf16* rows, int k0,
                                            int col0, int lane) {
  constexpr int LD = HD + 8;
  const uint32_t a[4] = {pack_bf16(x0[0], x0[1]), pack_bf16(x0[2], x0[3]),
                         pack_bf16(x1[0], x1[1]), pack_bf16(x1[2], x1[3])};
#pragma unroll
  for (int dn = 0; dn < NCOL / 16; ++dn) {
    // matrices: (k 0..7, n dn*16 .. +7), (k 8..15, n), (k, n +8), (k +8, n +8)
    uint32_t b[4];
    ldsm_x4_trans(b, smem_u32(rows + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + col0 +
                              dn * 16 + (lane >> 4) * 8));
    mma_bf16(acc[2 * dn], a, b[0], b[1]);
    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
  }
}

// Write a warp's 16 rows of an fp32 accumulator of NCOL columns, times mul,
// as bf16 into columns col0 .. of rows warp*16 .. of a [64, HD] tile in
// shared memory (for 16-byte stores).
template <int HD, int NCOL>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[NCOL / 8][4],
                                           float mul, int col0, int warp, int lane) {
  constexpr int LD = HD + 8;
  const int r = warp * 16 + (lane >> 2), c = col0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + r * LD + n * 8 + c) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(tile + (r + 8) * LD + n * 8 + c) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// Columns col0 .. col0 + NCOL of rows warp*16 .. of a staged [64, HD] tile to
// global rows row0 + r (pitch ld elements), r < n, 16 bytes a lane.
template <int HD, int NCOL>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld, int row0, int n,
                                           const bf16* tile, int col0, int warp, int lane) {
  constexpr int CH = NCOL / 8;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = warp * 16 + idx / CH, c = col0 + (idx % CH) * 8;
    if (r < n)
      *reinterpret_cast<uint4*>(dst + size_t(row0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(tile + r * (HD + 8) + c);
  }
}

// ---------------------------------------------------------------------------
// E: dq. A CTA owns 64 query rows of one head; a warp 16 of them.
// ---------------------------------------------------------------------------

// E's Q or dO fragments (a placeholder where it re-reads them)
template <int HD>
using QdFrags = uint32_t[BwdTiles<HD>::QD_REGS ? HD / 16 : 1][4];

// One 64-column K/V tile: S = Q K^T, P, dP = dO V^T, dS, dQ += dS K. EDGE: the
// tile crosses the causal diagonal, the window's edge or c_hi for some of
// the warp's rows; masked entries get p = ds = 0. Q's and dO's fragments:
// qf, dof, or the warp's rows of the shared tiles Qs, dOs.
template <int HD, bool EDGE>
__device__ __forceinline__ void dq_tile(const BwdArgs& a, const bf16* ks, const bf16* vs,
                                        const QdFrags<HD>& qf, const QdFrags<HD>& dof,
                                        const bf16* Qs, const bf16* dOs,
                                        float (&dq)[BwdTiles<HD>::DCOLS / 8][4],
                                        const float (&lse2)[2], const float (&delta)[2],
                                        int c0, int c_hi, int t_row, int col0, float scale2,
                                        int warp, int lane) {
  using Tl = BwdTiles<HD>;
  constexpr int SUB = Tl::SUB, LD = HD + 8;
  const int tq = lane & 3;
#pragma unroll
  for (int sb = 0; sb < BT / SUB; ++sb) {
    float s[SUB / 8][4], dp[SUB / 8][4];
    scores_of<HD, SUB, Tl::QD_REGS>(s, qf, Qs, ks + sb * SUB * LD, warp, lane);
    scores_of<HD, SUB, Tl::QD_REGS>(dp, dof, dOs, vs + sb * SUB * LD, warp, lane);
#pragma unroll
    for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale2, -lse2[r]));
        if (EDGE) {
          const int c = c0 + sb * SUB + j * 8 + 2 * tq + (e & 1);
          if (c >= c_hi || !a.keep(t_row + 8 * r, c)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - delta[r]);
      }
    }
#pragma unroll
    for (int k = 0; k < SUB / 16; ++k)
      acc_product<HD, Tl::DCOLS>(dq, dp[2 * k], dp[2 * k + 1], ks, sb * SUB + k * 16, col0,
                                 lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, MINB) flash_bwd_dq_kernel(const BwdArgs a) {
  using Tl = BwdTiles<HD>;
  constexpr int STAGES = Tl::STAGES;
  constexpr bool QD = Tl::QD_REGS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: K at 2 s TILE, V after it
  bf16* Qs = ring + (QD ? STAGES - 1 : STAGES) * 2 * Tl::TILE;
  bf16* dOs = Qs + Tl::TILE;

  constexpr int DC = Tl::DCOLS;
  // head h, dQ's columns col0 .. col0 + DC
  const int h = blockIdx.x / Tl::DSPLIT, col0 = (blockIdx.x % Tl::DSPLIT) * DC;
  const int b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BT;  // longest causal tiles first
  const int nrows = min(BT, a.T - t0);
  const int kvh = h / (a.H / a.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // live columns [c_lo, c_hi) of the CTA's query positions [q_lo, q_hi]
  const int q_lo = t0 + a.rel, q_hi = t0 + nrows - 1 + a.rel;
  const int c_lo = a.window > 0 ? max(0, q_lo - (a.window - 1)) : 0;
  const int c_hi = a.causal ? max(0, min(a.S, q_hi + 1)) : a.S;
  const int ntiles = c_hi > c_lo ? (c_hi - c_lo + BT - 1) / BT : 0;

  const size_t q_ld = size_t(a.H) * HD, kv_ld = size_t(a.K) * HD;
  const size_t q_off = (size_t(b) * a.T * a.H + h) * HD;
  const bf16* kg = a.k + (size_t(b) * a.S * a.K + kvh) * HD;
  const bf16* vg = a.v + (size_t(b) * a.S * a.K + kvh) * HD;

  copy_rows<HD, BT, NT>(Qs, a.q + q_off, q_ld, t0, nrows);
  copy_rows<HD, BT, NT>(dOs, a.dout + q_off, q_ld, t0, nrows);
  auto issue = [&](int i) {  // tile i's K and V into stage i % STAGES
    if (i < ntiles) {
      const int c0 = c_lo + i * BT;
      const int nc = min(BT, c_hi - c0);
      bf16* ks = ring + (i % STAGES) * 2 * Tl::TILE;
      copy_rows<HD, BT, NT>(ks, kg, kv_ld, c0, nc);
      copy_rows<HD, BT, NT>(ks + Tl::TILE, vg, kv_ld, c0, nc);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // Q and dO ride in the first group

  // the thread's rows g and g + 8 of the warp: lse (times log2 e) and delta
  const int r0 = warp * 16 + (lane >> 2);
  const float* lse_g = a.lse + (size_t(b) * a.H + h) * a.T + t0;
  const float* delta_g = a.delta + (size_t(b) * a.H + h) * a.T + t0;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = r0 + 8 * r < nrows;
    lse2[r] = ok ? lse_g[r0 + 8 * r] * LOG2E : 0.f;
    delta[r] = ok ? delta_g[r0 + 8 * r] : 0.f;
  }
  const float scale2 = a.scale * LOG2E;
  const int t_row = t0 + r0;                                     // the thread's row g
  const int w_lo = t0 + warp * 16 + a.rel, w_hi = w_lo + 15;    // the warp's positions

  QdFrags<HD> qf, dof;
  float dq[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  if constexpr (QD) {
    if (ntiles > 0) {  // Q's and dO's fragments, before any warp may refill their stage
      cp_async_wait<STAGES - 2>();
      __syncthreads();
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        a_frag<HD>(qf[kd], Qs, warp, kd, lane);
        a_frag<HD>(dof[kd], dOs, warp, kd, lane);
      }
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i landed for this thread's copies
    __syncthreads();              // ... for every thread's; tile i - 1's stage is free
    issue(i + STAGES - 1);
    const int c0 = c_lo + i * BT;
    const bf16* ks = ring + (i % STAGES) * 2 * Tl::TILE;
    const bf16* vs = ks + Tl::TILE;
    if (c0 + BT > c_hi || (a.causal && c0 + BT - 1 > w_lo) ||
        (a.window > 0 && c0 < w_hi - (a.window - 1)))
      dq_tile<HD, true>(a, ks, vs, qf, dof, Qs, dOs, dq, lse2, delta, c0, c_hi, t_row, col0,
                        scale2, warp, lane);
    else
      dq_tile<HD, false>(a, ks, vs, qf, dof, Qs, dOs, dq, lse2, delta, c0, c_hi, t_row, col0,
                         scale2, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: stage dQ in the warp's own Q rows

  stage_rows<HD, DC>(Qs, dq, a.scale, col0, warp, lane);
  __syncwarp();
  store_rows<HD, DC>(a.dq + q_off, q_ld, t0, nrows, Qs, col0, warp, lane);
}

// ---------------------------------------------------------------------------
// F: dk, dv. A CTA owns 64 kv rows of one kv head; a warp 16 of them.
// ---------------------------------------------------------------------------

// One streamed tile of 64 query rows (Q, dO, and their lse and delta): S^T =
// K Q^T, P^T, dP^T = V dO^T, dS^T, then the CTA's columns col0 .. col0 +
// DCOLS of dV += P^T dO and dK += dS^T Q. EDGE: the tile crosses the causal
// diagonal, the window's edge or t_hi for some of the warp's kv rows; masked
// entries get p = ds = 0.
template <int HD, bool EDGE>
__device__ __forceinline__ void dkv_tile(const BwdArgs& a, const bf16* qs, const bf16* dos,
                                         const float* lse_s, const float* delta_s,
                                         const KvFrags<HD>& kf, const KvFrags<HD>& vf,
                                         const bf16* Ks, const bf16* Vs,
                                         float (&dk)[BwdTiles<HD>::DCOLS / 8][4],
                                         float (&dv)[BwdTiles<HD>::DCOLS / 8][4], int t0,
                                         int t_hi, int c_row, int col0, float scale2, int warp,
                                         int lane) {
  using Tl = BwdTiles<HD>;
  constexpr int SUB = Tl::SUB, LD = HD + 8;
  const int tq = lane & 3;
#pragma unroll
  for (int sb = 0; sb < BT / SUB; ++sb) {
    const bf16* qrows = qs + sb * SUB * LD;
    const bf16* dorows = dos + sb * SUB * LD;
    float s[SUB / 8][4], dp[SUB / 8][4];
    scores_of<HD, SUB, Tl::KV_REGS>(s, kf, Ks, qrows, warp, lane);
    scores_of<HD, SUB, Tl::KV_REGS>(dp, vf, Vs, dorows, warp, lane);
#pragma unroll
    for (int j = 0; j < SUB / 8; ++j) {
      const int col = sb * SUB + j * 8 + 2 * tq;  // the tile's query rows col, col + 1
      const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale2, -(e & 1 ? l.y : l.x) * LOG2E));
        if (EDGE) {
          const int t = t0 + col + (e & 1);
          if (t >= t_hi || !a.keep(t, c_row + 8 * (e >> 1))) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (e & 1 ? dl.y : dl.x));
      }
    }
#pragma unroll
    for (int k = 0; k < SUB / 16; ++k) {
      acc_product<HD, Tl::DCOLS>(dv, s[2 * k], s[2 * k + 1], dorows, k * 16, col0, lane);
      acc_product<HD, Tl::DCOLS>(dk, dp[2 * k], dp[2 * k + 1], qrows, k * 16, col0, lane);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, MINB) flash_bwd_dkv_kernel(const BwdArgs a) {
  using Tl = BwdTiles<HD>;
  constexpr int STAGES = Tl::STAGES, DC = Tl::DCOLS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Tl::TILE;
  unsigned char* ring = smem + 2 * Tl::TILE * sizeof(bf16);  // stage: Q, dO, lse, delta

  // kv head kk, its columns col0 .. col0 + DC of dK and dV
  const int kk = blockIdx.x / Tl::DSPLIT, col0 = (blockIdx.x % Tl::DSPLIT) * DC;
  const int b = blockIdx.y, c0 = blockIdx.z * BT;
  const int rep = a.H / a.K;
  const int nc = min(BT, a.S - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // query rows t that see a column of [c0, c0 + nc): causal t + rel >= c0,
  // window t + rel - (c0 + nc - 1) <= window - 1; walked as n_t tiles of
  // every query head h = kk * rep + rr of the group, one sequence of tiles
  const int t_lo = a.causal ? min(a.T, max(0, c0 - a.rel)) : 0;
  const int t_hi = a.window > 0 ? max(0, min(a.T, c0 + nc + a.window - 1 - a.rel)) : a.T;
  const int n_t = t_hi > t_lo ? (t_hi - t_lo + BT - 1) / BT : 0;
  const int ntiles = rep * n_t;

  const size_t q_ld = size_t(a.H) * HD, kv_ld = size_t(a.K) * HD;
  const size_t kv_off = (size_t(b) * a.S * a.K + kk) * HD;
  copy_rows<HD, BT, NT>(Ks, a.k + kv_off, kv_ld, c0, nc);
  copy_rows<HD, BT, NT>(Vs, a.v + kv_off, kv_ld, c0, nc);
  auto issue = [&](int i) {  // tile i into stage i % STAGES
    if (i < ntiles) {
      const int rr = i / n_t, h = kk * rep + rr;
      const int t0 = t_lo + (i - rr * n_t) * BT;
      const int nr = min(BT, t_hi - t0);
      unsigned char* st = ring + (i % STAGES) * Tl::F_STAGE;
      bf16* qs = reinterpret_cast<bf16*>(st);
      const size_t q_off = (size_t(b) * a.T * a.H + h) * HD;
      copy_rows<HD, BT, NT>(qs, a.q + q_off, q_ld, t0, nr);
      copy_rows<HD, BT, NT>(qs + Tl::TILE, a.dout + q_off, q_ld, t0, nr);
      // thread x < 64 copies lse of row x, thread x >= 64 delta of row x - 64
      static_assert(NT == 2 * BT, "one statistic a thread");
      const int r = threadIdx.x % BT;
      const float* src = (threadIdx.x < BT ? a.lse : a.delta) + (size_t(b) * a.H + h) * a.T + t0;
      float* stats = reinterpret_cast<float*>(st + 2 * Tl::TILE * sizeof(bf16));
      cp_async4(smem_u32(stats + threadIdx.x), src + (r < nr ? r : 0), r < nr ? 4 : 0);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // K and V ride in the first group

  KvFrags<HD> kf, vf;
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if constexpr (Tl::KV_REGS) {
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      a_frag<HD>(kf[kd], Ks, warp, kd, lane);
      a_frag<HD>(vf[kd], Vs, warp, kd, lane);
    }
  }

  const float scale2 = a.scale * LOG2E;
  const int cw = c0 + warp * 16;        // the warp's first kv row
  const int c_row = cw + (lane >> 2);   // the thread's row g
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i landed for this thread's copies
    __syncthreads();              // ... for every thread's; tile i - 1's stage is free
    issue(i + STAGES - 1);
    const int rr = i / n_t;
    const int t0 = t_lo + (i - rr * n_t) * BT;
    const unsigned char* st = ring + (i % STAGES) * Tl::F_STAGE;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* dos = qs + Tl::TILE;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * Tl::TILE * sizeof(bf16));
    const float* delta_s = lse_s + BT;
    if (t0 + BT > t_hi || (a.causal && t0 + a.rel < cw + 15) ||
        (a.window > 0 && t0 + BT - 1 + a.rel - cw > a.window - 1))
      dkv_tile<HD, true>(a, qs, dos, lse_s, delta_s, kf, vf, Ks, Vs, dk, dv, t0, t_hi, c_row,
                         col0, scale2, warp, lane);
    else
      dkv_tile<HD, false>(a, qs, dos, lse_s, delta_s, kf, vf, Ks, Vs, dk, dv, t0, t_hi, c_row,
                          col0, scale2, warp, lane);
  }
  cp_async_wait<0>();

  // a warp reads only its own rows of K and V: stage dK and dV there
  stage_rows<HD, DC>(Ks, dk, a.scale, col0, warp, lane);
  stage_rows<HD, DC>(Vs, dv, 1.f, col0, warp, lane);
  __syncwarp();
  store_rows<HD, DC>(a.dk + kv_off, kv_ld, c0, nc, Ks, col0, warp, lane);
  store_rows<HD, DC>(a.dv + kv_off, kv_ld, c0, nc, Vs, col0, warp, lane);
}

template <int HD, bool DKV>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using Tl = BwdTiles<HD>;
  auto kern = DKV ? flash_bwd_dkv_kernel<HD> : flash_bwd_dq_kernel<HD>;
  const size_t bytes = DKV ? Tl::F_BYTES : Tl::E_BYTES;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  // F: kv tile 0 first, the heaviest under a causal mask; E reverses its own
  const dim3 grid = DKV ? dim3(a.K * Tl::DSPLIT, a.B, (a.S + BT - 1) / BT)
                        : dim3(a.H * Tl::DSPLIT, a.B, (a.T + BT - 1) / BT);
  kern<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int launch_bwd_any_hd(const BwdArgs& a, int hd, cudaStream_t stream) {
  if (hd == 128) return launch_bwd<128, DKV>(a, stream);
  if (hd == 64) return launch_bwd<64, DKV>(a, stream);
  if (hd == 96) return launch_bwd<96, DKV>(a, stream);
  if (hd == 256) return launch_bwd<256, DKV>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, int B, int T, int S, int H, int K,
                  int causal, int window, int rel, float scale) {
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.B = B; a.T = T; a.S = S; a.H = H; a.K = K;
  a.causal = causal; a.window = window; a.rel = rel; a.scale = scale;
  return a;
}

}  // namespace dst

extern "C" {

// Kernel E. Returns cudaError_t.
int dst_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int B, int T, int S, int H,
                     int K, int hd, int causal, int window, int rel_offset, float scale,
                     void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  dst::BwdArgs a = dst::make_args(q, k, v, dout, lse, delta, B, T, S, H, K, causal, window,
                                  rel_offset, scale);
  a.dq = static_cast<dst::bf16*>(dq);
  return dst::launch_bwd_any_hd<false>(a, hd, static_cast<cudaStream_t>(stream));
}

// Kernel F. Returns cudaError_t.
int dst_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int B, int T,
                      int S, int H, int K, int hd, int causal, int window, int rel_offset,
                      float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  dst::BwdArgs a = dst::make_args(q, k, v, dout, lse, delta, B, T, S, H, K, causal, window,
                                  rel_offset, scale);
  a.dk = static_cast<dst::bf16*>(dk);
  a.dv = static_cast<dst::bf16*>(dv);
  return dst::launch_bwd_any_hd<true>(a, hd, static_cast<cudaStream_t>(stream));
}

// Kernels E and F's dynamic shared memory in bytes at d = 64, 96, 128 and
// 256 (extern: a const has internal linkage otherwise).
extern const int dst_flash_bwd_dq_smem_bytes[4] = {
    static_cast<int>(dst::BwdTiles<64>::E_BYTES), static_cast<int>(dst::BwdTiles<96>::E_BYTES),
    static_cast<int>(dst::BwdTiles<128>::E_BYTES), static_cast<int>(dst::BwdTiles<256>::E_BYTES)};
extern const int dst_flash_bwd_dkv_smem_bytes[4] = {
    static_cast<int>(dst::BwdTiles<64>::F_BYTES), static_cast<int>(dst::BwdTiles<96>::F_BYTES),
    static_cast<int>(dst::BwdTiles<128>::F_BYTES), static_cast<int>(dst::BwdTiles<256>::F_BYTES)};

}  // extern "C"
