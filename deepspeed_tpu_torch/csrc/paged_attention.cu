// Paged chunk-past partials on Hopper: kernel B of the serving path, over a
// bf16, int8 or int4 KV pool.
//
// Replaces deepspeed_tpu/ops/paged_attention.py _past_kernel (:782) via
// _prefill_attention (:952), with its quantized / kv_bits modes (:840-876):
// the tq rows of each of the H heads of a chunk atom over the atom's pooled
// past (columns < pos0, and > pos0 + t - window for token t under a sliding
// window), returned as unnormalised flash partials -- acc [A, K, R = tq rep,
// d] fp32, m and l [A, K, R], row t rep + rr = token t of head kk rep + rr --
// that kernel C (flash_attention.cu) seeds its self flash with. An atom with
// nothing visible (pos0 = 0, or a window past every column) gets m = -1e30,
// l = 0, acc = 0: the merge's exp(m - m2) = 0 then drops it.
//
// What bounds it on the card: the score operations, ~4 d FLOPs a visible
// (row, column) pair (a 256-token chunk over a past of 768 does ~1000
// products a pooled byte), and then the fp32 partials it writes (8 bytes a
// row and feature, more than the past's K/V at serving lengths). The design
// is kernel D's register-resident flash (flash_fwd_tile.cuh), the same tile
// body over the paged columns, as kernel I's tile regime (paged_tile.cu):
//   * a CTA owns 64 query rows -- one head's tokens, 16 a warp -- grid
//     (H, q tiles, atoms): the heads of a GQA group are neighbouring CTAs and
//     share each K/V tile through L2, and the atoms are taken longest live
//     past first (each CTA ranks the atoms' pasts itself, up to MAX_RANKED
//     atoms; more keep the grid's order), so the longest CTAs start first
//     and the tail is short;
//   * a CTA computes its atom's live range itself, by _past_ranges' formula
//     ([lo bs, min(pos0, (lo + nblk) bs))), and walks it in 64-column tiles
//     from lo bs in order; under a window it skips the tiles before its first
//     row's first visible column. Without a window that is kernel D's walk
//     over the same columns, so B's fp32 state after the past is D's bit for
//     bit, and kernel C continues D's walk from it: a chunked prompt's
//     attention equals the whole prompt's (chunks start at multiples of 64);
//   * a tile's pool rows are looked up in the slot's block table one tile
//     ahead (64 threads, one column each) into a small shared table, and the
//     kv head's [*, d] lanes come out of the lane-folded [L, nb+1, bs, K d]
//     pool by 16-byte cp.async copies through a 3-stage ring (2 at d = 256),
//     zero-filled past the range by the copy's src-size, one barrier a tile;
//   * S = Q K^T and O += P V on mma.sync m16n8k16 with S, P and O in
//     registers, Q held as fragments (from a shared tile at d = 256, where
//     two CTAs split O's columns, as D); masks only on tiles that cross c_hi
//     or a row's window edge;
//   * the epilogue writes the unnormalised fp32 O, m and l straight from the
//     accumulators (each quad's 8 or 16 bytes a row fill whole sectors).
// Int pools (paged_past_int8 / _int4; q stays bf16, as the reference's):
// the K/V bytes go through the ring as bytes, with each tile's per-token k
// and v scales from kv_scale [L, nb+1, 1, 2 bs] (k in lanes [0, bs), v in
// [bs, 2 bs)), and become bf16 B fragments in registers (int_unpack.cuh's
// frag_int8, and one nibble of frag_int4's): ldmatrix of byte rows hands a
// thread features 4t .. 4t + 3 of a key, so Q's fragments take their
// features in the same order (a dot product does not care about the order
// of its terms), and P V's accumulator columns come out as even and odd
// features, put back in order by the epilogue's 16-byte stores. A score is
// (s scale) k_scale[col], p is scaled by v_scale[col] before P V, and l sums
// the unscaled p. The int4 pool pairs lanes GLOBALLY -- byte j holds feature
// j (low nibble) and j + K d / 2 (high) -- and each CTA reads its kv head's
// bytes for one nibble, per 16-feature chunk: it does NOT pair kv heads kk
// and kk + K / 2 as kernel A does, because B is bound by its products and
// its fp32 partials, not by the pool's bytes, and a paired CTA would run
// the products of both heads' rows.
// Not yet: wgmma and TMA copies of whole blocks with a producer warp, and
// K/V reuse across the rep heads of a group beyond what L2 gives.
#include "flash_fwd_tile.cuh"
#include "int_unpack.cuh"

namespace dst {

struct PastArgs {
  const bf16* q;             // [A tq, H, hd]
  const unsigned char* kp;   // pools [L, nbp1, bs, lanes]: bf16, int8 or int4 bytes
  const unsigned char* vp;
  const float* kv_scale;     // [L, nbp1, 1, 2 bs] (int pools)
  const int* bt;             // [S, nb_max] physical block ids, by SLOT
  const int* slot;           // [A]
  const int* pos0;           // [A] pool frontier: columns < pos0 are cached
  float* acc;                // [A, K, tq rep, hd]
  float* m;                  // [A, K, tq rep]
  float* l;                  // [A, K, tq rep]
  int layer, nbp1, bs, H, K, nb_max, A, tq, window;
  float scale;
};

// atoms a CTA ranks by the length of their live past (one a thread)
constexpr int MAX_RANKED = 128;

// Shared memory: the ring of STAGES tiles (stage s: K rows, V rows, then an
// int pool's k and v scales of the tile's columns), Q's tile in the ring's
// last stage where Q's fragments stay in registers (d <= 128) and after the
// ring at d = 256; then the pool rows of the columns of the STAGES tiles in
// flight ([STAGES][BN] ints, -1 past the live range), the atoms' past
// lengths and the CTA's atom. A bf16 ring is kernel D's (FwdTiles).
template <int BITS, int HD>
struct PastTiles {
  using F = FwdTiles<HD>;
  static constexpr bool INT = BITS != 16;
  static constexpr int PITCH = INT ? HD + 16 : 2 * F::LD;  // row bytes, 16 of skew
  static constexpr int KV_BYTES = BN * PITCH;
  static constexpr int STAGE = 2 * KV_BYTES + (INT ? 2 * BN * 4 : 0);
  static constexpr int Q_BYTES = F::Q_ELEMS * 2;
  static constexpr size_t Q_OFF = size_t(F::Q_REGS ? F::STAGES - 1 : F::STAGES) * STAGE;
  static constexpr size_t ROWS_OFF = size_t(F::STAGES) * STAGE + (F::Q_REGS ? 0 : Q_BYTES);
  static constexpr size_t LEN_OFF = ROWS_OFF + size_t(F::STAGES) * BN * 4;
  static constexpr size_t ATOM_OFF = LEN_OFF + MAX_RANKED * 4;
  static constexpr size_t BYTES = ATOM_OFF + 16;
  static_assert(Q_BYTES <= STAGE, "Q's tile fits one stage");
};

// The atom's live past columns [c_lo, c_hi), by _past_ranges' formula (C's
// division truncates where floor would not only below 0, clamped to 0).
__device__ __forceinline__ int2 past_cols(const PastArgs& a, int at) {
  const int p0 = a.pos0[at];
  const int lo = a.window > 0 ? max((p0 - (a.window - 1)) / a.bs, 0) : 0;
  const int last = p0 > 0 ? min((p0 - 1) / a.bs, a.nb_max - 1) : -1;
  if (last < lo) return make_int2(0, 0);
  return make_int2(lo * a.bs, min(p0, (last + 1) * a.bs));
}

// ldmatrix address of lane `lane` over 16 byte rows (pitch `pitch`):
// matrices (rows 0-7, bytes b .. b + 15), (rows 8-15, same), (rows 0-7,
// b + 16 ..), (rows 8-15, b + 16 ..) -- two 16-byte chunks of both n8 halves.
__device__ __forceinline__ uint32_t byte_rows(const unsigned char* rows, int pitch, int b,
                                              int lane) {
  return smem_u32(rows + (((lane >> 3) & 1) * 8 + (lane & 7)) * pitch + b + (lane >> 4) * 16);
}

// The nibble of an int4 chunk whose first feature is f: features >= half are
// high nibbles (a right shift by 4); int8 takes the bytes.
template <int BITS>
__device__ __forceinline__ int nib_shift(int f, int half) {
  return BITS == 4 && f >= half ? 4 : 0;
}

// A word of four bytes (as ldmatrix hands it a thread) as two bf16x2 words
// of the byte pairs (b0, b2) and (b1, b3): frag_int8, or frag_int4's low
// (sh = 0) or high (sh = 4) nibbles.
template <int BITS>
__device__ __forceinline__ uint2 frag_bytes(uint32_t r, int sh) {
  if constexpr (BITS == 8) {
    return frag_int8(r);
  } else {
    const uint32_t u = (r ^ 0x88888888u) >> sh, nib = 0x000F000Fu, bf128 = 0x43004300u;
    const uint32_t bias = 0x43084308u;  // bf16x2 136
    return make_uint2(bf16x2_sub(and_or(u, nib, bf128), bias),
                      bf16x2_sub(and_or(u >> 8, nib, bf128), bias));
  }
}

// Q's A fragment of k step kd for an int pool, from the warp's 16 rows of
// Q's shared tile: k positions (2t, 2t + 1) carry features (4t, 4t + 2) and
// (2t + 8, 2t + 9) features (4t + 1, 4t + 3) of the step -- frag_bytes' pairs.
template <int HD>
__device__ __forceinline__ void q_frag_int(uint32_t (&f)[4], const bf16* qs, int kd, int lane) {
  constexpr int LD = HD + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint2 w = *reinterpret_cast<const uint2*>(qs + (g + 8 * r) * LD + kd * 16 + 4 * t);
    f[r] = __byte_perm(w.x, w.y, 0x5410);
    f[2 + r] = __byte_perm(w.x, w.y, 0x7632);
  }
}

// S = Q K^T of a warp's 16 rows and a 64-column tile of int8 / int4 K bytes
// (raw products of the integer values). fbase: the kv head's first feature.
template <int BITS, int HD, bool QREG>
__device__ __forceinline__ void int_scores(const unsigned char* ks,
                                           const uint32_t (&qf)[QREG ? HD / 16 : 1][4],
                                           const bf16* qs, float (&s)[BN / 8][4], int lane,
                                           int fbase, int half) {
  constexpr int PITCH = HD + 16;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // two 16-feature chunks an iteration; Q from shared memory at d = 256
  unrolled<HD / 32, QREG ? HD / 32 : 1>([&](int k2) {
    uint32_t qa[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[c][e] = qf[2 * k2 + c][e];
      } else {
        q_frag_int<HD>(qa[c], qs, 2 * k2 + c, lane);
      }
    }
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      uint32_t kb[4];  // (cols 0-7 | 8-15) x (chunk 2 k2 | 2 k2 + 1)
      ldsm_x4(kb, byte_rows(ks + np * 16 * PITCH, PITCH, k2 * 32, lane));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int sh = nib_shift<BITS>(fbase + (2 * k2 + c) * 16, half);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2 b = frag_bytes<BITS>(kb[2 * c + j], sh);
          mma_bf16(s[2 * np + j], qa[c], b.x, b.y);
        }
      }
    }
  });
}

// tile_softmax_pv (flash_fwd_tile.cuh) over an int tile: scores times their
// columns' k scales, p times their v scales before P V (l sums the unscaled
// p), and V's bytes as B fragments; o[2 c] holds the even features of O's
// chunk c, o[2 c + 1] the odd ones. No causal limit: the past ends at c_hi.
template <int BITS, int HD, int OC, bool EDGE>
__device__ __forceinline__ void int_softmax_pv(const unsigned char* vs, const float* ksc,
                                               const float* vsc, float (&s)[BN / 8][4],
                                               float (&o)[OC / 8][4], float (&m)[2],
                                               float (&l)[2], int c0, int c_hi, int qp0,
                                               int window, float scale, int col0, int lane,
                                               int fbase, int half) {
  constexpr int PITCH = HD + 16;
  const int tq = lane & 3;
  auto keep = [&](int j, int e) {
    const int c = c0 + j * 8 + 2 * tq + (e & 1);
    const int qp = qp0 + (e >> 1) * 8;
    return c < c_hi && (window <= 0 || qp - c < window);
  };
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 ks = *reinterpret_cast<const float2*>(ksc + j * 8 + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = !EDGE || keep(j, e) ? score_of(s[j][e], scale) * (e & 1 ? ks.y : ks.x)
                                    : FWD_NEG_INF;
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
  for (int j = 0; j < BN / 8; ++j) {
    const float2 vsj = *reinterpret_cast<const float2*>(vsc + j * 8 + 2 * tq);
    s[j][0] *= vsj.x;
    s[j][1] *= vsj.y;
    s[j][2] *= vsj.x;
    s[j][3] *= vsj.y;
  }

#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int k2 = 0; k2 < OC / 32; ++k2) {
      uint32_t vb[4];  // (cols 0-7 | 8-15) x (chunk 2 k2 | 2 k2 + 1), transposed
      ldsm_x4_trans(vb, byte_rows(vs + kk * 16 * PITCH, PITCH, col0 + k2 * 32, lane));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ch = 2 * k2 + c;
        const int sh = nib_shift<BITS>(fbase + col0 + ch * 16, half);
        const uint2 v0 = frag_bytes<BITS>(vb[2 * c], sh), v8 = frag_bytes<BITS>(vb[2 * c + 1], sh);
        mma_bf16(o[2 * ch], pa, v0.x, v8.x);
        mma_bf16(o[2 * ch + 1], pa, v0.y, v8.y);
      }
    }
  }
}

template <int BITS, int HD>
__global__ void __launch_bounds__(WARPS * 32, MINB) paged_past_kernel(const PastArgs a) {
  using T = PastTiles<BITS, HD>;
  using F = FwdTiles<HD>;
  constexpr bool INT = T::INT, QREG = F::Q_REGS;
  constexpr int LD = F::LD, BM = F::BM, NT = WARPS * 32, STAGES = F::STAGES, OC = F::OC;
  static_assert(STAGES >= 2 && NT >= BN && NT >= MAX_RANKED && NT == 2 * BN,
                "a ring; a column a thread; an atom a thread; a scale a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + T::Q_OFF);
  int* rows_s = reinterpret_cast<int*>(smem + T::ROWS_OFF);
  int* len_s = reinterpret_cast<int*>(smem + T::LEN_OFF);
  int* atom_s = reinterpret_cast<int*>(smem + T::ATOM_OFF);

  // head h, O's columns col0 .. col0 + OC, tokens t0 ..
  const int h = blockIdx.x / F::OSPLIT, col0 = (blockIdx.x % F::OSPLIT) * OC;
  const int t0 = blockIdx.y * BM;
  const int nrows = min(BM, a.tq - t0);
  const int rep = a.H / a.K, kk = h / rep, rr = h - kk * rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the atom: the one with the blockIdx.z-th longest live past (ties in
  // atom order)
  int at = blockIdx.z;
  if (a.A > 1 && a.A <= MAX_RANKED) {
    int len = 0;
    if (threadIdx.x < a.A) {
      const int2 c = past_cols(a, threadIdx.x);
      len = c.y - c.x;
      len_s[threadIdx.x] = len;
    }
    __syncthreads();
    if (threadIdx.x < a.A) {
      int rank = 0;
      for (int i = 0; i < a.A; ++i) {
        const int li = len_s[i];
        rank += li > len || (li == len && i < int(threadIdx.x));
      }
      if (rank == int(blockIdx.z)) *atom_s = threadIdx.x;
    }
    __syncthreads();
    at = *atom_s;
  }

  // the live columns, walked in 64-column tiles from c_lo in order; under a
  // window, from the tile of the CTA's first row's first visible column
  const int p0 = a.pos0[at];
  const int2 live = past_cols(a, at);
  int c_lo = live.x;
  const int c_hi = live.y;
  if (a.window > 0) c_lo += max(0, p0 + t0 - (a.window - 1) - c_lo) / BN * BN;
  const int ntiles = c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN : 0;

  const size_t q_ld = size_t(a.H) * HD;
  const bf16* qg = a.q + (size_t(at) * a.tq * a.H + h) * HD;
  const int* btb = a.bt + size_t(a.slot[at]) * a.nb_max;
  // a pool row's bytes, and the kv head's 16-byte chunk ch in it
  const size_t row_bytes = BITS == 16 ? size_t(a.K) * HD * 2
                                      : BITS == 8 ? size_t(a.K) * HD : size_t(a.K) * HD / 2;
  const int fbase = kk * HD, half = a.K * HD / 2;  // int4: features >= half are high nibbles
  auto chunk_off = [&](int ch) {
    if constexpr (BITS == 16) return fbase * 2 + ch * 16;
    if constexpr (BITS == 8) return fbase + ch * 16;
    const int f = fbase + ch * 16;
    return f < half ? f : f - half;
  };

  // the pool row of tile i's column threadIdx.x (threads < BN), -1 past c_hi
  auto pool_row = [&](int i) {
    const int c = c_lo + i * BN + threadIdx.x;
    if (i >= ntiles || c >= c_hi) return -1;
    const int blk = c / a.bs;
    return (a.layer * a.nbp1 + btb[blk]) * a.bs + (c - blk * a.bs);
  };
  auto issue = [&](int i) {  // tile i's K and V (and scales) into stage i % STAGES
    if (i < ntiles) {
      unsigned char* st = smem + (i % STAGES) * T::STAGE;
      const int* rws = rows_s + (i % STAGES) * BN;
      constexpr int CH = INT ? HD / 16 : HD / 8;  // 16-byte chunks a row
      static_assert(BN * CH % NT == 0, "whole copies per thread");
#pragma unroll
      for (int it = 0; it < BN * CH / NT; ++it) {
        const int idx = threadIdx.x + it * NT;
        const int r = idx / CH, ch = idx % CH;
        const int row = rws[r];
        const size_t off = row >= 0 ? size_t(row) * row_bytes + chunk_off(ch) : 0;
        const int n = row >= 0 ? 16 : 0;
        cp_async16(smem_u32(st + r * T::PITCH + ch * 16), a.kp + off, n);
        cp_async16(smem_u32(st + T::KV_BYTES + r * T::PITCH + ch * 16), a.vp + off, n);
      }
      if constexpr (INT) {
        // kv_scale [L, nbp1, 1, 2 bs]: a block's k scales, then its v scales
        const int which = threadIdx.x / BN, row = rws[threadIdx.x % BN];
        const float* src = a.kv_scale + (row >= 0 ? row + (row / a.bs + which) * a.bs : 0);
        cp_async4(smem_u32(st + 2 * T::KV_BYTES + threadIdx.x * 4), src, row >= 0 ? 4 : 0);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  if (threadIdx.x < BN) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) rows_s[i * BN + threadIdx.x] = pool_row(i);
  }
  copy_rows<HD, BM, NT>(Qs, qg, q_ld, t0, nrows);
  __syncthreads();  // the first tiles' pool rows
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // Q rides in the first group

  uint32_t qf[QREG ? HD / 16 : 1][4];
  float o[OC / 8][4];
#pragma unroll
  for (int n = 0; n < OC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {FWD_NEG_INF, FWD_NEG_INF};  // running max of scores, rows g, g + 8
  float l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = p0 + t0 + r0;                  // row r0's position
  const int w_hi = p0 + t0 + warp * 16 + 15;     // the warp's last row's
  const bf16* qs = Qs + warp * 16 * LD;

  if constexpr (QREG) {
    if (ntiles > 0) {  // Q's fragments, before any warp may refill Q's stage
      cp_async_wait<STAGES - 2>();
      __syncthreads();
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        if constexpr (INT)
          q_frag_int<HD>(qf[kd], qs, kd, lane);
        else
          ldsm_x4(qf[kd], smem_u32(qs + (lane & 15) * LD + kd * 16 + (lane >> 4) * 8));
      }
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i landed for this thread's copies
    __syncthreads();              // ... for every thread's; tile i - 1's (Q's) stage is free
    issue(i + STAGES - 1);        // its pool rows were staged before this barrier
    // tile i + STAGES's pool rows, into the slot tile i's held: looked up
    // now, stored after the math, read after the next barrier
    const int next = threadIdx.x < BN ? pool_row(i + STAGES) : -1;
    if (warp * 16 < nrows) {  // a warp past the CTA's last row has nothing to do
      const int c0 = c_lo + i * BN;
      const unsigned char* st = smem + (i % STAGES) * T::STAGE;
      // masks only where the tile crosses c_hi or the window's edge for
      // one of the warp's rows
      const bool edge = c0 + BN > c_hi || (a.window > 0 && c0 < w_hi - (a.window - 1));
      float sc[BN / 8][4];
      if constexpr (!INT) {
        const bf16* ks = reinterpret_cast<const bf16*>(st);
        const bf16* vs = reinterpret_cast<const bf16*>(st + T::KV_BYTES);
        tile_scores<HD, QREG>(ks, qf, qs, sc, lane);
        if (edge)
          tile_softmax_pv<HD, OC, true>(vs, sc, o, m, l, c0, c_hi, qp0, 0, a.window, a.scale,
                                        col0, lane);
        else
          tile_softmax_pv<HD, OC, false>(vs, sc, o, m, l, c0, c_hi, qp0, 0, a.window, a.scale,
                                         col0, lane);
      } else {
        const float* ksc = reinterpret_cast<const float*>(st + 2 * T::KV_BYTES);
        int_scores<BITS, HD, QREG>(st, qf, qs, sc, lane, fbase, half);
        if (edge)
          int_softmax_pv<BITS, HD, OC, true>(st + T::KV_BYTES, ksc, ksc + BN, sc, o, m, l, c0,
                                             c_hi, qp0, a.window, a.scale, col0, lane, fbase,
                                             half);
        else
          int_softmax_pv<BITS, HD, OC, false>(st + T::KV_BYTES, ksc, ksc + BN, sc, o, m, l, c0,
                                              c_hi, qp0, a.window, a.scale, col0, lane, fbase,
                                              half);
      }
    }
    if (threadIdx.x < BN) rows_s[(i % STAGES) * BN + threadIdx.x] = next;
  }
  cp_async_wait<0>();

  // epilogue: the unnormalised O, m and l of rows r0 and r0 + 8, row
  // t rep + rr of (atom, kv head)
  const size_t base = (size_t(at) * a.K + kk) * size_t(a.tq) * rep;
  const int tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r >= nrows) continue;
    const size_t row = base + size_t(t0 + r) * rep + rr;
    float* dst = a.acc + row * HD + col0;
    if constexpr (INT) {  // features 16 c + 4 tq .. + 3 of chunk c
#pragma unroll
      for (int c = 0; c < OC / 16; ++c)
        *reinterpret_cast<float4*>(dst + c * 16 + 4 * tq) =
            make_float4(o[2 * c][2 * hf], o[2 * c + 1][2 * hf], o[2 * c][2 * hf + 1],
                        o[2 * c + 1][2 * hf + 1]);
    } else {
#pragma unroll
      for (int n = 0; n < OC / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8 + 2 * tq) =
            make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
    }
    if (tq == 0 && col0 == 0) {
      a.m[row] = m[hf];
      a.l[row] = l[hf];
    }
  }
}

template <int BITS, int HD>
int launch_past(const PastArgs& a, cudaStream_t stream) {
  using T = PastTiles<BITS, HD>;
  auto kern = paged_past_kernel<BITS, HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(T::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.H * T::F::OSPLIT, (a.tq + T::F::BM - 1) / T::F::BM, a.A), WARPS * 32, T::BYTES,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// head_dim dispatch: 64, 96, 128 and 256 (the wrappers refuse any other head
// dim before a launch). Returns the launch's cudaError_t (0 = launched).
template <int BITS>
int launch_past_c(const void* q, const void* kpool, const void* vpool, const float* kv_scale,
                  int layer, int nbp1, int bs, int H, int K, int hd, const int* bt, int nb_max,
                  const int* slot, const int* pos0, int A, int tq, int window, float scale,
                  float* acc, float* m, float* l, void* stream) {
  if (A <= 0 || tq <= 0) return 0;
  if (K <= 0 || H % K != 0 || bs <= 0 || nb_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PastArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.kp = static_cast<const unsigned char*>(kpool);
  a.vp = static_cast<const unsigned char*>(vpool);
  a.kv_scale = kv_scale;
  a.bt = bt; a.slot = slot; a.pos0 = pos0;
  a.acc = acc; a.m = m; a.l = l;
  a.layer = layer; a.nbp1 = nbp1; a.bs = bs; a.H = H; a.K = K; a.nb_max = nb_max;
  a.A = A; a.tq = tq; a.window = window;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_past<BITS, 128>(a, st);
  if (hd == 64) return launch_past<BITS, 64>(a, st);
  if (hd == 96) return launch_past<BITS, 96>(a, st);
  if (hd == 256) return launch_past<BITS, 256>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dst

extern "C" {

// Kernel B over a bf16 pool. Returns the launch's cudaError_t (0 = launched).
int dst_paged_past(const void* q, const void* kpool, const void* vpool, int layer, int nbp1,
                   int bs, int H, int K, int hd, const int* bt, int nb_max, const int* slot,
                   const int* pos0, int A, int tq, int window, float scale, float* acc, float* m,
                   float* l, void* stream) {
  return dst::launch_past_c<16>(q, kpool, vpool, nullptr, layer, nbp1, bs, H, K, hd, bt, nb_max,
                                slot, pos0, A, tq, window, scale, acc, m, l, stream);
}

// Kernel B over an int8 pool (q bf16).
int dst_paged_past_int8(const void* q, const void* kpool, const void* vpool,
                        const float* kv_scale, int layer, int nbp1, int bs, int H, int K, int hd,
                        const int* bt, int nb_max, const int* slot, const int* pos0, int A,
                        int tq, int window, float scale, float* acc, float* m, float* l,
                        void* stream) {
  return dst::launch_past_c<8>(q, kpool, vpool, kv_scale, layer, nbp1, bs, H, K, hd, bt, nb_max,
                               slot, pos0, A, tq, window, scale, acc, m, l, stream);
}

// Kernel B over an int4 pool (q bf16).
int dst_paged_past_int4(const void* q, const void* kpool, const void* vpool,
                        const float* kv_scale, int layer, int nbp1, int bs, int H, int K, int hd,
                        const int* bt, int nb_max, const int* slot, const int* pos0, int A,
                        int tq, int window, float scale, float* acc, float* m, float* l,
                        void* stream) {
  return dst::launch_past_c<4>(q, kpool, vpool, kv_scale, layer, nbp1, bs, H, K, hd, bt, nb_max,
                               slot, pos0, A, tq, window, scale, acc, m, l, stream);
}

// Dynamic shared memory in bytes at d = 64, 96, 128 and 256, per pool mode
// (extern: a const has internal linkage otherwise).
#define DST_PAST_SMEM(BITS)                                                             \
  {static_cast<int>(dst::PastTiles<BITS, 64>::BYTES),                                   \
   static_cast<int>(dst::PastTiles<BITS, 96>::BYTES),                                   \
   static_cast<int>(dst::PastTiles<BITS, 128>::BYTES),                                  \
   static_cast<int>(dst::PastTiles<BITS, 256>::BYTES)}
extern const int dst_paged_past_smem_bytes[4] = DST_PAST_SMEM(16);
extern const int dst_paged_past_int8_smem_bytes[4] = DST_PAST_SMEM(8);
extern const int dst_paged_past_int4_smem_bytes[4] = DST_PAST_SMEM(4);
#undef DST_PAST_SMEM

}  // extern "C"
