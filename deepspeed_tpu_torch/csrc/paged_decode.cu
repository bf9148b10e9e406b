// Paged decode partials on Hopper: kernel A of the serving path, over a
// bf16, int8 or int4 KV pool.
//
// Replaces deepspeed_tpu/ops/paged_attention.py _decode_kernel (:420) via
// decode_pool_partials (:543), with its quantized / kv_bits modes (:483-516):
// one query row per decode atom, all H heads, over the atom's pooled past
// (positions < pos0, and > row_pos - window under a sliding window). Returns
// unnormalised flash partials -- acc [A, H, d] fp32, m and l [A, H] -- that the
// caller merges with the atom's own token; m is the maximum score over the
// whole visible past. An atom with nothing visible gets m = -1e30, l = 0,
// acc = 0.
//
// What bounds it on the card: the KV bytes. A decode row does ~1 FLOP per
// byte of its past, far below the H100's ~295 FLOP/byte ridge, so the floor
// is the live blocks' bytes over 3.35 TB/s: a few microseconds at serving
// batch. What the design does about it:
//   * the past is split over CTAs, as the reference's work list splits it
//     into groups of blocks: grid (A, kv head groups, nsplit), a split a run
//     of `bps` whole pool blocks of the atom's live range (the wrapper's
//     decode_splits: one 128-row block at the serving block size). A CTA
//     computes its atom's live range itself, by _past_ranges' formula, and
//     CTAs past the atom's live blocks exit at once;
//   * a CTA looks its split's physical block ids up once into shared memory
//     and streams the K and V rows of its kv head (plus the per-token scales
//     of an int pool) through a STAGES-deep ring of 16-byte cp.async copies
//     of TN-row tiles, one barrier a tile; rows past the visible range are
//     zero-filled by the copy's src-size, so a p = 0 never meets NaN bits;
//   * only the live query rows are computed: the H / K heads of a GQA group
//     form the 16 rows of one mma.sync A operand (m16n8k16 bf16, or m16n8k32
//     s8 x s8 for the int8 pool), held in registers for the whole walk; each
//     of the WARPS warps takes 16 columns of every tile with its own online
//     softmax (S, P, O in registers, as kernel D), and the warps' partials
//     merge in shared memory at the end, in warp order;
//   * the int pools stay bytes in shared memory: ldmatrix hands each thread
//     words of packed bytes that become bf16 B fragments in registers
//     (frag_int8 / frag_int4). The score takes them as they come -- the query
//     fragments are permuted to match, a dot product does not care about the
//     order of its terms -- and P V's accumulator columns come out as even and
//     odd features, put back in order in the epilogue;
//   * int4 pairs lanes GLOBALLY: byte j holds feature j (low nibble) and
//     j + K d / 2 (high nibble). For even K (and H / K <= 8) one CTA serves
//     kv heads kk and kk + K / 2 together -- rows 0-7 of its m16 tile are kk's
//     heads, rows 8-15 kk + K / 2's -- so both nibbles of every byte it reads
//     are used and an int4 head costs half an int8 head's bytes. The two
//     groups' products run on the same accumulators with the other group's
//     query (or P) rows zeroed. For odd K a head's features may straddle the
//     nibble halves, and a CTA reads each 16-byte chunk for one nibble, as
//     before;
//   * int8 keeps the reference's integer score: the wrapper's q-hat
//     (_quantize_q_rows) is computed here, in the prologue, bit for bit
//     (amax * (1/127) floored at 1e-12, an IEEE-rounded q / qs, round half to
//     even, clamp to +-127), the score is the exact s8 x s8 -> s32 product
//     dequantized as (s_int * (q_scale * scale)) * k_scale[col], and p is
//     scaled by v_scale[col] before P V (l sums the unscaled p);
//   * splits merge in the same launch: each live split writes its partial
//     to the workspace and takes a ticket; the last of an (atom, group) resets
//     the ticket and merges all its splits in split order, so two launches
//     give the same bits. A past of one split writes its output directly;
//   * head dims 64, 96, 128 and 256. At d = 256 a warp's m16 x d output is
//     128 fp32 a thread, so the query's A fragments (64 registers in bf16
//     and int4) leave registers: the prologue writes them to shared memory
//     in fragment order (one 16-byte row a lane and k step) and each k step
//     of the score reads its own back; one CTA an SM there.
// Not yet: one work list over the live splits instead of a grid sized for
// the table's nb_max (the dead CTAs of short pasts cost a launch each), and
// TMA copies of whole blocks.
#include "flash_mma.cuh"
#include "int_unpack.cuh"

namespace dst {

// WARPS warps a CTA, 16 columns of each TN-column tile a warp; STAGES tiles in
// the ring; minb(BITS, HD) CTAs an SM for __launch_bounds__ (int8 fits three
// without spills up to d = 128, and a decode_batch step's grid in one wave;
// the others spill at three; d = 256 runs one: its O and, for bf16, its
// shared memory). ROWS query heads a CTA: one m16 tile. A split's block ids
// are looked up into shared memory, at most MAX_BPS of them; a grid has at
// most MAX_SPLITS splits an atom (the wrapper's decode_splits keeps both; a
// CPU test reads them from here).
constexpr int WARPS = 4, NT = 32 * WARPS, TN = 16 * WARPS, STAGES = 3;
constexpr int minb(int bits, int hd) { return hd > 128 ? 1 : bits == 8 ? 3 : 2; }
constexpr int ROWS = 16;
constexpr int MAX_BPS = 128, MAX_SPLITS = 64;
constexpr float DEC_NEG_INF = -1e30f;  // masked score, empty running max

// Shared memory: the ring (stage s: K rows, V rows, then an int pool's k and v
// scales of the tile's columns), which the warps' scaled O reuses once the
// walk is done; then the split's block ids, the warps' row statistics, the
// merge's per-split (m, l) -- then (factor, l) -- and row statistics, the
// ticket's verdict and, at d = 256 (not QREG), the query's A fragments.
template <int BITS, int HD>
struct DecTiles {
  static constexpr bool INT = BITS != 16;
  static constexpr int KSTEPS = BITS == 8 ? HD / 32 : HD / 16;  // k steps of the score
  static constexpr bool QREG = HD <= 128;  // the query's fragments stay in registers
  static constexpr int PITCH = INT ? HD + 16 : 2 * (HD + 8);  // row bytes, 16 of skew
  static constexpr int KV_BYTES = TN * PITCH;
  static constexpr int STAGE = 2 * KV_BYTES + (INT ? 2 * TN * 4 : 0);
  static constexpr size_t RING = size_t(STAGES) * STAGE;
  static constexpr int OBP = HD + 4;  // fp32 pitch of the warps' O rows
  static constexpr size_t MERGE = size_t(WARPS) * ROWS * OBP * 4;
  static constexpr size_t BT_OFF = RING > MERGE ? RING : MERGE;
  static constexpr size_t WST_OFF = BT_OFF + MAX_BPS * 4;
  static constexpr size_t FAC_OFF = WST_OFF + WARPS * ROWS * 2 * 4;
  static constexpr size_t RST_OFF = FAC_OFF + ROWS * MAX_SPLITS * 8;
  static constexpr size_t FLAG_OFF = RST_OFF + ROWS * 2 * 4;
  static constexpr size_t QF_OFF = FLAG_OFF + 16;  // [KSTEPS][32 lanes] uint4
  static constexpr size_t BYTES = QF_OFF + (QREG ? 0 : KSTEPS * 32 * 16);
};

struct DecArgs {
  const bf16* q;             // [A, H, hd]
  const unsigned char* kp;   // pools [L, nbp1, bs, lanes]: bf16, int8 or int4 bytes
  const unsigned char* vp;
  const float* kv_scale;     // [L, nbp1, 1, 2 bs] (int pools)
  const int* bt;             // [S, nb_max] physical block ids, by SLOT
  const int* slot;           // [A]
  const int* pos0;           // [A] pool frontier: columns < pos0 are cached
  const int* rowpos;         // [A] query position (window anchor)
  float* ws;                 // [A, H, nsplit, hd] partials, then [A, H, nsplit, 2] (m, l)
  int* tickets;              // [A, gridDim.y], zero between launches
  float* acc;                // [A, H, hd]
  float* m;                  // [A, H]
  float* l;                  // [A, H]
  int layer, nbp1, bs, H, K, nb_max, A, window, bps, nsplit;
  float scale;
};

// c += a b, m16n8k32, s8 x s8 -> s32. Lane = 4 g + t: a holds rows g (a0, a2)
// and g + 8 (a1, a3) at bytes 4t .. 4t + 3 (a0, a1) and 16 + 4t .. (a2, a3); b
// holds column g at the same bytes; c rows g, g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rows g (half 0) or g + 8 (half 1) of an A fragment, the other half zero:
// a paired int4 CTA's products of one kv head's group.
__device__ __forceinline__ void half_rows(uint32_t (&h)[4], const uint32_t (&a)[4], int half) {
  h[0] = half ? 0u : a[0];
  h[1] = half ? a[1] : 0u;
  h[2] = half ? 0u : a[2];
  h[3] = half ? a[3] : 0u;
}

__device__ __forceinline__ uint32_t pack_s8x4(const float (&v)[4]) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (uint32_t(int(v[i])) & 0xFFu) << (8 * i);
  return w;
}

// ldmatrix address of lane `lane` over a warp's 16 byte rows (pitch `pitch`):
// matrices (rows 0-7, bytes b .. b + 15), (rows 8-15, same), (rows 0-7,
// b + 16 ..), (rows 8-15, b + 16 ..) -- two 16-byte chunks of both n8 halves.
__device__ __forceinline__ uint32_t byte_rows_addr(const unsigned char* rows, int pitch, int b,
                                                   int lane) {
  return smem_u32(rows + (((lane >> 3) & 1) * 8 + (lane & 7)) * pitch + b + (lane >> 4) * 16);
}

template <int BITS, bool PAIR, int HD>
__global__ void __launch_bounds__(NT, minb(BITS, HD)) paged_decode_kernel(const DecArgs a) {
  using T = DecTiles<BITS, HD>;
  constexpr bool INT = T::INT, QREG = T::QREG;
  constexpr int PITCH = T::PITCH;
  constexpr int LDE = HD + 8;  // bf16 row pitch in elements
  extern __shared__ __align__(128) unsigned char smem[];
  int* bt_s = reinterpret_cast<int*>(smem + T::BT_OFF);
  float* wst = reinterpret_cast<float*>(smem + T::WST_OFF);  // [WARPS][ROWS][m, l]
  float* rst = reinterpret_cast<float*>(smem + T::RST_OFF);  // [ROWS][m, l]
  int* flag = reinterpret_cast<int*>(smem + T::FLAG_OFF);
  uint4* qfs = reinterpret_cast<uint4*>(smem + T::QF_OFF);  // !QREG: [KSTEPS][32]

  const int at = blockIdx.x, y = blockIdx.y, z = blockIdx.z;
  // the atom's live blocks [lo, lo + nblk), by _past_ranges' formula (C's
  // division truncates where floor would not only below 0, clamped to 0)
  const int p0 = a.pos0[at], rp = a.rowpos[at], s = a.slot[at];
  const int lo = a.window > 0 ? max((rp - (a.window - 1)) / a.bs, 0) : 0;
  const int nblk = p0 > 0 ? max(min((p0 - 1) / a.bs, a.nb_max - 1) - lo + 1, 0) : 0;
  const int nlive = (nblk + a.bps - 1) / a.bps;
  if (z >= max(nlive, 1)) return;  // past the atom's live blocks

  // the CTA's query rows: r < 8 and r >= 8 of the m16 tile
  const int rep = a.H / a.K;
  int kk, nch = 1;
  if constexpr (PAIR) {
    kk = y;  // heads of kv heads kk (rows 0-7) and kk + K / 2 (rows 8-15)
  } else {
    nch = (rep + ROWS - 1) / ROWS;  // 16-head chunks of a group
    kk = y / nch;
  }
  auto head_of = [&](int r) {
    if constexpr (PAIR) {
      const int rr = r & 7;
      return rr < rep ? (kk + (r >> 3) * (a.K / 2)) * rep + rr : -1;
    } else {
      const int rr = (y % nch) * ROWS + r;
      return rr < rep ? kk * rep + rr : -1;
    }
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t HH = size_t(a.H);

  if (nlive == 0) {  // nothing visible: m = -1e30, l = 0, acc = 0
    for (int i = threadIdx.x; i < ROWS * HD; i += NT) {
      const int h = head_of(i / HD);
      if (h < 0) continue;
      const size_t row = size_t(at) * HH + h;
      a.acc[row * HD + i % HD] = 0.f;
      if (i % HD == 0) {
        a.m[row] = DEC_NEG_INF;
        a.l[row] = 0.f;
      }
    }
    return;
  }

  // the split: blocks [b0, b0 + nb), columns [c_lo, c_hi)
  const int b0 = lo + z * a.bps, nb = min(a.bps, nblk - z * a.bps);
  const int c_lo = b0 * a.bs, c_hi = min(p0, (b0 + nb) * a.bs);
  const int ntiles = (c_hi - c_lo + TN - 1) / TN;
  for (int i = threadIdx.x; i < nb; i += NT) bt_s[i] = a.bt[size_t(s) * a.nb_max + b0 + i];
  __syncthreads();

  // a column's block and row in it: shifts for a power-of-two block size
  const int bs_shift = (a.bs & (a.bs - 1)) == 0 ? __ffs(a.bs) - 1 : -1;
  // (the block's index in the layer-stacked pool, the column's row in it)
  auto block_row = [&](int c) {
    const int cc = c - c_lo;  // >= 0: the split starts a block
    const int blk = bs_shift >= 0 ? cc >> bs_shift : cc / a.bs;
    const int off = bs_shift >= 0 ? cc & (a.bs - 1) : cc - blk * a.bs;
    return make_int2(a.layer * a.nbp1 + bt_s[blk], off);
  };

  // byte offset of the CTA's kv head in a pool row, per 16-byte chunk
  const size_t row_bytes = INT ? (BITS == 8 ? size_t(a.K) * HD : size_t(a.K) * HD / 2)
                               : size_t(a.K) * HD * 2;
  const int half = a.K * HD / 2;  // int4: features >= half are high nibbles
  auto chunk_off = [&](int ch) {
    if constexpr (!INT) return kk * HD * 2 + ch * 16;
    if constexpr (BITS == 8 || PAIR) return kk * HD + ch * 16;
    const int f = kk * HD + ch * 16;
    return f < half ? f : f - half;
  };
  auto issue = [&](int i) {  // tile i into stage i % STAGES
    if (i < ntiles) {
      unsigned char* st = smem + (i % STAGES) * T::STAGE;
      const int c0 = c_lo + i * TN;
      constexpr int CH = INT ? HD / 16 : HD / 8;  // 16-byte chunks a row
      static_assert(2 * TN * CH % NT == 0, "whole copies a thread");
      // d = 256: 16 or 32 copies a thread, four an iteration (their
      // addresses all computed ahead of the copies spill)
      constexpr int COPIES = 2 * TN * CH / NT;
      unrolled<COPIES, QREG ? COPIES : 4>([&](int it) {
        const int idx = threadIdx.x + it * NT;
        const int which = idx / (TN * CH), r = idx / CH % TN, ch = idx % CH;
        const int c = c0 + r;
        const bool ok = c < c_hi;
        size_t off = 0;
        if (ok) {
          const int2 br = block_row(c);
          off = (size_t(br.x) * a.bs + br.y) * row_bytes + chunk_off(ch);
        }
        cp_async16(smem_u32(st + which * T::KV_BYTES + r * PITCH + ch * 16),
                   (which ? a.vp : a.kp) + off, ok ? 16 : 0);
      });
      if constexpr (INT) {
        static_assert(2 * TN == NT, "one scale a thread");
        const int which = threadIdx.x / TN, r = threadIdx.x % TN, c = c0 + r;
        const bool ok = c < c_hi;
        // kv_scale [L, nbp1, 1, 2 bs]: a block's k scales, then its v scales
        const float* src = a.kv_scale;
        if (ok) {
          const int2 br = block_row(c);
          src += size_t(br.x) * 2 * a.bs + which * a.bs + br.y;
        }
        cp_async4(smem_u32(st + 2 * T::KV_BYTES + (which * TN + r) * 4), src, ok ? 4 : 0);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // the query's A fragments, while the ring fills: bf16 and int4 straight
  // from global memory, rows g and g + 8
  const bf16* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = head_of(g + 8 * r);
    qrow[r] = h >= 0 ? a.q + (size_t(at) * HH + h) * HD : nullptr;
  }
  constexpr int KSTEPS = T::KSTEPS;
  uint32_t qf[KSTEPS][4];
  float qsc[2] = {0.f, 0.f};  // int8: the rows' q-hat scales
  if constexpr (BITS == 16) {
    // natural order: a0 = row g at k 2t, 2t + 1; a2 at 8 + 2t, ..
#pragma unroll
    for (int kd = 0; kd < KSTEPS; ++kd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(qrow[r] + kd * 16 + 2 * t);
        qf[kd][r] = qrow[r] ? p[0] : 0u;
        qf[kd][2 + r] = qrow[r] ? p[4] : 0u;
      }
  } else if constexpr (BITS == 4) {
    // k positions (2t, 2t + 1) carry features (4t, 4t + 2) and (2t + 8, 2t + 9)
    // features (4t + 1, 4t + 3) of the 16-feature step: frag_int4's pairs
#pragma unroll
    for (int kd = 0; kd < KSTEPS; ++kd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint2 w = make_uint2(0u, 0u);
        if (qrow[r]) w = *reinterpret_cast<const uint2*>(qrow[r] + kd * 16 + 4 * t);
        qf[kd][r] = __byte_perm(w.x, w.y, 0x5410);
        qf[kd][2 + r] = __byte_perm(w.x, w.y, 0x7632);
      }
  } else {
    // int8 q-hat, bit for bit _quantize_q_rows, computed once a CTA: 8
    // threads a row, HD / 8 features each, into the ring's last stage (free
    // until the walk's first barrier), then each warp's A fragments from there
    constexpr int PER = HD / 8;
    constexpr int QP = HD + 16;  // byte pitch of a q-hat row
    int8_t* q8 = reinterpret_cast<int8_t*>(smem + (STAGES - 1) * T::STAGE);
    float* qs_s = reinterpret_cast<float*>(q8 + ROWS * QP);
    const int row = threadIdx.x >> 3, part = threadIdx.x & 7;
    const int h = head_of(row);
    float v[PER];
    float amax = 0.f;
    const bf16* qsrc = a.q + (size_t(at) * HH + (h >= 0 ? h : 0)) * HD + part * PER;
    if constexpr (PER % 8 == 0) {  // 16-byte loads of 8 features
#pragma unroll
      for (int c = 0; c < PER / 8; ++c) {
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (h >= 0) w = *reinterpret_cast<const uint4*>(qsrc + c * 8);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[c * 8 + 2 * e] = __low2float(x[e]);
          v[c * 8 + 2 * e + 1] = __high2float(x[e]);
        }
      }
    } else {  // d = 96: 12 features a thread, 8-byte loads of 4
#pragma unroll
      for (int c = 0; c < PER / 4; ++c) {
        uint2 w = make_uint2(0u, 0u);
        if (h >= 0) w = *reinterpret_cast<const uint2*>(qsrc + c * 4);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[c * 4 + 2 * e] = __low2float(x[e]);
          v[c * 4 + 2 * e + 1] = __high2float(x[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) amax = fmaxf(amax, fabsf(v[e]));
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, sh));
    const float qs = fmaxf(amax * (1.0f / 127.0f), 1e-12f);
#pragma unroll
    for (int c = 0; c < PER / 4; ++c) {
      float qv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qv[e] = fminf(fmaxf(rintf(__fdiv_rn(v[4 * c + e], qs)), -127.f), 127.f);
      *reinterpret_cast<uint32_t*>(q8 + row * QP + part * PER + 4 * c) = pack_s8x4(qv);
    }
    if (part == 0) qs_s[row] = qs;
    __syncthreads();
    // A fragments: a0 / a1 rows g / g + 8 at bytes 32 kd + 4t, a2 / a3 at + 16
#pragma unroll
    for (int kd = 0; kd < KSTEPS; ++kd)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qf[kd][r] = *reinterpret_cast<const uint32_t*>(q8 + (g + 8 * (r & 1)) * QP + kd * 32 +
                                                       16 * (r >> 1) + 4 * t);
    qsc[0] = qs_s[g];
    qsc[1] = qs_s[g + 8];
  }
  if constexpr (!QREG) {  // every warp holds the same fragments: warp 0 writes them
    if (warp == 0) {
#pragma unroll
      for (int kd = 0; kd < KSTEPS; ++kd)
        qfs[kd * 32 + lane] = make_uint4(qf[kd][0], qf[kd][1], qf[kd][2], qf[kd][3]);
    }
  }
  // the query's A fragment of k step kd (read back after the walk's first barrier)
  auto qfrag = [&](uint32_t (&f)[4], int kd) {
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = qf[kd][e];
    } else {
      const uint4 w = qfs[kd * 32 + lane];
      f[0] = w.x;
      f[1] = w.y;
      f[2] = w.z;
      f[3] = w.w;
    }
  };

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {DEC_NEG_INF, DEC_NEG_INF};  // running max, rows g and g + 8
  float l[2] = {0.f, 0.f};                  // this thread's columns' share

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i landed for this thread's copies
    __syncthreads();              // ... for every thread's; tile i - 1's stage is free
    issue(i + STAGES - 1);
    const unsigned char* st = smem + (i % STAGES) * T::STAGE;
    const unsigned char* ks = st + warp * 16 * PITCH;  // the warp's 16 columns
    const unsigned char* vs = ks + T::KV_BYTES;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * T::KV_BYTES) + warp * 16;
    const float* vsc = ksc + TN;

    // S for the warp's two n8 column tiles (raw products)
    float sc[2][4];
    if constexpr (BITS == 8) {
      int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      // the query from shared memory (d = 256): two k steps an iteration
      unrolled<KSTEPS, QREG ? KSTEPS : 2>([&](int kd) {
        uint32_t kb[4], qa[4];  // (cols 0-7 | 8-15) x (bytes 32 kd .. + 15 | + 16 ..)
        ldsm_x4(kb, byte_rows_addr(ks, PITCH, kd * 32, lane));
        qfrag(qa, kd);
        mma_s8(si[0], qa, kb[0], kb[2]);
        mma_s8(si[1], qa, kb[1], kb[3]);
      });
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = float(si[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if constexpr (BITS == 16) {
        const bf16* kr = reinterpret_cast<const bf16*>(ks);
        unrolled<KSTEPS, QREG ? KSTEPS : 2>([&](int kd) {
          uint32_t kb[4], qa[4];  // (cols 0-7, d lo), (0-7, d hi), (8-15, d lo), (8-15, d hi)
          ldsm_x4(kb, smem_u32(kr + ((lane >> 4) * 8 + (lane & 7)) * LDE + kd * 16 +
                               ((lane >> 3) & 1) * 8));
          qfrag(qa, kd);
          mma_bf16(sc[0], qa, kb[0], kb[1]);
          mma_bf16(sc[1], qa, kb[2], kb[3]);
        });
      } else {
        unrolled<HD / 32, QREG ? HD / 32 : 1>([&](int k2) {
          uint32_t kb[4];  // (cols 0-7 | 8-15) x (chunk 2 k2 | 2 k2 + 1)
          ldsm_x4(kb, byte_rows_addr(ks, PITCH, k2 * 32, lane));
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kd = 2 * k2 + c;
            uint32_t qa[4];
            qfrag(qa, kd);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint2 lo4, hi4;
              frag_int4(kb[2 * c + j], lo4, hi4);
              if constexpr (PAIR) {
                uint32_t qh[4];
                half_rows(qh, qa, 0);
                mma_bf16(sc[j], qh, lo4.x, lo4.y);
                half_rows(qh, qa, 1);
                mma_bf16(sc[j], qh, hi4.x, hi4.y);
              } else {
                const uint2 b = kk * HD + kd * 16 >= half ? hi4 : lo4;
                mma_bf16(sc[j], qa, b.x, b.y);
              }
            }
          }
        });
      }
    }

    // scores, masks and the online softmax of the warp's 16 columns
    const int cw = c_lo + i * TN + warp * 16;
    float2 kscale[2], vscale[2];
    if constexpr (INT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kscale[j] = *reinterpret_cast<const float2*>(ksc + j * 8 + 2 * t);
        vscale[j] = *reinterpret_cast<const float2*>(vsc + j * 8 + 2 * t);
      }
    }
    bool keep[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cw + j * 8 + 2 * t + e;
        keep[j][e] = c < c_hi && (a.window <= 0 || c > rp - a.window);
      }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = sc[j][e];
        if constexpr (BITS == 8) {
          x = (x * (qsc[r] * a.scale)) * (e & 1 ? kscale[j].y : kscale[j].x);
        } else if constexpr (BITS == 4) {
          x = (x * a.scale) * (e & 1 ? kscale[j].y : kscale[j].x);
        } else {
          x = x * a.scale;
        }
        sc[j][e] = keep[j][e & 1] ? x : DEC_NEG_INF;
        mx[r] = fmaxf(mx[r], sc[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = keep[j][e & 1] ? expf(sc[j][e] - mx[e >> 1]) : 0.f;
        psum[e >> 1] += p;
        if constexpr (INT) {
          sc[j][e] = p * (e & 1 ? vscale[j].y : vscale[j].x);
        } else {
          sc[j][e] = p;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float corr = expf(m[r] - mx[r]);  // 0 when m was empty, 1 when nothing new
      m[r] = mx[r];
      l[r] = l[r] * corr + psum[r];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: P's two n8 tiles are one k16 A fragment
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    if constexpr (BITS == 16) {
      const bf16* vr = reinterpret_cast<const bf16*>(vs);
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t vb[4];  // (cols 0-7, d), (cols 8-15, d), (cols 0-7, d + 8), (cols 8-15, d + 8)
        ldsm_x4_trans(vb, smem_u32(vr + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDE + dn * 16 +
                                   (lane >> 4) * 8));
        mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    } else {
      // o[2 c] holds features 16 c + 2 n of its columns n, o[2 c + 1] 16 c + 2 n + 1
#pragma unroll
      for (int k2 = 0; k2 < HD / 32; ++k2) {
        uint32_t vb[4];  // (cols 0-7 | 8-15) x (chunk 2 k2 | 2 k2 + 1), transposed
        ldsm_x4_trans(vb, byte_rows_addr(vs, PITCH, k2 * 32, lane));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ch = 2 * k2 + c;
          if constexpr (BITS == 8) {
            const uint2 v0 = frag_int8(vb[2 * c]), v8 = frag_int8(vb[2 * c + 1]);
            mma_bf16(o[2 * ch], pa, v0.x, v8.x);
            mma_bf16(o[2 * ch + 1], pa, v0.y, v8.y);
          } else {
            uint2 lo0, hi0, lo8, hi8;
            frag_int4(vb[2 * c], lo0, hi0);
            frag_int4(vb[2 * c + 1], lo8, hi8);
            if constexpr (PAIR) {
              uint32_t ph[4];
              half_rows(ph, pa, 0);
              mma_bf16(o[2 * ch], ph, lo0.x, lo8.x);
              mma_bf16(o[2 * ch + 1], ph, lo0.y, lo8.y);
              half_rows(ph, pa, 1);
              mma_bf16(o[2 * ch], ph, hi0.x, hi8.x);
              mma_bf16(o[2 * ch + 1], ph, hi0.y, hi8.y);
            } else {
              const bool hi = kk * HD + ch * 16 >= half;
              mma_bf16(o[2 * ch], pa, hi ? hi0.x : lo0.x, hi ? hi8.x : lo8.x);
              mma_bf16(o[2 * ch + 1], pa, hi ? hi0.y : lo0.y, hi ? hi8.y : lo8.y);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the warps' O goes there

  // The live rows of the m16 tile, lr = 0 .. nlr - 1: all 16 rows hold a
  // query head only when a group has 16 (8 a kv head when paired), so the
  // epilogue and the merge walk these alone, 4 floats at a time.
  const int nlr = PAIR ? 2 * rep : min(ROWS, rep - (y % nch) * ROWS);
  auto row_of = [&](int lr) { return PAIR && lr >= rep ? lr - rep + 8 : lr; };
  constexpr int Q4 = HD / 4;  // float4s a row
  const int nitems = nlr * Q4;

  // the warps' partials, merged in warp order: M = max m_w, f_w = e^(m_w - M)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) {
      wst[(warp * ROWS + g + 8 * r) * 2] = m[r];
      wst[(warp * ROWS + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  float* ob = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][OBP], each scaled by f_w
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (head_of(row) < 0) continue;
    float mm = DEC_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, wst[(w * ROWS + row) * 2]);
    const float f = expf(m[r] - mm);
    float* dst = ob + (warp * ROWS + row) * T::OBP;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      // the column pair of o[n]: 2t, 2t + 1 in order (bf16), even / odd features (int)
      const int f0 = INT ? (n >> 1) * 16 + 4 * t + (n & 1) : n * 8 + 2 * t;
      const int df = INT ? 2 : 1;
      dst[f0] = o[n][2 * r] * f;
      dst[f0 + df] = o[n][2 * r + 1] * f;
    }
  }
  if (threadIdx.x < nlr) {
    const int row = row_of(threadIdx.x);
    float mm = DEC_NEG_INF, ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, wst[(w * ROWS + row) * 2]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      ll += expf(wst[(w * ROWS + row) * 2] - mm) * wst[(w * ROWS + row) * 2 + 1];
    rst[row * 2] = mm;
    rst[row * 2 + 1] = ll;
  }
  __syncthreads();

  // a past of one split writes its output; a split of several, its partial
  float* ws_ml = a.ws + size_t(a.A) * HH * a.nsplit * HD;
  for (int it = threadIdx.x; it < nitems; it += NT) {
    const int row = row_of(it / Q4), j = (it % Q4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 y4 = *reinterpret_cast<const float4*>(ob + (w * ROWS + row) * T::OBP + j);
      x.x += y4.x;
      x.y += y4.y;
      x.z += y4.z;
      x.w += y4.w;
    }
    const size_t hrow = size_t(at) * HH + head_of(row);
    float* dst = nlive == 1 ? a.acc + hrow * HD : a.ws + (hrow * a.nsplit + z) * HD;
    *reinterpret_cast<float4*>(dst + j) = x;
  }
  if (threadIdx.x < nlr) {
    const int row = row_of(threadIdx.x);
    const size_t hrow = size_t(at) * HH + head_of(row);
    if (nlive == 1) {
      a.m[hrow] = rst[row * 2];
      a.l[hrow] = rst[row * 2 + 1];
    } else {
      ws_ml[(hrow * a.nsplit + z) * 2] = rst[row * 2];
      ws_ml[(hrow * a.nsplit + z) * 2 + 1] = rst[row * 2 + 1];
    }
  }
  if (nlive == 1) return;

  // the ticket: the last split of (atom, group) to finish merges them all
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // after the barrier: every thread's partial (cumulative)
    int* ticket = a.tickets + size_t(at) * gridDim.y + y;
    const bool last = atomicAdd(ticket, 1) == nlive - 1;
    if (last) *ticket = 0;  // every split has taken its ticket: ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // acc = sum of factor x partial in split order. A thread's first AHEAD
  // splits are loaded before the (m, l) of every split (into shared memory,
  // one round trip) and the factors, so both loads overlap.
  constexpr int AHEAD = 8;
  float4 v[AHEAD];
  auto load = [&](int it, int z0) {
    const size_t hrow = size_t(at) * HH + head_of(row_of(it / Q4));
    const float4* src = reinterpret_cast<const float4*>(a.ws + hrow * a.nsplit * HD) + it % Q4;
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      v[u] = z0 + u < nlive ? __ldcg(src + (z0 + u) * Q4) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  if (threadIdx.x < nitems) load(threadIdx.x, 0);
  float2* mls = reinterpret_cast<float2*>(smem + T::FAC_OFF);  // [ROWS][MAX_SPLITS]
  const float2* ws_ml2 = reinterpret_cast<const float2*>(ws_ml);
  for (int i = threadIdx.x; i < nlr * nlive; i += NT) {
    const int row = row_of(i / nlive), zz = i % nlive;
    mls[row * MAX_SPLITS + zz] =
        __ldcg(ws_ml2 + (size_t(at) * HH + head_of(row)) * a.nsplit + zz);
  }
  __syncthreads();
  if (threadIdx.x < nlr) {
    const int row = row_of(threadIdx.x);
    const size_t hrow = size_t(at) * HH + head_of(row);
    float2* ml = mls + row * MAX_SPLITS;
    float mm = DEC_NEG_INF, ll = 0.f;
    for (int zz = 0; zz < nlive; ++zz) mm = fmaxf(mm, ml[zz].x);
    for (int zz = 0; zz < nlive; ++zz) {
      const float f = expf(ml[zz].x - mm);
      ml[zz].x = f;  // the split's factor from here on
      ll += f * ml[zz].y;
    }
    a.m[hrow] = mm;
    a.l[hrow] = ll;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < nitems; it += NT) {
    const int row = row_of(it / Q4);
    const float2* ml = mls + row * MAX_SPLITS;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < nlive; z0 += AHEAD) {
      if (it != threadIdx.x || z0 > 0) load(it, z0);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (z0 + u >= nlive) break;
        const float f = ml[z0 + u].x;
        x.x += f * v[u].x;
        x.y += f * v[u].y;
        x.z += f * v[u].z;
        x.w += f * v[u].w;
      }
    }
    const size_t hrow = size_t(at) * HH + head_of(row);
    *reinterpret_cast<float4*>(a.acc + hrow * HD + (it % Q4) * 4) = x;
  }
}

template <int BITS, bool PAIR, int HD>
int launch_decode(const DecArgs& a, int groups, cudaStream_t stream) {
  using T = DecTiles<BITS, HD>;
  auto kern = paged_decode_kernel<BITS, PAIR, HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(T::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.A, groups, a.nsplit), NT, T::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the split and the head grouping, picks the grid's kv head groups and
// the instantiation. Returns the launch's cudaError_t (0 = launched).
template <int BITS>
int launch_any(const DecArgs& a, int hd, cudaStream_t stream) {
  if (a.A <= 0) return 0;
  if (a.K <= 0 || a.H % a.K != 0 || a.bs <= 0 || a.nb_max <= 0 || a.bps < 1 ||
      a.bps > MAX_BPS || a.nsplit < 1 || a.nsplit > MAX_SPLITS ||
      size_t(a.nsplit) * a.bps < size_t(a.nb_max))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = a.H / a.K;
  if constexpr (BITS == 4) {
    if (a.K % 2 == 0 && rep <= 8) {  // both nibbles of every byte
      if (hd == 128) return launch_decode<4, true, 128>(a, a.K / 2, stream);
      if (hd == 64) return launch_decode<4, true, 64>(a, a.K / 2, stream);
      if (hd == 96) return launch_decode<4, true, 96>(a, a.K / 2, stream);
      if (hd == 256) return launch_decode<4, true, 256>(a, a.K / 2, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int groups = a.K * ((rep + ROWS - 1) / ROWS);
  if (hd == 128) return launch_decode<BITS, false, 128>(a, groups, stream);
  if (hd == 64) return launch_decode<BITS, false, 64>(a, groups, stream);
  if (hd == 96) return launch_decode<BITS, false, 96>(a, groups, stream);
  if (hd == 256) return launch_decode<BITS, false, 256>(a, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BITS>
int launch_decode_c(const void* q, const void* kpool, const void* vpool, const float* kv_scale,
                    int layer, int nbp1, int bs, int H, int K, int hd, const int* bt, int nb_max,
                    const int* slot, const int* pos0, const int* rowpos, int A, int window,
                    float scale, int bps, int nsplit, float* ws, int* tickets, float* acc,
                    float* m, float* l, void* stream) {
  DecArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.kp = static_cast<const unsigned char*>(kpool);
  a.vp = static_cast<const unsigned char*>(vpool);
  a.kv_scale = kv_scale;
  a.bt = bt; a.slot = slot; a.pos0 = pos0; a.rowpos = rowpos;
  a.ws = ws; a.tickets = tickets; a.acc = acc; a.m = m; a.l = l;
  a.layer = layer; a.nbp1 = nbp1; a.bs = bs; a.H = H; a.K = K; a.nb_max = nb_max;
  a.A = A; a.window = window; a.bps = bps; a.nsplit = nsplit;
  a.scale = scale;
  return launch_any<BITS>(a, hd, static_cast<cudaStream_t>(stream));
}

}  // namespace dst

extern "C" {

// Kernel A over a bf16 pool. ws: A * H * nsplit * (hd + 2) floats; tickets:
// A * (kv head groups) ints, zero. Returns cudaError_t (0 = launched).
int dst_paged_decode(const void* q, const void* kpool, const void* vpool, int layer, int nbp1,
                     int bs, int H, int K, int hd, const int* bt, int nb_max, const int* slot,
                     const int* pos0, const int* rowpos, int A, int window, float scale,
                     int bps, int nsplit, float* ws, int* tickets, float* acc, float* m,
                     float* l, void* stream) {
  return dst::launch_decode_c<16>(q, kpool, vpool, nullptr, layer, nbp1, bs, H, K, hd, bt,
                                  nb_max, slot, pos0, rowpos, A, window, scale, bps, nsplit, ws,
                                  tickets, acc, m, l, stream);
}

// Kernel A over an int8 pool (q bf16: the q-hat is computed in the kernel).
int dst_paged_decode_int8(const void* q, const void* kpool, const void* vpool,
                          const float* kv_scale, int layer, int nbp1, int bs, int H, int K,
                          int hd, const int* bt, int nb_max, const int* slot, const int* pos0,
                          const int* rowpos, int A, int window, float scale, int bps, int nsplit,
                          float* ws, int* tickets, float* acc, float* m, float* l,
                          void* stream) {
  return dst::launch_decode_c<8>(q, kpool, vpool, kv_scale, layer, nbp1, bs, H, K, hd, bt,
                                 nb_max, slot, pos0, rowpos, A, window, scale, bps, nsplit, ws,
                                 tickets, acc, m, l, stream);
}

// Kernel A over an int4 pool.
int dst_paged_decode_int4(const void* q, const void* kpool, const void* vpool,
                          const float* kv_scale, int layer, int nbp1, int bs, int H, int K,
                          int hd, const int* bt, int nb_max, const int* slot, const int* pos0,
                          const int* rowpos, int A, int window, float scale, int bps, int nsplit,
                          float* ws, int* tickets, float* acc, float* m, float* l,
                          void* stream) {
  return dst::launch_decode_c<4>(q, kpool, vpool, kv_scale, layer, nbp1, bs, H, K, hd, bt,
                                 nb_max, slot, pos0, rowpos, A, window, scale, bps, nsplit, ws,
                                 tickets, acc, m, l, stream);
}

// Dynamic shared memory in bytes at d = 64, 96, 128 and 256, per pool mode
// (extern: a const has internal linkage otherwise).
#define DST_DEC_SMEM(BITS)                                                              \
  {static_cast<int>(dst::DecTiles<BITS, 64>::BYTES),                                    \
   static_cast<int>(dst::DecTiles<BITS, 96>::BYTES),                                    \
   static_cast<int>(dst::DecTiles<BITS, 128>::BYTES),                                   \
   static_cast<int>(dst::DecTiles<BITS, 256>::BYTES)}
extern const int dst_paged_decode_smem_bytes[4] = DST_DEC_SMEM(16);
extern const int dst_paged_decode_int8_smem_bytes[4] = DST_DEC_SMEM(8);
extern const int dst_paged_decode_int4_smem_bytes[4] = DST_DEC_SMEM(4);
#undef DST_DEC_SMEM

}  // extern "C"
