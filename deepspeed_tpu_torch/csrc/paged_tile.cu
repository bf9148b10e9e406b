// Dense-tile paged attention on Hopper: kernel I of the packed=False serving
// engine.
//
// Replaces deepspeed_tpu/ops/paged_attention.py _paged_kernel (:110) via
// _paged_pallas (:161): the query tile q [B, t, H, d] (every slot a row,
// chunks right-padded) over each slot's lane-folded pool [L, nb+1, bs, K d]
// at `layer`. Row i of slot b sits at position p = pos[b] + i and keeps
// columns c <= p (and c > p - window under a window); the tile's own K/V are
// already in the pool. Columns are clamped to the table's nb_max bs: padded
// rows of a deep slot pass the end of the table. Output acc / max(l, 1e-30)
// in bf16, so a row with nothing visible gives 0.
//
// One launch a call, in one of two regimes chosen by the launcher from the
// t rep rows of a GQA group (rep = H / K):
//
// Decode regime (t rep <= 16: a decode step, t = 1). What bounds it: the KV
// bytes -- a decode row does ~1 FLOP per byte of its past, so one CTA a
// (slot, kv head) walking the whole past alone with 16-row tiles of 4 live
// rows leaves the card idle. The design is kernel A's (paged_decode.cu):
//   * grid (B, K, nsplit): the slot's live columns -- from the window start
//     of its oldest row to its newest row, clamped to nb_max bs -- split into
//     runs of `bps` whole pool blocks (the wrapper's paged_tile_splits); a
//     CTA looks its split's block ids up once into shared memory and CTAs
//     past the live blocks exit at once;
//   * the t rep rows of the group (row g = i rep + rr) are the m16 A operand,
//     held in registers (in shared memory at d = 256, in fragment order);
//   * K/V rows stream through a STAGES-deep ring of 16-byte cp.async copies
//     of 64-column tiles, one barrier a tile, zero-filled past the range by
//     the copy's src-size; each warp takes 16 columns of a tile with its own
//     online softmax (S, P and O in registers); the causal and window limits
//     are per row (row g sees columns <= pos + g / rep);
//   * the warps merge in shared memory in warp order; a past of one split
//     writes its normalised bf16 output at once, otherwise each split writes
//     its partial to the workspace and the last CTA of the (slot, kv head),
//     by an atomic ticket, merges the splits in split order and normalises.
//
// Tile regime (t rep > 16: a prompt or a chunk). What bounds it: the causal
// score operations, ~4 d FLOPs a visible (row, column) pair, so S, P and O
// stay in registers and the loads overlap the math. The design is kernel
// D's register-resident flash (flash_fwd_tile.cuh), the same tile body:
//   * a CTA owns 64 query rows -- one head's tokens, 16 a warp -- grid
//     (H, B, q tiles) with the q tiles reversed so the longest causal tiles
//     launch first; the heads of a GQA group are neighbouring CTAs and share
//     each K/V tile through L2. Rows of (token, head) pairs would share it
//     through shared memory instead, but each CTA would still do 64 rows of
//     work per K/V tile it loads, and it would give up D's tile body and its
//     bits; with one head's rows, I at pos = 0 equals D bit for bit;
//   * Q kept as ldmatrix fragments, S = Q K^T and O += P V on mma.sync
//     m16n8k16 with fp32 accumulators in registers, P packed into A
//     fragments without touching shared memory;
//   * K/V tiles through a 3-stage cp.async ring, one barrier a tile, rows
//     padded by 16 bytes; a column's pool row is looked up in the slot's
//     block table once a tile (64 threads, one column each, a warp's loads
//     falling on the one or two blocks the tile spans), one tile ahead of
//     its copies, into a small shared table the copies read;
//   * masks only on tiles that cross a row's causal limit, its window edge
//     or nb_max bs;
//   * at d = 256 two CTAs split O's columns (each computes the whole score)
//     and Q's fragments come from a shared tile, as in D.
// Not yet: wgmma and TMA copies of whole blocks with a producer warp, and a
// work list over the decode regime's live splits (a grid sized for the
// table's nb_max launches CTAs that exit at once).
#include "flash_fwd_tile.cuh"

namespace dst {

struct TileArgs {
  const bf16* q;   // [B, t, H, hd]
  const bf16* kp;  // pools [L, nbp1, bs, K * hd]
  const bf16* vp;
  const int* bt;   // [B, nb_max] physical block ids
  const int* pos;  // [B] tokens cached before the tile
  float* ws;       // decode: [B, K, t rep, nsplit, hd] partials, then (m, l)
  int* tickets;    // decode: [B, K], zero between launches
  bf16* out;       // [B, t, H, hd]
  int layer, nbp1, bs, H, K, nb_max, t, window, bps, nsplit;
  float scale;
};

// The slot's live columns [c_lo, c_hi) for its tokens i0 .. i1 - 1: from the
// window start of the oldest to the newest, clamped to the table.
__device__ __forceinline__ int2 live_cols(const TileArgs& a, int p0, int i0, int i1) {
  const int c_lo = a.window > 0 ? max(0, p0 + i0 - (a.window - 1)) : 0;
  return make_int2(c_lo, min(p0 + i1, a.nb_max * a.bs));
}

// ---------------------------------------------------------------------------
// decode regime
// ---------------------------------------------------------------------------

// DWARPS warps a CTA, 16 columns of each DTN-column tile a warp; DSTAGES
// tiles in the ring; ROWS query rows a CTA (one m16 tile: t rep <= ROWS). A
// split's block ids are looked up into shared memory, at most MAX_BPS of
// them; a grid has at most MAX_SPLITS splits a slot (the wrapper's
// paged_tile_splits keeps both; a CPU test reads them from here).
constexpr int DWARPS = 4, DNT = 32 * DWARPS, DTN = 16 * DWARPS, DSTAGES = 3;
constexpr int ROWS = 16;
constexpr int MAX_BPS = 128, MAX_SPLITS = 64;

// Shared memory: the ring (stage s: K rows, then V rows), which the warps'
// scaled O reuses once the walk is done; then the split's block ids, the
// warps' row statistics, the merge's per-split (m, l) -- then (factor, l) --
// and row statistics, the ticket's verdict and, at d = 256 (not QREG), the
// query's A fragments.
template <int HD>
struct DecodeTiles {
  static constexpr int KSTEPS = HD / 16;
  static constexpr bool QREG = HD <= 128;  // the query's fragments stay in registers
  static constexpr int LDE = HD + 8;       // bf16 row pitch: 16 bytes of skew
  static constexpr int KV_BYTES = DTN * LDE * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr size_t RING = size_t(DSTAGES) * STAGE;
  static constexpr int OBP = HD + 4;  // fp32 pitch of the warps' O rows
  static constexpr size_t MERGE = size_t(DWARPS) * ROWS * OBP * 4;
  static constexpr size_t BT_OFF = RING > MERGE ? RING : MERGE;
  static constexpr size_t WST_OFF = BT_OFF + MAX_BPS * 4;
  static constexpr size_t FAC_OFF = WST_OFF + DWARPS * ROWS * 2 * 4;
  static constexpr size_t RST_OFF = FAC_OFF + ROWS * MAX_SPLITS * 8;
  static constexpr size_t FLAG_OFF = RST_OFF + ROWS * 2 * 4;
  static constexpr size_t QF_OFF = FLAG_OFF + 16;  // [KSTEPS][32 lanes] uint4
  static constexpr size_t BYTES = QF_OFF + (QREG ? 0 : KSTEPS * 32 * 16);
};

// four fp32 values / den as bf16, one 8-byte store
__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 x, float den) {
  const float inv = 1.f / den;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(x.x * inv, x.y * inv), pack_bf16(x.z * inv, x.w * inv));
}

template <int HD>
__global__ void __launch_bounds__(DNT, HD > 128 ? 1 : 2)
    paged_tile_decode_kernel(const TileArgs a) {
  using T = DecodeTiles<HD>;
  constexpr bool QREG = T::QREG;
  constexpr int LDE = T::LDE;
  extern __shared__ __align__(128) unsigned char smem[];
  int* bt_s = reinterpret_cast<int*>(smem + T::BT_OFF);
  float* wst = reinterpret_cast<float*>(smem + T::WST_OFF);  // [DWARPS][ROWS][m, l]
  float* rst = reinterpret_cast<float*>(smem + T::RST_OFF);  // [ROWS][m, l]
  int* flag = reinterpret_cast<int*>(smem + T::FLAG_OFF);
  uint4* qfs = reinterpret_cast<uint4*>(smem + T::QF_OFF);  // !QREG: [KSTEPS][32]

  const int b = blockIdx.x, kk = blockIdx.y, z = blockIdx.z;
  const int rep = a.H / a.K, nr = a.t * rep;  // live rows of the m16 tile
  const int p0 = a.pos[b];
  const int2 live = live_cols(a, p0, 0, a.t);
  const int lo = live.x / a.bs;
  const int nblk = live.y > live.x ? (live.y - 1) / a.bs + 1 - lo : 0;
  const int nlive = (nblk + a.bps - 1) / a.bps;
  if (z >= max(nlive, 1)) return;  // past the slot's live blocks

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // row r of the tile: token r / rep of the slot at head kk rep + r % rep
  auto row_off = [&](int r) {
    return ((size_t(b) * a.t + r / rep) * a.H + kk * rep + r % rep) * HD;
  };
  constexpr int Q4 = HD / 4;  // float4s a row
  const int nitems = nr * Q4;

  if (nlive == 0) {  // nothing visible: zeros
    for (int it = threadIdx.x; it < nitems; it += DNT)
      *reinterpret_cast<uint2*>(a.out + row_off(it / Q4) + (it % Q4) * 4) = make_uint2(0u, 0u);
    return;
  }

  // the split: blocks [b0, b0 + nb), columns [c_lo, c_hi)
  const int b0 = lo + z * a.bps, nb = min(a.bps, nblk - z * a.bps);
  const int c_lo = max(live.x, b0 * a.bs), c_hi = min(live.y, (b0 + nb) * a.bs);
  const int ntiles = (c_hi - c_lo + DTN - 1) / DTN;
  for (int i = threadIdx.x; i < nb; i += DNT) bt_s[i] = a.bt[size_t(b) * a.nb_max + b0 + i];
  __syncthreads();

  // a column's block and row in it: shifts for a power-of-two block size
  const int bs_shift = (a.bs & (a.bs - 1)) == 0 ? __ffs(a.bs) - 1 : -1;
  // (the block's index in the layer-stacked pool, the column's row in it)
  auto block_row = [&](int c) {
    const int cc = c - b0 * a.bs;  // >= 0: the split starts a block
    const int blk = bs_shift >= 0 ? cc >> bs_shift : cc / a.bs;
    const int off = bs_shift >= 0 ? cc & (a.bs - 1) : cc - blk * a.bs;
    return make_int2(a.layer * a.nbp1 + bt_s[blk], off);
  };
  const size_t row_bytes = size_t(a.K) * HD * 2;
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(a.kp);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(a.vp);
  auto issue = [&](int i) {  // tile i into stage i % DSTAGES
    if (i < ntiles) {
      unsigned char* st = smem + (i % DSTAGES) * T::STAGE;
      const int c0 = c_lo + i * DTN;
      constexpr int CH = HD / 8;  // 16-byte chunks a row
      static_assert(2 * DTN * CH % DNT == 0, "whole copies a thread");
      // d = 256: 32 copies a thread, four an iteration (their addresses all
      // computed ahead of the copies spill)
      constexpr int COPIES = 2 * DTN * CH / DNT;
      unrolled<COPIES, QREG ? COPIES : 4>([&](int it) {
        const int idx = threadIdx.x + it * DNT;
        const int which = idx / (DTN * CH), r = idx / CH % DTN, ch = idx % CH;
        const int c = c0 + r;
        const bool ok = c < c_hi;
        size_t off = 0;
        if (ok) {
          const int2 br = block_row(c);
          off = (size_t(br.x) * a.bs + br.y) * row_bytes + kk * HD * 2 + ch * 16;
        }
        cp_async16(smem_u32(st + which * T::KV_BYTES + r * LDE * 2 + ch * 16),
                   (which ? vp : kp) + off, ok ? 16 : 0);
      });
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < DSTAGES - 1; ++i) issue(i);

  // the query's A fragments, rows g and g + 8, while the ring fills
  constexpr int KSTEPS = T::KSTEPS;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bf16* qrow = g + 8 * r < nr ? a.q + row_off(g + 8 * r) : nullptr;
#pragma unroll
    for (int kd = 0; kd < KSTEPS; ++kd) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(qrow + kd * 16 + 2 * t);
      qf[kd][r] = qrow ? p[0] : 0u;
      qf[kd][2 + r] = qrow ? p[4] : 0u;
    }
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

  // rows g and g + 8: live, and their positions (the causal limit)
  const bool live_r[2] = {g < nr, g + 8 < nr};
  const int rp[2] = {p0 + g / rep, p0 + (g + 8) / rep};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {FWD_NEG_INF, FWD_NEG_INF};  // running max, rows g and g + 8
  float l[2] = {0.f, 0.f};                  // this thread's columns' share

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<DSTAGES - 2>();  // tile i landed for this thread's copies
    __syncthreads();               // ... for every thread's; tile i - 1's stage is free
    issue(i + DSTAGES - 1);
    const unsigned char* st = smem + (i % DSTAGES) * T::STAGE;
    const bf16* kr = reinterpret_cast<const bf16*>(st) + warp * 16 * LDE;  // the warp's 16 columns
    const bf16* vr = kr + T::KV_BYTES / 2;

    // S for the warp's two n8 column tiles (raw products); the query from
    // shared memory at d = 256: two k steps an iteration
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    unrolled<KSTEPS, QREG ? KSTEPS : 2>([&](int kd) {
      uint32_t kb[4], qa[4];  // (cols 0-7, d lo), (0-7, d hi), (8-15, d lo), (8-15, d hi)
      ldsm_x4(kb, smem_u32(kr + ((lane >> 4) * 8 + (lane & 7)) * LDE + kd * 16 +
                           ((lane >> 3) & 1) * 8));
      qfrag(qa, kd);
      mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma_bf16(sc[1], qa, kb[2], kb[3]);
    });

    // scores, each row's causal and window limits, the online softmax
    const int cw = c_lo + i * DTN + warp * 16;
    float mx[2] = {m[0], m[1]};
    bool keep[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = cw + j * 8 + 2 * t + (e & 1);
        keep[j][e] = live_r[r] && c < c_hi && c <= rp[r] &&
                     (a.window <= 0 || c > rp[r] - a.window);
        sc[j][e] = keep[j][e] ? sc[j][e] * a.scale : FWD_NEG_INF;
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
        const float p = keep[j][e] ? expf(sc[j][e] - mx[e >> 1]) : 0.f;
        psum[e >> 1] += p;
        sc[j][e] = p;
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
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t vb[4];  // (cols 0-7, d), (cols 8-15, d), (cols 0-7, d + 8), (cols 8-15, d + 8)
      ldsm_x4_trans(vb, smem_u32(vr + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDE + dn * 16 +
                                 (lane >> 4) * 8));
      mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the warps' O goes there

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
  float* ob = reinterpret_cast<float*>(smem);  // [DWARPS][ROWS][OBP], each scaled by f_w
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (!live_r[r]) continue;
    float mm = FWD_NEG_INF;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) mm = fmaxf(mm, wst[(w * ROWS + row) * 2]);
    const float f = expf(m[r] - mm);
    float* dst = ob + (warp * ROWS + row) * T::OBP;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      dst[n * 8 + 2 * t] = o[n][2 * r] * f;
      dst[n * 8 + 2 * t + 1] = o[n][2 * r + 1] * f;
    }
  }
  if (threadIdx.x < nr) {
    const int row = threadIdx.x;
    float mm = FWD_NEG_INF, ll = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) mm = fmaxf(mm, wst[(w * ROWS + row) * 2]);
#pragma unroll
    for (int w = 0; w < DWARPS; ++w)
      ll += expf(wst[(w * ROWS + row) * 2] - mm) * wst[(w * ROWS + row) * 2 + 1];
    rst[row * 2] = mm;
    rst[row * 2 + 1] = ll;
  }
  __syncthreads();

  // a past of one split writes its output; a split of several, its partial:
  // row r of (slot, kv head) is ws row (b K + kk) nr + r, its splits in order
  const size_t hrow0 = (size_t(b) * a.K + kk) * nr;
  float* ws_ml = a.ws + size_t(a.nsplit) * a.K * gridDim.x * nr * HD;
  for (int it = threadIdx.x; it < nitems; it += DNT) {
    const int row = it / Q4, j = (it % Q4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const float4 y4 = *reinterpret_cast<const float4*>(ob + (w * ROWS + row) * T::OBP + j);
      x.x += y4.x;
      x.y += y4.y;
      x.z += y4.z;
      x.w += y4.w;
    }
    if (nlive == 1)
      store_bf16x4(a.out + row_off(row) + j, x, fmaxf(rst[row * 2 + 1], 1e-30f));
    else
      *reinterpret_cast<float4*>(a.ws + ((hrow0 + row) * a.nsplit + z) * HD + j) = x;
  }
  if (nlive == 1) return;
  if (threadIdx.x < nr) {
    const size_t w = ((hrow0 + threadIdx.x) * a.nsplit + z) * 2;
    ws_ml[w] = rst[threadIdx.x * 2];
    ws_ml[w + 1] = rst[threadIdx.x * 2 + 1];
  }

  // the ticket: the last split of (slot, kv head) to finish merges them all
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // after the barrier: every thread's partial (cumulative)
    int* ticket = a.tickets + size_t(b) * a.K + kk;
    const bool last = atomicAdd(ticket, 1) == nlive - 1;
    if (last) *ticket = 0;  // every split has taken its ticket: ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // acc = sum of factor x partial in split order, normalised by the merged
  // l. A thread's first AHEAD splits are loaded before the (m, l) of every
  // split (into shared memory, one round trip) and the factors, so both
  // loads overlap.
  constexpr int AHEAD = 8;
  float4 v[AHEAD];
  auto load = [&](int it, int z0) {
    const float4* src =
        reinterpret_cast<const float4*>(a.ws + (hrow0 + it / Q4) * a.nsplit * HD) + it % Q4;
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
      v[u] = z0 + u < nlive ? __ldcg(src + (z0 + u) * Q4) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  if (threadIdx.x < nitems) load(threadIdx.x, 0);
  float2* mls = reinterpret_cast<float2*>(smem + T::FAC_OFF);  // [ROWS][MAX_SPLITS]
  const float2* ws_ml2 = reinterpret_cast<const float2*>(ws_ml);
  for (int i = threadIdx.x; i < nr * nlive; i += DNT) {
    const int row = i / nlive, zz = i % nlive;
    mls[row * MAX_SPLITS + zz] = __ldcg(ws_ml2 + (hrow0 + row) * a.nsplit + zz);
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    float2* ml = mls + threadIdx.x * MAX_SPLITS;
    float mm = FWD_NEG_INF, ll = 0.f;
    for (int zz = 0; zz < nlive; ++zz) mm = fmaxf(mm, ml[zz].x);
    for (int zz = 0; zz < nlive; ++zz) {
      const float f = expf(ml[zz].x - mm);
      ml[zz].x = f;  // the split's factor from here on
      ll += f * ml[zz].y;
    }
    rst[threadIdx.x * 2 + 1] = ll;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < nitems; it += DNT) {
    const int row = it / Q4;
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
    store_bf16x4(a.out + row_off(row) + (it % Q4) * 4, x, fmaxf(rst[row * 2 + 1], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// tile regime
// ---------------------------------------------------------------------------

// D's shared memory (FwdTiles), then the pool rows of the columns of the
// STAGES tiles in flight: [STAGES][BN] ints, -1 past the live range.
template <int HD>
struct PagedTiles : FwdTiles<HD> {
  static constexpr size_t ROWS_OFF = FwdTiles<HD>::BYTES;
  static constexpr size_t BYTES = ROWS_OFF + size_t(FwdTiles<HD>::STAGES) * BN * 4;
};

template <int HD>
__global__ void __launch_bounds__(WARPS * 32, MINB) paged_tile_kernel(const TileArgs a) {
  using Tiles = PagedTiles<HD>;
  constexpr int LD = Tiles::LD, BM = Tiles::BM, NT = WARPS * 32, STAGES = Tiles::STAGES;
  constexpr bool QREG = Tiles::Q_REGS;
  static_assert(STAGES >= 2 && NT >= BN, "a ring; a column a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: K at 2 s KV_ELEMS, V after it
  bf16* Qs = ring + (QREG ? STAGES - 1 : STAGES) * 2 * Tiles::KV_ELEMS;
  int* rows_s = reinterpret_cast<int*>(smem + Tiles::ROWS_OFF);

  constexpr int OC = Tiles::OC;
  // head h, O's columns col0 .. col0 + OC
  const int h = blockIdx.x / Tiles::OSPLIT, col0 = (blockIdx.x % Tiles::OSPLIT) * OC;
  const int b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest causal tiles first
  const int nrows = min(BM, a.t - t0);
  const int kvh = h / (a.H / a.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // live columns of the CTA's rows, walked in 64-column tiles from c_lo in
  // order, as kernel D walks them
  const int p0 = a.pos[b];
  const int2 live = live_cols(a, p0, t0, t0 + nrows);
  const int c_lo = live.x, c_hi = live.y;
  const int ntiles = c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN : 0;

  const size_t q_ld = size_t(a.H) * HD, kv_ld = size_t(a.K) * HD;
  const bf16* qg = a.q + (size_t(b) * a.t * a.H + h) * HD;
  const bf16* kg = a.kp + size_t(kvh) * HD;
  const bf16* vg = a.vp + size_t(kvh) * HD;
  const int* btb = a.bt + size_t(b) * a.nb_max;

  // the pool row of tile i's column threadIdx.x (threads < BN), -1 past c_hi
  auto pool_row = [&](int i) {
    const int c = c_lo + i * BN + threadIdx.x;
    if (i >= ntiles || c >= c_hi) return -1;
    const int blk = c / a.bs;
    return (a.layer * a.nbp1 + btb[blk]) * a.bs + (c - blk * a.bs);
  };
  auto issue = [&](int i) {  // tile i's K and V into stage i % STAGES
    if (i < ntiles) {
      bf16* ks = ring + (i % STAGES) * 2 * Tiles::KV_ELEMS;
      const int* rws = rows_s + (i % STAGES) * BN;
      constexpr int CH = HD / 8;
      static_assert(BN * CH % NT == 0, "whole copies per thread");
#pragma unroll
      for (int it = 0; it < BN * CH / NT; ++it) {
        const int idx = threadIdx.x + it * NT;
        const int r = idx / CH, c = idx % CH;
        const int row = rws[r];
        const size_t off = (row >= 0 ? size_t(row) * kv_ld : 0) + c * 8;
        const int n = row >= 0 ? 16 : 0;
        cp_async16(smem_u32(ks + r * LD + c * 8), kg + off, n);
        cp_async16(smem_u32(ks + Tiles::KV_ELEMS + r * LD + c * 8), vg + off, n);
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
  const int qp0 = p0 + t0 + r0;
  const int w_lo = p0 + t0 + warp * 16, w_hi = w_lo + 15;  // the warp's rows

  if constexpr (QREG) {
    if (ntiles > 0) {  // Q's fragments, before any warp may refill Q's stage
      cp_async_wait<STAGES - 2>();
      __syncthreads();
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        ldsm_x4(qf[kd],
                smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8));
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i landed for this thread's copies
    __syncthreads();              // ... for every thread's; tile i - 1's (Q's) stage is free
    issue(i + STAGES - 1);        // its pool rows were staged before this barrier
    // tile i + STAGES's pool rows, into the slot tile i's held: looked up
    // now, stored after the math, read after the next barrier
    const int next = threadIdx.x < BN ? pool_row(i + STAGES) : -1;
    if (warp * 16 < nrows) {  // a warp past the tile's last row has nothing to do
      const int c0 = c_lo + i * BN;
      const bf16* ks = ring + (i % STAGES) * 2 * Tiles::KV_ELEMS;
      const bf16* vs = ks + Tiles::KV_ELEMS;
      float sc[BN / 8][4];
      tile_scores<HD, QREG>(ks, qf, Qs + warp * 16 * LD, sc, lane);
      // masks only where the tile crosses the diagonal, the window's edge
      // or c_hi for one of the warp's rows
      if (c0 + BN > c_hi || c0 + BN - 1 > w_lo || (a.window > 0 && c0 < w_hi - (a.window - 1)))
        tile_softmax_pv<HD, OC, true>(vs, sc, o, m, l, c0, c_hi, qp0, 1, a.window, a.scale,
                                      col0, lane);
      else
        tile_softmax_pv<HD, OC, false>(vs, sc, o, m, l, c0, c_hi, qp0, 1, a.window, a.scale,
                                       col0, lane);
    }
    if (threadIdx.x < BN) rows_s[(i % STAGES) * BN + threadIdx.x] = next;
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: O / l in bf16 into this warp's own Q rows, then 16-byte stores
  // of whole rows
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const int tq = lane & 3;
#pragma unroll
  for (int n = 0; n < OC / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + r0 * LD + col0 + n * 8 + 2 * tq) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(Qs + (r0 + 8) * LD + col0 + n * 8 + 2 * tq) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  constexpr int CH = OC / 8;
  bf16* og = a.out + (size_t(b) * a.t * a.H + h) * HD + col0;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = warp * 16 + idx / CH, c = idx % CH;
    if (r < nrows)
      *reinterpret_cast<uint4*>(og + size_t(t0 + r) * q_ld + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * LD + col0 + c * 8);
  }
}

template <int HD>
int launch_tile_decode(const TileArgs& a, int B, cudaStream_t stream) {
  auto kern = paged_tile_decode_kernel<HD>;
  constexpr size_t bytes = DecodeTiles<HD>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(B, a.K, a.nsplit), DNT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tile_flash(const TileArgs& a, int B, cudaStream_t stream) {
  using Tiles = PagedTiles<HD>;
  auto kern = paged_tile_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Tiles::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.H * Tiles::OSPLIT, B, (a.t + Tiles::BM - 1) / Tiles::BM), WARPS * 32,
         Tiles::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dst

using dst::bf16;

extern "C" {

// Kernel I: the decode regime when t (H / K) <= 16, else the tile regime.
// bps, nsplit, ws (B K t (H / K) nsplit (hd + 2) floats) and tickets (B K
// ints, zero) serve the decode regime only. Returns cudaError_t (0 =
// launched).
int dst_paged_tile(const void* q, const void* kpool, const void* vpool, int layer, int nbp1,
                   int bs, int H, int K, int hd, const int* bt, int nb_max, const int* pos, int B,
                   int t, int window, float scale, int bps, int nsplit, float* ws, int* tickets,
                   void* out, void* stream) {
  if (B <= 0 || t <= 0) return 0;
  if (K <= 0 || H % K != 0 || bs <= 0 || nb_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dst::TileArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.kp = static_cast<const bf16*>(kpool);
  a.vp = static_cast<const bf16*>(vpool);
  a.bt = bt; a.pos = pos; a.ws = ws; a.tickets = tickets;
  a.out = static_cast<bf16*>(out);
  a.layer = layer; a.nbp1 = nbp1; a.bs = bs; a.H = H; a.K = K; a.nb_max = nb_max;
  a.t = t; a.window = window; a.bps = bps; a.nsplit = nsplit;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (t * (H / K) <= dst::ROWS) {
    if (bps < 1 || bps > dst::MAX_BPS || nsplit < 1 || nsplit > dst::MAX_SPLITS ||
        size_t(nsplit) * bps < size_t(nb_max))
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 128) return dst::launch_tile_decode<128>(a, B, st);
    if (hd == 64) return dst::launch_tile_decode<64>(a, B, st);
    if (hd == 96) return dst::launch_tile_decode<96>(a, B, st);
    if (hd == 256) return dst::launch_tile_decode<256>(a, B, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 128) return dst::launch_tile_flash<128>(a, B, st);
  if (hd == 64) return dst::launch_tile_flash<64>(a, B, st);
  if (hd == 96) return dst::launch_tile_flash<96>(a, B, st);
  if (hd == 256) return dst::launch_tile_flash<256>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory in bytes at d = 64, 96, 128 and 256, per regime
// (extern: a const has internal linkage otherwise).
extern const int dst_paged_tile_decode_smem_bytes[4] = {
    static_cast<int>(dst::DecodeTiles<64>::BYTES), static_cast<int>(dst::DecodeTiles<96>::BYTES),
    static_cast<int>(dst::DecodeTiles<128>::BYTES),
    static_cast<int>(dst::DecodeTiles<256>::BYTES)};
extern const int dst_paged_tile_smem_bytes[4] = {
    static_cast<int>(dst::PagedTiles<64>::BYTES), static_cast<int>(dst::PagedTiles<96>::BYTES),
    static_cast<int>(dst::PagedTiles<128>::BYTES), static_cast<int>(dst::PagedTiles<256>::BYTES)};

}  // extern "C"
