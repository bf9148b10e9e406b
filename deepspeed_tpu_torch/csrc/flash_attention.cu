// Seeded causal flash attention on Hopper: kernel C of the serving path.
//
// Replaces deepspeed_tpu/ops/paged_attention.py _self_kernel (:891) via
// _prefill_attention (:952): causal flash over a chunk atom's own
// right-padded tokens, its online state SEEDED from kernel B's past partials
// (paged_attention.cu), masks col <= row, col < atom_len and the window,
// rows >= atom_len written as zeros, the output normalised by max(l, 1e-30).
// (Kernel D, the unseeded flash forward, is flash_forward.cu.)
//
// What bounds it on the card: at prefill widths (hundreds of rows an atom)
// the causal QK^T and PV products, about 4 d FLOPs per live (row, col) pair,
// against 989 TFLOP/s bf16; q, k, v, the seed and the output are a few
// percent of that time. The design is kernel D's register-resident flash
// (flash_fwd_tile.cuh), the same tile body:
//   * a CTA owns 64 query rows -- one head's tokens of one atom, 16 a warp --
//     grid (H, atoms, q tiles) with the q tiles reversed, so the longest
//     causal tiles launch first, and the heads of a GQA group are
//     neighbouring CTAs that share each K/V tile through L2;
//   * Q held as ldmatrix fragments, S = Q K^T and O += P V on mma.sync
//     m16n8k16 with S, P and O in registers, K/V through a 3-stage cp.async
//     ring (2 at d = 256, where two CTAs split O's columns, each computing
//     the whole score, and Q's fragments come from a shared tile);
//   * the online state (m, l, O) starts from B's partials (row t rep + rr of
//     the atom's kv head) when there is a seed, from (-1e30, 0, 0) when there
//     is none; columns stop at atom_len and at the window, masks only on the
//     tiles that cross them or the diagonal;
//   * the 64-column tiles, the scores scaled before the max, p = expf(score
//     - m), each tile's row sum and l's update, the mma k order: all D's, so
//     C unseeded equals D bit for bit, and C seeded from B's partials over a
//     64-aligned past continues D's walk over the whole prompt bit for bit.
// Not yet: wgmma and TMA with a producer warp.
#include "flash_fwd_tile.cuh"

namespace dst {

// q [A tq, H, hd]; k/v [A tq, K, hd]; seeds in kernel B's layout [A, K, tq
// rep (, hd)], null without a past; out [A tq, H, hd]
struct SelfArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* alen;  // [A] real tokens of each atom
  const float* m0;
  const float* l0;
  const float* a0;
  bf16* out;
  int tq, H, K, window;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(WARPS * 32, MINB) chunk_self_kernel(const SelfArgs a) {
  using Tiles = FwdTiles<HD>;
  constexpr int LD = Tiles::LD, BM = Tiles::BM, NT = WARPS * 32, STAGES = Tiles::STAGES;
  constexpr bool QREG = Tiles::Q_REGS;
  static_assert(STAGES >= 2, "a ring");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: K at 2 s KV_ELEMS, V after it
  bf16* Qs = ring + (QREG ? STAGES - 1 : STAGES) * 2 * Tiles::KV_ELEMS;

  constexpr int OC = Tiles::OC;
  // head h, O's columns col0 .. col0 + OC
  const int h = blockIdx.x / Tiles::OSPLIT, col0 = (blockIdx.x % Tiles::OSPLIT) * OC;
  const int at = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest causal tiles first
  const int nrows = min(BM, a.tq - t0);
  const int rep = a.H / a.K, kvh = h / rep;
  const int alen = a.alen[at];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // live columns [c_lo, c_hi) of the CTA's tokens t0 .. t0 + nrows - 1,
  // walked in 64-column tiles from c_lo in order, as kernel D walks them
  const int c_lo = a.window > 0 ? max(0, t0 - (a.window - 1)) : 0;
  // (a tile of padding rows alone, t0 >= atom_len, writes its zeros)
  const int c_hi = max(0, min(alen, t0 + nrows));
  const int ntiles = t0 < alen && c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN : 0;

  const size_t q_ld = size_t(a.H) * HD, kv_ld = size_t(a.K) * HD;
  const bf16* qg = a.q + (size_t(at) * a.tq * a.H + h) * HD;
  const bf16* kg = a.k + (size_t(at) * a.tq * a.K + kvh) * HD;
  const bf16* vg = a.v + (size_t(at) * a.tq * a.K + kvh) * HD;

  copy_rows<HD, BM, NT>(Qs, qg, q_ld, t0, nrows);
  auto issue = [&](int i) {  // tile i's K and V into stage i % STAGES
    if (i < ntiles) {
      const int c0 = c_lo + i * BN;
      const int nc = min(BN, c_hi - c0);
      bf16* ks = ring + (i % STAGES) * 2 * Tiles::KV_ELEMS;
      copy_rows<HD, BN, NT>(ks, kg, kv_ld, c0, nc);
      copy_rows<HD, BN, NT>(ks + Tiles::KV_ELEMS, vg, kv_ld, c0, nc);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);  // Q rides in the first group

  uint32_t qf[QREG ? HD / 16 : 1][4];
  float o[OC / 8][4];
#pragma unroll
  for (int n = 0; n < OC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {FWD_NEG_INF, FWD_NEG_INF};  // running max of scores, rows g, g + 8
  float l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + (lane >> 2);
  const int tq = lane & 3;
  const int w_lo = t0 + warp * 16, w_hi = w_lo + 15;  // the warp's rows

  // the seed: B's row t rep + rr of (atom, kv head) for token t of head h
  if (a.m0 != nullptr) {
    const size_t base = (size_t(at) * a.K + kvh) * size_t(a.tq) * rep + (h - kvh * rep);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r >= nrows) continue;
      const size_t row = base + size_t(t0 + r) * rep;
      m[hf] = a.m0[row];
      l[hf] = a.l0[row];
      const float* src = a.a0 + row * HD + col0;
#pragma unroll
      for (int n = 0; n < OC / 8; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(src + n * 8 + 2 * tq);
        o[n][2 * hf] = x.x;
        o[n][2 * hf + 1] = x.y;
      }
    }
  }

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
    issue(i + STAGES - 1);
    const int c0 = c_lo + i * BN;
    const bf16* ks = ring + (i % STAGES) * 2 * Tiles::KV_ELEMS;
    const bf16* vs = ks + Tiles::KV_ELEMS;
    float sc[BN / 8][4];
    tile_scores<HD, QREG>(ks, qf, Qs + warp * 16 * LD, sc, lane);
    // masks only where the tile crosses the diagonal, the window's edge or
    // c_hi for one of the warp's rows
    if (c0 + BN > c_hi || c0 + BN - 1 > w_lo || (a.window > 0 && c0 < w_hi - (a.window - 1)))
      tile_softmax_pv<HD, OC, true>(vs, sc, o, m, l, c0, c_hi, t0 + r0, 1, a.window, a.scale,
                                    col0, lane);
    else
      tile_softmax_pv<HD, OC, false>(vs, sc, o, m, l, c0, c_hi, t0 + r0, 1, a.window, a.scale,
                                     col0, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: O / max(l, 1e-30) in bf16 (zero for rows >= atom_len) into
  // this warp's own Q rows, then 16-byte stores of whole rows
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const bool live0 = t0 + r0 < alen, live1 = t0 + r0 + 8 < alen;
#pragma unroll
  for (int n = 0; n < OC / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + r0 * LD + col0 + n * 8 + 2 * tq) =
        live0 ? pack_bf16(o[n][0] * inv0, o[n][1] * inv0) : 0u;
    *reinterpret_cast<uint32_t*>(Qs + (r0 + 8) * LD + col0 + n * 8 + 2 * tq) =
        live1 ? pack_bf16(o[n][2] * inv1, o[n][3] * inv1) : 0u;
  }
  __syncwarp();
  constexpr int CH = OC / 8;
  bf16* og = a.out + (size_t(at) * a.tq * a.H + h) * HD + col0;
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
int launch_self(const SelfArgs& a, int A, cudaStream_t stream) {
  using Tiles = FwdTiles<HD>;
  auto kern = chunk_self_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Tiles::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.H * Tiles::OSPLIT, A, (a.tq + Tiles::BM - 1) / Tiles::BM), WARPS * 32,
         Tiles::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dst

using dst::bf16;

extern "C" {

// Kernel C. m0/l0/a0 null = no past (unseeded). Returns cudaError_t.
int dst_chunk_self(const void* q, const void* ks, const void* vs, const int* alen, const float* m0,
                   const float* l0, const float* a0, void* out, int A, int tq, int H, int K,
                   int hd, int window, float scale, void* stream) {
  if (A <= 0 || tq <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  dst::SelfArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(ks);
  a.v = static_cast<const bf16*>(vs);
  a.alen = alen; a.m0 = m0; a.l0 = l0; a.a0 = a0;
  a.out = static_cast<bf16*>(out);
  a.tq = tq; a.H = H; a.K = K; a.window = window;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return dst::launch_self<128>(a, A, st);
  if (hd == 64) return dst::launch_self<64>(a, A, st);
  if (hd == 96) return dst::launch_self<96>(a, A, st);
  if (hd == 256) return dst::launch_self<256>(a, A, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel C's dynamic shared memory in bytes at d = 64, 96, 128 and 256
// (extern: a const has internal linkage otherwise).
extern const int dst_chunk_self_smem_bytes[4] = {static_cast<int>(dst::FwdTiles<64>::BYTES),
                                                 static_cast<int>(dst::FwdTiles<96>::BYTES),
                                                 static_cast<int>(dst::FwdTiles<128>::BYTES),
                                                 static_cast<int>(dst::FwdTiles<256>::BYTES)};

}  // extern "C"
