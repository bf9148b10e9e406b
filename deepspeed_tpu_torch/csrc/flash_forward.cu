// Causal GQA flash forward on Hopper: kernel D of the serving and training
// paths, register-resident.
//
// Replaces deepspeed_tpu/ops/flash_attention.py _fwd_kernel (:66) via
// _fwd_pallas (:121): causal (or full) GQA flash attention with a window and
// a static rel_offset, returning out and lse = m + log(l). Query row t sits at
// position t + rel against key column c (start-aligned, as the TPU kernel);
// causal keeps t + rel >= c, a window keeps t + rel - c <= window - 1. A row
// that sees no column gets out = 0 and lse = -1e30 + log(1e-30), as
// plain_flash_forward.
//
// What bounds it on the card: operations. Each live (row, column) pair costs
// about 4 d FLOPs (S = Q K^T and O += P V, 2 d each) against 989 TFLOP/s bf16;
// q, k, v and the outputs are a few percent of that time at prefill and
// training widths. The design's answer (FlashAttention-2's tiling on mma.sync):
//   * a CTA owns 16 x WARPS query rows of one head, 16 rows a warp, and walks
//     only its live column range in 64-column tiles (the TPU kernel's
//     _block_live skip); grid (H, B, q tiles) with the q tile index
//     reversed, so the longest causal tiles launch first and the tail is
//     short;
//   * Q is copied once (cp.async) and held in registers as mma A fragments
//     (ldmatrix) for the whole walk; its shared tile lies in the ring's last
//     stage, which is refilled only after every warp has taken its fragments.
//     At d = 256 Q's fragments (64 registers) and O (128) leave no room for
//     the scores: two CTAs share each 64-row tile, each computing the whole
//     score and half of O's columns (the score twice: 1.5x the products);
//     Q keeps a shared tile of its own and each k16 step of the score takes
//     its fragment from there by ldmatrix (the k steps still run in
//     ascending order into one accumulator, so the bits do not change); the
//     ring has two stages (168960 bytes of shared memory: one CTA an SM);
//   * S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 accumulate) into registers,
//     K fragments by ldmatrix from K's [column, d] rows (the col-major B);
//   * the online softmax stays in registers: a thread holds rows g and g + 8 of
//     its warp's 16; a row max is two quad shuffles;
//   * P is packed from the S accumulators into bf16 A fragments (two n8 tiles
//     make one k16 step) and never touches shared memory; O += P V with V
//     fragments by ldmatrix.trans; O is rescaled in registers and written once,
//     normalised by l, staged through the warp's own Q rows for 16-byte stores;
//   * K and V arrive through a STAGES-deep ring of 16-byte cp.async.cg copies:
//     tile i + STAGES - 1 is issued before tile i's math, one barrier a tile;
//     rows past the valid range are zero-filled through the copy's src-size
//     (stale shared memory can hold NaN bits, and NaN x 0 is NaN); rows are
//     padded by 16 bytes so every ldmatrix phase hits 8 distinct bank quads;
//   * masks are computed only on tiles that cross the causal diagonal, the
//     window's edge or the last valid column for some of a warp's rows (a
//     second instantiation of the tile body); masked entries get p = 0.
// A prompt served whole (kernel D) and in chunks (kernels B then C) must give
// the same logits: at full depth any change of rounding grows to several
// percent of them. So B and C run D's own tile body (flash_fwd_tile.cuh) --
// its 64-column tiles from column 0 in order, scores scaled before the max,
// p = expf(score - m), each tile's row sum in one fixed order, l = fma(l,
// corr, sum), the same mma k order -- and the paths agree bit for bit (card
// tests hold D against C, and against B then C).
// Not yet: wgmma and TMA with a producer warp, and K/V reuse across the heads
// of a GQA group beyond what L2 gives (neighbouring CTAs are those heads).
#include "flash_fwd_tile.cuh"

namespace dst {

// q [B, T, H, hd]; k/v [B, S, K, hd]; out [B, T, H, hd]; lse [B, H, T]
struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  int T, S, H, K, causal, window, rel;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(WARPS * 32, MINB) flash_fwd_kernel(const FwdArgs a) {
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
  const int b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest causal tiles first
  const int nrows = min(BM, a.T - t0);
  const int kvh = h / (a.H / a.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // live columns [c_lo, c_hi) of the CTA's query positions [q_lo, q_hi]; D
  // walks 64-column tiles from column 0 (no window) or c_lo, in order, so
  // its sums meet kernels B and C's bit for bit
  const int q_lo = t0 + a.rel, q_hi = t0 + nrows - 1 + a.rel;
  const int c_lo = a.window > 0 ? max(0, q_lo - (a.window - 1)) : 0;
  const int c_hi = a.causal ? max(0, min(a.S, q_hi + 1)) : a.S;
  const int ntiles = c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN : 0;

  const size_t q_ld = size_t(a.H) * HD, kv_ld = size_t(a.K) * HD;
  const bf16* qg = a.q + (size_t(b) * a.T * a.H + h) * HD;
  const bf16* kg = a.k + (size_t(b) * a.S * a.K + kvh) * HD;
  const bf16* vg = a.v + (size_t(b) * a.S * a.K + kvh) * HD;

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
  const int qp0 = t0 + r0 + a.rel;
  const int w_lo = t0 + warp * 16 + a.rel, w_hi = w_lo + 15;  // the warp's rows

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
    if (c0 + BN > c_hi || (a.causal && c0 + BN - 1 > w_lo) ||
        (a.window > 0 && c0 < w_hi - (a.window - 1)))
      tile_softmax_pv<HD, OC, true>(vs, sc, o, m, l, c0, c_hi, qp0, a.causal, a.window,
                                    a.scale, col0, lane);
    else
      tile_softmax_pv<HD, OC, false>(vs, sc, o, m, l, c0, c_hi, qp0, a.causal, a.window,
                                     a.scale, col0, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: O / l in bf16 into this warp's own Q rows, then 16-byte stores
  // of whole rows; lse = m + log(l), -1e30 + log(1e-30) where nothing was seen
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  const float inv0 = 1.f / den0, inv1 = 1.f / den1;
  const int tq = lane & 3;
#pragma unroll
  for (int n = 0; n < OC / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + r0 * LD + col0 + n * 8 + 2 * tq) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(Qs + (r0 + 8) * LD + col0 + n * 8 + 2 * tq) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (tq == 0 && col0 == 0) {
    float* lse = a.lse + (size_t(b) * a.H + h) * a.T + t0;
    if (r0 < nrows) lse[r0] = m[0] + logf(den0);
    if (r0 + 8 < nrows) lse[r0 + 8] = m[1] + logf(den1);
  }
  __syncwarp();
  constexpr int CH = OC / 8;
  bf16* og = a.out + (size_t(b) * a.T * a.H + h) * HD + col0;
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
int launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  using Tiles = FwdTiles<HD>;
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Tiles::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(a.H * Tiles::OSPLIT, B, (a.T + Tiles::BM - 1) / Tiles::BM), WARPS * 32,
         Tiles::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dst

using dst::bf16;

extern "C" {

// Kernel D. Returns cudaError_t.
int dst_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                  int T, int S, int H, int K, int hd, int causal, int window, int rel_offset,
                  float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  dst::FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.T = T; a.S = S; a.H = H; a.K = K;
  a.causal = causal; a.window = window; a.rel = rel_offset;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dst::launch_fwd<64>(a, B, st);
  if (hd == 128) return dst::launch_fwd<128>(a, B, st);
  if (hd == 96) return dst::launch_fwd<96>(a, B, st);
  if (hd == 256) return dst::launch_fwd<256>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D's dynamic shared memory in bytes at d = 64, 96, 128 and 256
// (extern: a const has internal linkage otherwise).
extern const int dst_flash_fwd_smem_bytes[4] = {static_cast<int>(dst::FwdTiles<64>::BYTES),
                                                static_cast<int>(dst::FwdTiles<96>::BYTES),
                                                static_cast<int>(dst::FwdTiles<128>::BYTES),
                                                static_cast<int>(dst::FwdTiles<256>::BYTES)};

}  // extern "C"
