// Seeded causal flash attention on Hopper: kernel C of the serving path.
//
// Replaces deepspeed_tpu/ops/paged_attention.py _self_kernel (:891) via
// _prefill_attention (:952): causal flash over a chunk atom's own
// right-padded tokens, its online state SEEDED from kernel B's past partials,
// masks col <= row, col < atom_len and the window, rows >= atom_len written
// as zeros. (Kernel D, the unseeded flash forward, is csrc/flash_forward.cu.)
//
// What bounds it on the card: at prefill widths (hundreds to thousands of
// rows) the causal QK^T and PV products, about 2 * 2 * d FLOPs per live
// (row, col) pair, against 989 TFLOP/s bf16 -- the KV bytes are small next to
// that. The design's answer in this first version:
//   * bf16 tensor cores (wmma 16x16x16, fp32 accumulate) for both products;
//   * a CTA per (atom, head, 64-row q tile) walks only the live column range:
//     tiles entirely above the causal diagonal or older than the window are
//     never visited (the TPU kernel's _block_live skip);
//   * q, k and v are read in the model's own [rows, heads, d] layout through
//     strides: no transposes or padding copies around the launch.
// Not yet: wgmma/TMA, register-resident O, K/V tile reuse across the rep
// heads of a GQA group, and pipelined loads -- later tuning.
#include "flash_tile.cuh"

namespace dst {

// C: grid (A, H, ceil(tq / 64)). q packed [N, H, hd]; k/v self [N, K, hd];
// seeds in kernel B's layout [A, K, tq*rep(, hd)]: row t*rep + rr of kv head
// kk is head kk*rep + rr.
struct SelfMode {
  const bf16* q;
  const bf16* ks;
  const bf16* vs;
  const int* alen_p;  // [A] real tokens of each atom
  const float* m0;    // null when the atom has no past
  const float* l0;
  const float* a0;
  bf16* out;          // [N, H, hd]
  int H, K, hd, tq, window;
  // per-CTA
  int a, h, kk, rr, rep, t0, alen;

  __device__ void setup() {
    a = blockIdx.x;
    h = blockIdx.y;
    t0 = blockIdx.z * BM;
    rep = H / K;
    kk = h / rep;
    rr = h % rep;
    alen = alen_p[a];
  }
  __device__ int rows() const { return min(BM, tq - t0); }
  __device__ const bf16* q_row(int r) const {
    return q + ((size_t(a) * tq + t0 + r) * H + h) * hd;
  }
  __device__ int col_lo() const { return window > 0 ? max(0, t0 - (window - 1)) : 0; }
  __device__ int col_hi() const { return min(alen, t0 + rows()); }
  __device__ const bf16* k_row(int c) const { return ks + ((size_t(a) * tq + c) * K + kk) * hd; }
  __device__ const bf16* v_row(int c) const { return vs + ((size_t(a) * tq + c) * K + kk) * hd; }
  __device__ bool keep(int r, int c) const {
    const int t = t0 + r;
    return t < alen && c < alen && c <= t && (window <= 0 || c > t - window);
  }
  __device__ size_t seed_row(int r) const {
    return (size_t(a) * K + kk) * (size_t(tq) * rep) + size_t(t0 + r) * rep + rr;
  }
  __device__ float seed_m(int r) const { return m0 ? m0[seed_row(r)] : NEG_INF; }
  __device__ float seed_l(int r) const { return l0 ? l0[seed_row(r)] : 0.f; }
  __device__ float seed_acc(int r, int j) const { return a0 ? a0[seed_row(r) * hd + j] : 0.f; }
  __device__ void finish(int r, const float* o, float, float l, int lane) const {
    const int t = t0 + r;
    const float inv = t < alen ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    bf16* dst = out + ((size_t(a) * tq + t) * H + h) * hd;
    for (int j = lane; j < hd; j += 32) dst[j] = __float2bfloat16(o[j] * inv);
  }
};

}  // namespace dst

using dst::bf16;

extern "C" {

// Kernel C. m0/l0/a0 null = no past (unseeded). Returns cudaError_t.
int dst_chunk_self(const void* q, const void* ks, const void* vs, const int* alen, const float* m0,
                   const float* l0, const float* a0, void* out, int A, int tq, int H, int K,
                   int hd, int window, float scale, void* stream) {
  if (A <= 0 || tq <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  dst::SelfMode md{};
  md.q = static_cast<const bf16*>(q);
  md.ks = static_cast<const bf16*>(ks);
  md.vs = static_cast<const bf16*>(vs);
  md.alen_p = alen; md.m0 = m0; md.l0 = l0; md.a0 = a0;
  md.out = static_cast<bf16*>(out);
  md.H = H; md.K = K; md.hd = hd; md.tq = tq; md.window = window;
  return dst::launch_any_hd(md, hd, dim3(A, H, (tq + dst::BM - 1) / dst::BM), scale,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
