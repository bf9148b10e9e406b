// Paged past-partials on Hopper: kernels A and B of the serving path.
//
// Replaces (deepspeed_tpu/ops/paged_attention.py):
//   A  _decode_kernel (:420) via decode_pool_partials (:543): one query row
//      per decode atom (rep rows per kv head) over its pooled past < pos0;
//   B  _past_kernel (:782) via _prefill_attention (:952): the tq*rep rows of
//      a chunk atom per kv head over the same pooled past.
// Both return unnormalised flash partials (acc fp32, m, l) that the caller
// merges with the atom's own tokens.
//
// What bounds it on the card: the KV bytes. Every live past block of a
// sequence is read once per kv head group (decode does ~1 FLOP per byte, far
// below the H100's ~295 FLOP/byte ridge), so the floor is
// KV bytes / 3.35 TB/s. The design reads only what that needs:
//   * one CTA per (atom, kv head [, 64-row tile]) walks ONLY the live logical
//     blocks [lo, lo + nblk) of _past_ranges, looking each physical id up in
//     block_tables[slot] -- never the whole nb_max table;
//   * it reads the [*, d] lanes of its own kv head out of the lane-folded
//     [L, nb+1, bs, K*d] pool with 16-byte loads. The TPU kernel's
//     zero-padded q_big [H, K*d] (every head against every kv head's lanes,
//     for one wide MXU matmul) is NOT carried over: on the GPU it would
//     multiply the score work by K;
//   * the rep query heads of a GQA group share each K/V tile from shared
//     memory.
// What it does not do yet: split a long past over several CTAs (decode runs
// A*K CTAs, fewer than the 132 SMs at small batch) or overlap the next tile's
// loads with this tile's math (cp.async / TMA). Those are tuning work.
//
// Atoms with nothing to read (pos0 == 0, or a window past everything) write
// m = -1e30, l = 0, acc = 0: the merge's exp(m - m2) = 0 then drops them.
#include "flash_tile.cuh"

namespace dst {

struct PagedPast {
  // pool: stacked lane-folded [L, nbp1, bs, K*hd], layer picked by `layer`
  const bf16* kpool;
  const bf16* vpool;
  int layer, nbp1, bs, K, hd;
  const int* bt;  // [S, nb_max] physical block ids, indexed by SLOT
  int nb_max;
  const int* slot;   // [A]
  const int* pos0;   // [A] pool frontier (columns < pos0 are cached)
  const int* lo;     // [A] first live logical block
  const int* nblk;   // [A] live block count
  // per-CTA
  int a, kk, s, p0, c_lo, c_hi;

  __device__ void setup_past() {
    s = slot[a];
    p0 = pos0[a];
    c_lo = lo[a] * bs;
    c_hi = min(p0, (lo[a] + nblk[a]) * bs);
  }
  __device__ const bf16* pool_row(const bf16* pool, int c) const {
    const int phys = bt[size_t(s) * nb_max + c / bs];
    return pool + ((size_t(layer) * nbp1 + phys) * bs + c % bs) * size_t(K) * hd +
           size_t(kk) * hd;
  }
  __device__ const bf16* k_row(int c) const { return pool_row(kpool, c); }
  __device__ const bf16* v_row(int c) const { return pool_row(vpool, c); }
  __device__ int col_lo() const { return c_lo; }
  __device__ int col_hi() const { return c_hi; }
  __device__ float seed_m(int) const { return NEG_INF; }
  __device__ float seed_l(int) const { return 0.f; }
  __device__ float seed_acc(int, int) const { return 0.f; }
};

// A: grid (A, K); rows r < rep are heads kk*rep + r of atom a
struct DecodeMode : PagedPast {
  const bf16* q;    // [A, H, hd]
  const int* rowpos;  // [A] query position (window anchor)
  int H, rep, window;
  float* acc;       // [A, H, hd]
  float* m_out;     // [A, H]
  float* l_out;     // [A, H]
  int rp;

  __device__ void setup() {
    a = blockIdx.x;
    kk = blockIdx.y;
    setup_past();
    rp = rowpos[a];
  }
  __device__ int rows() const { return rep; }
  __device__ const bf16* q_row(int r) const {
    return q + (size_t(a) * H + kk * rep + r) * hd;
  }
  __device__ bool keep(int, int c) const {
    return c < p0 && (window <= 0 || c > rp - window);
  }
  __device__ void finish(int r, const float* o, float m, float l, int lane) const {
    const size_t row = size_t(a) * H + kk * rep + r;
    for (int j = lane; j < hd; j += 32) acc[row * hd + j] = o[j];
    if (lane == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
};

// B: grid (A, K, ceil(R / 64)) with R = tq * rep; row g = t * rep + rr is
// query token t of the atom at head kk * rep + rr
struct PastMode : PagedPast {
  const bf16* q;  // packed [N, H, hd], atom a owns rows [a*tq, (a+1)*tq)
  int H, rep, tq, window;
  float* acc;     // [A, K, R, hd]
  float* m_out;   // [A, K, R]
  float* l_out;   // [A, K, R]
  int g0, R;

  __device__ void setup() {
    a = blockIdx.x;
    kk = blockIdx.y;
    g0 = blockIdx.z * BM;
    R = tq * rep;
    setup_past();
  }
  __device__ int rows() const { return min(BM, R - g0); }
  __device__ const bf16* q_row(int r) const {
    const int g = g0 + r, t = g / rep, rr = g % rep;
    return q + ((size_t(a) * tq + t) * H + kk * rep + rr) * hd;
  }
  __device__ bool keep(int r, int c) const {
    const int t = (g0 + r) / rep;
    return c < p0 && (window <= 0 || c > p0 + t - window);
  }
  __device__ void finish(int r, const float* o, float m, float l, int lane) const {
    const size_t row = (size_t(a) * K + kk) * R + g0 + r;
    for (int j = lane; j < hd; j += 32) acc[row * hd + j] = o[j];
    if (lane == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
};

}  // namespace dst

using dst::bf16;

extern "C" {

// Kernel A. Returns the launch's cudaError_t (0 = launched).
int dst_paged_decode(const void* q, const void* kpool, const void* vpool, int layer,
                     int nbp1, int bs, int H, int K, int hd, const int* bt, int nb_max,
                     const int* slot, const int* pos0, const int* rowpos, const int* lo,
                     const int* nblk, int A, int window, float scale, float* acc, float* m,
                     float* l, void* stream) {
  if (A <= 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > dst::BM) return static_cast<int>(cudaErrorInvalidValue);
  dst::DecodeMode md{};
  md.kpool = static_cast<const bf16*>(kpool);
  md.vpool = static_cast<const bf16*>(vpool);
  md.layer = layer; md.nbp1 = nbp1; md.bs = bs; md.K = K; md.hd = hd;
  md.bt = bt; md.nb_max = nb_max; md.slot = slot; md.pos0 = pos0; md.lo = lo; md.nblk = nblk;
  md.q = static_cast<const bf16*>(q);
  md.rowpos = rowpos; md.H = H; md.rep = H / K; md.window = window;
  md.acc = acc; md.m_out = m; md.l_out = l;
  return dst::launch_any_hd(md, hd, dim3(A, K, 1), scale, static_cast<cudaStream_t>(stream));
}

// Kernel B. Returns the launch's cudaError_t (0 = launched).
int dst_paged_past(const void* q, const void* kpool, const void* vpool, int layer, int nbp1,
                   int bs, int H, int K, int hd, const int* bt, int nb_max, const int* slot,
                   const int* pos0, const int* lo, const int* nblk, int A, int tq, int window,
                   float scale, float* acc, float* m, float* l, void* stream) {
  if (A <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  dst::PastMode md{};
  md.kpool = static_cast<const bf16*>(kpool);
  md.vpool = static_cast<const bf16*>(vpool);
  md.layer = layer; md.nbp1 = nbp1; md.bs = bs; md.K = K; md.hd = hd;
  md.bt = bt; md.nb_max = nb_max; md.slot = slot; md.pos0 = pos0; md.lo = lo; md.nblk = nblk;
  md.q = static_cast<const bf16*>(q);
  md.H = H; md.rep = H / K; md.tq = tq; md.window = window;
  md.acc = acc; md.m_out = m; md.l_out = l;
  const int R = tq * (H / K);
  return dst::launch_any_hd(md, hd, dim3(A, K, (R + dst::BM - 1) / dst::BM), scale,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
