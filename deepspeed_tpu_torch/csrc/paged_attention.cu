// Paged chunk-past partials on Hopper: kernel B of the serving path, a mode
// of the tile engine (flash_tile.cuh). Kernel A, the decode partials, has its
// own kernel (paged_decode.cu), and so has kernel I, the dense-tile paged
// attention (paged_tile.cu).
//
// Replaces deepspeed_tpu/ops/paged_attention.py _past_kernel (:782) via
// _prefill_attention (:952): the tq*rep rows of a chunk atom per kv head
// over its pooled past < pos0, returned as unnormalised flash partials (acc
// fp32, m, l) that kernel C seeds its self flash with.
//
// What bounds it on the card: the KV bytes. Every live past block of a
// sequence is read once per kv head group, so the floor is
// KV bytes / 3.35 TB/s. The design reads only what that needs:
//   * one CTA per (atom, kv head, 64-row tile) walks ONLY the live logical
//     blocks [lo, lo + nblk) of _past_ranges, looking each physical id up in
//     block_tables[slot] -- never the whole nb_max table;
//   * it reads the [*, d] lanes of its own kv head out of the lane-folded
//     [L, nb+1, bs, K*d] pool with 16-byte loads. The TPU kernel's
//     zero-padded q_big [H, K*d] (every head against every kv head's lanes,
//     for one wide MXU matmul) is NOT carried over: on the GPU it would
//     multiply the score work by K;
//   * the rep query heads of a GQA group share each K/V tile from shared
//     memory.
// What it does not do yet: overlap the next tile's loads with this tile's
// math (cp.async / TMA). That is tuning work.
//
// Atoms with nothing to read (pos0 == 0, or a window past everything) write
// m = -1e30, l = 0, acc = 0: the merge's exp(m - m2) = 0 then drops them.
//
// Quantized pools (the reference's `quantized` / `kv_bits` modes of
// _past_kernel, :840-876), one launcher each: paged_past_int8 and
// paged_past_int4 load int -> bf16 K/V tiles, q unquantized, scores times
// k_scale[col], and p is scaled by v_scale[col] before the P V product. The
// per-token scales come from kv_scale [L, nb+1, 1, 2*bs] (k in lanes [0, bs),
// v in [bs, 2bs)). The int4 pool pairs lanes GLOBALLY: byte j holds feature
// j (low nibble) and j + K*d/2 (high nibble), so a kv head whose features lie
// in the upper half reads high nibbles. This first version reads a 16-byte
// chunk for 16 features and keeps one nibble of each byte: an int4 head
// costs as many bytes as an int8 one (PERF.md). QuantPool's RAW_K load (K
// kept int8 for the tile engine's integer score) served kernel A's int8
// mode, which has its own kernel now.
#include "flash_tile.cuh"
#include "int_unpack.cuh"

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

// int8 / int4 pool loader of the quantized modes: K and V tiles of one kv
// head (columns c0 .. c0 + nc - 1 of atom p.a) and their per-token scales.
// RAW_K keeps K as int8 (Q8LD-byte rows) for the integer score product.
template <int BITS>
struct QuantPool {
  const int8_t* kq;  // [L, nbp1, bs, K*hd] (int8) or [.., K*hd/2] (int4)
  const int8_t* vq;
  const float* kv_scale;  // [L, nbp1, 1, 2*bs]

  template <int HD, bool RAW_K>
  __device__ void load(const PagedPast& p, bf16* Ks, bf16* Vs, float* ksc, float* vsc, int c0,
                       int nc) const {
    constexpr int CH = HD / 16;  // 16-feature chunks of a head
    const int lanes = BITS == 8 ? p.K * p.hd : p.K * p.hd / 2;
    const int half = p.K * p.hd / 2;
    for (int i = threadIdx.x; i < BN * CH; i += NTHREADS) {
      const int r = i / CH, j = i % CH;
      const int f = p.kk * p.hd + j * 16;  // first feature of the chunk
      const bool hi = BITS == 4 && f >= half;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (r < nc) {
        const int c = c0 + r;
        const int phys = p.bt[size_t(p.s) * p.nb_max + c / p.bs];
        const size_t row = (size_t(p.layer) * p.nbp1 + phys) * p.bs + c % p.bs;
        const size_t off = row * lanes + (hi ? f - half : f);
        kr = *reinterpret_cast<const uint4*>(kq + off);
        vr = *reinterpret_cast<const uint4*>(vq + off);
      }
      bf16* kd = Ks + r * Smem<HD>::KLD + j * 16;
      bf16* vd = Vs + r * Smem<HD>::KLD + j * 16;
      if (BITS == 8) {
        if (RAW_K) {
          *reinterpret_cast<uint4*>(reinterpret_cast<int8_t*>(Ks) + r * Smem<HD>::Q8LD + j * 16) =
              kr;
        } else {
          unpack16<0>(kr, kd);
        }
        unpack16<0>(vr, vd);
      } else if (hi) {
        unpack16<2>(kr, kd);
        unpack16<2>(vr, vd);
      } else {
        unpack16<1>(kr, kd);
        unpack16<1>(vr, vd);
      }
    }
    for (int r = threadIdx.x; r < BN; r += NTHREADS) {
      float ks = 0.f, vs = 0.f;
      if (r < nc) {
        const int c = c0 + r;
        const int phys = p.bt[size_t(p.s) * p.nb_max + c / p.bs];
        const float* sc = kv_scale + (size_t(p.layer) * p.nbp1 + phys) * 2 * p.bs + c % p.bs;
        ks = sc[0];
        vs = sc[p.bs];
      }
      ksc[r] = ks;
      vsc[r] = vs;
    }
  }
};

// B over an int8 / int4 pool (q unquantized)
template <int BITS>
struct PastQuantMode : PastMode {
  static constexpr int kKvBits = BITS;
  QuantPool<BITS> pool;

  template <int HD, bool RAW_K>
  __device__ void load_kv(bf16* Ks, bf16* Vs, float* ksc, float* vsc, int c0, int nc) const {
    pool.template load<HD, RAW_K>(*this, Ks, Vs, ksc, vsc, c0, nc);
  }
};

template <class M>
void fill_past(M& md, int layer, int nbp1, int bs, int K, int hd, const int* bt, int nb_max,
               const int* slot, const int* pos0, const int* lo, const int* nblk) {
  md.layer = layer; md.nbp1 = nbp1; md.bs = bs; md.K = K; md.hd = hd;
  md.bt = bt; md.nb_max = nb_max; md.slot = slot; md.pos0 = pos0; md.lo = lo; md.nblk = nblk;
}

template <int BITS>
int launch_past_quant(const void* q, const void* kq, const void* vq, const float* kv_scale,
                      int layer, int nbp1, int bs, int H, int K, int hd, const int* bt,
                      int nb_max, const int* slot, const int* pos0, const int* lo,
                      const int* nblk, int A, int tq, int window, float scale, float* acc,
                      float* m, float* l, cudaStream_t stream) {
  if (A <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  PastQuantMode<BITS> md{};
  fill_past(md, layer, nbp1, bs, K, hd, bt, nb_max, slot, pos0, lo, nblk);
  md.pool = {static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq), kv_scale};
  md.q = static_cast<const bf16*>(q);
  md.H = H; md.rep = H / K; md.tq = tq; md.window = window;
  md.acc = acc; md.m_out = m; md.l_out = l;
  const int R = tq * (H / K);
  return launch_any_hd(md, hd, dim3(A, K, (R + BM - 1) / BM), scale, stream);
}

}  // namespace dst

using dst::bf16;

extern "C" {

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

// Kernel B over an int8 / int4 pool (q bf16).
int dst_paged_past_int8(const void* q, const void* kpool, const void* vpool,
                        const float* kv_scale, int layer, int nbp1, int bs, int H, int K, int hd,
                        const int* bt, int nb_max, const int* slot, const int* pos0,
                        const int* lo, const int* nblk, int A, int tq, int window, float scale,
                        float* acc, float* m, float* l, void* stream) {
  return dst::launch_past_quant<8>(q, kpool, vpool, kv_scale, layer, nbp1, bs, H, K, hd, bt,
                                   nb_max, slot, pos0, lo, nblk, A, tq, window, scale, acc, m, l,
                                   static_cast<cudaStream_t>(stream));
}

int dst_paged_past_int4(const void* q, const void* kpool, const void* vpool,
                        const float* kv_scale, int layer, int nbp1, int bs, int H, int K, int hd,
                        const int* bt, int nb_max, const int* slot, const int* pos0,
                        const int* lo, const int* nblk, int A, int tq, int window, float scale,
                        float* acc, float* m, float* l, void* stream) {
  return dst::launch_past_quant<4>(q, kpool, vpool, kv_scale, layer, nbp1, bs, H, K, hd, bt,
                                   nb_max, slot, pos0, lo, nblk, A, tq, window, scale, acc, m, l,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
