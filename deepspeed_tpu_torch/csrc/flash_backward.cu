// Flash-attention backward on Hopper: kernels E (dq) and F (dk, dv) of the
// training path.
//
// Replaces:
//   E  deepspeed_tpu/ops/flash_attention.py _bwd_dq_kernel (:173) via
//      _bwd_pallas (:249): dq of the causal/window GQA flash attention from
//      the forward's saved lse and delta = rowsum(dO * O) - dlse;
//   F  deepspeed_tpu/ops/flash_attention.py _bwd_dkv_kernel (:208) via
//      _bwd_pallas (:249), with the GQA group sum of :311-313 folded in: the
//      TPU writes per-query-head dk_h / dv_h [B, H, S, d] and sums each kv
//      head's group afterwards; here one CTA owns a kv head's 64-row tile,
//      walks every query head of its group and writes [B, S, K, d] once --
//      no atomics and no intermediate buffer.
//
// Both recompute the scores from q, k and lse (FA2): with s = q k^T * scale
//   p  = exp(s - lse)         masked entries p = 0 (never exp(0) garbage)
//   dp = dO v^T,  ds = p * (dp - delta)
//   E: dq = scale * ds k      F: dv = p^T dO,  dk = scale * ds^T q
// p and ds are rounded to bf16 before their products, as the TPU kernels do.
// Masking is start-aligned like the forward (kernel D): query row t sits at
// position t + rel against key column c; causal keeps t + rel >= c, a window
// keeps t + rel - c <= window - 1.
//
// What bounds it on the card: the products, 2 * d FLOPs each per live (row,
// col) pair and query head -- three in E (s, dp, dq), four in F (s, dp, dv,
// dk) -- against 989 TFLOP/s bf16; at training widths (T = 2048, d = 64) the
// bytes of q, k, v, dO and the outputs are a few percent of that time. The
// design's answer in this first version:
//   * bf16 tensor cores (wmma 16x16x16, fp32 accumulate) for every product,
//     on flash_tile.cuh's 64 x 64 tiles and 16-byte row loads;
//   * only live tiles are visited: E walks the column range its 64 query rows
//     can see, F the query-row range its 64 kv rows are seen by (the TPU
//     kernels' _block_live skip);
//   * q, k, v, dO and the gradients are read and written in the model's own
//     [rows, heads, d] layout: no transposes around the launches;
//   * F's group sum lives in its fp32 shared-memory accumulators.
// Not yet: wgmma/TMA, register-resident accumulators, more than one CTA per
// SM (F holds ~190 KB of shared memory at d = 128), pipelined loads, and one
// fused kernel that shares s and dp between dq and dk/dv -- later tuning.
#include <type_traits>

#include "flash_tile.cuh"

namespace dst {

template <int HD>
struct BwdSmem {
  // bf16 [64, HD] tiles, fp32 [64, 64] scores, bf16 [64, 64] p / ds, fp32
  // [64, HD] accumulators; every region a multiple of 128 bytes (wmma wants
  // 32-byte aligned tile pointers and ldm % 8 == 0 / % 4 == 0)
  static constexpr int LD = HD + 8;
  static constexpr int SLD = BN + 4;
  static constexpr int PLD = BN + 8;
  static constexpr int ALD = HD + 4;
  static constexpr size_t tile = size_t(BM) * LD * 2;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t dp_off = s_off + size_t(BM) * SLD * 4;
  static constexpr size_t p_off = dp_off + size_t(BM) * SLD * 4;
  static constexpr size_t ds_off = p_off + size_t(BM) * PLD * 2;
  static constexpr size_t st_off = ds_off + size_t(BM) * PLD * 2;  // lse, delta
  static constexpr size_t acc_off = st_off + 2 * BM * 4;
  static constexpr size_t acc_bytes = size_t(BM) * ALD * 4;
  static constexpr size_t bytes(int n_acc) { return acc_off + n_acc * acc_bytes; }
};

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
  __device__ const bf16* q_row(const bf16* base, int b, int t, int h, int hd) const {
    return base + ((size_t(b) * T + t) * H + h) * hd;
  }
  __device__ size_t kv_off(int b, int c, int kk, int hd) const {
    return ((size_t(b) * S + c) * K + kk) * hd;
  }
};

// C[r0 : r0+16, 0 : 64] = A[r0 : r0+16, 0 : HD] * B[0 : 64, 0 : HD]^T, fp32
// into shared memory: one warp's 16 rows of s = q k^T or dp = dO v^T
template <int HD>
__device__ __forceinline__ void gemm_abt(const bf16* A, const bf16* B, int ld, float* C,
                                         int ldc, int r0) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r0 * ld + k0, ld);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + j * 16 * ld + k0, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(C + r0 * ldc + j * 16, acc[j], ldc, wmma::mem_row_major);
}

// C[r0 : r0+16, 0 : HD] += op(A)[r0 : r0+16, 0 : 64] * B[0 : 64, 0 : HD], the
// fp32 accumulator in shared memory. TRANS_A: A is stored [64 x 64] with the
// product's rows as its COLUMNS (p^T dO, ds^T q in F); else as its rows
// (ds k in E).
template <int HD, bool TRANS_A>
__device__ __forceinline__ void gemm_acc(const bf16* A, int lda, const bf16* B, int ldb,
                                         float* C, int ldc, int r0) {
  using namespace nvcuda;
  using ALayout = typename std::conditional<TRANS_A, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int n0 = 0; n0 < HD; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* cptr = C + r0 * ldc + n0;
    wmma::load_matrix_sync(acc, cptr, ldc, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < BN; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, TRANS_A ? A + k0 * lda + r0 : A + r0 * lda + k0, lda);
      wmma::load_matrix_sync(b, B + k0 * ldb + n0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cptr, acc, ldc, wmma::mem_row_major);
  }
}

// One warp's 16 rows: p and ds of the tile from s and dp. Rows >= nr,
// columns >= nc and masked entries give p = ds = 0.
template <bool WRITE_P>
__device__ __forceinline__ void tile_grads(const BwdArgs& a, const float* Ss, const float* dPs,
                                           const float* lse_s, const float* delta_s, bf16* Ps,
                                           bf16* dSs, int r0, int nr, int nc, int t0, int c0,
                                           int lane, int sld, int pld) {
  for (int i = lane; i < 16 * BN; i += 32) {
    const int r = r0 + i / BN, c = i % BN;
    float p = 0.f, ds = 0.f;
    if (r < nr && c < nc && a.keep(t0 + r, c0 + c)) {
      p = expf(Ss[r * sld + c] * a.scale - lse_s[r]);
      ds = p * (dPs[r * sld + c] - delta_s[r]);
    }
    if (WRITE_P) Ps[r * pld + c] = __float2bfloat16(p);
    dSs[r * pld + c] = __float2bfloat16(ds);
  }
}

// E: grid (B, H, ceil(T / 64)); a CTA owns 64 query rows of one head and
// walks the live kv columns.
template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const BwdArgs a) {
  using SM = BwdSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + SM::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v_off);
  float* Ss = reinterpret_cast<float*>(smem + SM::s_off);
  float* dPs = reinterpret_cast<float*>(smem + SM::dp_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + SM::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + SM::st_off);
  float* delta_s = lse_s + BM;
  float* dQs = reinterpret_cast<float*>(smem + SM::acc_off);

  const int b = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * BM;
  const int kk = h / (a.H / a.K);
  const int nr = min(BM, a.T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;

  load_rows<HD>(Qs, SM::LD, nr, [&](int r) { return a.q_row(a.q, b, t0 + r, h, HD); });
  load_rows<HD>(dOs, SM::LD, nr, [&](int r) { return a.q_row(a.dout, b, t0 + r, h, HD); });
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    const size_t row = (size_t(b) * a.H + h) * a.T + t0 + r;
    lse_s[r] = r < nr ? a.lse[row] : 0.f;
    delta_s[r] = r < nr ? a.delta[row] : 0.f;
  }
  for (int i = threadIdx.x; i < BM * SM::ALD; i += NTHREADS) dQs[i] = 0.f;
  __syncthreads();

  const int c_lo = a.window > 0 ? max(0, t0 + a.rel - (a.window - 1)) : 0;
  const int c_hi = a.causal ? max(0, min(a.S, t0 + nr + a.rel)) : a.S;
  for (int c0 = c_lo; c0 < c_hi; c0 += BN) {
    const int nc = min(BN, c_hi - c0);
    load_rows<HD>(Ks, SM::LD, nc, [&](int r) { return a.k + a.kv_off(b, c0 + r, kk, HD); });
    load_rows<HD>(Vs, SM::LD, nc, [&](int r) { return a.v + a.kv_off(b, c0 + r, kk, HD); });
    __syncthreads();
    gemm_abt<HD>(Qs, Ks, SM::LD, Ss, SM::SLD, r0);
    gemm_abt<HD>(dOs, Vs, SM::LD, dPs, SM::SLD, r0);
    __syncwarp();
    tile_grads<false>(a, Ss, dPs, lse_s, delta_s, nullptr, dSs, r0, nr, nc, t0, c0, lane,
                      SM::SLD, SM::PLD);
    __syncwarp();
    gemm_acc<HD, false>(dSs, SM::PLD, Ks, SM::LD, dQs, SM::ALD, r0);
    __syncthreads();  // K/V are rewritten by the next tile
  }

  for (int r = warp; r < nr; r += NTHREADS / 32) {
    bf16* dst = a.dq + ((size_t(b) * a.T + t0 + r) * a.H + h) * HD;
    for (int j = lane; j < HD; j += 32) dst[j] = __float2bfloat16(dQs[r * SM::ALD + j] * a.scale);
  }
}

// F: grid (B, K, ceil(S / 64)); a CTA owns 64 kv rows of one kv head and
// walks the live query rows of every query head of its group.
template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const BwdArgs a) {
  using SM = BwdSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + SM::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v_off);
  float* Ss = reinterpret_cast<float*>(smem + SM::s_off);
  float* dPs = reinterpret_cast<float*>(smem + SM::dp_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::p_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + SM::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + SM::st_off);
  float* delta_s = lse_s + BM;
  float* dKs = reinterpret_cast<float*>(smem + SM::acc_off);
  float* dVs = dKs + BM * SM::ALD;

  const int b = blockIdx.x, kk = blockIdx.y, c0 = blockIdx.z * BN;
  const int rep = a.H / a.K;
  const int nc = min(BN, a.S - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;

  load_rows<HD>(Ks, SM::LD, nc, [&](int r) { return a.k + a.kv_off(b, c0 + r, kk, HD); });
  load_rows<HD>(Vs, SM::LD, nc, [&](int r) { return a.v + a.kv_off(b, c0 + r, kk, HD); });
  for (int i = threadIdx.x; i < 2 * BM * SM::ALD; i += NTHREADS) dKs[i] = 0.f;
  __syncthreads();

  // query rows t that see a column of [c0, c0 + nc): causal t + rel >= c0,
  // window t + rel - (c0 + nc - 1) <= window - 1
  const int t_lo = a.causal ? min(a.T, max(0, c0 - a.rel)) : 0;
  const int t_hi = a.window > 0 ? max(0, min(a.T, c0 + nc + a.window - 1 - a.rel)) : a.T;
  for (int rr = 0; rr < rep; ++rr) {
    const int h = kk * rep + rr;
    for (int t0 = t_lo; t0 < t_hi; t0 += BM) {
      const int nr = min(BM, t_hi - t0);
      load_rows<HD>(Qs, SM::LD, nr, [&](int r) { return a.q_row(a.q, b, t0 + r, h, HD); });
      load_rows<HD>(dOs, SM::LD, nr, [&](int r) { return a.q_row(a.dout, b, t0 + r, h, HD); });
      for (int r = threadIdx.x; r < BM; r += NTHREADS) {
        const size_t row = (size_t(b) * a.H + h) * a.T + t0 + r;
        lse_s[r] = r < nr ? a.lse[row] : 0.f;
        delta_s[r] = r < nr ? a.delta[row] : 0.f;
      }
      __syncthreads();
      // this warp's 16 query rows against the 64 kv columns
      gemm_abt<HD>(Qs, Ks, SM::LD, Ss, SM::SLD, r0);
      gemm_abt<HD>(dOs, Vs, SM::LD, dPs, SM::SLD, r0);
      __syncwarp();
      tile_grads<true>(a, Ss, dPs, lse_s, delta_s, Ps, dSs, r0, nr, nc, t0, c0, lane, SM::SLD,
                       SM::PLD);
      __syncthreads();
      // this warp's 16 kv rows against every query row of the tile
      gemm_acc<HD, true>(Ps, SM::PLD, dOs, SM::LD, dVs, SM::ALD, r0);
      gemm_acc<HD, true>(dSs, SM::PLD, Qs, SM::LD, dKs, SM::ALD, r0);
      __syncthreads();  // Q/dO/P/dS are rewritten by the next tile
    }
  }

  for (int r = warp; r < nc; r += NTHREADS / 32) {
    const size_t off = a.kv_off(b, c0 + r, kk, HD);
    for (int j = lane; j < HD; j += 32) {
      a.dk[off + j] = __float2bfloat16(dKs[r * SM::ALD + j] * a.scale);
      a.dv[off + j] = __float2bfloat16(dVs[r * SM::ALD + j]);
    }
  }
}

template <int HD, bool DKV>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  auto kern = DKV ? flash_bwd_dkv_kernel<HD> : flash_bwd_dq_kernel<HD>;
  const size_t bytes = BwdSmem<HD>::bytes(DKV ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = DKV ? dim3(a.B, a.K, (a.S + BN - 1) / BN)
                        : dim3(a.B, a.H, (a.T + BM - 1) / BM);
  kern<<<grid, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int launch_bwd_any_hd(const BwdArgs& a, int hd, cudaStream_t stream) {
  if (hd == 128) return launch_bwd<128, DKV>(a, stream);
  if (hd == 64) return launch_bwd<64, DKV>(a, stream);
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

}  // extern "C"
