// Fused row RMSNorm on Hopper: kernel J.
//
// Replaces deepspeed_tpu/ops/rms_norm.py:20 _rms_kernel (via _rms_pallas :27
// and fused_rms_norm :76): out = x * rsqrt(mean(x^2) + eps) * w per row, the
// statistics in fp32, the result cast to x's dtype. The backward stays plain
// torch, as the reference's custom VJP left it to XLA (:57-70).
//
// What bounds it on the card: bytes. A row of D values is read, reduced and
// written back with ~3 FLOPs per value, far below the H100's ~295 FLOP/byte
// ridge, so the floor is (x + w + out) bytes / 3.35 TB/s. The design:
//   * one CTA per row, 256 threads; every thread moves 16 bytes a load
//     (8 bf16 or 4 fp32 values), neighbouring threads on neighbouring
//     addresses;
//   * the sum of squares in fp32, reduced by warp shuffles and one
//     shared-memory step across the 8 warps (a fixed order: deterministic);
//   * a second pass over the same row writes x * inv * w. A row (8 KB bf16
//     at D = 4096) is read from device memory once: the second read finds it
//     in L1/L2.
// The TPU kernel's (256-row block, D) VMEM tiles are not carried over: a
// 256 x 4096 tile is 2 MB, far more than a CTA's shared memory, and a row
// needs no data of another row.
// Instantiated for x bf16 / fp32 and w bf16 / fp32; D must be a multiple of
// 8 (the wrapper checks), so every row and w start on 16-byte boundaries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dst {

constexpr int RMS_THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T as an array of values
template <class T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <class T, class W>
__global__ void __launch_bounds__(RMS_THREADS)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out, int D,
                    float eps) {
  constexpr int N = Vec<T>::N;
  const size_t row = blockIdx.x;
  const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + row * D);
  Vec<T>* orow = reinterpret_cast<Vec<T>*>(out + row * D);
  const int nv = D / N;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += RMS_THREADS) {
    const Vec<T> a = xr[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = to_f(a.v[k]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ float part[RMS_THREADS / 32];
  __shared__ float inv_s;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < RMS_THREADS / 32; ++k) tot += part[k];
    inv_s = rsqrtf(tot / float(D) + eps);
  }
  __syncthreads();
  const float inv = inv_s;

  for (int i = threadIdx.x; i < nv; i += RMS_THREADS) {
    const Vec<T> a = xr[i];
    Vec<T> r;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r.v[k] = from_f<T>(to_f(a.v[k]) * inv * to_f(w[i * N + k]));
    }
    orow[i] = r;
  }
}

template <class T, class W>
int launch_rms(const void* x, const void* w, void* out, int n, int D, float eps,
               cudaStream_t stream) {
  rms_norm_kernel<T, W><<<n, RMS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dst

extern "C" {

// Kernel J: x [n, D] (bf16 or fp32, x_fp32 says which), w [D] (bf16 or
// fp32), out [n, D] in x's dtype. Returns the launch's cudaError_t.
int dst_rms_norm(const void* x, const void* w, void* out, int n, int D, int x_fp32, int w_fp32,
                 float eps, void* stream) {
  if (n <= 0) return 0;
  if (D <= 0 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_fp32) {
    return w_fp32 ? dst::launch_rms<float, float>(x, w, out, n, D, eps, s)
                  : dst::launch_rms<float, bf>(x, w, out, n, D, eps, s);
  }
  return w_fp32 ? dst::launch_rms<bf, float>(x, w, out, n, D, eps, s)
                : dst::launch_rms<bf, bf>(x, w, out, n, D, eps, s);
}

}  // extern "C"
