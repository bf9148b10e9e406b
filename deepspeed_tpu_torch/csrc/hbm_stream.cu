// Device-memory stream-read probe on Hopper: kernel K.
//
// Replaces bench_infer.py:67 _stream_kernel (via stream_once :74 inside
// measure_hbm_bandwidth :27): the sum of a large fp32 array, read in block
// order rotated by a per-call offset (:80-81) so that a loop of calls is not
// loop-invariant, timed to give the card's measured read rate.
//
// What bounds it: bytes, by construction. The array (256 MB) is five times
// the 50 MB L2, and each value costs one add. The design keeps every SM's
// loads in flight and does nothing else:
//   * the array is cut into chunks of chunk_words values; CTA i reads chunk
//     (i + offset) % n_chunks with 16-byte loads (4 independent float4 loads
//     in flight per thread per step) and writes that chunk's partial sum
//     to partials[chunk] (fp64), so the result does not depend on the offset;
//   * a second one-CTA kernel sums partials[0 .. n_chunks) in a fixed order
//     into out[0]: per-CTA partials, then one in-order pass -- deterministic,
//     no float atomics.
// Partials are fp64: summing 64Mi values in fp32 would lose ~1e-6 of the
// result, and an fp64 add per loaded value costs nothing in a read-bound
// loop. The TPU kernel's sequential grid, accumulating into one resident
// output block, has no counterpart on a card whose CTAs run in no order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace dst {

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_UNROLL = 4;

__device__ __forceinline__ double block_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __shared__ double part[STREAM_THREADS / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  double tot = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < STREAM_THREADS / 32; ++k) tot += part[k];
  }
  return tot;  // valid in thread 0
}

__global__ void __launch_bounds__(STREAM_THREADS)
    stream_chunks(const float4* __restrict__ x, double* __restrict__ partials, int n_chunks,
                  int chunk_vec, int offset) {
  const int chunk = (blockIdx.x + offset) % n_chunks;
  const float4* src = x + size_t(chunk) * chunk_vec;
  double acc = 0.0;
  int i = threadIdx.x;
  for (; i + (STREAM_UNROLL - 1) * STREAM_THREADS < chunk_vec;
       i += STREAM_UNROLL * STREAM_THREADS) {
    float4 v[STREAM_UNROLL];
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u) v[u] = __ldcs(src + i + u * STREAM_THREADS);
#pragma unroll
    for (int u = 0; u < STREAM_UNROLL; ++u)
      acc += (double(v[u].x) + double(v[u].y)) + (double(v[u].z) + double(v[u].w));
  }
  for (; i < chunk_vec; i += STREAM_THREADS) {
    const float4 v = __ldcs(src + i);
    acc += (double(v.x) + double(v.y)) + (double(v.z) + double(v.w));
  }
  const double tot = block_sum(acc);
  if (threadIdx.x == 0) partials[chunk] = tot;
}

__global__ void __launch_bounds__(STREAM_THREADS)
    sum_partials(const double* __restrict__ partials, double* __restrict__ out, int n_chunks) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_chunks; i += STREAM_THREADS) acc += partials[i];
  const double tot = block_sum(acc);
  if (threadIdx.x == 0) out[0] = tot;
}

}  // namespace dst

extern "C" {

// Kernel K: x fp32 [n_chunks * chunk_words] (chunk_words a multiple of 4),
// partials fp64 [n_chunks] scratch, out fp64 [1]. Returns the launches'
// cudaError_t (0 = both launched).
int dst_hbm_stream(const void* x, void* partials, void* out, int n_chunks, int chunk_words,
                   int offset, void* stream) {
  if (n_chunks <= 0 || chunk_words <= 0 || chunk_words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int off = ((offset % n_chunks) + n_chunks) % n_chunks;
  dst::stream_chunks<<<n_chunks, dst::STREAM_THREADS, 0, s>>>(
      static_cast<const float4*>(x), static_cast<double*>(partials), n_chunks, chunk_words / 4,
      off);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dst::sum_partials<<<1, dst::STREAM_THREADS, 0, s>>>(static_cast<const double*>(partials),
                                                       static_cast<double*>(out), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
