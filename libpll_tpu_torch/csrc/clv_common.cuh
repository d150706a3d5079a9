// Device pieces shared by the port's likelihood kernels (clv_fused.cu,
// clv_dyn.cu): encodings, scaling units, the f32/f64 math overloads and the
// per-block float64 reduction of the per-site log-likelihoods.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;  // sites per block, and per partial sum

enum { TIP_CLV = 0, TIP_CHARS = 1, TIP_MASKS = 2 };
enum { SCALE_NONE = 0, SCALE_PER_SITE = 1, SCALE_PER_RATE = 2 };

// One scaling event multiplies by 2^bits (the reference's 2^256 at double,
// 2^32 at float).
template <typename T> struct Shift;
template <> struct Shift<float> { static constexpr int bits = 32; };
template <> struct Shift<double> { static constexpr int bits = 256; };

__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }
__device__ __forceinline__ float dev_fma(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double dev_fma(double x, double y, double z) {
  return fma(x, y, z);
}

// Sum `v` over the block's kThreads threads in float64 and store it at
// out[blockIdx.x].  Every thread of the block must call it.
__device__ void block_sum_store(double v, double* out) {
  __shared__ double warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    out[blockIdx.x] = total;
  }
}

}  // namespace
