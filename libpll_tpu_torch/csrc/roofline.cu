// Roofline probes for Hopper (sm_90a): the float32 multiply-add peak (K7)
// and the speed of light of the DNA contraction on resident data (K8),
// bound to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py builds
// this file; libpll_tpu_torch/ops/roofline.py wraps and times it).
//
// Replaces the Pallas TPU probes of scripts/bench_vpu_roofline.py:
//   K7  vpu_fma_peak             (pallas_call at :102, body :91-98)
//   K8  roll_contract_sustained  (pallas_call at :139, body :127-133)
//
// What they compute, carried k times inside one launch (so that two chain
// lengths can be timed and differenced):
//   K7: acc <- acc * c + x over a [16, N] tile, acc starting at x and
//       c = x[0, 0]; 2 flop per element and iteration;
//   K8: x <- (sum_d coeff[r, d] x[(r + d*C) mod C*S]) * renorm per column
//       of a [C*S, N] tile (the TPU's sublane roll by (C*S - d*C) mod C*S,
//       with jnp.roll's direction), C = S = 4; counted as (2S - 1)*C*S flop
//       per column and iteration, as the TPU script counts it.
//
// Design on this card:
//  * The TPU probe carried one [16, 512*w] tile through the VPU.  Here the
//    tile is widened until the grid fills every SM, and each K7 thread
//    carries kIlp = 8 independent accumulators, so that the four schedulers
//    of an SM always have independent multiply-adds to issue: the probe
//    measures throughput, not the latency of one chain (the TPU script's
//    own point, bench_vpu_roofline.py:28-31).
//  * K8: one thread holds one column's C*S = 16 values and the [16, 4]
//    coefficients in registers; the roll becomes compile-time register
//    indexing, and a column's 16 rows give 16 independent chains.
//  * Nothing leaves the registers inside the loop: both probes are bound
//    by the FP32 pipes alone (Hopper: 128 FP32 lanes per SM, so
//    SMs x 128 x 2 flop per clock).
//  * acc grows without bound when c > 1 and may reach inf at large k; an
//    inf costs the FP32 pipe the same as a finite value, so it does not
//    change a rate.  The kernels are compared with their plain versions at
//    small k only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbeThreads = 256;
constexpr int kIlp = 8;            // K7 accumulators per thread
constexpr int kRates = 4, kStates = 4, kRows = kRates * kStates;

__global__ void __launch_bounds__(kProbeThreads)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int64_t n, int k) {
  const float c = x[0];
  const int64_t base = (int64_t)blockIdx.x * kIlp * kProbeThreads +
                       threadIdx.x;
  float xv[kIlp], acc[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    const int64_t i = base + (int64_t)j * kProbeThreads;
    xv[j] = i < n ? x[i] : 0.0f;
    acc[j] = xv[j];
  }
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int j = 0; j < kIlp; ++j) acc[j] = fmaf(acc[j], c, xv[j]);
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    const int64_t i = base + (int64_t)j * kProbeThreads;
    if (i < n) out[i] = acc[j];
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    roll_contract_kernel(const float* __restrict__ x,
                         const float* __restrict__ coeff,
                         float* __restrict__ out, int64_t cols, int k,
                         float renorm) {
  const int64_t col = (int64_t)blockIdx.x * kProbeThreads + threadIdx.x;
  if (col >= cols) return;
  float cf[kRows][kStates], v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int d = 0; d < kStates; ++d) cf[r][d] = coeff[r * kStates + d];
    v[r] = x[r * cols + col];
  }
  for (int it = 0; it < k; ++it) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] = cf[r][0] * v[r];
#pragma unroll
      for (int d = 1; d < kStates; ++d)
        acc[r] = fmaf(cf[r][d], v[(r + d * kRates) % kRows], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = acc[r] * renorm;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * cols + col] = v[r];
}

}  // namespace

// Plain C interface for ctypes.  Each function launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success).

// K7 over n = numel contiguous float32 values.
extern "C" int roofline_fma_chain(const void* x, void* out, int64_t n, int k,
                                  void* stream) {
  const int64_t per_block = (int64_t)kIlp * kProbeThreads;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  fma_chain_kernel<<<blocks, kProbeThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, k);
  return (int)cudaGetLastError();
}

// K8 over a [16, cols] float32 tile with [16, 4] coefficients.
extern "C" int roofline_roll_contract(const void* x, const void* coeff,
                                      void* out, int64_t cols, int k,
                                      float renorm, void* stream) {
  const unsigned blocks =
      (unsigned)((cols + kProbeThreads - 1) / kProbeThreads);
  roll_contract_kernel<<<blocks, kProbeThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(coeff),
      static_cast<float*>(out), cols, k, renorm);
  return (int)cudaGetLastError();
}

extern "C" const char* roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
