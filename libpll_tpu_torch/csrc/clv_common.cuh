// Device pieces shared by the port's likelihood kernels (clv_fused.cu,
// clv_dyn.cu, clv_seg.cu): encodings, scaling units, the f32/f64 math
// overloads, the per-rate contraction, the per-site and per-rate scaling
// test, the per-rate scaler fold of the edge log-likelihood and the
// per-block float64 reduction of the per-site log-likelihoods.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;    // sites per block, and per partial sum
constexpr int kRateMaxDiff = 4;  // SCALE_RATE_MAXDIFF
constexpr int kMaxRates = 8;

enum { TIP_CLV = 0, TIP_CHARS = 1, TIP_MASKS = 2 };
enum { SCALE_NONE = 0, SCALE_PER_SITE = 1, SCALE_PER_RATE = 2 };

// One scaling event multiplies by 2^bits (the reference's 2^256 at double,
// 2^32 at float).
template <typename T> struct Shift;
template <> struct Shift<float> { static constexpr int bits = 32; };
template <> struct Shift<double> { static constexpr int bits = 256; };

// The scaling units of one dtype: the threshold 2^-bits, the factor 2^bits
// and log(2^-bits), each exact or correctly rounded in T.
template <typename T>
struct Scale {
  T thresh, factor, log_scale;
};

template <typename T>
Scale<T> scale_units() {
  Scale<T> s;
  s.factor = (T)std::ldexp(1.0, Shift<T>::bits);
  s.thresh = (T)std::ldexp(1.0, -Shift<T>::bits);
  s.log_scale = (T)(-Shift<T>::bits * 0.69314718055994530942);
  return s;
}

__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }
__device__ __forceinline__ float dev_fma(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double dev_fma(double x, double y, double z) {
  return fma(x, y, z);
}

// sum_d row[d] * x[d], in K1's order.
template <typename T, int S>
__device__ __forceinline__ T dot(const T* row, const T (&x)[S]) {
  T acc = __ldg(row) * x[0];
#pragma unroll
  for (int d = 1; d < S; ++d) acc = dev_fma(__ldg(row + d), x[d], acc);
  return acc;
}

// The contraction of rate c of a child: t[s] = sum_d pm[c, s, d] x[d],
// with pm one branch's [C, S, S] P-matrices.  Each row is addressed from
// pm as (c*S + s)*S: the same loop over a pointer advanced to rate c first
// made the dyn kernels 9% slower on an H100.
template <typename T, int S>
__device__ __forceinline__ void contract_rate(const T* pm, int c,
                                              const T (&x)[S], T (&t)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) t[s] = dot<T, S>(pm + (c * S + s) * S, x);
}

// The same contraction of the second child, multiplied into t.
template <typename T, int S>
__device__ __forceinline__ void mul_contract_rate(const T* pm, int c,
                                                  const T (&x)[S],
                                                  T (&t)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) t[s] *= dot<T, S>(pm + (c * S + s) * S, x);
}

template <typename T, int S>
__device__ __forceinline__ T max_of(const T (&t)[S]) {
  T mx = t[0];
#pragma unroll
  for (int s = 1; s < S; ++s) mx = t[s] > mx ? t[s] : mx;
  return mx;
}

// The scaling test of one block of values whose maximum is mx: when a node
// that may scale has every value below 2^-bits, the values are multiplied
// by 2^bits.  Returns the counter's increment (0 or 1).  Per rate the
// block is one rate's S values; per site it is the site's C*S values
// (their running maximum over the rates).
template <typename T>
__device__ __forceinline__ bool scales(bool has, T mx, const Scale<T>& u) {
  return has && mx < u.thresh;
}

template <typename T, int S>
__device__ __forceinline__ int scale_rate(bool has, T (&t)[S],
                                          const Scale<T>& u) {
  if (!scales(has, max_of<T, S>(t), u)) return 0;
#pragma unroll
  for (int s = 0; s < S; ++s) t[s] *= u.factor;
  return 1;
}

// Rate c's term of the edge sum: sum_s pv[s] (P x)[s] w[c*S + s], with pe
// the edge's [C, S, S] P-matrices and w the [C*S] weight vector.
template <typename T, int S>
__device__ __forceinline__ T edge_rate_term(const T* pe, int c,
                                            const T (&pv)[S],
                                            const T (&x)[S], const T* w) {
  T acc = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    acc = dev_fma(pv[s] * dot<T, S>(pe + (c * S + s) * S, x),
                  __ldg(w + c * S + s), acc);
  return acc;
}

// The per-rate counters sn of one site folded as the reference does
// (src/core_likelihood.c:916-941): the site's counter is their minimum, and
// each rate's term is multiplied by 2^-bits once per count above it, at
// most kRateMaxDiff times.  Returns the sum of the folded terms; the
// site's counter goes to snum.
template <typename T>
__device__ __forceinline__ T fold_rates(T (&term_r)[kMaxRates],
                                        const int (&sn)[kMaxRates], int C,
                                        T thresh, int& snum) {
  snum = 0;
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    snum = (c == 0 || sn[c] < snum) ? sn[c] : snum;
  }
  T term = 0;
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    const int diff = min(sn[c] - snum, kRateMaxDiff);
    for (int k = 0; k < diff; ++k) term_r[c] *= thresh;
    term += term_r[c];
  }
  return term;
}

// A site's weighted log-likelihood from its summed term and counter.
template <typename T>
__device__ __forceinline__ T site_lnl(T term, int snum, const Scale<T>& u,
                                      T pattern_weight) {
  return (dev_log(term) + (T)snum * u.log_scale) * pattern_weight;
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
