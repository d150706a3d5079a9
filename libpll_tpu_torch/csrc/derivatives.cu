// Newton branch-length solve on a sumtable (N1) for Hopper (sm_90a), bound
// to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py builds this file;
// libpll_tpu_torch/ops/derivatives.py wraps it).
//
// Replaces no Pallas kernel: the JAX package runs this loop as one
// lax.while_loop inside a compiled program (libpll_tpu/engine/evaluate.py
// :657 and :723), its body libpll_tpu/ops/derivatives.py:71-151
// (likelihood_derivatives).  Eager PyTorch would issue ~35 small operations
// per iteration, and a loop that stops on |d1| would read d1 on the host
// every iteration.
//
// What it computes, on a sumtable st[C, S, L] (the edge's CLVs in the
// eigenbasis, derivatives.update_sumtable):
//   lam[c,j] = eigenvals[c,j] * rates[c] / (1 - pinv[c]);
//   per body, at t: e = exp(lam t) and, per site n < ef,
//     cat_k[c] = sum_j st[c,j,n] * lam^k e          (k = 0, 1, 2)
//     under +I (pinv[c] > 0): cat_0 = cat_0 (1 - p) + freqs[c, inv[n]] p
//       (0 for a variant site), cat_1,2 *= (1 - p)
//     lk_k = sum_c rw[c] cat_k[c]
//     d1 += w[n] (-lk1/lk0),  d2 += w[n] ((lk1/lk0)^2 - lk2/lk0)
//   (ef = sites, or sites + S under Stamatakis, whose pseudo columns count
//   as real sites); under Lewis / Felsenstein the S pseudo columns add
//   their terms from absolute likelihoods (per-site scaler powers, no +I);
//   then step = d1/d2 (d1 where d2 == 0), t = clip(t - step, 1e-8, 100).
//   The loop keeps while_loop's semantics: the condition |d1| > 1e-9 and
//   iterations < 32 is tested before each body on the previous body's d1
//   (inf at first), so a body runs in the iteration whose d1 ends the loop.
//
// Design (simple and right first).
//  * One launch per body, issued back to back by newton_solve_* with no
//    host read (32 launches).  The loop's state (t, d1, d2 in out[]; the
//    iteration count, a ticket and the done flag in ctl[]) lives in device
//    memory; a launch after the loop has ended returns at once.  A CUDA
//    graph can capture the whole step.
//  * Each block computes e, lam e and lam^2 e for its C*S entries once, in
//    shared memory; its threads stride over sites, one site at a time, each
//    making the site's three C x S dots, the mixing and the weighted terms
//    in the working type, as the reference's body does.
//  * Sums: each block writes its float64 partials (a warp shuffle tree,
//    then the warps in order); the last block to finish (an atomic ticket
//    after __threadfence) folds them in a fixed order, adds the pseudo-site
//    terms, and applies the Newton update.  No float atomics, so two calls
//    give the same bits.  The JAX package sums float32 terms in float32;
//    this kernel sums them in float64 and rounds d1 and d2 to the working
//    type before the step.
//
// What bounds it, at the flagship (64 taxa x 262 144 sites, four rates,
// float32): per body ~130 flop a site, 1.1e9 flop for 32 bodies (0.017 ms
// at the FP32 peak), and 16.8 MB of sumtable plus 2.1 MB of weights and
// invariant codes read (0.006 ms at 3.35 TB/s; they fit the 50 MB L2, so
// later bodies read them from there).  Each launch's latency and its serial
// tail (the last block's fold) are what its time is expected to show.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "clv_common.cuh"  // Shift<T>, kMaxRates

namespace {

constexpr int kBlock = 256;  // threads per block (derivatives.THREADS)
constexpr int kWarps = kBlock / 32;
constexpr int kMaxIters = 32;
constexpr int kAscNone = 0, kAscLewis = 1, kAscFelsenstein = 2,
              kAscStamatakis = 3;
constexpr int kIters = 0, kTicket = 1, kDone = 2;  // ctl[] fields

template <typename T>
struct NewtonArgs {
  const T* sumtable;  // [C, S, L]
  const T* t0;        // [1]
  const T* rates;     // [C]
  const T* pinv;      // [C]
  const T* evals;     // [C, S]
  const T* freqs;     // [C, S]
  const T* rw;        // [C]
  const int32_t* invariant;  // [L], -1: variant
  const T* weights;          // [L]
  const int32_t* scal_p;     // [L] or null (zeros)
  const int32_t* scal_c;     // [L] or null (zeros)
  double* partials;          // [gridDim.x, 3]
  int32_t* ctl;              // iterations, ticket, done
  T* out;                    // t, d1, d2
  int64_t length;            // L: sites + pseudo columns
  int64_t sites;
  int64_t ef;                // sites evaluated as real sites
  int rate_cats;
  int asc_mode;
  int max_iters;
  int launch;  // this launch's index: 0 starts from t0
};

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double dev_abs(double x) { return fabs(x); }

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v (every thread's), in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by an earlier block_sum
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

// The three dots of rate c at column n with the staged diagonals (e,
// lam e, lam^2 e): the site's cat_0, cat_1, cat_2 of that rate.
template <typename T, int S>
__device__ __forceinline__ void rate_dots(const NewtonArgs<T>& a,
                                          const T* diag, int c, int64_t n,
                                          T cat[3]) {
  const T* col = a.sumtable + (int64_t)c * S * a.length + n;
  cat[0] = cat[1] = cat[2] = (T)0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const T v = col[j * a.length];
    cat[0] += v * diag[c * S + j];
    cat[1] += v * diag[kMaxRates * S + c * S + j];
    cat[2] += v * diag[2 * kMaxRates * S + c * S + j];
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kBlock)
    newton_kernel(const __grid_constant__ NewtonArgs<T> a) {
  if (a.launch > 0 && a.ctl[kDone]) return;  // the loop has ended
  __shared__ T diag[3 * kMaxRates * S];     // e, lam e, lam^2 e
  __shared__ T one_minus[kMaxRates];
  __shared__ double scratch[kWarps];
  __shared__ bool last;
  const int C = a.rate_cats;
  const T t = a.launch == 0 ? a.t0[0] : a.out[0];
  for (int k = threadIdx.x; k < C * S; k += blockDim.x) {
    const int c = k / S;
    const T ki = a.rates[c] / ((T)1 - a.pinv[c]);
    const T lam = a.evals[k] * ki;
    const T e = dev_exp(lam * t);
    diag[k] = e;
    diag[kMaxRates * S + k] = lam * e;
    diag[2 * kMaxRates * S + k] = lam * lam * e;
  }
  if (threadIdx.x < C) one_minus[threadIdx.x] = (T)1 - a.pinv[threadIdx.x];
  __syncthreads();

  double acc1 = 0.0, acc2 = 0.0, accw = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < a.ef;
       n += stride) {
    const int inv = a.invariant[n];
    T lk0 = 0, lk1 = 0, lk2 = 0;
    for (int c = 0; c < C; ++c) {
      T cat[3];
      rate_dots<T, S>(a, diag, c, n, cat);
      const T p = a.pinv[c];
      if (p > (T)0) {
        const T inv_lk = inv >= 0 ? a.freqs[c * S + inv] * p : (T)0;
        cat[0] = cat[0] * one_minus[c] + inv_lk;
        cat[1] = cat[1] * one_minus[c];
        cat[2] = cat[2] * one_minus[c];
      }
      const T w = a.rw[c];
      lk0 += w * cat[0];
      lk1 += w * cat[1];
      lk2 += w * cat[2];
    }
    const T deriv1 = -lk1 / lk0;
    const T deriv2 = deriv1 * deriv1 - lk2 / lk0;
    const T w = a.weights[n];
    acc1 += (double)(w * deriv1);
    acc2 += (double)(w * deriv2);
    if (n < a.sites) accw += (double)w;
  }
  acc1 = block_sum(acc1, scratch);
  acc2 = block_sum(acc2, scratch);
  accw = block_sum(accw, scratch);
  if (threadIdx.x == 0) {
    double* part = a.partials + 3 * (int64_t)blockIdx.x;
    part[0] = acc1;
    part[1] = acc2;
    part[2] = accw;
    __threadfence();  // the partials reach device memory before the ticket
    const unsigned ticket =
        atomicAdd(reinterpret_cast<unsigned*>(a.ctl + kTicket), 1u);
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: fold every block's partials in block order (thread i
  // takes blocks i, i + blockDim.x, ...), read past L1.
  __threadfence();
  double s1 = 0.0, s2 = 0.0, sw = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    s1 += __ldcg(a.partials + 3 * (int64_t)b);
    s2 += __ldcg(a.partials + 3 * (int64_t)b + 1);
    sw += __ldcg(a.partials + 3 * (int64_t)b + 2);
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  sw = block_sum(sw, scratch);
  if (threadIdx.x != 0) return;

  T d1 = (T)s1, d2 = (T)s2;
  if (a.asc_mode == kAscLewis || a.asc_mode == kAscFelsenstein) {
    double A0 = 0.0, A1 = 0.0, A2 = 0.0, sw_inv = 0.0;
    for (int64_t n = a.sites; n < a.length; ++n) {
      // no invariant mixing: p-inv and asc-bias exclude each other
      T lk[3] = {0, 0, 0};
      for (int c = 0; c < C; ++c) {
        T cat[3];
        rate_dots<T, S>(a, diag, c, n, cat);
        for (int k = 0; k < 3; ++k) lk[k] += a.rw[c] * cat[k];
      }
      const int sc = (a.scal_p ? a.scal_p[n] : 0) + (a.scal_c ? a.scal_c[n] : 0);
      const T factor = (T)ldexp(1.0, -Shift<T>::bits * sc);
      A0 += (double)(lk[0] * factor);
      A1 += (double)(lk[1] * factor);
      A2 += (double)(lk[2] * factor);
      sw_inv += (double)a.weights[n];
    }
    const T a0 = (T)A0, a1 = (T)A1, a2 = (T)A2;
    if (a.asc_mode == kAscLewis) {
      const T sum_w = (T)sw;
      d1 = d1 + sum_w * (a1 / (a0 - (T)1));
      d2 = d2 + sum_w * (((a0 - (T)1) * a2 - a1 * a1) /
                         ((a0 - (T)1) * (a0 - (T)1)));
    } else {
      const T sum_w_inv = (T)sw_inv;
      d1 = d1 - sum_w_inv * (a1 / a0);
      d2 = d2 - sum_w_inv * ((a2 * a0 - a1 * a1) / (a0 * a0));
    }
  }
  const T step = d2 != (T)0 ? d1 / d2 : d1;
  T t_new = t - step;
  // jnp.clip: NaN stays NaN (no fmin/fmax, which would drop it)
  const T lo = (T)1e-8, hi = (T)100;
  t_new = t_new < lo ? lo : (t_new > hi ? hi : t_new);
  const int iters = a.ctl[kIters] + 1;
  a.out[0] = t_new;
  a.out[1] = d1;
  a.out[2] = d2;
  a.ctl[kIters] = iters;
  a.ctl[kDone] = !(dev_abs(d1) > (T)1e-9 && iters < a.max_iters);
  a.ctl[kTicket] = 0;  // for the next launch
}

template <typename T>
int solve(int rate_cats, int states, int64_t length, int64_t sites, int grid,
          int asc_mode, int max_iters, int threads, const void* sumtable,
          const void* t0, const void* rates, const void* pinv,
          const void* evals, const void* freqs, const void* rw,
          const int32_t* invariant, const void* weights,
          const int32_t* scal_p, const int32_t* scal_c, double* partials,
          int32_t* ctl, void* out, void* stream) {
  const bool asc_cols = asc_mode != kAscNone;
  if (rate_cats < 1 || rate_cats > kMaxRates ||
      (states != 4 && states != 20) || sites < 1 || sites > length ||
      (asc_cols && length - sites != states) || asc_mode < kAscNone ||
      asc_mode > kAscStamatakis || grid < 1 || max_iters < 1 ||
      max_iters > kMaxIters || threads != kBlock)
    return (int)cudaErrorInvalidValue;
  NewtonArgs<T> a;
  a.sumtable = static_cast<const T*>(sumtable);
  a.t0 = static_cast<const T*>(t0);
  a.rates = static_cast<const T*>(rates);
  a.pinv = static_cast<const T*>(pinv);
  a.evals = static_cast<const T*>(evals);
  a.freqs = static_cast<const T*>(freqs);
  a.rw = static_cast<const T*>(rw);
  a.invariant = invariant;
  a.weights = static_cast<const T*>(weights);
  a.scal_p = scal_p;
  a.scal_c = scal_c;
  a.partials = partials;
  a.ctl = ctl;
  a.out = static_cast<T*>(out);
  a.length = length;
  a.sites = sites;
  a.ef = asc_mode == kAscStamatakis ? sites + states : sites;
  a.rate_cats = rate_cats;
  a.asc_mode = asc_mode;
  a.max_iters = max_iters;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < max_iters; ++k) {
    a.launch = k;
    if (states == 4)
      newton_kernel<T, 4><<<grid, kBlock, 0, st>>>(a);
    else
      newton_kernel<T, 20><<<grid, kBlock, 0, st>>>(a);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// Plain C interface for ctypes.  newton_solve_* launches `max_iters` kernels
// on `stream`, back to back, and returns the first cudaGetLastError() that is
// not 0 (0 on success).  ctl[] must be zero before the call.

#define SOLVE_PARAMS                                                          \
  int rate_cats, int states, int64_t length, int64_t sites, int grid,         \
      int asc_mode, int max_iters, int threads, const void *sumtable,         \
      const void *t0, const void *rates, const void *pinv, const void *evals, \
      const void *freqs, const void *rw, const int32_t *invariant,            \
      const void *weights, const int32_t *scal_p, const int32_t *scal_c,      \
      double *partials, int32_t *ctl, void *out, void *stream
#define SOLVE_ARGS                                                           \
  rate_cats, states, length, sites, grid, asc_mode, max_iters, threads,      \
      sumtable, t0, rates, pinv, evals, freqs, rw, invariant, weights,       \
      scal_p, scal_c, partials, ctl, out, stream

extern "C" int newton_solve_f32(SOLVE_PARAMS) {
  return solve<float>(SOLVE_ARGS);
}
extern "C" int newton_solve_f64(SOLVE_PARAMS) {
  return solve<double>(SOLVE_ARGS);
}

extern "C" const char* newton_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
