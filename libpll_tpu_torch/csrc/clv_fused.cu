// Fused post-order pruning sweep (K2) and fused edge score (K1) for Hopper
// (sm_90a), bound to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py
// builds this file; libpll_tpu_torch/ops/clv_fused.py wraps it).
//
// Replaces the two Pallas TPU kernels of libpll_tpu/ops/clv_pallas.py:
//   K1  make_fused_edge_score  (pallas_call at :653)
//   K2  make_fused_sweep       (pallas_call at :840)
//
// What they compute, per site: for every op in post order (children before
// parents, the op table of clv_fused.flatten_ops),
//   x[c,s] = (sum_d P[m1,c,s,d] child1[c,d]) * (sum_d P[m2,c,s,d] child2[c,d])
// with the parent's counter starting at the sum of its children's.  Under
// per-site scaling, when every one of the site's C*S values is below
// 2^-shift the values are multiplied by 2^shift and the counter gains 1
// (shift = 32 at float, 256 at double).  Under per-rate scaling the same
// test runs per rate category with one counter per (rate, site).  K2 writes
// every inner CLV and counter out.  K1 then folds the edge log-likelihood:
//   lnl = (log(sum_k parent[k] * (P[edge] child)[k] * wvec[k] (+ inv_add))
//          + counters * log(2^-shift)) * pattern_weight
// and writes one float64 partial sum per thread block; the wrapper folds the
// partials in float64.
//
// Tips come as 0/1 CLV rows ("clv", [tips, C*S, L]), as 4-bit ambiguity
// codes packed eight to an int32 word ("chars", nibble 4*(i%8) of word i/8,
// masked & 0xF), or as one bitmask word per tip ("masks").  A pattern tip is
// decoded into the same 0/1 rows a "clv" tip would hold, so the three
// encodings share one contraction.
//
// Design on this card.  The TPU kernel kept every inner CLV of a site block
// in 10 MB of VMEM.  An H100 block has at most 227 KB of shared memory,
// and at the flagship (64 taxa, 62 inner nodes, C*S = 16 floats) a site's
// inner CLVs take ~4 KB, so a useful site tile does not fit on chip.  This
// first kernel therefore runs one thread per site (blocks over the site
// axis, the ragged last block masked), keeps each op's C*S values in
// registers and spills every inner CLV to a global scratch laid out
// [node, C*S, site] with the site innermost, so that a warp's loads and
// stores are coalesced.  P-matrices and the op table are read through the
// read-only cache with warp-uniform addresses; counters are int32.
//
// What bounds it, at the flagship per evaluation: ~62 ops x 262,144 sites x
// 4 rates x ~68 flop = 4.4 GFLOP (0.07 ms at the 67 TFLOP/s FP32 peak)
// against one write and one read of ~4 KB of scratch per site, ~2 GB (a
// 0.6 ms floor at 3.35 TB/s): the simple K1 is bound by its scratch
// traffic, and K2 by its ~1 GB CLV write-out.  Keeping the live post-order
// frontier on chip is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "clv_common.cuh"

namespace {

constexpr int kStates = 4;     // DNA; clv_dyn.cu also takes protein
constexpr int kOpFields = 8;   // prow, c1, m1, c2, m2, s1, s2, has_scaler

template <typename T>
struct SweepArgs {
  const int32_t* ops;        // [n_ops, kOpFields]
  int n_ops;
  int n_tips;
  int n_inner;
  int64_t sites;
  int tip_encoding;
  int scale_mode;
  const T* tip_clv;          // [n_tips, C*S, sites]        ("clv")
  const int32_t* tip_words;  // [ceil(n_tips/8) or n_tips, sites]
  const T* pmatrix;          // [M, C, S, S]
  T* inner;                  // [n_inner, C*S, sites]; written and re-read
  int32_t* scalers;          // [(n_inner + 1) * srows, sites]
  T thresh;
  T factor;
};

template <typename T>
struct ScoreArgs {
  int parent_clv;
  int child_clv;
  int edge_matrix;
  int parent_srow;           // n_inner (the dummy) for a tip
  int child_srow;
  const T* weight_vec;       // [C*S]
  const T* pattern_weights;  // [sites]
  const T* inv_add;          // [sites], or null without +I
  T log_scale;
  double* partials;          // [n_blocks]
};

// CLV rows of node `idx` at one site.  Inner rows are read with plain
// loads: this kernel wrote them, so the non-coherent read-only path is
// not allowed there.
template <typename T, int C>
__device__ __forceinline__ void load_clv(const SweepArgs<T>& a, int idx,
                                         int64_t site, T (&x)[C * kStates]) {
  constexpr int CS = C * kStates;
  if (idx >= a.n_tips) {
    const T* base = a.inner + (int64_t)(idx - a.n_tips) * CS * a.sites;
#pragma unroll
    for (int k = 0; k < CS; ++k) x[k] = base[k * a.sites + site];
    return;
  }
  if (a.tip_encoding == TIP_CLV) {
    const T* base = a.tip_clv + (int64_t)idx * CS * a.sites;
#pragma unroll
    for (int k = 0; k < CS; ++k) x[k] = __ldg(base + k * a.sites + site);
    return;
  }
  uint32_t code;
  if (a.tip_encoding == TIP_CHARS) {
    const uint32_t word =
        (uint32_t)__ldg(a.tip_words + (int64_t)(idx >> 3) * a.sites + site);
    code = (word >> (4 * (idx & 7))) & 0xFu;
  } else {
    code = (uint32_t)__ldg(a.tip_words + (int64_t)idx * a.sites + site);
  }
#pragma unroll
  for (int d = 0; d < kStates; ++d) {
    const T bit = (T)((code >> d) & 1u);
#pragma unroll
    for (int c = 0; c < C; ++c) x[c * kStates + d] = bit;
  }
}

// y[c,s] = sum_d pm[c,s,d] * x[c,d] for one [C, S, S] matrix.
template <typename T, int C>
__device__ __forceinline__ void contract(const T* pm,
                                         const T (&x)[C * kStates],
                                         T (&y)[C * kStates]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      const T* row = pm + (c * kStates + s) * kStates;
      T acc = __ldg(row) * x[c * kStates];
#pragma unroll
      for (int d = 1; d < kStates; ++d)
        acc = dev_fma(__ldg(row + d), x[c * kStates + d], acc);
      y[c * kStates + s] = acc;
    }
  }
}

template <typename T>
__device__ __forceinline__ int load_count(const SweepArgs<T>& a, int srow,
                                          int srows, int c, int64_t site) {
  return srow == a.n_inner
             ? 0
             : a.scalers[((int64_t)srow * srows + c) * a.sites + site];
}

template <typename T, int C>
__device__ void sweep_site(const SweepArgs<T>& a, int64_t site) {
  constexpr int CS = C * kStates;
  constexpr int PM = C * kStates * kStates;  // one branch's P-matrices
  const int srows = a.scale_mode == SCALE_PER_RATE ? C : 1;
  for (int c = 0; c < srows; ++c)
    a.scalers[((int64_t)a.n_inner * srows + c) * a.sites + site] = 0;

  for (int i = 0; i < a.n_ops; ++i) {
    const int32_t* op = a.ops + i * kOpFields;
    const int prow = __ldg(op + 0);
    const int s1 = __ldg(op + 5), s2 = __ldg(op + 6);
    const bool has = __ldg(op + 7) != 0;
    T x[CS], t1[CS], t2[CS];
    load_clv<T, C>(a, __ldg(op + 1), site, x);
    contract<T, C>(a.pmatrix + (int64_t)__ldg(op + 2) * PM, x, t1);
    load_clv<T, C>(a, __ldg(op + 3), site, x);
    contract<T, C>(a.pmatrix + (int64_t)__ldg(op + 4) * PM, x, t2);
#pragma unroll
    for (int k = 0; k < CS; ++k) t1[k] *= t2[k];

    if (a.scale_mode == SCALE_PER_RATE) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        int cnt = load_count(a, s1, C, c, site) + load_count(a, s2, C, c, site);
        if (has) {
          T mx = t1[c * kStates];
#pragma unroll
          for (int s = 1; s < kStates; ++s)
            mx = t1[c * kStates + s] > mx ? t1[c * kStates + s] : mx;
          if (mx < a.thresh) {
#pragma unroll
            for (int s = 0; s < kStates; ++s) t1[c * kStates + s] *= a.factor;
            cnt += 1;
          }
        }
        a.scalers[((int64_t)prow * C + c) * a.sites + site] = cnt;
      }
    } else {
      int cnt = load_count(a, s1, 1, 0, site) + load_count(a, s2, 1, 0, site);
      if (a.scale_mode == SCALE_PER_SITE && has) {
        T mx = t1[0];
#pragma unroll
        for (int k = 1; k < CS; ++k) mx = t1[k] > mx ? t1[k] : mx;
        if (mx < a.thresh) {
#pragma unroll
          for (int k = 0; k < CS; ++k) t1[k] *= a.factor;
          cnt += 1;
        }
      }
      a.scalers[(int64_t)prow * a.sites + site] = cnt;
    }

    T* out = a.inner + (int64_t)prow * CS * a.sites + site;
#pragma unroll
    for (int k = 0; k < CS; ++k) out[k * a.sites] = t1[k];
  }
}

// Weighted log-likelihood of one site across the evaluation edge (per-site
// or no scaling: K1's scope, as on the TPU).
template <typename T, int C>
__device__ T edge_site_lnl(const SweepArgs<T>& a, const ScoreArgs<T>& s,
                           int64_t site) {
  constexpr int CS = C * kStates;
  constexpr int PM = C * kStates * kStates;
  T pv[CS], x[CS], tb[CS];
  load_clv<T, C>(a, s.parent_clv, site, pv);
  load_clv<T, C>(a, s.child_clv, site, x);
  contract<T, C>(a.pmatrix + (int64_t)s.edge_matrix * PM, x, tb);
  T site_term = 0;
#pragma unroll
  for (int k = 0; k < CS; ++k)
    site_term = dev_fma(pv[k] * tb[k], __ldg(s.weight_vec + k), site_term);
  if (s.inv_add != nullptr) site_term += __ldg(s.inv_add + site);
  const int snum = load_count(a, s.parent_srow, 1, 0, site) +
                   load_count(a, s.child_srow, 1, 0, site);
  return (dev_log(site_term) + (T)snum * s.log_scale) *
         __ldg(s.pattern_weights + site);
}

template <typename T, int C, bool kScore>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(SweepArgs<T> a, ScoreArgs<T> s) {
  const int64_t site = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  double lnl = 0.0;
  if (site < a.sites) {
    sweep_site<T, C>(a, site);
    if (kScore) lnl = (double)edge_site_lnl<T, C>(a, s, site);
  }
  // every thread of the block joins the reduction, masked sites with 0
  if (kScore) block_sum_store(lnl, s.partials);
}

template <typename T, bool kScore>
int launch(const SweepArgs<T>& a, const ScoreArgs<T>& s, int rate_cats,
           void* stream) {
  const unsigned blocks = (unsigned)((a.sites + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rate_cats) {
    case 1: fused_kernel<T, 1, kScore><<<blocks, kThreads, 0, st>>>(a, s); break;
    case 2: fused_kernel<T, 2, kScore><<<blocks, kThreads, 0, st>>>(a, s); break;
    case 4: fused_kernel<T, 4, kScore><<<blocks, kThreads, 0, st>>>(a, s); break;
    case 8: fused_kernel<T, 8, kScore><<<blocks, kThreads, 0, st>>>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
SweepArgs<T> sweep_args(const int32_t* ops, int n_ops, int n_tips,
                        int n_inner, int64_t sites, int tip_encoding,
                        int scale_mode, const void* tips, const void* pmatrix,
                        void* inner, int32_t* scalers) {
  SweepArgs<T> a;
  a.ops = ops;
  a.n_ops = n_ops;
  a.n_tips = n_tips;
  a.n_inner = n_inner;
  a.sites = sites;
  a.tip_encoding = tip_encoding;
  a.scale_mode = scale_mode;
  a.tip_clv = tip_encoding == TIP_CLV ? static_cast<const T*>(tips) : nullptr;
  a.tip_words =
      tip_encoding == TIP_CLV ? nullptr : static_cast<const int32_t*>(tips);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.inner = static_cast<T*>(inner);
  a.scalers = scalers;
  a.factor = (T)std::ldexp(1.0, Shift<T>::bits);
  a.thresh = (T)std::ldexp(1.0, -Shift<T>::bits);
  return a;
}

template <typename T>
int sweep(const int32_t* ops, int n_ops, int n_tips, int n_inner,
          int64_t sites, int rate_cats, int tip_encoding, int scale_mode,
          const void* tips, const void* pmatrix, void* inner,
          int32_t* scalers, void* stream) {
  const SweepArgs<T> a =
      sweep_args<T>(ops, n_ops, n_tips, n_inner, sites, tip_encoding,
                    scale_mode, tips, pmatrix, inner, scalers);
  return launch<T, false>(a, ScoreArgs<T>{}, rate_cats, stream);
}

template <typename T>
int score(const int32_t* ops, int n_ops, int n_tips, int n_inner,
          int64_t sites, int rate_cats, int tip_encoding, int scale_mode,
          const void* tips, const void* pmatrix, void* inner,
          int32_t* scalers, int parent_clv, int child_clv, int edge_matrix,
          int parent_srow, int child_srow, const void* weight_vec,
          const void* pattern_weights, const void* inv_add, double* partials,
          void* stream) {
  const SweepArgs<T> a =
      sweep_args<T>(ops, n_ops, n_tips, n_inner, sites, tip_encoding,
                    scale_mode, tips, pmatrix, inner, scalers);
  ScoreArgs<T> s;
  s.parent_clv = parent_clv;
  s.child_clv = child_clv;
  s.edge_matrix = edge_matrix;
  s.parent_srow = parent_srow;
  s.child_srow = child_srow;
  s.weight_vec = static_cast<const T*>(weight_vec);
  s.pattern_weights = static_cast<const T*>(pattern_weights);
  s.inv_add = static_cast<const T*>(inv_add);
  s.log_scale = (T)(-Shift<T>::bits * 0.69314718055994530942);
  s.partials = partials;
  return launch<T, true>(a, s, rate_cats, stream);
}

}  // namespace

// Plain C interface for ctypes.  Each function launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success).

#define SWEEP_PARAMS                                                        \
  const int32_t *ops, int n_ops, int n_tips, int n_inner, int64_t sites,    \
      int rate_cats, int tip_encoding, int scale_mode, const void *tips,    \
      const void *pmatrix, void *inner, int32_t *scalers
#define SWEEP_ARGS                                                          \
  ops, n_ops, n_tips, n_inner, sites, rate_cats, tip_encoding, scale_mode,  \
      tips, pmatrix, inner, scalers
#define SCORE_PARAMS                                                        \
  int parent_clv, int child_clv, int edge_matrix, int parent_srow,          \
      int child_srow, const void *weight_vec, const void *pattern_weights,  \
      const void *inv_add, double *partials
#define SCORE_ARGS                                                          \
  parent_clv, child_clv, edge_matrix, parent_srow, child_srow, weight_vec,  \
      pattern_weights, inv_add, partials

extern "C" int clv_fused_sweep_f32(SWEEP_PARAMS, void* stream) {
  return sweep<float>(SWEEP_ARGS, stream);
}
extern "C" int clv_fused_sweep_f64(SWEEP_PARAMS, void* stream) {
  return sweep<double>(SWEEP_ARGS, stream);
}
extern "C" int clv_fused_score_f32(SWEEP_PARAMS, SCORE_PARAMS, void* stream) {
  return score<float>(SWEEP_ARGS, SCORE_ARGS, stream);
}
extern "C" int clv_fused_score_f64(SWEEP_PARAMS, SCORE_PARAMS, void* stream) {
  return score<double>(SWEEP_ARGS, SCORE_ARGS, stream);
}
extern "C" const char* clv_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
