// Schedule-as-data segment kernels for Hopper (sm_90a): the dyn sweep (K5)
// and the dyn score (K6), bound to PyTorch through ctypes
// (libpll_tpu_torch/ops/_build.py builds this file;
// libpll_tpu_torch/ops/clv_dyn.py wraps it).
//
// Replaces the Pallas TPU kernels of libpll_tpu/ops/clv_pallas_dyn.py:
//   K5  make_dyn_sweep   (pallas_call at :521)
//   K6  make_dyn_score   (leaf segments, pallas_call at :928; the root
//                         segment, pallas_call at :990)
//
// What one launch computes: one segment of a tree cut into segments
// (ops/clv_seg.py, padded by ops/clv_dyn.build_dyn_schedule).  The segment
// is data: an op table of (parent, child1, child2, scaler1, scaler2,
// has_scaler) rows in the segment's own row numbers (tips | imports |
// locals | trash), and two P-matrix ids per op.  Per site, for each op,
//   x[c,s] = (sum_d P[m1,c,s,d] child1[c,d]) * (sum_d P[m2,c,s,d] child2[c,d])
// and the parent's counter starts at the sum of its children's.  Under
// per-site scaling, when all C*S values are below 2^-shift they are
// multiplied by 2^shift and the counter gains 1 (shift 32 at float, 256 at
// double); under per-rate scaling the test runs per rate, one counter per
// (rate, site).  Then, by mode:
//   sweep (K5): the locals are the tree's inner rows, written in place;
//   leaf  (K6): the rows later segments import are copied out by the
//               segment's export table;
//   root  (K6): the edge log-likelihood is folded,
//     lnl = (log(sum_k parent[k] (P[edge] child)[k] wvec[k] (+ inv_add))
//            + counters * log(2^-shift)) * pattern_weight,
//     per-rate counters first folded to their per-site minimum with the
//     remainder (capped at 4) applied to each rate's term as the reference
//     does (src/core_likelihood.c:916-941); one float64 partial per block.
//
// Design on this card, and what was decided:
//  * The TPU kernel kept a segment's rows in VMEM (10 MB) and sized
//    segments to it.  An H100 block has 227 KB of shared memory, less than
//    one site's rows of a useful segment.  So, as K1 (clv_fused.cu), one
//    thread runs one site through the whole op table, and a segment's
//    local rows live in device memory laid out [row, C*S, site] with the
//    site innermost, so that a warp's loads and stores are coalesced.  K5
//    writes them straight into the tree's inner CLV array; K6 into one
//    scratch of r_loc rows that every segment reuses.  The row budget is
//    therefore a device-memory budget (clv_dyn.dyn_max_rows: 16 GiB of
//    scratch, 204 rows at 10 240 taxa x 2^20 sites in float32), not the
//    TPU's VMEM constants.
//  * Imports are read where they lie (K5: earlier segments' inner rows;
//    K6: earlier segments' export rows) through one index per import slot,
//    and tips are read from the tree's one packed tip array by global id
//    (tip_globals): no per-segment copies.
//  * The contraction runs rate by rate, so a thread holds S values of a
//    child and S of the product, not C*S of each: the template is over the
//    dtype and S in {4, 20} only (4 instances), the rate count is a runtime
//    loop, and protein (S = 20) fits the registers at any rate count.  A
//    rate's product is stored as soon as it is done; under per-site
//    scaling the thread keeps the running maximum and, in the rare case
//    that the site scales, reads its C*S values back and multiplies them.
//    Scaling by a power of two is exact, so this equals scaling in
//    registers.
//  * Pad ops (parent = trash row) and pad export entries are skipped.
//  * Mode, tip encoding, scale mode and +I are warp-uniform runtime
//    branches, as in K1.
//
// What bounds it: per op and site it moves one CLV row out (C*S values)
// and one in for each inner child, against 2*C*S*S multiply-adds; for DNA
// (C*S = 16 floats, 64 B) that is ~130 B per 128 flop: memory-bound, as
// K1.  At 10 240 taxa x 2^20 sites an evaluation moves ~1.4 TB (0.4 s at
// 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "clv_common.cuh"

namespace {

constexpr int kFields = 6;  // parent, c1, c2, s1, s2, has_scaler

enum { MODE_SWEEP = 0, MODE_LEAF = 1, MODE_ROOT = 2 };

template <typename T>
struct DynArgs {
  int mode;
  int rate_cats;
  int tip_encoding;
  int scale_mode;
  int64_t sites;
  int r_tip, r_imp, r_loc, r_exp;
  const int32_t* table;        // [r_loc, kFields]
  const int32_t* m_ops;        // [r_loc, 2]
  const int32_t* tip_globals;  // [r_tip]: global tip id of each tip row
  const int32_t* imp_rows;     // [r_imp]: row of each import in src
  const T* tip_clv;            // [tips, C*S, sites]             ("clv")
  const int32_t* tip_words;    // [ceil(tips/8) or tips, sites]
  const T* pmatrix;            // [M, C, S, S]
  const T* src;                // import rows [*, C*S, sites]
  const int32_t* src_scal;     // their counters [* x srows, sites]
  T* loc;                      // local rows [r_loc, C*S, sites]
  int32_t* loc_scal;           // [r_loc x srows, sites]
  const int32_t* exp_table;    // leaf: [r_exp, 2] (state row, scaler row)
  T* exports;                  // leaf: [r_exp, C*S, sites]
  int32_t* export_scal;        // leaf: [r_exp x srows, sites]
  const int32_t* edge;         // root: p_state, c_state, p_scal, c_scal, M
  const T* weight_vec;         // root: [C*S]
  const T* pattern_weights;    // root: [sites]
  const T* inv_add;            // root: [sites], or null without +I
  double* partials;            // root: [n_blocks]
  Scale<T> u;
};

// A state row at one site: a CLV row (ptr at its k = 0 value), or a
// pattern tip's ambiguity bits.
template <typename T>
struct Row {
  const T* ptr;
  uint32_t code;
};

template <typename T, int S>
__device__ __forceinline__ Row<T> resolve(const DynArgs<T>& a, int row,
                                          int64_t site) {
  const int64_t cs_sites = (int64_t)a.rate_cats * S * a.sites;
  Row<T> r{nullptr, 0u};
  if (row < a.r_tip) {
    const int64_t g = __ldg(a.tip_globals + row);
    if (a.tip_encoding == TIP_CLV) {
      r.ptr = a.tip_clv + g * cs_sites + site;
    } else if (a.tip_encoding == TIP_CHARS) {
      const uint32_t word =
          (uint32_t)__ldg(a.tip_words + (g >> 3) * a.sites + site);
      r.code = (word >> (4 * (g & 7))) & 0xFu;
    } else {
      r.code = (uint32_t)__ldg(a.tip_words + g * a.sites + site);
    }
  } else if (row < a.r_tip + a.r_imp) {
    r.ptr = a.src + (int64_t)__ldg(a.imp_rows + row - a.r_tip) * cs_sites +
            site;
  } else {
    r.ptr = a.loc + (int64_t)(row - a.r_tip - a.r_imp) * cs_sites + site;
  }
  return r;
}

// The S values of rate c of a row.  Rows this launch writes are read with
// plain loads (not the read-only path).
template <typename T, int S>
__device__ __forceinline__ void load_rate(const Row<T>& r, int c,
                                          int64_t sites, T (&x)[S]) {
  if (r.ptr != nullptr) {
    const T* base = r.ptr + (int64_t)c * S * sites;
#pragma unroll
    for (int d = 0; d < S; ++d) x[d] = base[d * sites];
  } else {
#pragma unroll
    for (int d = 0; d < S; ++d) x[d] = (T)((r.code >> d) & 1u);
  }
}

// Counter of scaler row `srow`, rate c (c = 0 with one row per node).
template <typename T>
__device__ __forceinline__ int count(const DynArgs<T>& a, int srow,
                                     int srows, int c, int64_t site) {
  if (srow < a.r_imp)
    return a.src_scal[((int64_t)__ldg(a.imp_rows + srow) * srows + c) *
                          a.sites + site];
  const int l = srow - a.r_imp;
  if (l < a.r_loc)
    return a.loc_scal[((int64_t)l * srows + c) * a.sites + site];
  return 0;  // the dummy row
}

template <typename T, int S>
__device__ void run_ops(const DynArgs<T>& a, int64_t site) {
  const int C = a.rate_cats;
  const int64_t cs_sites = (int64_t)C * S * a.sites;
  const int64_t pm_size = (int64_t)C * S * S;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int loc0 = a.r_tip + a.r_imp;
  for (int i = 0; i < a.r_loc; ++i) {
    const int32_t* op = a.table + i * kFields;
    const int p = __ldg(op);
    if (p >= loc0 + a.r_loc) continue;  // a pad op
    const int local = p - loc0;
    const Row<T> r1 = resolve<T, S>(a, __ldg(op + 1), site);
    const Row<T> r2 = resolve<T, S>(a, __ldg(op + 2), site);
    const int s1 = __ldg(op + 3), s2 = __ldg(op + 4);
    const bool has = __ldg(op + 5) != 0;
    const T* p1 = a.pmatrix + __ldg(a.m_ops + 2 * i) * pm_size;
    const T* p2 = a.pmatrix + __ldg(a.m_ops + 2 * i + 1) * pm_size;
    T* out = a.loc + local * cs_sites + site;
    T site_max = 0;
    for (int c = 0; c < C; ++c) {
      T x[S], t[S];
      load_rate<T, S>(r1, c, a.sites, x);
      contract_rate<T, S>(p1, c, x, t);
      load_rate<T, S>(r2, c, a.sites, x);
      mul_contract_rate<T, S>(p2, c, x, t);
      const T mx = max_of<T, S>(t);
      if (per_rate) {
        const int cnt = count(a, s1, C, c, site) + count(a, s2, C, c, site) +
                        scale_rate<T, S>(has, t, a.u);
        a.loc_scal[((int64_t)local * C + c) * a.sites + site] = cnt;
      }
      site_max = (c == 0 || mx > site_max) ? mx : site_max;
#pragma unroll
      for (int s = 0; s < S; ++s) out[(int64_t)(c * S + s) * a.sites] = t[s];
    }
    if (!per_rate) {
      int cnt = count(a, s1, 1, 0, site) + count(a, s2, 1, 0, site);
      if (a.scale_mode == SCALE_PER_SITE && scales(has, site_max, a.u)) {
        for (int k = 0; k < C * S; ++k)
          out[(int64_t)k * a.sites] *= a.u.factor;
        cnt += 1;
      }
      a.loc_scal[(int64_t)local * a.sites + site] = cnt;
    }
  }
}

// Leaf: copy the rows later segments import into this segment's exports.
template <typename T, int S>
__device__ void export_rows(const DynArgs<T>& a, int64_t site) {
  const int C = a.rate_cats;
  const int srows = a.scale_mode == SCALE_PER_RATE ? C : 1;
  const int trash = a.r_tip + a.r_imp + a.r_loc;
  for (int e = 0; e < a.r_exp; ++e) {
    const int st = __ldg(a.exp_table + 2 * e);
    if (st >= trash) continue;  // a pad entry
    const int sc = __ldg(a.exp_table + 2 * e + 1);
    const Row<T> r = resolve<T, S>(a, st, site);
    T* out = a.exports + (int64_t)e * C * S * a.sites + site;
    for (int c = 0; c < C; ++c) {
      T x[S];
      load_rate<T, S>(r, c, a.sites, x);
#pragma unroll
      for (int s = 0; s < S; ++s) out[(int64_t)(c * S + s) * a.sites] = x[s];
    }
    for (int c = 0; c < srows; ++c)
      a.export_scal[((int64_t)e * srows + c) * a.sites + site] =
          count(a, sc, srows, c, site);
  }
}

// Root: the weighted log-likelihood of one site across the evaluation edge.
template <typename T, int S>
__device__ T edge_site_lnl(const DynArgs<T>& a, int64_t site) {
  const int C = a.rate_cats;
  const Row<T> rp = resolve<T, S>(a, __ldg(a.edge + 0), site);
  const Row<T> rc = resolve<T, S>(a, __ldg(a.edge + 1), site);
  const int psc = __ldg(a.edge + 2), csc = __ldg(a.edge + 3);
  const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * C * S * S;
  T term_r[kMaxRates];
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    T pv[S], x[S];
    load_rate<T, S>(rp, c, a.sites, pv);
    load_rate<T, S>(rc, c, a.sites, x);
    term_r[c] = edge_rate_term<T, S>(pe, c, pv, x, a.weight_vec);
  }
  T term = 0;
  int snum;
  if (a.scale_mode == SCALE_PER_RATE) {
    int sn[kMaxRates];
#pragma unroll
    for (int c = 0; c < kMaxRates; ++c) {
      if (c >= C) break;
      sn[c] = count(a, psc, C, c, site) + count(a, csc, C, c, site);
    }
    term = fold_rates<T>(term_r, sn, C, a.u.thresh, snum);
  } else {
#pragma unroll
    for (int c = 0; c < kMaxRates; ++c) {
      if (c >= C) break;
      term += term_r[c];
    }
    snum = count(a, psc, 1, 0, site) + count(a, csc, 1, 0, site);
  }
  if (a.inv_add != nullptr) term += __ldg(a.inv_add + site);
  return site_lnl<T>(term, snum, a.u, __ldg(a.pattern_weights + site));
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) dyn_kernel(DynArgs<T> a) {
  const int64_t site = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  double lnl = 0.0;
  if (site < a.sites) {
    run_ops<T, S>(a, site);
    if (a.mode == MODE_LEAF)
      export_rows<T, S>(a, site);
    else if (a.mode == MODE_ROOT)
      lnl = (double)edge_site_lnl<T, S>(a, site);
  }
  // every thread of a root block joins the reduction, masked sites with 0
  if (a.mode == MODE_ROOT) block_sum_store(lnl, a.partials);
}

template <typename T>
int segment(int mode, int states, int rate_cats, int tip_encoding,
            int scale_mode, int64_t sites, int r_tip, int r_imp, int r_loc,
            int r_exp, const int32_t* table, const int32_t* m_ops,
            const int32_t* tip_globals, const int32_t* imp_rows,
            const void* tips, const void* pmatrix, const void* src,
            const int32_t* src_scal, void* loc, int32_t* loc_scal,
            const int32_t* exp_table, void* exports, int32_t* export_scal,
            const int32_t* edge, const void* weight_vec,
            const void* pattern_weights, const void* inv_add,
            double* partials, void* stream) {
  if (rate_cats < 1 || rate_cats > kMaxRates) return (int)cudaErrorInvalidValue;
  DynArgs<T> a;
  a.mode = mode;
  a.rate_cats = rate_cats;
  a.tip_encoding = tip_encoding;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.r_tip = r_tip;
  a.r_imp = r_imp;
  a.r_loc = r_loc;
  a.r_exp = r_exp;
  a.table = table;
  a.m_ops = m_ops;
  a.tip_globals = tip_globals;
  a.imp_rows = imp_rows;
  a.tip_clv = tip_encoding == TIP_CLV ? static_cast<const T*>(tips) : nullptr;
  a.tip_words =
      tip_encoding == TIP_CLV ? nullptr : static_cast<const int32_t*>(tips);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.src = static_cast<const T*>(src);
  a.src_scal = src_scal;
  a.loc = static_cast<T*>(loc);
  a.loc_scal = loc_scal;
  a.exp_table = exp_table;
  a.exports = static_cast<T*>(exports);
  a.export_scal = export_scal;
  a.edge = edge;
  a.weight_vec = static_cast<const T*>(weight_vec);
  a.pattern_weights = static_cast<const T*>(pattern_weights);
  a.inv_add = static_cast<const T*>(inv_add);
  a.partials = partials;
  a.u = scale_units<T>();
  const unsigned blocks = (unsigned)((sites + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 4: dyn_kernel<T, 4><<<blocks, kThreads, 0, st>>>(a); break;
    case 20: dyn_kernel<T, 20><<<blocks, kThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: one segment's kernel on `stream`; returns
// cudaGetLastError() (0 on success).

#define SEGMENT_PARAMS                                                       \
  int mode, int states, int rate_cats, int tip_encoding, int scale_mode,    \
      int64_t sites, int r_tip, int r_imp, int r_loc, int r_exp,            \
      const int32_t *table, const int32_t *m_ops,                           \
      const int32_t *tip_globals, const int32_t *imp_rows,                  \
      const void *tips, const void *pmatrix, const void *src,               \
      const int32_t *src_scal, void *loc, int32_t *loc_scal,                \
      const int32_t *exp_table, void *exports, int32_t *export_scal,         \
      const int32_t *edge, const void *weight_vec,                          \
      const void *pattern_weights, const void *inv_add, double *partials,   \
      void *stream
#define SEGMENT_ARGS                                                         \
  mode, states, rate_cats, tip_encoding, scale_mode, sites, r_tip, r_imp,   \
      r_loc, r_exp, table, m_ops, tip_globals, imp_rows, tips, pmatrix,     \
      src, src_scal, loc, loc_scal, exp_table, exports, export_scal, edge,   \
      weight_vec, pattern_weights, inv_add, partials, stream

extern "C" int clv_dyn_segment_f32(SEGMENT_PARAMS) {
  return segment<float>(SEGMENT_ARGS);
}
extern "C" int clv_dyn_segment_f64(SEGMENT_PARAMS) {
  return segment<double>(SEGMENT_ARGS);
}
extern "C" const char* clv_dyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
