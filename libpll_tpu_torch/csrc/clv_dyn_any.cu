// K5/K6 for any alphabet (2 <= S <= 64) and any rate count, for Hopper
// (sm_90a), bound to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py
// builds this file; libpll_tpu_torch/ops/clv_dyn.py wraps it beside the DNA
// and protein instances of clv_dyn.cu, whose tables and slot plan it
// reads).
//
// Replaces, where clv_dyn.cu's instances do not take the configuration,
// the Pallas TPU kernels of libpll_tpu/ops/clv_pallas_dyn.py:
//   K5  make_dyn_sweep   (pallas_call at :521; any S and C, :416)
//   K6  make_dyn_score   (leaf segments, pallas_call at :928; the root
//                         segment, pallas_call at :990; any S and C, :723)
// that is K5/K6 at every (S, C) with S not in {4, 20} or C not in
// {1, 2, 4, 8}, with S and C read at run time.  One launch runs one
// segment of the schedule (clv_dyn.build_dyn_schedule), as clv_dyn.cu's
// header says: per site, each op of the segment's table makes its
// parent's row from its two children (clv_common.cuh's any_op: the dots
// in K1's order, the products, the per-site or per-rate vote, the
// counters); then by mode the sweep (K5) has written every local row to
// its inner row, a leaf segment (K6) copies the rows later segments import
// to its export rows, and the root segment (K6) folds the edge
// log-likelihood (any_edge_term: per-rate counters through the
// reference's min/cap fold, +I's inv_add), one float64 partial per 32
// sites in a warp's shuffle tree (the wrapper adds four into each 128-site
// partial).
//
// Design: a thread a site runs every op of the segment (clv_any.cu's
// mapping): a site's C rates stay in one thread, so any C runs
// (clv_dyn.cu's thread per (site, rate) needs C to divide 32), a site's
// vote needs no barrier, and a thread reads only rows it wrote, so the
// kernel has no barrier at all.  Every thread reads the same table
// entry at once (a broadcast through L1).  The state loops run to a
// compile-time bound R (16 or 64, S masked; at R = 64 a row's loop stays
// a loop, as in clv_any.cu, or nvcc takes minutes), so a rate's child
// values stay in registers; the P-matrices come padded to rows of SP = S
// rounded up to a 16-byte vector (clv_fused.pad_rows) and are read as
// vectors through L1/L2: at 61 states one rate's matrix is 15.6 KB, too
// large to stage.  The live local rows go where the host's slot plan
// (clv_dyn.dyn_slot_plan) puts them: slots below `pool` in a shared-memory
// pool ([slot, C*S, block] values, [slot, srows, block] counters, a
// column a thread), which clv_dyn.any_pool_cap sizes to two blocks an SM;
// every other row spills to device memory (K6's scratch row slot - pool,
// K5's own output row).  Pattern tips are decoded bit by bit from the
// tree's packed tip words (chars: a nibble; masks: up to 31 states).
//
// What bounds it: operations, 2 C S^2 multiply-adds per op and site (at
// GT16, 10 240 taxa x 65 536 sites x 4 rates, float32: 2.75e12 flop,
// 41.1 ms at the FP32 peak) for K6; K5 writes every row and counter
// (9.1 GB at 4 096 x 8 192 GT16, 2.73 ms at 3.35 TB/s).  PERF.md has its
// times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kFields = 6;  // parent, c1, c2, s1, s2, has_scaler
constexpr int kAnyMaxStates = 64;
constexpr int kSites = 128;  // sites (threads) a block

enum { MODE_SWEEP = 0, MODE_LEAF = 1, MODE_ROOT = 2 };

template <typename T>
struct DynAnyArgs {
  int mode;
  int states;
  int sp;  // a padded P-matrix row
  int rate_cats;
  int tip_encoding;
  int scale_mode;
  int64_t sites;
  int r_tip, r_imp, r_loc, r_exp;
  int pool;                    // slots in shared memory
  const int32_t* table;        // [r_loc, kFields]
  const int32_t* m_ops;        // [r_loc, 2]
  const int32_t* tip_globals;  // [r_tip]
  const int32_t* imp_rows;     // [r_imp]
  const int32_t* slots;        // [r_loc]
  const T* tip_clv;            // [tips, C*S, sites]             ("clv")
  const int32_t* tip_words;    // [ceil(tips/8) or tips, sites]
  const T* pmatrix;            // [M, C, S, sp], rows padded with zeros
  const T* src;                // import rows [*, C*S, sites]
  const int32_t* src_scal;     // their counters [* x srows, sites]
  T* loc;                      // sweep: the segment's inner rows; else the
                               // spill scratch, row slot - pool
  int32_t* loc_scal;           // their counters [* x srows, sites]
  const int32_t* exp_table;    // leaf: [r_exp, 2] (state row, scaler row)
  T* exports;                  // leaf: [r_exp, C*S, sites]
  int32_t* export_scal;        // leaf: [r_exp x srows, sites]
  const int32_t* edge;         // root: p_state, c_state, p_scal, c_scal, M
  const T* weight_vec;         // root: [C*S]
  const T* pattern_weights;    // root: [sites]
  const T* inv_add;            // root: [sites], or null without +I
  double* partials;            // root: one per 32 sites
  int64_t n_groups;            // root: partials' length
  Scale<T> u;
};

template <typename T, int R>
__global__ void __launch_bounds__(kSites)
    dyn_any_kernel(const __grid_constant__ DynAnyArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = a.states, sp = a.sp, C = a.rate_cats, cs = C * ns;
  const int nb = blockDim.x, t = threadIdx.x;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool counts = a.scale_mode != SCALE_NONE;
  const bool sweep = a.mode == MODE_SWEEP;
  const int srows = per_rate ? C : 1;
  const int loc0 = a.r_tip + a.r_imp, trash = loc0 + a.r_loc;
  T* const pool = reinterpret_cast<T*>(smem);
  int32_t* const spool =
      reinterpret_cast<int32_t*>(pool + (size_t)a.pool * cs * nb);
  const int64_t L = a.sites;
  const int64_t n = (int64_t)blockIdx.x * nb + t;
  const bool live = n < L;
  const int64_t mat = (int64_t)cs * sp;  // a padded [C, S, sp] matrix
  const bool code_tips = a.tip_encoding != TIP_CLV;
  const int32_t zero = 0;  // a missing counter, at stride 0

  // local row l's values and counters: a pool slot, or a device row
  auto home = [&](int l) -> RowAt<T> {
    const int slot = __ldg(a.slots + l);
    if (slot < a.pool) return RowAt<T>{pool + (size_t)slot * cs * nb + t, nb};
    const int64_t row = sweep ? l : slot - a.pool;
    return RowAt<T>{a.loc + row * cs * L + n, L};
  };
  auto home_scal = [&](int l) -> RowAt<int32_t> {
    const int slot = __ldg(a.slots + l);
    if (slot < a.pool)
      return RowAt<int32_t>{spool + (size_t)slot * srows * nb + t, nb};
    const int64_t row = sweep ? l : slot - a.pool;
    return RowAt<int32_t>{a.loc_scal + row * srows * L + n, L};
  };
  // a state row that holds values (an import, a local or a CLV tip)
  auto values = [&](int r) -> RowAt<T> {
    if (r < a.r_tip)
      return RowAt<T>{
          a.tip_clv + (int64_t)__ldg(a.tip_globals + r) * cs * L + n, L};
    if (r < loc0)
      return RowAt<T>{
          a.src + (int64_t)__ldg(a.imp_rows + r - a.r_tip) * cs * L + n, L};
    return home(r - loc0);
  };
  // a pattern tip's code (tip row r < r_tip)
  auto code = [&](int r) -> CodeAt<T> {
    const int64_t g = __ldg(a.tip_globals + r);
    if (a.tip_encoding == TIP_CHARS)
      return CodeAt<T>{
          ((uint32_t)__ldg(a.tip_words + (g >> 3) * L + n) >> (4 * (g & 7))) &
          0xFu};
    return CodeAt<T>{(uint32_t)__ldg(a.tip_words + g * L + n)};
  };
  // any state row as a run-time variant (exports, the edge)
  auto any_row = [&](int r) -> AnyRow<T> {
    if (r >= trash) return AnyRow<T>{nullptr, 0, 0u, true};
    if (code_tips && r < a.r_tip) return AnyRow<T>{nullptr, 0, code(r).code,
                                                   true};
    const RowAt<T> v = values(r);
    return AnyRow<T>{v.p, v.stride, 0u, false};
  };
  // a scaler row: an import's, a local's, or the zero dummy / trash row
  auto counters = [&](int sr) -> RowAt<int32_t> {
    if (sr < a.r_imp)
      return RowAt<int32_t>{
          a.src_scal + (int64_t)__ldg(a.imp_rows + sr) * srows * L + n, L};
    if (sr < a.r_imp + a.r_loc) return home_scal(sr - a.r_imp);
    return RowAt<int32_t>{&zero, 0};
  };

  if (live) {
    for (int i = 0; i < a.r_loc; ++i) {
      const int32_t* op = a.table + i * kFields;
      const int p = __ldg(op);
      if (p >= trash) continue;  // a pad op
      const int l = p - loc0;
      const int r1 = __ldg(op + 1), r2 = __ldg(op + 2);
      const RowAt<T> out = home(l);
      const RowAt<int32_t> so = home_scal(l);
      const T* p1 = a.pmatrix + (int64_t)__ldg(a.m_ops + 2 * i) * mat;
      const T* p2 = a.pmatrix + (int64_t)__ldg(a.m_ops + 2 * i + 1) * mat;
      const RowAt<int32_t> sc1 = counters(__ldg(op + 3));
      const RowAt<int32_t> sc2 = counters(__ldg(op + 4));
      const bool may = __ldg(op + 5) != 0;
      auto run = [&](const auto& x1, const auto& x2) {
        any_op<T, R>(x1, x2, const_cast<T*>(out.p), out.stride, p1, p2, sc1,
                     sc2, const_cast<int32_t*>(so.p), so.stride, counts, may,
                     per_rate, C, ns, sp, a.u);
      };
      const bool code1 = code_tips && r1 < a.r_tip;
      const bool code2 = code_tips && r2 < a.r_tip;
      if (code1 && code2)
        run(code(r1), code(r2));
      else if (code1)
        run(code(r1), values(r2));
      else if (code2)
        run(values(r1), code(r2));
      else
        run(values(r1), values(r2));
      if (sweep) {  // K5's output row (a spilled row lives there already)
        T* dst = a.loc + (int64_t)l * cs * L + n;
        int32_t* dsc = a.loc_scal + (int64_t)l * srows * L + n;
        if (out.p != dst)
          for (int k = 0; k < cs; ++k) dst[(int64_t)k * L] = out(0, k, ns);
        for (int r = 0; r < srows; ++r)
          dsc[(int64_t)r * L] = counts ? so(0, r, 1) : 0;
      }
    }
    if (a.mode == MODE_LEAF) {
      for (int e = 0; e < a.r_exp; ++e) {
        const int st = __ldg(a.exp_table + 2 * e);
        if (st >= trash) continue;  // a pad entry
        const AnyRow<T> x = any_row(st);
        const RowAt<int32_t> sc = counters(__ldg(a.exp_table + 2 * e + 1));
        T* dst = a.exports + (int64_t)e * cs * L + n;
        for (int k = 0; k < cs; ++k) dst[(int64_t)k * L] = x(0, k, ns);
        for (int r = 0; r < srows; ++r)
          a.export_scal[((int64_t)e * srows + r) * L + n] =
              counts ? sc(0, r, 1) : 0;
      }
    }
  }
  if (a.mode == MODE_ROOT) {
    // past-the-end sites add 0; every lane of a warp joins the shuffle
    double lnl = 0.0;
    if (live) {
      int snum;
      T term = any_edge_term<T, R>(
          any_row(__ldg(a.edge + 0)), any_row(__ldg(a.edge + 1)),
          a.pmatrix + (int64_t)__ldg(a.edge + 4) * mat, a.weight_vec,
          counters(__ldg(a.edge + 2)), counters(__ldg(a.edge + 3)), counts,
          per_rate, C, ns, sp, a.u.thresh, snum);
      if (a.inv_add != nullptr) term += __ldg(a.inv_add + n);
      lnl = (double)site_lnl<T>(term, snum, a.u,
                                __ldg(a.pattern_weights + n));
    }
    warp_sum_store(lnl, a.partials, (n - (t & 31)) / 32, a.n_groups);
  }
}

// The bound of the instance that takes `states`.
int any_bound(int states) { return states <= 16 ? 16 : kAnyMaxStates; }

template <typename T, int R>
int launch(const DynAnyArgs<T>& a, cudaStream_t st) {
  auto kernel = dyn_any_kernel<T, R>;
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  const size_t smem = (size_t)a.pool * kSites *
                      ((size_t)a.rate_cats * a.states * sizeof(T) +
                       (size_t)srows * sizeof(int32_t));
  // above 48 KB only after raising the kernel's limit; a pool the card
  // cannot hold makes this call fail, and nothing is launched
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.sites + kSites - 1) / kSites);
  kernel<<<blocks, kSites, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int segment(int mode, int states, int sp, int rate_cats, int tip_encoding,
            int scale_mode, int64_t sites, int r_tip, int r_imp, int r_loc,
            int r_exp, int pool, const int32_t* table, const int32_t* m_ops,
            const int32_t* tip_globals, const int32_t* imp_rows,
            const int32_t* slots, const void* tips, const void* pmatrix,
            const void* src, const int32_t* src_scal, void* loc,
            int32_t* loc_scal, const int32_t* exp_table, void* exports,
            int32_t* export_scal, const int32_t* edge,
            const void* weight_vec, const void* pattern_weights,
            const void* inv_add, double* partials, int64_t n_groups,
            void* stream) {
  if (states < 2 || states > kAnyMaxStates || rate_cats < 1 || sites < 1 ||
      sp < states || sp % Vec16<T>::n || sp > kAnyMaxStates || pool < 0 ||
      (tip_encoding == TIP_CHARS && states > 4) ||
      (tip_encoding == TIP_MASKS && states > 31) ||
      mode < MODE_SWEEP || mode > MODE_ROOT ||
      (mode == MODE_ROOT && (!edge || !partials || n_groups < 1)) ||
      (mode == MODE_LEAF && (!exp_table || !exports || !export_scal)))
    return (int)cudaErrorInvalidValue;
  DynAnyArgs<T> a;
  a.mode = mode;
  a.states = states;
  a.sp = sp;
  a.rate_cats = rate_cats;
  a.tip_encoding = tip_encoding;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.r_tip = r_tip;
  a.r_imp = r_imp;
  a.r_loc = r_loc;
  a.r_exp = r_exp;
  a.pool = pool;
  a.table = table;
  a.m_ops = m_ops;
  a.tip_globals = tip_globals;
  a.imp_rows = imp_rows;
  a.slots = slots;
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
  a.n_groups = n_groups;
  a.u = scale_units<T>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return any_bound(states) == 16 ? launch<T, 16>(a, st)
                                 : launch<T, kAnyMaxStates>(a, st);
}

}  // namespace

// Plain C interface for ctypes: one segment's launch on `stream`, with
// clv_dyn.py's pool of `pool` shared slots a block of 128 sites and
// `pmatrix` [M, C, S, sp], each row padded with zeros to `sp` (a multiple
// of 16 bytes, at most 64 values); `partials` holds `n_groups` float64
// partials, one per 32 sites.  Returns cudaGetLastError() (0 on success).
#define SEGMENT_PARAMS                                                       \
  int mode, int states, int sp, int rate_cats, int tip_encoding,            \
      int scale_mode, int64_t sites, int r_tip, int r_imp, int r_loc,       \
      int r_exp, int pool, const int32_t *table, const int32_t *m_ops,      \
      const int32_t *tip_globals, const int32_t *imp_rows,                  \
      const int32_t *slots, const void *tips, const void *pmatrix,          \
      const void *src, const int32_t *src_scal, void *loc,                  \
      int32_t *loc_scal, const int32_t *exp_table, void *exports,           \
      int32_t *export_scal, const int32_t *edge, const void *weight_vec,    \
      const void *pattern_weights, const void *inv_add, double *partials,   \
      int64_t n_groups, void *stream
#define SEGMENT_ARGS                                                         \
  mode, states, sp, rate_cats, tip_encoding, scale_mode, sites, r_tip,      \
      r_imp, r_loc, r_exp, pool, table, m_ops, tip_globals, imp_rows,       \
      slots, tips, pmatrix, src, src_scal, loc, loc_scal, exp_table,        \
      exports, export_scal, edge, weight_vec, pattern_weights, inv_add,     \
      partials, n_groups, stream

extern "C" int clv_dyn_any_segment_f32(SEGMENT_PARAMS) {
  return segment<float>(SEGMENT_ARGS);
}
extern "C" int clv_dyn_any_segment_f64(SEGMENT_PARAMS) {
  return segment<double>(SEGMENT_ARGS);
}
extern "C" const char* clv_dyn_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
