// K3/K4 for any alphabet (2 <= S <= 64) and any rate count, for Hopper
// (sm_90a), bound to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py
// builds this file; libpll_tpu_torch/ops/clv_seg.py wraps it beside the DNA
// and protein instances of clv_seg.cu, whose op descriptors it walks).
//
// Replaces, where clv_seg.cu's instances do not take the configuration,
// the Pallas TPU kernels of libpll_tpu/ops/clv_pallas_seg.py:
//   K3  make_segmented_sweep  (pallas_call at :386; any S and C, :339)
//   K4  make_segmented_score  (leaf segments, pallas_call at :600; the
//                              root segment, pallas_call at :555; any S
//                              and C, :440)
// that is K3/K4 at every (S, C) with S not in {4, 20} or C not in
// {1, 2, 4, 8}, and at any schedule whose pool does not fit those
// instances' shared memory (protein at eight rates in float64), with S and
// C read at run time.  One launch walks every segment of the schedule in
// order over all sites, as clv_seg.cu's header says: each op (its
// descriptor, clv_common.cuh's OpDesc, resolved once per schedule by
// clv_seg._SegKernel._plan_walk) makes its parent's row from two children
// (a tip of the segment's slab, an import an earlier segment wrote, or a
// pool slot) with clv_common.cuh's any_op, stores it in its pool slot and,
// where it has one, in its device row (K3: its inner row; K4: its export
// row); after the last segment K4 folds the edge log-likelihood
// (any_edge_term, per-rate counters through the reference's min/cap fold),
// one float64 partial per 32 sites.
//
// Design: a thread a site walks every segment (clv_any.cu's mapping): a
// site's C rates stay in one thread, so any C runs, and a thread reads
// only rows it wrote, the imports included, so the kernel has no barrier
// at all.  Every thread reads the same descriptor at once (a
// broadcast through L1).  The state loops run to a compile-time bound R
// (16 or 64, S masked); the P-matrices come padded to rows of SP = S
// rounded up to a 16-byte vector (clv_fused.pad_rows), read through
// L1/L2.  The schedule's pool (its largest segment's peak of live rows)
// keeps its first `shared` slots in shared memory ([slot, C*S, block]
// values, [slot, srows, block] counters, a column a thread: as many as
// fit two blocks an SM, clv_seg.any_shared_slots) and spills the rest to
// device scratch rows ([slot - shared, C*S, sites]).
//
// What bounds it: per op and site, 2*C*S*S multiply-adds; each tip read
// once from device memory, and K3 writes every row and counter once.  At
// GT16, 1 024 taxa x 32 768 sites x 4 rates, float32, both are bound by
// bytes: K3 moves 17.5 GB (8.6 GB of CLV tips in, its rows out: 5.2 ms at
// 3.35 TB/s), K4 reads the tips (2.6 ms, above its 1.37e11 flop, 2.05 ms
// at the FP32 peak).  PERF.md has its times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kSegFields = 4;  // op0, n_ops, n_tip, unused
constexpr int kAnyMaxStates = 64;
constexpr int kSites = 128;  // sites (threads) a block

template <typename T>
struct SegAnyArgs {
  int states;
  int sp;  // a padded P-matrix row
  int rate_cats;
  int scale_mode;
  int64_t sites;
  int seg0, seg1;             // the segments this launch walks
  int pool;                   // slots of the schedule's pool
  int shared;                 // of them in shared memory; the rest spill
  const int32_t* segs;        // [n_seg, kSegFields]
  const long long* tip_ptrs;  // [n_seg]: each segment's slab
                              // [n_tip, C*S, sites]
  const OpDesc* ops;          // [n_ops]
  const T* pmatrix;           // [M, C, S, sp], rows padded with zeros
  T* rows;                    // K3: the inner rows; K4: the exports
                              // [*, C*S, sites]
  int32_t* rows_scal;         // their counters [* x srows, sites]
  T* spill;                   // [pool - shared, C*S, sites]
  int32_t* spill_scal;        // [pool - shared, srows, sites]
  const int32_t* edge;        // K4: p, c, p_scal, c_scal descriptors, M;
                              // null: no edge
  const T* weight_vec;        // K4: [C*S]
  const T* pattern_weights;   // K4: [sites]
  double* partials;           // K4: one per 32 sites
  int64_t n_groups;           // K4: partials' length
  Scale<T> u;
};

template <typename T, int R>
__global__ void __launch_bounds__(kSites)
    seg_any_kernel(const __grid_constant__ SegAnyArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = a.states, sp = a.sp, C = a.rate_cats, cs = C * ns;
  const int nb = blockDim.x, t = threadIdx.x;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool counts = a.scale_mode != SCALE_NONE;
  const int srows = per_rate ? C : 1;
  T* const pool = reinterpret_cast<T*>(smem);
  int32_t* const spool =
      reinterpret_cast<int32_t*>(pool + (size_t)a.shared * cs * nb);
  const int64_t L = a.sites;
  const int64_t n = (int64_t)blockIdx.x * nb + t;
  const bool live = n < L;
  const int64_t mat = (int64_t)cs * sp;  // a padded [C, S, sp] matrix
  const int32_t zero = 0;  // a missing counter, at stride 0
  const T* slab = nullptr;

  // a pool slot's values and counters: shared memory, or a spill row
  auto slot_row = [&](int slot) -> RowAt<T> {
    if (slot < a.shared)
      return RowAt<T>{pool + (size_t)slot * cs * nb + t, nb};
    return RowAt<T>{a.spill + (int64_t)(slot - a.shared) * cs * L + n, L};
  };
  auto slot_scal = [&](int slot) -> RowAt<int32_t> {
    if (slot < a.shared)
      return RowAt<int32_t>{spool + (size_t)slot * srows * nb + t, nb};
    return RowAt<int32_t>{
        a.spill_scal + (int64_t)(slot - a.shared) * srows * L + n, L};
  };
  // a child's values by descriptor: a tip of the slab, an import, a slot
  auto row_of = [&](int d) -> RowAt<T> {
    const int kind = kind_of(d), v = index_of(d);
    if (kind == K_POOL) return slot_row(v);
    return RowAt<T>{(kind == K_TIP ? slab : a.rows) + (int64_t)v * cs * L + n,
                    L};
  };
  // a counter source by descriptor (K_ZERO: none)
  auto count_of = [&](int d) -> RowAt<int32_t> {
    if (d < 0) return RowAt<int32_t>{&zero, 0};
    if (kind_of(d) == K_POOL) return slot_scal(index_of(d));
    return RowAt<int32_t>{a.rows_scal + (int64_t)index_of(d) * srows * L + n,
                          L};
  };

  for (int si = a.seg0; si < a.seg1; ++si) {
    slab = reinterpret_cast<const T*>(__ldg(a.tip_ptrs + si));
    if (!live) continue;
    const int op0 = __ldg(a.segs + si * kSegFields);
    const int n_ops = __ldg(a.segs + si * kSegFields + 1);
    // (a final segment may have no ops: its edge reads imports)
    for (int i = op0; i < op0 + n_ops; ++i) {
      const OpDesc o = a.ops[i];
      const RowAt<T> out = slot_row(index_of(o.home));
      const RowAt<int32_t> so = slot_scal(index_of(o.home));
      any_op<T, R>(row_of(o.c[0]), row_of(o.c[1]), const_cast<T*>(out.p),
                   out.stride, a.pmatrix + (int64_t)o.m[0] * mat,
                   a.pmatrix + (int64_t)o.m[1] * mat, count_of(o.s[0]),
                   count_of(o.s[1]), const_cast<int32_t*>(so.p), so.stride,
                   counts, o.has != 0, per_rate, C, ns, sp, a.u);
      if (o.out >= 0) {
        T* dst = a.rows + (int64_t)o.out * cs * L + n;
        for (int k = 0; k < cs; ++k) dst[(int64_t)k * L] = out(0, k, ns);
        for (int r = 0; r < srows; ++r)
          a.rows_scal[((int64_t)o.out * srows + r) * L + n] =
              counts ? so(0, r, 1) : 0;
      }
    }
  }
  if (a.edge != nullptr) {
    // past-the-end sites add 0; every lane of a warp joins the shuffle
    double lnl = 0.0;
    if (live) {
      const RowAt<T> par = row_of(__ldg(a.edge + 0));
      const RowAt<T> ch = row_of(__ldg(a.edge + 1));
      int snum;
      const T term = any_edge_term<T, R>(
          AnyRow<T>{par.p, par.stride, 0u, false},
          AnyRow<T>{ch.p, ch.stride, 0u, false},
          a.pmatrix + (int64_t)__ldg(a.edge + 4) * mat, a.weight_vec,
          count_of(__ldg(a.edge + 2)), count_of(__ldg(a.edge + 3)), counts,
          per_rate, C, ns, sp, a.u.thresh, snum);
      lnl = (double)site_lnl<T>(term, snum, a.u,
                                __ldg(a.pattern_weights + n));
    }
    warp_sum_store(lnl, a.partials, (n - (t & 31)) / 32, a.n_groups);
  }
}

// The bound of the instance that takes `states`.
int any_bound(int states) { return states <= 16 ? 16 : kAnyMaxStates; }

template <typename T, int R>
int launch(const SegAnyArgs<T>& a, cudaStream_t st) {
  auto kernel = seg_any_kernel<T, R>;
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  const size_t smem = (size_t)a.shared * kSites *
                      ((size_t)a.rate_cats * a.states * sizeof(T) +
                       (size_t)srows * sizeof(int32_t));
  // above 48 KB only after raising the kernel's limit; a layout the card
  // cannot hold makes this call fail, and nothing is launched
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.sites + kSites - 1) / kSites);
  kernel<<<blocks, kSites, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int walk(int states, int sp, int rate_cats, int scale_mode, int64_t sites,
         int seg0, int seg1, int pool, int shared, const int32_t* segs,
         const long long* tip_ptrs, const void* ops, const void* pmatrix,
         void* rows, int32_t* rows_scal, void* spill, int32_t* spill_scal,
         const int32_t* edge, const void* weight_vec,
         const void* pattern_weights, double* partials, int64_t n_groups,
         void* stream) {
  if (states < 2 || states > kAnyMaxStates || rate_cats < 1 || sites < 1 ||
      sp < states || sp % Vec16<T>::n || sp > kAnyMaxStates || pool < 1 ||
      shared < 0 || shared > pool ||
      (shared < pool && (!spill || !spill_scal)) || seg0 < 0 ||
      seg1 <= seg0 || (edge != nullptr && (!partials || n_groups < 1)))
    return (int)cudaErrorInvalidValue;
  SegAnyArgs<T> a;
  a.states = states;
  a.sp = sp;
  a.rate_cats = rate_cats;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.seg0 = seg0;
  a.seg1 = seg1;
  a.pool = pool;
  a.shared = shared;
  a.segs = segs;
  a.tip_ptrs = tip_ptrs;
  a.ops = static_cast<const OpDesc*>(ops);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.rows = static_cast<T*>(rows);
  a.rows_scal = rows_scal;
  a.spill = static_cast<T*>(spill);
  a.spill_scal = spill_scal;
  a.edge = edge;
  a.weight_vec = static_cast<const T*>(weight_vec);
  a.pattern_weights = static_cast<const T*>(pattern_weights);
  a.partials = partials;
  a.n_groups = n_groups;
  a.u = scale_units<T>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return any_bound(states) == 16 ? launch<T, 16>(a, st)
                                 : launch<T, kAnyMaxStates>(a, st);
}

}  // namespace

// Plain C interface for ctypes: segments [seg0, seg1) of a schedule over
// all sites, one launch on `stream` of blocks of 128 sites, the pool's
// first `shared` slots in shared memory and the rest in `spill` /
// `spill_scal`, the edge folded after them when `edge` is not null
// (`partials`: `n_groups` float64 partials, one per 32 sites); `pmatrix` is
// [M, C, S, sp], each row padded with zeros to `sp` (a multiple of 16
// bytes, at most 64 values).  Returns cudaGetLastError() (0 on success).
#define WALK_PARAMS                                                          \
  int states, int sp, int rate_cats, int scale_mode, int64_t sites,         \
      int seg0, int seg1, int pool, int shared, const int32_t *segs,        \
      const long long *tip_ptrs, const void *ops, const void *pmatrix,      \
      void *rows, int32_t *rows_scal, void *spill, int32_t *spill_scal,     \
      const int32_t *edge, const void *weight_vec,                          \
      const void *pattern_weights, double *partials, int64_t n_groups,      \
      void *stream
#define WALK_ARGS                                                            \
  states, sp, rate_cats, scale_mode, sites, seg0, seg1, pool, shared, segs, \
      tip_ptrs, ops, pmatrix, rows, rows_scal, spill, spill_scal, edge,     \
      weight_vec, pattern_weights, partials, n_groups, stream

extern "C" int clv_seg_any_walk_f32(WALK_PARAMS) {
  return walk<float>(WALK_ARGS);
}
extern "C" int clv_seg_any_walk_f64(WALK_PARAMS) {
  return walk<double>(WALK_ARGS);
}
extern "C" const char* clv_seg_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
