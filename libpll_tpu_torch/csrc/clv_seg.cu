// Segmented large-tree kernels for Hopper (sm_90a): the segmented sweep
// (K3) and the segmented score (K4), bound to PyTorch through ctypes
// (libpll_tpu_torch/ops/_build.py builds this file;
// libpll_tpu_torch/ops/clv_seg.py wraps it).
//
// Replaces the Pallas TPU kernels of libpll_tpu/ops/clv_pallas_seg.py:
//   K3  make_segmented_sweep  (pallas_call at :386, body :281-320)
//   K4  make_segmented_score  (leaf segments, pallas_call at :600; the
//                              root segment, pallas_call at :555)
//
// What one launch computes: every segment of a tree cut into segments
// (ops/clv_seg.build_segmented_schedule), in order, over all sites.  The
// host resolves each op once per schedule into a descriptor
// (clv_common.cuh's OpDesc): the parent's pool slot and the device row it
// is also written to (K3: its inner row; K4: its export row, or none), and
// each child and counter as a tip of the segment's slab, an import (a
// device row an earlier segment wrote) or a pool slot.  Per site, for each
// op,
//   x[c,s] = (sum_d P[m1,c,s,d] child1[c,d]) * (sum_d P[m2,c,s,d] child2[c,d])
// with the parent's counter starting at the sum of its children's and the
// reference's per-site or per-rate scaling (clv_common.cuh).  K4 then folds
// the edge log-likelihood after the last segment,
//   lnl = (log(sum_k parent[k] (P[edge] child)[k] wvec[k])
//          + counters * log(2^-shift)) * pattern_weight,
// per-rate counters through the reference's min/cap fold; one float64
// partial per 32 sites (no +I, as on the TPU).
//
// Design on this card, and what was decided:
//  * One launch per call.  Segments depend on each other only site by
//    site: segment i imports rows earlier segments computed at the same
//    sites.  So a block owns a tile of 32 sites and walks every segment of
//    the schedule in order over it (the loop inside the block that stands
//    for the TPU's sequential grid of pallas_calls).  Imports are read
//    where this block wrote them (K3: its inner rows; K4: the exports),
//    each value by the thread that wrote it (the site's counter: warp 0's
//    lane), and a block barrier lies between two segments.  The host's
//    work per call no longer grows with the segment count.
//  * A block is 32 sites by C rates, one thread per (site, rate), warp c
//    rate c (clv_dyn.cu's mapping: every P-matrix row a warp reads is one
//    address).  A segment's live local rows sit in a shared-memory pool
//    [slot, S, 32*C] planned on the host (clv_seg.segment_slots, first fit
//    in op order, the dyn kernels' planner); the pool holds the schedule's
//    peak (4 slots at the README cut), so nothing spills.  Per-site
//    scaling votes across the C warps with one barrier per scaled op; each
//    chunk of ops' descriptors and (DNA) P-matrices is staged in shared
//    memory.  At the README cut a block takes 18 KB of shared memory and
//    64 registers a thread: eight blocks share an SM, and all 1 024 blocks
//    of 32 768 sites are resident at once on 132 SMs.
//  * Tips are read from the segment's slab where an op needs them, a
//    warp reading 32 consecutive sites of one value; while an op runs, its
//    successor's tip and import rows are prefetched into L1.  The next
//    segment's tip tile copied into shared memory behind the ops (cp.async
//    into the second of two buffers, completion on an mbarrier) was
//    measured and dropped: its 49 KB of buffers a block let only three
//    blocks share an SM, the grid ran in three waves and K4 took 1.6x as
//    long (PERF.md).
//  * The arithmetic of every value is the first port's (dot in K1's
//    order, products, scaling by exact powers of two): K3's rows and
//    counters are the same bits.  Partials are summed per 32 sites in a
//    warp's shuffle tree and the wrapper adds four into each 128-site
//    partial in order, as the first port's block sum did: K4's logL is the
//    same bits.
//  * The template is over the dtype and S in {4, 20} (4 instances); the
//    rate count, scale mode and whether there is an edge are runtime
//    values.
//
// What bounds it: per op and site, 2*C*S*S multiply-adds; each tip read
// once from device memory, and K3 writes every row and counter once.  At
// 1 024 taxa x 32 768 sites (DNA, four rates, float32) the tips are
// 2.15 GB (0.64 ms at 3.35 TB/s) and K3's rows and counters 2.28 GB: both
// kernels are bound by bytes.  They stay above that bound, held by the
// latency of each op's tip loads (a block's warps meet at every op's
// vote), with the 32 resident warps of an SM too few to cover it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kSegFields = 4;  // op0, n_ops, n_tip, unused
// Each op's children that are not pool rows (tips, imports) are
// prefetched into L1 while the op before it runs.
constexpr bool kPrefetchL1 = true;

template <typename T>
struct SegArgs {
  int rate_cats;
  int scale_mode;
  int64_t sites;
  int seg0, seg1;            // the segments this launch walks
  int pool;                  // slots
  const int32_t* segs;       // [n_seg, kSegFields]
  const long long* tip_ptrs; // [n_seg]: each segment's slab [n_tip, C*S, sites]
  const OpDesc* ops;         // [n_ops]
  const T* pmatrix;          // [M, C, S, S]
  T* rows;                   // K3: the inner rows; K4: the exports
                             // [*, C*S, sites]
  int32_t* rows_scal;        // their counters [* x srows, sites]
  const int32_t* edge;       // K4: p, c, p_scal, c_scal descriptors, M;
                             // null: no edge
  const T* weight_vec;       // K4: [C*S]
  const T* pattern_weights;  // K4: [sites]
  double* partials;          // K4: [n_tiles]
  Scale<T> u;
};

// ------------------------------------------------------------ the walk
// The thread's S values of a row named by a descriptor: a tip of the
// segment's slab, an import in device memory (plain loads: this launch
// wrote it) or a pool slot.
template <typename T, int S>
__device__ __forceinline__ void load_row(const SegArgs<T>& a,
                                         const Pool<T>& pl, const Lane& ln,
                                         const T* slab, int d, T (&x)[S]) {
  const int kind = kind_of(d);
  const int v = index_of(d);
  if (kind == K_POOL) {
#pragma unroll
    for (int e = 0; e < S; ++e) x[e] = pl.clv[pool_at<S>(v, pl.nt) + e * pl.nt];
    return;
  }
  const T* p = (kind == K_TIP ? slab : a.rows) +
               ((int64_t)v * a.rate_cats + ln.c) * S * a.sites + ln.site;
#pragma unroll
  for (int e = 0; e < S; ++e) x[e] = p[e * a.sites];
}

// Prefetch into L1 the thread's values of op o's children that no op of
// this segment writes (tips, imports).
template <typename T, int S>
__device__ __forceinline__ void prefetch_children(const SegArgs<T>& a,
                                                  const Lane& ln,
                                                  const T* slab,
                                                  const OpDesc& o) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int kind = kind_of(o.c[k]);
    if (kind == K_POOL) continue;
    const T* p = (kind == K_TIP ? slab : a.rows) +
                 ((int64_t)index_of(o.c[k]) * a.rate_cats + ln.c) * S *
                     a.sites +
                 ln.site;
#pragma unroll
    for (int e = 0; e < S; ++e)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(p + e * a.sites));
  }
}

// The thread's counter from a descriptor (K_ZERO: 0).
template <typename T>
__device__ __forceinline__ int load_count(const SegArgs<T>& a,
                                          const Pool<T>& pl, const Lane& ln,
                                          int d) {
  if (d < 0) return 0;
  const int v = index_of(d);
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  if (kind_of(d) == K_POOL) return pl.scal[scal_at(per_rate, v, ln, pl.sstride)];
  const int64_t row = per_rate ? (int64_t)v * a.rate_cats + ln.c : v;
  return a.rows_scal[row * a.sites + ln.site];
}

// Store an op's values and counter in its pool slot and, when it has one,
// in its device row.
template <typename T, int S>
__device__ __forceinline__ void store_row(const SegArgs<T>& a,
                                          const Pool<T>& pl, const Lane& ln,
                                          const OpDesc& o, const T (&t)[S],
                                          int cnt) {
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int slot = index_of(o.home);
#pragma unroll
  for (int e = 0; e < S; ++e) pl.clv[pool_at<S>(slot, pl.nt) + e * pl.nt] = t[e];
  if (per_rate || ln.c == 0)
    pl.scal[scal_at(per_rate, slot, ln, pl.sstride)] = cnt;
  if (o.out < 0 || !ln.live) return;
  T* out = a.rows + ((int64_t)o.out * a.rate_cats + ln.c) * S * a.sites +
           ln.site;
#pragma unroll
  for (int e = 0; e < S; ++e) out[e * a.sites] = t[e];
  if (per_rate)
    a.rows_scal[((int64_t)o.out * a.rate_cats + ln.c) * a.sites + ln.site] =
        cnt;
  else if (ln.c == 0)
    a.rows_scal[(int64_t)o.out * a.sites + ln.site] = cnt;
}

// K4: the weighted log-likelihood of the thread's site across the
// evaluation edge (the same value in every thread of the site).
template <typename T, int S>
__device__ T edge_site_lnl(const SegArgs<T>& a, const Pool<T>& pl,
                           const Lane& ln, const T* slab,
                           T* term_s, int* sn_s) {
  const int C = a.rate_cats;
  T pv[S], x[S];
  load_row<T, S>(a, pl, ln, slab, __ldg(a.edge + 0), pv);
  load_row<T, S>(a, pl, ln, slab, __ldg(a.edge + 1), x);
  const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * C * S * S;
  term_s[threadIdx.x] = edge_rate_term<T, S>(pe, ln.c, pv, x, a.weight_vec);
  sn_s[threadIdx.x] = load_count(a, pl, ln, __ldg(a.edge + 2)) +
                      load_count(a, pl, ln, __ldg(a.edge + 3));
  __syncthreads();
  int snum;
  const T term = site_term<T>(term_s, sn_s, C, ln,
                              a.scale_mode == SCALE_PER_RATE, a.u.thresh,
                              snum);
  return site_lnl<T>(term, snum, a.u, __ldg(a.pattern_weights + ln.site));
}

// Dynamic shared memory, in this order: the staged P-matrices (DNA), the
// pool's values and counters, the edge's exchange [C*32] terms and
// counters.
template <typename T, int S>
size_t smem_bytes(const SegArgs<T>& a) {
  const size_t nt = (size_t)kTileSites * a.rate_cats;
  const size_t counters = a.scale_mode == SCALE_PER_RATE ? nt : kTileSites;
  return (kStagePm<S> ? (size_t)kChunk * 2 * a.rate_cats * S * S * sizeof(T)
                      : 0) +
         (size_t)a.pool * (S * nt * sizeof(T) + counters * sizeof(int32_t)) +
         nt * (sizeof(T) + sizeof(int32_t));
}

// Every thread runs every op, past-the-end sites included (their loads
// clamped or zero, their device stores skipped): the votes need whole
// warps.  The arguments stay in the parameter space (__grid_constant__):
// the helpers take them by reference, which otherwise makes nvcc copy
// them to the stack (K4 3% slower at the README cut; PERF.md).
template <typename T, int S>
__global__ void __launch_bounds__(kTileSites * kMaxRates)
    seg_kernel(const __grid_constant__ SegArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ OpDesc ops[kChunk];
  __shared__ unsigned votes[2][kMaxRates];
  const int C = a.rate_cats;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool counts = per_rate || threadIdx.x < kTileSites;  // warp-uniform
  const int64_t pm_size = (int64_t)C * S * S;
  Lane ln;
  ln.c = threadIdx.x / kTileSites;
  ln.sl = threadIdx.x % kTileSites;
  const int64_t tile0 = (int64_t)blockIdx.x * kTileSites;
  ln.live = tile0 + ln.sl < a.sites;
  ln.site = ln.live ? tile0 + ln.sl : a.sites - 1;

  T* const dyn = reinterpret_cast<T*>(smem);
  Pool<T> pl;
  pl.nt = kTileSites * C;
  pl.sstride = per_rate ? pl.nt : kTileSites;
  pl.pm = kStagePm<S> ? dyn : nullptr;
  pl.clv = dyn + (kStagePm<S> ? kChunk * 2 * pm_size : 0);
  pl.scal = reinterpret_cast<int32_t*>(pl.clv + a.pool * S * pl.nt);
  T* const term_s = reinterpret_cast<T*>(pl.scal + a.pool * pl.sstride);
  int* const sn_s = reinterpret_cast<int*>(term_s + pl.nt);

  const T* slab = nullptr;
  int vb = 0;  // the votes buffer
  for (int si = a.seg0; si < a.seg1; ++si) {
    slab = reinterpret_cast<const T*>(__ldg(a.tip_ptrs + si));
    const int op0 = __ldg(a.segs + si * kSegFields);
    const int n_ops = __ldg(a.segs + si * kSegFields + 1);
    // the previous segment is done with what is staged, and what it wrote
    // is visible to the whole block
    __syncthreads();
    // (a final segment may have no ops: its edge reads imports)
    for (int base = 0; base < n_ops; base += kChunk) {
      const int n = min(kChunk, n_ops - base);
      if (base > 0) __syncthreads();  // the previous chunk is done
      if ((int)threadIdx.x < n) ops[threadIdx.x] = a.ops[op0 + base + threadIdx.x];
      __syncthreads();
      if (kPrefetchL1) prefetch_children<T, S>(a, ln, slab, ops[0]);
      if (pl.pm != nullptr) stage_pmatrices<T, S>(a.pmatrix, C, ops, n, pl.pm);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const OpDesc o = ops[j];
        int cnt = counts ? load_count(a, pl, ln, o.s[0]) +
                               load_count(a, pl, ln, o.s[1])
                         : 0;
        T x1[S], x2[S], t[S];
        load_row<T, S>(a, pl, ln, slab, o.c[0], x1);
        load_row<T, S>(a, pl, ln, slab, o.c[1], x2);
        if (kPrefetchL1 && j + 1 < n)
          prefetch_children<T, S>(a, ln, slab, ops[j + 1]);
        if (pl.pm != nullptr) {
          const T* p = pl.pm + (2 * j * C + ln.c) * S * S;
          contract<T, S, true>(p, p + C * S * S, x1, x2, t);
        } else {
          contract<T, S, false>(a.pmatrix + o.m[0] * pm_size + ln.c * S * S,
                                a.pmatrix + o.m[1] * pm_size + ln.c * S * S,
                                x1, x2, t);
        }
        const bool has = o.has != 0;
        if (per_rate) {
          cnt += scale_rate<T, S>(has, t, a.u);
        } else if (a.scale_mode == SCALE_PER_SITE && has &&
                   site_vote<T, S>(t, a.u, C, ln, votes, vb)) {
#pragma unroll
          for (int s = 0; s < S; ++s) t[s] *= a.u.factor;
          cnt += 1;
        }
        store_row<T, S>(a, pl, ln, o, t, cnt);
      }
    }
  }
  if (a.edge != nullptr) {
    // the last ops' pool rows and counters (warp 0's) are read by every
    // warp; past-the-end sites add 0
    __syncthreads();
    const double lnl =
        (double)edge_site_lnl<T, S>(a, pl, ln, slab, term_s, sn_s);
    tile_sum_store(ln.live ? lnl : 0.0, a.partials);
  }
}

template <typename T, int S>
int launch(const SegArgs<T>& a, cudaStream_t st) {
  const size_t smem = smem_bytes<T, S>(a);
  // above 48 KB only after raising the kernel's limit; a layout the card
  // cannot hold makes this call fail, and nothing is launched
  cudaError_t err = cudaFuncSetAttribute(
      seg_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(seg_kernel<T, S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.sites + kTileSites - 1) / kTileSites);
  seg_kernel<T, S><<<blocks, kTileSites * a.rate_cats, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int max_dynamic_smem() {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, seg_kernel<T, S>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

template <typename T, int S>
int blocks_per_sm(int rate_cats, size_t smem) {
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      seg_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(seg_kernel<T, S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, seg_kernel<T, S>, kTileSites * rate_cats, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int walk(int states, int rate_cats, int scale_mode, int64_t sites, int seg0,
         int seg1, int pool, const int32_t* segs, const long long* tip_ptrs,
         const void* ops, const void* pmatrix, void* rows,
         int32_t* rows_scal, const int32_t* edge,
         const void* weight_vec, const void* pattern_weights,
         double* partials, void* stream) {
  // the lanes of a site share a warp: C must divide 32
  if (rate_cats < 1 || rate_cats > kMaxRates || (32 % rate_cats) != 0 ||
      pool < 1 || seg0 < 0 || seg1 <= seg0 || sites < 1)
    return (int)cudaErrorInvalidValue;
  SegArgs<T> a;
  a.rate_cats = rate_cats;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.seg0 = seg0;
  a.seg1 = seg1;
  a.pool = pool;
  a.segs = segs;
  a.tip_ptrs = tip_ptrs;
  a.ops = static_cast<const OpDesc*>(ops);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.rows = static_cast<T*>(rows);
  a.rows_scal = rows_scal;
  a.edge = edge;
  a.weight_vec = static_cast<const T*>(weight_vec);
  a.pattern_weights = static_cast<const T*>(pattern_weights);
  a.partials = partials;
  a.u = scale_units<T>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 4: return launch<T, 4>(a, st);
    case 20: return launch<T, 20>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes: segments [seg0, seg1) of a schedule over
// all sites, one launch on `stream`, the edge folded after them when
// `edge` is not null; returns cudaGetLastError() (0 on success).

#define WALK_PARAMS                                                          \
  int states, int rate_cats, int scale_mode, int64_t sites, int seg0,       \
      int seg1, int pool, const int32_t *segs, const long long *tip_ptrs,   \
      const void *ops, const void *pmatrix, void *rows, int32_t *rows_scal, \
      const int32_t *edge, const void *weight_vec,                          \
      const void *pattern_weights, double *partials, void *stream
#define WALK_ARGS                                                            \
  states, rate_cats, scale_mode, sites, seg0, seg1, pool, segs, tip_ptrs,   \
      ops, pmatrix, rows, rows_scal, edge, weight_vec, pattern_weights,     \
      partials, stream

extern "C" int clv_seg_walk_f32(WALK_PARAMS) { return walk<float>(WALK_ARGS); }
extern "C" int clv_seg_walk_f64(WALK_PARAMS) {
  return walk<double>(WALK_ARGS);
}

// The largest dynamic shared memory, in bytes, one block of the instance
// (states, float64 or not) may ask for on the current device; a negative
// CUDA error code on failure.
extern "C" int clv_seg_max_smem(int states, int f64) {
  if (states == 4) return f64 ? max_dynamic_smem<double, 4>()
                              : max_dynamic_smem<float, 4>();
  if (states == 20) return f64 ? max_dynamic_smem<double, 20>()
                               : max_dynamic_smem<float, 20>();
  return -(int)cudaErrorInvalidValue;
}

// How many blocks of the instance fit one SM at `rate_cats` rates and
// `smem` bytes of dynamic shared memory; a negative CUDA error code on
// failure.
extern "C" int clv_seg_blocks_per_sm(int states, int f64, int rate_cats,
                                     int smem) {
  if (states == 4) return f64 ? blocks_per_sm<double, 4>(rate_cats, smem)
                              : blocks_per_sm<float, 4>(rate_cats, smem);
  if (states == 20) return f64 ? blocks_per_sm<double, 20>(rate_cats, smem)
                               : blocks_per_sm<float, 20>(rate_cats, smem);
  return -(int)cudaErrorInvalidValue;
}

extern "C" const char* clv_seg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
