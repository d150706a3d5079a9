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
// What one launch computes: one segment of a tree cut into segments
// (ops/clv_seg.build_segmented_schedule), over all sites.  The segment's
// op table (parent, child1, child2, scaler1, scaler2, has_scaler) numbers
// its state rows tips | imports | locals and its scaler rows imports |
// locals | the zero dummy, without padding.  Per site, for each op,
//   x[c,s] = (sum_d P[m1,c,s,d] child1[c,d]) * (sum_d P[m2,c,s,d] child2[c,d])
// with the parent's counter starting at the sum of its children's and the
// reference's per-site or per-rate scaling (clv_common.cuh).  Then, by mode:
//   sweep (K3): every local row and counter row is copied out to the
//               tree's segment-major inner arrays;
//   leaf  (K4): only the rows later segments import are copied out;
//   root  (K4): the edge log-likelihood is folded,
//     lnl = (log(sum_k parent[k] (P[edge] child)[k] wvec[k])
//            + counters * log(2^-shift)) * pattern_weight,
//     per-rate counters through the reference's min/cap fold; one float64
//     partial per block (no +I, as on the TPU).
//
// Design on this card, and what was decided:
//  * The point of the TPU kernels was that a segment is sized so that its
//    rows stay on chip: only the tip slab comes in and only the export
//    rows go out (clv_pallas_seg.py:1-25).  The H100's on-chip counterpart
//    of VMEM is shared memory, up to 227 KB per block.  One block runs a
//    tile of kThreads = 128 sites, one thread per site, and keeps the
//    segment's local rows and their counters in dynamic shared memory laid
//    out [row, C*S, 128] and [row * srows, 128], site innermost: thread t
//    touches column t only, so the threads never synchronise and a warp's
//    accesses hit 32 different banks.  A DNA float32 row at four rates
//    takes 8 KB plus 0.5-2 KB of counters, so 22 local rows fit one block.
//    The segments are cut to half of that (11 rows, clv_seg.seg_max_rows),
//    so that two blocks share an SM, and each launch asks for its own
//    segment's rows only; a caller's larger segments run up to a block's
//    227 KB.
//  * Tips are read from the segment's slab in device memory, a warp
//    reading 32 consecutive sites of one value (coalesced).  Imports are
//    read where they lie, through one index per import slot: K3 from the
//    inner rows earlier launches wrote, K4 from earlier segments' export
//    rows.  K4 allocates nothing of the tree's size.
//  * The per-site scaling test runs on the row in shared memory: a rate's
//    product is stored as soon as it is done, the thread keeps the running
//    maximum, and in the rare case that the site scales it multiplies its
//    C*S values in shared memory.
//  * Both children's values of a rate are loaded before either is
//    contracted, so that a thread has 2*S loads in flight.
//  * The template is over the dtype and S in {4, 20} (4 instances), as
//    clv_dyn.cu; the rate count, scale mode and mode are runtime values.
//
// What bounds it: per op and site it reads a tip's or an import's C*S
// values from device memory (a local child comes from shared memory) and
// does 2*C*S*S multiply-adds; K4 moves little else, K3 writes every local
// row once.  At 1 024 taxa x 32 768 sites (DNA, four rates, float32) the
// tips are 2.15 GB (0.64 ms at 3.35 TB/s) and K3's inner rows 2.19 GB.
// Shared memory caps the warps in flight: a segment of 22 rows holds one
// block (four warps) per SM, 11 rows two; that is too few to cover
// device-memory latency, so this first kernel is bound by the latency of
// its tip loads, not by bandwidth (on an H100 K4 reads its tips at about a
// tenth of the card's 3.35 TB/s, and two blocks per SM ran it 1.8x faster
// than one).

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kFields = 6;  // parent, c1, c2, s1, s2, has_scaler

enum { MODE_SWEEP = 0, MODE_LEAF = 1, MODE_ROOT = 2 };

template <typename T>
struct SegArgs {
  int mode;
  int rate_cats;
  int scale_mode;
  int64_t sites;
  int n_tip, n_imp, n_loc, n_out;
  const int32_t* table;     // [n_loc, kFields]
  const int32_t* m_ops;     // [n_loc, 2]
  const int32_t* imp_rows;  // [n_imp]: row of each import in src
  const T* tips;            // the segment's tip slab [n_tip, C*S, sites]
  const T* pmatrix;         // [M, C, S, S]
  const T* src;             // import rows [*, C*S, sites]
  const int32_t* src_scal;  // their counters [* x srows, sites]
  const int32_t* out_rows;  // leaf: [n_out] local row of each export;
                            // sweep: null, output row e is local row e
  T* out;                   // [n_out, C*S, sites]
  int32_t* out_scal;        // [n_out x srows, sites]
  const int32_t* edge;      // root: p_state, c_state, p_scal, c_scal, M
  const T* weight_vec;      // root: [C*S]
  const T* pattern_weights; // root: [sites]
  double* partials;         // root: [n_blocks]
  Scale<T> u;
};

// A state row at one site: value k of the row at ptr[k * stride] (a tip
// or an import in device memory, or a local row in shared memory).
template <typename T>
struct Row {
  const T* ptr;
  int64_t stride;
};

template <typename T, int S>
__device__ __forceinline__ Row<T> resolve(const SegArgs<T>& a, const T* loc,
                                          int row, int64_t site) {
  const int64_t cs = (int64_t)a.rate_cats * S;
  if (row < a.n_tip) return {a.tips + row * cs * a.sites + site, a.sites};
  if (row < a.n_tip + a.n_imp)
    return {a.src + (int64_t)__ldg(a.imp_rows + row - a.n_tip) * cs * a.sites +
                site,
            a.sites};
  return {loc + (row - a.n_tip - a.n_imp) * cs * kThreads + threadIdx.x,
          kThreads};
}

template <typename T, int S>
__device__ __forceinline__ void load_rate(const Row<T>& r, int c,
                                          T (&x)[S]) {
  const T* base = r.ptr + (int64_t)c * S * r.stride;
#pragma unroll
  for (int d = 0; d < S; ++d) x[d] = base[d * r.stride];
}

// Counter of scaler row `srow`, rate c (c = 0 with one row per node).
template <typename T>
__device__ __forceinline__ int count(const SegArgs<T>& a,
                                     const int32_t* loc_scal, int srow,
                                     int srows, int c, int64_t site) {
  if (srow < a.n_imp)
    return a.src_scal[((int64_t)__ldg(a.imp_rows + srow) * srows + c) *
                          a.sites + site];
  const int l = srow - a.n_imp;
  if (l < a.n_loc) return loc_scal[(l * srows + c) * kThreads + threadIdx.x];
  return 0;  // the dummy row
}

template <typename T, int S>
__device__ void run_ops(const SegArgs<T>& a, T* loc, int32_t* loc_scal,
                        int64_t site) {
  const int C = a.rate_cats;
  const int64_t pm_size = (int64_t)C * S * S;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int loc0 = a.n_tip + a.n_imp;
  for (int i = 0; i < a.n_loc; ++i) {
    const int32_t* op = a.table + i * kFields;
    const int local = __ldg(op) - loc0;
    const Row<T> r1 = resolve<T, S>(a, loc, __ldg(op + 1), site);
    const Row<T> r2 = resolve<T, S>(a, loc, __ldg(op + 2), site);
    const int s1 = __ldg(op + 3), s2 = __ldg(op + 4);
    const bool has = __ldg(op + 5) != 0;
    const T* p1 = a.pmatrix + __ldg(a.m_ops + 2 * i) * pm_size;
    const T* p2 = a.pmatrix + __ldg(a.m_ops + 2 * i + 1) * pm_size;
    T* out = loc + local * C * S * kThreads + threadIdx.x;
    T site_max = 0;
    for (int c = 0; c < C; ++c) {
      T x1[S], x2[S], t[S];
      load_rate<T, S>(r1, c, x1);
      load_rate<T, S>(r2, c, x2);
      contract_rate<T, S>(p1, c, x1, t);
      mul_contract_rate<T, S>(p2, c, x2, t);
      const T mx = max_of<T, S>(t);
      if (per_rate)
        loc_scal[(local * C + c) * kThreads + threadIdx.x] =
            count(a, loc_scal, s1, C, c, site) +
            count(a, loc_scal, s2, C, c, site) +
            scale_rate<T, S>(has, t, a.u);
      site_max = (c == 0 || mx > site_max) ? mx : site_max;
#pragma unroll
      for (int s = 0; s < S; ++s) out[(c * S + s) * kThreads] = t[s];
    }
    if (!per_rate) {
      int cnt = count(a, loc_scal, s1, 1, 0, site) +
                count(a, loc_scal, s2, 1, 0, site);
      if (a.scale_mode == SCALE_PER_SITE && scales(has, site_max, a.u)) {
        for (int k = 0; k < C * S; ++k) out[k * kThreads] *= a.u.factor;
        cnt += 1;
      }
      loc_scal[local * kThreads + threadIdx.x] = cnt;
    }
  }
}

// Sweep and leaf: copy local rows and their counters to the output rows.
template <typename T, int S>
__device__ void copy_out(const SegArgs<T>& a, const T* loc,
                         const int32_t* loc_scal, int64_t site) {
  const int cs = a.rate_cats * S;
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  for (int e = 0; e < a.n_out; ++e) {
    const int l = a.out_rows == nullptr ? e : __ldg(a.out_rows + e);
    const T* row = loc + l * cs * kThreads + threadIdx.x;
    T* dst = a.out + (int64_t)e * cs * a.sites + site;
    for (int k = 0; k < cs; ++k) dst[k * a.sites] = row[k * kThreads];
    for (int c = 0; c < srows; ++c)
      a.out_scal[((int64_t)e * srows + c) * a.sites + site] =
          loc_scal[(l * srows + c) * kThreads + threadIdx.x];
  }
}

// Root: the weighted log-likelihood of one site across the evaluation edge.
template <typename T, int S>
__device__ T edge_site_lnl(const SegArgs<T>& a, const T* loc,
                           const int32_t* loc_scal, int64_t site) {
  const int C = a.rate_cats;
  const Row<T> rp = resolve<T, S>(a, loc, __ldg(a.edge + 0), site);
  const Row<T> rc = resolve<T, S>(a, loc, __ldg(a.edge + 1), site);
  const int psc = __ldg(a.edge + 2), csc = __ldg(a.edge + 3);
  const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * C * S * S;
  T term_r[kMaxRates];
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    T pv[S], x[S];
    load_rate<T, S>(rp, c, pv);
    load_rate<T, S>(rc, c, x);
    term_r[c] = edge_rate_term<T, S>(pe, c, pv, x, a.weight_vec);
  }
  T term = 0;
  int snum;
  if (a.scale_mode == SCALE_PER_RATE) {
    int sn[kMaxRates];
#pragma unroll
    for (int c = 0; c < kMaxRates; ++c) {
      if (c >= C) break;
      sn[c] = count(a, loc_scal, psc, C, c, site) +
              count(a, loc_scal, csc, C, c, site);
    }
    term = fold_rates<T>(term_r, sn, C, a.u.thresh, snum);
  } else {
#pragma unroll
    for (int c = 0; c < kMaxRates; ++c) {
      if (c >= C) break;
      term += term_r[c];
    }
    snum = count(a, loc_scal, psc, 1, 0, site) +
           count(a, loc_scal, csc, 1, 0, site);
  }
  return site_lnl<T>(term, snum, a.u, __ldg(a.pattern_weights + site));
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) seg_kernel(SegArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* loc = reinterpret_cast<T*>(smem);
  int32_t* loc_scal = reinterpret_cast<int32_t*>(
      loc + (int64_t)a.n_loc * a.rate_cats * S * kThreads);
  const int64_t site = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  double lnl = 0.0;
  if (site < a.sites) {
    run_ops<T, S>(a, loc, loc_scal, site);
    if (a.mode == MODE_ROOT)
      lnl = (double)edge_site_lnl<T, S>(a, loc, loc_scal, site);
    else
      copy_out<T, S>(a, loc, loc_scal, site);
  }
  // every thread of a root block joins the reduction, masked sites with 0
  if (a.mode == MODE_ROOT) block_sum_store(lnl, a.partials);
}

// Dynamic shared memory of one launch: the segment's local rows and
// counters.
template <typename T, int S>
size_t smem_bytes(const SegArgs<T>& a) {
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  return (size_t)a.n_loc * kThreads *
         ((size_t)a.rate_cats * S * sizeof(T) + srows * sizeof(int32_t));
}

template <typename T, int S>
int launch(const SegArgs<T>& a, cudaStream_t st) {
  const size_t smem = smem_bytes<T, S>(a);
  // above 48 KB only after raising the kernel's limit; a segment the card
  // cannot hold makes this call fail, and nothing is launched
  cudaError_t err = cudaFuncSetAttribute(
      seg_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.sites + kThreads - 1) / kThreads);
  seg_kernel<T, S><<<blocks, kThreads, smem, st>>>(a);
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

template <typename T>
int segment(int mode, int states, int rate_cats, int scale_mode,
            int64_t sites, int n_tip, int n_imp, int n_loc, int n_out,
            const int32_t* table, const int32_t* m_ops,
            const int32_t* imp_rows, const void* tips, const void* pmatrix,
            const void* src, const int32_t* src_scal,
            const int32_t* out_rows, void* out, int32_t* out_scal,
            const int32_t* edge, const void* weight_vec,
            const void* pattern_weights, double* partials, void* stream) {
  if (rate_cats < 1 || rate_cats > kMaxRates) return (int)cudaErrorInvalidValue;
  SegArgs<T> a;
  a.mode = mode;
  a.rate_cats = rate_cats;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.n_tip = n_tip;
  a.n_imp = n_imp;
  a.n_loc = n_loc;
  a.n_out = n_out;
  a.table = table;
  a.m_ops = m_ops;
  a.imp_rows = imp_rows;
  a.tips = static_cast<const T*>(tips);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.src = static_cast<const T*>(src);
  a.src_scal = src_scal;
  a.out_rows = out_rows;
  a.out = static_cast<T*>(out);
  a.out_scal = out_scal;
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

// Plain C interface for ctypes: one segment's kernel on `stream`; returns
// cudaGetLastError() (0 on success).

#define SEGMENT_PARAMS                                                      \
  int mode, int states, int rate_cats, int scale_mode, int64_t sites,      \
      int n_tip, int n_imp, int n_loc, int n_out, const int32_t *table,    \
      const int32_t *m_ops, const int32_t *imp_rows, const void *tips,     \
      const void *pmatrix, const void *src, const int32_t *src_scal,       \
      const int32_t *out_rows, void *out, int32_t *out_scal,               \
      const int32_t *edge, const void *weight_vec,                         \
      const void *pattern_weights, double *partials, void *stream
#define SEGMENT_ARGS                                                        \
  mode, states, rate_cats, scale_mode, sites, n_tip, n_imp, n_loc, n_out,  \
      table, m_ops, imp_rows, tips, pmatrix, src, src_scal, out_rows, out, \
      out_scal, edge, weight_vec, pattern_weights, partials, stream

extern "C" int clv_seg_segment_f32(SEGMENT_PARAMS) {
  return segment<float>(SEGMENT_ARGS);
}
extern "C" int clv_seg_segment_f64(SEGMENT_PARAMS) {
  return segment<double>(SEGMENT_ARGS);
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

extern "C" const char* clv_seg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
