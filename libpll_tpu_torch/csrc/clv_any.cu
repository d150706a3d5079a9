// K1/K2 for any alphabet (2 <= S <= 64) and any rate count, for Hopper
// (sm_90a), bound to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py
// builds this file; libpll_tpu_torch/ops/clv_fused.py wraps it beside the
// DNA and protein instances of clv_fused.cu, whose walk plan it shares).
//
// Replaces, where clv_fused.cu's instances do not take the configuration,
// the two Pallas TPU kernels of libpll_tpu/ops/clv_pallas.py:
//   K1  make_fused_edge_score  (pallas_call at :653; any S and C, :498)
//   K2  make_fused_sweep       (pallas_call at :840; any S and C, :715)
// that is K1/K2 at every (S, C) with S not in {4, 20} or C not in
// {1, 2, 4, 8}, and at any walk whose pool does not fit those instances'
// shared memory (float64 protein at eight rates and 1 000 taxa), with S
// and C read at run time.  It computes what clv_fused.cu's header says, in
// the DNA instances' arithmetic: per op, rate and site the two children's
// dots in K1's order and their product, the per-site or per-rate vote, the
// counters; K1's edge sum in row order, one float64 partial per 32 sites.
// It is a file of its own so that nvcc builds it beside clv_fused.cu (in
// that file its instances doubled the build).
//
// Design: a thread a site walks the plan's descriptors (clv_fused.FusedPlan,
// the same walk as the other instances); no barrier is needed, as a thread
// reads only the pool columns it wrote.  Each op is clv_common.cuh's
// any_op, which C1's any-alphabet instance (partials.cu) runs too.  The
// state loops run to a
// compile-time bound R (16 or 64: the instance takes S <= R) with the
// states past S masked: a rate's child values stay in registers, and at
// R = 16 its products too (the loop over a row's states is unrolled whole;
// at R = 64 it is a loop and the products sit in local memory: unrolled
// whole, those instances took nvcc minutes and spilled anyway).  The
// P-matrices come padded to rows of SP = S rounded up to a 16-byte vector
// (clv_fused.pad_rows: zeros past S), so each row loads as vectors, one
// address a warp, each serving four (two) multiply-adds; a zero entry adds
// 0 * 0 to the dot, which changes no bit.  (A first design with run-time
// loops, the values in local memory, took 78 ms for K1 at the 16-state
// flagship on an H100, slower than its plain version: PERF.md.)  The
// walk's live rows take the first `shared_slots` slots of a shared-memory
// pool ([slot, C*S, block] values, [slot, srows, block] counters, a column
// a thread) and the rest spill to device scratch rows ([slot, C*S, sites],
// read back through L1/L2): clv_fused.any_layout gives a block as many
// slots as fit half a block's shared memory (two blocks an SM), so a row
// of 976 bytes a site (S = 61, C = 4, float32) spills rather than refusing
// the walk.  Pattern tips are decoded bit by bit from their word (chars: a
// nibble; masks: up to 32 states).  K2 writes each op's row and counters
// out as it makes them.
//
// What bounds it: operations, 2 C S^2 multiply-adds per op and site (at
// the 16-state flagship, 64 taxa x 262 144 sites x 4 rates, float32:
// ~6.8e10 flop, ~1.0 ms at the FP32 peak) for K1, and for K2 the rows it
// writes (4.2 GB there, ~1.26 ms at 3.35 TB/s); PERF.md has its times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kGroupSites = 32;  // sites per float64 partial (a warp)
constexpr int kAnyMaxStates = 64;

template <typename T>
struct AnyArgs {
  int tip_encoding;
  int scale_mode;
  int64_t sites;
  int n_ops;
  int n_inner;
  int states;
  int sp;            // a padded P-matrix row
  int rate_cats;
  int shared_slots;  // pool slots in shared memory; the rest spill
  int64_t n_groups;  // K1: 32-site partials, four per 128 sites
  const OpDesc* ops;         // [n_ops]: the plan's walk
  const T* tip_clv;          // [tips, C*S, sites]              ("clv")
  const int32_t* tip_words;  // [ceil(tips/8) or tips, sites]
  const T* pmatrix;          // [M, C, S, sp], rows padded with zeros
  T* inner;                  // K2: [n_inner, C*S, sites]
  int32_t* scalers;          // K2: [(n_inner + 1) * srows, sites]
  T* spill;                  // [pool - shared_slots, C*S, sites]
  int32_t* spill_scal;       // [pool - shared_slots, srows, sites]
  const int32_t* edge;       // K1: parent, child, their counters, matrix,
                             // the child's nibble shift
  const T* weight_vec;       // K1: [C*S]
  const T* pattern_weights;  // K1: [sites]
  const T* inv_add;          // K1: [sites], or null without +I
  double* partials;          // K1: [n_groups]
  Scale<T> u;
};

// The dynamic shared memory of a block of nb sites holding `slots` slots.
template <typename T>
size_t any_smem_bytes(int slots, int cs, int srows, int nb) {
  return (size_t)slots * nb * (cs * sizeof(T) + srows * sizeof(int32_t));
}

template <typename T, int R, bool kScore>
__global__ void __launch_bounds__(kThreads)
    fused_any_kernel(const __grid_constant__ AnyArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = a.states, sp = a.sp, C = a.rate_cats, cs = C * ns;
  const int nb = blockDim.x, t = threadIdx.x;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool counts = a.scale_mode != SCALE_NONE;
  const int srows = per_rate ? C : 1;
  const int shared = a.shared_slots;
  T* const pool = reinterpret_cast<T*>(smem);
  int32_t* const spool =
      reinterpret_cast<int32_t*>(pool + (size_t)shared * cs * nb);
  const int64_t L = a.sites;
  const int64_t mat = (int64_t)cs * sp;  // a padded [C, S, sp] matrix
  const uint32_t code_mask = a.tip_encoding == TIP_CHARS ? 0xFu : ~0u;
  const bool code_tips = a.tip_encoding != TIP_CLV;
  const int32_t zero = 0;  // a tip's counters, at stride 0

  const int64_t padded =
      (L + 4 * kGroupSites - 1) / (4 * kGroupSites) * 4 * kGroupSites;
  const int64_t n_tiles = (padded + nb - 1) / nb;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n = tile * nb + t;
    const bool live = n < L;
    // a pool slot's row and counters: shared memory, or a spill row
    auto row_at = [&](int slot) -> RowAt<T> {
      if (slot < shared)
        return RowAt<T>{pool + (size_t)slot * cs * nb + t, nb};
      return RowAt<T>{a.spill + (int64_t)(slot - shared) * cs * L + n, L};
    };
    auto scal_at = [&](int slot) -> RowAt<int32_t> {
      if (slot < shared)
        return RowAt<int32_t>{spool + (size_t)slot * srows * nb + t, nb};
      return RowAt<int32_t>{
          a.spill_scal + (int64_t)(slot - shared) * srows * L + n, L};
    };
    auto count_at = [&](int d) -> RowAt<int32_t> {
      return d < 0 ? RowAt<int32_t>{&zero, 0} : scal_at(index_of(d));
    };
    // a child's entries: a pool slot, a CLV tip or a pattern tip's code
    auto code_of = [&](int d, int shift) -> CodeAt<T> {
      return CodeAt<T>{
          ((uint32_t)__ldg(a.tip_words + (int64_t)index_of(d) * L + n) >>
           shift) & code_mask};
    };
    auto row_of = [&](int d) -> RowAt<T> {
      return kind_of(d) == K_POOL
                 ? row_at(index_of(d))
                 : RowAt<T>{a.tip_clv + (int64_t)index_of(d) * cs * L + n, L};
    };
    if (live) {
      if (!kScore)  // the dummy counters
        for (int r = 0; r < srows; ++r)
          a.scalers[((int64_t)a.n_inner * srows + r) * L + n] = 0;
      for (int i = 0; i < a.n_ops; ++i) {
        const OpDesc o = a.ops[i];
        const RowAt<T> out = row_at(o.home);
        const RowAt<int32_t> so = scal_at(o.home);
        const T* p1 = a.pmatrix + (int64_t)o.m[0] * mat;
        const T* p2 = a.pmatrix + (int64_t)o.m[1] * mat;
        auto run = [&](const auto& x1, const auto& x2) {
          any_op<T, R>(x1, x2, const_cast<T*>(out.p), out.stride, p1, p2,
                       count_at(o.s[0]), count_at(o.s[1]),
                       const_cast<int32_t*>(so.p), so.stride, counts,
                       o.has != 0, per_rate, C, ns, sp, a.u);
        };
        const bool code1 = code_tips && kind_of(o.c[0]) != K_POOL;
        const bool code2 = code_tips && kind_of(o.c[1]) != K_POOL;
        if (code1 && code2)
          run(code_of(o.c[0], o.pad[0]), code_of(o.c[1], o.pad[1]));
        else if (code1)
          run(code_of(o.c[0], o.pad[0]), row_of(o.c[1]));
        else if (code2)
          run(row_of(o.c[0]), code_of(o.c[1], o.pad[1]));
        else
          run(row_of(o.c[0]), row_of(o.c[1]));
        if (!kScore) {
          T* dst = a.inner + (int64_t)o.out * cs * L + n;
          for (int k = 0; k < cs; ++k) dst[(int64_t)k * L] = out(0, k, ns);
          for (int r = 0; r < srows; ++r)
            a.scalers[((int64_t)o.out * srows + r) * L + n] =
                counts ? so(0, r, 1) : 0;
        }
      }
    }
    if (kScore) {
      // the edge's weighted log-likelihood at the site (per-site or no
      // scaling), in the DNA instances' order
      double lnl = 0.0;
      if (live) {
        const int pd = __ldg(a.edge + 0), cd = __ldg(a.edge + 1);
        const RowAt<T> par = row_at(index_of(pd));
        const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * mat;
        const bool child_code = code_tips && kind_of(cd) != K_POOL;
        T term = 0;
        for (int c = 0; c < C; ++c) {
          T x[R], tb[R];
          if (child_code)
            any_child<T, R>(code_of(cd, __ldg(a.edge + 5)), c, ns, x);
          else
            any_child<T, R>(row_of(cd), c, ns, x);
          contract_any<T, R, false>(pe + (int64_t)c * ns * sp, ns, sp, x,
                                    tb);
          each_state<R>(ns, [&](int j) {
            term = dev_fma(par(c, j, ns) * tb[j],
                           __ldg(a.weight_vec + c * ns + j), term);
          });
        }
        if (a.inv_add != nullptr) term += __ldg(a.inv_add + n);
        const int snum = counts ? count_at(__ldg(a.edge + 2))(0, 0, 1) +
                                      count_at(__ldg(a.edge + 3))(0, 0, 1)
                                : 0;
        lnl = (double)site_lnl<T>(term, snum, a.u,
                                  __ldg(a.pattern_weights + n));
      }
      // one warp's 32 sites in the first kernel's order
      for (int off = 16; off > 0; off >>= 1)
        lnl += __shfl_down_sync(0xffffffffu, lnl, off);
      const int64_t group = (n - (t & 31)) / kGroupSites;
      if ((t & 31) == 0 && group < a.n_groups) a.partials[group] = lnl;
    }
  }
}

// The bound of the instance that takes `states`.
int any_bound(int states) { return states <= 16 ? 16 : kAnyMaxStates; }

template <typename T, int R, bool kScore>
int any_launch(const AnyArgs<T>& a, int threads, int grid,
               cudaStream_t st) {
  auto kernel = fused_any_kernel<T, R, kScore>;
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  const size_t smem = any_smem_bytes<T>(
      a.shared_slots, a.rate_cats * a.states, srows, threads);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The instance's card: out[0] the dynamic shared memory a block may have,
// out[1] SMs, out[2] blocks an SM holds at (threads, smem).
template <typename T, int R, bool kScore>
int any_query(int threads, int smem, int* out) {
  int limit = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      open_kernel(fused_any_kernel<T, R, kScore>, &limit, &sms);
  if (err == cudaSuccess && threads > 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_any_kernel<T, R, kScore>, threads, (size_t)smem);
  out[0] = limit;
  out[1] = sms;
  out[2] = per_sm;
  return (int)err;
}

template <typename T, bool kScore>
int any_query_for(int states, int threads, int smem, int* out) {
  return any_bound(states) == 16
             ? any_query<T, 16, kScore>(threads, smem, out)
             : any_query<T, kAnyMaxStates, kScore>(threads, smem, out);
}

template <typename T>
int walk_any(int states, int sp, int rate_cats, int tip_encoding,
             int scale_mode, int64_t sites, int n_ops, int n_inner, int pool,
             int shared_slots, int threads, int grid, const void* ops,
             const void* tips, const void* pmatrix, void* inner,
             int32_t* scalers, void* spill, int32_t* spill_scal,
             const int32_t* edge, const void* weight_vec,
             const void* pattern_weights, const void* inv_add,
             double* partials, void* stream) {
  if (states < 2 || states > kAnyMaxStates || rate_cats < 1 || sites < 1 ||
      sp < states || sp % Vec16<T>::n || sp > kAnyMaxStates ||
      n_ops < 1 || pool < 1 || shared_slots < 0 || shared_slots > pool ||
      (shared_slots < pool && (!spill || !spill_scal)) || threads < 32 ||
      threads > kThreads || threads % 32 || grid < 1 ||
      (tip_encoding == TIP_CHARS && states > 4) ||
      (tip_encoding == TIP_MASKS && states > 32) ||
      (edge != nullptr && scale_mode == SCALE_PER_RATE) ||
      (edge == nullptr && (!inner || !scalers)))
    return (int)cudaErrorInvalidValue;
  AnyArgs<T> a;
  a.tip_encoding = tip_encoding;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.n_ops = n_ops;
  a.n_inner = n_inner;
  a.states = states;
  a.sp = sp;
  a.rate_cats = rate_cats;
  a.shared_slots = shared_slots;
  a.n_groups = (sites + 4 * kGroupSites - 1) / (4 * kGroupSites) * 4;
  a.ops = static_cast<const OpDesc*>(ops);
  a.tip_clv = tip_encoding == TIP_CLV ? static_cast<const T*>(tips) : nullptr;
  a.tip_words =
      tip_encoding == TIP_CLV ? nullptr : static_cast<const int32_t*>(tips);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.inner = static_cast<T*>(inner);
  a.scalers = scalers;
  a.spill = static_cast<T*>(spill);
  a.spill_scal = spill_scal;
  a.edge = edge;
  a.weight_vec = static_cast<const T*>(weight_vec);
  a.pattern_weights = static_cast<const T*>(pattern_weights);
  a.inv_add = static_cast<const T*>(inv_add);
  a.partials = partials;
  a.u = scale_units<T>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (any_bound(states) == 16)
    return edge == nullptr ? any_launch<T, 16, false>(a, threads, grid, st)
                           : any_launch<T, 16, true>(a, threads, grid, st);
  return edge == nullptr
             ? any_launch<T, kAnyMaxStates, false>(a, threads, grid, st)
             : any_launch<T, kAnyMaxStates, true>(a, threads, grid, st);
}

}  // namespace

// Plain C interface for ctypes.  clv_any_walk_* launches the instance (K2
// when `edge` is null, else K1) with clv_fused.any_layout's block:
// `threads` sites a block, the pool's first `shared_slots` slots in shared
// memory and the rest in `spill` / `spill_scal`; `pmatrix` is [M, C, S,
// sp], each row padded with zeros to `sp` (a multiple of 16 bytes, at most
// 64 values).  It returns cudaGetLastError() (0 on success).
#define ANY_PARAMS                                                           \
  int states, int sp, int rate_cats, int tip_encoding, int scale_mode,      \
      int64_t sites, int n_ops, int n_inner, int pool, int shared_slots,    \
      int threads, int grid, const void *ops, const void *tips,             \
      const void *pmatrix, void *inner, int32_t *scalers, void *spill,      \
      int32_t *spill_scal, const int32_t *edge, const void *weight_vec,     \
      const void *pattern_weights, const void *inv_add, double *partials,   \
      void *stream
#define ANY_ARGS                                                             \
  states, sp, rate_cats, tip_encoding, scale_mode, sites, n_ops, n_inner,   \
      pool, shared_slots, threads, grid, ops, tips, pmatrix, inner,         \
      scalers, spill, spill_scal, edge, weight_vec, pattern_weights,        \
      inv_add, partials, stream

extern "C" int clv_any_walk_f32(ANY_PARAMS) {
  return walk_any<float>(ANY_ARGS);
}
extern "C" int clv_any_walk_f64(ANY_PARAMS) {
  return walk_any<double>(ANY_ARGS);
}

// The instance for `states` on the current device (any_query above; its
// shared-memory limit raised first); returns 0 or a CUDA error code.
extern "C" int clv_any_query(int states, int f64, int score, int threads,
                             int smem, int* out) {
  if (f64)
    return score ? any_query_for<double, true>(states, threads, smem, out)
                 : any_query_for<double, false>(states, threads, smem, out);
  return score ? any_query_for<float, true>(states, threads, smem, out)
               : any_query_for<float, false>(states, threads, smem, out);
}

extern "C" const char* clv_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
