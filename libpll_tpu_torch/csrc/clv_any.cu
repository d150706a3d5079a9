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
// dots in K1's order and their product, the per-site or per-rate vote
// (all_below's NaN rule), the counters; K1's edge sum in row order (one
// fma chain over every rate and state, +I added after), one float64
// partial per 32 sites.  It is a file of its own so that nvcc builds it
// beside clv_fused.cu.
//
// Design (the levers of clv_dyn_any.cu's K5/K6, whose block both take from
// any_warp.cuh, on the one-launch walk of clv_fused.FusedPlan; the numbers
// are PERF.md's, tools/fused_times.py --alphabet on an H100):
//  * A block is a tile of 32 sites, a lane a site and a warp a rate (past
//    eight rates a warp takes ceil(C/8) of them, rates w, w + W, ...), so
//    a thread holds one rate's values, not a site's C*S; one warp for all
//    rates measured 1.6-2.0x slower.  A thread reads and writes only its
//    own (site, rate) column of the pool, and a site's counter only warp
//    0's lane (per rate: the rate's warp), so a parent may take its
//    child's slot without a barrier.  The per-site vote spans the warps: a
//    ballot a warp and one barrier an op that may scale; a warp with one
//    rate holds its products in registers until the vote, one with more
//    stores them and rescales its columns.  Every tile is a block.
//  * The pool: the walk's slots below `shared_slots` live in shared memory
//    ([slot, C*S, 32] values, [slot, srows, 32] counters: 8.3 KB at GT16,
//    31 KB at 61 states, four rates, float32), the rest in device rows.
//    clv_fused.any_layout sizes it for 16 warps an SM, or for the blocks
//    the registers allow where fewer (the 64-state instances: two), so
//    the GT16 and codon walks (3 slots) fit whole; spills cost little
//    there (every row spilled: 0.2-1.8% slower).
//  * Staging: a chunk of kChunk ops' descriptors is resolved into shared
//    memory and the chunk's tip codes read in bulk, so that an op waits on
//    no chain of dependent loads.
//  * P-matrices come transposed and zero-padded to [R, R] at every R in
//    {4, 8, 16, 64} (any_block.any_pt: entry [k, j] = P[j, k]), and every
//    contraction runs k-outer: per k one broadcast row of P^T feeds R
//    independent multiply-adds of the lane's site, each dot still in K1's
//    order (0 + the product at k = 0 is the product; fma after).  At
//    R <= 16 a rate's child values and products stay in registers and
//    each warp copies the matrices of its next (op, rate) unit into its own
//    two-entry ring in shared memory by cp.async (a __syncwarp, no block
//    barrier): through L1 instead, GT16 ran 1.6-1.8x slower.  At R = 64
//    (17-64 states) the k loop runs to S at run time over kPass output
//    states at a time, the child value x_k read once a pass from the pool
//    or the row, and the P^T rows are read through L1: a rate's pair of
//    padded 64-state matrices is 32 KB in float32, and a warp's unit
//    staged in shared memory (tools/fused_any_ablations.json pt_staged_64,
//    one block an SM) measured no faster.  Passes of 16, 32 and 64 states
//    took the codon K1 8.3, 6.5 and 5.7 ms: each pass reads x again;
//    loading P^T is about half of what remains.  At 64-state passes ptxas
//    keeps some of the second child's accumulators in local memory (under
//    250 B a thread in float32); the 32-state passes that keep none ran
//    15% slower.  Float64 runs 16-state passes, its k loop unrolled as
//    float32's: its ~2 KB of spills a thread cost less than 8- or
//    32-state passes or a loop not unrolled (the codon cell in float64
//    21.5/25.9 ms against 45.1/45.0 with 8-state passes not unrolled).
//  * K1's edge: each rate's warp multiplies the parent's values by the
//    edge's P x in place, then warp 0 folds the products in row order.
//
// What bounds it: operations, 2 C S^2 multiply-adds per op and site (at
// the 16-state flagship, 64 taxa x 262 144 sites x 4 rates, float32:
// ~6.8e10 flop, ~1.0 ms at the FP32 peak; at 61 states, 64 x 16 384,
// ~6.1e10 flop, ~0.9 ms) for K1 and the codon K2, and for the GT16 K2 the
// rows it writes (4.2 GB, ~1.28 ms at 3.35 TB/s).  It reaches 15-25% of
// those bounds; at GT16 two thirds of its time is outside the
// multiply-adds (the children's values, the rings, the vote's barrier).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "any_warp.cuh"

namespace {

// R = 64: output states a pass of the k loop (float64 takes fewer, PERF.md)
template <typename T>
constexpr int kPass = sizeof(T) == 4 ? 64 : 16;

template <typename T>
struct AnyArgs {
  int tip_encoding;
  int scale_mode;
  int64_t sites;
  int n_ops;
  int n_inner;
  int states;
  int rate_cats;
  int warps;         // W: warp w runs rates w, w + W, ...
  int shared_slots;  // pool slots in shared memory; the rest spill
  int64_t n_groups;  // 32-site partials (K1) and blocks
  const OpDesc* ops;         // [n_ops]: the plan's walk
  const T* tip_clv;          // [tips, C*S, sites]              ("clv")
  const int32_t* tip_words;  // [ceil(tips/8) or tips, sites]
  const T* pmatrix;          // [M, C, R, R]: P^T, zero-padded
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

// R = 64: t[j] (=, or *= with kMul) sum_{k < ns} pt[k, j] x(k) for j < R,
// k-outer in passes of kPass output states, x(k) read once a pass (a row's
// column or a pattern tip's bit), pt's rows through L1.  The accumulators
// start at 0: fma(p, x, 0) is the product, so each dot is K1's order.
template <typename T, int R, bool kMul, typename X>
__device__ __forceinline__ void contract_k(const T* pt, const X& x, int ns,
                                           T (&t)[R]) {
  constexpr int kJ = kPass<T>;
  static_assert(R % kJ == 0, "whole passes of kJ states");
#pragma unroll
  for (int j0 = 0; j0 < R; j0 += kJ) {
    T acc[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[jj] = 0;
#pragma unroll 4
    for (int k = 0; k < ns; ++k) {
      const T xk = x(0, k, ns);
      T p[kJ];
      load_pm_row<T, kJ, false>(pt + k * R + j0, p);
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) acc[jj] = dev_fma(p[jj], xk, acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      t[j0 + jj] = kMul ? t[j0 + jj] * acc[jj] : acc[jj];
  }
}

// f(j) for each state j < ns, unrolled to R so that arrays indexed by j stay
// in registers (each_state keeps R = 64 a loop).
template <int R, typename F>
__device__ __forceinline__ void each_held(int ns, F&& f) {
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j < ns) f(j);
}

template <typename T, int R, bool kScore>
__global__ void __launch_bounds__(kTileSites * kMaxWarps)
    fused_any_kernel(const __grid_constant__ AnyArgs<T> a) {
  constexpr bool kRing = R <= kAnyUnrolled;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ OpDesc ops[kChunk];
  __shared__ __align__(16) uint32_t codes[kChunk][2][kTileSites];
  __shared__ unsigned votes[2][kMaxWarps];
  const int ns = a.states, C = a.rate_cats, cs = C * ns, W = a.warps;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (C - w + W - 1) / W;  // the warp's rates
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool per_site = a.scale_mode == SCALE_PER_SITE;
  const bool counts = a.scale_mode != SCALE_NONE;
  const bool code_tips = a.tip_encoding != TIP_CLV;
  const uint32_t code_mask = a.tip_encoding == TIP_CHARS ? 0xFu : ~0u;
  const int srows = per_rate ? C : 1;
  const int shared = a.shared_slots;
  const int64_t L = a.sites;
  const int64_t site = (int64_t)blockIdx.x * kTileSites + lane;
  if ((int64_t)blockIdx.x * kTileSites >= L) {  // a tile past the sites
    if (kScore && threadIdx.x == 0) a.partials[blockIdx.x] = 0.0;
    return;
  }
  const bool live = site < L;
  const int64_t n = live ? site : L - 1;  // loads past the end: clamped
  T* const pool = reinterpret_cast<T*>(smem);
  int32_t* const spool =
      reinterpret_cast<int32_t*>(pool + (size_t)shared * cs * kTileSites);
  // past the pool: the warps' rings (R <= 16)
  T* const tail = reinterpret_cast<T*>(
      spool + (size_t)shared * srows * kTileSites);
  constexpr int kUnit = 2 * R * R;  // a unit: one rate's two matrices
  T* const ring = tail + (size_t)w * kDepth * kUnit;

  // a staged source's rows (pool slot, spill row or CLV tip) at the lane's
  // site, rate c's first state at p
  auto row_of = [&](int d, int c) -> RowAt<T> {
    const int kind = kind_of(d), v = index_of(d);
    if (kind == K_POOL)
      return RowAt<T>{pool + ((size_t)v * cs + c * ns) * kTileSites + lane,
                      kTileSites};
    const T* base = kind == K_TIP ? a.tip_clv : a.spill;
    return RowAt<T>{base + ((int64_t)v * cs + c * ns) * L + n, L};
  };
  // a staged counter source's counter of rate/row cc (K_ZERO: 0)
  auto count_of = [&](int d, int cc) -> int {
    if (d < 0) return 0;
    const int v = index_of(d);
    if (kind_of(d) == K_POOL)
      return spool[((size_t)v * srows + cc) * kTileSites + lane];
    return a.spill_scal[((int64_t)v * srows + cc) * L + n];
  };
  // a plan descriptor with its pool slot resolved: shared or spilled
  auto resolve = [&](int d) -> int {
    if (d < 0 || kind_of(d) != K_POOL) return d;
    const int v = index_of(d);
    return v < shared ? d : desc(K_SPILL, v - shared);
  };
  auto coded = [&](int d) { return code_tips && kind_of(d) == K_TIP; };
  // rate c's values of a staged child (0 past ns), into registers (R <= 16)
  auto child = [&](int d, uint32_t code, int c, T(&x)[R]) {
    if (coded(d))
      any_child<T, R>(CodeAt<T>{code}, c, ns, x);
    else
      any_child<T, R>(row_of(d, c), 0, ns, x);
  };
  // R = 64: t (=, or *= with kMul) rate c's dots of a staged child with pt
  auto dots = [&](auto mul, const T* pt, int d, uint32_t code, int c,
                  T(&t)[R]) {
    constexpr bool kMul = decltype(mul)::value;
    if (coded(d))
      contract_k<T, R, kMul>(pt, CodeAt<T>{code}, ns, t);
    else
      contract_k<T, R, kMul>(pt, row_of(d, c), ns, t);
  };
  // a warp's unit u (op u / nq, its rate u % nq): the two matrices into
  // its ring entry by cp.async, one group a unit (empty past the walk)
  auto prefetch = [&](int u) {
    if (u < a.n_ops * nq) {
      const int i = u / nq, c = w + (u - i * nq) * W;
      constexpr int kVec = Vec16<T>::n, kPer = R * R / kVec;
      T* dst = ring + (u % kDepth) * kUnit;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const T* src = a.pmatrix +
                       ((int64_t)__ldg(&a.ops[i].m[side]) * C + c) * R * R;
        for (int v = lane; v < kPer; v += 32)
          cp_async16(dst + side * R * R + v * kVec, src + v * kVec);
      }
    }
    cp_async_commit();
  };

  if (!kScore && w == 0 && live)  // the dummy counters
    for (int r = 0; r < srows; ++r)
      a.scalers[((int64_t)a.n_inner * srows + r) * L + n] = 0;
  int vb = 0;  // the votes buffer; a barrier lies between two uses of one
  if constexpr (kRing)
    for (int u = 0; u < kDepth - 1; ++u) prefetch(u);
  for (int base = 0; base < a.n_ops; base += kChunk) {
    const int cnt = min(kChunk, a.n_ops - base);
    __syncthreads();  // the previous chunk is done with what is staged
    if ((int)threadIdx.x < cnt) {  // resolve op base + t
      const OpDesc src = a.ops[base + threadIdx.x];
      OpDesc& o = ops[threadIdx.x];
      o = src;
      o.home = resolve(desc(K_POOL, src.home));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        o.c[k] = resolve(src.c[k]);
        o.s[k] = resolve(src.s[k]);
      }
    }
    __syncthreads();
    if (code_tips) {  // the chunk's tip codes at the tile's sites, in bulk
      stage_codes(
          ops, codes, cnt, L,
          [&](const OpDesc&, int d) { return kind_of(d) == K_TIP; },
          [&](const OpDesc& o, int k, int d, int64_t s) {
            return ((uint32_t)__ldg(a.tip_words + (int64_t)index_of(d) * L +
                                    s) >>
                    o.pad[k]) &
                   code_mask;
          });
      __syncthreads();
    }
    for (int j = 0; j < cnt; ++j) {
      const OpDesc o = ops[j];
      const int i = base + j;
      const bool may = o.has != 0;
      const bool pooled = kind_of(o.home) == K_POOL;
      const int hv = index_of(o.home);
      // the parent's home (its pool slot or spill row) and, K2, its row
      T* const hp = pooled ? pool + (size_t)hv * cs * kTileSites + lane
                           : a.spill + (int64_t)hv * cs * L + n;
      const int64_t hs = pooled ? kTileSites : L;
      const bool home_put = pooled || live;
      T* const op_row = kScore ? nullptr : a.inner + (int64_t)o.out * cs * L + n;
      auto put = [&](int e, T v) {
        if (home_put) hp[e * hs] = v;
        if (!kScore && live) op_row[(int64_t)e * L] = v;
      };
      auto put_count = [&](int cc, int v) {
        if (pooled)
          spool[((size_t)hv * srows + cc) * kTileSites + lane] = v;
        else if (live)
          a.spill_scal[((int64_t)hv * srows + cc) * L + n] = v;
        if (!kScore && live)
          a.scalers[((int64_t)o.out * srows + cc) * L + n] = v;
      };
      // per site with one rate a warp: the products wait in registers for
      // the vote
      const bool hold = per_site && may && nq == 1;
      bool site_below = true;
      T t[R];
      for (int q = 0; q < nq; ++q) {
        const int c = w + q * W;
        if constexpr (kRing) {
          const int u = i * nq + q;
          __syncwarp();  // the ring entry refilled below is free
          prefetch(u + kDepth - 1);
          cp_async_wait_ring();
          __syncwarp();  // unit u has landed for the whole warp
          const T* pm = ring + (u % kDepth) * kUnit;  // its P^T pair
          T x[R], t2[R];
          child(o.c[0], codes[j][0][lane], c, x);
          contract_t<T, R, false>(pm, x, t);
          child(o.c[1], codes[j][1][lane], c, x);
          contract_t<T, R, false>(pm + R * R, x, t2);
#pragma unroll
          for (int jj = 0; jj < R; ++jj) t[jj] *= t2[jj];
        } else {  // the P^T pair through L1
          const T* p1 = a.pmatrix + ((int64_t)o.m[0] * C + c) * R * R;
          const T* p2 = a.pmatrix + ((int64_t)o.m[1] * C + c) * R * R;
          dots(std::false_type{}, p1, o.c[0], codes[j][0][lane], c, t);
          dots(std::true_type{}, p2, o.c[1], codes[j][1][lane], c, t);
        }
        bool below = may;
        each_held<R>(ns, [&](int jj) { below &= t[jj] < a.u.thresh; });
        if (per_rate) {
          if (below) each_held<R>(ns, [&](int jj) { t[jj] *= a.u.factor; });
          put_count(c, count_of(o.s[0], c) + count_of(o.s[1], c) +
                           (int)below);
        }
        site_below &= below;
        if (!hold) each_held<R>(ns, [&](int jj) { put(c * ns + jj, t[jj]); });
      }
      if (per_site) {
        bool scale = false;
        if (may) {  // the site's vote across the warps
          scale = site_vote_warps(site_below, votes, vb, W, w, lane);
          vb ^= 1;
        }
        if (hold) {
          if (scale) each_held<R>(ns, [&](int jj) { t[jj] *= a.u.factor; });
          each_held<R>(ns, [&](int jj) { put(w * ns + jj, t[jj]); });
        } else if (scale) {  // rescale the warp's stored rates
          for (int q = 0; q < nq; ++q) {
            const int c = w + q * W;
            for (int jj = 0; jj < ns; ++jj) {
              const int e = c * ns + jj;
              if (home_put) {
                const T v = hp[e * hs] * a.u.factor;
                hp[e * hs] = v;
                if (!kScore && live) op_row[(int64_t)e * L] = v;
              }
            }
          }
        }
        if (w == 0)
          put_count(0, count_of(o.s[0], 0) + count_of(o.s[1], 0) +
                           (int)scale);
      } else if (!counts && !kScore && w == 0 && live) {
        a.scalers[(int64_t)o.out * L + n] = 0;  // K2's counters unscaled
      }
    }
  }
  if constexpr (kScore) {
    // the edge: each rate's warp multiplies the parent's values by the
    // edge's P x in place, then warp 0 folds them in row order (the DNA
    // instances' order: one fma chain over every rate and state)
    if constexpr (kRing) cp_async_wait_all();
    __syncthreads();  // every op's rows are written
    const int pd = resolve(__ldg(a.edge + 0)), cd = resolve(__ldg(a.edge + 1));
    const bool ppool = kind_of(pd) == K_POOL;
    T* const par = ppool
        ? pool + (size_t)index_of(pd) * cs * kTileSites + lane
        : a.spill + (int64_t)index_of(pd) * cs * L + n;
    const int64_t ps = ppool ? kTileSites : L;
    const bool par_put = ppool || live;
    const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * C * R * R;
    const uint32_t code =
        coded(cd) ? ((uint32_t)__ldg(a.tip_words +
                                     (int64_t)index_of(cd) * L + n) >>
                     __ldg(a.edge + 5)) & code_mask
                  : 0u;
    for (int q = 0; q < nq; ++q) {
      const int c = w + q * W;
      T tb[R];
      if constexpr (kRing) {
        T x[R];
        child(cd, code, c, x);
        contract_t<T, R, true>(pe + (int64_t)c * R * R, x, tb);
      } else {
        dots(std::false_type{}, pe + (int64_t)c * R * R, cd, code, c, tb);
      }
      if (par_put)
        each_held<R>(ns, [&](int jj) {
          T& v = par[(c * ns + jj) * ps];
          v = v * tb[jj];
        });
    }
    __syncthreads();
    if (w == 0) {
      double lnl = 0.0;  // past-the-end sites add 0
      if (live) {
        T term = 0;
        for (int e = 0; e < cs; ++e)
          term = dev_fma(par[e * ps], __ldg(a.weight_vec + e), term);
        if (a.inv_add != nullptr) term += __ldg(a.inv_add + n);
        const int snum = counts ? count_of(resolve(__ldg(a.edge + 2)), 0) +
                                      count_of(resolve(__ldg(a.edge + 3)), 0)
                                : 0;
        lnl = (double)site_lnl<T>(term, snum, a.u,
                                  __ldg(a.pattern_weights + n));
      }
      warp_sum_store(lnl, a.partials, blockIdx.x, a.n_groups);
    }
  }
}

// The dynamic shared memory of a block: its pool's slots and what follows
// them (clv_fused.any_layout).
template <typename T, int R>
size_t any_smem_bytes(int slots, int rate_cats, int states, int srows,
                      int warps) {
  const size_t slot = (size_t)kTileSites *
                      ((size_t)rate_cats * states * sizeof(T) +
                       (size_t)srows * sizeof(int32_t));
  const size_t units = R <= kAnyUnrolled ? kDepth : 0;
  return slots * slot + (size_t)warps * units * 2 * R * R * sizeof(T);
}

template <typename T, int R, bool kScore>
int any_launch(const AnyArgs<T>& a, cudaStream_t st) {
  auto kernel = fused_any_kernel<T, R, kScore>;
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  const size_t smem = any_smem_bytes<T, R>(a.shared_slots, a.rate_cats,
                                           a.states, srows, a.warps);
  // above 48 KB only after raising the kernel's limit; a pool the card
  // cannot hold makes this call fail, and nothing is launched
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)a.n_groups, kTileSites * a.warps, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The instance's card: out[0] the dynamic shared memory a block may have
// (the kernel's limit raised to it), out[1] SMs, out[2] blocks an SM holds
// at (threads, smem).  The carveout is left to the driver, so that L1 keeps
// what the blocks leave (R = 64 reads its matrices through it).
template <typename T, int R, bool kScore>
int any_query(int threads, int smem, int* out) {
  auto kernel = fused_any_kernel<T, R, kScore>;
  out[0] = out[1] = out[2] = 0;
  cudaError_t err = open_kernel(kernel, &out[0], &out[1]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutDefault);
  if (err == cudaSuccess && threads > 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        threads, (size_t)smem);
  return (int)err;
}

template <typename T, bool kScore>
int any_query_for(int states, int threads, int smem, int* out) {
  switch (any_bound(states)) {
    case 4: return any_query<T, 4, kScore>(threads, smem, out);
    case 8: return any_query<T, 8, kScore>(threads, smem, out);
    case 16: return any_query<T, 16, kScore>(threads, smem, out);
    default: return any_query<T, kAnyMaxStates, kScore>(threads, smem, out);
  }
}

template <typename T, int R>
int launch_for(const AnyArgs<T>& a, cudaStream_t st) {
  return a.edge == nullptr ? any_launch<T, R, false>(a, st)
                           : any_launch<T, R, true>(a, st);
}

template <typename T>
int walk_any(int states, int rate_cats, int tip_encoding, int scale_mode,
             int64_t sites, int n_ops, int n_inner, int pool,
             int shared_slots, const void* ops, const void* tips,
             const void* pmatrix, void* inner, int32_t* scalers, void* spill,
             int32_t* spill_scal, const int32_t* edge, const void* weight_vec,
             const void* pattern_weights, const void* inv_add,
             double* partials, void* stream) {
  if (states < 2 || states > kAnyMaxStates || rate_cats < 1 || sites < 1 ||
      n_ops < 1 || pool < 1 || shared_slots < 0 || shared_slots > pool ||
      (shared_slots < pool && (!spill || !spill_scal)) ||
      (tip_encoding == TIP_CHARS && states > 4) ||
      (tip_encoding == TIP_MASKS && states > 32) ||
      (edge != nullptr && (scale_mode == SCALE_PER_RATE || !partials)) ||
      (edge == nullptr && (!inner || !scalers)))
    return (int)cudaErrorInvalidValue;
  AnyArgs<T> a;
  a.tip_encoding = tip_encoding;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.n_ops = n_ops;
  a.n_inner = n_inner;
  a.states = states;
  a.rate_cats = rate_cats;
  a.warps = any_warps(rate_cats);
  a.shared_slots = shared_slots;
  a.n_groups = (sites + 4 * kTileSites - 1) / (4 * kTileSites) * 4;
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
  switch (any_bound(states)) {
    case 4: return launch_for<T, 4>(a, st);
    case 8: return launch_for<T, 8>(a, st);
    case 16: return launch_for<T, 16>(a, st);
    default: return launch_for<T, kAnyMaxStates>(a, st);
  }
}

}  // namespace

// Plain C interface for ctypes.  clv_any_walk_* launches the instance (K2
// when `edge` is null, else K1) over every 32-site tile of the sites padded
// to whole 128-site partials, with clv_fused.any_layout's pool: its first
// `shared_slots` slots in shared memory and the rest in `spill` /
// `spill_scal`; `pmatrix` is [M, C, R, R], each matrix transposed and
// zero-padded to the instance's R in {4, 8, 16, 64} (any_block.any_pt).
// It returns cudaGetLastError() (0 on success).
#define ANY_PARAMS                                                           \
  int states, int rate_cats, int tip_encoding, int scale_mode,              \
      int64_t sites, int n_ops, int n_inner, int pool, int shared_slots,    \
      const void *ops, const void *tips, const void *pmatrix, void *inner,  \
      int32_t *scalers, void *spill, int32_t *spill_scal,                   \
      const int32_t *edge, const void *weight_vec,                          \
      const void *pattern_weights, const void *inv_add, double *partials,   \
      void *stream
#define ANY_ARGS                                                             \
  states, rate_cats, tip_encoding, scale_mode, sites, n_ops, n_inner, pool, \
      shared_slots, ops, tips, pmatrix, inner, scalers, spill, spill_scal,  \
      edge, weight_vec, pattern_weights, inv_add, partials, stream

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
