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
// parent's row from its two children (the dots in K1's order, the
// products, the per-site or per-rate vote, the counters: clv_common.cuh's
// any_op); then by mode the sweep (K5) has written every local row to its
// inner row, a leaf segment (K6) copies the rows later segments import to
// its export rows, and the root segment (K6) folds the edge
// log-likelihood (any_edge_term's arithmetic: per-rate counters through
// the reference's min/cap fold, +I's inv_add), one float64 partial per 32
// sites in a warp's shuffle tree (the wrapper adds four into each 128-site
// partial).
//
// Design:
//  * A block is a tile of 32 sites, a lane a site and a warp a rate (past
//    eight rates a warp takes ceil(C/8) of them, rates w, w + W, ...), so
//    any C runs and a thread holds one rate's S values, not a site's C*S:
//    at GT16 a thread runs 512 multiply-adds an op, not 2 048, and a site
//    has four warps, not one lane.  A thread reads and writes only its own
//    (site, rate) column of the pool, and a site's counter only warp 0's
//    lane (per rate: the rate's warp), so a parent may take its child's
//    slot without a barrier.  The per-site vote spans the warps: each warp
//    votes (a ballot), one barrier per op that may scale shows the block
//    the votes (all_below's NaN rule per rate, AND across rates).  Where a
//    warp holds more than one rate it stores them unscaled and rescales
//    its columns when the site scales.
//  * The pool: the live local rows go where the host's slot plan
//    (clv_dyn.dyn_slot_plan) puts them: slots below `pool` in shared
//    memory laid out [slot, C*S, 32] values and [slot, srows, 32]
//    counters (a 16-state slot at four rates is 8.3 KB, a quarter of the
//    first design's 128-site slot), every other row spilled to device
//    memory (K6's scratch row slot - pool, K5's own output row).
//    clv_dyn.any_pool_cap sizes the pool so that 16 warps fit an SM: at
//    GT16 four blocks an SM with most rows spilled ran faster than two or
//    three with few, more warps gained nothing (PERF.md).
//  * Staging: a chunk of kChunk ops' descriptors is resolved into shared
//    memory (one thread an op: tip, import, pool slot or spill row) and
//    the chunk's tip codes are read in bulk, so an op waits on no chain of
//    dependent loads.  At S <= 16 the state loops run to a compile-time
//    bound R in {4, 8, 16} over whole padded matrices: the wrapper hands
//    the P-matrices transposed and zero-padded to [M, C, R, R]
//    (clv_dyn.any_kernel_pmatrix), each warp copies the matrices of its
//    next (op, rate) unit into its own two-entry ring in shared memory by
//    cp.async while it computes (a __syncwarp, no block barrier), and an
//    op runs k-outer: per k, a broadcast row of P^T and R independent
//    multiply-adds, each dot still in K1's order (product at k = 0, then
//    fma up; the zero padding adds 0 * 0 to a value, which changes no bit
//    of a nonzero sum).  At S > 16 (R = 64) a
//    rate's row loop stays a loop, as in clv_any.cu, or nvcc takes
//    minutes, and the padded rows (clv_fused.pad_rows) are read as vectors
//    through L1: at 61 states one rate's matrix is 15.6 KB.
//  * Pattern tips are decoded bit by bit from the tree's packed tip words
//    (chars: a nibble; masks: up to 31 states).
//  * The block's device pieces (the cp.async ring, contract_t, the tip-code
//    staging, the vote) are any_warp.cuh's, shared with K1/K2's
//    clv_any.cu, in forms that leave this kernel's SASS as it was.
//
// What bounds it: operations, 2 C S^2 multiply-adds per op and site (at
// GT16, 10 240 taxa x 65 536 sites x 4 rates, float32: 2.75e12 flop,
// 41.1 ms at the FP32 peak) for K6; K5 writes every row and counter
// (9.1 GB at 4 096 x 8 192 GT16, 2.73 ms at 3.35 TB/s).  K6 runs at a
// fifth of its bound: by ablation (tools/dyn_any_ablations.json) most of
// its time is outside the multiply-adds (the rows' and the staged
// matrices' traffic, the per-op work), and reading P^T through L1 instead
// of the rings took 1.4 times as long.  Two sites a thread with half the
// states each (a P^T value feeding two multiply-adds) measured slower.
// PERF.md has the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "any_warp.cuh"

namespace {

constexpr int kFields = 6;  // parent, c1, c2, s1, s2, has_scaler

enum { MODE_SWEEP = 0, MODE_LEAF = 1, MODE_ROOT = 2 };

template <typename T>
struct DynAnyArgs {
  int mode;
  int states;
  int sp;  // R <= 16: R (P^T padded square); else a padded P-matrix row
  int rate_cats;
  int warps;  // W: warp w runs rates w, w + W, ...
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
  const T* pmatrix;            // R <= 16: [M, C, R, R] transposed, padded;
                               // else [M, C, S, sp] rows padded with zeros
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
__global__ void __launch_bounds__(kTileSites * kMaxWarps)
    dyn_any_kernel(const __grid_constant__ DynAnyArgs<T> a) {
  constexpr bool kStaged = R <= kAnyUnrolled;
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
  const bool sweep = a.mode == MODE_SWEEP;
  const bool code_tips = a.tip_encoding != TIP_CLV;
  const int srows = per_rate ? C : 1;
  const int loc0 = a.r_tip + a.r_imp, trash = loc0 + a.r_loc;
  const int64_t L = a.sites;
  const int64_t site = (int64_t)blockIdx.x * kTileSites + lane;
  const bool live = site < L;
  const int64_t n = live ? site : L - 1;  // loads past the end: clamped
  T* const pool = reinterpret_cast<T*>(smem);
  int32_t* const spool =
      reinterpret_cast<int32_t*>(pool + (size_t)a.pool * cs * kTileSites);
  // past the pool: the warps' rings, then (root) the edge fold's exchange
  unsigned char* const tail = reinterpret_cast<unsigned char*>(
      spool + (size_t)a.pool * srows * kTileSites);
  constexpr int kUnit = 2 * R * R;  // a unit: one rate's two matrices
  T* const ring = reinterpret_cast<T*>(tail) + (size_t)w * kDepth * kUnit;

  // local row l's values and counters (rate/row c): a pool slot, or a
  // device row
  auto home = [&](int l) -> RowAt<T> {
    const int slot = __ldg(a.slots + l);
    if (slot < a.pool)
      return RowAt<T>{pool + (size_t)slot * cs * kTileSites + lane,
                      kTileSites};
    const int64_t row = sweep ? l : slot - a.pool;
    return RowAt<T>{a.loc + row * cs * L + n, L};
  };
  auto home_scal = [&](int l) -> RowAt<int32_t> {
    const int slot = __ldg(a.slots + l);
    if (slot < a.pool)
      return RowAt<int32_t>{spool + (size_t)slot * srows * kTileSites + lane,
                            kTileSites};
    const int64_t row = sweep ? l : slot - a.pool;
    return RowAt<int32_t>{a.loc_scal + row * srows * L + n, L};
  };
  // any state row as a run-time variant (exports, the edge)
  auto any_row = [&](int r) -> AnyRow<T> {
    if (r >= trash) return AnyRow<T>{nullptr, 0, 0u, true};
    if (r < a.r_tip) {
      const int64_t g = __ldg(a.tip_globals + r);
      if (a.tip_encoding == TIP_CHARS)
        return AnyRow<T>{nullptr, 0,
                         ((uint32_t)__ldg(a.tip_words + (g >> 3) * L + n) >>
                          (4 * (g & 7))) & 0xFu,
                         true};
      if (a.tip_encoding == TIP_MASKS)
        return AnyRow<T>{nullptr, 0, (uint32_t)__ldg(a.tip_words + g * L + n),
                         true};
      return AnyRow<T>{a.tip_clv + g * cs * L + n, L, 0u, false};
    }
    if (r < loc0)
      return AnyRow<T>{
          a.src + (int64_t)__ldg(a.imp_rows + r - a.r_tip) * cs * L + n, L, 0u,
          false};
    const RowAt<T> h = home(r - loc0);
    return AnyRow<T>{h.p, h.stride, 0u, false};
  };
  // a scaler row's counter of rate/row cc: an import's, a local's, or the
  // zero dummy / trash row
  auto counter = [&](int sr, int cc) -> int {
    if (sr < a.r_imp)
      return a.src_scal[((int64_t)__ldg(a.imp_rows + sr) * srows + cc) * L +
                        n];
    if (sr < a.r_imp + a.r_loc) return home_scal(sr - a.r_imp)(0, cc, 1);
    return 0;
  };
  // a staged counter source's counter of rate/row cc
  auto staged_count = [&](int d, int cc) -> int {
    if (d < 0) return 0;
    const int v = index_of(d);
    if (kind_of(d) == K_POOL)
      return spool[((size_t)v * srows + cc) * kTileSites + lane];
    const int32_t* base = kind_of(d) == K_IMP ? a.src_scal : a.loc_scal;
    return base[((int64_t)v * srows + cc) * L + n];
  };
  // a staged child's values of rate c (0 past ns)
  auto child = [&](int d, uint32_t code, int c, T(&x)[R]) {
    const int kind = kind_of(d), v = index_of(d);
    if (kind == K_TIP && code_tips) {
      any_child<T, R>(CodeAt<T>{code}, c, ns, x);
      return;
    }
    RowAt<T> row;
    if (kind == K_POOL) {
      row = RowAt<T>{pool + (size_t)v * cs * kTileSites + lane, kTileSites};
    } else {
      const T* base = kind == K_TIP ? a.tip_clv : kind == K_IMP ? a.src : a.loc;
      row = RowAt<T>{base + (int64_t)v * cs * L + n, L};
    }
    any_child<T, R>(row, c, ns, x);
  };
  // a warp's unit u (op u / nq, its rate u % nq): the two matrices into
  // ring entry u % kDepth by cp.async, one group a unit (empty past the
  // table and for pad ops)
  auto prefetch = [&](int u) {
    if (u < a.r_loc * nq) {
      const int i = u / nq, c = w + (u - i * nq) * W;
      if (__ldg(a.table + i * kFields) < trash) {
        constexpr int kVec = Vec16<T>::n, kPer = R * R / kVec;
        T* dst = ring + (u % kDepth) * kUnit;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const T* src =
              a.pmatrix +
              ((int64_t)__ldg(a.m_ops + 2 * i + side) * C + c) * R * R;
          for (int v = lane; v < kPer; v += 32)
            cp_async16(dst + side * R * R + v * kVec, src + v * kVec);
        }
      }
    }
    cp_async_commit();
  };

  int vb = 0;  // the votes buffer; a barrier lies between two uses of one
  if constexpr (kStaged)
    for (int u = 0; u < kDepth - 1; ++u) prefetch(u);
  for (int base = 0; base < a.r_loc; base += kChunk) {
    const int cnt = min(kChunk, a.r_loc - base);
    __syncthreads();  // the previous chunk is done with what is staged
    if ((int)threadIdx.x < cnt) {  // resolve op base + t
      const int i = base + threadIdx.x;
      OpDesc& o = ops[threadIdx.x];
      const int32_t* op = a.table + i * kFields;
      const int p = __ldg(op);
      o.parent = -1;
      if (p < trash) {
        auto home_desc = [&](int l) {
          const int slot = __ldg(a.slots + l);
          return slot < a.pool ? desc(K_POOL, slot)
                               : desc(K_SPILL, sweep ? l : slot - a.pool);
        };
        o.parent = p - loc0;
        o.home = home_desc(p - loc0);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int row = __ldg(op + 1 + k);
          if (row < a.r_tip)
            o.c[k] = desc(K_TIP, __ldg(a.tip_globals + row));
          else if (row < loc0)
            o.c[k] = desc(K_IMP, __ldg(a.imp_rows + row - a.r_tip));
          else
            o.c[k] = home_desc(row - loc0);
          const int sr = __ldg(op + 3 + k);
          if (sr < a.r_imp)
            o.s[k] = desc(K_IMP, __ldg(a.imp_rows + sr));
          else if (sr < a.r_imp + a.r_loc)
            o.s[k] = home_desc(sr - a.r_imp);
          else
            o.s[k] = K_ZERO;  // the dummy or trash row
          o.m[k] = __ldg(a.m_ops + 2 * i + k);
        }
        o.has = __ldg(op + 5);
      }
    }
    __syncthreads();
    if (code_tips) {  // the chunk's tip codes at the tile's sites, in bulk
      stage_codes(
          ops, codes, cnt, L,
          [&](const OpDesc& o, int d) {
            return o.parent >= 0 && kind_of(d) == K_TIP;
          },
          [&](const OpDesc&, int, int d, int64_t s) {
            const int64_t g = index_of(d);
            return a.tip_encoding == TIP_CHARS
                       ? ((uint32_t)__ldg(a.tip_words + (g >> 3) * L + s) >>
                          (4 * (g & 7))) & 0xFu
                       : (uint32_t)__ldg(a.tip_words + g * L + s);
          });
      __syncthreads();
    }
    for (int j = 0; j < cnt; ++j) {
      const OpDesc o = ops[j];
      const int i = base + j;
      const bool real = o.parent >= 0, may = o.has != 0;
      const bool pooled = kind_of(o.home) == K_POOL;
      const int hv = index_of(o.home);
      // the parent's device row (K5's output row, or K6's spill row)
      const int64_t drow = sweep ? o.parent : hv;
      // the parent's value (c, jj): to its pool slot and/or its device row
      auto put = [&](int c, int jj, T v) {
        if (pooled)
          pool[((size_t)hv * cs + c * ns + jj) * kTileSites + lane] = v;
        if ((sweep || !pooled) && live)
          a.loc[(drow * cs + c * ns + jj) * L + n] = v;
      };
      auto put_count = [&](int cc, int v) {
        if (pooled) spool[((size_t)hv * srows + cc) * kTileSites + lane] = v;
        if ((sweep || !pooled) && live)
          a.loc_scal[(drow * srows + cc) * L + n] = v;
      };
      // per site with one rate a warp: the products wait in registers for
      // the vote
      const bool hold = per_site && may && nq == 1;
      bool site_below = true;
      T t[R];
      for (int q = 0; q < nq; ++q) {
        const int c = w + q * W;
        const T* pm = nullptr;  // the unit's staged P^T pair (R <= 16)
        if constexpr (kStaged) {
          const int u = i * nq + q;
          __syncwarp();  // the ring entry refilled below is free
          prefetch(u + kDepth - 1);
          cp_async_wait_ring();
          __syncwarp();  // unit u has landed for the whole warp
          pm = ring + (u % kDepth) * kUnit;
        }
        if (!real) continue;
        T x[R];
        child(o.c[0], codes[j][0][lane], c, x);
        if constexpr (kStaged) {
          T t2[R];
          contract_t<T, R, false>(pm, x, t);
          child(o.c[1], codes[j][1][lane], c, x);
          contract_t<T, R, false>(pm + R * R, x, t2);
#pragma unroll
          for (int jj = 0; jj < R; ++jj) t[jj] *= t2[jj];
        } else {
          const int64_t m = (int64_t)c * ns * a.sp;
          contract_any<T, R, false>(a.pmatrix + o.m[0] * (int64_t)cs * a.sp + m,
                                    ns, a.sp, x, t);
          child(o.c[1], codes[j][1][lane], c, x);
          contract_any<T, R, true>(a.pmatrix + o.m[1] * (int64_t)cs * a.sp + m,
                                   ns, a.sp, x, t);
        }
        bool below = may;
        each_state<R>(ns, [&](int jj) { below &= t[jj] < a.u.thresh; });
        if (per_rate) {
          if (below) each_state<R>(ns, [&](int jj) { t[jj] *= a.u.factor; });
          put_count(c, staged_count(o.s[0], c) + staged_count(o.s[1], c) +
                           (int)below);
        }
        site_below &= below;
        if (!hold) each_state<R>(ns, [&](int jj) { put(c, jj, t[jj]); });
      }
      if (!real) continue;
      if (per_site) {
        bool scale = false;
        if (may) {  // the site's vote across the warps
          scale = site_vote_warps(site_below, votes, vb, W, w, lane);
          vb ^= 1;
        }
        if (hold) {
          if (scale) each_state<R>(ns, [&](int jj) { t[jj] *= a.u.factor; });
          each_state<R>(ns, [&](int jj) { put(w, jj, t[jj]); });
        } else if (scale) {  // rescale the warp's stored rates
          for (int q = 0; q < nq; ++q) {
            const int c = w + q * W;
            for (int jj = 0; jj < ns; ++jj) {
              if (pooled) {
                T& v =
                    pool[((size_t)hv * cs + c * ns + jj) * kTileSites + lane];
                v = v * a.u.factor;
              }
              if ((sweep || !pooled) && live) {
                T& v = a.loc[(drow * cs + c * ns + jj) * L + n];
                v = v * a.u.factor;
              }
            }
          }
        }
        if (w == 0)
          put_count(0, staged_count(o.s[0], 0) + staged_count(o.s[1], 0) +
                           (int)scale);
      } else if (!counts && sweep && w == 0) {
        put_count(0, 0);  // K5's counters without scaling
      }
    }
  }
  if (a.mode == MODE_LEAF) {
    for (int e = 0; e < a.r_exp; ++e) {
      const int st = __ldg(a.exp_table + 2 * e);
      if (st >= trash) continue;  // a pad entry
      const AnyRow<T> x = any_row(st);
      const int sr = __ldg(a.exp_table + 2 * e + 1);
      for (int q = 0; q < nq; ++q) {
        const int c = w + q * W;
        T* dst = a.exports + ((int64_t)e * cs + c * ns) * L + n;
        for (int jj = 0; jj < ns; ++jj) {
          const T v = x(c, jj, ns);
          if (live) dst[(int64_t)jj * L] = v;
        }
      }
      // the counters: per rate each rate's warp, per site warp 0
      for (int q = 0; q < (per_rate ? nq : w == 0); ++q) {
        const int cc = per_rate ? w + q * W : 0;
        const int v = counts ? counter(sr, cc) : 0;
        if (live) a.export_scal[((int64_t)e * srows + cc) * L + n] = v;
      }
    }
  }
  if (a.mode == MODE_ROOT) {
    if constexpr (kStaged) cp_async_wait_all();
    __syncthreads();  // the exchange takes the rings' place
    T* const term_s = reinterpret_cast<T*>(tail);  // [C, 32]
    int* const sn_s = reinterpret_cast<int*>(term_s + (size_t)C * kTileSites);
    const AnyRow<T> par = any_row(__ldg(a.edge + 0));
    const AnyRow<T> ch = any_row(__ldg(a.edge + 1));
    const int sp_row = __ldg(a.edge + 2), sc_row = __ldg(a.edge + 3);
    const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * C * (kStaged
        ? (int64_t)R * R : (int64_t)ns * a.sp);
    for (int q = 0; q < nq; ++q) {
      const int c = w + q * W;
      T x[R], tb[R];
      any_child<T, R>(ch, c, ns, x);
      if constexpr (kStaged)
        contract_t<T, R, true>(pe + (int64_t)c * R * R, x, tb);
      else
        contract_any<T, R, false>(pe + (int64_t)c * ns * a.sp, ns, a.sp, x, tb);
      T tc = 0;
      each_state<R>(ns, [&](int jj) {
        tc = dev_fma(par(c, jj, ns) * tb[jj], __ldg(a.weight_vec + c * ns + jj),
                     tc);
      });
      term_s[c * kTileSites + lane] = tc;
      if (per_rate) sn_s[c * kTileSites + lane] =
          counter(sp_row, c) + counter(sc_row, c);
    }
    __syncthreads();
    if (w == 0) {
      // the site's counter: per site the node's, per rate the minimum; each
      // rate's term times 2^-bits once per count above it, at most
      // kRateMaxDiff times; rates summed in order
      int snum = 0;
      if (per_rate) {
        for (int c = 0; c < C; ++c) {
          const int s = sn_s[c * kTileSites + lane];
          snum = (c == 0 || s < snum) ? s : snum;
        }
      } else if (counts) {
        snum = counter(sp_row, 0) + counter(sc_row, 0);
      }
      T term = 0;
      for (int c = 0; c < C; ++c) {
        T tc = term_s[c * kTileSites + lane];
        if (per_rate) {
          const int diff =
              min(sn_s[c * kTileSites + lane] - snum, kRateMaxDiff);
          for (int k = 0; k < diff; ++k) tc *= a.u.thresh;
        }
        term += tc;
      }
      double lnl = 0.0;  // past-the-end sites add 0
      if (live) {
        if (a.inv_add != nullptr) term += __ldg(a.inv_add + n);
        lnl = (double)site_lnl<T>(term, snum, a.u,
                                  __ldg(a.pattern_weights + n));
      }
      warp_sum_store(lnl, a.partials, blockIdx.x, a.n_groups);
    }
  }
}

template <typename T, int R>
int launch(const DynAnyArgs<T>& a, cudaStream_t st) {
  auto kernel = dyn_any_kernel<T, R>;
  const int srows = a.scale_mode == SCALE_PER_RATE ? a.rate_cats : 1;
  const size_t slot = (size_t)kTileSites *
                      ((size_t)a.rate_cats * a.states * sizeof(T) +
                       (size_t)srows * sizeof(int32_t));
  const size_t ring = R <= kAnyUnrolled
                          ? (size_t)a.warps * kDepth * 2 * R * R * sizeof(T)
                          : 0;
  const size_t exchange =
      a.mode == MODE_ROOT
          ? (size_t)a.rate_cats * kTileSites * (sizeof(T) + sizeof(int32_t))
          : 0;
  const size_t smem = a.pool * slot + (ring > exchange ? ring : exchange);
  // above 48 KB only after raising the kernel's limit; a pool the card
  // cannot hold makes this call fail, and nothing is launched
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((a.sites + kTileSites - 1) / kTileSites);
  kernel<<<blocks, kTileSites * a.warps, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int segment(int mode, int states, int sp, int rate_cats, int tip_encoding,
            int scale_mode, int64_t sites, int r_tip, int r_imp, int r_loc,
            int r_exp, int pool, const int32_t* table,
            const int32_t* m_ops, const int32_t* tip_globals,
            const int32_t* imp_rows, const int32_t* slots, const void* tips,
            const void* pmatrix, const void* src, const int32_t* src_scal,
            void* loc, int32_t* loc_scal, const int32_t* exp_table,
            void* exports, int32_t* export_scal, const int32_t* edge,
            const void* weight_vec, const void* pattern_weights,
            const void* inv_add, double* partials, int64_t n_groups,
            void* stream) {
  const int R = states >= 2 && states <= kAnyMaxStates ? any_bound(states)
                                                       : 0;
  const bool staged = R <= kAnyUnrolled;
  if (R == 0 || rate_cats < 1 || sites < 1 || pool < 0 ||
      (staged ? sp != R
              : sp < states || sp % Vec16<T>::n || sp > kAnyMaxStates) ||
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
  a.warps = any_warps(rate_cats);
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
  switch (R) {
    case 4: return launch<T, 4>(a, st);
    case 8: return launch<T, 8>(a, st);
    case 16: return launch<T, 16>(a, st);
    default: return launch<T, kAnyMaxStates>(a, st);
  }
}

}  // namespace

// Plain C interface for ctypes: one segment's launch on `stream`, with
// clv_dyn.py's pool of `pool` shared slots a block of 32 sites.
// `pmatrix`: at S <= 16 [M, C, R, R], each matrix transposed and
// zero-padded to the instance's R in {4, 8, 16} (sp = R); else
// [M, C, S, sp], each row padded with zeros to `sp` (a multiple of 16
// bytes, at most 64 values).  `partials` holds `n_groups` float64
// partials, one per 32 sites.  Returns cudaGetLastError() (0 on success).
#define SEGMENT_PARAMS                                                       \
  int mode, int states, int sp, int rate_cats, int tip_encoding,            \
      int scale_mode, int64_t sites, int r_tip, int r_imp, int r_loc,       \
      int r_exp, int pool, const int32_t *table,                            \
      const int32_t *m_ops, const int32_t *tip_globals,                     \
      const int32_t *imp_rows, const int32_t *slots, const void *tips,      \
      const void *pmatrix, const void *src, const int32_t *src_scal,        \
      void *loc, int32_t *loc_scal, const int32_t *exp_table,               \
      void *exports, int32_t *export_scal, const int32_t *edge,             \
      const void *weight_vec, const void *pattern_weights,                  \
      const void *inv_add, double *partials, int64_t n_groups, void *stream
#define SEGMENT_ARGS                                                         \
  mode, states, sp, rate_cats, tip_encoding, scale_mode, sites, r_tip,      \
      r_imp, r_loc, r_exp, pool, table, m_ops, tip_globals,                 \
      imp_rows, slots, tips, pmatrix, src, src_scal, loc, loc_scal,         \
      exp_table, exports, export_scal, edge, weight_vec, pattern_weights,   \
      inv_add, partials, n_groups, stream

extern "C" int clv_dyn_any_segment_f32(SEGMENT_PARAMS) {
  return segment<float>(SEGMENT_ARGS);
}
extern "C" int clv_dyn_any_segment_f64(SEGMENT_PARAMS) {
  return segment<double>(SEGMENT_ARGS);
}
extern "C" const char* clv_dyn_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
