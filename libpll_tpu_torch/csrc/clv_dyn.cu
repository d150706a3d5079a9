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
//     does (src/core_likelihood.c:916-941); one float64 partial per 32
//     sites, the sum of one warp's worth of sites in a warp's shuffle tree
//     (the wrapper adds four of them into each 128-site partial).
//
// Design on this card, and what was decided:
//  * The TPU kernel kept a whole segment's rows in VMEM (10 MB).  An H100
//    block has 227 KB of shared memory, less than one site's rows of a
//    useful segment, but only a few rows of a segment are live at once: a
//    row lives from its op to its last reader (13 at most at 10 240 taxa,
//    19 in the one 4 094-row segment at 4 096 taxa).  The host plans a slot
//    for each local row (clv_dyn.dyn_slot_plan, first fit in op order, one
//    int32 per row, data like the op table).  A block keeps a pool of P
//    slots in dynamic shared memory laid out [slot, S, 32*C], one column
//    per (site, rate) thread, and their counters [slot, 32] (per rate
//    [slot, 32*C]).  A row whose slot is P or above is a spill: K6 keeps it
//    in device scratch row slot - P (allocated only when a row spills), K5
//    reads it back from its output row.  P is each segment's peak up to
//    what leaves two blocks per SM (clv_dyn.pool_cap): DNA float32 never
//    spills; protein and float64 spill when their peak is higher.
//  * A block is a tile of 32 sites run by 32*C threads, one per (site,
//    rate): warp c runs rate c of the 32 sites, so 4 096 x 8 192 runs 256
//    blocks, not 64, and every P-matrix row a warp reads is one address
//    (a broadcast; protein's rows from L1/L2 gained most).  A thread
//    touches only its own column of the pool, and a site's counter (one
//    per node) only warp 0's lane, so a parent may take its child's slot
//    without a barrier.  The per-site scaling test needs the site's C
//    rates: each warp votes, and one block barrier per scaled op shows the
//    votes to all.  The edge fold gathers a site's C terms through shared
//    memory and sums them in rate order.
//  * Ops are staged kChunk at a time: one thread per op resolves its row
//    numbers (tip, import, pool slot or spill) into shared memory, then the
//    block reads the chunk's tip codes and, for DNA, its P-matrices
//    (16-byte vectors) into shared memory in bulk.  An op then waits on no
//    device-memory load: without staging each op waited on a chain of
//    dependent loads (table, tip id, tip word) and on its P rows from L2.
//  * The arithmetic of every value is the first port's (dot in K1's order,
//    products, scaling by exact powers of two), so the float32 results are
//    the same bits.  Partials are summed per 32-site tile in a warp's
//    shuffle tree, and the wrapper adds four into each 128-site partial in
//    order, as the first port's block sum did: the logL is bit for bit the
//    same.
//  * Imports are read where they lie (K5: earlier segments' inner rows;
//    K6: earlier segments' export rows) through one index per import slot,
//    and tips from the tree's one packed tip array by global id.  K6
//    leaves write only their export rows to device memory, the root only
//    its partials; K5 writes every row and counter (its output).
//  * Pad ops (parent = trash row) and pad export entries are skipped.
//    Mode, tip encoding, scale mode and +I are block-uniform runtime
//    branches; the template is over the dtype and S in {4, 20}.
//
// What bounds it: with the rows on chip, K6 at 10 240 taxa x 2^20 sites
// moves 6-43 GB (tip words, exports) against 2.40e12 flop of contraction
// (35.9 ms at the FP32 peak), so its roofline is the contraction; the
// kernel stays far above it, held by the work around each op (per (site,
// rate) and op, several times as many issued instructions as its 36
// multiply-adds: descriptor and tip decode, counters, the vote, pool
// stores) and by the shared-memory reads of the P rows.  Other mappings
// (a site's rates in one warp, two sites or four rates per thread) were
// measured and lost at one size or another (PERF.md).  K5 writes every
// row and counter: 2.70 GB at 4 096 x 8 192 per rate (0.81 ms at
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
  int pool;                    // P: slots in shared memory
  const int32_t* table;        // [r_loc, kFields]
  const int32_t* m_ops;        // [r_loc, 2]
  const int32_t* tip_globals;  // [r_tip]: global tip id of each tip row
  const int32_t* imp_rows;     // [r_imp]: row of each import in src
  const int32_t* slots;        // [r_loc]: the slot of each local row
  const T* tip_clv;            // [tips, C*S, sites]             ("clv")
  const int32_t* tip_words;    // [ceil(tips/8) or tips, sites]
  const T* pmatrix;            // [M, C, S, S]
  const T* src;                // import rows [*, C*S, sites]
  const int32_t* src_scal;     // their counters [* x srows, sites]
  T* loc;                      // sweep: the segment's inner rows (every
                               // local's output); else the spill scratch
                               // [*, C*S, sites], row slot - P
  int32_t* loc_scal;           // their counters [* x srows, sites]
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

// Value 0 of the thread's rate of device row `row` (rows [*, C*S, sites]);
// value e is e * sites further.
template <typename T, int S>
__device__ __forceinline__ int64_t at(const DynArgs<T>& a, const Lane& ln,
                                      int64_t row) {
  return (row * a.rate_cats + ln.c) * S * a.sites + ln.site;
}

// Where local row l lives: its pool slot (< P), or its device row in loc.
struct Home {
  bool pooled;
  int index;
};

template <typename T>
__device__ __forceinline__ Home home(const DynArgs<T>& a, int l) {
  const int slot = __ldg(a.slots + l);
  if (slot < a.pool) return {true, slot};
  return {false, a.mode == MODE_SWEEP ? l : slot - a.pool};
}

// The thread's S values of a row named by its state-row number (the
// exports and the edge).  Rows this launch writes are read with plain
// loads (not the read-only path).
template <typename T, int S>
__device__ __forceinline__ void load_state_row(const DynArgs<T>& a,
                                               const Pool<T>& pl,
                                               const Lane& ln, int row,
                                               T (&x)[S]) {
  const T* p;
  if (row < a.r_tip) {
    const int64_t g = __ldg(a.tip_globals + row);
    if (a.tip_encoding != TIP_CLV) {
      const uint32_t code =
          a.tip_encoding == TIP_CHARS
              ? ((uint32_t)__ldg(a.tip_words + (g >> 3) * a.sites + ln.site) >>
                 (4 * (g & 7))) & 0xFu
              : (uint32_t)__ldg(a.tip_words + g * a.sites + ln.site);
#pragma unroll
      for (int e = 0; e < S; ++e) x[e] = (T)((code >> e) & 1u);
      return;
    }
    p = a.tip_clv + at<T, S>(a, ln, g);
  } else if (row < a.r_tip + a.r_imp) {
    p = a.src + at<T, S>(a, ln, __ldg(a.imp_rows + row - a.r_tip));
  } else {
    const Home h = home(a, row - a.r_tip - a.r_imp);
    if (h.pooled) {
#pragma unroll
      for (int e = 0; e < S; ++e)
        x[e] = pl.clv[pool_at<S>(h.index, pl.nt) + e * pl.nt];
      return;
    }
    p = a.loc + at<T, S>(a, ln, h.index);
  }
#pragma unroll
  for (int e = 0; e < S; ++e) x[e] = p[e * a.sites];
}

// The thread's counter of scaler row `srow`.
template <typename T>
__device__ __forceinline__ int count(const DynArgs<T>& a, const Pool<T>& pl,
                                     const Lane& ln, int srow) {
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int srows = per_rate ? a.rate_cats : 1;
  const int cc = per_rate ? ln.c : 0;
  if (srow < a.r_imp)
    return a.src_scal[((int64_t)__ldg(a.imp_rows + srow) * srows + cc) *
                          a.sites + ln.site];
  const int l = srow - a.r_imp;
  if (l >= a.r_loc) return 0;  // the dummy row
  const Home h = home(a, l);
  if (h.pooled) return pl.scal[scal_at(per_rate, h.index, ln, pl.sstride)];
  return a.loc_scal[((int64_t)h.index * srows + cc) * a.sites + ln.site];
}

template <typename T>
__device__ __forceinline__ int home_desc(const DynArgs<T>& a, int l) {
  const Home h = home(a, l);
  return desc(h.pooled ? K_POOL : K_SPILL, h.index);
}

// Resolve op i of the table (one thread per op).
template <typename T>
__device__ void stage_op(const DynArgs<T>& a, int i, OpDesc& o) {
  const int loc0 = a.r_tip + a.r_imp;
  const int32_t* op = a.table + i * kFields;
  const int p = __ldg(op);
  o.parent = -1;
  if (p >= loc0 + a.r_loc) return;  // a pad op
  o.parent = p - loc0;
  o.home = home_desc(a, p - loc0);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = __ldg(op + 1 + k);
    if (row < a.r_tip)
      o.c[k] = desc(K_TIP, __ldg(a.tip_globals + row));
    else if (row < loc0)
      o.c[k] = desc(K_IMP, __ldg(a.imp_rows + row - a.r_tip));
    else
      o.c[k] = home_desc(a, row - loc0);
    const int srow = __ldg(op + 3 + k);
    if (srow < a.r_imp)
      o.s[k] = desc(K_IMP, __ldg(a.imp_rows + srow));
    else if (srow < a.r_imp + a.r_loc)
      o.s[k] = home_desc(a, srow - a.r_imp);
    else
      o.s[k] = K_ZERO;  // the dummy or trash row
    o.m[k] = __ldg(a.m_ops + 2 * i + k);
  }
  o.has = __ldg(op + 5);
}

// The pattern codes of a chunk's tip children at the tile's sites, read
// in bulk (consecutive threads, consecutive sites; kBatch loads in flight
// per thread) so that no op waits on a tip load.
template <typename T>
__device__ void stage_codes(const DynArgs<T>& a, const OpDesc* ops, int n,
                            uint32_t (*codes)[2][kTileSites]) {
  constexpr int kBatch = 8;
  const int64_t tile = (int64_t)blockIdx.x * kTileSites;
  const int total = n * 2 * kTileSites;
  for (int it0 = threadIdx.x; it0 < total; it0 += kBatch * blockDim.x) {
    uint32_t w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * blockDim.x;
      w[u] = 0;
      if (it >= total) continue;
      const int d = ops[it / (2 * kTileSites)].c[(it / kTileSites) & 1];
      if (ops[it / (2 * kTileSites)].parent < 0 || kind_of(d) != K_TIP)
        continue;
      const int64_t g = index_of(d);
      const int64_t site = tile + it % kTileSites;
      const int64_t s = site < a.sites ? site : a.sites - 1;
      if (a.tip_encoding == TIP_CHARS)
        w[u] = ((uint32_t)__ldg(a.tip_words + (g >> 3) * a.sites + s) >>
                (4 * (g & 7))) & 0xFu;
      else
        w[u] = (uint32_t)__ldg(a.tip_words + g * a.sites + s);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * blockDim.x;
      if (it < total)
        codes[it / (2 * kTileSites)][(it / kTileSites) & 1]
             [it % kTileSites] = w[u];
    }
  }
}

// A staged child's S values for this thread (code: its staged tip code).
template <typename T, int S>
__device__ __forceinline__ void load_child(const DynArgs<T>& a,
                                           const Pool<T>& pl, const Lane& ln,
                                           int d, uint32_t code, T (&x)[S]) {
  const int kind = kind_of(d);
  const int v = index_of(d);
  if (kind == K_POOL) {
#pragma unroll
    for (int e = 0; e < S; ++e) x[e] = pl.clv[pool_at<S>(v, pl.nt) + e * pl.nt];
    return;
  }
  if (kind == K_TIP && a.tip_encoding != TIP_CLV) {
#pragma unroll
    for (int e = 0; e < S; ++e) x[e] = (T)((code >> e) & 1u);
    return;
  }
  const T* base = kind == K_TIP ? a.tip_clv : kind == K_IMP ? a.src : a.loc;
  const T* p = base + at<T, S>(a, ln, v);
#pragma unroll
  for (int e = 0; e < S; ++e) x[e] = p[e * a.sites];
}

// The thread's counter from a staged counter source.
template <typename T>
__device__ __forceinline__ int staged_count(const DynArgs<T>& a,
                                            const Pool<T>& pl,
                                            const Lane& ln, int d) {
  if (d < 0) return 0;
  const int kind = kind_of(d);
  const int v = index_of(d);
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  if (kind == K_POOL) return pl.scal[scal_at(per_rate, v, ln, pl.sstride)];
  const int64_t row = per_rate ? (int64_t)v * a.rate_cats + ln.c : v;
  const int32_t* base = kind == K_IMP ? a.src_scal : a.loc_scal;
  return base[row * a.sites + ln.site];
}

// Store the thread's values and counter of local row l at its home (a
// pool slot, or device row `index` of loc), and under sweep also at its
// output row l.
template <typename T, int S>
__device__ __forceinline__ void store_local(const DynArgs<T>& a,
                                            const Pool<T>& pl, const Lane& ln,
                                            int l, bool pooled, int index,
                                            const T (&t)[S], int cnt) {
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  if (pooled) {
#pragma unroll
    for (int e = 0; e < S; ++e)
      pl.clv[pool_at<S>(index, pl.nt) + e * pl.nt] = t[e];
    if (per_rate || ln.c == 0)
      pl.scal[scal_at(per_rate, index, ln, pl.sstride)] = cnt;
  }
  if ((a.mode == MODE_SWEEP || !pooled) && ln.live) {
    const int64_t row = a.mode == MODE_SWEEP ? l : index;
    T* out = a.loc + at<T, S>(a, ln, row);
#pragma unroll
    for (int e = 0; e < S; ++e) out[e * a.sites] = t[e];
    if (per_rate)
      a.loc_scal[(row * a.rate_cats + ln.c) * a.sites + ln.site] = cnt;
    else if (ln.c == 0)
      a.loc_scal[row * a.sites + ln.site] = cnt;
  }
}

// Every thread runs every op, past-the-end sites included (their loads
// clamped, their device stores skipped): the votes need whole warps.  A
// thread reads and writes only its own column of the pool (a site's
// counter: warp 0's lane), so ops need no barrier but the per-site vote's.
template <typename T, int S>
__device__ void run_ops(const DynArgs<T>& a, const Pool<T>& pl,
                        const Lane& ln, OpDesc* ops,
                        uint32_t (*codes)[2][kTileSites]) {
  __shared__ unsigned votes[2][kMaxRates];
  const int C = a.rate_cats;
  const int64_t pm_size = (int64_t)C * S * S;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool counts = per_rate || ln.c == 0;  // warp-uniform
  int vb = 0;  // the votes buffer; a barrier lies between two uses of one
  for (int base = 0; base < a.r_loc; base += kChunk) {
    const int n = min(kChunk, a.r_loc - base);
    __syncthreads();  // the previous chunk is done with what is staged
    if ((int)threadIdx.x < n) stage_op(a, base + threadIdx.x, ops[threadIdx.x]);
    __syncthreads();
    if (a.tip_encoding != TIP_CLV) stage_codes(a, ops, n, codes);
    if (pl.pm != nullptr)
      stage_pmatrices<T, S>(a.pmatrix, a.rate_cats, ops, n, pl.pm);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const OpDesc o = ops[j];
      if (o.parent < 0) continue;  // a pad op
      int cnt = counts ? staged_count(a, pl, ln, o.s[0]) +
                             staged_count(a, pl, ln, o.s[1])
                       : 0;
      T x1[S], x2[S], t[S];
      load_child<T, S>(a, pl, ln, o.c[0], codes[j][0][ln.sl], x1);
      load_child<T, S>(a, pl, ln, o.c[1], codes[j][1][ln.sl], x2);
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
      store_local<T, S>(a, pl, ln, o.parent, kind_of(o.home) == K_POOL,
                        index_of(o.home), t, cnt);
    }
  }
}

// Leaf: copy the rows later segments import into this segment's exports.
template <typename T, int S>
__device__ void export_rows(const DynArgs<T>& a, const Pool<T>& pl,
                            const Lane& ln) {
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int trash = a.r_tip + a.r_imp + a.r_loc;
  for (int e = 0; e < a.r_exp; ++e) {
    const int st = __ldg(a.exp_table + 2 * e);
    if (st >= trash) continue;  // a pad entry
    T x[S];
    load_state_row<T, S>(a, pl, ln, st, x);
    const int cnt = count(a, pl, ln, __ldg(a.exp_table + 2 * e + 1));
    if (!ln.live) continue;
    T* out = a.exports + ((int64_t)e * a.rate_cats + ln.c) * S * a.sites +
             ln.site;
#pragma unroll
    for (int s = 0; s < S; ++s) out[s * a.sites] = x[s];
    if (per_rate)
      a.export_scal[((int64_t)e * a.rate_cats + ln.c) * a.sites + ln.site] =
          cnt;
    else if (ln.c == 0)
      a.export_scal[(int64_t)e * a.sites + ln.site] = cnt;
  }
}

// Root: the weighted log-likelihood of the thread's site across the
// evaluation edge (the same value in every thread of the site).
template <typename T, int S>
__device__ T edge_site_lnl(const DynArgs<T>& a, const Pool<T>& pl,
                           const Lane& ln, void* exchange) {
  const int C = a.rate_cats;
  T pv[S], x[S];
  load_state_row<T, S>(a, pl, ln, __ldg(a.edge + 0), pv);
  load_state_row<T, S>(a, pl, ln, __ldg(a.edge + 1), x);
  const T* pe = a.pmatrix + (int64_t)__ldg(a.edge + 4) * C * S * S;
  const T mine = edge_rate_term<T, S>(pe, ln.c, pv, x, a.weight_vec);
  const int my_sn =
      count(a, pl, ln, __ldg(a.edge + 2)) + count(a, pl, ln, __ldg(a.edge + 3));
  // every thread gathers its site's terms and counters, rate by rate,
  // from the C warps through shared memory
  T* term_s = static_cast<T*>(exchange);              // [C, 32]
  int* sn_s = reinterpret_cast<int*>(term_s + C * kTileSites);
  term_s[threadIdx.x] = mine;
  sn_s[threadIdx.x] = my_sn;
  __syncthreads();
  int snum;
  T term = site_term<T>(term_s, sn_s, C, ln,
                        a.scale_mode == SCALE_PER_RATE, a.u.thresh, snum);
  if (a.inv_add != nullptr) term += __ldg(a.inv_add + ln.site);
  return site_lnl<T>(term, snum, a.u, __ldg(a.pattern_weights + ln.site));
}

template <typename T, int S>
__global__ void __launch_bounds__(kTileSites * kMaxRates)
    dyn_kernel(DynArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ OpDesc ops[kChunk];
  // the staged tip codes; after the ops, the edge fold's exchange
  __shared__ __align__(16) uint32_t codes[kChunk][2][kTileSites];
  static_assert(sizeof(codes) >= kMaxRates * kTileSites * (sizeof(T) + 4),
                "the edge fold's exchange fits the codes' buffer");
  const int C = a.rate_cats;
  Lane ln;
  ln.c = threadIdx.x / kTileSites;
  ln.sl = threadIdx.x % kTileSites;
  const int64_t site = (int64_t)blockIdx.x * kTileSites + ln.sl;
  ln.live = site < a.sites;
  ln.site = ln.live ? site : a.sites - 1;
  Pool<T> pl;
  pl.nt = kTileSites * C;
  pl.sstride = a.scale_mode == SCALE_PER_RATE ? pl.nt : kTileSites;
  pl.clv = reinterpret_cast<T*>(smem);
  pl.scal = reinterpret_cast<int32_t*>(pl.clv + a.pool * S * pl.nt);
  pl.pm = kStagePm<S> ? reinterpret_cast<T*>(pl.scal + a.pool * pl.sstride)
                      : nullptr;

  run_ops<T, S>(a, pl, ln, ops, codes);
  // the last ops' counters (warp 0's) are read by every warp below, and
  // the codes' buffer is taken for the edge fold
  __syncthreads();
  if (a.mode == MODE_LEAF) {
    export_rows<T, S>(a, pl, ln);
  } else if (a.mode == MODE_ROOT) {
    // past-the-end sites add 0
    const double lnl = (double)edge_site_lnl<T, S>(a, pl, ln, codes);
    tile_sum_store(ln.live ? lnl : 0.0, a.partials);
  }
}

template <typename T, int S>
int launch(const DynArgs<T>& a, cudaStream_t st) {
  const int threads = kTileSites * a.rate_cats;
  const int counters =
      a.scale_mode == SCALE_PER_RATE ? threads : kTileSites;
  const size_t smem =
      (size_t)a.pool * ((size_t)S * threads * sizeof(T) +
                        (size_t)counters * sizeof(int32_t)) +
      (kStagePm<S> ? (size_t)kChunk * 2 * a.rate_cats * S * S * sizeof(T)
                   : 0);
  // above 48 KB only after raising the kernel's limit; a pool the card
  // cannot hold makes this call fail, and nothing is launched
  cudaError_t err = cudaFuncSetAttribute(
      dyn_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((a.sites + kTileSites - 1) / kTileSites);
  dyn_kernel<T, S><<<blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int segment(int mode, int states, int rate_cats, int tip_encoding,
            int scale_mode, int64_t sites, int r_tip, int r_imp, int r_loc,
            int r_exp, int pool, const int32_t* table, const int32_t* m_ops,
            const int32_t* tip_globals, const int32_t* imp_rows,
            const int32_t* slots, const void* tips, const void* pmatrix,
            const void* src, const int32_t* src_scal, void* loc,
            int32_t* loc_scal, const int32_t* exp_table, void* exports,
            int32_t* export_scal, const int32_t* edge,
            const void* weight_vec, const void* pattern_weights,
            const void* inv_add, double* partials, void* stream) {
  // the lanes of a site share a warp: C must divide 32
  if (rate_cats < 1 || rate_cats > kMaxRates || (32 % rate_cats) != 0 ||
      pool < 0)
    return (int)cudaErrorInvalidValue;
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

#define SEGMENT_PARAMS                                                       \
  int mode, int states, int rate_cats, int tip_encoding, int scale_mode,    \
      int64_t sites, int r_tip, int r_imp, int r_loc, int r_exp, int pool,  \
      const int32_t *table, const int32_t *m_ops,                           \
      const int32_t *tip_globals, const int32_t *imp_rows,                  \
      const int32_t *slots, const void *tips, const void *pmatrix,          \
      const void *src, const int32_t *src_scal, void *loc,                  \
      int32_t *loc_scal, const int32_t *exp_table, void *exports,           \
      int32_t *export_scal, const int32_t *edge, const void *weight_vec,    \
      const void *pattern_weights, const void *inv_add, double *partials,   \
      void *stream
#define SEGMENT_ARGS                                                         \
  mode, states, rate_cats, tip_encoding, scale_mode, sites, r_tip, r_imp,   \
      r_loc, r_exp, pool, table, m_ops, tip_globals, imp_rows, slots, tips, \
      pmatrix, src, src_scal, loc, loc_scal, exp_table, exports,            \
      export_scal, edge, weight_vec, pattern_weights, inv_add, partials,    \
      stream

extern "C" int clv_dyn_segment_f32(SEGMENT_PARAMS) {
  return segment<float>(SEGMENT_ARGS);
}
extern "C" int clv_dyn_segment_f64(SEGMENT_PARAMS) {
  return segment<double>(SEGMENT_ARGS);
}
extern "C" const char* clv_dyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
