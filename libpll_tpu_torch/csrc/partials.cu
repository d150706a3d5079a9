// Op-table replay for Hopper (sm_90a): the Partition's (U1) and tree
// search's batched candidates (C1), bound to PyTorch through ctypes
// (libpll_tpu_torch/ops/_build.py builds this file; ops/clv.py wraps U1 as
// replay_ops, ops/incremental.py C1 as score_candidates and
// replay_candidates).
//
// U1 replaces no Pallas kernel: the JAX package runs a Partition's op table as
// an XLA lax.scan over the ops (libpll_tpu/ops/clv.py:58 update_partials),
// and its branch-length sweep replays one such table an edge inside one
// compiled program (libpll_tpu/engine/blopt.py:223 op_body).  The port's
// plain executors (ops/clv.py update_partials_by_op, update_partials_grouped)
// issue ~15 PyTorch operations an op and pass over each row about ten times.
//
// What it computes, in place, with the table's sequential semantics: for
// each op (parent, parent scaler, child1, matrix1, scaler1, child2,
// matrix2, scaler2) in order, per rate c and site n,
//   x[c,:,n] = (P[m1,c] @ clv[c1,c,:,n]) * (P[m2,c] @ clv[c2,c,:,n]);
//   per-site scaling: when every x[:,:,n] < 2^-bits and the op owns a
//     scaler, x[:,:,n] *= 2^bits and the counter adds one;
//   per-rate scaling: the same test and product on each x[c,:,n];
//   scalers[ps] = scalers[s1] + scalers[s2] + (scaled), where ps is not
//     the dummy row K (the last), which stays zero;
//   clv[parent] = x.
// Shapes: clv [N, C, S, L], pmatrix [M, C, S, S] (float32 or float64),
// scalers int32 [K+1, L] per site, [K+1, C, L] per rate (untouched without
// scaling), ops int32 [n, 8] in device memory.
//
// Design: pruning is independent per site, so one thread owns one site and
// walks the whole table in order.  No barrier is needed anywhere: an op that
// reads a row an earlier op of the table wrote, or rewrites a row a child
// read, reads this thread's own earlier stores.  So nothing the kernel writes
// is __restrict__ or read through the non-coherent path; the P-matrices and
// the table, which it never writes, are (they stay in L1 and L2: every
// thread of a warp reads the same entry).  Per rate a thread holds the two
// children's S values and the S products in registers; per-site scaling
// writes the products unscaled, keeps the vote over the rates and rescales
// the row in a second pass only when the site scales.  A span scales only
// when every entry is below 2^-bits, so a NaN anywhere means no scaling
// (all_below, as JAX's jnp.all(x < thresh)).  An op equal
// to the one before it whose parent row and scaler are none of its inputs
// would recompute the same values (the padding of ops/incremental.
// pad_op_table repeats the final op), and is skipped.  S = 4 and
// S = 20 are instances with register arrays; other alphabets up to
// kMaxAnyStates take one instance with the state loops bounded at run time.
//
// What bounds it: bytes.  An op reads two child rows and writes the parent
// row (C*S*L values each) and the scaler rows; at the float64 flagship (64
// taxa x 262 144 sites x 4 rates, 62 ops) that is 6.24 GB, 1.86 ms at 3.35
// TB/s, against ~3.9 GFLOP (0.12 ms at the FP64 peak).
//
// C1 replaces no Pallas kernel either: JAX scores a batch of SPR/NNI
// candidates as an XLA lax.map over them (libpll_tpu/ops/incremental.py:96
// make_candidate_scorer; the map's body :149-197 replays the candidate's
// op subset with a lax.scan and takes its edge's log-likelihood).  C1 is
// that body for all B candidates of a batch in one launch, in two
// instances of one device body (candidates_body):
//  * the scoring instance (score_candidates_kernel) returns B
//    log-likelihoods and writes no CLV row to device memory.  A block is
//    one candidate by one tile of 32-128 sites, block j * B + b (the
//    candidates of a tile in adjacent blocks read the same base rows: once
//    from device memory, then from L2), a thread one site.  The thread
//    walks the candidate's op descriptors (ops/incremental.py
//    plan_candidates, planned on the host a batch): each row is a base
//    row, a slot of the block's pool in shared memory ([slot, C*S, tile]
//    values and [slot, (C,) tile] counters, a column a thread, so no
//    barrier is needed), or a spill row in device memory for what the pool
//    cannot hold; each matrix the base's or the candidate's overlay slot.
//    An op nothing reads is not run.  Then the edge at the site:
//    sum_j parent_j pi_j (P child)_j per rate, the per-rate counters folded
//    as the reference does (at most SCALE_RATE_MAXDIFF), +I, the site's
//    log-likelihood times its weight, summed over the tile in float64 in a
//    fixed order into partials [B, tiles]; the asc pseudo-columns' per-rate
//    terms and counters go out for the PyTorch tail.
//  * the replay instance (replay_candidates_kernel) reads the raw tables:
//    a CLV row r < N is the base's and otherwise b's scratch row r - N
//    (scaler rows: s <= NS base, else scratch s - NS - 1), a P-matrix
//    index that equals one of b's U overlay slots (the last match wins: an
//    NNI passes one slot three times) reads b's new matrix, and every op's
//    parent lands in scratch row (column 0) - N with U1's rule for skipped
//    repeats.  The checks of rows and counters use it.
// Both use U1's per-op code (op_at_site, with each row's stride: a device
// row's L or the tile).  The base CLVs, scalers and P-matrices are never
// written; what C1 writes is not __restrict__ nor read through the
// non-coherent path.  Shapes: base clv [N, C, S, L], scalers [NS+1, (C,)
// L], pmatrix [M, C, S, S]; tables int32 [B, K, 8]; the overlay [B, U, C,
// S, S]; scratch [B, R, C, S, L] and [B, R, (C,) L].  What bounds the
// scoring instance: bytes, the distinct base rows the batch reads, each
// once (the candidates of a tile share them through L2); at
// scripts/bench_spr.py's 1 024 taxa x 16 384 sites in float32 a row is
// 1 MiB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"  // SCALE_*, Shift<T>, scale_units, dev_fma

namespace {

constexpr int kReplayBlock = 128;  // threads a block
constexpr int kAnyStates = 0;      // the instance for any other alphabet
constexpr int kMaxAnyStates = 64;  // clv.REPLAY_MAX_STATES

template <typename T>
struct ReplayArgs {
  T* clv;                 // [N, C, S, L]
  int32_t* scalers;       // [K+1, L] or [K+1, C, L]
  const T* pmatrix;       // [M, C, S, S]
  const int32_t* ops;     // [n_ops, 8]
  T thresh, factor;       // 2^-bits, 2^bits
  int64_t sites;          // L
  int n_ops;
  int rate_cats;          // C
  int states;             // S
  int scale_mode;
  int dummy;              // K: the scaler row that stays zero
};

// sum_k row[k] x[k] for k < ns.  The loops over states run to ns, a
// constant in the S = 4 and S = 20 instances (unrolled whole) and the
// alphabet's size in the kAnyStates one (not unrolled).
template <typename T, int R>
__device__ __forceinline__ T dot_n(const T* row, const T (&x)[R], int ns) {
  T acc = __ldg(row) * x[0];
#pragma unroll
  for (int k = 1; k < ns; ++k) acc = dev_fma(__ldg(row + k), x[k], acc);
  return acc;
}

// One op at one site: per rate c the two children's products, the
// scaling vote and the counters, with U1's semantics (header).  x1, x2 and
// out point at the site's entry of rate 0, state 0 of their CLV rows, entry
// (c, k) lying (c*ns + k) strides further (l1, l2, lo: the sites of a
// device row, or a block's tile for a row in C1's shared-memory pool);
// sc1, sc2 and sout at the site's counter (rate c's c strides further;
// read and written only when `scaled`).  out may be x1 or x2: a rate's two
// child columns are read before its parent column is written.  Per-site
// scaling writes the products unscaled, keeps the vote over the rates and
// rescales the row in a second pass only where the site scales.  The vote
// is all_below's: a NaN anywhere in the span means no scaling, as in JAX.
template <typename T, int S>
__device__ __forceinline__ void op_at_site(
    const T* x1, int64_t l1, const T* x2, int64_t l2, T* out, int64_t lo,
    const T* p1, const T* p2, const int32_t* sc1, int64_t ls1,
    const int32_t* sc2, int64_t ls2, int32_t* sout, int64_t lso,
    bool scaled, bool per_rate, int C, int ns, T thresh, T factor) {
  constexpr int R = S == kAnyStates ? kMaxAnyStates : S;
  bool site_below = true;
  for (int c = 0; c < C; ++c) {
    T l[R], r[R], v[R];
#pragma unroll
    for (int k = 0; k < ns; ++k) {
      l[k] = x1[((int64_t)c * ns + k) * l1];
      r[k] = x2[((int64_t)c * ns + k) * l2];
    }
    bool below = true;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      const int64_t e = ((int64_t)c * ns + j) * ns;
      v[j] = dot_n<T, R>(p1 + e, l, ns) * dot_n<T, R>(p2 + e, r, ns);
      below &= v[j] < thresh;
    }
    if (per_rate && scaled) {
      if (below)
#pragma unroll
        for (int j = 0; j < ns; ++j) v[j] *= factor;
      const int32_t sum = sc1[c * ls1] + sc2[c * ls2] + (int32_t)below;
      sout[c * lso] = sum;
    }
    site_below &= below;
#pragma unroll
    for (int j = 0; j < ns; ++j) out[((int64_t)c * ns + j) * lo] = v[j];
  }
  if (scaled && !per_rate) {
    if (site_below)
      for (int64_t k = 0; k < (int64_t)C * ns; ++k)
        out[k * lo] = out[k * lo] * factor;
    const int32_t sum = sc1[0] + sc2[0] + (int32_t)site_below;
    sout[0] = sum;
  }
}

// An op the same as the one before it, whose parent row and scaler are
// none of its inputs, recomputes the values that op stored: skipped.
__device__ __forceinline__ bool repeats(const int32_t* op, bool scaled) {
  const int32_t p = __ldg(op), ps = __ldg(op + 1), c1 = __ldg(op + 2),
                s1 = __ldg(op + 4), c2 = __ldg(op + 5), s2 = __ldg(op + 7);
  if (p == c1 || p == c2 || (scaled && (ps == s1 || ps == s2))) return false;
  bool same = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) same = same && __ldg(op + k) == __ldg(op - 8 + k);
  return same;
}

template <typename T, int S>
__global__ void __launch_bounds__(kReplayBlock)
    replay_kernel(const __grid_constant__ ReplayArgs<T> a) {
  const int ns = S == kAnyStates ? a.states : S;
  const int64_t n = (int64_t)blockIdx.x * kReplayBlock + threadIdx.x;
  if (n >= a.sites) return;
  const int C = a.rate_cats;
  const int64_t L = a.sites;
  const int64_t row = (int64_t)C * ns * L;     // one CLV buffer
  const int64_t mat = (int64_t)C * ns * ns;    // one P-matrix set
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int64_t srow = per_rate ? (int64_t)C * L : L;  // one scaler row

  for (int i = 0; i < a.n_ops; ++i) {
    const int32_t* op = a.ops + 8 * (int64_t)i;
    const int64_t p = __ldg(op), ps = __ldg(op + 1), c1 = __ldg(op + 2),
                  m1 = __ldg(op + 3), s1 = __ldg(op + 4), c2 = __ldg(op + 5),
                  m2 = __ldg(op + 6), s2 = __ldg(op + 7);
    const bool scaled = a.scale_mode != SCALE_NONE && ps != a.dummy;
    if (i > 0 && repeats(op, scaled)) continue;
    op_at_site<T, S>(a.clv + c1 * row + n, L, a.clv + c2 * row + n, L,
                     a.clv + p * row + n, L, a.pmatrix + m1 * mat,
                     a.pmatrix + m2 * mat, a.scalers + s1 * srow + n, L,
                     a.scalers + s2 * srow + n, L, a.scalers + ps * srow + n,
                     L, scaled, per_rate, C, ns, a.thresh, a.factor);
  }
}

// C1: B candidates' op subsets at once.  The block of candidate b and
// site tile j is blockIdx.x = j * B + b (the candidates of a tile in
// adjacent blocks); a thread owns one site of the tile.
enum { SRC_BASE = 0, SRC_OVERLAY = 1, SRC_POOL = 2, SRC_SPILL = 3 };
constexpr int kSrcBits = 28;

template <typename T>
struct CandidateArgs {
  const T* clv;                // base [N, C, S, L], read only
  const int32_t* scalers;      // base [NS+1, L] or [NS+1, C, L], read only
  const T* pmatrix;            // base [M, C, S, S]
  const int32_t* tables;       // [B, K, 8]: op tables (replay) or descriptors
  const int32_t* eval;         // [B, 5] descriptors of the edge (score)
  const int32_t* upd_midx;     // [B, U] (replay)
  const T* upd_pmatrix;        // [B, U, C, S, S]
  T* scratch;                  // [B, R, C, S, L]
  int32_t* scal_scratch;       // [B, R, L] or [B, R, C, L]
  // the edge (score)
  const T* freqs;              // [C, S]
  const T* rate_weights;       // [C]
  const T* prop_invar;         // [C]
  const int32_t* invariant;    // [L]: -1 or the invariant state
  const T* pattern_weights;    // [L]
  double* partials;            // [B, tiles]
  T* asc_terms;                // [B, C, L - sites]
  int32_t* asc_scal;           // [B, L - sites]
  T thresh, factor, log_scale; // 2^-bits, 2^bits, log(2^-bits)
  int64_t sites;               // L
  int64_t real_sites;          // columns before the asc pseudo-columns
  int n_ops;                   // K
  int n_upd;                   // U
  int rows;                    // R
  int n_nodes;                 // N
  int dummy;                   // NS: the base scaler row that stays zero
  int rate_cats;               // C
  int states;                  // S
  int scale_mode;
  int batch;                   // B
  int slots;                   // pool slots a block (score)
};

// Where a descriptor's row lives, as (pointer at the site's entry, stride
// between entries): the base's rows, the block's pool (entry e of slot s
// at pool[(s * width + e) * tile + t]) or the candidate's spill rows.
template <typename U>
struct Loc {
  U* p;
  int64_t stride;
};

template <typename T, int S, bool kScore>
__device__ __forceinline__ void candidates_body(const CandidateArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char pool_bytes[];
  __shared__ double s_part[kReplayBlock / 32];
  const int ns = S == kAnyStates ? a.states : S;
  const int tile = blockDim.x, t = threadIdx.x;
  const int64_t b = blockIdx.x % a.batch;
  const int64_t n = (int64_t)(blockIdx.x / a.batch) * tile + t;
  const bool live = n < a.sites;
  if (!kScore && !live) return;
  const int C = a.rate_cats;
  const int64_t L = a.sites;
  const int64_t row = (int64_t)C * ns * L;
  const int64_t mat = (int64_t)C * ns * ns;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int64_t srow = per_rate ? (int64_t)C * L : L;
  const int N = a.n_nodes, NS = a.dummy, U = a.n_upd;
  const int width = C * ns;                      // CLV entries a slot
  const int swidth = per_rate ? C : 1;           // counters a slot
  T* pool = reinterpret_cast<T*>(pool_bytes);
  int32_t* spool =
      reinterpret_cast<int32_t*>(pool + (int64_t)a.slots * width * tile);
  const int32_t* table = a.tables + b * a.n_ops * 8;
  int32_t* scalers = const_cast<int32_t*>(a.scalers);  // read only
  T* scratch = a.scratch + b * a.rows * row;
  int32_t* scal_scratch = a.scal_scratch + b * a.rows * srow;
  const T* overlay = a.upd_pmatrix + b * U * mat;

  // the replay instance's row ids (below N the base's, else b's scratch)
  // and the score instance's descriptors (kind << 28 | index)
  auto clv_at = [&](int32_t d) -> Loc<T> {
    if (!kScore)
      return d < N ? Loc<T>{const_cast<T*>(a.clv) + d * row + n, L}
                   : Loc<T>{scratch + (d - N) * row + n, L};
    const int kind = d >> kSrcBits, i = d & ((1 << kSrcBits) - 1);
    if (kind == SRC_POOL)
      return Loc<T>{pool + (int64_t)i * width * tile + t, tile};
    if (kind == SRC_SPILL) return Loc<T>{scratch + i * row + n, L};
    return Loc<T>{const_cast<T*>(a.clv) + i * row + n, L};
  };
  auto scal_at = [&](int32_t d) -> Loc<int32_t> {
    if (!kScore)
      return d <= NS ? Loc<int32_t>{scalers + d * srow + n, L}
                     : Loc<int32_t>{scal_scratch + (d - NS - 1) * srow + n, L};
    const int kind = d >> kSrcBits, i = d & ((1 << kSrcBits) - 1);
    if (kind == SRC_POOL)
      return Loc<int32_t>{spool + (int64_t)i * swidth * tile + t, tile};
    if (kind == SRC_SPILL) return Loc<int32_t>{scal_scratch + i * srow + n, L};
    return Loc<int32_t>{scalers + i * srow + n, L};
  };
  // replay: a matrix one of the candidate's U slots (the last that
  // matches) is its overlay; score: the descriptor says which
  auto matrix = [&](int32_t m) -> const T* {
    if (kScore)
      return (m >> kSrcBits) == SRC_OVERLAY
                 ? overlay + (int64_t)(m & ((1 << kSrcBits) - 1)) * mat
                 : a.pmatrix + (int64_t)m * mat;
    const T* pm = a.pmatrix + (int64_t)m * mat;
    for (int u = 0; u < U; ++u)
      if (__ldg(a.upd_midx + b * U + u) == m) pm = overlay + u * mat;
    return pm;
  };

  if (live) {
    for (int i = 0; i < a.n_ops; ++i) {
      const int32_t* op = table + 8 * (int64_t)i;
      const int32_t p = __ldg(op), ps = __ldg(op + 1);
      bool scaled;
      if (kScore) {
        if (p < 0) continue;  // a repeat, or no later read
        scaled = ps >= 0;
      } else {
        scaled = a.scale_mode != SCALE_NONE && ps != NS;
        if (i > 0 && repeats(op, scaled)) continue;
      }
      const Loc<T> x1 = clv_at(__ldg(op + 2)), x2 = clv_at(__ldg(op + 5));
      const Loc<T> out = clv_at(p);
      Loc<int32_t> sc1{nullptr, 0}, sc2{nullptr, 0}, so{nullptr, 0};
      if (scaled) {
        sc1 = scal_at(__ldg(op + 4));
        sc2 = scal_at(__ldg(op + 7));
        so = scal_at(ps);
      }
      op_at_site<T, S>(x1.p, x1.stride, x2.p, x2.stride, out.p, out.stride,
                       matrix(__ldg(op + 3)), matrix(__ldg(op + 6)), sc1.p,
                       sc1.stride, sc2.p, sc2.stride, so.p, so.stride, scaled,
                       per_rate, C, ns, a.thresh, a.factor);
    }
  }
  if constexpr (kScore) {
    // the edge's log-likelihood at this site (ops/likelihood.py
    // edge_loglikelihood): per rate sum_j parent_j pi_j (P child)_j, the
    // per-rate counters folded as the reference does, +I, the weight
    double lnl = 0;
    if (live) {
      const int32_t* ev = a.eval + b * 5;
      const Loc<T> par = clv_at(__ldg(ev)), chi = clv_at(__ldg(ev + 2));
      const T* pe = matrix(__ldg(ev + 4));
      const bool has_scal = a.scale_mode != SCALE_NONE;
      Loc<int32_t> sp{nullptr, 0}, sc{nullptr, 0};
      if (has_scal) {
        sp = scal_at(__ldg(ev + 1));
        sc = scal_at(__ldg(ev + 3));
      }
      int snum = 0;
      if (has_scal) {
        snum = sp.p[0] + sc.p[0];
        if (per_rate)
          for (int c = 1; c < C; ++c)
            snum = min(snum, sp.p[c * sp.stride] + sc.p[c * sc.stride]);
      }
      const int inv = __ldg(a.invariant + n);
      const bool asc = n >= a.real_sites;
      const int64_t na = n - a.real_sites, n_asc = L - a.real_sites;
      T term = 0;
      for (int c = 0; c < C; ++c) {
        constexpr int R = S == kAnyStates ? kMaxAnyStates : S;
        T x[R];
#pragma unroll
        for (int k = 0; k < ns; ++k)
          x[k] = chi.p[((int64_t)c * ns + k) * chi.stride];
        T term_r = 0;
#pragma unroll
        for (int j = 0; j < ns; ++j) {
          const T pv = par.p[((int64_t)c * ns + j) * par.stride] *
                       __ldg(a.freqs + c * ns + j);
          const T pc = dot_n<T, R>(pe + ((int64_t)c * ns + j) * ns, x, ns);
          term_r = dev_fma(pv, pc, term_r);
        }
        if (per_rate && has_scal) {
          const int diff = min(sp.p[c * sp.stride] + sc.p[c * sc.stride] - snum,
                               kRateMaxDiff);
          for (int k = 0; k < diff; ++k) term_r *= a.thresh;
        }
        if (asc) a.asc_terms[(b * C + c) * n_asc + na] = term_r;
        const T pinv = __ldg(a.prop_invar + c);
        T mixed = term_r;
        if (pinv > (T)0) {
          const T inv_lk = inv >= 0 ? __ldg(a.freqs + c * ns + inv) : (T)0;
          mixed = term_r * ((T)1 - pinv) + inv_lk * pinv;
        }
        term = dev_fma(__ldg(a.rate_weights + c), mixed, term);
      }
      if (asc)
        a.asc_scal[b * n_asc + na] = snum;
      else
        lnl = (double)((dev_log(term) + (T)snum * a.log_scale) *
                       __ldg(a.pattern_weights + n));
    }
    // the tile's sum in a fixed order: each warp's shuffle tree, then the
    // warps in order
    for (int o = 16; o; o >>= 1) lnl += __shfl_down_sync(0xffffffffu, lnl, o);
    if ((t & 31) == 0) s_part[t >> 5] = lnl;
    __syncthreads();
    if (t == 0) {
      double total = 0;
      for (int w = 0; w < (tile + 31) / 32; ++w) total += s_part[w];
      a.partials[b * (gridDim.x / a.batch) + blockIdx.x / a.batch] = total;
    }
  }
}

// The two instances of C1's body: the scorer's (pool, descriptors, the
// edge's log-likelihood) and the replay's (every op's rows to scratch).
template <typename T, int S>
__global__ void __launch_bounds__(kReplayBlock)
    score_candidates_kernel(const __grid_constant__ CandidateArgs<T> a) {
  candidates_body<T, S, true>(a);
}

template <typename T, int S>
__global__ void __launch_bounds__(kReplayBlock)
    replay_candidates_kernel(const __grid_constant__ CandidateArgs<T> a) {
  candidates_body<T, S, false>(a);
}

template <typename T>
int replay(void* clv, void* scalers, const void* pmatrix,
           const int32_t* ops, int n_ops, int rate_cats, int states,
           int64_t sites, int scale_mode, int dummy, void* stream) {
  if (n_ops < 0 || rate_cats < 1 || states < 2 || states > kMaxAnyStates ||
      sites < 1 || scale_mode < SCALE_NONE || scale_mode > SCALE_PER_RATE ||
      dummy < 0 || !clv || !pmatrix || (n_ops > 0 && !ops) ||
      (scale_mode != SCALE_NONE && !scalers))
    return (int)cudaErrorInvalidValue;
  if (n_ops == 0) return 0;
  const Scale<T> u = scale_units<T>();
  ReplayArgs<T> a;
  a.clv = static_cast<T*>(clv);
  a.scalers = static_cast<int32_t*>(scalers);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.ops = ops;
  a.thresh = u.thresh;
  a.factor = u.factor;
  a.sites = sites;
  a.n_ops = n_ops;
  a.rate_cats = rate_cats;
  a.states = states;
  a.scale_mode = scale_mode;
  a.dummy = dummy;
  const dim3 grid((unsigned)((sites + kReplayBlock - 1) / kReplayBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == 4)
    replay_kernel<T, 4><<<grid, kReplayBlock, 0, st>>>(a);
  else if (states == 20)
    replay_kernel<T, 20><<<grid, kReplayBlock, 0, st>>>(a);
  else
    replay_kernel<T, kAnyStates><<<grid, kReplayBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int candidates(const CandidateArgs<T>& args, int score, int tile, int smem,
               void* stream) {
  CandidateArgs<T> a = args;
  if (a.n_ops < 1 || a.n_upd < 0 || a.rows < 0 || a.batch < 1 ||
      a.n_nodes < 1 || a.dummy < 0 || a.rate_cats < 1 || a.states < 2 ||
      a.states > kMaxAnyStates || a.sites < 1 ||
      a.scale_mode < SCALE_NONE || a.scale_mode > SCALE_PER_RATE ||
      !a.clv || !a.pmatrix || !a.tables || tile < 32 || tile > kReplayBlock ||
      tile % 32 || smem < 0 || (a.n_upd > 0 && !a.upd_pmatrix) ||
      (!score && ((a.n_upd > 0 && !a.upd_midx) || a.rows < 1 || !a.scratch)) ||
      (score && (!a.eval || !a.freqs || !a.rate_weights || !a.prop_invar ||
                 !a.invariant || !a.pattern_weights || !a.partials ||
                 a.real_sites > a.sites || a.slots < 0 ||
                 (a.real_sites < a.sites && (!a.asc_terms || !a.asc_scal)))) ||
      (a.scale_mode != SCALE_NONE && !a.scalers))
    return (int)cudaErrorInvalidValue;
  const Scale<T> u = scale_units<T>();
  a.thresh = u.thresh;
  a.factor = u.factor;
  const int64_t tiles = (a.sites + tile - 1) / tile;
  if (tiles * a.batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * a.batch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<grid, tile, smem, st>>>(a);
    return (int)cudaGetLastError();
  };
  if (score) {
    if (a.states == 4) return launch(score_candidates_kernel<T, 4>);
    if (a.states == 20) return launch(score_candidates_kernel<T, 20>);
    return launch(score_candidates_kernel<T, kAnyStates>);
  }
  if (a.states == 4) return launch(replay_candidates_kernel<T, 4>);
  if (a.states == 20) return launch(replay_candidates_kernel<T, 20>);
  return launch(replay_candidates_kernel<T, kAnyStates>);
}

}  // namespace

// Plain C interface for ctypes.  replay_ops_* runs the n_ops ops of the
// device table `ops` on the buffers in place, one launch on `stream` (none
// for an empty table), and returns its cudaError_t (0 on success).  The
// caller vouches for the table's indices: every CLV, matrix and (when
// scaled) scaler index inside its tensor.
extern "C" int replay_ops_f32(void* clv, void* scalers, const void* pmatrix,
                              const int32_t* ops, int n_ops, int rate_cats,
                              int states, int64_t sites, int scale_mode,
                              int dummy, void* stream) {
  return replay<float>(clv, scalers, pmatrix, ops, n_ops, rate_cats, states,
                       sites, scale_mode, dummy, stream);
}
extern "C" int replay_ops_f64(void* clv, void* scalers, const void* pmatrix,
                              const int32_t* ops, int n_ops, int rate_cats,
                              int states, int64_t sites, int scale_mode,
                              int dummy, void* stream) {
  return replay<double>(clv, scalers, pmatrix, ops, n_ops, rate_cats, states,
                        sites, scale_mode, dummy, stream);
}

// C1, both instances, one launch on `stream` each: `args` points at a
// CandidateArgs<float> (candidates_f32) or CandidateArgs<double>
// (candidates_f64) whose layout ops/incremental.py mirrors; thresh and
// factor are filled in here.  score = 0: the replay instance: candidate
// b's K ops (tables [B, K, 8]) read CLV rows below n_nodes and scaler rows
// up to `dummy` from the base buffers, the others from b's scratch rows
// (row r - n_nodes, scaler row s - dummy - 1), P-matrices from the base or
// from b's U overlay slots, and write each op's parent to its scratch row.
// score = 1: the scoring instance: tables holds ops/incremental's
// descriptors (kind << 28 | index for every row, scaler and matrix; -1
// skips an op), `eval` the edge's, `slots` pool slots of `tile` sites in
// `smem` bytes of shared memory; it writes each tile's log-likelihood to
// partials [B, tiles] and the asc columns' per-rate terms and counters.
// The base buffers are not written.  The caller vouches for every index.
extern "C" int candidates_f32(const void* args, int score, int tile,
                              int smem, void* stream) {
  return candidates<float>(*static_cast<const CandidateArgs<float>*>(args),
                           score, tile, smem, stream);
}
extern "C" int candidates_f64(const void* args, int score, int tile,
                              int smem, void* stream) {
  return candidates<double>(*static_cast<const CandidateArgs<double>*>(args),
                            score, tile, smem, stream);
}

// The largest dynamic shared memory a block may ask for on the current
// device (bytes), less the scoring instance's static shared memory.
extern "C" int candidates_smem_limit(int* smem) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
  cudaFuncAttributes attr;
  if (rc == cudaSuccess)
    rc = cudaFuncGetAttributes(&attr, score_candidates_kernel<double, 20>);
  if (rc == cudaSuccess) *smem -= (int)attr.sharedSizeBytes;
  return (int)rc;
}

extern "C" const char* replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
