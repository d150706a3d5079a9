// Op-table replay for Hopper (sm_90a): the Partition's (U1) and tree
// search's batched candidates (C1), bound to PyTorch through ctypes
// (libpll_tpu_torch/ops/_build.py builds this file; ops/clv.py wraps U1 as
// replay_ops, ops/incremental.py C1 as score_candidates).
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
// make_candidate_scorer, the map at :193-199), each a lax.scan of its op
// subset.  C1 runs that replay for all B candidates of a batch in one
// launch: the grid is (site tiles, B), and one thread owns (candidate b,
// site n) and walks b's K ops in order, with U1's per-op code (op_at_site)
// and its rule for skipped repeats.  Two indirections are U1's addition: a
// CLV row r < N is the base's and otherwise b's scratch row r - N (scaler
// rows: s <= NS base, else scratch s - NS - 1), and a P-matrix index that
// equals one of b's U overlay slots (the last match wins: an NNI passes one
// slot three times) reads b's new matrix, else the base's.  An op's parent
// lands in scratch row (column 0) - N.  The base CLVs, scalers and
// P-matrices are never written; the scratch rows are, so nothing C1 writes
// is __restrict__ or read through the non-coherent path.  Shapes: base clv
// [N, C, S, L], scalers [NS+1, (C,) L], pmatrix [M, C, S, S]; tables int32
// [B, K, 8], upd_midx int32 [B, U], the overlay [B, U, C, S, S]; scratch
// [B, R, C, S, L] and scaler scratch [B, R, (C,) L], R the rows a candidate
// may write.  What bounds it: bytes, per real op two child rows read and
// one written; at scripts/bench_spr.py's 1 024 taxa x 16 384 sites in
// float32 a row is 1 MiB.

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

// One op at one site n: per rate c the two children's products, the
// scaling vote and the counters, with U1's semantics (header).  x1, x2 and
// out point at the site's entry of rate 0, state 0 of their CLV rows; sc1,
// sc2 and sout at the start of their scaler rows (read and written only
// when `scaled`).  out may be x1 or x2: a rate's two child columns are read
// before its parent column is written.  Per-site scaling writes the
// products unscaled, keeps the vote over the rates and rescales the row in
// a second pass only where the site scales.  The vote is all_below's: a
// NaN anywhere in the span means no scaling, as in JAX.
template <typename T, int S>
__device__ __forceinline__ void op_at_site(
    const T* x1, const T* x2, T* out, const T* p1, const T* p2,
    const int32_t* sc1, const int32_t* sc2, int32_t* sout, bool scaled,
    bool per_rate, int C, int ns, int64_t L, int64_t n, T thresh, T factor) {
  constexpr int R = S == kAnyStates ? kMaxAnyStates : S;
  bool site_below = true;
  for (int c = 0; c < C; ++c) {
    T l[R], r[R], v[R];
#pragma unroll
    for (int k = 0; k < ns; ++k) {
      l[k] = x1[((int64_t)c * ns + k) * L];
      r[k] = x2[((int64_t)c * ns + k) * L];
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
      const int64_t k = (int64_t)c * L + n;
      const int32_t sum = sc1[k] + sc2[k] + (int32_t)below;
      sout[k] = sum;
    }
    site_below &= below;
#pragma unroll
    for (int j = 0; j < ns; ++j) out[((int64_t)c * ns + j) * L] = v[j];
  }
  if (scaled && !per_rate) {
    if (site_below)
      for (int64_t k = 0; k < (int64_t)C * ns; ++k)
        out[k * L] = out[k * L] * factor;
    const int32_t sum = sc1[n] + sc2[n] + (int32_t)site_below;
    sout[n] = sum;
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
    op_at_site<T, S>(a.clv + c1 * row + n, a.clv + c2 * row + n,
                     a.clv + p * row + n, a.pmatrix + m1 * mat,
                     a.pmatrix + m2 * mat, a.scalers + s1 * srow,
                     a.scalers + s2 * srow, a.scalers + ps * srow, scaled,
                     per_rate, C, ns, L, n, a.thresh, a.factor);
  }
}

// C1: B candidates' op subsets at once, one candidate a grid row.
template <typename T>
struct CandidateArgs {
  const T* clv;                // base [N, C, S, L], read only
  const int32_t* scalers;      // base [NS+1, L] or [NS+1, C, L], read only
  const T* pmatrix;            // base [M, C, S, S], read only
  const int32_t* tables;       // [B, K, 8]
  const int32_t* upd_midx;     // [B, U]
  const T* upd_pmatrix;        // [B, U, C, S, S]
  T* scratch;                  // [B, R, C, S, L]
  int32_t* scal_scratch;       // [B, R, L] or [B, R, C, L]
  T thresh, factor;            // 2^-bits, 2^bits
  int64_t sites;               // L
  int n_ops;                   // K
  int n_upd;                   // U
  int rows;                    // R
  int n_nodes;                 // N
  int dummy;                   // NS: the base scaler row that stays zero
  int rate_cats;               // C
  int states;                  // S
  int scale_mode;
};

template <typename T, int S>
__global__ void __launch_bounds__(kReplayBlock)
    candidates_kernel(const __grid_constant__ CandidateArgs<T> a) {
  const int ns = S == kAnyStates ? a.states : S;
  const int64_t n = (int64_t)blockIdx.x * kReplayBlock + threadIdx.x;
  if (n >= a.sites) return;
  const int64_t b = blockIdx.y;
  const int C = a.rate_cats;
  const int64_t L = a.sites;
  const int64_t row = (int64_t)C * ns * L;
  const int64_t mat = (int64_t)C * ns * ns;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int64_t srow = per_rate ? (int64_t)C * L : L;
  const int N = a.n_nodes, NS = a.dummy, U = a.n_upd;
  const int32_t* table = a.tables + b * a.n_ops * 8;
  const int32_t* midx = a.upd_midx + b * U;
  const T* overlay = a.upd_pmatrix + b * U * mat;
  T* scratch = a.scratch + b * a.rows * row;
  int32_t* scal_scratch = a.scal_scratch + b * a.rows * srow;
  // rows below N are the base's, the others this candidate's scratch;
  // scaler rows up to NS the base's; a matrix one of the candidate's U
  // slots (the last that matches) is its overlay
  auto clv_row = [&](int64_t r) -> const T* {
    return (r < N ? a.clv + r * row : scratch + (r - N) * row) + n;
  };
  auto scaler_row = [&](int64_t s) -> const int32_t* {
    return s <= NS ? a.scalers + s * srow : scal_scratch + (s - NS - 1) * srow;
  };
  auto matrix = [&](int32_t m) -> const T* {
    const T* pm = a.pmatrix + (int64_t)m * mat;
    for (int u = 0; u < U; ++u)
      if (__ldg(midx + u) == m) pm = overlay + u * mat;
    return pm;
  };

  for (int i = 0; i < a.n_ops; ++i) {
    const int32_t* op = table + 8 * (int64_t)i;
    const int64_t p = __ldg(op), ps = __ldg(op + 1), c1 = __ldg(op + 2),
                  s1 = __ldg(op + 4), c2 = __ldg(op + 5), s2 = __ldg(op + 7);
    const bool scaled = a.scale_mode != SCALE_NONE && ps != NS;
    if (i > 0 && repeats(op, scaled)) continue;
    op_at_site<T, S>(
        clv_row(c1), clv_row(c2), scratch + (p - N) * row + n,
        matrix(__ldg(op + 3)), matrix(__ldg(op + 6)),
        scaled ? scaler_row(s1) : nullptr, scaled ? scaler_row(s2) : nullptr,
        scaled ? scal_scratch + (ps - NS - 1) * srow : nullptr, scaled,
        per_rate, C, ns, L, n, a.thresh, a.factor);
  }
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
int candidates(const void* clv, const void* scalers, const void* pmatrix,
               const int32_t* tables, int n_ops, const int32_t* upd_midx,
               const void* upd_pmatrix, int n_upd, void* scratch,
               void* scal_scratch, int rows, int batch, int n_nodes,
               int dummy, int rate_cats, int states, int64_t sites,
               int scale_mode, void* stream) {
  if (n_ops < 1 || n_upd < 0 || rows < 1 || batch < 1 || batch > 65535 ||
      n_nodes < 1 || dummy < 0 || rate_cats < 1 || states < 2 ||
      states > kMaxAnyStates || sites < 1 || scale_mode < SCALE_NONE ||
      scale_mode > SCALE_PER_RATE || !clv || !pmatrix || !tables ||
      !scratch || (n_upd > 0 && (!upd_midx || !upd_pmatrix)) ||
      (scale_mode != SCALE_NONE && (!scalers || !scal_scratch)))
    return (int)cudaErrorInvalidValue;
  const Scale<T> u = scale_units<T>();
  CandidateArgs<T> a;
  a.clv = static_cast<const T*>(clv);
  a.scalers = static_cast<const int32_t*>(scalers);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.tables = tables;
  a.upd_midx = upd_midx;
  a.upd_pmatrix = static_cast<const T*>(upd_pmatrix);
  a.scratch = static_cast<T*>(scratch);
  a.scal_scratch = static_cast<int32_t*>(scal_scratch);
  a.thresh = u.thresh;
  a.factor = u.factor;
  a.sites = sites;
  a.n_ops = n_ops;
  a.n_upd = n_upd;
  a.rows = rows;
  a.n_nodes = n_nodes;
  a.dummy = dummy;
  a.rate_cats = rate_cats;
  a.states = states;
  a.scale_mode = scale_mode;
  const dim3 grid((unsigned)((sites + kReplayBlock - 1) / kReplayBlock),
                  (unsigned)batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == 4)
    candidates_kernel<T, 4><<<grid, kReplayBlock, 0, st>>>(a);
  else if (states == 20)
    candidates_kernel<T, 20><<<grid, kReplayBlock, 0, st>>>(a);
  else
    candidates_kernel<T, kAnyStates><<<grid, kReplayBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
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

// score_candidates_* runs the op tables of `batch` candidates, one launch
// on `stream`: candidate b's K ops (tables [B, K, 8]) read CLV rows below
// n_nodes and scaler rows up to `dummy` from the base buffers, the others
// from b's scratch rows (row r - n_nodes, scaler row s - dummy - 1), P-
// matrices from the base or from b's U overlay slots, and write each op's
// parent to its scratch row.  The base buffers are not written.  The
// caller vouches for the tables' indices (every scratch row below `rows`).
extern "C" int score_candidates_f32(
    const void* clv, const void* scalers, const void* pmatrix,
    const int32_t* tables, int n_ops, const int32_t* upd_midx,
    const void* upd_pmatrix, int n_upd, void* scratch, void* scal_scratch,
    int rows, int batch, int n_nodes, int dummy, int rate_cats, int states,
    int64_t sites, int scale_mode, void* stream) {
  return candidates<float>(clv, scalers, pmatrix, tables, n_ops, upd_midx,
                           upd_pmatrix, n_upd, scratch, scal_scratch, rows,
                           batch, n_nodes, dummy, rate_cats, states, sites,
                           scale_mode, stream);
}
extern "C" int score_candidates_f64(
    const void* clv, const void* scalers, const void* pmatrix,
    const int32_t* tables, int n_ops, const int32_t* upd_midx,
    const void* upd_pmatrix, int n_upd, void* scratch, void* scal_scratch,
    int rows, int batch, int n_nodes, int dummy, int rate_cats, int states,
    int64_t sites, int scale_mode, void* stream) {
  return candidates<double>(clv, scalers, pmatrix, tables, n_ops, upd_midx,
                            upd_pmatrix, n_upd, scratch, scal_scratch, rows,
                            batch, n_nodes, dummy, rate_cats, states, sites,
                            scale_mode, stream);
}

extern "C" const char* replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
