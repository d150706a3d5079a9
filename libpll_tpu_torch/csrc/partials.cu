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
// Design: pruning is independent per site, and per rate up to the vote.
// ops/clv.py replay_plan gives a site `lanes` lanes (1, 2, 4 or 8), one a
// rate (rates q, q + lanes, ... where C exceeds them); a warp holds 32 /
// lanes sites, each rate's lanes adjacent (lane q * (32 / lanes) + j is
// rate q of the warp's site j), so a warp's loads of one state are `lanes`
// runs of consecutive sites.  A lane reads only the CLV entries and
// counters it wrote itself, so the table's order needs no barrier: an op
// that reads a row an earlier op wrote, or rewrites a row a child read,
// reads this lane's own earlier stores.  Nothing the kernel writes is
// __restrict__ or read through the non-coherent path.  Per rate a lane
// holds the two children's S values and the S products in registers; the
// per-site vote is an AND over the site's lanes by shuffles, after which
// each lane rescales the entries it stored unscaled, its last rate's from
// registers (per-rate scaling scales a rate's products before it stores
// them).  A
// span scales only when every entry is below 2^-bits, so a NaN anywhere
// means no scaling (all_below, as JAX's jnp.all(x < thresh)).  The
// table is staged in shared memory a window of ops at a time (the plan's
// `window`, two buffers when the table takes more than one): each op's
// eight ints and its two P-matrix sets, every rate's matrix padded by one
// value so that a warp's rates read distinct banks, copied by cp.async
// while the window before computes, one barrier a window.  Whether an op
// repeats the one before it, with a parent row and scaler that are none
// of its inputs (it would recompute the same values: the padding of
// ops/incremental.pad_op_table repeats the final op), is decided once a
// block, and such an op is skipped: a block first finds the table's
// trailing run of repeats (a sweep's 8-32 slots hold 1-3 real ops) and
// neither stages nor walks it.  Where one
// op's matrices exceed the plan's budget (window 0) every lane reads the
// table and the matrices through L1/L2.  S = 4 and S = 20 are instances
// with register arrays; other alphabets up to kMaxAnyStates take one
// instance with the state loops bounded at run time.
//
// What bounds it: bytes.  An op reads two child rows and writes the parent
// row (C*S*L values each) and the scaler rows; at the float64 flagship (64
// taxa x 262 144 sites x 4 rates, 62 ops) that is 6.24 GB, 1.86 ms at 3.35
// TB/s, against ~3.9 GFLOP (0.12 ms at the FP64 peak).  A branch-length
// sweep's table at scripts/bench_infer.py's 1 024 taxa x 16 384 sites in
// float32 (8-32 slots, 1-3 real ops) moves ~3.2 MB an op: ~1 us at 3.35
// TB/s.  There a lane per site filled four warps an SM and walked the
// rates one after another (a dependent round trip each); a lane per rate
// fills the card C times over, one round trip an op.
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
// Both use one per-op device function, a thread a site (op_at_site at
// S = 4 and 20, clv_common.cuh's any_op for any other alphabet, which
// reads the P-matrices in rows padded to 16 bytes; each row with its
// stride: a device row's L or the tile).  The base CLVs, scalers and
// P-matrices are never written; what C1 writes is not __restrict__ nor
// read through the non-coherent path.  Shapes: base clv [N, C, S, L],
// scalers [NS+1, (C,) L], pmatrix [M, C, S, S]; tables int32 [B, K, 8];
// the overlay [B, U, C, S, S] (C1's P-matrices' rows padded to sp values
// at S not in {4, 20}); scratch [B, R, C, S, L] and [B, R, (C,) L].  What
// bounds the scoring instance: bytes, the distinct base rows the batch reads, each
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
  int lanes;              // lanes a site: 1, 2, 4 or 8
  int window;             // ops staged at once (0: none staged)
};

// sum_k row[k] x[k] for k < ns.  The loops over states run to ns, a
// constant in the S = 4 and S = 20 instances (unrolled whole) and the
// alphabet's size in U1's kAnyStates one (not unrolled).
template <typename T, int R>
__device__ __forceinline__ T dot_n(const T* row, const T (&x)[R], int ns) {
  T acc = __ldg(row) * x[0];
#pragma unroll
  for (int k = 1; k < ns; ++k) acc = dev_fma(__ldg(row + k), x[k], acc);
  return acc;
}

// One op at one site (C1 at S = 4 and 20): per rate c the two children's
// products, the scaling vote and the counters, with U1's semantics
// (header).  x1, x2 and
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
  constexpr int R = S;
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

// ------------------------------------------------------------------ U1
// cp.async of one N-byte value from device memory to shared memory; the
// copies a thread issued land by the end of its next wait.
template <int N>
__device__ __forceinline__ void cp_async_value(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One P-matrix value: from shared memory (staged) or through __ldg.
template <typename T, bool kStaged>
__device__ __forceinline__ T pm_value(const T* p) {
  if constexpr (kStaged)
    return *p;
  else
    return __ldg(p);
}

// sum_k row[k] x[k] for k < ns, in dot_n's order.
template <typename T, int R, bool kStaged>
__device__ __forceinline__ T dot_pm(const T* row, const T (&x)[R], int ns) {
  T acc = pm_value<T, kStaged>(row) * x[0];
#pragma unroll
  for (int k = 1; k < ns; ++k)
    acc = dev_fma(pm_value<T, kStaged>(row + k), x[k], acc);
  return acc;
}

// The AND of b over a site's lanes (lanes 32 / lanes apart); every lane of
// the warp takes part.
__device__ __forceinline__ bool site_all(bool b, int lanes) {
  for (int o = 16; o >= 32 / lanes; o >>= 1) {
    const int other = __shfl_xor_sync(0xffffffffu, (int)b, o);
    b = b && other;
  }
  return b;
}

// An op's rows: parent, its scaler, the children and theirs; `scaled`
// when the scale mode scales and the parent's scaler is not the dummy.
struct U1Op {
  int64_t p, ps, c1, s1, c2, s2;
  bool scaled;
};

template <typename T>
__device__ __forceinline__ U1Op u1_op(const int32_t* op,
                                      const ReplayArgs<T>& a) {
  U1Op o;
  o.p = op[0];
  o.ps = op[1];
  o.c1 = op[2];
  o.s1 = op[4];
  o.c2 = op[5];
  o.s2 = op[7];
  o.scaled = a.scale_mode != SCALE_NONE && o.ps != a.dummy;
  return o;
}

// One op at one lane: rates q, q + lanes, ... < C of site n, with U1's
// semantics (header).  pa, pb: the op's two P-matrix sets, rate c's matrix
// at c * pstride.  A lane past the last site (live false) reads and writes
// nothing but takes part in the vote's shuffles.
template <typename T, int S, bool kStaged>
__device__ __forceinline__ void u1_lane(const ReplayArgs<T>& a, int ns,
                                        const U1Op& o, const T* pa,
                                        const T* pb, int pstride, int q,
                                        int64_t n, bool live) {
  constexpr int R = S == kAnyStates ? kMaxAnyStates : S;
  const int C = a.rate_cats, lanes = a.lanes;
  const int64_t L = a.sites;
  const int64_t row = (int64_t)C * ns * L;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int64_t srow = per_rate ? (int64_t)C * L : L;
  const T* x1 = a.clv + o.c1 * row + n;
  const T* x2 = a.clv + o.c2 * row + n;
  T* out = a.clv + o.p * row + n;
  int32_t* sc1 = a.scalers + o.s1 * srow + n;
  int32_t* sc2 = a.scalers + o.s2 * srow + n;
  int32_t* sout = a.scalers + o.ps * srow + n;
  // per-site scaling stores the products unscaled and rescales the lane's
  // entries after the vote, its last rate's from registers (a rate a lane:
  // no entry is read back); a lane past the last rate votes true
  bool lane_below = true;
  const bool site_counts = o.scaled && !per_rate && live && q == 0;
  const int32_t site_sum = site_counts ? sc1[0] + sc2[0] : 0;
  T v[R];
  int last = -1;  // the lane's last rate
  if (live) {
    for (int c = q; c < C; c += lanes) {
      const int64_t sc = (int64_t)c * L;
      // a rate's counters are loaded with its CLVs: one round trip a rate
      const int32_t sum = per_rate && o.scaled ? sc1[sc] + sc2[sc] : 0;
      T l[R], r[R];
#pragma unroll
      for (int k = 0; k < ns; ++k) {
        l[k] = x1[((int64_t)c * ns + k) * L];
        r[k] = x2[((int64_t)c * ns + k) * L];
      }
      bool under = true;
#pragma unroll
      for (int j = 0; j < ns; ++j) {
        const int e = c * pstride + j * ns;
        v[j] = dot_pm<T, R, kStaged>(pa + e, l, ns) *
               dot_pm<T, R, kStaged>(pb + e, r, ns);
        under &= v[j] < a.thresh;
      }
      if (per_rate && o.scaled) {
        if (under)
#pragma unroll
          for (int j = 0; j < ns; ++j) v[j] *= a.factor;
        sout[sc] = sum + (int32_t)under;
      }
      lane_below &= under;
#pragma unroll
      for (int j = 0; j < ns; ++j) out[((int64_t)c * ns + j) * L] = v[j];
      last = c;
    }
  }
  if (o.scaled && !per_rate) {
    const bool site = site_all(lane_below, lanes);
    if (live) {
      if (site && last >= 0) {
        for (int c = q; c < last; c += lanes)
          for (int j = 0; j < ns; ++j) {
            const int64_t e = ((int64_t)c * ns + j) * L;
            out[e] = out[e] * a.factor;
          }
#pragma unroll
        for (int j = 0; j < ns; ++j)
          out[((int64_t)last * ns + j) * L] = v[j] * a.factor;
      }
      if (site_counts) sout[0] = site_sum + (int32_t)site;
    }
  }
}

// The bytes of one staged window's matrices (each rate's matrix padded by
// one value), rounded up to 16; then its ops' eight ints and skip flags
// (ops/clv.py replay_plan sizes the stage so; the launcher checks it).
template <typename T>
__host__ __device__ __forceinline__ int64_t stage_pm_bytes(int window, int C,
                                                          int ns) {
  return ((int64_t)window * 2 * C * (ns * ns + 1) * sizeof(T) + 15) / 16 *
         16;
}

__host__ __device__ __forceinline__ int64_t stage_op_bytes(int window) {
  return ((int64_t)window * 9 * 4 + 15) / 16 * 16;
}

// Issue the cp.async copies of ops [lo, lo + cnt) into a stage buffer: the
// ops' ints and their two P-matrix sets; with `flags`, threads below cnt
// decide whether each op repeats the one before it (plain stores, seen
// after the window's barrier).
template <typename T>
__device__ __forceinline__ void stage_window(const ReplayArgs<T>& a,
                                             unsigned char* buf,
                                             int64_t pm_bytes, int lo,
                                             int cnt, int ns, bool flags) {
  T* pm = reinterpret_cast<T*>(buf);
  int32_t* ops = reinterpret_cast<int32_t*>(buf + pm_bytes);
  int32_t* skip = ops + 8 * a.window;
  const int ss = ns * ns, mat = a.rate_cats * ss;
  const int set = a.rate_cats * (ss + 1);
  const int32_t* table = a.ops + 8 * (int64_t)lo;
  for (int e = threadIdx.x; e < 2 * mat * cnt; e += blockDim.x) {
    const int k = e / (2 * mat), rem = e - k * 2 * mat;
    const int side = rem >= mat, r = rem - side * mat, c = r / ss;
    const int64_t m = __ldg(table + 8 * k + (side ? 6 : 3));
    cp_async_value<(int)sizeof(T)>(pm + (2 * k + side) * set + r + c,
                              a.pmatrix + m * mat + r);
  }
  for (int e = threadIdx.x; e < 8 * cnt; e += blockDim.x)
    cp_async_value<4>(ops + e, table + e);
  cp_async_commit();
  for (int k = threadIdx.x; flags && k < cnt; k += blockDim.x) {
    const int32_t* op = table + 8 * k;
    const bool scaled =
        a.scale_mode != SCALE_NONE && __ldg(op + 1) != a.dummy;
    skip[k] = lo + k > 0 && repeats(op, scaled);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kReplayBlock)
    replay_kernel(const __grid_constant__ ReplayArgs<T> a) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ int s_runs[kReplayBlock / 32];  // each warp's ops that run
  const int ns = S == kAnyStates ? a.states : S;
  const int per_warp = 32 / a.lanes;  // sites a warp
  const int lane = threadIdx.x & 31;
  const int q = lane / per_warp;      // the lane's first rate
  const int64_t n =
      ((int64_t)blockIdx.x * (kReplayBlock / 32) + (threadIdx.x >> 5)) *
          per_warp +
      lane % per_warp;
  const bool live = n < a.sites;
  const int C = a.rate_cats;

  if (a.window == 0) {  // the table and the matrices through L1/L2
    const int64_t mat = (int64_t)C * ns * ns;
    for (int i = 0; i < a.n_ops; ++i) {
      const int32_t* op = a.ops + 8 * (int64_t)i;
      int32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldg(op + k);
      const U1Op o = u1_op(v, a);
      if (i > 0 && repeats(op, o.scaled)) continue;
      u1_lane<T, S, false>(a, ns, o, a.pmatrix + v[3] * mat,
                           a.pmatrix + v[6] * mat, ns * ns, q, n, live);
    }
    return;
  }
  const int window = a.window;
  const int set = C * (ns * ns + 1);  // a staged P-matrix set
  const int64_t pm_bytes = stage_pm_bytes<T>(window, C, ns);
  const int64_t buf_bytes = pm_bytes + stage_op_bytes(window);
  // the ops that run: the table less its trailing repeats (a padded
  // table's padding), which are neither staged nor walked; the first
  // window's repeat flags on the way
  int32_t* skip0 = reinterpret_cast<int32_t*>(stage + pm_bytes) + 8 * window;
  int last = 0;
  for (int i = threadIdx.x; i < a.n_ops; i += blockDim.x) {
    const int32_t* op = a.ops + 8 * (int64_t)i;
    const bool scaled =
        a.scale_mode != SCALE_NONE && __ldg(op + 1) != a.dummy;
    const bool rep = i > 0 && repeats(op, scaled);
    if (!rep) last = i + 1;
    if (i < window) skip0[i] = rep;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) s_runs[threadIdx.x >> 5] = last;
  __syncthreads();
  int n_run = 0;
#pragma unroll
  for (int w = 0; w < kReplayBlock / 32; ++w) n_run = max(n_run, s_runs[w]);
  const int windows = (n_run + window - 1) / window;
  stage_window(a, stage, pm_bytes, 0, min(window, n_run), ns, false);
  cp_async_wait_all();
  __syncthreads();
  for (int w = 0; w < windows; ++w) {
    const unsigned char* buf = stage + (w & 1) * buf_bytes;
    const int lo = (w + 1) * window;
    if (lo < n_run)  // the next window, while this one computes
      stage_window(a, stage + ((w + 1) & 1) * buf_bytes, pm_bytes, lo,
                   min(window, n_run - lo), ns, true);
    const T* pm = reinterpret_cast<const T*>(buf);
    const int32_t* ops = reinterpret_cast<const int32_t*>(buf + pm_bytes);
    const int32_t* skip = ops + 8 * window;
    const int cnt = min(window, n_run - w * window);
    for (int k = 0; k < cnt; ++k) {
      if (skip[k]) continue;
      u1_lane<T, S, true>(a, ns, u1_op(ops + 8 * k, a), pm + 2 * k * set,
                          pm + (2 * k + 1) * set, ns * ns + 1, q, n, live);
    }
    cp_async_wait_all();
    __syncthreads();  // the next window landed; this buffer is free
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
  int sp;                      // a P-matrix row: S, or at S not in {4, 20}
                               // S padded to 16 bytes (pad_rows)
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
  constexpr int R = S == kAnyStates ? kMaxAnyStates : S;
  const int pw = S == kAnyStates ? a.sp : S;  // a P-matrix row's values
  const int C = a.rate_cats;
  const int64_t L = a.sites;
  const int64_t row = (int64_t)C * ns * L;
  const int64_t mat = (int64_t)C * ns * pw;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const int64_t srow = per_rate ? (int64_t)C * L : L;
  const int N = a.n_nodes, NS = a.dummy, U = a.n_upd;
  const int width = C * ns;                      // CLV entries a slot
  const int swidth = per_rate ? C : 1;           // counters a slot
  T* pool = reinterpret_cast<T*>(pool_bytes);
  int32_t* spool =
      reinterpret_cast<int32_t*>(pool + (int64_t)a.slots * width * tile);
  const int32_t* table = a.tables + b * a.n_ops * 8;
  Scale<T> u;  // any_op's units: the threshold and factor (no log)
  u.thresh = a.thresh;
  u.factor = a.factor;
  u.log_scale = a.log_scale;
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
      if constexpr (S == kAnyStates)
        any_op<T, R>(RowAt<T>{x1.p, x1.stride}, RowAt<T>{x2.p, x2.stride},
                     out.p, out.stride, matrix(__ldg(op + 3)),
                     matrix(__ldg(op + 6)), RowAt<int32_t>{sc1.p, sc1.stride},
                     RowAt<int32_t>{sc2.p, sc2.stride}, so.p, so.stride,
                     scaled, true, per_rate, C, ns, pw, u);
      else
        op_at_site<T, S>(x1.p, x1.stride, x2.p, x2.stride, out.p,
                         out.stride, matrix(__ldg(op + 3)),
                         matrix(__ldg(op + 6)), sc1.p, sc1.stride, sc2.p,
                         sc2.stride, so.p, so.stride, scaled, per_rate, C,
                         ns, a.thresh, a.factor);
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
        T x[R];
        if constexpr (S == kAnyStates)
          any_child<T, R>(RowAt<T>{chi.p, chi.stride}, c, ns, x);
        else
#pragma unroll
          for (int k = 0; k < ns; ++k)
            x[k] = chi.p[((int64_t)c * ns + k) * chi.stride];
        T term_r = 0;
#pragma unroll
        for (int j = 0; j < ns; ++j) {
          const T pv = par.p[((int64_t)c * ns + j) * par.stride] *
                       __ldg(a.freqs + c * ns + j);
          const T* pr = pe + ((int64_t)c * ns + j) * pw;
          T pc;
          if constexpr (S == kAnyStates)
            pc = dot_row<T, R>(pr, ns, x);
          else
            pc = dot_n<T, R>(pr, x, ns);
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
           int64_t sites, int scale_mode, int dummy, int lanes, int window,
           int grid, int smem, void* stream) {
  if (n_ops < 0 || rate_cats < 1 || states < 2 || states > kMaxAnyStates ||
      sites < 1 || scale_mode < SCALE_NONE || scale_mode > SCALE_PER_RATE ||
      dummy < 0 || !clv || !pmatrix || (n_ops > 0 && !ops) ||
      (scale_mode != SCALE_NONE && !scalers) ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8) || window < 0 ||
      window > n_ops || smem < 0)
    return (int)cudaErrorInvalidValue;
  if (n_ops == 0) return 0;
  // the plan's grid covers every site (a block is kReplayBlock / 32 warps
  // of 32 / lanes sites) and its shared memory holds its stage buffers
  // (two when the table takes more than one window)
  const int64_t need =
      window == 0 ? 0
                  : (window < n_ops ? 2 : 1) *
                        (stage_pm_bytes<T>(window, rate_cats, states) +
                         stage_op_bytes(window));
  if (grid < 1 || (int64_t)grid * (kReplayBlock / lanes) < sites ||
      smem < need)
    return (int)cudaErrorInvalidValue;
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
  a.lanes = lanes;
  a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<grid, kReplayBlock, (size_t)smem, st>>>(a);
    return (int)cudaGetLastError();
  };
  if (states == 4) return launch(replay_kernel<T, 4>);
  if (states == 20) return launch(replay_kernel<T, 20>);
  return launch(replay_kernel<T, kAnyStates>);
}

template <typename T>
int candidates(const CandidateArgs<T>& args, int score, int tile, int smem,
               void* stream) {
  CandidateArgs<T> a = args;
  if (a.n_ops < 1 || a.n_upd < 0 || a.rows < 0 || a.batch < 1 ||
      a.n_nodes < 1 || a.dummy < 0 || a.rate_cats < 1 || a.states < 2 ||
      a.states > kMaxAnyStates || a.sites < 1 ||
      a.sp != (a.states == 4 || a.states == 20
                   ? a.states
                   : (a.states * (int)sizeof(T) + 15) / 16 * 16 /
                         (int)sizeof(T)) ||
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
// for an empty table), laid out by ops/clv.py replay_plan: `lanes` lanes a
// site, `window` ops staged at once (0 stages none), `grid` blocks and
// `smem` bytes of shared memory, refused when they do not cover the sites
// or hold the stage; it returns its cudaError_t (0 on success).  The
// caller vouches for the table's indices: every CLV, matrix and (when
// scaled) scaler index inside its tensor.
extern "C" int replay_ops_f32(void* clv, void* scalers, const void* pmatrix,
                              const int32_t* ops, int n_ops, int rate_cats,
                              int states, int64_t sites, int scale_mode,
                              int dummy, int lanes, int window, int grid,
                              int smem, void* stream) {
  return replay<float>(clv, scalers, pmatrix, ops, n_ops, rate_cats, states,
                       sites, scale_mode, dummy, lanes, window, grid, smem,
                       stream);
}
extern "C" int replay_ops_f64(void* clv, void* scalers, const void* pmatrix,
                              const int32_t* ops, int n_ops, int rate_cats,
                              int states, int64_t sites, int scale_mode,
                              int dummy, int lanes, int window, int grid,
                              int smem, void* stream) {
  return replay<double>(clv, scalers, pmatrix, ops, n_ops, rate_cats, states,
                        sites, scale_mode, dummy, lanes, window, grid, smem,
                        stream);
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
