// Device pieces shared by the port's likelihood kernels (clv_fused.cu,
// clv_dyn.cu, clv_seg.cu): encodings, scaling units, the f32/f64 math
// overloads, the per-site and per-rate scaling test and the per-rate
// scaler fold of the edge log-likelihood.  Then what the pool kernels
// share: op descriptors, the P-matrices staged per chunk of ops and their
// rows read as vectors; and what clv_dyn.cu and clv_seg.cu share: a block
// of 32 sites by C rates, the shared-memory pool of live rows, the
// per-site scaling vote, the gather of a site's rate terms at the edge and
// the 32-site partial.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;    // threads per block of clv_fused.cu
constexpr int kRateMaxDiff = 4;  // SCALE_RATE_MAXDIFF
constexpr int kMaxRates = 8;

enum { TIP_CLV = 0, TIP_CHARS = 1, TIP_MASKS = 2 };
enum { SCALE_NONE = 0, SCALE_PER_SITE = 1, SCALE_PER_RATE = 2 };

// One scaling event multiplies by 2^bits (the reference's 2^256 at double,
// 2^32 at float).
template <typename T> struct Shift;
template <> struct Shift<float> { static constexpr int bits = 32; };
template <> struct Shift<double> { static constexpr int bits = 256; };

// The scaling units of one dtype: the threshold 2^-bits, the factor 2^bits
// and log(2^-bits), each exact or correctly rounded in T.
template <typename T>
struct Scale {
  T thresh, factor, log_scale;
};

template <typename T>
Scale<T> scale_units() {
  Scale<T> s;
  s.factor = (T)std::ldexp(1.0, Shift<T>::bits);
  s.thresh = (T)std::ldexp(1.0, -Shift<T>::bits);
  s.log_scale = (T)(-Shift<T>::bits * 0.69314718055994530942);
  return s;
}

__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }
__device__ __forceinline__ float dev_fma(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double dev_fma(double x, double y, double z) {
  return fma(x, y, z);
}

// sum_d row[d] * x[d], in K1's order.
template <typename T, int S>
__device__ __forceinline__ T dot(const T* row, const T (&x)[S]) {
  T acc = __ldg(row) * x[0];
#pragma unroll
  for (int d = 1; d < S; ++d) acc = dev_fma(__ldg(row + d), x[d], acc);
  return acc;
}

// The scaling vote of one block of values: true when every value is below
// 2^-bits.  A NaN anywhere makes it false, as JAX's jnp.all(x < thresh)
// (libpll_tpu/ops/clv.py:90,93) and the plain versions' amax do; a running
// maximum by `v > mx` would skip a NaN after the first entry.  Per rate the
// block is one rate's S values; per site it is the site's C*S values.
template <typename T, int S>
__device__ __forceinline__ bool all_below(const T (&t)[S], T thresh) {
  bool below = true;
#pragma unroll
  for (int s = 0; s < S; ++s) below &= t[s] < thresh;
  return below;
}

// The scaling test of one rate's values: when a node that may scale has
// every value below 2^-bits, the values are multiplied by 2^bits.  Returns
// the counter's increment (0 or 1).
template <typename T, int S>
__device__ __forceinline__ int scale_rate(bool has, T (&t)[S],
                                          const Scale<T>& u) {
  if (!(has && all_below<T, S>(t, u.thresh))) return 0;
#pragma unroll
  for (int s = 0; s < S; ++s) t[s] *= u.factor;
  return 1;
}

// Rate c's term of the edge sum: sum_s pv[s] (P x)[s] w[c*S + s], with pe
// the edge's [C, S, S] P-matrices and w the [C*S] weight vector.
template <typename T, int S>
__device__ __forceinline__ T edge_rate_term(const T* pe, int c,
                                            const T (&pv)[S],
                                            const T (&x)[S], const T* w) {
  T acc = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    acc = dev_fma(pv[s] * dot<T, S>(pe + (c * S + s) * S, x),
                  __ldg(w + c * S + s), acc);
  return acc;
}

// The per-rate counters sn of one site folded as the reference does
// (src/core_likelihood.c:916-941): the site's counter is their minimum, and
// each rate's term is multiplied by 2^-bits once per count above it, at
// most kRateMaxDiff times.  Returns the sum of the folded terms; the
// site's counter goes to snum.
template <typename T>
__device__ __forceinline__ T fold_rates(T (&term_r)[kMaxRates],
                                        const int (&sn)[kMaxRates], int C,
                                        T thresh, int& snum) {
  snum = 0;
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    snum = (c == 0 || sn[c] < snum) ? sn[c] : snum;
  }
  T term = 0;
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    const int diff = min(sn[c] - snum, kRateMaxDiff);
    for (int k = 0; k < diff; ++k) term_r[c] *= thresh;
    term += term_r[c];
  }
  return term;
}

// A site's weighted log-likelihood from its summed term and counter.
template <typename T>
__device__ __forceinline__ T site_lnl(T term, int snum, const Scale<T>& u,
                                      T pattern_weight) {
  return (dev_log(term) + (T)snum * u.log_scale) * pattern_weight;
}

// ---------------------------------------------------------------------------
// The pool kernels (clv_dyn.cu, clv_seg.cu)
// ---------------------------------------------------------------------------
constexpr int kTileSites = 32;  // sites per block, and per partial sum
constexpr int kChunk = 16;      // ops staged at once

// DNA stages each chunk's P-matrices in shared memory (8 KB of float32 at
// four rates); protein reads its rate rows (1.6 KB) from L1/L2.
template <int S>
constexpr bool kStagePm = S == 4;

// What one thread is: rate c of site `site` (clamped to the last site for
// loads past the end; `live` says whether it is a real site).  Warp c of a
// block runs rate c of the tile's 32 sites, lane sl site sl.
struct Lane {
  int c;
  int sl;  // site within the tile
  int64_t site;
  bool live;
};

// The shared-memory pool of a block, laid out [slot, S, nt] (one column
// per thread, nt = 32 * C threads) with its counters [slot, 32] (per rate
// [slot, nt]), and the P-matrices of the staged ops (DNA).  A site's
// counter (one per node) is read and written by warp 0 only.
template <typename T>
struct Pool {
  T* clv;
  int32_t* scal;
  T* pm;       // [kChunk, 2, C, S, S], or null (S = 20)
  int nt;      // threads per block
  int sstride; // counters per slot
};

// Value 0 of the thread's column of pool slot `slot`; value e is e * nt
// further.
template <int S>
__device__ __forceinline__ int pool_at(int slot, int nt) {
  return slot * S * nt + threadIdx.x;
}

// The thread's counter in a slot: its site's (warp 0's), or per rate its
// own.
__device__ __forceinline__ int scal_at(bool per_rate, int slot,
                                       const Lane& ln, int sstride) {
  return slot * sstride + (per_rate ? (int)threadIdx.x : ln.sl);
}

// 16-byte vector loads of a P-matrix row.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T, int S, bool kShared>
__device__ __forceinline__ void load_pm_row(const T* row, T (&p)[S]) {
  using V = typename Vec16<T>::type;
  constexpr int n = Vec16<T>::n;
  static_assert(S % n == 0, "P-matrix rows load as whole vectors");
  const V* v = reinterpret_cast<const V*>(row);
#pragma unroll
  for (int k = 0; k < S / n; ++k) {
    const V w = kShared ? v[k] : __ldg(v + k);
    if constexpr (n == 4) {
      p[4 * k] = w.x; p[4 * k + 1] = w.y;
      p[4 * k + 2] = w.z; p[4 * k + 3] = w.w;
    } else {
      p[2 * k] = w.x; p[2 * k + 1] = w.y;
    }
  }
}

// sum_d p[d] * x[d], in K1's order (dot above).
template <typename T, int S>
__device__ __forceinline__ T dot_regs(const T (&p)[S], const T (&x)[S]) {
  T acc = p[0] * x[0];
#pragma unroll
  for (int d = 1; d < S; ++d) acc = dev_fma(p[d], x[d], acc);
  return acc;
}

// t = (P1 x1) * (P2 x2) for the thread's rate (p1, p2 at its [S, S]
// block): P rows from the staged chunk (kShared) or from device memory.
template <typename T, int S, bool kShared>
__device__ __forceinline__ void contract(const T* p1, const T* p2,
                                         const T (&x1)[S], const T (&x2)[S],
                                         T (&t)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T row[S];
    load_pm_row<T, S, kShared>(p1 + s * S, row);
    t[s] = dot_regs<T, S>(row, x1);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T row[S];
    load_pm_row<T, S, kShared>(p2 + s * S, row);
    t[s] *= dot_regs<T, S>(row, x2);
  }
}

// An op as the block stages it in shared memory: the parent's local row
// (-1 for a pad op) and home, the children's and their counters' sources
// as (kind << 28 | index) (K_ZERO for no counter), the matrices, the
// scaling flag and, for clv_seg.cu, the device row the parent is also
// written to (-1 for none).  16-byte aligned: three vector loads read one.
enum { K_TIP = 0, K_IMP = 1, K_POOL = 2, K_SPILL = 3 };
constexpr int K_ZERO = -1;
constexpr int kIndexBits = 28;

struct __align__(16) OpDesc {
  int parent, home, c[2], s[2], m[2], has, out, pad[2];
};

__device__ __forceinline__ int desc(int kind, int index) {
  return (kind << kIndexBits) | index;
}
__device__ __forceinline__ int kind_of(int d) { return d >> kIndexBits; }
__device__ __forceinline__ int index_of(int d) {
  return d & ((1 << kIndexBits) - 1);
}

// The P-matrices of a chunk's ops in shared memory, [j, k, C, S, S], read
// in bulk as 16-byte vectors (kBatch in flight per thread): the ops then
// read them from shared memory, not from L2 one op at a time.  Pad ops
// (parent < 0) are skipped.
template <typename T, int S>
__device__ void stage_pmatrices(const T* pmatrix, int rate_cats,
                                const OpDesc* ops, int n, T* pm) {
  using V = typename Vec16<T>::type;
  constexpr int kBatch = 4;
  const int per = rate_cats * S * S / Vec16<T>::n;  // vectors a matrix
  const int64_t pm_size = (int64_t)rate_cats * S * S;
  const int total = n * 2 * per;
  for (int it0 = threadIdx.x; it0 < total; it0 += kBatch * blockDim.x) {
    V w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * blockDim.x;
      const int j = it / (2 * per), k = (it / per) & 1;
      if (it < total && ops[j].parent >= 0)
        w[u] = __ldg(reinterpret_cast<const V*>(pmatrix +
                                                ops[j].m[k] * pm_size) +
                     it % per);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * blockDim.x;
      if (it < total && ops[it / (2 * per)].parent >= 0)
        reinterpret_cast<V*>(pm)[it] = w[u];
    }
  }
}

// The per-site scaling test of one op: a site scales when all its C*S
// values are small, so each rate's warp votes and one block barrier shows
// every warp the C votes (votes[vb], vb alternating: a barrier lies
// between two uses of one buffer).  Every thread of the block must call
// it.  Returns whether the thread's site scales.
template <typename T, int S>
__device__ __forceinline__ bool site_vote(const T (&t)[S], const Scale<T>& u,
                                          int C, const Lane& ln,
                                          unsigned (*votes)[kMaxRates],
                                          int& vb) {
  const unsigned small =
      __ballot_sync(0xffffffffu, all_below<T, S>(t, u.thresh));
  if ((threadIdx.x & 31) == 0) votes[vb][ln.c] = small;
  __syncthreads();
  unsigned all = 0xffffffffu;
  for (int c = 0; c < C; ++c) all &= votes[vb][c];
  vb ^= 1;
  return (all >> ln.sl) & 1u;
}

// At the edge every thread gathers its site's C rate terms and counters
// from term_s/sn_s [C, 32] (the C warps wrote them before a barrier) and
// sums them in rate order, per rate through the reference's fold; the
// site's counter goes to snum (per site: warp 0's, the node's counter).
template <typename T>
__device__ __forceinline__ T site_term(const T* term_s, const int* sn_s,
                                       int C, const Lane& ln, bool per_rate,
                                       T thresh, int& snum) {
  T term_r[kMaxRates];
  int sn[kMaxRates];
#pragma unroll
  for (int c = 0; c < kMaxRates; ++c) {
    if (c >= C) break;
    term_r[c] = term_s[c * kTileSites + ln.sl];
    sn[c] = sn_s[c * kTileSites + ln.sl];
  }
  T term = 0;
  if (per_rate) {
    term = fold_rates<T>(term_r, sn, C, thresh, snum);
  } else {
#pragma unroll
    for (int c = 0; c < kMaxRates; ++c) {
      if (c >= C) break;
      term += term_r[c];
    }
    snum = sn[0];
  }
  return term;
}

// Warp 0's sum of the tile's 32 per-site values in one warp's shuffle
// tree (the first fused kernel's order), stored at out[blockIdx.x].
__device__ void tile_sum_store(double v, double* out) {
  if (threadIdx.x >= 32) return;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// ---------------------------------------------------------------- any S
// The any-alphabet op (clv_any.cu's K1/K2, partials.cu's C1,
// clv_dyn_any.cu's K5/K6 and clv_seg_any.cu's K3/K4 at S not in {4, 20}):
// the state loops run to a compile-time bound R with the states past S
// masked, the P-matrices in rows padded with zeros to whole 16-byte
// vectors (clv_fused.pad_rows), read as vectors in K1's dot order (a zero
// entry adds 0 * 0, which changes no bit).
// R at or below which a row's state loop is unrolled whole
constexpr int kAnyUnrolled = 16;

// A row's entries at one site: entry (c, k) at p[(c*ns + k) * stride].
template <typename T>
struct RowAt {
  const T* p;
  int64_t stride;
  __device__ __forceinline__ T operator()(int c, int k, int ns) const {
    return p[((int64_t)c * ns + k) * stride];
  }
};

// A pattern tip's 0/1 entries: bit k of its code, at every rate.
template <typename T>
struct CodeAt {
  uint32_t code;
  __device__ __forceinline__ T operator()(int, int k, int) const {
    return (T)((code >> k) & 1u);
  }
};

// f(j) for each state j < ns: unrolled whole at R <= kAnyUnrolled, so that
// arrays indexed by j stay in registers, else a loop.
template <int R, typename F>
__device__ __forceinline__ void each_state(int ns, F&& f) {
  if constexpr (R <= kAnyUnrolled) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j >= ns) break;
      f(j);
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < ns; ++j) f(j);
  }
}

// Rate c's child values into x (0 past ns), always in registers.
template <typename T, int R, typename X>
__device__ __forceinline__ void any_child(const X& child, int c, int ns,
                                           T (&x)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) x[k] = k < ns ? child(c, k, ns) : (T)0;
}

// sum_k row[k] x[k] in K1's order, the padded row read as 16-byte vectors
// (its zeros past ns meet zeros in x).
template <typename T, int R>
__device__ __forceinline__ T dot_row(const T* row_p, int ns,
                                     const T (&x)[R]) {
  using V = typename Vec16<T>::type;
  constexpr int n = Vec16<T>::n;
  const V* row = reinterpret_cast<const V*>(row_p);
  T acc = 0;
#pragma unroll
  for (int q = 0; q < R / n; ++q) {
    if (q * n >= ns) break;
    const V w = __ldg(row + q);
    if constexpr (n == 4) {
      acc = q == 0 ? w.x * x[0] : dev_fma(w.x, x[4 * q], acc);
      acc = dev_fma(w.y, x[4 * q + 1], acc);
      acc = dev_fma(w.z, x[4 * q + 2], acc);
      acc = dev_fma(w.w, x[4 * q + 3], acc);
    } else {
      acc = q == 0 ? w.x * x[0] : dev_fma(w.x, x[2 * q], acc);
      acc = dev_fma(w.y, x[2 * q + 1], acc);
    }
  }
  return acc;
}

// t[j] (=, or *= when kMul) sum_k pm[j, k] x[k] for j < ns: pm is one
// rate's [ns, sp] padded rows.
template <typename T, int R, bool kMul>
__device__ __forceinline__ void contract_any(const T* pm, int ns, int sp,
                                             const T (&x)[R], T (&t)[R]) {
  each_state<R>(ns, [&](int j) {
    const T acc = dot_row<T, R>(pm + (int64_t)j * sp, ns, x);
    t[j] = kMul ? t[j] * acc : acc;
  });
}

// One op at one site (U1's semantics, partials.cu): per rate c the two
// children's products, the vote and the counters.  out: the parent's row
// (entry (c, k) (c*ns + k) strides of lo further), which may be a child's:
// a rate's child values are read before its products are written.  The
// counters (sc1, sc2 in, sout out; rate c c strides further) are read and
// written only when `counts`; the products scale only where `may` (the
// op's flag) holds.  Per-site scaling stores the products unscaled and
// rescales the row where every rate voted small.  The vote is all_below's:
// a NaN anywhere means no scaling, as in JAX.
template <typename T, int R, typename X1, typename X2>
__device__ __forceinline__ void any_op(
    const X1& x1, const X2& x2, T* out, int64_t lo, const T* p1,
    const T* p2, RowAt<int32_t> sc1, RowAt<int32_t> sc2, int32_t* sout,
    int64_t lso, bool counts, bool may, bool per_rate, int C, int ns,
    int sp, const Scale<T>& u) {
  bool site_below = true;
  for (int c = 0; c < C; ++c) {
    T x[R], t[R];
    const int64_t m = (int64_t)c * ns * sp;
    any_child<T, R>(x1, c, ns, x);
    contract_any<T, R, false>(p1 + m, ns, sp, x, t);
    any_child<T, R>(x2, c, ns, x);
    contract_any<T, R, true>(p2 + m, ns, sp, x, t);
    bool below = may;
    each_state<R>(ns, [&](int j) { below &= t[j] < u.thresh; });
    if (per_rate && counts) {
      if (below) each_state<R>(ns, [&](int j) { t[j] *= u.factor; });
      sout[c * lso] = sc1(0, c, 1) + sc2(0, c, 1) + (int32_t)below;
    }
    site_below &= below;
    each_state<R>(ns, [&](int j) { out[((int64_t)c * ns + j) * lo] = t[j]; });
  }
  if (counts && !per_rate) {
    if (site_below)
      for (int64_t k = 0; k < (int64_t)C * ns; ++k)
        out[k * lo] = out[k * lo] * u.factor;
    sout[0] = sc1(0, 0, 1) + sc2(0, 0, 1) + (int32_t)site_below;
  }
}

// A row's entries at one site where the kind is known only at run time
// (the large tiers' exports and edge): values at p (entry (c, k) at
// (c*ns + k) strides further), or a pattern tip's code; code 0 with
// `coded` is a row of zeros.
template <typename T>
struct AnyRow {
  const T* p;
  int64_t stride;
  uint32_t code;
  bool coded;
  __device__ __forceinline__ T operator()(int c, int k, int ns) const {
    return coded ? (T)((code >> k) & 1u) : p[((int64_t)c * ns + k) * stride];
  }
};

// The edge's summed term at one site, any alphabet and rate count (the
// large tiers' any instances): per rate c, sum_j par(c, j) (P_e[c]
// x_c)(j) w[c*ns + j] with x_c the child's values, rates summed in order.
// The counters (cp, cc: rate c c strides further) give the site's counter
// snum: per site their sum; per rate the minimum over rates of their sum,
// each rate's term multiplied by 2^-bits once per count above it, at most
// kRateMaxDiff times (fold_rates' rule, src/core_likelihood.c:916-941).
template <typename T, int R>
__device__ __forceinline__ T any_edge_term(
    const AnyRow<T>& par, const AnyRow<T>& ch, const T* pe, const T* w,
    RowAt<int32_t> cp, RowAt<int32_t> cc, bool counts, bool per_rate,
    int C, int ns, int sp, T thresh, int& snum) {
  snum = 0;
  if (counts && per_rate) {
    for (int c = 0; c < C; ++c) {
      const int s = cp(0, c, 1) + cc(0, c, 1);
      snum = (c == 0 || s < snum) ? s : snum;
    }
  } else if (counts) {
    snum = cp(0, 0, 1) + cc(0, 0, 1);
  }
  T term = 0;
  for (int c = 0; c < C; ++c) {
    T x[R], tb[R];
    any_child<T, R>(ch, c, ns, x);
    contract_any<T, R, false>(pe + (int64_t)c * ns * sp, ns, sp, x, tb);
    T tc = 0;
    each_state<R>(ns, [&](int j) {
      tc = dev_fma(par(c, j, ns) * tb[j], __ldg(w + c * ns + j), tc);
    });
    if (counts && per_rate) {
      const int diff =
          min(cp(0, c, 1) + cc(0, c, 1) - snum, kRateMaxDiff);
      for (int k = 0; k < diff; ++k) tc *= thresh;
    }
    term += tc;
  }
  return term;
}

// Warp-wide sum of one float64 per site in the first kernel's order, lane
// 0's stored at out[group] when group < n (the large tiers' any
// instances: a warp is 32 consecutive sites).
__device__ __forceinline__ void warp_sum_store(double v, double* out,
                                               int64_t group, int64_t n) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && group < n) out[group] = v;
}

// ------------------------------------------------------------------ host
// Raise `kernel`'s limit of dynamic shared memory to all a block may have
// (so that every launch of a layout given for it is taken) and prefer
// shared memory to L1.  limit: those bytes; sms: the card's SMs.
template <typename K>
cudaError_t open_kernel(K* kernel, int* limit, int* sms) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *limit = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace
