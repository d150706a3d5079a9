// Newton branch-length solve on a sumtable (N1) for Hopper (sm_90a), bound
// to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py builds this file;
// libpll_tpu_torch/ops/derivatives.py wraps it and plans its launch).
//
// Replaces no Pallas kernel: the JAX package runs this loop as one
// lax.while_loop inside a compiled program (libpll_tpu/engine/evaluate.py
// :657 and :723), its body libpll_tpu/ops/derivatives.py:71-151
// (likelihood_derivatives).  Eager PyTorch would issue ~35 small operations
// per iteration, and a loop that stops on |d1| would read d1 on the host
// every iteration.
//
// What it computes, on a sumtable st[C, S, L] (the edge's CLVs in the
// eigenbasis, derivatives.update_sumtable):
//   lam[c,j] = eigenvals[c,j] * rates[c] / (1 - pinv[c]);
//   per body, at t: e = exp(lam t) and, per site n < ef,
//     cat_k[c] = sum_j st[c,j,n] * lam^k e          (k = 0, 1, 2)
//     under +I (pinv[c] > 0): cat_0 = cat_0 (1 - p) + freqs[c, inv[n]] p
//       (0 for a variant site), cat_1,2 *= (1 - p)
//     lk_k = sum_c rw[c] cat_k[c]
//     d1 += w[n] (-lk1/lk0),  d2 += w[n] ((lk1/lk0)^2 - lk2/lk0)
//   (ef = sites, or sites + S under Stamatakis, whose pseudo columns count
//   as real sites); under Lewis / Felsenstein the S pseudo columns add
//   their terms from absolute likelihoods (per-site scaler powers, no +I);
//   then step = d1/d2, or d1/|d2| under blopt's rule (libpll_tpu/engine/
//   blopt.py:59, which keeps the step downhill where d2 <= 0), d1 where
//   d2 == 0, and t = clip(t - step, 1e-8, 100).
//   The loop keeps while_loop's semantics: the condition |d1| > 1e-9 and
//   iterations < 32 is tested before each body on the previous body's d1
//   (inf at first), so a body runs in the iteration whose d1 ends the loop.
//
// Design: the whole solve is one cooperative launch.
//  * Every block is resident (the wrapper's planner sizes the grid at one
//    block of kBlock threads an SM at most; cudaLaunchCooperativeKernel
//    refuses a grid that would not be, and the blocks wait on each other)
//    and owns one contiguous slice of block_sites sites.  The bodies loop
//    inside the kernel.  Each block sums its sites' three terms in float64
//    (up to four sites a thread at a time, each staged diagonal entry
//    feeding all of them) and its warps' sums meet in shared memory.
//  * One grid barrier a body, run by warp 0 while the other warps wait at
//    the block's barrier: warp 0 sums the warps' sums; lane 0 stores the
//    block's float64 partials into its slot of buffer k % 2 of
//    partials[2, grid, kSlots], adds one to a counter (zero at launch)
//    with release semantics and alone polls it with acquire semantics
//    until all (k + 1) * grid arrivals are in (cooperative_groups' grid
//    sync does the same, between two block barriers of all threads).  Then
//    warp 0 folds every block's partials in block order, so every block
//    gets the same d1, d2 and t bit for bit, tests the loop's condition
//    itself, stages the next body's e, lam e and lam^2 e in shared memory
//    and releases its warps: two __syncthreads a body.  Every block leaves
//    the loop at the same body; block 0 writes out[] and the body count.
//    The two buffers make one barrier a body enough: a block writes buffer
//    k+1 only after barrier k, and buffer k is next written after barrier
//    k+1, by which time every block has folded it.
//  * Resident slices (the planner's choice where a slice fits a block's
//    shared memory): before body 0 each block copies its slice of the
//    sumtable, the pattern weights and the invariant codes into dynamic
//    shared memory by cp.async, site-innermost ([C*S][stride]), and the
//    bodies read only shared memory.  Streamed slices (a slice that does
//    not fit: the float64 flagship) read the same columns from device
//    memory (L2) every body.  The planner picks by size alone.
//  * A resident launch may take the edge's two rows in place of the
//    sumtable (derivatives.newton_solve_rows): the prologue forms each
//    slice's sumtable columns in shared memory (S dots each of
//    (pi left)^T and right, the per-rate fold), so the step never writes
//    the sumtable to device memory.
//  * Under Lewis / Felsenstein, warp 0 of block 0 sums the S pseudo columns'
//    terms (a lane a column) and stores them in its slot beside its sums;
//    every block reads them after the barrier.
//  * Derivative mode (a non-null `sums`, one body, no asc terms): block 0
//    also writes the body's float64 sums (d1, d2, the real sites' weights)
//    at t0.  A solve whose sites are sharded across processes launches it
//    once an iteration and reduces the sums across the ranks on the host
//    before the step (derivatives.newton_solve_mesh): the one-launch loop
//    cannot wait for another process's sums.
//  * No float atomics and a fixed fold order: two calls give the same bits.
//    The JAX package sums float32 terms in float32; this kernel sums them
//    in float64 and rounds d1 and d2 to the working type before the step.
//
// What bounds it, at the flagship (64 taxa x 262 144 sites, four rates,
// float32): per body ~130 flop a site, 1.1e9 flop for 32 bodies (0.016 ms
// at the FP32 peak); 33.5 MB of rows (or 16.8 MB of sumtable) plus 2.1 MB
// of weights and codes read once (0.011 ms at 3.35 TB/s).  With the slices
// resident, a body reads 143 KB of shared memory an SM (~0.55 us at 128 B
// a clock); the grid barrier and the fold after it are the fixed cost of
// each body (about half of its time on an H100; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "clv_common.cuh"  // Shift<T>, kMaxRates

namespace {

constexpr int kBlock = 512;  // threads per block (derivatives.THREADS)
constexpr int kWarps = kBlock / 32;
constexpr int kSliceAlign = 4;  // a shared row's length, in sites
                                // (derivatives.SLICE_ALIGN)
constexpr int kMaxGrid = 160;   // blocks a launch (derivatives.MAX_GRID)
constexpr int kSlots = 8;       // float64 partials a block and body
                                // (derivatives.PARTIAL_SLOTS)
// slots: d1, d2 and the real sites' weight sum; then, block 0's under
// Lewis / Felsenstein, the pseudo columns' A0, A1, A2 and weight sum
constexpr int kValues = 3, kPseudo = 4;
constexpr int kMaxIters = 32;
constexpr int kAscNone = 0, kAscLewis = 1, kAscFelsenstein = 2,
              kAscStamatakis = 3;
constexpr bool kSiteWork = true;    // false: timing only (no site terms)
constexpr bool kResidentOk = true;  // false: every size streams (timing)
constexpr bool kBarrier = true;     // false: timing only (each block
                                    // folds its own sums alone)

// Sites a thread carries through the rates at once: each staged diagonal
// entry feeds all of them (float64 and 20 states hold fewer in registers).
template <typename T, int S>
__host__ __device__ constexpr int sites_per_thread() {
  return sizeof(T) == 4 && S == 4 ? 4 : 2;
}

template <typename T>
struct NewtonArgs {
  const T* sumtable;  // [C, S, L], or null: formed from the rows below
  const T* clv_p;     // [C, S, L]: the edge's rows, when resident and
  const T* clv_c;     //   the sumtable is null
  const T* lt;        // [C, S, S]: lt[c, j, k] = freqs[c, k] left[c, k, j]
  const T* right;     // [C, S, S]
  const int32_t* rscal_p;  // [C, L] per-rate scaler rows, or null
  const int32_t* rscal_c;
  const T* t0;        // [1]
  const T* rates;     // [C]
  const T* pinv;      // [C]
  const T* evals;     // [C, S]
  const T* freqs;     // [C, S]
  const T* rw;        // [C]
  const int32_t* invariant;  // [L], -1: variant
  const T* weights;          // [L]
  const int32_t* scal_p;     // [L] or null (zeros)
  const int32_t* scal_c;     // [L] or null (zeros)
  double* partials;          // [2, gridDim.x, kSlots]
  unsigned* arrived;         // [1], zero at launch: blocks' arrivals
  int32_t* iterations;       // [1]: bodies run
  T* out;                    // t, d1, d2
  double* sums;              // [3] or null: derivative mode (below)
  int64_t length;            // L: sites + pseudo columns
  int64_t sites;
  int64_t ef;                // sites evaluated as real sites
  int block_sites;           // sites of a block's slice (the last: fewer)
  int stride;                // a resident shared row's length
  int rate_cats;
  int asc_mode;
  int max_iters;
  int abs_d2;  // step d1/|d2| (blopt's rule), else d1/d2
};

// The block's constants and the body's staged diagonals.
template <typename T, int S>
struct Staged {
  T diag[kMaxRates][3][S];  // e, lam e, lam^2 e at the body's t
  T lam[kMaxRates * S];
  T inv_lk[kMaxRates * S];  // freqs[c, j] * pinv[c]: an invariant site's term
  T one_minus[kMaxRates];
  T pinv[kMaxRates];
  T rw[kMaxRates];
  double scratch[kWarps][kValues];  // each warp's sums
  int more;                         // the loop goes on
};

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double dev_abs(double x) { return fabs(x); }

// The warp's sum of v, the same bits in every lane (a butterfly: each
// pair adds the same two values).
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Add one to the counter with release semantics (this thread's stores
// before it reach every reader of the count) and poll it with acquire
// semantics until it reaches `all`.
__device__ __forceinline__ void arrive_and_wait(unsigned* counter,
                                                unsigned all) {
  unsigned seen;
  asm volatile("atom.add.release.gpu.u32 %0, [%1], 1;\n"
               : "=r"(seen)
               : "l"(counter)
               : "memory");
  for (++seen; seen < all;)
    asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                 : "=r"(seen)
                 : "l"(counter)
                 : "memory");
}

// One element from device memory to shared memory by cp.async (through
// L1; 4 or 8 bytes); the copies land by the thread's next wait.
template <typename E>
__device__ __forceinline__ void cp_async_elem(E* dst, const E* src) {
  static_assert(sizeof(E) == 4 || sizeof(E) == 8, "4 or 8 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(E) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// An element of a slice: shared memory when resident, else device memory
// through the read-only path.
template <bool Resident, typename E>
__device__ __forceinline__ E slice_at(const E* p, int64_t i) {
  if constexpr (Resident)
    return p[i];
  else
    return __ldg(p + i);
}

// The float64 terms (d1, d2, real sites' weights) of sites base, base +
// kBlock, ..., U of them, those below `count` added to acc (a site past it
// reads the slice's last site and is dropped).  Resident slices read
// shared memory, streamed ones the device arrays: st, wt and inv point at
// the slice's first site, sumtable rows `row` entries apart.
template <int U, typename T, int S, bool Resident>
__device__ __forceinline__ void site_pass(const NewtonArgs<T>& a,
                                          const Staged<T, S>& sh,
                                          const T* st, const T* wt,
                                          const int32_t* inv, int64_t row,
                                          int64_t first, int count, int base,
                                          double (&acc)[3]) {
  int n[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    n[u] = base + u * kBlock;
    n[u] = n[u] < count ? n[u] : count - 1;
  }
  T lk[U][3];
#pragma unroll
  for (int u = 0; u < U; ++u) lk[u][0] = lk[u][1] = lk[u][2] = (T)0;
  for (int c = 0; c < a.rate_cats; ++c) {
    T cat[U][3];
#pragma unroll
    for (int u = 0; u < U; ++u) cat[u][0] = cat[u][1] = cat[u][2] = (T)0;
    const T* col = st + (int64_t)c * S * row;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const T e0 = sh.diag[c][0][j], e1 = sh.diag[c][1][j],
              e2 = sh.diag[c][2][j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T v = slice_at<Resident>(col, j * row + n[u]);
        cat[u][0] += v * e0;
        cat[u][1] += v * e1;
        cat[u][2] += v * e2;
      }
    }
    const T p = sh.pinv[c], om = sh.one_minus[c], w = sh.rw[c];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p > (T)0) {
        const int code = slice_at<Resident>(inv, n[u]);
        const T inv_lk = code >= 0 ? sh.inv_lk[c * S + code] : (T)0;
        cat[u][0] = cat[u][0] * om + inv_lk;
        cat[u][1] = cat[u][1] * om;
        cat[u][2] = cat[u][2] * om;
      }
      lk[u][0] += w * cat[u][0];
      lk[u][1] += w * cat[u][1];
      lk[u][2] += w * cat[u][2];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (base + u * kBlock >= count) continue;
    const T deriv1 = -lk[u][1] / lk[u][0];
    const T deriv2 = deriv1 * deriv1 - lk[u][2] / lk[u][0];
    const T w = slice_at<Resident>(wt, n[u]);
    acc[0] += (double)(w * deriv1);
    acc[1] += (double)(w * deriv2);
    if (first + n[u] < a.sites) acc[2] += (double)w;
  }
}

// This thread's float64 sums over the block's slice (`count` sites from
// site `first`), in passes of V sites a thread: as many as the slice
// gives a thread, up to sites_per_thread<T, S>().
template <typename T, int S, bool Resident>
__device__ __forceinline__ void site_terms(const NewtonArgs<T>& a,
                                           const Staged<T, S>& sh,
                                           const T* st_s, const T* w_s,
                                           const int32_t* inv_s,
                                           int64_t first, int count,
                                           double (&acc)[3]) {
  constexpr int U = sites_per_thread<T, S>();
  const int64_t row = Resident ? a.stride : a.length;
  const T* st = Resident ? st_s : a.sumtable + first;
  const T* wt = Resident ? w_s : a.weights + first;
  const int32_t* inv = Resident ? inv_s : a.invariant + first;
  const int want = (count + kBlock - 1) / kBlock;
  if constexpr (U >= 4) {
    if (want >= 4) {
      for (int base = threadIdx.x; base < count; base += 4 * kBlock)
        site_pass<4, T, S, Resident>(a, sh, st, wt, inv, row, first, count,
                                     base, acc);
      return;
    }
  }
  if (want >= 2) {
    for (int base = threadIdx.x; base < count; base += 2 * kBlock)
      site_pass<2, T, S, Resident>(a, sh, st, wt, inv, row, first, count,
                                   base, acc);
    return;
  }
  for (int base = threadIdx.x; base < count; base += kBlock)
    site_pass<1, T, S, Resident>(a, sh, st, wt, inv, row, first, count,
                                 base, acc);
}

// Lewis / Felsenstein: the S pseudo columns' absolute terms (A0, A1, A2)
// and weight sum, a lane a column, summed over the warp (every lane).
template <typename T, int S>
__device__ __forceinline__ void pseudo_terms(const NewtonArgs<T>& a,
                                             const Staged<T, S>& sh,
                                             double (&p)[4]) {
  p[0] = p[1] = p[2] = p[3] = 0.0;
  const int j = threadIdx.x & 31;
  if (j < S) {
    // no invariant mixing: p-inv and asc-bias exclude each other
    const int64_t n = a.sites + j;
    T lk[3] = {0, 0, 0};
    for (int c = 0; c < a.rate_cats; ++c) {
      T cat[3] = {0, 0, 0};
      for (int i = 0; i < S; ++i) {
        const T v = a.sumtable[((int64_t)c * S + i) * a.length + n];
        for (int k = 0; k < 3; ++k) cat[k] += v * sh.diag[c][k][i];
      }
      for (int k = 0; k < 3; ++k) lk[k] += sh.rw[c] * cat[k];
    }
    const int sc = (a.scal_p ? a.scal_p[n] : 0) + (a.scal_c ? a.scal_c[n] : 0);
    const T factor = (T)ldexp(1.0, -Shift<T>::bits * sc);
    for (int k = 0; k < 3; ++k) p[k] = (double)(lk[k] * factor);
    p[3] = (double)a.weights[n];
  }
  for (int k = 0; k < 4; ++k) p[k] = warp_sum(p[k]);
}

// A resident slice formed from the edge's two rows (derivatives.
// update_sumtable in the prologue; the sumtable never reaches device
// memory): st[c,j,n] = (sum_k lt[c,j,k] clv_p[c,k,n]) (sum_k right[c,j,k]
// clv_c[c,k,n]), times 2^-(bits diff[c,n]) under per-rate scaling (the
// min/cap fold of likelihood.fold_rate_scalers).
template <typename T, int S>
__device__ __forceinline__ void form_slice(const NewtonArgs<T>& a, T* st_s,
                                           int64_t first, int count) {
  const int C = a.rate_cats;
  for (int n = threadIdx.x; n < count; n += kBlock) {
    const int64_t col = first + n;
    int low = 0;
    if (a.rscal_p) {
      low = a.rscal_p[col] + a.rscal_c[col];
      for (int c = 1; c < C; ++c) {
        const int sc = a.rscal_p[c * a.length + col] +
                       a.rscal_c[c * a.length + col];
        low = sc < low ? sc : low;
      }
    }
    for (int c = 0; c < C; ++c) {
      T factor = (T)1;
      if (a.rscal_p) {
        int d = a.rscal_p[c * a.length + col] +
                a.rscal_c[c * a.length + col] - low;
        d = d < kRateMaxDiff ? d : kRateMaxDiff;
        factor = (T)ldexp(1.0, -Shift<T>::bits * d);
      }
      // the left dots into the slice, then times the right dots (one
      // row's S values held at a time)
      T* out = st_s + (int64_t)c * S * a.stride + n;
      for (int side = 0; side < 2; ++side) {
        const T* rows = side ? a.clv_c : a.clv_p;
        const T* m = (side ? a.right : a.lt) + (int64_t)c * S * S;
        T x[S];
#pragma unroll
        for (int k = 0; k < S; ++k)
          x[k] = rows[((int64_t)c * S + k) * a.length + col];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          T dot = (T)0;
#pragma unroll
          for (int k = 0; k < S; ++k) dot += __ldg(m + j * S + k) * x[k];
          if (side == 0) {
            out[j * a.stride] = dot;
          } else {
            T v = out[j * a.stride] * dot;
            if (a.rscal_p) v = v * factor;
            out[j * a.stride] = v;
          }
        }
      }
    }
  }
}

// e, lam e and lam^2 e at t into the staged diagonals (the lanes of one
// warp, or a block's threads, over the C*S entries).
template <typename T, int S>
__device__ __forceinline__ void stage_diag(Staged<T, S>& sh, int C, T t,
                                           int first, int step) {
  for (int i = first; i < C * S; i += step) {
    const T lam = sh.lam[i];
    const T e = dev_exp(lam * t);
    sh.diag[i / S][0][i % S] = e;
    sh.diag[i / S][1][i % S] = lam * e;
    sh.diag[i / S][2][i % S] = lam * lam * e;
  }
}

// Warp 0, every lane, after the barrier of a body: the sums over all
// blocks of each block's kValues partials, in block order (lane l folds
// blocks l, l + 32, ... in turn, then the lanes in a butterfly), the same
// bits in every block.  Read past L1.
__device__ __forceinline__ void fold(const double* part, int blocks,
                                     double (&f)[kValues]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kValues; ++i) f[i] = 0.0;
#pragma unroll
  for (int r = 0; r < kMaxGrid / 32; ++r) {
    const int b = lane + 32 * r;
    if (b < blocks)
#pragma unroll
      for (int i = 0; i < kValues; ++i)
        f[i] += __ldcg(part + (int64_t)b * kSlots + i);
  }
#pragma unroll
  for (int i = 0; i < kValues; ++i) f[i] = warp_sum(f[i]);
}

template <typename T, int S, bool Resident>
__global__ void __launch_bounds__(kBlock, 1)
    newton_solve_kernel(const __grid_constant__ NewtonArgs<T> a) {
  extern __shared__ __align__(16) unsigned char slice_raw[];
  __shared__ Staged<T, S> sh;
  const int C = a.rate_cats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t first = (int64_t)blockIdx.x * a.block_sites;
  const int count = (int)(a.ef - first < a.block_sites ? a.ef - first
                                                       : a.block_sites);
  const bool asc_terms =
      a.asc_mode == kAscLewis || a.asc_mode == kAscFelsenstein;

  for (int k = tid; k < C * S; k += kBlock) {
    const int c = k / S;
    sh.lam[k] = a.evals[k] * (a.rates[c] / ((T)1 - a.pinv[c]));
    sh.inv_lk[k] = a.freqs[k] * a.pinv[c];
  }
  if (tid < C) {
    sh.pinv[tid] = a.pinv[tid];
    sh.one_minus[tid] = (T)1 - a.pinv[tid];
    sh.rw[tid] = a.rw[tid];
  }
  // the slice, site-innermost: sumtable rows [C*S][stride], weights
  // [stride], invariant codes [stride]
  T* st_s = reinterpret_cast<T*>(slice_raw);
  T* w_s = st_s + (int64_t)C * S * a.stride;
  int32_t* inv_s = reinterpret_cast<int32_t*>(w_s + a.stride);
  if (Resident) {
    if (a.sumtable == nullptr) {
      form_slice<T, S>(a, st_s, first, count);
    } else {
      for (int k = 0; k < C * S; ++k) {
        const T* src = a.sumtable + (int64_t)k * a.length + first;
        for (int n = tid; n < count; n += kBlock)
          cp_async_elem(st_s + (int64_t)k * a.stride + n, src + n);
      }
    }
    for (int n = tid; n < count; n += kBlock) {
      cp_async_elem(w_s + n, a.weights + first + n);
      cp_async_elem(inv_s + n, a.invariant + first + n);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();  // lam staged
  T t = a.t0[0], d1 = (T)0, d2 = (T)0;  // warp 0's
  stage_diag(sh, C, t, tid, kBlock);
  __syncthreads();

  int k = 0;
  for (;; ++k) {
    double acc[kValues] = {0.0, 0.0, 0.0};
    if (kSiteWork)
      site_terms<T, S, Resident>(a, sh, st_s, w_s, inv_s, first, count, acc);
    double pseudo[kPseudo] = {0.0, 0.0, 0.0, 0.0};
    if (asc_terms && blockIdx.x == 0 && warp == 0) pseudo_terms(a, sh, pseudo);
#pragma unroll
    for (int i = 0; i < kValues; ++i) acc[i] = warp_sum(acc[i]);
    if (lane == 0)
      for (int i = 0; i < kValues; ++i) sh.scratch[warp][i] = acc[i];
    __syncthreads();

    // warp 0: publish the block's sums, wait for every block's, fold
    // them, take the step and stage the next body's diagonals; the other
    // warps wait
    if (warp == 0) {
      double v[kValues];
#pragma unroll
      for (int i = 0; i < kValues; ++i)
        v[i] = warp_sum(lane < kWarps ? sh.scratch[lane][i] : 0.0);
      double* part = a.partials + (int64_t)(k & 1) * gridDim.x * kSlots;
      double f[kValues];
      if (kBarrier) {
        if (lane == 0) {
          double* mine = part + (int64_t)blockIdx.x * kSlots;
          for (int i = 0; i < kValues; ++i) mine[i] = v[i];
          if (asc_terms && blockIdx.x == 0)
            for (int i = 0; i < kPseudo; ++i) mine[kValues + i] = pseudo[i];
          arrive_and_wait(a.arrived, (unsigned)(k + 1) * gridDim.x);
        }
        __syncwarp();
        fold(part, (int)gridDim.x, f);
      } else {
#pragma unroll
        for (int i = 0; i < kValues; ++i) f[i] = v[i];
      }
      d1 = (T)f[0];
      d2 = (T)f[1];
      // derivative mode (one body, no asc terms): the body's float64 sums
      // (d1, d2, the real sites' weights) out, for a mesh's ranks to add
      if (a.sums != nullptr && blockIdx.x == 0 && lane == 0)
        for (int i = 0; i < kValues; ++i) a.sums[i] = f[i];
      if (asc_terms) {
        double ps[kPseudo];
        for (int i = 0; i < kPseudo; ++i) ps[i] = __ldcg(part + kValues + i);
        const T a0 = (T)ps[0], a1 = (T)ps[1], a2 = (T)ps[2];
        if (a.asc_mode == kAscLewis) {
          const T sum_w = (T)f[2];
          d1 = d1 + sum_w * (a1 / (a0 - (T)1));
          d2 = d2 + sum_w * (((a0 - (T)1) * a2 - a1 * a1) /
                             ((a0 - (T)1) * (a0 - (T)1)));
        } else {
          const T sum_w_inv = (T)ps[3];
          d1 = d1 - sum_w_inv * (a1 / a0);
          d2 = d2 - sum_w_inv * ((a2 * a0 - a1 * a1) / (a0 * a0));
        }
      }
      const T step =
          d2 != (T)0 ? d1 / (a.abs_d2 ? dev_abs(d2) : d2) : d1;
      const T t_new = t - step;
      // jnp.clip: NaN stays NaN (no fmin/fmax, which would drop it)
      const T lo = (T)1e-8, hi = (T)100;
      t = t_new < lo ? lo : (t_new > hi ? hi : t_new);
      const bool more = dev_abs(d1) > (T)1e-9 && k + 1 < a.max_iters;
      if (more) stage_diag(sh, C, t, lane, 32);
      if (lane == 0) sh.more = more;
    }
    __syncthreads();
    if (!sh.more) break;
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.out[0] = t;
    a.out[1] = d1;
    a.out[2] = d2;
    a.iterations[0] = k + 1;
  }
}

template <typename T, int S>
cudaError_t instance_query(int64_t smem, int32_t* out) {
  // [0]: the dynamic shared memory a resident block may have, after
  // raising the resident instance's limit to it; [1]: SMs; [2]: blocks an
  // SM holds of the instance `smem` picks (resident when smem > 0)
  int device = 0, optin = 0, sms = 0, blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, newton_solve_kernel<T, S, true>);
  if (err != cudaSuccess) return err;
  const int limit = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(newton_solve_kernel<T, S, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err == cudaSuccess)
    err = smem > 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, newton_solve_kernel<T, S, true>, kBlock,
                         (size_t)smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, newton_solve_kernel<T, S, false>, kBlock,
                         0);
  out[0] = limit;
  out[1] = sms;
  out[2] = blocks;
  return err;
}

template <typename T, int S, bool Resident>
cudaError_t launch(NewtonArgs<T>& a, int grid, int64_t smem,
                   cudaStream_t st) {
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      (const void*)newton_solve_kernel<T, S, Resident>, dim3(grid),
      dim3(kBlock), args, (size_t)smem, st);
}

template <typename T>
int solve(int rate_cats, int states, int64_t length, int64_t sites,
          int asc_mode, int max_iters, int abs_d2, int threads, int grid,
          int block_sites, int64_t smem, const void* sumtable,
          const void* clv_p, const void* clv_c, const void* lt,
          const void* right, const int32_t* rscal_p, const int32_t* rscal_c,
          const void* t0, const void* rates, const void* pinv,
          const void* evals, const void* freqs, const void* rw,
          const int32_t* invariant, const void* weights,
          const int32_t* scal_p, const int32_t* scal_c, double* partials,
          unsigned* arrived, int32_t* iterations, void* out, double* sums,
          void* stream) {
  const bool asc_cols = asc_mode != kAscNone;
  const int64_t ef = asc_mode == kAscStamatakis ? sites + states : sites;
  const int stride =
      (block_sites + kSliceAlign - 1) / kSliceAlign * kSliceAlign;
  const int64_t slice = (int64_t)stride * ((int64_t)rate_cats * states *
                                               sizeof(T) +
                                           sizeof(T) + sizeof(int32_t));
  if (rate_cats < 1 || rate_cats > kMaxRates ||
      (states != 4 && states != 20) || sites < 1 || sites > length ||
      (asc_cols && length - sites != states) || asc_mode < kAscNone ||
      asc_mode > kAscStamatakis || max_iters < 1 || max_iters > kMaxIters ||
      threads != kBlock || grid < 1 || grid > kMaxGrid || block_sites < 1 ||
      (int64_t)grid * block_sites < ef ||
      (int64_t)(grid - 1) * block_sites >= ef ||
      (smem != 0 && smem != slice) ||
      (sums != nullptr && (asc_mode != kAscNone || max_iters != 1)) ||
      (sumtable == nullptr &&
       (smem == 0 || !kResidentOk || !clv_p || !clv_c || !lt || !right ||
        asc_mode == kAscLewis || asc_mode == kAscFelsenstein ||
        (rscal_p == nullptr) != (rscal_c == nullptr))))
    return (int)cudaErrorInvalidValue;
  NewtonArgs<T> a;
  a.sumtable = static_cast<const T*>(sumtable);
  a.clv_p = static_cast<const T*>(clv_p);
  a.clv_c = static_cast<const T*>(clv_c);
  a.lt = static_cast<const T*>(lt);
  a.right = static_cast<const T*>(right);
  a.rscal_p = rscal_p;
  a.rscal_c = rscal_c;
  a.t0 = static_cast<const T*>(t0);
  a.rates = static_cast<const T*>(rates);
  a.pinv = static_cast<const T*>(pinv);
  a.evals = static_cast<const T*>(evals);
  a.freqs = static_cast<const T*>(freqs);
  a.rw = static_cast<const T*>(rw);
  a.invariant = invariant;
  a.weights = static_cast<const T*>(weights);
  a.scal_p = scal_p;
  a.scal_c = scal_c;
  a.partials = partials;
  a.arrived = arrived;
  a.iterations = iterations;
  a.out = static_cast<T*>(out);
  a.sums = sums;
  a.length = length;
  a.sites = sites;
  a.ef = ef;
  a.block_sites = block_sites;
  a.stride = stride;
  a.rate_cats = rate_cats;
  a.asc_mode = asc_mode;
  a.max_iters = max_iters;
  a.abs_d2 = abs_d2 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool resident = smem > 0 && kResidentOk;
  cudaError_t err;
  if (states == 4)
    err = resident ? launch<T, 4, true>(a, grid, smem, st)
                   : launch<T, 4, false>(a, grid, 0, st);
  else
    err = resident ? launch<T, 20, true>(a, grid, smem, st)
                   : launch<T, 20, false>(a, grid, 0, st);
  return (int)err;
}

}  // namespace

// Plain C interface for ctypes.  newton_solve_* makes one cooperative
// launch on `stream` with the wrapper's plan (grid, block_sites, smem: the
// resident slice's bytes, or 0 to stream; abs_d2 nonzero: blopt's step)
// and returns its cudaError_t (0 on success); `arrived` must be zero; a
// non-null `sums` [3] asks for the derivative mode (max_iters 1, no asc).  A null `sumtable` forms the
// resident slices from clv_p, clv_c, lt, right (and rscal_p, rscal_c
// under per-rate scaling), outside Lewis and Felsenstein.  newton_query fills out[3] (see
// instance_query) after raising the resident instance's shared-memory
// limit: call it once per process, dtype and alphabet before the first
// solve.

#define SOLVE_PARAMS                                                          \
  int rate_cats, int states, int64_t length, int64_t sites, int asc_mode,     \
      int max_iters, int abs_d2, int threads, int grid, int block_sites,      \
      int64_t smem,                                                           \
      const void *sumtable, const void *clv_p, const void *clv_c,             \
      const void *lt, const void *right, const int32_t *rscal_p,              \
      const int32_t *rscal_c, const void *t0, const void *rates,              \
      const void *pinv, const void *evals, const void *freqs, const void *rw, \
      const int32_t *invariant, const void *weights, const int32_t *scal_p,   \
      const int32_t *scal_c, double *partials, unsigned *arrived,             \
      int32_t *iterations,                                                    \
      void *out, double *sums, void *stream
#define SOLVE_ARGS                                                         \
  rate_cats, states, length, sites, asc_mode, max_iters, abs_d2, threads,  \
      grid, block_sites, smem, sumtable, clv_p, clv_c, lt, right, rscal_p,       \
      rscal_c, t0, rates, pinv, evals, freqs, rw,                          \
      invariant, weights, scal_p, scal_c, partials, arrived, iterations,  \
      out, sums, stream

extern "C" int newton_solve_f32(SOLVE_PARAMS) {
  return solve<float>(SOLVE_ARGS);
}
extern "C" int newton_solve_f64(SOLVE_PARAMS) {
  return solve<double>(SOLVE_ARGS);
}

extern "C" int newton_query(int f64, int states, int64_t smem,
                            int32_t* out) {
  if (states != 4 && states != 20) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (f64)
    err = states == 4 ? instance_query<double, 4>(smem, out)
                      : instance_query<double, 20>(smem, out);
  else
    err = states == 4 ? instance_query<float, 4>(smem, out)
                      : instance_query<float, 20>(smem, out);
  return (int)err;
}

// The device address of pinned host memory (the derivative mode's t and
// sums live there), or an error.
extern "C" int newton_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}

extern "C" const char* newton_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
