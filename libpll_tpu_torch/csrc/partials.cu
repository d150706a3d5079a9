// Partition op-table replay (U1) for Hopper (sm_90a), bound to PyTorch
// through ctypes (libpll_tpu_torch/ops/_build.py builds this file;
// libpll_tpu_torch/ops/clv.py wraps it as replay_ops).
//
// Replaces no Pallas kernel: the JAX package runs a Partition's op table as
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
// writes the products unscaled, tracks their maximum over the rates and
// rescales the row in a second pass only when the site scales.  An op equal
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

template <typename T, int S>
__global__ void __launch_bounds__(kReplayBlock)
    replay_kernel(const __grid_constant__ ReplayArgs<T> a) {
  constexpr int R = S == kAnyStates ? kMaxAnyStates : S;
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
    if (i > 0 && p != c1 && p != c2 && !(scaled && (ps == s1 || ps == s2))) {
      bool same = true;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        same = same && __ldg(op + k) == __ldg(op - 8 + k);
      if (same) continue;  // a repeat of an op that is idempotent
    }
    const T* x1 = a.clv + c1 * row + n;
    const T* x2 = a.clv + c2 * row + n;
    T* out = a.clv + p * row + n;
    const T* p1 = a.pmatrix + m1 * mat;
    const T* p2 = a.pmatrix + m2 * mat;
    T site_max = (T)0;
    for (int c = 0; c < C; ++c) {
      // both children's column of rate c before the parent's is written:
      // the parent may be one of them
      T l[R], r[R], v[R];
#pragma unroll
      for (int k = 0; k < ns; ++k) {
        l[k] = x1[((int64_t)c * ns + k) * L];
        r[k] = x2[((int64_t)c * ns + k) * L];
      }
      T mx = (T)0;
#pragma unroll
      for (int j = 0; j < ns; ++j) {
        const int64_t e = ((int64_t)c * ns + j) * ns;
        v[j] = dot_n<T, R>(p1 + e, l, ns) * dot_n<T, R>(p2 + e, r, ns);
        mx = (j == 0 || v[j] > mx) ? v[j] : mx;
      }
      if (per_rate && scaled) {
        const int32_t below = mx < a.thresh;
        if (below)
#pragma unroll
          for (int j = 0; j < ns; ++j) v[j] *= a.factor;
        const int64_t k = (int64_t)c * L + n;
        const int32_t sum =
            a.scalers[s1 * srow + k] + a.scalers[s2 * srow + k] + below;
        a.scalers[ps * srow + k] = sum;
      }
      site_max = (c == 0 || mx > site_max) ? mx : site_max;
#pragma unroll
      for (int j = 0; j < ns; ++j) out[((int64_t)c * ns + j) * L] = v[j];
    }
    if (scaled && !per_rate) {
      const int32_t below = site_max < a.thresh;
      if (below)
        for (int64_t k = 0; k < (int64_t)C * ns; ++k)
          out[k * L] = out[k * L] * a.factor;
      const int32_t sum = a.scalers[s1 * srow + n] + a.scalers[s2 * srow + n] +
                          below;
      a.scalers[ps * srow + n] = sum;
    }
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

extern "C" const char* replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
