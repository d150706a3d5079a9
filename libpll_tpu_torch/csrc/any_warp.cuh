// The block of the warp-a-rate any-alphabet instances, K1/K2 (clv_any.cu)
// and K5/K6 (clv_dyn_any.cu), included by those two files only, so that
// the kernels built on clv_common.cuh alone stay as they are: a tile of
// kTileSites sites, a lane a site and a warp a rate (up to kMaxWarps
// warps, then ceil(C/8) rates a warp); each warp's ring of kDepth (op,
// rate) units of P-matrices filled by cp.async; the k-outer contraction
// over a transposed, zero-padded [R, R] matrix; a chunk's tip codes read
// in bulk; the per-site scaling vote across the warps.  The wrappers take
// the block's sizes from libpll_tpu_torch/ops/any_block.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kAnyMaxStates = 64;
constexpr int kMaxWarps = 8;  // warps a block: a rate each up to eight
constexpr int kDepth = 2;     // a warp's ring: (op, rate) units, two

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kDepth - 1 of the thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  static_assert(kDepth == 2, "the wait's count is kDepth - 1");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// t[j] = sum_k pt[k, j] x[k] for j < R, k-outer over the [R, R] transposed
// matrix (rows from shared memory, or with kGlobal through __ldg): product
// at k = 0, then fma, so each dot is K1's order.
template <typename T, int R, bool kGlobal>
__device__ __forceinline__ void contract_t(const T* pt, const T (&x)[R],
                                           T (&t)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    T p[R];
    load_pm_row<T, R, !kGlobal>(pt + k * R, p);
#pragma unroll
    for (int j = 0; j < R; ++j)
      t[j] = k == 0 ? p[j] * x[0] : dev_fma(p[j], x[k], t[j]);
  }
}

// The tip codes of a chunk of `cnt` staged ops at the tile's sites, in
// bulk (eight loads in flight a thread): codes[j][k][i] = load(ops[j], k,
// d, s) for each child k of op j, d its descriptor ops[j].c[k], that
// tip(ops[j], d) says is a pattern tip (else 0), at the tile's site i, s
// clamped to the last of the L sites.  The caller's barrier makes them
// visible.
template <typename Tip, typename Load>
__device__ __forceinline__ void stage_codes(
    const OpDesc* ops, uint32_t (*codes)[2][kTileSites], int cnt, int64_t L,
    Tip&& tip, Load&& load) {
  constexpr int kBatch = 8;
  const int total = cnt * 2 * kTileSites;
  for (int it0 = threadIdx.x; it0 < total; it0 += kBatch * blockDim.x) {
    uint32_t v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = it0 + b * blockDim.x;
      v[b] = 0;
      if (it >= total) continue;
      const OpDesc& o = ops[it / (2 * kTileSites)];
      const int k = (it / kTileSites) & 1;
      const int d = o.c[k];
      if (!tip(o, d)) continue;
      const int64_t at = (int64_t)blockIdx.x * kTileSites + it % kTileSites;
      v[b] = load(o, k, d, at < L ? at : L - 1);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = it0 + b * blockDim.x;
      if (it < total)
        codes[it / (2 * kTileSites)][(it / kTileSites) & 1]
             [it % kTileSites] = v[b];
    }
  }
}

// The per-site vote of an op that may scale, across the block's W warps
// (this thread warp w's lane): whether every rate of the lane's site is
// below the threshold (each warp's `below` over its rates: a ballot, then
// one barrier).  `votes` is double-buffered: the caller flips `vb` after
// each vote, so that a barrier lies between two uses of one buffer.
__device__ __forceinline__ bool site_vote_warps(bool below,
                                                unsigned (*votes)[kMaxWarps],
                                                int vb, int W, int w,
                                                int lane) {
  const unsigned small = __ballot_sync(0xffffffffu, below);
  if (lane == 0) votes[vb][w] = small;
  __syncthreads();
  unsigned all = 0xffffffffu;
  for (int k = 0; k < W; ++k) all &= votes[vb][k];
  return (all >> lane) & 1u;
}

// ------------------------------------------------------------------ host
// The bound R of the instance that takes `states` (any_block.any_bound).
inline int any_bound(int states) {
  return states <= 4 ? 4 : states <= 8 ? 8 : states <= 16 ? 16
                                                            : kAnyMaxStates;
}

// Warps a block for C rates: one a rate up to kMaxWarps, then ceil(C/8)
// rates a warp (any_block.any_warps).
inline int any_warps(int rate_cats) {
  const int per = (rate_cats + kMaxWarps - 1) / kMaxWarps;
  return (rate_cats + per - 1) / per;
}

}  // namespace
