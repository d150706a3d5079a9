// Fitch parsimony kernels for Hopper (sm_90a), bound to PyTorch through
// ctypes (libpll_tpu_torch/ops/_build.py builds this file;
// libpll_tpu_torch/ops/fitch.py wraps it).
//
// Port-only kernels: libpll_tpu computes Fitch parsimony in plain XLA with
// jax.lax.population_count (libpll_tpu/ops/fitch.py), no Pallas kernel.
//   P1 fitch_waves      fitch_update / fitch_run_waves   (fitch.py:103,126)
//   P2 fitch_scores     fitch_edge_score(s_batch), fitch_insert_scores
//                       (fitch.py:145,158,172)
//   P3 stepwise_commit  one insertion of _stepwise_range_body, its star
//                       refresh, and _stepwise_final_body (fitch.py:273,408)
//
// Words are uint32 per state and 32 sites, row r of a partition at
// vec + r*S*W, state k's words at + k*W (the [N, S, W] layout of the JAX
// package; PyTorch holds them as int32 bit patterns).  Costs and scores are
// uint32 and wrap as JAX's do.  The Fitch step of one word position:
//   union = OR_k (a_k & b_k);  parent_k = (a_k & b_k) | (~union & (a_k|b_k));
//   cost += popc(~union).
//
// What bounds them: each is a few integer operations per word read (S
// loads of each child, S stores, ~3S logic ops and one popc a word
// position), so device-memory bytes bound P1/P2 on paper; at the stepwise
// build's shapes (a few hundred to a few thousand words a row) the launch
// and, for P3, the latency of each dependent level of the refresh (its
// bookkeeping, one round trip to L2 for the children's words, two block
// barriers) set the time.
//
// Design:
//  * P1: one launch a call, every wave of the table in it (JAX runs a
//    call's waves in one compiled lax.scan for the same reason: each
//    insertion of the host engine costs one device call, not one a
//    dependency level).  ops/fitch.wave_plan splits the words across G
//    blocks as P3's commit_plan does (a block per SLICE_WORDS words, at
//    most one an SM); the Fitch step is independent per word, so block g
//    walks every wave in order over its own slice and waits for no other
//    block: a warp an op (two at once at up to four states where a wave
//    has more ops than warps), its lanes over the slice's words, one
//    __syncthreads between waves; the table and its wave offsets are
//    first copied to shared memory where they fit, so a wave waits on
//    one round trip, its children's words.  A wave's ops run in no order,
//    so none may touch another's rows (the wrapper checks).  Block g
//    writes its slice's popcounts of each op to shares[g, op]; the last
//    block to finish (a counter after __threadfence) sums each op's
//    shares, all ops at once, then forms the costs wave by wave in table
//    order, cost[p] = cost[c1] + cost[c2] + sum_g shares[g, op] (uint32
//    wrap: the unsliced sum's bits).
//  * P2: a warp per edge, lanes over word positions, a warp reduction.
//    Insert mode forms X = fitch(V[u], T) per word in registers and folds
//    it against V[v]; edge rows come from edge_rows/back on the card, so the
//    device build issues P2 with no host read.
//  * P3: G blocks of 512 threads, block g owning a contiguous slice of the
//    words of every partition (ops/fitch.commit_plan picks G from the
//    words and the SMs: a slice of at least 32 words, one warp-width; G = 1
//    below 64 words).  The refresh after a splice is a dependency chain (a
//    row's dirty child is the row that enqueued it), a few rows wide and
//    ~i/4 levels deep at tree size i.  The Fitch step is independent per
//    word, so every block walks the same chain over its own words and no
//    block waits for another: each block does the argmin and the splice
//    on its own copy of `back` and builds the same queue.  Rows come off a
//    FIFO queue in chunks of up to kChunk taken from the queue's state at
//    the chunk's start (so a chunk never holds a row together with its
//    dirty child); each row's two dependents are appended at an exclusive
//    prefix sum of the chunk's live rows (a ballot per warp), so the
//    queue's order does not depend on timing.  `back`, co1, co2, the
//    queue and each entry's source (the queue position of its dirty child)
//    live in shared memory where they fit (n up to ~2 900 taxa), else in a
//    per-block slice of the workspace in device memory, in the same
//    kernel.  A warp takes one row of a chunk at a time (two at up to four
//    states where the chunk has more rows than warps), its lanes over the
//    slice's words; it loads the children's words before it stores any
//    and sums its popcounts with __reduce_add_sync.
//    The only quantity across words is a row's cost, and it is linear:
//    cost[p] = cost[c1] + cost[c2] + mut (uint32 wrap).  Block g keeps its
//    slice's share of each refreshed row, chain_g[k] = mut_g[k] +
//    chain_g[dirty child] (block 0 adds the clean children's costs), in the
//    workspace; the last block to finish (a counter after __threadfence)
//    writes cost = sum over g of chain_g, bit-identical to the unsliced
//    sum, and writes the splice into `back` and `edge_rows`, which P2 reads
//    in the next launch.  The argmin packs (score << 32 | index) into 64
//    bits: the smallest key is the first minimum.  Nothing P3 writes is
//    read through the non-coherent path (no __restrict__ on what it
//    writes); the last block reads the other blocks' shares through L2
//    (__ldcg).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWaveThreads = 512;     // P1: threads a block
constexpr int kWaveWarps = kWaveThreads / 32;
constexpr int kScoreWarps = 8;        // P2: a warp per edge
constexpr int kCommitThreads = 512;   // P3: threads a block
constexpr int kCommitWarps = kCommitThreads / 32;
constexpr int kChunk = 256;           // P3: queue rows a trip
constexpr int kMaxParts = 32;         // fitch.py MAX_PARTS
constexpr int kMaxDevices = 64;       // P3: cards whose smem setting it keeps
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kStar = 0, kInsert = 1, kFinal = 2 };

struct Part {
  uint32_t* vec;
  uint32_t* cost;
  int states;
  int words;
};

struct Parts {
  int n;
  Part p[kMaxParts];
};

// cp.async of 4 bytes from device memory to shared memory; the copies a
// thread issued land by the end of its next wait.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The sum of v over the block (every thread passes its value; the result
// is valid in thread 0).  `scratch` holds one value a warp.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  return total;
}

// ------------------------------------------------------------------ P1
// The ops [begin, end) of one wave over the block's words [lo, hi), R ops
// a warp at once and a lane a word (the table in shared or device
// memory).  With SB > 0 (up to SB states) every
// child word of the R ops is loaded before any parent word is stored, so
// R ops cost one round trip to memory; SB = 0 takes any number of states,
// one op at a time, reading each child word twice.  Lane 0 writes each
// op's popcount to the block's share row.
template <int SB, int R>
__device__ __forceinline__ void wave_ops(uint32_t* vec, int S, int W,
                                         const int32_t* table, int begin,
                                         int end, int lo, int hi,
                                         uint32_t* share) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)S * W;
  for (int k0 = begin + warp; k0 < end; k0 += R * kWaveWarps) {
    const uint32_t* x[R];
    const uint32_t* y[R];
    uint32_t* o[R];
    uint32_t mut[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // a missing second op repeats the first: the same stores again
      const int k = k0 + j * kWaveWarps < end ? k0 + j * kWaveWarps : k0;
      o[j] = vec + table[3 * k] * row;
      x[j] = vec + table[3 * k + 1] * row;
      y[j] = vec + table[3 * k + 2] * row;
      mut[j] = 0;
    }
    if constexpr (SB == 0) {
      for (int w = lo + lane; w < hi; w += 32) {
        uint32_t u = 0;
        for (int k = 0; k < S; ++k) u |= x[0][k * W + w] & y[0][k * W + w];
        for (int k = 0; k < S; ++k) {
          const uint32_t xs = x[0][k * W + w], ys = y[0][k * W + w];
          o[0][k * W + w] = (xs & ys) | (~u & (xs | ys));
        }
        mut[0] += __popc(~u);
      }
    } else {
      for (int w = lo + lane; w < hi; w += 32) {
        uint32_t xs[R][SB], ys[R][SB], u[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          u[j] = 0;
#pragma unroll
          for (int k = 0; k < SB; ++k)
            if (k < S) {
              xs[j][k] = x[j][k * W + w];
              ys[j][k] = y[j][k * W + w];
              u[j] |= xs[j][k] & ys[j][k];
            }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int k = 0; k < SB; ++k)
            if (k < S)
              o[j][k * W + w] = (xs[j][k] & ys[j][k]) |
                                (~u[j] & (xs[j][k] | ys[j][k]));
          mut[j] += __popc(~u[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mut[j] = __reduce_add_sync(kFull, mut[j]);
      const int k = k0 + j * kWaveWarps;
      if (lane == 0 && k < end) share[k] = mut[j];
    }
  }
}

// P1: table holds the ops [n_ops, 3] (parent, child1, child2), then the
// waves' offsets [n_waves + 1]; shares [G, n_ops]; done one counter at 0.
// With `staged`, every block first copies the table to shared memory (and
// the last block forms the ops' totals there); else both stay in device
// memory (the totals in the last block's share row).
__global__ void __launch_bounds__(kWaveThreads)
    fitch_wave_kernel(uint32_t* vec, uint32_t* cost, int S, int W,
                      const int32_t* __restrict__ table, int n_ops,
                      int n_waves, uint32_t* shares, unsigned* done,
                      int staged) {
  extern __shared__ int32_t s_table[];
  __shared__ int s_last;
  const int g = blockIdx.x, G = gridDim.x;
  const int lo = (int)((int64_t)W * g / G);
  const int hi = (int)((int64_t)W * (g + 1) / G);
  const int n_ints = 3 * n_ops + n_waves + 1;
  const int32_t* tab = table;
  if (staged) {
    for (int i = threadIdx.x; i < n_ints; i += blockDim.x)
      cp_async4(s_table + i, table + i);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    tab = s_table;
  }
  const int32_t* offsets = tab + 3 * n_ops;
  uint32_t* share = shares + (int64_t)g * n_ops;
  for (int wave = 0; wave < n_waves; ++wave) {
    const int begin = offsets[wave], end = offsets[wave + 1];
    if (S > 4)
      wave_ops<0, 1>(vec, S, W, tab, begin, end, lo, hi, share);
    else if (end - begin > kWaveWarps)
      wave_ops<4, 2>(vec, S, W, tab, begin, end, lo, hi, share);
    else
      wave_ops<4, 1>(vec, S, W, tab, begin, end, lo, hi, share);
    __syncthreads();  // this wave's rows written; the next reads them
  }

  // the last block to finish forms the costs from the shares
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each op's total over the slices, all at once
  uint32_t* totals =
      staged ? reinterpret_cast<uint32_t*>(s_table + n_ints) : share;
  for (int k = threadIdx.x; k < n_ops; k += blockDim.x) {
    uint32_t total = 0;
    for (int h = 0; h < G; ++h)
      total += __ldcg(shares + (int64_t)h * n_ops + k);
    totals[k] = total;
  }
  __syncthreads();
  // then the costs wave by wave in table order
  for (int wave = 0; wave < n_waves; ++wave) {
    const int begin = offsets[wave], end = offsets[wave + 1];
    for (int k = begin + threadIdx.x; k < end; k += blockDim.x) {
      const int p = tab[3 * k], c1 = tab[3 * k + 1], c2 = tab[3 * k + 2];
      cost[p] = cost[c1] + cost[c2] + totals[k];
    }
    __syncthreads();  // this wave's costs written; the next reads them
  }
  if (threadIdx.x == 0) *done = 0;
}

// ------------------------------------------------------------------ P2
__global__ void __launch_bounds__(kScoreWarps * 32)
    fitch_scores_kernel(const uint32_t* __restrict__ vec,
                        const uint32_t* __restrict__ cost, int S, int W,
                        const int32_t* __restrict__ n1,
                        const int32_t* __restrict__ n2,
                        const int32_t* __restrict__ back, int tip, int E,
                        uint32_t* out, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kScoreWarps + (threadIdx.x >> 5);
  if (e >= E) return;
  const int u = n1[e];
  const int v = n2 ? n2[e] : back[u];
  const int64_t row = (int64_t)S * W;
  const uint32_t* a = vec + u * row;
  const uint32_t* b = vec + v * row;
  uint32_t mut = 0;
  if (tip < 0) {  // edge mode
    for (int w = lane; w < W; w += 32) {
      uint32_t un = 0;
      for (int k = 0; k < S; ++k) un |= __ldg(a + k * W + w) & __ldg(b + k * W + w);
      mut += __popc(~un);
    }
  } else {  // insert mode: X = fitch(V[u], T), then X against V[v]
    const uint32_t* t = vec + tip * row;
    for (int w = lane; w < W; w += 32) {
      uint32_t u1 = 0;
      for (int k = 0; k < S; ++k) u1 |= __ldg(a + k * W + w) & __ldg(t + k * W + w);
      uint32_t u2 = 0;
      for (int k = 0; k < S; ++k) {
        const uint32_t x = __ldg(a + k * W + w), y = __ldg(t + k * W + w);
        u2 |= ((x & y) | (~u1 & (x | y))) & __ldg(b + k * W + w);
      }
      mut += __popc(~u1) + __popc(~u2);
    }
  }
  mut = warp_sum(mut);
  if (lane == 0) {
    const uint32_t s = mut + cost[u] + cost[v];
    out[e] = accumulate ? out[e] + s : s;
  }
}

// ------------------------------------------------------------------ P3
struct CommitArgs {
  int mode;
  int n_tips;
  int rows;          // D = 4n - 6 direction rows
  int shared_tables; // back, co1, co2, queue, sources in shared memory
  const uint32_t* scores;
  int ne, base, tip;
  int32_t* back;
  int32_t* edge_rows;
  const int32_t* co1;
  const int32_t* co2;
  int32_t* tables;   // [G, 3D]: the tables in device memory
  uint32_t* chain;   // [G, P, D]: each block's share of the costs
  unsigned* done;    // blocks finished (the last one resets it to 0)
  uint32_t* finals;
};

__device__ __forceinline__ void final_scores(const Parts& parts,
                                             const CommitArgs& a,
                                             uint32_t* scratch) {
  const int u = a.n_tips, v = a.back[u];
  for (int q = 0; q < parts.n; ++q) {
    const Part P = parts.p[q];
    const int S = P.states, W = P.words;
    const uint32_t* x = P.vec + (int64_t)u * S * W;
    const uint32_t* y = P.vec + (int64_t)v * S * W;
    uint32_t mut = 0;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      uint32_t un = 0;
      for (int k = 0; k < S; ++k) un |= x[k * W + w] & y[k * W + w];
      mut += __popc(~un);
    }
    const uint32_t total = block_sum(mut, scratch);
    if (threadIdx.x == 0) a.finals[q] = total + P.cost[u] + P.cost[v];
    __syncthreads();  // scratch is reused by the next partition
  }
}

// One chunk of P3's refresh as a block sees it: the queue positions
// [head, head + cnt), their rows, children and sources, the block's words
// [lo, hi) and its share of the costs.
struct Level {
  int head, cnt, lo, hi, g;
  const int32_t* queue;
  const int* row;
  const int* c1;
  const int* c2;
  const int* src;
  uint32_t* chain;
};

// The Fitch step of a chunk's rows over the block's words, R rows a warp
// at once and a lane a word.  With SB > 0 (up to SB states) every child
// word of the R rows is loaded into registers before any parent word is
// stored (a store could alias a later load as far as the compiler knows),
// so R rows cost one round trip to memory; SB = 0 takes any number of
// states, one row at a time, reading each child word twice.  Lane 0
// writes each row's share of its cost: its popcounts, the dirty child's
// share (this block wrote it in an earlier chunk) and, in block 0, the
// clean children's whole costs.
template <int SB, int R>
__device__ __forceinline__ void refresh_level(const Part& P, const Level& lv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = P.states, W = P.words;
  const int64_t stride = (int64_t)S * W;
  for (int r0 = warp; r0 < lv.cnt; r0 += R * kCommitWarps) {
    const uint32_t* x[R];
    const uint32_t* y[R];
    uint32_t* o[R];
    uint32_t carry[R], mut[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // a missing second row repeats the first: the same stores again
      const int r = r0 + j * kCommitWarps < lv.cnt ? r0 + j * kCommitWarps : r0;
      const int c1 = lv.c1[r], c2 = lv.c2[r], sp = lv.src[r];
      carry[j] = 0;
      if (lane == 0) {
        if (sp >= 0) carry[j] = lv.chain[sp];
        if (lv.g == 0)
          carry[j] += sp < 0 ? P.cost[c1] + P.cost[c2]
                             : P.cost[c1 == lv.queue[sp] ? c2 : c1];
      }
      x[j] = P.vec + c1 * stride;
      y[j] = P.vec + c2 * stride;
      o[j] = P.vec + lv.row[r] * stride;
      mut[j] = 0;
    }
    if constexpr (SB == 0) {
      for (int w = lv.lo + lane; w < lv.hi; w += 32) {
        uint32_t u = 0;
        for (int k = 0; k < S; ++k) u |= x[0][k * W + w] & y[0][k * W + w];
        for (int k = 0; k < S; ++k) {
          const uint32_t xs = x[0][k * W + w], ys = y[0][k * W + w];
          o[0][k * W + w] = (xs & ys) | (~u & (xs | ys));
        }
        mut[0] += __popc(~u);
      }
    } else {
      for (int w = lv.lo + lane; w < lv.hi; w += 32) {
        uint32_t xs[R][SB], ys[R][SB], u[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          u[j] = 0;
#pragma unroll
          for (int k = 0; k < SB; ++k)
            if (k < S) {
              xs[j][k] = x[j][k * W + w];
              ys[j][k] = y[j][k * W + w];
              u[j] |= xs[j][k] & ys[j][k];
            }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int k = 0; k < SB; ++k)
            if (k < S)
              o[j][k * W + w] = (xs[j][k] & ys[j][k]) |
                                (~u[j] & (xs[j][k] | ys[j][k]));
          mut[j] += __popc(~u[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mut[j] = __reduce_add_sync(kFull, mut[j]);
      const int r = r0 + j * kCommitWarps;
      if (lane == 0 && r < lv.cnt) lv.chain[lv.head + r] = carry[j] + mut[j];
    }
  }
}

__global__ void __launch_bounds__(kCommitThreads)
    stepwise_commit_kernel(const __grid_constant__ Parts parts,
                           const __grid_constant__ CommitArgs a) {
  extern __shared__ int32_t dyn[];
  __shared__ unsigned long long s_key[kCommitWarps];
  __shared__ uint32_t s_sum[kCommitWarps];
  __shared__ int s_row[kChunk], s_c1[kChunk], s_c2[kChunk], s_src[kChunk];
  __shared__ int s_live[kChunk / 32];
  __shared__ int s_head, s_tail, s_u, s_v, s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, G = gridDim.x, D = a.rows;

  if (a.mode == kFinal) {  // each partition's score at the edge of row n
    final_scores(parts, a, s_sum);
    return;
  }

  // the walk's tables: this block's own copy of back, the ring tables, the
  // queue and each entry's source (the queue position of its dirty child)
  int32_t *back, *queue, *src;
  const int32_t *co1, *co2;
  if (a.shared_tables) {
    back = dyn;
    queue = back + D;
    src = queue + D;  // a row is queued at most once: D entries
    int32_t* c1 = src + D;
    int32_t* c2 = c1 + D;
    for (int i = tid; i < D; i += blockDim.x) {
      c1[i] = __ldg(a.co1 + i);
      c2[i] = __ldg(a.co2 + i);
    }
    co1 = c1;
    co2 = c2;
  } else {
    back = a.tables + (int64_t)g * 3 * D;
    queue = back + D;
    src = queue + D;
    co1 = a.co1;
    co2 = a.co2;
  }
  for (int i = tid; i < D; i += blockDim.x) back[i] = a.back[i];

  int first = a.n_tips;  // the star ring
  if (a.mode == kInsert) {
    unsigned long long best = ~0ull;
    for (int e = tid; e < a.ne; e += blockDim.x)
      best = min(best, ((unsigned long long)a.scores[e] << 32) | (unsigned)e);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      best = min(best, __shfl_xor_sync(kFull, best, o));
    if (lane == 0) s_key[warp] = best;
    __syncthreads();  // the keys; this block's copy of back
    if (tid == 0) {
      for (int w = 1; w < kCommitWarps; ++w) best = min(best, s_key[w]);
      const int e = (int)(best & 0xffffffffu);
      const int u = a.edge_rows[e], v = back[u], base = a.base;
      back[u] = base;
      back[base] = u;
      back[v] = base + 1;
      back[base + 1] = v;
      back[a.tip] = base + 2;
      back[base + 2] = a.tip;
      s_u = u;
      s_v = v;
    }
    first = a.base;
  }
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) {
      queue[k] = first + k;
      src[k] = -1;
    }
    s_head = 0;
    s_tail = 3;
  }
  __syncthreads();

  for (;;) {
    const int head = s_head, tail = s_tail;
    if (head >= tail) break;  // the same values in every thread
    const int cnt = min(kChunk, tail - head);
    int live = 0, dep = 0;
    unsigned ballot = 0;
    if (tid < cnt) {
      const int row = queue[head + tid];
      s_row[tid] = row;
      s_c1[tid] = back[co1[row]];
      s_c2[tid] = back[co2[row]];
      s_src[tid] = src[head + tid];
      dep = back[row];
      live = dep >= a.n_tips;
    }
    if (tid < kChunk) {  // whole warps
      ballot = __ballot_sync(kFull, live);
      if (lane == 0) s_live[warp] = __popc(ballot);
    }
    __syncthreads();  // rows, children and live counts visible; head/tail read
    if (live) {
      int before = __popc(ballot & ((1u << lane) - 1));
      for (int w = 0; w < warp; ++w) before += s_live[w];
      const int at = tail + 2 * before;
      queue[at] = co1[dep];
      queue[at + 1] = co2[dep];
      src[at] = src[at + 1] = head + tid;
    }
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < kChunk / 32; ++w) total += s_live[w];
      s_head = head + cnt;
      s_tail = tail + 2 * total;
    }
    // the Fitch step of this block's words, a warp a row (two at once for
    // up to four states)
    for (int q = 0; q < parts.n; ++q) {
      const Part& P = parts.p[q];
      const int lo = (int)((int64_t)P.words * g / G);
      const int hi = (int)((int64_t)P.words * (g + 1) / G);
      uint32_t* chain = a.chain + ((int64_t)g * parts.n + q) * D;
      const Level lv{head, cnt, lo, hi, g, queue, s_row, s_c1, s_c2, s_src,
                     chain};
      if (P.states > 4)
        refresh_level<0, 1>(P, lv);
      else if (cnt > kCommitWarps)
        refresh_level<4, 2>(P, lv);
      else
        refresh_level<4, 1>(P, lv);
    }
    __syncthreads();  // rows and shares written; the queue's new state
  }

  // the last block to finish sums the shares into the costs
  const int n_rows = s_tail;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.done, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = 0; q < parts.n; ++q) {
    uint32_t* cost = parts.p[q].cost;
    for (int k = tid; k < n_rows; k += blockDim.x) {
      uint32_t total = 0;
      for (int h = 0; h < G; ++h)
        total += __ldcg(a.chain + ((int64_t)h * parts.n + q) * D + k);
      cost[queue[k]] = total;
    }
  }
  if (tid == 0) {
    if (a.mode == kInsert) {
      const int base = a.base;
      a.back[s_u] = base;
      a.back[base] = s_u;
      a.back[s_v] = base + 1;
      a.back[base + 1] = s_v;
      a.back[a.tip] = base + 2;
      a.back[base + 2] = a.tip;
      a.edge_rows[a.ne] = base + 1;
      a.edge_rows[a.ne + 1] = base + 2;
    }
    *a.done = 0;
  }
}

int launch_status() { return (int)cudaGetLastError(); }

}  // namespace

// P1, one launch on `stream`: `table` (on the card) holds n_ops ops of
// (parent, child1, child2) and then the n_waves + 1 offsets of the waves
// (wave w is ops [offsets[w], offsets[w+1])); `grid` blocks split the
// words (ops/fitch.wave_plan); `shares` [grid, n_ops] uint32 of workspace
// and `done` one unsigned that is 0 before the launch (and after it);
// `smem` bytes of shared memory for the staged table and the totals
// ((4 n_ops + n_waves + 1) * 4), or 0 to leave both in device memory.
extern "C" int fitch_waves(void* vec, void* cost, int S, int W,
                           const void* table, int n_ops, int n_waves,
                           int grid, void* shares, void* done, int smem,
                           void* stream) {
  if (S < 1 || S > 32 || W < 1 || n_ops < 0 || n_waves < 0 || grid < 1 ||
      smem < 0 || (n_ops > 0 && (!table || !shares || !done)) ||
      (smem > 0 && smem < 4 * (4 * n_ops + n_waves + 1)))
    return (int)cudaErrorInvalidValue;
  if (n_ops == 0) return 0;
  static int allowed[kMaxDevices];  // dynamic shared memory set so far
  int dev = 0;
  if (smem > 48 * 1024 && cudaGetDevice(&dev) == cudaSuccess &&
      (dev >= kMaxDevices || smem > allowed[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fitch_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  fitch_wave_kernel<<<grid, kWaveThreads, (size_t)smem,
                      (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(vec), static_cast<uint32_t*>(cost), S, W,
      static_cast<const int32_t*>(table), n_ops, n_waves,
      static_cast<uint32_t*>(shares), static_cast<unsigned*>(done),
      smem > 0);
  return launch_status();
}

extern "C" int fitch_scores(const void* vec, const void* cost, int S, int W,
                            const void* n1, const void* n2, const void* back,
                            int tip, int E, void* out, int accumulate,
                            void* stream) {
  if (S < 1 || S > 32 || W < 1 || (!n2 && !back))
    return (int)cudaErrorInvalidValue;
  if (E <= 0) return 0;
  const int grid = (E + kScoreWarps - 1) / kScoreWarps;
  fitch_scores_kernel<<<grid, kScoreWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(vec), static_cast<const uint32_t*>(cost),
      S, W, static_cast<const int32_t*>(n1), static_cast<const int32_t*>(n2),
      static_cast<const int32_t*>(back), tip, E, static_cast<uint32_t*>(out),
      accumulate);
  return launch_status();
}

// vecs/costs: host arrays of n_parts device pointers; states/words: host.
// `grid` blocks split the words (grid 1 for the final scores); tables in
// shared memory when `shared_tables`, else in `tables` ([grid, 3D] int32);
// `chain` [grid, n_parts, D] uint32; `done` one unsigned that
// is 0 before the launch (and after it).
extern "C" int stepwise_commit(int mode, int n_parts, const int64_t* vecs,
                               const int64_t* costs, const int32_t* states,
                               const int32_t* words, int n_tips,
                               const void* scores, int ne, int base, int tip,
                               void* back, void* edge_rows, const void* co1,
                               const void* co2, int grid, int shared_tables,
                               void* tables, void* chain,
                               void* done, void* finals, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || mode < kStar || mode > kFinal ||
      grid < 1 || (mode == kFinal && grid != 1) ||
      (mode != kFinal && (!chain || !done || (!shared_tables && !tables))))
    return (int)cudaErrorInvalidValue;
  Parts parts;
  parts.n = n_parts;
  for (int q = 0; q < n_parts; ++q) {
    if (states[q] < 1 || states[q] > 32 || words[q] < 1)
      return (int)cudaErrorInvalidValue;
    parts.p[q] = Part{reinterpret_cast<uint32_t*>(vecs[q]),
                      reinterpret_cast<uint32_t*>(costs[q]), states[q],
                      words[q]};
  }
  const int D = 4 * n_tips - 6;
  CommitArgs a;
  a.mode = mode;
  a.n_tips = n_tips;
  a.rows = D;
  a.shared_tables = shared_tables;
  a.scores = static_cast<const uint32_t*>(scores);
  a.ne = ne;
  a.base = base;
  a.tip = tip;
  a.back = static_cast<int32_t*>(back);
  a.edge_rows = static_cast<int32_t*>(edge_rows);
  a.co1 = static_cast<const int32_t*>(co1);
  a.co2 = static_cast<const int32_t*>(co2);
  a.tables = static_cast<int32_t*>(tables);
  a.chain = static_cast<uint32_t*>(chain);
  a.done = static_cast<unsigned*>(done);
  a.finals = static_cast<uint32_t*>(finals);
  const size_t smem = (mode != kFinal && shared_tables)
                          ? sizeof(int32_t) * 5 * (size_t)D
                          : 0;
  static size_t allowed[kMaxDevices];  // dynamic shared memory set so far
  int dev = 0;
  if (smem > 48 * 1024 && cudaGetDevice(&dev) == cudaSuccess &&
      (dev >= kMaxDevices || smem > allowed[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        stepwise_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  stepwise_commit_kernel<<<grid, kCommitThreads, smem,
                           (cudaStream_t)stream>>>(parts, a);
  return launch_status();
}

// The SM count and the largest dynamic shared memory a block may ask for
// (bytes) on the current device, for ops/fitch.commit_plan.
extern "C" int stepwise_commit_limits(int* sms, int* smem) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
  cudaFuncAttributes attr;
  if (rc == cudaSuccess)
    rc = cudaFuncGetAttributes(&attr, stepwise_commit_kernel);
  if (rc == cudaSuccess) *smem -= (int)attr.sharedSizeBytes;
  return (int)rc;
}

extern "C" const char* fitch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
