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
// and, for P3, the chain of dependent global loads between a block's
// barriers set the time.
//
// Design:
//  * P1: a block per op of one wave (blocks of a wave run in no order, so a
//    wave's ops must not touch each other's rows: the wrapper checks), the
//    threads over word positions, a block reduction of the popcounts; one
//    launch per wave, the waves launched in order from one C call.
//  * P2: a warp per edge, lanes over word positions, a warp reduction.
//    Insert mode forms X = fitch(V[u], T) per word in registers and folds
//    it against V[v]; edge rows come from edge_rows/back on the card, so the
//    device build issues P2 with no host read.
//  * P3: ONE block of 1 024 threads.  The refresh after a splice is a
//    dependency chain (a row's dirty child is the row that enqueued it), a
//    few rows wide and ~i/4 levels deep at tree size i, so a grid barrier a
//    level would cost more than the level's work; __syncthreads is cheap.
//    Rows come off a FIFO queue in device memory in chunks of up to kChunk
//    taken from the queue's state at the chunk's start (so a chunk never
//    holds a row together with its dirty child); each row's two dependents
//    are appended at an exclusive prefix sum of the chunk's live rows (a
//    ballot per warp), so the queue's order does not depend on timing.
//    The argmin packs (score << 32 | index) into 64 bits: the smallest key
//    is the first minimum.  Nothing P3 writes is read through the
//    non-coherent path (no __restrict__ on what it writes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWaveThreads = 128;     // P1: a block per op
constexpr int kScoreWarps = 8;        // P2: a warp per edge
constexpr int kCommitThreads = 1024;  // P3: one block
constexpr int kChunk = 256;           // P3: queue rows a trip (fitch.py QUEUE_CHUNK)
constexpr int kMaxParts = 32;         // fitch.py MAX_PARTS
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
__global__ void __launch_bounds__(kWaveThreads)
    fitch_wave_kernel(uint32_t* vec, uint32_t* cost, int S, int W,
                      const int32_t* __restrict__ ops) {
  __shared__ uint32_t scratch[kWaveThreads / 32];
  const int p = ops[3 * blockIdx.x], c1 = ops[3 * blockIdx.x + 1],
            c2 = ops[3 * blockIdx.x + 2];
  const int64_t row = (int64_t)S * W;
  const uint32_t* a = vec + c1 * row;
  const uint32_t* b = vec + c2 * row;
  uint32_t* o = vec + p * row;
  uint32_t mut = 0;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    uint32_t u = 0;
    for (int k = 0; k < S; ++k) u |= a[k * W + w] & b[k * W + w];
    for (int k = 0; k < S; ++k) {
      const uint32_t x = a[k * W + w], y = b[k * W + w];
      o[k * W + w] = (x & y) | (~u & (x | y));
    }
    mut += __popc(~u);
  }
  const uint32_t total = block_sum(mut, scratch);
  if (threadIdx.x == 0) cost[p] = cost[c1] + cost[c2] + total;
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
__global__ void __launch_bounds__(kCommitThreads)
    stepwise_commit_kernel(int mode, Parts parts, int n_tips,
                           const uint32_t* scores, int ne, int base, int tip,
                           int32_t* back, int32_t* edge_rows,
                           const int32_t* co1, const int32_t* co2,
                           int32_t* queue, uint32_t* finals) {
  __shared__ unsigned long long s_key[kCommitThreads / 32];
  __shared__ uint32_t s_sum[kCommitThreads / 32];
  __shared__ int s_row[kChunk], s_c1[kChunk], s_c2[kChunk];
  __shared__ uint32_t s_mut[kChunk];
  __shared__ int s_live[kChunk / 32];
  __shared__ int s_head, s_tail;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (mode == kFinal) {  // each partition's score at the edge of row n
    const int u = n_tips, v = back[u];
    for (int q = 0; q < parts.n; ++q) {
      const Part P = parts.p[q];
      const int S = P.states, W = P.words;
      const uint32_t* a = P.vec + (int64_t)u * S * W;
      const uint32_t* b = P.vec + (int64_t)v * S * W;
      uint32_t mut = 0;
      for (int w = tid; w < W; w += blockDim.x) {
        uint32_t un = 0;
        for (int k = 0; k < S; ++k) un |= a[k * W + w] & b[k * W + w];
        mut += __popc(~un);
      }
      const uint32_t total = block_sum(mut, s_sum);
      if (tid == 0) finals[q] = total + P.cost[u] + P.cost[v];
      __syncthreads();  // s_sum is reused by the next partition
    }
    return;
  }

  int first = n_tips;  // the star ring
  if (mode == kInsert) {
    unsigned long long best = ~0ull;
    for (int e = tid; e < ne; e += blockDim.x)
      best = min(best, ((unsigned long long)scores[e] << 32) | (unsigned)e);
#pragma unroll
    for (int o = 16; o; o >>= 1) best = min(best, __shfl_xor_sync(kFull, best, o));
    if (lane == 0) s_key[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kCommitThreads / 32; ++w) best = min(best, s_key[w]);
      const int e = (int)(best & 0xffffffffu);
      const int u = edge_rows[e], v = back[u];
      back[u] = base;
      back[base] = u;
      back[v] = base + 1;
      back[base + 1] = v;
      back[tip] = base + 2;
      back[base + 2] = tip;
      edge_rows[ne] = base + 1;
      edge_rows[ne + 1] = base + 2;
    }
    first = base;
  }
  if (tid == 0) {
    queue[0] = first;
    queue[1] = first + 1;
    queue[2] = first + 2;
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
      dep = back[row];
      live = dep >= n_tips;
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
    }
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < kChunk / 32; ++w) total += s_live[w];
      s_head = head + cnt;
      s_tail = tail + 2 * total;
    }
    for (int q = 0; q < parts.n; ++q) {
      const Part P = parts.p[q];
      const int S = P.states, W = P.words;
      const int64_t row = (int64_t)S * W;
      if (tid < cnt) s_mut[tid] = 0;
      __syncthreads();
      for (int it = tid; it < cnt * W; it += blockDim.x) {
        const int r = it / W, w = it - r * W;
        const uint32_t* a = P.vec + s_c1[r] * row + w;
        const uint32_t* b = P.vec + s_c2[r] * row + w;
        uint32_t* o = P.vec + s_row[r] * row + w;
        uint32_t u = 0;
        for (int k = 0; k < S; ++k) u |= a[k * W] & b[k * W];
        for (int k = 0; k < S; ++k) {
          const uint32_t x = a[k * W], y = b[k * W];
          o[k * W] = (x & y) | (~u & (x | y));
        }
        atomicAdd(&s_mut[r], (uint32_t)__popc(~u));
      }
      __syncthreads();
      if (tid < cnt)
        P.cost[s_row[tid]] = P.cost[s_c1[tid]] + P.cost[s_c2[tid]] + s_mut[tid];
    }
    __syncthreads();  // rows and costs written; the queue's new state
  }
}

int launch_status() { return (int)cudaGetLastError(); }

}  // namespace

// One launch per non-empty wave; wave w is ops[offsets[w]:offsets[w+1]]
// (host offsets, ops on the card).
extern "C" int fitch_waves(void* vec, void* cost, int S, int W,
                           const void* ops, const int32_t* offsets,
                           int n_waves, void* stream) {
  if (S < 1 || S > 32 || W < 1) return (int)cudaErrorInvalidValue;
  const int32_t* table = static_cast<const int32_t*>(ops);
  for (int w = 0; w < n_waves; ++w) {
    const int count = offsets[w + 1] - offsets[w];
    if (count <= 0) continue;
    fitch_wave_kernel<<<count, kWaveThreads, 0, (cudaStream_t)stream>>>(
        static_cast<uint32_t*>(vec), static_cast<uint32_t*>(cost), S, W,
        table + 3 * offsets[w]);
    const int rc = launch_status();
    if (rc) return rc;
  }
  return 0;
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
extern "C" int stepwise_commit(int mode, int n_parts, const int64_t* vecs,
                               const int64_t* costs, const int32_t* states,
                               const int32_t* words, int n_tips,
                               const void* scores, int ne, int base, int tip,
                               void* back, void* edge_rows, const void* co1,
                               const void* co2, void* queue, void* finals,
                               void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || mode < kStar || mode > kFinal)
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
  stepwise_commit_kernel<<<1, kCommitThreads, 0, (cudaStream_t)stream>>>(
      mode, parts, n_tips, static_cast<const uint32_t*>(scores), ne, base,
      tip, static_cast<int32_t*>(back), static_cast<int32_t*>(edge_rows),
      static_cast<const int32_t*>(co1), static_cast<const int32_t*>(co2),
      static_cast<int32_t*>(queue), static_cast<uint32_t*>(finals));
  return launch_status();
}

extern "C" const char* fitch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
