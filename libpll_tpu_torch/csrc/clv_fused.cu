// Fused post-order pruning sweep (K2) and fused edge score (K1) for Hopper
// (sm_90a), bound to PyTorch through ctypes (libpll_tpu_torch/ops/_build.py
// builds this file; libpll_tpu_torch/ops/clv_fused.py wraps it).
//
// Replaces the two Pallas TPU kernels of libpll_tpu/ops/clv_pallas.py:
//   K1  make_fused_edge_score  (pallas_call at :653)
//   K2  make_fused_sweep       (pallas_call at :840)
//
// What they compute, per site: for every op in post order (children before
// parents),
//   x[c,s] = (sum_d P[m1,c,s,d] child1[c,d]) * (sum_d P[m2,c,s,d] child2[c,d])
// with the parent's counter starting at the sum of its children's.  Under
// per-site scaling, when every one of the site's C*S values is below
// 2^-shift the values are multiplied by 2^shift and the counter gains 1
// (shift = 32 at float, 256 at double).  Under per-rate scaling the same
// test runs per rate category with one counter per (rate, site).  K2 writes
// every inner CLV and counter out.  K1 instead folds the edge
// log-likelihood:
//   lnl = (log(sum_k parent[k] * (P[edge] child)[k] * wvec[k] (+ inv_add))
//          + counters * log(2^-shift)) * pattern_weight
// and writes one float64 partial per 32 sites; the wrapper folds four into
// each 128-site partial (clv_seg.fold_tile_partials) and those in float64.
//
// Tips come as 0/1 CLV rows ("clv", [tips, C*S, L]), as 4-bit ambiguity
// codes packed eight to an int32 word ("chars", nibble 4*(i%8) of word i/8,
// masked & 0xF; DNA only), or as one bitmask word per tip ("masks").
//
// Instances: DNA (S = 4) and protein (S = 20, where the TPU kernels switch
// to their MXU variant, a block-diagonal contraction: clv_pallas.py:498,
// :715), each at C in {1, 2, 4, 8} rates, float32 and float64, K1 and K2.
//
// Design on this card.
//  * The walk is planned once per topology on the host (clv_fused.FusedPlan):
//    the ops in a post order that visits first the child needing more live
//    rows, so that only a few inner rows are live at once (3 at the 64-taxon
//    flagship, 6 at 1 000 taxa), and those rows get slots of a shared-memory
//    pool by first fit.  Each op is a descriptor (clv_common.cuh's OpDesc)
//    naming its children and counters as a tip or a pool slot.  K1 keeps
//    every inner row on chip (no device scratch); K2 writes each row and
//    counter once, coalesced, as its op makes it, and reads none back.
//  * DNA: one thread runs kSitesPerThread sites of a block's tile (the site
//    axis is fastest: a warp's loads and stores are coalesced, and its pool
//    columns sit in distinct banks) and holds each site's C*S values in
//    registers, so per-site scaling needs no barrier.  Each P row read
//    serves every site of the thread.
//  * Each chunk of ops (8 at most) has its descriptors and P-matrices
//    staged in shared memory (16-byte vectors, a warp reading one address).
//    A tree whose ops all fit one chunk is staged once per block, and the
//    blocks loop over the site tiles (grid: the blocks the card holds at
//    once).  A pattern tip's word is read once per site and op and decoded
//    into 0/1 values that are contracted as any row.  (A table of the 16
//    codes' terms per tip child, built per chunk, measured slower on an
//    H100: it cost more shared memory and build time than its FMAs saved;
//    PERF.md.)
//  * The argument struct stays in the parameter space (__grid_constant__):
//    helpers take it by reference, which otherwise makes nvcc copy it to
//    the stack (3-5% on clv_seg.cu, PERF.md).
//  * Per value the arithmetic is the first port's (dot in K1's order,
//    products, scaling by exact powers of two, the edge sum in row order),
//    and the partials are summed in the first kernel's order (each warp's
//    shuffle tree, then four warps in order): the rows, counters and logL
//    keep their bits.
//  * Protein takes the pool kernels' layout, a warp per rate and two
//    sites a thread (see "Protein" below): each op's matrices copied by
//    cp.async while the op before computes, one barrier an op; the
//    contraction stays full FP32 on CUDA cores (3xTF32 on the tensor
//    cores measured slower on an H100, and outside F32_RTOL: PERF.md),
//    each value in the DNA instances' order, the rate terms of the edge
//    summed in rate order.
//
// What bounds it, at the flagship (64 taxa x 262 144 sites, four rates,
// float32) per evaluation: ~3.7 GFLOP of contraction (0.055 ms at the FP32
// peak) against 8.4 MB of tip words and 1 MB of pattern weights read (K1)
// and 1.11 GB of rows and counters written (K2, 0.33 ms at 3.35 TB/s).
// Protein (64 taxa, LG4X+G4, float32): 1 600 flop per inner node, site and
// rate, so K1 is bound by its operations and K2 by the rows it writes
// (PERF.md has both bounds at the run's pattern count).

#include <cuda_runtime.h>
#include <stdint.h>

#include "clv_common.cuh"

namespace {

constexpr int kStates = 4;
constexpr int kMaxChunk = 8;        // ops staged at once, at most
constexpr int kGroupSites = 32;     // sites per float64 partial (a warp)
constexpr int kMaxSitesPerThread = 2;
// P rows read from the staged chunk (else through L1 from device memory)
constexpr bool kStageP = true;

// Sites per thread: each P row read serves them all.  kMaxSitesPerThread
// while a site's values take at most 64 bytes of registers (float at up to
// four rates, double at up to two), else one.
template <typename T, int C>
constexpr int kSitesPerThread = sizeof(T) * C <= 16 ? kMaxSitesPerThread : 1;

template <typename T>
struct FusedArgs {
  int tip_encoding;
  int scale_mode;
  int64_t sites;
  int n_ops;
  // = n_ops.  Without this field nvcc gave the float, four-rate K1 more
  // than 128 registers a thread: 3 blocks an SM, not 4, and K1 20% slower
  // on an H100 (PERF.md).
  int n_inner;
  int pool;       // slots
  int chunk;      // ops staged at once
  int64_t n_groups;  // K1: 32-site partials, four per 128 sites
  const OpDesc* ops;         // [n_ops]
  const T* tip_clv;          // [tips, C*S, sites]              ("clv")
  const int32_t* tip_words;  // [ceil(tips/8) or tips, sites]
  const T* pmatrix;          // [M, C, S, S]
  T* inner;                  // K2: [n_inner, C*S, sites]
  int32_t* scalers;          // K2: [(n_inner + 1) * srows, sites]
  const int32_t* edge;       // K1: parent, child, their counters, matrix,
                             // the child's nibble shift
  const T* weight_vec;       // K1: [C*S]
  const T* pattern_weights;  // K1: [sites]
  const T* inv_add;          // K1: [sites], or null without +I
  double* partials;          // K1: [n_groups]
  Scale<T> u;
};

// Dynamic shared memory, in this order: the chunk's descriptors, its
// P-matrices [j, k, C, S, S], the pool's values [slot, C*S, nb] and
// counters [slot, srows, nb] (nb: the block's sites).
template <typename T, int C>
size_t smem_bytes(int chunk, int pool, int srows, int nb) {
  return (size_t)chunk * sizeof(OpDesc) +
         (size_t)chunk * 2 * C * kStates * kStates * sizeof(T) +
         (size_t)pool * nb * (C * kStates * sizeof(T) + srows * 4);
}

template <typename T>
struct Shared {
  OpDesc* ops;
  T* pm;
  T* pool;
  int32_t* scal;
  int nb;  // the block's sites: the pool's row length
};

// Where the thread's sites are: column col[u] of the pool, site site[u]
// (clamped to the last site for loads past the end; live[u]: a real site).
template <int U>
struct Cols {
  int col[U];
  int64_t site[U];
  bool live[U];
};

// The thread's U rows of C*S values named by descriptor d (a pool slot or
// a tip; `shift`: a pattern tip's nibble shift).
template <typename T, int C, int U>
__device__ __forceinline__ void load_row(const FusedArgs<T>& a,
                                         const Shared<T>& sh,
                                         const Cols<U>& q, int d, int shift,
                                         T (&x)[U][C * kStates]) {
  constexpr int CS = C * kStates;
  const int v = index_of(d);
  if (kind_of(d) == K_POOL) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < CS; ++k)
        x[u][k] = sh.pool[(v * CS + k) * sh.nb + q.col[u]];
    return;
  }
  if (a.tip_encoding == TIP_CLV) {
    const T* base = a.tip_clv + (int64_t)v * CS * a.sites;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < CS; ++k) x[u][k] = __ldg(base + k * a.sites + q.site[u]);
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t code =
        ((uint32_t)__ldg(a.tip_words + (int64_t)v * a.sites + q.site[u]) >>
         shift) & 0xFu;
#pragma unroll
    for (int d2 = 0; d2 < kStates; ++d2) {
      const T bit = (T)((code >> d2) & 1u);
#pragma unroll
      for (int c = 0; c < C; ++c) x[u][c * kStates + d2] = bit;
    }
  }
}

// t (=, or *= when kMul) the contraction of x with one branch's [C, S, S]
// P-matrices pm (staged, or in device memory), in K1's order.
template <typename T, int C, int U, bool kMul, bool kShared>
__device__ __forceinline__ void contract_rows(const T* pm,
                                              const T (&x)[U][C * kStates],
                                              T (&t)[U][C * kStates]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      T row[kStates];
      load_pm_row<T, kStates, kShared>(pm + (c * kStates + s) * kStates, row);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T xc[kStates];
#pragma unroll
        for (int e = 0; e < kStates; ++e) xc[e] = x[u][c * kStates + e];
        const T v = dot_regs<T, kStates>(row, xc);
        t[u][c * kStates + s] = kMul ? t[u][c * kStates + s] * v : v;
      }
    }
  }
}

// One child of op j of the staged chunk into t (=, or *=).
template <typename T, int C, int U, bool kMul>
__device__ __forceinline__ void child_term(const FusedArgs<T>& a,
                                           const Shared<T>& sh,
                                           const Cols<U>& q, const OpDesc& o,
                                           int j, int k,
                                           T (&t)[U][C * kStates]) {
  constexpr int PM = C * kStates * kStates;
  T x[U][C * kStates];
  load_row<T, C, U>(a, sh, q, o.c[k], o.pad[k], x);
  if (kStageP)
    contract_rows<T, C, U, kMul, true>(sh.pm + (j * 2 + k) * PM, x, t);
  else
    contract_rows<T, C, U, kMul, false>(a.pmatrix + (int64_t)o.m[k] * PM, x,
                                        t);
}

// The thread's counter of row r (rate r per rate, else 0) named by a
// counter descriptor (K_ZERO: 0).
template <typename T>
__device__ __forceinline__ int load_count(const Shared<T>& sh, int srows,
                                          int d, int r, int col) {
  if (d < 0) return 0;
  return sh.scal[(index_of(d) * srows + r) * sh.nb + col];
}

// Stage ops [op0, op0 + n): descriptors and P-matrices.  Every
// thread of the block must call it; it returns behind a barrier.
template <typename T, int C>
__device__ void stage_chunk(const FusedArgs<T>& a, const Shared<T>& sh,
                            int op0, int n) {
  __syncthreads();  // every thread is done with the previous chunk
  if ((int)threadIdx.x < n) sh.ops[threadIdx.x] = a.ops[op0 + threadIdx.x];
  __syncthreads();
  if (kStageP) {
    stage_pmatrices<T, kStates>(a.pmatrix, C, sh.ops, n, sh.pm);
    __syncthreads();
  }
}

// Ops [0, n) of the staged chunk over the thread's U sites.
template <typename T, int C, int U, bool kScore>
__device__ void run_chunk(const FusedArgs<T>& a, const Shared<T>& sh,
                          const Cols<U>& q, int n) {
  constexpr int CS = C * kStates;
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  for (int j = 0; j < n; ++j) {
    const OpDesc o = sh.ops[j];
    T t[U][CS];
    child_term<T, C, U, false>(a, sh, q, o, j, 0, t);
    child_term<T, C, U, true>(a, sh, q, o, j, 1, t);
    const bool has = o.has != 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = q.col[u];
      if (per_rate) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          int cnt = load_count(sh, C, o.s[0], c, col) +
                    load_count(sh, C, o.s[1], c, col);
          T tc[kStates];
#pragma unroll
          for (int s = 0; s < kStates; ++s) tc[s] = t[u][c * kStates + s];
          if (scale_rate<T, kStates>(has, tc, a.u)) {
#pragma unroll
            for (int s = 0; s < kStates; ++s) t[u][c * kStates + s] = tc[s];
            cnt += 1;
          }
          sh.scal[(o.home * C + c) * sh.nb + col] = cnt;
          if (!kScore && q.live[u])
            a.scalers[((int64_t)o.out * C + c) * a.sites + q.site[u]] = cnt;
        }
      } else {
        int cnt = load_count(sh, 1, o.s[0], 0, col) +
                  load_count(sh, 1, o.s[1], 0, col);
        if (a.scale_mode == SCALE_PER_SITE &&
            has && all_below<T, CS>(t[u], a.u.thresh)) {
#pragma unroll
          for (int k = 0; k < CS; ++k) t[u][k] *= a.u.factor;
          cnt += 1;
        }
        sh.scal[o.home * sh.nb + col] = cnt;
        if (!kScore && q.live[u])
          a.scalers[(int64_t)o.out * a.sites + q.site[u]] = cnt;
      }
#pragma unroll
      for (int k = 0; k < CS; ++k)
        sh.pool[(o.home * CS + k) * sh.nb + col] = t[u][k];
      if (!kScore && q.live[u]) {
        T* out = a.inner + (int64_t)o.out * CS * a.sites + q.site[u];
#pragma unroll
        for (int k = 0; k < CS; ++k) out[k * a.sites] = t[u][k];
      }
    }
  }
}

// K1: the weighted log-likelihood of each of the thread's sites across the
// evaluation edge (per-site or no scaling), 0 past the last site.
template <typename T, int C, int U>
__device__ void edge_site_lnl(const FusedArgs<T>& a, const Shared<T>& sh,
                              const Cols<U>& q, double (&lnl)[U]) {
  constexpr int CS = C * kStates;
  constexpr int PM = C * kStates * kStates;
  const int pd = __ldg(a.edge + 0), cd = __ldg(a.edge + 1);
  T pv[U][CS], x[U][CS], tb[U][CS];
  load_row<T, C, U>(a, sh, q, pd, 0, pv);
  load_row<T, C, U>(a, sh, q, cd, __ldg(a.edge + 5), x);
  contract_rows<T, C, U, false, false>(
      a.pmatrix + (int64_t)__ldg(a.edge + 4) * PM, x, tb);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    T term = 0;
#pragma unroll
    for (int k = 0; k < CS; ++k)
      term = dev_fma(pv[u][k] * tb[u][k], __ldg(a.weight_vec + k), term);
    if (a.inv_add != nullptr) term += __ldg(a.inv_add + q.site[u]);
    const int snum = load_count(sh, 1, __ldg(a.edge + 2), 0, q.col[u]) +
                     load_count(sh, 1, __ldg(a.edge + 3), 0, q.col[u]);
    const T v =
        site_lnl<T>(term, snum, a.u, __ldg(a.pattern_weights + q.site[u]));
    lnl[u] = q.live[u] ? (double)v : 0.0;
  }
}

// Every thread runs every op, past-the-end sites included (loads clamped,
// device stores skipped): the staging needs the whole block.
template <typename T, int C, bool kScore>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const __grid_constant__ FusedArgs<T> a) {
  constexpr int U = kSitesPerThread<T, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int srows = a.scale_mode == SCALE_PER_RATE ? C : 1;
  Shared<T> sh;
  sh.nb = nt * U;
  sh.ops = reinterpret_cast<OpDesc*>(smem);
  sh.pm = reinterpret_cast<T*>(sh.ops + a.chunk);
  sh.pool = sh.pm + (size_t)a.chunk * 2 * C * kStates * kStates;
  sh.scal = reinterpret_cast<int32_t*>(sh.pool +
                                       (size_t)a.pool * C * kStates * sh.nb);

  const bool one_chunk = a.n_ops <= a.chunk;
  if (one_chunk) stage_chunk<T, C>(a, sh, 0, a.n_ops);
  // the tiles cover every 128-site partial's sites
  const int64_t padded =
      (a.sites + 4 * kGroupSites - 1) / (4 * kGroupSites) * 4 * kGroupSites;
  const int64_t n_tiles = (padded + sh.nb - 1) / sh.nb;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    Cols<U> q;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      q.col[u] = u * nt + threadIdx.x;
      const int64_t site = tile * sh.nb + q.col[u];
      q.live[u] = site < a.sites;
      q.site[u] = q.live[u] ? site : a.sites - 1;
    }
    if (!kScore) {  // the dummy counters
#pragma unroll
      for (int u = 0; u < U; ++u)
        for (int r = 0; q.live[u] && r < srows; ++r)
          a.scalers[((int64_t)a.n_inner * srows + r) * a.sites + q.site[u]] =
              0;
    }
    for (int op0 = 0; op0 < a.n_ops; op0 += a.chunk) {
      const int n = min(a.chunk, a.n_ops - op0);
      if (!one_chunk) stage_chunk<T, C>(a, sh, op0, n);
      run_chunk<T, C, U, kScore>(a, sh, q, n);
    }
    if (kScore) {
      double lnl[U];
      edge_site_lnl<T, C, U>(a, sh, q, lnl);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // one warp's 32 sites in the first kernel's order
        double v = lnl[u];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        const int64_t group =
            (tile * sh.nb + q.col[u] - (threadIdx.x & 31)) / kGroupSites;
        if ((threadIdx.x & 31) == 0 && group < a.n_groups)
          a.partials[group] = v;
      }
    }
  }
}

// The launch for a plan: the largest chunk (8, 4, 2, 1 ops) and then
// block (128, 64, 32 threads) whose shared memory fits a block.  out:
// dynamic shared memory, blocks per SM, threads, chunk, sites per block,
// SMs, and 1 (the protein instances' matrix buffers).
template <typename T, int C, bool kScore>
int layout(int scale_mode, int pool, int* out) {
  int limit = 0, sms = 0;
  cudaError_t err = open_kernel(fused_kernel<T, C, kScore>, &limit, &sms);
  if (err != cudaSuccess) return (int)err;
  const int srows = scale_mode == SCALE_PER_RATE ? C : 1;
  constexpr int U = kSitesPerThread<T, C>;
  for (int chunk = kMaxChunk; chunk >= 1; chunk >>= 1) {
    for (int nt = kThreads; nt >= 32; nt >>= 1) {
      const size_t smem = smem_bytes<T, C>(chunk, pool, srows, nt * U);
      if (smem > (size_t)limit) continue;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_kernel<T, C, kScore>, nt, smem);
      if (err != cudaSuccess) return (int)err;
      out[0] = (int)smem;
      out[1] = per_sm;
      out[2] = nt;
      out[3] = chunk;
      out[4] = nt * U;
      out[5] = sms;
      out[6] = 1;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;  // the pool does not fit one block
}

template <typename T, int C, bool kScore>
int launch(const FusedArgs<T>& a, int threads, int grid, cudaStream_t st) {
  const int srows = a.scale_mode == SCALE_PER_RATE ? C : 1;
  const size_t smem = smem_bytes<T, C>(a.chunk, a.pool, srows,
                                      threads * kSitesPerThread<T, C>);
  fused_kernel<T, C, kScore><<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kScore>
int dispatch(int rate_cats, const FusedArgs<T>& a, int threads, int grid,
             cudaStream_t st) {
  switch (rate_cats) {
    case 1: return launch<T, 1, kScore>(a, threads, grid, st);
    case 2: return launch<T, 2, kScore>(a, threads, grid, st);
    case 4: return launch<T, 4, kScore>(a, threads, grid, st);
    case 8: return launch<T, 8, kScore>(a, threads, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Protein (S = 20)
// ---------------------------------------------------------------------------
// A site's C*S values would take 80 registers a child at four rates, too
// many to hold as the DNA instances do.  The protein instances take the
// pool kernels' layout instead (clv_dyn.cu, clv_seg.cu): a block is a tile
// of 32*U sites by C rates, one thread per (rate, U sites) holding that
// rate's 20 values of each (warp c runs rate c; lane l sites l, l + 32,
// ...), and the walk's live rows sit in the pool [slot, S, 32*C*U] in
// shared memory.
//
// Each op reads its two [C, S, S] P-matrices from shared memory, as they lie
// in device memory (untransposed): parent state s's row of 20 entries loads
// as 16-byte vectors, one address a warp, and feeds the U sites' chains of
// 20 multiply-adds (d = 0, 1, ..., 19, the first a multiply: K1's order, so
// the values keep the bits of the transposed staging before them).  Each
// broadcast vector serves U sites.
//
// What bounds it at the protein configuration: K1 its 25.8 GFLOP of FP32
// contraction, K2 the 1.33 GB of rows and counters it writes; on an H100
// they take ~2.7x and ~3.3x those bounds (PERF.md: what holds them).
//
// The walk is a sequence of stages, each tile's ops and then (K1) its edge.
// Stage k's matrices land in buffer k % buffers by cp.async, issued at the
// start of stage k - 1 (two buffers), so that the copy from L2 overlaps
// the contraction before it, and one block barrier a stage serves both
// "stage k's matrices have landed" and "stage k - 1's buffer is free".  The
// same barrier shows every warp the per-site scaling votes of the stage
// before: an op's values are contracted and voted on in its stage, and
// scaled, stored in the pool and written out at the start of the next
// (a thread reads and writes only its own pool columns, so a child's row
// is stored before its parent reads it).  Where two buffers do not fit a
// block's shared memory (large pools), one buffer takes each stage's
// matrices after a second barrier, behind the stage.  K1's edge fold
// gathers a site's C rate terms through shared memory (a second barrier)
// and sums them in rate order.  Read through L1 instead of staged, the
// matrices took twice as long on an H100: the blocks of an SM walk
// different ops, and their matrices do not fit the L1 that the pool
// leaves.  A walk of up to kProtChunk ops has its descriptors staged once
// per block; the blocks loop over the tiles.
constexpr int kProtStates = 20;
constexpr int kProtChunk = 64;  // ops staged at once, at most
// Sites a thread at float (each staged P vector serves them all: K1 -14%,
// K2 -5% on an H100 against one, PERF.md); double runs one (its K1 takes
// 254 registers at one).  The layout falls back to one site a thread, and
// to one matrix buffer, where a block's shared memory does not hold more.
constexpr int kProtSitesPerThread = 2;

template <typename T>
constexpr int kProtSites = sizeof(T) == 4 ? kProtSitesPerThread : 1;

// The protein kernels' arguments: the walk's, and the matrix buffers (2,
// or 1 where two do not fit).
template <typename T>
struct ProtArgs {
  FusedArgs<T> f;
  int buffers;
};

// Dynamic shared memory, in this order: the matrix buffers [buffers, 2,
// C, S, S], the chunk's descriptors, the pool's values [slot, S, cols]
// and counters [slot, 32*U] (per rate [slot, cols]), and K1's edge
// exchange, [cols] terms and counters (cols = 32*C*U: a thread's U sites).
template <typename T, int C, bool kScore>
size_t protein_smem_bytes(int chunk, int pool, int scale_mode, int sites,
                          int buffers) {
  const size_t cols = (size_t)kTileSites * C * sites;
  const size_t counters =
      scale_mode == SCALE_PER_RATE ? cols : (size_t)kTileSites * sites;
  return (size_t)buffers * 2 * C * kProtStates * kProtStates * sizeof(T) +
         (size_t)chunk * sizeof(OpDesc) +
         (size_t)pool * (kProtStates * cols * sizeof(T) +
                         counters * sizeof(int32_t)) +
         (kScore ? cols * (sizeof(T) + sizeof(int32_t)) : 0);
}

// The block's pool: values [slot, S, cols] and counters [slot, sstride];
// thread x's site u is column u*nt + x.
template <typename T>
struct ProtPool {
  T* clv;
  int32_t* scal;
  int nt;       // threads
  int cols;     // nt * U
  int sstride;  // counters a slot
};

// What one thread is: rate c of U sites (site[u] clamped to the last site
// for loads past the end; live[u]: a real site).
template <int U>
struct ProtLanes {
  int c;
  int sl;  // lane: the sites' offset in each 32-site group
  int64_t site[U];
  bool live[U];
};

// The thread's counter of site u in pool slot `slot`: its site's (warp
// 0's), or per rate its own.
template <typename T>
__device__ __forceinline__ int prot_scal_at(const ProtPool<T>& pl,
                                            bool per_rate, int slot, int u,
                                            int sl) {
  return slot * pl.sstride +
         (per_rate ? u * pl.nt + (int)threadIdx.x : u * kTileSites + sl);
}

// The thread's U rows of 20 values named by descriptor d: a pool slot, a
// CLV tip (its rate's rows) or a 20-bit tip mask decoded into 0/1 values.
template <typename T, int C, int U>
__device__ __forceinline__ void protein_rows(const FusedArgs<T>& a,
                                             const ProtPool<T>& pl,
                                             const ProtLanes<U>& q, int d,
                                             T (&x)[U][kProtStates]) {
  constexpr int S = kProtStates;
  const int v = index_of(d);
  if (kind_of(d) == K_POOL) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < S; ++e)
        x[u][e] = pl.clv[(v * S + e) * pl.cols + u * pl.nt + threadIdx.x];
    return;
  }
  if (a.tip_encoding == TIP_CLV) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* p =
          a.tip_clv + ((int64_t)v * C + q.c) * S * a.sites + q.site[u];
#pragma unroll
      for (int e = 0; e < S; ++e) x[u][e] = __ldg(p + e * a.sites);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t code =
        (uint32_t)__ldg(a.tip_words + (int64_t)v * a.sites + q.site[u]);
#pragma unroll
    for (int e = 0; e < S; ++e) x[u][e] = (T)((code >> e) & 1u);
  }
}

// The thread's counter named by a counter descriptor (a pool slot, or
// K_ZERO: 0) for site u.
template <typename T>
__device__ __forceinline__ int protein_count(const ProtPool<T>& pl,
                                             bool per_rate, int d, int u,
                                             int sl) {
  return d < 0 ? 0 : pl.scal[prot_scal_at(pl, per_rate, index_of(d), u, sl)];
}

// cp.async: 16 bytes from device memory to shared memory, not through L1;
// the copies a thread issued land by the end of its next wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Matrices m0 (and m1 when k is 2) of pmatrix [M, C, S, S] into dst [k, C,
// S, S] in shared memory, as they are, by cp.async from every thread of
// the block (16 bytes a copy).
template <typename T, int C>
__device__ __forceinline__ void issue_matrices(const T* pmatrix, int m0,
                                               int m1, int k, T* dst) {
  constexpr int PM = C * kProtStates * kProtStates;
  constexpr int per = PM * (int)sizeof(T) / 16;  // copies a matrix
  const char* src0 = reinterpret_cast<const char*>(pmatrix + (int64_t)m0 * PM);
  const char* src1 = reinterpret_cast<const char*>(pmatrix + (int64_t)m1 * PM);
  char* out = reinterpret_cast<char*>(dst);
  for (int i = threadIdx.x; i < k * per; i += blockDim.x)
    cp_async16(out + (size_t)i * 16, i < per ? src0 + (size_t)i * 16
                                             : src1 + (size_t)(i - per) * 16);
}

// The matrices of walk op g into dst: its descriptor from the staged chunk
// [op0, op0 + n) when that holds it, else from device memory.
template <typename T, int C>
__device__ __forceinline__ void issue_op(const FusedArgs<T>& a,
                                         const OpDesc* ops, int op0, int n,
                                         int g, T* dst) {
  const bool staged = g >= op0 && g < op0 + n;
  const int m0 = staged ? ops[g - op0].m[0] : __ldg(&a.ops[g].m[0]);
  const int m1 = staged ? ops[g - op0].m[1] : __ldg(&a.ops[g].m[1]);
  issue_matrices<T, C>(a.pmatrix, m0, m1, 2, dst);
}

// t (=, or *= when kMul) the thread's rate block p ([S, S], untransposed,
// in shared memory) times each of its U rows x: sum_d p[s, d] x[d], in
// K1's order (dot_regs).
template <typename T, int U, bool kMul>
__device__ __forceinline__ void protein_term(const T* p,
                                             const T (&x)[U][kProtStates],
                                             T (&t)[U][kProtStates]) {
  constexpr int S = kProtStates;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T row[S];
    load_pm_row<T, S, true>(p + s * S, row);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T v = dot_regs<T, S>(row, x[u]);
      t[u][s] = kMul ? t[u][s] * v : v;
    }
  }
}

// Stage the descriptors of ops [op0, op0 + n).  Every thread of the block
// must call it; it returns behind a barrier.
template <typename T>
__device__ void stage_ops(const FusedArgs<T>& a, OpDesc* ops, int op0,
                          int n) {
  __syncthreads();  // every thread is done with the previous chunk
  for (int j = threadIdx.x; j < n; j += blockDim.x) ops[j] = a.ops[op0 + j];
  __syncthreads();
}

// An op contracted and voted on, to be scaled and stored at the start of
// the next stage: its values and counters, where they go, and the tile's
// sites.
template <typename T, int U>
struct Pending {
  T t[U][kProtStates];
  int cnt[U];
  int home, out, vb;
  bool vote;  // per-site scaling of an op that may scale: read the votes
  int64_t site[U];
  bool live[U];
};

// Store a pending op: scale the sites whose C warps all voted small (the
// votes of buffer p.vb, cast before the barrier that precedes this call),
// then its values and counters into the pool and, for K2, out.
template <typename T, int C, int U, bool kScore>
__device__ __forceinline__ void store_op(const FusedArgs<T>& a,
                                         const ProtPool<T>& pl, int c, int sl,
                                         bool per_rate, bool counts,
                                         unsigned (*votes)[U][kMaxRates],
                                         Pending<T, U>& p) {
  constexpr int S = kProtStates;
  const int srows = per_rate ? C : 1;
  const int crow = per_rate ? c : 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p.vote) {
      unsigned all = 0xffffffffu;
#pragma unroll
      for (int r = 0; r < C; ++r) all &= votes[p.vb][u][r];
      if ((all >> sl) & 1u) {
#pragma unroll
        for (int s = 0; s < S; ++s) p.t[u][s] *= a.u.factor;
        p.cnt[u] += 1;
      }
    }
#pragma unroll
    for (int e = 0; e < S; ++e)
      pl.clv[(p.home * S + e) * pl.cols + u * pl.nt + threadIdx.x] = p.t[u][e];
    if (counts) pl.scal[prot_scal_at(pl, per_rate, p.home, u, sl)] = p.cnt[u];
    if (!kScore && p.live[u]) {
      T* out = a.inner + ((int64_t)p.out * C + c) * S * a.sites + p.site[u];
#pragma unroll
      for (int e = 0; e < S; ++e) out[e * a.sites] = p.t[u][e];
      if (counts)
        a.scalers[((int64_t)p.out * srows + crow) * a.sites + p.site[u]] =
            p.cnt[u];
    }
  }
}

// Every thread runs every stage, past-the-end sites included (loads
// clamped, device stores skipped): the votes need whole warps.  A thread
// reads and writes only its own columns of the pool (a site's counter:
// warp 0's lane), so a parent may take a child's slot and the tiles
// follow each other without a barrier of their own.
template <typename T, int C, bool kScore, int U>
__global__ void __launch_bounds__(kTileSites * C)
    fused_protein_kernel(const __grid_constant__ ProtArgs<T> pa) {
  constexpr int S = kProtStates;
  constexpr int PM = C * S * S;
  const FusedArgs<T>& a = pa.f;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned votes[2][U][kMaxRates];
  const bool per_rate = a.scale_mode == SCALE_PER_RATE;
  const bool per_site = a.scale_mode == SCALE_PER_SITE;
  const bool counts = per_rate || threadIdx.x < kTileSites;  // warp-uniform
  const bool two = pa.buffers == 2;
  ProtLanes<U> q;
  q.c = threadIdx.x / kTileSites;
  q.sl = threadIdx.x % kTileSites;
  ProtPool<T> pl;
  pl.nt = kTileSites * C;
  pl.cols = pl.nt * U;
  pl.sstride = per_rate ? pl.cols : kTileSites * U;
  T* const pm_s = reinterpret_cast<T*>(smem);  // the matrix buffers
  OpDesc* const ops = reinterpret_cast<OpDesc*>(pm_s + pa.buffers * 2 * PM);
  pl.clv = reinterpret_cast<T*>(ops + a.chunk);
  pl.scal = reinterpret_cast<int32_t*>(pl.clv + (size_t)a.pool * S * pl.cols);
  T* const term_s = reinterpret_cast<T*>(pl.scal + a.pool * pl.sstride);
  int* const sn_s = reinterpret_cast<int*>(term_s + pl.cols);

  const int64_t n_tiles = a.n_groups / U;  // 32-site groups, four a 128
  const bool one_chunk = a.n_ops <= a.chunk;
  if (one_chunk) stage_ops(a, ops, 0, a.n_ops);
  // stage 0: the first tile's first op
  if (blockIdx.x < n_tiles)
    issue_op<T, C>(a, ops, 0, one_chunk ? a.n_ops : 0, 0, pm_s);
  cp_async_commit();
  int stage = 0;
  Pending<T, U> p;
  bool pending = false;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool next_tile = tile + gridDim.x < n_tiles;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t site = (tile * U + u) * kTileSites + q.sl;
      q.live[u] = site < a.sites;
      q.site[u] = q.live[u] ? site : a.sites - 1;
      if (!kScore && counts && q.live[u])  // the dummy counters
        a.scalers[((int64_t)a.n_inner * (per_rate ? C : 1) +
                   (per_rate ? q.c : 0)) * a.sites + q.site[u]] = 0;
    }
    for (int op0 = 0; op0 < a.n_ops; op0 += a.chunk) {
      const int n = min(a.chunk, a.n_ops - op0);
      if (!one_chunk) stage_ops(a, ops, op0, n);
      for (int j = 0; j < n; ++j, ++stage) {
        T* const buf = pm_s + (two ? (stage & 1) : 0) * 2 * PM;
        T* const other = pm_s + (two ? (~stage & 1) : 0) * 2 * PM;
        // what the stage after this one reads: the next op, K1's edge or
        // the next tile's first op
        const int g = op0 + j;
        const bool has_next = g + 1 < a.n_ops || kScore || next_tile;
        cp_async_wait_all();
        __syncthreads();  // this stage's matrices; the last stage is done
        if (two && has_next) {
          if (g + 1 < a.n_ops)
            issue_op<T, C>(a, ops, op0, n, g + 1, other);
          else if (kScore)
            issue_matrices<T, C>(a.pmatrix, __ldg(a.edge + 4), 0, 1, other);
          else
            issue_op<T, C>(a, ops, op0, n, 0, other);
        }
        cp_async_commit();
        if (pending)
          store_op<T, C, U, kScore>(a, pl, q.c, q.sl, per_rate, counts,
                                    votes, p);
        const OpDesc o = ops[j];
        T x[U][S];
#pragma unroll
        for (int u = 0; u < U; ++u)
          p.cnt[u] = counts ? protein_count(pl, per_rate, o.s[0], u, q.sl) +
                                  protein_count(pl, per_rate, o.s[1], u, q.sl)
                            : 0;
        protein_rows<T, C, U>(a, pl, q, o.c[0], x);
        protein_term<T, U, false>(buf + q.c * S * S, x, p.t);
        protein_rows<T, C, U>(a, pl, q, o.c[1], x);
        protein_term<T, U, true>(buf + PM + q.c * S * S, x, p.t);
        const bool has = o.has != 0;
        p.vote = per_site && has;
        p.vb = stage & 1;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (per_rate) p.cnt[u] += scale_rate<T, S>(has, p.t[u], a.u);
          if (p.vote) {
            const unsigned small =
                __ballot_sync(0xffffffffu,
                              all_below<T, S>(p.t[u], a.u.thresh));
            if (q.sl == 0) votes[p.vb][u][q.c] = small;
          }
          p.site[u] = q.site[u];
          p.live[u] = q.live[u];
        }
        p.home = o.home;
        p.out = o.out;
        pending = true;
        if (!two && has_next) {
          __syncthreads();  // every thread is done with the buffer
          if (g + 1 < a.n_ops)
            issue_op<T, C>(a, ops, op0, n, g + 1, buf);
          else if (kScore)
            issue_matrices<T, C>(a.pmatrix, __ldg(a.edge + 4), 0, 1, buf);
          else
            issue_op<T, C>(a, ops, op0, n, 0, buf);
          cp_async_commit();
        }
      }
    }
    if (kScore) {
      T* const buf = pm_s + (two ? (stage & 1) : 0) * 2 * PM;
      T* const other = pm_s + (two ? (~stage & 1) : 0) * 2 * PM;
      cp_async_wait_all();
      __syncthreads();  // the edge's matrices; the last op's votes
      if (two && next_tile) issue_op<T, C>(a, ops, 0, one_chunk ? a.n_ops : 0,
                                           0, other);
      cp_async_commit();
      store_op<T, C, U, kScore>(a, pl, q.c, q.sl, per_rate, counts, votes,
                                p);
      pending = false;
      T pv[U][S], x[U][S], tb[U][S];
      protein_rows<T, C, U>(a, pl, q, __ldg(a.edge + 0), pv);
      protein_rows<T, C, U>(a, pl, q, __ldg(a.edge + 1), x);
      protein_term<T, U, false>(buf + q.c * S * S, x, tb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // rate c's term of the edge sum (edge_rate_term's arithmetic); the
        // site's counters are warp 0's, stored by warp 0 after the barrier
        T acc = 0;
#pragma unroll
        for (int s = 0; s < S; ++s)
          acc = dev_fma(pv[u][s] * tb[u][s], __ldg(a.weight_vec + q.c * S + s),
                        acc);
        term_s[u * pl.nt + threadIdx.x] = acc;
        sn_s[u * pl.nt + threadIdx.x] =
            counts ? protein_count(pl, false, __ldg(a.edge + 2), u, q.sl) +
                         protein_count(pl, false, __ldg(a.edge + 3), u, q.sl)
                   : 0;
      }
      __syncthreads();  // the exchange
      Lane ln;
      ln.c = q.c;
      ln.sl = q.sl;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int snum;
        T term = site_term<T>(term_s + u * pl.nt, sn_s + u * pl.nt, C, ln,
                              false, a.u.thresh, snum);
        if (a.inv_add != nullptr) term += __ldg(a.inv_add + q.site[u]);
        const T v =
            site_lnl<T>(term, snum, a.u, __ldg(a.pattern_weights + q.site[u]));
        // warp 0 sums the 32 sites of group tile*U + u into its partial,
        // in one warp's shuffle tree (the first fused kernel's order)
        if (threadIdx.x < kTileSites) {
          double w = q.live[u] ? (double)v : 0.0;
          for (int off = 16; off > 0; off >>= 1)
            w += __shfl_down_sync(0xffffffffu, w, off);
          if (threadIdx.x == 0) a.partials[tile * U + u] = w;
        }
      }
      if (!two && next_tile) {
        __syncthreads();  // every thread is done with the edge's matrices
        issue_op<T, C>(a, ops, 0, one_chunk ? a.n_ops : 0, 0, buf);
        cp_async_commit();
      }
      ++stage;
    }
  }
  if (pending) {  // K2: the last op of the block's last tile
    __syncthreads();
    store_op<T, C, U, kScore>(a, pl, q.c, q.sl, per_rate, counts, votes, p);
  }
}

// The fit of the U-site instance: two matrix buffers before one, then the
// largest chunk (64 ops, halved down to 1) whose shared memory fits a
// block of 32*C threads.  out: as layout's, and out[6] the buffers.
// Returns cudaErrorInvalidValue where nothing fits.
template <typename T, int C, bool kScore, int U>
int protein_fit(int scale_mode, int pool, int* out) {
  int limit = 0, sms = 0;
  cudaError_t err =
      open_kernel(fused_protein_kernel<T, C, kScore, U>, &limit, &sms);
  if (err != cudaSuccess) return (int)err;
  for (int buffers = 2; buffers >= 1; --buffers) {
    for (int chunk = kProtChunk; chunk >= 1; chunk >>= 1) {
      const size_t smem = protein_smem_bytes<T, C, kScore>(
          chunk, pool, scale_mode, U, buffers);
      if (smem > (size_t)limit) continue;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_protein_kernel<T, C, kScore, U>, kTileSites * C,
          smem);
      if (err != cudaSuccess) return (int)err;
      out[0] = (int)smem;
      out[1] = per_sm;
      out[2] = kTileSites * C;
      out[3] = chunk;
      out[4] = kTileSites * U;
      out[5] = sms;
      out[6] = buffers;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The launch of a plan at S = 20: kProtSites sites a thread where that
// fits, else one.
template <typename T, int C, bool kScore>
int protein_layout(int scale_mode, int pool, int* out) {
  if constexpr (kProtSites<T> >= 2) {
    const int rc = protein_fit<T, C, kScore, 2>(scale_mode, pool, out);
    if (rc != (int)cudaErrorInvalidValue) return rc;
  }
  return protein_fit<T, C, kScore, 1>(scale_mode, pool, out);
}

template <typename T, int C, bool kScore, int U>
int protein_launch(const ProtArgs<T>& pa, int threads, int grid,
                   cudaStream_t st) {
  const size_t smem = protein_smem_bytes<T, C, kScore>(
      pa.f.chunk, pa.f.pool, pa.f.scale_mode, U, pa.buffers);
  fused_protein_kernel<T, C, kScore, U><<<grid, threads, smem, st>>>(pa);
  return (int)cudaGetLastError();
}

template <typename T, int C, bool kScore>
int protein_sites(const ProtArgs<T>& pa, int block_sites, int threads,
                  int grid, cudaStream_t st) {
  if constexpr (kProtSites<T> >= 2)
    if (block_sites == 2 * kTileSites)
      return protein_launch<T, C, kScore, 2>(pa, threads, grid, st);
  if (block_sites == kTileSites)
    return protein_launch<T, C, kScore, 1>(pa, threads, grid, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kScore>
int protein_dispatch(int rate_cats, const ProtArgs<T>& pa, int block_sites,
                     int threads, int grid, cudaStream_t st) {
  switch (rate_cats) {
    case 1:
      return protein_sites<T, 1, kScore>(pa, block_sites, threads, grid,
                                           st);
    case 2:
      return protein_sites<T, 2, kScore>(pa, block_sites, threads, grid,
                                           st);
    case 4:
      return protein_sites<T, 4, kScore>(pa, block_sites, threads, grid,
                                           st);
    case 8:
      return protein_sites<T, 8, kScore>(pa, block_sites, threads, grid,
                                           st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int walk(int states, int rate_cats, int tip_encoding, int scale_mode,
         int64_t sites, int n_ops, int n_inner, int pool, int chunk,
         int threads, int grid, int block_sites, int buffers,
         const void* ops, const void* tips, const void* pmatrix, void* inner,
         int32_t* scalers, const int32_t* edge, const void* weight_vec,
         const void* pattern_weights, const void* inv_add, double* partials,
         void* stream) {
  const bool protein = states == kProtStates;
  const bool block_ok =
      protein ? threads == kTileSites * rate_cats && chunk <= kProtChunk &&
                    (buffers == 1 || buffers == 2) &&
                    tip_encoding != TIP_CHARS  // a nibble holds 4 states
              : threads >= 32 && threads <= kThreads && (threads & 31) == 0 &&
                    chunk <= kMaxChunk;
  if ((states != kStates && !protein) || !block_ok || sites < 1 ||
      n_ops < 1 || pool < 1 || chunk < 1 || grid < 1 ||
      (edge != nullptr && scale_mode == SCALE_PER_RATE))
    return (int)cudaErrorInvalidValue;
  FusedArgs<T> a;
  a.tip_encoding = tip_encoding;
  a.scale_mode = scale_mode;
  a.sites = sites;
  a.n_ops = n_ops;
  a.n_inner = n_inner;
  a.pool = pool;
  a.chunk = chunk;
  a.n_groups = (sites + 4 * kGroupSites - 1) / (4 * kGroupSites) * 4;
  a.ops = static_cast<const OpDesc*>(ops);
  a.tip_clv = tip_encoding == TIP_CLV ? static_cast<const T*>(tips) : nullptr;
  a.tip_words =
      tip_encoding == TIP_CLV ? nullptr : static_cast<const int32_t*>(tips);
  a.pmatrix = static_cast<const T*>(pmatrix);
  a.inner = static_cast<T*>(inner);
  a.scalers = scalers;
  a.edge = edge;
  a.weight_vec = static_cast<const T*>(weight_vec);
  a.pattern_weights = static_cast<const T*>(pattern_weights);
  a.inv_add = static_cast<const T*>(inv_add);
  a.partials = partials;
  a.u = scale_units<T>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (protein) {
    ProtArgs<T> pa;
    pa.f = a;
    pa.buffers = buffers;
    return edge == nullptr ? protein_dispatch<T, false>(rate_cats, pa,
                                                        block_sites, threads,
                                                        grid, st)
                           : protein_dispatch<T, true>(rate_cats, pa,
                                                       block_sites, threads,
                                                       grid, st);
  }
  return edge == nullptr ? dispatch<T, false>(rate_cats, a, threads, grid, st)
                         : dispatch<T, true>(rate_cats, a, threads, grid, st);
}

template <typename T, bool kScore>
int layout_of(int states, int rate_cats, int scale_mode, int pool, int* out) {
  if (states == kProtStates) {
    switch (rate_cats) {
      case 1: return protein_layout<T, 1, kScore>(scale_mode, pool, out);
      case 2: return protein_layout<T, 2, kScore>(scale_mode, pool, out);
      case 4: return protein_layout<T, 4, kScore>(scale_mode, pool, out);
      case 8: return protein_layout<T, 8, kScore>(scale_mode, pool, out);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (states != kStates) return (int)cudaErrorInvalidValue;
  switch (rate_cats) {
    case 1: return layout<T, 1, kScore>(scale_mode, pool, out);
    case 2: return layout<T, 2, kScore>(scale_mode, pool, out);
    case 4: return layout<T, 4, kScore>(scale_mode, pool, out);
    case 8: return layout<T, 8, kScore>(scale_mode, pool, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  clv_fused_walk_* launches one kernel on
// `stream` (K2 when `edge` is null, else K1; the DNA instances at 4
// states, the protein ones at 20, whose sites a block and matrix buffers
// the layout gives; DNA ignores those two) and returns cudaGetLastError()
// (0 on success).

#define WALK_PARAMS                                                          \
  int states, int rate_cats, int tip_encoding, int scale_mode,              \
      int64_t sites, int n_ops, int n_inner, int pool, int chunk,           \
      int threads, int grid, int block_sites, int buffers, const void *ops, \
      const void *tips, const void *pmatrix, void *inner, int32_t *scalers, \
      const int32_t *edge, const void *weight_vec,                          \
      const void *pattern_weights, const void *inv_add, double *partials,   \
      void *stream
#define WALK_ARGS                                                            \
  states, rate_cats, tip_encoding, scale_mode, sites, n_ops, n_inner, pool, \
      chunk, threads, grid, block_sites, buffers, ops, tips, pmatrix,       \
      inner, scalers, edge, weight_vec, pattern_weights, inv_add, partials, \
      stream

extern "C" int clv_fused_walk_f32(WALK_PARAMS) { return walk<float>(WALK_ARGS); }
extern "C" int clv_fused_walk_f64(WALK_PARAMS) {
  return walk<double>(WALK_ARGS);
}

// The launch of a plan on the current device (see layout and
// protein_layout above); returns 0, or a CUDA error code
// (cudaErrorInvalidValue: the pool does not fit).
extern "C" int clv_fused_layout(int states, int f64, int rate_cats,
                                int scale_mode, int score, int pool,
                                int* out) {
  if (f64)
    return score ? layout_of<double, true>(states, rate_cats, scale_mode,
                                           pool, out)
                 : layout_of<double, false>(states, rate_cats, scale_mode,
                                            pool, out);
  return score ? layout_of<float, true>(states, rate_cats, scale_mode, pool,
                                        out)
               : layout_of<float, false>(states, rate_cats, scale_mode, pool,
                                         out);
}

extern "C" const char* clv_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
