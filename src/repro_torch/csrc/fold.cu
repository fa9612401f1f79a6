// segment_fold: every chain stage of a lowered query batch in one launch.
//
// Replaces the fused fold of the JAX engine, `_fold_core` +
// `_search_segments` (src/repro/core/device_engine.py), which XLA runs as
// jnp under jit there; it has no Pallas original.
//
// Layout (see repro_torch.core.device_engine.LoweredPlan):
//   cells      (4, N) int32 rows: posting index (PAD = pad cell), group id,
//              query id (>= n_queries_pad = dropped), arity (0 = pad cell)
//   stage_seg  (2, n_stages * group_width) int32: per stage, every group's
//              (start, len) segment inside post_docs
//   stages     the binary-search depth of each stage, by value
//
// One thread per cell; the cell's value stays in a register across all
// stages.  At each stage where its group is still active (arity > s) and
// the cell is alive, the cell runs the reference's leftmost binary search
// of stage_iters[s] steps in its group's segment of post_docs, the same
// integer steps (so counts, entering and members are bit-identical to the
// plain version); a miss turns it into PAD.
//
// What bounds it on the H100.  The work is a few dependent 4-byte probes
// per cell into the resident post_docs, so the floor is the bytes the data
// needs: the cells, and the distinct sectors of post_docs the probes touch
// (16 us at the main path's arity-2 plan of 1.8 M cells).  The first
// design (one integer atomic per surviving cell onto counts[query], one
// per warp and stage onto entering[s], the depths uploaded per call) took
// 0.77 ms there.  Ablated copies of it, timed at the main path's plans
// (tools/kernel_ab.py), split that: without the counts atomics
// 0.034-0.055 ms, without any atomic 0.025-0.036 ms, with one probe
// instead of the search and no atomics 0.016-0.019 ms.  A batch's
// survivors, each adding to one of 256 counters (8 cache lines), serialize
// in L2; the search itself costs ~0.015 ms (the lanes of a group probe the
// same top of its search tree, which the caches hold).  A second design
// staged each warp's runs of one group's segment into shared memory
// (cp.async) and searched there; it took 0.062 ms, more than the probes
// it replaced, since each warp copied whole segments (hundreds of
// postings) for short runs of cells, so it was dropped.  This design keeps
// the search in place and removes the serialization:
//
//  * Counts: a warp merges its survivors by query (__match_any_sync), the
//    warp's leaders add into a per-block table in shared memory indexed
//    from the block's smallest query, and the block adds each non-zero
//    entry to device memory once.  A query's groups lie side by side after
//    lower_plan's stable arity sort, so a block holds few queries and a
//    batch issues a few global atomics per block instead of one per cell.
//    A query beyond the table's reach is added directly by its warp.
//    Integer sums are exact in any order.
//  * entering: one shared-memory sum per block and stage, one global
//    atomic per block and stage.
//  * The depths travel by value in the kernel's arguments: the launcher
//    copies nothing from the host and never synchronizes, so a call can
//    be captured in a CUDA graph.
//  * A plan deeper than FOLD_MAX_STAGES stages (a query of arity 66 or
//    more) runs as a chain of launches of at most FOLD_MAX_STAGES stages
//    each, on the same stream: every launch but the first starts from the
//    cells the one before left in `members` (each thread reads and writes
//    only its own cell, so in place), and only the last counts.  The
//    common case stays one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_VALUE 0x7fffffff
#define FULL_MASK 0xffffffffu
#define FOLD_THREADS 256
#define FOLD_MAX_STAGES 64
#define FOLD_QUERY_TABLE 512  // per-block count table, from the smallest query

struct FoldStages {
  int n;
  int iters[FOLD_MAX_STAGES];
};

// The reference's fixed-step leftmost search of `cur` in
// post_docs[lo, lo + len), reads clamped to the array, as in
// kernels/intersect/ref.py::_search_segments.
__device__ __forceinline__ bool probe_in_place(const int32_t* __restrict__ post_docs,
                                               int64_t n_post, int64_t lo, int64_t len,
                                               int iters, int32_t cur) {
  int64_t hi = lo + len;
  const int64_t end = hi;
  for (int it = 0; it < iters; ++it) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t v = post_docs[mid < n_post - 1 ? mid : n_post - 1];
    if (v < cur) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && post_docs[lo < n_post - 1 ? lo : n_post - 1] == cur;
}

__global__ void __launch_bounds__(FOLD_THREADS) segment_fold_kernel(
    const int32_t* __restrict__ post_docs, int64_t n_post,
    const int32_t* __restrict__ cells, int64_t n_cells,
    const int32_t* __restrict__ stage_seg, int64_t seg_cols, int group_width,
    FoldStages stages, int stage0, const int32_t* cur_in, int n_queries_pad,
    int32_t* counts, int32_t* __restrict__ entering, int32_t* members) {
  __shared__ int32_t s_entering[FOLD_MAX_STAGES];
  __shared__ int32_t s_counts[FOLD_QUERY_TABLE];
  __shared__ int32_t s_query0;

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_cells;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < FOLD_QUERY_TABLE; t += blockDim.x) s_counts[t] = 0;
  for (int t = threadIdx.x; t < stages.n; t += blockDim.x) s_entering[t] = 0;
  if (threadIdx.x == 0) s_query0 = 0x7fffffff;

  int32_t cur = PAD_VALUE;
  int32_t group = 0, query = 0, arity = 0;
  if (in_range) {
    const int32_t post = cells[i];
    group = cells[n_cells + i];
    query = cells[2 * n_cells + i];
    arity = cells[3 * n_cells + i];
    if (cur_in != nullptr) {
      cur = cur_in[i];  // a chained launch: the cell as the last one left it
    } else if (post != PAD_VALUE && n_post > 0) {
      int64_t p = post < 0 ? 0 : (int64_t)post;
      if (p > n_post - 1) p = n_post - 1;
      cur = post_docs[p];
    }
  }
  __syncthreads();

  // Every lane of a warp runs the stage loop (its bound is uniform), so the
  // ballot below and the match after it always see all 32 lanes.
  for (int s = 0; s < stages.n; ++s) {
    const bool live = in_range && arity > stage0 + s + 1 && cur != PAD_VALUE;
    const unsigned live_mask = __ballot_sync(FULL_MASK, live);
    if (lane == 0 && live_mask) atomicAdd(&s_entering[s], __popc(live_mask));
    if (live) {
      const int64_t col = (int64_t)(stage0 + s) * group_width + group;
      if (!probe_in_place(post_docs, n_post, stage_seg[col], stage_seg[seg_cols + col],
                          stages.iters[s], cur)) {
        cur = PAD_VALUE;
      }
    }
  }

  if (in_range && members != nullptr) members[i] = cur;
  // A launch of a chain but the last stops here (the flag is uniform, so
  // no thread of the block waits at a barrier the others skip).
  if (counts == nullptr) {
    __syncthreads();
    for (int t = threadIdx.x; t < stages.n; t += blockDim.x) {
      if (s_entering[t]) atomicAdd(&entering[t], s_entering[t]);
    }
    return;
  }

  // Counts: merged per warp by query, then per block in shared memory.
  const bool counted = in_range && cur != PAD_VALUE && query >= 0 && query < n_queries_pad;
  const unsigned peers = __match_any_sync(FULL_MASK, counted ? query : -1 - lane);
  const bool leader = counted && lane == __ffs(peers) - 1;
  if (leader) atomicMin(&s_query0, query);
  __syncthreads();
  const int query0 = s_query0;
  if (leader) {
    const int slot = query - query0;
    if (slot < FOLD_QUERY_TABLE) {
      atomicAdd(&s_counts[slot], __popc(peers));
    } else {
      atomicAdd(&counts[query], __popc(peers));
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < FOLD_QUERY_TABLE; t += blockDim.x) {
    if (s_counts[t]) atomicAdd(&counts[query0 + t], s_counts[t]);
  }
  for (int t = threadIdx.x; t < stages.n; t += blockDim.x) {
    if (s_entering[t]) atomicAdd(&entering[t], s_entering[t]);
  }
}

// `members` may be null only when n_stages <= FOLD_MAX_STAGES: a longer
// chain carries its cells from launch to launch there.
extern "C" int segment_fold_launch(
    const void* post_docs, int64_t n_post, const void* cells, int64_t n_cells,
    const void* stage_seg, int64_t seg_cols, int group_width,
    const int* stage_iters, int n_stages, int n_queries_pad, void* counts,
    void* entering, void* members, void* stream) {
  if (n_stages < 0) return (int)cudaErrorInvalidValue;
  if (n_stages > FOLD_MAX_STAGES && members == nullptr) return (int)cudaErrorInvalidValue;
  if (n_cells <= 0) return (int)cudaGetLastError();
  const int n_launches = n_stages <= FOLD_MAX_STAGES
                             ? 1
                             : (n_stages + FOLD_MAX_STAGES - 1) / FOLD_MAX_STAGES;
  const int64_t blocks = (n_cells + FOLD_THREADS - 1) / FOLD_THREADS;
  for (int c = 0; c < n_launches; ++c) {
    const int stage0 = c * FOLD_MAX_STAGES;
    const int n = n_stages - stage0 < FOLD_MAX_STAGES ? n_stages - stage0 : FOLD_MAX_STAGES;
    const bool last = c == n_launches - 1;
    FoldStages stages;
    stages.n = n;
    for (int s = 0; s < FOLD_MAX_STAGES; ++s) stages.iters[s] = s < n ? stage_iters[stage0 + s] : 0;
    segment_fold_kernel<<<(unsigned)blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)post_docs, n_post, (const int32_t*)cells, n_cells,
        (const int32_t*)stage_seg, seg_cols, group_width, stages, stage0,
        c == 0 ? nullptr : (const int32_t*)members, n_queries_pad,
        last ? (int32_t*)counts : nullptr, (int32_t*)entering + stage0, (int32_t*)members);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
