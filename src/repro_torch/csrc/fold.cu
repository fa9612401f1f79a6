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
//   stage_iters (n_stages,) int32 on the device: the fixed binary-search
//              depth of each stage, so no shape is baked into the kernel
//
// One thread per cell.  The cell loads its posting, then at every stage
// where its group is still active (arity > s) and it is still alive, runs
// the leftmost binary search of stage_iters[s-1] steps in its group's
// segment of post_docs, exactly the integer steps of the reference; a
// miss turns the cell into PAD.  Per-stage survivor totals are counted
// with one warp-aggregated integer atomic per warp, the per-query counts
// with one integer atomic per surviving cell: integer atomics are exact in
// any order.
//
// What bounds it: device-memory latency of the dependent probes.  Each
// probe is a random 4-byte read that costs a 32-byte sector, and the
// search depth is a chain of dependent loads; the arithmetic is trivial.
// The design keeps every intermediate survivor list in registers (nothing
// between stages touches memory), probes the resident posting array in
// place (no gather of the long side), and relies on the L1/L2 caches for
// the top levels of the search tree, which all cells of a group share.

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_VALUE 0x7fffffff

__global__ void segment_fold_kernel(
    const int32_t* __restrict__ post_docs, int64_t n_post,
    const int32_t* __restrict__ cells, int64_t n_cells,
    const int32_t* __restrict__ stage_seg, int64_t seg_cols,
    int group_width, const int32_t* __restrict__ stage_iters, int n_stages,
    int n_queries_pad, int32_t* __restrict__ counts,
    int32_t* __restrict__ entering, int32_t* __restrict__ members) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_cells;
  const unsigned lane = threadIdx.x & 31u;

  int32_t cur = PAD_VALUE;
  int32_t group = 0, query = 0, arity = 0;
  if (in_range) {
    const int32_t post = cells[i];
    group = cells[n_cells + i];
    query = cells[2 * n_cells + i];
    arity = cells[3 * n_cells + i];
    if (post != PAD_VALUE && n_post > 0) {
      int64_t p = post < 0 ? 0 : (int64_t)post;
      if (p > n_post - 1) p = n_post - 1;
      cur = post_docs[p];
    }
  }

  // Every thread of the warp runs the stage loop (its bound is uniform),
  // so the ballot below always sees the full warp.
  for (int s = 1; s <= n_stages; ++s) {
    const bool act = in_range && arity > s;
    const bool live = act && cur != PAD_VALUE;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0 && ballot) atomicAdd(&entering[s - 1], __popc(ballot));
    if (live) {
      const int64_t col = (int64_t)(s - 1) * group_width + group;
      int64_t lo = stage_seg[col];
      int64_t hi = lo + stage_seg[seg_cols + col];
      const int64_t end = hi;
      const int iters = stage_iters[s - 1];
      for (int it = 0; it < iters; ++it) {
        const int64_t mid = (lo + hi) >> 1;
        const int32_t v = post_docs[mid < n_post - 1 ? mid : n_post - 1];
        if (v < cur) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const bool found =
          lo < end && post_docs[lo < n_post - 1 ? lo : n_post - 1] == cur;
      if (!found) cur = PAD_VALUE;
    }
  }

  if (!in_range) return;
  if (cur != PAD_VALUE && query >= 0 && query < n_queries_pad) {
    atomicAdd(&counts[query], 1);
  }
  if (members != nullptr) members[i] = cur;
}

extern "C" int segment_fold_launch(
    const void* post_docs, int64_t n_post, const void* cells, int64_t n_cells,
    const void* stage_seg, int64_t seg_cols, int group_width,
    const void* stage_iters, int n_stages, int n_queries_pad, void* counts,
    void* entering, void* members, void* stream) {
  if (n_cells > 0) {
    const int threads = 256;
    const int64_t blocks = (n_cells + threads - 1) / threads;
    segment_fold_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)post_docs, n_post, (const int32_t*)cells, n_cells,
        (const int32_t*)stage_seg, seg_cols, group_width,
        (const int32_t*)stage_iters, n_stages, n_queries_pad,
        (int32_t*)counts, (int32_t*)entering, (int32_t*)members);
  }
  return (int)cudaGetLastError();
}
