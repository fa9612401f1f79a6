// The intersect trio: per-row membership of PAD-padded int32 doc-id rows.
//
// Replaces the Pallas kernels of src/repro/kernels/intersect/kernel.py:
//   intersect_members_launch        <- intersect_members_kernel
//                                      (_members_kernel -> _probe_hits)
//   intersect_members_count_launch  <- intersect_members_count_kernel
//                                      (_members_count_kernel)
//   intersect_count_launch          <- intersect_count_kernel (_kernel)
//
// Contract: short (B, Ls) and long (B, Ll) int32, row-major and dense;
// long rows are sorted with PAD last, short rows may hold PAD holes
// anywhere; PAD never matches.  Postings are strictly increasing within a
// row, so per-element membership equals the TPU kernel's count of equal
// (short, long) pairs.
//
// The TPU kernels walk 128-wide tiles of the long row held in VMEM and
// skip tiles by a min/max directory, because a TPU has no cheap gather.
// On Hopper a thread can binary-search the long row directly: one thread
// per short element (mask form), or one block per row with a block-level
// sum (count forms).  Every probe step is a dependent read of the long
// row; rows of a block share them through L1.
//
// What bounds it: device-memory bytes.  The short and long blocks are
// each read once from DRAM (the probes of one row stay in L1/L2) and the
// output written once; the compares are a few integer operations per
// probe, far below the card's integer rate.
//
// The count forms come in two shapes of grid (kernel.py's count_route
// and split_chunk pick the form and the chunk by shape):
//   row_count_kernel    one block a row.  At the block path's ~15,000
//                       rows of <= 1,024 short elements that fills the
//                       card.
//   split_count_kernel  one block a (row, chunk of the short row).  The
//                       non-clustered baseline's bins hold 1-40 rows of up
//                       to 131,072 short elements against 262,144 long
//                       ones: one block a row would run 30 blocks on 132
//                       SMs, each thread walking ~1,000 elements one after
//                       another.  The TPU kernel's second grid axis (short
//                       tiles, long tiles skipped by their min/max range)
//                       is what this form restores.  Each block reduces
//                       its chunk's non-PAD min and max (an all-PAD chunk
//                       exits), finds the long row's window [lower_bound
//                       (min), upper_bound(max)) by a block-wide search
//                       that narrows by the block's width a step (3 steps
//                       over 262,144 elements instead of 18), copies a
//                       window that fits into shared memory (cp.async),
//                       and probes its elements inside the
//                       window only, its ITEMS searches interleaved so that
//                       their loads are in flight together.  Each block
//                       adds its count to its row's output (zeroed on the
//                       same stream) by one integer atomicAdd: exact in any
//                       order, and nothing for a CUDA graph to refuse.
//
// The non-clustered baseline counts every bin of a batch in one launch:
//   intersect_count_bins_launch     <- intersect_count_kernel, once over
//                                      every bin (the reference runs it
//                                      bin by bin, then scatters)
//   bins_count_kernel   one warp a work item of a host-built table (rows
//                       or chunks of rows of every bin, the heaviest
//                       first), warps walking the table in a grid-stride
//                       over a persistent grid.  Only true elements are
//                       read: the table carries each row's n_short and
//                       n_long, so no PAD tail is loaded.  Two kinds of
//                       item, by the row's Ll / Ls:
//     merge   balanced rows: an item is a range [d0, d1) of the row's
//             merge path (short and long merged, ties short first).  The
//             warp finds the co-ranks of d0 and d1 (its window of both
//             rows) by a warp-wide search that samples 32 positions a step
//             (the first step around the co-rank random ids would give),
//             stages both ranges in its shared-memory buffer with 16-byte
//             cp.async (start aligned down to 4 elements, the ragged end
//             by 4-byte copies) plus the long element just past its range,
//             and counts by a merge path over the staged tiles: each lane
//             a co-ranked share, every element read once.  The buffers are
//             double-buffered: the next item's search and copies are
//             issued before this item's merge.
//     search  skewed rows: a chunk of 32 x ITEMS short elements, each
//             searched in the whole long row (probe_window: ITEMS
//             branchless searches a lane, interleaved); the chunk's values
//             span most of the row, whose top levels every probe of the
//             row shares in L1 and L2.
//   Each item adds its warp's sum by one atomicAdd into out[query_id]; the
//   launcher zeroes out by one cudaMemsetAsync on the same stream first.
//   Nothing is copied from the host: a call can be captured in a graph.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define PAD_VALUE 0x7fffffff

// Leftmost binary search of x in the sorted row[0:len]; PAD never matches.
__device__ __forceinline__ bool probe_row(const int32_t* __restrict__ row,
                                          int64_t len, int32_t x) {
  if (x == PAD_VALUE || len <= 0) return false;
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < len && row[lo] == x;
}

__global__ void members_mask_kernel(const int32_t* __restrict__ short_rows,
                                    const int32_t* __restrict__ long_rows,
                                    int64_t n_rows, int64_t ls, int64_t ll,
                                    int32_t* __restrict__ out) {
  const int64_t n = n_rows * ls;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / ls;
    const int32_t x = short_rows[i];
    out[i] = probe_row(long_rows + r * ll, ll, x) ? x : PAD_VALUE;
  }
}

// One block per row: each thread probes a strided share of the short row,
// the warp sums with a shuffle reduction, warps combine in shared memory.
__global__ void row_count_kernel(const int32_t* __restrict__ short_rows,
                                 const int32_t* __restrict__ long_rows,
                                 int64_t n_rows, int64_t ls, int64_t ll,
                                 int32_t* __restrict__ out) {
  __shared__ int32_t warp_sums[32];
  for (int64_t r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int32_t* srow = short_rows + r * ls;
    const int32_t* lrow = long_rows + r * ll;
    int32_t hits = 0;
    for (int64_t c = threadIdx.x; c < ls; c += blockDim.x) {
      hits += probe_row(lrow, ll, srow[c]) ? 1 : 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
      hits += __shfl_down_sync(0xffffffffu, hits, off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_sums[warp] = hits;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t total = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
      out[r] = total;
    }
    __syncthreads();
  }
}

static unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  return (unsigned)(blocks > 0 ? blocks : 1);
}

extern "C" int intersect_members_launch(const void* short_rows,
                                        const void* long_rows, int64_t n_rows,
                                        int64_t ls, int64_t ll, void* out,
                                        void* stream) {
  if (n_rows > 0 && ls > 0) {
    const int threads = 256;
    members_mask_kernel<<<grid_for(n_rows * ls, threads), threads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)short_rows, (const int32_t*)long_rows, n_rows, ls, ll,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

static int launch_row_count(const void* short_rows, const void* long_rows,
                            int64_t n_rows, int64_t ls, int64_t ll, void* out,
                            void* stream) {
  if (n_rows > 0) {
    const int threads = 128;
    const unsigned blocks =
        (unsigned)(n_rows < 65535LL * 32 ? n_rows : 65535LL * 32);
    row_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)short_rows, (const int32_t*)long_rows, n_rows, ls, ll,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The split form.
// ---------------------------------------------------------------------

#define SPLIT_THREADS 256
// Largest window a block stages in shared memory (int32 elements, 16 KB):
// a wider window is probed in global memory (through L1/L2).
#define SPLIT_STAGE 4096

// Block-wide lower_bound of both keys in the sorted row[0:len]: each step
// samples the live range at SPLIT_THREADS evenly spaced positions and keeps
// the gap between the last sample below the key and the next one, so the
// range shrinks by the block's width a step.  Every thread returns the
// same bounds (the counts come from __syncthreads_count).
__device__ __forceinline__ void block_lower_bounds(const int32_t* __restrict__ row,
                                                   int64_t len, int32_t k0, int32_t k1,
                                                   int64_t* b0, int64_t* b1) {
  int64_t lo0 = 0, hi0 = len, lo1 = 0, hi1 = len;
  while (lo0 < hi0 || lo1 < hi1) {
    const int64_t s0 = (hi0 - lo0 + SPLIT_THREADS - 1) / SPLIT_THREADS;
    const int64_t s1 = (hi1 - lo1 + SPLIT_THREADS - 1) / SPLIT_THREADS;
    const int64_t i0 = lo0 + (int64_t)threadIdx.x * s0;
    const int64_t i1 = lo1 + (int64_t)threadIdx.x * s1;
    const int p0 = lo0 < hi0 && i0 < hi0 && row[i0] < k0;
    const int p1 = lo1 < hi1 && i1 < hi1 && row[i1] < k1;
    const int64_t c0 = __syncthreads_count(p0);
    const int64_t c1 = __syncthreads_count(p1);
    if (lo0 < hi0) {
      const int64_t nhi = lo0 + c0 * s0 < hi0 ? lo0 + c0 * s0 : hi0;
      lo0 = c0 == 0 ? lo0 : lo0 + (c0 - 1) * s0 + 1;
      hi0 = c0 == 0 ? lo0 : nhi;
    }
    if (lo1 < hi1) {
      const int64_t nhi = lo1 + c1 * s1 < hi1 ? lo1 + c1 * s1 : hi1;
      lo1 = c1 == 0 ? lo1 : lo1 + (c1 - 1) * s1 + 1;
      hi1 = c1 == 0 ? lo1 : nhi;
    }
  }
  *b0 = lo0;
  *b1 = lo1;
}

// ITEMS branchless lower_bound searches over the same window w[0:n]
// (n >= 1, no PAD inside), interleaved step by step; a hit is x at the
// lower bound.  PAD keys never hit (the window holds none).
template <int ITEMS, typename Index = int64_t>
__device__ __forceinline__ int32_t probe_window(const int32_t* w, Index n,
                                                const int32_t (&x)[ITEMS]) {
  Index base[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) base[i] = 0;
  Index len = n;
  while (len > 1) {
    const Index half = len >> 1;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      base[i] = w[base[i] + half] < x[i] ? base[i] + half : base[i];
    }
    len -= half;
  }
  int32_t hits = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const Index pos = base[i] + (w[base[i]] < x[i] ? 1 : 0);
    hits += (pos < n && w[pos] == x[i]) ? 1 : 0;
  }
  return hits;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Block (chunk, row): the chunk's CHUNK = SPLIT_THREADS * ITEMS short
// elements (thread t holds elements t, t + SPLIT_THREADS, ...), counted
// against its window of the long row.  A window of at most SPLIT_STAGE
// elements is copied to shared memory first.
template <int ITEMS>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_count_kernel(const int32_t* __restrict__ short_rows,
                   const int32_t* __restrict__ long_rows, int64_t n_rows, int64_t ls,
                   int64_t ll, int32_t* __restrict__ out) {
  __shared__ int32_t window[SPLIT_STAGE];
  __shared__ int32_t warp_min[SPLIT_THREADS / 32], warp_max[SPLIT_THREADS / 32];
  __shared__ int32_t warp_hits[SPLIT_THREADS / 32];
  const int64_t c0 = (int64_t)blockIdx.x * (SPLIT_THREADS * ITEMS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const int32_t* srow = short_rows + r * ls;
    const int32_t* lrow = long_rows + r * ll;
    int32_t x[ITEMS];
    int32_t mn = PAD_VALUE, mx = INT_MIN;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t c = c0 + threadIdx.x + (int64_t)i * SPLIT_THREADS;
      x[i] = c < ls ? srow[c] : PAD_VALUE;
      if (x[i] != PAD_VALUE) {
        mn = min(mn, x[i]);
        mx = max(mx, x[i]);
      }
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) {
      warp_min[warp] = mn;
      warp_max[warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < SPLIT_THREADS / 32; ++w) {
      mn = min(mn, warp_min[w]);
      mx = max(mx, warp_max[w]);
    }
    // An all-PAD chunk counts nothing (block-uniform: every thread read
    // the same shared minimum).
    if (mn == PAD_VALUE || ll <= 0) {
      __syncthreads();
      continue;
    }
    int64_t wlo, whi;
    // upper_bound(mx) = lower_bound(mx + 1); mx < PAD, so mx + 1 fits.
    block_lower_bounds(lrow, ll, mn, mx + 1, &wlo, &whi);
    const int64_t n = whi - wlo;
    int32_t hits = 0;
    if (n > 0) {
      if (n <= SPLIT_STAGE) {
        for (int64_t i = threadIdx.x; i < n; i += SPLIT_THREADS) {
          cp_async4(window + i, lrow + wlo + i);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        hits = probe_window<ITEMS>(window, n, x);
      } else {
        hits = probe_window<ITEMS>(lrow + wlo, n, x);
      }
    }
    hits = __reduce_add_sync(0xffffffffu, hits);
    if (lane == 0) warp_hits[warp] = hits;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t total = 0;
#pragma unroll
      for (int w = 0; w < SPLIT_THREADS / 32; ++w) total += warp_hits[w];
      if (total) atomicAdd(out + r, total);
    }
    __syncthreads();  // the shared arrays and window are reused by the next row
  }
}

template <int ITEMS>
static int launch_split(const void* short_rows, const void* long_rows, int64_t n_rows,
                        int64_t ls, int64_t ll, void* out, void* stream) {
  const int64_t chunk = (int64_t)SPLIT_THREADS * ITEMS;
  const int64_t chunks = (ls + chunk - 1) / chunk;
  if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)(n_rows < 65535 ? n_rows : 65535));
  split_count_kernel<ITEMS><<<grid, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)short_rows, (const int32_t*)long_rows, n_rows, ls, ll, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The split form of both count launchers: per-row |short ∩ long| added
// into ``out``, which the caller zeroes on ``stream`` first.  ``chunk``
// (short elements a block) is SPLIT_THREADS times 2 or 8 (kernel.py's
// split_chunk).
extern "C" int intersect_count_split_launch(const void* short_rows, const void* long_rows,
                                            int64_t n_rows, int64_t ls, int64_t ll,
                                            int64_t chunk, void* out, void* stream) {
  if (n_rows <= 0 || ls <= 0) return (int)cudaGetLastError();
  switch (chunk) {
    case SPLIT_THREADS * 2:
      return launch_split<2>(short_rows, long_rows, n_rows, ls, ll, out, stream);
    case SPLIT_THREADS * 8:
      return launch_split<8>(short_rows, long_rows, n_rows, ls, ll, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// The baseline's one launch over a work table.
// ---------------------------------------------------------------------

#define BINS_WARPS 4
#define BINS_THREADS (BINS_WARPS * 32)
#define FULL_MASK 0xffffffffu
// A work item: ITEM_WORDS int64 words (kernel.py's ITEM_COLUMNS).
#define ITEM_WORDS 8
#define ITEM_SHORT_OFF 0  // element offset of the row's short elements
#define ITEM_LONG_OFF 1   // element offset of the row's long elements
#define ITEM_N_SHORT 2    // the row's true lengths
#define ITEM_N_LONG 3
#define ITEM_START 4      // merge: first merge-path position; search: first short element
#define ITEM_LENGTH 5     // merge: positions (<= TILE); search: short elements (<= 32 ITEMS)
#define ITEM_QUERY 6
#define ITEM_KIND 7
#define KIND_MERGE 0
// A warp's staging buffer: TILE positions, the long element past them and
// the alignment slack of both ranges (3 each, 3 to align long's start).
#define BINS_CAP(TILE) ((TILE) + 16)

// Positions inside a row are int32 (index/batched.py's upload_bins takes
// rows of at most 2^30 elements): the two items a warp holds then take 56
// registers a thread, not 70-72, and the kernel runs 36 warps an SM, not 28.
struct BinItem {
  const int32_t* a;  // the row's short elements
  const int32_t* b;  // the row's long elements
  int32_t ns, nl, start, len, query, kind;
  // merge items: co-ranks of start and start + len, and the staged layout
  int32_t a0, a1, b0, b1, ga, gb;
  int32_t sb;  // buffer offset of long's first staged element (gb)
};

__device__ __forceinline__ void load_bin_item(const int64_t* __restrict__ items, int64_t k,
                                              const int32_t* short_buf, const int32_t* long_buf,
                                              BinItem& it) {
  const int lane = threadIdx.x & 31;
  const int64_t w = lane < ITEM_WORDS ? items[k * ITEM_WORDS + lane] : 0;
  const int32_t v = (int32_t)w;
  it.a = short_buf + __shfl_sync(FULL_MASK, w, ITEM_SHORT_OFF);
  it.b = long_buf + __shfl_sync(FULL_MASK, w, ITEM_LONG_OFF);
  it.ns = __shfl_sync(FULL_MASK, v, ITEM_N_SHORT);
  it.nl = __shfl_sync(FULL_MASK, v, ITEM_N_LONG);
  it.start = __shfl_sync(FULL_MASK, v, ITEM_START);
  it.len = __shfl_sync(FULL_MASK, v, ITEM_LENGTH);
  it.query = __shfl_sync(FULL_MASK, v, ITEM_QUERY);
  it.kind = __shfl_sync(FULL_MASK, v, ITEM_KIND);
}

// First samples of a co-rank search over [lo, hi): 32 positions spaced
// about sigma / 4 apart around the co-rank of diagonal d if the rows' ids
// were random (d ns / (ns + nl), standard deviation sigma); a range of at
// most 32 is sampled whole.  Any data stay exact: a co-rank outside the
// samples narrows the range to one side of them.
__device__ __forceinline__ void corank_first(int32_t d, int32_t ns, int32_t nl, int32_t lo,
                                             int32_t hi, int32_t& base, int32_t& step) {
  if (hi - lo <= 32) {
    base = lo;
    step = 1;
    return;
  }
  const float q = (float)ns / ((float)ns + (float)nl);
  const int32_t guess = (int32_t)((float)d * q);
  step = (int32_t)(sqrtf((float)d * q * (1.0f - q)) * 0.25f) + 1;
  base = min(max(guess - 16 * step, lo), hi - 1);
}

// One step of a warp-wide search for the first position of [lo, hi) where
// a predicate, true then false, is false: ``c`` samples base + lane * step
// were true.
__device__ __forceinline__ void corank_narrow(int32_t& lo, int32_t& hi, int32_t base,
                                              int32_t step, int c) {
  if (c == 0) {
    hi = min(hi, base);
  } else {
    lo = base + (c - 1) * step + 1;
    if (c < 32) hi = min(hi, base + c * step);
  }
}

// Merge-path co-ranks of diagonals d0 and d1 of the rows a[0:ns], b[0:nl]
// (ties: a first): the number of a's elements among the first d of the
// merge, i.e. the first m in [max(0, d - nl), min(d, ns)) with
// a[m] > b[d - 1 - m].  Both searches share each step's loads.
__device__ __forceinline__ void warp_coranks(const int32_t* __restrict__ a,
                                             const int32_t* __restrict__ b, int32_t ns,
                                             int32_t nl, int32_t d0, int32_t d1, int32_t& r0,
                                             int32_t& r1) {
  const int lane = threadIdx.x & 31;
  int32_t lo0 = max(0, d0 - nl), hi0 = min(d0, ns);
  int32_t lo1 = max(0, d1 - nl), hi1 = min(d1, ns);
  int32_t base0, step0, base1, step1;
  corank_first(d0, ns, nl, lo0, hi0, base0, step0);
  corank_first(d1, ns, nl, lo1, hi1, base1, step1);
  while (lo0 < hi0 || lo1 < hi1) {
    const int32_t x0 = base0 + lane * step0, x1 = base1 + lane * step1;
    const bool p0 = lo0 < hi0 && x0 < hi0 && a[x0] <= b[d0 - 1 - x0];
    const bool p1 = lo1 < hi1 && x1 < hi1 && a[x1] <= b[d1 - 1 - x1];
    const int c0 = __popc(__ballot_sync(FULL_MASK, p0));
    const int c1 = __popc(__ballot_sync(FULL_MASK, p1));
    if (lo0 < hi0) corank_narrow(lo0, hi0, base0, step0, c0);
    if (lo1 < hi1) corank_narrow(lo1, hi1, base1, step1, c1);
    step0 = (hi0 - lo0 + 31) >> 5;
    step1 = (hi1 - lo1 + 31) >> 5;
    base0 = lo0;
    base1 = lo1;
  }
  r0 = lo0;
  r1 = lo1;
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Copy row[g:end) (g a multiple of 4 elements, the row 16-byte aligned)
// to dst[0:end - g]: 16-byte copies, then the ragged end by 4-byte ones,
// so nothing past ``end`` is read.
__device__ __forceinline__ void stage_range(int32_t* dst, const int32_t* row, int32_t g,
                                            int32_t end) {
  const int lane = threadIdx.x & 31;
  const int32_t body = end & ~3;
  for (int32_t i = g + 4 * lane; i < body; i += 128) cp_async16(dst + (i - g), row + i);
  const int32_t t = body + lane;
  if (t < end) cp_async4(dst + (t - g), row + t);
}

// Issue item ``it``'s part before its count: a merge item's co-ranks and
// copies into ``buf``.  Every call commits one cp.async group (empty for
// a search item), so the caller can wait for all but the newest.
__device__ __forceinline__ void bins_prepare(BinItem& it, int32_t* buf) {
  if (it.kind == KIND_MERGE) {
    warp_coranks(it.a, it.b, it.ns, it.nl, it.start, it.start + it.len, it.a0, it.a1);
    it.b0 = it.start - it.a0;
    it.b1 = it.start + it.len - it.a1;
    it.ga = it.a0 & ~3;
    it.gb = it.b0 & ~3;
    it.sb = (it.a1 - it.ga + 3) & ~3;
    if (it.a1 > it.a0) stage_range(buf, it.a, it.ga, it.a1);
    // the long element past the range: a short element last in this item
    // may equal it
    stage_range(buf + it.sb, it.b, it.gb, min(it.b1 + 1, it.nl));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The merge count of a staged item: lane l takes merge positions
// [l per, (l + 1) per) of the item's tile, co-ranked in shared memory,
// and counts the short elements equal to the long element the merge
// stands at when it takes them.
template <int TILE>
__device__ __forceinline__ int32_t bins_merge(const BinItem& it, const int32_t* buf) {
  const int lane = threadIdx.x & 31;
  const int32_t* A = buf + (it.a0 - it.ga);
  const int32_t* B = buf + it.sb + (it.b0 - it.gb);
  const int na = it.a1 - it.a0, nb = it.b1 - it.b0;
  const int nb_seen = nb + (it.b1 < it.nl ? 1 : 0);
  const int total = na + nb, per = (total + 31) >> 5;
  const int p0 = min(lane * per, total), p1 = min(p0 + per, total);
  int lo = max(0, p0 - nb), hi = min(p0, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (A[mid] <= B[p0 - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = p0 - lo;
  int32_t hits = 0;
  for (int p = p0; p < p1; ++p) {
    if (i < na && (j >= nb || A[i] <= B[j])) {
      hits += (j < nb_seen && A[i] == B[j]) ? 1 : 0;
      ++i;
    } else {
      ++j;
    }
  }
  return hits;
}

template <int ITEMS>
__device__ __forceinline__ int32_t bins_search(const BinItem& it) {
  const int lane = threadIdx.x & 31;
  int32_t x[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int32_t c = lane + 32 * i;
    x[i] = c < it.len ? it.a[it.start + c] : PAD_VALUE;
  }
  return it.nl > 0 ? probe_window<ITEMS, int32_t>(it.b, it.nl, x) : 0;
}

template <int TILE, int ITEMS>
__global__ void __launch_bounds__(BINS_THREADS)
bins_count_kernel(const int32_t* __restrict__ short_buf, const int32_t* __restrict__ long_buf,
                  const int64_t* __restrict__ items, int64_t n_items,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t bins_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* bufs = bins_smem + warp * 2 * BINS_CAP(TILE);
  const int64_t n_warps = (int64_t)gridDim.x * BINS_WARPS;
  int64_t k = (int64_t)blockIdx.x * BINS_WARPS + warp;
  if (k >= n_items) return;
  BinItem cur, nxt;
  load_bin_item(items, k, short_buf, long_buf, cur);
  bins_prepare(cur, bufs);
  for (int s = 0; k < n_items; ++s) {
    const int64_t kn = k + n_warps;
    if (kn < n_items) {
      load_bin_item(items, kn, short_buf, long_buf, nxt);
      bins_prepare(nxt, bufs + ((s + 1) & 1) * BINS_CAP(TILE));
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    int32_t hits = cur.kind == KIND_MERGE
                       ? bins_merge<TILE>(cur, bufs + (s & 1) * BINS_CAP(TILE))
                       : bins_search<ITEMS>(cur);
    hits = __reduce_add_sync(FULL_MASK, hits);
    if (lane == 0 && hits) atomicAdd(out + cur.query, hits);
    __syncwarp();  // this buffer takes the item after next
    cur = nxt;
    k = kn;
  }
}

template <int TILE, int ITEMS>
static int launch_bins(const void* short_buf, const void* long_buf, const void* items,
                       int64_t n_items, void* out, int sms, void* stream) {
  const int smem = BINS_WARPS * 2 * BINS_CAP(TILE) * (int)sizeof(int32_t);
  static int per_sm = 0;  // resident blocks a multiprocessor, asked once
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(bins_count_kernel<TILE, ITEMS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bins_count_kernel<TILE, ITEMS>,
                                                        BINS_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  int64_t blocks = (n_items + BINS_WARPS - 1) / BINS_WARPS;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  bins_count_kernel<TILE, ITEMS><<<(unsigned)blocks, BINS_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)short_buf, (const int32_t*)long_buf, (const int64_t*)items, n_items,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int TILE>
static int launch_bins_tile(const void* short_buf, const void* long_buf, const void* items,
                            int64_t n_items, void* out, int64_t chunk, int sms, void* stream) {
  switch (chunk) {
    case 64:
      return launch_bins<TILE, 2>(short_buf, long_buf, items, n_items, out, sms, stream);
    case 128:
      return launch_bins<TILE, 4>(short_buf, long_buf, items, n_items, out, sms, stream);
    case 256:
      return launch_bins<TILE, 8>(short_buf, long_buf, items, n_items, out, sms, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Per-query |short ∩ long| of every bin of a batch, (n_queries,) int32 in
// ``out``: zeroed on ``stream``, then one launch over the (n_items,
// ITEM_WORDS) int64 work table.  ``tile`` (merge positions an item) is
// 256, 512, 1,024 or 2,048; ``chunk`` (short elements a search item) 64, 128
// or 256; ``sms`` the card's multiprocessors.  Both buffers must be
// 16-byte aligned and every row offset a multiple of 4 elements.
extern "C" int intersect_count_bins_launch(const void* short_buf, const void* long_buf,
                                           const void* items, int64_t n_items, void* out,
                                           int64_t n_queries, int64_t tile, int64_t chunk,
                                           int sms, void* stream) {
  if (n_queries > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_queries * sizeof(int32_t),
                                            (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_items <= 0) return (int)cudaGetLastError();
  switch (tile) {
    case 256:
      return launch_bins_tile<256>(short_buf, long_buf, items, n_items, out, chunk, sms, stream);
    case 512:
      return launch_bins_tile<512>(short_buf, long_buf, items, n_items, out, chunk, sms, stream);
    case 1024:
      return launch_bins_tile<1024>(short_buf, long_buf, items, n_items, out, chunk, sms, stream);
    case 2048:
      return launch_bins_tile<2048>(short_buf, long_buf, items, n_items, out, chunk, sms, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int intersect_members_count_launch(const void* short_rows,
                                              const void* long_rows,
                                              int64_t n_rows, int64_t ls,
                                              int64_t ll, void* out,
                                              void* stream) {
  return launch_row_count(short_rows, long_rows, n_rows, ls, ll, out, stream);
}

extern "C" int intersect_count_launch(const void* short_rows,
                                      const void* long_rows, int64_t n_rows,
                                      int64_t ls, int64_t ll, void* out,
                                      void* stream) {
  return launch_row_count(short_rows, long_rows, n_rows, ls, ll, out, stream);
}
