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
template <int ITEMS>
__device__ __forceinline__ int32_t probe_window(const int32_t* w, int64_t n,
                                                const int32_t (&x)[ITEMS]) {
  int64_t base[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) base[i] = 0;
  int64_t len = n;
  while (len > 1) {
    const int64_t half = len >> 1;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      base[i] = w[base[i] + half] < x[i] ? base[i] + half : base[i];
    }
    len -= half;
  }
  int32_t hits = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t pos = base[i] + (w[base[i]] < x[i] ? 1 : 0);
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
