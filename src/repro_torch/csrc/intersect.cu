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

#include <cuda_runtime.h>
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
