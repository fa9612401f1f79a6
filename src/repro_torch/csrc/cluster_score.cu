// cluster_scores: the δ⁺ scoring gather of the device K-means.
//
// Replaces the Pallas kernel `cluster_scores_kernel` (body `_kernel`) of
// src/repro/kernels/cluster_score/kernel.py.
//
// Contract: ell (N, L) int32 holds each document's frequent-term ranks;
// a slot outside [0, TC) is a pad and adds nothing, wherever it sits in
// the row (pads go up to 2^31 - 1).  p (TC,) and tables (TC, K) are fp32,
// row-major and dense.  Result (N, K) fp32:
//
//     out[d, :] = sum_l p[ell[d, l]] * tables[ell[d, l], :]
//
// Duplicate ranks in a row accumulate once per slot.
//
// The TPU kernel builds a one-hot (BD, TT) weight tile per term tile on
// the VPU and feeds a (BD, TT) @ (TT, K) product to the MXU, because a
// TPU has no cheap gather.  On Hopper a warp gathers the table rows
// directly: one warp per document row, lanes over K.  The warp reads its
// row's slots 32 at a time, coalesced; each lane tests its slot and
// gathers p[r] for it, a ballot lists the valid slots, and for each valid
// slot, in slot order, the lanes add p[r] * tables[r, lane + 32c] into
// fp32 accumulators held in registers (K / 32 of them per lane, at most
// 8; a K above 256 is covered in column chunks of 256).  Every output
// element is owned by one thread and summed in slot order: no float
// atomics, so the result is the same from run to run, and the argmin the
// clustering takes of it too.
//
// What bounds it: device-memory bytes.  The ELL matrix is read once and
// is most of the traffic (at the path's shapes it is ~93 % pad slots, all
// of which must be read because pads may sit anywhere); the output is
// written once.  The (TC, K) table is at most a few MB and stays in the
// 50 MB L2, so its gathered rows come from L2, not DRAM; at large K those
// L2 reads (K * 4 bytes per valid slot) and the serial chain of gathers
// per row are what keep the kernel above its byte bound.  Staging the
// table in shared memory and ordering the gathers is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS_PER_BLOCK 8

template <int KPL>
__global__ void cluster_scores_kernel(const int32_t* __restrict__ ell,
                                      int64_t n, int64_t l,
                                      const float* __restrict__ p,
                                      const float* __restrict__ tables,
                                      int64_t tc, int64_t k,
                                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t first_warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // Every loop bound below is uniform across the warp, so the ballot and
  // the shuffles always see all 32 lanes.
  for (int64_t d = first_warp; d < n; d += n_warps) {
    const int32_t* row = ell + d * l;
    float* orow = out + d * k;
    for (int64_t c0 = 0; c0 < k; c0 += 32 * KPL) {
      float acc[KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c) acc[c] = 0.0f;
      for (int64_t base = 0; base < l; base += 32) {
        const int64_t slot = base + lane;
        int32_t r = 0;
        float w = 0.0f;
        bool valid = false;
        if (slot < l) {
          r = row[slot];
          valid = r >= 0 && (int64_t)r < tc;
          if (valid) w = p[r];
        }
        unsigned todo = __ballot_sync(0xffffffffu, valid);
        while (todo) {
          const int s = __ffs(todo) - 1;
          todo &= todo - 1;
          const int32_t rs = __shfl_sync(0xffffffffu, r, s);
          const float ws = __shfl_sync(0xffffffffu, w, s);
          const float* trow = tables + (int64_t)rs * k + c0 + lane;
#pragma unroll
          for (int c = 0; c < KPL; ++c) {
            if (c0 + lane + 32 * c < k) acc[c] += ws * trow[32 * c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int64_t col = c0 + lane + 32 * c;
        if (col < k) orow[col] = acc[c];
      }
    }
  }
}

extern "C" int cluster_scores_launch(const void* ell, int64_t n, int64_t l,
                                     const void* p, const void* tables,
                                     int64_t tc, int64_t k, void* out,
                                     void* stream) {
  if (n > 0 && k > 0) {
    const int threads = 32 * WARPS_PER_BLOCK;
    int64_t blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
    const cudaStream_t s = (cudaStream_t)stream;
    const int32_t* e = (const int32_t*)ell;
    const float* pp = (const float*)p;
    const float* t = (const float*)tables;
    float* o = (float*)out;
    if (k <= 32) {
      cluster_scores_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    } else if (k <= 64) {
      cluster_scores_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    } else if (k <= 128) {
      cluster_scores_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    } else {
      cluster_scores_kernel<8><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    }
  }
  return (int)cudaGetLastError();
}
