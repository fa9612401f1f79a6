// cluster_scores: the δ⁺ scoring gather of the device K-means.
//
// Replaces the Pallas kernel `cluster_scores_kernel` (body `_kernel`) of
// src/repro/kernels/cluster_score/kernel.py.
//
// Contract: ell (N, L) int32 holds each document's frequent-term ranks;
// a slot outside [0, TC) is a pad and adds nothing, wherever it sits in
// the row (pads go up to 2^31 - 1, and may be negative).  p (TC,) and
// tables (TC, K) are fp32, row-major and dense.  Result (N, K) fp32:
//
//     out[d, :] = sum_l p[ell[d, l]] * tables[ell[d, l], :]
//
// Duplicate ranks in a row accumulate once per slot.
//
// The TPU kernel builds a one-hot (BD, TT) weight tile per term tile on
// the VPU and feeds a (BD, TT) @ (TT, K) product to the MXU, because a
// TPU has no cheap gather.  On Hopper the table rows are gathered
// directly.  Two variants; the launcher picks one from the shapes alone
// (kernels/cluster_score/kernel.py::score_route):
//
// `staged` (every K <= 16 whose table fits a block's shared memory: every
// round of TopDown, K <= chi = 8 over TC = 3000).  What bounds it on the
// H100 is device-memory bytes: the ELL (594 MB at the top split, mostly
// pads, all read because pads may sit anywhere) is nearly all of them.
// The first design (the `general` kernel below, one warp per row, one
// 128-byte ELL read and one serial L2 gather per valid slot in flight per
// warp) took 0.58 ms against a 0.18 ms byte bound; ablated copies of it
// (tools/kernel_ab.py) took 0.42 ms for the ELL stream alone and 0.50 ms
// for the gathers alone, so both the bytes in flight and the serial
// gathers held it.  This design (0.21 ms there):
//  * persistent blocks, as many as fit on each SM; each first stages the
//    weighted table W[r, c] = p[r] * tables[r, c] (fp32 products, rows
//    padded to KP = K rounded up to a power of two) into shared memory;
//  * a warp per row reads the row with 16-byte loads from the aligned
//    16-byte blocks that cover it (a row starts anywhere: L * 4 bytes
//    apart, and the base may sit inside a block), all of a row's loads in
//    flight at once (up to 32 * CH 16-byte vectors a batch);
//  * lanes take slots, not columns: each lane adds the W rows of its own
//    valid slots from shared memory (KP / 4 16-byte loads each), in slot
//    order, into KP register sums; a fixed xor-shuffle tree then combines
//    the 32 lanes.  The order is fixed by the shapes and the base address,
//    so the result is the same from run to run; no float atomics.
//
// `general` (larger K, or a table above the shared-memory budget, as the
// flat algorithm's K = 256 at TC = 3000): one warp per document row, lanes
// over K.  The warp reads its row's slots 32 at a time, coalesced; each
// lane tests its slot and gathers p[r] for it, a ballot lists the valid
// slots, and for each valid slot, in slot order, the lanes add p[r] *
// tables[r, lane + 32c] into fp32 accumulators held in registers (K / 32
// of them per lane, at most 8; a K above 256 is covered in column chunks
// of 256).  Every output element is owned by one thread and summed in
// slot order: no float atomics.  Its table rows come from L2 and its
// gathers run one after another, so it stays above its byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS_PER_BLOCK 8

template <int KPL>
__global__ void cluster_scores_general_kernel(const int32_t* __restrict__ ell,
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

extern "C" int cluster_scores_general_launch(const void* ell, int64_t n, int64_t l,
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
      cluster_scores_general_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    } else if (k <= 64) {
      cluster_scores_general_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    } else if (k <= 128) {
      cluster_scores_general_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    } else {
      cluster_scores_general_kernel<8><<<(unsigned)blocks, threads, 0, s>>>(
          e, n, l, pp, t, tc, k, o);
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The staged variant
// ---------------------------------------------------------------------

#define STAGED_THREADS 512
// Bytes of the weighted table a block stages at most (STAGED_TABLE_BYTES
// of kernels/cluster_score/kernel.py; a block may take 227 KB).
#define STAGED_TABLE_BYTES (192 * 1024)
#define STAGED_MAX_DEVICES 64

// 16-byte loads a lane keeps in flight per batch of a row.
template <int KP>
struct StagedChunks {
  static constexpr int value = KP >= 16 ? 4 : 6;
};

template <int KP>
__device__ __forceinline__ void add_weighted_row(float (&acc)[KP], const float* w_row) {
  if constexpr (KP >= 4) {
#pragma unroll
    for (int c = 0; c < KP; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w_row + c);
      acc[c] += v.x;
      acc[c + 1] += v.y;
      acc[c + 2] += v.z;
      acc[c + 3] += v.w;
    }
  } else if constexpr (KP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(w_row);
    acc[0] += v.x;
    acc[1] += v.y;
  } else {
    acc[0] += w_row[0];
  }
}

template <int KP>
__global__ void __launch_bounds__(STAGED_THREADS, KP >= 16 ? 1 : 2)
    cluster_scores_staged_kernel(const int32_t* __restrict__ ell, int64_t n, int64_t l,
                                 const float* __restrict__ p,
                                 const float* __restrict__ tables, int tc, int k,
                                 float* __restrict__ out) {
  extern __shared__ float4 staged_smem[];
  float* w = reinterpret_cast<float*>(staged_smem);
  constexpr int CH = StagedChunks<KP>::value;
  const int lane = threadIdx.x & 31;

  // W = p[r] * tables[r, c]: one fp32 product, zero in the padded columns.
#pragma unroll 8
  for (int i = threadIdx.x; i < tc * KP; i += STAGED_THREADS) {
    const int r = i / KP, c = i % KP;
    w[i] = c < k ? p[r] * tables[(int64_t)r * k + c] : 0.0f;
  }
  __syncthreads();

  // ell as whole 16-byte blocks: `mis` elements of the first block lie
  // before ell's base.
  const int mis = (int)((reinterpret_cast<uintptr_t>(ell) >> 2) & 3);
  const int4* __restrict__ blocks = reinterpret_cast<const int4*>(ell - mis);
  const int64_t first_warp = ((int64_t)blockIdx.x * STAGED_THREADS + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * STAGED_THREADS) >> 5;
  for (int64_t d = first_warp; d < n; d += n_warps) {
    float acc[KP];
#pragma unroll
    for (int c = 0; c < KP; ++c) acc[c] = 0.0f;
    const int64_t e0 = d * l + mis;  // the row's first slot, counted from `blocks`
    const int64_t v_begin = e0 >> 2;
    const int64_t v_end = l > 0 ? (e0 + l + 3) >> 2 : v_begin;
    const int lead = (int)(e0 & 3);  // elements of the first block before the row
    for (int64_t vb = v_begin; vb < v_end; vb += 32 * CH) {
      int4 buf[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int64_t v = vb + lane + 32 * j;
        buf[j] = v < v_end ? __ldcs(blocks + v) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int64_t slot0 = 4 * (vb - v_begin + lane + 32 * j) - lead;
        const int r4[4] = {buf[j].x, buf[j].y, buf[j].z, buf[j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t slot = slot0 + q;
          const int r = r4[q];
          if (slot >= 0 && slot < l && r >= 0 && r < tc) add_weighted_row<KP>(acc, w + r * KP);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < KP; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    float mine = 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      if (lane == c) mine = acc[c];
    }
    if (lane < k) out[d * k + lane] = mine;
  }
}

// The attribute, the SM count and the occupancy are looked up once per
// device (and table size), outside any CUDA-graph capture: the first call
// at a shape runs eagerly before a capture of it.
template <int KP>
static int launch_staged(const int32_t* ell, int64_t n, int64_t l, const float* p,
                         const float* tables, int tc, int k, float* out, cudaStream_t stream) {
  static bool ready[STAGED_MAX_DEVICES];
  static int sms[STAGED_MAX_DEVICES], per_sm[STAGED_MAX_DEVICES];
  static size_t per_sm_smem[STAGED_MAX_DEVICES];
  const size_t smem = (size_t)tc * KP * sizeof(float);
  if (smem > STAGED_TABLE_BYTES) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= STAGED_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(cluster_scores_staged_kernel<KP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, STAGED_TABLE_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  if (per_sm[device] == 0 || per_sm_smem[device] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[device], cluster_scores_staged_kernel<KP>, STAGED_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm[device] < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm_smem[device] = smem;
  }
  const int64_t warps = STAGED_THREADS / 32;
  int64_t blocks = (n + warps - 1) / warps;
  const int64_t resident = (int64_t)per_sm[device] * sms[device];
  if (blocks > resident) blocks = resident;
  cluster_scores_staged_kernel<KP><<<(unsigned)blocks, STAGED_THREADS, smem, stream>>>(
      ell, n, l, p, tables, tc, k, out);
  return (int)cudaGetLastError();
}

extern "C" int cluster_scores_staged_launch(const void* ell, int64_t n, int64_t l,
                                            const void* p, const void* tables, int64_t tc,
                                            int64_t k, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* e = (const int32_t*)ell;
  const float* pp = (const float*)p;
  const float* t = (const float*)tables;
  float* o = (float*)out;
  const int itc = (int)tc, ik = (int)k;
  if (k == 1) return launch_staged<1>(e, n, l, pp, t, itc, ik, o, s);
  if (k == 2) return launch_staged<2>(e, n, l, pp, t, itc, ik, o, s);
  if (k <= 4) return launch_staged<4>(e, n, l, pp, t, itc, ik, o, s);
  if (k <= 8) return launch_staged<8>(e, n, l, pp, t, itc, ik, o, s);
  if (k <= 16) return launch_staged<16>(e, n, l, pp, t, itc, ik, o, s);
  return (int)cudaErrorInvalidValue;
}
