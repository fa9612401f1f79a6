// flash_attention: forward attention with an online softmax, causal and
// sliding-window masks, GQA.
//
// Replaces the Pallas kernel `flash_attention_kernel` (body `_kernel`) of
// src/repro/kernels/flash_attention/kernel.py.
//
// Contract (what the Pallas kernel computes): q (B, H, Lq, D), k and v
// (B, Hkv, Lk, D), H a multiple of Hkv; query head h reads key/value head
// h / (H / Hkv).  Queries are aligned to the end of the keys: query row i
// sits at key position p = i + Lk - Lq.  Key j is visible to it when
// (not causal or j <= p) and (no window or j > p - window).  Scores are
// fp32 dot products times `scale`; masked scores are set to NEG_INF = -1e30
// (not -inf: a tile in which a row sees no key then gives exp(0) until a
// visible key arrives and the rescale factor wipes it, as on the TPU).
// The running max m, sum l and the (row, D) accumulator are fp32; the end
// divides by max(l, 1e-30) and casts to the input type.  Inputs are fp32
// or bf16 (template T), D <= 256, any strides with the last dimension
// dense (the model passes (B, L, H, D) buffers and the cache's valid
// prefix as views, so nothing is copied).  Every query row must see at
// least one key; the launcher in kernel.py refuses inputs where one
// cannot.
//
// Design.  The TPU grid's sequential third axis over key tiles (carried in
// VMEM scratch) becomes a loop inside one block over the live key tiles
// only: the block computes the first and last key its rows can see and
// walks the 32-key tiles between them, so tiles that are fully masked by
// causality or the window are never loaded (the skip of the Pallas
// kernel's `pl.when(live)`, with the same tile boundaries).  One block of
// 4 warps covers (batch·head, 16 query rows); each warp owns 4 rows.  The
// block stages its Q tile once and each K/V tile in shared memory as fp32
// (K transposed, its rows padded to 33 floats against bank conflicts),
// each thread keeping 16 branch-free loads in flight.
// Scores: lane j computes the dot product of key j of the tile with the
// warp's 4 query rows (Q read as float4 broadcasts).  Softmax: warp
// shuffles give each row's tile max and sum.  P·V: lanes split D (lane
// + 32c, c < D/32, so at D = 256 a lane keeps 4 rows x 8 fp32
// accumulators in registers), and each key's probability is broadcast
// with a shuffle.  The tail of the keys (Lk need not be a tile multiple:
// decode has Lk = 2049..2064) and of the queries is masked in the kernel.
//
// What bounds it on an H100.  At prefill (Lq = Lk = 2048, D = 256) the
// operations: 4·D operations (2·D multiply-adds) per visible (query, key)
// pair, hundreds per byte moved, far above the card's ~295 bf16 operations
// per byte.  At decode (Lq = 1) the bytes: every visible K/V row is read
// once for one query row.  This first version computes on the fp32 CUDA
// cores, not the tensor cores, so at prefill it stays far from its bf16
// tensor-core bound (989 TFLOP/s); a later version takes the products to
// wgmma with TMA-fed pipelined tiles.  At decode 15 of a block's 16 rows idle (3 of its 4
// warps only help stage the tiles), only B·H blocks run, and each GQA
// query head reads its K/V rows again (from L2); splitting the keys over
// blocks (split-K) is the later fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_NEG_INF (-1e30f)
#define FA_WARPS 4
#define FA_THREADS (FA_WARPS * 32)
#define FA_STAGE 16                  // loads in flight per thread when staging
#define FA_ROWS 4                    // query rows per warp
#define FA_BQ (FA_WARPS * FA_ROWS)   // query rows per block
#define FA_BK 32                     // keys per tile: one per lane
#define FA_KT_STRIDE (FA_BK + 1)     // padded row of the transposed K tile
#define FA_FULL 0xffffffffu

struct FaStrides {  // in elements: batch, head, position (D is dense)
  int64_t q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float fa_float(float x) { return x; }
__device__ __forceinline__ float fa_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float fa_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FA_FULL, x, o));
  return x;
}

__device__ __forceinline__ float fa_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FA_FULL, x, o);
  return x;
}

template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int h, int groups, int lq, int lk, int d,
                       FaStrides st, int causal, int has_window,
                       int64_t window, float scale) {
  constexpr int DP = NC * 32;  // D padded to a multiple of 32 with zeros
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [FA_BQ][DP]
  float* kt = qs + FA_BQ * DP;            // [DP][FA_KT_STRIDE]
  float* vs = kt + DP * FA_KT_STRIDE;     // [FA_BK][DP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hq = bh % h;
  const int hk = hq / groups;
  const int q0 = blockIdx.x * FA_BQ;
  const T* qb = q + b * st.q[0] + hq * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  T* ob = o + b * st.o[0] + hq * st.o[1];

  // Each staging loop issues FA_STAGE loads per thread before it converts
  // or stores any, and the loads are unconditional (an element outside the
  // tensor reads element 0 of its row block and is then replaced by 0), so
  // no branch separates them and their memory latencies overlap.
  for (int base = tid; base < FA_BQ * DP; base += FA_THREADS * FA_STAGE) {
    T x[FA_STAGE];
    bool ok[FA_STAGE];
#pragma unroll
    for (int u = 0; u < FA_STAGE; ++u) {
      const int idx = base + u * FA_THREADS;
      const int r = idx / DP, c = idx % DP;
      ok[u] = idx < FA_BQ * DP && q0 + r < lq && c < d;
      x[u] = qb[(ok[u] ? (int64_t)(q0 + r) * st.q[2] + c : 0)];
    }
#pragma unroll
    for (int u = 0; u < FA_STAGE; ++u) {
      const int idx = base + u * FA_THREADS;
      if (idx < FA_BQ * DP) qs[idx] = ok[u] ? fa_float(x[u]) : 0.0f;
    }
  }

  // The keys the block's rows can see: [j_begin, j_end).  64-bit, since a
  // global layer's window is 2^30.
  const int rows_here = min(FA_BQ, lq - q0);
  const int64_t q_lo = (int64_t)q0 + (lk - lq);  // key position of row 0
  const int64_t q_hi = q_lo + rows_here - 1;
  int64_t j_begin = 0, j_end = lk;
  if (has_window && q_lo - window + 1 > 0) j_begin = q_lo - window + 1;
  if (causal && q_hi + 1 < j_end) j_end = q_hi + 1;

  const int r0 = warp * FA_ROWS;
  const bool warp_live = q0 + r0 < lq;  // uniform across the warp
  int64_t pos[FA_ROWS];
  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][NC];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    pos[r] = q_lo + r0 + r;
    m[r] = FA_NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  for (int64_t t0 = (j_begin / FA_BK) * FA_BK; t0 < j_end; t0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed
    for (int base = tid; base < FA_BK * DP; base += FA_THREADS * FA_STAGE) {
      T kx[FA_STAGE], vx[FA_STAGE];
      bool ok[FA_STAGE];
#pragma unroll
      for (int u = 0; u < FA_STAGE; ++u) {
        const int idx = base + u * FA_THREADS;
        const int j = idx / DP, c = idx % DP;
        ok[u] = idx < FA_BK * DP && t0 + j < lk && c < d;
        kx[u] = kb[ok[u] ? (t0 + j) * st.k[2] + c : 0];
        vx[u] = vb[ok[u] ? (t0 + j) * st.v[2] + c : 0];
      }
#pragma unroll
      for (int u = 0; u < FA_STAGE; ++u) {
        const int idx = base + u * FA_THREADS;
        if (idx < FA_BK * DP) {
          const int j = idx / DP, c = idx % DP;
          kt[c * FA_KT_STRIDE + j] = ok[u] ? fa_float(kx[u]) : 0.0f;
          vs[j * DP + c] = ok[u] ? fa_float(vx[u]) : 0.0f;
        }
      }
    }
    __syncthreads();
    if (!warp_live) continue;  // all of this warp's rows lie past Lq

    float s[FA_ROWS];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) s[r] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float k0 = kt[(c + 0) * FA_KT_STRIDE + lane];
      const float k1 = kt[(c + 1) * FA_KT_STRIDE + lane];
      const float k2 = kt[(c + 2) * FA_KT_STRIDE + lane];
      const float k3 = kt[(c + 3) * FA_KT_STRIDE + lane];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + (r0 + r) * DP + c);
        s[r] = fmaf(q4.x, k0, s[r]);
        s[r] = fmaf(q4.y, k1, s[r]);
        s[r] = fmaf(q4.z, k2, s[r]);
        s[r] = fmaf(q4.w, k3, s[r]);
      }
    }

    const int64_t j = t0 + lane;
    const bool in_range = j < lk;
    float p[FA_ROWS];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      bool visible = in_range;
      if (causal) visible = visible && j <= pos[r];
      if (has_window) visible = visible && j > pos[r] - window;
      const float sr = visible ? s[r] * scale : FA_NEG_INF;
      const float m_new = fmaxf(m[r], fa_warp_max(sr));
      p[r] = in_range ? expf(sr - m_new) : 0.0f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + fa_warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < FA_BK; ++jj) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[jj * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float pj = __shfl_sync(FA_FULL, p[r], jj);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + (int64_t)row * st.o[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) fa_store(orow + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int NC>
static int launch_nc(const void* q, const void* k, const void* v, void* o,
                     int64_t b, int64_t h, int64_t hkv, int64_t lq, int64_t lk,
                     int64_t d, const FaStrides& st, int causal, int has_window,
                     int64_t window, float scale, cudaStream_t stream) {
  const int dp = NC * 32;
  const size_t smem = sizeof(float) *
      (size_t)(FA_BQ * dp + dp * FA_KT_STRIDE + FA_BK * dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((lq + FA_BQ - 1) / FA_BQ), (unsigned)(b * h));
  flash_attention_kernel<T, NC><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)h, (int)(h / hkv),
      (int)lq, (int)lk, (int)d, st, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(const void* q, const void* k, const void* v, void* o,
                    int64_t b, int64_t h, int64_t hkv, int64_t lq, int64_t lk,
                    int64_t d, const FaStrides& st, int causal, int has_window,
                    int64_t window, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch_nc<T, 1>(q, k, v, o, b, h, hkv, lq, lk, d, st, causal,
                           has_window, window, scale, stream);
  if (d <= 64)
    return launch_nc<T, 2>(q, k, v, o, b, h, hkv, lq, lk, d, st, causal,
                           has_window, window, scale, stream);
  if (d <= 128)
    return launch_nc<T, 4>(q, k, v, o, b, h, hkv, lq, lk, d, st, causal,
                           has_window, window, scale, stream);
  return launch_nc<T, 8>(q, k, v, o, b, h, hkv, lq, lk, d, st, causal,
                         has_window, window, scale, stream);
}

// strides: 12 int64 (q, k, v, o; each batch, head, position).  dtype: 0 =
// fp32, 1 = bf16.  Returns the CUDA error of the launch (0 when it ran).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int64_t b, int64_t h, int64_t hkv,
                                      int64_t lq, int64_t lk, int64_t d,
                                      const int64_t* strides, int causal,
                                      int has_window, int64_t window, float scale,
                                      int dtype, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || h % hkv != 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (lq <= 0 || b * h <= 0) return 0;
  FaStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, b, h, hkv, lq, lk, d, st, causal,
                           has_window, window, scale, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, o, b, h, hkv, lq, lk, d, st,
                                   causal, has_window, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
