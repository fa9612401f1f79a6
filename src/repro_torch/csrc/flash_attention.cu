// flash_attention: forward attention with an online softmax, causal and
// sliding-window masks, GQA.  Three of the port's four attention kernels:
// the general kernel `flash_attention_kernel`, the resident variant
// `flash_resident_kernel` and the decode variant `flash_decode_kernel`
// with its `flash_combine_kernel` (below); the prefill variant is
// csrc/flash_attention_sm90.cu.  The launcher in
// kernels/flash_attention/kernel.py picks one by dtype and shape:
//   - decode: Lq·(H/Hkv) <= 8 and D·itemsize a multiple of 16 bytes
//     (fp32 or bf16);
//   - sm90 prefill: bf16 with D in {64, 128, 256} otherwise;
//   - resident: fp32, not causal, no window, D a multiple of 4 up to 64,
//     and K and V of one (batch, KV head) within shared memory;
//   - general: everything else (fp32 at long Lq, other D).
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
// Design of the general kernel.  The TPU grid's sequential third axis over key tiles (carried in
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
// What bounds the general kernel on an H100: at a long Lq the operations
// (4·D per visible (query, key) pair), which it does on the fp32 CUDA
// cores, far from the bf16 tensor-core bound; the model's bf16 prefill
// goes to the sm90 variant instead, and its decode to the split-K variant.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident_common.cuh"

#define FA_NEG_INF (-1e30f)
#define FA_WARPS 4
#define FA_THREADS (FA_WARPS * 32)
#define FA_STAGE 16                  // loads in flight per thread when staging
#define FA_ROWS 4                    // query rows per warp
#define FA_BQ (FA_WARPS * FA_ROWS)   // query rows per block
#define FA_BK 32                     // keys per tile: one per lane
#define FA_KT_STRIDE (FA_BK + 1)     // padded row of the transposed K tile
#define FA_FULL 0xffffffffu
#define FA_MAX_GRID_Y 65535          // gridDim.y's limit: B·H is launched in such chunks

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
                       int64_t window, float scale, int64_t bh0) {
  constexpr int DP = NC * 32;  // D padded to a multiple of 32 with zeros
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [FA_BQ][DP]
  float* kt = qs + FA_BQ * DP;            // [DP][FA_KT_STRIDE]
  float* vs = kt + DP * FA_KT_STRIDE;     // [FA_BK][DP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t b = bh / h;
  const int hq = (int)(bh % h);
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
  // B·H rows in launches of at most FA_MAX_GRID_Y (gridDim.y's limit), on
  // one stream: no host sync between them.
  for (int64_t bh0 = 0; bh0 < b * h; bh0 += FA_MAX_GRID_Y) {
    const int64_t rows = b * h - bh0 < FA_MAX_GRID_Y ? b * h - bh0 : FA_MAX_GRID_Y;
    const dim3 grid((unsigned)((lq + FA_BQ - 1) / FA_BQ), (unsigned)rows);
    flash_attention_kernel<T, NC><<<grid, FA_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)h, (int)(h / hkv),
        (int)lq, (int)lk, (int)d, st, causal, has_window, window, scale, bh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
  if (d < 1 || d > 256 || hkv < 1 || h % hkv != 0) return (int)cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------
// The resident variant: fp32, not causal, no window (BERT4Rec's
// bidirectional encoder: Lq = Lk = 200, D = 32, B·H = 65,536 a slice).
//
// What held the general kernel back there: its blocks of 16 query rows
// restage all keys and values of the head, 13 blocks a head at Lq = 200,
// its scores and P·V run on the fp32 CUDA cores, and its P·V broadcasts
// every probability with a shuffle per key and row.
//
// Layout.  One block of FR_WARPS warps per (batch, KV head, query chunk);
// the launcher makes the chunk the whole of Lq unless B·Hkv is too small
// to fill the card.  K and V of the head are copied once into shared
// memory with 16-byte cp.async copies, as fp32 rows of DP = D rounded up
// to 32 (zeros past D; zero rows up to a multiple of 8 keys), each row's
// 16-byte pieces XOR-swizzled within groups of 8 (piece c of row r sits
// at c ^ (r & 7)), so that the fragment loads below hit 32 distinct banks
// at offsets each lane computes once.  The warps then walk the
// block's query rows (every query head of the group) in tiles of
// FR_ROWS = 16; a warp's Q tile lives in registers as mma fragments.
//
// Arithmetic: TF32 tensor cores (mma.sync.m16n8k8) in the 3xTF32 split
// (resident_common.cuh, which the backward shares), the softmax in fp32.
// Scores: Q (pre-multiplied by
// scale·log2 e) times K^T, 8 keys an mma, FR_KEYS = 32 keys a chunk.
// Softmax: online over the chunks, as the other kernels, in base 2: the
// running max m of each row (an xor shuffle over the row's 4 lanes), the
// sum l (per lane, summed once at the end), p = exp2(s - m) (one MUFU
// ex2.approx, relative error about 2^-22); keys past Lk get p = 0.  P·V: the mma's score fragment is the A fragment of the
// next mma when the k index kk of P·V runs over the 8 keys in the order
// (0, 2, 4, 6, 1, 3, 5, 7): lane (g, t) holds p of keys 2t and 2t + 1 of
// rows g and g + 8, which are A's (g, t), (g, t + 4), (g + 8, t),
// (g + 8, t + 4) under that order; V's rows are read in the same order.
// So P never leaves the registers.  The end divides by max(l, 1e-30),
// as the file's contract says.  Given an `lse` pointer (training: the
// resident backward of csrc/flash_attention_bwd_resident.cu reads it), the
// end also writes each row's natural-log log-sum-exp of its scaled scores,
// (m + log2 l)·ln 2, into lse[(b·H + h)·Lq + row]; serving passes null.
//
// What bounds it on an H100: the operations (4·D per (query, key) pair)
// over the bytes (q, k, v and o once), at BERT4Rec's call 5.0 ms on the
// fp32 CUDA cores (67 TFLOP/s) against 2.0 ms; the three TF32 products
// run on the tensor cores (495 TFLOP/s dense) instead.
// ---------------------------------------------------------------------

#define FR_WARPS 4
#define FR_THREADS (FR_WARPS * 32)
#define FR_ROWS 16            // query rows of a warp's tile: the mma's M
#define FR_KEYS 32            // keys of a chunk: 4 mma tiles of 8

struct FrParams {
  int h, groups, lq, lk, d, q_chunk;
  int64_t sq[3], sk[3], sv[3], so[3];  // strides in elements: batch, head, position
  float scale_log2;                    // scale · log2(e)
  float* lse;                          // (B·H, Lq) log-sum-exp of each row, or null
  int64_t bh0;                         // the first (batch, KV head) of this launch
};

// K and V as [lk rounded up to 8][dp] fp32 each.
static size_t fr_smem_bytes(int64_t lk, int dp) {
  return sizeof(float) * (size_t)2 * ((lk + 7) / 8 * 8) * dp;
}

template <int NC>
__global__ void __launch_bounds__(FR_THREADS)
flash_resident_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, FrParams p) {
  constexpr int DP = NC * 32;  // D padded to a multiple of 32 with zeros
  constexpr int NCH = DP / 4;  // 16-byte pieces of a padded row
  constexpr int KS = DP / 8;   // k steps of the scores' mma over D
  constexpr int NT = DP / 8;   // n tiles of P·V's mma over D
  constexpr int CT = FR_KEYS / 8;  // n tiles of the scores' mma over a chunk
  extern __shared__ __align__(16) float fr_smem[];
  const int lk = p.lk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma's group and thread in group
  const int lk8 = (lk + 7) / 8 * 8;   // rows past Lk hold zeros
  float* ks = fr_smem;                // [lk8][DP]
  float* vs = ks + (size_t)lk8 * DP;  // [lk8][DP]

  const int hkv = p.h / p.groups;
  const int64_t bh = p.bh0 + blockIdx.y;
  const int64_t b = bh / hkv;
  const int hk = (int)(bh % hkv);
  const float* kb = k + b * p.sk[0] + hk * p.sk[1];
  const float* vb = v + b * p.sv[0] + hk * p.sv[1];
  const int dch = p.d / 4;  // pieces of a row that hold data

  for (int idx = threadIdx.x; idx < lk8 * NCH; idx += FR_THREADS) {
    const int r = idx / NCH, c = idx % NCH;
    const bool full = c < dch && r < lk;
    const int off = r * DP + fr_swz(r, c) * 4;
    fr_cp16(ks + off, kb + (full ? r : 0) * p.sk[2] + (full ? c : 0) * 4, full);
    fr_cp16(vs + off, vb + (full ? r : 0) * p.sv[2] + (full ? c : 0) * 4, full);
  }

  // The lane's fragment offsets within a tile of 8 key rows: every tile
  // starts at a multiple of 8, so its rows' swizzle is fixed by the lane.
  // K: row g, columns 8s + t and + 4; V: rows 2t and 2t + 1, column 8j + g.
  int koff[KS][2], voff[NT][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) koff[s][h] = fr_at(g, 8 * s + t + 4 * h, DP);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) voff[j][h] = fr_at(2 * t + h, 8 * j + g, DP);
  fr_cp_wait_all();
  __syncthreads();

  // This block's query positions [p0, p1) of every query head of the group.
  const int p0 = blockIdx.x * p.q_chunk;
  const int p1 = min(p.lq, p0 + p.q_chunk);
  const int tiles_per_head = (p1 - p0 + FR_ROWS - 1) / FR_ROWS;
  for (int tile = warp; tile < p.groups * tiles_per_head; tile += FR_WARPS) {
    const int hq = hk * p.groups + tile / tiles_per_head;
    const int r0 = p0 + (tile % tiles_per_head) * FR_ROWS;
    const float* qb = q + b * p.sq[0] + (int64_t)hq * p.sq[1];

    // Q's A fragments, times scale·log2 e: rows g and g + 8, columns
    // 8s + t and 8s + t + 4 (zeros past D and past the chunk's rows).
    uint32_t qh[KS][4], ql[KS][4];
    {
      const bool live0 = r0 + g < p1, live1 = r0 + g + 8 < p1;
      const float* q0 = qb + (int64_t)(live0 ? r0 + g : r0) * p.sq[2];
      const float* q1 = qb + (int64_t)(live1 ? r0 + g + 8 : r0) * p.sq[2];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int c0 = 8 * s + t, c1 = c0 + 4;
        const float x[4] = {live0 && c0 < p.d ? __ldg(q0 + c0) : 0.0f,
                            live1 && c0 < p.d ? __ldg(q1 + c0) : 0.0f,
                            live0 && c1 < p.d ? __ldg(q0 + c1) : 0.0f,
                            live1 && c1 < p.d ? __ldg(q1 + c1) : 0.0f};
#pragma unroll
        for (int e = 0; e < 4; ++e) fr_split(x[e] * p.scale_log2, qh[s][e], ql[s][e]);
      }
    }

    // Rows g (index 0) and g + 8 (index 1): running max, sum, and the
    // output's C fragments (n tile j: columns 8j + 2t, 8j + 2t + 1).
    float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.0f, 0.0f}, acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

    for (int j0 = 0; j0 < lk; j0 += FR_KEYS) {
      // Scores of the chunk: n tile c holds keys j0 + 8c + 2t (+ 1).
      float s[CT][4];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = 0.0f;
        if (j0 + 8 * c >= lk) continue;  // uniform across the warp
        const float* kt = ks + (j0 + 8 * c) * DP;
#pragma unroll
        for (int st = 0; st < KS; ++st)
          fr_mma3(s[c], qh[st], ql[st], kt[koff[st][0]], kt[koff[st][1]]);
      }

      // Online softmax over the chunk, in base 2; s becomes p.
      if (j0 + FR_KEYS > lk) {  // the last chunk: keys past Lk (uniform)
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * c + 2 * t + (e & 1) >= lk) s[c][e] = FA_NEG_INF;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = FA_NEG_INF;
#pragma unroll
        for (int c = 0; c < CT; ++c) tmax = fmaxf(tmax, fmaxf(s[c][2 * r], s[c][2 * r + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(FA_FULL, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(FA_FULL, tmax, 2));
        const float m_new = fmaxf(m[r], tmax);
        const float alpha = fr_exp2(m[r] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[c][2 * r + e];
            x = fr_exp2(x - m_new);  // 0 past Lk: x is NEG_INF there
            sum += x;
          }
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }

      // P·V: A = the score fragment of n tile c in the key order
      // (0, 2, 4, 6, 1, 3, 5, 7); V's rows j0 + 8c + 2t and + 1 (rows past
      // Lk hold zeros, and their p is 0).
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if (j0 + 8 * c >= lk) continue;  // uniform across the warp
        uint32_t ph[4], pl[4];
        fr_split(s[c][0], ph[0], pl[0]);
        fr_split(s[c][2], ph[1], pl[1]);
        fr_split(s[c][1], ph[2], pl[2]);
        fr_split(s[c][3], ph[3], pl[3]);
        const float* vt = vs + (j0 + 8 * c) * DP;
#pragma unroll
        for (int j = 0; j < NT; ++j) fr_mma3(acc[j], ph, pl, vt[voff[j][0]], vt[voff[j][1]]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(FA_FULL, lr, 1);
      lr += __shfl_xor_sync(FA_FULL, lr, 2);
      const int row = r0 + g + 8 * r;
      if (row >= p1) continue;
      if (p.lse != nullptr && t == 0)
        p.lse[(b * p.h + hq) * (int64_t)p.lq + row] = (m[r] + log2f(lr)) * FR_LN2;
      const float denom = fmaxf(lr, 1e-30f);
      float* orow = o + b * p.so[0] + (int64_t)hq * p.so[1] + (int64_t)row * p.so[2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < p.d)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
      }
    }
  }
}

template <int NC>
static int resident_launch_nc(const float* q, const float* k, const float* v, float* o,
                              int64_t b, int64_t hkv, FrParams p, cudaStream_t stream) {
  const size_t smem = fr_smem_bytes(p.lk, NC * 32);
  cudaError_t err = cudaFuncSetAttribute(
      flash_resident_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned chunks = (unsigned)((p.lq + p.q_chunk - 1) / p.q_chunk);
  // B·Hkv in launches of at most FA_MAX_GRID_Y (gridDim.y's limit), on one
  // stream: no host sync between them.
  for (p.bh0 = 0; p.bh0 < b * hkv; p.bh0 += FA_MAX_GRID_Y) {
    const int64_t rows = b * hkv - p.bh0 < FA_MAX_GRID_Y ? b * hkv - p.bh0 : FA_MAX_GRID_Y;
    flash_resident_kernel<NC><<<dim3(chunks, (unsigned)rows), FR_THREADS, smem, stream>>>(
        q, k, v, o, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The resident variant.  a: 19 int64, packed once per input geometry by
// kernel.py: b, h, hkv, lq, lk, d, q_chunk (query positions a block), the
// 12 strides of q, k, v and o (each batch, head, position).  fp32 only;
// the launcher in kernel.py has checked 16-byte aligned bases and strides.
// lse: null, or float32 (B·H, Lq) contiguous for each row's log-sum-exp.
extern "C" int flash_resident_launch(const void* q, const void* k, const void* v, void* o,
                                     const int64_t* a, float scale, void* lse,
                                     void* stream) {
  const int64_t b = a[0], h = a[1], hkv = a[2], lq = a[3], lk = a[4], d = a[5];
  const int64_t q_chunk = a[6];
  if (d < 1 || d > 64 || d % 4 != 0 || hkv < 1 || h % hkv != 0 || lk < 1 || q_chunk < 1 ||
      lq > 2147483647 || fr_smem_bytes(lk, (int)((d + 31) / 32 * 32)) > FR_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (lq <= 0 || b * h <= 0) return 0;
  FrParams p;
  p.h = (int)h;
  p.groups = (int)(h / hkv);
  p.lq = (int)lq;
  p.lk = (int)lk;
  p.d = (int)d;
  p.q_chunk = (int)(q_chunk < lq ? q_chunk : lq);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = a[7 + i];
    p.sk[i] = a[10 + i];
    p.sv[i] = a[13 + i];
    p.so[i] = a[16 + i];
  }
  p.scale_log2 = scale * FR_LOG2E;
  p.lse = (float*)lse;
  p.bh0 = 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float* of = (float*)o;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32) return resident_launch_nc<1>(qf, kf, vf, of, b, hkv, p, s);
  return resident_launch_nc<2>(qf, kf, vf, of, b, hkv, p, s);
}

// ---------------------------------------------------------------------
// The decode (short-Lq) variant: split-K over the keys, one GQA group a
// block, and its combine.
//
// Rows.  The Lq·(H/Hkv) query rows of one (batch, KV head) -- every query
// head of the group at every query position, row r = g·Lq + i -- form one
// block's rows (at most FD_MAX_ROWS), so each K/V row is read from device
// memory once per group.  Grid: (split, batch·KV head), the second axis in
// launches of at most 65,535 (batch, KV head) pairs.  The split's keys
// are [j_begin + split·chunk, + chunk) ∩ [j_begin, j_end), where
// [j_begin, j_end) is the union of the rows' visible keys (the launcher
// chooses chunk and the number of splits, so that several blocks run on
// each SM and no split lies wholly outside the window).
//
// Loads.  Each key row is read by LPK lanes with 16-byte loads (NU per
// lane), so a warp reads 32 / LPK keys at once, KT of those at a time,
// all loads issued before any is used.  The 4 warps take turns over the
// split's tiles.
//
// Arithmetic.  fp32, as the general kernel: scores are fp32 dot products
// times scale (lane partials summed with xor shuffles), masked scores are
// NEG_INF, p = exp(s - m) in fp32 with the running max m of each key slot
// of each warp, and the fp32 (m, l, acc) of those slots are merged in
// shared memory into the split's partial: M = max m, L = Σ e^{m-M} l,
// A = Σ e^{m-M} acc.  The splits of each row are then merged in split
// order (so the result does not depend on the order in which blocks
// finish) into A / max(L, 1e-30) in the output dtype, by one routine
// (fa_merge_splits) that two callers share, so they give the same bits:
//   - Fused (the single-device call): the last block of each (batch, KV
//     head) to finish.  Each block, after writing its partial, counts
//     itself on an int32 counter of its (batch, KV head) (fence, then
//     atomicAdd: the partial is visible before the count); the block that
//     sees n_splits - 1 fences, reads every split's partial through L2
//     (__ldcg: L1 is not coherent across SMs), merges them into o and sets
//     the counter back to 0 for the next launch.  One launch a call, no
//     float atomics.
//   - PartialsOnly, then flash_combine_kernel: the mesh decode, whose
//     shards' partials come from separate launches (models/layers.py
//     merges them across shards).
// A split or slot whose keys are all masked for a row holds m = NEG_INF
// and gets weight e^{NEG_INF - M} = 0 beside the split that holds the
// row's visible keys, exactly as masked keys do in the general kernel.
//
// What bounds it on an H100: bytes.  Each visible K/V row is read once
// per group for Lq·(H/Hkv) rows, about one operation per byte.  The fused
// tail adds a read of the (batch, KV head)'s partials, from L2, by one
// block of n_splits.
// ---------------------------------------------------------------------

#define FD_WARPS 4
#define FD_THREADS (FD_WARPS * 32)
#define FD_MAX_ROWS 8

struct FdParams {
  int h, groups, lq, lk, d, rows;
  int64_t sq[3], sk[3], sv[3];  // strides in elements: batch, head, position
  int causal, has_window;
  int64_t window;
  float scale;
  int64_t j_begin, j_end;
  int chunk, n_splits;
  int64_t bh0;    // the first (batch, KV head) of this launch
  int64_t so[3];  // Fused: the output's strides in elements: batch, head, position
};

enum FdMode { kPartialsOnly = 0, kFused = 1 };

// S splits of the K units u = base + k·step (k < K) of a thread of
// fa_merge_splits from L2: unit u is the V outputs V·u .. V·u + V - 1 (acc
// is [n][rows][d], so they are elements V·u.. of each split); 0 past the
// last unit or past the last split.
template <int K, int S, int V>
__device__ __forceinline__ void fa_merge_load(float (&x)[K][S][V], const float* acc,
                                              int64_t split_stride, int base, int step, int s0,
                                              int n, int units) {
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = base + k * step;
      const bool in = u < units && s0 + j < n;
      const float* at = acc + (s0 + j) * split_stride + (int64_t)V * u;
      if constexpr (V == 4) {
        const float4 q = in ? __ldcg(reinterpret_cast<const float4*>(at))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[k][j][0] = q.x;
        x[k][j][1] = q.y;
        x[k][j][2] = q.z;
        x[k][j][3] = q.w;
      } else {
        x[k][j][0] = in ? __ldcg(at) : 0.0f;
      }
    }
}

// The merge of the n splits of one (batch, KV head) -- ml [n][rows][2]
// (max, sum) and acc [n][rows][d], fp32 -- into o (batch b, KV head hk):
// each row's weights w_s = e^{m_s - M} / max(Σ e^{m_s - M} l_s, 1e-30)
// into w (2·rows·n floats of shared memory: the weights, then each l),
// then the outputs of this thread's units (V consecutive outputs of a
// row; unit u = first + k·step below rows·d / V; V divides d), each
// Σ_s w_s acc_s by fmaf in split order, rounded once to T.  Every thread
// of the block calls it (it holds two __syncthreads).  Partials are read
// with __ldcg: the fused decode reads what other blocks wrote.
//
// The fused decode's last block merges while the rest of the card has
// drained, with one warp on each scheduler, so the merge's time is its
// chain of latencies and instructions (on an H100 a merge one output at a
// time, one load after another, took longer than the combine launch it
// replaces).  So a thread's first K·S·V partials are loaded before the
// weights are formed, with 16-byte loads (V = 4), its K units advance
// together S splits at a time, and each row's weights are one warp's (M
// by shuffles: fmaxf gives the same bits in any order; the sum by one
// lane, by fmaf in split order), with no block-wide barrier between their
// steps.
template <typename T, int K, int S, int V>
__device__ __forceinline__ void fa_merge_splits(const float* ml, const float* acc, float* w,
                                                T* o, const int64_t (&so)[3], int64_t b, int hk,
                                                int groups, int lq, int rows, int d, int n,
                                                int first, int step) {
  const int64_t split_stride = (int64_t)rows * d;
  const int units = rows * d / V;
  float x[K][S][V];
  fa_merge_load<K, S, V>(x, acc, split_stride, first, step, 0, n, units);
  float* ls = w + rows * n;
  const float2* ml2 = reinterpret_cast<const float2*>(ml);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float* wr = w + r * n;
    float* lr = ls + r * n;
    float mx = FA_NEG_INF;
    for (int s = lane; s < n; s += 32) {
      const float2 m_l = __ldcg(ml2 + (int64_t)s * rows + r);
      wr[s] = m_l.x;
      lr[s] = m_l.y;
      mx = fmaxf(mx, m_l.x);
    }
    mx = fa_warp_max(mx);
    for (int s = lane; s < n; s += 32) wr[s] = expf(wr[s] - mx);
    __syncwarp();
    float inv = 0.0f;
    if (lane == 0) {
      float lsum = 0.0f;
      for (int s = 0; s < n; ++s) lsum = fmaf(wr[s], lr[s], lsum);
      inv = 1.0f / fmaxf(lsum, 1e-30f);
    }
    inv = __shfl_sync(FA_FULL, inv, 0);
    for (int s = lane; s < n; s += 32) wr[s] *= inv;
  }
  __syncthreads();
  for (int base = first; base < units; base += K * step) {
    int wrow[K];
    float a[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = base + k * step;
      wrow[k] = u < units ? V * u / d * n : 0;
#pragma unroll
      for (int e = 0; e < V; ++e) a[k][e] = 0.0f;
    }
    for (int s0 = 0; s0 < n; s0 += S) {
      if (base != first || s0 != 0)
        fa_merge_load<K, S, V>(x, acc, split_stride, base, step, s0, n, units);
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (s0 + j < n)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float ws = w[wrow[k] + s0 + j];
#pragma unroll
            for (int e = 0; e < V; ++e) a[k][e] = fmaf(ws, x[k][j][e], a[k][e]);
          }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = base + k * step;
      if (u >= units) continue;
      const int r = V * u / d, c = V * u - r * d;
      const int g = r / lq, i = r - g * lq;
      T* dst = o + b * so[0] + (int64_t)(hk * groups + g) * so[1] + (int64_t)i * so[2] + c;
#pragma unroll
      for (int e = 0; e < V; ++e) fa_store(dst + e, a[k][e]);
    }
  }
}

__device__ __forceinline__ void fd_unpack(const uint4& x, float* f, const float*) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void fd_unpack(const uint4& x, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T, int LPK, int NU, int RR, int KT, FdMode MODE>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    float* __restrict__ part_ml, float* __restrict__ part_acc, T* __restrict__ o,
                    int* __restrict__ count, FdParams p) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte load
  constexpr int KPW = 32 / LPK;        // key slots of a warp
  constexpr int E = NU * VEC;          // elements of a row a lane holds
  extern __shared__ __align__(16) float fd_smem[];  // [slot][row][d + 2]

  const int split = blockIdx.x;
  const int64_t bh = p.bh0 + blockIdx.y;
  const int hkv = p.h / p.groups;
  const int64_t b = bh / hkv;
  const int hk = (int)(bh % hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = lane / LPK, sl = lane % LPK;
  const int64_t s0 = p.j_begin + (int64_t)split * p.chunk;
  const int64_t s1 = min(s0 + p.chunk, p.j_end);

  float qr[RR][E];
  int64_t pos[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const bool live = r < p.rows;
    const int g = live ? r / p.lq : 0, i = live ? r % p.lq : 0;
    pos[r] = (int64_t)i + p.lk - p.lq;
    const T* qrow = q + b * p.sq[0] + (int64_t)(hk * p.groups + g) * p.sq[1] + i * p.sq[2];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = (sl + LPK * u) * VEC;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (live && col < p.d) x = __ldg(reinterpret_cast<const uint4*>(qrow + col));
      fd_unpack(x, &qr[r][u * VEC], (const T*)nullptr);
    }
  }

  float m[RR], l[RR], acc[RR][E];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    m[r] = FA_NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  const T* kb = k + b * p.sk[0] + hk * p.sk[1];
  const T* vb = v + b * p.sv[0] + hk * p.sv[1];
  for (int64_t t = s0 + warp * KPW * KT; t < s1; t += FD_WARPS * KPW * KT) {
    uint4 kx[KT][NU], vx[KT][NU];
    bool ok[KT];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int64_t j = t + kt * KPW + ks;
      ok[kt] = j < s1;
      const int64_t jj = ok[kt] ? j : s0;  // a valid row; its values are not used
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int col = (sl + LPK * u) * VEC;
        const int cc = col < p.d ? col : 0;
        kx[kt][u] = __ldg(reinterpret_cast<const uint4*>(kb + jj * p.sk[2] + cc));
        vx[kt][u] = __ldg(reinterpret_cast<const uint4*>(vb + jj * p.sv[2] + cc));
      }
    }

    // Scores: lane partials over its columns, summed over the key's LPK lanes.
    float s[RR][KT];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float kf[E];
#pragma unroll
      for (int u = 0; u < NU; ++u) fd_unpack(kx[kt][u], &kf[u * VEC], (const T*)nullptr);
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if ((sl + LPK * u) * VEC >= p.d)
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[u * VEC + e] = 0.0f;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        float x = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[r][e], kf[e], x);
        s[r][kt] = x;
      }
    }
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          s[r][kt] += __shfl_xor_sync(FA_FULL, s[r][kt], o);

    // Online softmax of each row over this key slot's KT keys.
    float pr[RR][KT];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      float tmax = FA_NEG_INF;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int64_t j = t + kt * KPW + ks;
        bool vis = ok[kt];
        if (p.causal) vis = vis && j <= pos[r];
        if (p.has_window) vis = vis && j > pos[r] - p.window;
        s[r][kt] = vis ? s[r][kt] * p.scale : FA_NEG_INF;
        tmax = fmaxf(tmax, s[r][kt]);
      }
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        pr[r][kt] = ok[kt] ? expf(s[r][kt] - m_new) : 0.0f;
        sum += pr[r][kt];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float vf[E];
#pragma unroll
      for (int u = 0; u < NU; ++u) fd_unpack(vx[kt][u], &vf[u * VEC], (const T*)nullptr);
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pr[r][kt], vf[e], acc[r][e]);
    }
  }

  // Merge the block's key slots into the split's partial.
  const int width = p.d + 2;
  float* mine = fd_smem + (size_t)(warp * KPW + ks) * p.rows * width;
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    if (r >= p.rows) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = (sl + LPK * u) * VEC;
      if (col < p.d)
#pragma unroll
        for (int e = 0; e < VEC; ++e) mine[r * width + col + e] = acc[r][u * VEC + e];
    }
    if (sl == 0) {
      mine[r * width + p.d] = m[r];
      mine[r * width + p.d + 1] = l[r];
    }
  }
  __syncthreads();
  const int n_slots = FD_WARPS * KPW;
  const int64_t part = bh * p.n_splits + split;
  for (int idx = threadIdx.x; idx < p.rows * p.d; idx += FD_THREADS) {
    const int r = idx / p.d, c = idx % p.d;
    float mx = FA_NEG_INF;
    for (int sidx = 0; sidx < n_slots; ++sidx)
      mx = fmaxf(mx, fd_smem[((size_t)sidx * p.rows + r) * width + p.d]);
    float lsum = 0.0f, a = 0.0f;
    for (int sidx = 0; sidx < n_slots; ++sidx) {
      const float* slot = fd_smem + ((size_t)sidx * p.rows + r) * width;
      const float w = expf(slot[p.d] - mx);
      lsum = fmaf(w, slot[p.d + 1], lsum);
      a = fmaf(w, slot[c], a);
    }
    part_acc[(part * p.rows + r) * p.d + c] = a;
    if (c == 0) {
      part_ml[(part * p.rows + r) * 2] = mx;
      part_ml[(part * p.rows + r) * 2 + 1] = lsum;
    }
  }
  if constexpr (MODE == kFused) {
    // The last of the (batch, KV head)'s n_splits blocks merges them all.
    __shared__ int fd_last;
    __syncthreads();  // the block's partial written, fd_smem free
    if (threadIdx.x == 0) {
      __threadfence();
      fd_last = atomicAdd(count + bh, 1) == p.n_splits - 1;
    }
    __syncthreads();
    if (!fd_last) return;
    __threadfence();
    const int64_t first_part = bh * p.n_splits * p.rows;
    const float* ml = part_ml + first_part * 2;
    const float* acc_bh = part_acc + first_part * p.d;
    // Units of 4 outputs a thread: rows·d / (4·FD_THREADS), at most RR / 2
    // (d <= 256): 1 unit 16 splits, or 2 units 8 splits, at a time (64
    // partials in flight).  acc_bh is 16-byte aligned: the launcher pads
    // the (max, sum) pairs before the accumulators.
    constexpr int K = RR <= 2 ? 1 : 2, S = 16 / K;
    fa_merge_splits<T, K, S, 4>(ml, acc_bh, fd_smem, o, p.so, b, hk, p.groups, p.lq, p.rows,
                                p.d, p.n_splits, threadIdx.x, FD_THREADS);
    if (threadIdx.x == 0) count[bh] = 0;
  }
}

struct FcParams {
  int h, groups, lq, d, rows, n_splits;
  int64_t so[3];  // output strides in elements: batch, head, position
};

// One block per (batch·KV head, 256 outputs): the rows' split weights are
// computed once into shared memory, then each thread sums its output over
// the splits in split order (fa_merge_splits, the fused decode's merge).
template <typename T>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                     T* __restrict__ o, FcParams p) {
  extern __shared__ float fc_w[];  // fa_merge_splits' weights, then each split's sum
  const int bh = blockIdx.x;
  const int hkv = p.h / p.groups;
  const int64_t first_part = (int64_t)bh * p.n_splits * p.rows;
  fa_merge_splits<T, 1, 8, 1>(part_ml + first_part * 2, part_acc + first_part * p.d, fc_w, o,
                              p.so, bh / hkv, bh % hkv, p.groups, p.lq, p.rows, p.d, p.n_splits,
                              blockIdx.y * blockDim.x + threadIdx.x, p.rows * p.d);
}

template <typename T, int LPK, int NU, FdMode MODE>
static int decode_launch_lpk(const void* q, const void* k, const void* v, float* ml, float* acc,
                             void* o, int* count, int64_t b, int64_t hkv,
                             const FdParams& params, cudaStream_t stream) {
  // The key slots' partials; in Fused mode at least the last block's split
  // weights and sums (2 x rows x n_splits floats), which reuse them.
  size_t smem = sizeof(float) * (size_t)FD_WARPS * (32 / LPK) * params.rows * (params.d + 2);
  const size_t weights = 2 * sizeof(float) * (size_t)params.rows * params.n_splits;
  if (MODE == kFused && weights > smem) smem = weights;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // no opt-in: the plan stays below
  // B·Hkv in launches of at most FA_MAX_GRID_Y (gridDim.y's limit), on one
  // stream: no host sync between them.  The counters are indexed by the
  // global (batch, KV head), bh0 + blockIdx.y.
  FdParams p = params;
  for (p.bh0 = 0; p.bh0 < b * hkv; p.bh0 += FA_MAX_GRID_Y) {
    const int64_t rows = b * hkv - p.bh0 < FA_MAX_GRID_Y ? b * hkv - p.bh0 : FA_MAX_GRID_Y;
    const dim3 grid((unsigned)p.n_splits, (unsigned)rows);
    if (p.rows <= 2)
      flash_decode_kernel<T, LPK, NU, 2, 8, MODE><<<grid, FD_THREADS, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, ml, acc, (T*)o, count, p);
    else
      flash_decode_kernel<T, LPK, NU, FD_MAX_ROWS, 4, MODE><<<grid, FD_THREADS, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, ml, acc, (T*)o, count, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, FdMode MODE>
static int decode_launch_t(const void* q, const void* k, const void* v, float* ml, float* acc,
                           void* o, int* count, int64_t b, int64_t hkv, const FdParams& p,
                           cudaStream_t stream) {
  const int nvec = p.d * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  if (nvec <= 4)
    return decode_launch_lpk<T, 4, 1, MODE>(q, k, v, ml, acc, o, count, b, hkv, p, stream);
  if (nvec <= 8)
    return decode_launch_lpk<T, 8, 1, MODE>(q, k, v, ml, acc, o, count, b, hkv, p, stream);
  if (nvec <= 16)
    return decode_launch_lpk<T, 16, 1, MODE>(q, k, v, ml, acc, o, count, b, hkv, p, stream);
  if constexpr (sizeof(T) == 4) {  // fp32 rows above 128 elements: two loads a lane
    if (nvec > 32)
      return decode_launch_lpk<T, 32, 2, MODE>(q, k, v, ml, acc, o, count, b, hkv, p, stream);
  }
  return decode_launch_lpk<T, 32, 1, MODE>(q, k, v, ml, acc, o, count, b, hkv, p, stream);
}

// The decode variant.  a: 26 int64, packed once per input geometry by
// kernel.py (a call converts fewer arguments): b, h, hkv, lq, lk, d, the
// 12 strides of q, k, v and o (each batch, head, position), causal,
// has_window, window, j_begin, j_end, chunk, n_splits, dtype (0 = fp32,
// 1 = bf16).  ml: (B·Hkv, n_splits, rows, 2) and acc: (B·Hkv, n_splits,
// rows, D) fp32 scratch for the partials (acc 16-byte aligned in Fused
// mode).  mode 0 (PartialsOnly): the
// partials are the result (o and count are not read).  mode 1 (Fused): the
// last block of each (batch, KV head) merges them into o (B, H, Lq, D) in
// the input dtype; count: int32, at least B·Hkv of them, all 0 (each last
// block sets its own back to 0).  The launcher in kernel.py has checked
// rows = Lq·(H/Hkv) <= FD_MAX_ROWS, D·itemsize a multiple of 16 bytes,
// 16-byte aligned bases and strides, and chosen [j_begin, j_end), chunk
// and n_splits.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* ml,
                                   void* acc, void* o, void* count, const int64_t* a,
                                   float scale, int mode, void* stream) {
  const int64_t b = a[0], h = a[1], hkv = a[2], lq = a[3], lk = a[4], d = a[5];
  const int64_t* strides = a + 6;
  const int causal = (int)a[18], has_window = (int)a[19];
  const int64_t window = a[20], j_begin = a[21], j_end = a[22], chunk = a[23];
  const int64_t n_splits = a[24];
  const int dtype = (int)a[25];
  const int64_t esize = dtype == 0 ? 4 : 2;
  if (d < 1 || d > 256 || (d * esize) % 16 != 0 || hkv < 1 || h % hkv != 0 ||
      lq * (h / hkv) > FD_MAX_ROWS || chunk < 1 || n_splits < 1 ||
      (dtype != 0 && dtype != 1) || (mode != kPartialsOnly && mode != kFused) ||
      (mode == kFused && (o == nullptr || count == nullptr || (uintptr_t)acc % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (lq <= 0 || b * h <= 0) return 0;
  FdParams p;
  p.h = (int)h;
  p.groups = (int)(h / hkv);
  p.lq = (int)lq;
  p.lk = (int)lk;
  p.d = (int)d;
  p.rows = (int)(lq * p.groups);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  p.j_begin = j_begin;
  p.j_end = j_end;
  p.chunk = (int)chunk;
  p.n_splits = (int)n_splits;
  p.bh0 = 0;
  const cudaStream_t s = (cudaStream_t)stream;
  float *mlf = (float*)ml, *accf = (float*)acc;
  int* cnt = (int*)count;
  if (dtype == 0)
    return mode == kFused
               ? decode_launch_t<float, kFused>(q, k, v, mlf, accf, o, cnt, b, hkv, p, s)
               : decode_launch_t<float, kPartialsOnly>(q, k, v, mlf, accf, o, cnt, b, hkv, p, s);
  return mode == kFused
             ? decode_launch_t<__nv_bfloat16, kFused>(q, k, v, mlf, accf, o, cnt, b, hkv, p, s)
             : decode_launch_t<__nv_bfloat16, kPartialsOnly>(q, k, v, mlf, accf, o, cnt, b, hkv,
                                                             p, s);
}

// The merge of the decode variant's partials into o.  a: 10 int64, b, h,
// hkv, lq, d, n_splits, the 3 strides of o (batch, head, position), dtype
// (0 = fp32, 1 = bf16).
extern "C" int flash_combine_launch(const void* ml, const void* acc, void* o, const int64_t* a,
                                    void* stream) {
  const int64_t b = a[0], h = a[1], hkv = a[2], lq = a[3], d = a[4], n_splits = a[5];
  const int64_t* strides = a + 6;
  const int dtype = (int)a[9];
  if (d < 1 || hkv < 1 || h % hkv != 0 || b * hkv > 2147483647 || n_splits < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (lq <= 0 || b * h <= 0) return 0;
  FcParams p;
  p.h = (int)h;
  p.groups = (int)(h / hkv);
  p.lq = (int)lq;
  p.d = (int)d;
  p.rows = (int)(lq * p.groups);
  p.n_splits = (int)n_splits;
  for (int i = 0; i < 3; ++i) p.so[i] = strides[i];
  const dim3 grid((unsigned)(b * hkv), (unsigned)((p.rows * p.d + 255) / 256));
  const size_t smem = 2 * sizeof(float) * (size_t)p.rows * p.n_splits;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // the decode plan stays far below
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    flash_combine_kernel<float><<<grid, 256, smem, s>>>((const float*)ml, (const float*)acc,
                                                        (float*)o, p);
  else
    flash_combine_kernel<__nv_bfloat16><<<grid, 256, smem, s>>>(
        (const float*)ml, (const float*)acc, (__nv_bfloat16*)o, p);
  return (int)cudaGetLastError();
}
