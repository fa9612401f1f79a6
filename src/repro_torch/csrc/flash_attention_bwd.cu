// flash_attention_bwd: the gradient of the port's attention with respect to
// q, k and v, in three kernels (FlashAttention-2's recompute, no atomics,
// so every launch is deterministic):
//   - flash_bwd_prep_kernel: one block a (batch, head, 16 query rows):
//     each row's log-sum-exp over its visible keys (recomputed from Q and
//     K), and delta = rowsum(dO ∘ O); or delta alone, where the forward
//     saved the log-sum-exp (the sm90 forward does; a pass over bytes);
//   - flash_bwd_dkdv_kernel: one block a (batch, KV head, 32 keys): loops
//     over the group's query heads and their query tiles that see the
//     keys, recomputes P from the log-sum-exp, and accumulates dV = Pᵀ·dO
//     and dK = scale · dSᵀ·Q in registers (dS = P ∘ (dP − delta),
//     dP = dO·Vᵀ); the group's heads are summed there, and each row of dK
//     and dV is written once;
//   - flash_bwd_dq_kernel: one block a (batch, head, 16 query rows): loops
//     over the key tiles its rows see and accumulates dQ = scale · dS·K.
//
// Replaces no Pallas kernel: the JAX package trains through the jnp
// `attention` (src/repro/models/layers.py:97-141, differentiated by XLA),
// and its Pallas `flash_attention_kernel` has no backward.  The port's
// forward is a hand-written kernel (csrc/flash_attention*.cu), so its
// gradient is one too; kernels/flash_attention/ops.py wraps both in a
// torch.autograd.Function.
//
// Contract: the gradient of kernels/flash_attention/ref.py::attention_ref
// under the forward's masks (queries aligned to the end of the keys, row
// i at key position p = i + Lk − Lq; key j visible when (not causal or
// j <= p) and (no window or j > p − window)), GQA with query head h on KV
// head h / (H / Hkv).  Inputs q (B, H, Lq, D), k and v (B, Hkv, Lk, D),
// the forward's output o and its gradient dO (B, H, Lq, D), fp32 or bf16
// (template T), D <= 256, any strides with the last dimension dense.
// Every row must see a key (the launcher refuses inputs where one cannot).
// Arithmetic is fp32 throughout; dQ, dK, dV are written once each, in the
// input type.  The plain version is ref.py::attention_bwd_ref.
//
// Design: the general forward kernel's layout.  Tiles of 32 keys and 16
// query rows, staged in shared memory as fp32 (K and V transposed, rows
// padded to 33 floats against bank conflicts; Q and dO row-major, read as
// float4 broadcasts).  Eight warps; in the score step lane j takes key j
// of the tile and warp w rows 2w and 2w+1, so S = Q·Kᵀ and dP = dO·Vᵀ
// cost one conflict-free shared load of K and V per 2 FMAs each.  In
// dkdv each thread then owns key j and 4·NC of the head's dims, and
// reads P and dS of each row from shared memory; in dq each thread owns
// its 2 rows × NC dims and takes dS of key j by a shuffle.
//
// What bounds it on an H100: operations.  Per visible (row, key) pair it
// does 8 products of length D on the fp32 CUDA cores (S in prep, dkdv
// and dq; dP in dkdv and dq; dV, dK, dQ), against the 5 of the minimal
// backward (the bound chip_smoke.py states: 10·D flops a pair and head
// at the unit's peak).  For bf16 at D in {64, 128, 256} the backward takes
// the tensor-core kernels of csrc/flash_attention_bwd_sm90.cu instead
// (dkdv and dq; prep as here), and these stay the general backward: fp32,
// the other head dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FB_NEG_INF (-1e30f)
#define FB_WARPS 8
#define FB_THREADS (FB_WARPS * 32)
#define FB_RW 2                    // query rows per warp
#define FB_BQ (FB_WARPS * FB_RW)   // query rows per tile
#define FB_BK 32                   // keys per tile: one per lane
#define FB_KT (FB_BK + 1)          // padded row of a transposed K or V tile
#define FB_STAGE 8                 // loads in flight per thread when staging
#define FB_FULL 0xffffffffu
#define FB_MAX_GRID_Y 65535        // gridDim.y's limit: pairs go in such chunks

struct FbDims {
  int64_t b, h, hkv, lq, lk, d;
  int causal, has_window;
  int64_t window;
};

struct FbStrides {  // in elements: batch, head, position (D is dense)
  int64_t q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float fb_float(float x) { return x; }
__device__ __forceinline__ float fb_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void fb_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fb_store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float fb_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FB_FULL, x, o));
  return x;
}

__device__ __forceinline__ float fb_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FB_FULL, x, o);
  return x;
}

__device__ __forceinline__ bool fb_visible(int64_t j, int64_t pos, const FbDims& dm) {
  return j < dm.lk && (!dm.causal || j <= pos) && (!dm.has_window || j > pos - dm.window);
}

// Copy rows row0 .. row0 + ROWS - 1 (those below n_rows) of a (rows, D)
// matrix with row stride `rs` into shared memory as fp32, zero-padded to
// DP columns: row-major [ROWS][DP], or transposed [DP][FB_KT].  Each thread
// issues FB_STAGE unconditional loads before it stores any (a load outside
// the matrix reads its element 0 and is replaced by 0).
template <typename T, int DP, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void fb_stage(float* dst, const T* __restrict__ src, int64_t row0,
                                         int64_t n_rows, int64_t rs, int d) {
  for (int base = threadIdx.x; base < ROWS * DP; base += FB_THREADS * FB_STAGE) {
    T x[FB_STAGE];
    bool ok[FB_STAGE];
#pragma unroll
    for (int u = 0; u < FB_STAGE; ++u) {
      const int idx = base + u * FB_THREADS;
      const int r = idx / DP, c = idx % DP;
      ok[u] = idx < ROWS * DP && row0 + r < n_rows && c < d;
      x[u] = src[ok[u] ? (row0 + r) * rs + c : 0];
    }
#pragma unroll
    for (int u = 0; u < FB_STAGE; ++u) {
      const int idx = base + u * FB_THREADS;
      if (idx < ROWS * DP) {
        const int r = idx / DP, c = idx % DP;
        const float val = ok[u] ? fb_float(x[u]) : 0.0f;
        if (TRANSPOSE)
          dst[c * FB_KT + r] = val;
        else
          dst[r * DP + c] = val;
      }
    }
  }
}

// s[r] += the dot products of rows r0 + r of `rows` (row-major [.][DP])
// with key `lane` of the transposed tile `kt`.
template <int DP>
__device__ __forceinline__ void fb_dots(float s[FB_RW], const float* rows, const float* kt,
                                        int r0, int lane) {
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    const float k0 = kt[(c + 0) * FB_KT + lane];
    const float k1 = kt[(c + 1) * FB_KT + lane];
    const float k2 = kt[(c + 2) * FB_KT + lane];
    const float k3 = kt[(c + 3) * FB_KT + lane];
#pragma unroll
    for (int r = 0; r < FB_RW; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(rows + (r0 + r) * DP + c);
      s[r] = fmaf(a.x, k0, s[r]);
      s[r] = fmaf(a.y, k1, s[r]);
      s[r] = fmaf(a.z, k2, s[r]);
      s[r] = fmaf(a.w, k3, s[r]);
    }
  }
}

// The keys [j_begin, j_end) that rows q0 .. q0 + rows - 1 can see.
__device__ __forceinline__ void fb_key_range(const FbDims& dm, int64_t q0, int64_t rows,
                                             int64_t* j_begin, int64_t* j_end) {
  const int64_t q_lo = q0 + (dm.lk - dm.lq);
  const int64_t q_hi = q_lo + rows - 1;
  *j_begin = 0;
  *j_end = dm.lk;
  if (dm.has_window && q_lo - dm.window + 1 > 0) *j_begin = q_lo - dm.window + 1;
  if (dm.causal && q_hi + 1 < *j_end) *j_end = q_hi + 1;
}

template <typename T, int NC>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ g,
                      float* __restrict__ lse, float* __restrict__ delta, FbDims dm,
                      FbStrides st, float scale, int64_t bh0, int want_lse) {
  constexpr int DP = NC * 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [FB_BQ][DP]
  float* kt = qs + FB_BQ * DP;    // [DP][FB_KT]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t b = bh / dm.h;
  const int64_t hq = bh % dm.h;
  const int64_t hk = hq / (dm.h / dm.hkv);
  const int64_t q0 = (int64_t)blockIdx.x * FB_BQ;
  const int d = (int)dm.d;
  const T* qb = q + b * st.q[0] + hq * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* ob = o + b * st.o[0] + hq * st.o[1];
  const T* gb = g + b * st.g[0] + hq * st.g[1];

  const int r0 = warp * FB_RW;
  int64_t pos[FB_RW];
#pragma unroll
  for (int r = 0; r < FB_RW; ++r) {
    const int64_t row = q0 + r0 + r;
    pos[r] = row + (dm.lk - dm.lq);
    if (row < dm.lq) {  // delta = rowsum(dO ∘ O), lanes over D
      float acc = 0.0f;
      for (int c = lane; c < d; c += 32)
        acc = fmaf(fb_float(gb[row * st.g[2] + c]), fb_float(ob[row * st.o[2] + c]), acc);
      acc = fb_warp_sum(acc);
      if (lane == 0) delta[bh * dm.lq + row] = acc;
    }
  }
  if (!want_lse) return;  // the forward saved it
  fb_stage<T, DP, FB_BQ, false>(qs, qb, q0, dm.lq, st.q[2], d);

  const int64_t rows_here = dm.lq - q0 < FB_BQ ? dm.lq - q0 : FB_BQ;
  int64_t j_begin, j_end;
  fb_key_range(dm, q0, rows_here, &j_begin, &j_end);
  float m[FB_RW], l[FB_RW];
#pragma unroll
  for (int r = 0; r < FB_RW; ++r) {
    m[r] = FB_NEG_INF;
    l[r] = 0.0f;
  }
  for (int64_t t0 = (j_begin / FB_BK) * FB_BK; t0 < j_end; t0 += FB_BK) {
    __syncthreads();  // the previous tile is consumed
    fb_stage<T, DP, FB_BK, true>(kt, kb, t0, dm.lk, st.k[2], d);
    __syncthreads();
    float s[FB_RW] = {0.0f, 0.0f};
    fb_dots<DP>(s, qs, kt, r0, lane);
    const int64_t j = t0 + lane;
#pragma unroll
    for (int r = 0; r < FB_RW; ++r) {
      const bool vis = fb_visible(j, pos[r], dm);
      const float sr = vis ? s[r] * scale : FB_NEG_INF;
      const float m_new = fmaxf(m[r], fb_warp_max(sr));
      const float p = vis ? expf(sr - m_new) : 0.0f;
      l[r] = l[r] * expf(m[r] - m_new) + fb_warp_sum(p);
      m[r] = m_new;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < FB_RW; ++r) {
      const int64_t row = q0 + r0 + r;
      if (row < dm.lq) lse[bh * dm.lq + row] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, FbDims dm, FbStrides st,
                      float scale, int64_t bkv0) {
  constexpr int DP = NC * 32;
  constexpr int DW = 4 * NC;  // dims a warp owns: 8 warps cover DP
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // [DP][FB_KT]
  float* vt = kt + DP * FB_KT;       // [DP][FB_KT]
  float* qs = vt + DP * FB_KT;       // [FB_BQ][DP]
  float* gs = qs + FB_BQ * DP;       // [FB_BQ][DP]
  float* ps = gs + FB_BQ * DP;       // [FB_BQ][FB_KT]
  float* dss = ps + FB_BQ * FB_KT;   // [FB_BQ][FB_KT]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bkv = bkv0 + blockIdx.y;
  const int64_t b = bkv / dm.hkv;
  const int64_t hk = bkv % dm.hkv;
  const int64_t groups = dm.h / dm.hkv;
  const int64_t k0 = (int64_t)blockIdx.x * FB_BK;
  const int d = (int)dm.d;
  const int64_t off = dm.lk - dm.lq;

  fb_stage<T, DP, FB_BK, true>(kt, k + b * st.k[0] + hk * st.k[1], k0, dm.lk, st.k[2], d);
  fb_stage<T, DP, FB_BK, true>(vt, v + b * st.v[0] + hk * st.v[1], k0, dm.lk, st.v[2], d);

  // The query rows that see some key of the tile: [i_lo, i_hi).
  const int64_t k_last = (k0 + FB_BK < dm.lk ? k0 + FB_BK : dm.lk) - 1;
  int64_t i_lo = 0, i_hi = dm.lq;
  if (dm.causal && k0 - off > 0) i_lo = k0 - off;
  if (dm.has_window && k_last - off + dm.window < i_hi) i_hi = k_last - off + dm.window;

  const int r0 = warp * FB_RW;
  const int c0 = warp * DW;
  const int64_t j = k0 + lane;
  float acc_k[DW], acc_v[DW];
#pragma unroll
  for (int c = 0; c < DW; ++c) {
    acc_k[c] = 0.0f;
    acc_v[c] = 0.0f;
  }

  for (int64_t gi = 0; gi < groups; ++gi) {
    const int64_t hq = hk * groups + gi;
    const int64_t bh = b * dm.h + hq;
    const T* qb = q + b * st.q[0] + hq * st.q[1];
    const T* gb = g + b * st.g[0] + hq * st.g[1];
    for (int64_t q0 = (i_lo / FB_BQ) * FB_BQ; q0 < i_hi; q0 += FB_BQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      fb_stage<T, DP, FB_BQ, false>(qs, qb, q0, dm.lq, st.q[2], d);
      fb_stage<T, DP, FB_BQ, false>(gs, gb, q0, dm.lq, st.g[2], d);
      __syncthreads();
      float s[FB_RW] = {0.0f, 0.0f}, dp[FB_RW] = {0.0f, 0.0f};
      fb_dots<DP>(s, qs, kt, r0, lane);
      fb_dots<DP>(dp, gs, vt, r0, lane);
#pragma unroll
      for (int r = 0; r < FB_RW; ++r) {
        const int64_t row = q0 + r0 + r;
        float p = 0.0f, ds = 0.0f;
        if (row < dm.lq && fb_visible(j, row + off, dm)) {
          p = expf(s[r] * scale - lse[bh * dm.lq + row]);
          ds = p * (dp[r] - delta[bh * dm.lq + row]);
        }
        ps[(r0 + r) * FB_KT + lane] = p;
        dss[(r0 + r) * FB_KT + lane] = ds;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < FB_BQ; ++i) {
        const float p = ps[i * FB_KT + lane];
        const float ds = dss[i * FB_KT + lane];
#pragma unroll
        for (int c = 0; c < DW; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(gs + i * DP + c0 + c);
          const float4 bq = *reinterpret_cast<const float4*>(qs + i * DP + c0 + c);
          acc_v[c + 0] = fmaf(p, a.x, acc_v[c + 0]);
          acc_v[c + 1] = fmaf(p, a.y, acc_v[c + 1]);
          acc_v[c + 2] = fmaf(p, a.z, acc_v[c + 2]);
          acc_v[c + 3] = fmaf(p, a.w, acc_v[c + 3]);
          acc_k[c + 0] = fmaf(ds, bq.x, acc_k[c + 0]);
          acc_k[c + 1] = fmaf(ds, bq.y, acc_k[c + 1]);
          acc_k[c + 2] = fmaf(ds, bq.z, acc_k[c + 2]);
          acc_k[c + 3] = fmaf(ds, bq.w, acc_k[c + 3]);
        }
      }
    }
  }

  if (j < dm.lk) {
    T* dkr = dk + b * st.dk[0] + hk * st.dk[1] + j * st.dk[2];
    T* dvr = dv + b * st.dv[0] + hk * st.dv[1] + j * st.dv[2];
#pragma unroll
    for (int c = 0; c < DW; ++c) {
      if (c0 + c < d) {
        fb_store(dkr + c0 + c, acc_k[c] * scale);
        fb_store(dvr + c0 + c, acc_v[c]);
      }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, FbDims dm, FbStrides st, float scale, int64_t bh0) {
  constexpr int DP = NC * 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [FB_BQ][DP]
  float* gs = qs + FB_BQ * DP;      // [FB_BQ][DP]
  float* kt = gs + FB_BQ * DP;      // [DP][FB_KT]
  float* vt = kt + DP * FB_KT;      // [DP][FB_KT]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t b = bh / dm.h;
  const int64_t hq = bh % dm.h;
  const int64_t hk = hq / (dm.h / dm.hkv);
  const int64_t q0 = (int64_t)blockIdx.x * FB_BQ;
  const int d = (int)dm.d;
  const int64_t off = dm.lk - dm.lq;
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  fb_stage<T, DP, FB_BQ, false>(qs, q + b * st.q[0] + hq * st.q[1], q0, dm.lq, st.q[2], d);
  fb_stage<T, DP, FB_BQ, false>(gs, g + b * st.g[0] + hq * st.g[1], q0, dm.lq, st.g[2], d);

  const int r0 = warp * FB_RW;
  float row_lse[FB_RW], row_delta[FB_RW];
  bool live[FB_RW];
#pragma unroll
  for (int r = 0; r < FB_RW; ++r) {
    const int64_t row = q0 + r0 + r;
    live[r] = row < dm.lq;
    row_lse[r] = live[r] ? lse[bh * dm.lq + row] : 0.0f;
    row_delta[r] = live[r] ? delta[bh * dm.lq + row] : 0.0f;
  }
  const int64_t rows_here = dm.lq - q0 < FB_BQ ? dm.lq - q0 : FB_BQ;
  int64_t j_begin, j_end;
  fb_key_range(dm, q0, rows_here, &j_begin, &j_end);

  float acc[FB_RW][NC];
#pragma unroll
  for (int r = 0; r < FB_RW; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;

  for (int64_t t0 = (j_begin / FB_BK) * FB_BK; t0 < j_end; t0 += FB_BK) {
    __syncthreads();  // the previous tile is consumed
    fb_stage<T, DP, FB_BK, true>(kt, kb, t0, dm.lk, st.k[2], d);
    fb_stage<T, DP, FB_BK, true>(vt, vb, t0, dm.lk, st.v[2], d);
    __syncthreads();
    float s[FB_RW] = {0.0f, 0.0f}, dp[FB_RW] = {0.0f, 0.0f};
    fb_dots<DP>(s, qs, kt, r0, lane);
    fb_dots<DP>(dp, gs, vt, r0, lane);
    const int64_t j = t0 + lane;
    float ds[FB_RW];
#pragma unroll
    for (int r = 0; r < FB_RW; ++r) {
      ds[r] = 0.0f;
      if (live[r] && fb_visible(j, q0 + r0 + r + off, dm)) {
        const float p = expf(s[r] * scale - row_lse[r]);
        ds[r] = p * (dp[r] - row_delta[r]);
      }
    }
#pragma unroll 4
    for (int jj = 0; jj < FB_BK; ++jj) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = kt[(lane + 32 * c) * FB_KT + jj];
#pragma unroll
      for (int r = 0; r < FB_RW; ++r) {
        const float dsj = __shfl_sync(FB_FULL, ds[r], jj);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kv[c], acc[r][c]);
      }
    }
  }

  T* dqb = dq + b * st.dq[0] + hq * st.dq[1];
#pragma unroll
  for (int r = 0; r < FB_RW; ++r) {
    if (!live[r]) continue;
    T* row = dqb + (q0 + r0 + r) * st.dq[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) fb_store(row + col, acc[r][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------
// Launchers: one grid dimension over (batch, head) pairs (prep, dq) or
// (batch, KV head) pairs (dkdv), cut into launches of at most
// FB_MAX_GRID_Y on the stream (no host sync between them).

static size_t fb_prep_smem(int dp) { return sizeof(float) * (size_t)(FB_BQ * dp + dp * FB_KT); }
static size_t fb_dkdv_smem(int dp) {
  return sizeof(float) * (size_t)(2 * dp * FB_KT + 2 * FB_BQ * dp + 2 * FB_BQ * FB_KT);
}
static size_t fb_dq_smem(int dp) {
  return sizeof(float) * (size_t)(2 * FB_BQ * dp + 2 * dp * FB_KT);
}

struct FbArgs {
  FbDims dm;
  FbStrides st;
  int dtype;
};

// a: b, h, hkv, lq, lk, d, causal, has_window, window, dtype, then the
// strides (batch, head, position) of q, k, v, o, dO, dQ, dK, dV: 34 int64.
static int fb_parse(const int64_t* a, FbArgs* out) {
  FbDims& dm = out->dm;
  dm.b = a[0];
  dm.h = a[1];
  dm.hkv = a[2];
  dm.lq = a[3];
  dm.lk = a[4];
  dm.d = a[5];
  dm.causal = (int)a[6];
  dm.has_window = (int)a[7];
  dm.window = a[8];
  out->dtype = (int)a[9];
  int64_t* dst[8] = {out->st.q, out->st.k, out->st.v, out->st.o,
                     out->st.g, out->st.dq, out->st.dk, out->st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = a[10 + 3 * t + i];
  if (dm.d < 1 || dm.d > 256 || dm.hkv < 1 || dm.h % dm.hkv != 0) return (int)cudaErrorInvalidValue;
  if (out->dtype != 0 && out->dtype != 1) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int NC>
static int fb_prep_nc(const void* q, const void* k, const void* o, const void* g, float* lse,
                      float* delta, const FbArgs& fa, float scale, int want_lse,
                      cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_prep_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)fb_prep_smem(NC * 32));
  if (err != cudaSuccess) return (int)err;
  const size_t smem = want_lse ? fb_prep_smem(NC * 32) : 0;  // delta alone stages nothing
  const int64_t pairs = fa.dm.b * fa.dm.h;
  for (int64_t p0 = 0; p0 < pairs; p0 += FB_MAX_GRID_Y) {
    const int64_t n = pairs - p0 < FB_MAX_GRID_Y ? pairs - p0 : FB_MAX_GRID_Y;
    const dim3 grid((unsigned)((fa.dm.lq + FB_BQ - 1) / FB_BQ), (unsigned)n);
    flash_bwd_prep_kernel<T, NC><<<grid, FB_THREADS, smem, s>>>(
        (const T*)q, (const T*)k, (const T*)o, (const T*)g, lse, delta, fa.dm, fa.st, scale, p0,
        want_lse);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int NC>
static int fb_dkdv_nc(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, void* dk, void* dv,
                      const FbArgs& fa, float scale, cudaStream_t s) {
  const size_t smem = fb_dkdv_smem(NC * 32);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t pairs = fa.dm.b * fa.dm.hkv;
  for (int64_t p0 = 0; p0 < pairs; p0 += FB_MAX_GRID_Y) {
    const int64_t n = pairs - p0 < FB_MAX_GRID_Y ? pairs - p0 : FB_MAX_GRID_Y;
    const dim3 grid((unsigned)((fa.dm.lk + FB_BK - 1) / FB_BK), (unsigned)n);
    flash_bwd_dkdv_kernel<T, NC><<<grid, FB_THREADS, smem, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, delta, (T*)dk, (T*)dv, fa.dm,
        fa.st, scale, p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int NC>
static int fb_dq_nc(const void* q, const void* k, const void* v, const void* g,
                    const float* lse, const float* delta, void* dq, const FbArgs& fa,
                    float scale, cudaStream_t s) {
  const size_t smem = fb_dq_smem(NC * 32);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t pairs = fa.dm.b * fa.dm.h;
  for (int64_t p0 = 0; p0 < pairs; p0 += FB_MAX_GRID_Y) {
    const int64_t n = pairs - p0 < FB_MAX_GRID_Y ? pairs - p0 : FB_MAX_GRID_Y;
    const dim3 grid((unsigned)((fa.dm.lq + FB_BQ - 1) / FB_BQ), (unsigned)n);
    flash_bwd_dq_kernel<T, NC><<<grid, FB_THREADS, smem, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, delta, (T*)dq, fa.dm, fa.st,
        scale, p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Dispatch on the dtype and on NC = ceil(D / 32) rounded up to 1, 2, 4, 8.
#define FB_DISPATCH(FN, ...)                                              \
  do {                                                                    \
    const int64_t d_ = fa.dm.d;                                           \
    if (fa.dtype == 0) {                                                  \
      if (d_ <= 32) return FN<float, 1>(__VA_ARGS__);                     \
      if (d_ <= 64) return FN<float, 2>(__VA_ARGS__);                     \
      if (d_ <= 128) return FN<float, 4>(__VA_ARGS__);                    \
      return FN<float, 8>(__VA_ARGS__);                                   \
    }                                                                     \
    if (d_ <= 32) return FN<__nv_bfloat16, 1>(__VA_ARGS__);               \
    if (d_ <= 64) return FN<__nv_bfloat16, 2>(__VA_ARGS__);               \
    if (d_ <= 128) return FN<__nv_bfloat16, 4>(__VA_ARGS__);              \
    return FN<__nv_bfloat16, 8>(__VA_ARGS__);                             \
  } while (0);                                                            \
  return (int)cudaErrorInvalidValue

// Each returns the CUDA error of its launches (0 when they ran).  Prep
// writes lse only when want_lse is not 0.
extern "C" int flash_bwd_prep_launch(const void* q, const void* k, const void* o,
                                     const void* g, void* lse, void* delta, const int64_t* a,
                                     float scale, int want_lse, void* stream) {
  FbArgs fa;
  const int bad = fb_parse(a, &fa);
  if (bad) return bad;
  if (fa.dm.lq <= 0 || fa.dm.b * fa.dm.h <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  FB_DISPATCH(fb_prep_nc, q, k, o, g, (float*)lse, (float*)delta, fa, scale, want_lse, s);
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                     const void* g, const void* lse, const void* delta,
                                     void* dk, void* dv, const int64_t* a, float scale,
                                     void* stream) {
  FbArgs fa;
  const int bad = fb_parse(a, &fa);
  if (bad) return bad;
  if (fa.dm.lk <= 0 || fa.dm.b * fa.dm.hkv <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  FB_DISPATCH(fb_dkdv_nc, q, k, v, g, (const float*)lse, (const float*)delta, dk, dv, fa,
              scale, s);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dq,
                                   const int64_t* a, float scale, void* stream) {
  FbArgs fa;
  const int bad = fb_parse(a, &fa);
  if (bad) return bad;
  if (fa.dm.lq <= 0 || fa.dm.b * fa.dm.h <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  FB_DISPATCH(fb_dq_nc, q, k, v, g, (const float*)lse, (const float*)delta, dq, fa, scale, s);
}
