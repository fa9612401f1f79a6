// flash_attention_bwd_resident: the gradient of the port's fp32 attention
// with respect to q, k and v in one kernel, `flash_bwd_resident_kernel`,
// for the calls the resident forward takes (csrc/flash_attention.cu:
// fp32, not causal, no window, D a multiple of 4 up to 64) whose K, V, Q
// and dO of one (batch, KV head) fit in shared memory: BERT4Rec's
// bidirectional encoder (Lq = Lk = 200, D = 32, B·H = 32,768 a train step
// of 16,384 rows).  kernels/flash_attention/kernel.py's `bwd_route` names
// it "resident"; the general backward (csrc/flash_attention_bwd.cu) keeps
// the other fp32 inputs, the sm90 one (csrc/flash_attention_bwd_sm90.cu)
// bf16 at D in {64, 128, 256}.
//
// Replaces no Pallas kernel: the JAX package trains through the jnp
// `attention` (src/repro/models/layers.py:97-141, differentiated by XLA),
// and its Pallas `flash_attention_kernel` has no backward.
//
// Contract: kernels/flash_attention/ref.py::attention_bwd_ref without a
// mask, given the forward's log-sum-exp: q, o, dO (B, H, Lq, D), k, v
// (B, Hkv, Lk, D) fp32, any strides with the last dimension dense and
// every base and stride 16-byte aligned; lse float32 (B·H, Lq) contiguous,
// each row's natural-log log-sum-exp of its scaled scores (the resident
// forward writes it, or the general prep recomputes it).  dq, dk, dv like
// q, k, v; the group's query heads summed into dK and dV.  Every gradient
// element is written once, with no atomics: reruns are bit-identical.
//
// What held the general backward back at BERT4Rec's call (191 ms on an
// H100 against SDPA's 71): its three kernels run on the fp32 CUDA cores
// (67 TFLOP/s), take 8 products of length D a (row, key) pair where 5
// are needed, recompute the log-sum-exp the forward had, and restage the
// K/V (32 keys) and Q/dO (16 rows) tiles of a head from device memory at
// every tile pair (a 200-key head is read 13 times a kernel).
//
// Design.  One block of FRB_WARPS warps a (batch, KV head), B·Hkv on
// gridDim.y in launches of at most 65,535.  The block copies K and V of
// the head and Q and dO of every query head of its group into shared
// memory once (16-byte cp.async; fp32 rows padded with zeros to DP = 32
// ⌈D/32⌉ columns and to a multiple of 16 rows, XOR-swizzled as the
// forward's), so every operand comes from device memory once.  Then:
//   1. while the copies fly, the warps compute delta = rowsum(dO ∘ O) (8
//      lanes a row, O and dO read once with 16-byte loads) and stage each
//      row's lse·log2 e beside it (padding rows get lse 1e30, delta 0, so
//      their P is 0);
//   2. warps over 16-key tiles (the mma's M), K (times scale·log2 e) and V
//      kept as A fragments in registers, looping over the group's heads
//      and 32 query rows at a time: Sᵀ = K·Qᵀ, Pᵀ = exp2(Sᵀ − lse·log2 e),
//      dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − delta), then dV += Pᵀ·dO and
//      dK += dSᵀ·Q with Pᵀ and dSᵀ read from their C fragments as the next
//      product's A fragments (the forward's trick: the k index runs over
//      the 8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7), so they never leave
//      the registers; dK (times scale) and dV are written once;
//   3. warps over 16-row query tiles of every head of the group (in the
//      reverse order, so that the warps' shares of both phases even out:
//      13 + 13 tiles of a 200-row head over 4 warps take 7, 6, 6, 7 tile
//      turns, not 8, 6, 6, 6), Q (times scale·log2 e) and dO as A
//      fragments: S, P, dP and dS again over 32 keys at a time, dQ += dS·K
//      in registers, written once (times scale).  No barrier separates
//      the phases: both only read shared memory.
// Products: TF32 mma.sync.m16n8k8 in the 3xTF32 split
// (resident_common.cuh), the softmax in fp32 with one MUFU ex2 a
// probability.  7 products of length D a (row, key) pair: S and dP twice,
// dV, dK, dQ.
//
// What bounds it on an H100: the operations, 14·D flops a (row, key) pair
// and head, three TF32 products each at 495 TFLOP/s: 7.12 ms at
// BERT4Rec's call of 32,768 rows (the minimal backward's 10·D: 5.09 ms),
// against 4.0 ms for its bytes (q, k, v, o, dO, lse read once; dq, dk, dv
// written once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "resident_common.cuh"

#define FRB_WARPS 4
#define FRB_THREADS (FRB_WARPS * 32)
#define FRB_TILE 16           // keys (phase 2) or query rows (phase 3) a warp's tile
#define FRB_CHUNK 32          // query rows (phase 2) or keys (phase 3) a step: 4 n tiles
#define FRB_PAD_LSE 1e30f     // lse·log2 e of a padding row: its P is exp2(-1e30) = 0
#define FRB_MAX_GRID_Y 65535  // gridDim.y's limit: B·Hkv goes in such chunks
#define FRB_FULL 0xffffffffu

struct FrbParams {
  int h, groups, lq, lk, d;
  // strides in elements (batch, head, position) of q, k, v, o, dO, dq, dk, dv
  int64_t sq[3], sk[3], sv[3], so[3], sg[3], sdq[3], sdk[3], sdv[3];
  float scale, scale_log2;
  const float* lse;  // (B·H, Lq), natural log
  int64_t bh0;       // the first (batch, KV head) of this launch
};

// K and V as [Lk rounded up to 16][dp]; Q and dO as [groups][Lq rounded up
// to 16][dp]; lse·log2 e and delta as [groups][Lq rounded up to 16].
static size_t frb_smem_bytes(int64_t lq, int64_t lk, int dp, int64_t groups) {
  const int64_t lk16 = (lk + 15) / 16 * 16, lq16 = (lq + 15) / 16 * 16;
  return sizeof(float) * (size_t)(2 * lk16 * dp + 2 * groups * lq16 * dp + 2 * groups * lq16);
}

// A fragments (rows g and g + 8, columns 8s + t and 8s + t + 4) of the 16
// rows of a swizzled array starting at `tile` (a multiple of 8 rows), each
// value times `mul`, split into hi and lo.
template <int KS>
__device__ __forceinline__ void frb_a_frags(const float* tile, int (*off)[2], int dp,
                                            float mul, uint32_t (*hi)[4], uint32_t (*lo)[4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const float x[4] = {tile[off[s][0]], tile[8 * dp + off[s][0]], tile[off[s][1]],
                        tile[8 * dp + off[s][1]]};
#pragma unroll
    for (int e = 0; e < 4; ++e) fr_split(x[e] * mul, hi[s][e], lo[s][e]);
  }
}

// The A fragment of a C fragment (rows 16, k = the 8 columns in the order
// 0, 2, 4, 6, 1, 3, 5, 7), split into hi and lo.
__device__ __forceinline__ void frb_c_as_a(const float* c, uint32_t* hi, uint32_t* lo) {
  fr_split(c[0], hi[0], lo[0]);
  fr_split(c[2], hi[1], lo[1]);
  fr_split(c[1], hi[2], lo[2]);
  fr_split(c[3], hi[3], lo[3]);
}

template <int NC>
__global__ void __launch_bounds__(FRB_THREADS)
flash_bwd_resident_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ o,
                          const float* __restrict__ dout, float* __restrict__ dq,
                          float* __restrict__ dk, float* __restrict__ dv, FrbParams p) {
  constexpr int DP = NC * 32;  // D padded to a multiple of 32 with zeros
  constexpr int NCH = DP / 4;  // 16-byte pieces of a padded row
  constexpr int KS = DP / 8;   // k steps of the S and dP products over D
  constexpr int NT = DP / 8;   // n tiles of the dV, dK and dQ products over D
  constexpr int CT = FRB_CHUNK / 8;
  extern __shared__ __align__(16) float frb_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma's group and thread in group
  const int lq = p.lq, lk = p.lk, groups = p.groups;
  const int lk16 = (lk + 15) / 16 * 16, lq16 = (lq + 15) / 16 * 16;
  float* ks = frb_smem;                         // [lk16][DP]
  float* vs = ks + (size_t)lk16 * DP;           // [lk16][DP]
  float* qs = vs + (size_t)lk16 * DP;           // [groups][lq16][DP]
  float* gs = qs + (size_t)groups * lq16 * DP;  // dO, as qs
  float* lse2 = gs + (size_t)groups * lq16 * DP;  // [groups][lq16]
  float* dlt = lse2 + groups * lq16;              // [groups][lq16]

  const int hkv = p.h / groups;
  const int64_t bh = p.bh0 + blockIdx.y;
  const int64_t b = bh / hkv;
  const int hk = (int)(bh % hkv);
  const int dch = p.d / 4;  // pieces of a row that hold data

  // The operands, once, into shared memory (zeros past D and the lengths).
  {
    const float* kb = k + b * p.sk[0] + hk * p.sk[1];
    const float* vb = v + b * p.sv[0] + hk * p.sv[1];
    for (int idx = threadIdx.x; idx < lk16 * NCH; idx += FRB_THREADS) {
      const int r = idx / NCH, c = idx % NCH;
      const bool full = c < dch && r < lk;
      const int off = r * DP + fr_swz(r, c) * 4;
      fr_cp16(ks + off, kb + (full ? r : 0) * p.sk[2] + (full ? c : 0) * 4, full);
      fr_cp16(vs + off, vb + (full ? r : 0) * p.sv[2] + (full ? c : 0) * 4, full);
    }
    for (int idx = threadIdx.x; idx < groups * lq16 * NCH; idx += FRB_THREADS) {
      const int row = idx / NCH, c = idx % NCH;  // row = gi·lq16 + r
      const int gi = row / lq16, r = row % lq16;
      const int hq = hk * groups + gi;
      const bool full = c < dch && r < lq;
      const int off = row * DP + fr_swz(row, c) * 4;
      const int64_t at = (full ? r : 0) * p.sq[2] + (full ? c : 0) * 4;
      const int64_t atg = (full ? r : 0) * p.sg[2] + (full ? c : 0) * 4;
      fr_cp16(qs + off, q + b * p.sq[0] + hq * p.sq[1] + at, full);
      fr_cp16(gs + off, dout + b * p.sg[0] + hq * p.sg[1] + atg, full);
    }
  }

  // Phase 1: delta = rowsum(dO ∘ O) and lse·log2 e of every row of the
  // group's heads, 8 lanes a row, while the copies fly.
  for (int base = warp * 4; base < groups * lq16; base += FRB_WARPS * 4) {
    const int row = base + (lane >> 3);
    const int gi = row / lq16, r = row % lq16;
    const bool live = row < groups * lq16 && r < lq;
    const int hq = hk * groups + gi;
    float sum = 0.0f;
    if (live) {
      const float* orow = o + b * p.so[0] + hq * p.so[1] + (int64_t)r * p.so[2];
      const float* grow = dout + b * p.sg[0] + hq * p.sg[1] + (int64_t)r * p.sg[2];
      for (int c = lane & 7; c < dch; c += 8) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(orow) + c);
        const float4 y = __ldg(reinterpret_cast<const float4*>(grow) + c);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    sum += __shfl_xor_sync(FRB_FULL, sum, 1);
    sum += __shfl_xor_sync(FRB_FULL, sum, 2);
    sum += __shfl_xor_sync(FRB_FULL, sum, 4);
    if ((lane & 7) == 0 && row < groups * lq16) {
      dlt[row] = live ? sum : 0.0f;
      lse2[row] = live ? p.lse[(b * p.h + hq) * (int64_t)lq + r] * FR_LOG2E : FRB_PAD_LSE;
    }
  }

  // The lane's fragment offsets within a tile of 8 rows (every tile starts
  // at a multiple of 8, so its rows' swizzle is fixed by the lane): aoff,
  // row g, columns 8s + t and + 4 (A fragments; the B fragments of S and
  // dP); boff, rows 2t and 2t + 1, column 8j + g (the B fragments of dV,
  // dK and dQ).
  int aoff[KS][2], boff[NT][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) aoff[s][h] = fr_at(g, 8 * s + t + 4 * h, DP);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) boff[j][h] = fr_at(2 * t + h, 8 * j + g, DP);
  fr_cp_wait_all();
  __syncthreads();

  // Phase 2: dK and dV of a 16-key tile a warp.
  for (int kt = warp; kt < lk16 / FRB_TILE; kt += FRB_WARPS) {
    const int j0 = kt * FRB_TILE;
    uint32_t kh[KS][4], kl[KS][4], vh[KS][4], vl[KS][4];
    frb_a_frags<KS>(ks + j0 * DP, aoff, DP, p.scale_log2, kh, kl);
    frb_a_frags<KS>(vs + j0 * DP, aoff, DP, 1.0f, vh, vl);
    float dka[NT][4], dva[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;

    for (int gi = 0; gi < groups; ++gi) {
      const float* qh = qs + (size_t)gi * lq16 * DP;
      const float* gh = gs + (size_t)gi * lq16 * DP;
      const float* l2 = lse2 + gi * lq16;
      const float* dl = dlt + gi * lq16;
      for (int r0 = 0; r0 < lq; r0 += FRB_CHUNK) {
        // Sᵀ and dPᵀ of the chunk: n tile c holds query rows r0 + 8c + 2t
        // (+ 1) of keys j0 + g and j0 + g + 8.
        float s[CT][4], dp[CT][4];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.0f;
          if (r0 + 8 * c >= lq) continue;  // uniform across the warp
          const float* qt = qh + (r0 + 8 * c) * DP;
          const float* gt = gh + (r0 + 8 * c) * DP;
#pragma unroll
          for (int st = 0; st < KS; ++st) {
            fr_mma3(s[c], kh[st], kl[st], qt[aoff[st][0]], qt[aoff[st][1]]);
            fr_mma3(dp[c], vh[st], vl[st], gt[aoff[st][0]], gt[aoff[st][1]]);
          }
        }
        // Pᵀ, then dSᵀ in dp's place.
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (r0 + 8 * c >= lq) continue;
          const float2 lr = *reinterpret_cast<const float2*>(l2 + r0 + 8 * c + 2 * t);
          const float2 dr = *reinterpret_cast<const float2*>(dl + r0 + 8 * c + 2 * t);
          s[c][0] = fr_exp2(s[c][0] - lr.x);
          s[c][1] = fr_exp2(s[c][1] - lr.y);
          s[c][2] = fr_exp2(s[c][2] - lr.x);
          s[c][3] = fr_exp2(s[c][3] - lr.y);
          dp[c][0] = s[c][0] * (dp[c][0] - dr.x);
          dp[c][1] = s[c][1] * (dp[c][1] - dr.y);
          dp[c][2] = s[c][2] * (dp[c][2] - dr.x);
          dp[c][3] = s[c][3] * (dp[c][3] - dr.y);
        }
        // dV += Pᵀ·dO and dK += dSᵀ·Q over the chunk's 8-row k steps.
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (r0 + 8 * c >= lq) continue;
          uint32_t ph[4], pl[4], sh[4], sl[4];
          frb_c_as_a(s[c], ph, pl);
          frb_c_as_a(dp[c], sh, sl);
          const float* qt = qh + (r0 + 8 * c) * DP;
          const float* gt = gh + (r0 + 8 * c) * DP;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            fr_mma3(dva[j], ph, pl, gt[boff[j][0]], gt[boff[j][1]]);
            fr_mma3(dka[j], sh, sl, qt[boff[j][0]], qt[boff[j][1]]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = j0 + g + 8 * r;
      if (key >= lk) continue;
      float* dkrow = dk + b * p.sdk[0] + hk * p.sdk[1] + (int64_t)key * p.sdk[2];
      float* dvrow = dv + b * p.sdv[0] + hk * p.sdv[1] + (int64_t)key * p.sdv[2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= p.d) continue;
        *reinterpret_cast<float2*>(dkrow + col) =
            make_float2(dka[j][2 * r] * p.scale, dka[j][2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(dvrow + col) = make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
      }
    }
  }

  // Phase 3: dQ of a 16-row query tile a warp, over every head of the group.
  // The warps take the tiles in the reverse order of phase 2's, so that a
  // warp that took one key tile more takes one query tile fewer.
  const int q_tiles = lq16 / FRB_TILE;
  for (int tile = FRB_WARPS - 1 - warp; tile < groups * q_tiles; tile += FRB_WARPS) {
    const int gi = tile / q_tiles, i0 = (tile % q_tiles) * FRB_TILE;
    const int hq = hk * groups + gi;
    const int row0 = gi * lq16 + i0;
    uint32_t qh[KS][4], ql[KS][4], gh[KS][4], gl[KS][4];
    frb_a_frags<KS>(qs + row0 * DP, aoff, DP, p.scale_log2, qh, ql);
    frb_a_frags<KS>(gs + row0 * DP, aoff, DP, 1.0f, gh, gl);
    const float lr[2] = {lse2[row0 + g], lse2[row0 + g + 8]};
    const float dr[2] = {dlt[row0 + g], dlt[row0 + g + 8]};
    float dqa[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[j][e] = 0.0f;

    for (int j0 = 0; j0 < lk; j0 += FRB_CHUNK) {
      // S and dP of the chunk: n tile c holds keys j0 + 8c + 2t (+ 1) of
      // rows g and g + 8.
      float s[CT][4], dp[CT][4];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.0f;
        if (j0 + 8 * c >= lk) continue;  // uniform across the warp
        const float* kt = ks + (j0 + 8 * c) * DP;
        const float* vt = vs + (j0 + 8 * c) * DP;
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          fr_mma3(s[c], qh[st], ql[st], kt[aoff[st][0]], kt[aoff[st][1]]);
          fr_mma3(dp[c], gh[st], gl[st], vt[aoff[st][0]], vt[aoff[st][1]]);
        }
      }
      const bool tail = j0 + FRB_CHUNK > lk;  // keys past Lk: P = 0 (uniform)
#pragma unroll
      for (int c = 0; c < CT; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = fr_exp2(s[c][e] - lr[e >> 1]);
          const bool dead = tail && j0 + 8 * c + 2 * t + (e & 1) >= lk;
          s[c][e] = dead ? 0.0f : pe;
          dp[c][e] = s[c][e] * (dp[c][e] - dr[e >> 1]);
        }
      }
      // dQ += dS·K over the chunk's 8-key k steps.
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if (j0 + 8 * c >= lk) continue;
        uint32_t sh[4], sl[4];
        frb_c_as_a(dp[c], sh, sl);
        const float* kt = ks + (j0 + 8 * c) * DP;
#pragma unroll
        for (int j = 0; j < NT; ++j) fr_mma3(dqa[j], sh, sl, kt[boff[j][0]], kt[boff[j][1]]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + g + 8 * r;
      if (row >= lq) continue;
      float* dqrow = dq + b * p.sdq[0] + (int64_t)hq * p.sdq[1] + (int64_t)row * p.sdq[2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < p.d)
          *reinterpret_cast<float2*>(dqrow + col) =
              make_float2(dqa[j][2 * r] * p.scale, dqa[j][2 * r + 1] * p.scale);
      }
    }
  }
}

template <int NC>
static int frb_launch_nc(const float* q, const float* k, const float* v, const float* o,
                         const float* g, float* dq, float* dk, float* dv, int64_t b,
                         int64_t hkv, FrbParams p, cudaStream_t stream) {
  const size_t smem = frb_smem_bytes(p.lq, p.lk, NC * 32, p.groups);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_resident_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // B·Hkv in launches of at most FRB_MAX_GRID_Y (gridDim.y's limit), on one
  // stream: no host sync between them.
  for (p.bh0 = 0; p.bh0 < b * hkv; p.bh0 += FRB_MAX_GRID_Y) {
    const int64_t rows = b * hkv - p.bh0 < FRB_MAX_GRID_Y ? b * hkv - p.bh0 : FRB_MAX_GRID_Y;
    flash_bwd_resident_kernel<NC><<<dim3(1, (unsigned)rows), FRB_THREADS, smem, stream>>>(
        q, k, v, o, g, dq, dk, dv, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The resident backward.  a: 30 int64, packed by kernel.py: b, h, hkv, lq,
// lk, d, then the strides (batch, head, position) of q, k, v, o, dO, dq,
// dk and dv.  fp32 only; kernel.py has checked 16-byte aligned bases and
// strides and lse's shape.  Returns the CUDA error of the launch.
extern "C" int flash_bwd_resident_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* g, const void* lse,
                                         void* dq, void* dk, void* dv, const int64_t* a,
                                         float scale, void* stream) {
  const int64_t b = a[0], h = a[1], hkv = a[2], lq = a[3], lk = a[4], d = a[5];
  if (d < 4 || d > 64 || d % 4 != 0 || hkv < 1 || h % hkv != 0 || lk < 1 ||
      lq > 2147483647 || lk > 2147483647 ||
      frb_smem_bytes(lq, lk, (int)((d + 31) / 32 * 32), h / hkv) > FR_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (lq <= 0 || b * h <= 0) return 0;
  FrbParams p;
  p.h = (int)h;
  p.groups = (int)(h / hkv);
  p.lq = (int)lq;
  p.lk = (int)lk;
  p.d = (int)d;
  int64_t* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sg, p.sdq, p.sdk, p.sdv};
  for (int m = 0; m < 8; ++m)
    for (int i = 0; i < 3; ++i) dst[m][i] = a[6 + 3 * m + i];
  p.scale = scale;
  p.scale_log2 = scale * FR_LOG2E;
  p.lse = (const float*)lse;
  p.bh0 = 0;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *of = (const float*)o, *gf = (const float*)g;
  float *dqf = (float*)dq, *dkf = (float*)dk, *dvf = (float*)dv;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32) return frb_launch_nc<1>(qf, kf, vf, of, gf, dqf, dkf, dvf, b, hkv, p, s);
  return frb_launch_nc<2>(qf, kf, vf, of, gf, dqf, dkf, dvf, b, hkv, p, s);
}
