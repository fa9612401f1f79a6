// flash_attention_bwd_sm90: the gradient of the port's bf16 attention with
// respect to q, k and v on the Hopper tensor cores, for head dims D in
// {64, 128, 256} (kernels/flash_attention/kernel.py's `bwd_route` picks
// it; every other input takes the three kernels of
// csrc/flash_attention_bwd.cu, the general backward).  Two kernels:
//   - flash_bwd_dkdv_sm90_kernel: one block a tile of 64 keys of one
//     (batch, KV head); it loops over the group's query heads and over the
//     64-row query tiles that see those keys, and writes each row of dK
//     and dV once;
//   - flash_bwd_dq_sm90_kernel: one block 128 query rows (two heads of a
//     GQA group at the same 64 positions when H/Hkv is even, as the
//     forward does); it loops over the 64-key tiles its rows see and
//     writes each row of dQ once.
// No atomics: every launch is deterministic.  Both read each row's
// log-sum-exp (the sm90 forward's, csrc/flash_attention_sm90.cu, or the
// general prep's where the forward took another variant).  Given the
// forward's log-sum-exp, dq runs first and computes delta = rowsum(dO ∘ O)
// of its rows itself (bwd_row_delta), writing it for dkdv, which runs
// second: two launches a backward.  Without it, the prep kernel
// (csrc/flash_attention_bwd.cu) recomputes the log-sum-exp and writes
// delta beside it, and dkdv and dq read both.
//
// Replaces no Pallas kernel: the JAX package trains through the jnp
// `attention` (src/repro/models/layers.py:97-141, differentiated by XLA),
// and its Pallas `flash_attention_kernel` has no backward.  The port's
// forward is a hand-written kernel, so its gradient is one too.
//
// Contract: that of csrc/flash_attention_bwd.cu (the masks, GQA, strided
// (B, H, L, D) views with the last dimension dense, every row sees a key)
// for bf16 inputs, with every base and every stride of a dimension longer
// than 1 a multiple of 16 bytes (TMA), and lse and delta float32
// (B·H, Lq) contiguous.  Arithmetic: bf16
// products on the tensor cores with fp32 accumulators; P and dS are fp32
// and are rounded to bf16 as the A operand of dV += Pᵀ·dO, dK += dSᵀ·Q
// and dQ += dS·K, which moves a gradient element by at most 2^-8 times the
// same product of absolute values (tests/_torch_parity.py adds that term
// to this route's limit).  dQ, dK, dV are written once each in bf16.
//
// What bounds them on an H100: operations.  Per visible (row, key) pair
// and head, dkdv does 8·D flops (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV, dK) and dq
// 6·D (S, dP, dQ), hundreds per byte at a 4,096-token layer; the bound is
// the bf16 tensor-core rate (989 TFLOP/s dense).  What the design does
// about it: every product is a wgmma with fp32 accumulators in registers;
// TMA feeds the operands through rings of stages with full and empty
// mbarriers from one producer thread, into 128-byte-swizzled shared
// memory, through 4-D tensor maps built from the real strides (q is a
// (B, H, L, D) view of the model's (B, L, H, D) buffer); blocks walk only
// the tiles their rows can see (window, causality) and mask inside a tile
// only where it crosses an edge (the masked and the whole tile are
// separate code: per-element mask arithmetic in the common path cost dkdv
// ~40 %); the blocks with the most work start first (dkdv: the first keys,
// which the most queries see under causality; dq: the last rows).
//
// dkdv design.  Three warpgroups: two consumers and a producer (its first
// warp: lane 0 issues every TMA load).  At D = 256 a 64-key tile's dK and dV
// accumulators are 32,768 fp32 values; one warpgroup holding both would
// need 256 registers a thread for them alone.  So the consumers split the
// work by gradient, not by key: warpgroup 0 computes Sᵀ = K·Qᵀ and
// Pᵀ = exp(Sᵀ·scale − lse) and accumulates dV += Pᵀ·dO; warpgroup 1
// computes dPᵀ = V·dOᵀ, takes Pᵀ from warpgroup 0 through 16 KB of shared
// memory (fp32, each thread reads the elements its peer wrote: the two
// accumulators share one layout), forms dSᵀ = Pᵀ ∘ (dPᵀ − delta) and
// accumulates dK += dSᵀ·Q.  Each holds 128 accumulator registers at
// D = 256 under `setmaxnreg` 240, and both do the same tensor-core work.
// Two named barriers order the exchange (P written, P read).  The stage
// ring carries a query tile's Q and dO (D/64 chunks of 64 rows x 128
// bytes each) and the tile's 64 lse · log2 e and delta values, which the
// producer warp's 32 lanes copy in with plain loads (a TMA box would have
// to start 16-byte aligned, and a row of Lq values need not; loaded by the
// consumers from global memory they cost dkdv a sixth of its time at a
// 4,096-token layer): 2 stages at D = 256 (211 KB of shared memory in
// all), 4 otherwise.  The products: Sᵀ and dPᵀ are m64n64k16 with both
// operands K-major in shared memory;
// dV and dK are m64nDk16 with Pᵀ or dSᵀ from registers (the accumulator's
// layout is the A fragment's) and dO or Q MN-major (transposed by the
// instruction).  At the end warpgroup 0 writes dV into K's buffer and
// warpgroup 1 scale·dK into V's (each the operand only it read), and TMA
// stores them.
//
// dq design.  The forward's structure: two consumer warpgroups of 64 rows
// and a producer; Q and dO of both consumers stay resident; K and V tiles
// pass through rings of their own (K: 2 stages at D = 256, V: 1; 4 each
// otherwise: 225 KB at D = 256).  A consumer issues S = Q·Kᵀ and
// dP = dO·Vᵀ (m64n64k16, K-major) as one group, releases V, forms
// P = exp2(S·scale·log2 e − lse·log2 e) and dS = P ∘ (dP − delta) in fp32,
// rounds dS to bf16 in place as the A fragments and accumulates
// dQ += dS·K with K MN-major; then releases K.  The dQ accumulator (128
// registers at D = 256) is written once, scaled, through its Q buffer by
// TMA.  Asked for delta (given O), each consumer thread first sums
// dO ∘ O over a quarter of the columns of its two rows with 16-byte loads
// from global memory, the 4 lanes of a row reduce with two shuffles and
// one writes the row's delta: before the main loop, while the producer's
// first K and V loads are in flight (the prep kernel's launch, which read
// the same bytes on its own, goes).

#include "sm90_common.cuh"

struct BwdParams {
  int h, groups, lq, lk;
  int pair;            // dq: the consumers take two heads of a group
  int causal, has_window;
  int64_t window;
  float scale;         // 1 / sqrt(D): dK and dQ
  float scale_log2;    // scale · log2(e): scores go to exp2
  int slot_q[3];       // map dimension (1..3) of L, H, B in each map
  int slot_k[3];
  int slot_v[3];
  int slot_g[3];
  int slot_out[3];     // dq's, or dk's (dv's is slot_out2)
  int slot_out2[3];
  const float* lse;    // (B·H, Lq), natural units
  const float* delta;  // (B·H, Lq); dq computing delta: null
  // dq computing delta: O and dO ((B, H, Lq, D) bf16, their strides in
  // elements: batch, head, position) and where each row's delta goes.
  const __nv_bfloat16* o;  // null: delta is read
  const __nv_bfloat16* g;
  int64_t so[3], sg[3];
  float* delta_out;
};

// The key j is visible to the query at position pos (queries aligned to
// the end of the keys).  32-bit: positions below 2^31, pos - window above
// -2^31.
__device__ __forceinline__ bool bwd_visible(int j, int pos, const BwdParams& p, int window) {
  return j < p.lk && (!p.causal || j <= pos) && (!p.has_window || j > pos - window);
}

// delta = rowsum(dO ∘ O) of rows r0 and r0 + 8 of head hq of batch b (a
// dq consumer thread's rows, lane / 4 apart), in fp32: the 4 lanes of a row
// (lane % 4) each sum D/4 columns, its 16-byte chunks lane % 4, + 4, ...,
// with fmaf in column order, then two xor shuffles add the four (each
// lane gets the same bits).  Lane % 4 == 0 writes the row's delta to
// p.delta_out for dkdv.  Rows at or past Lq read row 0 (a valid row) and
// give 0; the loads are unconditional, so the warp stays converged for the
// shuffles.
template <int D>
__device__ __forceinline__ void bwd_row_delta(const BwdParams& p, int b, int hq, int r0, int lane,
                                              float (&dl)[2]) {
  constexpr int CHUNKS = D / 32;  // 16-byte chunks (8 bf16) a lane takes of a row
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = r0 + 8 * rh;
    const bool in = row < p.lq;
    const int64_t at = in ? row : 0;
    const __nv_bfloat16* orow = p.o + b * p.so[0] + hq * p.so[1] + at * p.so[2];
    const __nv_bfloat16* grow = p.g + b * p.sg[0] + hq * p.sg[1] + at * p.sg[2];
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int col = 8 * (4 * u + lane % 4);
      const uint4 ox = __ldg(reinterpret_cast<const uint4*>(orow + col));
      const uint4 gx = __ldg(reinterpret_cast<const uint4*>(grow + col));
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ox);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gx);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
        s = fmaf(gf.x, of.x, s);
        s = fmaf(gf.y, of.y, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dl[rh] = in ? s : 0.0f;
    if (in && lane % 4 == 0) p.delta_out[((int64_t)b * p.h + hq) * p.lq + row] = s;
  }
  __syncwarp();
}

// Write a 64 x D fp32 accumulator (wgmma layout), times `mul`, as bf16 into
// the swizzled tile at `dst` (as TMA reads and writes it).
template <int D>
__device__ __forceinline__ void bwd_stage_out(uint8_t* dst, const float (&acc)[D / 2], float mul,
                                              int warp, int lane) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    const int cc = col % 64;
    const uint32_t at = (col / 64) * SM90_CHUNK_BYTES + row * 128 +
                        (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
    *reinterpret_cast<uint32_t*>(dst + at) = pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
}

// Pᵀ of a dkdv tile in place (rows keys key0 + {0, 8}, columns queries
// q0 + 8·(i/4) + col0 + (i & 1)), from the scores and the columns'
// lse · log2 e, also written to the exchange buffer for warpgroup 1.  MASK
// (a tile that crosses an edge) zeroes what the masks hide; the two
// versions are separate code, so a whole tile runs no mask arithmetic.
template <bool MASK>
__device__ __forceinline__ void bwd_p_tile(float (&sc)[32], const float (&stat)[16], float* p_x,
                                           int tid, int key0, int q0, int col0, int off,
                                           const BwdParams& p, int window) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float pv = exp2f(sc[i] * p.scale_log2 - stat[2 * (i / 4) + (i & 1)]);
    if (MASK) {
      const int qrow = q0 + 8 * (i / 4) + col0 + (i & 1);
      if (qrow >= p.lq || !bwd_visible(key0 + ((i & 2) ? 8 : 0), qrow + off, p, window))
        pv = 0.0f;
    }
    sc[i] = pv;
    p_x[i * 128 + tid] = pv;
  }
}

// dS of a dq tile in place (rows pos0 + {0, 8}, keys t0 + 8·(i/4) + col0 +
// (i & 1)): P = exp2(S·scale·log2 e − lse·log2 e), dS = P ∘ (dP − delta);
// MASK as for bwd_p_tile.
template <bool MASK>
__device__ __forceinline__ void bwd_ds_tile(float (&sc)[32], const float (&dp)[32],
                                            const float (&lse2)[2], const float (&dl)[2], int t0,
                                            int pos0, int col0, const BwdParams& p, int window) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int rh = (i >> 1) & 1;
    float pv = exp2f(sc[i] * p.scale_log2 - lse2[rh]);
    if (MASK && !bwd_visible(t0 + 8 * (i / 4) + col0 + (i & 1), pos0 + 8 * rh, p, window))
      pv = 0.0f;
    sc[i] = pv * (dp[i] - dl[rh]);
  }
}

// acc (32 fp32, an m64n64 accumulator) as bf16 A fragments of four k16 steps.
__device__ __forceinline__ void bwd_pack(const float (&acc)[32], uint32_t (&pf)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) pf[kk][x] = pack_bf16(acc[8 * kk + 2 * x], acc[8 * kk + 2 * x + 1]);
  }
}

// acc = A · Bᵀ over D (m64n64k16 steps, both 64-row tiles K-major and
// swizzled in shared memory).  Not committed.
template <int D>
__device__ __forceinline__ void bwd_issue_ss(float (&acc)[32], uint64_t desc_a, uint64_t desc_b) {
  const uint64_t da = sm90_opaque(desc_a), db = sm90_opaque(desc_b);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t step = (c * SM90_CHUNK_BYTES + kk * 32) >> 4;
      wgmma_ss_n64(acc, da + step, db + step, (c | kk) != 0);
    }
  }
}

// acc += A · B over 64 rows of B (four k16 steps; B MN-major, 16 rows a
// step are two 8-row swizzle atoms, D spans the 64-column chunks).
template <int D>
__device__ __forceinline__ void bwd_issue_rs(float (&acc)[D / 2], const uint32_t (&pf)[4][4],
                                             uint64_t desc_b) {
  const uint64_t db = sm90_opaque(desc_b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv(acc, pf[kk], db + ((kk * 2048) >> 4));
}

// Named barriers and wgmma are aligned instructions: every thread of a
// warp must reach them together, so each first reconverges the warp (a
// masked store or load, an mbarrier wait loop may have split it).
__device__ __forceinline__ void named_sync(int id, int threads) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bwd_fence() {
  __syncwarp();
  wgmma_fence();
}

// Named barriers (0 is __syncthreads): P written, P read, and one for each
// consumer's epilogue.
#define BWD_BAR_P_READY 1
#define BWD_BAR_P_FREE 2
#define BWD_BAR_EPILOGUE 3

// ---------------------------------------------------------------------
// dK and dV.

template <int D>
struct BwdKvCfg {
  static constexpr int TILE = (D / 64) * SM90_CHUNK_BYTES;  // 64 rows of D, bf16
  static constexpr int STAGES = D == 256 ? 2 : 4;
  // Q, dO, then 64 lse · log2 e and 64 delta (padded: tiles stay 1024-aligned).
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr int P_BYTES = 64 * 64 * 4;
  static constexpr int SMEM = 1024 + 2 * TILE + STAGES * STAGE + P_BYTES;
};

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_g,
                           const __grid_constant__ CUtensorMap map_dk,
                           const __grid_constant__ CUtensorMap map_dv, const BwdParams p) {
  using C = BwdKvCfg<D>;
  extern __shared__ uint8_t bwd_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * C::STAGES];
  const uint32_t raw = sm90_smem(bwd_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = bwd_raw + (base - raw);
  const uint32_t k_smem = base, v_smem = base + C::TILE;
  const uint32_t st0 = base + 2 * C::TILE;  // + stage · STAGE: Q, dO, statistics
  float* p_x = reinterpret_cast<float*>(base_ptr + 2 * C::TILE + C::STAGES * C::STAGE);
  // Barriers: K and V; per stage full, then per stage empty.
  const uint32_t bar_kv = sm90_smem(&bars[0]);
  const uint32_t full = bar_kv + 8, empty = full + 8 * C::STAGES;

  // The block's keys k0 .. k0 + 63 of (batch b, KV head hk); tiles of the
  // first keys first (blockIdx.y), every (batch, KV head) in turn.
  const int hkv = p.h / p.groups;
  const int b = (int)(blockIdx.x / hkv), hk = (int)(blockIdx.x % hkv);
  const int k0 = blockIdx.y * SM90_BK;
  const int off = p.lk - p.lq;
  // The query rows that see a key of the tile, [i_lo, i_hi), in 64-row
  // tiles from t_first: per_head tiles for each of the group's heads.
  const int k_last = min(k0 + SM90_BK, p.lk) - 1;
  int64_t i_lo = 0, i_hi = p.lq;
  if (p.causal && k0 - off > 0) i_lo = k0 - off;
  if (p.has_window && (int64_t)k_last - off + p.window < i_hi) i_hi = (int64_t)k_last - off + p.window;
  const int t_first = (int)(i_lo / SM90_ROWS);
  const int per_head = i_hi > i_lo ? (int)((i_hi + SM90_ROWS - 1) / SM90_ROWS) - t_first : 0;
  const int n_tiles = per_head * p.groups;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, SM90_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == SM90_CONSUMERS) {
    // ---- producer: its first warp.  All 32 lanes copy each tile's
    // statistics into the stage; lane 0 issues every TMA load and arrives
    // on the stage's full barrier after them (release: the lanes' stores
    // are visible to the consumers that see the barrier flip). ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < SM90_CONSUMERS * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * C::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_smem + c * SM90_CHUNK_BYTES, &map_k, bar_kv, c * 64,
                      sm90_coord(p.slot_k, 1, k0, hk, b), sm90_coord(p.slot_k, 2, k0, hk, b),
                      sm90_coord(p.slot_k, 3, k0, hk, b));
          tma_load_4d(v_smem + c * SM90_CHUNK_BYTES, &map_v, bar_kv, c * 64,
                      sm90_coord(p.slot_v, 1, k0, hk, b), sm90_coord(p.slot_v, 2, k0, hk, b),
                      sm90_coord(p.slot_v, 3, k0, hk, b));
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::STAGES;
        const int hq = hk * p.groups + it / per_head;
        const int q0 = (t_first + it % per_head) * SM90_ROWS;
        const uint32_t st = st0 + s * C::STAGE;
        mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        // lse · log2 e and delta of the tile's 64 query rows, 0 past Lq.
        float* stat = reinterpret_cast<float*>(base_ptr + (st - base) + 2 * C::TILE);
        const int64_t row0 = ((int64_t)b * p.h + hq) * p.lq + q0;
        for (int r = lane; r < SM90_ROWS; r += 32) {
          const bool in = q0 + r < p.lq;
          stat[r] = in ? p.lse[row0 + r] * SM90_LOG2E : 0.0f;
          stat[SM90_ROWS + r] = in ? p.delta[row0 + r] : 0.0f;
        }
        __syncwarp();
        if (lane != 0) continue;
        mbar_expect_tx(full + 8 * s, 2 * C::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(st + c * SM90_CHUNK_BYTES, &map_q, full + 8 * s, c * 64,
                      sm90_coord(p.slot_q, 1, q0, hq, b), sm90_coord(p.slot_q, 2, q0, hq, b),
                      sm90_coord(p.slot_q, 3, q0, hq, b));
          tma_load_4d(st + C::TILE + c * SM90_CHUNK_BYTES, &map_g, full + 8 * s, c * 64,
                      sm90_coord(p.slot_g, 1, q0, hq, b), sm90_coord(p.slot_g, 2, q0, hq, b),
                      sm90_coord(p.slot_g, 3, q0, hq, b));
        }
      }
    }
  } else {
    // ---- consumer wg: 0 takes P and dV, 1 takes dS and dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
    const int col0 = 2 * (lane % 4);             // its first query column of each 8
    const int window = (int)p.window;
    const uint64_t desc_a = sm90_desc(wg == 0 ? k_smem : v_smem, 16, 1024);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    uint32_t pf[4][4];

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int q0 = (t_first + it % per_head) * SM90_ROWS;
      const uint32_t st = st0 + s * C::STAGE;
      mbar_wait(full + 8 * s, (it / C::STAGES) & 1);
      // Sᵀ = K·Qᵀ (wg 0) or dPᵀ = V·dOᵀ (wg 1).
      float sc[32];
      bwd_fence();
      bwd_issue_ss<D>(sc, desc_a, sm90_desc(st + (wg == 0 ? 0 : C::TILE), 16, 1024));
      wgmma_commit();
      // While it runs: lse · log2 e (wg 0) or delta (wg 1) of this thread's
      // 16 columns (query rows q0 + 8u' + col0 + {0, 1}) from the stage.
      float stat[16];
      {
        const float* src = reinterpret_cast<const float*>(base_ptr + (st - base) + 2 * C::TILE) +
                           (wg == 0 ? 0 : SM90_ROWS);
#pragma unroll
        for (int u = 0; u < 16; ++u) stat[u] = src[8 * (u / 2) + col0 + (u & 1)];
      }
      wgmma_wait_all();
      if (wg == 0) {
        // Pᵀ: rows are keys, columns queries; masked only where the tile
        // crosses the end of the keys or queries, the diagonal or the
        // window's edge.
        const bool whole = k0 + SM90_BK - 1 < p.lk && q0 + SM90_ROWS - 1 < p.lq &&
                           (!p.causal || k0 + SM90_BK - 1 <= q0 + off) &&
                           (!p.has_window || k0 > q0 + SM90_ROWS - 1 + off - window);
        if (it > 0) named_sync(BWD_BAR_P_FREE, 256);  // wg 1 has read the last P
        if (whole)
          bwd_p_tile<false>(sc, stat, p_x, tid, key0, q0, col0, off, p, window);
        else
          bwd_p_tile<true>(sc, stat, p_x, tid, key0, q0, col0, off, p, window);
        named_arrive(BWD_BAR_P_READY, 256);
      } else {
        named_sync(BWD_BAR_P_READY, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = p_x[i * 128 + tid] * (sc[i] - stat[2 * (i / 4) + (i & 1)]);  // dSᵀ; 0 where P is
        }
        if (it + 1 < n_tiles) named_arrive(BWD_BAR_P_FREE, 256);
      }
      bwd_pack(sc, pf);
      // dV += Pᵀ·dO (wg 0) or dK += dSᵀ·Q (wg 1).
      bwd_fence();
      bwd_issue_rs<D>(acc, pf, sm90_desc(st + (wg == 0 ? C::TILE : 0), SM90_CHUNK_BYTES, 1024));
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty + 8 * s);
    }

    // dV into K's buffer (wg 0), scale·dK into V's (wg 1): each is the
    // operand only that warpgroup read.  TMA clips keys past Lk.
    const uint32_t out = wg == 0 ? k_smem : v_smem;
    bwd_stage_out<D>(base_ptr + (out - base), acc, wg == 0 ? 1.0f : p.scale, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(BWD_BAR_EPILOGUE + wg, 128);
    if (tid == 0) {
      const CUtensorMap* map = wg == 0 ? &map_dv : &map_dk;
      const int* slot = wg == 0 ? p.slot_out2 : p.slot_out;
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(map, out + c * SM90_CHUNK_BYTES, c * 64, sm90_coord(slot, 1, k0, hk, b),
                     sm90_coord(slot, 2, k0, hk, b), sm90_coord(slot, 3, k0, hk, b));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------
// dQ.

template <int D>
struct BwdQCfg {
  static constexpr int TILE = (D / 64) * SM90_CHUNK_BYTES;
  static constexpr int K_STAGES = D == 256 ? 2 : 4;
  static constexpr int V_STAGES = D == 256 ? 1 : 4;
  // Q and dO of both consumers, then the K ring and the V ring.
  static constexpr int SMEM = 1024 + 4 * TILE + (K_STAGES + V_STAGES) * TILE;
};

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_dq, const BwdParams p) {
  using C = BwdQCfg<D>;
  extern __shared__ uint8_t bwd_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * (C::K_STAGES + C::V_STAGES)];
  const uint32_t raw = sm90_smem(bwd_raw);
  const uint32_t q_smem = (raw + 1023u) & ~1023u;  // + wg · TILE
  uint8_t* q_ptr = bwd_raw + (q_smem - raw);
  const uint32_t g_smem = q_smem + 2 * C::TILE;      // + wg · TILE
  const uint32_t k_smem = g_smem + 2 * C::TILE;      // + stage · TILE
  const uint32_t v_smem = k_smem + C::K_STAGES * C::TILE;
  // Barriers: Q and dO; K full, K empty per K stage; V full, V empty per V stage.
  const uint32_t bar_q = sm90_smem(&bars[0]);
  const uint32_t k_full = bar_q + 8, k_empty = k_full + 8 * C::K_STAGES;
  const uint32_t v_full = k_empty + 8 * C::K_STAGES, v_empty = v_full + 8 * C::V_STAGES;

  // The block's rows, as the forward takes them: batch b, KV head hk;
  // consumer w takes query head hq[w] at positions row[w] .. row[w] + 63.
  // The last positions (the most keys under causality) first.
  const int yt = gridDim.y - 1 - blockIdx.y;
  const int hkv = p.h / p.groups;
  int b, hk, hq0, hq1, row0, row1, rows_hi;
  if (p.pair) {
    const int pairs = p.groups / 2;
    b = (int)(blockIdx.x / (hkv * pairs));
    const int rem = (int)(blockIdx.x % (hkv * pairs));
    hk = rem / pairs;
    hq0 = hk * p.groups + 2 * (rem % pairs);
    hq1 = hq0 + 1;
    row0 = row1 = yt * SM90_ROWS;
    rows_hi = row0 + SM90_ROWS - 1;
  } else {
    b = (int)(blockIdx.x / p.h);
    hq0 = hq1 = (int)(blockIdx.x % p.h);
    hk = hq0 / p.groups;
    row0 = yt * 2 * SM90_ROWS;
    row1 = row0 + SM90_ROWS;
    rows_hi = row1 + SM90_ROWS - 1;
  }
  const int off = p.lk - p.lq;
  const int64_t pos_lo = (int64_t)row0 + off;
  const int64_t pos_hi = (int64_t)min(rows_hi, p.lq - 1) + off;
  int64_t j_begin = 0, j_end = p.lk;
  if (p.has_window && pos_lo - p.window + 1 > 0) j_begin = pos_lo - p.window + 1;
  if (p.causal && pos_hi + 1 < j_end) j_end = pos_hi + 1;
  const int t_first = (int)(j_begin / SM90_BK);
  const int n_tiles = j_end > j_begin ? (int)((j_end + SM90_BK - 1) / SM90_BK) - t_first : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::K_STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, SM90_CONSUMERS * 128);
    }
    for (int s = 0; s < C::V_STAGES; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, SM90_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == SM90_CONSUMERS) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == SM90_CONSUMERS * 128) {
      mbar_expect_tx(bar_q, 4 * C::TILE);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        const uint32_t at = c * SM90_CHUNK_BYTES;
        tma_load_4d(q_smem + at, &map_q, bar_q, c * 64, sm90_coord(p.slot_q, 1, row0, hq0, b),
                    sm90_coord(p.slot_q, 2, row0, hq0, b), sm90_coord(p.slot_q, 3, row0, hq0, b));
        tma_load_4d(q_smem + C::TILE + at, &map_q, bar_q, c * 64,
                    sm90_coord(p.slot_q, 1, row1, hq1, b), sm90_coord(p.slot_q, 2, row1, hq1, b),
                    sm90_coord(p.slot_q, 3, row1, hq1, b));
        tma_load_4d(g_smem + at, &map_g, bar_q, c * 64, sm90_coord(p.slot_g, 1, row0, hq0, b),
                    sm90_coord(p.slot_g, 2, row0, hq0, b), sm90_coord(p.slot_g, 3, row0, hq0, b));
        tma_load_4d(g_smem + C::TILE + at, &map_g, bar_q, c * 64,
                    sm90_coord(p.slot_g, 1, row1, hq1, b), sm90_coord(p.slot_g, 2, row1, hq1, b),
                    sm90_coord(p.slot_g, 3, row1, hq1, b));
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int key = (t_first + it) * SM90_BK;
        const int sk = it % C::K_STAGES, sv = it % C::V_STAGES;
        mbar_wait(k_empty + 8 * sk, ((it / C::K_STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * sk, C::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(k_smem + sk * C::TILE + c * SM90_CHUNK_BYTES, &map_k, k_full + 8 * sk,
                      c * 64, sm90_coord(p.slot_k, 1, key, hk, b),
                      sm90_coord(p.slot_k, 2, key, hk, b), sm90_coord(p.slot_k, 3, key, hk, b));
        mbar_wait(v_empty + 8 * sv, ((it / C::V_STAGES) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * sv, C::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(v_smem + sv * C::TILE + c * SM90_CHUNK_BYTES, &map_v, v_full + 8 * sv,
                      c * 64, sm90_coord(p.slot_v, 1, key, hk, b),
                      sm90_coord(p.slot_v, 2, key, hk, b), sm90_coord(p.slot_v, 3, key, hk, b));
      }
    }
  } else {
    // ---- consumer warpgroup wg: 64 query rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int hq = wg == 0 ? hq0 : hq1;
    const int rowbase = wg == 0 ? row0 : row1;
    const int window = (int)p.window;
    const int col0 = 2 * (lane % 4);
    const int pos0 = rowbase + 16 * warp + lane / 4 + off;  // this thread's rows: pos0, pos0 + 8
    const int wg_lo = rowbase + off, wg_hi = wg_lo + SM90_ROWS - 1;
    // Each row's lse (in the exp2 domain) and delta, computed here when
    // asked (p.o: while the first K and V tiles load) or read; rows past Lq
    // see nothing.
    float lse2[2], dl[2];
    if (p.o != nullptr) bwd_row_delta<D>(p, b, hq, rowbase + 16 * warp + lane / 4, lane, dl);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = rowbase + 16 * warp + lane / 4 + 8 * rh;
      const int64_t at = ((int64_t)b * p.h + hq) * p.lq + row;
      lse2[rh] = row < p.lq ? p.lse[at] * SM90_LOG2E : 0.0f;
      if (p.o == nullptr) dl[rh] = row < p.lq ? p.delta[at] : 0.0f;
    }
    const uint32_t my_q = q_smem + wg * C::TILE, my_g = g_smem + wg * C::TILE;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    uint32_t pf[4][4];

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int sk = it % C::K_STAGES, sv = it % C::V_STAGES;
      const int t0 = (t_first + it) * SM90_BK;
      const uint32_t k_at = k_smem + sk * C::TILE;
      float sc[32], dp[32];
      mbar_wait(k_full + 8 * sk, (it / C::K_STAGES) & 1);
      mbar_wait(v_full + 8 * sv, (it / C::V_STAGES) & 1);
      bwd_fence();
      bwd_issue_ss<D>(sc, sm90_desc(my_q, 16, 1024), sm90_desc(k_at, 16, 1024));
      bwd_issue_ss<D>(dp, sm90_desc(my_g, 16, 1024), sm90_desc(v_smem + sv * C::TILE, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(v_empty + 8 * sv);
      const bool whole = t0 + SM90_BK - 1 < p.lk && (!p.causal || t0 + SM90_BK - 1 <= wg_lo) &&
                         (!p.has_window || t0 > wg_hi - window);
      if (whole)
        bwd_ds_tile<false>(sc, dp, lse2, dl, t0, pos0, col0, p, window);
      else
        bwd_ds_tile<true>(sc, dp, lse2, dl, t0, pos0, col0, p, window);
      bwd_pack(sc, pf);
      bwd_fence();
      bwd_issue_rs<D>(acc, pf, sm90_desc(k_at, SM90_CHUNK_BYTES, 1024));
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(k_empty + 8 * sk);
    }

    // scale·dQ in bf16 into this consumer's Q buffer, then one TMA store;
    // rows past Lq are clipped.
    bwd_stage_out<D>(q_ptr + (my_q - q_smem), acc, p.scale, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(BWD_BAR_EPILOGUE + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(&map_dq, my_q + c * SM90_CHUNK_BYTES, c * 64,
                     sm90_coord(p.slot_out, 1, rowbase, hq, b),
                     sm90_coord(p.slot_out, 2, rowbase, hq, b),
                     sm90_coord(p.slot_out, 3, rowbase, hq, b));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host side ----

struct BwdArgs {
  int64_t b, h, hkv, lq, lk, d;
  int causal, has_window;
  int64_t window;
  int64_t st[8][3];  // q, k, v, o, dO, dQ, dK, dV: batch, head, position
};

// a: b, h, hkv, lq, lk, d, causal, has_window, window, dtype, then the
// strides (batch, head, position) of q, k, v, o, dO, dQ, dK, dV: 34 int64,
// the general backward's layout (o's strides are read by dq computing
// delta).
static int bwd_parse(const int64_t* a, BwdArgs* out, BwdParams* p) {
  out->b = a[0];
  out->h = a[1];
  out->hkv = a[2];
  out->lq = a[3];
  out->lk = a[4];
  out->d = a[5];
  out->causal = (int)a[6];
  out->has_window = (int)a[7];
  out->window = a[8];
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) out->st[t][i] = a[10 + 3 * t + i];
  if ((out->d != 64 && out->d != 128 && out->d != 256) || a[9] != 1 || out->hkv < 1 ||
      out->h % out->hkv != 0)
    return (int)cudaErrorInvalidValue;
  // 32-bit row indices and grid rows.
  if (out->b * out->h * out->lq >= ((int64_t)1 << 31) || out->lk >= ((int64_t)1 << 31) ||
      (out->lq + SM90_ROWS - 1) / SM90_ROWS > SM90_MAX_GRID_Y ||
      (out->lk + SM90_BK - 1) / SM90_BK > SM90_MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  p->h = (int)out->h;
  p->groups = (int)(out->h / out->hkv);
  p->lq = (int)out->lq;
  p->lk = (int)out->lk;
  p->pair = p->groups % 2 == 0;
  p->causal = out->causal;
  p->has_window = out->has_window;
  p->window = out->window;
  p->scale = 0.0f;
  p->scale_log2 = 0.0f;
  p->lse = nullptr;
  p->delta = nullptr;
  p->o = nullptr;
  p->g = nullptr;
  p->delta_out = nullptr;
  for (int i = 0; i < 3; ++i) {
    p->so[i] = out->st[3][i];
    p->sg[i] = out->st[4][i];
  }
  return 0;
}

// The tensor map of operand t (0 q, 1 k, 2 v, 4 dO, 5 dQ, 6 dK, 7 dV).
static int bwd_map(CUtensorMap* map, Sm90EncodeFn encode, const void* ptr, const BwdArgs& fa,
                   int t, int* slot) {
  const bool keys = t == 1 || t == 2 || t == 6 || t == 7;
  const int64_t size[3] = {keys ? fa.lk : fa.lq, keys ? fa.hkv : fa.h, fa.b};
  const int64_t stride[3] = {fa.st[t][2], fa.st[t][1], fa.st[t][0]};
  return sm90_map(map, encode, ptr, fa.d, size, stride, slot);
}

template <typename Kernel>
static int bwd_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Each returns 0 when its kernel launched, a CUDA error, or
// SM90_ENCODE_FAILED + the driver's error for a refused tensor map.  The
// launcher in kernel.py has checked dtypes, shapes, 16-byte aligned bases
// and strides, and that lse and delta are float32 (B·H, Lq) contiguous.
extern "C" int flash_bwd_dkdv_sm90_launch(const void* q, const void* k, const void* v,
                                          const void* g, const void* lse, const void* delta,
                                          void* dk, void* dv, const int64_t* a, float scale,
                                          void* stream) {
  BwdArgs fa;
  BwdParams p;
  int rc = bwd_parse(a, &fa, &p);
  if (rc) return rc;
  if (fa.lk <= 0 || fa.b * fa.hkv <= 0) return 0;
  const Sm90EncodeFn encode = sm90_encode();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  p.scale = scale;
  p.scale_log2 = scale * SM90_LOG2E;
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  CUtensorMap mq, mk, mv, mg, mdk, mdv;
  rc = bwd_map(&mq, encode, q, fa, 0, p.slot_q);
  if (rc == 0) rc = bwd_map(&mk, encode, k, fa, 1, p.slot_k);
  if (rc == 0) rc = bwd_map(&mv, encode, v, fa, 2, p.slot_v);
  if (rc == 0) rc = bwd_map(&mg, encode, g, fa, 4, p.slot_g);
  if (rc == 0) rc = bwd_map(&mdk, encode, dk, fa, 6, p.slot_out);
  if (rc == 0) rc = bwd_map(&mdv, encode, dv, fa, 7, p.slot_out2);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)(fa.b * fa.hkv), (unsigned)((fa.lk + SM90_BK - 1) / SM90_BK));
  const cudaStream_t s = (cudaStream_t)stream;
#define BWD_KV(DD)                                                                         \
  do {                                                                                     \
    const int smem = BwdKvCfg<DD>::SMEM;                                                   \
    rc = bwd_smem(flash_bwd_dkdv_sm90_kernel<DD>, smem);                                   \
    if (rc) return rc;                                                                     \
    flash_bwd_dkdv_sm90_kernel<DD><<<grid, SM90_THREADS, smem, s>>>(mq, mk, mv, mg, mdk,   \
                                                                    mdv, p);               \
  } while (0)
  if (fa.d == 64)
    BWD_KV(64);
  else if (fa.d == 128)
    BWD_KV(128);
  else
    BWD_KV(256);
#undef BWD_KV
  return (int)cudaGetLastError();
}

// dq: o null reads delta (prep's); o given computes each row's delta from
// O and dO and writes it to delta (float32 (B·H, Lq) contiguous) for dkdv.
extern "C" int flash_bwd_dq_sm90_launch(const void* q, const void* k, const void* v,
                                        const void* o, const void* g, const void* lse,
                                        void* delta, void* dq, const int64_t* a, float scale,
                                        void* stream) {
  BwdArgs fa;
  BwdParams p;
  int rc = bwd_parse(a, &fa, &p);
  if (rc) return rc;
  if (fa.lq <= 0 || fa.b * fa.h <= 0) return 0;
  const Sm90EncodeFn encode = sm90_encode();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  p.scale = scale;
  p.scale_log2 = scale * SM90_LOG2E;
  p.lse = (const float*)lse;
  if (o != nullptr) {
    p.o = (const __nv_bfloat16*)o;
    p.g = (const __nv_bfloat16*)g;
    p.delta_out = (float*)delta;
  } else {
    p.delta = (const float*)delta;
  }
  CUtensorMap mq, mk, mv, mg, mdq;
  rc = bwd_map(&mq, encode, q, fa, 0, p.slot_q);
  if (rc == 0) rc = bwd_map(&mk, encode, k, fa, 1, p.slot_k);
  if (rc == 0) rc = bwd_map(&mv, encode, v, fa, 2, p.slot_v);
  if (rc == 0) rc = bwd_map(&mg, encode, g, fa, 4, p.slot_g);
  if (rc == 0) rc = bwd_map(&mdq, encode, dq, fa, 5, p.slot_out);
  if (rc != 0) return rc;
  const int64_t xs = p.pair ? fa.b * fa.hkv * (p.groups / 2) : fa.b * fa.h;
  const int64_t rows = p.pair ? SM90_ROWS : 2 * SM90_ROWS;
  const dim3 grid((unsigned)xs, (unsigned)((fa.lq + rows - 1) / rows));
  const cudaStream_t s = (cudaStream_t)stream;
#define BWD_Q(DD)                                                                          \
  do {                                                                                     \
    const int smem = BwdQCfg<DD>::SMEM;                                                    \
    rc = bwd_smem(flash_bwd_dq_sm90_kernel<DD>, smem);                                     \
    if (rc) return rc;                                                                     \
    flash_bwd_dq_sm90_kernel<DD><<<grid, SM90_THREADS, smem, s>>>(mq, mk, mv, mg, mdq, p);  \
  } while (0)
  if (fa.d == 64)
    BWD_Q(64);
  else if (fa.d == 128)
    BWD_Q(128);
  else
    BWD_Q(256);
#undef BWD_Q
  return (int)cudaGetLastError();
}
