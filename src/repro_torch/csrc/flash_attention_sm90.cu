// flash_attention_sm90: the long-Lq (prefill) variant of the port's
// attention, bf16 on the Hopper tensor cores.
//
// Replaces, with csrc/flash_attention.cu, the Pallas kernel
// `flash_attention_kernel` (body `_kernel`) of
// src/repro/kernels/flash_attention/kernel.py, for bf16 inputs with head
// dim D in {64, 128, 256} whose Lq·(H/Hkv) exceeds the decode variant's
// limit (the launcher in kernels/flash_attention/kernel.py picks it).
// The contract is that of csrc/flash_attention.cu: causal and
// sliding-window masks, queries aligned to the end of the keys
// (off = Lk - Lq), GQA (query head h reads KV head h / (H / Hkv)), an fp32
// online softmax with NEG_INF = -1e30 for masked scores, output in bf16,
// strided (B, H, L, D) views.  One difference in arithmetic: the
// probabilities P are rounded to bf16 for the P·V product (the row sum l
// stays the sum of the fp32 p), which moves an output element by at most
// 2^-8 · Σ_j p_j |v_jd| / l (the bf16 unit roundoff times the plain
// attention of |v|); tests/_torch_parity.py adds that term to this
// variant's limit.
//
// What bounds it on an H100: operations.  A 2048 x 2048 prefill at D = 256
// does 4·D operations per visible (query, key) pair, hundreds per byte
// moved, far above the card's ~295 bf16 operations per byte; the bound is
// the bf16 tensor-core rate (989 TFLOP/s dense).
//
// Design.  A block of three warpgroups (384 threads, one block an SM at
// D = 256): two consumer warpgroups of 64 query rows each and one
// producer warpgroup, of which one thread issues every load.
//   - Rows.  When H/Hkv is even the two consumers take two query heads of
//     one GQA group at the same 64 positions, so each K/V tile serves both
//     heads and both see the same live key range; otherwise they take 128
//     positions of one head.  Blocks of the last positions (the most keys
//     under causality) are scheduled first.
//   - Loads.  TMA copies Q (once) and each 64-key K and V tile into
//     128-byte-swizzled shared memory, in 64-column chunks (a swizzled row
//     holds 128 bytes), through 4-D tensor maps (D, and L, H, B ordered by
//     stride) built on the host from the tensors' real strides, so the
//     model's (B, L, H, D) buffers and the cache's valid prefix go in as
//     they are.  K and V tiles pass through rings of stages with full and
//     empty mbarriers; the ragged key tail comes back zero-filled and is
//     masked.
//   - Registers.  `setmaxnreg` gives the consumers 240 registers a thread
//     and leaves the producer 24: at D = 256 the O accumulator alone is 128
//     fp32 registers a thread.
//   - Products.  S = Q·K^T is wgmma m64n64k16 with both operands in shared
//     memory (K-major); O += P·V is wgmma m64nDk16 with P from registers
//     (the S accumulator's layout is the A fragment's, so P is packed to
//     bf16 in place) and V in shared memory (MN-major, transposed by the
//     instruction).  Accumulation is fp32 in registers.
//   - Masks.  The block walks only the key tiles its rows can see (the
//     first and last visible key of its rows, as the general kernel and
//     the Pallas kernel's `pl.when(live)` do) and masks inside a tile only
//     where the tile crosses the diagonal, the window edge or the end of
//     the keys.
//   - Output.  Each consumer writes its bf16 O tile into its own Q buffer
//     in the swizzled layout and one thread stores it with TMA, which
//     clips rows past Lq.  When the autograd forward asks for it
//     (`lse` not null), each row's log-sum-exp ln 2 · (m + log2 l) goes
//     out too, for the backward (csrc/flash_attention_bwd_sm90.cu); the
//     serving path passes null.
// Each consumer overlaps its softmax of key tile n with its P·V product of
// tile n - 1 on the tensor cores: it issues S_n = Q·K_n^T and
// O += P_{n-1}·V_{n-1} as two wgmma groups, waits for the first, computes
// P_n while the second runs, then rescales O and packs P_n to bf16.
// K and V have rings and barriers of their own, so a K tile is released as
// soon as its scores are computed.  The barrier, TMA and wgmma wrappers
// and the tensor maps live in sm90_common.cuh, shared with the backward.

#include "sm90_common.cuh"

struct Sm90Params {
  int h, groups, lq, lk;
  int pair;            // 1: the consumers take two heads of a group
  int causal, has_window;
  int64_t window;
  float scale_log2;    // scale · log2(e): scores go to exp2
  int slot_q[3];       // map dimension (1..3) of L, H, B in each map
  int slot_k[3];
  int slot_v[3];
  int slot_o[3];
  int64_t bh0;         // the first (batch, head) row of gridDim.y in this launch
  float* lse;          // null, or (B·H, Lq) float32: each row's log-sum-exp
};

template <int D>
struct Sm90Cfg {
  static constexpr int DC = D / 64;                  // 64-column chunks of a row
  static constexpr int STAGES = D == 256 ? 2 : 4;    // K ring and V ring
  static constexpr int NACC = D / 2;                 // O accumulators a thread
  static constexpr int Q_BYTES = SM90_CONSUMERS * DC * SM90_CHUNK_BYTES;
  static constexpr int KV_BYTES = DC * SM90_CHUNK_BYTES;  // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
};

// The online softmax of one 64 x 64 score tile held in the wgmma
// accumulator layout (this thread: rows r and r + 8, 16 columns each), in
// the exp2 domain, in place: scores in, fp32 p out.  Masks only where the
// tile needs them; updates m and l (the sum of the fp32 p) and returns the
// rescale factor of each row.
struct Sm90Rows {
  int pos0;        // key position of this thread's first row
  int wg_lo, wg_hi;  // key positions of the consumer's first and last row
  int col0;        // this thread's first column in each 8-column block
};

__device__ __forceinline__ void sm90_softmax(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int t0, const Sm90Rows& r,
                                             const Sm90Params& p, int window) {
  const bool whole = t0 + SM90_BK - 1 < p.lk && (!p.causal || t0 + SM90_BK - 1 <= r.wg_lo) &&
                     (!p.has_window || t0 > r.wg_hi - window);
  float tmax[2] = {SM90_NEG_INF, SM90_NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * p.scale_log2;
    if (!whole) {
      const int j = t0 + 8 * (i / 4) + r.col0 + (i & 1);
      const int pos = r.pos0 + ((i & 2) ? 8 : 0);
      bool vis = j < p.lk;
      if (p.causal) vis = vis && j <= pos;
      if (p.has_window) vis = vis && j > pos - window;
      if (!vis) x = SM90_NEG_INF;
    }
    sc[i] = x;
    tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], x);
  }
  float rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    tmax[rh] = fmaxf(tmax[rh], __shfl_xor_sync(0xffffffffu, tmax[rh], 1));
    tmax[rh] = fmaxf(tmax[rh], __shfl_xor_sync(0xffffffffu, tmax[rh], 2));
    const float m_new = fmaxf(m[rh], tmax[rh]);
    alpha[rh] = exp2f(m[rh] - m_new);
    m[rh] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int rh = (i >> 1) & 1;
    float pv = exp2f(sc[i] - m[rh]);
    if (!whole && t0 + 8 * (i / 4) + r.col0 + (i & 1) >= p.lk) pv = 0.0f;  // past the keys
    sc[i] = pv;
    rsum[rh] += pv;
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) l[rh] = l[rh] * alpha[rh] + rsum[rh];
}

// P (bf16) as the A fragments of four k16 steps: the S accumulator's
// layout is the A fragment's, so each step packs 8 of this thread's p.
__device__ __forceinline__ void sm90_pack(const float (&sc)[32], uint32_t (&pf)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) pf[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  }
}

// S = Q · K^T of tile it into sc, after its K tile has landed: 16-column
// steps of D (32 bytes along a swizzled row; descriptor addresses step in
// 16-byte units).  Committed as one wgmma group.
template <int D>
__device__ __forceinline__ void sm90_issue_s(float (&sc)[32], uint64_t desc_q, uint64_t desc_k,
                                             uint32_t k_full, int it) {
  using C = Sm90Cfg<D>;
  const int s = it % C::STAGES;
  mbar_wait(k_full + 8 * s, (it / C::STAGES) & 1);
  const uint64_t dq = sm90_opaque(desc_q);
  const uint64_t dk = sm90_opaque(desc_k + ((s * C::KV_BYTES) >> 4));
#pragma unroll
  for (int c = 0; c < C::DC; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t step = (c * SM90_CHUNK_BYTES + kk * 32) >> 4;
      wgmma_ss_n64(sc, dq + step, dk + step, (c | kk) != 0);
    }
  }
  wgmma_commit();
}

// O += P · V of tile it, after its V tile has landed.  V is MN-major (D
// contiguous): 16 keys a step are two 8-row swizzle atoms (SBO 1024
// bytes), D spans the 64-column chunks (LBO one chunk).  One wgmma group.
template <int D>
__device__ __forceinline__ void sm90_issue_pv(float (&o)[D / 2], const uint32_t (&pf)[4][4],
                                              uint64_t desc_v, uint32_t v_full, int it) {
  using C = Sm90Cfg<D>;
  const int s = it % C::STAGES;
  mbar_wait(v_full + 8 * s, (it / C::STAGES) & 1);
  const uint64_t dv = sm90_opaque(desc_v + ((s * C::KV_BYTES) >> 4));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv(o, pf[kk], dv + ((kk * 2048) >> 4));
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_o,
                            const Sm90Params p) {
  using C = Sm90Cfg<D>;
  extern __shared__ uint8_t sm90_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * C::STAGES];
  // Swizzled tiles start on 1024-byte boundaries (the swizzle atom).
  const uint32_t raw = sm90_smem(sm90_raw);
  const uint32_t q_smem = (raw + 1023u) & ~1023u;
  uint8_t* q_ptr = sm90_raw + (q_smem - raw);
  const uint32_t k_smem = q_smem + C::Q_BYTES;            // + stage · KV_BYTES
  const uint32_t v_smem = k_smem + C::STAGES * C::KV_BYTES;
  // Barriers (8 bytes each): Q; then per stage K full, K empty, V full,
  // V empty (K and V are released separately: K once S is computed, V
  // once P·V is).
  const uint32_t bar_q = sm90_smem(&bars[0]);
  const uint32_t k_full = bar_q + 8, k_empty = k_full + 8 * C::STAGES;
  const uint32_t v_full = k_empty + 8 * C::STAGES, v_empty = v_full + 8 * C::STAGES;

  // The block's rows: batch b, KV head hk; consumer w takes query head
  // hq[w] at positions row[w] .. row[w] + 63.
  const int xt = gridDim.x - 1 - blockIdx.x;  // the last positions first
  const int hkv = p.h / p.groups;
  int b, hk, hq0, hq1, row0, row1, rows_hi;
  const int64_t by = p.bh0 + blockIdx.y;  // (batch, KV head) or (batch, head)
  if (p.pair) {
    b = (int)(by / hkv);
    hk = (int)(by % hkv);
    hq0 = hk * p.groups + 2 * blockIdx.z;
    hq1 = hq0 + 1;
    row0 = row1 = xt * SM90_ROWS;
    rows_hi = row0 + SM90_ROWS - 1;
  } else {
    b = (int)(by / p.h);
    hq0 = hq1 = (int)(by % p.h);
    hk = hq0 / p.groups;
    row0 = xt * 2 * SM90_ROWS;
    row1 = row0 + SM90_ROWS;
    rows_hi = row1 + SM90_ROWS - 1;
  }
  // The keys the block's rows can see: [j_begin, j_end), walked in
  // 64-key tiles from tile t_first.  64-bit: a global layer's window is 2^30.
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
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, SM90_CONSUMERS * 128);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, SM90_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == SM90_CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == SM90_CONSUMERS * 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::DC; ++c) {
        tma_load_4d(q_smem + c * SM90_CHUNK_BYTES, &map_q, bar_q, c * 64,
                    sm90_coord(p.slot_q, 1, row0, hq0, b), sm90_coord(p.slot_q, 2, row0, hq0, b),
                    sm90_coord(p.slot_q, 3, row0, hq0, b));
        tma_load_4d(q_smem + (C::DC + c) * SM90_CHUNK_BYTES, &map_q, bar_q, c * 64,
                    sm90_coord(p.slot_q, 1, row1, hq1, b), sm90_coord(p.slot_q, 2, row1, hq1, b),
                    sm90_coord(p.slot_q, 3, row1, hq1, b));
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::STAGES;
        const uint32_t free_parity = ((it / C::STAGES) & 1) ^ 1;
        const int key = (t_first + it) * SM90_BK;
        mbar_wait(k_empty + 8 * s, free_parity);
        mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::DC; ++c)
          tma_load_4d(k_smem + s * C::KV_BYTES + c * SM90_CHUNK_BYTES, &map_k, k_full + 8 * s,
                      c * 64, sm90_coord(p.slot_k, 1, key, hk, b),
                      sm90_coord(p.slot_k, 2, key, hk, b), sm90_coord(p.slot_k, 3, key, hk, b));
        mbar_wait(v_empty + 8 * s, free_parity);
        mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::DC; ++c)
          tma_load_4d(v_smem + s * C::KV_BYTES + c * SM90_CHUNK_BYTES, &map_v, v_full + 8 * s,
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
    const uint32_t my_q = q_smem + wg * C::DC * SM90_CHUNK_BYTES;
    // 32-bit positions: below 2^31, and pos - window stays above -2^31.
    Sm90Rows rows;
    rows.pos0 = rowbase + 16 * warp + lane / 4 + off;
    rows.wg_lo = rowbase + off;
    rows.wg_hi = rows.wg_lo + SM90_ROWS - 1;
    rows.col0 = 2 * (lane % 4);
    const int window = (int)p.window;
    const uint64_t desc_q = sm90_desc(my_q, 16, 1024);
    const uint64_t desc_k = sm90_desc(k_smem, 16, 1024);
    const uint64_t desc_v = sm90_desc(v_smem, SM90_CHUNK_BYTES, 1024);

    float o[C::NACC];
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) o[i] = 0.0f;
    float m[2] = {SM90_NEG_INF, SM90_NEG_INF}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t pf[4][4];

    mbar_wait(bar_q, 0);
    // Registers that a wgmma reads are written only between its groups:
    // each tile's scores go to fresh accumulators, and P is packed and O
    // rescaled once the P·V group in flight has completed.
    if (n_tiles > 0) {
      float sc[32];
      wgmma_fence();
      sm90_issue_s<D>(sc, desc_q, desc_k, k_full, 0);
      wgmma_wait_all();
      mbar_arrive(k_empty);
      sm90_softmax(sc, m, l, alpha, t_first * SM90_BK, rows, p, window);
      sm90_pack(sc, pf);
    }
    // Each step overlaps the softmax of tile it with the P·V product of
    // tile it - 1 on the tensor cores.
    for (int it = 1; it < n_tiles; ++it) {
      float sc[32];
      wgmma_fence();
      sm90_issue_s<D>(sc, desc_q, desc_k, k_full, it);
      sm90_issue_pv<D>(o, pf, desc_v, v_full, it - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile it
      mbar_arrive(k_empty + 8 * (it % C::STAGES));
      sm90_softmax(sc, m, l, alpha, (t_first + it) * SM90_BK, rows, p, window);
      wgmma_wait_all();  // P·V of tile it - 1
      mbar_arrive(v_empty + 8 * ((it - 1) % C::STAGES));
#pragma unroll
      for (int i = 0; i < C::NACC; ++i) o[i] *= alpha[(i >> 1) & 1];
      sm90_pack(sc, pf);
    }
    if (n_tiles > 0) {
      wgmma_fence();
      sm90_issue_pv<D>(o, pf, desc_v, v_full, n_tiles - 1);
      wgmma_wait_all();
      mbar_arrive(v_empty + 8 * ((n_tiles - 1) % C::STAGES));
    }

    // O / l in bf16 into this consumer's Q buffer (swizzled as TMA reads
    // it), then one TMA store of its chunks; rows past Lq are clipped.
    float inv[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float lt = l[rh] + __shfl_xor_sync(0xffffffffu, l[rh], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[rh] = 1.0f / fmaxf(lt, 1e-30f);
      // The backward's log-sum-exp, natural units: ln(2) · (m + log2 l).
      const int row = rowbase + 16 * warp + lane / 4 + 8 * rh;
      if (p.lse != nullptr && lane % 4 == 0 && row < p.lq)
        p.lse[((int64_t)b * p.h + hq) * p.lq + row] = (m[rh] + log2f(lt)) * SM90_LN2;
    }
    __syncwarp();  // converged again before the aligned barrier below
#pragma unroll
    for (int i = 0; i < C::NACC; i += 2) {
      const int rh = (i >> 1) & 1;
      const int row = 16 * warp + lane / 4 + 8 * rh;
      const int col = 8 * (i / 4) + rows.col0;
      const int cc = col % 64;
      const uint32_t at = (col / 64) * SM90_CHUNK_BYTES + row * 128 +
                          ((((cc / 8) ^ (row % 8))) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(q_ptr + (my_q - q_smem) + at) =
          pack_bf16(o[i] * inv[rh], o[i + 1] * inv[rh]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < C::DC; ++c) {
        tma_store_4d(&map_o, my_q + c * SM90_CHUNK_BYTES, c * 64,
                     sm90_coord(p.slot_o, 1, rowbase, hq, b), sm90_coord(p.slot_o, 2, rowbase, hq, b),
                     sm90_coord(p.slot_o, 3, rowbase, hq, b));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D>
static int sm90_launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                       const CUtensorMap& mo, const Sm90Params& params, int64_t b, int64_t lq,
                       cudaStream_t stream) {
  const int smem = Sm90Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t hkv = params.h / params.groups;
  const int64_t ys = params.pair ? b * hkv : b * params.h;
  // gridDim.y in launches of at most SM90_MAX_GRID_Y rows, on one stream:
  // no host sync between them.
  Sm90Params p = params;
  for (p.bh0 = 0; p.bh0 < ys; p.bh0 += SM90_MAX_GRID_Y) {
    const unsigned rows = (unsigned)(ys - p.bh0 < SM90_MAX_GRID_Y ? ys - p.bh0 : SM90_MAX_GRID_Y);
    const dim3 grid = p.pair
        ? dim3((unsigned)((lq + SM90_ROWS - 1) / SM90_ROWS), rows, (unsigned)(p.groups / 2))
        : dim3((unsigned)((lq + 2 * SM90_ROWS - 1) / (2 * SM90_ROWS)), rows, 1u);
    flash_attention_sm90_kernel<D><<<grid, SM90_THREADS, smem, stream>>>(mq, mk, mv, mo, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// bf16 q, k, v, o; strides: 12 int64 (q, k, v, o; each batch, head,
// position, in elements).  d in {64, 128, 256}; the launcher in kernel.py
// has checked that every base and every stride of a dimension longer
// than 1 is a multiple of 16 bytes.  Returns 0 when the kernel launched,
// a CUDA error, or SM90_ENCODE_FAILED + the driver's error for a refused
// tensor map.  `lse` is null, or float32 (B·H, Lq) contiguous: each
// row's log-sum-exp of its visible scaled scores, for the backward.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                           int64_t b, int64_t h, int64_t hkv, int64_t lq,
                                           int64_t lk, int64_t d, const int64_t* strides,
                                           int causal, int has_window, int64_t window,
                                           float scale, void* lse, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (lq <= 0 || b * h <= 0) return 0;
  const Sm90EncodeFn encode = sm90_encode();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  Sm90Params p;
  p.h = (int)h;
  p.groups = (int)(h / hkv);
  p.lq = (int)lq;
  p.lk = (int)lk;
  p.pair = p.groups % 2 == 0;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale_log2 = scale * SM90_LOG2E;
  p.bh0 = 0;
  p.lse = (float*)lse;
  CUtensorMap mq, mk, mv, mo;
  const int64_t size_q[3] = {lq, h, b}, size_k[3] = {lk, hkv, b};
  const int64_t sq[3] = {strides[2], strides[1], strides[0]};
  const int64_t sk[3] = {strides[5], strides[4], strides[3]};
  const int64_t sv[3] = {strides[8], strides[7], strides[6]};
  const int64_t so[3] = {strides[11], strides[10], strides[9]};
  int rc = sm90_map(&mq, encode, q, d, size_q, sq, p.slot_q);
  if (rc == 0) rc = sm90_map(&mk, encode, k, d, size_k, sk, p.slot_k);
  if (rc == 0) rc = sm90_map(&mv, encode, v, d, size_k, sv, p.slot_v);
  if (rc == 0) rc = sm90_map(&mo, encode, o, d, size_q, so, p.slot_o);
  if (rc != 0) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return sm90_launch<64>(mq, mk, mv, mo, p, b, lq, s);
  if (d == 128) return sm90_launch<128>(mq, mk, mv, mo, p, b, lq, s);
  return sm90_launch<256>(mq, mk, mv, mo, p, b, lq, s);
}
