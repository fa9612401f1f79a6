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
//     clips rows past Lq.
// Each consumer overlaps its softmax of key tile n with its P·V product of
// tile n - 1 on the tensor cores: it issues S_n = Q·K_n^T and
// O += P_{n-1}·V_{n-1} as two wgmma groups, waits for the first, computes
// P_n while the second runs, then rescales O and packs P_n to bf16.
// K and V have rings and barriers of their own, so a K tile is released as
// soon as its scores are computed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SM90_NEG_INF (-1e30f)
#define SM90_ROWS 64            // query rows per consumer warpgroup
#define SM90_BK 64              // keys per K/V tile
#define SM90_CHUNK_BYTES 8192   // one 64-row x 128-byte swizzled chunk
#define SM90_CONSUMERS 2
#define SM90_THREADS ((SM90_CONSUMERS + 1) * 128)
#define SM90_LOG2E 1.4426950408889634f
#define SM90_MAX_GRID_Y 65535   // gridDim.y's limit: its rows go in such chunks

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
};

__device__ __forceinline__ uint32_t sm90_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Waits until the barrier's phase differs from `parity`.  (No timeout: a
// clock check in this loop costs the D = 256 consumers the registers that
// keep their wgmma pipelined.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile whose
// 1024-byte swizzle atoms are 1024-byte aligned (base offset 0).
__device__ __forceinline__ uint64_t sm90_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The value of x, opaque to the compiler: descriptors derived from it are
// computed where they are used instead of being hoisted out of the key
// loop, where 16 or more of them would each hold two registers across it.
__device__ __forceinline__ uint64_t sm90_opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The coordinate of a map's dimension slot s (1..3) for (row, head, batch),
// where slot[0..2] says in which slot L, H and B lie.
__device__ __forceinline__ int sm90_coord(const int* slot, int s, int row, int head, int b) {
  return slot[0] == s ? row : (slot[1] == s ? head : b);
}

// ---- wgmma wrappers (register lists written out: the instruction names
// every accumulator register) ----
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b, 1);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b, 1);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n256(d, a, b, 1);
}

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
    }
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

// ---- host side ----

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library does not link libcuda.
typedef CUresult (*Sm90EncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static Sm90EncodeFn sm90_encode() {
  static Sm90EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<Sm90EncodeFn>(ptr);
  }
  return fn;
}

#define SM90_ENCODE_FAILED 100000  // + the CUresult of a refused tensor map

// A 4-D map (D, then L, H, B ordered by stride) of a bf16 (B, H, L, D) view
// with the given sizes {L, H, B} and strides {L, H, B} in elements; 64 x 64
// boxes (64 columns of D, 64 positions), 128-byte swizzle, zero fill past
// the edges.  slot[i] receives the map dimension (1..3) of L, H, B.
static int sm90_map(CUtensorMap* map, Sm90EncodeFn encode, const void* ptr, int64_t d,
                    const int64_t* size, const int64_t* stride, int* slot) {
  // A dimension of size 1 is never stepped: give it a stride past the
  // tensor's extent, so the order stays by stride.
  int64_t extent = d * 2;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * 2 * size[i] > extent) extent = stride[i] * 2 * size[i];
  extent = (extent + 15) / 16 * 16;
  int64_t bytes[3];
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i) bytes[i] = size[i] > 1 ? stride[i] * 2 : extent;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (bytes[order[j]] < bytes[order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  cuuint64_t gdim[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int r = 0; r < 3; ++r) {
    gdim[1 + r] = (cuuint64_t)size[order[r]];
    gstride[r] = (cuuint64_t)bytes[order[r]];
    if (order[r] == 0) box[1 + r] = 64;
    slot[order[r]] = 1 + r;
  }
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : SM90_ENCODE_FAILED + (int)res;
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
// tensor map.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                           int64_t b, int64_t h, int64_t hkv, int64_t lq,
                                           int64_t lk, int64_t d, const int64_t* strides,
                                           int causal, int has_window, int64_t window,
                                           float scale, void* stream) {
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
