// segment_aggregate: PNA's four aggregators (mean, max, min, std) and the
// degree over a destination-sorted edge list, forward and backward.
//
// Replaces no Pallas kernel: the JAX package computes the aggregation with
// XLA's segment_sum and segment_max over an explicit edge list
// (src/repro/models/pna.py:73-97, `_aggregate` inside `_pna_layer`).
// Plain PyTorch at ogb_products (61.2 M edges, d = 75) builds about six
// (E, d) float32 tensors of 18.4 GB each a layer, more than the card
// holds; these kernels never hold an (E, d) tensor.
//
// Contract (kernels/segment_aggregate/ref.py): hs, hd (N, d) fp32; the
// edges sorted by destination, src/dst (E,) int32, w (E,) fp32 (the edge
// mask), indptr (N + 1,) int32.  With v = relu(hs[src] + hd[dst]) * w:
// deg = sum w, denom = max(deg, 1), mean = sum v / denom,
// q = sum v^2 / denom - mean^2, std = sqrt(max(q, 0) + 1e-5), max and min
// over the edges with w > 0 (0 where deg == 0).  The forward also writes
// the tie counts of the max and the min (edges with w > 0 whose v equals
// them) and q's sign (2, 1, 0 as q >, ==, < 0) for the backward.
//
// The split by edges.  The in-degree is a power law: at ogb_products node 0
// receives 11.5 M edges and 48 % of the nodes none, so a warp or block per
// node would spend ~0.2 s on node 0 alone.  The run kernels cut the sorted
// edges into runs of `run_edges` (a warp each).  A warp keeps the running
// statistics of the current destination; a destination that begins and
// ends inside the run is finished there.  The first destination of a run,
// when it began in an earlier run, goes to the run's head record; the last
// one, when it continues into the next run (and is not the head), to its
// tail record.  The merge takes every destination that spans runs, once,
// at the first run boundary inside it: its tail record in the run before
// and the head record of each later run it covers, strided over 32 warps
// and combined across warps in a fixed order (like the decode's split-K
// combine).  Sums add; a max and its tie count merge exactly (equal maxima
// add their counts), so the counts are those of the whole destination.  A
// fill kernel writes the outputs of the destinations with no edges.
//
// The ring design (the main path: seg_agg_fwd_ring, seg_agg_bwd_ring, 4
// warps a block).  A warp walks its run once: its lanes hold every
// feature, ceil(d/32) a lane 32 apart (a d past 128 walks the run again
// for each further 128).  The edges' indices come 32 at a time into
// registers (this chunk and the next), and each edge's source row is
// copied by cp.async (4 bytes a lane, at the unpadded stride d) into the
// warp's ring of RING_SLOTS rows in shared memory; the warp reads
// RING_BATCH edges at a time, and after each batch refills the slots the
// batch before used, RING_SLOTS - RING_BATCH rows ahead.  A lane copies and
// reads only its own features, so the ring needs no barrier.  Registers
// hold the float64 running state, not the gathered rows.  At each new
// destination the warp loads hd[dst] (and, backward, the destination's
// coefficients) once; a destination's outputs (its float64 divisions and
// square roots) are formed out of line.  A whole batch into the current
// destination (the common case) runs without a test between its edges;
// the extremes and tie counts update by selects, not branches.  Runs,
// records, the merge and the fill are the register design's, so both
// give the same forward and d hd bits.  Chosen on the card
// (tools/aggregate_ab.py): 8 slots (16 and 4 slower), batches of 2 (1 and
// 4 slower), 5 forward and 4 backward blocks of 4 warps an SM (96
// registers), runs of 1,024 (2,048 and 4,096 slower; 512 slower forward,
// 5 % faster backward).  Taken out again, as no faster: asking L2 for a
// new destination's rows ahead; a merge that took a destination's records
// all features at once, gave the destinations of at most 32 records a warp
// each, or asked L2 for the records first (1.60-1.67 ms against 1.57); a
// fill by nodes (2.48 ms against 1.84).
//
// The register design (the first one, kept as a forced variant off the
// main path: seg_agg_fwd_runs, seg_agg_bwd_runs).  The forward holds one feature a
// lane and walks each run once for every 32 features, a warp gathering 4
// edges' values into registers before using them; the backward holds up
// to 4 features a lane.
//
// The sums (of v, of v^2, and the backward's of d pre into d hd) are kept
// in float64, in registers, records and the merge: in float32 their
// rounding grows with the run and the merge (~1,400 roundings deep at
// node 0), as large as one run's share of node 0's 11.5 M edges, so a
// dropped run would hide in it.  mean, q and std are formed in float64
// from them and rounded to float32 once.  Sums are taken in a fixed order
// set by the shapes: a rerun gives the same bits.  v is formed by the same
// IEEE operations as the plain version's (an add, relu, a multiply; the _rn
// intrinsics keep nvcc from contracting them), so max, min, deg (a sum of
// 0/1 weights) and the tie counts equal the plain version's bit for bit.
//
// Backward: the same runs recompute each edge's v, then
//   dv = g_mean/denom + g_std*c*(v - mean)/(denom*std)
//        + g_max*[v == max]/n_max + g_min*[v == min]/n_min
// (c = 1, 1/2, 0 as q >, ==, < 0: jnp.maximum's gradient; the max and min
// terms only for w > 0 and deg > 0), d pre = dv*w*[pre > 0].  d pre goes
// into d hd[dst] through per-run partial sums and the merge, as in the
// forward (in float64), and into d hs[src] by scalar float atomics (a
// source has few out-edges: 25 on average at ogb_products).  The sources
// are random, so a pass without atomics needs the edges sorted by source
// too (a second sort and a second gather of every row).  Vector reductions
// (red.global.add.v4.f32) need 16-byte aligned rows: a row of d = 75
// floats is 300 bytes, so they would need a padded hs and d hs, and they
// move the same sectors.  d hs's sums therefore change order from run to
// run.
//
// What bounds it on the H100 (3.35 TB/s; ogb_products, d = 75, one layer):
// device-memory bytes.  The forward's function moves 5.16 GB counting each
// input once and each output once (1.54 ms), 6.82 GB with the tie counts
// and q's sign it saves for the backward (2.03 ms); gathered once an edge,
// the 300-byte source rows alone are 18.4 GB, since the 735 MB hs is far
// past the 50 MB L2 (7.02 ms in all).  The backward's function moves
// 9.57 GB (2.86 ms), 27.9 GB with each edge's source row gathered
// (8.34 ms); its d hs scatter is a read-modify-write of a random source
// row an edge in L2, ~2 x 61.2 M x ~336 bytes (sector-rounded) ~ 41 GB,
// ~12 ms more (a floor of the atomics' design, not the function's bound).
// The operations (~10 per edge and feature, 3 of them float64) are well
// below either.  On an NVIDIA H100 80GB HBM3 at 700 W (aggregate_ab): the
// ring forward 16.9 ms (its run kernel 13.5, the fill 1.9, the merge 1.6;
// 14.0 without the gather, 14.8 with the gather and no statistics), the
// register design's 32.1; the ring backward 34.9 ms (17.1 without the d hs
// atomics, 8.8 with the gather alone), the register design's 36.1.  So
// the forward is held by its instruction stream and the fill and merge,
// the backward by the d hs scatter.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define FULL_MASK 0xffffffffu
#define RUN_WARPS 8      // runs (warps) a block of the run kernels
#define MERGE_WARPS 32   // warps a block of the merge kernels
#define BATCH 4          // edges whose rows a warp gathers before using them (register design)
#define RING_WARPS 4     // runs (warps) a block of the ring kernels
#define RING_SLOTS 8     // source rows in a warp's ring (ring design)
#define RING_BATCH 2     // edges a warp of the ring design reads at once: 6 rows in flight
#define RING_FWD_BLOCKS 5  // blocks an SM the forward's ring kernel is held to
#define RING_BWD_BLOCKS 4  // and the backward's

namespace {

constexpr float kEps = 1e-5f;
constexpr float kBig = 1e30f;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

struct Stats {
  double s1, s2;  // float64 sums: their rounding does not grow with the in-degree
  float mx, mn;
  int nmx, nmn;
};

__device__ __forceinline__ void reset(Stats& a) {
  a.s1 = 0.0;
  a.s2 = 0.0;
  a.mx = 0.f;
  a.mn = 0.f;
  a.nmx = 0;
  a.nmn = 0;
}

__device__ __forceinline__ void merge_max(float& m, int& c, float m2, int c2) {
  if (c2 == 0) return;
  if (c == 0 || m2 > m) {
    m = m2;
    c = c2;
  } else if (m2 == m) {
    c += c2;
  }
}

__device__ __forceinline__ void merge_min(float& m, int& c, float m2, int c2) {
  if (c2 == 0) return;
  if (c == 0 || m2 < m) {
    m = m2;
    c = c2;
  } else if (m2 == m) {
    c += c2;
  }
}

__device__ __forceinline__ float message(float x, float y, float w) {
  const float pre = __fadd_rn(x, y);
  return __fmul_rn(pre > 0.f ? pre : 0.f, w);
}

__device__ __forceinline__ void add_edge(Stats& a, float v, float w) {
  const double x = (double)v;
  a.s1 = __dadd_rn(a.s1, x);
  a.s2 = __dadd_rn(a.s2, __dmul_rn(x, x));  // exact: a float's square fits a double
  if (w > 0.f) {
    if (a.nmx == 0 || v > a.mx) {
      a.mx = v;
      a.nmx = 1;
    } else if (v == a.mx) {
      ++a.nmx;
    }
    if (a.nmn == 0 || v < a.mn) {
      a.mn = v;
      a.nmn = 1;
    } else if (v == a.mn) {
      ++a.nmn;
    }
  }
}

struct FwdOut {
  float* mean;
  float* mx;
  float* mn;
  float* std_;
  float* deg;
  int32_t* nmax;
  int32_t* nmin;
  int8_t* vcode;
};

// The node's outputs at feature f from its whole statistics (the plain
// version's formulas, in float64, each output rounded to float32 once).
__device__ __forceinline__ void finish(const FwdOut& o, int64_t node, int d, int f, float deg,
                                       const Stats& a) {
  const double denom = (double)fmaxf(deg, 1.f);
  const double m = __ddiv_rn(a.s1, denom);
  const double q = __dsub_rn(__ddiv_rn(a.s2, denom), __dmul_rn(m, m));
  const double var = q > 0.0 ? q : 0.0;
  const int64_t i = node * d + f;
  const bool has = deg > 0.f;
  o.mean[i] = __double2float_rn(m);
  o.std_[i] = __double2float_rn(__dsqrt_rn(__dadd_rn(var, (double)kEps)));
  o.vcode[i] = (int8_t)(q > 0.0 ? 2 : (q == 0.0 ? 1 : 0));
  o.mx[i] = has ? (a.nmx > 0 ? a.mx : -kBig) : 0.f;
  o.mn[i] = has ? (a.nmn > 0 ? a.mn : kBig) : 0.f;
  o.nmax[i] = has ? a.nmx : 0;
  o.nmin[i] = has ? a.nmn : 0;
  if (f == 0) o.deg[node] = deg;
}

// Record slots: run r's head is slot 2r, its tail 2r + 1.  A forward
// record is 2d doubles (s1, s2 by feature), 2d + 1 floats (max, min by
// feature, then deg) and 2d ints (the max's and the min's tie counts); a
// backward record d doubles.
struct Records {
  double* sums;
  float* ext;
  int32_t* cnt;
};

__device__ __forceinline__ void put_record(const Records& rec, int64_t slot, int d, int f,
                                           bool act, float deg, const Stats& a) {
  double* s = rec.sums + slot * 2 * (int64_t)d;
  float* p = rec.ext + slot * (2 * (int64_t)d + 1);
  int32_t* q = rec.cnt + slot * 2 * (int64_t)d;
  if (act) {
    s[f] = a.s1;
    s[d + f] = a.s2;
    p[f] = a.mx;
    p[d + f] = a.mn;
    q[f] = a.nmx;
    q[d + f] = a.nmn;
  }
  if (f == 0) p[2 * d] = deg;
}

// Held to 3 blocks an SM (80 registers, a few spilled): left free, the
// float64 sums take it to 102 registers and 2 blocks an SM, ~15 % slower at
// ogb_products (measured on the card).
__global__ void __launch_bounds__(RUN_WARPS * WARP, 3)
seg_agg_fwd_runs(const float* __restrict__ hs, const float* __restrict__ hd,
                 const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                 const float* __restrict__ w, int64_t n_edges, int d, int run_edges,
                 int64_t n_runs, Records rec, FwdOut o) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t r = (int64_t)blockIdx.x * RUN_WARPS + (threadIdx.x >> 5);
  if (r >= n_runs) return;  // the whole warp leaves together
  const int64_t lo = r * run_edges;
  const int64_t hi = min64(lo + run_edges, n_edges);
  const int32_t first = dst[lo];
  const int32_t last = dst[hi - 1];
  const bool head_open = lo > 0 && dst[lo - 1] == first;
  const bool tail_open = hi < n_edges && dst[hi] == last;
  for (int f0 = 0; f0 < d; f0 += WARP) {  // a lane holds one feature
    const int f = f0 + lane;
    const bool act = f < d;
    Stats a;
    reset(a);
    int32_t cur = first;
    bool is_first = true;
    float deg = 0.f;
    for (int64_t base = lo; base < hi; base += WARP) {
      const int cnt = (int)min64(WARP, hi - base);
      int32_t s_l = 0, t_l = first;
      float w_l = 0.f;
      if (lane < cnt) {
        s_l = src[base + lane];
        t_l = dst[base + lane];
        w_l = w[base + lane];
      }
      for (int j0 = 0; j0 < cnt; j0 += BATCH) {
        float xs[BATCH], ys[BATCH], ws[BATCH];
        int32_t ts[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int j = (j0 + u) & (WARP - 1);
          const int32_t s = __shfl_sync(FULL_MASK, s_l, j);
          ts[u] = __shfl_sync(FULL_MASK, t_l, j);
          ws[u] = __shfl_sync(FULL_MASK, w_l, j);
          const bool ok = j0 + u < cnt && act;
          xs[u] = ok ? __ldg(hs + (int64_t)s * d + f) : 0.f;
          ys[u] = ok ? __ldg(hd + (int64_t)ts[u] * d + f) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (j0 + u >= cnt) break;  // uniform across the warp
          if (ts[u] != cur) {        // uniform: the destination changes
            if (is_first && head_open) {
              put_record(rec, 2 * r, d, f, act, deg, a);
            } else if (act) {
              finish(o, cur, d, f, deg, a);
            }
            reset(a);
            cur = ts[u];
            is_first = false;
            deg = 0.f;
          }
          deg = __fadd_rn(deg, ws[u]);
          add_edge(a, message(xs[u], ys[u], ws[u]), ws[u]);
        }
      }
    }
    if (is_first && head_open) {
      put_record(rec, 2 * r, d, f, act, deg, a);
    } else if (tail_open) {
      put_record(rec, 2 * r + 1, d, f, act, deg, a);
    } else if (act) {
      finish(o, cur, d, f, deg, a);
    }
  }
}

// The destination that spans run boundary b (between runs b - 1 and b),
// when b is the first boundary inside it; else -1.  Sets the range of
// record slots to merge: the tail of run b - 1, then the heads of runs b
// to the last run the destination covers.
__device__ __forceinline__ int32_t spanning(const int32_t* __restrict__ dst,
                                            const int32_t* __restrict__ indptr, int64_t b,
                                            int run_edges, int64_t& n_rec) {
  const int64_t e = b * run_edges;
  const int32_t x = dst[e];
  if (dst[e - 1] != x) return -1;
  if ((int64_t)indptr[x] < (b - 1) * run_edges) return -1;  // an earlier boundary has it
  const int64_t r_last = ((int64_t)indptr[x + 1] - 1) / run_edges;
  n_rec = r_last - b + 2;
  return x;
}

__device__ __forceinline__ int64_t record_slot(int64_t b, int64_t k) {
  return k == 0 ? 2 * (b - 1) + 1 : 2 * (b - 1 + k);
}

__global__ void __launch_bounds__(MERGE_WARPS * WARP)
seg_agg_fwd_merge(const int32_t* __restrict__ dst, const int32_t* __restrict__ indptr, int d,
                  int run_edges, Records rec, FwdOut o) {
  const int64_t b = (int64_t)blockIdx.x + 1;
  int64_t n_rec = 0;
  const int32_t x = spanning(dst, indptr, b, run_edges, n_rec);
  if (x < 0) return;  // uniform across the block
  __shared__ double sh_s[MERGE_WARPS][2][WARP];
  __shared__ float sh_f[MERGE_WARPS][2][WARP];
  __shared__ int32_t sh_i[MERGE_WARPS][2][WARP];
  __shared__ float sh_deg[MERGE_WARPS];
  const int lane = threadIdx.x & (WARP - 1);
  const int wid = threadIdx.x >> 5;
  for (int f0 = 0; f0 < d; f0 += WARP) {
    const int f = f0 + lane;
    const bool act = f < d;
    Stats a;
    reset(a);
    float deg = 0.f;
    for (int64_t k = wid; k < n_rec; k += MERGE_WARPS) {
      const int64_t slot = record_slot(b, k);
      const double* s = rec.sums + slot * 2 * (int64_t)d;
      const float* p = rec.ext + slot * (2 * (int64_t)d + 1);
      const int32_t* q = rec.cnt + slot * 2 * (int64_t)d;
      deg = __fadd_rn(deg, p[2 * d]);
      if (act) {
        a.s1 = __dadd_rn(a.s1, s[f]);
        a.s2 = __dadd_rn(a.s2, s[d + f]);
        merge_max(a.mx, a.nmx, p[f], q[f]);
        merge_min(a.mn, a.nmn, p[d + f], q[d + f]);
      }
    }
    sh_s[wid][0][lane] = a.s1;
    sh_s[wid][1][lane] = a.s2;
    sh_f[wid][0][lane] = a.mx;
    sh_f[wid][1][lane] = a.mn;
    sh_i[wid][0][lane] = a.nmx;
    sh_i[wid][1][lane] = a.nmn;
    if (lane == 0) sh_deg[wid] = deg;
    __syncthreads();
    if (wid == 0) {
      Stats t;
      reset(t);
      float dg = 0.f;
      for (int k = 0; k < MERGE_WARPS; ++k) {  // a fixed order: the same bits every run
        dg = __fadd_rn(dg, sh_deg[k]);
        t.s1 = __dadd_rn(t.s1, sh_s[k][0][lane]);
        t.s2 = __dadd_rn(t.s2, sh_s[k][1][lane]);
        merge_max(t.mx, t.nmx, sh_f[k][0][lane], sh_i[k][0][lane]);
        merge_min(t.mn, t.nmn, sh_f[k][1][lane], sh_i[k][1][lane]);
      }
      if (act) finish(o, x, d, f, dg, t);
    }
    __syncthreads();
  }
}

__global__ void seg_agg_fill_empty(const int32_t* __restrict__ indptr, int64_t n_nodes, int d,
                                   FwdOut o) {
  const int64_t total = n_nodes * d;
  Stats a;
  reset(a);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t node = i / d;
    if (indptr[node + 1] == indptr[node]) finish(o, node, d, (int)(i - node * d), 0.f, a);
  }
}

struct BwdIn {
  const float* mean;
  const float* mx;
  const float* mn;
  const float* std_;
  const float* deg;
  const int32_t* nmax;
  const int32_t* nmin;
  const int8_t* vcode;
  const float* g_mean;
  const float* g_max;
  const float* g_min;
  const float* g_std;
};

// dv = a + b*(v - m) + tie terms, the node's factors at feature i.
struct Coef {
  float a, b, m, mx, mn, tmx, tmn;
};

__device__ __forceinline__ Coef coef(const BwdIn& in, int32_t node, int d, int f, bool act) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (!act) return c;
  const int64_t i = (int64_t)node * d + f;
  const float deg = in.deg[node];
  const float denom = fmaxf(deg, 1.f);
  const float half_c = 0.5f * (float)in.vcode[i];
  c.a = __fdiv_rn(in.g_mean[i], denom);
  c.b = __fdiv_rn(__fmul_rn(in.g_std[i], half_c), __fmul_rn(denom, in.std_[i]));
  c.m = in.mean[i];
  c.mx = in.mx[i];
  c.mn = in.mn[i];
  const bool has = deg > 0.f;
  const int nmx = in.nmax[i], nmn = in.nmin[i];
  c.tmx = has && nmx > 0 ? __fdiv_rn(in.g_max[i], (float)nmx) : 0.f;
  c.tmn = has && nmn > 0 ? __fdiv_rn(in.g_min[i], (float)nmn) : 0.f;
  return c;
}

// ---- The ring design -------------------------------------------------------

static_assert((RING_SLOTS & (RING_SLOTS - 1)) == 0 && RING_SLOTS <= 32,
              "the ring holds a power of two of rows, at most a chunk");
static_assert(RING_BATCH >= 1 && WARP % RING_BATCH == 0 && RING_SLOTS >= 2 * RING_BATCH,
              "a batch divides a chunk, and the ring holds two batches");

__device__ __forceinline__ void copy4_async(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_rows() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's walk over its run [lo, hi) for the features g0 + c*32 + lane
// (c < NCH), RING_BATCH edges at a time: the indices of this chunk of 32
// edges and of the next in registers (lane l holds edge base + l), and the
// source rows of the next AHEAD edges in flight into the warp's ring.  Edge
// i of the run (k = lo + i) lives in slot i % RING_SLOTS; after a batch is
// read, the rows of the edges AHEAD on go into the slots the batch before
// used.  Lane l copies and reads only the floats of its own features.
template <int NCH>
struct RowRing {
  static constexpr int SLOT = NCH * WARP;  // floats a slot
  static constexpr int AHEAD = RING_SLOTS - RING_BATCH;
  float* col;  // this lane's column of the warp's ring
  int64_t lo, hi;
  int lane, g0;
  int32_t s_c, t_c, s_n, t_n;  // this chunk's and the next one's sources and destinations
  float w_c, w_n;

  __device__ __forceinline__ bool act(int c, int d) const { return g0 + c * WARP + lane < d; }

  __device__ __forceinline__ void load_chunk(const int32_t* __restrict__ src,
                                             const int32_t* __restrict__ dst,
                                             const float* __restrict__ w, int64_t base,
                                             int32_t& s, int32_t& t, float& wt) const {
    const int64_t e = base + lane;
    s = 0;
    t = -1;
    wt = 0.f;
    if (e < hi) {
      s = __ldg(src + e);
      t = __ldg(dst + e);
      wt = __ldg(w + e);
    }
  }

  __device__ __forceinline__ void start(float* warp_ring, const int32_t* __restrict__ src,
                                        const int32_t* __restrict__ dst,
                                        const float* __restrict__ w, int64_t lo_, int64_t hi_,
                                        int g0_, int lane_) {
    col = warp_ring + lane_;
    lo = lo_;
    hi = hi_;
    lane = lane_;
    g0 = g0_;
    load_chunk(src, dst, w, lo, s_c, t_c, w_c);
    load_chunk(src, dst, w, lo + WARP, s_n, t_n, w_n);
  }

  // Copies edge k's source row (k < hi) into `slot` and commits its group
  // (an empty one past hi).
  __device__ __forceinline__ void copy_row(const float* __restrict__ hs, int d, int64_t k, int slot,
                                        int32_t s) {
    if (k < hi) {
      const float* row = hs + (int64_t)s * d + g0 + lane;
      float* to = col + slot * SLOT;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (act(c, d)) copy4_async(to + c * WARP, row + c * WARP);
      }
    }
    commit_rows();
  }

  // The prologue: the rows of the run's first AHEAD edges (in this chunk).
  __device__ __forceinline__ void prime(const float* __restrict__ hs, int d) {
    for (int j = 0; j < AHEAD; ++j) copy_row(hs, d, lo + j, j, __shfl_sync(FULL_MASK, s_c, j));
  }

  // The batch of edges i .. i + RING_BATCH - 1 of the run: waits for their
  // rows and reads the lane's features (those past hi read as they lie).
  __device__ __forceinline__ void read(int d, int i, float (&x)[RING_BATCH][NCH]) const {
    wait_rows<AHEAD - RING_BATCH>();
#pragma unroll
    for (int u = 0; u < RING_BATCH; ++u) {
      const float* from = col + ((i + u) & (RING_SLOTS - 1)) * SLOT;
#pragma unroll
      for (int c = 0; c < NCH; ++c) x[u][c] = act(c, d) ? from[c * WARP] : 0.f;
    }
  }

  // After the batch at base + j is used: the row of edge base + j + u + AHEAD.
  __device__ __forceinline__ void refill(const float* __restrict__ hs, int d, int64_t base, int j,
                                         int u) {
    const int jp = j + u + AHEAD;
    const int32_t s = __shfl_sync(FULL_MASK, jp < WARP ? s_c : s_n, jp & (WARP - 1));
    const int64_t k = base + jp;
    copy_row(hs, d, k, (int)(k - lo) & (RING_SLOTS - 1), s);
  }

  // After the chunk at base: the next one becomes this one, and the one
  // after it is loaded.
  __device__ __forceinline__ void next_chunk(const int32_t* __restrict__ src,
                                             const int32_t* __restrict__ dst,
                                             const float* __restrict__ w, int64_t base) {
    s_c = s_n;
    t_c = t_n;
    w_c = w_n;
    load_chunk(src, dst, w, base + 2 * WARP, s_n, t_n, w_n);
  }
};

// The ring kernels' running extremes start at -inf and +inf with no ties
// counted, so that an edge updates them without a branch (v >= 0).
__device__ __forceinline__ void reset_ring(Stats& a) {
  a.s1 = 0.0;
  a.s2 = 0.0;
  a.mx = __int_as_float(0xff800000);  // -inf
  a.mn = __int_as_float(0x7f800000);  // +inf
  a.nmx = 0;
  a.nmn = 0;
}

// add_edge's arithmetic without branches: the same sums (x*x is exact in
// float64, so one fused add gives the product-then-sum's bits) and the
// same extremes and tie counts, for the edges with w > 0 (`pos`).  The
// tests combine with `&`, not `&&`, so that they compile to selects and
// not to divergent branches.
__device__ __forceinline__ void add_edge_ring(Stats& a, float v, bool pos) {
  const double x = (double)v;
  a.s1 = __dadd_rn(a.s1, x);
  a.s2 = __fma_rn(x, x, a.s2);
  const bool gt = pos & (v > a.mx), tie_x = pos & (v == a.mx);
  const bool lt = pos & (v < a.mn), tie_n = pos & (v == a.mn);
  a.nmx = gt ? 1 : (tie_x ? a.nmx + 1 : a.nmx);
  a.nmn = lt ? 1 : (tie_n ? a.nmn + 1 : a.nmn);
  a.mx = gt ? v : a.mx;
  a.mn = lt ? v : a.mn;
}

// A destination's outputs from its statistics, or its record, out of line:
// called at a destination's end only, so that the float64 divisions and
// square roots of `finish` do not hold registers in the walk's loop.
// kind: 0 the outputs, 1 the run's head record, 2 its tail record.
template <int NCH>
__device__ __noinline__ void close_fwd(const Stats* a, float deg, int32_t node, int64_t r,
                                       int d, int fl, int kind, Records rec, FwdOut o) {
  for (int c = 0; c < NCH; ++c) {
    const int f = fl + c * WARP;
    if (kind == 0) {
      if (f < d) finish(o, node, d, f, deg, a[c]);
    } else {
      put_record(rec, 2 * r + (kind - 1), d, f, f < d, deg, a[c]);
    }
  }
}

// A forward walk's state: the current destination's statistics and hd.
template <int NCH>
struct FwdWalk {
  Stats a[NCH];
  float y[NCH];
  int32_t cur;
  bool is_first;
  float deg;

  __device__ __forceinline__ void open(const float* __restrict__ hd, int d, int g0, int lane,
                                       int32_t t) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int f = g0 + c * WARP + lane;
      reset_ring(a[c]);
      y[c] = f < d ? __ldg(hd + (int64_t)t * d + f) : 0.f;
    }
    cur = t;
    deg = 0.f;
  }

  // The current destination done: into the run's head record (when it
  // began in an earlier run and `head`), its tail record (`tail`) or the
  // outputs.  The statistics go out of line through a copy (the walk's own
  // stay in registers).
  __device__ __forceinline__ void close(const Records& rec, const FwdOut& o, int64_t r, int d,
                                        int g0, int lane, bool head, bool tail) const {
    Stats out[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) out[c] = a[c];
    close_fwd<NCH>(out, deg, cur, r, d, g0 + lane, head ? 1 : (tail ? 2 : 0), rec, o);
  }

  __device__ __forceinline__ void add(const float (&x)[NCH], float wt) {
    deg = __fadd_rn(deg, wt);
    const bool pos = wt > 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) add_edge_ring(a[c], message(x[c], y[c], wt), pos);
  }
};

template <int NCH>
__global__ void __launch_bounds__(RING_WARPS * WARP, RING_FWD_BLOCKS)
seg_agg_fwd_ring(const float* __restrict__ hs, const float* __restrict__ hd,
                 const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                 const float* __restrict__ w, int64_t n_edges, int d, int run_edges,
                 int64_t n_runs, Records rec, FwdOut o) {
  extern __shared__ float ring_smem[];
  const int lane = threadIdx.x & (WARP - 1);
  const int wid = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * RING_WARPS + wid;
  if (r >= n_runs) return;  // the whole warp leaves together
  const int64_t lo = r * run_edges;
  const int64_t hi = min64(lo + run_edges, n_edges);
  const int32_t first = dst[lo];
  const int32_t last = dst[hi - 1];
  const bool head_open = lo > 0 && dst[lo - 1] == first;
  const bool tail_open = hi < n_edges && dst[hi] == last;
  float* warp_ring = ring_smem + (size_t)wid * RING_SLOTS * NCH * WARP;
  for (int g0 = 0; g0 < d; g0 += NCH * WARP) {  // one walk unless d > 128
    RowRing<NCH> ring;
    ring.start(warp_ring, src, dst, w, lo, hi, g0, lane);
    ring.prime(hs, d);
    FwdWalk<NCH> walk;
    walk.open(hd, d, g0, lane, first);
    walk.is_first = true;
    for (int64_t base = lo; base < hi; base += WARP) {
      const int cnt = (int)min64(WARP, hi - base);
      for (int j = 0; j < cnt; j += RING_BATCH) {
        const int m = min(RING_BATCH, cnt - j);  // uniform: below RING_BATCH at the run's end
        float x[RING_BATCH][NCH];
        ring.read(d, (int)(base - lo) + j, x);
        int32_t t[RING_BATCH];
        float wt[RING_BATCH];
#pragma unroll
        for (int u = 0; u < RING_BATCH; ++u) {
          t[u] = __shfl_sync(FULL_MASK, ring.t_c, j + u);
          wt[u] = __shfl_sync(FULL_MASK, ring.w_c, j + u);
        }
        if (m == RING_BATCH && t[RING_BATCH - 1] == walk.cur) {
          // The whole batch into the current destination (the edges are
          // sorted): no test between its edges.
#pragma unroll
          for (int u = 0; u < RING_BATCH; ++u) walk.add(x[u], wt[u]);
        } else {
#pragma unroll
          for (int u = 0; u < RING_BATCH; ++u) {
            if (u >= m) break;  // uniform across the warp
            if (t[u] != walk.cur) {  // uniform: the destination changes
              walk.close(rec, o, r, d, g0, lane, walk.is_first && head_open, false);
              walk.open(hd, d, g0, lane, t[u]);
              walk.is_first = false;
            }
            walk.add(x[u], wt[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < RING_BATCH; ++u) ring.refill(hs, d, base, j, u);  // none past hi
      }
      ring.next_chunk(src, dst, w, base);
    }
    wait_rows<0>();  // only empty groups are left; the next walk reuses the ring
    walk.close(rec, o, r, d, g0, lane, walk.is_first && head_open, tail_open);
  }
}

// A backward walk's state: the current destination's coefficients (formed
// once a destination), hd and its float64 sum of d pre.
template <int NCH>
struct BwdWalk {
  Coef cf[NCH];
  float y[NCH];
  double acc[NCH];
  int32_t cur;
  bool is_first;

  __device__ __forceinline__ void open(const BwdIn& in, const float* __restrict__ hd, int d,
                                       int g0, int lane, int32_t t) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int f = g0 + c * WARP + lane;
      acc[c] = 0.0;
      cf[c] = coef(in, t, d, f, f < d);
      y[c] = f < d ? __ldg(hd + (int64_t)t * d + f) : 0.f;
    }
    cur = t;
  }

  __device__ __forceinline__ void close(double* __restrict__ rec, float* __restrict__ d_hd,
                                        int64_t r, int d, int g0, int lane, bool head,
                                        bool tail) const {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int f = g0 + c * WARP + lane;
      if (f >= d) continue;
      if (head) {
        rec[2 * r * (int64_t)d + f] = acc[c];
      } else if (tail) {
        rec[(2 * r + 1) * (int64_t)d + f] = acc[c];
      } else {
        d_hd[(int64_t)cur * d + f] = __double2float_rn(acc[c]);
      }
    }
  }

  __device__ __forceinline__ void add(const float (&x)[NCH], int32_t s, float wt, int d, int g0,
                                      int lane, float* __restrict__ d_hs) {
    float* d_row = d_hs + (int64_t)s * d + g0 + lane;
    const bool pos = wt > 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float pre = __fadd_rn(x[c], y[c]);
      const float v = __fmul_rn(pre > 0.f ? pre : 0.f, wt);
      float dv = __fadd_rn(cf[c].a, __fmul_rn(cf[c].b, __fsub_rn(v, cf[c].m)));
      // The tie terms: added where the edge ties (w > 0), else 0 added
      // (dv + 0 is dv).
      dv = __fadd_rn(dv, (pos & (v == cf[c].mx)) ? cf[c].tmx : 0.f);
      dv = __fadd_rn(dv, (pos & (v == cf[c].mn)) ? cf[c].tmn : 0.f);
      const float dpre = pre > 0.f ? __fmul_rn(dv, wt) : 0.f;
      if (g0 + c * WARP + lane < d && dpre != 0.f) atomicAdd(d_row + c * WARP, dpre);
      acc[c] = __dadd_rn(acc[c], (double)dpre);
    }
  }
};

template <int NCH>
__global__ void __launch_bounds__(RING_WARPS * WARP, RING_BWD_BLOCKS)
seg_agg_bwd_ring(const float* __restrict__ hs, const float* __restrict__ hd,
                 const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                 const float* __restrict__ w, int64_t n_edges, int d, int run_edges,
                 int64_t n_runs, BwdIn in, double* __restrict__ rec, float* __restrict__ d_hs,
                 float* __restrict__ d_hd) {
  extern __shared__ float ring_smem[];
  const int lane = threadIdx.x & (WARP - 1);
  const int wid = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * RING_WARPS + wid;
  if (r >= n_runs) return;
  const int64_t lo = r * run_edges;
  const int64_t hi = min64(lo + run_edges, n_edges);
  const int32_t first = dst[lo];
  const int32_t last = dst[hi - 1];
  const bool head_open = lo > 0 && dst[lo - 1] == first;
  const bool tail_open = hi < n_edges && dst[hi] == last;
  float* warp_ring = ring_smem + (size_t)wid * RING_SLOTS * NCH * WARP;
  for (int g0 = 0; g0 < d; g0 += NCH * WARP) {
    RowRing<NCH> ring;
    ring.start(warp_ring, src, dst, w, lo, hi, g0, lane);
    ring.prime(hs, d);
    BwdWalk<NCH> walk;
    walk.open(in, hd, d, g0, lane, first);
    walk.is_first = true;
    for (int64_t base = lo; base < hi; base += WARP) {
      const int cnt = (int)min64(WARP, hi - base);
      for (int j = 0; j < cnt; j += RING_BATCH) {
        const int m = min(RING_BATCH, cnt - j);
        float x[RING_BATCH][NCH];
        ring.read(d, (int)(base - lo) + j, x);
        int32_t s[RING_BATCH], t[RING_BATCH];
        float wt[RING_BATCH];
#pragma unroll
        for (int u = 0; u < RING_BATCH; ++u) {
          s[u] = __shfl_sync(FULL_MASK, ring.s_c, j + u);
          t[u] = __shfl_sync(FULL_MASK, ring.t_c, j + u);
          wt[u] = __shfl_sync(FULL_MASK, ring.w_c, j + u);
        }
        if (m == RING_BATCH && t[RING_BATCH - 1] == walk.cur) {
#pragma unroll
          for (int u = 0; u < RING_BATCH; ++u) walk.add(x[u], s[u], wt[u], d, g0, lane, d_hs);
        } else {
#pragma unroll
          for (int u = 0; u < RING_BATCH; ++u) {
            if (u >= m) break;
            if (t[u] != walk.cur) {
              walk.close(rec, d_hd, r, d, g0, lane, walk.is_first && head_open, false);
              walk.open(in, hd, d, g0, lane, t[u]);
              walk.is_first = false;
            }
            walk.add(x[u], s[u], wt[u], d, g0, lane, d_hs);
          }
        }
#pragma unroll
        for (int u = 0; u < RING_BATCH; ++u) ring.refill(hs, d, base, j, u);  // none past hi
      }
      ring.next_chunk(src, dst, w, base);
    }
    wait_rows<0>();
    walk.close(rec, d_hd, r, d, g0, lane, walk.is_first && head_open, tail_open);
  }
}

// ---- The register design (a forced variant) -------------------------------

template <int NCH>
__global__ void __launch_bounds__(RUN_WARPS * WARP)
seg_agg_bwd_runs(const float* __restrict__ hs, const float* __restrict__ hd,
                 const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                 const float* __restrict__ w, int64_t n_edges, int d, int run_edges,
                 int64_t n_runs, BwdIn in, double* __restrict__ rec, float* __restrict__ d_hs,
                 float* __restrict__ d_hd) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t r = (int64_t)blockIdx.x * RUN_WARPS + (threadIdx.x >> 5);
  if (r >= n_runs) return;
  const int64_t lo = r * run_edges;
  const int64_t hi = min64(lo + run_edges, n_edges);
  const int32_t first = dst[lo];
  const int32_t last = dst[hi - 1];
  const bool head_open = lo > 0 && dst[lo - 1] == first;
  const bool tail_open = hi < n_edges && dst[hi] == last;
  for (int g0 = 0; g0 < d; g0 += NCH * WARP) {
    int fs[NCH];
    bool act[NCH];
    double acc[NCH];  // float64, as the forward's sums
    Coef cf[NCH];
    int32_t cur = first;
    bool is_first = true;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      fs[c] = g0 + c * WARP + lane;
      act[c] = fs[c] < d;
      acc[c] = 0.0;
      cf[c] = coef(in, cur, d, fs[c], act[c]);
    }
    for (int64_t base = lo; base < hi; base += WARP) {
      const int cnt = (int)min64(WARP, hi - base);
      int32_t s_l = 0, t_l = first;
      float w_l = 0.f;
      if (lane < cnt) {
        s_l = src[base + lane];
        t_l = dst[base + lane];
        w_l = w[base + lane];
      }
      for (int j0 = 0; j0 < cnt; j0 += BATCH) {
        float xs[BATCH][NCH], ys[BATCH][NCH], ws[BATCH];
        int32_t ss[BATCH], ts[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int j = (j0 + u) & (WARP - 1);
          ss[u] = __shfl_sync(FULL_MASK, s_l, j);
          ts[u] = __shfl_sync(FULL_MASK, t_l, j);
          ws[u] = __shfl_sync(FULL_MASK, w_l, j);
          const bool in_run = j0 + u < cnt;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const bool ok = in_run && act[c];
            xs[u][c] = ok ? __ldg(hs + (int64_t)ss[u] * d + fs[c]) : 0.f;
            ys[u][c] = ok ? __ldg(hd + (int64_t)ts[u] * d + fs[c]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (j0 + u >= cnt) break;
          if (ts[u] != cur) {
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              if (act[c]) {
                if (is_first && head_open) {
                  rec[2 * r * (int64_t)d + fs[c]] = acc[c];
                } else {
                  d_hd[(int64_t)cur * d + fs[c]] = __double2float_rn(acc[c]);
                }
              }
              acc[c] = 0.0;
              cf[c] = coef(in, ts[u], d, fs[c], act[c]);
            }
            cur = ts[u];
            is_first = false;
          }
          const float wt = ws[u];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float pre = __fadd_rn(xs[u][c], ys[u][c]);
            const float v = __fmul_rn(pre > 0.f ? pre : 0.f, wt);
            float dv = __fadd_rn(cf[c].a, __fmul_rn(cf[c].b, __fsub_rn(v, cf[c].m)));
            if (wt > 0.f) {
              if (v == cf[c].mx) dv = __fadd_rn(dv, cf[c].tmx);
              if (v == cf[c].mn) dv = __fadd_rn(dv, cf[c].tmn);
            }
            const float dpre = pre > 0.f ? __fmul_rn(dv, wt) : 0.f;
            if (act[c] && dpre != 0.f) atomicAdd(d_hs + (int64_t)ss[u] * d + fs[c], dpre);
            acc[c] = __dadd_rn(acc[c], (double)dpre);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (!act[c]) continue;
      if (is_first && head_open) {
        rec[2 * r * (int64_t)d + fs[c]] = acc[c];
      } else if (tail_open) {
        rec[(2 * r + 1) * (int64_t)d + fs[c]] = acc[c];
      } else {
        d_hd[(int64_t)cur * d + fs[c]] = __double2float_rn(acc[c]);
      }
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * WARP)
seg_agg_bwd_merge(const int32_t* __restrict__ dst, const int32_t* __restrict__ indptr, int d,
                  int run_edges, const double* __restrict__ rec, float* __restrict__ d_hd) {
  const int64_t b = (int64_t)blockIdx.x + 1;
  int64_t n_rec = 0;
  const int32_t x = spanning(dst, indptr, b, run_edges, n_rec);
  if (x < 0) return;
  __shared__ double sh[MERGE_WARPS][WARP];
  const int lane = threadIdx.x & (WARP - 1);
  const int wid = threadIdx.x >> 5;
  for (int f0 = 0; f0 < d; f0 += WARP) {
    const int f = f0 + lane;
    const bool act = f < d;
    double acc = 0.0;
    if (act) {
      for (int64_t k = wid; k < n_rec; k += MERGE_WARPS) {
        acc = __dadd_rn(acc, rec[record_slot(b, k) * d + f]);
      }
    }
    sh[wid][lane] = acc;
    __syncthreads();
    if (wid == 0 && act) {
      double t = 0.0;
      for (int k = 0; k < MERGE_WARPS; ++k) t = __dadd_rn(t, sh[k][lane]);
      d_hd[(int64_t)x * d + f] = __double2float_rn(t);
    }
    __syncthreads();
  }
}

// Features a lane holds (32 apart): d = 75 takes 3, and a d past 128
// walks the run again for each further 128.  Both ring kernels, and the
// register design's backward; the register design's forward holds one (on
// the card at ogb_products three a lane spilled there, with the gathered
// rows in registers, and ran slower).
int chunks_of(int d) { return d > 96 ? 4 : (d > 64 ? 3 : (d > 32 ? 2 : 1)); }

int64_t n_runs_of(int64_t n_edges, int run_edges) {
  return n_edges > 0 ? (n_edges + run_edges - 1) / run_edges : 0;
}

size_t ring_bytes(int nch) { return sizeof(float) * RING_WARPS * RING_SLOTS * nch * WARP; }

// Launches a ring kernel with its ring in dynamic shared memory (past
// 48 KB only after the attribute is set).
template <class Kernel, class... Args>
cudaError_t launch_ring(Kernel kernel, int nch, unsigned blocks, cudaStream_t stream,
                        Args... args) {
  const size_t smem = ring_bytes(nch);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, RING_WARPS * WARP, smem, stream>>>(args...);
  return cudaSuccess;
}

enum Design { kRing = 0, kRegisters = 1 };

int fwd_launch(Design design, const float* hs, const float* hd, const int32_t* src,
               const int32_t* dst, const float* w, const int32_t* indptr, int64_t n_nodes,
               int64_t n_edges, int d, int run_edges, const Records& rec, const FwdOut& o,
               cudaStream_t stream) {
  const int64_t n_runs = n_runs_of(n_edges, run_edges);
  if (n_nodes > 0) {
    const int64_t blocks = min64((n_nodes * d + 255) / 256, 132 * 16);
    seg_agg_fill_empty<<<(unsigned)blocks, 256, 0, stream>>>(indptr, n_nodes, d, o);
  }
  if (n_runs > 0) {
    const int per = design == kRegisters ? RUN_WARPS : RING_WARPS;
    const unsigned blocks = (unsigned)((n_runs + per - 1) / per);
    if (design == kRegisters) {
      seg_agg_fwd_runs<<<blocks, RUN_WARPS * WARP, 0, stream>>>(hs, hd, src, dst, w, n_edges, d,
                                                                 run_edges, n_runs, rec, o);
    } else {
      cudaError_t err;
#define FWD_RING(NCH)                                                                        \
  err = launch_ring(seg_agg_fwd_ring<NCH>, NCH, blocks, stream, hs, hd, src, dst, w, n_edges, d, \
                    run_edges, n_runs, rec, o)
      switch (chunks_of(d)) {
        case 1: FWD_RING(1); break;
        case 2: FWD_RING(2); break;
        case 3: FWD_RING(3); break;
        default: FWD_RING(4); break;
      }
#undef FWD_RING
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (n_runs > 1) {
    seg_agg_fwd_merge<<<(unsigned)(n_runs - 1), MERGE_WARPS * WARP, 0, stream>>>(
        dst, indptr, d, run_edges, rec, o);
  }
  return (int)cudaGetLastError();
}

int bwd_launch(Design design, const float* hs, const float* hd, const int32_t* src,
               const int32_t* dst, const float* w, const int32_t* indptr, int64_t n_edges, int d,
               int run_edges, const BwdIn& in, double* rec, float* d_hs, float* d_hd,
               cudaStream_t stream) {
  const int64_t n_runs = n_runs_of(n_edges, run_edges);
  if (n_runs > 0) {
    const int per = design == kRegisters ? RUN_WARPS : RING_WARPS;
    const unsigned blocks = (unsigned)((n_runs + per - 1) / per);
    cudaError_t err = cudaSuccess;
#define BWD_RUNS(NCH)                                                                         \
  if (design == kRegisters) {                                                               \
    seg_agg_bwd_runs<NCH><<<blocks, RUN_WARPS * WARP, 0, stream>>>(                         \
        hs, hd, src, dst, w, n_edges, d, run_edges, n_runs, in, rec, d_hs, d_hd);           \
  } else {                                                                                  \
    err = launch_ring(seg_agg_bwd_ring<NCH>, NCH, blocks, stream, hs, hd, src, dst, w, n_edges, \
                      d, run_edges, n_runs, in, rec, d_hs, d_hd);                           \
  }
    switch (chunks_of(d)) {
      case 1: BWD_RUNS(1); break;
      case 2: BWD_RUNS(2); break;
      case 3: BWD_RUNS(3); break;
      default: BWD_RUNS(4); break;
    }
#undef BWD_RUNS
    if (err != cudaSuccess) return (int)err;
  }
  if (n_runs > 1) {
    seg_agg_bwd_merge<<<(unsigned)(n_runs - 1), MERGE_WARPS * WARP, 0, stream>>>(
        dst, indptr, d, run_edges, rec, d_hd);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FWD_PARAMS                                                                            \
  const float *hs, const float *hd, const int32_t *src, const int32_t *dst, const float *w,   \
      const int32_t *indptr, int64_t n_nodes, int64_t n_edges, int d, int run_edges,          \
      double *rec_sums, float *rec_ext, int32_t *rec_cnt, float *mean, float *mx, float *mn,  \
      float *std_, float *deg, int32_t *nmax, int32_t *nmin, int8_t *vcode, cudaStream_t stream
#define FWD_ARGS                                                                              \
  hs, hd, src, dst, w, indptr, n_nodes, n_edges, d, run_edges,                                \
      Records{rec_sums, rec_ext, rec_cnt}, FwdOut{mean, mx, mn, std_, deg, nmax, nmin, vcode}, \
      stream

// The ring design (the main path).
extern "C" int segment_aggregate_fwd_launch(FWD_PARAMS) { return fwd_launch(kRing, FWD_ARGS); }

// The register design, forced (off the main path).
extern "C" int segment_aggregate_fwd_registers_launch(FWD_PARAMS) {
  return fwd_launch(kRegisters, FWD_ARGS);
}

// d_hs and d_hd come zeroed: d_hs takes atomics, d_hd keeps 0 at the
// nodes with no edges.
#define BWD_PARAMS                                                                              \
  const float *hs, const float *hd, const int32_t *src, const int32_t *dst, const float *w,     \
      const int32_t *indptr, int64_t n_nodes, int64_t n_edges, int d, int run_edges,            \
      const float *mean, const float *mx, const float *mn, const float *std_, const float *deg, \
      const int32_t *nmax, const int32_t *nmin, const int8_t *vcode, const float *g_mean,       \
      const float *g_max, const float *g_min, const float *g_std, double *rec, float *d_hs,     \
      float *d_hd, cudaStream_t stream
#define BWD_ARGS                                                                            \
  hs, hd, src, dst, w, indptr, n_edges, d, run_edges,                                       \
      BwdIn{mean, mx, mn, std_, deg, nmax, nmin, vcode, g_mean, g_max, g_min, g_std}, rec, \
      d_hs, d_hd, stream

extern "C" int segment_aggregate_bwd_launch(BWD_PARAMS) {
  (void)n_nodes;
  return bwd_launch(kRing, BWD_ARGS);
}

extern "C" int segment_aggregate_bwd_registers_launch(BWD_PARAMS) {
  (void)n_nodes;
  return bwd_launch(kRegisters, BWD_ARGS);
}
