// resident_common.cuh: what the port's fp32 "resident" attention kernels
// share (csrc/flash_attention.cu's `flash_resident_kernel`, the forward,
// and csrc/flash_attention_bwd_resident.cu's `flash_bwd_resident_kernel`,
// its backward): the XOR swizzle of the fp32 rows they keep in shared
// memory, the 16-byte cp.async copy that fills them, and the TF32
// tensor-core product in the 3xTF32 split.  Each source that includes it
// is compiled on its own, so everything here is inline or a macro.
//
// The 3xTF32 split.  Each fp32 operand x is split into x_hi = tf32(x)
// (round to nearest, ties away) and x_lo = x - x_hi cut to TF32, and a
// product a·b is taken as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with fp32
// sums: the dropped a_lo·b_lo (2^-22 of |a·b|) and the cut of the lo parts
// (below 2^-21) keep the error near that of fp32 FMA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FR_LOG2E 1.4426950408889634f
#define FR_LN2 0.6931471805599453f
#define FR_MAX_SMEM 232448  // an H100 block's opt-in shared memory

// Piece c (16 bytes) of row r: swizzled within its group of 8 pieces.
__device__ __forceinline__ int fr_swz(int r, int c) { return (c & ~7) | ((c ^ r) & 7); }

// Element (r, col) of a swizzled [rows][dp] array.
__device__ __forceinline__ int fr_at(int r, int col, int dp) {
  return r * dp + fr_swz(r, col >> 2) * 4 + (col & 3);
}

// One 16-byte copy into shared memory; zeros where `full` is false (the
// source is then not read, but stays a valid address).
__device__ __forceinline__ void fr_cp16(float* dst, const float* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void fr_cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, in two integer
// operations at the full rate (the conversion runs at a quarter of it).
__device__ __forceinline__ uint32_t fr_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split of x: hi = tf32(x), lo = x - hi (exact in fp32, at most
// 2^-11 of |x|) cut to TF32 by dropping its low 13 bits: that moves lo by
// less than 2^-21 of |x|, and costs one operation.
__device__ __forceinline__ void fr_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = fr_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a·b: one m16n8k8 TF32 product on the tensor cores, fp32 sums.
__device__ __forceinline__ void fr_mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in the 3xTF32 split, the small terms first.
__device__ __forceinline__ void fr_mma3(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                        float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  fr_split(b0, b0h, b0l);
  fr_split(b1, b1h, b1l);
  fr_mma(c, a_lo, b0h, b1h);
  fr_mma(c, a_hi, b0l, b1l);
  fr_mma(c, a_hi, b0h, b1h);
}

// 2^x in one MUFU operation (ex2.approx: relative error about 2^-22;
// results below the smallest normal float are 0).
__device__ __forceinline__ float fr_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
