// Tensor-core primitives shared by the kernels for Hopper (sm_90a): the
// packed kernels (short_attention_common.cuh and the files that include it),
// the flash kernels (flash_attention_common.cuh) and the f32 dense layers
// (dense_f32.cu).
//
// bf16: mma.sync m16n8k16 with f32 accumulation, and ldmatrix to load its
// fragments from shared memory. Fragment layouts are those of mma.m16n8k16:
// lane = 4*g + t holds rows g and g+8, columns 2t, 2t+1 (+8).
//
// f32: the section "f32 on TF32" below, each product as three TF32
// products on mma.sync m16n8k8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tensor_core {

// c += a . b for a 16x16 bf16 tile a (row fragment), a 16x8 bf16 tile b
// (column fragment) and a 16x8 f32 tile c.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles from shared memory: lanes 8i..8i+7 give the row
// addresses of tile i, and lane 4g+t gets elements (g, 2t) and (g, 2t+1) of
// each tile: the A fragment of a row-major tile, or the B fragment of a
// matrix stored [n][k].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Transposed: each lane gets two vertically adjacent elements of each tile,
// the B fragment of a matrix stored [k][n].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---------------------------------------------------------------- f32 on TF32
// An f32 product a . b runs as three products on mma.sync m16n8k8 .tf32
// (CUTLASS's OpMultiplyAddFastF32): each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded by cvt.rna (to nearest,
// ties away from zero), and a . b = lo_a . hi_b + hi_a . lo_b + hi_a . hi_b,
// the small terms first, into one f32 accumulator. What the split drops
// (lo . lo and lo's own rounding) is ~2^-22 of |a||b|, as large as an f32
// FMA chain's error; one TF32 product alone would leave ~2^-11. lo is formed
// from the f32 value where it is used, not kept beside it in registers.
// An mma truncates the sum it accumulates, losing up to an ulp of it each
// time: over a K of thousands an accumulator fed by every product drifts
// toward zero, so dense_f32.cu adds each 32-wide stage's products into the
// f32 sum by FADD (rounded to nearest).
//
// Fragments of mma.m16n8k8 .tf32, lane = 4g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// So an accumulator is not the next product's A fragment as it stands: C
// holds columns 2t and 2t+1 where A wants t and t+4. A product sums over k in
// any order, though: take the k index t as column 2t and t+4 as column 2t+1,
// and C's {c0, c2, c1, c3} is the A fragment (`acc_as_a`), provided B's rows
// are taken in the same order, b0 from row 2t and b1 from row 2t+1
// (`load_b_kn`). No shuffle, no trip through shared memory.
//
// Shared f32 rows are padded by kPadF floats: a row stride of 4 (mod 32)
// words keeps every fragment load below free of bank conflicts.

constexpr int kPadF = 4;  // floats of padding per shared f32 row

// The cvt is volatile so that the compiler forms hi and lo where they are
// used, rather than hoisting a loop's worth of them into registers.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

// The split on the integer and f32 pipes, without cvt (which issues at a
// fraction of their rate: the flash backward splits every fragment it
// loads, PERF.md): hi = x with its 13 low bits cleared, lo = x - hi (exact)
// passed whole, since the tensor cores ignore a TF32 operand's 13 low bits
// (clearing them gives the same bits on an H100). Both round toward
// zero: ~2^-21 of |x| is left, where cvt.rna's split leaves ~2^-22.
__device__ __forceinline__ Tf32Pair split_tf32_rz(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// An A fragment (a0..a3 in the layout above), split.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32Pair p = split_tf32(a[e]);
    f.hi[e] = p.hi;
    f.lo[e] = p.lo;
  }
  return f;
}

// The A fragment of an accumulator tile, its columns read as k = t <-> 2t,
// t + 4 <-> 2t + 1; pair it with B rows from `load_b_kn`.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8) += a (16 x 8) . b (8 x 8) in three TF32 terms, small first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0, float b1) {
  const Tf32Pair x = split_tf32(b0), y = split_tf32(b1);
  mma_1688(c, a.lo, x.hi, y.hi);
  mma_1688(c, a.hi, x.lo, y.lo);
  mma_1688(c, a.hi, x.hi, y.hi);
}

// ldmatrix on f32 rows: each 8x8 b16 tile is 8 rows of 4 floats, and lane
// 4g + t gets float t of row g of each tile.
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], const float* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint32_t x[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr)
               : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(x[i]);
}

// Two tiles: lanes 0-7 and 8-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(float& r0, float& r1, const float* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint32_t x0, x1;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(x0), "=r"(x1)
               : "r"(addr)
               : "memory");
  r0 = __uint_as_float(x0);
  r1 = __uint_as_float(x1);
}

// The split A fragment of columns [8kk, 8kk + 8) of 16 shared rows
// ([row][LD] at `rows`): the four tiles are rows 0-7 / 8-15 by columns 0-3 /
// 4-7, lanes 8i..8i+7 addressing tile i.
template <int LD>
__device__ __forceinline__ FragA load_a_f32(const float* rows, int kk, int lane) {
  float a[4];
  ldmatrix_x4(a, rows + ((lane & 7) + (lane & 8)) * LD + (lane >> 4) * 4 + kk * 8);
  return split_a(a[0], a[1], a[2], a[3]);
}

// The B fragment of k-chunk kk of a matrix stored [n][k] (8 shared rows
// [n][LD] at `rows`, k along the row): b0 from columns 8kk..8kk+3, b1 from
// 8kk+4..8kk+7.
template <int LD>
__device__ __forceinline__ void load_b_nk(float& b0, float& b1, const float* rows, int kk,
                                          int lane) {
  ldmatrix_x2(b0, b1, rows + (lane & 7) * LD + kk * 8 + (lane & 8) / 2);
}

// A float from shared memory, kept in program order among the asm above,
// so that a product's B loads are not all hoisted over its (volatile)
// conversions and mma (with plain loads the backward's key side spilled
// more: tools/torch_packed_attention_turns.py --f32).
__device__ __forceinline__ float lds(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// The B fragment of columns [n0, n0 + 8) of a matrix stored [k][n] (8 shared
// rows at `rows`), rows in the order of `acc_as_a`: b0 from row 2t, b1 from
// row 2t + 1.
template <int LD>
__device__ __forceinline__ void load_b_kn(float& b0, float& b1, const float* rows, int n0, int g,
                                          int t) {
  b0 = lds(rows + 2 * t * LD + n0 + g);
  b1 = lds(rows + (2 * t + 1) * LD + n0 + g);
}

}  // namespace tensor_core
