// Shared device code of the packed short-sequence attention kernels for
// Hopper (sm_90a): short_attention_fwd.cu (the forward), short_attention_bwd.cu
// (the recompute backward) and fused_qkv_attention_fwd.cu (the qkv projection
// and the forward in one kernel).
//
// bf16 products run on the tensor cores with mma.sync m16n8k16 (f32
// accumulation), their fragments loaded from shared memory with ldmatrix.
// Fragment layouts are those of mma.m16n8k16: lane = 4*g + t holds rows g and
// g+8, columns 2t, 2t+1 (+8). Shared rows are padded by kPad bf16 (16 bytes),
// which makes the fragment loads conflict-free. `attend_steps` (whole key
// steps, no branch inside one; the forward's and the fused kernel's) with
// `store_rows_bf16` are the forward's one online-softmax loop over staged
// keys and its output epilogue, in the order of the TPU's head-pair kernel
// (avt_tpu/ops/flash_attention.py:_short_fwd_kernel_paired):
//   s  = q' . k^T (f32), q' = q * (sm_scale * log2 e) rounded to bf16
//   p  = exp2(s - rowmax s), rounded to bf16 for an f32-accumulated p . v
//   out = (p . v) / max(rowsum p, 1e-30), rounded once to bf16
// `load_a_global` and `fix2` give a warp its own rows' A fragments straight
// from device memory, with the bias add and scaling that `fix8` does to a
// staged tile applied in registers (the same bits).
//
// f32 products run on the tensor cores too, as three TF32 products each
// (the section "f32 on TF32" at the end of this file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace packed {

constexpr int kPad = 8;   // bf16 of padding per shared row
constexpr int kBK = 64;   // keys per step of the forward's online softmax

// Two floats as one register of two bf16, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// fix8's arithmetic on one register of two bf16: + b (when `biased`), then
// * scale2 (when `scaled`), each result rounded once.
__device__ __forceinline__ uint32_t fix2(uint32_t x, uint32_t b, bool biased, bool scaled,
                                         __nv_bfloat162 scale2) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  if (biased) v = __hadd2(v, *reinterpret_cast<const __nv_bfloat162*>(&b));
  if (scaled) v = __hmul2(v, scale2);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// In place on eight bf16 in shared memory: + bias (when given), then * scale
// (when `scaled`); bf16x2 arithmetic rounds each result once, as a bf16
// tensor add or multiply does.
__device__ __forceinline__ void fix8(__nv_bfloat16* p, const __nv_bfloat16* bias,
                                     bool scaled, __nv_bfloat162 scale2) {
  uint4 x = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162* xv = reinterpret_cast<__nv_bfloat162*>(&x);
  if (bias != nullptr) {
    const uint4 b = *reinterpret_cast<const uint4*>(bias);
    const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = __hadd2(xv[i], bv[i]);
  }
  if (scaled) {
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = __hmul2(xv[i], scale2);
  }
  *reinterpret_cast<uint4*>(p) = x;
}

// 2^x on the special-function unit (flushing denormal results to zero): p is
// rounded to bf16 before it is used, far coarser than the approximation.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copies 16 bytes global -> shared without holding registers; with `valid`
// false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// A fragments (16 rows x D) of a warp's rows from a shared [row][LD] tile.
template <int D, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* rows,
                                       int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld_u32(rows + g * LD + kk * 16 + 2 * t);
    a[kk][1] = ld_u32(rows + (g + 8) * LD + kk * 16 + 2 * t);
    a[kk][2] = ld_u32(rows + g * LD + kk * 16 + 2 * t + 8);
    a[kk][3] = ld_u32(rows + (g + 8) * LD + kk * 16 + 2 * t + 8);
  }
}

// A fragments (16 rows x D) read straight from device memory, with fix8's
// arithmetic applied in registers: `rows` points at the first row's first
// column, `ld` is the row stride; rows from `valid` on are zero. `bias` (D
// values, or null) is added and, with `scaled`, the sum multiplied by scale2:
// the bits a staged tile gets from fix8, without the shared-memory pass.
template <int D>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[D / 16][4], const __nv_bfloat16* rows,
                                              size_t ld, int valid, const __nv_bfloat16* bias,
                                              bool scaled, __nv_bfloat162 scale2, int g, int t) {
  const bool v0 = g < valid, v1 = g + 8 < valid;
  const __nv_bfloat16* r0 = rows + size_t(g) * ld + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * ld;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = v0 ? ldg_u32(r0 + kk * 16) : 0u;
    a[kk][1] = v1 ? ldg_u32(r1 + kk * 16) : 0u;
    a[kk][2] = v0 ? ldg_u32(r0 + kk * 16 + 8) : 0u;
    a[kk][3] = v1 ? ldg_u32(r1 + kk * 16 + 8) : 0u;
  }
  const bool biased = bias != nullptr;
  if (!biased && !scaled) return;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t b0 = biased ? ldg_u32(bias + kk * 16 + 2 * t) : 0u;
    const uint32_t b1 = biased ? ldg_u32(bias + kk * 16 + 2 * t + 8) : 0u;
    if (v0) a[kk][0] = fix2(a[kk][0], b0, biased, scaled, scale2);
    if (v1) a[kk][1] = fix2(a[kk][1], b0, biased, scaled, scale2);
    if (v0) a[kk][2] = fix2(a[kk][2], b1, biased, scaled, scale2);
    if (v1) a[kk][3] = fix2(a[kk][3], b1, biased, scaled, scale2);
  }
}

// The forward's running state for one warp's 16 query rows.
template <int D>
struct RowState {
  float o[D / 8][4];
  float m0, m1, l0, l1;  // row max and sum of rows g and g+8
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
  }
};

// One warp's query rows (row0 = qw + g, row1 = row0 + 8) against keys
// [ks0, k_end) staged at Ks / Vs ([row][D + kPad], row r = key ks0 + r), in
// KB-key steps with an online softmax. The staged rows must cover every step
// that starts before k_end (finite values past T: those keys are masked), so
// each step's products run whole, with no branch inside a step, and its score
// tiles are independent chains of mma the warp can interleave. Keys >= T, and
// with `causal` keys after the query, are masked.
template <int D, int KB>
__device__ __forceinline__ void attend_steps(RowState<D>& st, const uint32_t (&qa)[D / 16][4],
                                             const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                             int ks0, int k_end, int T, int row0, int row1,
                                             bool causal, int lane) {
  constexpr int LD = D + kPad;
  const int t = lane & 3;
  for (int k0 = ks0; k0 < k_end; k0 += KB) {
    const __nv_bfloat16* Kc = Ks + (k0 - ks0) * LD;
    const __nv_bfloat16* Vc = Vs + (k0 - ks0) * LD;
    float s[KB / 8][4];
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* ktile = Kc + (j * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ktile + kk * 16);
        mma_16816(s[j], qa[kk], b[0], b[1]);
        mma_16816(s[j], qa[kk + 1], b[2], b[3]);
      }
    }
    if (causal || k0 + KB > T) {
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          if (key >= T || (causal && key > (e < 2 ? row0 : row1))) s[j][e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(st.m0, quad_max(mx0)), mn1 = fmaxf(st.m1, quad_max(mx1));
    // a row with every key so far masked keeps max -inf: shift by 0 so that
    // exp2 gives 0 rather than NaN
    const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
    const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = fast_exp2(st.m0 - sh0), a1 = fast_exp2(st.m1 - sh1);
    st.m0 = mn0;
    st.m1 = mn1;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      s[j][0] = fast_exp2(s[j][0] - sh0);
      s[j][1] = fast_exp2(s[j][1] - sh0);
      s[j][2] = fast_exp2(s[j][2] - sh1);
      s[j][3] = fast_exp2(s[j][3] - sh1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    st.l0 = st.l0 * a0 + l0;
    st.l1 = st.l1 * a1 + l1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      st.o[j][0] *= a0;
      st.o[j][1] *= a0;
      st.o[j][2] *= a1;
      st.o[j][3] *= a1;
    }
    // o += p . v: the score accumulators of key columns [16kk, 16kk+16) are
    // exactly the A fragment of the next product; V's B fragments come from
    // its row-major tile through ldmatrix.trans, two dim-tiles a load
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vtile = Vc + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vtile + j * 8);
        mma_16816(st.o[j], pa, b[0], b[1]);
        mma_16816(st.o[j + 1], pa, b[2], b[3]);
      }
    }
  }
}

// out rows row0 / row1 (those < T) of one head: o / max(l, 1e-30) rounded to
// bf16. `out0` points at row0's first column of the head, `ld` is the row
// stride of out.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* out0, size_t ld, const RowState<D>& st,
                                                int row0, int row1, int T, int t) {
  const float inv0 = 1.f / fmaxf(quad_sum(st.l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(st.l1), 1e-30f);
  __nv_bfloat16* p0 = out0 + 2 * t;
  __nv_bfloat16* p1 = out0 + 8 * ld + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(p0 + j * 8) = pack_bf16(st.o[j][0] * inv0, st.o[j][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(p1 + j * 8) = pack_bf16(st.o[j][2] * inv1, st.o[j][3] * inv1);
  }
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

// Blocks of the f32 forms hold at most 6 warps of 16 rows (3 blocks of 5 at
// T=197, where bf16 takes 2 of 7): two blocks of 7 an SM would put 4 warps
// on one of its four register files and cap a thread at 128 registers, too
// few for the f32 fragments without spilling; two of at most 6 put 3 there,
// which allows 168.
constexpr int kMaxWarpsF32 = 6;

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

// In place on four floats in shared memory: + b (when `biased`), then
// * scale (when `scaled`), in f32 as the plain version adds and scales.
__device__ __forceinline__ void fix4(float* p, const float4& b, bool biased, bool scaled,
                                     float scale) {
  float4 x = *reinterpret_cast<const float4*>(p);
  if (biased) {
    x.x += b.x;
    x.y += b.y;
    x.z += b.z;
    x.w += b.w;
  }
  if (scaled) {
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
  }
  *reinterpret_cast<float4*>(p) = x;
}

}  // namespace packed
