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
// (the section "f32 on TF32" of tensor_core.cuh, which also holds the bf16
// mma and ldmatrix primitives).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace packed {

using namespace tensor_core;

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

// Blocks of the f32 forms hold at most 6 warps of 16 rows (3 blocks of 5 at
// T=197, where bf16 takes 2 of 7): two blocks of 7 an SM would put 4 warps
// on one of its four register files and cap a thread at 128 registers, too
// few for the f32 fragments without spilling; two of at most 6 put 3 there,
// which allows 168.
constexpr int kMaxWarpsF32 = 6;

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
