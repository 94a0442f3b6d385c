// Shared pieces of the blocked flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu (the forward) and flash_attention_bwd.cu (the
// recompute backward).
//
// Layout. q, k, v and dO are (B, T, H, D) views whose last two axes are
// contiguous (head stride D, element stride 1); the batch and sequence strides
// are passed in, so the views of a fused qkv projection (B, T, 3*H*D) are read
// in place. Every output is a contiguous (B, T, H, D) tensor; lse and delta
// are contiguous (B, H, T) f32.
//
// Arithmetic. All products run on the FMA units in f32. A bf16 product is
// exact in f32, so a bf16 operand pair gives what the TPU's bf16 matrix unit
// with f32 accumulation gives; an f32 storage type gets exact f32 FMAs (no
// TF32). Values are rounded to the storage type exactly where the TPU kernel
// casts them (round_to below).
//
// Work split. A block is 8 warps. A warp owns a few rows of the block's tile
// (query rows in the forward and the dq side, key rows in the dk/dv side);
// for a score tile each lane takes one row of the other operand, so a
// score s[r] is one lane's dot product over D, read from shared memory as
// float4 (the per-lane rows are padded by 4 floats, which makes those reads
// conflict-free; the warp's own rows are read as broadcasts). For the
// products with the score tile each lane owns the columns lane + 32*c of the
// warp's rows, and the scores reach it by warp shuffles, so no score or
// probability tile goes through shared memory and no T x T matrix reaches
// device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;          // keys per step (forward, dq) or queries per step (dk/dv)
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF for masked scores
constexpr unsigned kFull = 0xffffffffu;

// Query rows per warp in the forward and the dq side: 64 accumulators a
// thread (RPW * D / 32), at most 8 rows.
__host__ __device__ constexpr int query_rows_per_warp(int D) {
  return 2048 / D < 8 ? 2048 / D : 8;
}
// Key rows per warp in the dk/dv side: dk and dv take 2 * RPW * D / 32
// accumulators a thread, at most 64.
__host__ __device__ constexpr int key_rows_per_warp(int D) {
  return 1024 / D < 8 ? 1024 / D : 8;
}
// Floats per row of a per-lane operand in shared memory.
__host__ __device__ constexpr int padded(int D) { return D + 4; }

struct View {  // a (B, T, H, D) operand: batch and sequence strides, in elements
  long long sb, st;
};

struct Geometry {
  int B, H, Tq, Tk, causal;
};

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of storage as floats: 4 f32 or 8 bf16.
__device__ __forceinline__ void to_floats(const uint4& raw, float* x, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = f[e];
}
__device__ __forceinline__ void to_floats(const uint4& raw, float* x, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// Rows [row0, row0 + kRows) of one head's (T, D) slice `src` (rows `stride`
// elements apart) into shared memory as f32, `ss` floats per row; rows at or
// past `valid` are zero. With scale != 0 each value is multiplied by it and
// rounded to T, as the TPU kernel's `q_ref[...] * sm_scale` is.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_rows(float* dst, int ss, const T* __restrict__ src,
                                          long long stride, int row0, int valid, float scale) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < kRows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    float x[V];
    if (row0 + r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c));
      to_floats(raw, x, T());
      if (scale != 0.f) {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = round_to<T>(x[e] * scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ss + c);
#pragma unroll
    for (int e = 0; e < V / 4; ++e)
      d[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
  }
}

// s[r] = a[r] . b over D for the warp's R rows a (broadcast reads, rows
// `as` floats apart) and this lane's row b.
template <int D, int R>
__device__ __forceinline__ void dot_rows(float (&s)[R], const float* a, int as, const float* b) {
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(a + r * as + d);
      s[r] = fmaf(x.x, y.x, s[r]);
      s[r] = fmaf(x.y, y.y, s[r]);
      s[r] = fmaf(x.z, y.z, s[r]);
      s[r] = fmaf(x.w, y.w, s[r]);
    }
  }
}

// Butterfly reductions: every lane ends with the same value (each step adds
// two operands in either order, and f32 addition commutes).
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Raises the kernel's dynamic shared memory limit to `bytes` (needed above 48 KB).
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace flash
