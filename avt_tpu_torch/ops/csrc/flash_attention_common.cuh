// Shared pieces of the blocked flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu (the forward) and flash_attention_bwd.cu (the
// recompute backward). The arithmetic and the work split below are the
// forward's; the backward takes the layout, the staging and the rounding
// from here and runs its products on the tensor cores (its own note).
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
// Work split. A block is 8 warps. It keeps BM rows of one operand (the
// query rows) in shared memory and steps over BN-row tiles of the others
// (Tiling below).
// Every product is tiled in registers, so that each shared-memory load feeds
// several FMAs: an SM issues 4 warp-FMAs a clock and reads one 128-byte
// wavefront a clock, so a loop that loads more than one wavefront per 4
// warp-FMAs is paced by shared memory.
//   Scores (score_partials): the BN x BM tile of a . b over D. The warps
//   split D into NSL slices and the tile into PARTS parts (NSL * PARTS = 8);
//   a lane sums a TA x TB block over its slice from float4 loads, its kept
//   rows 8 apart and its step rows 4 apart, so that a warp's loads touch 8
//   and 4 rows (one wavefront each; rows padded by 4 floats): per 4 values
//   of d, TA + TB wavefronts for 4 * TA * TB FMAs a lane. The partials go
//   through shared memory and are added in a fixed order, slice 0 first
//   (partial_sum): no atomics, the same bits run to run.
//   Accumulators (fma_step): a thread owns RT = 8 kept rows x CT columns (64
//   floats at D >= 256), the columns in VEC-float groups tc*VEC + CG*VEC*j
//   so that a warp's row loads are contiguous; per step row each loaded
//   value feeds RT FMAs and each tile value, a broadcast, feeds CT.
// No T x T matrix reaches device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF for masked scores
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block can have

// The tiles of every flash kernel (the note at the top). BM * D = 16384 (at
// most 64 rows) is what a block keeps; BN * D = 8192 (at most 32) a step:
// 32 and 16 rows at D=512, 16 and 8 at D=1024.
template <int D>
struct Tiling {
  static constexpr int BM = 16384 / D < 64 ? 16384 / D : 64;  // rows a block keeps
  static constexpr int BN = 8192 / D < 32 ? 8192 / D : 32;    // rows a step
  static constexpr int KS = D + 4;  // floats an operand row, padded (the note at the top)
  // scores: a lane's TA x TB block, a warp's WA x WB part over D / NSL
  static constexpr int TA = D == 1024 ? 2 : 4, TB = TA;
  static constexpr int WA = 8 * TA, WB = 4 * TB;
  static constexpr int PB = BN / WB, PARTS = (BM / WA) * PB;
  static constexpr int NSL = kWarps / PARTS, DS = D / NSL;
  static constexpr int PS = BM + 8;  // floats a row of a BN x BM score tile
  static constexpr int EPT = (BM * BN + kThreads - 1) / kThreads;  // scores a thread sums
  // accumulators: a thread's RT kept rows x CT columns, in NV groups of VEC
  static constexpr int RT = 8, RG = BM / RT, CG = kThreads / RG, CT = D / CG;
  static constexpr int VEC = CT < 4 ? CT : 4, NV = CT / VEC;

  static_assert(BM % WA == 0 && BN % WB == 0 && kWarps % PARTS == 0 && NSL >= 2, "score split");
  static_assert(DS % 4 == 0 && BM % RT == 0 && CG * CT == D && CT % VEC == 0, "tiles");
};

// Where a lane's score block and accumulators lie (the note at the top).
template <class L>
struct Place {
  int ar, br, d0, slice;  // scores: first kept and step row, slice of D
  int tr, tc;             // accumulators: kept rows tr*RT + r, columns col(c)
  __device__ explicit Place(int tid) {
    const int warp = tid / 32, lane = tid % 32, part = warp % L::PARTS;
    slice = warp / L::PARTS;
    ar = (part / L::PB) * L::WA + lane % 8;
    br = (part % L::PB) * L::WB + lane / 8;
    d0 = slice * L::DS;
    tr = tid / L::CG;
    tc = tid % L::CG;
  }
  __device__ int col(int c) const {
    return (c / L::VEC) * L::CG * L::VEC + tc * L::VEC + c % L::VEC;
  }
};

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
// A thread's 16-byte global loads go out 4 at a time, all 4 before the first
// store (16 registers in flight): one memory round trip per 4 vectors, where
// a load followed by its store waits out each trip alone (the dk/dv side,
// one block an SM, lost 13-17% to that). Two groups are unrolled, so the
// compiler can overlap them; more stay a loop: unrolled, the compiler hoists
// every group's loads and spills beside the accumulators (the first forward
// and dq side, at D=512 and 1024 in f32).
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_rows(float* dst, int ss, const T* __restrict__ src,
                                          long long stride, int row0, int valid, float scale) {
  constexpr int V = 16 / sizeof(T), VPR = D / V, N = kRows * VPR / kThreads;
  constexpr int G = N < 4 ? N : 4;
  constexpr int kUnroll = N <= 2 * G ? N / G : 1;
  static_assert(kRows * VPR % kThreads == 0 && N % G == 0, "whole groups of vectors a thread");
#pragma unroll (kUnroll)
  for (int n0 = 0; n0 < N; n0 += G) {
    uint4 raw[G];
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int i = threadIdx.x + (n0 + n) * kThreads, r = i / VPR, c = (i % VPR) * V;
      raw[n] = row0 + r < valid
                   ? __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int i = threadIdx.x + (n0 + n) * kThreads, r = i / VPR, c = (i % VPR) * V;
      float x[V];
      to_floats(raw[n], x, T());
      if (scale != 0.f) {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = round_to<T>(x[e] * scale);
      }
      float4* d = reinterpret_cast<float4*>(dst + r * ss + c);
#pragma unroll
      for (int e = 0; e < V / 4; ++e)
        d[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
    }
  }
}

// One 16-byte cp.async copy from device to shared memory; bytes = 0 writes
// zeros. commit_copies closes a group of them, wait_copies waits for all.
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  const unsigned to = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + kRows) of a K or V slice into shared memory, as
// load_rows puts them (scale 0). f32 rows are copied by cp.async straight
// into the padded rows (rows past `valid` zero-filled), so that the copy runs
// on while the block computes; the caller waits (wait_copies) before the
// barrier that hands the rows on. bf16 rows are converted through registers
// (load_rows), so their loads are not overlapped.
template <typename T, int D, int kRows>
__device__ __forceinline__ void fetch_rows(float* dst, int ss, const T* __restrict__ src,
                                           long long stride, int row0, int valid) {
  if constexpr (sizeof(T) != sizeof(float)) {
    load_rows<T, D, kRows>(dst, ss, src, stride, row0, valid, 0.f);
  } else {
    constexpr int VPR = D / 4, N = kRows * VPR / kThreads;
    static_assert(kRows * VPR % kThreads == 0, "whole vectors a thread");
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = threadIdx.x + n * kThreads, r = i / VPR, c = (i % VPR) * 4;
      const bool in = row0 + r < valid;
      copy16(dst + r * ss + c, in ? src + (row0 + r) * stride + c : src, in ? 16 : 0);
    }
    commit_copies();
  }
}

// One warp's partial scores: a (kept rows, 8 apart) . b (step rows, 4 apart)
// over the warp's slice of D, TA x TB sums a lane, stored to `out` (step
// row major, PS floats a row): out = part + slice*BN*PS + br*PS + ar, a =
// kept + ar*KS + d0, b = step + br*KS + d0.
template <class L>
__device__ __forceinline__ void score_partials(float* out, const float* a, const float* b) {
  float acc[L::TA][L::TB];
#pragma unroll
  for (int i = 0; i < L::TA; ++i) {
#pragma unroll
    for (int j = 0; j < L::TB; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < L::DS; d += 4) {
    float4 x[L::TA], y[L::TB];
#pragma unroll
    for (int i = 0; i < L::TA; ++i) x[i] = *reinterpret_cast<const float4*>(a + 8 * i * L::KS + d);
#pragma unroll
    for (int j = 0; j < L::TB; ++j) y[j] = *reinterpret_cast<const float4*>(b + 4 * j * L::KS + d);
#pragma unroll
    for (int i = 0; i < L::TA; ++i) {
#pragma unroll
      for (int j = 0; j < L::TB; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::TA; ++i) {
#pragma unroll
    for (int j = 0; j < L::TB; ++j) out[4 * j * L::PS + 8 * i] = acc[i][j];
  }
}

// The score at `at` (= step row * PS + kept row) of the tile: the NSL
// partials added in slice order.
template <class L>
__device__ __forceinline__ float partial_sum(const float* part, int at) {
  float t = part[at];
#pragma unroll
  for (int sl = 1; sl < L::NSL; ++sl) t += part[sl * L::BN * L::PS + at];
  return t;
}

// V consecutive floats from shared memory (16- or 8-byte aligned).
template <int V>
__device__ __forceinline__ void load_vec(float* x, const float* src) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    static_assert(V == 2, "2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x, x[1] = t.y;
  }
}

// acc[r][c] += w[r] * x[c] for one step row: w = the row's RT tile values
// at the thread's kept rows (tile + row*PS + tr*RT), x = its CT operand
// values at the thread's columns (operand + row*KS + tc*VEC).
template <class L>
__device__ __forceinline__ void fma_step(float (&acc)[L::RT][L::CT], const float* w_row,
                                         const float* x_row) {
  float w[L::RT], x[L::CT];
#pragma unroll
  for (int r = 0; r < L::RT; r += 4) load_vec<4>(w + r, w_row + r);
#pragma unroll
  for (int j = 0; j < L::NV; ++j) load_vec<L::VEC>(x + j * L::VEC, x_row + j * L::CG * L::VEC);
#pragma unroll
  for (int r = 0; r < L::RT; ++r) {
#pragma unroll
    for (int c = 0; c < L::CT; ++c) acc[r][c] = fmaf(w[r], x[c], acc[r][c]);
  }
}

// Butterfly reductions over W consecutive lanes: every lane of the group
// ends with the same value (each step adds two operands in either order,
// and f32 addition commutes).
template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Raises the kernel's dynamic shared memory limit to `bytes` (needed above 48 KB).
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace flash
