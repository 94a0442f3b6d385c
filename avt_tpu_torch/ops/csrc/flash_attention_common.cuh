// Shared pieces of the blocked flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu (the forward) and flash_attention_bwd.cu (the
// recompute backward, two kernels). All three run on one tiling (Tiling
// below) and one pair of product loops on the tensor cores.
//
// Layout. q, k, v and dO are (B, T, H, D) views whose last two axes are
// contiguous (head stride D, element stride 1); the batch and sequence strides
// are passed in, so the views of a fused qkv projection (B, T, 3*H*D) are read
// in place. Every output is a contiguous (B, T, H, D) tensor; lse and delta
// are contiguous (B, H, T) f32.
//
// Arithmetic. Every product runs on mma.sync (tensor_core.cuh). bf16: one
// m16n8k16 with f32 accumulation, exact products, as the TPU's bf16 matrix
// unit with f32 accumulation gives. f32: three TF32 products on m16n8k8,
// lo.hi + hi.lo + hi.hi into one f32 accumulator, each operand split by
// split_tf32_rz (hi = x with its 13 low bits cleared, lo = x - hi passed
// whole: ~2^-21 of |a||b| left, as f32 FMA chains leave; one TF32 product
// would leave ~2^-11). Values are rounded to the storage type exactly where
// the TPU kernels cast them (round_to below).
//
// Work split. A block is 8 warps. It keeps BM rows of one or two operands
// (the kept rows) in shared memory and steps over BN-row tiles of the others
// (the step rows). The warps form RW row groups x CW column groups: a warp
// owns MT m-tiles (16 rows) of the kept rows and a DW = D/CW wide slice of D.
//   Step 1 (scores): the warp's BM/RW x BN partial scores, X . Y^T over its
//   slice of D (NP products in one loop: the forward's S; the backward's S
//   and dP). With few m- and n-tiles a warp sums its k-steps into KS
//   interleaved accumulators: independent mma chains hide the mma latency.
//   Where one warp spans D (CW = 1) the scores stay in its registers and
//   become step 3's A fragments there (RegisterA: f32 as C's {c0, c2, c1,
//   c3}, tensor_core.cuh). Otherwise the warps store their partials
//   (store_partials) and whoever forms a score adds its CW partials in slice
//   order: a fixed order, no atomics, the same bits run to run; the result
//   goes to shared memory as step 3's A operand (store_w), in f32 already
//   split into hi and lo planes, so that the 8 warps reading it do not split
//   it again (SharedA).
//   Step 3 (accumulate): acc += W . Y, the warp's rows x its slice of D.
// Staging: every tile is copied by cp.async straight into padded shared rows
// (16 bytes of padding a row: conflict-free fragment loads). No T x T
// matrix reaches device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace flash {

using namespace tensor_core;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF for masked scores
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block can have

// The tiles of one flash kernel (the note at the top), by storage type and
// head dim: kFwd for the forward (keeps q', steps over K and V), else for
// either side of the backward (keeps two operands, steps over two).
template <typename T, int D, bool kFwd>
struct Tiling {
  using Elem = T;
  static constexpr bool kF32 = sizeof(T) == sizeof(float);
  static constexpr int NP = kFwd ? 1 : 2;  // step-1 products: S; or S and dP
  static constexpr int CW = D == 64 ? 1 : D == 128 ? 2 : D == 256 ? 4 : 8;  // column groups
  static constexpr int RW = kWarps / CW;                                    // row groups
  static constexpr int MT = D == 512 ? 2 : 1;  // m-tiles of 16 kept rows a warp
  static constexpr int BM = 16 * MT * RW;      // kept rows: 128, 64, 32, 32, 16
  // the forward at one row group (D >= 512): each warp alone reads its
  // slice of D of the step rows, so it stages that slice itself, in one
  // buffer, each operand as soon as it is done with it (no block barrier)
  static constexpr bool kOwnSlice = kFwd && RW == 1;
  // step rows: as many as the shared memory holds beside the kept rows; at
  // D=64, 16 in the backward, so that two f32 blocks (128 registers a
  // thread) fit an SM, 32 in the forward (one operand kept)
  static constexpr int BN = D == 64 ? (kFwd ? 32 : 16)
                            : kOwnSlice ? (!kF32 ? 32 : D == 512 ? 16 : 8)
                            : kF32 ? (D == 128 ? 32 : D == 256 ? 16 : 8)
                                   : (D <= 256 ? 32 : 16);
  static constexpr int MIN_BLOCKS = D == 64 && kF32 ? 2 : 1;  // blocks an SM
  static constexpr int NBUF = kOwnSlice || (kF32 && D == 1024) ? 1 : 2;  // step buffers
  static constexpr int DW = D / CW;                       // a warp's slice of D
  static constexpr int LD = D + 16 / int(sizeof(T));      // elements a staged row
  // floats a row of a score tile and of an f32 W plane (a stride of 8 or 24
  // words mod 32: a half-warp's float2 accesses hit distinct banks), bf16 a
  // row of a bf16 W tile (12 or 20 words: ldmatrix's 8 rows hit distinct
  // 16-byte bank groups)
  static constexpr int LDP = BN % 32 == 8 ? BN : BN + 8;
  static constexpr int LDW = BN + 8;
  static constexpr int EPT = (BM * BN + kThreads - 1) / kThreads;  // elements a thread in step 2
  // one warp spans D: the scores stay in its registers and become step 3's
  // A fragments there (no partial tiles, no W tile)
  static constexpr bool kRegs = CW == 1;
  // f32 step 1 sums its k-steps into KS accumulators a product (added in
  // order at the end), so that a warp has 8 independent mma chains; at most
  // 4 in the forward (at D=1024 8 took 26 more registers a thread and ran
  // 3% slower)
  static constexpr int CHAINS = NP * MT * (BN / 8);
  static constexpr int KS = !kF32 || kRegs || CHAINS >= 8 ? 1
                            : kFwd && CHAINS == 1 ? 4 : 8 / CHAINS;

  static_assert(RW * CW == kWarps && DW % 32 == 0 && BN % (kF32 ? 8 : 16) == 0, "tiles");
  static_assert((DW / 8) % KS == 0, "k-split");
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

// One 16-byte cp.async copy from device to shared memory; bytes = 0 writes
// zeros. commit_copies closes a group of them; wait_copies<N> waits until
// at most the N newest groups are still in flight.
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  const unsigned to = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N = 0>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + kRows) of one head's (T, D) slice `src` (rows `stride`
// elements apart) into shared rows of LD elements by cp.async, 16 bytes a
// copy; rows at or past `valid` are zero-filled. The caller commits.
template <typename T, int D, int kRows, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long stride,
                                           int row0, int valid) {
  constexpr int V = 16 / sizeof(T), VPR = D / V;
  for (int i = threadIdx.x; i < kRows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    const bool in = row0 + r < valid;
    copy16(reinterpret_cast<float*>(dst + r * LD + c),
           reinterpret_cast<const float*>(in ? src + (row0 + r) * stride + c : src), in ? 16 : 0);
  }
}

// In place on kRows staged rows: x = x * scale rounded to T (q' of the
// function, as the TPU kernels' `q_ref[...] * sm_scale`).
template <typename T, int D, int kRows, int LD>
__device__ __forceinline__ void scale_rows(T* rows, float scale) {
  constexpr int V = 16 / sizeof(T), VPR = D / V;
  for (int i = threadIdx.x; i < kRows * VPR; i += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(rows + (i / VPR) * LD + (i % VPR) * V);
    float x[V];
    to_floats(*p, x, T());
    uint4 out;
    if constexpr (sizeof(T) == sizeof(float)) {
      out = make_uint4(__float_as_uint(x[0] * scale), __float_as_uint(x[1] * scale),
                       __float_as_uint(x[2] * scale), __float_as_uint(x[3] * scale));
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < V / 2; ++e)
        h[e] = __floats2bfloat162_rn(x[2 * e] * scale, x[2 * e + 1] * scale);
    }
    *p = out;
  }
}

// An A fragment of columns [8kk, 8kk + 8) of 16 shared f32 rows, as
// load_a_f32 loads it, split by split_tf32_rz.
template <int LD>
__device__ __forceinline__ FragA load_a_split(const float* rows, int kk, int lane) {
  float a[4];
  ldmatrix_x4(a, rows + ((lane & 7) + (lane & 8)) * LD + (lane >> 4) * 4 + kk * 8);
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32Pair s = split_tf32_rz(a[e]);
    f.hi[e] = s.hi;
    f.lo[e] = s.lo;
  }
  return f;
}

// The same fragment from rows already split: hi at `rows`, lo `lo_at`
// floats on (the same bits as load_a_split, without its arithmetic).
template <int LD>
__device__ __forceinline__ FragA load_a_planes(const float* rows, int lo_at, int kk, int lane) {
  const float* p = rows + ((lane & 7) + (lane & 8)) * LD + (lane >> 4) * 4 + kk * 8;
  float hi[4], lo[4];
  ldmatrix_x4(hi, p);
  ldmatrix_x4(lo, p + lo_at);
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f.hi[e] = __float_as_uint(hi[e]);
    f.lo[e] = __float_as_uint(lo[e]);
  }
  return f;
}

// Step 1 for one warp: c[o][mt][nt] = its partial X_o . Y_o^T for the NP
// products, summed over its slice of D. `x` is the warp's first kept row of
// X_0 at the slice (X_1's BM rows on), `y` the first step row of Y_0 at the
// slice (Y_1's BN rows on); Y_0's values are multiplied by `y0_scale` where
// kScaleY0 (q' = q * sm_scale, exact in f32). kSplitX (f32, NP = 1): X_0 is
// kept split, its hi plane at `x` and its lo plane BM rows on. The products
// run in one loop, the k-steps in KS interleaved accumulators a product:
// independent mma chains to hide the mma's latency.
template <class L, bool kScaleY0, bool kSplitX>
__device__ __forceinline__ void scores(float (&c)[L::NP][L::MT][L::BN / 8][4],
                                       const typename L::Elem* x, const typename L::Elem* y,
                                       float y0_scale, int lane) {
  constexpr int NP = L::NP, MT = L::MT, NT = L::BN / 8, LD = L::LD, KS = L::KS;
  constexpr int XO = L::BM * LD, YO = L::BN * LD;  // X_1 and Y_1 from X_0 and Y_0
  static_assert(!kSplitX || (L::kF32 && NP == 1), "split kept rows: f32, one product");
  float cs[KS][NP][MT][NT][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int o = 0; o < NP; ++o) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[s][o][m][n][e] = 0.f;
        }
      }
    }
  }
  if constexpr (L::kF32) {
#pragma unroll 2
    for (int k0 = 0; k0 < L::DW / 8; k0 += KS) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int kk = k0 + s;
        Tf32Pair b[NP][NT][2];  // the B fragments of the k-step, split once
#pragma unroll
        for (int o = 0; o < NP; ++o) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float b0, b1;
            load_b_nk<LD>(b0, b1, y + o * YO + n * 8 * LD, kk, lane);
            if (kScaleY0 && o == 0) b0 *= y0_scale, b1 *= y0_scale;
            b[o][n][0] = split_tf32_rz(b0);
            b[o][n][1] = split_tf32_rz(b1);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int o = 0; o < NP; ++o) {
            FragA a;
            if constexpr (kSplitX) a = load_a_planes<LD>(x + m * 16 * LD, XO, kk, lane);
            else a = load_a_split<LD>(x + o * XO + m * 16 * LD, kk, lane);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              float(&acc)[4] = cs[s][o][m][n];
              mma_1688(acc, a.lo, b[o][n][0].hi, b[o][n][1].hi);
              mma_1688(acc, a.hi, b[o][n][0].lo, b[o][n][1].lo);
              mma_1688(acc, a.hi, b[o][n][0].hi, b[o][n][1].hi);
            }
          }
        }
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < L::DW / 32; ++kk) {
      uint32_t b[NP][NT][4];  // two k-steps of 16 a load
#pragma unroll
      for (int o = 0; o < NP; ++o) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ldmatrix_x4(b[o][n], y + o * YO + (n * 8 + (lane & 7)) * LD + kk * 32 + (lane >> 3) * 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int o = 0; o < NP; ++o) {
            uint32_t a[4];
            ldmatrix_x4(a, x + o * XO + (m * 16 + (lane & 15)) * LD + kk * 32 + hh * 16 +
                               (lane >> 4) * 8);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_16816(cs[0][o][m][n], a, b[o][n][2 * hh], b[o][n][2 * hh + 1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < NP; ++o) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t = cs[0][o][m][n][e];
#pragma unroll
          for (int s = 1; s < KS; ++s) t += cs[s][o][m][n][e];
          c[o][m][n][e] = t;
        }
      }
    }
  }
}

// The warp's partial scores into its slot of the partial tiles ([row][LDP]).
template <class L>
__device__ __forceinline__ void store_partials(float* dst,
                                               const float (&c)[L::MT][L::BN / 8][4], int row0,
                                               int g, int t) {
#pragma unroll
  for (int m = 0; m < L::MT; ++m) {
#pragma unroll
    for (int n = 0; n < L::BN / 8; ++n) {
      float* p = dst + (row0 + m * 16 + g) * L::LDP + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(c[m][n][0], c[m][n][1]);
      *reinterpret_cast<float2*>(p + 8 * L::LDP) = make_float2(c[m][n][2], c[m][n][3]);
    }
  }
}

// One element of W (the A operand of step 3), from its value rounded to T:
// f32 as TF32 hi and lo in two planes, bf16 as it is.
template <class L>
__device__ __forceinline__ void store_w(void* plane, int at, float x) {
  if constexpr (L::kF32) {
    const Tf32Pair s = split_tf32_rz(x);
    float* hi = static_cast<float*>(plane);
    hi[at] = __uint_as_float(s.hi);
    hi[L::BM * L::LDP + at] = __uint_as_float(s.lo);
  } else {
    static_cast<typename L::Elem*>(plane)[at] = from_float<typename L::Elem>(x);
  }
}

// Two values of a result row into device memory, rounded once to T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Two floats as one register of two bf16, the lower index in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Step 3 for one warp: acc[mt][nt] += W (the warp's rows x BN) . Y (BN x its
// slice of D), `yc` the step rows at the slice, their values multiplied by
// `y_scale` where kScaleY (f32). get_a(kk, m, a) gives the A fragment of
// m-tile m over k-step kk: in f32 split, its k index t read as column 2t and
// t + 4 as 2t + 1 (the row order of load_b_kn); in bf16 the m16n8k16
// fragment in a.hi.
template <class L, bool kScaleY, class GetA>
__device__ __forceinline__ void accumulate(float (&acc)[L::MT][L::DW / 8][4], GetA get_a,
                                           const typename L::Elem* yc, float y_scale, int lane) {
  constexpr int MT = L::MT, NT = L::DW / 8, LD = L::LD;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (L::kF32) {
#pragma unroll
    for (int kk = 0; kk < L::BN / 8; ++kk) {
      FragA a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) get_a(kk, m, a[m]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float b0, b1;
        load_b_kn<LD>(b0, b1, yc + kk * 8 * LD, n * 8, g, t);
        if (kScaleY) b0 *= y_scale, b1 *= y_scale;
        const Tf32Pair x = split_tf32_rz(b0), y = split_tf32_rz(b1);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_1688(acc[m][n], a[m].lo, x.hi, y.hi);
          mma_1688(acc[m][n], a[m].hi, x.lo, y.lo);
          mma_1688(acc[m][n], a[m].hi, x.hi, y.hi);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < L::BN / 16; ++kk) {
      FragA a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) get_a(kk, m, a[m]);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];  // two n-tiles of 8 a load
        ldmatrix_x4_trans(b, yc + (kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_16816(acc[m][n], a[m].hi, b[0], b[1]);
          mma_16816(acc[m][n + 1], a[m].hi, b[2], b[3]);
        }
      }
    }
  }
}

// get_a for a W tile in shared memory: `w` the tile (f32: the hi plane, lo
// BM * LDP floats on), `wrow` the warp's first row in it.
template <class L>
struct SharedA {
  const void* w;
  int wrow, lane;
  __device__ void operator()(int kk, int m, FragA& a) const {
    if constexpr (L::kF32) {
      const float* hi = static_cast<const float*>(w);
      const float* lo = hi + L::BM * L::LDP;
      const int at = (wrow + m * 16 + (lane >> 2)) * L::LDP + kk * 8 + 2 * (lane & 3);
      const float2 h0 = *reinterpret_cast<const float2*>(hi + at);
      const float2 h1 = *reinterpret_cast<const float2*>(hi + at + 8 * L::LDP);
      const float2 l0 = *reinterpret_cast<const float2*>(lo + at);
      const float2 l1 = *reinterpret_cast<const float2*>(lo + at + 8 * L::LDP);
      a.hi[0] = __float_as_uint(h0.x), a.hi[1] = __float_as_uint(h1.x);
      a.hi[2] = __float_as_uint(h0.y), a.hi[3] = __float_as_uint(h1.y);
      a.lo[0] = __float_as_uint(l0.x), a.lo[1] = __float_as_uint(l1.x);
      a.lo[2] = __float_as_uint(l0.y), a.lo[3] = __float_as_uint(l1.y);
    } else {
      ldmatrix_x4(a.hi, static_cast<const typename L::Elem*>(w) +
                            (wrow + m * 16 + (lane & 15)) * L::LDW + kk * 16 + (lane >> 4) * 8);
    }
  }
};

// get_a for a tile the warp holds in its registers in the C layout of step
// 1 (w[mt][nt], values already rounded to T).
template <class L>
struct RegisterA {
  const float (&w)[L::MT][L::BN / 8][4];
  __device__ void operator()(int kk, int m, FragA& a) const {
    if constexpr (L::kF32) {  // C's {c0, c2, c1, c3} (tensor_core.cuh: acc_as_a)
      const float(&c)[4] = w[m][kk];
      const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Tf32Pair s = split_tf32_rz(x[e]);
        a.hi[e] = s.hi;
        a.lo[e] = s.lo;
      }
    } else {  // n-tiles 2kk and 2kk + 1 are the two k halves of the fragment
      const float(&c0)[4] = w[m][2 * kk];
      const float(&c1)[4] = w[m][2 * kk + 1];
      a.hi[0] = bf16x2(c0[0], c0[1]), a.hi[1] = bf16x2(c0[2], c0[3]);
      a.hi[2] = bf16x2(c1[0], c1[1]), a.hi[3] = bf16x2(c1[2], c1[3]);
    }
  }
};

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
