// Blocked flash-attention recompute backward for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernels avt_tpu/ops/flash_attention.py:_dq_kernel and
// _dkv_kernel, both launched by _flash_attention_bwd. On the port's main path
// it is the backward of AVT-h's attention (GPT-2, causal) over 128 or more
// observed features: (B, T, H, D) = (64, 256, 4, 512) in f32 for expts/02 at
// 256 s of context, (64, 128, 2, 1024) for expts/04, and (64, 256, 8, 64)
// non-causal for the Transformer aggregator. One entry point launches both
// kernels on the stream.
//
// Function, in the TPU kernels' order. From the forward's inputs, its
// logsumexp lse and delta = rowsum(dO . O) in f32 (computed by the caller, as
// _fa_bwd does):
//   q' = q * sm_scale                 rounded to the storage type
//   p  = exp(q' . k^T - lse)          recomputed, f32; masked scores -1e30
//   ds = p * (dO . v^T - delta)       f32
//   dq = (ds . k) * sm_scale          ds rounded to the storage type; the
//                                     scale an f32 here, as in _dq_kernel
//   dk = ds^T . q'                    ds rounded; q' gets no further scale
//   dv = p^T . dO                     p rounded
// Each result is accumulated in f32 and rounded once on store. Query rows
// past Tq contribute nothing; the causal mask is top-left (key j is kept for
// query i when j <= i) at Tq != Tk.
//
// Hopper runs blocks in no order, so nothing is summed across blocks: the dq
// side (flash_bwd_dq: one block per BM query rows, stepping over BN-row key
// tiles) owns its dq rows, and the dk/dv side (flash_bwd_dkv: one block per
// BM key rows, stepping over BN-row query tiles) owns its dk and dv rows. No
// atomics: the result has the same bits run to run. Both sides recompute the
// scores and dO . v^T: 7 products of T x T x D where the function needs 5,
// the price of no cross-block sum and no T x T matrix in device memory.
//
// Bound on the H100. 10*B*H*Tq*Tk*D operations for the 5 products (half
// when causal) over the bytes of q, k, v, dO, lse, delta, dq, dk, dv. At
// (64, 256, 4, 512) f32 causal: 43 GFLOP, 0.64 ms on the FMA units at 67
// TFLOP/s; as three TF32 products each on the tensor cores (495 TFLOP/s) the
// floor is 0.26 ms, below the 0.28 ms its 0.94 GB take at 3.35 TB/s. The
// FMA register tiles this replaces sat at ~30% of the FMA peak (2.89 ms
// there on an H100; 1.98x SDPA at D=64).
//
// Design. Both sides are one loop (`side`) with the roles of the operands
// swapped: a block keeps BM rows of two operands X1, X2 (dq side: q', dO;
// dk/dv side: K, V) in shared memory and steps over BN-row tiles of the other
// two, Y1, Y2 (K, V; q', dO). Per step:
//   1. S = X1 . Y1^T and dP = X2 . Y2^T (BM x BN, over D) on the tensor cores,
//      both in one loop. The 8 warps form RW row groups x CW column groups: a
//      warp owns MT m-tiles (16 rows) of the kept rows and a D/CW-wide slice
//      of D. At D >= 512 the dq and dk/dv accumulators of a tile fill the
//      registers (128 a thread on the dk/dv side), so the warps split D 8
//      ways; with few m- and n-tiles a warp then sums its k-steps into KS
//      interleaved accumulators, 8 independent mma chains to hide the mma's
//      latency.
//   2. p = exp(s - lse), ds = p * (dp - delta), each rounded to the storage
//      type. Where one warp spans D (D=64, CW = 1) the scores never leave
//      its registers: the accumulators are step 3's A fragments (f32: C's
//      {c0, c2, c1, c3}, tensor_core.cuh), no barrier. Otherwise the warps
//      store their partials, every thread adds an element's CW partials in
//      slice order (a fixed order, no atomics) and stores it as step 3's A
//      operand: in f32 already split into TF32 hi and lo planes, so that the
//      8 warps that read it do not split it again.
//   3. acc += W . Y on the tensor cores, the warp's rows x its D slice:
//      dq += ds . K (dq side); dv += p . dO and dk += ds . q' (dk/dv side).
// f32 runs each product as three TF32 products on mma.sync m16n8k8, lo.hi +
// hi.lo + hi.hi into one f32 accumulator, each operand split by
// split_tf32_rz (toward zero: ~2^-21 of |a||b| left, as f32 FMA chains
// leave): an AND and a subtraction a value, where splitting with cvt.rna
// held the first tensor-core form above the FMA tiles at D=512 (PERF.md).
// Each loaded fragment is split once and kept
// for every mma of the warp's tile that uses it. bf16 runs one mma.sync
// m16n8k16 per product with f32 accumulation: exact products, as before.
// Staging: every tile is copied by cp.async straight into padded shared rows
// (16 bytes of padding a row: conflict-free fragment loads). The step tiles
// are double-buffered: the next tile's rows arrive while this one computes.
// In f32 at D=1024 the kept rows alone take 128 KB, so there is one step
// buffer; each side then fetches a step operand as soon as it is done with
// it (dq side: V after step 1; dk/dv side: dO after dv). q' = q * sm_scale:
// the dq side scales its rows in shared memory once; the dk/dv side scales
// every step, f32 as the fragments load (the same f32 product), bf16 in
// shared memory (rounded to bf16 as load_rows rounds). At D=64 the f32
// blocks hold 16-row steps and 128 registers a thread, so two fit an SM.
// Registers and spills of every template are in chip_smoke.py's log (it
// fails if an f32 template at D=64, 512 or 1024 spills); times in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_bwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace flash;
using namespace tensor_core;

// The tiles of each side, by storage type and head dim (the note at the top).
template <typename T, int D>
struct BwdTiling {
  static constexpr bool kF32 = sizeof(T) == sizeof(float);
  static constexpr int CW = D == 64 ? 1 : D == 128 ? 2 : D == 256 ? 4 : 8;  // column groups
  static constexpr int RW = kWarps / CW;                                    // row groups
  static constexpr int MT = D == 512 ? 2 : 1;  // m-tiles of 16 kept rows a warp
  static constexpr int BM = 16 * MT * RW;      // kept rows: 128, 64, 32, 32, 16
  // step rows: as many as the shared memory holds beside the kept rows; at
  // D=64, 16, so that two f32 blocks (128 registers a thread) fit an SM
  static constexpr int BN = D == 64 ? 16
                            : kF32 ? (D == 128 ? 32 : D == 256 ? 16 : 8)
                                   : (D <= 256 ? 32 : 16);
  static constexpr int MIN_BLOCKS = D == 64 && kF32 ? 2 : 1;  // blocks an SM
  static constexpr int NBUF = kF32 && D == 1024 ? 1 : 2;  // step buffers
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
  // order at the end), so that a warp has 8 independent mma chains
  static constexpr int CHAINS = 2 * MT * (BN / 8);
  static constexpr int KS = kF32 && !kRegs && CHAINS < 8 ? 8 / CHAINS : 1;

  static_assert(RW * CW == kWarps && DW % 32 == 0 && BN % (kF32 ? 8 : 16) == 0, "tiles");
  static_assert((DW / 8) % KS == 0, "k-split");
};

// Byte offsets of a side's shared memory: X1, X2 (BM rows each), NBUF x (Y1,
// Y2) (BN rows each), the CW x (S, dP) partial score tiles, W (dq side: ds;
// dk/dv side: ds, p; f32 as hi and lo planes), then lse and delta.
template <typename T, int D, bool kDkv>
struct BwdSmem {
  using L = BwdTiling<T, D>;
  static constexpr int NW = kDkv ? 2 : 1;
  static constexpr size_t x = 0;
  static constexpr size_t y = x + sizeof(T) * 2 * L::BM * L::LD;
  static constexpr size_t part = y + sizeof(T) * L::NBUF * 2 * L::BN * L::LD;
  static constexpr size_t w = part + (L::kRegs ? 0 : sizeof(float) * L::CW * 2 * L::BM * L::LDP);
  static constexpr size_t w_plane = L::kRegs ? 0
                                    : L::kF32 ? sizeof(float) * L::BM * L::LDP
                                              : sizeof(T) * L::BM * L::LDW;
  static constexpr size_t w_p = w_plane * (L::kF32 ? 2 : 1);  // the p tile, after ds's
  static constexpr size_t stats = w + w_p * NW;
  static constexpr size_t bytes = stats + sizeof(float) * 2 * (kDkv ? L::BN : L::BM);
  static_assert(bytes <= kMaxSmem, "shared memory");
};

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

// In place on kRows staged rows: x = x * scale rounded to T, as load_rows
// scales q (q' of the function).
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

// Step 1 for one warp: c[0][mt][nt] = its partial S = X1 . Y1^T and c[1] =
// dP = X2 . Y2^T, summed over its slice of D. `x` is the warp's first kept
// row of X1 at the slice (X2's BM rows on), `y` the first step row of Y1 at
// the slice (Y2's BN rows on); Y1's values are multiplied by `y1_scale`
// where kScaleY1 (q' = q * sm_scale, exact in f32). Both products run in one
// loop, the k-steps in KS interleaved accumulators a product: independent
// mma chains to hide the mma's latency.
template <typename T, int D, bool kScaleY1>
__device__ __forceinline__ void scores(
    float (&c)[2][BwdTiling<T, D>::MT][BwdTiling<T, D>::BN / 8][4], const T* x, const T* y,
    float y1_scale, int lane) {
  using L = BwdTiling<T, D>;
  constexpr int MT = L::MT, NT = L::BN / 8, LD = L::LD, KS = L::KS;
  constexpr int XO = L::BM * LD, YO = L::BN * LD;  // X2 and Y2 from X1 and Y1
  float cs[KS][2][MT][NT][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
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
        Tf32Pair b[2][NT][2];  // the B fragments of the k-step, split once
#pragma unroll
        for (int o = 0; o < 2; ++o) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float b0, b1;
            load_b_nk<LD>(b0, b1, y + o * YO + n * 8 * LD, kk, lane);
            if (kScaleY1 && o == 0) b0 *= y1_scale, b1 *= y1_scale;
            b[o][n][0] = split_tf32_rz(b0);
            b[o][n][1] = split_tf32_rz(b1);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const FragA a = load_a_split<LD>(x + o * XO + m * 16 * LD, kk, lane);
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
      uint32_t b[2][NT][4];  // two k-steps of 16 a load
#pragma unroll
      for (int o = 0; o < 2; ++o) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ldmatrix_x4(b[o][n], y + o * YO + (n * 8 + (lane & 7)) * LD + kk * 32 + (lane >> 3) * 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int o = 0; o < 2; ++o) {
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
  for (int o = 0; o < 2; ++o) {
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
template <typename T, int D>
__device__ __forceinline__ void store_partials(
    float* dst, const float (&c)[BwdTiling<T, D>::MT][BwdTiling<T, D>::BN / 8][4], int row0,
    int g, int t) {
  using L = BwdTiling<T, D>;
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
template <typename T, int D>
__device__ __forceinline__ void store_w(void* plane, int at, float x) {
  using L = BwdTiling<T, D>;
  if constexpr (L::kF32) {
    const Tf32Pair s = split_tf32_rz(x);
    float* hi = static_cast<float*>(plane);
    hi[at] = __uint_as_float(s.hi);
    hi[L::BM * L::LDP + at] = __uint_as_float(s.lo);
  } else {
    static_cast<T*>(plane)[at] = from_float<T>(x);
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
template <typename T, int D, bool kScaleY, class GetA>
__device__ __forceinline__ void accumulate(
    float (&acc)[BwdTiling<T, D>::MT][BwdTiling<T, D>::DW / 8][4], GetA get_a, const T* yc,
    float y_scale, int lane) {
  using L = BwdTiling<T, D>;
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
template <typename T, int D>
struct SharedA {
  const void* w;
  int wrow, lane;
  __device__ void operator()(int kk, int m, FragA& a) const {
    using L = BwdTiling<T, D>;
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
      ldmatrix_x4(a.hi, static_cast<const T*>(w) + (wrow + m * 16 + (lane & 15)) * L::LDW +
                            kk * 16 + (lane >> 4) * 8);
    }
  }
};

// get_a for a tile the warp holds in its registers in the C layout of step
// 1 (w[mt][nt], values already rounded to T).
template <typename T, int D>
struct RegisterA {
  const float (&w)[BwdTiling<T, D>::MT][BwdTiling<T, D>::BN / 8][4];
  __device__ void operator()(int kk, int m, FragA& a) const {
    if constexpr (BwdTiling<T, D>::kF32) {  // C's {c0, c2, c1, c3} (tensor_core.cuh: acc_as_a)
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

// One side (the note at the top). kDkv = false: the dq side, kept rows are
// queries (X1 = q', X2 = dO), steps over keys (Y1 = K, Y2 = V), out0 = dq
// scaled by out_scale. kDkv = true: kept rows are keys (K, V), steps over
// queries (q', dO), out0 = dk, out1 = dv.
template <typename T, int D, bool kDkv>
__device__ __forceinline__ void side(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const T* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, T* __restrict__ out0,
                                     T* __restrict__ out1, View qv, View kv, View vv, View dov,
                                     Geometry g, int tiles, float q_scale, float out_scale) {
  using L = BwdTiling<T, D>;
  using S = BwdSmem<T, D, kDkv>;
  constexpr int BM = L::BM, BN = L::BN, LD = L::LD, LDP = L::LDP, MT = L::MT, DW = L::DW;
  constexpr int NACC = kDkv ? 2 : 1;
  // f32 q' on the dk/dv side: scaled as its fragments load; bf16: in place
  constexpr bool kFold = kDkv && L::kF32;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* x_s = reinterpret_cast<T*>(base + S::x);            // X1 rows, then X2 rows
  T* y_s = reinterpret_cast<T*>(base + S::y);            // per buffer: Y1 rows, then Y2 rows
  float* part = reinterpret_cast<float*>(base + S::part);  // [slice][S, dP][BM][LDP]
  char* w_s = base + S::w;                                // [ds, p] tiles
  float* lse_s = reinterpret_cast<float*>(base + S::stats);
  float* delta_s = lse_s + (kDkv ? BN : BM);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int rw = warp / L::CW, cw = warp % L::CW, wrow = rw * MT * 16, d0 = cw * DW;
  const int bh = blockIdx.x / tiles, r0 = (blockIdx.x % tiles) * BM;
  const int b = bh / g.H, h = bh % g.H;
  const T* qb = q + b * qv.sb + h * D;
  const T* kb = k + b * kv.sb + h * D;
  const T* vb = v + b * vv.sb + h * D;
  const T* dob = dout + b * dov.sb + h * D;
  const T* x1 = kDkv ? kb : qb;
  const T* x2 = kDkv ? vb : dob;
  const T* y1 = kDkv ? qb : kb;
  const T* y2 = kDkv ? dob : vb;
  const long long x1st = kDkv ? kv.st : qv.st, x2st = kDkv ? vv.st : dov.st;
  const long long y1st = kDkv ? qv.st : kv.st, y2st = kDkv ? dov.st : vv.st;
  const int n_kept = kDkv ? g.Tk : g.Tq, n_step = kDkv ? g.Tq : g.Tk;
  // causal: the dq side's keys end at its last query; the dk/dv side's
  // query tiles that end before its first key see none of its keys
  const int s_begin = kDkv && g.causal ? (r0 / BN) * BN : 0;
  const int s_end = !kDkv && g.causal ? min(n_step, r0 + BM) : n_step;

  stage_rows<T, D, BM, LD>(x_s, x1, x1st, r0, n_kept);
  stage_rows<T, D, BM, LD>(x_s + BM * LD, x2, x2st, r0, n_kept);
  stage_rows<T, D, BN, LD>(y_s, y1, y1st, s_begin, n_step);
  stage_rows<T, D, BN, LD>(y_s + BN * LD, y2, y2st, s_begin, n_step);
  commit_copies();
  if (!kDkv && tid < BM) {
    const int qpos = r0 + tid;
    const bool real = qpos < g.Tq;
    lse_s[tid] = real ? lse[(long long)bh * g.Tq + qpos] : 0.f;
    delta_s[tid] = real ? delta[(long long)bh * g.Tq + qpos] : 0.f;
  }
  if constexpr (!kDkv) {
    wait_copies();
    __syncthreads();
    scale_rows<T, D, BM, LD>(x_s, q_scale);  // q'
  }

  float acc[NACC][MT][DW / 8][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < DW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][m][n][e] = 0.f;
      }
    }
  }

  int buf = 0;
  for (int s0 = s_begin; s0 < s_end; s0 += BN) {
    T* y1_s = y_s + buf * 2 * BN * LD;
    T* y2_s = y1_s + BN * LD;
    const bool more = s0 + BN < s_end;
    wait_copies();
    __syncthreads();  // this step's rows are in; every warp is done with the last step
    if constexpr (L::NBUF == 2) {
      if (more) {  // the next tile arrives while this one computes
        T* next = y_s + (buf ^ 1) * 2 * BN * LD;
        stage_rows<T, D, BN, LD>(next, y1, y1st, s0 + BN, n_step);
        stage_rows<T, D, BN, LD>(next + BN * LD, y2, y2st, s0 + BN, n_step);
        commit_copies();
      }
    }
    if constexpr (kDkv) {
      if (tid < BN) {
        const int qpos = s0 + tid;
        const bool real = qpos < g.Tq;
        lse_s[tid] = real ? lse[(long long)bh * g.Tq + qpos] : 0.f;
        delta_s[tid] = real ? delta[(long long)bh * g.Tq + qpos] : 0.f;
      }
      if constexpr (!kFold) scale_rows<T, D, BN, LD>(y1_s, q_scale);  // q'
      if constexpr (!kFold || L::kRegs) __syncthreads();  // q', lse and delta are in
    }

    // 1. the warp's partial scores S = X1 . Y1^T and dP = X2 . Y2^T
    float c[2][MT][BN / 8][4];
    scores<T, D, kFold>(c, x_s + wrow * LD + d0, y1_s + d0, q_scale, lane);
    if constexpr (L::kRegs) {
      // 2. p and ds in the warp's registers, in place of S and dP
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = wrow + m * 16 + g8 + (e >= 2 ? 8 : 0), j = n * 8 + 2 * t4 + (e & 1);
            const int qpos = kDkv ? s0 + j : r0 + i, kpos = kDkv ? r0 + i : s0 + j;
            const int si = kDkv ? j : i;
            const bool keep = qpos < g.Tq && kpos < g.Tk && (!g.causal || kpos <= qpos);
            const float pr = keep ? expf(c[0][m][n][e] - lse_s[si]) : 0.f;
            c[1][m][n][e] = round_to<T>(pr * (c[1][m][n][e] - delta_s[si]));
            c[0][m][n][e] = round_to<T>(pr);
          }
        }
      }
      // 3. dq += ds . K; dv += p . dO and dk += ds . q'
      if constexpr (kDkv) {
        accumulate<T, D, false>(acc[1], RegisterA<T, D>{c[0]}, y2_s + d0, 1.f, lane);
        accumulate<T, D, kFold>(acc[0], RegisterA<T, D>{c[1]}, y1_s + d0, q_scale, lane);
      } else {
        accumulate<T, D, false>(acc[0], RegisterA<T, D>{c[1]}, y1_s + d0, 1.f, lane);
      }
    } else {
      store_partials<T, D>(part + (2 * cw) * BM * LDP, c[0], wrow, g8, t4);
      store_partials<T, D>(part + (2 * cw + 1) * BM * LDP, c[1], wrow, g8, t4);
      __syncthreads();  // the partials are in; Y2 is read on the dq side
      if constexpr (L::NBUF == 1) {
        if (!kDkv && more) {  // the next V comes in while ds and dq are formed
          stage_rows<T, D, BN, LD>(y2_s, y2, y2st, s0 + BN, n_step);
          commit_copies();
        }
      }

      // 2. p and ds from the partials added in slice order, into W
#pragma unroll
      for (int m = 0; m < L::EPT; ++m) {
        const int e = tid + m * kThreads;
        if (e < BM * BN) {
          const int i = e / BN, j = e % BN, at = i * LDP + j;
          float s = part[at], dp = part[BM * LDP + at];
#pragma unroll
          for (int sl = 1; sl < L::CW; ++sl) {
            s += part[2 * sl * BM * LDP + at];
            dp += part[(2 * sl + 1) * BM * LDP + at];
          }
          const int qpos = kDkv ? s0 + j : r0 + i, kpos = kDkv ? r0 + i : s0 + j;
          const int si = kDkv ? j : i;
          const bool keep = qpos < g.Tq && kpos < g.Tk && (!g.causal || kpos <= qpos);
          const float pr = keep ? expf(s - lse_s[si]) : 0.f;
          const int wat = L::kF32 ? at : i * L::LDW + j;
          store_w<T, D>(w_s, wat, round_to<T>(pr * (dp - delta_s[si])));
          if constexpr (kDkv) store_w<T, D>(w_s + S::w_p, wat, round_to<T>(pr));
        }
      }
      __syncthreads();  // W is in

      // 3. dq += ds . K; dv += p . dO and dk += ds . q'
      if constexpr (kDkv) {
        accumulate<T, D, false>(acc[1], SharedA<T, D>{w_s + S::w_p, wrow, lane}, y2_s + d0, 1.f,
                                lane);
        if constexpr (L::NBUF == 1) {
          if (more) {  // dO is done with: the next comes in while dk is formed
            __syncthreads();
            stage_rows<T, D, BN, LD>(y2_s, y2, y2st, s0 + BN, n_step);
            commit_copies();
          }
        }
        accumulate<T, D, kFold>(acc[0], SharedA<T, D>{w_s, wrow, lane}, y1_s + d0, q_scale,
                                lane);
      } else {
        accumulate<T, D, false>(acc[0], SharedA<T, D>{w_s, wrow, lane}, y1_s + d0, 1.f, lane);
      }
    }
    if constexpr (L::NBUF == 1) {
      if (more) {  // Y1's buffer is free once every warp is done with it
        __syncthreads();
        stage_rows<T, D, BN, LD>(y1_s, y1, y1st, s0 + BN, n_step);
        commit_copies();
      }
    } else {
      buf ^= 1;
    }
  }

  // results: rows r0 + wrow + 16m + g (+8), columns d0 + 8n + 2t (+1)
  const int n_rows = kDkv ? g.Tk : g.Tq;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    T* out = a == 0 ? out0 : out1;
    const float scale = kDkv ? 1.f : out_scale;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wrow + m * 16 + g8 + 8 * half;
        if (row >= n_rows) continue;
        T* p = out + ((long long)(b * n_rows + row) * g.H + h) * D + d0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
          store2(p + n * 8, acc[a][m][n][2 * half] * scale, acc[a][m][n][2 * half + 1] * scale);
      }
    }
  }
}

// dq for BM query rows; steps over BN-row key tiles (the note at the top).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, BwdTiling<T, D>::MIN_BLOCKS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, View qv, View kv, View vv,
             View dov, Geometry g, int q_tiles, float q_scale, float dq_scale) {
  side<T, D, false>(q, k, v, dout, lse, delta, dq, nullptr, qv, kv, vv, dov, g, q_tiles, q_scale,
                    dq_scale);
}

// dk and dv for BM key rows; steps over BN-row query tiles (the note at the top).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, BwdTiling<T, D>::MIN_BLOCKS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              View qv, View kv, View vv, View dov, Geometry g, int k_tiles, float q_scale) {
  side<T, D, true>(q, k, v, dout, lse, delta, dk, dv, qv, kv, vv, dov, g, k_tiles, q_scale, 1.f);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  View qv, kv, vv, dov;
  Geometry g;
  float q_scale, dq_scale;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BM = BwdTiling<T, D>::BM;  // query rows of the dq side, key rows of the dk/dv side
  const int q_tiles = (a.g.Tq + BM - 1) / BM, k_tiles = (a.g.Tk + BM - 1) / BM;
  const unsigned heads = unsigned(a.g.B) * a.g.H;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  constexpr size_t dq_smem = BwdSmem<T, D, false>::bytes, dkv_smem = BwdSmem<T, D, true>::bytes;
  cudaError_t err = set_smem(flash_bwd_dq<T, D>, dq_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, D><<<dim3(q_tiles * heads), kThreads, dq_smem, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.qv, a.kv, a.vv, a.dov, a.g,
      q_tiles, a.q_scale, a.dq_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(flash_bwd_dkv<T, D>, dkv_smem)) != cudaSuccess) return err;
  flash_bwd_dkv<T, D><<<dim3(k_tiles * heads), kThreads, dkv_smem, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qv, a.kv,
      a.vv, a.dov, a.g, k_tiles, a.q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    case 512: return launch<T, 512>(a, stream);
    case 1024: return launch<T, 1024>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout (B, Tq, H, D) and k, v (B, Tk, H, D): last two axes contiguous,
// batch and sequence strides in elements, rows 16-byte aligned. lse and delta
// (B, H, Tq) f32 contiguous. dq (B, Tq, H, D), dk and dv (B, Tk, H, D)
// contiguous in the storage type. is_bf16 selects bf16 (1) or f32 (0); D is
// 64, 128, 256, 512 or 1024; q_scale is 1/sqrt(D) rounded to the storage type,
// dq_scale the same in f32. Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                        int B, int H, int Tq, int Tk, int D, int is_bf16, int causal,
                        long long q_sb, long long q_st, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, long long do_sb, long long do_st,
                        float q_scale, float dq_scale, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, dk, dv,
               View{q_sb, q_st}, View{k_sb, k_st}, View{v_sb, v_st}, View{do_sb, do_st},
               Geometry{B, H, Tq, Tk, causal}, q_scale, dq_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return int(dispatch<__nv_bfloat16>(D, a, s));
  return int(dispatch<float>(D, a, s));
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
