// Blocked flash-attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel avt_tpu/ops/flash_attention.py:_flash_kernel,
// launched by _flash_attention_fwd. On the port's main path it is the
// attention of AVT-h (GPT-2, causal) over 128 or more observed features:
// (B, T, H, D) = (64, 256, 4, 512) in f32 for expts/02 at 256 s of context,
// (64, 128, 2, 1024) for expts/04, and (64, 256, 8, 64) non-causal for the
// Transformer aggregator.
//
// Function, in the TPU kernel's order:
//   q' = q * sm_scale                 rounded to the storage type (the scale
//                                     is passed rounded to it too: a Python
//                                     float takes q's dtype in JAX)
//   s  = q' . k^T                     f32; keys >= Tk and, if causal, keys
//                                     after the query get -1e30 (top-left
//                                     at Tq != Tk)
//   online softmax over key tiles:    m' = max(m, rowmax s), p = exp(s - m'),
//                                     l = l * exp(m - m') + rowsum p,
//                                     acc = acc * exp(m - m') + p . v with p
//                                     rounded to the storage type
//   out = acc / max(l, 1e-30)         rounded once on store
//   lse = m + log(max(l, 1e-30))      f32, written only when lse != NULL
// The TPU kernel steps over 128 keys, this one over BN (16 at D=512 in f32,
// 8 at D=1024): p is formed against another running max, which moves the
// bf16 rounding of p, not the result.
//
// Bound on the H100. 4*B*H*Tq*Tk*D operations (the unmasked pairs: about
// half when causal) over the bytes of q, k, v, out and lse. At (64, 256, 4,
// 512) f32 causal: 17.25 GFLOP, 0.2574 ms on the FMA units at 67 TFLOP/s;
// as three TF32 products each on the tensor cores (495 TFLOP/s) 0.1045 ms,
// under the 0.1603 ms its 537 MB take at 3.35 TB/s: the floor is the bytes.
// (64, 128, 2, 1024) causal: FMA 0.0646, TF32 0.0262, bytes 0.0801 ms;
// (64, 256, 8, 64) non-causal: FMA 0.1282, TF32 0.0521, bytes 0.0401 ms;
// bf16 at (64, 256, 4, 512): 0.0174 ms of operations, 0.0802 of bytes.
// The FMA register tiles this replaces ran at 29% of the FMA peak (0.8812
// ms at D=512 f32, 0.8617 in bf16, on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): 3.4x and 10.7x their bounds, slower than SDPA.
//
// Design: the backward's tiling and product loops (flash_attention_common.cuh)
// with one operand kept. A block keeps BM rows of q' and steps over BN-row
// tiles of K and V. What holds such a kernel back on this card is feeding
// the tensor cores: fragment loads from shared memory, the f32 split and the
// block barriers, at one block an SM for D >= 128. So:
//   - q' is scaled and, in f32, split into TF32 hi and lo planes once, when
//     its rows arrive: every key tile reads them as two ldmatrix a fragment
//     with no arithmetic (at D=512, 32 rows take 132 KB as two planes).
//   - K and V tiles come by cp.async into padded rows, so that the next
//     tile arrives while this one computes: at D <= 256 double-buffered, by
//     the block. At D >= 512 a warp owns a slice of D of all BM rows, so it
//     alone reads that slice of K and V: each warp stages its own slices,
//     the next K's as soon as its step 1 is done with K, the next V's as
//     soon as its step 3 is done with V, and waits for them only where it
//     reads them, in one buffer (f32 at D=1024 leaves room for no more) and
//     with no block barrier: two barriers a tile, 16 keys a tile at D=512
//     in f32, 32 in bf16.
// Per key tile:
//   1. S = q' . K^T on the tensor cores, the warp's rows x BN over its slice
//      of D (the k-steps in interleaved accumulators where the warp has few
//      mma chains).
//   2. The online softmax. Where one warp spans D (D=64) a row's scores lie
//      in one quad of lanes: the row max and sum are taken by quad shuffles,
//      m and l stay in the quad's registers, and p becomes step 3's A
//      fragment in place (f32: C's {c0, c2, c1, c3}); no barrier but the
//      tile's. Otherwise the warps store their partial scores, kThreads / BM
//      threads own a row, add its CW partials in slice order (no atomics),
//      reduce its max and sum with shuffles and keep m and l in their
//      registers; p (rounded to the storage type; f32 as hi and lo planes)
//      and alpha = exp(m - m') go to shared memory.
//   3. acc = acc * alpha + P . V on the tensor cores, a warp's MT m-tiles x
//      its slice of D.
// Causal blocks stop at their last query. f32 runs each product as three
// TF32 products on mma.sync m16n8k8, bf16 one m16n8k16 (the common header's
// note). Registers and spills of every template are in chip_smoke.py's log
// (it fails if an f32 template at D=64, 512 or 1024 spills).
//
// Measured (PERF.md; NVIDIA H100 80GB HBM3 at 700 W): ~0.62 ms at (64, 256,
// 4, 512) f32 causal, about SDPA's time and 3.9x the floor; ~0.27 ms at
// D=1024 (1.07x SDPA); ~0.18 ms at D=64 non-causal (0.59x); ~0.26 ms in
// bf16 (1.3x). What holds it back at D >= 512: step 2 and its two barriers
// take ~18% (0.62 -> 0.51 ms at D=512 in a timing-only copy without them);
// the rest is the product loops at 8 warps an SM (one block, 220-240
// registers a thread), whose fragment loads and mma latencies two warps a
// scheduler do not hide: the tensor cores run at ~17% of the TF32 peak.
// Smaller blocks, two an SM (16 rows at D=512), ran 15% slower: twice the
// K and V traffic and half the work a barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_fwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
using FwdTiling = Tiling<T, D, true>;

// Byte offsets of the shared memory: q' (BM rows; f32 as the hi plane, then
// the lo plane), NBUF x (K, V) (BN rows each), the CW partial score tiles,
// P (f32 as hi and lo planes), then alpha and l of each kept row.
template <typename T, int D>
struct FwdSmem {
  using L = FwdTiling<T, D>;
  static constexpr size_t x = 0;
  static constexpr size_t y = x + sizeof(T) * (L::kF32 ? 2 : 1) * L::BM * L::LD;
  static constexpr size_t part = y + sizeof(T) * L::NBUF * 2 * L::BN * L::LD;
  static constexpr size_t w = part + (L::kRegs ? 0 : sizeof(float) * L::CW * L::BM * L::LDP);
  static constexpr size_t stats = w + (L::kRegs ? 0
                                       : L::kF32 ? sizeof(float) * 2 * L::BM * L::LDP
                                                 : sizeof(T) * L::BM * L::LDW);
  static constexpr size_t bytes = stats + (L::kRegs ? 0 : sizeof(float) * 2 * L::BM);
  static_assert(bytes <= kMaxSmem, "shared memory");
  static_assert(L::NBUF == (L::kOwnSlice ? 1 : 2), "step buffers");
};

// q' = q * sm_scale in place on the BM staged rows (the product scale_rows
// forms); in f32 then split once by split_tf32_rz: the hi plane in place,
// the lo plane BM rows on.
template <typename T, int D>
__device__ __forceinline__ void prepare_q(T* rows, float scale) {
  using L = FwdTiling<T, D>;
  if constexpr (L::kF32) {
    constexpr int VPR = D / 4;
    for (int i = threadIdx.x; i < L::BM * VPR; i += kThreads) {
      float4* p = reinterpret_cast<float4*>(rows + (i / VPR) * L::LD + (i % VPR) * 4);
      const float4 x = *p;
      const Tf32Pair s0 = split_tf32_rz(x.x * scale), s1 = split_tf32_rz(x.y * scale);
      const Tf32Pair s2 = split_tf32_rz(x.z * scale), s3 = split_tf32_rz(x.w * scale);
      *p = make_float4(__uint_as_float(s0.hi), __uint_as_float(s1.hi), __uint_as_float(s2.hi),
                       __uint_as_float(s3.hi));
      p[L::BM * L::LD / 4] = make_float4(__uint_as_float(s0.lo), __uint_as_float(s1.lo),
                                         __uint_as_float(s2.lo), __uint_as_float(s3.lo));
    }
  } else {
    scale_rows<T, D, L::BM, L::LD>(rows, scale);
  }
}

// One warp's slice of D (columns [d0, d0 + DW)) of step rows [row0, row0 +
// BN) into their shared rows by cp.async, rows at or past `valid`
// zero-filled (kOwnSlice: the warp alone reads them). The caller commits.
template <typename T, int D>
__device__ __forceinline__ void stage_slice(T* dst, const T* __restrict__ src, long long stride,
                                            int row0, int valid, int d0, int lane) {
  using L = FwdTiling<T, D>;
  constexpr int V = 16 / sizeof(T), VPR = L::DW / V;
  static_assert(L::BN * VPR % 32 == 0, "whole copies a lane");
#pragma unroll
  for (int i = lane; i < L::BN * VPR; i += 32) {
    const int r = i / VPR, c = d0 + (i % VPR) * V;
    const bool in = row0 + r < valid;
    copy16(reinterpret_cast<float*>(dst + r * L::LD + c),
           reinterpret_cast<const float*>(in ? src + (row0 + r) * stride + c : src), in ? 16 : 0);
  }
}

// out and lse for BM query rows; steps over BN-row key tiles (the note at
// the top).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, FwdTiling<T, D>::MIN_BLOCKS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, float* __restrict__ lse, View qv, View kv, View vv, Geometry g,
          int q_tiles, float q_scale) {
  using L = FwdTiling<T, D>;
  using S = FwdSmem<T, D>;
  constexpr int BM = L::BM, BN = L::BN, LD = L::LD, LDP = L::LDP, MT = L::MT, DW = L::DW;
  constexpr int NT = BN / 8;
  // step 2 where the warps split D: TPR threads a row, KPT scores each
  constexpr int TPR = kThreads / BM, KPT = (BN + TPR - 1) / TPR;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* x_s = reinterpret_cast<T*>(base + S::x);              // q' (f32: hi, then lo)
  T* y_s = reinterpret_cast<T*>(base + S::y);              // per buffer: K rows, then V rows
  float* part = reinterpret_cast<float*>(base + S::part);  // [slice][BM][LDP]
  char* w_s = base + S::w;                                 // P
  float* alpha_s = reinterpret_cast<float*>(base + S::stats);
  float* l_s = alpha_s + BM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int rw = warp / L::CW, cw = warp % L::CW, wrow = rw * MT * 16, d0 = cw * DW;
  const int row = tid / TPR, sub = tid % TPR;  // step 2's row where the warps split D
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BM;
  const int b = bh / g.H, h = bh % g.H;
  const T* kb = k + b * kv.sb + h * D;
  const T* vb = v + b * vv.sb + h * D;
  const int kv_end = g.causal ? min(g.Tk, q0 + BM) : g.Tk;  // causal: up to the last query

  stage_rows<T, D, BM, LD>(x_s, q + b * qv.sb + h * D, qv.st, q0, g.Tq);
  stage_rows<T, D, BN, LD>(y_s, kb, kv.st, 0, g.Tk);
  stage_rows<T, D, BN, LD>(y_s + BN * LD, vb, vv.st, 0, g.Tk);
  commit_copies();
  wait_copies();
  __syncthreads();
  prepare_q<T, D>(x_s, q_scale);
  __syncthreads();  // q' is in place

  float acc[MT][DW / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    }
  }
  // running max and sum: of the lane's rows wrow + 16m + g8 + 8hh where one
  // warp spans D (the same in the rows' quad), else of step 2's row (the
  // same in its TPR threads, kept in [0][0])
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    m_run[m][0] = m_run[m][1] = kNegInf;
    l_run[m][0] = l_run[m][1] = 0.f;
  }

  int buf = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    T* k_s = y_s + buf * 2 * BN * LD;
    T* v_s = k_s + BN * LD;
    const bool more = k0 + BN < kv_end;
    if constexpr (L::kOwnSlice) {
      wait_copies<1>();  // the warp's slice of this tile's K; of its V, later
      __syncwarp();
    } else {
      wait_copies();
      __syncthreads();  // this tile is in; every warp is done with the last tile
      if (more) {  // the next tile arrives while this one computes
        T* next = y_s + (buf ^ 1) * 2 * BN * LD;
        stage_rows<T, D, BN, LD>(next, kb, kv.st, k0 + BN, g.Tk);
        stage_rows<T, D, BN, LD>(next + BN * LD, vb, vv.st, k0 + BN, g.Tk);
        commit_copies();
      }
    }

    // 1. the warp's partial scores S = q' . K^T
    float c[1][MT][NT][4];
    scores<L, false, L::kF32>(c, x_s + wrow * LD + d0, k_s + d0, 1.f, lane);
    if constexpr (L::kOwnSlice) {  // the next K's slice comes in from here on
      __syncwarp();
      if (more) stage_slice<T, D>(k_s, kb, kv.st, k0 + BN, g.Tk, d0, lane);
      commit_copies();  // every step commits, so that the waits count alike
    }
    if constexpr (L::kRegs) {
      // 2. p in the warp's registers, in place of S: a row's scores lie in
      // one quad of lanes
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qpos = q0 + wrow + m * 16 + g8 + 8 * hh;
          float mx = kNegInf;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
              const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
              const bool keep = kpos < g.Tk && (!g.causal || kpos <= qpos);
              if (!keep) c[0][m][n][e] = kNegInf;
              mx = fmaxf(mx, c[0][m][n][e]);
            }
          }
          const float m_new = fmaxf(m_run[m][hh], group_max<4>(mx));
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
              const float p = expf(c[0][m][n][e] - m_new);
              sum += p;
              c[0][m][n][e] = round_to<T>(p);
            }
          }
          const float alpha = expf(m_run[m][hh] - m_new);
          l_run[m][hh] = l_run[m][hh] * alpha + group_sum<4>(sum);
          m_run[m][hh] = m_new;
#pragma unroll
          for (int n = 0; n < DW / 8; ++n) {
            acc[m][n][2 * hh] *= alpha;
            acc[m][n][2 * hh + 1] *= alpha;
          }
        }
      }
      // 3. acc += P . V
      accumulate<L, false>(acc, RegisterA<L>{c[0]}, v_s + d0, 1.f, lane);
    } else {
      store_partials<L>(part + cw * BM * LDP, c[0], wrow, g8, t4);
      __syncthreads();  // the partials are in

      // 2. the row's scores from the partials added in slice order; p into
      // W, alpha into alpha_s
      const int qpos = q0 + row;
      float sv[KPT], mx = kNegInf;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int j = sub + i * TPR, kpos = k0 + j;
        float s = kNegInf;
        if (j < BN && kpos < g.Tk && (!g.causal || kpos <= qpos)) {
          s = part[row * LDP + j];
#pragma unroll
          for (int sl = 1; sl < L::CW; ++sl) s += part[(sl * BM + row) * LDP + j];
        }
        sv[i] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m_run[0][0], group_max<TPR>(mx));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int j = sub + i * TPR;
        if (j < BN) {
          const float p = expf(sv[i] - m_new);
          sum += p;
          store_w<L>(w_s, L::kF32 ? row * LDP + j : row * L::LDW + j, round_to<T>(p));
        }
      }
      const float alpha = expf(m_run[0][0] - m_new);
      l_run[0][0] = l_run[0][0] * alpha + group_sum<TPR>(sum);
      m_run[0][0] = m_new;
      if (sub == 0) alpha_s[row] = alpha;
      if constexpr (L::kOwnSlice) wait_copies<1>();  // the warp's slice of this tile's V
      __syncthreads();  // P and alpha are in (and each warp's V slice)

      // 3. acc = acc * alpha + P . V
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float al = alpha_s[wrow + m * 16 + g8 + 8 * hh];
#pragma unroll
          for (int n = 0; n < DW / 8; ++n) {
            acc[m][n][2 * hh] *= al;
            acc[m][n][2 * hh + 1] *= al;
          }
        }
      }
      accumulate<L, false>(acc, SharedA<L>{w_s, wrow, lane}, v_s + d0, 1.f, lane);
      if constexpr (L::kOwnSlice) {  // the next V's slice comes in from here on
        __syncwarp();
        if (more) stage_slice<T, D>(v_s, vb, vv.st, k0 + BN, g.Tk, d0, lane);
        commit_copies();
      }
    }
    if constexpr (!L::kOwnSlice) buf ^= 1;
  }

  // out = acc / max(l, 1e-30), rounded once; lse = m + log(max(l, 1e-30))
  if constexpr (!L::kRegs) {
    if (sub == 0) {
      const float lc = fmaxf(l_run[0][0], 1e-30f);
      l_s[row] = lc;
      if (lse != nullptr && q0 + row < g.Tq)
        lse[(long long)bh * g.Tq + q0 + row] = m_run[0][0] + logf(lc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = wrow + m * 16 + g8 + 8 * hh, qpos = q0 + i;
      float lc;
      if constexpr (L::kRegs) {
        lc = fmaxf(l_run[m][hh], 1e-30f);
        if (t4 == 0 && lse != nullptr && qpos < g.Tq)
          lse[(long long)bh * g.Tq + qpos] = m_run[m][hh] + logf(lc);
      } else {
        lc = l_s[i];
      }
      if (qpos >= g.Tq) continue;
      T* p = out + ((long long)(b * g.Tq + qpos) * g.H + h) * D + d0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
        store2(p + n * 8, acc[m][n][2 * hh] / lc, acc[m][n][2 * hh + 1] / lc);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   View qv, View kv, View vv, Geometry g, float q_scale, cudaStream_t stream) {
  constexpr int BM = FwdTiling<T, D>::BM;
  constexpr size_t smem = FwdSmem<T, D>::bytes;
  const int q_tiles = (g.Tq + BM - 1) / BM;
  cudaError_t err = set_smem(flash_fwd<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd<T, D><<<dim3(unsigned(q_tiles) * g.B * g.H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), qv, kv, vv, g, q_tiles, q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* out, void* lse,
                     View qv, View kv, View vv, Geometry g, float q_scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, lse, qv, kv, vv, g, q_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, qv, kv, vv, g, q_scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, lse, qv, kv, vv, g, q_scale, stream);
    case 512: return launch<T, 512>(q, k, v, out, lse, qv, kv, vv, g, q_scale, stream);
    case 1024: return launch<T, 1024>(q, k, v, out, lse, qv, kv, vv, g, q_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Tq, H, D), k and v (B, Tk, H, D): last two axes contiguous, batch and
// sequence strides in elements, rows 16-byte aligned. out (B, Tq, H, D)
// contiguous in the storage type; lse (B, H, Tq) f32 or NULL. is_bf16 selects
// bf16 (1) or f32 (0) storage; D is 64, 128, 256, 512 or 1024; q_scale is
// 1/sqrt(D) rounded to the storage type. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int H, int Tq, int Tk, int D, int is_bf16, int causal,
                        long long q_sb, long long q_st, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, float q_scale, void* stream) {
  const Geometry g{B, H, Tq, Tk, causal};
  const View qv{q_sb, q_st}, kv{k_sb, k_st}, vv{v_sb, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return int(dispatch<__nv_bfloat16>(D, q, k, v, out, lse, qv, kv, vv, g, q_scale, s));
  return int(dispatch<float>(D, q, k, v, out, lse, qv, kv, vv, g, q_scale, s));
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
