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
// Design. Both sides are one loop (`side`) on the tiling and the step loops
// they share with the forward (flash_attention_common.cuh), the roles of the
// operands swapped: a block keeps BM rows of two operands X1, X2 (dq side:
// q', dO; dk/dv side: K, V) in shared memory and steps over BN-row tiles of
// the other two, Y1, Y2 (K, V; q', dO). Per step:
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
// shared memory (rounded to bf16 as scale_rows rounds). At D=64 the f32
// blocks hold 16-row steps and 128 registers a thread, so two fit an SM.
// Registers and spills of every template are in chip_smoke.py's log (it
// fails if an f32 template at D=64, 512 or 1024 spills); times in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_bwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
using BwdTiling = Tiling<T, D, false>;  // the tiles of both sides

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
    scores<L, kFold, false>(c, x_s + wrow * LD + d0, y1_s + d0, q_scale, lane);
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
        accumulate<L, false>(acc[1], RegisterA<L>{c[0]}, y2_s + d0, 1.f, lane);
        accumulate<L, kFold>(acc[0], RegisterA<L>{c[1]}, y1_s + d0, q_scale, lane);
      } else {
        accumulate<L, false>(acc[0], RegisterA<L>{c[1]}, y1_s + d0, 1.f, lane);
      }
    } else {
      store_partials<L>(part + (2 * cw) * BM * LDP, c[0], wrow, g8, t4);
      store_partials<L>(part + (2 * cw + 1) * BM * LDP, c[1], wrow, g8, t4);
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
          store_w<L>(w_s, wat, round_to<T>(pr * (dp - delta_s[si])));
          if constexpr (kDkv) store_w<L>(w_s + S::w_p, wat, round_to<T>(pr));
        }
      }
      __syncthreads();  // W is in

      // 3. dq += ds . K; dv += p . dO and dk += ds . q'
      if constexpr (kDkv) {
        accumulate<L, false>(acc[1], SharedA<L>{w_s + S::w_p, wrow, lane}, y2_s + d0, 1.f,
                                lane);
        if constexpr (L::NBUF == 1) {
          if (more) {  // dO is done with: the next comes in while dk is formed
            __syncthreads();
            stage_rows<T, D, BN, LD>(y2_s, y2, y2st, s0 + BN, n_step);
            commit_copies();
          }
        }
        accumulate<L, kFold>(acc[0], SharedA<L>{w_s, wrow, lane}, y1_s + d0, q_scale,
                                lane);
      } else {
        accumulate<L, false>(acc[0], SharedA<L>{w_s, wrow, lane}, y1_s + d0, 1.f, lane);
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
