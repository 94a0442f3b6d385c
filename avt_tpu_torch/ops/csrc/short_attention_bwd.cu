// Packed short-sequence attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels avt_tpu/ops/flash_attention.py:_short_bwd_kernel_paired
// (with its qkv-bias gradient db_ref, launched by _short_attention_bwd_db_call,
// and without it, by _short_attention_bwd_call) and the unpaired
// _short_bwd_kernel that _short_attention_bwd_call picks for head dims other
// than 64. One source serves all of them: db is computed when a partials
// buffer is given.
//
// Function. qkv is (N, T, 3C), C = H*D, thirds q | k | v, read in place with an
// optional bias (3C) added in the storage type as it is loaded (so the biased
// qkv of the forward never has to be kept); dout is (N, T, C). In the order of
// the paired TPU kernel, per frame and head:
//   q' = (q + b_q) * (sm_scale * log2 e)     rounded to the storage type
//   s  = q' . k^T (f32); p = exp2(s - rowmax s); l = max(rowsum p, 1e-30)
//   dp = dO . v^T (f32); delta = rowsum(p * dp) / l
//   ds = p * (dp - delta)                    rounded to the storage type
//   dq = (ds . k) * (sm_scale / l)
//   dk = ds^T . (q' * (1/l rounded))  / log2 e, the product rounded
//   dv = p^T . (dO * (1/l rounded)), p and the product rounded
// accumulated in f32, each rounded once to the storage type into one packed
// dqkv (N, T, 3C) in the forward's layout. db (3C) = the column sums of the
// rounded dqkv over all frames and rows, in f32, written in the storage type.
//
// Bound on the H100. The function must read qkv and dO and write dqkv,
// 7*N*T*C*s bytes (0.101 ms at N=160 frames, T=197, C=768, bf16), and does five
// T x T x D products per head, 10*N*H*T^2*D FLOPs (0.048 ms at 989 TFLOP/s): it
// is bound by memory traffic, at T/7 FLOP per byte against the card's ~295.
//
// Design. The TPU kernel keeps a whole frame in VMEM and carries db across
// sequential grid steps; here blocks run in no order, so the work is split
// in three launches on one stream:
//   A. query side: one block per (frame, tile of up to 112 query rows, head),
//      16 rows per warp. Pass 1 over the keys accumulates the row max, l and
//      rowsum(p * dp) online (rescaled as the max grows); pass 2 recomputes p
//      against the final max, forms ds and accumulates dq. Writes dq, the row
//      statistics (max, 1/l, delta) to a scratch buffer, and the column sums
//      of dq for db.
//   B. key side: one block per (frame, tile of key rows, head), 16 keys per
//      warp; recomputes p^T and ds^T from the statistics of pass A and
//      accumulates dk and dv in registers over all queries. Writes dk, dv and
//      their column sums.
//   C. db: sums the per-(frame, tile) column sums in a fixed order, so db is
//      the same from run to run (no float atomics).
// That is 9 T x T x D products where the TPU kernel does 5; what holds the
// sides back on the card is latency, not products or traffic, so the bf16
// sides are built to keep 2 blocks of 7 warps resident on an SM (the
// register budget of `bwd_cfg`, 128 a thread at D <= 64) and to give each
// warp independent work:
//   - a warp's own operand rows come straight from device memory into
//     registers, bias and scaling applied there in bf16 (`load_a_global`):
//     q' and dO on side A, k and v on side B. A stages only k and v, B only
//     q' and dO (cp.async; then each thread's own chunks get the bias, and
//     q the scaling, in shared memory);
//   - B scales the q' and dO fragments of its dk and dv products by 1/l in
//     registers (`mma_ab_scaled`: the bits of the q'/l and dO/l tiles it
//     replaces);
//   - A runs whole key steps (16 keys at D=64) with no branch inside one
//     (the staged keys padded to whole steps and zero-filled), so a step's
//     products are independent chains of mma.sync m16n8k16 the warp
//     interleaves.
// Products run on the tensor cores (f32 accumulation, ldmatrix fragments):
// mma.sync m16n8k16 in bf16; in f32 mma.sync m16n8k8 on TF32, each product
// as three (hi/lo split of each operand, short_attention_common.cuh), which
// keeps f32's accuracy. In f32 the function is bound by operations (T/2.8
// FLOP per byte, 70 at T=197): at N=30 frames of the ViT-B/16 shape 0.13 ms
// on the FMA pipes (67 TFLOP/s), 0.054 ms as three TF32 products (495
// TFLOP/s), against 0.038 ms for its bytes. The f32 sides keep
// the bf16 geometry and steps; their accumulators (dq; dk and dv) stay in
// registers, and each warp's own operand rows (q' and dO; k and v) sit in
// shared memory, read with ldmatrix as A fragments where they are used, and
// a block holds at most 6 warps, so that 2 blocks an SM fit without
// spilling at D <= 64 (`f32_geometry`, `f32_cfg`). Scores never reach device memory; the scratch is 12 bytes
// per row and head. Rows and keys past T are zero-filled, masked, and never
// written. PERF.md has the levers that were timed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: short_attention_bwd(...) below; returns the first CUDA error.

#include <type_traits>

#include "short_attention_common.cuh"

namespace {

using namespace packed;

constexpr int kMaxWarps = 7;   // 16 rows each: up to 112 rows per block
constexpr float kLn2 = 0.6931471805599453f;  // 1 / log2(e)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum over the 8 row groups g of a warp (lanes with the same t)
__device__ __forceinline__ float rows_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// c (16 x 8) = a (16 x D) . B^T for 8 rows of B stored [row][LD] at `rows`
template <int D, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* rows, int lane) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const __nv_bfloat16* tile = rows + (lane & 7) * LD + (lane >> 3) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; kk += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, tile + kk * 16);
    mma_16816(c, a[kk], b[0], b[1]);
    mma_16816(c, a[kk + 1], b[2], b[3]);
  }
}

// acc (16 x D) += a (16 x 16) . B for 16 rows of B stored [row][LD] at `rows`
template <int D, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* rows, int lane) {
  const __nv_bfloat16* tile = rows + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < D / 8; j += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + j * 8);
    mma_16816(acc[j], a, b[0], b[1]);
    mma_16816(acc[j + 1], a, b[2], b[3]);
  }
}

// mma_ab with B's rows scaled first: rows 2t, 2t+1 of the tile by the pair
// f_lo and rows 8 + 2t, 9 + 2t by f_hi, each product rounded once in bf16 as
// a tensor multiply rounds it: the B fragments of (B * f) without staging it.
template <int D, int LD>
__device__ __forceinline__ void mma_ab_scaled(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                              const __nv_bfloat16* rows, __nv_bfloat162 f_lo,
                                              __nv_bfloat162 f_hi, int lane) {
  const __nv_bfloat16* tile = rows + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < D / 8; j += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + j * 8);
    b[0] = fix2(b[0], 0u, false, true, f_lo);
    b[1] = fix2(b[1], 0u, false, true, f_hi);
    b[2] = fix2(b[2], 0u, false, true, f_lo);
    b[3] = fix2(b[3], 0u, false, true, f_hi);
    mma_16816(acc[j], a, b[0], b[1]);
    mma_16816(acc[j + 1], a, b[2], b[3]);
  }
}

// The A fragment of columns [16kk, 16kk+16) of a 16 x 8n f32 accumulator,
// rounded to bf16 (the accumulator layout of one product is the A layout of
// the next).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A value as the storage type stores it.
template <bool kBf16>
__device__ __forceinline__ float stored(float x) {
  return kBf16 ? round_bf16(x) : x;
}

// Column sums of a warp's 16 x D tile (rows valid0/valid1 only), into red[D];
// values are rounded to the storage type first (db sums the stored values).
template <int D, bool kBf16 = true>
__device__ __forceinline__ void warp_colsum(float* red, const float (&v)[D / 8][4], float f,
                                            bool valid0, bool valid1, int g, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float c0 = (valid0 ? stored<kBf16>(v[j][0] * f) : 0.f) +
               (valid1 ? stored<kBf16>(v[j][2] * f) : 0.f);
    float c1 = (valid0 ? stored<kBf16>(v[j][1] * f) : 0.f) +
               (valid1 ? stored<kBf16>(v[j][3] * f) : 0.f);
    c0 = rows_sum(c0);
    c1 = rows_sum(c1);
    if (g == 0) {
      red[j * 8 + 2 * t] = c0;
      red[j * 8 + 2 * t + 1] = c1;
    }
  }
}

// The block's column sums: red[warps][D] summed in warp order.
__device__ __forceinline__ void block_colsum(float* dst, const float* red, int warps, int D,
                                             int tid, int nthreads) {
  for (int c = tid; c < D; c += nthreads) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * D + c];
    dst[c] = s;
  }
}

// The bf16 kernels' geometry per head dim: keys staged at once and keys per
// step (A), queries staged at once and queries per step (B), and the blocks
// resident on an SM that each side's register budget is set for
// (65536 / (32 * kMaxWarps * min_blocks) a thread).
struct BwdCfg {
  int kv_stage, key_step, min_blocks_a, q_stage, q_step, min_blocks_b;
};

template <int D>
__host__ __device__ constexpr BwdCfg bwd_cfg() {
  return D == 32   ? BwdCfg{256, 64, 2, 256, 32, 2}
         : D == 64 ? BwdCfg{256, 16, 2, 256, 16, 2}
                   : BwdCfg{128, 32, 1, 64, 16, 1};
}

// Keys the query side stages at once: whole key steps, zero-filled past T.
template <int D>
__host__ __device__ int kv_rows_a(int T) {
  constexpr BwdCfg cfg = bwd_cfg<D>();
  return min(cfg.kv_stage, (T + cfg.key_step - 1) / cfg.key_step * cfg.key_step);
}

struct Geometry {
  int warps, n_tiles;  // 16-row groups per block, blocks per frame and head
};

// The sequence's 16-row groups split evenly over the fewest tiles of at
// most `max_warps` warps.
__host__ __device__ inline Geometry split_rows(int T, int max_warps) {
  const int groups = (T + 15) / 16;
  const int n_tiles = (groups + max_warps - 1) / max_warps;
  return {(groups + n_tiles - 1) / n_tiles, n_tiles};
}

__host__ __device__ inline Geometry tile_geometry(int T) { return split_rows(T, kMaxWarps); }

// stats layout (N, H, 3, T): row max, 1/l, delta
__device__ __forceinline__ size_t stat_idx(int n, int h, int H, int k, int T, int row) {
  return ((size_t(n) * H + h) * 3 + k) * T + row;
}

// ---------------------------------------------------------------- bf16, A
// Grid (N * n_tiles, H). Warp w owns query rows q0 + 16w .. +16: its q' and
// dO fragments come straight from device memory into registers (q's bias
// and scale applied there); the block stages the head's keys and values.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32, bwd_cfg<D>().min_blocks_a)
    bwd_query_bf16(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
                   float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                   int n_tiles, int causal, float scale, float sm_scale) {
  constexpr int LD = D + kPad, CH = D / 8;
  constexpr int KT = bwd_cfg<D>().kv_stage, KB = bwd_cfg<D>().key_step;
  const int warps = blockDim.x >> 5, q_rows = warps * 16;
  const int kv_rows = kv_rows_a<D>(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kv_rows * LD;
  float* red = reinterpret_cast<float*>(Vs + kv_rows * LD);

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int q0 = tile * q_rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const __nv_bfloat16* frame = qkv + size_t(n) * T * rs;
  const __nv_bfloat16* dframe = dout + size_t(n) * T * C;
  const __nv_bfloat16* kb = bias ? bias + C + h * D : nullptr;
  const __nv_bfloat16* vb = bias ? bias + 2 * C + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  // each thread copies one 16-byte column chunk c of every rstep-th row
  const int c = (tid % CH) * 8, rstep = blockDim.x / CH;
  auto stage_kv = [&](int ks0) {
    for (int r = tid / CH; r < kv_rows; r += rstep) {
      const int row = ks0 + r;
      const __nv_bfloat16* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
      cp_async16(Ks + r * LD + c, src, row < T);
      cp_async16(Vs + r * LD + c, src + C, row < T);
    }
  };
  stage_kv(0);

  const int qw = q0 + warp * 16;
  const bool active = qw < T;
  const int row0 = qw + g, row1 = qw + g + 8;
  const int kmax = causal ? min(T, qw + 16) : T;
  uint32_t qa[D / 16][4], oa[D / 16][4];
  if (active) {
    load_a_global<D>(qa, frame + size_t(qw) * rs + h * D, rs, T - qw,
                     bias ? bias + h * D : nullptr, true, scale2, g, t);
    load_a_global<D>(oa, dframe + size_t(qw) * C + h * D, C, T - qw, nullptr, false, scale2,
                     g, t);
  }
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, t0 = 0.f, t1 = 0.f;
  float dl0 = 0.f, dl1 = 0.f;  // delta

  int n_st = (T + KT - 1) / KT;
  if (causal) n_st = min(n_st, (min(q0 + q_rows, T) - 1) / KT + 1);
  for (int pass = 0; pass < 2; ++pass) {
    for (int st = 0; st < n_st; ++st) {
      const int ks0 = st * KT;
      if (pass == 0 || n_st > 1) {
        if (pass > 0 || st > 0) {
          __syncthreads();  // every warp is done with the previous tile
          stage_kv(ks0);
        }
        cp_async_wait_all();
        if (bias != nullptr) {
          const uint4 bk = *reinterpret_cast<const uint4*>(kb + c);
          const uint4 bv = *reinterpret_cast<const uint4*>(vb + c);
          for (int r = tid / CH; r < kv_rows && ks0 + r < T; r += rstep) {
            fix8(Ks + r * LD + c, reinterpret_cast<const __nv_bfloat16*>(&bk), false, scale2);
            fix8(Vs + r * LD + c, reinterpret_cast<const __nv_bfloat16*>(&bv), false, scale2);
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int k0 = ks0; k0 < ks0 + KT && k0 < kmax; k0 += KB) {
        const __nv_bfloat16* Kc = Ks + (k0 - ks0) * LD;
        const __nv_bfloat16* Vc = Vs + (k0 - ks0) * LD;
        // whole steps, no branch inside: keys past T are zero rows, masked
        float s[KB / 8][4], dp[KB / 8][4];
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
          mma_abt<D, LD>(s[j], qa, Kc + j * 8 * LD, lane);
          mma_abt<D, LD>(dp[j], oa, Vc + j * 8 * LD, lane);
        }
        const bool need_mask = causal || k0 + KB > T;
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (need_mask && (key >= T || (causal && key > row))) s[j][e] = -INFINITY;
          }
        }
        if (pass == 0) {
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
          }
          const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
          const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
          const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
          const float a0 = fast_exp2(m0 - sh0), a1 = fast_exp2(m1 - sh1);
          m0 = mn0;
          m1 = mn1;
          l0 *= a0;
          t0 *= a0;
          l1 *= a1;
          t1 *= a1;
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            const float p0 = fast_exp2(s[j][0] - sh0), p1 = fast_exp2(s[j][1] - sh0);
            const float p2 = fast_exp2(s[j][2] - sh1), p3 = fast_exp2(s[j][3] - sh1);
            l0 += p0 + p1;
            l1 += p2 + p3;
            t0 += p0 * dp[j][0] + p1 * dp[j][1];
            t1 += p2 * dp[j][2] + p3 * dp[j][3];
          }
        } else {
          const float sh0 = m0 == -INFINITY ? 0.f : m0;
          const float sh1 = m1 == -INFINITY ? 0.f : m1;
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            s[j][0] = fast_exp2(s[j][0] - sh0) * (dp[j][0] - dl0);
            s[j][1] = fast_exp2(s[j][1] - sh0) * (dp[j][1] - dl0);
            s[j][2] = fast_exp2(s[j][2] - sh1) * (dp[j][2] - dl1);
            s[j][3] = fast_exp2(s[j][3] - sh1) * (dp[j][3] - dl1);
          }
          // dq += ds . k: k is stored [key][dim], the B layout of [k][n]
#pragma unroll
          for (int kk = 0; kk < KB / 16; ++kk) {
            uint32_t dsa[4];
            acc_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
            mma_ab<D, LD>(dq, dsa, Kc + kk * 16 * LD, lane);
          }
        }
      }
    }
    if (pass == 0 && active) {
      l0 = fmaxf(quad_sum(l0), 1e-30f);
      l1 = fmaxf(quad_sum(l1), 1e-30f);
      dl0 = quad_sum(t0) / l0;
      dl1 = quad_sum(t1) / l1;
      l0 = 1.f / l0;  // from here on: 1/l
      l1 = 1.f / l1;
    }
  }

  const bool v0 = active && row0 < T, v1 = active && row1 < T;
  const float f0 = sm_scale * l0, f1 = sm_scale * l1;
  if (active) {
    __nv_bfloat16* out0 = dqkv + (size_t(n) * T + row0) * rs + h * D + 2 * t;
    __nv_bfloat16* out1 = dqkv + (size_t(n) * T + row1) * rs + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (v0) *reinterpret_cast<uint32_t*>(out0 + j * 8) = pack_bf16(dq[j][0] * f0, dq[j][1] * f0);
      if (v1) *reinterpret_cast<uint32_t*>(out1 + j * 8) = pack_bf16(dq[j][2] * f1, dq[j][3] * f1);
    }
    if (t == 0) {
      if (v0) {
        stats[stat_idx(n, h, H, 0, T, row0)] = m0;
        stats[stat_idx(n, h, H, 1, T, row0)] = l0;
        stats[stat_idx(n, h, H, 2, T, row0)] = dl0;
      }
      if (v1) {
        stats[stat_idx(n, h, H, 0, T, row1)] = m1;
        stats[stat_idx(n, h, H, 1, T, row1)] = l1;
        stats[stat_idx(n, h, H, 2, T, row1)] = dl1;
      }
    }
  }
  if (partials == nullptr) return;
  // f0/f1 fold sm_scale/l into the rounding, as the store above does
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dq[j][0] *= f0;
    dq[j][1] *= f0;
    dq[j][2] *= f1;
    dq[j][3] *= f1;
  }
  warp_colsum<D>(red + warp * D, dq, 1.f, v0, v1, g, t);
  __syncthreads();
  block_colsum(partials + (size_t(n) * n_tiles + tile) * rs + h * D, red, warps, D, tid,
               blockDim.x);
}

// ---------------------------------------------------------------- bf16, B
// Grid (N * n_tiles, H). Warp w owns keys kb0 + 16w .. +16: its k and v
// fragments (bias added) come straight from device memory into registers;
// the block stages the head's q' (biased and scaled in place) and dO with
// the row statistics, and 1/l scales the q' and dO fragments in registers.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32, bwd_cfg<D>().min_blocks_b)
    bwd_key_bf16(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
                 const float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                 int n_tiles, int causal, float scale) {
  constexpr int LD = D + kPad, CH = D / 8;
  constexpr int QT = bwd_cfg<D>().q_stage, QB = bwd_cfg<D>().q_step;
  const int warps = blockDim.x >> 5, k_rows = warps * 16;
  const int q_rows = min(QT, (T + QB - 1) / QB * QB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // q' (biased, scaled)
  __nv_bfloat16* Os = Qs + q_rows * LD;                            // dO
  float* st_m = reinterpret_cast<float*>(Os + q_rows * LD);        // row max
  float* st_l = st_m + q_rows;                                     // 1/l
  float* st_d = st_l + q_rows;                                     // delta
  float* red = st_d + q_rows;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int kb0 = tile * k_rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const __nv_bfloat16* frame = qkv + size_t(n) * T * rs;
  const __nv_bfloat16* dframe = dout + size_t(n) * T * C;
  const __nv_bfloat16* qb = bias ? bias + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  // each thread copies one 16-byte column chunk c of every rstep-th row
  const int c = (tid % CH) * 8, rstep = blockDim.x / CH;
  auto stage_q = [&](int qs0) {
    for (int r = tid / CH; r < q_rows; r += rstep) {
      const int row = qs0 + r;
      const size_t src = size_t(min(row, T - 1));
      cp_async16(Qs + r * LD + c, frame + src * rs + h * D + c, row < T);
      cp_async16(Os + r * LD + c, dframe + src * C + h * D + c, row < T);
    }
    for (int i = tid; i < q_rows; i += blockDim.x) {
      const int row = qs0 + i;
      const bool in = row < T;
      st_m[i] = in ? stats[stat_idx(n, h, H, 0, T, row)] : 0.f;
      st_l[i] = in ? stats[stat_idx(n, h, H, 1, T, row)] : 0.f;
      st_d[i] = in ? stats[stat_idx(n, h, H, 2, T, row)] : 0.f;
    }
  };

  const int n_st = (T + QT - 1) / QT;
  // causal: queries before the block's first key see none of its keys
  const int st_first = causal ? kb0 / QT : 0;
  if (st_first < n_st) stage_q(st_first * QT);

  const int kw = kb0 + warp * 16;
  const bool active = kw < T;
  const int key0 = kw + g, key1 = kw + g + 8;
  uint32_t ka[D / 16][4], va[D / 16][4];
  if (active) {
    load_a_global<D>(ka, frame + size_t(kw) * rs + C + h * D, rs, T - kw,
                     bias ? bias + C + h * D : nullptr, false, scale2, g, t);
    load_a_global<D>(va, frame + size_t(kw) * rs + 2 * C + h * D, rs, T - kw,
                     bias ? bias + 2 * C + h * D : nullptr, false, scale2, g, t);
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int st = st_first; st < n_st; ++st) {
    const int qs0 = st * QT;
    if (st > st_first) {
      __syncthreads();  // every warp is done with the previous tile
      stage_q(qs0);
    }
    cp_async_wait_all();
    const uint4 bq = qb ? *reinterpret_cast<const uint4*>(qb + c) : make_uint4(0, 0, 0, 0);
    for (int r = tid / CH; r < q_rows && qs0 + r < T; r += rstep)
      fix8(Qs + r * LD + c, qb ? reinterpret_cast<const __nv_bfloat16*>(&bq) : nullptr, true,
           scale2);
    __syncthreads();
    if (!active) continue;
    for (int qq = 0; qq < q_rows && qs0 + qq < T; qq += QB) {
      if (causal && qs0 + qq + QB <= kw) continue;  // every query before every key
      float s[QB / 8][4], dp[QB / 8][4];
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        mma_abt<D, LD>(s[j], ka, Qs + (qq + j * 8) * LD, lane);
        mma_abt<D, LD>(dp[j], va, Os + (qq + j * 8) * LD, lane);
      }
      // s[j][e]: key kw + g (+8 for e >= 2), query qs0 + qq + 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qq + j * 8 + 2 * t + (e & 1), q = qs0 + qi;
          const int key = e < 2 ? key0 : key1;
          const bool keep = key < T && q < T && !(causal && key > q);
          const float p = keep ? fast_exp2(s[j][e] - st_m[qi]) : 0.f;
          s[j][e] = p;                           // p^T
          dp[j][e] = p * (dp[j][e] - st_d[qi]);  // ds^T
        }
      }
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
        // 1/l rounded to bf16 for queries 2t, 2t+1 and 8 + 2t, 9 + 2t
        const int qi = qq + kk * 16 + 2 * t;
        const __nv_bfloat162 il_lo = __floats2bfloat162_rn(st_l[qi], st_l[qi + 1]);
        const __nv_bfloat162 il_hi = __floats2bfloat162_rn(st_l[qi + 8], st_l[qi + 9]);
        mma_ab_scaled<D, LD>(dv, pa, Os + (qq + kk * 16) * LD, il_lo, il_hi, lane);
        mma_ab_scaled<D, LD>(dk, dsa, Qs + (qq + kk * 16) * LD, il_lo, il_hi, lane);
      }
    }
  }
  cp_async_wait_all();  // a block whose stage loop ran no iteration

  const bool v0 = active && key0 < T, v1 = active && key1 < T;
  if (active) {
    __nv_bfloat16* k0p = dqkv + (size_t(n) * T + key0) * rs + C + h * D + 2 * t;
    __nv_bfloat16* k1p = dqkv + (size_t(n) * T + key1) * rs + C + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (v0) {
        *reinterpret_cast<uint32_t*>(k0p + j * 8) = pack_bf16(dk[j][0] * kLn2, dk[j][1] * kLn2);
        *reinterpret_cast<uint32_t*>(k0p + C + j * 8) = pack_bf16(dv[j][0], dv[j][1]);
      }
      if (v1) {
        *reinterpret_cast<uint32_t*>(k1p + j * 8) = pack_bf16(dk[j][2] * kLn2, dk[j][3] * kLn2);
        *reinterpret_cast<uint32_t*>(k1p + C + j * 8) = pack_bf16(dv[j][2], dv[j][3]);
      }
    }
  }
  if (partials == nullptr) return;
  float* part = partials + (size_t(n) * n_tiles + tile) * rs + h * D;
  warp_colsum<D>(red + warp * D, dk, kLn2, v0, v1, g, t);
  __syncthreads();
  block_colsum(part + C, red, warps, D, tid, blockDim.x);
  __syncthreads();
  warp_colsum<D>(red + warp * D, dv, 1.f, v0, v1, g, t);
  __syncthreads();
  block_colsum(part + 2 * C, red, warps, D, tid, blockDim.x);
}

// ---------------------------------------------------------------- f32
// The f32 form on the tensor cores, as three TF32 products each
// (short_attention_common.cuh): 16 rows a warp, as in bf16, but at most
// kMaxWarpsF32 (6) warps a block (`f32_geometry`; 3 blocks of 5 at T=197,
// the header says why). Both sides keep their
// accumulators in registers and stage the warp's own operand rows in
// shared memory, read as A fragments with ldmatrix where they are used, so
// the registers hold the accumulators and one step's products. The loops
// over a product's k-chunks run one chunk at a time (`#pragma unroll 1`:
// they only step addresses, and unrolled, ptxas hoists their loads into
// registers the accumulators need). kv_stage / key_step: keys the query
// side stages at once and keys a step; q_stage / q_step: the same for the
// key side's queries, whose 8-query steps at D=64 are what keeps its dk and
// dv (64 registers) from spilling (16-query steps took 13-19% less time
// there, and spilled: tools/torch_packed_attention_turns.py --f32).

__host__ __device__ inline Geometry f32_geometry(int T) { return split_rows(T, kMaxWarpsF32); }

struct F32Cfg {
  int kv_stage, key_step, q_stage, q_step, min_blocks;
};

template <int D>
__host__ __device__ constexpr F32Cfg f32_cfg() {
  return D == 32   ? F32Cfg{256, 32, 256, 32, 2}
         : D == 64 ? F32Cfg{64, 32, 64, 8, 2}
                   : F32Cfg{32, 16, 32, 16, 1};
}

// Rows staged at once: whole steps, zero-filled past T.
__host__ __device__ inline int staged_rows(int stage, int step, int T) {
  return min(stage, (T + step - 1) / step * step);
}

// Query side. Grid (N * n_tiles, H). Warp w owns query rows q0 + 16w .. +16;
// the block stages its q' rows ((q + b_q) * scale) and dO rows once, and the
// head's keys and values (bias added) kv_stage at a time. Pass 1 over the
// keys takes the row max, l and rowsum(p * dp) online in whole key steps;
// pass 2 forms ds against the final max and accumulates dq += ds . k.
template <int D>
__global__ void __launch_bounds__(kMaxWarpsF32 * 32, f32_cfg<D>().min_blocks)
    bwd_query_tf32(const float* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ dout, float* __restrict__ dqkv,
                   float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                   int n_tiles, int causal, float scale, float sm_scale) {
  constexpr int LD = D + kPadF, CH = D / 4;
  constexpr int KT = f32_cfg<D>().kv_stage, KB = f32_cfg<D>().key_step;
  const int warps = blockDim.x >> 5, q_rows = warps * 16;
  const int kv_rows = staged_rows(KT, KB, T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // q' of the block's rows
  float* Os = Qs + q_rows * LD;                    // dO of the block's rows
  float* Ks = Os + q_rows * LD;
  float* Vs = Ks + kv_rows * LD;
  float* red = Vs + kv_rows * LD;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int q0 = tile * q_rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const float* frame = qkv + size_t(n) * T * rs;
  const float* dframe = dout + size_t(n) * T * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // each thread copies one 16-byte column chunk c of every rstep-th row
  const int c = (tid % CH) * 4, rstep = blockDim.x / CH;
  for (int r = tid / CH; r < q_rows; r += rstep) {
    const int row = q0 + r;
    const size_t src = size_t(min(row, T - 1));
    cp_async16(Qs + r * LD + c, frame + src * rs + h * D + c, row < T);
    cp_async16(Os + r * LD + c, dframe + src * C + h * D + c, row < T);
  }
  auto stage_kv = [&](int ks0) {
    for (int r = tid / CH; r < kv_rows; r += rstep) {
      const int row = ks0 + r;
      const float* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
      cp_async16(Ks + r * LD + c, src, row < T);
      cp_async16(Vs + r * LD + c, src + C, row < T);
    }
  };
  stage_kv(0);
  // this thread's chunk of the bias of third i (read where it is used)
  auto bias4 = [&](int i) {
    return bias ? *reinterpret_cast<const float4*>(bias + i * C + h * D + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  cp_async_wait_all();
  const float4 bq = bias4(0);
  for (int r = tid / CH; r < q_rows && q0 + r < T; r += rstep)
    fix4(Qs + r * LD + c, bq, bias != nullptr, true, scale);

  const int qw = q0 + warp * 16;
  const bool active = qw < T;
  const int row0 = qw + g, row1 = qw + g + 8;
  const int kmax = causal ? min(T, qw + 16) : T;
  const float* Qw = Qs + warp * 16 * LD;
  const float* Ow = Os + warp * 16 * LD;
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, t0 = 0.f, t1 = 0.f;
  float dl0 = 0.f, dl1 = 0.f;  // delta

  int n_st = (T + KT - 1) / KT;
  if (causal) n_st = min(n_st, (min(q0 + q_rows, T) - 1) / KT + 1);
  for (int pass = 0; pass < 2; ++pass) {
    for (int st = 0; st < n_st; ++st) {
      const int ks0 = st * KT;
      if (pass == 0 || n_st > 1) {
        if (pass > 0 || st > 0) {
          __syncthreads();  // every warp is done with the previous tile
          stage_kv(ks0);
          cp_async_wait_all();
        }
        if (bias != nullptr) {
          const float4 bk = bias4(1), bv = bias4(2);
          for (int r = tid / CH; r < kv_rows && ks0 + r < T; r += rstep) {
            fix4(Ks + r * LD + c, bk, true, false, 1.f);
            fix4(Vs + r * LD + c, bv, true, false, 1.f);
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int k0 = ks0; k0 < ks0 + KT && k0 < kmax; k0 += KB) {
        const float* Kc = Ks + (k0 - ks0) * LD;
        const float* Vc = Vs + (k0 - ks0) * LD;
        // whole steps, no branch inside: keys past T are zero rows, masked
        float s[KB / 8][4], dp[KB / 8][4];
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        }
#pragma unroll 1
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA f = load_a_f32<LD>(Qw, kk, lane);
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            float b0, b1;
            load_b_nk<LD>(b0, b1, Kc + j * 8 * LD, kk, lane);
            mma3(s[j], f, b0, b1);
          }
        }
#pragma unroll 1
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA f = load_a_f32<LD>(Ow, kk, lane);
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            float b0, b1;
            load_b_nk<LD>(b0, b1, Vc + j * 8 * LD, kk, lane);
            mma3(dp[j], f, b0, b1);
          }
        }
        const bool need_mask = causal || k0 + KB > T;
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (need_mask && (key >= T || (causal && key > row))) s[j][e] = -INFINITY;
          }
        }
        if (pass == 0) {
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
          }
          const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
          const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
          const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
          const float a0 = exp2f(m0 - sh0), a1 = exp2f(m1 - sh1);
          m0 = mn0;
          m1 = mn1;
          l0 *= a0;
          t0 *= a0;
          l1 *= a1;
          t1 *= a1;
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            const float p0 = exp2f(s[j][0] - sh0), p1 = exp2f(s[j][1] - sh0);
            const float p2 = exp2f(s[j][2] - sh1), p3 = exp2f(s[j][3] - sh1);
            l0 += p0 + p1;
            l1 += p2 + p3;
            t0 += p0 * dp[j][0] + p1 * dp[j][1];
            t1 += p2 * dp[j][2] + p3 * dp[j][3];
          }
        } else {
          const float sh0 = m0 == -INFINITY ? 0.f : m0;
          const float sh1 = m1 == -INFINITY ? 0.f : m1;
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            s[j][0] = exp2f(s[j][0] - sh0) * (dp[j][0] - dl0);
            s[j][1] = exp2f(s[j][1] - sh0) * (dp[j][1] - dl0);
            s[j][2] = exp2f(s[j][2] - sh1) * (dp[j][2] - dl1);
            s[j][3] = exp2f(s[j][3] - sh1) * (dp[j][3] - dl1);
          }
          // dq += ds . k: key tile j's ds is the A fragment, k's rows (stored
          // [key][dim], the [k][n] layout) taken in the matching order
#pragma unroll
          for (int j = 0; j < KB / 8; ++j) {
            const FragA da = acc_as_a(s[j]);
#pragma unroll
            for (int jd = 0; jd < D / 8; ++jd) {
              float b0, b1;
              load_b_kn<LD>(b0, b1, Kc + j * 8 * LD, jd * 8, g, t);
              mma3(dq[jd], da, b0, b1);
            }
          }
        }
      }
    }
    if (pass == 0 && active) {
      l0 = fmaxf(quad_sum(l0), 1e-30f);
      l1 = fmaxf(quad_sum(l1), 1e-30f);
      dl0 = quad_sum(t0) / l0;
      dl1 = quad_sum(t1) / l1;
      l0 = 1.f / l0;  // from here on: 1/l
      l1 = 1.f / l1;
    }
  }

  const bool v0 = active && row0 < T, v1 = active && row1 < T;
  const float f0 = sm_scale * l0, f1 = sm_scale * l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dq[j][0] *= f0;
    dq[j][1] *= f0;
    dq[j][2] *= f1;
    dq[j][3] *= f1;
  }
  if (active) {
    float* out0 = dqkv + (size_t(n) * T + row0) * rs + h * D + 2 * t;
    float* out1 = out0 + 8 * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (v0) *reinterpret_cast<float2*>(out0 + j * 8) = make_float2(dq[j][0], dq[j][1]);
      if (v1) *reinterpret_cast<float2*>(out1 + j * 8) = make_float2(dq[j][2], dq[j][3]);
    }
    if (t == 0) {
      if (v0) {
        stats[stat_idx(n, h, H, 0, T, row0)] = m0;
        stats[stat_idx(n, h, H, 1, T, row0)] = l0;
        stats[stat_idx(n, h, H, 2, T, row0)] = dl0;
      }
      if (v1) {
        stats[stat_idx(n, h, H, 0, T, row1)] = m1;
        stats[stat_idx(n, h, H, 1, T, row1)] = l1;
        stats[stat_idx(n, h, H, 2, T, row1)] = dl1;
      }
    }
  }
  if (partials == nullptr) return;
  warp_colsum<D, false>(red + warp * D, dq, 1.f, v0, v1, g, t);
  __syncthreads();
  block_colsum(partials + (size_t(n) * n_tiles + tile) * rs + h * D, red, warps, D, tid,
               blockDim.x);
}

// Key side. Grid (N * n_tiles, H). Warp w owns keys kb0 + 16w .. +16: the
// block stages its k and v rows (bias added) once, and the head's q'
// ((q + b_q) * scale) and dO rows q_stage at a time with the row statistics.
// It computes s^T = k . q'^T and dp^T = v . dO^T, so that p^T and ds^T are
// the warp's own key rows: dk += (ds^T / l) . q' and dv += (p^T / l) . dO
// accumulate in registers (1/l scales the score tiles, which the A
// fragments are made from, rather than q' and dO).
template <int D>
__global__ void __launch_bounds__(kMaxWarpsF32 * 32, f32_cfg<D>().min_blocks)
    bwd_key_tf32(const float* __restrict__ qkv, const float* __restrict__ bias,
                 const float* __restrict__ dout, float* __restrict__ dqkv,
                 const float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                 int n_tiles, int causal, float scale) {
  constexpr int LD = D + kPadF, CH = D / 4;
  constexpr int QT = f32_cfg<D>().q_stage, QB = f32_cfg<D>().q_step;
  const int warps = blockDim.x >> 5, k_rows = warps * 16;
  const int q_rows = staged_rows(QT, QB, T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // k of the block's keys
  float* Vs = Ks + k_rows * LD;                    // v of the block's keys
  float* Qs = Vs + k_rows * LD;                    // q' (biased, scaled)
  float* Os = Qs + q_rows * LD;                    // dO
  float* st_m = Os + q_rows * LD;                  // row max
  float* st_l = st_m + q_rows;                     // 1/l
  float* st_d = st_l + q_rows;                     // delta
  float* red = st_d + q_rows;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int kb0 = tile * k_rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const float* frame = qkv + size_t(n) * T * rs;
  const float* dframe = dout + size_t(n) * T * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int c = (tid % CH) * 4, rstep = blockDim.x / CH;
  for (int r = tid / CH; r < k_rows; r += rstep) {
    const int row = kb0 + r;
    const float* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
    cp_async16(Ks + r * LD + c, src, row < T);
    cp_async16(Vs + r * LD + c, src + C, row < T);
  }
  auto stage_q = [&](int qs0) {
    for (int r = tid / CH; r < q_rows; r += rstep) {
      const int row = qs0 + r;
      const size_t src = size_t(min(row, T - 1));
      cp_async16(Qs + r * LD + c, frame + src * rs + h * D + c, row < T);
      cp_async16(Os + r * LD + c, dframe + src * C + h * D + c, row < T);
    }
    for (int i = tid; i < q_rows; i += blockDim.x) {
      const int row = qs0 + i;
      const bool in = row < T;
      st_m[i] = in ? stats[stat_idx(n, h, H, 0, T, row)] : 0.f;
      st_l[i] = in ? stats[stat_idx(n, h, H, 1, T, row)] : 0.f;
      st_d[i] = in ? stats[stat_idx(n, h, H, 2, T, row)] : 0.f;
    }
  };

  const int n_st = (T + QT - 1) / QT;
  // causal: queries before the block's first key see none of its keys
  const int st_first = causal ? kb0 / QT : 0;
  if (st_first < n_st) stage_q(st_first * QT);
  // this thread's chunk of the bias of third i (read where it is used)
  auto bias4 = [&](int i) {
    return bias ? *reinterpret_cast<const float4*>(bias + i * C + h * D + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  cp_async_wait_all();
  if (bias != nullptr) {
    const float4 bk = bias4(1), bv = bias4(2);
    for (int r = tid / CH; r < k_rows && kb0 + r < T; r += rstep) {
      fix4(Ks + r * LD + c, bk, true, false, 1.f);
      fix4(Vs + r * LD + c, bv, true, false, 1.f);
    }
  }

  const int kw = kb0 + warp * 16;
  const bool active = kw < T;
  const int key0 = kw + g, key1 = kw + g + 8;
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int st = st_first; st < n_st; ++st) {
    const int qs0 = st * QT;
    if (st > st_first) {
      __syncthreads();  // every warp is done with the previous tile
      stage_q(qs0);
      cp_async_wait_all();
    }
    const float4 bq = bias4(0);
    for (int r = tid / CH; r < q_rows && qs0 + r < T; r += rstep)
      fix4(Qs + r * LD + c, bq, bias != nullptr, true, scale);
    __syncthreads();
    if (!active) continue;
    for (int qq = 0; qq < q_rows && qs0 + qq < T; qq += QB) {
      if (causal && qs0 + qq + QB <= kw) continue;  // every query before every key
      const float* Qc = Qs + qq * LD;
      const float* Oc = Os + qq * LD;
      float s[QB / 8][4], dp[QB / 8][4];
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll 1
      for (int kk = 0; kk < D / 8; ++kk) {
        const FragA f = load_a_f32<LD>(Kw, kk, lane);
#pragma unroll
        for (int j = 0; j < QB / 8; ++j) {
          float b0, b1;
          load_b_nk<LD>(b0, b1, Qc + j * 8 * LD, kk, lane);
          mma3(s[j], f, b0, b1);
        }
      }
#pragma unroll 1
      for (int kk = 0; kk < D / 8; ++kk) {
        const FragA f = load_a_f32<LD>(Vw, kk, lane);
#pragma unroll
        for (int j = 0; j < QB / 8; ++j) {
          float b0, b1;
          load_b_nk<LD>(b0, b1, Oc + j * 8 * LD, kk, lane);
          mma3(dp[j], f, b0, b1);
        }
      }
      // s[j][e]: key kw + g (+8 for e >= 2), query qs0 + qq + 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qq + j * 8 + 2 * t + (e & 1), q = qs0 + qi;
          const int key = e < 2 ? key0 : key1;
          const bool keep = key < T && q < T && !(causal && key > q);
          const float p = keep ? exp2f(s[j][e] - st_m[qi]) : 0.f;
          const float il = st_l[qi];
          dp[j][e] = p * (dp[j][e] - st_d[qi]) * il;  // ds^T / l
          s[j][e] = p * il;                           // p^T / l
        }
      }
      // dv += (p^T / l) . dO and dk += (ds^T / l) . q': query tile j is the
      // A fragment, the dO and q' rows ([query][dim], the [k][n] layout)
      // taken in the matching order
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        const FragA pa = acc_as_a(s[j]);
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          float b0, b1;
          load_b_kn<LD>(b0, b1, Oc + j * 8 * LD, jd * 8, g, t);
          mma3(dv[jd], pa, b0, b1);
        }
        const FragA da = acc_as_a(dp[j]);
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          float b0, b1;
          load_b_kn<LD>(b0, b1, Qc + j * 8 * LD, jd * 8, g, t);
          mma3(dk[jd], da, b0, b1);
        }
      }
    }
  }
  cp_async_wait_all();  // a block whose stage loop ran no iteration

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] *= kLn2;
    dk[j][1] *= kLn2;
    dk[j][2] *= kLn2;
    dk[j][3] *= kLn2;
  }
  const bool v0 = active && key0 < T, v1 = active && key1 < T;
  if (active) {
    float* k0p = dqkv + (size_t(n) * T + key0) * rs + C + h * D + 2 * t;
    float* k1p = k0p + 8 * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (v0) {
        *reinterpret_cast<float2*>(k0p + j * 8) = make_float2(dk[j][0], dk[j][1]);
        *reinterpret_cast<float2*>(k0p + C + j * 8) = make_float2(dv[j][0], dv[j][1]);
      }
      if (v1) {
        *reinterpret_cast<float2*>(k1p + j * 8) = make_float2(dk[j][2], dk[j][3]);
        *reinterpret_cast<float2*>(k1p + C + j * 8) = make_float2(dv[j][2], dv[j][3]);
      }
    }
  }
  if (partials == nullptr) return;
  float* part = partials + (size_t(n) * n_tiles + tile) * rs + h * D;
  warp_colsum<D, false>(red + warp * D, dk, 1.f, v0, v1, g, t);
  __syncthreads();
  block_colsum(part + C, red, warps, D, tid, blockDim.x);
  __syncthreads();
  warp_colsum<D, false>(red + warp * D, dv, 1.f, v0, v1, g, t);
  __syncthreads();
  block_colsum(part + 2 * C, red, warps, D, tid, blockDim.x);
}

// ---------------------------------------------------------------- db
// db[c] = sum over the partials' rows of column c, in row order.
template <typename S>
__global__ void db_reduce(const float* __restrict__ partials, int rows, int cols,
                          S* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partials[size_t(r) * cols + c];
  if constexpr (sizeof(S) == 2) {
    db[c] = __float2bfloat16_rn(s);
  } else {
    db[c] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// Dynamic shared memory of the query side (A) and key side (B) at T.
template <int D>
size_t bf16_smem_a(int T) {
  return sizeof(__nv_bfloat16) * size_t(2 * kv_rows_a<D>(T)) * (D + kPad) +
         sizeof(float) * tile_geometry(T).warps * D;
}

template <int D>
size_t bf16_smem_b(int T) {
  constexpr BwdCfg cfg = bwd_cfg<D>();
  const int q_rows = min(cfg.q_stage, (T + cfg.q_step - 1) / cfg.q_step * cfg.q_step);
  return sizeof(__nv_bfloat16) * size_t(2 * q_rows) * (D + kPad) +
         sizeof(float) * (3 * q_rows + tile_geometry(T).warps * D);
}

// f32, A: the block's q' and dO rows, kv_stage keys and values, column sums.
template <int D>
size_t f32_smem_a(int T) {
  constexpr F32Cfg cfg = f32_cfg<D>();
  const int warps = f32_geometry(T).warps;
  return sizeof(float) * (size_t(2 * (warps * 16 + staged_rows(cfg.kv_stage, cfg.key_step, T))) *
                              (D + kPadF) + warps * D);
}

// f32, B: the block's k and v rows, q_stage q' and dO rows with their row
// statistics, column sums.
template <int D>
size_t f32_smem_b(int T) {
  constexpr F32Cfg cfg = f32_cfg<D>();
  const int warps = f32_geometry(T).warps;
  const int q_rows = staged_rows(cfg.q_stage, cfg.q_step, T);
  return sizeof(float) * (size_t(2 * (warps * 16 + q_rows)) * (D + kPadF) + 3 * q_rows +
                          warps * D);
}

// The geometry, kernels and shared memory of one side (0: query, 1: key)
// of one storage type.
template <bool kBf16>
Geometry geometry(int T) {
  return kBf16 ? tile_geometry(T) : f32_geometry(T);
}

template <bool kBf16, int D>
auto query_kernel() {
  if constexpr (kBf16) {
    return bwd_query_bf16<D>;
  } else {
    return bwd_query_tf32<D>;
  }
}

template <bool kBf16, int D>
auto key_kernel() {
  if constexpr (kBf16) {
    return bwd_key_bf16<D>;
  } else {
    return bwd_key_tf32<D>;
  }
}

template <bool kBf16, int D>
size_t side_smem(int T, int side) {
  if constexpr (kBf16) {
    return side == 0 ? bf16_smem_a<D>(T) : bf16_smem_b<D>(T);
  } else {
    return side == 0 ? f32_smem_a<D>(T) : f32_smem_b<D>(T);
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* qkv, const void* bias, const void* dout, void* dqkv, float* stats,
                   float* partials, int N, int T, int H, int causal, float scale, float sm_scale,
                   cudaStream_t stream) {
  using S = std::conditional_t<kBf16, __nv_bfloat16, float>;
  const Geometry geo = geometry<kBf16>(T);
  const dim3 grid(N * geo.n_tiles, H);
  const size_t smem_a = side_smem<kBf16, D>(T, 0), smem_b = side_smem<kBf16, D>(T, 1);
  const auto query = query_kernel<kBf16, D>();
  const auto key = key_kernel<kBf16, D>();
  cudaError_t err = set_smem(query, smem_a);
  if (err != cudaSuccess) return err;
  query<<<grid, geo.warps * 32, smem_a, stream>>>(
      static_cast<const S*>(qkv), static_cast<const S*>(bias), static_cast<const S*>(dout),
      static_cast<S*>(dqkv), stats, partials, T, H, geo.n_tiles, causal, scale, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(key, smem_b)) != cudaSuccess) return err;
  key<<<grid, geo.warps * 32, smem_b, stream>>>(
      static_cast<const S*>(qkv), static_cast<const S*>(bias), static_cast<const S*>(dout),
      static_cast<S*>(dqkv), stats, partials, T, H, geo.n_tiles, causal, scale);
  return cudaGetLastError();
}

template <bool kBf16, int D>
cudaError_t residency(int T, int side, int* warps, int* smem, int* blocks) {
  *warps = geometry<kBf16>(T).warps;
  const size_t bytes = side_smem<kBf16, D>(T, side);
  *smem = int(bytes);
  if (side == 0) {
    const auto kernel = query_kernel<kBf16, D>();
    cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *warps * 32, bytes);
  }
  const auto kernel = key_kernel<kBf16, D>();
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *warps * 32, bytes);
}

template <bool kBf16>
cudaError_t launch_d(int D, const void* qkv, const void* bias, const void* dout, void* dqkv,
                     float* stats, float* partials, int N, int T, int H, int causal, float scale,
                     float sm_scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<kBf16, 32>(qkv, bias, dout, dqkv, stats, partials, N, T, H, causal, scale, sm_scale, st);
    case 64: return launch<kBf16, 64>(qkv, bias, dout, dqkv, stats, partials, N, T, H, causal, scale, sm_scale, st);
    case 128: return launch<kBf16, 128>(qkv, bias, dout, dqkv, stats, partials, N, T, H, causal, scale, sm_scale, st);
  }
  return cudaErrorInvalidValue;
}

template <bool kBf16>
cudaError_t residency_d(int T, int D, int side, int* warps, int* smem, int* blocks) {
  switch (D) {
    case 32: return residency<kBf16, 32>(T, side, warps, smem, blocks);
    case 64: return residency<kBf16, 64>(T, side, warps, smem, blocks);
    case 128: return residency<kBf16, 128>(T, side, warps, smem, blocks);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Blocks per frame and head along the sequence: the partials buffer has
// N * short_attention_bwd_tiles(T, is_bf16) rows of 3*H*D floats.
int short_attention_bwd_tiles(int T, int is_bf16) {
  return is_bf16 ? tile_geometry(T).n_tiles : f32_geometry(T).n_tiles;
}

// qkv (N, T, 3*H*D), dout (N, T, H*D) and dqkv (N, T, 3*H*D), contiguous and
// 16-byte aligned, in the storage type (is_bf16: bf16, else f32); bias
// (3*H*D) or NULL; stats: f32 scratch of N*H*3*T; partials: NULL (no db) or
// f32 scratch of N*tiles rows of 3*H*D, with db (3*H*D, storage type) the
// bias gradient. scale is sm_scale*log2(e) rounded to the storage type,
// sm_scale 1/sqrt(D). D is 32, 64 or 128. Returns a cudaError_t (1,
// cudaErrorInvalidValue, for an unsupported D).
int short_attention_bwd(const void* qkv, const void* bias, const void* dout, void* dqkv,
                        void* stats, void* partials, void* db, int N, int T, int H, int D,
                        int is_bf16, int causal, float scale, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  float* pp = static_cast<float*>(partials);
  const cudaError_t err =
      is_bf16 ? launch_d<true>(D, qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st)
              : launch_d<false>(D, qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st);
  if (err != cudaSuccess || partials == nullptr) return int(err);
  const int cols = 3 * H * D;
  const int rows = N * short_attention_bwd_tiles(T, is_bf16);
  if (is_bf16) {
    db_reduce<<<(cols + 255) / 256, 256, 0, st>>>(pp, rows, cols, static_cast<__nv_bfloat16*>(db));
  } else {
    db_reduce<<<(cols + 255) / 256, 256, 0, st>>>(pp, rows, cols, static_cast<float*>(db));
  }
  return int(cudaGetLastError());
}

// The query side (side 0) or key side (side 1) at sequence length T, head
// dim D and storage type (is_bf16: bf16, else f32): warps a block, its
// dynamic shared memory in bytes, and how many blocks of it one SM holds.
// is_bf16 comes last, so that a caller passing it to a library built from
// sources older than it gets the bf16 form. Returns a cudaError_t.
int short_attention_bwd_residency(int T, int D, int side, int* warps, int* smem_bytes,
                                  int* blocks, int is_bf16) {
  return int(is_bf16 ? residency_d<true>(T, D, side, warps, smem_bytes, blocks)
                     : residency_d<false>(T, D, side, warps, smem_bytes, blocks));
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
