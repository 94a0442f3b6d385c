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
// Design: right first, each pass simple. The TPU kernel keeps a whole frame
// in VMEM and carries db across sequential grid steps; here blocks run in no
// order, so the work is split in three launches on one stream:
//   A. query side: one block per (frame, tile of up to 128 query rows, head),
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
// Each head's keys and values (A) or queries and output gradients (B) are
// staged in shared memory with cp.async, the bias add (and the q scaling,
// and the 1/l products of B) done there in the storage type; products run on
// the tensor cores with mma.sync m16n8k16 (f32 accumulation, ldmatrix
// fragments) in bf16, plain FMAs in f32. Scores never reach device memory;
// the scratch is 12 bytes per row and head. Rows and keys past T are
// zero-filled, masked, and never written. Measured times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: short_attention_bwd(...) below; returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;        // bf16 of padding per shared row (16 bytes):
                               // conflict-free ldmatrix
constexpr int kMaxWarps = 8;   // 16 rows each: up to 128 rows per block
constexpr float kLn2 = 0.6931471805599453f;  // 1 / log2(e)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// c += a . b: a 16x16 bf16 (row fragment), b 16x8 bf16 (column fragment),
// c 16x8 f32. Lane 4g+t holds rows g, g+8 and columns 2t, 2t+1 (+8).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// In place on eight bf16 in shared memory: + bias (when given), then * scale
// (when `scaled`), each bf16x2 result rounded once as a bf16 tensor op does.
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

// dst[0:8] = src[0:8] * f in bf16 (one rounding per element).
__device__ __forceinline__ void scale8(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       __nv_bfloat162 f2) {
  uint4 x = *reinterpret_cast<const uint4*>(src);
  __nv_bfloat162* xv = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) xv[i] = __hmul2(xv[i], f2);
  *reinterpret_cast<uint4*>(dst) = x;
}

// 2^x on the special-function unit; p is rounded to bf16 before every product.
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

// sum over the 8 row groups g of a warp (lanes with the same t)
__device__ __forceinline__ float rows_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// 16 bytes global -> shared without registers; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 tiles; lanes 8i..8i+7 address the rows of tile i. Plain: lane
// 4g+t gets (g, 2t), (g, 2t+1), the B fragment of a matrix stored [n][k].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Transposed: the B fragment of a matrix stored [k][n].
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

// Column sums of a warp's 16 x D tile (rows valid0/valid1 only), into red[D];
// values are rounded to bf16 first (db sums the stored values).
template <int D>
__device__ __forceinline__ void warp_colsum(float* red, const float (&v)[D / 8][4], float f,
                                            bool valid0, bool valid1, int g, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float c0 = (valid0 ? round_bf16(v[j][0] * f) : 0.f) + (valid1 ? round_bf16(v[j][2] * f) : 0.f);
    float c1 = (valid0 ? round_bf16(v[j][1] * f) : 0.f) + (valid1 ? round_bf16(v[j][3] * f) : 0.f);
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

template <int D>
__host__ __device__ constexpr int kv_stage() { return D > 64 ? 128 : 256; }   // keys staged at once (A)
template <int D>
__host__ __device__ constexpr int key_step() { return D > 64 ? 32 : 64; }     // keys per step (A)
template <int D>
__host__ __device__ constexpr int q_stage() { return D > 64 ? 64 : 128; }     // queries staged at once (B)
template <int D>
__host__ __device__ constexpr int q_step() { return D > 64 ? 16 : 32; }       // queries per step (B)

struct Geometry {
  int warps, n_tiles;  // 16-row groups per block, blocks per frame and head
};

__host__ __device__ inline Geometry bf16_geometry(int T) {
  const int groups = (T + 15) / 16;
  const int n_tiles = (groups + kMaxWarps - 1) / kMaxWarps;
  return {(groups + n_tiles - 1) / n_tiles, n_tiles};
}

// stats layout (N, H, 3, T): row max, 1/l, delta
__device__ __forceinline__ size_t stat_idx(int n, int h, int H, int k, int T, int row) {
  return ((size_t(n) * H + h) * 3 + k) * T + row;
}

// ---------------------------------------------------------------- bf16, A
// Grid (N * n_tiles, H). Warp w owns query rows q0 + 16w .. +16.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bwd_query_bf16(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
                   float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                   int n_tiles, int causal, float scale, float sm_scale) {
  constexpr int LD = D + kPad, CH = D / 8, KT = kv_stage<D>(), KB = key_step<D>();
  const int warps = blockDim.x >> 5, q_rows = warps * 16;
  const int kv_rows = min(KT, (T + 15) & ~15);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + q_rows * LD;
  __nv_bfloat16* Ks = Os + q_rows * LD;
  __nv_bfloat16* Vs = Ks + kv_rows * LD;
  float* red = reinterpret_cast<float*>(Vs + kv_rows * LD);

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int q0 = tile * q_rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const __nv_bfloat16* frame = qkv + size_t(n) * T * rs;
  const __nv_bfloat16* dframe = dout + size_t(n) * T * C;
  const __nv_bfloat16* qb = bias ? bias + h * D : nullptr;
  const __nv_bfloat16* kb = bias ? bias + C + h * D : nullptr;
  const __nv_bfloat16* vb = bias ? bias + 2 * C + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  for (int i = tid; i < q_rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
    const size_t src = size_t(min(row, T - 1));
    cp_async16(Qs + r * LD + c, frame + src * rs + h * D + c, row < T);
    cp_async16(Os + r * LD + c, dframe + src * C + h * D + c, row < T);
  }

  const int qw = q0 + warp * 16;
  const bool active = qw < T;
  const int row0 = qw + g, row1 = qw + g + 8;
  const int kmax = causal ? min(T, qw + 16) : T;
  uint32_t qa[D / 16][4], oa[D / 16][4];
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
        __syncthreads();
        for (int i = tid; i < kv_rows * CH; i += blockDim.x) {
          const int r = i / CH, c = (i % CH) * 8, row = ks0 + r;
          const __nv_bfloat16* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
          cp_async16(Ks + r * LD + c, src, row < T);
          cp_async16(Vs + r * LD + c, src + C, row < T);
        }
        cp_async_wait_all();
        if (pass == 0 && st == 0) {
          for (int i = tid; i < q_rows * CH; i += blockDim.x) {
            const int r = i / CH, c = (i % CH) * 8;
            if (q0 + r < T) fix8(Qs + r * LD + c, qb ? qb + c : nullptr, true, scale2);
          }
        }
        if (bias != nullptr) {
          for (int i = tid; i < kv_rows * CH; i += blockDim.x) {
            const int r = i / CH, c = (i % CH) * 8;
            if (ks0 + r >= T) continue;
            fix8(Ks + r * LD + c, kb + c, false, scale2);
            fix8(Vs + r * LD + c, vb + c, false, scale2);
          }
        }
        __syncthreads();
      }
      if (!active) continue;
      if (pass == 0 && st == 0) {
        load_a<D, LD>(qa, Qs + warp * 16 * LD, g, t);
        load_a<D, LD>(oa, Os + warp * 16 * LD, g, t);
      }
      for (int k0 = ks0; k0 < ks0 + KT && k0 < kmax; k0 += KB) {
        const __nv_bfloat16* Kc = Ks + (k0 - ks0) * LD;
        const __nv_bfloat16* Vc = Vs + (k0 - ks0) * LD;
        float s[KB / 8][4], dp[KB / 8][4];
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
          if (k0 + j * 8 >= kmax) {
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
            dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
            continue;
          }
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
            if (k0 + kk * 16 >= kmax) break;
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
// Grid (N * n_tiles, H). Warp w owns keys kb0 + 16w .. +16.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bwd_key_bf16(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
                 const float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                 int n_tiles, int causal, float scale) {
  constexpr int LD = D + kPad, CH = D / 8, QT = q_stage<D>(), QB = q_step<D>();
  const int warps = blockDim.x >> 5, k_rows = warps * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + k_rows * LD;
  __nv_bfloat16* Qs = Vs + k_rows * LD;  // q' (biased, scaled)
  __nv_bfloat16* Os = Qs + QT * LD;      // dO
  __nv_bfloat16* Ql = Os + QT * LD;      // q' * (1/l)
  __nv_bfloat16* Ol = Ql + QT * LD;      // dO * (1/l)
  float* st_m = reinterpret_cast<float*>(Ol + QT * LD);
  float* st_d = st_m + QT;
  float* red = st_d + QT;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int kb0 = tile * k_rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const __nv_bfloat16* frame = qkv + size_t(n) * T * rs;
  const __nv_bfloat16* dframe = dout + size_t(n) * T * C;
  const __nv_bfloat16* qb = bias ? bias + h * D : nullptr;
  const __nv_bfloat16* kb = bias ? bias + C + h * D : nullptr;
  const __nv_bfloat16* vb = bias ? bias + 2 * C + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  for (int i = tid; i < k_rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8, row = kb0 + r;
    const __nv_bfloat16* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
    cp_async16(Ks + r * LD + c, src, row < T);
    cp_async16(Vs + r * LD + c, src + C, row < T);
  }

  const int kw = kb0 + warp * 16;
  const bool active = kw < T;
  const int key0 = kw + g, key1 = kw + g + 8;
  uint32_t ka[D / 16][4], va[D / 16][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  const int n_st = (T + QT - 1) / QT;
  // causal: queries before the block's first key see none of its keys
  const int st_first = causal ? kb0 / QT : 0;
  for (int st = st_first; st < n_st; ++st) {
    const int qs0 = st * QT;
    __syncthreads();
    for (int i = tid; i < QT * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8, row = qs0 + r;
      const size_t src = size_t(min(row, T - 1));
      cp_async16(Qs + r * LD + c, frame + src * rs + h * D + c, row < T);
      cp_async16(Os + r * LD + c, dframe + src * C + h * D + c, row < T);
    }
    for (int i = tid; i < QT; i += blockDim.x) {
      const int row = qs0 + i;
      st_m[i] = row < T ? stats[stat_idx(n, h, H, 0, T, row)] : 0.f;
      st_d[i] = row < T ? stats[stat_idx(n, h, H, 2, T, row)] : 0.f;
    }
    cp_async_wait_all();
    if (st == st_first && bias != nullptr) {
      for (int i = tid; i < k_rows * CH; i += blockDim.x) {
        const int r = i / CH, c = (i % CH) * 8;
        if (kb0 + r >= T) continue;
        fix8(Ks + r * LD + c, kb + c, false, scale2);
        fix8(Vs + r * LD + c, vb + c, false, scale2);
      }
    }
    for (int i = tid; i < QT * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8, row = qs0 + r;
      if (row < T) {
        fix8(Qs + r * LD + c, qb ? qb + c : nullptr, true, scale2);
        const __nv_bfloat162 il2 =
            __float2bfloat162_rn(stats[stat_idx(n, h, H, 1, T, row)]);
        scale8(Ql + r * LD + c, Qs + r * LD + c, il2);
        scale8(Ol + r * LD + c, Os + r * LD + c, il2);
      } else {
        *reinterpret_cast<uint4*>(Ql + r * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(Ol + r * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    if (!active) continue;
    if (st == st_first) {
      load_a<D, LD>(ka, Ks + warp * 16 * LD, g, t);
      load_a<D, LD>(va, Vs + warp * 16 * LD, g, t);
    }
    for (int qq = 0; qq < QT && qs0 + qq < T; qq += QB) {
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
          s[j][e] = p;                        // p^T
          dp[j][e] = p * (dp[j][e] - st_d[qi]);  // ds^T
        }
      }
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
        mma_ab<D, LD>(dv, pa, Ol + (qq + kk * 16) * LD, lane);
        mma_ab<D, LD>(dk, dsa, Ql + (qq + kk * 16) * LD, lane);
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
  __syncthreads();  // every warp is done with the shared tiles
  warp_colsum<D>(red + warp * D, dk, kLn2, v0, v1, g, t);
  __syncthreads();
  block_colsum(part + C, red, warps, D, tid, blockDim.x);
  __syncthreads();
  warp_colsum<D>(red + warp * D, dv, 1.f, v0, v1, g, t);
  __syncthreads();
  block_colsum(part + 2 * C, red, warps, D, tid, blockDim.x);
}

// ---------------------------------------------------------------- f32
// One thread per row, plain FMAs. A: 64 query rows per block, keys staged 32
// at a time; B: 64 key rows per block, accumulators in shared memory (two
// D-vectors per thread would not fit in registers at D=128).
constexpr int kF32Rows = 64;
constexpr int kF32Step = 32;

__host__ __device__ inline int f32_tiles(int T) { return (T + kF32Rows - 1) / kF32Rows; }

template <int D>
constexpr size_t f32_query_smem() {
  return sizeof(float) * (2 * size_t(kF32Rows) * (D + 1) + 2 * size_t(kF32Step) * D);
}

template <int D>
__global__ void __launch_bounds__(kF32Rows)
    bwd_query_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                  const float* __restrict__ dout, float* __restrict__ dqkv,
                  float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                  int n_tiles, int causal, float scale, float sm_scale) {
  constexpr int LDQ = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + kF32Rows * LDQ;
  float* Ks = Os + kF32Rows * LDQ;
  float* Vs = Ks + kF32Step * D;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int q0 = tile * kF32Rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const float* frame = qkv + size_t(n) * T * rs;
  const int tid = threadIdx.x, row = q0 + tid;

  for (int i = tid; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D, qrow = q0 + r;
    float qv = 0.f, ov = 0.f;
    if (qrow < T) {
      qv = frame[size_t(qrow) * rs + h * D + c];
      if (bias) qv += bias[h * D + c];
      qv *= scale;
      ov = dout[(size_t(n) * T + qrow) * C + h * D + c];
    }
    Qs[r * LDQ + c] = qv;
    Os[r * LDQ + c] = ov;
  }
  int n_kt = (T + kF32Step - 1) / kF32Step;
  if (causal) n_kt = min(n_kt, (min(q0 + kF32Rows, T) - 1) / kF32Step + 1);
  const float* q = Qs + tid * LDQ;
  const float* o = Os + tid * LDQ;
  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;
  float m = -INFINITY, l = 0.f, tsum = 0.f, delta = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kF32Step;
      __syncthreads();
      for (int i = tid; i < kF32Step * D; i += blockDim.x) {
        const int r = i / D, c = i % D, krow = k0 + r;
        float kv = 0.f, vv = 0.f;
        if (krow < T) {
          kv = frame[size_t(krow) * rs + C + h * D + c];
          vv = frame[size_t(krow) * rs + 2 * C + h * D + c];
          if (bias) {
            kv += bias[C + h * D + c];
            vv += bias[2 * C + h * D + c];
          }
        }
        Ks[i] = kv;
        Vs[i] = vv;
      }
      __syncthreads();
      const int n_keys = min(kF32Step, T - k0);
      for (int j = 0; j < n_keys; ++j) {
        if (causal && k0 + j > row) break;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(q[d], Ks[j * D + d], s);
          dp = fmaf(o[d], Vs[j * D + d], dp);
        }
        if (pass == 0) {
          const float mn = fmaxf(m, s);
          const float a = exp2f(m - mn), p = exp2f(s - mn);
          l = l * a + p;
          tsum = tsum * a + p * dp;
          m = mn;
        } else {
          const float ds = exp2f(s - m) * (dp - delta);
#pragma unroll
          for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, Ks[j * D + d], dq[d]);
        }
      }
    }
    if (pass == 0) {
      l = fmaxf(l, 1e-30f);
      delta = tsum / l;
      l = 1.f / l;
    }
  }
  const float f = sm_scale * l;
  __syncthreads();  // Qs becomes the tile of dq rows for the column sums
  float* qrow = Qs + tid * LDQ;
#pragma unroll
  for (int d = 0; d < D; ++d) qrow[d] = row < T ? dq[d] * f : 0.f;
  if (row < T) {
    float* dst = dqkv + (size_t(n) * T + row) * rs + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = qrow[d];
    stats[stat_idx(n, h, H, 0, T, row)] = m;
    stats[stat_idx(n, h, H, 1, T, row)] = l;
    stats[stat_idx(n, h, H, 2, T, row)] = delta;
  }
  if (partials == nullptr) return;
  __syncthreads();
  float* part = partials + (size_t(n) * n_tiles + tile) * rs + h * D;
  for (int c = tid; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < kF32Rows; ++r) s += Qs[r * LDQ + c];
    part[c] = s;
  }
}

template <int D>
constexpr size_t f32_key_smem() {
  return sizeof(float) * (4 * size_t(kF32Rows) * (D + 1) + 4 * size_t(kF32Step) * D +
                          2 * size_t(kF32Step));
}

template <int D>
__global__ void __launch_bounds__(kF32Rows)
    bwd_key_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                const float* __restrict__ dout, float* __restrict__ dqkv,
                const float* __restrict__ stats, float* __restrict__ partials, int T, int H,
                int n_tiles, int causal, float scale) {
  constexpr int LDK = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kr = reinterpret_cast<float*>(smem_raw);
  float* Vr = Kr + kF32Rows * LDK;
  float* dK = Vr + kF32Rows * LDK;
  float* dV = dK + kF32Rows * LDK;
  float* Qs = dV + kF32Rows * LDK;
  float* Os = Qs + kF32Step * D;
  float* Ql = Os + kF32Step * D;
  float* Ol = Ql + kF32Step * D;
  float* st_m = Ol + kF32Step * D;
  float* st_d = st_m + kF32Step;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int kb0 = tile * kF32Rows, h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const float* frame = qkv + size_t(n) * T * rs;
  const int tid = threadIdx.x, key = kb0 + tid;

  for (int i = tid; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D, krow = kb0 + r;
    float kv = 0.f, vv = 0.f;
    if (krow < T) {
      kv = frame[size_t(krow) * rs + C + h * D + c];
      vv = frame[size_t(krow) * rs + 2 * C + h * D + c];
      if (bias) {
        kv += bias[C + h * D + c];
        vv += bias[2 * C + h * D + c];
      }
    }
    Kr[r * LDK + c] = kv;
    Vr[r * LDK + c] = vv;
    dK[r * LDK + c] = 0.f;
    dV[r * LDK + c] = 0.f;
  }
  const float* kr = Kr + tid * LDK;
  const float* vr = Vr + tid * LDK;
  float* dkr = dK + tid * LDK;
  float* dvr = dV + tid * LDK;
  const int n_qt = (T + kF32Step - 1) / kF32Step;
  for (int qt = causal ? kb0 / kF32Step : 0; qt < n_qt; ++qt) {
    const int qs0 = qt * kF32Step;
    __syncthreads();
    for (int i = tid; i < kF32Step * D; i += blockDim.x) {
      const int r = i / D, c = i % D, qrow = qs0 + r;
      float qv = 0.f, ov = 0.f, il = 0.f;
      if (qrow < T) {
        qv = frame[size_t(qrow) * rs + h * D + c];
        if (bias) qv += bias[h * D + c];
        qv *= scale;
        ov = dout[(size_t(n) * T + qrow) * C + h * D + c];
        il = stats[stat_idx(n, h, H, 1, T, qrow)];
      }
      Qs[i] = qv;
      Os[i] = ov;
      Ql[i] = qv * il;
      Ol[i] = ov * il;
    }
    for (int i = tid; i < kF32Step; i += blockDim.x) {
      const int qrow = qs0 + i;
      st_m[i] = qrow < T ? stats[stat_idx(n, h, H, 0, T, qrow)] : 0.f;
      st_d[i] = qrow < T ? stats[stat_idx(n, h, H, 2, T, qrow)] : 0.f;
    }
    __syncthreads();
    if (key >= T) continue;
    const int n_q = min(kF32Step, T - qs0);
    for (int j = 0; j < n_q; ++j) {
      if (causal && key > qs0 + j) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], Qs[j * D + d], s);
        dp = fmaf(vr[d], Os[j * D + d], dp);
      }
      const float p = exp2f(s - st_m[j]);
      const float ds = p * (dp - st_d[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dvr[d] = fmaf(p, Ol[j * D + d], dvr[d]);
        dkr[d] = fmaf(ds, Ql[j * D + d], dkr[d]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) dkr[d] = key < T ? dkr[d] * kLn2 : 0.f;
  if (key < T) {
    float* dst = dqkv + (size_t(n) * T + key) * rs + C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dst[d] = dkr[d];
      dst[C + d] = dvr[d];
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) dvr[d] = 0.f;
  }
  if (partials == nullptr) return;
  __syncthreads();
  float* part = partials + (size_t(n) * n_tiles + tile) * rs + h * D;
  for (int c = tid; c < D; c += blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < kF32Rows; ++r) {
      sk += dK[r * LDK + c];
      sv += dV[r * LDK + c];
    }
    part[C + c] = sk;
    part[2 * C + c] = sv;
  }
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

template <int D>
cudaError_t launch_bf16(const void* qkv, const void* bias, const void* dout, void* dqkv,
                        float* stats, float* partials, int N, int T, int H, int causal,
                        float scale, float sm_scale, cudaStream_t stream) {
  constexpr int LD = D + kPad;
  using bf = __nv_bfloat16;
  const Geometry geo = bf16_geometry(T);
  const int rows = 16 * geo.warps;
  const dim3 grid(N * geo.n_tiles, H);
  const size_t smem_a =
      sizeof(bf) * size_t(2 * rows + 2 * min(kv_stage<D>(), (T + 15) & ~15)) * LD +
      sizeof(float) * geo.warps * D;
  cudaError_t err = set_smem(bwd_query_bf16<D>, smem_a);
  if (err != cudaSuccess) return err;
  bwd_query_bf16<D><<<grid, geo.warps * 32, smem_a, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(bias), static_cast<const bf*>(dout),
      static_cast<bf*>(dqkv), stats, partials, T, H, geo.n_tiles, causal, scale, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_b = sizeof(bf) * size_t(2 * rows + 4 * q_stage<D>()) * LD +
                        sizeof(float) * (2 * q_stage<D>() + geo.warps * D);
  if ((err = set_smem(bwd_key_bf16<D>, smem_b)) != cudaSuccess) return err;
  bwd_key_bf16<D><<<grid, geo.warps * 32, smem_b, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(bias), static_cast<const bf*>(dout),
      static_cast<bf*>(dqkv), stats, partials, T, H, geo.n_tiles, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* qkv, const void* bias, const void* dout, void* dqkv,
                       float* stats, float* partials, int N, int T, int H, int causal,
                       float scale, float sm_scale, cudaStream_t stream) {
  const int n_tiles = f32_tiles(T);
  const dim3 grid(N * n_tiles, H);
  cudaError_t err = set_smem(bwd_query_f32<D>, f32_query_smem<D>());
  if (err != cudaSuccess) return err;
  bwd_query_f32<D><<<grid, kF32Rows, f32_query_smem<D>(), stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<float*>(dqkv), stats, partials, T, H,
      n_tiles, causal, scale, sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(bwd_key_f32<D>, f32_key_smem<D>())) != cudaSuccess) return err;
  bwd_key_f32<D><<<grid, kF32Rows, f32_key_smem<D>(), stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<float*>(dqkv), stats, partials, T, H,
      n_tiles, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per frame and head along the sequence: the partials buffer has
// N * short_attention_bwd_tiles(T, is_bf16) rows of 3*H*D floats.
int short_attention_bwd_tiles(int T, int is_bf16) {
  return is_bf16 ? bf16_geometry(T).n_tiles : f32_tiles(T);
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
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    switch (D) {
      case 32: err = launch_bf16<32>(qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st); break;
      case 64: err = launch_bf16<64>(qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st); break;
      case 128: err = launch_bf16<128>(qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st); break;
    }
  } else {
    switch (D) {
      case 32: err = launch_f32<32>(qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st); break;
      case 64: err = launch_f32<64>(qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st); break;
      case 128: err = launch_f32<128>(qkv, bias, dout, dqkv, sp, pp, N, T, H, causal, scale, sm_scale, st); break;
    }
  }
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

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
