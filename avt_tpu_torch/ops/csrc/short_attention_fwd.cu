// Packed short-sequence attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel avt_tpu/ops/flash_attention.py:_short_fwd_kernel_paired
// (and its unpaired twin _short_fwd_kernel), both launched by
// _short_attention_fwd_call.
//
// Function. qkv is (N, T, 3C) with C = H*D: the fused qkv projection, thirds
// q | k | v along the last axis, head h at lanes [hD, (h+1)D) of each third.
// It is read in place (no split, transpose or pad copy); out is (N, T, C).
//   q' = q * (sm_scale * log2 e)           rounded to the storage type
//   s  = q' . k^T                          f32
//   p  = exp2(s - rowmax(s))               f32; keys >= T (and, if causal,
//                                          keys after the query) masked
//   out = (p . v) / rowsum(p)              p rounded to the storage type for
//                                          the product, f32 accumulation,
//                                          normalised after PV
// An optional bias (3C) is added to q, k and v in the storage type as they are
// loaded: the qkv projection's bias, as packed_qkv_bias_attention adds it
// before the kernel. The scores and probabilities never reach device memory.
//
// Bound on the H100. The kernel must read the qkv once and write the output
// once, N*T*4C*s bytes, and does 4*N*H*T^2*D FLOPs: T/2 FLOP per byte in bf16,
// 98.5 at the ViT-B/16 shape (T=197, H=12, D=64), against the card's ~295
// (989 TFLOP/s over 3.35 TB/s). So it is bound by memory traffic, and the
// design keeps its traffic at that minimum: one block per (frame, head) covers
// the whole sequence (16 query rows per warp, 13 warps at T=197), so each
// head's q, k and v are read once; they are staged in shared memory with
// cp.async, all copies in flight at once; the scores stay in registers with an
// online softmax over 64-key steps; each output is written once. bf16
// products run on the tensor cores with mma.sync m16n8k16 (f32 accumulation,
// fragments through ldmatrix); the f32 storage type uses plain FMAs. Measured
// times and the bound are in PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: short_attention_fwd(...) below; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;           // keys per compute step
constexpr int kPad = 8;           // bf16 of padding per shared row: 16 bytes,
                                  // which makes the fragment loads conflict-free

// Two floats as one register of two bf16, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for a 16x16 bf16 tile a (row-major fragment), a 16x8 bf16 tile b
// (column fragment) and a 16x8 f32 tile c.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 bf16 tiles from shared memory: lanes 8i..8i+7 give the row
// addresses of tile i, and lane 4g+t gets elements (g, 2t) and (g, 2t+1) of
// each tile, the B fragment layout of mma.m16n8k16 for a K stored [key][dim].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four 8x8 bf16 tiles from shared memory, transposed: lanes 8i..8i+7 give the
// row addresses of tile i, and each lane gets two vertically adjacent
// elements of each tile, which is the B fragment layout of mma.m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Query rows per block are 16 per warp, up to max_warps warps: one block
// covers a whole ViT sequence (T=197 -> 13 warps), so each head's keys and
// values are read from memory and staged once for all its queries. The
// register budget (65536 per SM) halves the warps at D=128.
template <int D>
constexpr int max_warps() {
  return D > 64 ? 8 : 16;
}

constexpr int kKT = 256;  // keys staged in shared memory at once

template <int D>
size_t bf16_smem_bytes(int q_rows, int kv_rows) {
  return sizeof(__nv_bfloat16) * size_t(q_rows + 2 * kv_rows) * (D + kPad);
}

// Grid (N * n_qtiles, H), 2 * q_rows threads. Warp w owns query rows
// [q0 + 16w, q0 + 16w + 16) of frame n, head h. Fragment layouts are those of
// mma.m16n8k16: lane = 4*g + t holds rows g and g+8, columns 2t, 2t+1 (+8).
template <int D>
__global__ void __launch_bounds__(max_warps<D>() * 32)
    short_attn_fwd_bf16(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int T, int H,
                        int n_qtiles, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + kPad;  // row stride of Qs, Ks and Vs
  constexpr int CH = D / 8;     // 16-byte chunks in one head row
  const int q_rows = (blockDim.x >> 5) * 16;
  const int kv_rows = min(kKT, (T + 15) & ~15);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + q_rows * LD;
  __nv_bfloat16* Vs = Ks + kv_rows * LD;

  const int n = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * q_rows;
  const int h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);  // row stride of qkv
  const __nv_bfloat16* frame = qkv + size_t(n) * T * rs;
  const __nv_bfloat16* qb = bias ? bias + h * D : nullptr;
  const __nv_bfloat16* kb = bias ? bias + C + h * D : nullptr;
  const __nv_bfloat16* vb = bias ? bias + 2 * C + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  // the copies of the query tile and of the first key/value tile are all in
  // flight at once (cp.async); rows past the sequence are zero-filled
  for (int i = tid; i < q_rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
    cp_async16(Qs + r * LD + c, frame + size_t(min(row, T - 1)) * rs + h * D + c, row < T);
  }

  const int qw = q0 + warp * 16;  // this warp's first query row
  const bool active = qw < T;     // warps past the sequence only help staging
  const int row0 = qw + g, row1 = qw + g + 8;
  // keys at or past kmax are masked for every row of this warp
  const int kmax = causal ? min(T, qw + 16) : T;
  uint32_t qa[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int n_st = (T + kKT - 1) / kKT;  // staged key tiles
  if (causal) n_st = min(n_st, (min(q0 + q_rows, T) - 1) / kKT + 1);
  for (int st = 0; st < n_st; ++st) {
    const int ks0 = st * kKT;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kv_rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8, row = ks0 + r;
      const __nv_bfloat16* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
      cp_async16(Ks + r * LD + c, src, row < T);
      cp_async16(Vs + r * LD + c, src + C, row < T);
    }
    cp_async_wait_all();
    // each thread finishes the chunks it copied: the bias add (and q's
    // scaling) in the storage type, as the reference rounds them
    if (st == 0) {
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
    if (!active) continue;
    if (st == 0) {
      const __nv_bfloat16* Qw = Qs + warp * 16 * LD;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = ld_u32(Qw + g * LD + kk * 16 + 2 * t);
        qa[kk][1] = ld_u32(Qw + (g + 8) * LD + kk * 16 + 2 * t);
        qa[kk][2] = ld_u32(Qw + g * LD + kk * 16 + 2 * t + 8);
        qa[kk][3] = ld_u32(Qw + (g + 8) * LD + kk * 16 + 2 * t + 8);
      }
    }

    for (int k0 = ks0; k0 < ks0 + kKT && k0 < kmax; k0 += kBK) {
      const __nv_bfloat16* Kc = Ks + (k0 - ks0) * LD;
      const __nv_bfloat16* Vc = Vs + (k0 - ks0) * LD;
      // s = q' . k^T for this warp's 16 rows and 64 keys; key columns past
      // kmax are left out of the product
      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        if (k0 + j * 8 >= kmax) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
          continue;
        }
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
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool need_mask = causal || k0 + kBK > T;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (need_mask && (key >= T || (causal && key > row))) s[j][e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // a row with every key so far masked keeps max -inf: shift by 0 so
      // that exp2 gives 0 rather than NaN
      const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
      const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = fast_exp2(m0 - sh0), a1 = fast_exp2(m1 - sh1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][0] = fast_exp2(s[j][0] - sh0);
        s[j][1] = fast_exp2(s[j][1] - sh0);
        s[j][2] = fast_exp2(s[j][2] - sh1);
        s[j][3] = fast_exp2(s[j][3] - sh1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      // o += p . v: the score accumulators of key columns [16kk, 16kk+16)
      // are exactly the A fragment of the next product; V's B fragments come
      // from its row-major tile through ldmatrix.trans, two dim-tiles a load
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (k0 + kk * 16 >= kmax) break;
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
          mma_16816(o[j], pa, b[0], b[1]);
          mma_16816(o[j + 1], pa, b[2], b[3]);
        }
      }
    }
  }
  if (!active) return;

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* out0 = out + (size_t(n) * T + row0) * C + h * D + 2 * t;
  __nv_bfloat16* out1 = out + (size_t(n) * T + row1) * C + h * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(out0 + j * 8) = pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(out1 + j * 8) = pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// f32 storage: one thread per query row, plain FMAs, two passes over the keys
// (row max, then exp2 and PV), so p is formed once against the final max as
// in the reference.
constexpr int kF32Rows = 64;
constexpr int kF32Keys = 32;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t(kF32Rows) * (D + 1) + 2 * size_t(kF32Keys) * D);
}

template <int D>
__global__ void __launch_bounds__(kF32Rows)
    short_attn_fwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                       float* __restrict__ out, int T, int H, int n_qtiles,
                       int causal, float scale) {
  constexpr int LDQ = D + 1;  // odd stride: row-per-thread reads are conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kF32Rows * LDQ;
  float* Vs = Ks + kF32Keys * D;

  const int n = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kF32Rows;
  const int h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const float* frame = qkv + size_t(n) * T * rs;
  const int tid = threadIdx.x;
  const int row = q0 + tid;

  for (int i = tid; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D, qrow = q0 + r;
    float v = 0.f;
    if (qrow < T) {
      v = frame[size_t(qrow) * rs + h * D + c];
      if (bias) v += bias[h * D + c];
      v *= scale;
    }
    Qs[r * LDQ + c] = v;
  }

  int n_kt = (T + kF32Keys - 1) / kF32Keys;
  if (causal) n_kt = min(n_kt, (min(q0 + kF32Rows, T) - 1) / kF32Keys + 1);
  const float* q = Qs + tid * LDQ;

  float m = -INFINITY;
  for (int pass = 0; pass < 2; ++pass) {
    float o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = 0.f;
    float l = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kF32Keys;
      __syncthreads();
      for (int i = tid; i < kF32Keys * D; i += blockDim.x) {
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
      const int n_keys = min(kF32Keys, T - k0);
      for (int j = 0; j < n_keys; ++j) {
        const int key = k0 + j;
        if (causal && key > row) break;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(q[d], Ks[j * D + d], s);
        if (pass == 0) {
          m = fmaxf(m, s);
        } else {
          const float p = exp2f(s - m);
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) o[d] = fmaf(p, Vs[j * D + d], o[d]);
        }
      }
    }
    if (pass == 1 && row < T) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      float* dst = out + (size_t(n) * T + row) * C + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) dst[d] = o[d] * inv;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* qkv, const void* bias, void* out, int N, int T,
                        int H, int causal, float scale, cudaStream_t stream) {
  // split the sequence's 16-row groups evenly over the fewest query tiles
  const int groups = (T + 15) / 16;
  const int n_qtiles = (groups + max_warps<D>() - 1) / max_warps<D>();
  const int warps = (groups + n_qtiles - 1) / n_qtiles;
  const int q_rows = 16 * warps;
  const size_t smem = bf16_smem_bytes<D>(q_rows, min(kKT, (T + 15) & ~15));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        short_attn_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  short_attn_fwd_bf16<D><<<dim3(N * n_qtiles, H), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), T, H, n_qtiles, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* qkv, const void* bias, void* out, int N, int T,
                       int H, int causal, float scale, cudaStream_t stream) {
  const int n_qtiles = (T + kF32Rows - 1) / kF32Rows;
  const size_t smem = f32_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        short_attn_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  short_attn_fwd_f32<D><<<dim3(N * n_qtiles, H), kF32Rows, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<float*>(out), T, H, n_qtiles, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (N, T, 3*H*D) and out (N, T, H*D), contiguous, 16-byte aligned; bias
// (3*H*D) or NULL. is_bf16 selects bf16 (1) or f32 (0) storage; D is 32, 64
// or 128. scale is sm_scale*log2(e) already rounded to the storage type.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for an unsupported D.
int short_attention_fwd(const void* qkv, const void* bias, void* out, int N, int T,
                        int H, int D, int is_bf16, int causal, float scale,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (D) {
      case 32: return launch_bf16<32>(qkv, bias, out, N, T, H, causal, scale, st);
      case 64: return launch_bf16<64>(qkv, bias, out, N, T, H, causal, scale, st);
      case 128: return launch_bf16<128>(qkv, bias, out, N, T, H, causal, scale, st);
    }
  } else {
    switch (D) {
      case 32: return launch_f32<32>(qkv, bias, out, N, T, H, causal, scale, st);
      case 64: return launch_f32<64>(qkv, bias, out, N, T, H, causal, scale, st);
      case 128: return launch_f32<128>(qkv, bias, out, N, T, H, causal, scale, st);
    }
  }
  return int(cudaErrorInvalidValue);
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
