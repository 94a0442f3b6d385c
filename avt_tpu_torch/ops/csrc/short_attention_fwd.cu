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
// (989 TFLOP/s over 3.35 TB/s). So it is bound by memory traffic.
//
// Design (bf16). What holds such a kernel back on the card is latency, not
// traffic: one warp's online softmax is a chain of dependent steps (the
// score product, the row max across a quad, exp2, the p.v product), and a
// block that stages its keys and then computes leaves the memory pipe idle
// while it computes. So the design keeps many small blocks on each SM, whose
// phases the SM interleaves:
//   - a block holds at most 7 warps of 16 query rows (a T=197 sequence is
//     2 blocks, whose shared key/value reads the L2 serves once), with a
//     register budget for 3 blocks an SM at D=64 (21 warps; 4 at D=32, 2 at
//     D=128: `fwd_cfg`);
//   - a warp's q' fragments come straight from device memory into registers,
//     the bias add and the scaling done there in bf16 (`load_a_global`: the
//     bits of the shared-memory pass it replaces), so only k and v are staged
//     in shared memory (cp.async, all in flight at once, then the bias add
//     on each thread's own chunks);
//   - the online softmax runs in whole 32-key steps with no branch inside a
//     step (`attend_steps`: the staged rows are padded to whole steps and
//     zero-filled), so a step's score tiles are independent chains of
//     mma.sync m16n8k16 the warp interleaves;
//   - each output is written once, the scores never leave registers.
// PERF.md has the levers that were timed (a persistent grid with two
// key/value buffers, whole-sequence blocks, other key steps and budgets) and
// what each gave.
//
// Design (f32). The same 16-row warps and one online-softmax pass, with every
// product on the tensor cores as three TF32 products (hi/lo split of each
// f32 operand; short_attention_common.cuh), which keeps f32's accuracy: in
// f32 the function does 4*N*H*T^2*D FLOPs on 16*N*T*C bytes (T/4 FLOP per
// byte), so at T=197 the FMA pipes (67 TFLOP/s) would bound it at 2.5x the
// memory time, and the three TF32 products (495 TFLOP/s) bring that bound
// down to the memory's. The blocks hold at most 6 warps (3 blocks of 5 at
// T=197; kMaxWarpsF32 says why), 2 an SM at D <= 64 (`f32_fwd_cfg`); k and
// v are staged 128 keys at a time at D=64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: short_attention_fwd(...) below; returns cudaGetLastError().

#include <type_traits>

#include "short_attention_common.cuh"

namespace {

using namespace packed;

// The bf16 kernel's geometry per head dim: blocks of up to kMaxWarps warps
// (16 query rows each), `min_blocks` blocks resident on an SM (the register
// budget), `key_step` keys per step of the online softmax.
constexpr int kMaxWarps = 7;

struct FwdCfg {
  int min_blocks, key_step;
};

template <int D>
__host__ __device__ constexpr FwdCfg fwd_cfg() {
  return D == 32 ? FwdCfg{4, 32} : D == 64 ? FwdCfg{3, 32} : FwdCfg{2, 16};
}

constexpr int kKT = 256;  // keys staged in shared memory at once

// Keys staged at once: whole key steps, zero-filled past T.
template <int D>
__host__ __device__ int kv_rows_of(int T) {
  constexpr int KB = fwd_cfg<D>().key_step;
  return min(kKT, (T + KB - 1) / KB * KB);
}

template <int D>
size_t bf16_smem_bytes(int T) {
  return sizeof(__nv_bfloat16) * size_t(2 * kv_rows_of<D>(T)) * (D + kPad);
}

// Grid (N * n_qtiles, H), 32 * warps threads. Warp w owns query rows
// [q0 + 16w, q0 + 16w + 16) of frame n, head h; its q' fragments come
// straight from device memory into registers (bias and scale applied
// there), while the block stages the head's keys and values in shared
// memory. Fragment layouts are those of mma.m16n8k16: lane = 4*g + t holds
// rows g and g+8, columns 2t, 2t+1 (+8).
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32, fwd_cfg<D>().min_blocks)
    short_attn_fwd_bf16(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int T, int H,
                        int n_qtiles, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + kPad;  // row stride of Ks and Vs
  constexpr int CH = D / 8;     // 16-byte chunks in one head row
  constexpr int KB = fwd_cfg<D>().key_step;
  const int q_rows = (blockDim.x >> 5) * 16;
  const int kv_rows = kv_rows_of<D>(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kv_rows * LD;

  const int n = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * q_rows;
  const int h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);  // row stride of qkv
  const __nv_bfloat16* frame = qkv + size_t(n) * T * rs;
  const __nv_bfloat16* kb = bias ? bias + C + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  // each thread copies one 16-byte column chunk c of every rstep-th row
  const int c = (tid % CH) * 8, rstep = blockDim.x / CH;
  // the copies of one key/value tile are all in flight at once (cp.async);
  // rows past the sequence are zero-filled
  auto stage = [&](int ks0) {
    for (int r = tid / CH; r < kv_rows; r += rstep) {
      const int row = ks0 + r;
      const __nv_bfloat16* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
      cp_async16(Ks + r * LD + c, src, row < T);
      cp_async16(Vs + r * LD + c, src + C, row < T);
    }
  };
  stage(0);

  const int qw = q0 + warp * 16;  // this warp's first query row
  const bool active = qw < T;     // warps past the sequence only help staging
  const int row0 = qw + g, row1 = qw + g + 8;
  // keys at or past kmax are masked for every row of this warp
  const int kmax = causal ? min(T, qw + 16) : T;
  // q' = (q + b_q) * scale while the first tile is in flight
  uint32_t qa[D / 16][4];
  if (active)
    load_a_global<D>(qa, frame + size_t(qw) * rs + h * D, rs, T - qw,
                     bias ? bias + h * D : nullptr, true, scale2, g, t);
  RowState<D> state;
  state.init();

  int n_st = (T + kKT - 1) / kKT;  // staged key tiles
  if (causal) n_st = min(n_st, (min(q0 + q_rows, T) - 1) / kKT + 1);
  for (int st = 0; st < n_st; ++st) {
    const int ks0 = st * kKT;
    if (st > 0) {
      __syncthreads();  // every warp is done with the previous tile
      stage(ks0);
    }
    cp_async_wait_all();
    // each thread adds the bias to the chunks it copied, in the storage
    // type, as the reference rounds it
    if (kb != nullptr) {
      const uint4 bk = *reinterpret_cast<const uint4*>(kb + c);
      const uint4 bv = *reinterpret_cast<const uint4*>(kb + C + c);
      for (int r = tid / CH; r < kv_rows && ks0 + r < T; r += rstep) {
        fix8(Ks + r * LD + c, reinterpret_cast<const __nv_bfloat16*>(&bk), false, scale2);
        fix8(Vs + r * LD + c, reinterpret_cast<const __nv_bfloat16*>(&bv), false, scale2);
      }
    }
    __syncthreads();
    if (active)
      attend_steps<D, KB>(state, qa, Ks, Vs, ks0, min(ks0 + kKT, kmax), T, row0, row1, causal,
                          lane);
  }
  if (!active) return;
  store_rows_bf16<D>(out + (size_t(n) * T + row0) * C + h * D, C, state, row0, row1, T, t);
}

// ---------------------------------------------------------------- f32
// The f32 form on the tensor cores, as three TF32 products
// (short_attention_common.cuh): the bf16 kernel's loop on mma.m16n8k8
// fragments. A warp's q' fragments come from device memory into
// registers, (q + b_q) * scale in f32; the block stages k and v (bias added)
// `kv_stage` keys at a time, padded to whole key steps and zero-filled; one
// online-softmax pass in whole `key_step`-key steps; p . v on the score
// accumulators read as A fragments (`acc_as_a`), normalised after p . v.
// Blocks hold at most kMaxWarpsF32 warps.
struct F32FwdCfg {
  int min_blocks, key_step, kv_stage;
};

template <int D>
__host__ __device__ constexpr F32FwdCfg f32_fwd_cfg() {
  return D == 32 ? F32FwdCfg{2, 32, 256} : D == 64 ? F32FwdCfg{2, 32, 128} : F32FwdCfg{1, 16, 128};
}

template <int D>
__host__ __device__ int f32_kv_rows(int T) {
  constexpr F32FwdCfg cfg = f32_fwd_cfg<D>();
  return min(cfg.kv_stage, (T + cfg.key_step - 1) / cfg.key_step * cfg.key_step);
}

template <int D>
size_t f32_smem_bytes(int T) {
  return sizeof(float) * size_t(2 * f32_kv_rows<D>(T)) * (D + kPadF);
}

// q' fragments (16 rows x D) of a warp, straight from device memory: rows
// from `valid` on are zero; (x + bias) * scale in f32 (bias may be null).
template <int D>
__device__ __forceinline__ void load_q_f32(float (&a)[D / 8][4], const float* rows, size_t ld,
                                           int valid, const float* bias, float scale, int g,
                                           int t) {
  const bool v0 = g < valid, v1 = g + 8 < valid;
  const float* r0 = rows + size_t(g) * ld + t;
  const float* r1 = r0 + 8 * ld;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = kk * 8;
    const float b0 = bias ? __ldg(bias + c + t) : 0.f, b1 = bias ? __ldg(bias + c + t + 4) : 0.f;
    a[kk][0] = v0 ? (__ldg(r0 + c) + b0) * scale : 0.f;
    a[kk][1] = v1 ? (__ldg(r1 + c) + b0) * scale : 0.f;
    a[kk][2] = v0 ? (__ldg(r0 + c + 4) + b1) * scale : 0.f;
    a[kk][3] = v1 ? (__ldg(r1 + c + 4) + b1) * scale : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxWarpsF32 * 32, f32_fwd_cfg<D>().min_blocks)
    short_attn_fwd_tf32(const float* __restrict__ qkv, const float* __restrict__ bias,
                        float* __restrict__ out, int T, int H, int n_qtiles, int causal,
                        float scale) {
  constexpr int LD = D + kPadF;  // row stride of Ks and Vs
  constexpr int CH = D / 4;      // 16-byte chunks in one head row
  constexpr int KB = f32_fwd_cfg<D>().key_step, KT = f32_fwd_cfg<D>().kv_stage;
  const int q_rows = (blockDim.x >> 5) * 16;
  const int kv_rows = f32_kv_rows<D>(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kv_rows * LD;

  const int n = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * q_rows;
  const int h = blockIdx.y;
  const int C = H * D;
  const size_t rs = 3 * size_t(C);
  const float* frame = qkv + size_t(n) * T * rs;
  const float* kb = bias ? bias + C + h * D : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int c = (tid % CH) * 4, rstep = blockDim.x / CH;
  auto stage = [&](int ks0) {
    for (int r = tid / CH; r < kv_rows; r += rstep) {
      const int row = ks0 + r;
      const float* src = frame + size_t(min(row, T - 1)) * rs + C + h * D + c;
      cp_async16(Ks + r * LD + c, src, row < T);
      cp_async16(Vs + r * LD + c, src + C, row < T);
    }
  };
  stage(0);

  const int qw = q0 + warp * 16;
  const bool active = qw < T;
  const int row0 = qw + g, row1 = qw + g + 8;
  const int kmax = causal ? min(T, qw + 16) : T;
  float qa[D / 8][4];
  if (active)
    load_q_f32<D>(qa, frame + size_t(qw) * rs + h * D, rs, T - qw, bias ? bias + h * D : nullptr,
                  scale, g, t);
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int n_st = (T + KT - 1) / KT;
  if (causal) n_st = min(n_st, (min(q0 + q_rows, T) - 1) / KT + 1);
  for (int st = 0; st < n_st; ++st) {
    const int ks0 = st * KT;
    if (st > 0) {
      __syncthreads();  // every warp is done with the previous tile
      stage(ks0);
    }
    cp_async_wait_all();
    if (kb != nullptr) {
      const float4 bk = *reinterpret_cast<const float4*>(kb + c);
      const float4 bv = *reinterpret_cast<const float4*>(kb + C + c);
      for (int r = tid / CH; r < kv_rows && ks0 + r < T; r += rstep) {
        fix4(Ks + r * LD + c, bk, true, false, 1.f);
        fix4(Vs + r * LD + c, bv, true, false, 1.f);
      }
    }
    __syncthreads();
    if (!active) continue;
    // whole steps, no branch inside: keys past T are zero rows, masked
    for (int k0 = ks0; k0 < ks0 + KT && k0 < kmax; k0 += KB) {
      const float* Kc = Ks + (k0 - ks0) * LD;
      const float* Vc = Vs + (k0 - ks0) * LD;
      float s[KB / 8][4];
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const FragA qf = split_a(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
          float b0, b1;
          load_b_nk<LD>(b0, b1, Kc + j * 8 * LD, kk, lane);
          mma3(s[j], qf, b0, b1);
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
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // a row with every key so far masked keeps max -inf: shift by 0
      const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
      const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2f(m0 - sh0), a1 = exp2f(m1 - sh1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
        s[j][0] = exp2f(s[j][0] - sh0);
        s[j][1] = exp2f(s[j][1] - sh0);
        s[j][2] = exp2f(s[j][2] - sh1);
        s[j][3] = exp2f(s[j][3] - sh1);
        ls0 += s[j][0] + s[j][1];
        ls1 += s[j][2] + s[j][3];
      }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
      // o += p . v: key tile j's probabilities are the A fragment, v's rows
      // taken in the matching order
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
        const FragA pa = acc_as_a(s[j]);
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          float b0, b1;
          load_b_kn<LD>(b0, b1, Vc + j * 8 * LD, jd * 8, g, t);
          mma3(o[jd], pa, b0, b1);
        }
      }
    }
  }
  if (!active) return;
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  float* p0 = out + (size_t(n) * T + row0) * C + h * D + 2 * t;
  float* p1 = p0 + 8 * size_t(C);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < T) *reinterpret_cast<float2*>(p0 + j * 8) = make_float2(o[j][0] * inv0, o[j][1] * inv0);
    if (row1 < T) *reinterpret_cast<float2*>(p1 + j * 8) = make_float2(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// The launch at T: the sequence's 16-row groups split evenly over the
// fewest query tiles of at most kMaxWarps (bf16) or kMaxWarpsF32 warps.
struct FwdLaunch {
  int n_qtiles, warps;
  size_t smem;
};

template <bool kBf16, int D>
FwdLaunch fwd_launch(int T) {
  constexpr int max_warps = kBf16 ? kMaxWarps : kMaxWarpsF32;
  const int groups = (T + 15) / 16;
  const int n_qtiles = (groups + max_warps - 1) / max_warps;
  return {n_qtiles, (groups + n_qtiles - 1) / n_qtiles,
          kBf16 ? bf16_smem_bytes<D>(T) : f32_smem_bytes<D>(T)};
}

template <bool kBf16, int D>
auto fwd_kernel() {
  if constexpr (kBf16) {
    return short_attn_fwd_bf16<D>;
  } else {
    return short_attn_fwd_tf32<D>;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <bool kBf16, int D>
cudaError_t launch(const void* qkv, const void* bias, void* out, int N, int T, int H, int causal,
                   float scale, cudaStream_t stream) {
  using S = std::conditional_t<kBf16, __nv_bfloat16, float>;
  const FwdLaunch geo = fwd_launch<kBf16, D>(T);
  const auto kernel = fwd_kernel<kBf16, D>();
  cudaError_t err = set_smem(kernel, geo.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N * geo.n_qtiles, H), geo.warps * 32, geo.smem, stream>>>(
      static_cast<const S*>(qkv), static_cast<const S*>(bias), static_cast<S*>(out), T, H,
      geo.n_qtiles, causal, scale);
  return cudaGetLastError();
}

template <bool kBf16, int D>
cudaError_t residency(int T, int* warps, int* smem, int* blocks) {
  const FwdLaunch geo = fwd_launch<kBf16, D>(T);
  *warps = geo.warps;
  *smem = int(geo.smem);
  const auto kernel = fwd_kernel<kBf16, D>();
  cudaError_t err = set_smem(kernel, geo.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, geo.warps * 32, geo.smem);
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
      case 32: return launch<true, 32>(qkv, bias, out, N, T, H, causal, scale, st);
      case 64: return launch<true, 64>(qkv, bias, out, N, T, H, causal, scale, st);
      case 128: return launch<true, 128>(qkv, bias, out, N, T, H, causal, scale, st);
    }
  } else {
    switch (D) {
      case 32: return launch<false, 32>(qkv, bias, out, N, T, H, causal, scale, st);
      case 64: return launch<false, 64>(qkv, bias, out, N, T, H, causal, scale, st);
      case 128: return launch<false, 128>(qkv, bias, out, N, T, H, causal, scale, st);
    }
  }
  return int(cudaErrorInvalidValue);
}

// The kernel at sequence length T, head dim D and storage type (is_bf16: bf16,
// else f32): warps a block, its dynamic shared memory in bytes, and how many
// blocks of it one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// is_bf16 comes last, so that a caller passing it to a library built from
// sources older than it gets the bf16 form. Returns a cudaError_t.
int short_attention_fwd_residency(int T, int D, int* warps, int* smem_bytes, int* blocks,
                                  int is_bf16) {
  switch (D) {
    case 32: return is_bf16 ? residency<true, 32>(T, warps, smem_bytes, blocks)
                            : residency<false, 32>(T, warps, smem_bytes, blocks);
    case 64: return is_bf16 ? residency<true, 64>(T, warps, smem_bytes, blocks)
                            : residency<false, 64>(T, warps, smem_bytes, blocks);
    case 128: return is_bf16 ? residency<true, 128>(T, warps, smem_bytes, blocks)
                             : residency<false, 128>(T, warps, smem_bytes, blocks);
  }
  return int(cudaErrorInvalidValue);
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
