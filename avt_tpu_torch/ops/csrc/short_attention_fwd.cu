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
// what each gave. The f32 storage type uses plain FMAs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: short_attention_fwd(...) below; returns cudaGetLastError().

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

// The bf16 kernel's launch at T: the sequence's 16-row groups split evenly
// over the fewest query tiles of at most kMaxWarps warps.
struct FwdLaunch {
  int n_qtiles, warps;
  size_t smem;
};

template <int D>
FwdLaunch bf16_launch(int T) {
  const int groups = (T + 15) / 16;
  const int n_qtiles = (groups + kMaxWarps - 1) / kMaxWarps;
  return {n_qtiles, (groups + n_qtiles - 1) / n_qtiles, bf16_smem_bytes<D>(T)};
}

template <int D>
cudaError_t set_bf16_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(short_attn_fwd_bf16<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int D>
cudaError_t launch_bf16(const void* qkv, const void* bias, void* out, int N, int T,
                        int H, int causal, float scale, cudaStream_t stream) {
  const FwdLaunch geo = bf16_launch<D>(T);
  cudaError_t err = set_bf16_smem<D>(geo.smem);
  if (err != cudaSuccess) return err;
  short_attn_fwd_bf16<D><<<dim3(N * geo.n_qtiles, H), geo.warps * 32, geo.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), T, H, geo.n_qtiles, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t residency_bf16(int T, int* warps, int* smem, int* blocks) {
  const FwdLaunch geo = bf16_launch<D>(T);
  *warps = geo.warps;
  *smem = int(geo.smem);
  cudaError_t err = set_bf16_smem<D>(geo.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, short_attn_fwd_bf16<D>,
                                                       geo.warps * 32, geo.smem);
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

// The bf16 kernel at sequence length T and head dim D: warps a block, its
// dynamic shared memory in bytes, and how many blocks of it one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
int short_attention_fwd_residency(int T, int D, int* warps, int* smem_bytes, int* blocks) {
  switch (D) {
    case 32: return residency_bf16<32>(T, warps, smem_bytes, blocks);
    case 64: return residency_bf16<64>(T, warps, smem_bytes, blocks);
    case 128: return residency_bf16<128>(T, warps, smem_bytes, blocks);
  }
  return int(cudaErrorInvalidValue);
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
