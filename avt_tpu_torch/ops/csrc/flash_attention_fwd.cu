// Blocked flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel avt_tpu/ops/flash_attention.py:_flash_kernel,
// launched by _flash_attention_fwd. On the port's main path it is the
// attention of AVT-h (GPT-2, causal) over 128 or more observed features:
// (B, T, H, D) = (64, 256, 4, 512) in f32 for expts/02 at 256 s of context.
//
// Function, in the TPU kernel's order (flash_attention_common.cuh has the
// layout and the work split):
//   q' = q * sm_scale                 rounded to the storage type (the scale
//                                     is passed rounded to it too: a Python
//                                     float takes q's dtype in JAX)
//   s  = q' . k^T                     f32; keys >= Tk and, if causal, keys
//                                     after the query get -1e30
//   online softmax over key tiles:    m' = max(m, rowmax s), p = exp(s - m'),
//                                     l = l * exp(m - m') + rowsum p,
//                                     acc = acc * exp(m - m') + p . v with p
//                                     rounded to the storage type
//   out = acc / max(l, 1e-30)         rounded once on store
//   lse = m + log(max(l, 1e-30))      f32, written only when lse != NULL
// The TPU kernel steps over 128 keys, this one over 32: p is formed against
// another running max, which moves the bf16 rounding of p, not the result.
//
// Bound on the H100. 4*B*H*Tq*Tk*D FLOPs (half of it when causal) over the
// bytes of q, k, v and out: (B, H, T, D) = (64, 4, 256, 512) in f32 is 17.2
// GFLOP causal, 0.26 ms at the 67 TFLOP/s of the FMA units, against 0.16 ms
// for its 537 MB: bound by operations. The design: a block takes RPW query
// rows a warp (4 at D=512: 32 rows, a 64 KB f32 tile kept in shared memory),
// steps over 32-key tiles of K and then V through one padded shared buffer,
// keeps the scores in registers (one key a lane) and the output accumulator
// in registers (16 columns a lane at D=512); causal blocks stop at their last
// query. A head dim of 512 is why it is this way: a 64-row tile of q and its
// accumulator would each take 128 KB. At D=1024 (expts/04) a block takes 16
// query rows: 64 KB of q and a 128.5 KB padded K/V tile, 197,120 bytes of
// shared memory. Measured times and the bound are in
// PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_fwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (size_t(kWarps * query_rows_per_warp(D)) * D + size_t(kTile) * padded(D));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, float* __restrict__ lse, View qv, View kv, View vv, Geometry g,
          int q_tiles, float q_scale) {
  constexpr int RPW = query_rows_per_warp(D);
  constexpr int BQ = kWarps * RPW;
  constexpr int NC = D / 32;
  constexpr int KS = padded(D);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BQ x D, scaled q
  float* kv_s = q_s + BQ * D;                    // kTile x KS, K then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BQ;
  const int b = bh / g.H, h = bh % g.H;
  const T* qb = q + b * qv.sb + h * D;
  const T* kb = k + b * kv.sb + h * D;
  const T* vb = v + b * vv.sb + h * D;

  load_rows<T, D, BQ>(q_s, D, qb, qv.st, q0, g.Tq, q_scale);
  float acc[RPW][NC];
  float m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int kv_end = g.causal ? min(g.Tk, q0 + BQ) : g.Tk;
  const float* my_q = q_s + warp * RPW * D;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the last tile's V reads are done
    load_rows<T, D, kTile>(kv_s, KS, kb, kv.st, k0, g.Tk, 0.f);
    __syncthreads();
    float s[RPW];
    dot_rows<D, RPW>(s, my_q, D, kv_s + lane * KS);
    __syncthreads();  // every warp is done with K
    load_rows<T, D, kTile>(kv_s, KS, vb, vv.st, k0, g.Tk, 0.f);
    const int kpos = k0 + lane;
    float p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + warp * RPW + r;
      const bool keep = kpos < g.Tk && (!g.causal || kpos <= qpos);
      const float sv = keep ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float pr = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
      p[r] = round_to<T>(pr);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // V is in place
    const int kn = min(kTile, kv_end - k0);  // later keys have p = 0
    for (int j = 0; j < kn; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vj[c] = kv_s[j * KS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q0 + warp * RPW + r;
    if (qpos >= g.Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = out + ((long long)(b * g.Tq + qpos) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[lane + 32 * c] = from_float<T>(acc[r][c] / lc);
    if (lse != nullptr && lane == 0) lse[(long long)bh * g.Tq + qpos] = m[r] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   View qv, View kv, View vv, Geometry g, float q_scale, cudaStream_t stream) {
  constexpr int BQ = kWarps * query_rows_per_warp(D);
  const int q_tiles = (g.Tq + BQ - 1) / BQ;
  cudaError_t err = set_smem(flash_fwd<T, D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  flash_fwd<T, D><<<dim3(unsigned(q_tiles) * g.B * g.H), kThreads, fwd_smem<D>(), stream>>>(
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
