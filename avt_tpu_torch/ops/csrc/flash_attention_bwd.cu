// Blocked flash-attention recompute backward for Hopper (sm_90a).
//
// Replaces the TPU kernels avt_tpu/ops/flash_attention.py:_dq_kernel and
// _dkv_kernel, both launched by _flash_attention_bwd. On the port's main path
// it is the backward of AVT-h's attention (GPT-2, causal) over 128 or more
// observed features: (B, T, H, D) = (64, 256, 4, 512) in f32 for expts/02 at
// 256 s of context. One entry point launches both kernels on the stream.
//
// Function, in the TPU kernels' order (flash_attention_common.cuh has the
// layout and the work split). From the forward's inputs, its logsumexp lse
// and delta = rowsum(dO . O) in f32 (computed by the caller, as _fa_bwd does):
//   q' = q * sm_scale                 rounded to the storage type
//   p  = exp(q' . k^T - lse)          recomputed, f32; masked scores -1e30
//   ds = p * (dO . v^T - delta)       f32
//   dq = (ds . k) * sm_scale          ds rounded to the storage type; the
//                                     scale an f32 here, as in _dq_kernel
//   dk = ds^T . q'                    ds rounded; q' gets no further scale
//   dv = p^T . dO                     p rounded
// Each result is accumulated in f32 and rounded once on store. Query rows
// past Tq contribute nothing.
//
// Hopper runs blocks in no order, so nothing is summed across blocks: the dq
// side (one block per query tile, stepping over key tiles) owns its dq rows,
// and the dk/dv side (one block per key tile, stepping over query tiles) owns
// its dk and dv rows. The result has the same bits run to run (no atomics).
// Both sides recompute the scores and dO . v^T: 7 products of T x T x D where
// the function needs 5, the price of no cross-block sum and no T x T matrix
// in device memory.
//
// Bound on the H100. 10*B*H*Tq*Tk*D FLOPs for the 5 products (half when
// causal) over the bytes of q, k, v, dO, lse, delta, dq, dk, dv: (64, 4, 256,
// 512) in f32 is 43 GFLOP causal, 0.64 ms at 67 TFLOP/s, against 0.24 ms for
// its bytes: bound by operations. Head dim 512 sets the tiling. The dq side
// keeps q' and dO for 32 query rows (64 KB each in f32) and one padded 32-key
// buffer that holds V (for dO . v^T), then K (for the scores and ds . k):
// 193 KB of shared memory, dq in registers (64 floats a thread). The dk/dv
// side keeps K and V for 16 key rows (32 KB each) and steps over 32-query
// tiles of q' and dO (66 KB each, padded), dk and dv in registers (64 floats
// a thread). Measured times are in PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_bwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * size_t(kWarps * query_rows_per_warp(D)) * D + size_t(kTile) * padded(D));
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * size_t(kWarps * key_rows_per_warp(D)) * D + 2 * size_t(kTile) * padded(D));
}

// dq for RPW query rows a warp; steps over 32-key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, View qv, View kv, View vv,
             View dov, Geometry g, int q_tiles, float q_scale, float dq_scale) {
  constexpr int RPW = query_rows_per_warp(D);
  constexpr int BQ = kWarps * RPW;
  constexpr int NC = D / 32;
  constexpr int KS = padded(D);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BQ x D, scaled q
  float* do_s = q_s + BQ * D;                    // BQ x D
  float* kv_s = do_s + BQ * D;                   // kTile x KS, V then K

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BQ;
  const int b = bh / g.H, h = bh % g.H;
  const T* kb = k + b * kv.sb + h * D;
  const T* vb = v + b * vv.sb + h * D;
  load_rows<T, D, BQ>(q_s, D, q + b * qv.sb + h * D, qv.st, q0, g.Tq, q_scale);
  load_rows<T, D, BQ>(do_s, D, dout + b * dov.sb + h * D, dov.st, q0, g.Tq, 0.f);

  float acc[RPW][NC], row_lse[RPW], row_delta[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q0 + warp * RPW + r;
    const bool real = qpos < g.Tq;
    row_lse[r] = real ? lse[(long long)bh * g.Tq + qpos] : 0.f;
    row_delta[r] = real ? delta[(long long)bh * g.Tq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int kv_end = g.causal ? min(g.Tk, q0 + BQ) : g.Tk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the last tile's K reads are done
    load_rows<T, D, kTile>(kv_s, KS, vb, vv.st, k0, g.Tk, 0.f);
    __syncthreads();
    float dp[RPW];
    dot_rows<D, RPW>(dp, do_s + warp * RPW * D, D, kv_s + lane * KS);
    __syncthreads();  // every warp is done with V
    load_rows<T, D, kTile>(kv_s, KS, kb, kv.st, k0, g.Tk, 0.f);
    __syncthreads();
    float s[RPW];
    dot_rows<D, RPW>(s, q_s + warp * RPW * D, D, kv_s + lane * KS);
    const int kpos = k0 + lane;
    float ds[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + warp * RPW + r;
      const bool keep = kpos < g.Tk && (!g.causal || kpos <= qpos);
      const float p = expf((keep ? s[r] : kNegInf) - row_lse[r]);
      ds[r] = round_to<T>(p * (dp[r] - row_delta[r]));
    }
    const int kn = min(kTile, kv_end - k0);  // later keys have ds = 0
    for (int j = 0; j < kn; ++j) {
      float kj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kj[c] = kv_s[j * KS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q0 + warp * RPW + r;
    if (qpos >= g.Tq) continue;
    T* row = dq + ((long long)(b * g.Tq + qpos) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[lane + 32 * c] = from_float<T>(acc[r][c] * dq_scale);
  }
}

// dk and dv for RPW key rows a warp; steps over 32-query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              View qv, View kv, View vv, View dov, Geometry g, int k_tiles, float q_scale) {
  constexpr int RPW = key_rows_per_warp(D);
  constexpr int BK = kWarps * RPW;
  constexpr int NC = D / 32;
  constexpr int QS = padded(D);
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // BK x D
  float* v_s = k_s + BK * D;                     // BK x D
  float* q_s = v_s + BK * D;                     // kTile x QS, scaled q
  float* do_s = q_s + kTile * QS;                // kTile x QS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * BK;
  const int b = bh / g.H, h = bh % g.H;
  const T* qb = q + b * qv.sb + h * D;
  const T* dob = dout + b * dov.sb + h * D;
  load_rows<T, D, BK>(k_s, D, k + b * kv.sb + h * D, kv.st, k0, g.Tk, 0.f);
  load_rows<T, D, BK>(v_s, D, v + b * vv.sb + h * D, vv.st, k0, g.Tk, 0.f);

  float dk_acc[RPW][NC], dv_acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }
  // causal: query tiles that end before this key tile see none of its keys
  const int q_start = g.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_start; q0 < g.Tq; q0 += kTile) {
    __syncthreads();  // the last tile's q' and dO reads are done
    load_rows<T, D, kTile>(q_s, QS, qb, qv.st, q0, g.Tq, q_scale);
    load_rows<T, D, kTile>(do_s, QS, dob, dov.st, q0, g.Tq, 0.f);
    const int qpos = q0 + lane;
    const bool real = qpos < g.Tq;
    const float q_lse = real ? lse[(long long)bh * g.Tq + qpos] : 0.f;
    const float q_delta = real ? delta[(long long)bh * g.Tq + qpos] : 0.f;
    __syncthreads();
    float s[RPW], dp[RPW];
    dot_rows<D, RPW>(s, k_s + warp * RPW * D, D, q_s + lane * QS);
    dot_rows<D, RPW>(dp, v_s + warp * RPW * D, D, do_s + lane * QS);
    float p[RPW], ds[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int kpos = k0 + warp * RPW + r;
      const bool keep = real && kpos < g.Tk && (!g.causal || kpos <= qpos);
      const float pr = keep ? expf(s[r] - q_lse) : 0.f;
      p[r] = round_to<T>(pr);
      ds[r] = round_to<T>(pr * (dp[r] - q_delta));
    }
    const int qn = min(kTile, g.Tq - q0);
    for (int i = 0; i < qn; ++i) {
      float qi[NC], di[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qi[c] = q_s[i * QS + lane + 32 * c];
        di[c] = do_s[i * QS + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pi = __shfl_sync(kFull, p[r], i);
        const float dsi = __shfl_sync(kFull, ds[r], i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[r][c] = fmaf(pi, di[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsi, qi[c], dk_acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int kpos = k0 + warp * RPW + r;
    if (kpos >= g.Tk) continue;
    const long long off = ((long long)(b * g.Tk + kpos) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + lane + 32 * c] = from_float<T>(dk_acc[r][c]);
      dv[off + lane + 32 * c] = from_float<T>(dv_acc[r][c]);
    }
  }
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
  constexpr int BQ = kWarps * query_rows_per_warp(D);
  constexpr int BK = kWarps * key_rows_per_warp(D);
  const int q_tiles = (a.g.Tq + BQ - 1) / BQ, k_tiles = (a.g.Tk + BK - 1) / BK;
  const unsigned heads = unsigned(a.g.B) * a.g.H;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  cudaError_t err = set_smem(flash_bwd_dq<T, D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, D><<<dim3(q_tiles * heads), kThreads, dq_smem<D>(), stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.qv, a.kv, a.vv, a.dov, a.g,
      q_tiles, a.q_scale, a.dq_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(flash_bwd_dkv<T, D>, dkv_smem<D>())) != cudaSuccess) return err;
  flash_bwd_dkv<T, D><<<dim3(k_tiles * heads), kThreads, dkv_smem<D>(), stream>>>(
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout (B, Tq, H, D) and k, v (B, Tk, H, D): last two axes contiguous,
// batch and sequence strides in elements, rows 16-byte aligned. lse and delta
// (B, H, Tq) f32 contiguous. dq (B, Tq, H, D), dk and dv (B, Tk, H, D)
// contiguous in the storage type. is_bf16 selects bf16 (1) or f32 (0); D is
// 64, 128, 256 or 512; q_scale is 1/sqrt(D) rounded to the storage type,
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
