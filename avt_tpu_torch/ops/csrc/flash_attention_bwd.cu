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
// its bytes: bound by operations. The dq side does 3 of the 7 products (s,
// dp, dq: 25.8 GFLOP, 0.385 ms), the dk/dv side 4 (s, dp, dk, dv: 34.4
// GFLOP, 0.513 ms); each is bound by operations on the FMA units.
//
// Both sides are tiled in registers (flash_attention_common.cuh has the
// tiles and why): the FMA units do 4 warp-FMAs a clock on an SM, shared
// memory gives one 128-byte wavefront a clock, so a loop that loads more than
// one wavefront per 4 warp-FMAs is paced by shared memory, as the first dq
// side (one key a lane, 1 query row a warp at D=1024) was. Both sides are
// one tiling with the roles swapped.
//
// The dq side keeps BM rows of q' and dO (32 at D=512, 16 at D=1024; 128 KB)
// and steps over BN-row tiles of K and V (16 and 8 rows; 64 KB). Per tile:
//   1. S = q' . K^T, then dP = dO . V^T, each BN x BM, from the score
//      partials (per 4 values of d, 8 wavefronts for 64 FMAs a lane).
//   2. p = exp(S - lse) and ds = p * (dP - delta), rounded to the storage
//      type, into a BN x BM tile of its own. V is done with: the next
//      tile's V comes in meanwhile (f32 by cp.async; there is no room for a
//      second K buffer, so K's loads are not overlapped).
//   3. dq += ds . K: a thread owns 8 query rows x CT columns (64
//      accumulators at D >= 256); per key 2 broadcast loads of ds and CT/4
//      float4 loads of K feed 8 * CT FMAs.
// 221,440 bytes of shared memory at D=512, 204,416 at D=1024.
//
// The dk/dv side keeps BM key rows of K and V (BM * D = 16384, at most 64:
// 32 at D=512, 16 at D=1024; 128 KB) and steps over BN-row tiles of q' and
// dO (BN * D = 8192, at most 32; 64 KB), rows padded by 4 floats. Per tile:
//   0. q', dO, lse and delta come in (load_rows keeps 4 of a thread's
//      global loads in flight: with one block an SM, one at a time left the
//      FMA units waiting; PERF.md has the times of both).
//   1. S = K . q'^T and then dP = V . dO^T, each BN x BM, from the score
//      partials (a lane a 4 x 4 block, 2 x 2 at D=1024).
//   2. p = exp(S - lse) and ds = p * (dP - delta), rounded to the storage
//      type, into a small BN x BM tile that takes the partials' place.
//   3. dv += p^T . dO and dk += ds^T . q': a thread owns 8 key rows x CT
//      columns of dk and of dv (CT = 8 at D >= 256: 128 accumulators); per
//      query each q'/dO value feeds 8 FMAs and each p/ds value, a broadcast,
//      feeds CT.
// 218 KB of shared memory at D=256 and 512, 204 KB at D=1024: one block an SM.
// Measured times are in PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_bwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <int D>
struct DqSmem {
  using L = Tiling<D>;
  static constexpr size_t bytes =
      sizeof(float) * (size_t(2 * L::BM + 2 * L::BN) * L::KS +
                       size_t(L::NSL + 1) * L::BN * L::PS + 2 * L::BM);
  static_assert(bytes <= kMaxSmem, "shared memory");
};

template <int D>
struct DkvSmem {
  using L = Tiling<D>;
  static constexpr size_t bytes =
      sizeof(float) * (size_t(2 * L::BM + 2 * L::BN) * L::KS + size_t(L::NSL) * L::BN * L::PS +
                       2 * L::BN);
  static_assert(bytes <= kMaxSmem, "shared memory");
};

// dq for BM query rows; steps over BN-row key tiles (the note at the top).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, View qv, View kv, View vv,
             View dov, Geometry g, int q_tiles, float q_scale, float dq_scale) {
  using L = Tiling<D>;
  constexpr int BM = L::BM, BN = L::BN, KS = L::KS, PS = L::PS, RT = L::RT, CT = L::CT;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BM x KS, scaled q
  float* do_s = q_s + BM * KS;                   // BM x KS
  float* k_s = do_s + BM * KS;                   // BN x KS
  float* v_s = k_s + BN * KS;                    // BN x KS
  float* part = v_s + BN * KS;                   // NSL x BN x PS score partials
  float* ds_s = part + L::NSL * BN * PS;         // BN x PS, ds rounded
  float* lse_s = ds_s + BN * PS;                 // BM
  float* delta_s = lse_s + BM;                   // BM

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BM;
  const int b = bh / g.H, h = bh % g.H;
  const T* kb = k + b * kv.sb + h * D;
  const T* vb = v + b * vv.sb + h * D;
  if (tid < BM) {
    const int qpos = q0 + tid;
    const bool real = qpos < g.Tq;
    lse_s[tid] = real ? lse[(long long)bh * g.Tq + qpos] : 0.f;
    delta_s[tid] = real ? delta[(long long)bh * g.Tq + qpos] : 0.f;
  }
  load_rows<T, D, BM>(q_s, KS, q + b * qv.sb + h * D, qv.st, q0, g.Tq, q_scale);
  load_rows<T, D, BM>(do_s, KS, dout + b * dov.sb + h * D, dov.st, q0, g.Tq, 0.f);

  const Place<L> at(tid);
  float* my_part = part + at.slice * BN * PS + at.br * PS + at.ar;
  float acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = g.causal ? min(g.Tk, q0 + BM) : g.Tk;
  fetch_rows<T, D, BN>(v_s, KS, vb, vv.st, 0, g.Tk);
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the last tile's K and ds reads are done
    load_rows<T, D, BN>(k_s, KS, kb, kv.st, k0, g.Tk, 0.f);
    wait_copies();
    __syncthreads();
    score_partials<L>(my_part, q_s + at.ar * KS + at.d0, k_s + at.br * KS + at.d0);
    __syncthreads();
    float s[L::EPT], dp[L::EPT];
    sum_partials<L>(s, part);
    __syncthreads();  // the score partials are read
    score_partials<L>(my_part, do_s + at.ar * KS + at.d0, v_s + at.br * KS + at.d0);
    __syncthreads();  // V is read: the next tile's comes in while this one ends
    if (k0 + BN < kv_end) fetch_rows<T, D, BN>(v_s, KS, vb, vv.st, k0 + BN, g.Tk);
    sum_partials<L>(dp, part);
#pragma unroll
    for (int m = 0; m < L::EPT; ++m) {
      const int e = tid + m * kThreads;
      if (e < BM * BN) {
        const int j = e / BM, i = e % BM;
        const int qpos = q0 + i, kpos = k0 + j;
        const bool keep = qpos < g.Tq && kpos < g.Tk && (!g.causal || kpos <= qpos);
        const float pr = keep ? expf(s[m] - lse_s[i]) : 0.f;
        ds_s[j * PS + i] = round_to<T>(pr * (dp[m] - delta_s[i]));
      }
    }
    __syncthreads();  // ds is in place
    const int kn = min(BN, kv_end - k0);  // later keys have ds = 0
    for (int j = 0; j < kn; ++j)
      fma_step<L>(acc, ds_s + j * PS + at.tr * RT, k_s + j * KS + at.tc * L::VEC);
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = at.tr * RT + r;
    if (q0 + i >= g.Tq) continue;
    T* row = dq + ((long long)(b * g.Tq + q0 + i) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) row[at.col(c)] = from_float<T>(acc[r][c] * dq_scale);
  }
}

// dk and dv for BM key rows; steps over BN-row query tiles (the note at the top).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              View qv, View kv, View vv, View dov, Geometry g, int k_tiles, float q_scale) {
  using L = Tiling<D>;
  constexpr int BK = L::BM, BQ = L::BN, KS = L::KS, PS = L::PS, RT = L::RT, CT = L::CT;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // BK x KS
  float* v_s = k_s + BK * KS;                     // BK x KS
  float* q_s = v_s + BK * KS;                     // BQ x KS, scaled q
  float* do_s = q_s + BQ * KS;                    // BQ x KS
  float* part = do_s + BQ * KS;                   // NSL x BQ x PS partial scores,
  float* p_s = part;                              // then p (BQ x PS)
  float* ds_s = part + BQ * PS;                   // and ds (BQ x PS)
  float* lse_s = part + L::NSL * BQ * PS;         // BQ
  float* delta_s = lse_s + BQ;                    // BQ

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * BK;
  const int b = bh / g.H, h = bh % g.H;
  const T* qb = q + b * qv.sb + h * D;
  const T* dob = dout + b * dov.sb + h * D;
  load_rows<T, D, BK>(k_s, KS, k + b * kv.sb + h * D, kv.st, k0, g.Tk, 0.f);
  load_rows<T, D, BK>(v_s, KS, v + b * vv.sb + h * D, vv.st, k0, g.Tk, 0.f);

  // scores: this lane's key rows (kept) and query rows (step); dk and dv:
  // its key rows tr*RT + r and columns at.col(c)
  const Place<L> at(tid);
  float* my_part = part + at.slice * BQ * PS + at.br * PS + at.ar;
  float dk_acc[RT][CT], dv_acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CT; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }

  // causal: query tiles that end before this key tile see none of its keys
  const int q_start = g.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < g.Tq; q0 += BQ) {
    __syncthreads();  // the last tile's q', dO, p and ds reads are done
    if (tid < BQ) {
      const int qpos = q0 + tid;
      const bool real = qpos < g.Tq;
      lse_s[tid] = real ? lse[(long long)bh * g.Tq + qpos] : 0.f;
      delta_s[tid] = real ? delta[(long long)bh * g.Tq + qpos] : 0.f;
    }
    load_rows<T, D, BQ>(q_s, KS, qb, qv.st, q0, g.Tq, q_scale);
    load_rows<T, D, BQ>(do_s, KS, dob, dov.st, q0, g.Tq, 0.f);
    __syncthreads();
    score_partials<L>(my_part, k_s + at.ar * KS + at.d0, q_s + at.br * KS + at.d0);
    __syncthreads();
    float s[L::EPT], dp[L::EPT];
    sum_partials<L>(s, part);
    __syncthreads();  // the score partials are read
    score_partials<L>(my_part, v_s + at.ar * KS + at.d0, do_s + at.br * KS + at.d0);
    __syncthreads();
    sum_partials<L>(dp, part);
    __syncthreads();  // the dP partials are read; p and ds take their place
#pragma unroll
    for (int m = 0; m < L::EPT; ++m) {
      const int e = tid + m * kThreads;
      if (e < BK * BQ) {
        const int i = e / BK, j = e % BK;
        const int qpos = q0 + i, kpos = k0 + j;
        const bool keep = qpos < g.Tq && kpos < g.Tk && (!g.causal || kpos <= qpos);
        const float pr = keep ? expf(s[m] - lse_s[i]) : 0.f;
        p_s[i * PS + j] = round_to<T>(pr);
        ds_s[i * PS + j] = round_to<T>(pr * (dp[m] - delta_s[i]));
      }
    }
    __syncthreads();
    const int qn = min(BQ, g.Tq - q0);  // later rows have p = ds = 0
    for (int i = 0; i < qn; ++i) {
      fma_step<L>(dv_acc, p_s + i * PS + at.tr * RT, do_s + i * KS + at.tc * L::VEC);
      fma_step<L>(dk_acc, ds_s + i * PS + at.tr * RT, q_s + i * KS + at.tc * L::VEC);
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int kpos = k0 + at.tr * RT + r;
    if (kpos >= g.Tk) continue;
    const long long off = ((long long)(b * g.Tk + kpos) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      dk[off + at.col(c)] = from_float<T>(dk_acc[r][c]);
      dv[off + at.col(c)] = from_float<T>(dv_acc[r][c]);
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
  constexpr int BM = Tiling<D>::BM;  // query rows of the dq side, key rows of the dk/dv side
  const int q_tiles = (a.g.Tq + BM - 1) / BM, k_tiles = (a.g.Tk + BM - 1) / BM;
  const unsigned heads = unsigned(a.g.B) * a.g.H;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  constexpr size_t dq_smem = DqSmem<D>::bytes, dkv_smem = DkvSmem<D>::bytes;
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
