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
// The dq side keeps q' and dO for 8 * RPW query rows (RPW = 2048 / D rows a
// warp, at most 8; 1 at D=1024) and one padded 32-key buffer that holds V
// (for dO . v^T), then K (for the scores and ds . k): 197,120 bytes of
// shared memory at D=512 and 1024, dq in registers (RPW * D / 32 floats a
// thread).
//
// The dk/dv side (DkvTiling below) is tiled in registers, so that every
// shared-memory load feeds several FMAs: the FMA units do 4 warp-FMAs a
// clock on an SM, shared memory gives one 128-byte wavefront a clock, so a
// loop that loads more than one wavefront per 4 warp-FMAs is paced by shared
// memory. A block holds BK key rows of K and V (BK * D = 16384, at most 64:
// 32 at D=512, 16 at D=1024; 128 KB) and steps over BQ-row tiles of q' and dO
// (BQ * D = 8192, at most 32; 64 KB), rows padded by 4 floats. Per tile:
//   0. q', dO, lse and delta come in (load_rows keeps 4 of a thread's
//      global loads in flight: with one block an SM, one at a time left the
//      FMA units waiting; PERF.md has the times of both).
//   1. S = K . q'^T and then dP = V . dO^T, each BK x BQ: the 8 warps split
//      D into NSL slices and the tile into PARTS parts (NSL * PARTS = 8); a
//      lane sums a TK x TQ block (4 x 4; 2 x 2 at D=1024) over its slice
//      from float4 loads, its rows 8 and 4 apart so that the loads hit
//      distinct banks (per 4 values of d a warp loads 8 wavefronts for 64
//      FMAs a lane). The partial sums go through shared memory and are
//      added in a fixed order, slice 0 first.
//   2. p = exp(S - lse) and ds = p * (dP - delta), rounded to the storage
//      type, into a small BQ x BK tile that takes the partials' place.
//   3. dv += p^T . dO and dk += ds^T . q': a thread owns RT = 8 key rows x
//      CT columns of dk and of dv (CT = 8 at D >= 256: 128 accumulators), the
//      columns in float4 groups tc*4 + 4*CG*j so that a warp's q'/dO loads
//      are contiguous; per query each q'/dO value feeds 8 FMAs and each p/ds
//      value, a broadcast, feeds CT.
// 218 KB of shared memory at D=256 and 512, 204 KB at D=1024: one block an SM.
// Measured times are in PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_bwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// Query rows per warp on the dq side: the forward's, but 1 at D=1024, where
// 2 would take 262,656 bytes of shared memory.
template <int D>
__host__ __device__ constexpr int dq_rows_per_warp() {
  return D == 1024 ? 1 : query_rows_per_warp(D);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * size_t(kWarps * dq_rows_per_warp<D>()) * D + size_t(kTile) * padded(D));
}

// The dk/dv side's tiles (see the note at the top).
template <int D>
struct DkvTiling {
  static constexpr int BK = 16384 / D < 64 ? 16384 / D : 64;  // key rows a block
  static constexpr int BQ = 8192 / D < 32 ? 8192 / D : 32;    // query rows a step
  static constexpr int KS = padded(D);                        // floats a K, V, q', dO row
  // scores: a lane's TK x TQ block, a warp's WK x WQ part over D / NSL
  static constexpr int TK = D == 1024 ? 2 : 4, TQ = TK;
  static constexpr int WK = 8 * TK, WQ = 4 * TQ;
  static constexpr int PQ = BQ / WQ, PARTS = (BK / WK) * PQ;
  static constexpr int NSL = kWarps / PARTS, DS = D / NSL;
  static constexpr int PS = BK + 8;  // floats a row of the partial, p and ds tiles
  static constexpr int EPT = (BK * BQ + kThreads - 1) / kThreads;  // scores a thread sums
  // dk and dv: a thread's RT key rows x CT columns, in NV groups of VEC
  static constexpr int RT = 8, RG = BK / RT, CG = kThreads / RG, CT = D / CG;
  static constexpr int VEC = CT < 4 ? CT : 4, NV = CT / VEC;
  static constexpr size_t smem =
      sizeof(float) * (size_t(2 * BK + 2 * BQ) * KS + size_t(NSL) * BQ * PS + 2 * BQ);

  static_assert(BK % WK == 0 && BQ % WQ == 0 && kWarps % PARTS == 0 && NSL >= 2, "score split");
  static_assert(DS % 4 == 0 && BK % RT == 0 && CG * CT == D && CT % VEC == 0, "tiles");
  static_assert(smem <= 232448, "shared memory");
};

// dq for RPW query rows a warp; steps over 32-key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, View qv, View kv, View vv,
             View dov, Geometry g, int q_tiles, float q_scale, float dq_scale) {
  constexpr int RPW = dq_rows_per_warp<D>();
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

// One warp's partial scores of the dk/dv side: a (rows `a`, 8 apart) .
// b (rows 4 apart) over the warp's slice of D, TK x TQ sums a lane, stored
// to `out` (query-major, PS floats a row).
template <int D>
__device__ __forceinline__ void score_partials(float* out, const float* a, const float* b) {
  using L = DkvTiling<D>;
  float acc[L::TK][L::TQ];
#pragma unroll
  for (int i = 0; i < L::TK; ++i) {
#pragma unroll
    for (int j = 0; j < L::TQ; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < L::DS; d += 4) {
    float4 x[L::TK], y[L::TQ];
#pragma unroll
    for (int i = 0; i < L::TK; ++i) x[i] = *reinterpret_cast<const float4*>(a + 8 * i * L::KS + d);
#pragma unroll
    for (int j = 0; j < L::TQ; ++j) y[j] = *reinterpret_cast<const float4*>(b + 4 * j * L::KS + d);
#pragma unroll
    for (int i = 0; i < L::TK; ++i) {
#pragma unroll
      for (int j = 0; j < L::TQ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::TK; ++i) {
#pragma unroll
    for (int j = 0; j < L::TQ; ++j) out[4 * j * L::PS + 8 * i] = acc[i][j];
  }
}

// The scores of this thread's entries e = threadIdx.x + m * kThreads of the
// BQ x BK tile (query-major): the NSL partials added in slice order.
template <int D>
__device__ __forceinline__ void sum_partials(float (&x)[DkvTiling<D>::EPT], const float* part) {
  using L = DkvTiling<D>;
#pragma unroll
  for (int m = 0; m < L::EPT; ++m) {
    const int e = threadIdx.x + m * kThreads;
    x[m] = 0.f;
    if (e < L::BK * L::BQ) {
      const int at = (e / L::BK) * L::PS + e % L::BK;
      float t = part[at];
#pragma unroll
      for (int sl = 1; sl < L::NSL; ++sl) t += part[sl * L::BQ * L::PS + at];
      x[m] = t;
    }
  }
}

// V consecutive floats from shared memory (16- or 8-byte aligned).
template <int V>
__device__ __forceinline__ void load_vec(float* x, const float* src) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    static_assert(V == 2, "2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x, x[1] = t.y;
  }
}

// dk and dv for BK key rows; steps over BQ-row query tiles (DkvTiling).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              View qv, View kv, View vv, View dov, Geometry g, int k_tiles, float q_scale) {
  using L = DkvTiling<D>;
  constexpr int BK = L::BK, BQ = L::BQ, KS = L::KS, PS = L::PS;
  constexpr int RT = L::RT, CT = L::CT, CG = L::CG, VEC = L::VEC;
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

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * BK;
  const int b = bh / g.H, h = bh % g.H;
  const T* qb = q + b * qv.sb + h * D;
  const T* dob = dout + b * dov.sb + h * D;
  load_rows<T, D, BK>(k_s, KS, k + b * kv.sb + h * D, kv.st, k0, g.Tk, 0.f);
  load_rows<T, D, BK>(v_s, KS, v + b * vv.sb + h * D, vv.st, k0, g.Tk, 0.f);

  // scores: this warp's part of the tile and slice of D, the lane's first
  // key and query rows
  const int part_id = warp % L::PARTS, slice = warp / L::PARTS;
  const int kr = (part_id / L::PQ) * L::WK + lane % 8;
  const int qr = (part_id % L::PQ) * L::WQ + lane / 8;
  const int d0 = slice * L::DS;
  float* my_part = part + slice * BQ * PS + qr * PS + kr;
  // dk and dv: this thread's key rows tr*RT + r and columns
  // j*CG*VEC + tc*VEC + e
  const int tr = tid / CG, tc = tid % CG;
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
    score_partials<D>(my_part, k_s + kr * KS + d0, q_s + qr * KS + d0);
    __syncthreads();
    float s[L::EPT], dp[L::EPT];
    sum_partials<D>(s, part);
    __syncthreads();  // the score partials are read
    score_partials<D>(my_part, v_s + kr * KS + d0, do_s + qr * KS + d0);
    __syncthreads();
    sum_partials<D>(dp, part);
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
      float pi[RT], dsi[RT], qi[CT], di[CT];
#pragma unroll
      for (int r = 0; r < RT; r += 4) {
        load_vec<4>(pi + r, p_s + i * PS + tr * RT + r);
        load_vec<4>(dsi + r, ds_s + i * PS + tr * RT + r);
      }
#pragma unroll
      for (int j = 0; j < L::NV; ++j) {
        load_vec<VEC>(qi + j * VEC, q_s + i * KS + j * CG * VEC + tc * VEC);
        load_vec<VEC>(di + j * VEC, do_s + i * KS + j * CG * VEC + tc * VEC);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          dv_acc[r][c] = fmaf(pi[r], di[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsi[r], qi[c], dk_acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int kpos = k0 + tr * RT + r;
    if (kpos >= g.Tk) continue;
    const long long off = ((long long)(b * g.Tk + kpos) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = (c / VEC) * CG * VEC + tc * VEC + c % VEC;
      dk[off + col] = from_float<T>(dk_acc[r][c]);
      dv[off + col] = from_float<T>(dv_acc[r][c]);
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
  constexpr int BQ = kWarps * dq_rows_per_warp<D>();
  constexpr int BK = DkvTiling<D>::BK;
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
  constexpr size_t dkv_smem = DkvTiling<D>::smem;
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
