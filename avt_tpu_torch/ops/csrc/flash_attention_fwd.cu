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
// The TPU kernel steps over 128 keys, this one over BN (16 at D=512): p is
// formed against another running max, which moves the bf16 rounding of p,
// not the result.
//
// Bound on the H100. 4*B*H*Tq*Tk*D FLOPs (half of it when causal) over the
// bytes of q, k, v and out: (B, H, T, D) = (64, 4, 256, 512) in f32 is 17.2
// GFLOP causal, 0.26 ms at the 67 TFLOP/s of the FMA units, against 0.16 ms
// for its 537 MB: bound by operations (at D=1024, (64, 2, 128), by bytes).
// What held the first design back was shared memory, not the FMA units: one
// key a lane, it loaded more than one wavefront per 4 warp-FMAs in both
// products. The design (flash_attention_common.cuh has the tiles): a block
// keeps BM rows of q' (32 at D=512, 16 at D=1024: 64 KB, rows padded) and
// steps over BN-row tiles of K and V (16 and 8 rows, 32 KB each), in two
// pairs of buffers: while the block computes one tile, the next comes in
// (f32 by cp.async, straight into the padded rows; bf16 is converted
// through registers, so its loads are not overlapped). Per tile:
//   1. S = q' . K^T from the score partials (per 4 values of d, 8
//      wavefronts for 64 FMAs a lane).
//   2. The softmax: kThreads / BM threads own a query row (8 at D=512), take
//      BN / (kThreads / BM) of its scores each and reduce the row's max and
//      sum with shuffles; m and l stay in their registers, p (rounded to the
//      storage type) and alpha go to shared memory.
//   3. acc = acc * alpha + p . V: a thread owns 8 query rows x CT columns
//      (64 accumulators at D >= 256); per key 2 broadcast loads of p and CT/4
//      float4 loads of V feed 8 * CT FMAs.
// Three barriers a tile; causal blocks stop at their last query. 221,440
// bytes of shared memory at D=512, 204,416 at D=1024: one block an SM.
// Measured times and the bound are in PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: flash_attention_fwd(...) below; returns cudaGetLastError().

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <int D>
struct FwdSmem {
  using L = Tiling<D>;
  static constexpr size_t bytes =
      sizeof(float) * (size_t(L::BM + 4 * L::BN) * L::KS + size_t(L::NSL + 1) * L::BN * L::PS +
                       2 * L::BM);
  static_assert(bytes <= kMaxSmem, "shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, float* __restrict__ lse, View qv, View kv, View vv, Geometry g,
          int q_tiles, float q_scale) {
  using L = Tiling<D>;
  constexpr int BM = L::BM, BN = L::BN, KS = L::KS, PS = L::PS, RT = L::RT, CT = L::CT;
  constexpr int TPR = kThreads / BM, KPT = (BN + TPR - 1) / TPR;  // softmax: threads a row
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BM x KS, scaled q
  float* kv_s = q_s + BM * KS;                   // 2 x (K, V): BN x KS each
  float* part = kv_s + 4 * BN * KS;              // NSL x BN x PS score partials
  float* p_s = part + L::NSL * BN * PS;          // BN x PS, p rounded
  float* alpha_s = p_s + BN * PS;                // BM
  float* l_s = alpha_s + BM;                     // BM

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BM;
  const int b = bh / g.H, h = bh % g.H;
  const T* kb = k + b * kv.sb + h * D;
  const T* vb = v + b * vv.sb + h * D;
  load_rows<T, D, BM>(q_s, KS, q + b * qv.sb + h * D, qv.st, q0, g.Tq, q_scale);

  const Place<L> at(tid);
  float* my_part = part + at.slice * BN * PS + at.br * PS + at.ar;
  float acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  }
  // softmax: this thread's query row and running max and sum (the same in
  // every thread of the row)
  const int row = tid / TPR, sub = tid % TPR, qpos = q0 + row;
  float m_run = kNegInf, l_run = 0.f;

  const int kv_end = g.causal ? min(g.Tk, q0 + BM) : g.Tk;
  fetch_rows<T, D, BN>(kv_s, KS, kb, kv.st, 0, g.Tk);
  fetch_rows<T, D, BN>(kv_s + BN * KS, KS, vb, vv.st, 0, g.Tk);
  for (int k0 = 0, t = 0; k0 < kv_end; k0 += BN, ++t) {
    const float* k_s = kv_s + (t & 1) * 2 * BN * KS;
    const float* v_s = k_s + BN * KS;
    wait_copies();
    __syncthreads();  // this tile is in; the last tile's K, V and p reads are done
    if (k0 + BN < kv_end) {  // the next tile comes in while this one is computed
      float* next = kv_s + ((t + 1) & 1) * 2 * BN * KS;
      fetch_rows<T, D, BN>(next, KS, kb, kv.st, k0 + BN, g.Tk);
      fetch_rows<T, D, BN>(next + BN * KS, KS, vb, vv.st, k0 + BN, g.Tk);
    }
    score_partials<L>(my_part, q_s + at.ar * KS + at.d0, k_s + at.br * KS + at.d0);
    __syncthreads();
    float sv[KPT], mx = kNegInf;
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int j = sub + m * TPR, kpos = k0 + j;
      const bool keep = j < BN && kpos < g.Tk && (!g.causal || kpos <= qpos);
      sv[m] = keep ? partial_sum<L>(part, j * PS + row) : kNegInf;
      mx = fmaxf(mx, sv[m]);
    }
    const float m_new = fmaxf(m_run, group_max<TPR>(mx));
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < KPT; ++m) {
      const int j = sub + m * TPR;
      const float pr = expf(sv[m] - m_new);
      sum += pr;
      if (j < BN) p_s[j * PS + row] = round_to<T>(pr);
    }
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + group_sum<TPR>(sum);
    m_run = m_new;
    if (sub == 0) alpha_s[row] = alpha;
    __syncthreads();  // p and alpha are in place
    float al[RT];
#pragma unroll
    for (int r = 0; r < RT; r += 4) load_vec<4>(al + r, alpha_s + at.tr * RT + r);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] *= al[r];
    }
    const int kn = min(BN, kv_end - k0);  // later keys have p = 0
    for (int j = 0; j < kn; ++j)
      fma_step<L>(acc, p_s + j * PS + at.tr * RT, v_s + j * KS + at.tc * L::VEC);
  }
  const float lc = fmaxf(l_run, 1e-30f);
  if (sub == 0) {
    l_s[row] = lc;
    if (lse != nullptr && qpos < g.Tq) lse[(long long)bh * g.Tq + qpos] = m_run + logf(lc);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = at.tr * RT + r;
    if (q0 + i >= g.Tq) continue;
    const float li = l_s[i];
    T* orow = out + ((long long)(b * g.Tq + q0 + i) * g.H + h) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) orow[at.col(c)] = from_float<T>(acc[r][c] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   View qv, View kv, View vv, Geometry g, float q_scale, cudaStream_t stream) {
  constexpr int BM = Tiling<D>::BM;
  constexpr size_t smem = FwdSmem<D>::bytes;
  const int q_tiles = (g.Tq + BM - 1) / BM;
  cudaError_t err = set_smem(flash_fwd<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd<T, D><<<dim3(unsigned(q_tiles) * g.B * g.H), kThreads, smem, stream>>>(
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
