// Fused qkv projection + packed attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel avt_tpu/ops/flash_attention.py:_fused_qkv_attn_fwd_kernel,
// launched by _fused_qkv_attn_fwd_call (the forward of
// fused_qkv_attention(use_pallas=True)).
//
// Function. x is (N, T, C) with C = H*64, W is (C, 3C) and b (3C), all in the
// storage type (bf16 or f32). Per frame, in the TPU kernel's order:
//   qkv = (x . W accumulated in f32, rounded to the storage type) + b
//                                          the add in the storage type, rounded
//                                          once more (flax Dense's order)
// then the head-pair attention of _short_fwd_kernel_paired on that qkv (see
// short_attention_common.cuh): q' = q * (sm_scale * log2 e) rounded, f32
// scores, the causal mask, exp2 against the row max, p rounded for an
// f32-accumulated PV, then 1/max(l, 1e-30). Writes out (N, T, C) and qkv
// (N, T, 3C), which the backward reads. Head dim 64 only, as the TPU kernel.
//
// W is read as W^T, a (3C, C) row-major array: each output column's C values
// are contiguous, the B-operand layout of mma.sync. The ViT passes W as the
// transposed view of its (3C, C) weight, so W^T is that weight and is read in
// place; the wrapper copies any other W into that layout once.
//
// Bound on the H100. The projection is 2*N*T*C*3C operations and the
// attention 4*N*H*T^2*64 (130.6 GFLOP at N=160 frames, T=197, C=768: 0.132 ms
// at 989 TFLOP/s in bf16), against x, W, out and qkv, ~246 MB (0.073 ms at
// 3.35 TB/s): bound by the tensor cores' rate.
//
// Design: right first, simple. One block per (frame, head, tile of up to 256
// rows); at T=197 one tile holds the whole sequence (13 warps of 16 rows).
//   1. Projection of the tile's rows onto the head's 64 q, 64 k and 64 v
//      columns (bf16: mma.sync m16n8k16 with f32 accumulation, each warp its
//      16 rows x 192 columns; x and W^T staged in 32-deep chunks by cp.async,
//      double-buffered; f32: 8x8 FMA tiles a thread, TF32 off). The result,
//      rounded and biased, lands in shared memory as the attention's q, k, v
//      tiles, and is written out as qkv.
//   2. The packed forward's attention over those tiles (bf16: the online
//      softmax of short_attention_common.cuh; f32: one thread per query row,
//      max pass then exp2 pass, as short_attention_fwd.cu's f32 kernel).
// For T > 256 each further key tile's k and v are projected again by every
// query tile that needs them (the query tile's own rows first, so the qkv
// output is written once). x is read once per head (from L2 after the first
// head); W^T's 192 rows once per block. The staging shares shared memory with
// the q, k, v tiles: the two phases never overlap in a block. Measured times
// are in PERF.md (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: fused_qkv_attention_fwd(...) below; returns cudaGetLastError().

#include "short_attention_common.cuh"

namespace {

using namespace packed;

constexpr int kD = 64;             // head dim: the TPU kernel's only geometry
constexpr int kLD = kD + kPad;     // row stride of the q, k, v tiles (bf16)
constexpr int kKC = 32;            // projection depth of one staged chunk (bf16)
constexpr int kXLD = kKC + kPad;   // row stride of the staged x and W^T chunks
constexpr int kMaxRows = 256;      // rows of a tile: 16 warps of 16 rows

struct Tiles {
  int rows, n_tiles;  // rows per tile (a multiple of 16 or 32), tiles per sequence
};

// bf16: one tile of the sequence rounded up to 16 rows, or 256-row tiles.
Tiles bf16_tiles(int T) {
  const int padded = (T + 15) & ~15;
  if (padded <= kMaxRows) return {padded, 1};
  return {kMaxRows, (T + kMaxRows - 1) / kMaxRows};
}

size_t bf16_smem_bytes(int rows) {
  const size_t tiles = size_t(3) * rows * kLD;                // q, k, v
  const size_t staging = size_t(2) * (rows + 3 * kD) * kXLD;  // x and W^T, two buffers
  return sizeof(__nv_bfloat16) * (tiles > staging ? tiles : staging);
}

// Projects rows [r0, r0 + rows) of one frame's x (T x C) onto NG groups of 64
// columns, group i being columns [c0 + i*C, c0 + i*C + 64) of W: x . W
// accumulated in f32 over C, rounded to bf16, plus the bias in bf16, into the
// shared tiles dst[i] ([row][kLD]). rows = 16 per warp; warp w owns rows
// [16w, 16w + 16) and all NG*64 columns. Rows >= T read as zeros. `stage`
// holds two buffers of x (rows x kKC) and of W^T (NG*64 x kKC); it may alias
// dst: the last chunk's reads end at a barrier before the results land.
template <int NG>
__device__ __forceinline__ void project_bf16(const __nv_bfloat16* __restrict__ xf,
                                             const __nv_bfloat16* __restrict__ wt,
                                             const __nv_bfloat16* __restrict__ bias, int r0,
                                             int T, int C, int c0,
                                             __nv_bfloat16* const (&dst)[NG],
                                             __nv_bfloat16* stage) {
  constexpr int N = NG * kD;
  constexpr int CPR = kKC / 8;  // 16-byte pieces of a staged row
  const int rows = blockDim.x / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // buffer b: x at stage + b * rows * kXLD, W^T at ws0 + b * N * kXLD
  __nv_bfloat16* const ws0 = stage + 2 * rows * kXLD;

  auto load = [&](int k0, int buf) {
    for (int i = tid; i < rows * CPR; i += blockDim.x) {
      const int r = i / CPR, c = (i % CPR) * 8, row = r0 + r;
      cp_async16(stage + (buf * rows + r) * kXLD + c, xf + size_t(min(row, T - 1)) * C + k0 + c, row < T);
    }
    for (int i = tid; i < N * CPR; i += blockDim.x) {
      const int n = i / CPR, c = (i % CPR) * 8;
      const int col = c0 + (n / kD) * C + n % kD;
      cp_async16(ws0 + (buf * N + n) * kXLD + c, wt + size_t(col) * C + k0 + c, true);
    }
    cp_async_commit();
  };

  float acc[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int n_chunks = C / kKC;
  load(0, 0);
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (kc + 1 < n_chunks) {
      load((kc + 1) * kKC, (kc + 1) & 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // chunk kc is in shared memory for every warp
    const __nv_bfloat16* xc = stage + (kc & 1) * rows * kXLD;
    const __nv_bfloat16* wc = ws0 + (kc & 1) * N * kXLD;
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4(a[kk], xc + (warp * 16 + (lane & 15)) * kXLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, wc + (j * 8 + (lane & 7)) * kXLD + (lane >> 3) * 8);
      mma_16816(acc[j], a[0], b[0], b[1]);
      mma_16816(acc[j], a[1], b[2], b[3]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int grp = j / (kD / 8), c = (j % (kD / 8)) * 8 + 2 * t;
    const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + c0 + grp * C + c);
    const __nv_bfloat162 v0 = __hadd2(__floats2bfloat162_rn(acc[j][0], acc[j][1]), b2);
    const __nv_bfloat162 v1 = __hadd2(__floats2bfloat162_rn(acc[j][2], acc[j][3]), b2);
    *reinterpret_cast<__nv_bfloat162*>(dst[grp] + (warp * 16 + g) * kLD + c) = v0;
    *reinterpret_cast<__nv_bfloat162*>(dst[grp] + (warp * 16 + g + 8) * kLD + c) = v1;
  }
}

// Grid (N * n_tiles, H), 2 * rows threads. Warp w owns query rows
// [q0 + 16w, q0 + 16w + 16) of frame n, head h; the block projects its own
// rows' q, k, v first, then, for T > 256 (kMulti), each other key tile's k, v.
// The one-tile form is its own instantiation, so that its registers hold no
// running softmax state across a projection.
template <bool kMulti>
__global__ void __launch_bounds__(kMaxRows * 2)
    fused_fwd_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                   const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ qkv, int T, int H, int n_tiles, int causal,
                   float scale) {
  constexpr int CH = kD / 8;  // 16-byte pieces of a head row
  const int rows = blockDim.x / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + rows * kLD;
  __nv_bfloat16* Vs = Ks + rows * kLD;
  __nv_bfloat16* stage = Qs;  // see project_bf16
  __nv_bfloat16* const qkv_tiles[3] = {Qs, Ks, Vs};
  __nv_bfloat16* const kv_tiles[2] = {Ks, Vs};

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles, h = blockIdx.y;
  const int C = H * kD;
  const int q0 = tile * rows;
  const __nv_bfloat16* xf = x + size_t(n) * T * C;
  __nv_bfloat16* qkvf = qkv + size_t(n) * T * 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  const int qw = q0 + warp * 16;  // this warp's first query row
  const bool active = qw < T;     // warps past the sequence only help the projection
  const int row0 = qw + g, row1 = qw + g + 8;
  const int kmax = causal ? min(T, qw + 16) : T;  // keys from kmax on are masked
  uint32_t qa[kD / 16][4];
  RowState<kD> state;
  state.init();

  const int n_stages = !kMulti ? 1 : causal ? tile + 1 : n_tiles;
  for (int si = 0; si < n_stages; ++si) {
    // the own tile first, then the others in order
    const int st = si == 0 ? tile : (si <= tile ? si - 1 : si);
    const int ks0 = st * rows;
    __syncthreads();  // every warp is done with the previous stage's tiles
    if (si == 0) {
      project_bf16<3>(xf, wt, bias, q0, T, C, h * kD, qkv_tiles, stage);
      __syncthreads();
      // the tile's q, k, v rows are the qkv output; then q is scaled in place
      for (int i = tid; i < rows * 3 * CH; i += blockDim.x) {
        const int r = i / (3 * CH), grp = (i % (3 * CH)) / CH, c = (i % CH) * 8;
        if (q0 + r >= T) continue;
        __nv_bfloat16* src = Qs + (grp * rows + r) * kLD + c;  // Qs, Ks, Vs in a row
        *reinterpret_cast<uint4*>(qkvf + size_t(q0 + r) * 3 * C + grp * C + h * kD + c) =
            *reinterpret_cast<const uint4*>(src);
        if (grp == 0) fix8(src, nullptr, true, scale2);
      }
      __syncthreads();
      if (active) load_a<kD, kLD>(qa, Qs + warp * 16 * kLD, g, t);
    } else if (kMulti) {
      project_bf16<2>(xf, wt, bias, ks0, T, C, C + h * kD, kv_tiles, stage);
      __syncthreads();
    }
    if (active)
      attend_bf16<kD>(state, qa, Ks, Vs, ks0, min(ks0 + rows, kmax), T, row0, row1, causal, lane);
  }
  if (active)
    store_rows_bf16<kD>(out + (size_t(n) * T + row0) * C + h * kD, C, state, row0, row1, T, t);
}

// ------------------------------------------------------------------- f32
// One thread per row: up to 256 rows a tile. The projection runs one 64-column
// group at a time, each thread an 8x8 tile of it over 16-deep chunks of x and
// W^T staged (transposed) in shared memory; the attention is the packed f32
// forward's (q in shared memory, k and v broadcast to every thread), with the
// row max taken over each key tile before its exp2 pass, so that at T <= 256
// p is formed once against the final max as in the reference.
constexpr int kF32Max = 256;
constexpr int kF32KC = 16;       // projection depth of one staged chunk (f32)
constexpr int kQLD = kD + 1;     // odd stride: row-per-thread reads are conflict-free

Tiles f32_tiles(int T) {
  const int padded = (T + 31) & ~31;
  if (padded <= kF32Max) return {padded, 1};
  return {kF32Max, (T + kF32Max - 1) / kF32Max};
}

size_t f32_smem_bytes(int rows) {
  return sizeof(float) * (size_t(rows) * (kQLD + 2 * kD)                 // q, k, v
                          + size_t(kF32KC) * (rows + 4) + kF32KC * kD);  // x, W^T chunks
}

// dst[r * ld + c] = (x[r0 + r] . W[:, col + c] + b[col + c]) * scale for the
// block's rows r and c < 64; with `to` (the qkv output's column col of frame
// row 0) the unscaled values of rows r0 + r < T also go out.
__device__ __forceinline__ void project_f32(const float* __restrict__ xf,
                                            const float* __restrict__ wt,
                                            const float* __restrict__ bias, int r0, int T, int C,
                                            int col, float* dst, int ld, float scale,
                                            float* to, size_t to_ld, float* xs, float* ws) {
  constexpr int KQ = kF32KC / 4;  // float4 pieces of a staged row
  const int rows = blockDim.x, tid = threadIdx.x;
  const int xld = rows + 4;
  const int rb = (tid >> 3) * 8, cb = (tid & 7) * 8;  // this thread's 8 rows and 8 columns
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kF32KC) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < rows * KQ; i += blockDim.x) {
      const int r = i / KQ, kq = i % KQ, row = r0 + r;
      const float4 v = row < T ? __ldg(reinterpret_cast<const float4*>(xf + size_t(row) * C + k0) + kq)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[(4 * kq + 0) * xld + r] = v.x;
      xs[(4 * kq + 1) * xld + r] = v.y;
      xs[(4 * kq + 2) * xld + r] = v.z;
      xs[(4 * kq + 3) * xld + r] = v.w;
    }
    for (int i = tid; i < kD * KQ; i += blockDim.x) {
      const int c = i / KQ, kq = i % KQ;
      const float4 v = __ldg(reinterpret_cast<const float4*>(wt + size_t(col + c) * C + k0) + kq);
      ws[(4 * kq + 0) * kD + c] = v.x;
      ws[(4 * kq + 1) * kD + c] = v.y;
      ws[(4 * kq + 2) * kD + c] = v.z;
      ws[(4 * kq + 3) * kD + c] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32KC; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(xs + k * xld + rb);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(xs + k * xld + rb + 4);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(ws + k * kD + cb);
      *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(ws + k * kD + cb + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = bias[col + cb + j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb + i;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[i][j] + bv[j];
      dst[r * ld + cb + j] = v[j] * scale;
    }
    if (to != nullptr && r0 + r < T) {
      float4* o = reinterpret_cast<float4*>(to + size_t(r0 + r) * to_ld + cb);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Grid (N * n_tiles, H), `rows` threads; thread i owns query row q0 + i.
__global__ void __launch_bounds__(kF32Max)
    fused_fwd_f32(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ qkv, int T, int H, int n_tiles, int causal, float scale) {
  const int rows = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + rows * kQLD;
  float* Vs = Ks + rows * kD;
  float* xs = Vs + rows * kD;
  float* ws = xs + kF32KC * (rows + 4);

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles, h = blockIdx.y;
  const int C = H * kD;
  const size_t rs = 3 * size_t(C);
  const int q0 = tile * rows;
  const float* xf = x + size_t(n) * T * C;
  float* qkvf = qkv + size_t(n) * T * rs;
  const int tid = threadIdx.x, row = q0 + tid;
  const float* q = Qs + tid * kQLD;

  float o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int n_stages = causal ? tile + 1 : n_tiles;
  for (int si = 0; si < n_stages; ++si) {
    const int st = si == 0 ? tile : (si <= tile ? si - 1 : si);
    const int ks0 = st * rows;
    float* to = si == 0 ? qkvf + h * kD : nullptr;  // the own tile's rows go out
    if (si == 0) project_f32(xf, wt, bias, ks0, T, C, h * kD, Qs, kQLD, scale, to, rs, xs, ws);
    project_f32(xf, wt, bias, ks0, T, C, C + h * kD, Ks, kD, 1.f, to ? to + C : nullptr, rs,
                xs, ws);
    project_f32(xf, wt, bias, ks0, T, C, 2 * C + h * kD, Vs, kD, 1.f, to ? to + 2 * C : nullptr,
                rs, xs, ws);
    __syncthreads();
    int n_keys = min(rows, T - ks0);
    if (causal) n_keys = min(n_keys, row - ks0 + 1);
    float tile_max = -INFINITY;
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(q[d], Ks[j * kD + d], s);
      tile_max = fmaxf(tile_max, s);
    }
    if (tile_max > -INFINITY) {
      const float m_new = fmaxf(m, tile_max);
      const float alpha = exp2f(m - m_new);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) o[d] *= alpha;
      m = m_new;
      for (int j = 0; j < n_keys; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) s = fmaf(q[d], Ks[j * kD + d], s);
        const float p = exp2f(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < kD; ++d) o[d] = fmaf(p, Vs[j * kD + d], o[d]);
      }
    }
  }
  if (row < T) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float4* dst = reinterpret_cast<float4*>(out + (size_t(n) * T + row) * C + h * kD);
#pragma unroll
    for (int d = 0; d < kD; d += 4)
      dst[d / 4] = make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace

extern "C" {

// x (N, T, H*64), wt = W^T (3*H*64, H*64), bias (3*H*64), out (N, T, H*64) and
// qkv (N, T, 3*H*64), contiguous, 16-byte aligned, in one storage type:
// is_bf16 selects bf16 (1) or f32 (0). scale is sm_scale*log2(e) already
// rounded to the storage type. Returns a cudaError_t.
int fused_qkv_attention_fwd(const void* x, const void* wt, const void* bias, void* out, void* qkv,
                            int N, int T, int H, int is_bf16, int causal, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    const Tiles tl = bf16_tiles(T);
    const size_t smem = bf16_smem_bytes(tl.rows);
    auto kernel = tl.n_tiles > 1 ? fused_fwd_bf16<true> : fused_fwd_bf16<false>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return int(err);
    kernel<<<dim3(N * tl.n_tiles, H), tl.rows * 2, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(qkv), T, H, tl.n_tiles, causal, scale);
  } else {
    const Tiles tl = f32_tiles(T);
    const size_t smem = f32_smem_bytes(tl.rows);
    if ((err = set_smem(fused_fwd_f32, smem)) != cudaSuccess) return int(err);
    fused_fwd_f32<<<dim3(N * tl.n_tiles, H), tl.rows, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(qkv), T,
        H, tl.n_tiles, causal, scale);
  }
  return int(cudaGetLastError());
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
