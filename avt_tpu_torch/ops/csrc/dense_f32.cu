// f32 dense layers on Hopper's tensor cores (sm_90a): C = A . B (+ bias),
// f32 in and out, each product as three TF32 products on mma.sync m16n8k8.
//
// Replaces no Pallas kernel: avt_tpu leaves x @ W to XLA. The port has it
// because cuBLAS runs an f32 product on the FMA units (its SIMT kernels, at
// most 67 TFLOP/s), and the f32 linears of AVT-h are most of an f32 train
// step (PERF.md §5). It is the engine of models/layers.py:dense for f32
// tensors on CUDA, in the forward (x . W, GPT-2's Conv1D, or x . W^T, torch's
// Linear) and in both backward products (dX = dY . W^T or dY . W, dW = X^T .
// dY or dY^T . X), through ops/dense.py.
//
// Function: C[m][n] = sum_k A[m][k] B[k][n] in f32, then the bias added in
// f32 (flax's order: the product rounded to f32, then the bias). Each
// operand x is split where it is used, in registers, by tensor_core.cuh's
// split_tf32_rz: hi = x with its 13 low bits cleared, lo = x - hi (exact)
// passed whole (the tensor cores read its top 19 bits), and a . b = lo_a .
// hi_b + hi_a . lo_b + hi_a . hi_b, the small terms first. The split leaves
// < 3 * 2^-20 of |a||b| a product (tests/test_torch_dense_f32.py), and costs
// two instructions an element on the integer and f32 pipes, where cvt.rna's
// split (split_tf32) would take two cvt, which issue at a fraction of their
// rate: as many issue slots as the products themselves.
//
// The accumulation: an mma adds its products into its accumulator and
// truncates the sum (measured on an H100: with one f32 accumulator over all
// of K, three mma a k-step of 8, uniform positive operands at K = 8192 came
// out 1.7e-4 low, 100x cuBLAS SIMT's error). So the products of one 32-wide
// stage of K go into accumulators of their own (12 mma a chain), which are
// then added into the f32 sum with FADD, which rounds to nearest: the error
// falls to 8e-7 there, below SIMT's 1.4e-6 (PERF.md).
//
// Layouts: A is K-major ([m][k], k contiguous) or M-major ([k][m]); B is
// K-major ([n][k]) or N-major ([k][n]); each with its own leading dimension.
// That covers every product of a linear and its gradients without a copy.
// mma.sync fragments load from shared memory in any layout (wgmma's tf32
// form takes only K-major operands).
//
// Bound on the H100: operations, 3 x 2MNK at 495 TFLOP/s (TF32). A t256 train
// step (64 clips x 256 features, 16384 rows) is 30.79 TFLOP of linears, 0.187
// s as three TF32 products at the peak; the bytes (each operand read once)
// are ~100x below that. cuBLAS SIMT took 0.58 s, this kernel 0.47.
//
// Design:
//   - A block computes a 128 x 128 tile of C, eight warps of 64 x 32 (2 x
//     4): the two accumulator sets take 128 registers a thread, so one
//     block an SM. Each split A fragment feeds 4 n-tiles, each B 4 m-tiles;
//     a k-step's 48 products go term by term over the 16 accumulators, so
//     that no product waits for the one before it.
//   - K advances 32 at a time through a ring of four stages in dynamic
//     shared memory, filled by cp.async (16 bytes a copy, or 4 where a
//     leading dimension or a base is not 16-byte aligned) with zero-fill
//     past the matrix's edge: any M, N, K.
//   - Shared rows are padded (rows along k: 36 floats, 4 mod 32 words; rows
//     along m or n: 136 floats, 8 mod 32 words) so that every fragment load,
//     ldmatrix on K-major tiles and lds on the others, is free of bank
//     conflicts.
//   - The next k-step's fragments are loaded while the current products run
//     (two warps a scheduler leave little else to hide their latency).
//   - Where the output tiles would leave SMs idle (fewer tiles than SMs), the
//     wrapper splits K over blocks (gridDim.z): each split writes its partial
//     tile to a scratch plane, and gemm_splitk_reduce adds the planes in
//     order, then the bias: no atomics, the same bits on every repeat.
//   - The bias is added to the f32 sum in the epilogue.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace {

using tensor_core::lds;
using tensor_core::mma_1688;
using tensor_core::split_tf32_rz;
using tensor_core::Tf32Pair;

constexpr int BM = 128, BN = 128, BK = 32;  // block tile
constexpr int kStages = 4;
constexpr int kWarpsN = 4, kThreads = 256;  // 2 x 4 warps, one block an SM
constexpr int WM = 64, WN = 32;  // warp tile
constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles of a warp
constexpr int kLdK = BK + 4;  // a shared row along k

// A stage of one operand whose tile spans kMN rows of C (BM) or columns
// (BN): kKMajor, kMN rows of BK floats; else BK rows of kMN floats.
template <bool kKMajor, int kMN>
struct Tile {
  static constexpr int kRows = kKMajor ? kMN : BK;
  static constexpr int kCols = kKMajor ? BK : kMN;
  static constexpr int kLd = kKMajor ? kLdK : kMN + 8;
  static constexpr int kFloats = kRows * kLd;
};
using TileA = Tile<false, BM>;  // the M-major A tile (its kLd)
using TileB = Tile<false, BN>;  // the N-major B tile (its kLd)

template <bool kAK, bool kBK>
struct Smem {
  static constexpr int kA = Tile<kAK, BM>::kFloats;
  static constexpr int kStage = kA + Tile<kBK, BN>::kFloats;
  static constexpr size_t kBytes = size_t(kStages) * kStage * sizeof(float);
};

// One cp.async copy of kVec floats; bytes < 4 * kVec zero-fills the rest.
template <int kVec>
__device__ __forceinline__ void copy(float* dst, const float* src, int bytes) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of a matrix whose element
// (r, c) is src[r * ld + c], into shared rows of kLd floats; what lies at or
// past row r_end or column c_end is zero-filled. The caller commits.
template <bool kKMajor, int kMN, int kVec>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long ld,
                                      int r0, int c0, int r_end, int c_end, int tid) {
  using T = Tile<kKMajor, kMN>;
  constexpr int kPerRow = T::kCols / kVec;
  constexpr int kCopies = T::kRows * kPerRow / kThreads;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int idx = tid + i * kThreads, r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    const int n = gr < r_end ? min(max(c_end - gc, 0), kVec) : 0;
    copy<kVec>(dst + r * T::kLd + c, n > 0 ? src + gr * ld + gc : src, 4 * n);
  }
}

// The f32 values of the A fragment of rows [m, m + 16) for k-step kk:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
template <bool kAK>
__device__ __forceinline__ void load_a(float (&a)[4], const float* s, int m, int kk, int lane) {
  if constexpr (kAK) {
    tensor_core::ldmatrix_x4(a, s + (m + (lane & 7) + (lane & 8)) * kLdK + (lane >> 4) * 4 + kk * 8);
  } else {
    constexpr int kLd = TileA::kLd;
    const float* p = s + (kk * 8 + (lane & 3)) * kLd + m + (lane >> 2);
    a[0] = lds(p);
    a[1] = lds(p + 8);
    a[2] = lds(p + 4 * kLd);
    a[3] = lds(p + 4 * kLd + 8);
  }
}

// The B fragments of columns [n, n + 8) (b[0], b[1]) and [n + 8, n + 16)
// (b[2], b[3]) for k-step kk: b0 (k = t, n = g), b1 (k = t + 4, n = g).
template <bool kBK>
__device__ __forceinline__ void load_b2(float (&b)[4], const float* s, int n, int kk, int lane) {
  if constexpr (kBK) {
    tensor_core::ldmatrix_x4(
        b, s + (n + (lane & 7) + ((lane >> 4) << 3)) * kLdK + kk * 8 + ((lane >> 1) & 4));
  } else {
    constexpr int kLd = TileB::kLd;
    const float* p = s + (kk * 8 + (lane & 3)) * kLd + n + (lane >> 2);
    b[0] = lds(p);
    b[1] = lds(p + 4 * kLd);
    b[2] = lds(p + 8);
    b[3] = lds(p + 4 * kLd + 8);
  }
}

__device__ __forceinline__ void split4(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32Pair p = split_tf32_rz(x[e]);
    hi[e] = p.hi;
    lo[e] = p.lo;
  }
}

// mma_1688 into a zeroed accumulator: c = a . b.
__device__ __forceinline__ void mma_1688_first(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The warp's 64 x 32 products over one stage (BK of K) into part, which it
// overwrites: four k-steps of 8, each 4 m-tiles x 4 n-tiles x 3 TF32
// products, taken term by term over the 16 accumulators so that no product
// waits for the one before it. The next k-step's fragments are loaded while
// the current ones multiply.
template <bool kAK, bool kBK>
__device__ __forceinline__ void multiply_stage(float (&part)[MT][NT][4], const float* sa,
                                               const float* sb, int wm, int wn, int lane) {
  float a_next[MT][4], b_next[NT / 2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) load_a<kAK>(a_next[i], sa, wm + 16 * i, 0, lane);
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) load_b2<kBK>(b_next[jp], sb, wn + 16 * jp, 0, lane);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4], bh[NT / 2][4], bl[NT / 2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) split4(ah[i], al[i], a_next[i]);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) split4(bh[jp], bl[jp], b_next[jp]);
    if (kk + 1 < BK / 8) {
#pragma unroll
      for (int i = 0; i < MT; ++i) load_a<kAK>(a_next[i], sa, wm + 16 * i, kk + 1, lane);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) load_b2<kBK>(b_next[jp], sb, wn + 16 * jp, kk + 1, lane);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint32_t b0 = bh[j / 2][2 * (j % 2)], b1 = bh[j / 2][2 * (j % 2) + 1];
        if (kk == 0)
          mma_1688_first(part[i][j], al[i], b0, b1);
        else
          mma_1688(part[i][j], al[i], b0, b1);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_1688(part[i][j], ah[i], bl[j / 2][2 * (j % 2)], bl[j / 2][2 * (j % 2) + 1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_1688(part[i][j], ah[i], bh[j / 2][2 * (j % 2)], bh[j / 2][2 * (j % 2) + 1]);
  }
}

struct Problem {
  int M, N, K;
  long long lda, ldb;
  int k_tiles;  // BK-wide steps of K a split takes
};

// grid (N tiles, M tiles, splits). out: C, or with splits the split's plane
// of the scratch (bias then NULL).
template <bool kAK, bool kBK, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ bias, float* __restrict__ out, Problem p) {
  extern __shared__ __align__(16) float smem[];
  using S = Smem<kAK, kBK>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
  const int kt0 = blockIdx.z * p.k_tiles;
  const int nk = max(min(p.k_tiles, (p.K + BK - 1) / BK - kt0), 0);
  out += (long long)blockIdx.z * p.M * p.N;

  auto load_stage = [&](int slot, int kt) {
    float* sa = smem + slot * S::kStage;
    float* sb = sa + S::kA;
    const int k0 = (kt0 + kt) * BK;
    if constexpr (kAK)
      stage<true, BM, kVec>(sa, a, p.lda, m0, k0, p.M, p.K, tid);
    else
      stage<false, BM, kVec>(sa, a, p.lda, k0, m0, p.K, p.M, tid);
    if constexpr (kBK)
      stage<true, BN, kVec>(sb, b, p.ldb, n0, k0, p.N, p.K, tid);
    else
      stage<false, BN, kVec>(sb, b, p.ldb, k0, n0, p.K, p.N, tid);
  };

  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    commit_copies();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait_copies<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    commit_copies();
    const float* sa = smem + (kt % kStages) * S::kStage;
    multiply_stage<kAK, kBK>(part, sa, sa + S::kA, wm, wn, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  wait_copies<0>();

  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.N & 1) == 0;  // row starts 8-byte aligned: store column pairs
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    if (col >= p.N) continue;
    const bool has2 = col + 1 < p.N;
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr && has2 ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * i + g + 8 * h;
        if (row >= p.M) continue;
        float* o = out + (long long)row * p.N + col;
        const float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (has2) o[1] = v1;
        }
      }
  }
}

// out = the sum of the splits' planes of ws, in split order, + bias.
__global__ void gemm_splitk_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
                                   float* __restrict__ out, long long mn, int n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    out[i] = bias != nullptr ? s + bias[i % n] : s;
  }
}

template <bool kAK, bool kBK, int kVec>
cudaError_t launch(const float* a, const float* b, const float* bias, float* out, float* ws,
                   Problem p, int splits, cudaStream_t stream) {
  constexpr size_t smem = Smem<kAK, kBK>::kBytes;
  auto kernel = gemm_tf32x3<kAK, kBK, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, splits > 1 ? nullptr : bias,
                                           splits > 1 ? ws : out, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)p.M * p.N;
  const int threads = 256;
  const long long blocks = std::min((mn + threads - 1) / threads, 4096LL);
  gemm_splitk_reduce<<<unsigned(blocks), threads, 0, stream>>>(ws, bias, out, mn, p.N, splits);
  return cudaGetLastError();
}

template <bool kAK, bool kBK>
cudaError_t dispatch_vec(int vec4, const float* a, const float* b, const float* bias, float* out,
                         float* ws, Problem p, int splits, cudaStream_t s) {
  return vec4 ? launch<kAK, kBK, 4>(a, b, bias, out, ws, p, splits, s)
              : launch<kAK, kBK, 1>(a, b, bias, out, ws, p, splits, s);
}

}  // namespace

extern "C" {

// out (M, N) = A . B (+ bias), all f32. A's element (m, k) is a[m * lda + k]
// when a_kmajor, else a[k * lda + m]; B's (k, n) is b[n * ldb + k] when
// b_kmajor, else b[k * ldb + n]. out is contiguous; bias (N) or NULL. vec4:
// both bases 16-byte aligned and both leading dimensions multiples of 4 (or
// their operand one row/column long). splits > 1 splits K into splits runs
// of k_tiles * 32 (the last may be shorter) through ws, splits * M * N
// floats; else ws may be NULL and k_tiles covers K. Returns a cudaError_t.
int dense_f32(const void* a, const void* b, const void* bias, void* out, void* ws, int M, int N,
              int K, long long lda, long long ldb, int a_kmajor, int b_kmajor, int vec4,
              int splits, int k_tiles, void* stream) {
  const Problem p{M, N, K, lda, ldb, k_tiles};
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b),
              *fbias = static_cast<const float*>(bias);
  float *fout = static_cast<float*>(out), *fws = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_kmajor && b_kmajor) return int(dispatch_vec<true, true>(vec4, fa, fb, fbias, fout, fws, p, splits, s));
  if (a_kmajor) return int(dispatch_vec<true, false>(vec4, fa, fb, fbias, fout, fws, p, splits, s));
  if (b_kmajor) return int(dispatch_vec<false, true>(vec4, fa, fb, fbias, fout, fws, p, splits, s));
  return int(dispatch_vec<false, false>(vec4, fa, fb, fbias, fout, fws, p, splits, s));
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
