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
// (N, T, 3C), which the backward reads, each element once. Head dim 64 and an
// even head count only, as the TPU kernel.
//
// W is read as W^T, a (3C, C) row-major array: each output column's C values
// are contiguous, the K-major B operand of the tensor cores. The ViT passes W
// as the transposed view of its (3C, C) weight, so W^T is that weight and is
// read in place; the wrapper copies any other W into that layout once.
//
// Bound on the H100. The projection is 2*N*T*C*3C operations and the
// attention 4*N*H*T^2*64 (130.6 GFLOP at N=160 frames, T=197, C=768: 0.132 ms
// at 989 TFLOP/s in bf16), against x, W, out and qkv, ~246 MB (0.073 ms at
// 3.35 TB/s): bound by the tensor cores' rate.
//
// Design (bf16). One block per (frame, tile of up to 256 rows, head pair),
// the pairs of a frame adjacent in the grid: x is staged by 6 blocks a frame,
// which run together, so they read it from L2.
//   - The projection runs on wgmma.mma_async (bf16 operands from shared
//     memory, f32 accumulators in registers): each warpgroup owns 64 rows, so
//     a tile is 64-row aligned (T=197 pads to 256 rows: 23% of the
//     projection's products are on zero rows). x and W^T come in 64-deep
//     chunks (one 128-byte row each) through a ring of 3 stages, filled by
//     the TMA in the 128-byte swizzled layout that the descriptors read (x's
//     rows past T read as zeros). Each stage has a "full" and an "empty"
//     mbarrier, so no block barrier paces the chunks: a warpgroup keeps one
//     chunk's products in flight, and thread 0 refills a stage as soon as
//     every warp is done with it, two chunks ahead. The TMA's tensor maps come
//     from cuTensorMapEncodeTiled, reached through the runtime's driver entry
//     point (no libcuda at link time), made at each launch. Not cp.async from
//     every thread: with it and a block barrier a chunk, the copies and the
//     products did not overlap (PERF.md).
//   - 64 rows x a pair's 384 columns of f32 are 192 registers a thread, more
//     than a thread has beside the attention, so a tile is projected a head
//     at a time: one pass of m64n192k16 over the head's q, k and v (96
//     registers), rounded and biased in registers. The C fragments of wgmma
//     are those of mma.m16n8k16, so a warp's q rows become the attention's A
//     fragments (scaled, as fix2 does) without leaving registers; k and v
//     land in shared tiles whose rows are whole key steps (zero rows of x
//     give the bias: masked keys).
//   - Each warp's rows of q, k and v, and later of the attention's output,
//     go to device memory through shared tiles, 16 bytes a lane in whole
//     128-byte rows (a warp's own rows: no block barrier).
//   - Each head's attention is attend_steps (branch-free 16-key steps) over
//     those tiles, one warp per 16 query rows, as the packed forward's; the
//     second head's first two chunks stream in meanwhile.
// For T > 256 each further key tile's k and v are projected again (m64n128k16)
// by every query tile that needs them (the query tile's own rows first, so
// the qkv output is written once). Measured times are in PERF.md
// (chip_smoke.py and tools/torch_packed_attention_turns.py print them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avt_tpu_torch/ops/_build.py does it at first use).
// Entry: fused_qkv_attention_fwd(...) below; returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda at link time)

#include "short_attention_common.cuh"

namespace {

using namespace packed;

constexpr int kD = 64;             // head dim: the TPU kernel's only geometry
constexpr int kLD = kD + kPad;     // row stride of the k, v tiles (bf16)
constexpr int kMaxRows = 256;      // rows of a tile: up to 4 warpgroups of 64
constexpr int kKC = 64;            // depth of a staged chunk: one 128-byte row
constexpr int kStages = 3;         // chunks in the staging ring
constexpr int kMaxGroups = 3;      // 64-column groups of a pass: a head's q, k, v
constexpr int kKB = 16;            // keys per step of attend_steps

struct Tiles {
  int rows, n_tiles;  // rows per tile, tiles per sequence
};

// bf16: one tile of the sequence rounded up to whole warpgroups, or 256-row
// tiles.
Tiles bf16_tiles(int T) {
  const int padded = (T + 63) & ~63;
  if (padded <= kMaxRows) return {padded, 1};
  return {kMaxRows, (T + kMaxRows - 1) / kMaxRows};
}

// A stage holds a chunk of x (rows x 64) and of W^T (up to 192 x 64).
__host__ __device__ constexpr int stage_bytes(int rows) {
  return (rows + kMaxGroups * kD) * 128;
}

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * kLD * 2; }
__host__ __device__ constexpr int kv_bytes(int rows) { return 2 * tile_bytes(rows); }

// Stages 0 and 1 of the ring, then stage 2, whose room the k and v tiles
// share: a pass's first two chunks stream into stages 0 and 1 while the
// previous head's attention reads the tiles, and stage 2 is filled only once
// that attention is over. Then the q tile, each warp's own rows on their way
// to device memory (q, then the attention's output). 1024-byte aligned for
// the swizzle: one alignment's slack.
size_t bf16_smem_bytes(int rows) {
  const int last = stage_bytes(rows) > kv_bytes(rows) ? stage_bytes(rows) : kv_bytes(rows);
  return 1024 + size_t(kStages - 1) * stage_bytes(rows) + last + tile_bytes(rows);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major tile in the 128-byte swizzled layout: rows of
// 128 bytes (64 bf16), 8-row groups 1024 bytes apart, the tile 1024-aligned.
// A k16 slice at byte offset 32*kk of the row is the same descriptor + 2*kk.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The accumulators are read only after the wait: no use moves above it.
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 8*NA/4 columns, f32) += A (64 x 16) . B (16 x columns), both bf16
// K-major in shared memory. d[4j + e] is row 16*(warp % 4) + g (+8 for
// e >= 2), column 8j + 2t + (e & 1): the C fragments of mma.m16n8k16 side by
// side. m64n128k16 (two column groups) and m64n192k16 (three).
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives and adds `bytes` to the transfer count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` is complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A box of a tensor map into shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The staging ring. Stage s is filled by thread 0 with the TMA (x's box of
// `rows` rows, zero past T, and one box of 64 W^T rows per column group) and
// counted on full[s]; every warp arrives on empty[s] once its products of the
// chunk are done. Bit s of full_phase / empty_phase is the parity of stage s's
// next wait; bit s of `filled` says stage s was filled before, so that its
// next fill waits for it to be empty.
__shared__ __align__(8) uint64_t ring_full[kStages];
__shared__ __align__(8) uint64_t ring_empty[kStages];

struct Ring {
  unsigned char* base;
  const CUtensorMap* xmap;  // x as (N, T, C), box (1, rows, 64)
  const CUtensorMap* wmap;  // W^T as (3C, C), box (64, 64)
  int rows;
  uint32_t full_phase, empty_phase, filled;
};

// The chunks of one pass: rows [r0, r0 + rows) of frame n's x (T x C) against
// NG groups of 64 W^T rows (output columns) starting at col[i].
template <int NG>
struct PassSrc {
  int n, r0, C;
  int col[NG];
};

// Chunk kc of a pass into stage kc % kStages (thread 0 only).
template <int NG>
__device__ __forceinline__ void fill(Ring& rg, const PassSrc<NG>& ps, int kc) {
  const int s = kc % kStages;
  if (rg.filled >> s & 1) {
    mbar_wait(ring_empty + s, rg.empty_phase >> s & 1);
    rg.empty_phase ^= 1u << s;
  }
  rg.filled |= 1u << s;
  fence_proxy_async();  // the stage's earlier reads and writes (the k, v tiles share stage 2) first
  unsigned char* xs = rg.base + s * stage_bytes(rg.rows);
  mbar_expect_tx(ring_full + s, (rg.rows + NG * kD) * 128);
  tma_3d(xs, rg.xmap, ring_full + s, kc * kKC, ps.r0, ps.n);
#pragma unroll
  for (int g = 0; g < NG; ++g)
    tma_2d(xs + (rg.rows + g * kD) * 128, rg.wmap, ring_full + s, kc * kKC, ps.col[g]);
}

// The first two chunks of a pass, into stages 0 and 1 (which nothing but the
// ring uses): they may stream in during an attention phase.
template <int NG>
__device__ __forceinline__ void pass_begin(Ring& rg, const PassSrc<NG>& ps) {
  if (threadIdx.x == 0) {
    fill(rg, ps, 0);
    fill(rg, ps, 1);  // C = 64 H, H even: at least 2 chunks
  }
}

// acc = this warpgroup's 64 rows of the pass (x . W^T over C, the columns of
// the NG groups side by side), after pass_begin. No block barrier a chunk:
// each warpgroup waits for the chunk's bytes, issues its products and keeps
// one chunk's in flight; once the chunk before is done it frees that stage,
// and thread 0 refills it with the chunk after next. Every thread of the
// block calls it; it begins with a barrier (every warp is done with the k, v
// tiles, which share stage 2) and ends with one (every warpgroup is done
// with the ring).
template <int NG>
__device__ __forceinline__ void pass_run(float (&acc)[NG * 32], Ring& rg, const PassSrc<NG>& ps) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NG * 32; ++i) acc[i] = 0.f;
  const int n_chunks = ps.C / kKC;
  __syncthreads();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int s = kc % kStages;
    mbar_wait(ring_full + s, rg.full_phase >> s & 1);
    rg.full_phase ^= 1u << s;
    const uint32_t xs = smem_u32(rg.base + s * stage_bytes(rg.rows));
    const uint64_t da = sw128_desc(xs + wg * 64 * 128), db = sw128_desc(xs + rg.rows * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait_one();  // chunk kc - 1's products are done
    if (kc > 0 && lane == 0) mbar_arrive(ring_empty + (kc - 1) % kStages);
    if (threadIdx.x == 0 && kc + 2 < n_chunks) fill(rg, ps, kc + 2);
  }
  wgmma_wait_all();
  if (lane == 0) mbar_arrive(ring_empty + (n_chunks - 1) % kStages);
  fence_acc(acc);
  __syncthreads();
}

// Column group HF of a pass (acc columns [64 HF, 64 HF + 64)) rounded to bf16,
// plus the group's bias (64 values at `bias`) in bf16: v[j][0] holds row g,
// columns 8j + 2t and 8j + 2t + 1 of the group, v[j][1] the same of row g + 8.
template <int HF, int NA>
__device__ __forceinline__ void biased(uint32_t (&v)[8][2], const float (&acc)[NA],
                                       const __nv_bfloat16* bias, int t) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* a = acc + (HF * 8 + j) * 4;
    const uint32_t b = ldg_u32(bias + 8 * j + 2 * t);
    v[j][0] = fix2(pack_bf16(a[0], a[1]), b, true, false, one);
    v[j][1] = fix2(pack_bf16(a[2], a[3]), b, true, false, one);
  }
}

// A warp's 16 rows of a shared [row][kLD] tile (`tile` at the first), those
// below `valid`, to device memory (`dst` at the first row's first column,
// `ld` the row stride), 16 bytes a lane: whole 128-byte rows.
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* tile, __nv_bfloat16* dst,
                                          size_t ld, int valid, int lane) {
#pragma unroll
  for (int i = lane; i < 16 * (kD / 8); i += 32) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(tile + r * kLD + c);
  }
}

// A group into a shared [row][kLD] tile, `rows` at the warp's first row + g.
__device__ __forceinline__ void store_tile(const uint32_t (&v)[8][2], __nv_bfloat16* rows, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(rows + 8 * j + 2 * t) = v[j][0];
    *reinterpret_cast<uint32_t*>(rows + 8 * kLD + 8 * j + 2 * t) = v[j][1];
  }
}

// q' = q * scale (fix2's product) as the A fragments of the warp's 16 rows.
__device__ __forceinline__ void to_qa(uint32_t (&qa)[kD / 16][4], const uint32_t (&v)[8][2],
                                      __nv_bfloat162 scale2) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    qa[kk][0] = fix2(v[2 * kk][0], 0u, false, true, scale2);
    qa[kk][1] = fix2(v[2 * kk][1], 0u, false, true, scale2);
    qa[kk][2] = fix2(v[2 * kk + 1][0], 0u, false, true, scale2);
    qa[kk][3] = fix2(v[2 * kk + 1][1], 0u, false, true, scale2);
  }
}

// Grid (N * n_tiles * H / 2), the head pairs of a (frame, tile) adjacent, so
// the blocks that stage the same rows of x run together and read them from
// L2; 2 * rows threads (rows / 64 warpgroups). Warp w owns rows
// [q0 + 16w, q0 + 16w + 16) of frame n in every pass and, for each head of
// the pair, those query rows' attention. Each head's own rows are one pass of
// its q, k and v; for T > 256 (kMulti) each other key tile's k and v are a
// further pass. In the one-tile form the second head's pass begins during the
// first head's attention, and its registers hold no running softmax state
// across a projection.
template <bool kMulti>
__global__ void __launch_bounds__(kMaxRows * 2, 1)
    fused_fwd_bf16(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ qkv, int T, int H, int n_tiles, int causal,
                   float scale) {
  const int rows = blockDim.x / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring_full + s, 1);
      mbar_init(ring_empty + s, blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring rg{ring, &xmap, &wmap, rows, 0u, 0u, 0u};
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(ring + (kStages - 1) * stage_bytes(rows));
  __nv_bfloat16* Vs = Ks + rows * kLD;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      ring + (kStages - 1) * stage_bytes(rows) +
      (stage_bytes(rows) > kv_bytes(rows) ? stage_bytes(rows) : kv_bytes(rows)));

  const int pairs = H / 2;
  const int pair = blockIdx.x % pairs, nt = blockIdx.x / pairs;
  const int n = nt / n_tiles, tile = nt % n_tiles;
  const int C = H * kD;
  const size_t rs = 3 * size_t(C);
  const int q0 = tile * rows;
  __nv_bfloat16* qkvf = qkv + size_t(n) * T * rs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);

  const int qw = q0 + warp * 16;  // this warp's first query row
  const bool active = qw < T;     // warps past the sequence only help the projection
  const int row0 = qw + g, row1 = qw + g + 8;
  const int kmax = causal ? min(T, qw + 16) : T;  // keys from kmax on are masked
  const int wrow = warp * 16 * kLD, trow = wrow + g * kLD;  // the warp's rows 0, g in a tile
  const int n_stages = !kMulti ? 1 : causal ? tile + 1 : n_tiles;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int hc = (2 * pair + hh) * kD;  // this head's column within a third
    uint32_t qa[kD / 16][4];
    uint32_t v[8][2];
    RowState<kD> state;
    state.init();
    for (int si = 0; si < n_stages; ++si) {
      // the own tile first, then the others in order
      const int st = si == 0 ? tile : (si <= tile ? si - 1 : si);
      const int ks0 = st * rows;
      if (si == 0) {  // the own rows' q, k and v: qkv's output
        const PassSrc<3> own{n, q0, C, {hc, C + hc, 2 * C + hc}};
        if (kMulti || hh == 0) pass_begin(rg, own);
        float acc[96];
        pass_run(acc, rg, own);
        biased<0>(v, acc, bias + hc, t);
        store_tile(v, Qs + trow, t);
        to_qa(qa, v, scale2);
        biased<1>(v, acc, bias + C + hc, t);
        store_tile(v, Ks + trow, t);
        biased<2>(v, acc, bias + 2 * C + hc, t);
        store_tile(v, Vs + trow, t);
        __syncwarp();  // the warp's own rows of the three tiles go out
        __nv_bfloat16* dst = qkvf + size_t(qw) * rs + hc;
        copy_rows(Qs + wrow, dst, rs, T - qw, lane);
        copy_rows(Ks + wrow, dst + C, rs, T - qw, lane);
        copy_rows(Vs + wrow, dst + 2 * C, rs, T - qw, lane);
      } else {  // another key tile's k and v
        const PassSrc<2> kv{n, ks0, C, {C + hc, 2 * C + hc}};
        pass_begin(rg, kv);
        float acc[64];
        pass_run(acc, rg, kv);
        biased<0>(v, acc, bias + C + hc, t);
        store_tile(v, Ks + trow, t);
        biased<1>(v, acc, bias + 2 * C + hc, t);
        store_tile(v, Vs + trow, t);
      }
      __syncthreads();  // the k, v tiles are whole
      if (!kMulti && hh == 0) {
        const PassSrc<3> next{n, q0, C, {hc + kD, C + hc + kD, 2 * C + hc + kD}};
        pass_begin(rg, next);
      }
      if (active)
        attend_steps<kD, kKB>(state, qa, Ks, Vs, ks0, min(ks0 + rows, kmax), T, row0, row1,
                              causal, lane);
    }
    if (active) {  // through the warp's own rows of the q tile
      store_rows_bf16<kD>(Qs + trow, kLD, state, row0, row1, T, t);
      __syncwarp();
      copy_rows(Qs + wrow, out + (size_t(n) * T + qw) * C + hc, C, T - qw, lane);
    }
  }
}

// ------------------------------------------------------------------- f32
// Exact f32 products on the FMA units (TF32 off). One block of 384 threads per
// (frame, head, tile of up to 240 rows). The projection stages each 32-deep
// chunk of x once for all of the head's 192 q, k and v columns: a tile is
// projected in slabs of 128 rows, each thread an 8-row x 8-column register
// tile (4 shared loads of 16 bytes for 64 FMAs a step; 12 warps, so that a
// slab's last rows still spread over the SM's four schedulers), the next
// chunk's device loads in flight in registers while this one is used;
// threads whose 8 rows all lie past T skip the products. Results go to shared
// q (scaled), k and v tiles and, for the own rows, to the qkv output. The
// attention is then one thread per query row, its q' in registers, k and v
// broadcast from shared memory: an online softmax over steps of 8 keys, each
// score four partial sums over 16 dims.
constexpr int kF32Threads = 384;
constexpr int kF32Max = 240;          // rows of a tile (shared memory): a query row a thread
constexpr int kF32Slab = 128;         // rows projected at once: 16 x 8
constexpr int kF32KC = 32;            // projection depth of one staged chunk
constexpr int kF32KB = 8;             // keys per step of the attention's online softmax
constexpr int kF32Cols = 3 * kD;      // a head's q, k and v columns: 24 x 8
constexpr int kQLD = kD + 1;          // odd stride: row-per-thread reads are conflict-free
constexpr int kXLD = kF32Slab + 4;    // [k][row] stride of the staged x chunk
constexpr int kWLD = kF32Cols + 4;    // [k][column] stride of the staged W^T chunk

Tiles f32_tiles(int T) {
  const int padded = (T + 15) & ~15;
  if (padded <= kF32Max) return {padded, 1};
  return {kF32Max, (T + kF32Max - 1) / kF32Max};
}

size_t f32_smem_bytes(int rows) {
  return sizeof(float) * (size_t(rows) * (kQLD + 2 * kD) + kF32KC * (kXLD + kWLD));
}

// Rows [r0, r0 + rows) of one frame's x (T x C) . W^T's rows (output
// columns) c0 + {0..63, C..C+63, 2C..2C+63} (a head's q, k, v) + b, in f32:
// k and v into the shared tiles Ks, Vs ([row][64]), with `own` q * scale into
// Qs ([row][kQLD]) and the unscaled q, k, v of the rows < T to the qkv output
// (`to`: row r0's q column of the head, `to_ld` its row stride).
__device__ __forceinline__ void project_f32(const float* __restrict__ xf,
                                            const float* __restrict__ wt,
                                            const float* __restrict__ bias, int r0, int rows,
                                            int T, int C, int c0, bool own, float scale,
                                            float* Qs, float* Ks, float* Vs, float* to,
                                            size_t to_ld, float* xs, float* ws) {
  constexpr int KQ = kF32KC / 4;  // float4 pieces of a staged row
  constexpr int XN = (kF32Slab * KQ + kF32Threads - 1) / kF32Threads;
  constexpr int WN = kF32Cols * KQ / kF32Threads;
  const int tid = threadIdx.x;
  // this thread's 8 rows and 8 columns: 4 at 4 cg, 4 at 96 + 4 cg (16-byte
  // pieces of a staged W^T row side by side across the warp)
  const int rb = (tid / 24) * 8, cg = tid % 24;
  // float4 i of this thread's copies is row / column (tid / KQ) + (384 / KQ) i
  // of the chunk, depth (tid % KQ) * 4
  const int kq = (tid % KQ) * 4, lead = tid / KQ;
  const float* wsrc = wt + size_t(c0) * C + kq;
  for (int s0 = 0; s0 < rows; s0 += kF32Slab) {
    // the thread's rows lie in the tile and hold some row < T
    const bool busy = s0 + rb < rows && r0 + s0 + rb < T;
    float4 xr[XN], wr[WN];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < XN; ++i) {
        const int r = lead + (kF32Threads / KQ) * i, row = r0 + s0 + r;
        xr[i] = r < kF32Slab && row < T
                    ? __ldg(reinterpret_cast<const float4*>(xf + size_t(row) * C + k0 + kq))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const int col = lead + (kF32Threads / KQ) * i;
        wr[i] = __ldg(reinterpret_cast<const float4*>(
            wsrc + size_t((col >> 6) * C + (col & 63)) * C + k0));
      }
    };
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    fetch(0);
    for (int k0 = 0; k0 < C; k0 += kF32KC) {
      __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
      for (int i = 0; i < XN; ++i) {
        const int r = lead + (kF32Threads / KQ) * i;
        if (r >= kF32Slab) break;
        xs[(kq + 0) * kXLD + r] = xr[i].x;
        xs[(kq + 1) * kXLD + r] = xr[i].y;
        xs[(kq + 2) * kXLD + r] = xr[i].z;
        xs[(kq + 3) * kXLD + r] = xr[i].w;
      }
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const int c = lead + (kF32Threads / KQ) * i;
        ws[(kq + 0) * kWLD + c] = wr[i].x;
        ws[(kq + 1) * kWLD + c] = wr[i].y;
        ws[(kq + 2) * kWLD + c] = wr[i].z;
        ws[(kq + 3) * kWLD + c] = wr[i].w;
      }
      __syncthreads();
      if (k0 + kF32KC < C) fetch(k0 + kF32KC);  // in flight while this chunk is used
      if (busy) {
#pragma unroll
        for (int k = 0; k < kF32KC; ++k) {
          float a[8], b[8];
          *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(xs + k * kXLD + rb);
          *reinterpret_cast<float4*>(a + 4) =
              *reinterpret_cast<const float4*>(xs + k * kXLD + rb + 4);
          *reinterpret_cast<float4*>(b) =
              *reinterpret_cast<const float4*>(ws + k * kWLD + 4 * cg);
          *reinterpret_cast<float4*>(b + 4) =
              *reinterpret_cast<const float4*>(ws + k * kWLD + 96 + 4 * cg);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    if (!busy) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // 4 columns at a time: never across a 64-column group
      const int col = 96 * q + 4 * cg, grp = col >> 6, d = col & 63;
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0 + grp * C + d));
      float* tile = grp == 0 ? Qs : grp == 1 ? Ks : Vs;
      const int ld = grp == 0 ? kQLD : kD;
      const float mul = grp == 0 ? scale : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = s0 + rb + i;
        const float4 v = make_float4(acc[i][4 * q] + b4.x, acc[i][4 * q + 1] + b4.y,
                                     acc[i][4 * q + 2] + b4.z, acc[i][4 * q + 3] + b4.w);
        if (grp != 0 || own) {
          tile[r * ld + d] = v.x * mul;
          tile[r * ld + d + 1] = v.y * mul;
          tile[r * ld + d + 2] = v.z * mul;
          tile[r * ld + d + 3] = v.w * mul;
        }
        if (own && r0 + r < T)
          *reinterpret_cast<float4*>(to + size_t(r0 + r) * to_ld + grp * C + d) = v;
      }
    }
  }
}

// Grid (N * n_tiles, H), 384 threads; thread i < rows owns query row q0 + i. For
// T > 256 (kMulti) each other key tile's k and v are projected again; the
// one-tile form is its own instantiation, so that no q' or o registers are
// live across a projection.
template <bool kMulti>
__global__ void __launch_bounds__(kF32Threads, 1)
    fused_fwd_f32(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ qkv, int T, int H, int n_tiles, int rows, int causal,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + rows * kQLD;
  float* Vs = Ks + rows * kD;
  float* xs = Vs + rows * kD;
  float* ws = xs + kF32KC * kXLD;

  const int n = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles, h = blockIdx.y;
  const int C = H * kD;
  const size_t rs = 3 * size_t(C);
  const int q0 = tile * rows;
  const float* xf = x + size_t(n) * T * C;
  float* qkvf = qkv + size_t(n) * T * rs;
  const int tid = threadIdx.x, row = q0 + tid;
  const bool active = tid < rows && row < T;

  float q[kD], o[kD];
  float m = -INFINITY, l = 0.f;
  const int n_stages = !kMulti ? 1 : causal ? tile + 1 : n_tiles;
  for (int si = 0; si < n_stages; ++si) {
    // the own tile first (its q, k, v, the qkv output's rows), then the others' k, v
    const int st = si == 0 ? tile : (si <= tile ? si - 1 : si);
    const int ks0 = st * rows;
    if (si > 0) __syncthreads();  // every thread is done with the previous k, v tiles
    project_f32(xf, wt, bias, ks0, rows, T, C, h * kD, si == 0, scale, Qs, Ks, Vs,
                qkvf + h * kD, rs, xs, ws);
    __syncthreads();
    if (si == 0 && active) {  // q' and o live from here on, not across the own projection
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        q[d] = Qs[tid * kQLD + d];
        o[d] = 0.f;
      }
    }
    if (!active) continue;
    int n_keys = min(rows, T - ks0);
    if (causal) n_keys = min(n_keys, row - ks0 + 1);
    // steps of kF32KB keys: the scores, the step's max, o and l rescaled
    // when it raises the row max, then p . v; keys past n_keys read the last
    // key's rows (finite) and get p = 0
    for (int j0 = 0; j0 < n_keys; j0 += kF32KB) {
      float sc[kF32KB];
#pragma unroll
      for (int jj = 0; jj < kF32KB; ++jj) {
        const float4* k4 = reinterpret_cast<const float4*>(Ks + min(j0 + jj, n_keys - 1) * kD);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 kv = k4[d4];
          float& p = part[d4 / 4];
          p = fmaf(q[4 * d4], kv.x, p);
          p = fmaf(q[4 * d4 + 1], kv.y, p);
          p = fmaf(q[4 * d4 + 2], kv.z, p);
          p = fmaf(q[4 * d4 + 3], kv.w, p);
        }
        sc[jj] = j0 + jj < n_keys ? (part[0] + part[1]) + (part[2] + part[3]) : -INFINITY;
      }
      float step_max = sc[0];
#pragma unroll
      for (int jj = 1; jj < kF32KB; ++jj) step_max = fmaxf(step_max, sc[jj]);
      if (step_max > m) {
        const float alpha = exp2f(m - step_max);  // 0 while m is -inf
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kD; ++d) o[d] *= alpha;
        m = step_max;
      }
#pragma unroll
      for (int jj = 0; jj < kF32KB; ++jj) {
        const float p = exp2f(sc[jj] - m);
        l += p;
        const float4* v4 = reinterpret_cast<const float4*>(Vs + min(j0 + jj, n_keys - 1) * kD);
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = v4[d4];
          o[4 * d4] = fmaf(p, vv.x, o[4 * d4]);
          o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
          o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
          o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
        }
      }
    }
  }
  if (active) {
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

// A form's launch at T: tiles a sequence, heads a block, threads a block,
// dynamic shared memory.
struct Launch {
  int n_tiles, heads, threads;
  size_t smem;
};

Launch bf16_launch(int T) {
  const Tiles tl = bf16_tiles(T);
  return {tl.n_tiles, 2, tl.rows * 2, bf16_smem_bytes(tl.rows)};  // one block a head pair
}

Launch f32_launch(int T) {
  const Tiles tl = f32_tiles(T);
  return {tl.n_tiles, 1, kF32Threads, f32_smem_bytes(tl.rows)};
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no libcuda at
// link time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map in the 128-byte swizzled layout of the ring: `dims` and
// `box` innermost first, `strides` the byte strides of dims 1 and on; what
// lies outside the tensor reads as zeros.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t residency(K kernel, const Launch& geo, int* warps, int* smem, int* blocks) {
  *warps = geo.threads / 32;
  *smem = int(geo.smem);
  cudaError_t err = set_smem(kernel, geo.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, geo.threads, geo.smem);
}

}  // namespace

extern "C" {

// x (N, T, H*64), wt = W^T (3*H*64, H*64), bias (3*H*64), out (N, T, H*64) and
// qkv (N, T, 3*H*64), contiguous, 16-byte aligned, in one storage type:
// is_bf16 selects bf16 (1) or f32 (0); H is even. scale is sm_scale*log2(e)
// already rounded to the storage type. Returns a cudaError_t.
int fused_qkv_attention_fwd(const void* x, const void* wt, const void* bias, void* out, void* qkv,
                            int N, int T, int H, int is_bf16, int causal, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    const Launch geo = bf16_launch(T);
    const int C = H * kD;
    const cuuint64_t x_dims[3] = {cuuint64_t(C), cuuint64_t(T), cuuint64_t(N)};
    const cuuint64_t x_strides[2] = {cuuint64_t(C) * 2, cuuint64_t(T) * C * 2};
    const cuuint32_t x_box[3] = {kKC, cuuint32_t(geo.threads / 2), 1};
    const cuuint64_t w_dims[2] = {cuuint64_t(C), cuuint64_t(3 * C)};
    const cuuint64_t w_strides[1] = {cuuint64_t(C) * 2};
    const cuuint32_t w_box[2] = {kKC, kD};
    CUtensorMap xmap, wmap;
    if ((err = bf16_map(&xmap, x, 3, x_dims, x_strides, x_box)) != cudaSuccess ||
        (err = bf16_map(&wmap, wt, 2, w_dims, w_strides, w_box)) != cudaSuccess)
      return int(err);
    auto kernel = geo.n_tiles > 1 ? fused_fwd_bf16<true> : fused_fwd_bf16<false>;
    if ((err = set_smem(kernel, geo.smem)) != cudaSuccess) return int(err);
    kernel<<<N * geo.n_tiles * (H / geo.heads), geo.threads, geo.smem, st>>>(
        xmap, wmap, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(qkv), T, H, geo.n_tiles, causal, scale);
  } else {
    const Launch geo = f32_launch(T);
    auto kernel = geo.n_tiles > 1 ? fused_fwd_f32<true> : fused_fwd_f32<false>;
    if ((err = set_smem(kernel, geo.smem)) != cudaSuccess) return int(err);
    kernel<<<dim3(N * geo.n_tiles, H / geo.heads), geo.threads, geo.smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(qkv), T,
        H, geo.n_tiles, f32_tiles(T).rows, causal, scale);
  }
  return int(cudaGetLastError());
}

// The form's kernel at sequence length T (the one-tile template at T <= 256):
// warps a block, its dynamic shared memory in bytes, and how many blocks of it
// one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a
// cudaError_t.
int fused_qkv_attention_fwd_residency(int T, int is_bf16, int* warps, int* smem_bytes,
                                      int* blocks) {
  if (!is_bf16) {
    const Launch geo = f32_launch(T);
    auto kernel = geo.n_tiles > 1 ? fused_fwd_f32<true> : fused_fwd_f32<false>;
    return int(residency(kernel, geo, warps, smem_bytes, blocks));
  }
  const Launch geo = bf16_launch(T);
  auto kernel = geo.n_tiles > 1 ? fused_fwd_bf16<true> : fused_fwd_bf16<false>;
  return int(residency(kernel, geo, warps, smem_bytes, blocks));
}

const char* avt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
