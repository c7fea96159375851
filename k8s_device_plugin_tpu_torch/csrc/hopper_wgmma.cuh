// Hopper (sm_90a) building blocks shared by the tensor-core attention
// kernels: cp.async copies into 128-byte-swizzled shared tiles, wgmma
// shared-memory descriptors for those tiles, and the m64n64k16 bf16 wgmma
// with float32 accumulators (A from shared memory or from registers).
//
// Tile layout.  Every shared tile here is made of slabs of 64 bf16 columns
// (128 bytes a row), each slab's base 1024-byte aligned; head_dim 64 is one
// slab a row, head_dim 128 two, side by side in memory (slab s of a 64-row
// tile starts s * TILE64_BYTES in).  16-byte chunk c of row r of a slab
// lives at r * 128 + ((c ^ (r % 8)) * 16): the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and that the descriptor's layout type 1
// ("B128") reads.  Such a slab serves wgmma two ways:
//   - K-major (the row is the reduction axis, e.g. Q or K in Q.K^T): one
//     8-row group is 1024 bytes (SBO), and the k16 step kk starts 32 * kk
//     bytes into the row; a 128-wide reduction runs the four steps of each
//     slab in turn;
//   - MN-major (the row is the output axis, e.g. V in P.V, transpose bit
//     set): 16 rows of the reduction axis per step, so step kk starts
//     2048 * kk bytes in; 64 columns are one swizzle atom wide, so the
//     stride between atoms along N never comes into play, and each slab is
//     the B operand of its own 64 output columns.
// A wrong swizzle or descriptor gives wrong numbers, not a fault: the card
// tests hold every kernel built on this against its plain version.
//
// Head dims below the instantiated width (16 and 32 in the 64-wide
// kernels) load as zero columns past the real head_dim: they add nothing to
// any product, and the epilogues write only the real columns.
//
// Accumulator layout of m64nN (PTX ISA, wgmma D fragments): thread t of the
// warpgroup, warp w = t / 32, lane l = t % 32, holds element i of its N / 2
// floats at row 16 w + l / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
// 2 * (l % 4) + i % 2.  So each thread owns two rows, and a row's values are
// spread over the four lanes of a quad.  The A fragment of an m64k16 wgmma
// from registers has the same layout over 16 columns, which is what lets a
// softmax written in the accumulator's registers feed the next product
// without passing through shared memory (see a_frag).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int ROW_BYTES = 128;                  // 64 bf16 values: one slab row
constexpr int TILE64_BYTES = 64 * ROW_BYTES;    // a 64-row tile
constexpr int SWIZZLE_ATOM_BYTES = 8 * ROW_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte-aligned address at or after the dynamic shared
// memory's base (a launch reserves SWIZZLE_ATOM_BYTES of slack for it).
__device__ __forceinline__ uint32_t aligned_smem_base(const void* dyn) {
  return (smem_u32(dyn) + SWIZZLE_ATOM_BYTES - 1) & ~uint32_t(SWIZZLE_ATOM_BYTES - 1);
}

// ------------------------------------------------------------------ cp.async

// 16 bytes global -> shared; with valid false the destination is zero-filled
// and nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when not valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's completed shared-memory writes visible to the async
// proxy that wgmma reads through (then a barrier publishes them to all).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 8 bytes global -> shared, zero-filled when not valid (src 8-byte aligned).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

// Copy ROWS rows of D columns of a bf16 matrix (row stride ld, starting at
// src) into the D / 64 swizzled slabs of the tile at `tile`, spread over
// THREADS threads with 16 bytes each per step; rows at or past `valid_rows`
// and columns at or past `valid_cols` (a multiple of 8) are zero-filled.
// Neighbouring threads take neighbouring 16-byte chunks of a row, so the
// reads coalesce.  A piece of a wider row (the wide kernels' 64-column
// pieces of a head_dim past the builds) is src at the piece's first column
// with ld the whole row.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_sw128_ld(uint32_t tile, const __nv_bfloat16* src,
                                                   int ld, int valid_rows, int valid_cols,
                                                   int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert(D % 64 == 0 && (ROWS * CPR) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CPR, cc = idx % CPR;  // row, chunk of the row
    const int slab = cc >> 3, c = cc & 7;
    const bool ok = r < valid_rows && cc * 8 < valid_cols;
    cp_async16(tile + slab * ROWS * ROW_BYTES + r * ROW_BYTES + ((c ^ (r & 7)) << 4),
               src + (ok ? (size_t)r * ld + cc * 8 : 0), ok);
  }
}

// The whole rows of a matrix with d_real columns (a multiple of 8), its row
// stride.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_sw128(uint32_t tile, const __nv_bfloat16* src,
                                                int valid_rows, int d_real, int tid) {
  load_tile_sw128_ld<ROWS, D, THREADS>(tile, src, d_real, valid_rows, d_real, tid);
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}

// k16 step kk of a K-major tile (LBO is unused under a 128-byte swizzle).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 16, SWIZZLE_ATOM_BYTES);
}

// k16 step kk of an MN-major tile.  Both offsets name the one stride that
// matters at N = 64, the 1024 bytes between 8-row groups of the reduction
// axis, so either reading of the two fields gives the same layout.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return desc_sw128(tile + 2 * SWIZZLE_ATOM_BYTES * kk, SWIZZLE_ATOM_BYTES, SWIZZLE_ATOM_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_OUT32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A.B, m64n64k16, A and B K-major in shared memory.  accumulate 0
// overwrites d (the first k16 step of a product).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A.B, m64n64k16, A from registers (a_frag), B MN-major in shared
// memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef HOPPER_D32
#undef HOPPER_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment for k16 step kk from an m64n64 float32 accumulator, each
// value rounded to bf16 (the only rounding before the product): columns
// 16 kk .. 16 kk + 15 are the accumulator's 8-column blocks 2 kk and
// 2 kk + 1, whose elements 4 j .. 4 j + 3 are (row, c), (row, c + 1),
// (row + 8, c), (row + 8, c + 1) -- the fragment's a0..a3 order.
__device__ __forceinline__ void a_frag(const float (&s)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// Row (0..63) and column (0..63) within the m64n64 tile of accumulator
// element i for thread tid of the warpgroup.
__device__ __forceinline__ int acc_row(int tid, int i) {
  return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

// Sum or max over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace hopper
