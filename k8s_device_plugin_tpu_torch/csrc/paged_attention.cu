// Split-K paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/paged_attention.py
// _paged_kernel (launched by _paged_pallas, page step _page_update) and its
// XLA second stage _combine_splits.  One query token per row attends over
// the row's pages of a shared KV pool [pages, page_size, kv_heads, head_dim]
// through a page table [batch, pages_per_seq], with the frontier mask
// (col < len) and the sliding-window mask (col >= len - window).
//
// Bound on the card: bytes, in principle.  Each live token's K and V row is
// read once (2 x kv_heads x head_dim x 2 bytes in bf16) for about 4 x group
// x head_dim flops, far below the ~295 flop/byte at which Hopper's tensor
// cores would become the limit.  At the serving shape (8 rows, a few
// hundred tokens each) those bytes take well under a microsecond, so what
// bounds the kernel in practice is latency: one launch and the chain of
// dependent memory round trips a block waits on.  The design keeps that
// chain short:
//   - grid (row, kv head, split), one warp per query head of the kv head's
//     group (or of a tile of it, below): the group's heads share each K/V
//     page, read once.  The split
//     axis spreads a row's pages over blocks so that the 132 SMs have work
//     (ops/tuning.py picks the split count); split s takes table entries
//     [s * pps, (s + 1) * pps), the reference's partition, and only the live
//     positions (below len, at or past the window's first), so no dead
//     page is read.  Spreading a row's live pages evenly
//     over the splits would halve the busiest block's pages at the serving
//     shape, but the plain version would then round probabilities against
//     other maxima than the reference and miss its bf16 test by one ulp;
//     so the splits past a short row's pages stay idle;
//   - every memory read of a block is in flight at once, in two waves:
//     lens, the split's table entries and the query rows together; then
//     cp.async copies of the raw bytes of the split's positions into
//     shared memory, in chunks of C = 16 positions, whatever the page size
//     (a chunk spans several small pages or part of a large one, each row
//     looked up through the table), up to the ring's NSLOT chunks; more
//     stream through it;
//   - rows are converted from the raw shared bytes at use, by every lane:
//     lane t of a warp scores position t of each chunk in the ring (the
//     two lanes t and t + 16 split the head_dim dot), the ring's chunks
//     take one online-softmax update (m, l), and each lane accumulates
//     head_dim / 32 output dims of p.v, reading the probabilities from
//     shared memory as broadcasts.  16-byte chunks are XOR-swizzled by row in shared memory,
//     so the lanes that read one chunk of eight rows hit eight different
//     bank groups.  The loops are unrolled over the ring's slots without a
//     branch per slot (an empty slot's score is dropped by a select), so
//     their shared-memory loads overlap;
//   - the splits merge inside the same launch: the splits of a (row, kv
//     head) form one thread-block cluster (cluster dims (1, 1, splits), at
//     most 8, the portable size).  Each block stores its (m, l, acc) into
//     the shared memory of the block of rank 0 with st.async, which counts
//     the bytes on an mbarrier there; rank 0 waits for them all and merges
//     in split order, exactly as _combine_splits: m* = max m_s, out =
//     sum(e^(m_s-m*) acc_s) / sum(e^(m_s-m*) l_s), with empty splits
//     (m = -inf) contributing nothing and an all-masked row giving 0.  (A
//     release barrier instead costs a GPU-wide memory fence, about 1300
//     cycles.)  One split needs no cluster.  So a call is one kernel and
//     allocates nothing.
// TPU layout that does not apply here: the group padding to 8 sublanes and
// the 128-lane replicated m/l scratch.
//
// Pool formats (the template parameter FMT), as the TPU kernel's branches:
//   - float: float32 or bfloat16 pools in the query's type;
//   - int8: int8 codes plus float32 scale pools [pages, page_size,
//     kv_heads], one scale per (position, kv head);
//   - int4: two signed 4-bit codes per byte along head_dim (element 2i in
//     the low nibble, ops/quant.py pack_int4) plus the same scale pools.
// Shapes: any head_dim, any page size, any kv group, as the reference.
//   - head_dim: the kernel is built 64, 128 and 256 wide (D, the shared
//     rows' width); any head_dim up to 256 runs in the narrowest build that
//     holds it, its rows zero-filled past the real head_dim in shared
//     memory, so the padding adds nothing to a score, and only the real
//     dims are written.  Above 256 (the 256-wide build's WIDE variant;
//     the others compile with one slab) the output dims are cut into 256-wide
//     slabs, one block each (grid axis y), and each block scores over the
//     whole head_dim in 256-wide pieces of K streamed through the ring
//     (the query rows stay whole in shared memory), then accumulates p.v
//     over its own slab of V: a wider head_dim re-reads K once per slab,
//     never more registers.  A pool row is copied in 16-byte pieces when
//     its bytes allow, else in 8- or 4-byte ones (an int4 row at head_dim
//     80 is 40 bytes, at 24 it is 12), else, for rows of an odd number of
//     halves or bytes (bf16 or int4 at head_dim 20, int8 at 3), by plain
//     loads and stores; no pool is padded;
//   - page size: any, a run-time divisor taken by a multiply-high and a
//     shift (the ring holds positions, not pages: a chunk of C positions
//     spans several small pages or part of a large one);
//   - kv group: a block takes at most 16 query heads (its launch bound),
//     and fewer when its shared memory (the ring, the split's table
//     entries, and the query rows, probabilities and every split's state
//     for each head) would pass the 227 KB a block may hold; a larger
//     group is cut into equal tiles of heads, one block each (grid axis
//     y), each reading the kv head's pages again.  The splits of each tile
//     still merge in one cluster, in the same launch.  The table entries
//     are always staged: a split of more than about 48,000 pages (a page of
//     one position past 380,000 positions at 8 splits) leaves no room for
//     one head, and the launch fails, as the reference's table, staged
//     whole in the TPU's scalar memory, has its own ceiling.
//
// Codes convert exactly, at use, through the mantissa of 2^23 rather than
// I2F (i8_to_f, i4_to_f).  No dequantized page is formed: the
// scale of K multiplies the score after sm_scale, and the scale of V
// multiplies the probability after the denominator l has summed it
// unscaled, then rounds to the query's type before p.v, in the reference's
// order.  The scales are read in the engine's [pages, page_size, kv_heads]
// layout; the TPU's swap to put page_size on the lane axis has no
// counterpart here.
//
// Types: scores, softmax state and accumulators are float32; probabilities
// are rounded to the query's type before p.v, as the reference casts them
// to v's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"  // the cp.async helpers

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async8;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int FMT_FLOAT = 0, FMT_INT8 = 1, FMT_INT4 = 2;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int RING_BUDGET = 32 * 1024;  // shared bytes for chunks in flight
constexpr int C = 16;  // positions per ring slot (one chunk of a row's positions)
constexpr size_t SMEM_LIMIT = 232448;  // the 227 KB of shared memory a block may ask for

// Query heads (warps) a block takes at most: its launch bound, with one
// block an SM named as the minimum, gives every build 128 registers a
// thread (at 1024 threads, or at 512 without the minimum, ptxas holds it to
// 64, and the generality below spills there).
constexpr int MAX_HEADS = 16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

constexpr unsigned FULL = 0xffffffffu;

// The kernel's compile-time geometry for query type T, pool format FMT and
// width D (the shared rows' width; the pool's may be narrower or wider).
template <typename T, int FMT, int D>
struct Geo {
  // Values per 16-byte chunk of a shared row, and a shared row's bytes.
  static constexpr int ELEMS =
      FMT == FMT_FLOAT ? 16 / (int)sizeof(T) : (FMT == FMT_INT8 ? 16 : 32);
  static constexpr int VECS = D / ELEMS;           // 16-byte chunks per row
  static constexpr int ROW = VECS * 16;
  static constexpr int SWZ = VECS < 8 ? VECS : 8;  // rows a swizzle pattern spans
  static constexpr int PAGE = C * ROW;             // one chunk of K (or V) of one kv head
  static constexpr int SLOT = 2 * PAGE + (FMT == FMT_FLOAT ? 0 : 2 * C * 4);  // K, V, scales
  // Slots in the ring: as many as RING_BUDGET holds, 2 to 4 (the code is
  // unrolled over them, and a longer kernel costs instruction fetches).
  static constexpr int NSLOT = RING_BUDGET / SLOT < 2   ? 2
                               : RING_BUDGET / SLOT > 4 ? 4
                                                        : RING_BUDGET / SLOT;
  static constexpr int PARTS = 32 / C;     // lanes sharing one position's dot
  static constexpr int DP = D / PARTS;     // dims of the dot each of them takes
  static constexpr int DL = D / 32;        // output dims each lane accumulates
  // A lane's DL output dims of a V row: their bytes, read in loads of at
  // most 16 bytes (one swizzled chunk each).
  static constexpr int VB = FMT == FMT_FLOAT ? DL * (int)sizeof(T) : (FMT == FMT_INT8 ? DL : DL / 2);
  static constexpr int NV = VB > 16 ? VB / 16 : 1;
  static_assert(DP % ELEMS == 0 && SLOT % 16 == 0, "whole chunks per lane and slot");
};

// Byte offset of 16-byte chunk c of row r within a page: chunks are
// XOR-swizzled by the row.
template <int VECS, int SWZ>
__device__ __forceinline__ int chunk_off(int r, int c) {
  return r * VECS * 16 + ((c ^ (r & (SWZ - 1))) << 4);
}

// A signed code as float32, exactly, without I2F (which runs at a quarter
// of the FADD rate): the code plus its bias is written into the low
// mantissa bits of 2^23, and 2^23 plus the bias is subtracted.  For an
// int8 byte r, r ^ 0x80 = code + 128; for an int4 nibble r, r ^ 8 = code + 8.
__device__ __forceinline__ float i8_to_f(uint32_t byte) {
  return __uint_as_float((byte & 0xFFu) ^ 0x4B000080u) - 8388736.f;
}
__device__ __forceinline__ float i4_to_f(uint32_t nibble) {
  return __uint_as_float((nibble & 0xFu) ^ 0x4B000008u) - 8388616.f;
}

// Exact conversion of N consecutive values (N even) starting at byte p of
// a row (shared memory, or a chunk held in registers).
template <typename T, int FMT, int N>
__device__ __forceinline__ void decode_n(const uint8_t* p, float* dst) {
  if constexpr (FMT == FMT_FLOAT) {
    const T* x = reinterpret_cast<const T*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f(x[i]);
  } else if constexpr (FMT == FMT_INT8) {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = i8_to_f(p[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      dst[2 * i] = i4_to_f(p[i]);           // low nibble: element 2i
      dst[2 * i + 1] = i4_to_f(p[i] >> 4);  // high nibble: element 2i+1
    }
  }
}

// Exact conversion of N consecutive values starting at byte p of a row in
// shared memory, read as one aligned load of their bytes (at most 16).
template <int NB> struct Bytes;
template <> struct Bytes<1> { using type = uint8_t; };
template <> struct Bytes<2> { using type = uint16_t; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

template <typename T, int FMT, int N>
__device__ __forceinline__ void load_n(const uint8_t* p, float* dst) {
  constexpr int NB = FMT == FMT_FLOAT ? N * (int)sizeof(T) : (FMT == FMT_INT8 ? N : N / 2);
  const typename Bytes<NB>::type raw = *reinterpret_cast<const typename Bytes<NB>::type*>(p);
  decode_n<T, FMT, N>(reinterpret_cast<const uint8_t*>(&raw), dst);
}

// The byte where value e of a row starts (for int4, the byte holding the
// pair 2i, 2i + 1 with e = 2i).
template <typename T, int FMT>
__host__ __device__ __forceinline__ constexpr int value_byte(int e) {
  return FMT == FMT_FLOAT ? e * (int)sizeof(T) : (FMT == FMT_INT8 ? e : e / 2);
}

// Thread-block-cluster primitives (PTX): the cluster barrier's relaxed
// arrive and its wait (acquire); mapa, the address of the same shared
// variable in the block of another rank; mbarrier init, expect-tx and a
// bounded wait; st.async, a store into another block's shared memory that
// counts its bytes on an mbarrier there.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(mbar),
      "r"(bytes)
      : "memory");
}
// Wait for phase 0 of the mbarrier; gives up after `tries` polls (a wrong
// byte count then shows as a wrong result, not as a hung card).
__device__ __forceinline__ void mbar_wait0(uint32_t mbar, int tries) {
  for (int i = 0; i < tries; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar)
        : "memory");
    if (done) return;
  }
}
__device__ __forceinline__ void st_async(uint32_t addr, float a, float b, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::
          "r"(addr),
      "f"(a), "f"(b), "r"(mbar)
      : "memory");
}
template <int N> __device__ __forceinline__ void st_async_n(uint32_t addr, const float (&x)[N],
                                                           uint32_t mbar) {
#pragma unroll
  for (int k = 0; k < N; k += 2) st_async(addr + 4 * k, x[k], x[k + 1], mbar);
}

// Dynamic shared memory: the chunk ring (NSLOT slots of K chunk, V chunk
// and, for the quantized formats, their C scales each), then the query rows
// as float32 [G][slabs * D] (every piece of the head_dim), then each warp's
// probabilities [G][NSLOT][C], then the splits' states [S][G][acc[D], m, l,
// pad] (the block of rank 0 receives every split's), then the mbarrier that
// counts them, then the split's table entries.
template <typename T, int FMT, int D>
__host__ __device__ constexpr int ring_bytes() {
  return Geo<T, FMT, D>::NSLOT * Geo<T, FMT, D>::SLOT;
}

// The shared bytes of everything but the ring and the table, per head.
template <typename T, int FMT, int D>
__host__ __device__ constexpr size_t head_bytes(int splits, int slabs) {
  return (size_t)slabs * D * 4 + (size_t)Geo<T, FMT, D>::NSLOT * C * 4 +
         (size_t)splits * (D + 4) * 4;
}

template <typename T, int FMT, int D>
__host__ __device__ constexpr size_t smem_bytes(int heads, int splits, int slabs, int tab) {
  return ring_bytes<T, FMT, D>() + heads * head_bytes<T, FMT, D>(splits, slabs) + 8 +
         (size_t)tab * 4;
}

// Bytes [16 cc, 16 cc + 16) of a piece of a pool row into shared memory at
// dst: the piece's real bytes (nbytes) and zeros past them.  `unit` is the
// widest piece (16, 8 or 4 bytes) that every row start of the pool is
// aligned to, and a copy in that unit; 1 stands for rows of an odd number
// of halves or bytes, copied by plain loads and stores (visible after the
// barrier that follows the ring's wait).  `base` is the pool's
// 16-byte-aligned start, the mapped address a zero-filling copy names.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const uint8_t* piece, int cc,
                                           int nbytes, int unit, const uint8_t* base) {
  const int rem = nbytes - 16 * cc;
  const uint8_t* src = piece + 16 * cc;
  if (unit == 16) {
    cp_async16(dst, rem > 0 ? src : base, rem > 0);
  } else if (unit == 8) {
#pragma unroll
    for (int o = 0; o < 16; o += 8) cp_async8(dst + o, rem > o ? src + o : base, rem > o);
  } else if (unit == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) cp_async4(dst + o, rem > o ? src + o : base, rem > o);
  } else {
#pragma unroll
    for (int o = 0; o < 16; o += 4) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rem > o + i) word |= (uint32_t)src[o + i] << (8 * i);
      }
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst + o), "r"(word) : "memory");
    }
  }
}

// The kernel for query type T, pool format FMT and shared-row width D.
// WIDE (only D = 256 has such a build) takes a head_dim past D in 256-wide
// slabs and pieces; every other build has one slab, fixed when it is
// compiled, so the head_dims the builds hold in one piece run none of the
// slab and piece arithmetic.
template <typename T, int FMT, int D, bool WIDE>
__global__ void __launch_bounds__(32 * MAX_HEADS, 1) paged_decode_kernel(
    const T* __restrict__ q,             // [B, H, d]
    const uint8_t* __restrict__ pool_k,  // [P, PS, Hk, row_bytes]
    const uint8_t* __restrict__ pool_v,  // [P, PS, Hk, row_bytes]
    const float* __restrict__ scale_k,   // [P, PS, Hk]  (quantized formats)
    const float* __restrict__ scale_v,   // [P, PS, Hk]
    const int* __restrict__ table,       // [B, mpp]
    const int* __restrict__ lens,        // [B]
    T* __restrict__ out,                 // [B, H, d]
    int H, int Hk, int d, int ps, uint32_t ps_magic, int ps_log, int mpp, int pps, int window,
    float sm_scale, int group, int tiles, int wide_slabs) {
  using G_ = Geo<T, FMT, D>;
  constexpr bool QUANT = FMT != FMT_FLOAT;
  constexpr int NSLOT = G_::NSLOT, DP = G_::DP, DL = G_::DL, ELEMS = G_::ELEMS;
  constexpr int STATE = D + 4;  // floats per head: acc, m, l, pad (16-byte slots)

  extern __shared__ __align__(16) uint8_t smem[];
  const int G = blockDim.x >> 5;  // query heads of this block (a tile of the group)
  const int slabs = WIDE ? wide_slabs : 1;
  const int dq = slabs * D;       // a shared query row: the whole head_dim, zero-padded
  // Grid (row, (kv head, tile, slab), split).
  const int b = blockIdx.x, s = blockIdx.z, S = gridDim.z;
  const int slab = WIDE ? blockIdx.y % slabs : 0;
  const int tile = blockIdx.y / slabs % tiles;
  const int hk = blockIdx.y / (slabs * tiles);
  float* s_q = reinterpret_cast<float*>(smem + ring_bytes<T, FMT, D>());  // [G][dq]
  float* s_prob = s_q + G * dq;                                          // [G][NSLOT][C]
  float* s_state = s_prob + G * NSLOT * C;                                  // [S][G][STATE]
  uint64_t* s_mbar = reinterpret_cast<uint64_t*>(s_state + S * G * STATE);
  int* s_tab = reinterpret_cast<int*>(s_mbar + 1);                          // [pps]
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warp's head in the kv head's group; a last tile's spare warps redo
  // its last head and write nothing.
  const int gi = tile * G + g;
  const bool active = gi < group;
  const int h = hk * group + min(gi, group - 1);
  const int t = lane % C, part = lane / C;
  const int row_bytes = value_byte<T, FMT>(d);  // a pool row's real bytes
  const int unit = row_bytes & 15 ? (row_bytes & 7 ? (row_bytes & 3 ? 1 : 4) : 8) : 16;
  const int col0 = slab * D;  // this block's output dims [col0, col0 + D)
  const int v_off = value_byte<T, FMT>(col0), v_bytes = value_byte<T, FMT>(min(D, d - col0));

  // Rank 0's mbarrier expects every split's state (acc, m and l of each
  // head).  Phase 0 of the cluster barrier then says this block has started
  // (and rank 0's mbarrier is initialised); it is waited on only before the
  // merge writes into rank 0's shared memory, long after.
  if (S > 1) {
    if (s == 0 && threadIdx.x == 0) mbar_init_expect(smem_u32(s_mbar), S * G * (D + 2) * 4);
    cluster_arrive_relaxed();
  }

  // Wave 1: lens, the query rows' first piece and the split's table
  // entries, every load issued (into registers) before any is stored or
  // used; a head_dim past 256 loads its other pieces after.
  const int first = s * pps;
  const int len = max(lens[b], 0);
  const T* qrow = q + ((size_t)b * H + h) * d;
  float qx[DL];  // zero past the real head_dim
#pragma unroll
  for (int k = 0; k < DL; ++k) {
    const int e = lane * DL + k;
    qx[k] = e < d ? to_f(qrow[e]) : 0.f;
  }
  for (int i = threadIdx.x; i < pps; i += blockDim.x) {
    s_tab[i] = first + i < mpp ? table[(size_t)b * mpp + first + i] : 0;
  }
#pragma unroll
  for (int k = 0; k < DL; ++k) s_q[g * dq + lane * DL + k] = qx[k];
  if constexpr (WIDE) {
    for (int e = D + lane; e < dq; e += 32) s_q[g * dq + e] = e < d ? to_f(qrow[e]) : 0.f;
  }
  // The split's live positions [tok_lo, tok_hi): its pages' positions
  // below len (and the table's end), at or past the window's first.
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int tok_lo = max(first * ps, lo);
  const int tok_hi = min(min(first + pps, mpp) * ps, len);
  const int np = max(tok_hi - tok_lo + C - 1, 0) / C;  // chunks (none when empty)
  __syncthreads();  // s_tab and s_q are in place

  // (page, position, kv head) row index of live position tok; positions
  // past the last live one read the last (finite, and masked below).  The
  // page is tok / ps by a multiply-high, an add and a shift (ps_magic and
  // ps_log from the launcher), never a division.
  const auto pool_row = [&](int tok) {
    tok = min(tok, tok_hi - 1);
    const int page = (int)((__umulhi((uint32_t)tok, ps_magic) + (uint32_t)tok) >> ps_log);
    return ((size_t)s_tab[page - first] * ps + (tok - page * ps)) * Hk + hk;
  };

  // Wave 2: the raw bytes of the split's positions into the ring, a chunk
  // of C positions a slot, as many as it holds (more come a ring at a
  // time): piece `piece` of each K row (D values of the head_dim) and, with
  // the first piece, this block's slab of each V row and the scales.
  const auto issue = [&](int i, int slot, int piece, bool with_v) {
    uint8_t* base = smem + slot * G_::SLOT;
    const int t0 = tok_lo + i * C;
    const int k_off = value_byte<T, FMT>(piece * D);
    const int k_bytes = value_byte<T, FMT>(min(D, d - piece * D));
    for (int idx = threadIdx.x; idx < C * G_::VECS; idx += blockDim.x) {
      const int r = idx / G_::VECS, c = idx % G_::VECS;
      const size_t off = pool_row(t0 + r) * row_bytes;
      const int dst = chunk_off<G_::VECS, G_::SWZ>(r, c);
      copy_chunk(smem_u32(base + dst), pool_k + off + k_off, c, k_bytes, unit, pool_k);
      if (with_v) {
        copy_chunk(smem_u32(base + G_::PAGE + dst), pool_v + off + v_off, c, v_bytes, unit,
                   pool_v);
      }
    }
    if constexpr (QUANT) {
      if (with_v) {
        float* sc = reinterpret_cast<float*>(base + 2 * G_::PAGE);  // [2][C]: K's, V's
        for (int idx = threadIdx.x; idx < 2 * C; idx += blockDim.x) {
          const float* src = (idx < C ? scale_k : scale_v) + pool_row(t0 + idx % C);
          cp_async4(smem_u32(sc + idx), src, true);
        }
      }
    }
  };
  for (int i = 0; i < min(np, NSLOT); ++i) issue(i, i, 0, true);
  cp_async_commit();

  // The ring's chunks are scored together and take one online-softmax
  // update: one max and one sum over the warp per ring, not per chunk.
  float m_run = -INFINITY, l_run = 0.f;
  float acc[DL];
#pragma unroll
  for (int k = 0; k < DL; ++k) acc[k] = 0.f;
  constexpr int KC = DP / ELEMS;  // 16-byte K chunks of a token's dot per lane
  constexpr int QE = ELEMS < 16 ? ELEMS : 16;  // values of a chunk scored together
  float* probs = s_prob + g * NSLOT * C;      // this warp's [NSLOT][C]
  const int vb = value_byte<T, FMT>(lane * DL);  // where its DL output dims sit in a V row

  for (int c0 = 0; c0 < np; c0 += NSLOT) {
    const int nc = min(NSLOT, np - c0);  // chunks in the ring, uniform over the block
    float sc[NSLOT];
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) sc[j] = 0.f;
    for (int piece = 0; piece < slabs; ++piece) {
      cp_async_wait<0>();
      __syncthreads();  // every thread's copies have landed

      // Position t of each chunk: lanes of one position split the head_dim
      // dot.  Each piece of the query is read once for all of them; a piece
      // is at most 16 values (half an int4 chunk), which bounds the
      // registers the wide int4 builds take.
      const float* qv = s_q + g * dq + piece * D + part * DP;  // this lane's DP query values
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int e0 = 0; e0 < ELEMS; e0 += QE) {
          float qc[QE];
#pragma unroll
          for (int e = 0; e < QE; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qv + c * ELEMS + e0 + e);
            qc[e] = q4.x, qc[e + 1] = q4.y, qc[e + 2] = q4.z, qc[e + 3] = q4.w;
          }
          // Every slot is read, filled or not (a branch per slot would keep
          // the loads from overlapping); an empty slot's score is dropped
          // below.
#pragma unroll
          for (int j = 0; j < NSLOT; ++j) {
            float x[QE];
            load_n<T, FMT, QE>(smem + j * G_::SLOT +
                                   chunk_off<G_::VECS, G_::SWZ>(t, part * KC + c) +
                                   value_byte<T, FMT>(e0),
                               x);
#pragma unroll
            for (int e = 0; e < QE; ++e) sc[j] = fmaf(qc[e], x[e], sc[j]);
          }
        }
      }
      if (piece + 1 < slabs) {  // a head_dim above 256: the next piece of K
        __syncthreads();        // every warp is done with this one
        for (int j = 0; j < nc; ++j) issue(c0 + j, j, piece + 1, false);
        cp_async_commit();
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) {
#pragma unroll
      for (int off = C; off < 32; off <<= 1) sc[j] += __shfl_xor_sync(FULL, sc[j], off);
      float v = sc[j] * sm_scale;
      if constexpr (QUANT) {
        v *= reinterpret_cast<const float*>(smem + j * G_::SLOT + 2 * G_::PAGE)[t];
      }
      const int col = tok_lo + (c0 + j) * C + t;
      sc[j] = j < nc && col < tok_hi ? v : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
#pragma unroll
    for (int off = 1; off < C; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m_run, mx);
    // Nothing seen yet: m stays -inf, and exponentials against 0 give 0
    // (exp(-inf - -inf) would be NaN).
    const float m_use = m_new > -INFINITY ? m_new : 0.f;
    const float alpha = expf(m_run - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) {
      const float p = expf(sc[j] - m_use);  // 0 for masked tokens and j >= nc
      psum += p;
      if (j < nc && part == 0) {
        float pv = p;
        if constexpr (QUANT) {
          pv *= reinterpret_cast<const float*>(smem + j * G_::SLOT + 2 * G_::PAGE)[C + t];
        }
        probs[j * C + t] = to_f(from_f<T>(pv));  // V's scale after l, then q's type
      }
    }
#pragma unroll
    for (int off = 1; off < C; off <<= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l_run = alpha * l_run + psum;  // l sums the probabilities before V's scale
    m_run = m_new;
    __syncwarp();  // the warp's probabilities are in place

    // p.v: each lane reads its DL dims of every V row (in NV loads of
    // swizzled chunks) and the probabilities as broadcasts, four tokens at
    // a time.
#pragma unroll
    for (int k = 0; k < DL; ++k) acc[k] *= alpha;
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) {
      if (j < nc) {
        const uint8_t* vpage = smem + j * G_::SLOT + G_::PAGE;
#pragma unroll
        for (int tt = 0; tt < C; tt += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(probs + j * C + tt);
          const float pt[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float x[DL];
#pragma unroll
            for (int n = 0; n < G_::NV; ++n) {
              load_n<T, FMT, DL / G_::NV>(
                  vpage + chunk_off<G_::VECS, G_::SWZ>(tt + u, (vb >> 4) + n) + (vb & 15),
                  x + n * (DL / G_::NV));
            }
#pragma unroll
            for (int k = 0; k < DL; ++k) acc[k] = fmaf(pt[u], x[k], acc[k]);
          }
        }
      }
    }
    __syncwarp();  // done with the probabilities
    if (c0 + NSLOT < np) {  // more chunks than the ring holds: refill it
      __syncthreads();      // every warp is done with it
      for (int i = c0 + NSLOT; i < min(np, c0 + 2 * NSLOT); ++i) issue(i, i - c0 - NSLOT, 0, true);
      cp_async_commit();
    }
  }

  // Merge: every split stores its (acc, m, l) into slot s of rank 0's
  // state array with st.async, which counts the bytes on rank 0's mbarrier
  // (once every block of the cluster has started); rank 0 waits for all of
  // them and merges the slots in split order s = 0..S-1, as
  // _combine_splits.  No block reads another's shared memory, and rank 0
  // exits only after every store into its own has landed.
  float* slot = s_state + (s * G + g) * STATE;
  if (S > 1) {
    cluster_wait();  // phase 0: every block has started
    const uint32_t mbar = mapa(smem_u32(s_mbar), 0);
    const uint32_t dst = mapa(smem_u32(slot), 0);
    st_async_n<DL>(dst + 4 * lane * DL, acc, mbar);
    if (lane == 0) st_async(dst + 4 * D, m_run, l_run, mbar);
    if (s != 0) return;
    mbar_wait0(smem_u32(s_mbar), 1 << 20);
  } else {
#pragma unroll
    for (int k = 0; k < DL; ++k) slot[lane * DL + k] = acc[k];
    if (lane == 0) {
      slot[D] = m_run;
      slot[D + 1] = l_run;
    }
    __syncwarp();
  }
  // The splits' states in shared memory, unrolled over MAX_SPLITS so their
  // loads overlap: their (m, l) and, up to 128 wide, their accumulators;
  // their max, then the sums against it (the 256-wide builds read the
  // accumulators in this second pass, which bounds their registers).
  constexpr int AR = D <= 128 ? DL : 1;  // accumulators held from the first pass
  float m_r[MAX_SPLITS], l_r[MAX_SPLITS], a_r[MAX_SPLITS][AR];
  float m_star = -INFINITY;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    const float* st = s_state + (min(r, S - 1) * G + g) * STATE;  // read in bounds
    m_r[r] = r < S ? st[D] : -INFINITY;
    l_r[r] = r < S ? st[D + 1] : 0.f;
    if constexpr (D <= 128) {
#pragma unroll
      for (int k = 0; k < DL; ++k) a_r[r][k] = r < S ? st[lane * DL + k] : 0.f;
    }
    m_star = fmaxf(m_star, m_r[r]);
  }
  const float m_use = m_star > -INFINITY ? m_star : 0.f;  // no split saw anything: all 0
  float denom = 0.f, o[DL];
#pragma unroll
  for (int k = 0; k < DL; ++k) o[k] = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    const float* st = s_state + (min(r, S - 1) * G + g) * STATE;
    const float alpha = expf(m_r[r] - m_use);  // an empty split (m = -inf) adds nothing
    denom += alpha * l_r[r];
#pragma unroll
    for (int k = 0; k < DL; ++k) {
      float a;
      if constexpr (D <= 128) {
        a = a_r[r][k];
      } else {
        a = r < S ? st[lane * DL + k] : 0.f;
      }
      o[k] = fmaf(alpha, a, o[k]);
    }
  }
  if (denom == 0.f) denom = 1.f;  // all-masked row -> 0, not NaN
  if (!active) return;
  T* orow = out + ((size_t)b * H + h) * d;
#pragma unroll
  for (int k = 0; k < DL; ++k) {
    const int e = col0 + lane * DL + k;
    if (e < d) orow[e] = from_f<T>(o[k] / denom);
  }
}

// A kernel that does nothing, launched like the paged kernel: the cost of
// one launch of that shape with no work (a latency floor).  The argument
// only keeps cudaLaunchKernelEx's argument array non-empty.
__global__ void empty_kernel(int) {}

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const float* scale_k;
  const float* scale_v;
  const int* table;
  const int* lens;
  void* out;
  int batch, heads, kv_heads, head_dim, page_size, mpp, splits, window;
  float sm_scale;
  cudaStream_t stream;
};

// How a call's heads and head_dim spread over blocks: `heads` query heads
// a block (a tile of the group), `tiles` tiles a kv head, `slabs` 256-wide
// slabs of the head_dim (1 up to 256).  The block's shared memory holds the
// ring, the split's pps table entries and, per head, its query row,
// probabilities and every split's state: a block takes as many heads as
// fit, at most MAX_HEADS.
struct Plan {
  int heads, tiles, slabs;
  size_t smem;
};

template <typename T, int FMT, int D>
Plan plan(int group, int splits, int pps, int head_dim) {
  Plan p{};
  p.slabs = (head_dim + D - 1) / D;
  const size_t fixed = smem_bytes<T, FMT, D>(0, splits, p.slabs, pps);
  const size_t per_head = head_bytes<T, FMT, D>(splits, p.slabs);
  const int fit = fixed < SMEM_LIMIT ? (int)((SMEM_LIMIT - fixed) / per_head) : 0;
  const int most = fit < MAX_HEADS ? fit : MAX_HEADS;
  if (most < 1) return p;  // heads 0: no block holds one head
  p.tiles = (group + most - 1) / most;
  p.heads = (group + p.tiles - 1) / p.tiles;  // equal tiles
  p.smem = smem_bytes<T, FMT, D>(p.heads, splits, p.slabs, pps);
  return p;
}

// tok / ps as (umulhi(tok, magic) + tok) >> log for every tok below 2^31:
// log = ceil(log2 ps), magic = floor(2^32 (2^log - ps) / ps) + 1 (a
// 33-bit multiplier 2^32 + magic; magic is 1 for a power of two).
void page_divisor(int ps, uint32_t* magic, int* ps_log) {
  int l = 0;
  while ((1ll << l) < ps) ++l;
  *ps_log = l;
  *magic = (uint32_t)((((1ull << l) - (unsigned long long)ps) << 32) / (unsigned long long)ps + 1);
}

// Grid (row, (kv head, tile, slab), split), a warp per query head of the
// tile, the splits of a row, kv head, tile and slab as one cluster (none
// for one split).
cudaLaunchConfig_t launch_config(int batch, int grid_y, int heads, int splits, size_t smem,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, grid_y, splits);
  cfg.blockDim = dim3(32 * heads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cfg;
}

template <typename T, int FMT, int D, bool WIDE>
int launch(const Args& a) {
  const int group = a.heads / a.kv_heads;
  const int pps = (a.mpp + a.splits - 1) / a.splits;
  const Plan p = plan<T, FMT, D>(group, a.splits, pps, a.head_dim);
  if (p.heads < 1) return (int)cudaErrorInvalidValue;
  uint32_t magic;
  int ps_log;
  page_divisor(a.page_size, &magic, &ps_log);
  const auto kernel = paged_decode_kernel<T, FMT, D, WIDE>;
  if (p.smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(a.batch, a.kv_heads * p.tiles * p.slabs, p.heads,
                                               a.splits, p.smem, a.stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const uint8_t*>(a.pool_k),
      static_cast<const uint8_t*>(a.pool_v), a.scale_k, a.scale_v, a.table, a.lens,
      static_cast<T*>(a.out), a.heads, a.kv_heads, a.head_dim, a.page_size, magic, ps_log, a.mpp,
      pps, a.window, a.sm_scale, group, p.tiles, p.slabs);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Head dims up to 64 run the 64-wide kernel, up to 128 the 128-wide one,
// up to 256 the 256-wide one, and above that its WIDE build (256-wide
// slabs).
template <typename T, int FMT>
int dispatch(const Args& a) {
  if (a.head_dim < 1) return (int)cudaErrorInvalidValue;
  if (a.head_dim <= 64) return launch<T, FMT, 64, false>(a);
  if (a.head_dim <= 128) return launch<T, FMT, 128, false>(a);
  return a.head_dim <= 256 ? launch<T, FMT, 256, false>(a) : launch<T, FMT, 256, true>(a);
}

template <typename T>
int dispatch_format(int kv_format, const Args& a) {
  switch (kv_format) {
    case FMT_FLOAT: return dispatch<T, FMT_FLOAT>(a);
    case FMT_INT8: return dispatch<T, FMT_INT8>(a);
    case FMT_INT4: return a.head_dim % 2 ? (int)cudaErrorInvalidValue : dispatch<T, FMT_INT4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_split(int heads, int kv_heads, int splits) {
  return kv_heads <= 0 || heads % kv_heads != 0 || splits < 1 || splits > MAX_SPLITS;
}

}  // namespace

// kv_format: 0 float pools (in the query's type), 1 int8, 2 int4-packed (an
// even head_dim); the quantized formats need both scale pools, the float
// one takes none.  Any head_dim, page size and kv group.
// splits: 1..8 (one cluster of that many blocks per row, kv head, tile and
// slab).
extern "C" int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                                   const void* scale_k, const void* scale_v,
                                   const void* table, const void* lens, void* out, int batch,
                                   int heads, int kv_heads, int head_dim, int page_size,
                                   int mpp, int splits, int window, float sm_scale,
                                   int kv_format, int is_bf16, void* stream) {
  if (bad_split(heads, kv_heads, splits) || page_size < 1) return (int)cudaErrorInvalidValue;
  if ((kv_format != FMT_FLOAT) != (scale_k != nullptr && scale_v != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, pool_k, pool_v, static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v), static_cast<const int*>(table),
               static_cast<const int*>(lens), out, batch, heads, kv_heads, head_dim, page_size,
               mpp, splits, window, sm_scale, static_cast<cudaStream_t>(stream)};
  if (is_bf16) return dispatch_format<__nv_bfloat16>(kv_format, a);
  return dispatch_format<float>(kv_format, a);
}

// The empty kernel with the paged kernel's grid, block and cluster shape
// for this batch, head layout and split count (a group above 16 in tiles
// of at most 16 heads, the kernel's bound).
extern "C" int paged_attention_empty(int batch, int heads, int kv_heads, int splits,
                                     void* stream) {
  if (bad_split(heads, kv_heads, splits)) return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads, tiles = (group + MAX_HEADS - 1) / MAX_HEADS;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(batch, kv_heads * tiles, (group + tiles - 1) / tiles,
                                               splits, 0, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel, 0);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
