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
//     group: the group's heads share each K/V page, read once.  The split
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
// head_dim: the kernel is built 64 and 128 wide (D); any multiple of 8 up
// to 64 runs in the 64-wide one, any above in the 128-wide one, its rows
// zero-filled past the real head_dim in shared memory (cp.async's zero
// fill), so the padding adds nothing to a score, and only the real dims are
// written.  A pool row is copied in 16-byte pieces when its bytes allow,
// else in 8- or 4-byte ones (an int4 row at head_dim 80 is 40 bytes, at 24
// it is 12), so no pool is padded.  Page size: any power of two from 1 to
// 128, a run-time argument.
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
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int FMT_FLOAT = 0, FMT_INT8 = 1, FMT_INT4 = 2;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int RING_BUDGET = 32 * 1024;  // shared bytes for chunks in flight
constexpr int C = 16;  // positions per ring slot (one chunk of a row's positions)

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
// head_dim D (the shared rows' width; the pool's may be narrower).
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
// shared memory, read as one aligned load of their bytes.
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
__device__ __forceinline__ constexpr int value_byte(int e) {
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
// as float32 [G][D], then each warp's probabilities [G][NSLOT][C], then the
// splits' states [S][G][acc[D], m, l, pad] (the block of rank 0 receives
// every split's), then the mbarrier that counts them, then the split's table
// entries.
template <typename T, int FMT, int D>
__host__ __device__ constexpr int ring_bytes() {
  return Geo<T, FMT, D>::NSLOT * Geo<T, FMT, D>::SLOT;
}

template <typename T, int FMT, int D>
__host__ __device__ constexpr size_t smem_bytes(int group, int splits, int pps) {
  return ring_bytes<T, FMT, D>() + (size_t)group * D * 4 +
         (size_t)group * Geo<T, FMT, D>::NSLOT * C * 4 +
         (size_t)splits * group * (D + 4) * 4 + 8 + (size_t)pps * 4;
}

// A pool row's chunk cc of 16 bytes into shared memory at dst: the row's
// real bytes (row_bytes) and zeros past them, in the widest pieces (16, 8
// or 4 bytes) that every row start of the pool is aligned to.  `base` is
// the pool's 16-byte-aligned start, the mapped address a zero-filling copy
// names.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const uint8_t* row, int cc,
                                           int row_bytes, const uint8_t* base) {
  const int rem = row_bytes - 16 * cc;
  const uint8_t* src = row + 16 * cc;
  if ((row_bytes & 15) == 0) {
    cp_async16(dst, rem > 0 ? src : base, rem > 0);
  } else if ((row_bytes & 7) == 0) {
#pragma unroll
    for (int o = 0; o < 16; o += 8) hopper::cp_async8(dst + o, rem > o ? src + o : base, rem > o);
  } else {
#pragma unroll
    for (int o = 0; o < 16; o += 4) cp_async4(dst + o, rem > o ? src + o : base, rem > o);
  }
}

template <typename T, int FMT, int D>
__global__ void __launch_bounds__(1024) paged_decode_kernel(
    const T* __restrict__ q,             // [B, H, d]
    const uint8_t* __restrict__ pool_k,  // [P, PS, Hk, row_bytes]
    const uint8_t* __restrict__ pool_v,  // [P, PS, Hk, row_bytes]
    const float* __restrict__ scale_k,   // [P, PS, Hk]  (quantized formats)
    const float* __restrict__ scale_v,   // [P, PS, Hk]
    const int* __restrict__ table,       // [B, mpp]
    const int* __restrict__ lens,        // [B]
    T* __restrict__ out,                 // [B, H, d]
    int H, int Hk, int d, int log2_ps, int mpp, int pps, int window, float sm_scale) {
  using G_ = Geo<T, FMT, D>;
  constexpr bool QUANT = FMT != FMT_FLOAT;
  constexpr int NSLOT = G_::NSLOT, DP = G_::DP, DL = G_::DL, ELEMS = G_::ELEMS;
  constexpr int STATE = D + 4;  // floats per head: acc, m, l, pad (16-byte slots)

  extern __shared__ __align__(16) uint8_t smem[];
  const int G = blockDim.x >> 5;
  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  float* s_q = reinterpret_cast<float*>(smem + ring_bytes<T, FMT, D>());  // [G][D]
  float* s_prob = s_q + G * D;                                          // [G][NSLOT][C]
  float* s_state = s_prob + G * NSLOT * C;                                  // [S][G][STATE]
  uint64_t* s_mbar = reinterpret_cast<uint64_t*>(s_state + S * G * STATE);
  int* s_tab = reinterpret_cast<int*>(s_mbar + 1);                          // [pps]
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = hk * G + g;
  const int t = lane % C, part = lane / C;
  const int ps = 1 << log2_ps;
  const int row_bytes = value_byte<T, FMT>(d);  // a pool row's real bytes

  // Rank 0's mbarrier expects every split's state (acc, m and l of each
  // head).  Phase 0 of the cluster barrier then says this block has started
  // (and rank 0's mbarrier is initialised); it is waited on only before the
  // merge writes into rank 0's shared memory, long after.
  if (S > 1) {
    if (s == 0 && threadIdx.x == 0) mbar_init_expect(smem_u32(s_mbar), S * G * (D + 2) * 4);
    cluster_arrive_relaxed();
  }

  // Wave 1: lens, the query rows and the split's table entries, every
  // load issued before any is used.
  const int first = s * pps;
  const int len = max(lens[b], 0);
  float qx[DL];  // zero past the real head_dim
#pragma unroll
  for (int k = 0; k < DL; ++k) {
    const int e = lane * DL + k;
    qx[k] = e < d ? to_f(q[((size_t)b * H + h) * d + e]) : 0.f;
  }
  for (int i = threadIdx.x; i < pps; i += blockDim.x) {
    s_tab[i] = first + i < mpp ? table[b * mpp + first + i] : 0;
  }
#pragma unroll
  for (int k = 0; k < DL; ++k) s_q[g * D + lane * DL + k] = qx[k];
  // The split's live positions [tok_lo, tok_hi): its pages' positions
  // below len (and the table's end), at or past the window's first.
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int tok_lo = max(first * ps, lo);
  const int tok_hi = min(min(first + pps, mpp) * ps, len);
  const int np = max(tok_hi - tok_lo + C - 1, 0) / C;  // chunks (none when empty)
  __syncthreads();  // s_tab and s_q are in place

  // (page, position, kv head) row index of live position tok; positions
  // past the last live one read the last (finite, and masked below).
  const auto pool_row = [&](int tok) {
    tok = min(tok, tok_hi - 1);
    const int page = s_tab[(tok >> log2_ps) - first];
    return ((size_t)page * ps + (tok & (ps - 1))) * Hk + hk;
  };

  // Wave 2: the raw bytes of the split's positions into the ring, a chunk
  // of C positions a slot, as many as it holds (more come a ring at a
  // time).
  const auto issue = [&](int i, int slot) {
    uint8_t* base = smem + slot * G_::SLOT;
    const int t0 = tok_lo + i * C;
    for (int idx = threadIdx.x; idx < C * G_::VECS; idx += blockDim.x) {
      const int r = idx / G_::VECS, c = idx % G_::VECS;
      const size_t off = pool_row(t0 + r) * row_bytes;
      const int dst = chunk_off<G_::VECS, G_::SWZ>(r, c);
      copy_chunk(smem_u32(base + dst), pool_k + off, c, row_bytes, pool_k);
      copy_chunk(smem_u32(base + G_::PAGE + dst), pool_v + off, c, row_bytes, pool_v);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(base + 2 * G_::PAGE);  // [2][C]: K's, V's
      for (int idx = threadIdx.x; idx < 2 * C; idx += blockDim.x) {
        const float* src = (idx < C ? scale_k : scale_v) + pool_row(t0 + idx % C);
        cp_async4(smem_u32(sc + idx), src, true);
      }
    }
  };
  for (int i = 0; i < min(np, NSLOT); ++i) issue(i, i);
  cp_async_commit();

  // The ring's chunks are scored together and take one online-softmax
  // update: one max and one sum over the warp per ring, not per chunk.
  float m_run = -INFINITY, l_run = 0.f;
  float acc[DL];
#pragma unroll
  for (int k = 0; k < DL; ++k) acc[k] = 0.f;
  constexpr int KC = DP / ELEMS;  // 16-byte K chunks of a token's dot per lane
  constexpr int QE = ELEMS < 16 ? ELEMS : 16;  // values of a chunk scored together
  const float* qv = s_q + g * D + part * DP;  // this lane's DP query values
  float* probs = s_prob + g * NSLOT * C;      // this warp's [NSLOT][C]
  const int vb = value_byte<T, FMT>(lane * DL);  // where its DL output dims sit in a V row

  for (int c0 = 0; c0 < np; c0 += NSLOT) {
    const int nc = min(NSLOT, np - c0);  // chunks in the ring, uniform over the block
    cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed

    // Position t of each chunk: lanes of one position split the head_dim
    // dot.  Each piece of the query is read once for all of them; a piece
    // is at most 16 values (half an int4 chunk), which keeps the 128-wide
    // int4 build within the 64 registers 1024 threads leave it.
    float sc[NSLOT];
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) sc[j] = 0.f;
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

    // p.v: each lane reads its DL dims of every V row and the
    // probabilities as broadcasts, four tokens at a time.
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
            load_n<T, FMT, DL>(vpage + chunk_off<G_::VECS, G_::SWZ>(tt + u, vb >> 4) + (vb & 15),
                               x);
#pragma unroll
            for (int k = 0; k < DL; ++k) acc[k] = fmaf(pt[u], x[k], acc[k]);
          }
        }
      }
    }
    __syncwarp();  // done with the probabilities
    if (c0 + NSLOT < np) {  // more chunks than the ring holds: refill it
      __syncthreads();      // every warp is done with it
      for (int i = c0 + NSLOT; i < min(np, c0 + 2 * NSLOT); ++i) issue(i, i - c0 - NSLOT);
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
  float m_r[MAX_SPLITS], l_r[MAX_SPLITS], a_r[MAX_SPLITS][DL];
  float m_star = -INFINITY;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    const float* st = s_state + (min(r, S - 1) * G + g) * STATE;  // read in bounds
    m_r[r] = r < S ? st[D] : -INFINITY;
    l_r[r] = r < S ? st[D + 1] : 0.f;
#pragma unroll
    for (int k = 0; k < DL; ++k) a_r[r][k] = r < S ? st[lane * DL + k] : 0.f;
    m_star = fmaxf(m_star, m_r[r]);
  }
  const float m_use = m_star > -INFINITY ? m_star : 0.f;  // no split saw anything: all 0
  float denom = 0.f, o[DL];
#pragma unroll
  for (int k = 0; k < DL; ++k) o[k] = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_SPLITS; ++r) {
    const float alpha = expf(m_r[r] - m_use);  // an empty split (m = -inf) adds nothing
    denom += alpha * l_r[r];
#pragma unroll
    for (int k = 0; k < DL; ++k) o[k] = fmaf(alpha, a_r[r][k], o[k]);
  }
  if (denom == 0.f) denom = 1.f;  // all-masked row -> 0, not NaN
  T* orow = out + ((size_t)b * H + h) * d;
#pragma unroll
  for (int k = 0; k < DL; ++k) {
    if (lane * DL + k < d) orow[lane * DL + k] = from_f<T>(o[k] / denom);
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
  int batch, heads, kv_heads, head_dim, log2_ps, mpp, splits, window;
  float sm_scale;
  cudaStream_t stream;
};

// Grid (row, kv head, split), a warp per query head, the splits of a row
// and kv head as one cluster (none for one split).
cudaLaunchConfig_t launch_config(int batch, int kv_heads, int group, int splits, size_t smem,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, kv_heads, splits);
  cfg.blockDim = dim3(32 * group);
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

template <typename T, int FMT, int D>
int launch(const Args& a) {
  const int group = a.heads / a.kv_heads;
  const int pps = (a.mpp + a.splits - 1) / a.splits;
  const size_t smem = smem_bytes<T, FMT, D>(group, a.splits, pps);
  const auto kernel = paged_decode_kernel<T, FMT, D>;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(a.batch, a.kv_heads, group, a.splits, smem, a.stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const uint8_t*>(a.pool_k),
      static_cast<const uint8_t*>(a.pool_v), a.scale_k, a.scale_v, a.table, a.lens,
      static_cast<T*>(a.out), a.heads, a.kv_heads, a.head_dim, a.log2_ps, a.mpp, pps, a.window,
      a.sm_scale);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Any multiple of 8 up to 64 runs the 64-wide kernel, above it the
// 128-wide one.
template <typename T, int FMT>
int dispatch(const Args& a) {
  if (a.head_dim < 8 || a.head_dim > 128 || a.head_dim % 8) return (int)cudaErrorInvalidValue;
  return a.head_dim <= 64 ? launch<T, FMT, 64>(a) : launch<T, FMT, 128>(a);
}

template <typename T>
int dispatch_format(int kv_format, const Args& a) {
  switch (kv_format) {
    case FMT_FLOAT: return dispatch<T, FMT_FLOAT>(a);
    case FMT_INT8: return dispatch<T, FMT_INT8>(a);
    case FMT_INT4: return dispatch<T, FMT_INT4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// log2 of a page size that is a power of two from 1 to 128, else -1.
int page_log2(int page_size) {
  for (int l = 0; l <= 7; ++l) {
    if (page_size == 1 << l) return l;
  }
  return -1;
}

bool bad_split(int heads, int kv_heads, int splits) {
  return kv_heads <= 0 || heads % kv_heads != 0 || heads / kv_heads > 32 || splits < 1 ||
         splits > MAX_SPLITS;
}

}  // namespace

// kv_format: 0 float pools (in the query's type), 1 int8, 2 int4-packed;
// the quantized formats need both scale pools, the float one takes none.
// head_dim a multiple of 8 from 8 to 128; page_size a power of two from 1
// to 128.
// splits: 1..8 (one cluster of that many blocks per row and kv head).
extern "C" int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                                   const void* scale_k, const void* scale_v,
                                   const void* table, const void* lens, void* out, int batch,
                                   int heads, int kv_heads, int head_dim, int page_size,
                                   int mpp, int splits, int window, float sm_scale,
                                   int kv_format, int is_bf16, void* stream) {
  const int log2_ps = page_log2(page_size);
  if (bad_split(heads, kv_heads, splits) || log2_ps < 0) return (int)cudaErrorInvalidValue;
  if ((kv_format != FMT_FLOAT) != (scale_k != nullptr && scale_v != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, pool_k, pool_v, static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v), static_cast<const int*>(table),
               static_cast<const int*>(lens), out, batch, heads, kv_heads, head_dim, log2_ps,
               mpp, splits, window, sm_scale, static_cast<cudaStream_t>(stream)};
  if (is_bf16) return dispatch_format<__nv_bfloat16>(kv_format, a);
  return dispatch_format<float>(kv_format, a);
}

// The empty kernel with the paged kernel's grid, block and cluster shape
// for this batch, head layout and split count.
extern "C" int paged_attention_empty(int batch, int heads, int kv_heads, int splits,
                                     void* stream) {
  if (bad_split(heads, kv_heads, splits)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(batch, kv_heads, heads / kv_heads, splits, 0,
                                               static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel, 0);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
