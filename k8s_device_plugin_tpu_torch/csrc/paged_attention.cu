// Split-K paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/paged_attention.py
// _paged_kernel (launched by _paged_pallas, page step _page_update) and its
// XLA second stage _combine_splits.  One query token per row attends over
// the row's pages of a shared KV pool [pages, page_size, kv_heads, head_dim]
// through a page table [batch, pages_per_seq], with the frontier mask
// (col < len) and the sliding-window mask (col >= len - window).
//
// Bound on the card: bytes.  Each live token's K and V row is read once
// (2 x kv_heads x head_dim x 2 bytes in bf16) for about 4 x group x
// head_dim flops, far below the ~295 flop/byte at which Hopper's tensor
// cores would become the limit, so the kernel is built to read only live
// pages and to spread a small batch over many SMs:
//   - grid (row, kv head, split): a decode batch of 8 rows x 4 kv heads is
//     32 blocks; the split axis multiplies that so the 132 SMs have work
//     (ops/tuning.py picks the split count);
//   - each block loads its own table entries and lens[row] and loops only
//     over pages below ceil(len / page_size) (and at or past the window's
//     first page): no dead page is read.  The TPU needed a rectangular grid,
//     a pl.when predicate and table padding aliased to page 0 for the same
//     effect;
//   - the group's G query heads share each K/V page tile in shared memory
//     (one warp per query head), so a page is read once per kv head;
//   - per page, lane t of a warp scores token t (lanes past page_size
//     split the head_dim dot), then the warp keeps the online-softmax
//     state (m, l) and each lane accumulates head_dim / 32 output dims.
// One split normalises in the kernel; several write f32 partials that a
// second small kernel merges exactly: m* = max m_s, out = sum(e^(m_s-m*)
// acc_s) / sum(e^(m_s-m*) l_s), with empty splits (m = -inf) contributing
// nothing and an all-masked row giving 0.
// TPU layout that does not apply here: the group padding to 8 sublanes and
// the 128-lane replicated m/l scratch.
//
// Pool formats (the template parameter FMT), as the TPU kernel's branches:
//   - float: float32 or bfloat16 pools in the query's type;
//   - int8: int8 codes plus float32 scale pools [pages, page_size,
//     kv_heads], one scale per (position, kv head);
//   - int4: two signed 4-bit codes per byte along head_dim (element 2i in
//     the low nibble, ops/quant.py pack_int4) plus the same scale pools.
// Rows load as 16-byte vectors (8 bf16, 4 f32, 16 int8 or 32 int4 values)
// and convert exactly into the float shared-memory tile; the nibbles
// sign-extend with shifts on int32, (x << 28) >> 28 for the low one.  No
// dequantized page is formed: the scale of K multiplies the score after
// sm_scale, and the scale of V multiplies the probability after the
// denominator l has summed it unscaled, then rounds to the query's type
// before p.v, in the reference's order.  The scales are read in the
// engine's [pages, page_size, kv_heads] layout; the TPU's swap to put
// page_size on the lane axis has no counterpart here.  Quantized pools
// move 1/2 (int8) or 1/4 (int4) of the bf16 bytes, which the kernel's
// serial page loop does not turn into time at the serving shape (PERF.md).
//
// Types: scores, softmax state and accumulators are float32; probabilities
// are rounded to the query's type before p.v, as the reference casts them
// to v's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FMT_FLOAT = 0, FMT_INT8 = 1, FMT_INT4 = 2;

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

// One pool row (one position, one kv head) of D values in format FMT.
template <typename T, int FMT, int D>
struct Row {
  static constexpr int ELEMS = FMT == FMT_FLOAT ? 16 / (int)sizeof(T) : (FMT == FMT_INT8 ? 16 : 32);
  static constexpr int BYTES = FMT == FMT_FLOAT ? D * (int)sizeof(T) : (FMT == FMT_INT8 ? D : D / 2);
  static constexpr int VECS = D / ELEMS;  // 16-byte loads per row
};

// Exact conversion of one 16-byte load into Row::ELEMS floats.
template <typename T, int FMT>
__device__ __forceinline__ void decode16(const uint4& raw, float* dst) {
  if constexpr (FMT == FMT_FLOAT) {
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = to_f(x[i]);
  } else if constexpr (FMT == FMT_INT8) {
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = (float)x[i];
  } else {
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned b = (unsigned)(int)x[i];  // the byte, sign-extended
      dst[2 * i] = (float)((int)(b << 28) >> 28);      // low nibble: element 2i
      dst[2 * i + 1] = (float)((int)(b << 24) >> 28);  // high nibble: element 2i+1
    }
  }
}

template <typename T, int FMT, int D, int PS>
__global__ void __launch_bounds__(1024) paged_decode_kernel(
    const T* __restrict__ q,          // [B, H, D]
    const char* __restrict__ pool_k,  // [P, PS, Hk, Row::BYTES]
    const char* __restrict__ pool_v,  // [P, PS, Hk, Row::BYTES]
    const float* __restrict__ scale_k,  // [P, PS, Hk]  (quantized formats)
    const float* __restrict__ scale_v,  // [P, PS, Hk]
    const int* __restrict__ table,    // [B, mpp]
    const int* __restrict__ lens,     // [B]
    T* __restrict__ out,              // [B, H, D]         (one split)
    float* __restrict__ o_part,       // [B, S, Hk, G, D]  (several splits)
    float* __restrict__ m_part,       // [B, S, Hk, G]
    float* __restrict__ l_part,       // [B, S, Hk, G]
    int H, int Hk, int mpp, int pps, int window, float sm_scale) {
  using R = Row<T, FMT, D>;
  constexpr bool QUANT = FMT != FMT_FLOAT;
  constexpr int PARTS = 32 / PS;      // lanes sharing one token's dot
  constexpr int DP = D / PARTS;       // dims of the dot each of them takes
  constexpr int DL = D / 32;          // output dims each lane accumulates

  __shared__ float ks[PS][D + 1];  // +1: lanes of different tokens hit different banks
  __shared__ float vs[PS][D];
  __shared__ float sks[PS], svs[PS];  // the page's scales (quantized formats)

  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int G = blockDim.x >> 5;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = hk * G + g;
  const int t = lane % PS, part = lane / PS;

  const int len = max(lens[b], 0);
  const int n_live = min((len + PS - 1) / PS, mpp);
  const int lo = window > 0 ? len - window : 0;
  int p_begin = s * pps;
  const int p_end = min(p_begin + pps, n_live);
  if (window > 0 && lo > 0) p_begin = max(p_begin, lo / PS);

  float qreg[DP];
  const T* qrow = q + ((size_t)b * H + h) * D + part * DP;
#pragma unroll
  for (int i = 0; i < DP; ++i) qreg[i] = to_f(qrow[i]);

  float m_run = -INFINITY, l_run = 0.f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int p = p_begin; p < p_end; ++p) {
    const int page = table[b * mpp + p];
    __syncthreads();  // every warp is done with the previous page's tiles
    for (int idx = threadIdx.x; idx < PS * R::VECS; idx += blockDim.x) {
      const int row = idx / R::VECS, vec = idx % R::VECS;
      const size_t off = (((size_t)page * PS + row) * Hk + hk) * R::BYTES + vec * 16;
      decode16<T, FMT>(*reinterpret_cast<const uint4*>(pool_k + off), &ks[row][vec * R::ELEMS]);
      decode16<T, FMT>(*reinterpret_cast<const uint4*>(pool_v + off), &vs[row][vec * R::ELEMS]);
    }
    if constexpr (QUANT) {
      if (threadIdx.x < PS) {  // blockDim >= 32 >= PS
        const size_t so = ((size_t)page * PS + threadIdx.x) * Hk + hk;
        sks[threadIdx.x] = scale_k[so];
        svs[threadIdx.x] = scale_v[so];
      }
    }
    __syncthreads();

    float sc = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) sc = fmaf(qreg[i], ks[t][part * DP + i], sc);
#pragma unroll
    for (int off = PS; off < 32; off <<= 1) sc += __shfl_xor_sync(FULL, sc, off);
    sc *= sm_scale;
    if constexpr (QUANT) sc *= sks[t];
    const int col = p * PS + t;
    const bool valid = col < len && (window <= 0 || col >= lo);
    sc = valid ? sc : -INFINITY;

    float mx = sc;
#pragma unroll
    for (int off = 1; off < PS; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const bool seen = m_new > -INFINITY;  // nothing seen yet: keep -inf, no NaN
    const float prob = seen ? expf(sc - m_new) : 0.f;
    const float alpha = seen ? expf(m_run - m_new) : 0.f;
    float psum = prob;
#pragma unroll
    for (int off = 1; off < PS; off <<= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l_run = alpha * l_run + psum;  // l sums the probabilities before V's scale
    float pv = prob;
    if constexpr (QUANT) pv *= svs[t];
    const float pr = to_f(from_f<T>(pv));
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int tt = 0; tt < PS; ++tt) {
      const float pt = __shfl_sync(FULL, pr, tt);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pt, vs[tt][lane * DL + i], acc[i]);
    }
    m_run = m_new;
  }

  if (S == 1) {
    const float l_safe = l_run == 0.f ? 1.f : l_run;
    T* orow = out + ((size_t)b * H + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane * DL + i] = from_f<T>(acc[i] / l_safe);
  } else {
    const size_t row = (((size_t)b * S + s) * Hk + hk) * G + g;
#pragma unroll
    for (int i = 0; i < DL; ++i) o_part[row * D + lane * DL + i] = acc[i];
    if (lane == 0) {
      m_part[row] = m_run;
      l_part[row] = l_run;
    }
  }
}

// Exact merge of the split partials: grid (B, H), one warp per (row, head).
template <typename T, int D>
__global__ void combine_splits_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      T* __restrict__ out, int S) {
  constexpr int DL = D / 32;
  const int b = blockIdx.x, r = blockIdx.y, H = gridDim.y, lane = threadIdx.x;
  float m_star = -INFINITY;
  for (int s = 0; s < S; ++s) m_star = fmaxf(m_star, m_part[((size_t)b * S + s) * H + r]);
  float denom = 0.f, o[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) o[i] = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t row = ((size_t)b * S + s) * H + r;
    const float m = m_part[row];
    const float alpha = m > -INFINITY ? expf(m - m_star) : 0.f;  // empty split: 0
    denom += alpha * l_part[row];
#pragma unroll
    for (int i = 0; i < DL; ++i) o[i] = fmaf(alpha, o_part[row * D + lane * DL + i], o[i]);
  }
  if (denom == 0.f) denom = 1.f;  // all-masked row -> 0, not NaN
  T* orow = out + ((size_t)b * H + r) * D;
#pragma unroll
  for (int i = 0; i < DL; ++i) orow[lane * DL + i] = from_f<T>(o[i] / denom);
}

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const float* scale_k;
  const float* scale_v;
  const int* table;
  const int* lens;
  void* out;
  float* o_part;
  float* m_part;
  float* l_part;
  int batch, heads, kv_heads, mpp, splits, window;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int FMT, int D, int PS>
void launch(const Args& a) {
  const int group = a.heads / a.kv_heads;
  const int pps = (a.mpp + a.splits - 1) / a.splits;
  paged_decode_kernel<T, FMT, D, PS>
      <<<dim3(a.batch, a.kv_heads, a.splits), 32 * group, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const char*>(a.pool_k),
          static_cast<const char*>(a.pool_v), a.scale_k, a.scale_v, a.table, a.lens,
          static_cast<T*>(a.out), a.o_part, a.m_part, a.l_part, a.heads, a.kv_heads, a.mpp, pps,
          a.window, a.sm_scale);
  if (a.splits > 1) {
    combine_splits_kernel<T, D><<<dim3(a.batch, a.heads), 32, 0, a.stream>>>(
        a.o_part, a.m_part, a.l_part, static_cast<T*>(a.out), a.splits);
  }
}

template <typename T, int FMT>
int dispatch(int head_dim, int page_size, const Args& a) {
#define PAGED_CASE(D_, PS_)                      \
  if (head_dim == D_ && page_size == PS_) {      \
    launch<T, FMT, D_, PS_>(a);                  \
    return (int)cudaGetLastError();              \
  }
  PAGED_CASE(64, 16)
  PAGED_CASE(64, 32)
  PAGED_CASE(128, 16)
  PAGED_CASE(128, 32)
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_format(int kv_format, int head_dim, int page_size, const Args& a) {
  switch (kv_format) {
    case FMT_FLOAT: return dispatch<T, FMT_FLOAT>(head_dim, page_size, a);
    case FMT_INT8: return dispatch<T, FMT_INT8>(head_dim, page_size, a);
    case FMT_INT4: return dispatch<T, FMT_INT4>(head_dim, page_size, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_format: 0 float pools (in the query's type), 1 int8, 2 int4-packed;
// the quantized formats need both scale pools, the float one takes none.
extern "C" int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                                   const void* scale_k, const void* scale_v,
                                   const void* table, const void* lens, void* out,
                                   void* o_part, void* m_part, void* l_part, int batch,
                                   int heads, int kv_heads, int head_dim, int page_size,
                                   int mpp, int splits, int window, float sm_scale,
                                   int kv_format, int is_bf16, void* stream) {
  if (heads % kv_heads != 0 || heads / kv_heads > 32 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((kv_format != FMT_FLOAT) != (scale_k != nullptr && scale_v != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, pool_k, pool_v, static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v), static_cast<const int*>(table),
               static_cast<const int*>(lens), out, static_cast<float*>(o_part),
               static_cast<float*>(m_part), static_cast<float*>(l_part), batch, heads,
               kv_heads, mpp, splits, window, sm_scale, static_cast<cudaStream_t>(stream)};
  if (is_bf16) return dispatch_format<__nv_bfloat16>(kv_format, head_dim, page_size, a);
  return dispatch_format<float>(kv_format, head_dim, page_size, a);
}
