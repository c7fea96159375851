// Causal (or full) flash-attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/flash_attention.py
// _flash_kernel (launched by _flash_impl).  q [b, h, s_q, d], k/v
// [b, hk, s_kv, d] with hk dividing h (GQA: q head i reads kv head
// i / (h / hk), as the TPU kernel's kv_index map does) -> out
// [b, h, s_q, d] in q's type and the per-row log-sum-exp [b, h, s_q] f32
// (the TPU's 128-lane replication of lse is a TPU register artefact and is
// gone).
//
// Bound on the card: operations once the sequence is long.  Causal
// attention does 2 x b x h x s^2 x d flops over 4 x b x h x s x d x 2
// bytes, which passes Hopper's ~295 flop/byte from a few hundred tokens on.
// This first kernel is plain and right rather than fast: float FMA on the
// CUDA cores, no tensor cores (wgmma/TMA are for a later PR).  What it does
// about its bound:
//   - grid (b*h, q tile): one 64-row q tile per block, one thread per query
//     row holding its q row and its f32 accumulator in registers;
//   - any sequence length: the last q tile's rows past s_q compute on a
//     copy of the last real row and write nothing, and the last kv tile's
//     columns past s_kv load as zeros and score -inf (a separate
//     instantiation, so full tiles carry no guards), so no length falls
//     back to a plain path;
//   - a loop over 64-column kv tiles takes the place of the TPU's
//     sequential kv grid axis: it starts at the sliding window's first live
//     tile and stops at the causal diagonal (_tile_live's band), so dead
//     tiles cost nothing at all instead of one predicate each;
//   - each K/V tile is staged once in shared memory as f32 and read by all
//     64 threads as broadcasts (every thread reads the same column), four
//     floats per load;
//   - online softmax per 16-column chunk, exact: a row that has seen
//     nothing keeps m = -inf and contributes 0, never NaN.
// Scores, softmax state and accumulators are float32; probabilities are
// rounded to v's type before p.v, as the reference casts them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The Python wrapper's CUDA_TILE names the same two sizes.
constexpr int BQ = 64;     // q rows per block (= threads per block)
constexpr int BK = 64;     // kv columns per tile
constexpr int CHUNK = 16;  // columns per online-softmax update

// One kv tile into the row's online-softmax state.  RAGGED is the last tile
// of a sequence that BK does not divide: its rows past seq_kv load as zeros
// and score -inf.  Full tiles compile without those guards.
template <typename T, int D, bool RAGGED>
__device__ __forceinline__ void kv_tile(const T* __restrict__ kbase,
                                        const T* __restrict__ vbase, int ki, int seq_kv,
                                        int row, int causal, int window, float sm_scale,
                                        const float (&qreg)[D], float (&acc)[D], float& m_run,
                                        float& l_run, float (*ks)[D], float (*vs)[D]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROW_VECS = D / VEC;
  __syncthreads();  // every thread is done with the previous tile
  for (int idx = threadIdx.x; idx < BK * ROW_VECS; idx += BQ) {
    const int r = idx / ROW_VECS, c = (idx % ROW_VECS) * VEC;
    const size_t off = ((size_t)ki * BK + r) * D + c;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
    if (!RAGGED || ki * BK + r < seq_kv) {
      kraw = *reinterpret_cast<const uint4*>(kbase + off);
      vraw = *reinterpret_cast<const uint4*>(vbase + off);
    }
    const T* ke = reinterpret_cast<const T*>(&kraw);
    const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ks[r][c + i] = to_f(ke[i]);
      vs[r][c + i] = to_f(ve[i]);
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < BK; c0 += CHUNK) {
    float sc[CHUNK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[c0 + j][0]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qreg[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qreg[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qreg[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qreg[4 * d4 + 3], kk.w, dot);
      }
      float s = dot * sm_scale;
      const int col = ki * BK + c0 + j;
      if (causal) {
        const bool ok = row >= col && (window <= 0 || row - col < window);
        s = ok ? s : -INFINITY;
      }
      if (RAGGED && col >= seq_kv) s = -INFINITY;
      sc[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m_run, mx);
    const bool seen = m_new > -INFINITY;
    const float alpha = seen ? expf(m_run - m_new) : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float p = seen ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      const float pr = to_f(from_f<T>(p));
      const float4* vr = reinterpret_cast<const float4*>(&vs[c0 + j][0]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(pr, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(pr, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pr, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pr, vv.w, acc[4 * d4 + 3]);
      }
    }
    l_run = alpha * l_run + psum;
    m_run = m_new;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int heads, int kv_heads, int seq_q,
    int seq_kv, int causal, int window, float sm_scale) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int group = heads / kv_heads;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  const int row = qi * BQ + threadIdx.x;

  float qreg[D];
  {
    // A row past seq_q in the last q tile reads the last real row (finite
    // values, no branch) and writes nothing.
    const T* qrow = q + ((size_t)bh * seq_q + min(row, seq_q - 1)) * D;
#pragma unroll
    for (int c = 0; c < D; c += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qrow + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) qreg[c + i] = to_f(e[i]);
    }
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  const int n_full = seq_kv / BK;
  const int n_kv = (seq_kv + BK - 1) / BK;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (qi * BQ + BQ - 1) / BK + 1);
    if (window > 0) kv_lo = max(qi * BQ - (window - 1), 0) / BK;
  }
  const T* kbase = k + (size_t)kvh * seq_kv * D;
  const T* vbase = v + (size_t)kvh * seq_kv * D;

  for (int ki = kv_lo; ki < min(kv_hi, n_full); ++ki) {
    kv_tile<T, D, false>(kbase, vbase, ki, seq_kv, row, causal, window, sm_scale, qreg, acc,
                         m_run, l_run, ks, vs);
  }
  if (kv_lo <= n_full && n_full < kv_hi) {  // the ragged last tile is live
    kv_tile<T, D, true>(kbase, vbase, n_full, seq_kv, row, causal, window, sm_scale, qreg,
                        acc, m_run, l_run, ks, vs);
  }

  if (row >= seq_q) return;
  const float l_safe = l_run == 0.f ? 1.f : l_run;  // fully masked row -> 0
  T* orow = out + ((size_t)bh * seq_q + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d] / l_safe);
  lse[(size_t)bh * seq_q + row] = l_run > 0.f ? m_run + logf(l_safe) : -INFINITY;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
           int heads, int kv_heads, int seq_q, int seq_kv, int head_dim, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch * heads, (seq_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, 64><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, heads, kv_heads, seq_q, seq_kv, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int batch, int heads, int kv_heads, int seq_q,
                                   int seq_kv, int head_dim, int causal, int window,
                                   float sm_scale, int is_bf16, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, out, l, batch, heads, kv_heads, seq_q, seq_kv,
                                 head_dim, causal, window, sm_scale, st);
  }
  return launch<float>(q, k, v, out, l, batch, heads, kv_heads, seq_q, seq_kv, head_dim,
                       causal, window, sm_scale, st);
}
