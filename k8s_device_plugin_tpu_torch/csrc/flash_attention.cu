// Causal (or full) flash-attention forward for float32 inputs on Hopper
// (sm_90a), on the CUDA cores, plain C interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/flash_attention.py
// _flash_kernel (launched by _flash_impl) for float32 inputs.  bf16 inputs
// run the tensor-core kernel of csrc/flash_attention_wgmma.cu: wgmma has no
// float32 operands, and TF32 would keep about three decimal digits, far
// from the float32 tolerances (2e-5 here, 1e-5 for a train step), so
// float32 keeps this kernel by design.  q [b, h, s_q, d], k/v
// [b, hk, s_kv, d] with hk dividing h (GQA: q head i reads kv head
// i / (h / hk), as the TPU kernel's kv_index map does) -> out
// [b, h, s_q, d] and the per-row log-sum-exp [b, h, s_q] f32 (the TPU's
// 128-lane replication of lse is a TPU register artefact and is gone).
//
// Bound on the card: operations once the sequence is long.  Causal
// attention does 2 x b x h x s^2 x d flops over 4 x b x h x s x d x 4
// bytes, which passes the card's float32 rate over bandwidth from a few
// hundred tokens on.  Float FMA on the CUDA cores; what the design does
// about its bound:
//   - grid (b*h, q tile): one 64-row q tile per block, one thread per query
//     row holding its q row and its f32 accumulator in registers;
//   - any sequence length: the last q tile's rows past s_q compute on a
//     copy of the last real row and write nothing, and the last kv tile's
//     columns past s_kv load as zeros and score -inf (a separate
//     instantiation, so full tiles carry no guards), so no length falls
//     back to a plain path;
//   - head_dim d is a template parameter (16, 32, 64 or 128), so q and the
//     accumulator stay in registers at every width; any other multiple of
//     8 runs in the 64- or 128-wide build, padded: its rows load as zeros
//     past d and only the real columns are written; at 128 the kv tile is
//     32 columns, so that K and V stay within 48 KB of static shared
//     memory (the registers of q and acc then spill to local memory: ptxas
//     reports it in the build log);
//   - a loop over kv tiles (64 columns, 32 at d 128) takes the place of the TPU's
//     sequential kv grid axis: it starts at the sliding window's first live
//     tile and stops at the causal diagonal (_tile_live's band), so dead
//     tiles cost nothing at all instead of one predicate each;
//   - each K/V tile is staged once in shared memory and read by all 64
//     threads as broadcasts (every thread reads the same column), four
//     floats per load;
//   - online softmax per 16-column chunk, exact: a row that has seen
//     nothing keeps m = -inf and contributes 0, never NaN;
//   - any head_dim d above 128 (d a multiple of 8; the wrapper pads any
//     other head_dim to one, and the builds take the rest) runs the wide
//     kernel below: a block per (b*h, q tile, 64-column slab of the
//     output), scores over the whole head_dim in 32-value pieces of Q and
//     K staged in shared memory, so its registers do not grow with d.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The Python wrapper's CUDA_TILE names the q tile and the kv tile below
// head_dim 128.
constexpr int BQ = 64;     // q rows per block (= threads per block)
constexpr int CHUNK = 16;  // columns per online-softmax update

// kv columns per tile: K and V tiles fit 48 KB of static shared memory.
template <int D> __host__ __device__ constexpr int kv_tile_cols() { return D > 64 ? 32 : 64; }

// One kv tile into the row's online-softmax state.  RAGGED is the last tile
// of a sequence that BK does not divide: its rows past seq_kv load as zeros
// and score -inf.  Full tiles compile without those guards.
template <int D, bool RAGGED, int BK = kv_tile_cols<D>()>
__device__ __forceinline__ void kv_tile(const float* __restrict__ kbase,
                                        const float* __restrict__ vbase, int d, int ki, int seq_kv,
                                        int row, int causal, int window, float sm_scale,
                                        const float (&qreg)[D], float (&acc)[D], float& m_run,
                                        float& l_run, float (*ks)[D], float (*vs)[D]) {
  constexpr int ROW_VECS = D / 4;
  __syncthreads();  // every thread is done with the previous tile
  for (int idx = threadIdx.x; idx < BK * ROW_VECS; idx += BQ) {
    const int r = idx / ROW_VECS, c = (idx % ROW_VECS) * 4;
    const size_t off = ((size_t)ki * BK + r) * d + c;
    float4 kraw = make_float4(0.f, 0.f, 0.f, 0.f), vraw = kraw;
    if ((!RAGGED || ki * BK + r < seq_kv) && c < d) {
      kraw = *reinterpret_cast<const float4*>(kbase + off);
      vraw = *reinterpret_cast<const float4*>(vbase + off);
    }
    *reinterpret_cast<float4*>(&ks[r][c]) = kraw;
    *reinterpret_cast<float4*>(&vs[r][c]) = vraw;
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
    for (int e = 0; e < D; ++e) acc[e] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float p = seen ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(&vs[c0 + j][0]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    l_run = alpha * l_run + psum;
    m_run = m_new;
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int heads, int kv_heads, int seq_q,
    int seq_kv, int d_arg, int causal, int window, float sm_scale) {
  constexpr int BK = kv_tile_cols<D>();
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int group = heads / kv_heads;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  const int row = qi * BQ + threadIdx.x;
  // The real head_dim: a constant of the build unless it pads.
  const int d = PAD ? d_arg : D;

  float qreg[D];
  {
    // A row past seq_q in the last q tile reads the last real row (finite
    // values, no branch) and writes nothing.
    const float* qrow = q + ((size_t)bh * seq_q + min(row, seq_q - 1)) * d;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 x =
          c < d ? *reinterpret_cast<const float4*>(qrow + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      qreg[c] = x.x, qreg[c + 1] = x.y, qreg[c + 2] = x.z, qreg[c + 3] = x.w;
    }
  }
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  const int n_full = seq_kv / BK;
  const int n_kv = (seq_kv + BK - 1) / BK;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (qi * BQ + BQ - 1) / BK + 1);
    if (window > 0) kv_lo = max(qi * BQ - (window - 1), 0) / BK;
  }
  const float* kbase = k + (size_t)kvh * seq_kv * d;
  const float* vbase = v + (size_t)kvh * seq_kv * d;

  for (int ki = kv_lo; ki < min(kv_hi, n_full); ++ki) {
    kv_tile<D, false>(kbase, vbase, d, ki, seq_kv, row, causal, window, sm_scale, qreg, acc,
                      m_run, l_run, ks, vs);
  }
  if (kv_lo <= n_full && n_full < kv_hi) {  // the ragged last tile is live
    kv_tile<D, true>(kbase, vbase, d, n_full, seq_kv, row, causal, window, sm_scale, qreg, acc,
                     m_run, l_run, ks, vs);
  }

  if (row >= seq_q) return;
  const float l_safe = l_run == 0.f ? 1.f : l_run;  // fully masked row -> 0
  float* orow = out + ((size_t)bh * seq_q + row) * d;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    if (e < d) orow[e] = acc[e] / l_safe;
  }
  lse[(size_t)bh * seq_q + row] = l_run > 0.f ? m_run + logf(l_safe) : -INFINITY;
}

// The wide kernel: any head_dim d (a multiple of 4) above 128.  Grid
// (b*h, q tile, 64-column slab of O), one thread per query row.  For each
// tile of WB kv columns, the scores accumulate over 32-value pieces of the
// head_dim (the q tile's piece, padded against bank conflicts, and the kv
// tile's, both staged in shared memory), then the tile takes one
// online-softmax update and O's slab accumulates P.V over the kv tile's
// slab of V.  Each slab recomputes the scores: the price of taking any
// width.
constexpr int WB = 16;  // kv columns per step
constexpr int WP = 32;  // head_dim values per piece of the scores
constexpr int WS = 64;  // output columns per block

__global__ void __launch_bounds__(BQ) flash_fwd_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int heads, int kv_heads, int seq_q,
    int seq_kv, int d, int causal, int window, float sm_scale) {
  __shared__ float qs[BQ][WP + 1];
  __shared__ float ks[WB][WP];
  __shared__ float vs[WB][WS];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ, col0 = blockIdx.z * WS;
  const int group = heads / kv_heads;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  const int row = q0 + tid;
  const float* qbase = q + ((size_t)bh * seq_q + q0) * d;
  const float* kbase = k + (size_t)kvh * seq_kv * d;
  const float* vbase = v + (size_t)kvh * seq_kv * d;

  float acc[WS];
#pragma unroll
  for (int c = 0; c < WS; ++c) acc[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_kv = (seq_kv + WB - 1) / WB;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (q0 + BQ - 1) / WB + 1);
    if (window > 0) kv_lo = max(q0 - (window - 1), 0) / WB;
  }
  for (int ki = kv_lo; ki < kv_hi; ++ki) {
    const int c0 = ki * WB;
    float sc[WB];
#pragma unroll
    for (int j = 0; j < WB; ++j) sc[j] = 0.f;
    for (int p0 = 0; p0 < d; p0 += WP) {
      __syncthreads();  // every thread is done with the previous piece
      for (int idx = tid; idx < BQ * WP; idx += BQ) {
        const int r = idx / WP, c = idx % WP;
        qs[r][c] = q0 + r < seq_q && p0 + c < d ? qbase[(size_t)r * d + p0 + c] : 0.f;
      }
      for (int idx = tid; idx < WB * WP; idx += BQ) {
        const int r = idx / WP, c = idx % WP;
        ks[r][c] = c0 + r < seq_kv && p0 + c < d ? kbase[(size_t)(c0 + r) * d + p0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < WP; ++e) {
        const float x = qs[tid][e];
#pragma unroll
        for (int j = 0; j < WB; ++j) sc[j] = fmaf(x, ks[j][e], sc[j]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < WB * WS; idx += BQ) {
      const int r = idx / WS, c = idx % WS;
      vs[r][c] = c0 + r < seq_kv && col0 + c < d ? vbase[(size_t)(c0 + r) * d + col0 + c] : 0.f;
    }
    __syncthreads();
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < WB; ++j) {
      const int col = c0 + j;
      const bool ok = col < seq_kv && (!causal || (row >= col && (window <= 0 || row - col < window)));
      sc[j] = ok ? sc[j] * sm_scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m_run, mx);
    const bool seen = m_new > -INFINITY;
    const float alpha = seen ? expf(m_run - m_new) : 0.f;
#pragma unroll
    for (int c = 0; c < WS; ++c) acc[c] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < WB; ++j) {
      const float p = seen ? expf(sc[j] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int c = 0; c < WS; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
    }
    l_run = alpha * l_run + psum;
    m_run = m_new;
  }

  if (row >= seq_q) return;
  const float l_safe = l_run == 0.f ? 1.f : l_run;  // fully masked row -> 0
  float* orow = out + ((size_t)bh * seq_q + row) * d;
#pragma unroll
  for (int c = 0; c < WS; ++c) {
    if (col0 + c < d) orow[col0 + c] = acc[c] / l_safe;
  }
  if (blockIdx.z == 0) lse[(size_t)bh * seq_q + row] = l_run > 0.f ? m_run + logf(l_safe) : -INFINITY;
}

int launch_wide(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                int heads, int kv_heads, int seq_q, int seq_kv, int d, int causal, int window,
                float sm_scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq_q + BQ - 1) / BQ, (d + WS - 1) / WS);
  flash_fwd_wide_kernel<<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), heads, kv_heads, seq_q, seq_kv, d,
      causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, bool PAD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
           int heads, int kv_heads, int seq_q, int seq_kv, int d, int causal, int window,
           float sm_scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq_q + BQ - 1) / BQ);
  flash_fwd_kernel<D, PAD><<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), heads, kv_heads, seq_q, seq_kv, d,
      causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim 64 or 128 in its own instantiation; any other multiple of 8 up
// to 128 in the next wider of the two builds, padded; above 128 the wide
// kernel.
extern "C" int flash_attention_fwd_fma(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int batch, int heads, int kv_heads, int seq_q,
                                       int seq_kv, int head_dim, int causal, int window,
                                       float sm_scale, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0 ||
      head_dim < 8 || head_dim % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
#define BUILD(D_, PAD_)                                                                  \
  launch<D_, PAD_>(q, k, v, out, lse, batch, heads, kv_heads, seq_q, seq_kv, head_dim, causal, \
                   window, sm_scale, s)
  if (head_dim > 128) {
    return launch_wide(q, k, v, out, lse, batch, heads, kv_heads, seq_q, seq_kv, head_dim,
                       causal, window, sm_scale, s);
  }
  switch (head_dim) {
    case 64: return BUILD(64, false);
    case 128: return BUILD(128, false);
    default: return head_dim < 64 ? BUILD(64, true) : BUILD(128, true);
  }
#undef BUILD
}
