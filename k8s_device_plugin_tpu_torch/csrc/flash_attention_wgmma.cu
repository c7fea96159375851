// Causal (or full) flash-attention forward on Hopper's tensor cores
// (sm_90a, bf16), plain C interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/flash_attention.py
// _flash_kernel (launched by _flash_impl) for bf16 inputs; float32 inputs
// run the FMA kernel of csrc/flash_attention.cu, since wgmma has no float32
// operands.  q [b, h, s_q, d], k/v [b, hk, s_kv, d] bf16 with hk dividing
// h (GQA: q head i reads kv head i / (h / hk)) -> out [b, h, s_q, d] bf16
// and the per-row log-sum-exp [b, h, s_q] float32 (-inf, with out 0, for a
// row that sees no column).  d is any multiple of 8 from 8 to 128: the
// kernel is built 64 and 128 wide (D), and any other d runs in the next
// wider build, padded: it zero-fills the columns past d
// (hopper_wgmma.cuh); the full-width builds carry d as a constant.
//
// Bound on the card: operations.  Causal attention does 4 x d flops per
// (row, col) pair over bytes that grow only with s, past Hopper's ~295
// flop/byte from a few hundred tokens on, so the products belong on the
// tensor cores.  The design (hopper_wgmma.cuh has the building blocks):
//   - grid (b*h, q tile), D / 64 warpgroups (128 threads each) per 64-row
//     q tile; the q tiles are handed out last first, so the long causal
//     rows start early and the short ones fill the tail;
//   - S = Q.K^T is D / 16 m64n64k16 wgmma with Q and K K-major in shared
//     memory, computed whole by every warpgroup; O += P.V is four more per
//     warpgroup with P from registers and V MN-major (transpose bit), each
//     warpgroup owning 64 columns of O (one slab of V), so a thread keeps
//     32 accumulators at either width; all bf16 operands and float32
//     accumulators;
//   - the online softmax runs in the accumulator's registers: a thread owns
//     two rows of the tile, and a row's max finishes with two shuffles over
//     its quad; the row sums stay per thread until the end.  P is rounded
//     to bf16 only as the A fragment of P.V (the reference's cast of p to
//     v's type), and the sum takes P before rounding, as the reference;
//   - K/V tiles of 64 columns stream through a two-stage ring of 128-byte-
//     swizzled shared tiles filled by cp.async: tile i + 1 is in flight
//     while tile i multiplies;
//   - the kv loop runs from the sliding window's first live tile to the
//     causal diagonal, so dead tiles cost nothing; only tiles that cross
//     the diagonal, the window's edge or the end of s_kv take a mask;
//   - any length: q rows past s_q and kv rows past s_kv load as zeros (no
//     NaN can enter a product), the latter masked to -inf, and rows past
//     s_q write nothing.
// Exponentials are exp2 of scores pre-scaled by sm_scale * log2(e).
// Built for sm_90a, ptxas reports registers and spills per build in the
// build log (`-Xptxas=-v`; chip_smoke.py phase 2 checks there is no
// spill); at D = 64 `cuobjdump -sass` shows 8 HGMMA, 4 for S and 4 for P.V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BQ = 64;     // q rows per block (one m64 tile)
constexpr int BK = 64;     // kv columns per streamed tile
constexpr int STAGES = 2;  // K/V ring depth

// Threads a block (a warpgroup per 64 columns of head_dim) and shared
// bytes: the Q tile, then STAGES x (K tile, V tile), each D / 64 slabs,
// plus slack to align the base to a swizzle atom.
template <int D> __host__ __device__ constexpr int threads() { return 128 * (D / 64); }
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return TILE64_BYTES * (D / 64) * (1 + 2 * STAGES) + SWIZZLE_ATOM_BYTES;
}

__device__ __forceinline__ bool live(int row, int col, int seq_kv, int causal, int window) {
  return col < seq_kv && (!causal || (row >= col && (window <= 0 || row - col < window)));
}

// Registers cap the blocks an SM holds: the full-width builds are held to
// 128 a thread (no spill), four blocks of 128 threads at D = 64 and two of
// 256 at D = 128; the padded build would spill under that cap.
template <int D, bool PAD>
__global__ void __launch_bounds__(128 * (D / 64), PAD ? 1 : 256 / D)
    flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int heads, int kv_heads, int seq_q,
    int seq_kv, int d_arg, int causal, int window, float scale_log2) {
  constexpr int SLABS = D / 64, THREADS = threads<D>();
  constexpr int TILE = TILE64_BYTES * SLABS;  // one 64-row tile, every slab
  static_assert(BQ == 64 && BK == 64, "one m64n64 tile per product and slab");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = aligned_smem_base(smem_raw);
  const auto s_k = [&](int st) { return s_q + TILE * (1 + 2 * st); };
  const auto s_v = [&](int st) { return s_q + TILE * (2 + 2 * st); };

  // The real head_dim: a constant of the build unless it pads (a head_dim
  // below the build's width), so the full-width paths carry no column
  // checks.
  const int d = PAD ? d_arg : D;
  const int tid = threadIdx.x;
  // Thread in its warpgroup, and the warpgroup (always 0 at D = 64).
  const int wt = SLABS == 1 ? tid : tid & 127, wg = SLABS == 1 ? 0 : tid >> 7;
  const int bh = blockIdx.x, qi = gridDim.y - 1 - blockIdx.y;
  const int group = heads / kv_heads;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  const int q0 = qi * BQ;
  const bf16* kbase = k + (size_t)kvh * seq_kv * d;
  const bf16* vbase = v + (size_t)kvh * seq_kv * d;

  const int n_kv = (seq_kv + BK - 1) / BK;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (q0 + BQ - 1) / BK + 1);
    if (window > 0) kv_lo = max(q0 - (window - 1), 0) / BK;
  }
  const int n = kv_hi - kv_lo;  // live kv tiles (none: every row is masked)

  const auto load_kv = [&](int ki, int st) {
    load_tile_sw128<BK, D, THREADS>(s_k(st), kbase + (size_t)ki * BK * d, seq_kv - ki * BK, d,
                                    tid);
    load_tile_sw128<BK, D, THREADS>(s_v(st), vbase + (size_t)ki * BK * d, seq_kv - ki * BK, d,
                                    tid);
  };
  load_tile_sw128<BQ, D, THREADS>(s_q, q + ((size_t)bh * seq_q + q0) * d, seq_q - q0, d, tid);
  if (n > 0) load_kv(kv_lo, 0);
  cp_async_commit();

  float o[32];  // this warpgroup's 64 columns of O
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // Running max (log2 domain) of this thread's two rows, and their partial
  // sums over this thread's columns.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n; ++t) {
    const int ki = kv_lo + t, st = t % STAGES;
    if (t + 1 < n) load_kv(ki + 1, (t + 1) % STAGES);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // everything but the newest group has landed
    fence_async_proxy();
    __syncthreads();

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(s, desc_k_major(s_q + sl * TILE64_BYTES, kk),
                 desc_k_major(s_k(st) + sl * TILE64_BYTES, kk), sl + kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int col0 = ki * BK;
    const bool masked = col0 + BK > seq_kv ||
                        (causal && (col0 + BK - 1 > q0 ||
                                    (window > 0 && q0 + BQ - 1 - col0 >= window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (masked && !live(q0 + acc_row(wt, i), col0 + acc_col(wt, i), seq_kv, causal, window)) {
        x = -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      // A row that has seen nothing keeps m = -inf; its p and alpha are 0
      // (exp2(-inf - -inf) would be NaN).
      const bool seen = m_new > -INFINITY;
      alpha[r] = seen ? exp2f(m_run[r] - m_new) : 0.f;
      m_use[r] = seen ? m_new : 0.f;
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(s[i] - m_use[r]);  // exp2(-inf) = 0 for masked columns
      s[i] = p;
      psum[r] += p;
      o[i] *= alpha[r];
    }
    l_run[0] = alpha[0] * l_run[0] + psum[0];
    l_run[1] = alpha[1] * l_run[1] + psum[1];

    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_frag(s, kk, a[kk]);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs(o, a[kk], desc_mn_major(s_v(st) + wg * TILE64_BYTES, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // the stage is free for the copy two tiles on
  }
  cp_async_wait<0>();

  const float ln2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(wt, 2 * r);
    const float l = quad_sum(l_run[r]);
    if (row >= seq_q) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a fully masked row writes 0
    bf16* orow = out + ((size_t)bh * seq_q + row) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * r;
      const int col = wg * 64 + acc_col(wt, i);  // even; d is a multiple of 8
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
    }
    if (wg == 0 && (wt & 3) == 0) {
      lse[(size_t)bh * seq_q + row] = l > 0.f ? m_run[r] * ln2 + logf(l) : -INFINITY;
    }
  }
}

template <int D, bool PAD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
           int heads, int kv_heads, int seq_q, int seq_kv, int d, int causal, int window,
           float sm_scale, cudaStream_t stream) {
  const auto kernel = flash_fwd_wgmma_kernel<D, PAD>;
  if (smem_bytes<D>() > 48 * 1024) {
    // Above 48 KB a block's shared memory must be asked for, on the
    // current device: set on every launch, as the backward kernels do.
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (attr != cudaSuccess) return (int)attr;
  }
  const dim3 grid(batch * heads, (seq_q + BQ - 1) / BQ);
  kernel<<<grid, threads<D>(), smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), heads, kv_heads, seq_q, seq_kv, d,
      causal, window, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim a multiple of 8 from 8 to 128 (the padded builds take all but 64
// and 128).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int batch, int heads, int kv_heads,
                                         int seq_q, int seq_kv, int head_dim, int causal,
                                         int window, float sm_scale, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // Any multiple of 8 from 8 to 128: 64 and 128 run their own builds,
  // the rest the next wider one, zero-filled past the real head_dim.
  if (head_dim < 8 || head_dim > 128 || head_dim % 8) return (int)cudaErrorInvalidValue;
#define BUILD(D_, PAD_) \
  launch<D_, PAD_>(q, k, v, out, lse, batch, heads, kv_heads, seq_q, seq_kv, head_dim, causal, window, \
      sm_scale, s)
  if (head_dim == 64) return BUILD(64, false);
  if (head_dim == 128) return BUILD(128, false);
  return head_dim < 64 ? BUILD(64, true) : BUILD(128, true);
#undef BUILD
}
