// Flash-attention dQ on Hopper's tensor cores (sm_90a, bf16), plain C
// interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/flash_attention.py
// _dq_kernel (launched by _flash_bwd_pallas) for bf16 inputs; float32
// inputs run the FMA kernel of csrc/flash_attention_bwd.cu, since wgmma has
// no float32 operands.  Inputs: q, out, dout [b, h, s_q, d]; k, v [b, hk,
// s_kv, d] bf16 with hk dividing h (GQA: q head i reads kv head i / (h /
// hk)); lse [b, h, s_q] float32 from the forward.  d is any multiple of 8
// from 8 to 128, in kernels built 64 and 128 wide (D) as the forward's.  Outputs dq bf16 and
// D = rowsum(dO o O) [b, h, s_q] float32, which the dK/dV kernel
// (csrc/flash_attention_bwd_wgmma.cu) reads after this one on the same
// stream.  Per q tile:
//   D   = rowsum(dO o O)            (once, float32)
//   S   = Q K^T                     P = exp(S scale - lse)  (0 where masked
//   dP  = dO V^T                                            or lse = -inf)
//   dS  = P o (dP - D) scale        (rounded to bf16, as the reference's
//                                    .astype(q.dtype))
//   dQ += dS K
// with every product accumulated in float32.
//
// Bound on the card: operations, 6 x d flops per causal (row, col) pair.
// The design mirrors the dK/dV kernel, untransposed (hopper_wgmma.cuh has
// the building blocks):
//   - grid (b*h, q tile), D / 64 warpgroups (128 threads each) per 64-row
//     q tile, the tiles handed out last first: the longest causal rows
//     start first and the diagonal's short ones fill the tail.  Every
//     warpgroup computes S and dP whole and owns 64 columns of dQ (one
//     slab of K), so a thread keeps the same registers at either width;
//   - Q and dO are loaded once into 128-byte-swizzled shared tiles, the A
//     operands (K-major) of S and dP; K and V are their B operands
//     (K-major);
//   - dQ += dS K takes dS from registers (the accumulator layout is already
//     the A fragment, so dS never goes to shared memory) and the same K
//     tile as the B operand read MN-major (transpose bit), the trick the
//     dK/dV kernel plays with Q;
//   - dQ stays float32 in registers across the whole loop (32 per thread);
//   - D is computed in the prologue while the first copies fly: the four
//     lanes of a quad own the same two accumulator rows, so each reads a
//     quarter of those rows of dO and O from global memory and a quad sum
//     gives D in the row layout of the accumulators, with no shared slab;
//     the lane of quad position 0 writes it out;
//   - K and V stream through a two-stage cp.async ring: tile i + 1 is in
//     flight while tile i multiplies;
//   - the loop visits live kv tiles only (the window's first to the
//     diagonal); only the diagonal tile, the window's edge tile and a
//     ragged last kv tile take a mask;
//   - any length: q rows past s_q and kv rows past s_kv load as zeros; the
//     former count as lse = -inf (P = 0) and write neither dq nor D.
// Shared memory: Q + dO + 2 x (K + V) = 48 KB at D = 64 (96 KB at 128)
// plus the alignment slack, so the launch asks for it with
// cudaFuncSetAttribute.
// Exponentials are exp2 of scores pre-scaled by sm_scale * log2(e), against
// lse * log2(e).
// Built for sm_90a, cuobjdump -sass shows 12 HGMMA at D = 64 (4 k16 steps
// each for S, dP and dQ); registers and spills are in the build log
// (-Xptxas=-v).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BQ = 64;     // q rows per block (one m64 tile)
constexpr int BKV = 64;    // kv rows per streamed tile
constexpr int STAGES = 2;  // K/V ring depth

// Threads a block (a warpgroup per 64 columns of head_dim) and shared
// bytes: the Q and dO tiles, then STAGES x (K tile, V tile), each D / 64
// slabs, plus slack to align the base to a swizzle atom.
template <int D> __host__ __device__ constexpr int threads() { return 128 * (D / 64); }
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return TILE64_BYTES * (D / 64) * (2 + 2 * STAGES) + SWIZZLE_ATOM_BYTES;
}

// Dot product of two 16-byte vectors of 8 bf16 values, in float32.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(x[e]), w = __bfloat1622float2(y[e]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

template <int D, bool PAD>
__global__ void __launch_bounds__(128 * (D / 64), 1) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ out, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int heads, int kv_heads, int seq_q,
    int seq_kv, int d_arg, int causal, int window, float sm_scale, float scale_log2) {
  constexpr int SLABS = D / 64, THREADS = threads<D>();
  constexpr int TILE = TILE64_BYTES * SLABS;  // one 64-row tile, every slab
  static_assert(BQ == 64 && BKV == 64, "one m64n64 tile per product and slab");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = aligned_smem_base(smem_raw);
  const uint32_t s_do = s_q + TILE;
  const auto s_k = [&](int st) { return s_q + TILE * (2 + 2 * st); };
  const auto s_v = [&](int st) { return s_q + TILE * (3 + 2 * st); };

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
  const size_t row0 = (size_t)bh * seq_q + q0;
  const bf16* kbase = k + (size_t)kvh * seq_kv * d;
  const bf16* vbase = v + (size_t)kvh * seq_kv * d;

  const int n_kv = (seq_kv + BKV - 1) / BKV;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (q0 + BQ - 1) / BKV + 1);
    if (window > 0) kv_lo = max(q0 - (window - 1), 0) / BKV;
  }
  const int n = max(kv_hi - kv_lo, 0);  // live kv tiles (none: every row is masked)

  const auto load_kv = [&](int ki, int st) {
    load_tile_sw128<BKV, D, THREADS>(s_k(st), kbase + (size_t)ki * BKV * d, seq_kv - ki * BKV,
                                     d, tid);
    load_tile_sw128<BKV, D, THREADS>(s_v(st), vbase + (size_t)ki * BKV * d, seq_kv - ki * BKV,
                                     d, tid);
  };
  load_tile_sw128<BQ, D, THREADS>(s_q, q + row0 * d, seq_q - q0, d, tid);
  load_tile_sw128<BQ, D, THREADS>(s_do, dout + row0 * d, seq_q - q0, d, tid);
  if (n > 0) load_kv(kv_lo, 0);
  cp_async_commit();

  // D and lse (times log2(e)) of this thread's two accumulator rows, while
  // the copies fly.  Lane c of a quad reads 16-byte chunks c, c + 4, ...
  // of each row, up to the real head_dim.  A row past s_q has D = 0 and no
  // P.
  const float log2e = 1.4426950408889634f;
  float d_row[2], lse2[2];
  bool seen[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(wt, 2 * r);
    const bool ok = row < seq_q;
    const size_t off = ((size_t)bh * seq_q + row) * d;
    float part = 0.f;
    if (ok) {
#pragma unroll
      for (int h = 0; h < D / 32; ++h) {
        const int c = ((wt & 3) + 4 * h) * 8;
        if (c < d) {
          part += dot8(*reinterpret_cast<const uint4*>(dout + off + c),
                       *reinterpret_cast<const uint4*>(out + off + c));
        }
      }
    }
    d_row[r] = quad_sum(part);
    const float l = ok ? lse[(size_t)bh * seq_q + row] : -INFINITY;
    seen[r] = l > -INFINITY;  // a row that saw nothing has P = 0
    lse2[r] = seen[r] ? l * log2e : 0.f;
    if (ok && wg == 0 && (wt & 3) == 0) delta[(size_t)bh * seq_q + row] = d_row[r];
  }

  float dq_acc[32];  // this warpgroup's 64 columns of dQ
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int ki = kv_lo + t, st = t % STAGES;
    if (t + 1 < n) load_kv(ki + 1, (t + 1) % STAGES);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // everything but the newest group has landed
    fence_async_proxy();
    __syncthreads();

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(s, desc_k_major(s_q + sl * TILE64_BYTES, kk),
                 desc_k_major(s_k(st) + sl * TILE64_BYTES, kk), sl + kk);
      }
    }
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(dp, desc_k_major(s_do + sl * TILE64_BYTES, kk),
                 desc_k_major(s_v(st) + sl * TILE64_BYTES, kk), sl + kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // Masks: the tile crosses the diagonal, reaches past the window, or
    // holds columns past s_kv (zero-filled).
    const int col0 = ki * BKV;
    const bool masked = col0 + BKV > seq_kv ||
                        (causal && (col0 + BKV - 1 > q0 ||
                                    (window > 0 && q0 + BQ - 1 - col0 >= window)));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      bool ok = seen[r];
      if (masked) {
        const int row = q0 + acc_row(wt, i), col = col0 + acc_col(wt, i);
        ok = ok && col < seq_kv &&
             (!causal || (row >= col && (window <= 0 || row - col < window)));
      }
      const float p = ok ? exp2f(s[i] * scale_log2 - lse2[r]) : 0.f;
      s[i] = p * (dp[i] - d_row[r]) * sm_scale;  // dS; a_frag rounds it to bf16
    }

    uint32_t da[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) a_frag(s, kk, da[kk]);
    wgmma_fence();
    fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wgmma_rs(dq_acc, da[kk], desc_mn_major(s_k(st) + wg * TILE64_BYTES, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    __syncthreads();  // the stage is free for the copy two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(wt, 2 * r);
    if (row >= seq_q) continue;
    bf16* dqrow = dq + ((size_t)bh * seq_q + row) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * r;
      const int col = wg * 64 + acc_col(wt, i);  // even; d is a multiple of 8
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dqrow + col) =
            __floats2bfloat162_rn(dq_acc[i], dq_acc[i + 1]);
      }
    }
  }
}

template <int D, bool PAD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* dq, void* delta, int batch, int heads, int kv_heads,
           int seq_q, int seq_kv, int d, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  const auto kernel = flash_bwd_dq_wgmma_kernel<D, PAD>;
  // Above 48 KB a block's shared memory must be asked for, on the current
  // device: set on every launch, as the dK/dV kernel does.
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(batch * heads, (seq_q + BQ - 1) / BQ);
  kernel<<<grid, threads<D>(), smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta),
      heads, kv_heads, seq_q, seq_kv, d, causal, window, sm_scale,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dQ and the per-row D = rowsum(dO o O) (written to `delta`, [b, h, s_q]
// float32, for flash_attention_bwd_dkv_wgmma); head_dim a multiple of 8 from
// 8 to 128.
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const void* lse,
                                            void* dq, void* delta, int batch, int heads,
                                            int kv_heads, int seq_q, int seq_kv, int head_dim,
                                            int causal, int window, float sm_scale,
                                            void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // Any multiple of 8 from 8 to 128: 64 and 128 run their own builds,
  // the rest the next wider one, zero-filled past the real head_dim.
  if (head_dim < 8 || head_dim > 128 || head_dim % 8) return (int)cudaErrorInvalidValue;
#define BUILD(D_, PAD_) \
  launch<D_, PAD_>(q, k, v, out, dout, lse, dq, delta, batch, heads, kv_heads, seq_q, seq_kv, head_dim, \
      causal, window, sm_scale, s)
  if (head_dim == 64) return BUILD(64, false);
  if (head_dim == 128) return BUILD(128, false);
  return head_dim < 64 ? BUILD(64, true) : BUILD(128, true);
#undef BUILD
}
