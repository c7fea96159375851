// Flash-attention dK/dV on Hopper's tensor cores (sm_90a, bf16), plain C
// interface.
//
// Replaces the TPU kernel k8s_device_plugin_tpu/ops/flash_attention.py
// _dkv_kernel (launched by _flash_bwd_pallas) for bf16 inputs; float32
// inputs run the FMA kernel of csrc/flash_attention_bwd.cu, since wgmma has
// no float32 operands.  Inputs: q, dout [b, h, s_q, d]; k, v [b, hk, s_kv,
// d] bf16 with hk dividing h (GQA: q head i reads kv head i / (h / hk));
// lse [b, h, s_q] float32 from the forward and D = rowsum(dO o O) [b, h,
// s_q] float32 from the bf16 dQ kernel
// (csrc/flash_attention_bwd_dq_wgmma.cu), which runs before this one on the
// same stream.  Outputs dk, dv bf16.  d is any multiple of 8 from 8 to
// 128, in kernels built 64 and 128 wide (D) as the forward's.  Per kv tile, written transposed (kv
// rows, q columns):
//   S^T  = K Q^T                 P^T = exp(S^T scale - lse)  (0 where masked
//   dP^T = V dO^T                                           or lse = -inf)
//   dS^T = P^T o (dP^T - D) scale
//   dV  += P^T dO,  dK += dS^T Q  (P^T and dS^T rounded to bf16)
// with every product accumulated in float32.
//
// Bound on the card: operations, 8 x d flops per causal (row, col) pair.
// The design (hopper_wgmma.cuh has the building blocks):
//   - grid (b*hk, kv tile), D / 64 warpgroups (128 threads each) per
//     64-row kv tile of one kv head; the block loops over every q head of
//     the kv head's group and over the live q tiles, so the group's
//     gradient is summed in registers, deterministically and without
//     atomics.  Every warpgroup computes S^T and dP^T whole and owns 64
//     columns of dK and dV (one slab of Q and of dO), so a thread keeps the
//     same registers at either width;
//   - K and V are loaded once into 128-byte-swizzled shared tiles and are
//     the A operands (K-major) of S^T and dP^T; Q and dO are their B
//     operands (K-major), then the B operands (MN-major, transpose bit) of
//     dK and dV, whose A operands are dS^T and P^T from registers: the
//     transposed accumulator layout is already the A fragment, so neither
//     P nor dS ever goes to shared memory;
//   - dK and dV stay float32 in registers across the whole loop (32 each
//     per thread at m64n64);
//   - Q, dO and the tile's lse and D slices stream through a two-stage
//     ring filled by cp.async: step i + 1 is in flight while step i
//     multiplies;
//   - the loop visits live q tiles only (the diagonal to the window's last
//     q tile); only the diagonal tile, the window's edge tile and a ragged
//     last q tile take a mask;
//   - any length: q rows past s_q and kv rows past s_kv load as zeros, the
//     former masked, and kv rows past s_kv write nothing.
// Exponentials are exp2 of scores pre-scaled by sm_scale * log2(e).
// Built for sm_90a, ptxas reports registers and spills per build in the
// build log (`-Xptxas=-v`; chip_smoke.py phase 2 checks there is no
// spill); at D = 64 `cuobjdump -sass` shows 16 HGMMA, 4 each for S^T, dP^T, dV and dK.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BKV = 64;    // kv rows per block (one m64 tile)
constexpr int BQ = 64;     // q rows per streamed tile
constexpr int STAGES = 2;  // Q/dO/lse/D ring depth
constexpr int ROWSTAT_BYTES = BQ * 4;

// Threads a block (a warpgroup per 64 columns of head_dim); a ring stage:
// the Q tile, the dO tile, then BQ floats each of lse and D, padded to a
// swizzle atom so the next stage's tiles stay aligned; shared bytes: the K
// and V tiles, the ring, and slack to align the base.
template <int D> __host__ __device__ constexpr int threads() { return 128 * (D / 64); }
template <int D> __host__ __device__ constexpr int stage_bytes() {
  return (2 * TILE64_BYTES * (D / 64) + 2 * ROWSTAT_BYTES + SWIZZLE_ATOM_BYTES - 1) /
         SWIZZLE_ATOM_BYTES * SWIZZLE_ATOM_BYTES;
}
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return 2 * TILE64_BYTES * (D / 64) + STAGES * stage_bytes<D>() + SWIZZLE_ATOM_BYTES;
}

// At D = 64 a build is held to three blocks an SM (at most 170 registers a
// thread, no spill).
template <int D, bool PAD>
__global__ void __launch_bounds__(128 * (D / 64), D == 64 ? 3 : 1)
    flash_bwd_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
    int kv_heads, int seq_q, int seq_kv, int d_arg, int causal, int window, float sm_scale,
    float scale_log2) {
  constexpr int SLABS = D / 64, THREADS = threads<D>();
  constexpr int TILE = TILE64_BYTES * SLABS;  // one 64-row tile, every slab
  static_assert(BKV == 64 && BQ == 64, "one m64n64 tile per product and slab");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_k = aligned_smem_base(smem_raw);
  const uint32_t s_v = s_k + TILE;
  const auto s_q = [&](int st) { return s_k + 2 * TILE + stage_bytes<D>() * st; };
  const auto s_do = [&](int st) { return s_q(st) + TILE; };
  const auto s_lse = [&](int st) { return s_q(st) + 2 * TILE; };
  const auto s_delta = [&](int st) { return s_lse(st) + ROWSTAT_BYTES; };
  // Generic pointers to the row statistics, for plain loads.
  const uint8_t* smem_gen = smem_raw + (s_k - smem_u32(smem_raw));

  // The real head_dim: a constant of the build unless it pads (a head_dim
  // below the build's width), so the full-width paths carry no column
  // checks.
  const int d = PAD ? d_arg : D;
  const int tid = threadIdx.x;
  // Thread in its warpgroup, and the warpgroup (always 0 at D = 64).
  const int wt = SLABS == 1 ? tid : tid & 127, wg = SLABS == 1 ? 0 : tid >> 7;
  const int b2 = blockIdx.x, ki = blockIdx.y;
  const int group = heads / kv_heads;
  const int kv0 = ki * BKV;

  const int n_q = (seq_q + BQ - 1) / BQ;
  int q_lo = 0, q_hi = n_q;
  if (causal) {
    q_lo = min(kv0 / BQ, n_q);  // the first q tile whose last row reaches kv0
    if (window > 0) q_hi = min(n_q, (kv0 + BKV - 1 + window - 1) / BQ + 1);
  }
  const int per_head = max(q_hi - q_lo, 0);
  const int n = group * per_head;  // (q head, q tile) steps

  const auto load_step = [&](int t, int st) {
    const int h = (b2 / kv_heads) * heads + (b2 % kv_heads) * group + t / per_head;
    const int q0 = (q_lo + t % per_head) * BQ;
    const size_t row = (size_t)h * seq_q + q0;
    load_tile_sw128<BQ, D, THREADS>(s_q(st), q + row * d, seq_q - q0, d, tid);
    load_tile_sw128<BQ, D, THREADS>(s_do(st), dout + row * d, seq_q - q0, d, tid);
    // lse on threads 0..63, D on 64..127, 4 bytes each.
    if (SLABS == 1 || tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = q0 + r < seq_q;
      const float* src = (tid < BQ ? lse : delta) + row + (ok ? r : 0);
      cp_async4((tid < BQ ? s_lse(st) : s_delta(st)) + 4 * r, src, ok);
    }
  };
  const size_t kv_row = (size_t)b2 * seq_kv + kv0;
  load_tile_sw128<BKV, D, THREADS>(s_k, k + kv_row * d, seq_kv - kv0, d, tid);
  load_tile_sw128<BKV, D, THREADS>(s_v, v + kv_row * d, seq_kv - kv0, d, tid);
  if (n > 0) load_step(0, 0);
  cp_async_commit();

  float dk_acc[32], dv_acc[32];  // this warpgroup's 64 columns of dK and dV
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float log2e = 1.4426950408889634f;

  for (int t = 0; t < n; ++t) {
    const int st = t % STAGES;
    const int q0 = (q_lo + t % per_head) * BQ;
    if (t + 1 < n) load_step(t + 1, (t + 1) % STAGES);
    cp_async_commit();  // an empty group on the last step keeps the count
    cp_async_wait<1>();  // everything but the newest group has landed
    fence_async_proxy();
    __syncthreads();

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(s, desc_k_major(s_k + sl * TILE64_BYTES, kk),
                 desc_k_major(s_q(st) + sl * TILE64_BYTES, kk), sl + kk);
      }
    }
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(dp, desc_k_major(s_v + sl * TILE64_BYTES, kk),
                 desc_k_major(s_do(st) + sl * TILE64_BYTES, kk), sl + kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // Masks: the tile crosses the diagonal, reaches past the window, or
    // holds rows past s_q (zero-filled: their lse and D read 0).
    const bool masked = q0 + BQ > seq_q ||
                        (causal && (q0 < kv0 + BKV - 1 ||
                                    (window > 0 && q0 + BQ - 1 - kv0 >= window)));
    const float* lse_s = reinterpret_cast<const float*>(smem_gen + (s_lse(st) - s_k));
    const float* delta_s = reinterpret_cast<const float*>(smem_gen + (s_delta(st) - s_k));
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      // This thread's two q columns of 8-column block j.
      const int c = acc_col(wt, 4 * j);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        bool ok = l > -INFINITY;  // a row that saw nothing has P = 0
        if (masked) {
          const int row = q0 + c + (e & 1), col = kv0 + acc_row(wt, i);
          ok = ok && row < seq_q &&
               (!causal || (row >= col && (window <= 0 || row - col < window)));
        }
        const float p = ok ? exp2f(s[i] * scale_log2 - l * log2e) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - dl) * sm_scale;
      }
    }

    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_frag(s, kk, pa[kk]);
      a_frag(dp, kk, da[kk]);
    }
    wgmma_fence();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs(dv_acc, pa[kk], desc_mn_major(s_do(st) + wg * TILE64_BYTES, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs(dk_acc, da[kk], desc_mn_major(s_q(st) + wg * TILE64_BYTES, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // the stage is free for the copy two steps on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + acc_row(wt, 2 * r);
    if (row >= seq_kv) continue;
    const size_t off = ((size_t)b2 * seq_kv + row) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * r;
      const int col = wg * 64 + acc_col(wt, i);  // even; d is a multiple of 8
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int D, bool PAD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int batch, int heads, int kv_heads, int seq_q,
           int seq_kv, int d, int causal, int window, float sm_scale, cudaStream_t stream) {
  const auto kernel = flash_bwd_dkv_wgmma_kernel<D, PAD>;
  // Above 48 KB a block's shared memory must be asked for, on the current
  // device: set on every launch (cheap next to the kernel), so a launch on
  // another device, or after a failed attempt, asks again.
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(batch * kv_heads, (seq_kv + BKV - 1) / BKV);
  kernel<<<grid, threads<D>(), smem_bytes<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads,
      kv_heads, seq_q, seq_kv, d, causal, window, sm_scale, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dK and dV, reading the `delta` that flash_attention_bwd_dq_wgmma wrote;
// head_dim a multiple of 8 from 8 to 128.
extern "C" int flash_attention_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv, int batch,
                                             int heads, int kv_heads, int seq_q, int seq_kv,
                                             int head_dim, int causal, int window,
                                             float sm_scale, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // Any multiple of 8 from 8 to 128: 64 and 128 run their own builds,
  // the rest the next wider one, zero-filled past the real head_dim.
  if (head_dim < 8 || head_dim > 128 || head_dim % 8) return (int)cudaErrorInvalidValue;
#define BUILD(D_, PAD_) \
  launch<D_, PAD_>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, seq_q, seq_kv, head_dim, \
      causal, window, sm_scale, s)
  if (head_dim == 64) return BUILD(64, false);
  if (head_dim == 128) return BUILD(128, false);
  return head_dim < 64 ? BUILD(64, true) : BUILD(128, true);
#undef BUILD
}
