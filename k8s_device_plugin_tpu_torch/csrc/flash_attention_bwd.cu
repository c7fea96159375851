// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, float32:
// the dQ and the dK/dV kernels, plain C interface.
//
// Replaces the TPU kernels k8s_device_plugin_tpu/ops/flash_attention.py
// _dq_kernel and _dkv_kernel (both launched by _flash_bwd_pallas) for
// float32 inputs.  bf16 runs the tensor-core kernels of
// csrc/flash_attention_bwd_dq_wgmma.cu (dQ) and
// csrc/flash_attention_bwd_wgmma.cu (dK/dV); float32 keeps the FMA kernels
// here by design, since wgmma has no float32 operands and TF32 would miss
// the float32 tolerances.  Inputs are the forward's residuals: q, out, dout
// [b, h, s_q, d]; k, v [b, hk, s_kv, d] with hk dividing h (GQA: q head i
// reads kv head i / (h / hk)); lse [b, h, s_q] float32 from
// csrc/flash_attention.cu.  Outputs dq, dk, dv float32.  The math is the
// TPU kernels':
//   P  = exp(S * scale - lse)            (0 where masked or lse = -inf)
//   D  = rowsum(dO o O)                   (once per q row)
//   dS = P o (dO V^T - D) * scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
// with every product accumulated in float32.
//
// Bound on the card: operations.  Per causal (row, col) pair dQ does 6 d
// flops (S, dP, dS K) and dK/dV 8 d (S, dP, dS^T Q, P^T dO) over bytes that
// grow only with s, so from a few hundred tokens on both are far above the
// card's float32 flop/byte.  These kernels are plain and right rather than
// fast: float FMA on the CUDA cores.  What the design does about its bound
// and the card:
//   - the TPU's sequential grid axes become loops inside a block, so no sum
//     crosses blocks: the dQ block (b*h, q tile) loops over kv tiles, the
//     dK/dV block (b*hk, kv tile) loops over every q head of its kv head's
//     group and over the q tiles, so the group's gradient is summed in
//     registers, deterministically and without atomics;
//   - both loops visit live tiles only: dQ from the sliding window's first
//     kv tile to the causal diagonal (as the forward), dK/dV from the
//     diagonal to the window's last q tile;
//   - head_dim d is a template parameter (16, 32, 64 or 128; any other
//     multiple of 8 runs in the 64- or 128-wide build, padded: global rows
//     load as zeros past d and only the real columns are written); at 128 a
//     block takes 32 rows and streams 32-row tiles, so both staged tiles
//     stay within 48 KB of static shared memory;
//   - any head_dim d above 128 (d a multiple of 8; the wrapper pads any
//     other head_dim to one) runs the wide kernels below: a block per
//     (b*h or b*hk, tile, 64-column slab of the gradient), one thread a
//     row, S and dP accumulated over 32-value pieces of the head_dim
//     staged in shared memory, so their registers do not grow with d;
//   - register pressure: a row's head_dim is split over PARTS = 4 threads,
//     each holding d / 4 elements of its operands and its float32
//     accumulators (at d 64, dQ: q, dO, dq = 48 floats; dK/dV: k, v, dk,
//     dv = 64);
//     row dot products finish with two warp shuffles.  The four threads of
//     a row take interleaved float4 chunks, so their reads of a
//     shared-memory row hit four different bank groups;
//   - the streamed operand tile (K and V for dQ; Q, dO, lse and D for
//     dK/dV) is staged once per block in shared memory and read by every
//     row as broadcasts;
//   - D is computed here, by the dQ kernel for its own rows (it holds their
//     dO and O), and written out for the dK/dV kernel, which runs after it
//     on the same stream;
//   - any length: rows past s_q or s_kv in a last tile compute on a copy of
//     the last real row and write nothing; the ragged last streamed tile
//     loads zeros and masks its dead rows or columns (a separate
//     instantiation, so full tiles carry no guards).  Rows whose lse is
//     -inf get P = 0 through the finite test, never NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PARTS = 4;  // threads per row

// Rows per block and per streamed tile, and threads per block, at head_dim
// D: two tiles of rows stay within 48 KB of static shared memory.
template <int D> __host__ __device__ constexpr int tile_rows() { return D > 64 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int threads() { return tile_rows<D>() * PARTS; }

// Thread `part` of a row owns float4 chunks part, part + PARTS, ...: element
// offset of its chunk c.
__device__ __forceinline__ int chunk_at(int part, int c) { return (part + PARTS * c) * 4; }

// This thread's PER = D / PARTS elements of a row (global or shared
// memory); elements at or past `width` (a multiple of 4: the real head_dim
// of a padded build's global rows) read as zeros.
template <int PER>
__device__ __forceinline__ void read_part(const float* __restrict__ row, int part,
                                          float (&r)[PER], int width = PER * PARTS) {
#pragma unroll
  for (int c = 0; c < PER / 4; ++c) {
    const int e = chunk_at(part, c);
    const float4 x =
        e < width ? *reinterpret_cast<const float4*>(row + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * c] = x.x, r[4 * c + 1] = x.y, r[4 * c + 2] = x.z, r[4 * c + 3] = x.w;
  }
}

// Writes the elements below `width` only.
template <int PER>
__device__ __forceinline__ void write_part(float* row, int part, const float (&r)[PER],
                                           int width = PER * PARTS) {
#pragma unroll
  for (int c = 0; c < PER / 4; ++c) {
    const int e = chunk_at(part, c);
    if (e < width) {
      *reinterpret_cast<float4*>(row + e) =
          make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
    }
  }
}

template <int PER>
__device__ __forceinline__ float dot_part(const float (&a)[PER], const float (&b)[PER]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

// Sum over the PARTS consecutive lanes of one row.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ bool in_band(int row, int col, int causal, int window) {
  return !causal || (row >= col && (window <= 0 || row - col < window));
}

// ------------------------------------------------------------------ dQ

// One kv tile into this row's dQ.  RAGGED: the last kv tile of a sequence
// that TILE does not divide (its rows past seq_kv load as zeros and mask).
template <int D, bool RAGGED, int TILE = tile_rows<D>(), int PER = D / PARTS>
__device__ __forceinline__ void dq_tile(const float* __restrict__ kbase,
                                        const float* __restrict__ vbase, int d,
                                        int ki, int seq_kv, int row, int part, int causal,
                                        int window, float sm_scale, float lse, float delta,
                                        const float (&qr)[PER], const float (&dor)[PER],
                                        float (&dq)[PER], float (*ks)[D], float (*vs)[D]) {
  __syncthreads();  // every thread is done with the previous tile
  {
    const int r = threadIdx.x / PARTS, kr = ki * TILE + r;
    float kt[PER], vt[PER];
    if (!RAGGED || kr < seq_kv) {
      read_part(kbase + (size_t)kr * d, part, kt, d);
      read_part(vbase + (size_t)kr * d, part, vt, d);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) kt[e] = vt[e] = 0.f;
    }
    write_part(ks[r], part, kt);
    write_part(vs[r], part, vt);
  }
  __syncthreads();
  const bool finite = lse > -INFINITY;
#pragma unroll 2
  for (int j = 0; j < TILE; ++j) {
    const int col = ki * TILE + j;
    float kj[PER], vj[PER];
    read_part(ks[j], part, kj);
    read_part(vs[j], part, vj);
    const float s = row_sum(dot_part(qr, kj));
    const float dp = row_sum(dot_part(dor, vj));
    bool ok = finite && in_band(row, col, causal, window);
    if (RAGGED) ok = ok && col < seq_kv;
    const float p = ok ? expf(s * sm_scale - lse) : 0.f;
    const float ds = p * (dp - delta) * sm_scale;
#pragma unroll
    for (int e = 0; e < PER; ++e) dq[e] = fmaf(ds, kj[e], dq[e]);
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__((D > 64 ? 32 : 64) * PARTS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta_out, int heads, int kv_heads, int seq_q,
    int seq_kv, int d_arg, int causal, int window, float sm_scale) {
  constexpr int TILE = tile_rows<D>(), PER = D / PARTS;
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int group = heads / kv_heads;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  const int part = threadIdx.x % PARTS;
  const int row = qi * TILE + threadIdx.x / PARTS;
  // A row past seq_q in the last q tile reads the last real row (finite
  // values, no branch) and writes nothing.
  const size_t rix = (size_t)bh * seq_q + min(row, seq_q - 1);
  const int d = PAD ? d_arg : D;  // the real head_dim: a constant unless padded

  float qr[PER], dor[PER];
  read_part(q + rix * d, part, qr, d);
  read_part(dout + rix * d, part, dor, d);
  float delta;
  {
    float orow[PER];
    read_part(out + rix * d, part, orow, d);
    delta = row_sum(dot_part(dor, orow));
  }
  const float l = lse[rix];
  if (row < seq_q && part == 0) delta_out[rix] = delta;

  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;

  const int n_full = seq_kv / TILE;
  const int n_kv = (seq_kv + TILE - 1) / TILE;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (qi * TILE + TILE - 1) / TILE + 1);
    if (window > 0) kv_lo = max(qi * TILE - (window - 1), 0) / TILE;
  }
  const float* kbase = k + (size_t)kvh * seq_kv * d;
  const float* vbase = v + (size_t)kvh * seq_kv * d;
  for (int ki = kv_lo; ki < min(kv_hi, n_full); ++ki) {
    dq_tile<D, false>(kbase, vbase, d, ki, seq_kv, row, part, causal, window, sm_scale, l, delta, qr,
                   dor, acc, ks, vs);
  }
  if (kv_lo <= n_full && n_full < kv_hi) {  // the ragged last tile is live
    dq_tile<D, true>(kbase, vbase, d, n_full, seq_kv, row, part, causal, window, sm_scale, l, delta,
                  qr, dor, acc, ks, vs);
  }
  if (row < seq_q) write_part(dq + rix * d, part, acc, d);
}

// ------------------------------------------------------------------ dK/dV

// One q tile of one q head into this kv row's dK and dV, float32.  RAGGED:
// the last q tile of a sequence that TILE does not divide (rows past seq_q
// load as zeros with lse = -inf, so their P is 0).
template <int D, bool RAGGED, int TILE = tile_rows<D>(), int PER = D / PARTS>
__device__ __forceinline__ void dkv_tile(const float* __restrict__ qbase,
                                         const float* __restrict__ dobase,
                                         const float* __restrict__ lsebase,
                                         const float* __restrict__ deltabase, int d, int qi,
                                         int seq_q,
                                         int col, int part, int causal, int window,
                                         float sm_scale, const float (&kr)[PER],
                                         const float (&vr)[PER], float (&dk)[PER],
                                         float (&dv)[PER], float (*qs)[D], float (*dos)[D],
                                         float* ls, float* dls) {
  __syncthreads();  // every thread is done with the previous tile
  {
    const int r = threadIdx.x / PARTS, qrow = qi * TILE + r;
    float qt[PER], dt[PER];
    const bool live = !RAGGED || qrow < seq_q;
    if (live) {
      read_part(qbase + (size_t)qrow * d, part, qt, d);
      read_part(dobase + (size_t)qrow * d, part, dt, d);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) qt[e] = dt[e] = 0.f;
    }
    write_part(qs[r], part, qt);
    write_part(dos[r], part, dt);
    if (part == 0) {
      ls[r] = live ? lsebase[qrow] : -INFINITY;
      dls[r] = live ? deltabase[qrow] : 0.f;
    }
  }
  __syncthreads();
#pragma unroll 2
  for (int i = 0; i < TILE; ++i) {
    const int row = qi * TILE + i;
    float qv[PER], dov[PER];
    read_part(qs[i], part, qv);
    read_part(dos[i], part, dov);
    const float s = row_sum(dot_part(qv, kr));
    const float dp = row_sum(dot_part(dov, vr));
    const float l = ls[i];
    const bool ok = l > -INFINITY && in_band(row, col, causal, window);
    const float p = ok ? expf(s * sm_scale - l) : 0.f;
    const float ds = p * (dp - dls[i]) * sm_scale;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      dk[e] = fmaf(ds, qv[e], dk[e]);
      dv[e] = fmaf(p, dov[e], dv[e]);
    }
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__((D > 64 ? 32 : 64) * PARTS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int heads,
    int kv_heads, int seq_q, int seq_kv, int d_arg, int causal, int window, float sm_scale) {
  constexpr int TILE = tile_rows<D>(), PER = D / PARTS;
  __shared__ __align__(16) float qs[TILE][D];
  __shared__ __align__(16) float dos[TILE][D];
  __shared__ float ls[TILE];
  __shared__ float dls[TILE];

  const int b2 = blockIdx.x, ki = blockIdx.y;
  const int group = heads / kv_heads;
  const int part = threadIdx.x % PARTS;
  const int col = ki * TILE + threadIdx.x / PARTS;
  // A row past seq_kv in the last kv tile reads the last real row and
  // writes nothing.
  const size_t cix = (size_t)b2 * seq_kv + min(col, seq_kv - 1);
  const int d = PAD ? d_arg : D;  // the real head_dim: a constant unless padded

  float kr[PER], vr[PER];
  read_part(k + cix * d, part, kr, d);
  read_part(v + cix * d, part, vr, d);
  float dk_acc[PER], dv_acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  const int n_full = seq_q / TILE;
  const int n_q = (seq_q + TILE - 1) / TILE;
  int q_lo = 0, q_hi = n_q;
  if (causal) {
    q_lo = ki;  // the first q tile whose last row reaches this tile's first column
    if (window > 0) q_hi = min(n_q, (ki * TILE + TILE - 1 + window - 1) / TILE + 1);
  }
  for (int g = 0; g < group; ++g) {
    const int h = (b2 / kv_heads) * heads + (b2 % kv_heads) * group + g;
    const float* qbase = q + (size_t)h * seq_q * d;
    const float* dobase = dout + (size_t)h * seq_q * d;
    const float* lbase = lse + (size_t)h * seq_q;
    const float* dbase = delta + (size_t)h * seq_q;
    for (int qi = q_lo; qi < min(q_hi, n_full); ++qi) {
      dkv_tile<D, false>(qbase, dobase, lbase, dbase, d, qi, seq_q, col, part, causal, window,
                      sm_scale, kr, vr, dk_acc, dv_acc, qs, dos, ls, dls);
    }
    if (q_lo <= n_full && n_full < q_hi) {  // the ragged last tile is live
      dkv_tile<D, true>(qbase, dobase, lbase, dbase, d, n_full, seq_q, col, part, causal, window,
                     sm_scale, kr, vr, dk_acc, dv_acc, qs, dos, ls, dls);
    }
  }
  if (col < seq_kv) {
    write_part(dk + cix * d, part, dk_acc, d);
    write_part(dv + cix * d, part, dv_acc, d);
  }
}

// ------------------------------------------------------------------ wide

// The wide kernels: any head_dim d (a multiple of 4) above 128, one thread
// per row of a 64-row tile and a 64-column slab of the gradient a block
// (grid axis z).  S and dP accumulate over 32-value pieces of the head_dim
// (the tile's own rows padded against bank conflicts, the streamed WB rows
// read as broadcasts), then the streamed rows' slabs (K for dQ; Q and dO
// for dK/dV) take the step's dS and P.  Each slab recomputes S and dP: the
// price of taking any width.
constexpr int WR = 64;  // rows a block (one thread each)
constexpr int WB = 16;  // streamed rows per step
constexpr int WP = 32;  // head_dim values per piece of S and dP
constexpr int WS = 64;  // gradient columns a block

// rows x cols of a row-major matrix (row stride ld) from (r0, c0) into a
// shared tile of row stride `stride`, zero past n_rows or n_cols.
__device__ __forceinline__ void stage(float* tile, int stride, int rows, int cols,
                                      const float* __restrict__ src, int ld, int r0, int c0,
                                      int n_rows, int n_cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx % cols;
    tile[r * stride + c] =
        r0 + r < n_rows && c0 + c < n_cols ? src[(size_t)(r0 + r) * ld + c0 + c] : 0.f;
  }
}

__global__ void __launch_bounds__(WR) flash_bwd_dq_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta, int heads, int kv_heads, int seq_q,
    int seq_kv, int d, int causal, int window, float sm_scale) {
  __shared__ float qs[WR][WP + 1], dos[WR][WP + 1];
  __shared__ float ks[WB][WP], vs[WB][WP], kslab[WB][WS];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, q0 = blockIdx.y * WR, col0 = blockIdx.z * WS;
  const int group = heads / kv_heads;
  const int kvh = (bh / heads) * kv_heads + (bh % heads) / group;
  const int row = q0 + tid;
  const float* qb = q + (size_t)bh * seq_q * d;
  const float* dob = dout + (size_t)bh * seq_q * d;
  const float* kb = k + (size_t)kvh * seq_kv * d;
  const float* vb = v + (size_t)kvh * seq_kv * d;

  // D = rowsum(dO o O) over the whole head_dim; the slab-0 block writes it.
  float dl = 0.f;
  if (row < seq_q) {
    const float* o_row = out + ((size_t)bh * seq_q + row) * d;
    for (int e = 0; e < d; ++e) dl = fmaf(dob[(size_t)row * d + e], o_row[e], dl);
    if (blockIdx.z == 0) delta[(size_t)bh * seq_q + row] = dl;
  }
  const float l = row < seq_q ? lse[(size_t)bh * seq_q + row] : -INFINITY;
  const bool finite = l > -INFINITY;

  float acc[WS];
#pragma unroll
  for (int c = 0; c < WS; ++c) acc[c] = 0.f;
  const int n_kv = (seq_kv + WB - 1) / WB;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) {
    kv_hi = min(n_kv, (q0 + WR - 1) / WB + 1);
    if (window > 0) kv_lo = max(q0 - (window - 1), 0) / WB;
  }
  for (int ki = kv_lo; ki < kv_hi; ++ki) {
    const int c0 = ki * WB;
    float s[WB], dp[WB];
#pragma unroll
    for (int j = 0; j < WB; ++j) s[j] = dp[j] = 0.f;
    for (int p0 = 0; p0 < d; p0 += WP) {
      __syncthreads();
      stage(&qs[0][0], WP + 1, WR, WP, qb, d, q0, p0, seq_q, d);
      stage(&dos[0][0], WP + 1, WR, WP, dob, d, q0, p0, seq_q, d);
      stage(&ks[0][0], WP, WB, WP, kb, d, c0, p0, seq_kv, d);
      stage(&vs[0][0], WP, WB, WP, vb, d, c0, p0, seq_kv, d);
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < WP; ++e) {
        const float x = qs[tid][e], y = dos[tid][e];
#pragma unroll
        for (int j = 0; j < WB; ++j) {
          s[j] = fmaf(x, ks[j][e], s[j]);
          dp[j] = fmaf(y, vs[j][e], dp[j]);
        }
      }
    }
    __syncthreads();
    stage(&kslab[0][0], WS, WB, WS, kb, d, c0, col0, seq_kv, d);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < WB; ++j) {
      const int col = c0 + j;
      const bool ok = finite && col < seq_kv && in_band(row, col, causal, window);
      const float p = ok ? expf(s[j] * sm_scale - l) : 0.f;
      const float ds = p * (dp[j] - dl) * sm_scale;
#pragma unroll
      for (int c = 0; c < WS; ++c) acc[c] = fmaf(ds, kslab[j][c], acc[c]);
    }
  }
  if (row >= seq_q) return;
  float* dq_row = dq + ((size_t)bh * seq_q + row) * d;
#pragma unroll
  for (int c = 0; c < WS; ++c) {
    if (col0 + c < d) dq_row[col0 + c] = acc[c];
  }
}

__global__ void __launch_bounds__(WR) flash_bwd_dkv_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int heads,
    int kv_heads, int seq_q, int seq_kv, int d, int causal, int window, float sm_scale) {
  __shared__ float ks[WR][WP + 1], vs[WR][WP + 1];
  __shared__ float qs[WB][WP], dos[WB][WP], qslab[WB][WS], doslab[WB][WS];
  __shared__ float lse_t[WB], dl_t[WB];
  const int tid = threadIdx.x;
  const int b2 = blockIdx.x, kv0 = blockIdx.y * WR, col0 = blockIdx.z * WS;
  const int group = heads / kv_heads;
  const int col = kv0 + tid;  // this thread's kv row
  const float* kb = k + (size_t)b2 * seq_kv * d;
  const float* vb = v + (size_t)b2 * seq_kv * d;

  float dk_acc[WS], dv_acc[WS];
#pragma unroll
  for (int c = 0; c < WS; ++c) dk_acc[c] = dv_acc[c] = 0.f;
  const int n_q = (seq_q + WB - 1) / WB;
  int q_lo = 0, q_hi = n_q;
  if (causal) {
    q_lo = min(kv0 / WB, n_q);  // the first q tile whose last row reaches kv0
    if (window > 0) q_hi = min(n_q, (kv0 + WR - 1 + window - 1) / WB + 1);
  }
  for (int hh = 0; hh < group; ++hh) {
    const int h = (b2 / kv_heads) * heads + (b2 % kv_heads) * group + hh;
    const float* qb = q + (size_t)h * seq_q * d;
    const float* dob = dout + (size_t)h * seq_q * d;
    for (int qt = q_lo; qt < q_hi; ++qt) {
      const int r0 = qt * WB;
      float s[WB], dp[WB];
#pragma unroll
      for (int j = 0; j < WB; ++j) s[j] = dp[j] = 0.f;
      for (int p0 = 0; p0 < d; p0 += WP) {
        __syncthreads();
        stage(&ks[0][0], WP + 1, WR, WP, kb, d, kv0, p0, seq_kv, d);
        stage(&vs[0][0], WP + 1, WR, WP, vb, d, kv0, p0, seq_kv, d);
        stage(&qs[0][0], WP, WB, WP, qb, d, r0, p0, seq_q, d);
        stage(&dos[0][0], WP, WB, WP, dob, d, r0, p0, seq_q, d);
        __syncthreads();
#pragma unroll 4
        for (int e = 0; e < WP; ++e) {
          const float x = ks[tid][e], y = vs[tid][e];
#pragma unroll
          for (int j = 0; j < WB; ++j) {
            s[j] = fmaf(x, qs[j][e], s[j]);
            dp[j] = fmaf(y, dos[j][e], dp[j]);
          }
        }
      }
      __syncthreads();
      stage(&qslab[0][0], WS, WB, WS, qb, d, r0, col0, seq_q, d);
      stage(&doslab[0][0], WS, WB, WS, dob, d, r0, col0, seq_q, d);
      if (tid < WB) {
        const bool ok = r0 + tid < seq_q;
        lse_t[tid] = ok ? lse[(size_t)h * seq_q + r0 + tid] : -INFINITY;
        dl_t[tid] = ok ? delta[(size_t)h * seq_q + r0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < WB; ++j) {
        const int row = r0 + j;
        const float l = lse_t[j];
        const bool ok = l > -INFINITY && row < seq_q && in_band(row, col, causal, window);
        const float p = ok ? expf(s[j] * sm_scale - l) : 0.f;
        const float ds = p * (dp[j] - dl_t[j]) * sm_scale;
#pragma unroll
        for (int c = 0; c < WS; ++c) {
          dv_acc[c] = fmaf(p, doslab[j][c], dv_acc[c]);
          dk_acc[c] = fmaf(ds, qslab[j][c], dk_acc[c]);
        }
      }
    }
  }
  if (col >= seq_kv) return;
  const size_t off = ((size_t)b2 * seq_kv + col) * d;
#pragma unroll
  for (int c = 0; c < WS; ++c) {
    if (col0 + c < d) {
      dk[off + col0 + c] = dk_acc[c];
      dv[off + col0 + c] = dv_acc[c];
    }
  }
}

bool bad_shape(int batch, int heads, int kv_heads, int seq_q, int seq_kv) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0;
}

template <int D, bool PAD>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, void* dq, void* delta, int batch, int heads, int kv_heads,
              int seq_q, int seq_kv, int d, int causal, int window, float sm_scale,
              cudaStream_t stream) {
  constexpr int TILE = tile_rows<D>();
  const dim3 grid(batch * heads, (seq_q + TILE - 1) / TILE);
  flash_bwd_dq_kernel<D, PAD><<<grid, threads<D>(), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(delta), heads,
      kv_heads, seq_q, seq_kv, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, bool PAD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int batch, int heads, int kv_heads,
               int seq_q, int seq_kv, int d, int causal, int window, float sm_scale,
               cudaStream_t stream) {
  constexpr int TILE = tile_rows<D>();
  const dim3 grid(batch * kv_heads, (seq_kv + TILE - 1) / TILE);
  flash_bwd_dkv_kernel<D, PAD><<<grid, threads<D>(), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), heads,
      kv_heads, seq_q, seq_kv, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries take head_dim 64 or 128 in its own instantiation, any other
// multiple of 8 up to 128 in the next wider of the two builds, padded, and
// any multiple of 8 above 128 in the wide kernels.
#define FMA_BWD_SWITCH(CALL)                                                   \
  switch (head_dim) {                                                          \
    case 64: return CALL<64, false>(FMA_BWD_ARGS);                             \
    case 128: return CALL<128, false>(FMA_BWD_ARGS);                           \
    default:                                                                   \
      return head_dim < 64 ? CALL<64, true>(FMA_BWD_ARGS) : CALL<128, true>(FMA_BWD_ARGS); \
  }

extern "C" int flash_attention_bwd_dq_fma(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* dq, void* delta, int batch, int heads,
                                          int kv_heads, int seq_q, int seq_kv, int head_dim,
                                          int causal, int window, float sm_scale, void* stream) {
  if (bad_shape(batch, heads, kv_heads, seq_q, seq_kv) || head_dim < 8 || head_dim % 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (head_dim > 128) {
    const dim3 grid(batch * heads, (seq_q + WR - 1) / WR, (head_dim + WS - 1) / WS);
    flash_bwd_dq_wide_kernel<<<grid, WR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(out), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(delta),
        heads, kv_heads, seq_q, seq_kv, head_dim, causal, window, sm_scale);
    return (int)cudaGetLastError();
  }
#define FMA_BWD_ARGS                                                                        \
  q, k, v, out, dout, lse, dq, delta, batch, heads, kv_heads, seq_q, seq_kv, head_dim, causal, \
      window, sm_scale, static_cast<cudaStream_t>(stream)
  FMA_BWD_SWITCH(launch_dq)
#undef FMA_BWD_ARGS
}

extern "C" int flash_attention_bwd_dkv_fma(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int batch, int heads,
                                           int kv_heads, int seq_q, int seq_kv, int head_dim,
                                           int causal, int window, float sm_scale,
                                           void* stream) {
  if (bad_shape(batch, heads, kv_heads, seq_q, seq_kv) || head_dim < 8 || head_dim % 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (head_dim > 128) {
    const dim3 grid(batch * kv_heads, (seq_kv + WR - 1) / WR, (head_dim + WS - 1) / WS);
    flash_bwd_dkv_wide_kernel<<<grid, WR, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
        heads, kv_heads, seq_q, seq_kv, head_dim, causal, window, sm_scale);
    return (int)cudaGetLastError();
  }
#define FMA_BWD_ARGS                                                                         \
  q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, seq_q, seq_kv, head_dim, causal, \
      window, sm_scale, static_cast<cudaStream_t>(stream)
  FMA_BWD_SWITCH(launch_dkv)
#undef FMA_BWD_ARGS
}
#undef FMA_BWD_SWITCH
