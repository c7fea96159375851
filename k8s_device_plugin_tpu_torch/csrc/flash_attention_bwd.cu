// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, plain C interface.
//
// Replaces the TPU kernels k8s_device_plugin_tpu/ops/flash_attention.py
// _dq_kernel and _dkv_kernel (both launched by _flash_bwd_pallas).  Inputs
// are the forward's residuals: q, out, dout [b, h, s_q, d]; k, v [b, hk,
// s_kv, d] with hk dividing h (GQA: q head i reads kv head i / (h / hk));
// lse [b, h, s_q] float32 from csrc/flash_attention.cu.  Outputs dq in q's
// type and dk, dv in k's type.  The math is the TPU kernels':
//   P  = exp(S * scale - lse)            (0 where masked or lse = -inf)
//   D  = rowsum(dO o O)                   (f32, once per q row)
//   dS = P o (dO V^T - D) * scale         (rounded to the input type)
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO (P rounded to dO's type)
// with every product accumulated in float32.
//
// Bound on the card: operations.  Per causal (row, col) pair dQ does 6 d
// flops (S, dP, dS K) and dK/dV 8 d (S, dP, dS^T Q, P^T dO) over bytes that
// grow only with s, so from a few hundred tokens on both are far above
// Hopper's ~295 flop/byte.  These first kernels are plain and right rather
// than fast: float FMA on the CUDA cores, no tensor cores (wgmma/TMA are for
// a later PR).  What the design does about its bound and the card:
//   - the TPU's sequential grid axes become loops inside a block, so no sum
//     crosses blocks: the dQ block (b*h, q tile) loops over kv tiles, the
//     dK/dV block (b*hk, kv tile) loops over every q head of its kv head's
//     group and over the q tiles, so the group's gradient is summed in
//     registers, deterministically and without atomics;
//   - both loops visit live tiles only: dQ from the sliding window's first
//     kv tile to the causal diagonal (as the forward), dK/dV from the
//     diagonal to the window's last q tile;
//   - register pressure: a row's head_dim is split over PARTS = 4 threads,
//     each holding 16 elements of its operands and its float32
//     accumulators (dQ: q, dO, dq = 48 floats; dK/dV: k, v, dk, dv = 64):
//     98-128 registers, no spills but 8 bytes in the float32 dK/dV kernel
//     (nvcc -Xptxas -v); row dot products finish with two warp shuffles.  The
//     four threads of a row take interleaved float4 chunks, so their reads
//     of a shared-memory row hit four different bank groups;
//   - the streamed operand tile (K and V for dQ; Q, dO, lse and D for
//     dK/dV) is staged once per block in shared memory as float32 and read
//     by every row as broadcasts;
//   - D is computed here, by the dQ kernel for its own rows (it holds their
//     dO and O), and written out for the dK/dV kernel, which runs after it
//     on the same stream;
//   - any length: rows past s_q or s_kv in a last tile compute on a copy of
//     the last real row and write nothing; the ragged last streamed tile
//     loads zeros and masks its dead rows or columns (a separate
//     instantiation, so full tiles carry no guards).  Rows whose lse is
//     -inf get P = 0 through the finite test, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                  // head_dim (the wrapper raises on others)
constexpr int TILE = 64;               // rows per block and rows per streamed tile
constexpr int PARTS = 4;               // threads per row
constexpr int THREADS = TILE * PARTS;  // 256
constexpr int PER = D / PARTS;         // elements of a row per thread
constexpr int CH = PER / 4;            // float4 chunks per thread

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

// Round to T and back, as the TPU kernels' .astype before a product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Thread `part` of a row owns float4 chunks part, part + PARTS, ...: element
// offset of its chunk c.
__device__ __forceinline__ int chunk_at(int part, int c) { return (part + PARTS * c) * 4; }

template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ void store4(T* p, float4 x);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 x) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x.x, x.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

// This thread's PER elements of a row (global memory, type T) as float32.
template <typename T>
__device__ __forceinline__ void load_part(const T* __restrict__ row, int part, float (&r)[PER]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 x = load4<T>(row + chunk_at(part, c));
    r[4 * c] = x.x, r[4 * c + 1] = x.y, r[4 * c + 2] = x.z, r[4 * c + 3] = x.w;
  }
}

template <typename T>
__device__ __forceinline__ void store_part(T* __restrict__ row, int part, const float (&r)[PER]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    store4<T>(row + chunk_at(part, c),
              make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]));
  }
}

// This thread's PER elements of a float32 row in shared memory.
__device__ __forceinline__ void read_part(const float* row, int part, float (&r)[PER]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(row + chunk_at(part, c));
    r[4 * c] = x.x, r[4 * c + 1] = x.y, r[4 * c + 2] = x.z, r[4 * c + 3] = x.w;
  }
}

__device__ __forceinline__ void write_part(float* row, int part, const float (&r)[PER]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    *reinterpret_cast<float4*>(row + chunk_at(part, c)) =
        make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
}

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
template <typename T, bool RAGGED>
__device__ __forceinline__ void dq_tile(const T* __restrict__ kbase, const T* __restrict__ vbase,
                                        int ki, int seq_kv, int row, int part, int causal,
                                        int window, float sm_scale, float lse, float delta,
                                        const float (&qr)[PER], const float (&dor)[PER],
                                        float (&dq)[PER], float (*ks)[D], float (*vs)[D]) {
  __syncthreads();  // every thread is done with the previous tile
  {
    const int r = threadIdx.x / PARTS, kr = ki * TILE + r;
    float kt[PER], vt[PER];
    if (!RAGGED || kr < seq_kv) {
      load_part(kbase + (size_t)kr * D, part, kt);
      load_part(vbase + (size_t)kr * D, part, vt);
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
    const float ds = round_to<T>(p * (dp - delta) * sm_scale);
#pragma unroll
    for (int e = 0; e < PER; ++e) dq[e] = fmaf(ds, kj[e], dq[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ delta_out, int heads, int kv_heads, int seq_q,
    int seq_kv, int causal, int window, float sm_scale) {
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

  float qr[PER], dor[PER];
  load_part(q + rix * D, part, qr);
  load_part(dout + rix * D, part, dor);
  float delta;
  {
    float orow[PER];
    load_part(out + rix * D, part, orow);
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
  const T* kbase = k + (size_t)kvh * seq_kv * D;
  const T* vbase = v + (size_t)kvh * seq_kv * D;
  for (int ki = kv_lo; ki < min(kv_hi, n_full); ++ki) {
    dq_tile<T, false>(kbase, vbase, ki, seq_kv, row, part, causal, window, sm_scale, l, delta,
                      qr, dor, acc, ks, vs);
  }
  if (kv_lo <= n_full && n_full < kv_hi) {  // the ragged last tile is live
    dq_tile<T, true>(kbase, vbase, n_full, seq_kv, row, part, causal, window, sm_scale, l,
                     delta, qr, dor, acc, ks, vs);
  }
  if (row < seq_q) store_part(dq + rix * D, part, acc);
}

// ------------------------------------------------------------------ dK/dV

// One q tile of one q head into this kv row's dK and dV.  RAGGED: the last q
// tile of a sequence that TILE does not divide (rows past seq_q load as
// zeros with lse = -inf, so their P is 0).
template <typename T, bool RAGGED>
__device__ __forceinline__ void dkv_tile(const T* __restrict__ qbase, const T* __restrict__ dobase,
                                         const float* __restrict__ lsebase,
                                         const float* __restrict__ deltabase, int qi, int seq_q,
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
      load_part(qbase + (size_t)qrow * D, part, qt);
      load_part(dobase + (size_t)qrow * D, part, dt);
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
    const float ds = round_to<T>(p * (dp - dls[i]) * sm_scale);
    const float pr = round_to<T>(p);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      dk[e] = fmaf(ds, qv[e], dk[e]);
      dv[e] = fmaf(pr, dov[e], dv[e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int heads, int kv_heads, int seq_q, int seq_kv,
    int causal, int window, float sm_scale) {
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

  float kr[PER], vr[PER];
  load_part(k + cix * D, part, kr);
  load_part(v + cix * D, part, vr);
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
    const T* qbase = q + (size_t)h * seq_q * D;
    const T* dobase = dout + (size_t)h * seq_q * D;
    const float* lbase = lse + (size_t)h * seq_q;
    const float* dbase = delta + (size_t)h * seq_q;
    for (int qi = q_lo; qi < min(q_hi, n_full); ++qi) {
      dkv_tile<T, false>(qbase, dobase, lbase, dbase, qi, seq_q, col, part, causal, window,
                         sm_scale, kr, vr, dk_acc, dv_acc, qs, dos, ls, dls);
    }
    if (q_lo <= n_full && n_full < q_hi) {  // the ragged last tile is live
      dkv_tile<T, true>(qbase, dobase, lbase, dbase, n_full, seq_q, col, part, causal, window,
                        sm_scale, kr, vr, dk_acc, dv_acc, qs, dos, ls, dls);
    }
  }
  if (col < seq_kv) {
    store_part(dk + cix * D, part, dk_acc);
    store_part(dv + cix * D, part, dv_acc);
  }
}

bool bad_shape(int batch, int heads, int kv_heads, int seq_q, int seq_kv, int head_dim) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_q <= 0 || seq_kv <= 0 ||
         head_dim != D;
}

}  // namespace

// dQ and the per-row D = rowsum(dO o O) (written to `delta`, [b, h, s_q]
// float32, for flash_attention_bwd_dkv).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* dq, void* delta, int batch, int heads, int kv_heads,
                                      int seq_q, int seq_kv, int head_dim, int causal,
                                      int window, float sm_scale, int is_bf16, void* stream) {
  if (bad_shape(batch, heads, kv_heads, seq_q, seq_kv, head_dim)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch * heads, (seq_q + TILE - 1) / TILE);
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  if (is_bf16) {
    using T = __nv_bfloat16;
    flash_bwd_dq_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(out), static_cast<const T*>(dout), l, static_cast<T*>(dq), dl,
        heads, kv_heads, seq_q, seq_kv, causal, window, sm_scale);
  } else {
    using T = float;
    flash_bwd_dq_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(out), static_cast<const T*>(dout), l, static_cast<T*>(dq), dl,
        heads, kv_heads, seq_q, seq_kv, causal, window, sm_scale);
  }
  return (int)cudaGetLastError();
}

// dK and dV, reading the `delta` that flash_attention_bwd_dq wrote.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int batch, int heads, int kv_heads,
                                       int seq_q, int seq_kv, int head_dim, int causal,
                                       int window, float sm_scale, int is_bf16, void* stream) {
  if (bad_shape(batch, heads, kv_heads, seq_q, seq_kv, head_dim)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch * kv_heads, (seq_kv + TILE - 1) / TILE);
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  if (is_bf16) {
    using T = __nv_bfloat16;
    flash_bwd_dkv_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), l, dl, static_cast<T*>(dk), static_cast<T*>(dv), heads,
        kv_heads, seq_q, seq_kv, causal, window, sm_scale);
  } else {
    using T = float;
    flash_bwd_dkv_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), l, dl, static_cast<T*>(dk), static_cast<T*>(dv), heads,
        kv_heads, seq_q, seq_kv, causal, window, sm_scale);
  }
  return (int)cudaGetLastError();
}
