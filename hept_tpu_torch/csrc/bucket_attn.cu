// Per-bucket RBF attention for Hopper: forward K1 / backward K2 (one CTA per
// bucket), forward K6 / backward K7 (several small buckets per CTA; their own
// notes below), and K10, the same kernels on the row layout.
//
// Replaces the TPU's flat-slab Pallas kernels
//   K1  hept_tpu/ops/bucket_attn_pallas.py:_fwd_slab128_kernel (pallas_call at :858)
//   K2  hept_tpu/ops/bucket_attn_pallas.py:_bwd_slab128_kernel (pallas_call at :893)
//
// Layout: (r, d, n) columns, n = nb * bs sorted points; bucket b of row r
// owns columns [b*bs, (b+1)*bs). Per bucket, with q_i, k_j the columns:
//   logit[i,j] = q_i.k_j - |q_i|^2/2 - |k_j|^2/2   (norms from f32 values)
//   pt[i,j]    = exp(min(logit, 0))
//   denom[i]   = sum_j pt[i,j] + 1e-20             (from the f32 pt)
//   so[:,i]    = sum_j v_j * pt[i,j]               (pt rounded to bf16 first
//                                                   when the inputs are bf16)
// K2 recomputes pt and forms, with g_so rounded to bf16 for bf16 inputs,
//   gp[j,i] = v_j.g_so_i + g_den_i,  dlt = pt*gp where logit < 0, else 0
//   dq_i = sum_j dlt k_j - (sum_j dlt) q_i,  dk_j = sum_i dlt q_i - (sum_i dlt) k_j
//   dv_j = sum_i g_so_i * pt[i,j]              (pt rounded to bf16 for bf16)
// outputs cast to the input dtype.
//
// Numerics. Products of (bf16-valued) operands are summed in f32 FMAs, as the
// TPU's bf16 MXU dots with f32 accumulation do; f32 inputs use f32 FMAs, not
// TF32. The TPU splits dlt into a hi/lo bf16 pair only because its dq/dk
// dots take bf16 operands; here dlt is accumulated in f32 directly, and the
// row and column sums that cancel the common mode (sum_j dlt (k_j - q_i))
// are taken from the very same dlt values as the products, which is the
// property the bf16-gradient contract needs.
//
// What bounds it on the H100. Per launch at the main path's shapes
// (r=16, d=30, dv=24, n=60416, bs=512) the bucket math is 2*r*n*bs*(d+dv)
// ~ 5.3e10 flop (K2 ~ 2.5x that) plus r*n*bs ~ 4.9e8 exponentials, over
// ~0.26 GB of inputs and outputs. The least time is the memory term
// (~77 us); the bf16 tensor-core term is ~54 us. These kernels are the
// simple first version: one CTA per (row, bucket) keeps the bucket's keys
// and values (K1, K2 query side) or queries and cotangents (K2 key side) in
// shared memory as f32, and each thread owns one query (or key) and loops
// over the other side with scalar FMAs. They are bound by the FMA and
// shared-memory issue rate of the CUDA cores, far above the bound; moving
// the two contractions onto wgmma is later work. K2 runs its two
// contractions as two halves of one grid (blockIdx.z): thread-per-query for
// dq, thread-per-key for dk and dv, each recomputing pt, so no value is
// reduced across threads or CTAs: no atomics, and the result is
// deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr float kDenomEps = 1e-20f;

template <bool BF16>
struct Io;

template <>
struct Io<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(const T* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ T store(float x) { return __float2bfloat16_rn(x); }
};

template <>
struct Io<false> {
  using T = float;
  static __device__ __forceinline__ float load(const T* p) { return *p; }
  static __device__ __forceinline__ T store(float x) { return x; }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy a (C, count) column block into shared rows dst[j*CP + e], the CP - C
// padding columns zeroed. Reads coalesce along n.
template <int C, int CP, bool BF16>
__device__ __forceinline__ void load_rows(const typename Io<BF16>::T* src, size_t n,
                                          size_t base, int count, float* dst) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
#pragma unroll
    for (int e = 0; e < C; ++e) dst[j * CP + e] = Io<BF16>::load(src + e * n + base + j);
#pragma unroll
    for (int e = C; e < CP; ++e) dst[j * CP + e] = 0.f;
  }
}

template <int D, int DV, bool BF16>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const typename Io<BF16>::T* __restrict__ q, const typename Io<BF16>::T* __restrict__ k,
           const typename Io<BF16>::T* __restrict__ v, float* __restrict__ denom,
           float* __restrict__ so, int n, int bs) {
  extern __shared__ float smem[];
  float* k_s = smem;              // [bs][D]
  float* v_s = k_s + bs * D;      // [bs][DV]
  float* ksq_s = v_s + bs * DV;   // [bs]
  const size_t nn = n;
  const size_t r = blockIdx.y;
  const size_t base = (size_t)blockIdx.x * bs;
  const auto* qr = q + r * D * nn;
  load_rows<D, D, BF16>(k + r * D * nn, nn, base, bs, k_s);
  load_rows<DV, DV, BF16>(v + r * DV * nn, nn, base, bs, v_s);
  __syncthreads();
  for (int j = threadIdx.x; j < bs; j += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc = fmaf(k_s[j * D + e], k_s[j * D + e], acc);
    ksq_s[j] = -0.5f * acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bs; i += kThreads) {
    float qi[D];
    float qsq = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      qi[e] = Io<BF16>::load(qr + e * nn + base + i);
      qsq = fmaf(qi[e], qi[e], qsq);
    }
    qsq *= -0.5f;
    float acc[DV];
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[e] = 0.f;
    float den = 0.f;
    for (int j = 0; j < bs; ++j) {
      const float* kj = k_s + j * D;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) dot = fmaf(qi[e], kj[e], dot);
      const float pt = expf(fminf(dot + qsq + ksq_s[j], 0.f));
      den += pt;
      const float pv = BF16 ? round_bf16(pt) : pt;
      const float* vj = v_s + j * DV;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[e] = fmaf(vj[e], pv, acc[e]);
    }
    denom[r * nn + base + i] = den + kDenomEps;
#pragma unroll
    for (int e = 0; e < DV; ++e) so[(r * DV + e) * nn + base + i] = acc[e];
  }
}

template <int D, int DV, bool BF16>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const typename Io<BF16>::T* __restrict__ q, const typename Io<BF16>::T* __restrict__ k,
           const typename Io<BF16>::T* __restrict__ v, const float* __restrict__ gso,
           const float* __restrict__ gden, typename Io<BF16>::T* __restrict__ dq,
           typename Io<BF16>::T* __restrict__ dk, typename Io<BF16>::T* __restrict__ dv,
           int n, int bs) {
  extern __shared__ float smem[];
  const size_t nn = n;
  const size_t r = blockIdx.y;
  const size_t base = (size_t)blockIdx.x * bs;
  const auto* qr = q + r * D * nn;
  const auto* kr = k + r * D * nn;
  const auto* vr = v + r * DV * nn;
  const float* gr = gso + r * DV * nn;
  const float* gdr = gden + r * nn;

  if (blockIdx.z == 0) {
    // query side: thread per query i, loop over the bucket's keys -> dq
    float* k_s = smem;             // [bs][D]
    float* v_s = k_s + bs * D;     // [bs][DV]
    float* ksq_s = v_s + bs * DV;  // [bs]
    load_rows<D, D, BF16>(kr, nn, base, bs, k_s);
    load_rows<DV, DV, BF16>(vr, nn, base, bs, v_s);
    __syncthreads();
    for (int j = threadIdx.x; j < bs; j += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) acc = fmaf(k_s[j * D + e], k_s[j * D + e], acc);
      ksq_s[j] = -0.5f * acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bs; i += kThreads) {
      float qi[D], gi[DV], acc[D];
      float qsq = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        qi[e] = Io<BF16>::load(qr + e * nn + base + i);
        qsq = fmaf(qi[e], qi[e], qsq);
        acc[e] = 0.f;
      }
      qsq *= -0.5f;
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        const float g = gr[e * nn + base + i];
        gi[e] = BF16 ? round_bf16(g) : g;
      }
      const float gd = gdr[base + i];
      float rowsum = 0.f;
      for (int j = 0; j < bs; ++j) {
        const float* kj = k_s + j * D;
        const float* vj = v_s + j * DV;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qi[e], kj[e], dot);
        const float logit = dot + qsq + ksq_s[j];
        const float pt = expf(fminf(logit, 0.f));
        float gp = 0.f;
#pragma unroll
        for (int e = 0; e < DV; ++e) gp = fmaf(vj[e], gi[e], gp);
        const float dl = logit < 0.f ? pt * (gp + gd) : 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] = fmaf(kj[e], dl, acc[e]);
        rowsum += dl;
      }
#pragma unroll
      for (int e = 0; e < D; ++e)
        dq[(r * D + e) * nn + base + i] = Io<BF16>::store(acc[e] - rowsum * qi[e]);
    }
  } else {
    // key side: thread per key j, loop over the bucket's queries -> dk, dv
    float* q_s = smem;              // [bs][D]
    float* g_s = q_s + bs * D;      // [bs][DV]
    float* qsq_s = g_s + bs * DV;   // [bs]
    float* gd_s = qsq_s + bs;       // [bs]
    load_rows<D, D, BF16>(qr, nn, base, bs, q_s);
    for (int i = threadIdx.x; i < bs; i += kThreads) {
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        const float g = gr[e * nn + base + i];
        g_s[i * DV + e] = BF16 ? round_bf16(g) : g;
      }
      gd_s[i] = gdr[base + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bs; i += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) acc = fmaf(q_s[i * D + e], q_s[i * D + e], acc);
      qsq_s[i] = -0.5f * acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < bs; j += kThreads) {
      float kj[D], vj[DV], acck[D], accv[DV];
      float ksq = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        kj[e] = Io<BF16>::load(kr + e * nn + base + j);
        ksq = fmaf(kj[e], kj[e], ksq);
        acck[e] = 0.f;
      }
      ksq *= -0.5f;
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        vj[e] = Io<BF16>::load(vr + e * nn + base + j);
        accv[e] = 0.f;
      }
      float colsum = 0.f;
      for (int i = 0; i < bs; ++i) {
        const float* qi = q_s + i * D;
        const float* gi = g_s + i * DV;
        // same products in the same order as the query side: identical pt
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qi[e], kj[e], dot);
        const float logit = dot + qsq_s[i] + ksq;
        const float pt = expf(fminf(logit, 0.f));
        float gp = 0.f;
#pragma unroll
        for (int e = 0; e < DV; ++e) gp = fmaf(vj[e], gi[e], gp);
        const float dl = logit < 0.f ? pt * (gp + gd_s[i]) : 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) acck[e] = fmaf(qi[e], dl, acck[e]);
        colsum += dl;
        const float pv = BF16 ? round_bf16(pt) : pt;
#pragma unroll
        for (int e = 0; e < DV; ++e) accv[e] = fmaf(gi[e], pv, accv[e]);
      }
#pragma unroll
      for (int e = 0; e < D; ++e)
        dk[(r * D + e) * nn + base + j] = Io<BF16>::store(acck[e] - colsum * kj[e]);
#pragma unroll
      for (int e = 0; e < DV; ++e) dv[(r * DV + e) * nn + base + j] = Io<BF16>::store(accv[e]);
    }
  }
}

template <int D, int DV, bool BF16>
int launch_fwd(const void* q, const void* k, const void* v, float* denom, float* so, int r,
               int n, int bs, cudaStream_t stream) {
  using T = typename Io<BF16>::T;
  const size_t smem = (size_t)bs * (D + DV + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<D, DV, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / bs, r);
  fwd_kernel<D, DV, BF16><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, denom, so, n, bs);
  return (int)cudaGetLastError();
}

template <int D, int DV, bool BF16>
int launch_bwd(const void* q, const void* k, const void* v, const float* gso, const float* gden,
               void* dq, void* dk, void* dv, int r, int n, int bs, cudaStream_t stream) {
  using T = typename Io<BF16>::T;
  const size_t smem = (size_t)bs * (D + DV + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<D, DV, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / bs, r, 2);
  bwd_kernel<D, DV, BF16><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, gso, gden, (T*)dq, (T*)dk, (T*)dv, n, bs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 / K7: the per-bucket column kernels for small buckets.
//
// Replace the TPU's per-bucket column kernels
//   K6  hept_tpu/ops/bucket_attn_pallas.py:_fwd_cols_kernel (:273) and
//       _fwd_cols_kernel_loop (:529), via _fwd_cols_impl (pallas_call at :1196)
//   K7  _bwd_cols_kernel (:334), _bwd_cols_kernel_v2 (:420) / _bwd_v2_bucket
//       (:447) and _bwd_cols_kernel_v2_loop (:511), via _bwd_cols_impl
//       (pallas_call at :1273)
// the bucket kernels of attn_impl pallas / hybrid / hybrid2 / hybrid2l /
// loop2 and of slab2 where no flat slab fits (block_size 100).
//
// What they compute (per bucket, as K1/K2 above):
//   K6, f32 inputs: exact f32 (fmaf, no TF32), logit = q.k + q_sq + k_sq.
//   K6, bf16 inputs, HILO (attn_impl pallas): each bias -|x|^2/2 is carried
//       as two bf16 rows hi + lo (_split_rows), logit = q.k + (q_hi + q_lo)
//       + (k_hi + k_lo). The TPU computes |q|^2 there with a default-
//       precision dot; this follows its interpret-mode value, exact f32.
//   K6, bf16 inputs, exact bias (the einsum / loop contract): K1's math.
//   bf16 inputs: pt rounded to bf16 before the value product.
//   K7 v1: f32 math (the wrapper upcasts bf16 residuals, as _bwd_cols_impl).
//   K7 v2 (bf16): exact f32 bias, g_so rounded to bf16, and dl carried as
//       hi + lo bf16 (_bwd_v2_bucket): the dq/dk products and the row and
//       column sums that cancel the common mode use the very same dl values.
//
// Design. At block_size 100 K1's one-CTA-per-bucket with a fixed 256-thread
// CTA leaves 156 threads idle; the TPU groups g buckets per grid step for
// the same reason. Here a CTA owns g = 256 / bs consecutive buckets (g * bs
// columns, one contiguous slice of n) with one thread per query (K6, K7's
// query half) or key (K7's key half) of one of them, and round_up(g*bs, 32)
// threads: 200 of 224 busy at bs 100. A ragged last CTA takes the buckets
// left. Shared rows are padded to a multiple of 4 floats so each shared load
// brings 4 operands (LDS.128); at d = 30, dv = 24 a bucket's keys and values
// take 22.8 KB, a CTA's 45.6 KB. K7 runs its two halves in one grid
// (blockIdx.z), each recomputing pt: no atomics, deterministic results.
//
// What bounds them on the H100: the pairwise work, r * nb * bs^2 * (2d +
// 2dv) flop for K6 (K7 ~2.5x), on scalar FP32 FMAs (f32 inputs must not use
// TF32 or bf16 tensor cores), so the least time is operations at the FP32
// peak (~67 TFLOP/s) for f32; for bf16 inputs the bound is the bytes (the
// bf16 tensor-core rate would allow ~16x the FP32 one). These are the simple
// first version: scalar FMAs with shared-memory operands, not wgmma.
//
// K10 (template argument ROWS) is K6 in f32 and K7 v1 on the ROW layout:
// (g * bs, d) rows, bucket b owning rows [b*bs, (b+1)*bs). It replaces
//   K10 hept_tpu/ops/bucket_attn_pallas.py:_fwd_kernel (:40) / _bwd_kernel
//       (:56), via _fwd_impl / _bwd_rule (pallas_call at :146 / :194),
// the kernel of hept_tpu/ops/bucket_attn.py:hept_attention_core, f32 only.
// Its math is K6's f32 forward and K7 v1's backward; the TPU pads the bucket
// to a multiple of 8 rows (a sublane rule) and masks the padded keys, while
// here any bs works unpadded. A CTA's g buckets are one contiguous run of
// g * bs * d floats, copied flat into the same padded shared rows; a thread
// reads its own query (or key) row with d-strided loads that the L1 serves,
// and writes its output row likewise. Bound at the parity shapes (14400
// buckets of 100, d 30, dv 24): operations at the FP32 peak, as K6 / K7.

constexpr int kColsThreads = 256;  // most threads (and columns) of a column CTA
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int pad4(int c) { return (c + 3) / 4 * 4; }

__host__ __device__ constexpr int cols_group(int bs) {
  return bs >= kColsThreads ? 1 : kColsThreads / bs;
}

// sum_e x[e] * s[e] in order e = 0..CP-1, four shared operands per load
template <int CP>
__device__ __forceinline__ float dot_row(const float (&x)[CP], const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < CP / 4; ++e) {
    const float4 w = s4[e];
    acc = fmaf(x[4 * e], w.x, acc);
    acc = fmaf(x[4 * e + 1], w.y, acc);
    acc = fmaf(x[4 * e + 2], w.z, acc);
    acc = fmaf(x[4 * e + 3], w.w, acc);
  }
  return acc;
}

// acc[e] += s[e] * a, four shared operands per load
template <int CP>
__device__ __forceinline__ void axpy_row(float (&acc)[CP], const float* s, float a) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int e = 0; e < CP / 4; ++e) {
    const float4 w = s4[e];
    acc[4 * e] = fmaf(w.x, a, acc[4 * e]);
    acc[4 * e + 1] = fmaf(w.y, a, acc[4 * e + 1]);
    acc[4 * e + 2] = fmaf(w.z, a, acc[4 * e + 2]);
    acc[4 * e + 3] = fmaf(w.w, a, acc[4 * e + 3]);
  }
}

// Offset of element e of point p in one row of a column block (ROWS false:
// C rows of n points, e * n + p) or of a row block (ROWS true: n points of C
// elements, p * C + e).
template <bool ROWS, int C>
__device__ __forceinline__ size_t at(size_t n, int e, size_t p) {
  return ROWS ? p * C + e : e * n + p;
}

// load_rows for either layout: points [base, base + count) of one row into
// shared rows dst[j*CP + e]. The row layout's points are one contiguous run
// of count * C values, copied flat.
template <int C, int CP, bool BF16, bool ROWS>
__device__ __forceinline__ void load_tile(const typename Io<BF16>::T* src, size_t n, size_t base,
                                          int count, float* dst) {
  if constexpr (ROWS) {
    const auto* s = src + base * C;
    for (int f = threadIdx.x; f < count * C; f += blockDim.x)
      dst[f / C * CP + f % C] = Io<BF16>::load(s + f);
    if constexpr (CP > C) {
      for (int j = threadIdx.x; j < count; j += blockDim.x) {
#pragma unroll
        for (int e = C; e < CP; ++e) dst[j * CP + e] = 0.f;
      }
    }
  } else {
    load_rows<C, CP, BF16>(src, n, base, count, dst);
  }
}

// x as hi + lo, two bf16 values (~2^-16 relative)
__device__ __forceinline__ float split_bf16(float x) {
  const float hi = round_bf16(x);
  return hi + round_bf16(x - hi);
}

// -|x|^2/2 of a shared row, summed in column order
template <int C>
__device__ __forceinline__ float half_sq(const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < C; ++e) acc = fmaf(row[e], row[e], acc);
  return -0.5f * acc;
}

template <int D, int DV, bool BF16, bool HILO, bool ROWS>
__global__ void __launch_bounds__(kColsThreads)
cols_fwd_kernel(const typename Io<BF16>::T* __restrict__ q,
                const typename Io<BF16>::T* __restrict__ k,
                const typename Io<BF16>::T* __restrict__ v, float* __restrict__ denom,
                float* __restrict__ so, int n, int bs) {
  constexpr int DP = pad4(D), DVP = pad4(DV);
  extern __shared__ float4 smem_cols[];
  const int g = cols_group(bs);
  const int b0 = blockIdx.x * g;
  const int span = min(g, n / bs - b0) * bs;  // this CTA's columns
  float* k_s = reinterpret_cast<float*>(smem_cols);  // [g*bs][DP]
  float* v_s = k_s + g * bs * DP;                     // [g*bs][DVP]
  float* kb_s = v_s + g * bs * DVP;                   // [g*bs]
  const size_t nn = n;
  const size_t r = blockIdx.y;
  const size_t base = (size_t)b0 * bs;
  load_tile<D, DP, BF16, ROWS>(k + r * D * nn, nn, base, span, k_s);
  load_tile<DV, DVP, BF16, ROWS>(v + r * DV * nn, nn, base, span, v_s);
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const float x_sq = half_sq<D>(k_s + j * DP);
    kb_s[j] = HILO ? split_bf16(x_sq) : x_sq;
  }
  __syncthreads();
  const auto* qr = q + r * D * nn;
  for (int c = threadIdx.x; c < span; c += blockDim.x) {
    const int b = c / bs * bs;  // the bucket's first column in the CTA
    float qi[DP];
    float qsq = 0.f;
#pragma unroll
    for (int e = 0; e < DP; ++e) {
      qi[e] = e < D ? Io<BF16>::load(qr + at<ROWS, D>(nn, e, base + c)) : 0.f;
      qsq = fmaf(qi[e], qi[e], qsq);
    }
    qsq *= -0.5f;
    const float qb = HILO ? split_bf16(qsq) : qsq;
    float acc[DVP];
#pragma unroll
    for (int e = 0; e < DVP; ++e) acc[e] = 0.f;
    float den = 0.f;
    for (int j = b; j < b + bs; ++j) {
      const float pt = expf(fminf(dot_row<DP>(qi, k_s + j * DP) + qb + kb_s[j], 0.f));
      den += pt;
      axpy_row<DVP>(acc, v_s + j * DVP, BF16 ? round_bf16(pt) : pt);
    }
    denom[r * nn + base + c] = den + kDenomEps;
#pragma unroll
    for (int e = 0; e < DV; ++e) so[r * DV * nn + at<ROWS, DV>(nn, e, base + c)] = acc[e];
  }
}

// V2: bf16 inputs and outputs, the v2 contract; otherwise f32 (v1).
template <int D, int DV, bool V2, bool ROWS>
__global__ void __launch_bounds__(kColsThreads)
cols_bwd_kernel(const typename Io<V2>::T* __restrict__ q, const typename Io<V2>::T* __restrict__ k,
                const typename Io<V2>::T* __restrict__ v, const float* __restrict__ gso,
                const float* __restrict__ gden, typename Io<V2>::T* __restrict__ dq,
                typename Io<V2>::T* __restrict__ dk, typename Io<V2>::T* __restrict__ dv,
                int n, int bs) {
  constexpr int DP = pad4(D), DVP = pad4(DV);
  extern __shared__ float4 smem_cols[];
  float* smem = reinterpret_cast<float*>(smem_cols);
  const int g = cols_group(bs);
  const int b0 = blockIdx.x * g;
  const int span = min(g, n / bs - b0) * bs;
  const int cap = g * bs;  // columns the shared layout is sized for
  const size_t nn = n;
  const size_t r = blockIdx.y;
  const size_t base = (size_t)b0 * bs;
  const auto* qr = q + r * D * nn;
  const auto* kr = k + r * D * nn;
  const auto* vr = v + r * DV * nn;
  const float* gr = gso + r * DV * nn;
  const float* gdr = gden + r * nn;

  if (blockIdx.z == 0) {
    // query side: thread per query i, loop over its bucket's keys -> dq
    float* k_s = smem;               // [cap][DP]
    float* v_s = k_s + cap * DP;     // [cap][DVP]
    float* ksq_s = v_s + cap * DVP;  // [cap]
    load_tile<D, DP, V2, ROWS>(kr, nn, base, span, k_s);
    load_tile<DV, DVP, V2, ROWS>(vr, nn, base, span, v_s);
    __syncthreads();
    for (int j = threadIdx.x; j < span; j += blockDim.x) ksq_s[j] = half_sq<D>(k_s + j * DP);
    __syncthreads();
    for (int c = threadIdx.x; c < span; c += blockDim.x) {
      const int b = c / bs * bs;
      float qi[DP], gi[DVP], acc[DP];
      float qsq = 0.f;
#pragma unroll
      for (int e = 0; e < DP; ++e) {
        qi[e] = e < D ? Io<V2>::load(qr + at<ROWS, D>(nn, e, base + c)) : 0.f;
        qsq = fmaf(qi[e], qi[e], qsq);
        acc[e] = 0.f;
      }
      qsq *= -0.5f;
#pragma unroll
      for (int e = 0; e < DVP; ++e) {
        const float gv = e < DV ? gr[at<ROWS, DV>(nn, e, base + c)] : 0.f;
        gi[e] = V2 ? round_bf16(gv) : gv;
      }
      const float gd = gdr[base + c];
      float rowsum = 0.f;
      for (int j = b; j < b + bs; ++j) {
        const float logit = dot_row<DP>(qi, k_s + j * DP) + qsq + ksq_s[j];
        const float pt = expf(fminf(logit, 0.f));
        const float gp = dot_row<DVP>(gi, v_s + j * DVP);
        float dl = logit < 0.f ? pt * (gp + gd) : 0.f;
        if (V2) dl = split_bf16(dl);
        axpy_row<DP>(acc, k_s + j * DP, dl);
        rowsum += dl;
      }
#pragma unroll
      for (int e = 0; e < D; ++e)
        dq[r * D * nn + at<ROWS, D>(nn, e, base + c)] = Io<V2>::store(acc[e] - rowsum * qi[e]);
    }
  } else {
    // key side: thread per key j, loop over its bucket's queries -> dk, dv
    float* q_s = smem;               // [cap][DP]
    float* g_s = q_s + cap * DP;     // [cap][DVP]
    float* qsq_s = g_s + cap * DVP;  // [cap]
    float* gd_s = qsq_s + cap;       // [cap]
    load_tile<D, DP, V2, ROWS>(qr, nn, base, span, q_s);
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
#pragma unroll
      for (int e = 0; e < DVP; ++e) {
        const float gv = e < DV ? gr[at<ROWS, DV>(nn, e, base + i)] : 0.f;
        g_s[i * DVP + e] = V2 ? round_bf16(gv) : gv;
      }
      gd_s[i] = gdr[base + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < span; i += blockDim.x) qsq_s[i] = half_sq<D>(q_s + i * DP);
    __syncthreads();
    for (int c = threadIdx.x; c < span; c += blockDim.x) {
      const int b = c / bs * bs;
      float kj[DP], vj[DVP], acck[DP], accv[DVP];
      float ksq = 0.f;
#pragma unroll
      for (int e = 0; e < DP; ++e) {
        kj[e] = e < D ? Io<V2>::load(kr + at<ROWS, D>(nn, e, base + c)) : 0.f;
        ksq = fmaf(kj[e], kj[e], ksq);
        acck[e] = 0.f;
      }
      ksq *= -0.5f;
#pragma unroll
      for (int e = 0; e < DVP; ++e) {
        vj[e] = e < DV ? Io<V2>::load(vr + at<ROWS, DV>(nn, e, base + c)) : 0.f;
        accv[e] = 0.f;
      }
      float colsum = 0.f;
      for (int i = b; i < b + bs; ++i) {
        // the query side's products in the same order: identical pt and dl
        const float logit = dot_row<DP>(kj, q_s + i * DP) + qsq_s[i] + ksq;
        const float pt = expf(fminf(logit, 0.f));
        const float gp = dot_row<DVP>(vj, g_s + i * DVP);
        float dl = logit < 0.f ? pt * (gp + gd_s[i]) : 0.f;
        if (V2) dl = split_bf16(dl);
        axpy_row<DP>(acck, q_s + i * DP, dl);
        colsum += dl;
        axpy_row<DVP>(accv, g_s + i * DVP, V2 ? round_bf16(pt) : pt);
      }
#pragma unroll
      for (int e = 0; e < D; ++e)
        dk[r * D * nn + at<ROWS, D>(nn, e, base + c)] = Io<V2>::store(acck[e] - colsum * kj[e]);
#pragma unroll
      for (int e = 0; e < DV; ++e)
        dv[r * DV * nn + at<ROWS, DV>(nn, e, base + c)] = Io<V2>::store(accv[e]);
    }
  }
}

// grid, threads and shared bytes of a column kernel; false if the shared
// rows of one CTA do not fit
inline bool cols_launch_shape(int r, int n, int bs, int shared_cols, dim3* grid, int* threads,
                              size_t* smem) {
  const int g = cols_group(bs);
  const int nb = n / bs;
  *grid = dim3((nb + g - 1) / g, r);
  *threads = std::min(kColsThreads, (g * bs + 31) / 32 * 32);
  *smem = (size_t)g * bs * shared_cols * sizeof(float);
  return *smem <= kMaxSmem;
}

template <int D, int DV, bool BF16, bool HILO, bool ROWS = false>
int launch_cols_fwd(const void* q, const void* k, const void* v, float* denom, float* so, int r,
                    int n, int bs, cudaStream_t stream) {
  using T = typename Io<BF16>::T;
  dim3 grid;
  int threads;
  size_t smem;
  if (!cols_launch_shape(r, n, bs, pad4(D) + pad4(DV) + 1, &grid, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cols_fwd_kernel<D, DV, BF16, HILO, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cols_fwd_kernel<D, DV, BF16, HILO, ROWS><<<grid, threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, denom, so, n, bs);
  return (int)cudaGetLastError();
}

template <int D, int DV, bool V2, bool ROWS = false>
int launch_cols_bwd(const void* q, const void* k, const void* v, const float* gso,
                    const float* gden, void* dq, void* dk, void* dv, int r, int n, int bs,
                    cudaStream_t stream) {
  using T = typename Io<V2>::T;
  dim3 grid;
  int threads;
  size_t smem;
  if (!cols_launch_shape(r, n, bs, pad4(D) + pad4(DV) + 2, &grid, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cols_bwd_kernel<D, DV, V2, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grid.z = 2;
  cols_bwd_kernel<D, DV, V2, ROWS><<<grid, threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, gso, gden, (T*)dq, (T*)dk, (T*)dv, n, bs);
  return (int)cudaGetLastError();
}

}  // namespace

// (d, dv) pairs compiled; ops/bucket_attn_cuda.py SUPPORTED_DIMS lists the same.
#define HEPT_DIMS(X) X(30, 24) X(7, 5)

extern "C" int hept_bucket_attn_fwd(const void* q, const void* k, const void* v, float* denom,
                                    float* so, int r, int d, int dv, int n, int bs, int bf16,
                                    void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_FWD_CASE(D_, DV_)                                                       \
  if (d == D_ && dv == DV_)                                                          \
    return bf16 ? launch_fwd<D_, DV_, true>(q, k, v, denom, so, r, n, bs, s)         \
                : launch_fwd<D_, DV_, false>(q, k, v, denom, so, r, n, bs, s);
  HEPT_DIMS(HEPT_FWD_CASE)
#undef HEPT_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int hept_bucket_attn_bwd(const void* q, const void* k, const void* v,
                                    const float* gso, const float* gden, void* dq, void* dk,
                                    void* dv_out, int r, int d, int dv, int n, int bs, int bf16,
                                    void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_BWD_CASE(D_, DV_)                                                                \
  if (d == D_ && dv == DV_)                                                                   \
    return bf16 ? launch_bwd<D_, DV_, true>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs, s)  \
                : launch_bwd<D_, DV_, false>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs, s);
  HEPT_DIMS(HEPT_BWD_CASE)
#undef HEPT_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int hept_cols_fwd(const void* q, const void* k, const void* v, float* denom, float* so,
                             int r, int d, int dv, int n, int bs, int bf16, int hilo,
                             void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_COLS_FWD_CASE(D_, DV_)                                                        \
  if (d == D_ && dv == DV_) {                                                              \
    if (!bf16) return launch_cols_fwd<D_, DV_, false, false>(q, k, v, denom, so, r, n, bs, s); \
    return hilo ? launch_cols_fwd<D_, DV_, true, true>(q, k, v, denom, so, r, n, bs, s)      \
                : launch_cols_fwd<D_, DV_, true, false>(q, k, v, denom, so, r, n, bs, s);    \
  }
  HEPT_DIMS(HEPT_COLS_FWD_CASE)
#undef HEPT_COLS_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// v2 = 1: bf16 inputs and outputs (the v2 contract); 0: f32 (v1)
extern "C" int hept_cols_bwd(const void* q, const void* k, const void* v, const float* gso,
                             const float* gden, void* dq, void* dk, void* dv_out, int r, int d,
                             int dv, int n, int bs, int v2, void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_COLS_BWD_CASE(D_, DV_)                                                          \
  if (d == D_ && dv == DV_)                                                                  \
    return v2 ? launch_cols_bwd<D_, DV_, true>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs, s) \
              : launch_cols_bwd<D_, DV_, false>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs, s);
  HEPT_DIMS(HEPT_COLS_BWD_CASE)
#undef HEPT_COLS_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// K10: the row layout, f32. q, k (n, d), v (n, dv) rows, n = g * bs.
extern "C" int hept_rows_fwd(const void* q, const void* k, const void* v, float* denom, float* so,
                             int d, int dv, int n, int bs, void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_ROWS_FWD_CASE(D_, DV_) \
  if (d == D_ && dv == DV_)         \
    return launch_cols_fwd<D_, DV_, false, false, true>(q, k, v, denom, so, 1, n, bs, s);
  HEPT_DIMS(HEPT_ROWS_FWD_CASE)
#undef HEPT_ROWS_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int hept_rows_bwd(const void* q, const void* k, const void* v, const float* gso,
                             const float* gden, void* dq, void* dk, void* dv_out, int d, int dv,
                             int n, int bs, void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_ROWS_BWD_CASE(D_, DV_) \
  if (d == D_ && dv == DV_)         \
    return launch_cols_bwd<D_, DV_, false, true>(q, k, v, gso, gden, dq, dk, dv_out, 1, n, bs, s);
  HEPT_DIMS(HEPT_ROWS_BWD_CASE)
#undef HEPT_ROWS_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hept_bucket_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
