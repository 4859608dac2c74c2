// Per-bucket RBF attention, forward (K1) and backward (K2), for Hopper.
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

// Copy one bucket's (C, bs) column block into shared rows dst[j*C + e].
// Reads coalesce along n.
template <int C, bool BF16>
__device__ __forceinline__ void load_rows(const typename Io<BF16>::T* src, size_t n,
                                          size_t base, int bs, float* dst) {
  for (int j = threadIdx.x; j < bs; j += kThreads) {
#pragma unroll
    for (int e = 0; e < C; ++e) dst[j * C + e] = Io<BF16>::load(src + e * n + base + j);
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
  load_rows<D, BF16>(k + r * D * nn, nn, base, bs, k_s);
  load_rows<DV, BF16>(v + r * DV * nn, nn, base, bs, v_s);
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
    load_rows<D, BF16>(kr, nn, base, bs, k_s);
    load_rows<DV, BF16>(vr, nn, base, bs, v_s);
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
    load_rows<D, BF16>(qr, nn, base, bs, q_s);
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

extern "C" const char* hept_bucket_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
