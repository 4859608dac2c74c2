// Per-bucket RBF attention for Hopper: forward K1 / backward K2 (the
// hept_acc step's bucket kernels, bs 512), forward K6 / backward K7 (several
// small buckets per CTA; their own notes below), and K10, the same kernels
// on the row layout.
//
// K1 / K2 replace the TPU's flat-slab Pallas kernels
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
// Two routes, chosen by the wrapper from dtype and bucket size before launch:
//  * tensor cores (tc_fwd_kernel / tc_bwd_kernel): bf16 inputs, bs % 16 == 0,
//    every shape of the hept_acc step and its eval. The TPU's contract
//    literally: logits and products from bf16 mma.sync m16n8k16 with f32
//    accumulation, both norm biases added in f32 (never folded into the mma
//    as bf16 columns: a per-bucket common mode of ~40 would be off by O(10)),
//    pt rounded to bf16 for the value product and summed in f32 for denom;
//    K2 rounds g_so to bf16, splits dlt into hi + lo bf16 and forms dq / dk
//    with the ones-augmented K~ = [k, 1, 0] / Q~ = [q, 1, 0], so column d of
//    the product is the row (column) sum that cancels the common mode, taken
//    from the same hi / lo values as the products.
//  * scalar (fwd_kernel / bwd_kernel): f32 inputs, which must not use TF32
//    (the reference asks for HIGHEST), and bf16 at a bs that is no multiple
//    of 16. One CTA per (row, bucket), operands staged in shared memory as
//    f32, one thread per query (or key) looping over the bucket with scalar
//    FMAs; bf16 dlt accumulated in f32 directly.
//
// What bounds K1 / K2 on the H100, per launch at the main path's shapes
// (r=16, d=30, dv=24, n=60416, bs=512: r*n*bs ~ 4.95e8 logits): the bytes,
// ~0.26 GB in and out (K1 ~77 us, K2 ~140 us of HBM), and the tensor-core
// term (~54 us K1, ~0.2-0.3 ms K2 with its hi / lo and augmented products)
// are below what every logit costs outside the tensor cores: one ex2 on the
// SFU (16 a clock per SM: ~0.12 ms a pass over the logits) and 5-11 more
// instructions (bias, clamp, scale, the denominator or dl, the bf16 packs);
// K2 makes two passes. So the design keeps the per-logit work short and in
// registers: a CTA per (row, bucket) (K2: and half) stages the bucket's
// other side once in shared memory as bf16 point-major rows (a 16-byte load
// per column pair and 8 points, 32-bit stores of column pairs, row strides
// of 4 words modulo 8 so the 8 rows a warp reads at once hit distinct
// banks); 8 warps take 16-point tiles of their own side (K1 two at a time,
// sharing every B fragment) with the A fragments in registers, and walk the
// bucket in chunks of 16 points: S (and K2's GP) on the tensor cores from
// accumulators that start at the f32 bias sum (and g_den), the per-logit
// work on the accumulator registers, and the results repacked as the A
// operand of the next product (ldmatrix.trans reads the point-major tile as
// the B operand where the contraction runs over points). exp is ex2.approx
// of a log2(e)-scaled argument; no running max is needed, the clamp keeps
// every pt <= 1. dl's hi half comes from one packed conversion per pair,
// unpacked by shifts. K2 keeps the two recomputing halves of the scalar
// design (blockIdx.z: dk, dv by keys; dq by queries): no atomics,
// deterministic. Outputs are stored from the accumulators: a warp's store
// fills whole 32-byte sectors (8 points of one column). Measured on the
// H100 (PERF.md): one CTA per bucket beats 2 or 4 (each restages the
// bucket), and K2 is bound by none of the SFU, the conversions or the
// tensor cores alone: removing any one of them saves little.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

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
// bf16 tensor-core rate would allow ~16x the FP32 one). The kernels here are
// the simple first versions. K6 and K7 each have two faster routes below,
// chosen by the wrapper before launch (cols_fwd_route, cols_bwd_route): K6
// on bf16 and K7 v2 at bs % 4 == 0 run K1's and K2's tensor-core scheme on
// buckets padded to 16 points (tc_cols_fwd_kernel, tc_cols_bwd_kernel), and
// f32 (K6, K7 v1) at bs <= 100 runs one pass per bucket on FP32 FMAs
// (cols_fwd_tiled_kernel, cols_bwd_tiled_kernel). cols_fwd_kernel and
// cols_bwd_kernel here stay for the other bucket sizes, on either layout.
//
// K10 (template argument ROWS) is K6 in f32 and K7 v1 on the ROW layout:
// (g * bs, d) rows, bucket b owning rows [b*bs, (b+1)*bs). It replaces
//   K10 hept_tpu/ops/bucket_attn_pallas.py:_fwd_kernel (:40) / _bwd_kernel
//       (:56), via _fwd_impl / _bwd_rule (pallas_call at :146 / :194),
// the kernel of hept_tpu/ops/bucket_attn.py:hept_attention_core, f32 only.
// Its math is K6's f32 forward and K7 v1's backward; the TPU pads the bucket
// to a multiple of 8 rows (a sublane rule) and masks the padded keys, while
// here any bs works unpadded. Two routes, picked by the wrapper before
// launch (rows_fwd_route, rows_bwd_route): the tiled kernels below with
// ROWS true (forward at bs % 4 == 0 up to 100, backward up to 100: the
// parity width's 14400 buckets of 100), and the first-cut kernels here for
// every other bs. On rows a bucket's q, k, v (and g_so, g_den) are
// contiguous runs, staged by cp.async in V-float pieces (V the widest of 4,
// 2, 1 dividing the row: 8 bytes at d = 30, 16 at dv = 24) into the same
// padded point-major shared rows as the columns; the tiled forward reads a
// thread's two query rows by 8-byte loads that the L1 serves and stores its
// so rows by 16-byte ones; the tiled backward stores a unit's 6 columns of
// a point as three 8-byte pieces of its row. The forward's arithmetic is
// K6 f32's own (its bits on the transposed operands). The backward's adds
// the norm biases after the dot, as the forward and the plain version do,
// where K7 v1 starts each logit from them: on the parity core's operands
// (|q|^2/2 up to ~500) K7 v1's order lands 2-4x further from a float64 run
// and trips the core's 1e-4 x scale gradient check (PERF.md §6). The
// first cut copies a CTA's run flat and reads and writes rows with
// d-strided loads. Bound at the parity shapes: operations at the FP32
// peak, as K6 / K7.

constexpr int kColsThreads = 256;  // most threads (and columns) of a column CTA
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int pad4(int c) { return (c + 3) / 4 * 4; }

// A shared row stride for rows of at least w floats, padded to 4 words
// modulo 8: 8 rows read as float4s at once (a quarter warp) fall in distinct
// banks, and so do 2 rows read at once by broadcast. pad4(w) + 4 is that at
// w = 30 (36) and 24 (28), but 32 at w = 28: every row in one bank.
__host__ __device__ constexpr int stride_4mod8(int w) {
  return pad4(w) % 8 == 4 ? pad4(w) : pad4(w) + 4;
}

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


// ---------------------------------------------------------------------------
// K1 / K2 on the tensor cores: the route for bf16 inputs with bs % 16 == 0
// (every shape the hept_acc step and its eval launch). Notes in the header.

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Widths of the shared tiles. DK: the depth of S = Q.K^T, with room for the
// ones column D of K2's augmented operands; DVK: the depth of GP = G.V^T;
// DVN: the so / dv output columns (n8 tiles), also the width of K2's value
// and cotangent tiles (GP's B fragments past it are zero). Point-major tiles
// are rows of RS (RSV) bf16, a stride of 4 words modulo 8 (8 more than the
// width where needed), so the 8 rows a warp reads at once fall in distinct
// banks.
template <int D, int DV>
struct TcDims {
  static constexpr int DK = round_up(D + 1, 16);
  static constexpr int DVK = round_up(DV, 16);
  static constexpr int DVN = round_up(DV, 8);
  static constexpr int RS = DK + 8;
  static constexpr int RSV = DVN % 16 == 8 ? DVN : DVN + 8;
  // K1: keys [bs][RS], values [DVN][bs + 8], key norms [bs]
  static size_t fwd_smem(int bs) {
    return (size_t)bs * RS * 2 + (size_t)DVN * (bs + 8) * 2 + (size_t)bs * 4;
  }
  // K2: keys [bs][RS] + values [bs][RSV] + norms (query half), or queries +
  // cotangents + norms + g_den (key half), whichever is larger
  static size_t bwd_smem(int bs) { return (size_t)bs * (RS + RSV) * 2 + (size_t)bs * 8; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// exp(x) on the SFU: ex2 of x log2(e)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// exp(min(x, 0))
__device__ __forceinline__ float exp_clamped(float x) { return exp_sfu(fminf(x, 0.f)); }

// c += a.b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b over a depth of 8: a (16 x 8) in two registers, b (8 x 8) in one
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void load8f(const bf16* p, float (&v)[8]) {
  uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    v[2 * u] = f.x;
    v[2 * u + 1] = f.y;
  }
}

__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load4f(const bf16* p, float (&v)[4]) {
  uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    v[2 * u] = f.x;
    v[2 * u + 1] = f.y;
  }
}

__device__ __forceinline__ void load4f(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ float load1f(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float load1f(const float* p) { return __ldg(p); }

// Points [base, base + count) of a (C, n) column block into point-major
// shared rows dst[p * RS + e], bf16 (f32 sources rounded), e < W: columns C
// and up zero, or column C one when ONES. A lane takes a column pair of 8
// points (two 16-byte loads), so each 32-bit shared store holds (e, e + 1)
// of one point.
template <int C, int W, int RS, bool ONES, typename T>
__device__ __forceinline__ void stage_rows(const T* src, size_t n, size_t base, int count,
                                           bf16* dst) {
  constexpr int kPairs = W / 2;
  const int chunks = count / 8;
  // unrolled so that several iterations' loads are in flight at once
#pragma unroll 4
  for (int w = threadIdx.x; w < kPairs * chunks; w += blockDim.x) {
    const int e = 2 * (w % kPairs), c = w / kPairs;
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (e + h < C) {
        load8f(src + (size_t)(e + h) * n + base + c * 8, v[h]);
      } else {
        const float f = ONES && e + h == C ? 1.f : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) v[h][u] = f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      *reinterpret_cast<uint32_t*>(dst + (c * 8 + u) * RS + e) = pack_bf16(v[0][u], v[1][u]);
  }
}

// stage_rows for nbk consecutive buckets of bs points (bs % 4 == 0), each
// into its own bsp = round_up(bs, 16) shared rows, rows bs..bsp-1 zero. A
// lane takes a column pair of 4 points: 8-byte loads of bf16 (a bucket
// starts at 2 * bs * b bytes, 8-byte aligned) and 16-byte loads of f32.
template <int C, int W, int RS, bool ONES, typename T>
__device__ __forceinline__ void stage_rows_padded(const T* src, size_t n, size_t base, int bs,
                                                  int bsp, int nbk, bf16* dst) {
  constexpr int kPairs = W / 2;
  const int chunks = bsp / 4;  // of one padded bucket
#pragma unroll 4
  for (int w = threadIdx.x; w < kPairs * chunks * nbk; w += blockDim.x) {
    const int e = 2 * (w % kPairs), cc = w / kPairs;
    const int kb = cc / chunks, p = (cc % chunks) * 4;  // bucket, point in it
    float v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (e + h < C && p < bs) {
        load4f(src + (size_t)(e + h) * n + base + (size_t)kb * bs + p, v[h]);
      } else {
        const float f = ONES && e + h == C && p < bs ? 1.f : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) v[h][u] = f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<uint32_t*>(dst + (kb * bsp + p + u) * RS + e) = pack_bf16(v[0][u], v[1][u]);
  }
}

// -|x|^2/2 of the first C columns of a shared bf16 row, summed in order
template <int C>
__device__ __forceinline__ float half_sq_bf16(const bf16* row) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < C; ++e) {
    const float x = __bfloat162float(row[e]);
    acc = fmaf(x, x, acc);
  }
  return -0.5f * acc;
}

// The A fragments (16 points x 16 columns per k-step, KS k-steps) of points
// p0..p0+15 of a (C, n) column block, read from global memory: lane (g, t)
// holds rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9 of each
// k-step, columns C and up zero. f keeps the values as floats (bf16-valued)
// in the order of the registers: per k-step (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1), then the same at columns + 8. So f[nt / 2][(nt % 2) * 4 + j]
// is the value at accumulator position j of the n8 tile nt.
// GUARD: rows rows..15 of the tile are padding (past the bucket's end) and
// read as zero.
template <int C, int KS, bool GUARD = false, typename T>
__device__ __forceinline__ void load_a(const T* src, size_t n, size_t p0, int lane,
                                       uint32_t (&a)[KS][4], float (&f)[KS][8], int rows = 16) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = ks * 16 + (i >= 4 ? 8 : 0) + 2 * t + (i & 1);
      const int row = g + ((i >> 1) & 1) * 8;
      const size_t p = p0 + g + ((i >> 1) & 1) * 8;
      f[ks][i] = e < C && (!GUARD || row < rows)
                     ? __bfloat162float(__float2bfloat16_rn(load1f(src + (size_t)e * n + p)))
                     : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) a[ks][j] = pack_bf16(f[ks][2 * j], f[ks][2 * j + 1]);
  }
}

// -|x|^2/2 of rows g (first) and g + 8 (second) of an A fragment set
template <int KS>
__device__ __forceinline__ float2 half_sq_rows(const float (&f)[KS][8]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i >> 1) & 1) s1 = fmaf(f[ks][i], f[ks][i], s1);
      else s0 = fmaf(f[ks][i], f[ks][i], s0);
    }
  }
  return make_float2(-0.5f * quad_sum(s0), -0.5f * quad_sum(s1));
}

// acc[nt] += a[h] . B for every h, where B (16 points x NT*8 columns) is
// points p0..p0+15 of a point-major shared tile with row stride RS, read
// transposed by ldmatrix: the contraction runs over the points.
template <int NT, int RS, int NA>
__device__ __forceinline__ void mma_points(float (&acc)[NT][4], const uint32_t (&a)[NA][4],
                                           const bf16* tile, int p0, int lane) {
  const bf16* row = tile + (p0 + (lane & 15)) * RS;
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, row + nt * 8 + (lane >> 4) * 8);
#pragma unroll
    for (int h = 0; h < NA; ++h) {
      mma_bf16(acc[nt], a[h], b[0], b[1]);
      mma_bf16(acc[nt + 1], a[h], b[2], b[3]);
    }
  }
  if constexpr (NT % 2 == 1) {
    uint32_t b[2];
    ldsm_x2_trans(b, row + (NT - 1) * 8);
#pragma unroll
    for (int h = 0; h < NA; ++h) mma_bf16(acc[NT - 1], a[h], b[0], b[1]);
  }
}

// s[m][nt] += a[m] . B^T for the two n8 tiles of points p0..p0+15 of a
// point-major shared tile (row stride RS, W columns), for M row tiles a[m]
// at once: the contraction runs over the columns. One ldmatrix brings an n8
// tile's B fragments for both k-steps (8-column blocks past W repeat the
// last one and go unused); a last k-step with only 8 columns below W is one
// m16n8k8.
template <int KS, int RS, int M, int W = KS * 16>
__device__ __forceinline__ void mma_cols(float (&s)[M][2][4], const uint32_t (&a)[M][KS][4],
                                         const bf16* tile, int p0, int lane) {
  static_assert(KS <= 2 && W <= KS * 16 && W % 8 == 0, "one ldmatrix.x4 per n8 tile");
  const bf16* src = tile + (p0 + (lane & 7)) * RS + min(lane >> 3, W / 8 - 1) * 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    uint32_t b[4];
    ldsm_x4(b, src + nt * 8 * RS);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (ks * 16 + 8 < W) mma_bf16(s[m][nt], a[m][ks], b[2 * ks], b[2 * ks + 1]);
        else mma_bf16_k8(s[m][nt], a[m][ks][0], a[m][ks][1], b[2 * ks]);
      }
    }
  }
}

// x as the one row tile of mma_cols's M-tile arguments
template <typename T>
__device__ __forceinline__ auto tile1(T& x) -> T (&)[1] {
  return *reinterpret_cast<T(*)[1]>(&x);
}

// K1. A CTA per (row, bucket) stages the bucket's keys and values once;
// each warp then takes TPW 16-query tiles at a time and walks the keys in
// chunks of 16.
template <int D, int DV, int TPW>
__global__ void __launch_bounds__(kTcThreads, 2)
tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, float* __restrict__ denom, float* __restrict__ so,
              int n, int bs) {
  using Dm = TcDims<D, DV>;
  constexpr int KS = Dm::DK / 16, VT = Dm::DVN / 8;
  extern __shared__ uint4 smem_tc[];
  const int vstr = bs + 8;
  bf16* k_s = reinterpret_cast<bf16*>(smem_tc);                  // [bs][RS]
  bf16* v_s = k_s + bs * Dm::RS;                                  // [DVN][bs + 8]
  float* ksq_s = reinterpret_cast<float*>(v_s + Dm::DVN * vstr);  // [bs]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t nn = n, r = blockIdx.y, base = (size_t)blockIdx.x * bs;
  stage_rows<D, Dm::DK, Dm::RS, false>(k + r * D * nn, nn, base, bs, k_s);
  // values as they lie: DVN rows of bs contiguous points, 16-byte copies
  const bf16* vr = v + r * DV * nn + base;
  for (int i = threadIdx.x; i < Dm::DVN * (bs / 8); i += blockDim.x) {
    const int e = i / (bs / 8), c = i % (bs / 8);
    const uint4 z = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(v_s + e * vstr + c * 8) =
        e < DV ? __ldg(reinterpret_cast<const uint4*>(vr + (size_t)e * nn + c * 8)) : z;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < bs; j += blockDim.x) ksq_s[j] = half_sq_bf16<D>(k_s + j * Dm::RS);
  __syncthreads();

  for (int grp = warp; grp < bs / (16 * TPW); grp += kTcWarps) {
    const size_t p0 = base + grp * 16 * TPW;  // this warp's TPW x 16 queries
    uint32_t qa[TPW][KS][4];
    float2 qsq[TPW];
#pragma unroll
    for (int m = 0; m < TPW; ++m) {
      float qf[KS][8];
      load_a<D, KS>(q + r * D * nn, nn, p0 + 16 * m, lane, qa[m], qf);
      qsq[m] = half_sq_rows<KS>(qf);
    }
    float acc[TPW][VT][4] = {};
    float den[TPW][2] = {};
#pragma unroll 2
    for (int kc = 0; kc < bs; kc += 16) {
      // the logits start from their f32 bias sum; the mma adds q.k
      float s[TPW][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 kb = *reinterpret_cast<const float2*>(ksq_s + kc + nt * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < TPW; ++m) {
          s[m][nt][0] = qsq[m].x + kb.x;
          s[m][nt][1] = qsq[m].x + kb.y;
          s[m][nt][2] = qsq[m].y + kb.x;
          s[m][nt][3] = qsq[m].y + kb.y;
        }
      }
      mma_cols<KS, Dm::RS, TPW>(s, qa, k_s, kc, lane);
      uint32_t pa[TPW][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int m = 0; m < TPW; ++m) {
          const float p00 = exp_clamped(s[m][nt][0]);
          const float p01 = exp_clamped(s[m][nt][1]);
          const float p10 = exp_clamped(s[m][nt][2]);
          const float p11 = exp_clamped(s[m][nt][3]);
          den[m][0] += p00 + p01;
          den[m][1] += p10 + p11;
          pa[m][2 * nt] = pack_bf16(p00, p01);
          pa[m][2 * nt + 1] = pack_bf16(p10, p11);
        }
      }
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) {
        const bf16* row = v_s + (vt * 8 + g) * vstr + kc + 2 * t;
        const uint32_t b0 = ld32(row), b1 = ld32(row + 8);
#pragma unroll
        for (int m = 0; m < TPW; ++m) mma_bf16(acc[m][vt], pa[m], b0, b1);
      }
    }
#pragma unroll
    for (int m = 0; m < TPW; ++m) {
      const size_t pm = p0 + 16 * m;
      const float d0 = quad_sum(den[m][0]), d1 = quad_sum(den[m][1]);
      if (t == 0) {
        denom[r * nn + pm + g] = d0 + kDenomEps;
        denom[r * nn + pm + g + 8] = d1 + kDenomEps;
      }
      // a 32-byte sector holds 8 queries of one column: each store fills whole ones
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = vt * 8 + 2 * t + j;
          if (e < DV) {
            so[(r * DV + e) * nn + pm + g] = acc[m][vt][j];
            so[(r * DV + e) * nn + pm + g + 8] = acc[m][vt][2 + j];
          }
        }
      }
    }
  }
}

// One half of K2. KEYS false: dq, warps by queries over the bucket's keys
// K~ = [k, 1, 0] and values; KEYS true: dk and dv, warps by keys over its
// queries Q~ = [q, 1, 0], bf16(g_so) and g_den. Column D is 1 in the staged
// augmented tile and 0 in the register operands, so S is untouched and
// column D of the dq / dk product is the row (column) sum of the very same
// bf16 hi / lo values. A warp takes one 16-point tile at a time.
//
// MASKED (K7 v2): the CTA takes nbk = min(g, buckets left) buckets of any bs
// with bs % 4 == 0, each padded to bsp = round_up(bs, 16) points in shared
// memory and in its tiles. A padded point of the other side has zero rows
// and the norm kPadBias, so its logit is ~kPadBias whatever the mma adds:
// pt = 0 and dl = 0 (its hi / lo parts and its share of the augmented sums
// too), and it adds nothing to dq, dk or dv. The bias is finite: -inf plus a
// finite sum would be safe, but an inf - inf would not. A padded point of a
// warp's own tile reads as zero, is never read past the bucket (or past n),
// and is not stored.
constexpr float kPadBias = -1e30f;

template <int D, int DV, bool KEYS, bool MASKED = false>
__device__ __forceinline__ void tc_bwd_half(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const float* __restrict__ gso,
                                            const float* __restrict__ gden, bf16* __restrict__ dx,
                                            bf16* __restrict__ dv, int n, int bs, bf16* a_s,
                                            int g_buckets = 1) {
  using Dm = TcDims<D, DV>;
  constexpr int KS = Dm::DK / 16, VKS = Dm::DVK / 16;
  constexpr int NTD = Dm::DK / 8, NTV = Dm::DVN / 8;
  // where column D sits in an accumulator set
  constexpr int kSumTile = D / 8, kSumLane = (D % 8) / 2, kSumReg = D % 2;
  const int bsp = MASKED ? round_up(bs, 16) : bs;                  // a bucket's shared rows
  const int nbk = MASKED ? min(g_buckets, n / bs - (int)blockIdx.x * g_buckets) : 1;
  const int rows = nbk * bsp;
  bf16* b_s = a_s + rows * Dm::RS;                                // [rows][RSV]
  float* sq_s = reinterpret_cast<float*>(b_s + rows * Dm::RSV);  // [rows] norms
  float* gd_s = sq_s + rows;                                     // [rows] g_den (KEYS)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t nn = n, r = blockIdx.y;
  const size_t base = (size_t)blockIdx.x * (MASKED ? g_buckets : 1) * bs;
  const bf16* qr = q + r * D * nn;
  const bf16* kr = k + r * D * nn;
  const bf16* vr = v + r * DV * nn;
  const float* gr = gso + r * DV * nn;
  const float* gdr = gden + r * nn;
  const bf16* xr = KEYS ? kr : qr;  // this half's own points
  if constexpr (MASKED) {
    stage_rows_padded<D, Dm::DK, Dm::RS, true>(KEYS ? qr : kr, nn, base, bs, bsp, nbk, a_s);
    if constexpr (KEYS) stage_rows_padded<DV, Dm::DVN, Dm::RSV, false>(gr, nn, base, bs, bsp, nbk, b_s);
    else stage_rows_padded<DV, Dm::DVN, Dm::RSV, false>(vr, nn, base, bs, bsp, nbk, b_s);
    if constexpr (KEYS) {
      for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        const int kb = i / bsp, p = i % bsp;
        gd_s[i] = p < bs ? gdr[base + (size_t)kb * bs + p] : 0.f;
      }
    }
  } else if constexpr (KEYS) {
    stage_rows<D, Dm::DK, Dm::RS, true>(qr, nn, base, bs, a_s);
    stage_rows<DV, Dm::DVN, Dm::RSV, false>(gr, nn, base, bs, b_s);
    for (int i = threadIdx.x; i < bs; i += blockDim.x) gd_s[i] = gdr[base + i];
  } else {
    stage_rows<D, Dm::DK, Dm::RS, true>(kr, nn, base, bs, a_s);
    stage_rows<DV, Dm::DVN, Dm::RSV, false>(vr, nn, base, bs, b_s);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    sq_s[j] = !MASKED || j % bsp < bs ? half_sq_bf16<D>(a_s + j * Dm::RS) : kPadBias;
  __syncthreads();

  const int tpb = bsp / 16;  // tiles of one bucket
  const int nwarps = MASKED ? (int)(blockDim.x >> 5) : kTcWarps;
  for (int grp = warp; grp < nbk * tpb; grp += nwarps) {
    // this warp's 16 points as A operands: x (q, or k) for S, y (bf16
    // g_so, or v) for GP; c0 is its bucket's first shared row
    const int kb = MASKED ? grp / tpb : 0, tile = MASKED ? grp % tpb : grp;
    const int c0 = kb * bsp;
    const int own = bs - tile * 16;  // points of the tile inside the bucket (MASKED)
    const size_t p0 = base + (size_t)kb * bs + tile * 16;
    uint32_t xa[KS][4], ya[VKS][4];
    float xf[KS][8], yf[VKS][8];
    load_a<D, KS, MASKED>(xr, nn, p0, lane, xa, xf, own);
    if constexpr (KEYS) load_a<DV, VKS, MASKED>(vr, nn, p0, lane, ya, yf, own);
    else load_a<DV, VKS, MASKED>(gr, nn, p0, lane, ya, yf, own);
    const float2 xsq = half_sq_rows<KS>(xf);
    const float2 gd_own = KEYS ? make_float2(0.f, 0.f)
                               : make_float2(!MASKED || g < own ? gdr[p0 + g] : 0.f,
                                             !MASKED || g + 8 < own ? gdr[p0 + g + 8] : 0.f);
    float acc[NTD][4] = {};              // dq~ or dk~
    float accv[KEYS ? NTV : 1][4] = {};  // dv (KEYS)

    // S and GP of a 16-point chunk: the logits start from their f32 bias sum
    // and gp from g_den; the mma adds q.k and v.g_so
    auto products = [&](int c, float (&s)[2][4], float (&gp)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 ob = *reinterpret_cast<const float2*>(sq_s + c + nt * 8 + 2 * t);
        float2 og = make_float2(0.f, 0.f);
        if constexpr (KEYS) og = *reinterpret_cast<const float2*>(gd_s + c + nt * 8 + 2 * t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[nt][j] = (j < 2 ? xsq.x : xsq.y) + (j & 1 ? ob.y : ob.x);  // row + column
          gp[nt][j] = KEYS ? (j & 1 ? og.y : og.x) : (j < 2 ? gd_own.x : gd_own.y);
        }
      }
      mma_cols<KS, Dm::RS, 1>(tile1(s), tile1(xa), a_s, c, lane);
      mma_cols<VKS, Dm::RSV, 1, Dm::DVN>(tile1(gp), tile1(ya), b_s, c, lane);
    };
    // dl of the chunk, then dq~ += (hi + lo) . K~ over its keys, or dk~ +=
    // (hi + lo)^T . Q~ and dv += bf16(pt)^T . G over its queries
    auto gradients = [&](int c, const float (&s)[2][4], const float (&gp)[2][4]) {
      uint32_t hl[2][4], pa[1][4];  // dl as bf16 hi and lo; bf16(pt) (KEYS)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float dl[4], pt[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // dq needs pt only where the logit is < 0: no clamp there
          pt[j] = KEYS ? exp_clamped(s[nt][j]) : exp_sfu(s[nt][j]);
          dl[j] = s[nt][j] < 0.f ? pt[j] * gp[nt][j] : 0.f;
        }
        // hi = bf16(dl) by one packed conversion per pair, unpacked by
        // shifts; lo = bf16(dl - hi) likewise packed
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t hp = pack_bf16(dl[2 * h], dl[2 * h + 1]);
          const float hi0 = __uint_as_float(hp << 16), hi1 = __uint_as_float(hp & 0xffff0000u);
          hl[0][2 * nt + h] = hp;
          hl[1][2 * nt + h] = pack_bf16(dl[2 * h] - hi0, dl[2 * h + 1] - hi1);
          if constexpr (KEYS) pa[0][2 * nt + h] = pack_bf16(pt[2 * h], pt[2 * h + 1]);
        }
      }
      mma_points<NTD, Dm::RS, 2>(acc, hl, a_s, c, lane);
      if constexpr (KEYS) mma_points<NTV, Dm::RSV, 1>(accv, pa, b_s, c, lane);
    };
    for (int c = c0; c < c0 + bsp; c += 16) {
      float s[2][4], gp[2][4];
      products(c, s, gp);
      gradients(c, s, gp);
    }

    const int src = (lane & ~3) | kSumLane;
    const float sum0 = __shfl_sync(0xffffffffu, acc[kSumTile][kSumReg], src);
    const float sum1 = __shfl_sync(0xffffffffu, acc[kSumTile][2 + kSumReg], src);
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = nt * 8 + 2 * t + (j & 1);
        if (e < D && (!MASKED || g + (j >> 1) * 8 < own)) {
          const size_t at = (size_t)e * nn + p0 + g + (j >> 1) * 8;
          const float val = acc[nt][j] - (j < 2 ? sum0 : sum1) * __bfloat162float(xr[at]);
          dx[r * D * nn + at] = __float2bfloat16_rn(val);
        }
      }
    }
    if constexpr (KEYS) {
#pragma unroll
      for (int nt = 0; nt < NTV; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = nt * 8 + 2 * t + (j & 1);
          if (e < DV && (!MASKED || g + (j >> 1) * 8 < own))
            dv[(r * DV + e) * nn + p0 + g + (j >> 1) * 8] = __float2bfloat16_rn(accv[nt][j]);
        }
      }
    }
  }
}

// K2: the key half (blockIdx.z 0, the heavier, so it is scheduled first) and
// the query half (1) in one grid, a CTA per (row, bucket, half); three CTAs
// an SM (80 registers, no spills)
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 3)
tc_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ gso,
              const float* __restrict__ gden, bf16* __restrict__ dq, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int n, int bs) {
  extern __shared__ uint4 smem_tc[];
  bf16* s = reinterpret_cast<bf16*>(smem_tc);
  if (blockIdx.z == 0)
    tc_bwd_half<D, DV, true>(q, k, v, gso, gden, dk, dv, n, bs, s);
  else
    tc_bwd_half<D, DV, false>(q, k, v, gso, gden, dq, nullptr, n, bs, s);
}

// K7 v2 on the tensor cores: K2's halves over g padded buckets a CTA (the
// key half blockIdx.z 0, the query half 1), as many warps as a balanced
// share of the CTA's 16-point tiles needs (7 for two buckets of 100: 14
// tiles in two rounds, no warp idle).
template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads, 3)
tc_cols_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ gso,
                   const float* __restrict__ gden, bf16* __restrict__ dq, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int n, int bs, int g) {
  extern __shared__ uint4 smem_tc[];
  bf16* s = reinterpret_cast<bf16*>(smem_tc);
  if (blockIdx.z == 0)
    tc_bwd_half<D, DV, true, true>(q, k, v, gso, gden, dk, dv, n, bs, s, g);
  else
    tc_bwd_half<D, DV, false, true>(q, k, v, gso, gden, dq, nullptr, n, bs, s, g);
}

// Buckets a CTA of tc_cols_bwd_kernel takes: two up to 128 points (bs 100 on
// the H100: 0.585 ms a launch at hept_fast's shape against 0.607-0.613 for
// one, 0.595 for three and 0.610 for four; PERF.md).
__host__ __device__ constexpr int tc_cols_group(int bs) { return bs <= 128 ? 2 : 1; }

template <int D, int DV>
int launch_tc_cols_bwd(const void* q, const void* k, const void* v, const float* gso,
                       const float* gden, void* dq, void* dk, void* dv, int r, int n, int bs,
                       int g, cudaStream_t stream) {
  const int bsp = round_up(bs, 16), nb = n / bs;
  const size_t smem = TcDims<D, DV>::bwd_smem(g * bsp);
  if (bs % 4 != 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tc_cols_bwd_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // warps: the fewest that take the tiles in the same number of rounds as 8
  const int tiles = g * bsp / 16, rounds = (tiles + kTcWarps - 1) / kTcWarps;
  const int warps = (tiles + rounds - 1) / rounds;
  dim3 grid((nb + g - 1) / g, r, 2);
  tc_cols_bwd_kernel<D, DV><<<grid, warps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, gso, gden, (bf16*)dq, (bf16*)dk, (bf16*)dv,
      n, bs, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 on the tensor cores: the route of bf16 K6 at bs % 4 == 0 (hept_fast,
// hept_turbo, and attn_impl slab / hybrid_slab on bf16, where K6 with HILO
// carries K8's contract). K1's products on K7 v2's padded buckets: a CTA
// takes g consecutive buckets (one, as measured), each staged once as bsp =
// round_up(bs, 16) point-major bf16 rows of keys and of values
// (stage_rows_padded: 8-byte loads, since a bucket of bf16 starts only
// 8-byte aligned; rows bs..bsp-1 zero) with the keys' f32 norms, the padded
// ones kPadBias, so pt = 0 for a padded key whatever the mma adds and its
// zero value row adds nothing. A warp takes TPW 16-query tiles of one
// bucket at a time (two, as measured), their A fragments read from global
// memory (rows past the bucket read as zero and are never stored), and walks
// its bucket's keys in chunks of 16: S = Q.K^T on the tensor cores from
// accumulators that start at the f32 bias sum (with HILO each bias as hi +
// lo bf16 values, _bias's split), pt = ex2.approx of the clamped,
// log2(e)-scaled logits on the accumulator registers, denom summed from the
// f32 pt, and so += bf16(pt) . V with the point-major value tile read
// transposed by ldmatrix (one B fragment for all TPW tiles). What bounds it
// at hept_fast's shape: the bytes (0.077 ms); it runs at ~2.3x that, with
// ~1.2e8 padded logits at K1's per-logit cost near 0.07 ms.

// acc[m][nt] += a[m] . B for M row tiles m, where B (16 points x
// NT*8 columns) is points p0..p0+15 of a point-major shared tile with row
// stride RS, read transposed by ldmatrix once for all M tiles
template <int NT, int RS, int M>
__device__ __forceinline__ void mma_points_tiles(float (&acc)[M][NT][4], const uint32_t (&a)[M][4],
                                                 const bf16* tile, int p0, int lane) {
  const bf16* row = tile + (p0 + (lane & 15)) * RS;
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, row + nt * 8 + (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_bf16(acc[m][nt], a[m], b[0], b[1]);
      mma_bf16(acc[m][nt + 1], a[m], b[2], b[3]);
    }
  }
  if constexpr (NT % 2 == 1) {
    uint32_t b[2];
    ldsm_x2_trans(b, row + (NT - 1) * 8);
#pragma unroll
    for (int m = 0; m < M; ++m) mma_bf16(acc[m][NT - 1], a[m], b[0], b[1]);
  }
}

// a -|x|^2/2 bias as K6 carries it: hi + lo bf16 with HILO, else exact f32
template <bool HILO>
__device__ __forceinline__ float cols_bias(float x_sq) {
  return HILO ? split_bf16(x_sq) : x_sq;
}

// keys [rows][RS] and values [rows][RSV] bf16, key norms [rows] f32
template <int D, int DV>
size_t tc_cols_fwd_smem(int rows) {
  return (size_t)rows * (TcDims<D, DV>::RS + TcDims<D, DV>::RSV) * 2 + (size_t)rows * 4;
}

// at most 4 warps a CTA, 80 registers a thread: six CTAs an SM
constexpr int kTcColsFwdWarps = 4;

template <int D, int DV, bool HILO, int TPW>
__global__ void __launch_bounds__(kTcColsFwdWarps * 32, 6)
tc_cols_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, float* __restrict__ denom, float* __restrict__ so,
                   int n, int bs, int g_buckets) {
  using Dm = TcDims<D, DV>;
  constexpr int KS = Dm::DK / 16, NTV = Dm::DVN / 8;
  extern __shared__ uint4 smem_tc[];
  const int bsp = round_up(bs, 16);  // a bucket's shared rows
  const int nbk = min(g_buckets, n / bs - (int)blockIdx.x * g_buckets);
  const int rows = nbk * bsp;
  bf16* k_s = reinterpret_cast<bf16*>(smem_tc);                  // [rows][RS]
  bf16* v_s = k_s + rows * Dm::RS;                                // [rows][RSV]
  float* kb_s = reinterpret_cast<float*>(v_s + rows * Dm::RSV);  // [rows]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t nn = n, r = blockIdx.y, base = (size_t)blockIdx.x * g_buckets * bs;
  stage_rows_padded<D, Dm::DK, Dm::RS, false>(k + r * D * nn, nn, base, bs, bsp, nbk, k_s);
  stage_rows_padded<DV, Dm::DVN, Dm::RSV, false>(v + r * DV * nn, nn, base, bs, bsp, nbk, v_s);
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    kb_s[j] = j % bsp < bs ? cols_bias<HILO>(half_sq_bf16<D>(k_s + j * Dm::RS)) : kPadBias;
  __syncthreads();

  const bf16* qr = q + r * D * nn;
  const int gpb = (bsp / 16 + TPW - 1) / TPW;  // groups of TPW tiles a bucket
  for (int grp = warp; grp < nbk * gpb; grp += (int)(blockDim.x >> 5)) {
    const int kb = grp / gpb, tile0 = (grp % gpb) * TPW, c0 = kb * bsp;
    const size_t p0 = base + (size_t)kb * bs + tile0 * 16;  // this warp's first query
    uint32_t qa[TPW][KS][4];
    float2 qsq[TPW];
    int own[TPW];  // queries of each tile inside the bucket
#pragma unroll
    for (int m = 0; m < TPW; ++m) {
      own[m] = bs - (tile0 + m) * 16;
      float qf[KS][8];
      load_a<D, KS, true>(qr, nn, p0 + 16 * m, lane, qa[m], qf, own[m]);
      const float2 x = half_sq_rows<KS>(qf);
      qsq[m] = make_float2(cols_bias<HILO>(x.x), cols_bias<HILO>(x.y));
    }
    float acc[TPW][NTV][4] = {};
    float den[TPW][2] = {};
#pragma unroll 2
    for (int kc = c0; kc < c0 + bsp; kc += 16) {
      // the logits start from their f32 bias sum; the mma adds q.k
      float s[TPW][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 kb2 = *reinterpret_cast<const float2*>(kb_s + kc + nt * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < TPW; ++m) {
          s[m][nt][0] = qsq[m].x + kb2.x;
          s[m][nt][1] = qsq[m].x + kb2.y;
          s[m][nt][2] = qsq[m].y + kb2.x;
          s[m][nt][3] = qsq[m].y + kb2.y;
        }
      }
      mma_cols<KS, Dm::RS, TPW>(s, qa, k_s, kc, lane);
      uint32_t pa[TPW][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int m = 0; m < TPW; ++m) {
          const float p00 = exp_clamped(s[m][nt][0]);
          const float p01 = exp_clamped(s[m][nt][1]);
          const float p10 = exp_clamped(s[m][nt][2]);
          const float p11 = exp_clamped(s[m][nt][3]);
          den[m][0] += p00 + p01;
          den[m][1] += p10 + p11;
          pa[m][2 * nt] = pack_bf16(p00, p01);
          pa[m][2 * nt + 1] = pack_bf16(p10, p11);
        }
      }
      mma_points_tiles<NTV, Dm::RSV, TPW>(acc, pa, v_s, kc, lane);
    }
#pragma unroll
    for (int m = 0; m < TPW; ++m) {
      const size_t pm = p0 + 16 * m;
      const float d0 = quad_sum(den[m][0]), d1 = quad_sum(den[m][1]);
      if (t == 0) {
        if (g < own[m]) denom[r * nn + pm + g] = d0 + kDenomEps;
        if (g + 8 < own[m]) denom[r * nn + pm + g + 8] = d1 + kDenomEps;
      }
      // a 32-byte sector holds 8 queries of one column: each store fills whole ones
#pragma unroll
      for (int vt = 0; vt < NTV; ++vt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = vt * 8 + 2 * t + j;
          if (e < DV) {
            if (g < own[m]) so[(r * DV + e) * nn + pm + g] = acc[m][vt][j];
            if (g + 8 < own[m]) so[(r * DV + e) * nn + pm + g + 8] = acc[m][vt][2 + j];
          }
        }
      }
    }
  }
}

// Buckets a CTA of tc_cols_fwd_kernel takes, and 16-query tiles a warp, as
// measured on the H100 at hept_fast's shape (bs 100, PERF.md): one bucket
// and two tiles a warp (4 warps for its 7 tiles) 0.178 ms a launch; two
// buckets 0.216, one tile a warp 0.235-0.257, four tiles 0.205. The bucket
// count stays a kernel argument: compiled with it fixed at one, the kernel
// spilled 52-84 bytes at its 80-register bound and took 0.189 ms.
constexpr int kTcColsFwdGroup = 1, kTcColsFwdTiles = 2;

template <int D, int DV, bool HILO, int TPW>
int launch_tc_cols_fwd(const void* q, const void* k, const void* v, float* denom, float* so,
                       int r, int n, int bs, int g, cudaStream_t stream) {
  const int bsp = round_up(bs, 16), nb = n / bs;
  const size_t smem = tc_cols_fwd_smem<D, DV>(g * bsp);
  if (bs % 4 != 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tc_cols_fwd_kernel<D, DV, HILO, TPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // warps: the fewest that take the tile groups in the same number of rounds
  // as kTcColsFwdWarps
  const int groups = g * ((bsp / 16 + TPW - 1) / TPW);
  const int rounds = (groups + kTcColsFwdWarps - 1) / kTcColsFwdWarps;
  const int warps = (groups + rounds - 1) / rounds;
  dim3 grid((nb + g - 1) / g, r);
  tc_cols_fwd_kernel<D, DV, HILO, TPW><<<grid, warps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, denom, so, n, bs, g);
  return (int)cudaGetLastError();
}

template <int D, int DV, int TPW>
int launch_tc_fwd_with(const void* q, const void* k, const void* v, float* denom, float* so,
                       int r, int n, int bs, cudaStream_t stream) {
  const size_t smem = TcDims<D, DV>::fwd_smem(bs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tc_fwd_kernel<D, DV, TPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / bs, r);
  tc_fwd_kernel<D, DV, TPW><<<grid, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, denom, so, n, bs);
  return (int)cudaGetLastError();
}

// Tiles per warp, as measured on the H100 (PERF.md): K1 takes two 16-query
// tiles per warp where the bucket size allows (sharing every B fragment),
// K2 one (two measured slower, with fewer CTAs an SM).
template <int D, int DV>
int launch_tc_fwd(const void* q, const void* k, const void* v, float* denom, float* so, int r,
                  int n, int bs, cudaStream_t stream) {
  if (bs % 32 == 0) return launch_tc_fwd_with<D, DV, 2>(q, k, v, denom, so, r, n, bs, stream);
  return launch_tc_fwd_with<D, DV, 1>(q, k, v, denom, so, r, n, bs, stream);
}

template <int D, int DV>
int launch_tc_bwd(const void* q, const void* k, const void* v, const float* gso, const float* gden,
                  void* dq, void* dk, void* dv, int r, int n, int bs, cudaStream_t stream) {
  const size_t smem = TcDims<D, DV>::bwd_smem(bs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tc_bwd_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / bs, r, 2);
  tc_bwd_kernel<D, DV><<<grid, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, gso, gden, (bf16*)dq, (bf16*)dk, (bf16*)dv,
      n, bs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 v1 (f32) on FP32 FMAs, one pass per bucket: the route of every f32 K7
// (and of v1 on bf16, K9's contract) whose bucket fits (bs <= 100 at d 30,
// dv 24), and with ROWS of K10's backward there; larger buckets and K7 v2
// off the tensor-core route keep cols_bwd_kernel above.
//
// What held cols_bwd_kernel back (3.1 ms at the parity shape against a
// 0.593 ms FP32 bound): its two halves recompute the logit and gp, ~200
// FMAs a logit against the 138 the gradient needs; a thread walks the other
// side with one 32-long dependent FMA chain per product; every 4 FMAs wait
// on one shared load; expf is the full-precision path; 7 warps an SM. Here
// one persistent CTA of 512 threads an SM walks the (row, bucket) items, a
// bucket at a time (no warp straddles two), the next bucket's q, k, v, g_so
// and g_den in flight as cp.async copies into the other of two staging
// buffers (point-major f32 rows) while it runs three phases on this one:
//  A. the logits and gp once per pair, a 4 x 5 tile of pairs a thread (20
//     independent accumulators each), pt = ex2.approx of a log2(e)-scaled
//     argument, dl = pt * gp where the logit is < 0, stored as dl[i][j],
//     dl[j][i] and pt[i][j];
//  B. the row and column sums of dl, each in a fixed order;
//  C. dq = dl . k - rowsum q, dk = dl^T . q - colsum k and dv = pt^T . g, a
//     4 x 6 output tile a thread (350 of them at bs 100: one round, each
//     output from a warp boundary), one loop for all three, only the
//     pointers and the epilogue differ.
// What bounds these phases is the shared memory's wavefronts, not its
// bytes: the lanes of a warp span few rows of each operand (A: 8 queries x
// 4 keys; C: the column block fastest), so each load is one wavefront, ~9
// for 80 FMAs in A and 4 for 24 in C.
// Padded points (bs up to the next multiple of 20) have zero rows and the
// norm kPadBias: pt = 0 and dl = 0. Every sum runs in a fixed order: no
// atomics, the same bits on every call. Where a quarter-warp reads 8 rows
// at once, the dl / pt rows are strided 4 words modulo 32 and the operand
// rows 4 modulo 8 (stride_4mod8).

constexpr int kTiledThreads = 512;
constexpr int kTiledMaxBs = 100;

template <int D, int DV>
struct TiledDims {
  static constexpr int kCC = 6;  // phase C's columns a unit
  // q / k and g / v row strides: phase C reads whole units of kCC columns,
  // past D (zero padding) where kCC does not divide it
  static constexpr int SQ = stride_4mod8(round_up(D, kCC));
  static constexpr int SV = stride_4mod8(round_up(DV, kCC));
  static constexpr int kCols = 2 * D + 2 * DV + 1;  // staged: q, k, g_so, v, g_den
  static __host__ __device__ int bp(int bs) { return round_up(bs, 20); }
  // dl / pt row stride: >= bp and 4 words modulo 32
  static __host__ __device__ int sl(int bs) { return bp(bs) + ((36 - bp(bs) % 32) % 32); }
  // one staging buffer: q, k [bp][SQ]; g, v [bp][SV]; g_den [bp]
  static __host__ __device__ int ops(int bs) { return bp(bs) * (2 * SQ + 2 * SV + 1); }
  // dl, its transpose and pt [bp][sl]; two staging buffers; two norms and
  // two sums [bp]
  static size_t smem(int bs) {
    return ((size_t)3 * bp(bs) * sl(bs) + (size_t)2 * ops(bs) + (size_t)4 * bp(bs)) * 4;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// The row layout (K10) of the tiled kernels: a point's C values are one row,
// a bucket's rows one contiguous run. Rows move V floats at a time, V the
// widest of 4, 2, 1 that divides C, where every pointer is 16-byte aligned
// (vec; else one float at a time): C = 30 as 8-byte pieces (120-byte rows
// keep 8-byte alignment), C = 24 as 16-byte ones.
template <int C>
__host__ __device__ constexpr int row_vec() {
  return C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
}

template <int BYTES>
__device__ __forceinline__ void cp_async_n(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
}

template <int V, int C, int S>
__device__ __forceinline__ void copy_rows_async_v(const float* src, int count, float* dst) {
  constexpr int NV = C / V;
  for (int f = threadIdx.x; f < count * NV; f += blockDim.x) {
    const int p = f / NV;
    cp_async_n<4 * V>(dst + p * S + (f - p * NV) * V, src + f * V);
  }
}

// cp.async copies (uncommitted) of `count` rows of C floats, the run at src,
// into shared rows dst[p * S + e], e < C; every copy in flight at once
template <int C, int S>
__device__ __forceinline__ void copy_rows_async(const float* src, int count, float* dst, bool vec) {
  if (vec)
    copy_rows_async_v<row_vec<C>(), C, S>(src, count, dst);
  else
    copy_rows_async_v<1, C, S>(src, count, dst);
}

// a row of C floats at src into x[0..C), zeros in x[C..CP)
template <int C, int CP>
__device__ __forceinline__ void load_row(const float* src, float (&x)[CP], bool vec) {
  constexpr int V = row_vec<C>();
  if (V == 1 || !vec) {
#pragma unroll
    for (int e = 0; e < C; ++e) x[e] = __ldg(src + e);
  } else if constexpr (V == 4) {
#pragma unroll
    for (int e = 0; e < C; e += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src + e));
      x[e] = t.x, x[e + 1] = t.y, x[e + 2] = t.z, x[e + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < C; e += 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(src + e));
      x[e] = t.x, x[e + 1] = t.y;
    }
  }
#pragma unroll
  for (int e = C; e < CP; ++e) x[e] = 0.f;
}

// x[0..C) as a row of C floats at dst
template <int C, int CP>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[CP], bool vec) {
  constexpr int V = row_vec<C>();
  if (V == 1 || !vec) {
#pragma unroll
    for (int e = 0; e < C; ++e) dst[e] = x[e];
  } else if constexpr (V == 4) {
#pragma unroll
    for (int e = 0; e < C; e += 4)
      *reinterpret_cast<float4*>(dst + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < C; e += 2) *reinterpret_cast<float2*>(dst + e) = make_float2(x[e], x[e + 1]);
  }
}

// x[0..lim) (lim <= C, C even) at dst, as float2s where pair (dst 8-byte
// aligned, lim even)
template <int C>
__device__ __forceinline__ void store_cols(float* dst, const float (&x)[C], int lim, bool pair) {
  if (pair) {
#pragma unroll
    for (int c = 0; c < C; c += 2)
      if (c < lim) *reinterpret_cast<float2*>(dst + c) = make_float2(x[c], x[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < lim) dst[c] = x[c];
  }
}

// acc[m][c] += a[x * sa + m] * b[x * sb + c] for x < len: an M x C tile of
// a product whose contraction runs down the rows of two shared tiles (a at
// 16-byte, b at 8-byte aligned columns)
template <int M, int C>
__device__ __forceinline__ void outer_tile(float (&acc)[M][C], const float* a, int sa,
                                           const float* b, int sb, int len) {
#pragma unroll 4
  for (int x = 0; x < len; ++x) {
    float am[M], bc[C];
#pragma unroll
    for (int m = 0; m < M; m += 4) {
      const float4 t = *reinterpret_cast<const float4*>(a + x * sa + m);
      am[m] = t.x, am[m + 1] = t.y, am[m + 2] = t.z, am[m + 3] = t.w;
    }
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const float2 t = *reinterpret_cast<const float2*>(b + x * sb + c);
      bc[c] = t.x, bc[c + 1] = t.y;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[m][c] = fmaf(am[m], bc[c], acc[m][c]);
    }
  }
}

// s[u][w] += sum_e x[iu][e] * y[jw][e] over e < C: four columns per float4
// load (each used 5 or 4 times), then the rest one at a time
template <int C, int S>
__device__ __forceinline__ void pair_dots(float (&s)[4][5], const float* x, const float* y,
                                          const int (&iu)[4], const int (&jw)[5]) {
#pragma unroll
  for (int e = 0; e + 4 <= C; e += 4) {
    float4 a[4], b[5];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = *reinterpret_cast<const float4*>(x + iu[u] * S + e);
#pragma unroll
    for (int w = 0; w < 5; ++w) b[w] = *reinterpret_cast<const float4*>(y + jw[w] * S + e);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        s[u][w] = fmaf(a[u].x, b[w].x, s[u][w]);
        s[u][w] = fmaf(a[u].y, b[w].y, s[u][w]);
        s[u][w] = fmaf(a[u].z, b[w].z, s[u][w]);
        s[u][w] = fmaf(a[u].w, b[w].w, s[u][w]);
      }
    }
  }
#pragma unroll
  for (int e = C / 4 * 4; e < C; ++e) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = x[iu[u] * S + e];
#pragma unroll
      for (int w = 0; w < 5; ++w) s[u][w] = fmaf(a, y[jw[w] * S + e], s[u][w]);
    }
  }
}

template <int D, int DV, bool ROWS>
__global__ void __launch_bounds__(kTiledThreads, 1)
cols_bwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ gso,
                      const float* __restrict__ gden, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv, int n, int bs, int items,
                      bool vec) {
  using Tm = TiledDims<D, DV>;
  constexpr int SQ = Tm::SQ, SV = Tm::SV;
  // phase C's unit: kCM points x kCC columns; DB, VB column blocks of dq /
  // dk and of dv
  constexpr int kCM = 4, kCC = Tm::kCC, DB = (D + kCC - 1) / kCC, VB = (DV + kCC - 1) / kCC;
  static_assert(kCM == 4, "a unit's points are one float4 of a column");
  const int bp = Tm::bp(bs), sl = Tm::sl(bs), ob = Tm::ops(bs), nb = n / bs;
  extern __shared__ float4 smem_tiled[];
  float* dl_s = reinterpret_cast<float*>(smem_tiled);  // [bp][sl] dl[i][j]
  float* dlt_s = dl_s + bp * sl;                        // [bp][sl] dl[j][i]
  float* p_s = dlt_s + bp * sl;                         // [bp][sl] pt[i][j]
  float* ops_s = p_s + bp * sl;                         // two staging buffers
  float* qb_s = ops_s + 2 * ob;                         // [bp] -|q|^2/2
  float* kb_s = qb_s + bp;                              // [bp] -|k|^2/2
  float* rs_s = kb_s + bp;                              // [bp] row sums of dl
  float* cs_s = rs_s + bp;                              // [bp] column sums
  const size_t nn = n;
  // the padding of the staging buffers (columns past D / DV, points past
  // bs) stays zero: staging writes only the rest
  for (int w = threadIdx.x; w < 2 * ob; w += blockDim.x) ops_s[w] = 0.f;
  __syncthreads();

  // async copies of an item's operands into a staging buffer, one group
  // (the column layout: a warp takes a column at a time, a lane a point)
  auto stage = [&](int item, float* buf) {
    if (item < items) {
      if constexpr (ROWS) {
        // the row layout: the bucket's q, k, g_so, v and g_den are five runs
        const size_t base = (size_t)item * bs;
        copy_rows_async<D, SQ>(q + base * D, bs, buf, vec);
        copy_rows_async<D, SQ>(k + base * D, bs, buf + bp * SQ, vec);
        copy_rows_async<DV, SV>(gso + base * DV, bs, buf + 2 * bp * SQ, vec);
        copy_rows_async<DV, SV>(v + base * DV, bs, buf + 2 * bp * SQ + bp * SV, vec);
        copy_rows_async<1, 1>(gden + base, bs, buf + 2 * bp * (SQ + SV), vec);
      } else {
        const size_t r = item / nb, base = (size_t)(item % nb) * bs;
        for (int c = threadIdx.x / 32; c < Tm::kCols; c += kTiledThreads / 32) {
          const float* src;
          float* dst;
          int stride = SQ;
          if (c < D) {
            src = q + (r * D + c) * nn, dst = buf + c;
          } else if (c < 2 * D) {
            src = k + (r * D + c - D) * nn, dst = buf + bp * SQ + c - D;
          } else if (c < 2 * D + 2 * DV) {
            const int e = c - 2 * D;  // g_so, then v
            src = e < DV ? gso + (r * DV + e) * nn : v + (r * DV + e - DV) * nn;
            dst = buf + 2 * bp * SQ + (e < DV ? e : bp * SV + e - DV);
            stride = SV;
          } else {
            src = gden + r * nn, dst = buf + 2 * bp * (SQ + SV), stride = 1;
          }
          for (int p = threadIdx.x % 32; p < bs; p += 32) cp_async4(dst + p * stride, src + base + p);
        }
      }
    }
    cp_async_commit();
  };

  // A persistent CTA walks the (row, bucket) items; the next item's copies
  // are in flight while this one computes.
  stage(blockIdx.x, ops_s);
  for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    float* q_s = ops_s + (it & 1) * ob;  // [bp][SQ]
    float* k_s = q_s + bp * SQ;          // [bp][SQ]
    float* g_s = k_s + bp * SQ;          // [bp][SV]
    float* v_s = g_s + bp * SV;          // [bp][SV]
    float* gd_s = v_s + bp * SV;         // [bp] g_den
    stage(item + gridDim.x, ops_s + ((it + 1) & 1) * ob);
    cp_async_wait_prev();
    __syncthreads();
    const size_t r = item / nb, base = (size_t)(item % nb) * bs;
    for (int p = threadIdx.x; p < bp; p += blockDim.x) {
      qb_s[p] = p < bs ? half_sq<D>(q_s + p * SQ) : kPadBias;
      kb_s[p] = p < bs ? half_sq<D>(k_s + p * SQ) : kPadBias;
    }
    __syncthreads();

    // A. queries ti + ti_n u (u < 4) against keys tj + tj_n w (w < 5); a
    // warp's lanes span 8 values of ti and 4 of tj, so each shared load
    // reads at most 8 distinct rows
    const int ti_n = bp / 4, tj_n = bp / 5;
    for (int tile = threadIdx.x; tile < ti_n * tj_n; tile += blockDim.x) {
      const int ti = (tile / 4) % ti_n, tj = tile / (4 * ti_n) * 4 + tile % 4;
      int iu[4], jw[5];
#pragma unroll
      for (int u = 0; u < 4; ++u) iu[u] = ti + ti_n * u;
#pragma unroll
      for (int w = 0; w < 5; ++w) jw[w] = tj + tj_n * w;
      // gp from g_den; s from the f32 bias sum (columns) or from 0, the
      // biases added after the dot (rows: the forward's and the plain
      // version's order, which holds the parity core's cancelling RPE norms)
      float s[4][5], gp[4][5];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int w = 0; w < 5; ++w) {
          if constexpr (ROWS)
            s[u][w] = 0.f;
          else
            s[u][w] = qb_s[iu[u]] + kb_s[jw[w]];
          gp[u][w] = gd_s[iu[u]];
        }
      }
      pair_dots<D, SQ>(s, q_s, k_s, iu, jw);
      pair_dots<DV, SV>(gp, g_s, v_s, iu, jw);
      if constexpr (ROWS) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int w = 0; w < 5; ++w) s[u][w] = s[u][w] + qb_s[iu[u]] + kb_s[jw[w]];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int w = 0; w < 5; ++w) {
          const float pt = exp_clamped(s[u][w]);
          const float dl = s[u][w] < 0.f ? pt * gp[u][w] : 0.f;
          dl_s[iu[u] * sl + jw[w]] = dl;
          dlt_s[jw[w] * sl + iu[u]] = dl;
          p_s[iu[u] * sl + jw[w]] = pt;
        }
      }
    }
    __syncthreads();

    // B. row sums (down dl[j][i]) and column sums (down dl[i][j]), in order
    for (int x = threadIdx.x; x < 2 * bp; x += blockDim.x) {
      const float* col = (x < bp ? dlt_s : dl_s) + x % bp;
      float acc = 0.f;
      for (int y = 0; y < bp; ++y) acc += col[y * sl];
      (x < bp ? rs_s : cs_s)[x % bp] = acc;
    }
    __syncthreads();

    // C. kCM points x kCC columns a unit, the column block fastest across
    // lanes: dq (points i, over keys), dk (points j, over queries), dv
    // (points j, over queries), each output's units from a warp boundary on
    // (a warp that held two would run the loop twice)
    const int pg_n = (bp + kCM - 1) / kCM, nq = pg_n * DB, nqw = round_up(nq, 32);
    for (int unit = threadIdx.x; unit < 2 * nqw + pg_n * VB; unit += blockDim.x) {
      const int kind = unit < nqw ? 0 : unit < 2 * nqw ? 1 : 2;  // dq, dk, dv
      const int u = unit - kind * nqw;
      if (kind < 2 && u >= nq) continue;
      const int blocks = kind == 2 ? VB : DB;
      const int p0 = kCM * (u / blocks), e0 = kCC * (u % blocks);
      const float* a = (kind == 0 ? dlt_s : kind == 1 ? dl_s : p_s) + p0;
      const float* b = (kind == 0 ? k_s : kind == 1 ? q_s : g_s) + e0;
      float acc[kCM][kCC] = {};
      outer_tile(acc, a, sl, b, kind == 2 ? SV : SQ, bp);
      // dq / dk: the correction -sum[p] own[p][e]; then each column's 4
      // points as one 16-byte store where bs % 4 == 0
      const int width = kind == 2 ? DV : D;
      if (kind < 2) {
        const float* own = kind == 0 ? q_s : k_s;
        const float* sum = kind == 0 ? rs_s : cs_s;
#pragma unroll
        for (int m = 0; m < kCM; ++m) {
#pragma unroll
          for (int c = 0; c < kCC; ++c) acc[m][c] -= sum[p0 + m] * own[(p0 + m) * SQ + e0 + c];
        }
      }
      if constexpr (ROWS) {
        // each point's kCC columns: 24 contiguous bytes of its row
        float* out = (kind == 0 ? dq : kind == 1 ? dk : dv) + (base + p0) * width + e0;
#pragma unroll
        for (int m = 0; m < kCM; ++m) {
          if (p0 + m < bs) store_cols<kCC>(out + m * width, acc[m], width - e0, vec && width % 2 == 0);
        }
      } else {
        float* out = (kind == 0 ? dq : kind == 1 ? dk : dv) + (r * width + e0) * nn + base + p0;
#pragma unroll
        for (int c = 0; c < kCC; ++c) {
          if (e0 + c >= width) continue;
          if (bs % 4 == 0) {
            if (p0 < bs)
              *reinterpret_cast<float4*>(out + c * nn) =
                  make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
          } else {
#pragma unroll
            for (int m = 0; m < kCM; ++m) {
              if (p0 + m < bs) out[c * nn + m] = acc[m][c];
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// one CTA an SM, each walking its share of the r * nb items; ROWS: the row
// layout (K10), r = 1; vec: every pointer 16-byte aligned
template <int D, int DV, bool ROWS = false>
int launch_cols_bwd_tiled(const void* q, const void* k, const void* v, const float* gso,
                          const float* gden, void* dq, void* dk, void* dv, int r, int n, int bs,
                          cudaStream_t stream, bool vec = false) {
  const size_t smem = TiledDims<D, DV>::smem(bs);
  cudaError_t err = cudaFuncSetAttribute(cols_bwd_tiled_kernel<D, DV, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int items = r * (n / bs);
  cols_bwd_tiled_kernel<D, DV, ROWS><<<std::min(items, sms), kTiledThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, gso, gden, (float*)dq, (float*)dk,
      (float*)dv, n, bs, items, vec);
  return (int)cudaGetLastError();
}

// K7's f32 (v1) kernel for this bucket size: the tiled one where it fits
template <int D, int DV>
int launch_cols_bwd_f32(const void* q, const void* k, const void* v, const float* gso,
                        const float* gden, void* dq, void* dk, void* dv, int r, int n, int bs,
                        cudaStream_t stream) {
  if (bs <= kTiledMaxBs && TiledDims<D, DV>::smem(bs) <= kMaxSmem)
    return launch_cols_bwd_tiled<D, DV>(q, k, v, gso, gden, dq, dk, dv, r, n, bs, stream);
  return launch_cols_bwd<D, DV, false>(q, k, v, gso, gden, dq, dk, dv, r, n, bs, stream);
}

// ---------------------------------------------------------------------------
// K6 in f32 on FP32 FMAs, register-tiled: the route of f32 K6 at bs <= 100
// with bs % 4 == 0 (the parity profile), and with ROWS of K10's forward
// there; other bucket sizes keep cols_fwd_kernel above.
//
// What held cols_fwd_kernel back (0.78 ms at the parity shape against a
// 0.232 ms FP32 bound): one query a thread and one key a step, so each
// logit is one 32-long dependent FMA chain and each key's broadcast k and v
// rows (14 shared loads) feed only ~57 FMAs; the full expf; k rows staged at
// a stride of 32 words, so the staging's stores hit one bank. Here a thread
// holds two queries of one bucket in registers (i and i + bs / 2) and walks
// its bucket's keys four at a time: a 2 x 4 tile of logits, eight
// independent chains, each broadcast k row feeding both queries; pt =
// ex2.approx of the clamped, log2(e)-scaled logit; each v row feeding both
// queries' 24 outputs. The sums run in one fixed order (no atomics, the
// same bits on every call). A CTA takes two buckets (bs threads), staged
// once as point-major rows at strides of 4 words modulo 8, so the rows of
// the two buckets a warp may straddle fall in distinct banks.
//
// Measured on the H100 at the parity shape (PERF.md): a one-pass design on
// K7 v1's persistent 512-thread tiles (cols_bwd_tiled_kernel: 4 x 5 pair
// tiles, cp.async double buffering, pt through shared memory) read 0.93-1.08
// ms, slower than cols_fwd_kernel: a warp's 128-bit loads there fetch 8
// distinct rows, the phases' barriers leave the SM idle, and the staging was
// exposed. This design keeps the first cut's broadcast loads and its many
// CTAs an SM, and moves the work per load up.

constexpr int kFwdTileMaxBs = 100;
constexpr int kFwdQueries = 2, kFwdKeys = 4;  // a thread's register tile
constexpr int kFwdGroup = 2;                  // buckets a CTA

template <int D, int DV>
struct TiledFwdDims {
  static constexpr int DP = pad4(D), DVP = pad4(DV);
  static constexpr int SK = stride_4mod8(D), SV = stride_4mod8(DV);  // k / v row strides
  // k [g*bs][SK], v [g*bs][SV], key norms [g*bs]
  static size_t smem(int g, int bs) { return (size_t)g * bs * (SK + SV + 1) * 4; }
};

template <int D, int DV, bool ROWS>
__global__ void __launch_bounds__(round_up(kFwdGroup * kFwdTileMaxBs / kFwdQueries, 32))
cols_fwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ denom,
                      float* __restrict__ so, int n, int bs, bool vec) {
  using Fm = TiledFwdDims<D, DV>;
  constexpr int DP = Fm::DP, DVP = Fm::DVP, SK = Fm::SK, SV = Fm::SV;
  constexpr int QT = kFwdQueries, KT = kFwdKeys;
  extern __shared__ float4 smem_tiled[];
  const int tpb = bs / QT;  // threads a bucket
  const int b0 = blockIdx.x * kFwdGroup, nbk = min(kFwdGroup, n / bs - b0), span = nbk * bs;
  float* k_s = reinterpret_cast<float*>(smem_tiled);  // [g*bs][SK]
  float* v_s = k_s + kFwdGroup * bs * SK;             // [g*bs][SV]
  float* kb_s = v_s + kFwdGroup * bs * SV;            // [g*bs] -|k|^2/2
  const size_t nn = n, r = blockIdx.y, base = (size_t)b0 * bs;
  if constexpr (ROWS) {
    // the CTA's points are one run of rows, every copy in flight at once;
    // padding columns zero
    copy_rows_async<D, SK>(k + base * D, span, k_s, vec);
    copy_rows_async<DV, SV>(v + base * DV, span, v_s, vec);
    cp_async_commit();
    for (int p = threadIdx.x; p < span; p += blockDim.x) {
#pragma unroll
      for (int e = D; e < DP; ++e) k_s[p * SK + e] = 0.f;
#pragma unroll
      for (int e = DV; e < DVP; ++e) v_s[p * SV + e] = 0.f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    // a thread a point, its row's loads all in flight; padding columns zero
    for (int p = threadIdx.x; p < span; p += blockDim.x) {
#pragma unroll
      for (int e = 0; e < DP; ++e) k_s[p * SK + e] = e < D ? __ldg(k + (r * D + e) * nn + base + p) : 0.f;
#pragma unroll
      for (int e = 0; e < DVP; ++e)
        v_s[p * SV + e] = e < DV ? __ldg(v + (r * DV + e) * nn + base + p) : 0.f;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += blockDim.x) kb_s[j] = half_sq<D>(k_s + j * SK);
  __syncthreads();
  if ((int)threadIdx.x >= nbk * tpb) return;
  const int cb = threadIdx.x / tpb * bs, i0 = threadIdx.x % tpb;  // bucket's first column, slot
  float qi[QT][DP], qb[QT];
#pragma unroll
  for (int m = 0; m < QT; ++m) {
    const size_t col = base + cb + i0 + m * tpb;
    float a = 0.f;
    if constexpr (ROWS) load_row<D, DP>(q + col * D, qi[m], vec);
#pragma unroll
    for (int e = 0; e < DP; ++e) {
      if constexpr (!ROWS) qi[m][e] = e < D ? __ldg(q + (r * D + e) * nn + col) : 0.f;
      a = fmaf(qi[m][e], qi[m][e], a);
    }
    qb[m] = -0.5f * a;
  }
  float acc[QT][DVP] = {}, den[QT] = {};
  for (int j = cb; j < cb + bs; j += KT) {
    // q.k in column order for the QT x KT pairs, four columns a broadcast load
    float s[QT][KT] = {};
#pragma unroll
    for (int e4 = 0; e4 < DP / 4; ++e4) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(k_s + (j + kk) * SK + 4 * e4);
#pragma unroll
        for (int m = 0; m < QT; ++m) {
          s[m][kk] = fmaf(qi[m][4 * e4], w.x, s[m][kk]);
          s[m][kk] = fmaf(qi[m][4 * e4 + 1], w.y, s[m][kk]);
          s[m][kk] = fmaf(qi[m][4 * e4 + 2], w.z, s[m][kk]);
          s[m][kk] = fmaf(qi[m][4 * e4 + 3], w.w, s[m][kk]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float pt[QT];
#pragma unroll
      for (int m = 0; m < QT; ++m) {
        pt[m] = exp_clamped(s[m][kk] + qb[m] + kb_s[j + kk]);
        den[m] += pt[m];
      }
#pragma unroll
      for (int e4 = 0; e4 < DVP / 4; ++e4) {
        const float4 w = *reinterpret_cast<const float4*>(v_s + (j + kk) * SV + 4 * e4);
#pragma unroll
        for (int m = 0; m < QT; ++m) {
          acc[m][4 * e4] = fmaf(w.x, pt[m], acc[m][4 * e4]);
          acc[m][4 * e4 + 1] = fmaf(w.y, pt[m], acc[m][4 * e4 + 1]);
          acc[m][4 * e4 + 2] = fmaf(w.z, pt[m], acc[m][4 * e4 + 2]);
          acc[m][4 * e4 + 3] = fmaf(w.w, pt[m], acc[m][4 * e4 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < QT; ++m) {
    const size_t col = base + cb + i0 + m * tpb;
    denom[r * nn + col] = den[m] + kDenomEps;
    if constexpr (ROWS) {
      store_row<DV, DVP>(so + col * DV, acc[m], vec);
    } else {
#pragma unroll
      for (int e = 0; e < DV; ++e) so[(r * DV + e) * nn + col] = acc[m][e];
    }
  }
}

// ROWS: the row layout (K10), r = 1; vec: every pointer 16-byte aligned
template <int D, int DV, bool ROWS = false>
int launch_cols_fwd_tiled(const void* q, const void* k, const void* v, float* denom, float* so,
                          int r, int n, int bs, cudaStream_t stream, bool vec = false) {
  const size_t smem = TiledFwdDims<D, DV>::smem(kFwdGroup, bs);
  if (bs > kFwdTileMaxBs || bs % kFwdKeys != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cols_fwd_tiled_kernel<D, DV, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = n / bs, threads = round_up(kFwdGroup * bs / kFwdQueries, 32);
  dim3 grid((nb + kFwdGroup - 1) / kFwdGroup, r);
  cols_fwd_tiled_kernel<D, DV, ROWS><<<grid, threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, denom, so, n, bs, vec);
  return (int)cudaGetLastError();
}

// K6's f32 kernel for this bucket size: the register-tiled one where it fits
template <int D, int DV>
int launch_cols_fwd_f32(const void* q, const void* k, const void* v, float* denom, float* so,
                        int r, int n, int bs, cudaStream_t stream) {
  if (bs <= kFwdTileMaxBs && bs % kFwdKeys == 0)
    return launch_cols_fwd_tiled<D, DV>(q, k, v, denom, so, r, n, bs, stream);
  return launch_cols_fwd<D, DV, false, false>(q, k, v, denom, so, r, n, bs, stream);
}

// K10 on the route the wrapper picked (ops/bucket_attn_cuda.py
// rows_fwd_route / rows_bwd_route): tiled, the register-tiled kernels above
// on the row layout; else the first-cut column kernels on it, any bs
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= (uintptr_t)p;
  return any % 16 == 0;
}

template <int D, int DV>
int launch_rows_fwd(const void* q, const void* k, const void* v, float* denom, float* so, int n,
                    int bs, bool tiled, cudaStream_t s) {
  if (!tiled) return launch_cols_fwd<D, DV, false, false, true>(q, k, v, denom, so, 1, n, bs, s);
  return launch_cols_fwd_tiled<D, DV, true>(q, k, v, denom, so, 1, n, bs, s,
                                            aligned16({q, k, v, so}));
}

template <int D, int DV>
int launch_rows_bwd(const void* q, const void* k, const void* v, const float* gso,
                    const float* gden, void* dq, void* dk, void* dv, int n, int bs, bool tiled,
                    cudaStream_t s) {
  if (!tiled) return launch_cols_bwd<D, DV, false, true>(q, k, v, gso, gden, dq, dk, dv, 1, n, bs, s);
  if (bs > kTiledMaxBs || TiledDims<D, DV>::smem(bs) > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_cols_bwd_tiled<D, DV, true>(q, k, v, gso, gden, dq, dk, dv, 1, n, bs, s,
                                            aligned16({q, k, v, gso, dq, dk, dv}));
}

}  // namespace

// (d, dv) pairs compiled; ops/bucket_attn_cuda.py SUPPORTED_DIMS lists the same.
// The column kernels K6 / K7 also take the pileup width (coords_dim 4:
// d = 28; COLS_DIMS there); K1 / K2 and K10 run on no pileup path.
#define HEPT_DIMS(X) X(30, 24) X(7, 5)
#define HEPT_COLS_DIMS(X) HEPT_DIMS(X) X(28, 24)

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

// K1 / K2 on the tensor cores: bf16 inputs, bs % 16 == 0, every pointer
// 16-byte aligned (the wrapper checks).
extern "C" int hept_bucket_attn_fwd_tc(const void* q, const void* k, const void* v, float* denom,
                                       float* so, int r, int d, int dv, int n, int bs,
                                       void* stream) {
  if (bs <= 0 || bs % 16 != 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_TC_FWD_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return launch_tc_fwd<D_, DV_>(q, k, v, denom, so, r, n, bs, s);
  HEPT_DIMS(HEPT_TC_FWD_CASE)
#undef HEPT_TC_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int hept_bucket_attn_bwd_tc(const void* q, const void* k, const void* v,
                                       const float* gso, const float* gden, void* dq, void* dk,
                                       void* dv_out, int r, int d, int dv, int n, int bs,
                                       void* stream) {
  if (bs <= 0 || bs % 16 != 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_TC_BWD_CASE(D_, DV_) \
  if (d == D_ && dv == DV_)       \
    return launch_tc_bwd<D_, DV_>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs, s);
  HEPT_DIMS(HEPT_TC_BWD_CASE)
#undef HEPT_TC_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// K7 v2 on the tensor cores: bf16 inputs, bs % 4 == 0, every pointer
// 16-byte aligned (the wrapper checks).
extern "C" int hept_cols_bwd_tc(const void* q, const void* k, const void* v, const float* gso,
                                const float* gden, void* dq, void* dk, void* dv_out, int r,
                                int d, int dv, int n, int bs, void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_TC_COLS_BWD_CASE(D_, DV_)                                                     \
  if (d == D_ && dv == DV_)                                                                \
    return launch_tc_cols_bwd<D_, DV_>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs,       \
                                       tc_cols_group(bs), s);
  HEPT_COLS_DIMS(HEPT_TC_COLS_BWD_CASE)
#undef HEPT_TC_COLS_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// K6 on FP32 FMAs: f32 (cols_fwd_tiled_kernel up to bs 100, else
// cols_fwd_kernel) and bf16 off the tensor-core route (cols_fwd_kernel)
extern "C" int hept_cols_fwd(const void* q, const void* k, const void* v, float* denom, float* so,
                             int r, int d, int dv, int n, int bs, int bf16, int hilo,
                             void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_COLS_FWD_CASE(D_, DV_)                                                        \
  if (d == D_ && dv == DV_) {                                                              \
    if (!bf16) return launch_cols_fwd_f32<D_, DV_>(q, k, v, denom, so, r, n, bs, s);        \
    return hilo ? launch_cols_fwd<D_, DV_, true, true>(q, k, v, denom, so, r, n, bs, s)      \
                : launch_cols_fwd<D_, DV_, true, false>(q, k, v, denom, so, r, n, bs, s);    \
  }
  HEPT_COLS_DIMS(HEPT_COLS_FWD_CASE)
#undef HEPT_COLS_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// K6 on the tensor cores: bf16 inputs, bs % 4 == 0, every pointer 16-byte
// aligned (the wrapper checks); hilo = 1 carries each bias as hi + lo bf16.
extern "C" int hept_cols_fwd_tc(const void* q, const void* k, const void* v, float* denom,
                                float* so, int r, int d, int dv, int n, int bs, int hilo,
                                void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = kTcColsFwdGroup;
#define HEPT_TC_COLS_FWD_CASE(D_, DV_)                                                       \
  if (d == D_ && dv == DV_)                                                                  \
    return hilo ? launch_tc_cols_fwd<D_, DV_, true, kTcColsFwdTiles>(q, k, v, denom, so, r, n, \
                                                                      bs, g, s)               \
                : launch_tc_cols_fwd<D_, DV_, false, kTcColsFwdTiles>(q, k, v, denom, so, r, n, \
                                                                       bs, g, s);
  HEPT_COLS_DIMS(HEPT_TC_COLS_FWD_CASE)
#undef HEPT_TC_COLS_FWD_CASE
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
              : launch_cols_bwd_f32<D_, DV_>(q, k, v, gso, gden, dq, dk, dv_out, r, n, bs, s);
  HEPT_COLS_DIMS(HEPT_COLS_BWD_CASE)
#undef HEPT_COLS_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// K10: the row layout, f32. q, k (n, d), v (n, dv) rows, n = g * bs;
// tiled = 1 the register-tiled kernels (forward bs % 4 == 0 up to 100,
// backward up to 100), else the first-cut ones.
extern "C" int hept_rows_fwd(const void* q, const void* k, const void* v, float* denom, float* so,
                             int d, int dv, int n, int bs, int tiled, void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_ROWS_FWD_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return launch_rows_fwd<D_, DV_>(q, k, v, denom, so, n, bs, tiled, s);
  HEPT_DIMS(HEPT_ROWS_FWD_CASE)
#undef HEPT_ROWS_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int hept_rows_bwd(const void* q, const void* k, const void* v, const float* gso,
                             const float* gden, void* dq, void* dk, void* dv_out, int d, int dv,
                             int n, int bs, int tiled, void* stream) {
  if (bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HEPT_ROWS_BWD_CASE(D_, DV_)                                                      \
  if (d == D_ && dv == DV_)                                                              \
    return launch_rows_bwd<D_, DV_>(q, k, v, gso, gden, dq, dk, dv_out, n, bs, tiled, s);
  HEPT_DIMS(HEPT_ROWS_BWD_CASE)
#undef HEPT_ROWS_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hept_bucket_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
