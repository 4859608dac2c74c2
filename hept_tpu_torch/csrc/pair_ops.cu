// Pair gather (K3) and anchor segment sum (K4) of the windowed InfoNCE loss.
//
// Replaces the TPU's windowed one-hot MXU kernels
//   K3  hept_tpu/ops/pair_ops.py:_gather_kernel  (pallas_call at :142)
//   K4  hept_tpu/ops/pair_ops.py:_scatter_kernel (pallas_call at :93)
//
// Layout: embeddings are (n, d) f32 rows, pair values (E, d) f32 rows, and
// the anchor index idx (E,) int32 (the pack-time layout of
// hept_tpu_torch/data/batching.py: anchor-sorted within each windowed block;
// the training loader's cached layout appends an augmentation block after
// the base block, so the whole index is not sorted).
//
// K3: out[e, :] = emb[idx[e], :]. On the TPU a gather became a one-hot
// matmul against a 256-row window; here it is a direct indexed copy, exact
// in f32, with no window restriction (the permissive semantics of the plain
// path). An index outside [0, n) yields NaN, as jnp.take's fill mode does.
// A row is nvec vectors of V floats, V the widest of 4, 2, 1 that d and the
// base pointers of emb and out allow (d = 12 aligned: three float4s). A
// block is (nvec, rows) threads: thread (c, y) copies vector c of the pairs
// y, y + rows, y + 2 rows, y + 3 rows of the block's span, each index read
// once and the four rows' loads in flight before their stores, so the
// threads of a warp write neighbouring vectors of out, with no division.
// At d = 1 a thread takes four neighbouring pairs: one 16-byte index load,
// four loads of emb, one 16-byte store (where idx and out are 16-byte
// aligned; else the (1, 256) blocks above).
//
// K4: out[i, :] = sum_{e: idx[e] = i} vals[e, :], for any index. It takes a
// CSR of the index: `order` (E,) int32, the pairs in stable anchor order,
// and `rowptr` (n + 1,) int32, so the pairs of row i are
// order[rowptr[i] .. rowptr[i+1]). The wrapper builds the CSR (a stable
// device sort, ops/pair_ops.py:anchor_csr), and the loss builds it once and
// shares it between the step's three K4 calls. A group of 8 lanes takes one
// row: lane l sums the row's pairs l, l + 8, l + 16, ... in that order, two
// at a time, each lane reading its int32 order[k] once, two turns ahead of
// the values, and then the whole d-wide value row with the widest vector
// loads that d and the base allow (d = 12: three 16-byte loads); then a
// fixed xor-shuffle tree combines the 8 lanes, and the row is stored with
// the same vectors. For d = 1 the lanes run over pairs. A row without pairs
// gets zeros. The summation order is fixed by the CSR, so every call gives
// the same bits, with no atomics. Window pads carry zero values and add
// nothing.
//
// What bounds them on the H100: both move bytes and do next to no
// arithmetic. K3 moves E*(4d + 4) + n*4d bytes (each index and output row
// once; emb, 2.9 MB at n ~ 60k and d = 12, stays in the L2 cache): ~57 MB
// for E ~ 1.1M pairs at d = 12, 0.018 ms at 3.35 TB/s; ~9 MB at d = 1
// (0.003 ms), where the two dependent loads of a pair (index, then row)
// bound it as much as the bytes. K4 with its CSR moves E*(4d + 4) +
// n*(4d + 4) bytes (each value row and order entry once, each output row
// and row pointer once): ~57 MB at d = 12, 0.017 ms. At d = 1 it moves
// ~9 MB (0.003 ms) and is bound by latency (two dependent loads per lane,
// order then value), not by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ void add(float* a, float v) { a[0] += v; }
  static __device__ float make(const float* a) { return a[0]; }
  static __device__ float nan() { return __int_as_float(0x7fc00000); }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ void add(float* a, float2 v) { a[0] += v.x; a[1] += v.y; }
  static __device__ float2 make(const float* a) { return make_float2(a[0], a[1]); }
  static __device__ float2 nan() { return make_float2(Vec<1>::nan(), Vec<1>::nan()); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ void add(float* a, float4 v) {
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
  }
  static __device__ float4 make(const float* a) { return make_float4(a[0], a[1], a[2], a[3]); }
  static __device__ float4 nan() {
    const float x = Vec<1>::nan();
    return make_float4(x, x, x, x);
  }
};

// K3: the pairs a thread copies (the block's span is rows * kGatherPairs)
constexpr int kGatherPairs = 4;

template <int V>
__global__ void __launch_bounds__(kThreads) gather_kernel(const float* __restrict__ emb,
                                                          const int32_t* __restrict__ idx,
                                                          float* __restrict__ out, int n,
                                                          int nvec, int e) {
  using T = typename Vec<V>::T;
  const int rows = blockDim.y;
  const int p0 = blockIdx.x * rows * kGatherPairs + threadIdx.y;
  int src[kGatherPairs];
#pragma unroll
  for (int u = 0; u < kGatherPairs; ++u) {
    const int p = p0 + u * rows;
    src[u] = p < e ? __ldg(idx + p) : 0;
  }
  const T* rows_in = reinterpret_cast<const T*>(emb);
  T* rows_out = reinterpret_cast<T*>(out);
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    T val[kGatherPairs];
#pragma unroll
    for (int u = 0; u < kGatherPairs; ++u)
      val[u] = (unsigned)src[u] < (unsigned)n ? __ldg(rows_in + (size_t)src[u] * nvec + c)
                                              : Vec<V>::nan();
#pragma unroll
    for (int u = 0; u < kGatherPairs; ++u) {
      const int p = p0 + u * rows;
      if (p < e) rows_out[(size_t)p * nvec + c] = val[u];
    }
  }
}

// K3 at d = 1: four neighbouring pairs a thread (idx and out 16-byte
// aligned); the e % 4 last pairs go to the next threads, one each
__global__ void __launch_bounds__(kThreads) gather1_kernel(const float* __restrict__ emb,
                                                           const int32_t* __restrict__ idx,
                                                           float* __restrict__ out, int n, int e) {
  const int t = blockIdx.x * kThreads + threadIdx.x, quads = e / 4;
  auto row = [&](int i) { return (unsigned)i < (unsigned)n ? __ldg(emb + i) : Vec<1>::nan(); };
  if (t < quads) {
    const int4 i = __ldg(reinterpret_cast<const int4*>(idx) + t);
    reinterpret_cast<float4*>(out)[t] = make_float4(row(i.x), row(i.y), row(i.z), row(i.w));
  } else if (t - quads < e % 4) {
    const int p = 4 * quads + t - quads;
    out[p] = row(__ldg(idx + p));
  }
}

// one launch of K3 over e < 2^30 pairs
int launch_gather(const float* emb, const int32_t* idx, float* out, int n, int d, int e,
                  cudaStream_t st) {
  const uintptr_t base = (uintptr_t)emb | (uintptr_t)out;
  if (d == 1 && ((uintptr_t)idx | (uintptr_t)out) % 16 == 0) {
    const int threads = e / 4 + e % 4;
    gather1_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(emb, idx, out, n, e);
    return (int)cudaGetLastError();
  }
  const int v = d % 4 == 0 && base % 16 == 0 ? 4 : d % 2 == 0 && base % 8 == 0 ? 2 : 1;
  const int nvec = d / v, x = std::min(nvec, kThreads), rows = kThreads / x;
  const dim3 block(x, rows), grid((e + rows * kGatherPairs - 1) / (rows * kGatherPairs));
  if (v == 4)
    gather_kernel<4><<<grid, block, 0, st>>>(emb, idx, out, n, nvec, e);
  else if (v == 2)
    gather_kernel<2><<<grid, block, 0, st>>>(emb, idx, out, n, nvec, e);
  else
    gather_kernel<1><<<grid, block, 0, st>>>(emb, idx, out, n, nvec, e);
  return (int)cudaGetLastError();
}

// One group of kLanes lanes per anchor row; V floats per vector, C vectors
// per pass over the row's features (d = V * nvec, passes of C vectors; EXACT:
// d = V * C, one pass with no ragged vectors). Each lane keeps two value rows
// in flight and the next two order entries behind them.
constexpr int kLanes = 8;

template <int V, int C, bool EXACT>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(const float* __restrict__ vals,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ rowptr, float* __restrict__ out,
                                   int n, int d) {
  using T = typename Vec<V>::T;
  constexpr int G = kLanes;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = gid / G;
  if (row >= n) return;  // whole groups leave together (G divides the block)
  const int lane = threadIdx.x % G;
  // the group's lanes within the warp, for the shuffles
  const unsigned mask = (0xffffffffu >> (32 - G)) << ((threadIdx.x & 31) & ~(G - 1));
  const int k0 = __ldg(rowptr + row), k1 = __ldg(rowptr + row + 1);
  const int nvec = EXACT ? C : d / V;
  for (int c0 = 0; c0 < nvec; c0 += C) {
    const int cv = EXACT ? C : min(C, nvec - c0);
    float acc[C * V];
#pragma unroll
    for (int i = 0; i < C * V; ++i) acc[i] = 0.f;
    // lane l: pairs k = k0 + l, k + G, k + 2G, ..., two per turn
    int k = k0 + lane;
    int e0 = k < k1 ? __ldg(order + k) : 0;
    int e1 = k + G < k1 ? __ldg(order + k + G) : 0;
    while (k < k1) {
      const bool two = k + G < k1;
      const T* s0 = reinterpret_cast<const T*>(vals + (long long)e0 * d) + c0;
      const T* s1 = reinterpret_cast<const T*>(vals + (long long)e1 * d) + c0;
      k += 2 * G;
      e0 = k < k1 ? __ldg(order + k) : 0;
      e1 = k + G < k1 ? __ldg(order + k + G) : 0;
      T v0[C], v1[C];
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < cv) {
          v0[j] = __ldg(s0 + j);
          if (two) v1[j] = __ldg(s1 + j);
        }
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < cv) {
          Vec<V>::add(acc + j * V, v0[j]);
          if (two) Vec<V>::add(acc + j * V, v1[j]);
        }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < C * V; ++i)
        if (i < cv * V) acc[i] += __shfl_xor_sync(mask, acc[i], off, G);
    T* dst = reinterpret_cast<T*>(out + row * d) + c0;
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (j < cv && j % G == lane) dst[j] = Vec<V>::make(acc + j * V);
  }
}

template <int V, int C>
int launch_segment_sum(const float* vals, const int32_t* order, const int32_t* rowptr,
                       float* out, int n, int d, cudaStream_t st) {
  const long long blocks = ((long long)n * kLanes + kThreads - 1) / kThreads;
  if (d == V * C)
    segment_sum_kernel<V, C, true><<<(unsigned)blocks, kThreads, 0, st>>>(vals, order, rowptr,
                                                                          out, n, d);
  else
    segment_sum_kernel<V, C, false><<<(unsigned)blocks, kThreads, 0, st>>>(vals, order, rowptr,
                                                                           out, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// out (E, d) = emb rows at idx, NaN out of range. Returns the CUDA error
// code of the launch.
extern "C" int hept_pair_gather(const float* emb, const int32_t* idx, float* out, int n, int d,
                                long long e, void* stream) {
  if (e == 0 || d == 0) return 0;
  if (d < 0 || n < 0 || e < 0) return (int)cudaErrorInvalidValue;
  constexpr long long kSpan = 1LL << 30;  // pairs a launch: int indices inside
  for (long long e0 = 0; e0 < e; e0 += kSpan) {
    const int err = launch_gather(emb, idx + e0, out + e0 * d, n, d, (int)std::min(kSpan, e - e0),
                                  (cudaStream_t)stream);
    if (err) return err;
  }
  return 0;
}

// out (n, d) = the CSR segment sums of vals (E, d). Returns the CUDA error
// code of the launch.
extern "C" int hept_pair_segment_sum(const float* vals, const int32_t* order,
                                     const int32_t* rowptr, float* out, int n, int d,
                                     void* stream) {
  if ((long long)n * d == 0) return 0;
  if (d < 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t base = (uintptr_t)vals | (uintptr_t)out;
  if (d == 1) return launch_segment_sum<1, 1>(vals, order, rowptr, out, n, d, st);
  if (d % 4 == 0 && base % 16 == 0)
    return launch_segment_sum<4, 3>(vals, order, rowptr, out, n, d, st);
  if (d % 2 == 0 && base % 8 == 0)
    return launch_segment_sum<2, 6>(vals, order, rowptr, out, n, d, st);
  return launch_segment_sum<1, 12>(vals, order, rowptr, out, n, d, st);
}

extern "C" const char* hept_pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
