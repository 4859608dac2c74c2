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
// arithmetic. K4 with its CSR moves E*(4d + 4) + n*(4d + 4) bytes (each
// value row and order entry once, each output row and row pointer once):
// ~57 MB for E ~ 1.1M pairs at d = 12, 0.017 ms at 3.35 TB/s. At d = 1 it
// moves ~9 MB (0.003 ms) and is bound by latency (two dependent loads per
// lane, order then value), not by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_kernel(const float* __restrict__ emb, const int32_t* __restrict__ idx,
                              float* __restrict__ out, int n, int d, long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long e = t / d;
  const int f = (int)(t - e * d);
  const int i = idx[e];
  out[t] = (i >= 0 && i < n) ? emb[(long long)i * d + f] : __int_as_float(0x7fc00000);
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ void add(float* a, float v) { a[0] += v; }
  static __device__ float make(const float* a) { return a[0]; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ void add(float* a, float2 v) { a[0] += v.x; a[1] += v.y; }
  static __device__ float2 make(const float* a) { return make_float2(a[0], a[1]); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ void add(float* a, float4 v) {
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
  }
  static __device__ float4 make(const float* a) { return make_float4(a[0], a[1], a[2], a[3]); }
};

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

extern "C" int hept_pair_gather(const float* emb, const int32_t* idx, float* out, int n, int d,
                                long long e, void* stream) {
  const long long total = e * d;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(emb, idx, out, n, d,
                                                                          total);
  return (int)cudaGetLastError();
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
