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
// K4: out[i, :] = sum_{e: idx[e] = i} vals[e, :]. The wrapper orders the
// pairs by anchor with a stable device argsort (`order`) and takes row
// pointers with torch.searchsorted, so the pairs of row i are
// order[rowptr[i] .. rowptr[i+1]); one thread per (row, feature) sums them
// in pair order: deterministic and bitwise reproducible, no atomics. Window
// pads carry zero values and add nothing.
//
// What bounds them on the H100: both move ~E*d*4 bytes (E ~ 1.1M pairs,
// d = 12 or 1) and do next to no arithmetic, so they are bound by memory;
// the ideal is E*d*4 bytes at 3.35 TB/s, ~16 us for d = 12. Thread-per-
// element indexing keeps neighbouring threads on neighbouring features of
// one row (coalesced within a row), and the sorted anchors make the gathered
// rows nearly contiguous. The segment sum's threads walk runs of ~18 pairs
// through `order` (nearly contiguous within a block); widening each thread
// to a whole row, and reusing one argsort for the step's three calls, is
// later work.
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

__global__ void segment_sum_kernel(const float* __restrict__ vals,
                                   const int64_t* __restrict__ order,
                                   const int64_t* __restrict__ rowptr, float* __restrict__ out,
                                   int n, int d) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * d) return;
  const long long i = t / d;
  const int f = (int)(t - i * d);
  float acc = 0.f;
  for (long long k = rowptr[i]; k < rowptr[i + 1]; ++k) acc += vals[order[k] * d + f];
  out[t] = acc;
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

extern "C" int hept_pair_segment_sum(const float* vals, const int64_t* order,
                                     const int64_t* rowptr, float* out, int n, int d,
                                     void* stream) {
  const long long total = (long long)n * d;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(vals, order, rowptr,
                                                                               out, n, d);
  return (int)cudaGetLastError();
}

extern "C" const char* hept_pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
