// Flat row gather (K5, which also carries K11's contract): the [num|denom]
// unsort of every HEPT layer, forward and backward.
//
// Replaces the TPU's row-gather kernels
//   K5   hept_tpu/ops/gather_pallas.py:_dma_kernel via row_gather_dma (pallas_call at :208)
//   K11  hept_tpu/ops/gather_pallas.py:_vreg_kernel via row_gather_vreg (pallas_call at :124)
// Both compute out[r, p, :] = src[r % S, idx[r, p], :] with S | R.
//
// Layout: src (S, n, W) and out (R, n, W), row-major, elements of 2 or 4
// bytes copied bit for bit (so the kernel sees rows of `row_bytes` bytes and
// never looks at the values); idx (R, n) int64, read as the static plan
// holds it. On the main path R = S = 2 rounds, n = 60416 and W = h*(dv+1) =
// 200 elements: 400 B rows in bf16 (unsort_pack), 800 B in f32. The width
// comes from the tensor; there is no 128-word cap as on the TPU.
//
// What the TPU kernel did and what this one does instead: the TPU kernel
// issued one DMA per row from HBM into a VMEM output tile, 16 in flight, and
// the vreg variant swept the source through VMEM. On Hopper the gather is a
// plain memory-bound copy. One warp per output row: lane 0 reads the row's
// index once and broadcasts it with a shuffle, then the lanes copy the row
// with 16-byte vector loads and stores where the row width and both base
// pointers allow it, 4-byte (or 2-byte) ones otherwise. Neighbouring lanes
// touch neighbouring addresses of one row, and a 400 B row is one burst.
//
// Bound on the H100: the bytes, R*n*(2*row_bytes + 8) (each source row read
// once under a permutation, each output row written once, each index read
// once), at 3.35 TB/s: 0.029 ms for the bf16 main-path call. A 400 B row is
// 25 16-byte vectors, so 7 of a warp's 32 lanes idle; packing several rows
// per warp is later work.
//
// An index outside [0, n) breaks the contract (the static plan's indices are
// permutations); the kernel then writes zeros instead of reading out of
// bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V>
__global__ void row_gather_kernel(const V* __restrict__ src, const int64_t* __restrict__ idx,
                                  V* __restrict__ out, long long rows, long long n, int s_rounds,
                                  int vecs) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  long long j = 0;
  if (lane == 0) j = idx[row];
  j = __shfl_sync(0xffffffffu, j, 0);
  V* o = out + row * vecs;
  if (j < 0 || j >= n) {
    for (int v = lane; v < vecs; v += 32) o[v] = V{};
    return;
  }
  const long long r = row / n;
  const V* s = src + ((r % s_rounds) * n + j) * vecs;
  for (int v = lane; v < vecs; v += 32) o[v] = __ldg(s + v);
}

template <typename V>
int launch(const void* src, const int64_t* idx, void* out, long long rows, long long n,
           int s_rounds, long long row_bytes, cudaStream_t stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_gather_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const V*)src, idx, (V*)out, rows, n, s_rounds, (int)(row_bytes / sizeof(V)));
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int a) { return ((uintptr_t)p % a) == 0; }

}  // namespace

// out[r, p, :] = src[r % s_rounds, idx[r, p], :] for r < rows / n; rows of
// `row_bytes` bytes (even). Returns the CUDA error code of the launch.
extern "C" int hept_row_gather(const void* src, const int64_t* idx, void* out, long long rows,
                               long long n, int s_rounds, long long row_bytes, void* stream) {
  if (rows == 0 || row_bytes == 0) return 0;
  if (n <= 0 || s_rounds <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned(src, 16) && aligned(out, 16))
    return launch<uint4>(src, idx, out, rows, n, s_rounds, row_bytes, st);
  if (row_bytes % 4 == 0 && aligned(src, 4) && aligned(out, 4))
    return launch<uint32_t>(src, idx, out, rows, n, s_rounds, row_bytes, st);
  return launch<uint16_t>(src, idx, out, rows, n, s_rounds, row_bytes, st);
}

extern "C" const char* hept_row_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
